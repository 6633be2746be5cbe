"""minitron-8b [dense] — 32L d_model=4096 32H (GQA kv=8) d_ff=16384
vocab=256000; width/depth-pruned Nemotron-4. [arXiv:2407.14679; hf]"""
import dataclasses

from repro_torch.models.model import ArchConfig

CONFIG = ArchConfig(
    name="minitron-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv=8, d_head=128,
    d_ff=16384, vocab=256000, act="silu",
    accum_steps=2,
    pattern=(("attn", "dense"),),
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, accum_steps=1, n_layers=2, d_model=64, n_heads=4, n_kv=2, d_head=16,
        d_ff=128, vocab=256, q_chunk=16, kv_chunk=16)
