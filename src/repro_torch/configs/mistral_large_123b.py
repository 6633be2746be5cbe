"""mistral-large-123b [dense] — 88L d_model=12288 96H (GQA kv=8)
d_ff=28672 vocab=32768. [hf:mistralai/Mistral-Large-Instruct-2407;
unverified]"""
import dataclasses

from repro_torch.models.model import ArchConfig

CONFIG = ArchConfig(
    name="mistral-large-123b", family="dense",
    n_layers=88, d_model=12288, n_heads=96, n_kv=8, d_head=128,
    d_ff=28672, vocab=32768, act="silu", rope_theta=1_000_000.0,
    accum_steps=8,
    pattern=(("attn", "dense"),),
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, accum_steps=1, n_layers=2, d_model=64, n_heads=8, n_kv=2, d_head=8,
        d_ff=128, vocab=256, q_chunk=16, kv_chunk=16)
