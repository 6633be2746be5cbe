"""llama-3.2-vision-90b [vlm] — 100L d_model=8192 64H (GQA kv=8)
d_ff=28672 vocab=128256; 80 self-attention + 20 cross-attention image
layers (every 5th block). Vision tower STUBBED: input_specs() provides
precomputed patch embeddings (n_memory=1600).
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""
import dataclasses

from repro_torch.models.model import ArchConfig

_GROUP = (("cross", "dense"), ("attn", "dense"), ("attn", "dense"),
          ("attn", "dense"), ("attn", "dense"))

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b", family="vlm",
    n_layers=100, d_model=8192, n_heads=64, n_kv=8, d_head=128,
    d_ff=28672, vocab=128256, act="silu", rope_theta=500_000.0,
    n_memory=1600,
    accum_steps=4,
    pattern=_GROUP,
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, accum_steps=1, n_layers=10, d_model=64, n_heads=4, n_kv=2, d_head=16,
        d_ff=128, vocab=256, n_memory=16, q_chunk=16, kv_chunk=16)
