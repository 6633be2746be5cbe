"""qwen1.5-32b [dense] — 64L d_model=5120 40H (GQA kv=40) d_ff=27392
vocab=152064, QKV bias. [hf:Qwen/Qwen1.5-0.5B family; hf]"""
import dataclasses

from repro_torch.models.model import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv=40, d_head=128,
    d_ff=27392, vocab=152064, act="silu", qkv_bias=True,
    rope_theta=1_000_000.0,
    accum_steps=2,
    # MHA (kv=40) at 128×32k decode is a 5.5 TB cache in bf16 — 21.5 GB/chip
    # even sharded both ways. fp8 KV (vLLM-style) halves it under budget.
    cache_dtype="float8_e4m3fn",
    pattern=(("attn", "dense"),),
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, accum_steps=1, n_layers=2, d_model=64, n_heads=4, n_kv=4, d_head=16,
        d_ff=128, vocab=256, q_chunk=16, kv_chunk=16)
