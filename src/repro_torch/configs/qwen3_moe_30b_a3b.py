"""qwen3-moe-30b-a3b [moe] — 48L d_model=2048 32H (GQA kv=4, head_dim=128)
expert d_ff=768 vocab=151936, MoE 128 experts top-8.
[hf:Qwen/Qwen3-30B-A3B; hf]"""
import dataclasses

from repro_torch.models.model import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv=4, d_head=128,
    d_ff=768, vocab=151936, act="silu", rope_theta=1_000_000.0,
    moe_experts=128, moe_top_k=8, moe_d_ff=768,
    accum_steps=4,
    pattern=(("attn", "moe"),),
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, accum_steps=1, n_layers=2, d_model=64, n_heads=4, n_kv=2, d_head=16,
        d_ff=64, vocab=256, moe_experts=8, moe_top_k=2, moe_d_ff=64,
        q_chunk=16, kv_chunk=16)
