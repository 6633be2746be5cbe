"""jamba-1.5-large-398b [hybrid] — 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536, MoE 16e top-2; Mamba:attn 7:1 interleave.

Structure: 9 groups of 8 blocks — [attn, mamba×7], MoE MLP on every other
block (4 MoE per group → 36 MoE layers). Jamba-1.5 ships Mamba-1 mixers;
the reference substitutes the SSD (Mamba-2) block, and so does the
port. Adafactor: AdamW moments would exceed the single-pod HBM
budget at 398B params. Sub-quadratic (9/72 attention layers): runs
long_500k. [arXiv:2403.19887; hf]"""
import dataclasses

from repro_torch.models.model import ArchConfig

_GROUP = (
    ("attn", "dense"), ("mamba", "moe"), ("mamba", "dense"), ("mamba", "moe"),
    ("mamba", "dense"), ("mamba", "moe"), ("mamba", "dense"), ("mamba", "moe"),
)

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv=8, d_head=128,
    d_ff=24576, vocab=65536, act="silu",
    moe_experts=16, moe_top_k=2, moe_d_ff=24576,
    ssm_state=128, ssm_headdim=64, ssm_groups=8, ssm_chunk=128,
    optimizer="adafactor", subquadratic=True,
    accum_steps=4,
    moe_capacity_factor=1.0,
    pattern=_GROUP,
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, accum_steps=1, n_layers=8, d_model=64, n_heads=4, n_kv=2, d_head=16,
        d_ff=128, vocab=256, moe_experts=4, moe_top_k=2, moe_d_ff=128,
        ssm_state=16, ssm_headdim=16, ssm_groups=2, ssm_chunk=8,
        q_chunk=16, kv_chunk=16)
