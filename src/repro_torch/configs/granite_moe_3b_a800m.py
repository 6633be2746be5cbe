"""granite-moe-3b-a800m [moe] — 32L d_model=1536 24H (GQA kv=8)
expert d_ff=512 vocab=49155, MoE 40 experts top-8.

Note: the assigned spec says 40e; the cited hf card
(ibm-granite/granite-3.0-1b-a400m-base) is a 32e sibling — we follow the
assigned 40e. 40 experts do not divide the 16-way model
axis, so EP falls back to sharding the per-expert ff dim
(launch/sharding.py). [hf; assigned spec]"""
import dataclasses

from repro_torch.models.model import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv=8, d_head=64,
    d_ff=512, vocab=49155, act="silu",
    moe_experts=40, moe_top_k=8, moe_d_ff=512,
    accum_steps=4,
    tie_embeddings=True,
    pattern=(("attn", "moe"),),
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, accum_steps=1, n_layers=2, d_model=64, n_heads=4, n_kv=2, d_head=16,
        d_ff=64, vocab=256, moe_experts=5, moe_top_k=2, moe_d_ff=64,
        q_chunk=16, kv_chunk=16)
