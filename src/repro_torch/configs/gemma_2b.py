"""gemma-2b [dense] — 18L d_model=2048 8H (MQA kv=1) d_ff=16384
vocab=256000; GeGLU, head_dim=256, RMSNorm(1+scale), scaled+tied embeddings.
[arXiv:2403.08295; hf]"""
import dataclasses

from repro_torch.models.model import ArchConfig

CONFIG = ArchConfig(
    name="gemma-2b", family="dense",
    n_layers=18, d_model=2048, n_heads=8, n_kv=1, d_head=256,
    d_ff=16384, vocab=256000, act="gelu", gated_mlp=True,
    norm_plus_one=True, embed_scale=True, tie_embeddings=True,
    pattern=(("attn", "dense"),),
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, accum_steps=1, n_layers=2, d_model=64, n_heads=4, n_kv=1, d_head=16,
        d_ff=128, vocab=256, q_chunk=16, kv_chunk=16)
