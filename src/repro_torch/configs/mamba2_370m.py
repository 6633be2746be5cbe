"""mamba2-370m [ssm] — 48L d_model=1024 (attention-free) vocab=50280,
ssm_state=128, SSD (state-space duality). Sub-quadratic: runs long_500k.
[arXiv:2405.21060; unverified]"""
import dataclasses

from repro_torch.models.model import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=0, n_kv=0, d_head=0,
    d_ff=0, vocab=50280,
    ssm_state=128, ssm_headdim=64, ssm_groups=1, ssm_chunk=128,
    tie_embeddings=True, subquadratic=True,
    pattern=(("mamba", "none"),),
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, accum_steps=1, n_layers=2, d_model=64, vocab=256, ssm_state=16,
        ssm_headdim=16, ssm_chunk=8)
