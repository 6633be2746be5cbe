"""whisper-medium [audio] — enc-dec, 24L(+24L enc) d_model=1024 16H
d_ff=4096 vocab=51865; LayerNorm, GELU (ungated), sinusoidal positions,
conv frontend STUBBED: input_specs() feeds precomputed frame embeddings
(n_memory=1500 ≙ 30 s of audio at 50 Hz). [arXiv:2212.04356; unverified]"""
import dataclasses

from repro_torch.models.model import ArchConfig

# One whisper decoder layer = self-attn -> cross-attn -> MLP; expressed as
# two blocks per layer, so n_layers=48 blocks ≙ 24 decoder layers.
CONFIG = ArchConfig(
    name="whisper-medium", family="encdec",
    n_layers=48, d_model=1024, n_heads=16, n_kv=16, d_head=64,
    d_ff=4096, vocab=51865, act="gelu", gated_mlp=False,
    norm="ln", pos_embed="sinusoidal",
    enc_layers=24, n_memory=1500,
    pattern=(("attn", "none"), ("cross", "dense")),
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, accum_steps=1, n_layers=4, d_model=64, n_heads=4, n_kv=4, d_head=16,
        d_ff=128, vocab=256, enc_layers=2, n_memory=16,
        q_chunk=16, kv_chunk=16)
