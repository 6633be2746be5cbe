"""Optimizer substrate (port of `repro/optim/`): AdamW, Adafactor,
schedules, and optional int8 gradient compression with error feedback."""
from repro_torch.optim.adamw import adafactor, adamw, cosine_schedule  # noqa: F401
from repro_torch.optim.compress import compressed_psum  # noqa: F401
