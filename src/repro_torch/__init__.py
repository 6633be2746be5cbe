"""repro_torch — the PyTorch/CUDA port of `repro` for one NVIDIA H100.

Mirrors the layout of the JAX package (`core/`, `kernels/`, `gp/`,
`data/`, `obs/`) so each module's counterpart is found under the same
name. The package imports `torch` and numpy only; the JAX package stays
the reference the port is held against, and only the tests import both.

Entry points (`gp.GPSession`, `kernels.ops.fitness`,
`core.engine.init_state`) run on `cuda` unless the caller passes
`device="cpu"`; with no card and no explicit CPU device they raise.
"""
from repro_torch.device import resolve_device  # noqa: F401
