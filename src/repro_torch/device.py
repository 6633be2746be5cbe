"""Device choice for the port's entry points.

The port runs on the card: an entry point given no device takes `cuda`,
and raises when there is none. The CPU is used only when the caller asks
for it (`device="cpu"`, as the tests do) — never as a quiet fallback.
"""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """`torch.device` for an entry point's `device=` argument: None means
    the card; a CUDA device is checked to exist."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run on the CPU explicitly")
    return dev


_CONSTANTS: dict = {}


def constant(values, device, dtype=None) -> torch.Tensor:
    """A small host table (opcode lists, arity, heap depth, constants)
    as a tensor on `device`, made once per device and reused: a copy
    to the card inside an evolution block would synchronise the host."""
    arr = np.ascontiguousarray(np.asarray(values, dtype=dtype))
    dev = torch.device(device)
    k = (arr.dtype.str, arr.shape, arr.tobytes(), str(dev))
    t = _CONSTANTS.get(k)
    if t is None:
        t = _CONSTANTS[k] = torch.from_numpy(arr.copy()).to(dev)
    return t
