"""Fused GP population evaluation + fitness moments: the CUDA kernel's wrapper.

`eval_fitness` replaces `repro/kernels/gp_eval.py::eval_fitness_pallas`
(TPU body `_eval_fitness_kernel`): every heap tree of the population is
evaluated against every data point and reduced to its fitness moments
f32[P, M] in one fused pass, so the [pop, nodes, data] intermediate of
the plain path never reaches device memory.

The kernel is hand-written CUDA C++ for Hopper (`csrc/gp_eval.cu`,
sm_90a), built by `kernels/build.py` at first use and called through
ctypes on PyTorch's current stream. What bounds it on the card: it reads
only op/arg (P·N·8 bytes), X (F·D·4), y and w (D·8) and writes P·4
bytes, while it executes one interpreted node per active tree node per
data point (a few integer and f32 instructions and a uniform branch
each), so instruction issue, not memory, is the limit. The design keeps
each tree's instruction list in shared memory and its operand stack in
registers, so X, y and w are the only device-memory reads in the loop,
and it splits the data axis into tiles so that even P=100 populations
give the card several hundred blocks.

On a CPU tensor the wrapper runs `eval_fitness_plain`, the plain PyTorch
version of the same function; on a CUDA tensor it launches the kernel or
raises. `launches` counts the kernel's calls (the tests and
`chip_smoke.py` read it).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core import fitness as fit
from repro_torch.core import primitives as prim
from repro_torch.core.trees import TreeSpec
from repro_torch.kernels import ref as _ref

# calls of the kernel by `eval_fitness`, one per call on a CUDA tensor; a
# call is two CUDA launches (eval + ordered tile merge) when D spans more
# than one data tile, one otherwise
launches = 0

_FN = None


def reset_launches() -> None:
    global launches
    launches = 0


def _fn():
    """The kernel's C entry point, built and bound on first use."""
    global _FN
    if _FN is None:
        from repro_torch.kernels import build

        f = build.load("gp_eval").gp_eval_fitness
        vp, i, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        f.argtypes = [vp, vp, i, i, i, vp, i, i, vp, vp, vp, i, ctypes.c_uint, i,
                      f32, f32, i, vp, vp, vp]
        f.restype = i
        _FN = f
    return _FN


def _fn_set(fn_codes) -> prim.FunctionSet:
    if fn_codes is None:
        return prim.KITCHEN_SINK
    return prim.FunctionSet(np.asarray(fn_codes, np.int32))


def eval_fitness_plain(op, arg, X, y, weight, const_table, *, max_depth: int,
                       kernel: str = "r", n_classes: int = 3, precision: float = 1e-4,
                       data_tile: int = 1024, fn_codes=None):
    """Plain PyTorch version of the kernel: `kernels/ref.py`'s
    `moments_ref_tiled` at the kernel's data tile (`evaluate_population`
    per tile, the registered kernel's `moments` on it, tiles merged in
    order: the reference kernel's j == 0 store / j != 0 merge)."""
    spec = TreeSpec(max_depth=max_depth, fn_set=_fn_set(fn_codes))
    fspec = fit.FitnessSpec(kernel, n_classes=n_classes, precision=precision)
    return _ref.moments_ref_tiled(op, arg, X, y, const_table, spec, fspec,
                                  weight=weight, tile=data_tile)


def eval_fitness(op, arg, X, y, weight, const_table, *, max_depth: int,
                 kernel: str = "r", n_classes: int = 3, precision: float = 1e-4,
                 gather: str | None = None, data_tile: int = 1024, fn_codes=None):
    """Fused eval+moments → f32[P, M] (M = 1 for the built-in kernels).

    op, arg:  int32[P, N]   heap population, N = 2**(max_depth+1) - 1
    X:        f32[F, D]     feature-major data (any D: the kernel masks
                            the ragged last tile itself)
    y:        f32[D]
    weight:   f32[D] | None 0.0 on padding points; None = all ones
    const:    f32[C]
    data_tile              points per block (the kernel's data tile)
    fn_codes               the run's opcodes; others evaluate to 0

    `gather` ("onehot" | "vmem") is accepted for parity with the TPU
    kernel and ignored: an indexed load of X[arg, d] does the job here.
    """
    del gather
    if not op.is_cuda:
        return eval_fitness_plain(op, arg, X, y, weight, const_table,
                                  max_depth=max_depth, kernel=kernel,
                                  n_classes=n_classes, precision=precision,
                                  data_tile=data_tile, fn_codes=fn_codes)
    kern = fit.get_kernel(kernel)
    if kern.device_id is None or kern.n_moments != 1:
        raise NotImplementedError(
            f"fitness kernel {kernel!r} has no device form in csrc/gp_eval.cu")
    P, N = op.shape
    F, D = X.shape
    dev = op.device
    for name, t, dt in (("arg", arg, torch.int32), ("op", op, torch.int32),
                        ("X", X, torch.float32), ("y", y, torch.float32),
                        ("const_table", const_table, torch.float32)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dt} tensor on {dev}, got "
                             f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
    if weight is not None and (weight.device != dev or weight.dtype != torch.float32
                               or not weight.is_contiguous() or weight.shape != (D,)):
        raise ValueError("weight must be a contiguous float32 [D] tensor on the "
                         "population's device")
    if arg.shape != (P, N) or y.shape != (D,) or N != 2 ** (max_depth + 1) - 1:
        raise ValueError(f"shape mismatch: op {tuple(op.shape)}, arg "
                         f"{tuple(arg.shape)}, X {tuple(X.shape)}, y {tuple(y.shape)}, "
                         f"max_depth {max_depth}")
    if not 0 <= max_depth <= 10 or P > 65535 or data_tile <= 0:
        raise ValueError(f"unsupported launch: max_depth={max_depth} (<= 10), "
                         f"P={P} (<= 65535), data_tile={data_tile}")
    out = torch.empty((P, 1), dtype=torch.float32, device=dev)
    if P == 0:
        return out
    tiles = -(-D // data_tile)
    partial = torch.empty((P * tiles if tiles > 1 else 1,), dtype=torch.float32,
                          device=dev)
    mask = _fn_set(fn_codes).mask
    global launches
    err = _fn()(op.data_ptr(), arg.data_ptr(), P, N, max_depth, X.data_ptr(), F, D,
                y.data_ptr(), None if weight is None else weight.data_ptr(),
                const_table.data_ptr(), const_table.shape[0], mask, kern.device_id,
                float(n_classes - 1), float(np.float32(precision)), data_tile,
                partial.data_ptr(), out.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gp_eval_fitness launch failed: CUDA error {err}")
    launches += 1
    return out
