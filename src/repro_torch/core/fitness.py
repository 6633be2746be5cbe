"""Fitness kernels — a registry of pluggable GP objectives, in PyTorch.

Port of `repro/core/fitness.py`: the paper's (r)egression,
(c)lassification and (m)atch kernels plus `mse`, under the same two-pass
protocol. Phase 1, `moments(preds, y, weight, spec)`, gives weighted
moment partials f32[P, M] over one data tile; partials from different
tiles merge (elementwise sum, or the kernel's `combine_moments`). Phase
2, `reduce_moments`, turns the merged moments into the fitness f32[P].

Conventions every kernel obeys:

  * MINIMIZE — lower fitness is better (classify and match are negated
    hit counts).
  * `weight` masks data padding: points with weight 0 contribute nothing.
  * A NaN prediction at any valid (weight > 0) point makes the tree's
    fitness +inf, so a NaN-producing tree never wins a tournament.

`pearson` and `r2` (the Chan-combined two-pass kernels) are not ported
yet: asking for them raises NotImplementedError (ROADMAP queue A).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

REGRESSION = "r"
CLASSIFY = "c"
MATCH = "m"

_NOT_PORTED = {"pearson", "r2", "r-squared"}


@dataclasses.dataclass(frozen=True)
class FitnessSpec:
    kernel: str = REGRESSION  # any name registered in the kernel registry
    n_classes: int = 3  # classify only
    precision: float = 1e-4  # match tolerance (paper: 4 decimal places)

    def __hash__(self):
        return hash((self.kernel, self.n_classes, self.precision))


@dataclasses.dataclass(frozen=True)
class FitnessKernel:
    """One pluggable objective, evaluated as moments → merge → finalize.

      moments:         (preds f32[P, D], y f32[D], weight f32[D], spec)
                       -> f32[P, M] weighted moment partials for one tile
      reduce_moments:  (moments f32[..., M], spec) -> f32[...] fitness
      combine_moments: optional pairwise merge; None = elementwise sum
      partial_fitness: (preds, y, weight, spec) -> f32[P]; for
                       `decomposable` kernels the M=1 moment
      metric:          (preds f32[P, D], y f32[D], spec) -> f32[P]
                       human-facing score used by `GPSession.score`
      device_id:       index of the kernel's branch in the CUDA epilogue
                       (kernels/csrc/gp_eval.cu); None = no device form
    """

    name: str
    partial_fitness: Callable = None
    metric: Callable = None
    aliases: tuple = ()
    decomposable: bool = True
    moments: Callable = None
    reduce_moments: Callable = None
    n_moments: int = 1
    combine_moments: Callable = None
    device_id: int | None = None

    def merge_moments(self, m1, m2, spec):
        """Merge two moment partials — the one way any path accumulates
        phase-1 output."""
        if self.combine_moments is None:
            return m1 + m2
        return self.combine_moments(m1, m2, spec)


_REGISTRY: dict[str, FitnessKernel] = {}


def _normalize(kernel: FitnessKernel) -> FitnessKernel:
    """Fill in the derivable half of the two-pass protocol."""
    if kernel.moments is not None:
        if kernel.reduce_moments is None:
            raise ValueError(f"fitness kernel {kernel.name!r} defines moments "
                             f"but no reduce_moments")
        mom, red = kernel.moments, kernel.reduce_moments
        repl = {}
        if kernel.partial_fitness is None:
            repl["partial_fitness"] = lambda p, y, w, s: red(mom(p, y, w, s), s)
        if kernel.n_moments > 1:
            repl["decomposable"] = False
        return dataclasses.replace(kernel, **repl) if repl else kernel
    if kernel.partial_fitness is None:
        raise ValueError(f"fitness kernel {kernel.name!r} must define either "
                         f"partial_fitness or moments + reduce_moments")
    if not kernel.decomposable:
        return kernel
    pf = kernel.partial_fitness
    return dataclasses.replace(
        kernel,
        moments=lambda p, y, w, s: pf(p, y, w, s)[..., None],
        reduce_moments=lambda m, s: m[..., 0],
        n_moments=1)


def register_kernel(kernel: FitnessKernel, *, overwrite: bool = False) -> FitnessKernel:
    keys = (kernel.name, *kernel.aliases)
    if not overwrite:
        for key in keys:
            if key in _REGISTRY:
                raise ValueError(f"fitness kernel {key!r} already registered "
                                 f"(pass overwrite=True to replace)")
    kernel = _normalize(kernel)
    for key in keys:
        _REGISTRY[key] = kernel
    return kernel


def get_kernel(name: str) -> FitnessKernel:
    try:
        return _REGISTRY[name]
    except KeyError:
        if name in _NOT_PORTED:
            raise NotImplementedError(
                f"fitness kernel {name!r} is not ported yet (ROADMAP queue A: "
                f"pearson/r2 with the Chan combine)") from None
        raise ValueError(f"unknown fitness kernel {name!r}; registered: "
                         f"{available_kernels()}") from None


def available_kernels() -> list[str]:
    return sorted({k.name for k in _REGISTRY.values()})


# --- built-in kernels ---------------------------------------------------------


def classify_labels(preds, n_classes: int):
    """Karoo's classification binning: round the regression output into
    {0..n_classes-1} with saturating ends (round half to even)."""
    return torch.clamp(torch.round(preds), 0, n_classes - 1).to(torch.int32)


def _f32(x) -> float:
    """A Python float rounded to float32, as the reference's weakly typed
    scalars are when they meet an f32 array."""
    return float(np.float32(x))


def _has_invalid(preds, w):
    """True per tree iff any valid data point evaluated to NaN."""
    return (torch.isnan(preds) & (w[None, :] > 0)).any(-1)


def _regression_partial(preds, y, w, spec):
    err = (preds - y[None, :]).abs()
    err = torch.where(w[None, :] > 0, err, 0.0)  # mask BEFORE inf-sanitize
    return torch.where(torch.isnan(err), math.inf, err).sum(-1)


def _classify_partial(preds, y, w, spec):
    lab = torch.clamp(torch.round(torch.nan_to_num(preds)), 0, spec.n_classes - 1)
    hits = ((lab == y[None, :]) * w[None, :]).sum(-1)
    return torch.where(_has_invalid(preds, w), math.inf, -hits)


def _match_partial(preds, y, w, spec):
    hit = (preds - y[None, :]).abs() <= _f32(spec.precision)
    hits = (hit * w[None, :]).sum(-1)
    return torch.where(_has_invalid(preds, w), math.inf, -hits)


def _mse_partial(preds, y, w, spec):
    err2 = torch.square(preds - y[None, :])
    err2 = torch.where(w[None, :] > 0, err2, 0.0)
    return torch.where(torch.isnan(err2), math.inf, err2).sum(-1)


def _classify_metric(preds, y, spec):
    lab = classify_labels(torch.nan_to_num(preds), spec.n_classes)
    return (lab == y[None, :].to(torch.int32)).float().mean(-1)


register_kernel(FitnessKernel(
    name=REGRESSION, aliases=("regression", "abs"), device_id=0,
    partial_fitness=_regression_partial,
    metric=lambda preds, y, spec: (preds - y[None, :]).abs().mean(-1)))
register_kernel(FitnessKernel(
    name=CLASSIFY, aliases=("classify", "classification"), device_id=1,
    partial_fitness=_classify_partial, metric=_classify_metric))
register_kernel(FitnessKernel(
    name=MATCH, aliases=("match",), device_id=2,
    partial_fitness=_match_partial,
    metric=lambda preds, y, spec: (
        (preds - y[None, :]).abs() <= _f32(spec.precision)).float().mean(-1)))
register_kernel(FitnessKernel(
    name="mse", partial_fitness=_mse_partial, device_id=3,
    metric=lambda preds, y, spec: torch.square(preds - y[None, :]).mean(-1)))


# --- convenience entry points -------------------------------------------------


def _weights(y, weight):
    return torch.ones_like(y) if weight is None else weight.float()


def fitness_from_preds(preds, y, spec: FitnessSpec, weight=None):
    """preds: [P, D] predictions; y: [D] targets → f32[P] (minimize), the
    whole-dataset fitness in one call."""
    y = y.float()
    return get_kernel(spec.kernel).partial_fitness(preds, y, _weights(y, weight), spec)


def moments_from_preds(preds, y, spec: FitnessSpec, weight=None):
    """Phase 1 only: f32[P, M] weighted moment partials of preds[P, D]."""
    kern = get_kernel(spec.kernel)
    if kern.moments is None:
        raise ValueError(f"fitness kernel {kern.name!r} defines no moment pass; "
                         f"it cannot be tiled over data")
    y = y.float()
    return kern.moments(preds, y, _weights(y, weight), spec)
