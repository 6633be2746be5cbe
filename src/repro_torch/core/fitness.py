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

`pearson` and `r2` are the two-pass kernels proper: phase 1 gives
per-tile centered moments (count, means, centered second moments and
co-moment, a non-finite count), `combine_moments` merges two partials
with Chan's parallel-variance formulas, and `reduce_moments` finishes.
Every f32 operation keeps the reference's association (`dxw = dx * w`
before `dxw * dx`; `delta * n2 / nz`), so per-point terms are bitwise
the reference's and only the order of the sums differs. `y_moment_idx`
marks the columns that depend on (y, weight) alone.
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
      combine_moments: optional pairwise merge; None = elementwise sum.
                       The all-zeros partial is a merge identity
      y_moments:       optional (y f32[D], weight f32[D], spec) ->
                       f32[len(y_moment_idx)], the tree-independent columns
      y_moment_idx:    positions of those columns in the M vector
      partial_fitness: (preds, y, weight, spec) -> f32[P]; for
                       `decomposable` kernels the M=1 moment, otherwise
                       the whole-dataset fitness in one call
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
    y_moments: Callable = None
    y_moment_idx: tuple = ()
    device_id: int | None = None

    def merge_moments(self, m1, m2, spec):
        """Merge two moment partials — the one way any path accumulates
        phase-1 output."""
        if self.combine_moments is None:
            return m1 + m2
        return self.combine_moments(m1, m2, spec)

    @property
    def tree_moment_idx(self) -> tuple:
        """Complement of `y_moment_idx`: the per-tree moment columns."""
        return tuple(i for i in range(self.n_moments) if i not in self.y_moment_idx)


_REGISTRY: dict[str, FitnessKernel] = {}


def _normalize(kernel: FitnessKernel) -> FitnessKernel:
    """Fill in the derivable half of the two-pass protocol."""
    if bool(kernel.y_moment_idx) != (kernel.y_moments is not None):
        raise ValueError(f"fitness kernel {kernel.name!r} must define "
                         f"y_moments and y_moment_idx together")
    if kernel.y_moment_idx and not all(
            0 <= i < kernel.n_moments for i in kernel.y_moment_idx):
        raise ValueError(f"fitness kernel {kernel.name!r} y_moment_idx "
                         f"{kernel.y_moment_idx} out of range for "
                         f"n_moments={kernel.n_moments}")
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


def _mean(x):
    """Mean over the last axis as XLA takes `jnp.mean`: the sum times the
    f32 reciprocal of the count (torch's `mean` divides, an ulp away)."""
    return x.sum(-1) * _f32(1.0 / x.shape[-1])


def _classify_metric(preds, y, spec):
    lab = classify_labels(torch.nan_to_num(preds), spec.n_classes)
    return _mean((lab == y[None, :].to(torch.int32)).float())


def _nonfinite_count(preds, w):
    """f32[P] count of non-finite (NaN or ±inf) predictions at valid
    points: the summable invalid moment of pearson/r2, which declare such
    a tree invalid (+inf) since an inf would poison their products."""
    return ((~torch.isfinite(preds)) & (w > 0)).sum(-1).float()


# pearson (1 - r² against the target) and r2 (1 - R²) carry shard-locally
# CENTERED moments, merged with Chan's parallel-variance formulas, so no
# path forms the raw E[x²] - E[x]² difference that cancels in f32 when
# |mean| ≫ std. A prediction is multiplied by its weight before any
# product, so a zero-weight point contributes exact 0.0 even when it
# saturated to ±3.4e38. Their `partial_fitness` is the exact centered
# single-pass form over the whole dataset (the un-tiled paths, `metric`).

_PEARSON_MOMENTS = 7  # n=Σw, x̄, ȳ, M2x, M2y, Cxy, invalid-count
_PEARSON_Y_IDX = (0, 2, 4)  # n, ȳ, M2y — tree-independent
_R2_MOMENTS = 5  # n=Σw, ȳ, M2y, Σw(pred-y)², invalid-count
_R2_Y_IDX = (0, 1, 2)  # n, ȳ, M2y — tree-independent

# Below this level a variance is indistinguishable from the f32 noise of
# the Chan merge (each pairwise combine subtracts two means, rounding
# ~eps·|mean|), which would crown constant-prediction trees as perfect;
# anything below (256·eps·|mean|)² counts as zero correlation (the
# resolution limit std/|mean| ≳ 3e-5).
_VAR_NOISE_FLOOR = 256 * 1.1920929e-07  # 256 * f32 machine epsilon


def _mean_divisor(n):
    """Safe divisor for a weighted mean: n whenever there is any weight
    (fractional weights included), 1.0 only for the empty (all-padding)
    case, whose numerator is an exact 0.0."""
    return torch.where(n > 0, n, 1.0)


def _pearson_partial(preds, y, w, spec):
    """Exact centered single-pass 1 - r² (whole dataset in one call)."""
    w_ = w[None, :]
    n = _mean_divisor(w.sum())
    p0 = torch.where(torch.isfinite(preds), preds, 0.0)
    mx = (p0 * w_).sum(-1, keepdim=True) / n
    my = (y[None, :] * w_).sum(-1, keepdim=True) / n
    dx = (p0 - mx) * w_
    dy = (y[None, :] - my) * w_
    r2 = torch.square((dx * dy).sum(-1)) / torch.clamp(
        (dx * dx).sum(-1) * (dy * dy).sum(-1), min=_f32(1e-12))
    invalid = ((~torch.isfinite(preds)) & (w_ > 0)).any(-1)
    out = torch.where(invalid, math.inf, 1.0 - r2)
    # huge-but-finite preds can overflow dx² to inf -> inf/inf NaN
    return torch.where(torch.isnan(out), math.inf, out)


def _y_center_moments(y, w, spec):
    """f32[3] tree-independent centered target moments: [Σw, ȳ, M2y]."""
    n = w.sum()
    my = (y * w).sum() / _mean_divisor(n)
    dy = y - my
    m2y = (dy * w * dy).sum()
    return torch.stack([n, my, m2y])


def _pearson_moments(preds, y, w, spec):
    nym = _y_center_moments(y, w, spec)
    n, my = nym[0], nym[1]
    nz = _mean_divisor(n)
    w_ = torch.broadcast_to(w[None, :], preds.shape)
    x0 = torch.where(torch.isfinite(preds), preds, 0.0)
    mx = (x0 * w_).sum(-1) / nz  # [P]
    dx = x0 - mx[..., None]
    dxw = dx * w_  # weight first: padded ±3.4e38 preds contribute exact 0
    m2x = (dxw * dx).sum(-1)
    cxy = (dxw * (y - my)[None, :]).sum(-1)
    P = preds.shape[:-1]
    return torch.stack([
        torch.broadcast_to(n, P), mx, torch.broadcast_to(my, P),
        m2x, torch.broadcast_to(nym[2], P), cxy,
        _nonfinite_count(preds, w_),
    ], dim=-1)


def _chan_merge(n1, mean1, m2_1, n2, mean2, m2_2):
    """Chan's parallel combine of (count, mean, centered M2) pairs.
    Zero-count partials are identities (δ·n2/n selects the other side's
    mean; the M2 cross term vanishes)."""
    n = n1 + n2
    nz = _mean_divisor(n)
    delta = mean2 - mean1
    mean = mean1 + delta * n2 / nz
    m2 = m2_1 + m2_2 + delta * delta * n1 * n2 / nz
    return n, mean, m2, delta, nz


def _pearson_combine(m1, m2, spec):
    n1, n2 = m1[..., 0], m2[..., 0]
    n, mx, m2x, dx, nz = _chan_merge(n1, m1[..., 1], m1[..., 3],
                                     n2, m2[..., 1], m2[..., 3])
    _, my, m2y, dy, _ = _chan_merge(n1, m1[..., 2], m1[..., 4],
                                    n2, m2[..., 2], m2[..., 4])
    cxy = m1[..., 5] + m2[..., 5] + dx * dy * n1 * n2 / nz
    return torch.stack([n, mx, my, m2x, m2y, cxy, m1[..., 6] + m2[..., 6]], dim=-1)


def _pearson_reduce(m, spec):
    n = _mean_divisor(m[..., 0])
    mx, my = m[..., 1], m[..., 2]
    # centered M2 never cancels, but clamp defensively at 0
    var_x = torch.clamp(m[..., 3], min=0.0) / n
    var_y = torch.clamp(m[..., 4], min=0.0) / n
    cov = m[..., 5] / n
    floor = _f32(_VAR_NOISE_FLOOR)
    ok = ((var_x > torch.square(floor * mx))
          & (var_y > torch.square(floor * my))
          & (var_x > 0.0) & (var_y > 0.0))
    r2 = torch.where(ok, torch.clamp(torch.square(cov) / torch.clamp(
        var_x * var_y, min=_f32(1e-12)), 0.0, 1.0), 0.0)
    out = torch.where(m[..., 6] > 0, math.inf, 1.0 - r2)
    return torch.where(torch.isnan(out), math.inf, out)  # NaN must never win


def _r2_partial(preds, y, w, spec):
    """Exact centered single-pass 1 - R² (whole dataset in one call)."""
    w_ = w[None, :]
    n = _mean_divisor(w.sum())
    p0 = torch.where(torch.isfinite(preds), preds, 0.0)
    my = (y[None, :] * w_).sum(-1, keepdim=True) / n
    ss_tot = torch.clamp((torch.square(y[None, :] - my) * w_).sum(-1), min=_f32(1e-12))
    ss_res = (torch.square(p0 - y[None, :]) * w_).sum(-1)
    invalid = ((~torch.isfinite(preds)) & (w_ > 0)).any(-1)
    out = torch.where(invalid, math.inf, ss_res / ss_tot)
    return torch.where(torch.isnan(out), math.inf, out)


def _r2_moments(preds, y, w, spec):
    nym = _y_center_moments(y, w, spec)
    w_ = torch.broadcast_to(w[None, :], preds.shape)
    yb = torch.broadcast_to(y[None, :], preds.shape)
    x0 = torch.where(torch.isfinite(preds), preds, 0.0)
    err = (x0 - yb) * w_  # weight BEFORE squaring
    P = preds.shape[:-1]
    return torch.stack([
        torch.broadcast_to(nym[0], P), torch.broadcast_to(nym[1], P),
        torch.broadcast_to(nym[2], P), (err * (x0 - yb)).sum(-1),
        _nonfinite_count(preds, w_),
    ], dim=-1)


def _r2_combine(m1, m2, spec):
    n, my, m2y, _, _ = _chan_merge(m1[..., 0], m1[..., 1], m1[..., 2],
                                   m2[..., 0], m2[..., 1], m2[..., 2])
    return torch.stack([n, my, m2y, m1[..., 3] + m2[..., 3],
                        m1[..., 4] + m2[..., 4]], dim=-1)


def _r2_reduce(m, spec):
    ss_tot = torch.clamp(m[..., 2], min=_f32(1e-12))
    out = torch.where(m[..., 4] > 0, math.inf, m[..., 3] / ss_tot)
    return torch.where(torch.isnan(out), math.inf, out)  # NaN must never win


register_kernel(FitnessKernel(
    name=REGRESSION, aliases=("regression", "abs"), device_id=0,
    partial_fitness=_regression_partial,
    metric=lambda preds, y, spec: _mean((preds - y[None, :]).abs())))
register_kernel(FitnessKernel(
    name=CLASSIFY, aliases=("classify", "classification"), device_id=1,
    partial_fitness=_classify_partial, metric=_classify_metric))
register_kernel(FitnessKernel(
    name=MATCH, aliases=("match",), device_id=2,
    partial_fitness=_match_partial,
    metric=lambda preds, y, spec: _mean(
        ((preds - y[None, :]).abs() <= _f32(spec.precision)).float())))
register_kernel(FitnessKernel(
    name="mse", partial_fitness=_mse_partial, device_id=3,
    metric=lambda preds, y, spec: _mean(torch.square(preds - y[None, :]))))
register_kernel(FitnessKernel(
    name="pearson", n_moments=_PEARSON_MOMENTS, device_id=4,
    partial_fitness=_pearson_partial,
    moments=_pearson_moments, reduce_moments=_pearson_reduce,
    combine_moments=_pearson_combine,
    y_moments=_y_center_moments, y_moment_idx=_PEARSON_Y_IDX,
    metric=lambda preds, y, spec: _pearson_partial(
        preds, y, torch.ones_like(y, dtype=torch.float32), spec)))
register_kernel(FitnessKernel(
    name="r2", aliases=("r-squared",), n_moments=_R2_MOMENTS, device_id=5,
    partial_fitness=_r2_partial,
    moments=_r2_moments, reduce_moments=_r2_reduce,
    combine_moments=_r2_combine,
    y_moments=_y_center_moments, y_moment_idx=_R2_Y_IDX,
    metric=lambda preds, y, spec: 1.0 - _r2_partial(
        preds, y, torch.ones_like(y, dtype=torch.float32), spec)))


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


def fold_moment_partials(kern: FitnessKernel, parts, spec: FitnessSpec):
    """Merge a sequence of f32[..., M] moment partials (one per tile) into
    one, in order, via the kernel's merge."""
    total = parts[0]
    for p in parts[1:]:
        total = kern.merge_moments(total, p, spec)
    return total


def scatter_tree_y(kern: FitnessKernel, tree_m, y_m):
    """Reassemble a full f32[..., M] moment vector from the per-tree
    columns `tree_m` f32[..., Mt] and the hoisted tree-independent columns
    `y_m` f32[My] (broadcast across the leading axes): the inverse of
    slicing by `tree_moment_idx` / `y_moment_idx`."""
    lead = tree_m.shape[:-1]
    out = torch.zeros((*lead, kern.n_moments), dtype=tree_m.dtype, device=tree_m.device)
    out[..., list(kern.tree_moment_idx)] = tree_m
    out[..., list(kern.y_moment_idx)] = torch.broadcast_to(
        y_m, (*lead, len(kern.y_moment_idx))).to(tree_m.dtype)
    return out


def accuracy_from_preds(preds, y, spec: FitnessSpec):
    """Human-facing metric (fraction correct / mean abs err) for reporting."""
    return get_kernel(spec.kernel).metric(preds, y.to(torch.float32), spec)
