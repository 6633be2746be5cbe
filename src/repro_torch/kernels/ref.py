"""Plain-PyTorch oracle for the fused GP eval+fitness kernels.

Port of `repro/kernels/ref.py`. The same contract as kernels/ops.fitness
(same padding/weighting semantics), built from the plain evaluators: the
path the CUDA kernels are measured against.

Every entry point takes `dedup`/`dedup_cap`: any value other than
``"off"`` engages the exact-tier population-wide subexpression dedup
(core/eval.make_postfix_evaluator) for postfix genomes, with
predictions, moments and fitness bitwise those of dedup-off. Heap
genomes ignore the flag. The dedup plan is built once per call and
shared by every data tile.
"""
from __future__ import annotations

import torch

from repro_torch.core.eval import make_postfix_evaluator
from repro_torch.core.fitness import (FitnessSpec, fitness_from_preds, get_kernel,
                                      moments_from_preds)
from repro_torch.core.trees import TreeSpec


def fitness_ref(op, arg, X, y, const_table, tree_spec: TreeSpec, fit_spec: FitnessSpec,
                weight=None, dedup: str = "off", dedup_cap: int = 0):
    """f32[P] fitness (minimize); weight masks out padded data points."""
    ev = make_postfix_evaluator(op, arg, const_table, tree_spec, dedup=dedup,
                                dedup_cap=dedup_cap)
    return fitness_from_preds(ev(X), y, fit_spec, weight=weight)


def moments_ref(op, arg, X, y, const_table, tree_spec: TreeSpec, fit_spec: FitnessSpec,
                weight=None, dedup: str = "off", dedup_cap: int = 0):
    """Phase 1 on the reference evaluator: f32[P, M] weighted moments."""
    ev = make_postfix_evaluator(op, arg, const_table, tree_spec, dedup=dedup,
                                dedup_cap=dedup_cap)
    return moments_from_preds(ev(X), y, fit_spec, weight=weight)


def moments_tiled(preds_of, D: int, y, fit_spec: FitnessSpec, weight=None,
                  tile: int = 65536):
    """f32[P, M] moments over data tiles of `tile` columns, merged in order
    through the kernel's `merge_moments`; `preds_of(lo, hi)` gives the
    predictions f32[P, hi - lo] of columns [lo, hi). A caller's `weight`
    composes with the tile-padding mask (padded points weigh 0)."""
    if D <= tile:
        return moments_from_preds(preds_of(0, D), y, fit_spec, weight=weight)
    kern = get_kernel(fit_spec.kernel)
    w = torch.ones_like(y, dtype=torch.float32) if weight is None else weight.float()
    out = None
    for lo in range(0, D, tile):
        hi = min(lo + tile, D)
        part = moments_from_preds(preds_of(lo, hi), y[lo:hi], fit_spec, weight=w[lo:hi])
        out = part if out is None else kern.merge_moments(out, part, fit_spec)
    return out


def moments_ref_tiled(op, arg, X, y, const_table, tree_spec: TreeSpec,
                      fit_spec: FitnessSpec, weight=None, tile: int = 65536,
                      dedup: str = "off", dedup_cap: int = 0):
    """`moments_ref` over data tiles of `tile` columns, so the
    [pop, nodes, data] buffer never exceeds one tile; tile partials merge
    in order (`moments_tiled`). The dedup plan, when engaged, is built
    once: it depends on the genomes only."""
    ev = make_postfix_evaluator(op, arg, const_table, tree_spec, dedup=dedup,
                                dedup_cap=dedup_cap)
    return moments_tiled(lambda lo, hi: ev(X[:, lo:hi]), X.shape[1], y, fit_spec,
                         weight=weight, tile=tile)


def fitness_ref_tiled(op, arg, X, y, const_table, tree_spec: TreeSpec,
                      fit_spec: FitnessSpec, weight=None, tile: int = 65536,
                      dedup: str = "off", dedup_cap: int = 0):
    """`fitness_ref`, tiled over data: merge the moment partials per tile,
    then finalize once."""
    kern = get_kernel(fit_spec.kernel)
    if X.shape[1] <= tile:
        return fitness_ref(op, arg, X, y, const_table, tree_spec, fit_spec,
                           weight=weight, dedup=dedup, dedup_cap=dedup_cap)
    m = moments_ref_tiled(op, arg, X, y, const_table, tree_spec, fit_spec,
                          weight=weight, tile=tile, dedup=dedup, dedup_cap=dedup_cap)
    return kern.reduce_moments(m, fit_spec)
