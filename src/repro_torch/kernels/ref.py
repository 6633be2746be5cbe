"""Plain-PyTorch oracle for the fused GP eval+fitness kernel.

Port of `repro/kernels/ref.py` (heap genomes). The same contract as
kernels/ops.fitness (same padding/weighting semantics), built from the
level-sweep evaluator: the path the CUDA kernel is measured against.
"""
from __future__ import annotations

import torch

from repro_torch.core.eval import evaluate_population
from repro_torch.core.fitness import (FitnessSpec, fitness_from_preds, get_kernel,
                                      moments_from_preds)
from repro_torch.core.trees import TreeSpec


def fitness_ref(op, arg, X, y, const_table, tree_spec: TreeSpec, fit_spec: FitnessSpec,
                weight=None):
    """f32[P] fitness (minimize); weight masks out padded data points."""
    preds = evaluate_population(op, arg, X, const_table, tree_spec)
    return fitness_from_preds(preds, y, fit_spec, weight=weight)


def moments_ref(op, arg, X, y, const_table, tree_spec: TreeSpec, fit_spec: FitnessSpec,
                weight=None):
    """Phase 1 on the reference evaluator: f32[P, M] weighted moments."""
    preds = evaluate_population(op, arg, X, const_table, tree_spec)
    return moments_from_preds(preds, y, fit_spec, weight=weight)


def moments_ref_tiled(op, arg, X, y, const_table, tree_spec: TreeSpec,
                      fit_spec: FitnessSpec, weight=None, tile: int = 65536):
    """`moments_ref` over data tiles of `tile` columns, so the
    [pop, nodes, data] buffer never exceeds one tile; tile partials merge
    in order through the kernel's `merge_moments`. A caller's `weight`
    composes with the tile-padding mask (padded points weigh 0)."""
    kern = get_kernel(fit_spec.kernel)
    D = X.shape[1]
    if D <= tile:
        return moments_ref(op, arg, X, y, const_table, tree_spec, fit_spec,
                           weight=weight)
    w = torch.ones_like(y, dtype=torch.float32) if weight is None else weight.float()
    out = None
    for lo in range(0, D, tile):
        part = moments_ref(op, arg, X[:, lo:lo + tile], y[lo:lo + tile],
                           const_table, tree_spec, fit_spec, weight=w[lo:lo + tile])
        out = part if out is None else kern.merge_moments(out, part, fit_spec)
    return out


def fitness_ref_tiled(op, arg, X, y, const_table, tree_spec: TreeSpec,
                      fit_spec: FitnessSpec, weight=None, tile: int = 65536):
    """`fitness_ref`, tiled over data: merge the moment partials per tile,
    then finalize once."""
    kern = get_kernel(fit_spec.kernel)
    if X.shape[1] <= tile:
        return fitness_ref(op, arg, X, y, const_table, tree_spec, fit_spec,
                           weight=weight)
    m = moments_ref_tiled(op, arg, X, y, const_table, tree_spec, fit_spec,
                          weight=weight, tile=tile)
    return kern.reduce_moments(m, fit_spec)
