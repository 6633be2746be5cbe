"""Vectorized population evaluation — the paper's core technique, in PyTorch.

Port of the heap half of `repro/core/eval.py`. The whole population is
evaluated by one level-synchronous sweep over the heap encoding:

    for level d = max_depth .. 0:
        node_val[d] = select(opcode, f(child_vals[d+1]), terminal_vals)

Every step is an elementwise select over a [pop, 2**d, data] block. This
module is the plain tensor path; kernels/gp_eval.py is the CUDA kernel
that fuses the same evaluation with the fitness reduction, and
kernels/ref.py uses these functions as the kernel's oracle.

Predictions are computed for every data column, padded or not; padding
is masked one layer up by the `weight: f32[D]` vector.
"""
from __future__ import annotations

import torch

from repro_torch.core import primitives as prim
from repro_torch.core.trees import TreeSpec


def evaluate_population(op, arg, X, const_table, spec: TreeSpec):
    """Evaluate every tree against every data point.

    op, arg:     int32[P, N]        heap population
    X:           float[F, D]        feature-major data (the paper's Eq. 2 layout)
    const_table: float[C]
    returns      float32[P, D]      predictions
    """
    if spec.genome != "tree":
        raise NotImplementedError("postfix evaluation is not ported yet "
                                  "(ROADMAP queue A item 5)")
    P, N = op.shape
    D = X.shape[1]
    max_depth = (N + 1).bit_length() - 2
    X = X.float()
    const_table = const_table.float()
    op = op.long()
    arg = arg.long()

    vals = None  # child-level buffer [P, 2**(d+1), D]
    for d in range(max_depth, -1, -1):
        lo, w = 2**d - 1, 2**d
        opd = op[:, lo:lo + w, None]  # [P, w, 1]
        argd = arg[:, lo:lo + w]
        feat = X[argd.clamp(0, X.shape[0] - 1)]  # [P, w, D] gather
        cons = const_table[argd.clamp(0, const_table.shape[0] - 1)][..., None]
        node = torch.where(opd == prim.FEATURE, feat, cons.expand(P, w, D))
        if vals is not None:
            lhs, rhs = vals[:, 0::2], vals[:, 1::2]
            fn = prim.apply_function(opd, lhs, rhs, spec.fn_set)
            node = torch.where(opd >= 3, fn, node)
        node = torch.where(opd == prim.EMPTY, 0.0, node)
        vals = node
    return vals[:, 0]  # [P, D]


def evaluate_tree(op_row, arg_row, X, const_table, spec: TreeSpec):
    """Single-tree convenience wrapper (used by tests/examples)."""
    return evaluate_population(op_row[None], arg_row[None], X, const_table, spec)[0]
