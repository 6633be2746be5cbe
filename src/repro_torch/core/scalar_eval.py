"""Paper-faithful scalar baseline — the "1-CPU_SP" configuration.

A numpy/Python copy of `repro/core/scalar_eval.py`. Karoo GP v0.9.1.6
evaluated each tree's SymPy expression once *per data point* (scalar
substitution), which is the slow baseline every figure in the paper
compares against. This module reproduces that execution model:
a recursive Python interpreter applied row by row, no vectorization, no
jit. It runs on the host by nature: the paper's baseline, asked for by
name (`backend="scalar"`), never chosen by `auto`. It exists so that the
same scalar-vs-vector axis the paper measures (Figs 1–3) can be measured
on the port.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core import primitives as prim
from repro_torch.core.fitness import FitnessSpec, fitness_from_preds

_EPS = 1e-9


def _apply(name: str, a, b):
    """One primitive in true float32 arithmetic (np.float32 operands stay
    f32 through + - * /), so protected-op branch decisions are bit-identical
    to the vectorized engine's."""
    f32 = np.float32
    a = f32(a)
    b = f32(b)
    if name == "add":
        return a + b
    if name == "sub":
        return a - b
    if name == "mul":
        return a * b
    if name == "div":
        return f32(1.0) if abs(b) < f32(_EPS) else a / b
    if name == "neg":
        return -a
    if name == "abs":
        return abs(a)
    if name == "sin":
        return f32(math.sin(a))
    if name == "cos":
        return f32(math.cos(a))
    if name == "sqrt":
        return f32(math.sqrt(abs(a)))
    if name == "log":
        return f32(math.log(abs(a) + f32(_EPS)))
    if name == "square":
        return a * a
    if name == "min":
        return min(a, b)
    if name == "max":
        return max(a, b)
    raise ValueError(name)


def eval_tree_scalar(op_row, arg_row, row, const_table, idx: int = 0) -> float:
    """Evaluate one heap tree on ONE data row, recursively (the baseline).

    Intermediates are rounded to float32 at every node so the baseline is
    numerically faithful to the vectorized engine (Karoo's TF ops are f32;
    comparing f64-vs-f32 interpreters would otherwise diverge around the
    protected-division threshold)."""
    o = int(op_row[idx])
    if o == prim.EMPTY:
        return 0.0
    if o == prim.CONST:
        return float(np.float32(const_table[int(arg_row[idx])]))
    if o == prim.FEATURE:
        return float(np.float32(row[int(arg_row[idx])]))
    p = prim.FUNCTIONS[o - 3]
    a = eval_tree_scalar(op_row, arg_row, row, const_table, 2 * idx + 1)
    b = eval_tree_scalar(op_row, arg_row, row, const_table, 2 * idx + 2) if p.arity == 2 else 0.0
    return float(np.float32(_apply(p.name, a, b)))


def eval_postfix_scalar(op_row, arg_row, row, const_table) -> float:
    """Evaluate one postfix stream on ONE data row with a list stack —
    the scalar oracle for the linear-genome interpreters. Same f32
    rounding discipline per node as `eval_tree_scalar`."""
    stack: list[float] = []
    for t in range(len(op_row)):
        o = int(op_row[t])
        if o == prim.EMPTY:
            break
        if o == prim.CONST:
            stack.append(float(np.float32(const_table[int(arg_row[t])])))
        elif o == prim.FEATURE:
            stack.append(float(np.float32(row[int(arg_row[t])])))
        else:
            p = prim.FUNCTIONS[o - 3]
            if p.arity == 1:
                a, b = stack.pop(), 0.0
            else:
                b = stack.pop()
                a = stack.pop()
            stack.append(float(np.float32(_apply(p.name, a, b))))
    return stack[0] if stack else 0.0


def evaluate_population_scalar(op, arg, X_rows, const_table,
                               genome: str = "tree") -> np.ndarray:
    """preds[p, d] via per-tree, per-row recursion. X_rows: [D, F] row-major
    (the paper's Eq. 1 layout — the un-transposed original)."""
    op = np.asarray(op)
    arg = np.asarray(arg)
    X_rows = np.asarray(X_rows)
    const_table = np.asarray(const_table)
    P, D = op.shape[0], X_rows.shape[0]
    one = eval_postfix_scalar if genome == "postfix" else eval_tree_scalar
    out = np.empty((P, D), np.float32)
    for p in range(P):
        for d in range(D):
            out[p, d] = one(op[p], arg[p], X_rows[d], const_table)
    return out


def fitness_scalar(op, arg, X_rows, y, const_table, kernel: str = "r",
                   n_classes: int = 3, precision: float = 1e-4,
                   weight=None, genome: str = "tree") -> np.ndarray:
    """Scalar-evaluated predictions reduced by the registered FitnessKernel
    (`core/fitness.fitness_from_preds` on CPU tensors: the reduction is
    negligible next to the per-point interpreter, and sharing the kernel
    registry keeps the NaN semantics identical across paths). `weight`
    masks dataset-padding rows (0.0 = padded), the same convention as the
    vectorized paths. Returns np.f32[P]."""
    preds = evaluate_population_scalar(op, arg, X_rows, const_table,
                                       genome=genome)
    spec = FitnessSpec(kernel, n_classes=n_classes, precision=precision)
    w = None if weight is None else torch.from_numpy(np.asarray(weight, np.float32))
    return fitness_from_preds(torch.from_numpy(preds),
                              torch.from_numpy(np.asarray(y, np.float32)), spec,
                              weight=w).numpy()
