"""Heap-tensor GP genomes + ramped half-and-half generation, in PyTorch.

Port of the heap half of `repro/core/trees.py`. A population is a pair
of int32 tensors

    op  : int32[pop, NODES]   opcode per slot (see primitives)
    arg : int32[pop, NODES]   feature index (FEATURE) or const index (CONST)

with NODES = 2**(max_depth+1) - 1 in heap order: node ``i`` has children
``2i+1``/``2i+2`` and depth ``floor(log2(i+1))``.

Well-formedness invariants (kept by generation and by every operator):
  I1  slot 0 (root) is never EMPTY;
  I2  a binary-function slot has both children non-EMPTY; a unary slot has
      a non-EMPTY left child and an EMPTY right child;
  I3  terminal (CONST/FEATURE) and EMPTY slots have EMPTY children;
  I4  slots at max depth hold terminals only.

Random draws use the port's threefry keys (`core/prng.py`), so the same
key gives the same population as the reference, bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import primitives as prim
from repro_torch.core import prng
from repro_torch.device import constant

# --- static index tables ----------------------------------------------------


def n_nodes(max_depth: int) -> int:
    return 2 ** (max_depth + 1) - 1


def depth_table(num_nodes: int) -> np.ndarray:
    """DEPTH[i] = depth of heap slot i."""
    return np.floor(np.log2(np.arange(num_nodes) + 1)).astype(np.int32)


# --- generation spec ---------------------------------------------------------

_GENOMES = ("tree",)  # "postfix" is ROADMAP queue A item 5


@dataclasses.dataclass(frozen=True)
class TreeSpec:
    """Static parameters of a tree population (hashable)."""

    max_depth: int = 5
    n_features: int = 2
    n_consts: int = 8
    fn_set: prim.FunctionSet = prim.ARITHMETIC
    p_const: float = 0.2  # probability a terminal is a constant
    grow_p_fn: float = 0.6  # probability an internal slot is a function (grow)
    genome: str = "tree"

    def __post_init__(self):
        if self.genome == "postfix":
            raise NotImplementedError(
                "genome='postfix' is not ported yet (ROADMAP queue A item 5, "
                "postfix genome)")
        if self.genome not in _GENOMES:
            raise ValueError(f"genome must be 'tree' or 'postfix', "
                             f"got {self.genome!r}")

    def __hash__(self):
        return hash((self.max_depth, self.n_features, self.n_consts,
                     tuple(self.fn_set.opcodes.tolist()), self.p_const,
                     self.grow_p_fn, self.genome))

    def __eq__(self, other):
        return isinstance(other, TreeSpec) and hash(self) == hash(other)

    @property
    def num_nodes(self) -> int:
        return n_nodes(self.max_depth)

    def const_table_numpy(self) -> np.ndarray:
        # Karoo-style integer constant terminals, symmetric around zero.
        half = self.n_consts // 2
        return np.concatenate([np.arange(1, half + 1),
                               -np.arange(1, self.n_consts - half + 1)]).astype(np.float32)

    def const_table(self, device="cpu") -> torch.Tensor:
        return constant(self.const_table_numpy(), device)


# --- random draws ------------------------------------------------------------


def _draw_terminal(key, shape, spec: TreeSpec):
    """Random terminal (op, arg) tensors of `shape`."""
    k1, k2, k3 = prng.split(key, 3)
    is_const = prng.bernoulli(k1, spec.p_const, shape)
    op = torch.where(is_const, prim.CONST, prim.FEATURE).to(torch.int32)
    feat = prng.randint(k2, shape, 0, spec.n_features)
    cons = prng.randint(k3, shape, 0, spec.n_consts)
    return op, torch.where(is_const, cons, feat)


def _draw_function(key, shape, spec: TreeSpec, binary_only: bool = False):
    """Random function opcode drawn from the spec's function set."""
    ops = spec.fn_set.binary_opcodes if binary_only else np.asarray(spec.fn_set.opcodes)
    idx = prng.randint(key, shape, 0, len(ops))
    return constant(ops, key.device, np.int32)[idx.long()]


def generate_population(key, pop: int, spec: TreeSpec):
    """Ramped half-and-half initial population (Karoo's `(r)amped` type).

    Trees get a ramp depth in [1, max_depth] and a method (full | grow),
    then grow top-down level by level over [pop, level_width]. Returns
    (op, arg): int32[pop, NODES] in heap layout, on the key's device."""
    N = spec.num_nodes
    D = spec.max_depth
    dev = key.device
    kd, km, kt = prng.split(key, 3)
    ramp_depth = prng.randint(kd, (pop,), 1, D + 1)  # per-tree depth ceiling
    full = prng.bernoulli(km, 0.5, (pop,))  # full vs grow
    arity_t = constant(prim.ARITY, dev)

    ops, args = [], []
    active = torch.ones((pop, 1), dtype=torch.bool, device=dev)
    keys = prng.split(kt, D + 1)
    for d in range(D + 1):
        w = 2 ** d
        kf, kg, kterm, _ = prng.split(keys[d], 4)
        at_ceiling = (d >= ramp_depth)[:, None]  # [pop, 1]
        grow = ~at_ceiling & prng.bernoulli(kg, spec.grow_p_fn, (pop, w))
        want_fn = torch.where(full[:, None], ~at_ceiling, grow)
        if d == 0:  # Karoo's min 3 nodes: the root is a function
            want_fn = torch.ones_like(want_fn)
        fn_op = _draw_function(kf, (pop, w), spec, binary_only=(d == 0))
        t_op, t_arg = _draw_terminal(kterm, (pop, w), spec)
        lvl_op = torch.where(want_fn, fn_op, t_op)
        lvl_arg = torch.where(want_fn, torch.zeros_like(t_arg), t_arg)
        lvl_op = torch.where(active, lvl_op, prim.EMPTY).to(torch.int32)
        lvl_arg = torch.where(active, lvl_arg, 0).to(torch.int32)
        ops.append(lvl_op)
        args.append(lvl_arg)
        if d < D:  # activate children
            arity = arity_t[lvl_op.long()]
            l_act = active & (arity >= 1)
            r_act = active & (arity == 2)
            active = torch.stack([l_act, r_act], dim=-1).reshape(pop, 2 * w)
    op, arg = torch.cat(ops, dim=1), torch.cat(args, dim=1)
    assert op.shape == (pop, N)
    return op, arg


# --- host-side pretty printing ----------------------------------------------


_INFIX_SYM = {"add": "+", "sub": "-", "mul": "*", "div": "/"}


def _terminal_str(o, a, feature_names, const_table) -> str:
    if o == prim.CONST:
        c = float(const_table[a]) if const_table is not None else a
        return f"{c:g}" if isinstance(c, float) else f"c{a}"
    return feature_names[a] if feature_names else f"x{a}"


def to_string(op_row, arg_row, feature_names=None, const_table=None,
              idx: int = 0, *, genome: str = "tree") -> str:
    """Render one heap genome row as an infix expression string (host)."""
    if genome != "tree":
        raise NotImplementedError(
            "postfix rendering is not ported yet (ROADMAP queue A item 5)")
    op_row = np.asarray(op_row.cpu() if torch.is_tensor(op_row) else op_row)
    arg_row = np.asarray(arg_row.cpu() if torch.is_tensor(arg_row) else arg_row)
    o = int(op_row[idx])
    if o == prim.EMPTY:
        return "∅"
    if o in (prim.CONST, prim.FEATURE):
        return _terminal_str(o, int(arg_row[idx]), feature_names, const_table)
    p = prim.FUNCTIONS[o - 3]
    lhs = to_string(op_row, arg_row, feature_names, const_table, 2 * idx + 1)
    if p.arity == 1:
        return f"{p.name}({lhs})"
    rhs = to_string(op_row, arg_row, feature_names, const_table, 2 * idx + 2)
    sym = _INFIX_SYM.get(p.name)
    return f"({lhs} {sym} {rhs})" if sym else f"{p.name}({lhs}, {rhs})"


def tree_sizes(op) -> torch.Tensor:
    """Number of non-EMPTY nodes per tree."""
    return (op != prim.EMPTY).sum(-1)


def check_invariants(op, spec: TreeSpec) -> None:
    """Assert heap well-formedness I1–I4 (host-side, used by tests)."""
    op = np.asarray(op.cpu() if torch.is_tensor(op) else op).reshape(-1, spec.num_nodes)
    assert ((op >= 0) & (op < len(prim.ARITY))).all(), "invalid opcode"
    N = spec.num_nodes
    depth = depth_table(N)
    arity = prim.ARITY[op]
    assert (op[:, 0] != prim.EMPTY).all(), "I1: empty root"
    for i in range((N - 1) // 2):
        l, r = op[:, 2 * i + 1], op[:, 2 * i + 2]
        a = arity[:, i]
        assert ((a < 1) | (l != prim.EMPTY)).all(), f"I2: missing left child of {i}"
        assert ((a < 2) | (r != prim.EMPTY)).all(), f"I2: missing right child of {i}"
        assert ((a == 2) | (r == prim.EMPTY)).all(), f"I2/I3: stray right child of {i}"
        assert ((a >= 1) | (l == prim.EMPTY)).all(), f"I3: stray left child of {i}"
    leaf = depth == spec.max_depth
    assert (prim.ARITY[op[:, leaf]] == 0).all(), "I4: function at max depth"
