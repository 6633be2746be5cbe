"""Vectorized population evaluation — the paper's core technique, in PyTorch.

Port of `repro/core/eval.py`. A heap population is evaluated by one
level-synchronous sweep over the heap encoding:

    for level d = max_depth .. 0:
        node_val[d] = select(opcode, f(child_vals[d+1]), terminal_vals)

Every step is an elementwise select over a [pop, 2**d, data] block. This
module is the plain tensor path; kernels/gp_eval.py is the CUDA kernel
that fuses the same evaluation with the fitness reduction, and
kernels/ref.py uses these functions as the kernel's oracle.

A postfix population runs a stack machine over its instruction slots
(`evaluate_population_postfix`), and the dedup layer below evaluates
each distinct subexpression of the population once. All three apply
the same f32 primitive to the same operand values per node, so the
three give bitwise-equal predictions for the same trees.

Predictions are computed for every data column, padded or not; padding
is masked one layer up by the `weight: f32[D]` vector.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import primitives as prim
from repro_torch.core import trees as trees_mod
from repro_torch.core.trees import TreeSpec
from repro_torch.device import constant


def evaluate_population(op, arg, X, const_table, spec: TreeSpec):
    """Evaluate every tree against every data point.

    op, arg:     int32[P, N]        heap population
    X:           float[F, D]        feature-major data (the paper's Eq. 2 layout)
    const_table: float[C]
    returns      float32[P, D]      predictions

    Dispatches on spec.genome: heap populations run the level sweep,
    postfix ones the stack machine (`evaluate_population_postfix`).
    """
    if spec.genome == "postfix":
        return evaluate_population_postfix(op, arg, X, const_table, spec)
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


def evaluate_population_postfix(op, arg, X, const_table, spec: TreeSpec):
    """Stack-machine evaluation of postfix populations: the plain version
    of the B2 kernel (kernels/gp_eval.py).

    One pass over all N instruction slots carries an operand stack
    f32[P, stack_size, D] (slot 0 = top): terminals shift-push their
    value, unary functions replace the top, binary functions fold the
    top two and shift up, EMPTY slots hold the stack. All-EMPTY rows
    stay 0.0, as on the heap path."""
    P, N = op.shape
    D = X.shape[1]
    S = spec.stack_size
    X = X.float()
    const_table = const_table.float()
    arity_t = constant(prim.ARITY, op.device)
    op_l, arg_l = op.long(), arg.long()
    stack = torch.zeros((P, S, D), dtype=torch.float32, device=X.device)
    for t in range(N):
        opt, argt = op_l[:, t], arg_l[:, t]
        feat = X[argt.clamp(0, X.shape[0] - 1)]  # [P, D]
        cons = const_table[argt.clamp(0, const_table.shape[0] - 1)][:, None]
        tval = torch.where((opt == prim.FEATURE)[:, None], feat, cons.expand(P, D))
        top = stack[:, 0]
        ar = arity_t[opt]
        lhs = torch.where((ar == 2)[:, None], stack[:, 1], top)
        fnv = prim.apply_function(opt[:, None], lhs, top, spec.fn_set)
        push = torch.cat([tval[:, None], stack[:, :S - 1]], dim=1)
        una = torch.cat([fnv[:, None], stack[:, 1:]], dim=1)
        binr = torch.cat([fnv[:, None], stack[:, 2:],
                          torch.zeros_like(stack[:, :1])], dim=1)
        a = ar[:, None, None]
        new = torch.where(a == 0, push, torch.where(a == 1, una, binr))
        stack = torch.where((opt == prim.EMPTY)[:, None, None], stack, new)
    return stack[:, 0]


def evaluate_tree(op_row, arg_row, X, const_table, spec: TreeSpec):
    """Single-tree convenience wrapper (used by tests/examples)."""
    return evaluate_population(op_row[None], arg_row[None], X, const_table, spec)[0]


# --- population-wide subexpression dedup (exact tier) ---------------------------
#
# Crossover copies subtrees verbatim, so one subexpression is evaluated
# many times a generation. This layer enumerates every postfix subtree
# span, canonicalizes each to a packed int32 signature
# (trees.subtree_signatures), dedups across the whole [P, N] population
# with one lexicographic sort, evaluates one representative per distinct
# subexpression (operands always have shorter spans, so span length is a
# topological order) and gathers each tree's root value. Each unique
# node applies the same primitive to the same operand bits as the stack
# machine, so predictions are bitwise those of dedup-off. Every buffer
# has a fixed shape: `cap` bounds the unique table, slot `cap - 1` is
# kept for the all-EMPTY row root, and `overflow` (n_unique > cap - 1)
# selects the plain interpreter instead.


class DedupPlan(NamedTuple):
    """Fixed-shape per-generation dedup schedule (on the population's
    device).

    uop/uarg/ulen: int32[cap]  opcode / terminal arg / span length of each
                               unique slot's representative (EMPTY/0 past
                               `n_unique` and in the reserved last slot)
    ulhs/urhs:     int32[cap]  unique-slot ids of the operands (binary:
                               left/right; unary: both the operand;
                               terminals: 0, never read)
    root:          int32[P]    unique-slot id of each tree's value (slot
                               cap - 1 for all-EMPTY rows, which stays 0.0)
    n_unique:      int32[]     distinct active subexpressions
    total:         int32[]     active subtree instances
    overflow:      bool[]      n_unique exceeds the usable cap - 1
    """

    uop: torch.Tensor
    uarg: torch.Tensor
    ulhs: torch.Tensor
    urhs: torch.Tensor
    ulen: torch.Tensor
    root: torch.Tensor
    n_unique: torch.Tensor
    total: torch.Tensor
    overflow: torch.Tensor


def resolve_dedup_cap(dedup_cap: int, pop: int, num_nodes: int) -> int:
    """Unique-table capacity: an explicit `dedup_cap > 0` wins, otherwise
    max(64, pop); clamped to the P*N + 1 slots any population can fill
    (+1 for the reserved all-EMPTY slot)."""
    cap = dedup_cap if dedup_cap > 0 else max(64, pop)
    return int(min(cap, pop * num_nodes + 1))


def _sorted_signatures(op, arg, spec: TreeSpec):
    """(s_pos, is_new, active): the flat positions of the population's
    subtree signatures in lexicographic (signature words, position)
    order, whether each sorted entry starts a new signature, and the
    flat active mask.

    PyTorch has no multi-key sort, so this is the radix form of the
    reference's `lax.sort(num_keys=W+1)`: stable sorts from the last key
    to the first, starting from position order. The words are
    non-negative and below 2**30, so two of them pack into one int64 key
    without changing the order, which halves the sorts."""
    P, N = op.shape
    T = P * N
    sig = trees_mod.subtree_signatures(op, arg, spec).reshape(T, -1).long()
    W = sig.shape[1]
    if W % 2:
        sig = torch.cat([sig, torch.zeros_like(sig[:, :1])], dim=1)
    keys = (sig[:, 0::2] << 30) | sig[:, 1::2]  # [T, ceil(W/2)]
    s_pos = torch.arange(T, device=op.device)
    for k in range(keys.shape[1] - 1, -1, -1):
        _, o = torch.sort(keys[s_pos, k], stable=True)
        s_pos = s_pos[o]
    s_keys = keys[s_pos]
    is_new = torch.ones(T, dtype=torch.bool, device=op.device)
    is_new[1:] = (s_keys[1:] != s_keys[:-1]).any(-1)
    return s_pos, is_new, (op != prim.EMPTY).reshape(T)


def build_dedup_plan(op, arg, spec: TreeSpec, cap: int) -> DedupPlan:
    """Canonicalize + sort + unique the population's subtree spans into a
    fixed-shape evaluation schedule; no value is read back to the host.
    Segment heads of the sorted signatures become unique slots, the
    first occurrence (lowest flat position) being the representative."""
    P, N = op.shape
    T = P * N
    dev = op.device
    s_pos, is_new, active = _sorted_signatures(op, arg, spec)
    new_u = is_new & active[s_pos]  # all-zero (inactive) signatures sort first
    uid_s = (torch.cumsum(new_u, 0) - 1).to(torch.int32)
    n_unique = new_u.sum().to(torch.int32)
    total = active.sum().to(torch.int32)
    # flat position -> unique id (-1 on inactive positions, never read)
    inv = torch.empty(T, dtype=torch.int32, device=dev)
    inv[s_pos] = uid_s
    # unique id -> representative flat position; slot `cap` collects the
    # entries that are not heads or do not fit, and is dropped
    dst = torch.where(new_u & (uid_s < cap), uid_s, cap).long()
    rep = torch.zeros(cap + 1, dtype=torch.int64, device=dev)
    rep.scatter_(0, dst, s_pos)
    rep = rep[:cap]

    slot = torch.arange(cap, device=dev)
    valid = slot < n_unique
    rp, ri = rep // N, rep % N
    start = trees_mod.subtree_spans(op)
    length = torch.arange(N, dtype=torch.int32, device=dev) - start + 1
    lhs_i = trees_mod.postfix_lhs_index(op)
    uop = torch.where(valid, op[rp, ri], prim.EMPTY).to(torch.int32)
    uar = constant(prim.ARITY, dev)[uop.long()]
    uarg = torch.where(valid & (uar == 0), arg[rp, ri], 0).to(torch.int32)
    ulen = torch.where(valid, length[rp, ri], 0).to(torch.int32)

    def inv_at(flat_pos):
        return inv[flat_pos.clamp(0, T - 1)]

    # the right operand of any function ends at i-1; the left operand of a
    # binary ends where the right one starts, minus one
    urhs = torch.where(uar >= 1, inv_at(rp * N + ri - 1), 0).to(torch.int32)
    ulhs = torch.where(uar == 2, inv_at(rp * N + lhs_i[rp, ri].long()),
                       urhs).to(torch.int32)

    row_len = (op != prim.EMPTY).sum(1)
    root_pos = torch.arange(P, device=dev) * N + (row_len - 1).clamp_min(0)
    root = torch.where(row_len > 0, inv[root_pos], cap - 1).to(torch.int32)
    return DedupPlan(uop, uarg, ulhs, urhs, ulen, root, n_unique, total,
                     n_unique > cap - 1)


def evaluate_unique_subtrees(plan: DedupPlan, X, const_table, spec: TreeSpec):
    """f32[cap, D] value of every unique subexpression (0.0 on unused
    slots): the plain version of the unique-table kernel
    (kernels/gp_eval.py). Slots are evaluated one span length at a time,
    shortest first, so every operand is final when it is read; each slot
    gets the stack machine's terminal lookup or primitive on the same
    operand bits. The lengths present are read on the host, so on a CUDA
    tensor this synchronises (the card's path uses the kernel)."""
    X = X.float()
    const_table = const_table.float()
    uarg = plan.uarg.long()
    feat = X[uarg.clamp(0, X.shape[0] - 1)]  # [cap, D]
    cons = const_table[uarg.clamp(0, const_table.shape[0] - 1)][:, None]
    tval = torch.where((plan.uop == prim.FEATURE)[:, None], feat, cons.expand_as(feat))
    vals = torch.where((plan.ulen == 1)[:, None], tval, 0.0)
    cap = vals.shape[0]
    ulhs = plan.ulhs.long().clamp(0, cap - 1)  # operand ids past the cap
    urhs = plan.urhs.long().clamp(0, cap - 1)  # (overflow) clamp, as a gather does
    ulen = plan.ulen.cpu().numpy()
    for lvl in np.unique(ulen[ulen >= 2]):
        rows = torch.from_numpy(np.flatnonzero(ulen == lvl)).to(vals.device)
        vals[rows] = prim.apply_function(plan.uop[rows, None], vals[ulhs[rows]],
                                         vals[urhs[rows]], spec.fn_set)
    return vals


def evaluate_population_dedup(op, arg, X, const_table, spec: TreeSpec, cap: int):
    """`evaluate_population_postfix` with population-wide subexpression
    dedup: each distinct subtree evaluated once, roots gathered. Bitwise
    the same predictions; on overflow the plain interpreter runs."""
    return make_postfix_evaluator(op, arg, const_table, spec, dedup="exact",
                                  dedup_cap=cap)(X)


def make_postfix_evaluator(op, arg, const_table, spec: TreeSpec,
                           dedup: str = "off", dedup_cap: int = 0):
    """Closure ``X -> f32[P, D]`` with the dedup plan built once, so the
    tiled paths (kernels/ref.py) reuse one plan for every data tile. Any
    ``dedup != "off"`` engages the exact tier (the semantic tier adds
    cache keys in the engine); heap genomes always take the plain
    evaluator. The overflow flag is read on the host: this is the plain
    path, and the card's (kernels/ops.py) selects on the device."""
    if dedup == "off" or spec.genome != "postfix":
        return lambda X: evaluate_population(op, arg, X, const_table, spec)
    cap = resolve_dedup_cap(dedup_cap, *op.shape)
    plan = build_dedup_plan(op, arg, spec, cap)

    def ev(X):
        if bool(plan.overflow):
            return evaluate_population_postfix(op, arg, X, const_table, spec)
        return evaluate_unique_subtrees(plan, X, const_table, spec)[plan.root.long()]

    return ev


def dedup_stats(op, arg, spec: TreeSpec, cap: int):
    """(unique_subtrees, subtree_evals_saved) int32 scalars for the
    telemetry counter stream: the signature sort without the schedule.
    `saved` is 0 when the unique table would overflow (the plain
    interpreter then runs)."""
    s_pos, is_new, active = _sorted_signatures(op, arg, spec)
    n_unique = (is_new & active[s_pos]).sum().to(torch.int32)
    total = active.sum().to(torch.int32)
    saved = torch.where(n_unique > cap - 1, 0, total - n_unique).to(torch.int32)
    return n_unique, saved
