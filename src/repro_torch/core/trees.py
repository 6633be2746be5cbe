"""GP genome representations + ramped half-and-half generation, in PyTorch.

Port of `repro/core/trees.py`. A population is a pair of int32 tensors

    op  : int32[pop, NODES]   opcode per slot (see primitives)
    arg : int32[pop, NODES]   feature index (FEATURE) or const index (CONST)

with NODES = 2**(max_depth+1) - 1, read in one of two forms selected by
``TreeSpec.genome``:

``genome="tree"``: heap order, node ``i`` has children ``2i+1``/``2i+2``
and depth ``floor(log2(i+1))``. Invariants (kept by generation and by
every operator):
  I1  slot 0 (root) is never EMPTY;
  I2  a binary-function slot has both children non-EMPTY; a unary slot has
      a non-EMPTY left child and an EMPTY right child;
  I3  terminal (CONST/FEATURE) and EMPTY slots have EMPTY children;
  I4  slots at max depth hold terminals only.

``genome="postfix"``: each row is a postfix instruction stream (terminals
push, functions pop their operands and push the result), padded with
EMPTY after the program's active length. Invariants:
  P1  the active program is a contiguous non-EMPTY prefix (length >= 1);
  P2  the first instruction is a terminal;
  P3  the running stack depth S(t) = cumsum(1 - arity) stays >= 1 on the
      active prefix;
  P4  S(len-1) == 1 (exactly one result remains);
  P5  max S(t) <= TreeSpec.stack_size = max_depth + 1.

Random draws use the port's threefry keys (`core/prng.py`), so the same
key gives the same population as the reference, bit for bit, in either
form; the subexpression signatures of the dedup layer are bitwise the
reference's too.
"""
from __future__ import annotations

import dataclasses
import functools

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


def subtree_mask_table(num_nodes: int) -> np.ndarray:
    """MASK[i, j] = True iff j is i or a descendant of i."""
    depth = depth_table(num_nodes)
    i = np.arange(num_nodes)[:, None] + 1  # 1-based
    j = np.arange(num_nodes)[None, :] + 1
    k = depth[None, :] - depth[:, None]  # relative depth of j under i
    anc = np.where(k >= 0, j >> np.maximum(k, 0), -1)
    return (anc == i) & (k >= 0)


# --- generation spec ---------------------------------------------------------

_GENOMES = ("tree", "postfix")


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

    @property
    def stack_size(self) -> int:
        """Operand-stack bound of the postfix interpreters (P5): postorder
        evaluation of a tree within the depth ceiling needs at most
        max_depth + 1 live operands, and the splice operators reject
        offspring that would need more."""
        return self.max_depth + 1

    def const_table_numpy(self) -> np.ndarray:
        # Karoo-style integer constant terminals, symmetric around zero.
        half = self.n_consts // 2
        return np.concatenate([np.arange(1, half + 1),
                               -np.arange(1, self.n_consts - half + 1)]).astype(np.float32)

    def const_table(self, device="cpu") -> torch.Tensor:
        return constant(self.const_table_numpy(), device)


# --- random draws ------------------------------------------------------------


def _draw_terminal(key, shape, spec: TreeSpec):
    """Random terminal (op, arg) tensors of `shape` (rows of a batch of
    keys merged)."""
    k1, k2, k3 = prng.split(key, 3).unbind(-2)
    is_const = prng.merge_rows(key, prng.bernoulli(k1, spec.p_const, shape))
    op = torch.where(is_const, prim.CONST, prim.FEATURE).to(torch.int32)
    feat = prng.merge_rows(key, prng.randint(k2, shape, 0, spec.n_features))
    cons = prng.merge_rows(key, prng.randint(k3, shape, 0, spec.n_consts))
    return op, torch.where(is_const, cons, feat)


def _draw_function(key, shape, spec: TreeSpec, binary_only: bool = False):
    """Random function opcode drawn from the spec's function set."""
    ops = spec.fn_set.binary_opcodes if binary_only else np.asarray(spec.fn_set.opcodes)
    idx = prng.merge_rows(key, prng.randint(key, shape, 0, len(ops)))
    return constant(ops, key.device, np.int32)[idx.long()]


def generate_population(key, pop: int, spec: TreeSpec):
    """Ramped half-and-half initial population (Karoo's `(r)amped` type).

    Trees get a ramp depth in [1, max_depth] and a method (full | grow),
    then grow top-down level by level over [pop, level_width]. Returns
    (op, arg): int32[pop, NODES] on the key's device, in the spec's
    genome form: the heap draw, converted to postfix streams when
    spec.genome == "postfix" (the same trees from the same key). A batch
    of keys [I, 2] draws `pop` trees from each: int32[I·pop, NODES], row
    block i the single-key draw on key i."""
    N = spec.num_nodes
    D = spec.max_depth
    dev = key.device
    kd, km, kt = prng.split(key, 3).unbind(-2)
    # per-tree depth ceiling, and full vs grow
    ramp_depth = prng.merge_rows(key, prng.randint(kd, (pop,), 1, D + 1))
    full = prng.merge_rows(key, prng.bernoulli(km, 0.5, (pop,)))
    arity_t = constant(prim.ARITY, dev)
    rows = pop * prng.n_keys(key)

    ops, args = [], []
    active = torch.ones((rows, 1), dtype=torch.bool, device=dev)
    keys = prng.split(kt, D + 1)
    for d in range(D + 1):
        w = 2 ** d
        kf, kg, kterm, _ = prng.split(keys[..., d, :], 4).unbind(-2)
        at_ceiling = (d >= ramp_depth)[:, None]  # [rows, 1]
        grow = ~at_ceiling & prng.merge_rows(key, prng.bernoulli(kg, spec.grow_p_fn,
                                                                 (pop, w)))
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
            active = torch.stack([l_act, r_act], dim=-1).reshape(rows, 2 * w)
    op, arg = torch.cat(ops, dim=1), torch.cat(args, dim=1)
    assert op.shape == (rows, N)
    if spec.genome == "postfix":
        return heap_to_postfix(op, arg)
    return op, arg


# --- postfix linear genomes ---------------------------------------------------


def postorder_table(num_nodes: int) -> np.ndarray:
    """PO[i] = postorder rank of heap slot i over the full complete heap.
    Pruning removes whole subtrees, so a pruned tree's own postorder is
    this order filtered to its active slots."""
    pos = np.zeros(num_nodes, np.int32)
    counter = 0

    def visit(i):
        nonlocal counter
        if i >= num_nodes:
            return
        visit(2 * i + 1)
        visit(2 * i + 2)
        pos[i] = counter
        counter += 1

    visit(0)
    return pos


@functools.lru_cache(maxsize=None)
def postorder_slots(num_nodes: int) -> np.ndarray:
    """The heap slots in full-heap postorder, argsort(postorder_table(N)):
    read-only int32[N]. A heap row read in this order and compacted to its
    non-EMPTY slots is its tree's postfix program (`heap_to_postfix`; the
    B1 kernel loads its rows this way)."""
    slots = np.argsort(postorder_table(num_nodes)).astype(np.int32)
    slots.flags.writeable = False
    return slots


def heap_to_postfix(op, arg):
    """Heap populations -> postfix streams, int32[..., N] -> int32[..., N].

    Per row: permute the slots into full-heap postorder, then move the
    non-EMPTY entries to the front in order (rank = running count of
    active slots); the EMPTY tail pads to N."""
    N = op.shape[-1]
    lead = op.shape[:-1]
    perm = constant(postorder_slots(N), op.device, np.int64)
    op_po = op.reshape(-1, N)[:, perm]
    arg_po = arg.reshape(-1, N)[:, perm]
    active = op_po != prim.EMPTY
    rank = torch.where(active, torch.cumsum(active, -1) - 1, N)
    out_op = torch.zeros((op_po.shape[0], N + 1), dtype=torch.int32, device=op.device)
    out_arg = torch.zeros_like(out_op)
    # column N collects the inactive slots and is dropped
    out_op.scatter_(1, rank, op_po.to(torch.int32))
    out_arg.scatter_(1, rank, arg_po.to(torch.int32))
    return (out_op[:, :N].reshape(*lead, N).contiguous(),
            out_arg[:, :N].reshape(*lead, N).contiguous())


def postfix_to_heap(op, arg, spec: TreeSpec):
    """Postfix populations -> heap trees (host; tests and the parity
    oracle). Raises ValueError on malformed streams or on programs too
    deep for the heap's max_depth (spliced postfix genomes may exceed it:
    only depth-bounded programs round-trip)."""
    op = _host(op)
    op = op.reshape(-1, op.shape[-1])
    arg = _host(arg).reshape(-1, op.shape[-1])
    P, N = op.shape
    out_op = np.zeros((P, N), np.int32)
    out_arg = np.zeros((P, N), np.int32)
    for p in range(P):
        stack = []
        for t in range(N):
            o = int(op[p, t])
            if o == prim.EMPTY:
                break
            a = int(prim.ARITY[o])
            if a == 0:
                stack.append((o, int(arg[p, t]), None, None))
            elif a == 1:
                if not stack:
                    raise ValueError(f"row {p}: unary op at {t} with empty stack")
                stack.append((o, 0, stack.pop(), None))
            else:
                if len(stack) < 2:
                    raise ValueError(f"row {p}: binary op at {t} underflows")
                r = stack.pop()
                stack.append((o, 0, stack.pop(), r))
        if len(stack) != 1:
            raise ValueError(f"row {p}: postfix stream leaves {len(stack)} "
                             f"values on the stack (want 1)")

        def place(node, idx):
            if idx >= N:
                raise ValueError(f"row {p}: program deeper than "
                                 f"max_depth={spec.max_depth}; it has no heap "
                                 f"form (postfix-only genome)")
            o, a, l_, r = node
            out_op[p, idx] = o
            out_arg[p, idx] = a
            if l_ is not None:
                place(l_, 2 * idx + 1)
            if r is not None:
                place(r, 2 * idx + 2)

        place(stack[0], 0)
    return out_op, out_arg


def postfix_stack_depths(op) -> torch.Tensor:
    """S int32[..., N]: running operand-stack depth after each instruction
    (cumsum of 1 - arity). Meaningful on the active prefix only: EMPTY
    slots add +1 each."""
    ar = constant(prim.ARITY, op.device)[op.long()]
    return torch.cumsum(1 - ar, dim=-1).to(torch.int32)


def subtree_spans(op) -> torch.Tensor:
    """start int32[..., N]: for each position i, where the subexpression
    ending at i begins: right after the last t < i whose running depth
    S(t) is below S(i) (0 when there is none). O(N^2) per row. Values
    beyond a row's active length are garbage; callers read active slots
    only."""
    N = op.shape[-1]
    S = postfix_stack_depths(op)
    t = torch.arange(N, dtype=torch.int32, device=op.device)
    below = (t[None, :] < t[:, None]) & (S[..., None, :] < S[..., :, None])
    last = torch.where(below, t, -1).amax(dim=-1)
    return (last + 1).to(torch.int32)


def postfix_lhs_index(op) -> torch.Tensor:
    """lhs int32[..., N]: for a binary function at i, the position of its
    left operand's result, start(i-1) - 1 (the right operand always ends
    at i-1). Garbage on other slots; readers take it for binaries only."""
    start = subtree_spans(op)
    return torch.cat([torch.zeros_like(start[..., :1]), start[..., :-1] - 1], dim=-1)


# --- subexpression signatures (population-wide dedup, core/eval.py) ----------


def signature_geometry(spec: TreeSpec, num_nodes: int) -> tuple[int, int, int]:
    """(bits, per_word, n_words) of the packed subtree signature.

    A subexpression's canonical form is its postfix token stream with
    terminal arguments embedded: token code = 1 + op*K + arg (arg for
    terminals only; K = max(n_features, n_consts)), 0 for "no token".
    Codes are < 2**bits, and `per_word = 30 // bits` of them pack into
    one non-negative int32 word, so equal words <=> equal streams <=> the
    same subexpression."""
    K = max(spec.n_features, spec.n_consts, 1)
    bits = (prim.N_OPCODES * K).bit_length()
    per_word = 30 // bits
    if per_word < 1:
        raise ValueError(
            f"subexpression signatures need token codes <= 30 bits; "
            f"n_features/n_consts = {spec.n_features}/{spec.n_consts} "
            f"needs {bits}")
    return bits, per_word, -(-num_nodes // per_word)


def subtree_signatures(op, arg, spec: TreeSpec) -> torch.Tensor:
    """int32[P, N, W] packed canonical signature of the subexpression
    ending at every position of every postfix row (W from
    `signature_geometry`). Equal signatures, anywhere in the population,
    mean the same subexpression; EMPTY positions get the all-zero
    signature, which no active subexpression has."""
    P, N = op.shape
    dev = op.device
    bits, per_word, W = signature_geometry(spec, N)
    K = max(spec.n_features, spec.n_consts, 1)
    ar = constant(prim.ARITY, dev)[op.long()]
    active = op != prim.EMPTY
    code = torch.where(active, 1 + op * K + torch.where(ar == 0, arg.clamp(0, K - 1), 0),
                       0).to(torch.int32)
    start = subtree_spans(op)
    t = torch.arange(N, dtype=torch.int32, device=dev)
    length = t[None, :] - start + 1
    idx = (start[:, :, None] + t).clamp(0, N - 1).long()  # [P, N, N] span positions
    g = torch.gather(code[:, None, :].expand(P, N, N), 2, idx)
    mask = (t < length[:, :, None]) & active[:, :, None]
    sig = torch.where(mask, g, 0)
    pad = W * per_word - N
    if pad:
        sig = torch.nn.functional.pad(sig, (0, pad))
    sig = sig.reshape(P, N, W, per_word)
    shifts = torch.arange(per_word, dtype=torch.int32, device=dev) * bits
    return (sig << shifts).sum(-1, dtype=torch.int32)


# --- host-side pretty printing ----------------------------------------------


_INFIX_SYM = {"add": "+", "sub": "-", "mul": "*", "div": "/"}


def _terminal_str(o, a, feature_names, const_table) -> str:
    if o == prim.CONST:
        c = float(const_table[a]) if const_table is not None else a
        return f"{c:g}" if isinstance(c, float) else f"c{a}"
    return feature_names[a] if feature_names else f"x{a}"


def _host(a) -> np.ndarray:
    return np.asarray(a.cpu() if torch.is_tensor(a) else a)


def to_string(op_row, arg_row, feature_names=None, const_table=None,
              idx: int = 0, *, genome: str = "tree") -> str:
    """Render one genome row as an infix expression string (host). Both
    forms give the same text for the same tree."""
    op_row = _host(op_row)
    arg_row = _host(arg_row)
    if genome == "postfix":
        return _postfix_to_string(op_row, arg_row, feature_names, const_table)
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


def _postfix_to_string(op_row, arg_row, feature_names, const_table) -> str:
    """String-stack rendering of one postfix stream."""
    stack: list[str] = []
    for t in range(op_row.shape[0]):
        o = int(op_row[t])
        if o == prim.EMPTY:
            break
        if o in (prim.CONST, prim.FEATURE):
            stack.append(_terminal_str(o, int(arg_row[t]), feature_names, const_table))
            continue
        p = prim.FUNCTIONS[o - 3]
        if p.arity == 1:
            stack.append(f"{p.name}({stack.pop()})")
        else:
            rhs = stack.pop()
            lhs = stack.pop()
            sym = _INFIX_SYM.get(p.name)
            stack.append(f"({lhs} {sym} {rhs})" if sym else f"{p.name}({lhs}, {rhs})")
    if not stack:
        return "∅"
    if len(stack) != 1:
        raise ValueError(f"malformed postfix stream: {len(stack)} results")
    return stack[0]


def tree_sizes(op) -> torch.Tensor:
    """Number of non-EMPTY nodes per tree."""
    return (op != prim.EMPTY).sum(-1)


def _check_heap_invariants(op: np.ndarray, spec: TreeSpec) -> None:
    """Assert heap well-formedness I1–I4."""
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


def _check_postfix_invariants(op: np.ndarray, spec: TreeSpec) -> None:
    """Assert postfix well-formedness P1–P5."""
    N = spec.num_nodes
    arity = prim.ARITY[op]
    active = op != prim.EMPTY
    lens = active.sum(-1)
    assert (lens >= 1).all(), "P1: empty program"
    assert (active == (np.arange(N)[None, :] < lens[:, None])).all(), \
        "P1: EMPTY slot inside the active prefix"
    assert (arity[:, 0] == 0).all(), "P2: first instruction is not a terminal"
    S = np.cumsum(1 - arity, axis=-1)
    act_S = np.where(active, S, 1)
    assert (act_S >= 1).all(), "P3: operand-stack underflow mid-program"
    assert (S[np.arange(op.shape[0]), lens - 1] == 1).all(), \
        "P4: program does not leave exactly one result"
    assert (act_S <= spec.stack_size).all(), \
        f"P5: operand-stack depth exceeds stack_size={spec.stack_size}"


_FORM_CHECKS = {"tree": _check_heap_invariants, "postfix": _check_postfix_invariants}


def check_invariants(op, spec: TreeSpec) -> None:
    """Assert well-formedness in the spec's genome form (host-side, used
    by tests): I1–I4 for "tree", P1–P5 for "postfix". Rows that fail
    their declared form but satisfy the other one raise a ValueError
    naming the mismatch (a state saved under the other encoding)."""
    op = _host(op).reshape(-1, spec.num_nodes)
    assert ((op >= 0) & (op < len(prim.ARITY))).all(), "invalid opcode"
    other = {"tree": "postfix", "postfix": "tree"}[spec.genome]
    try:
        _FORM_CHECKS[spec.genome](op, spec)
    except AssertionError as err:
        try:
            _FORM_CHECKS[other](op, spec)
        except AssertionError:
            raise err from None
        raise ValueError(
            f"population violates the {spec.genome!r} genome invariants "
            f"({err}) but satisfies the {other!r} form — was this state "
            f"saved under TreeSpec.genome={other!r}? Convert it with "
            f"trees.heap_to_postfix / trees.postfix_to_heap or re-initialize, "
            f"and keep TreeSpec.genome consistent with the stored population."
        ) from err
