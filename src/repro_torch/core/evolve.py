"""Genetic operators on heap-tensor and postfix populations, in PyTorch.

Port of `repro/core/evolve.py`. Karoo GP's tournament
selection, reproduction, mutation and crossover run branch-free over the
whole population, so a generation is a fixed sequence of tensor ops with
no host round-trip. Subtree crossover/mutation are integer path
arithmetic on heap indices:

  heap slot i ↔ 1-based code (i+1) whose binary digits below the leading 1
  spell the root-to-node path. Moving the subtree rooted at source slot b
  into target slot a maps every target descendant t (relative path suffix
  s, depth k below a) to source slot ((b+1) << k) + s - 1.

Transplants that would overflow the depth ceiling are repaired by demoting
dangling max-depth function nodes to terminals. On postfix genomes the
same operators are array splices of whole subexpressions.

Ordering matches the reference: argsort is stable, argmin/argmax take
the first occurrence, and every gather clips its index.

Island populations breed as one batch: every operator takes either one
key or a batch of keys `[I, 2]`, and with a batch the population rows
are the flattened `[I·P, N]` islands, row block i drawn from key i (the
reference vmaps its breeder over the island axis; the draws here are
`prng`'s batched forms, so a generation makes the same launches for any
I).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import primitives as prim
from repro_torch.core import prng
from repro_torch.core.trees import (TreeSpec, depth_table, generate_population,
                                    subtree_spans, tree_sizes)
from repro_torch.device import constant

# --- random node choice ------------------------------------------------------


def _per_key(key, rows: int) -> int:
    """Rows each key of `key` draws for (a batch splits the rows evenly)."""
    return rows // prng.n_keys(key)


def _random_active_node(key, op):
    """Uniform random non-EMPTY slot per tree via Gumbel-argmax.

    op: int32[R, N] → int32[R] heap index."""
    R, N = op.shape
    g = prng.merge_rows(key, prng.gumbel(key, (_per_key(key, R), N)))
    score = torch.where(op != prim.EMPTY, g, -torch.inf)
    return torch.argmax(score, dim=-1).to(torch.int32)


# --- subtree transplant (shared by crossover + branch mutation) -------------


def _transplant(op_t, arg_t, op_s, arg_s, a, b, spec: TreeSpec):
    """Replace the subtree at slot a[p] of target tree p with the subtree
    at slot b[p] of source tree p, for every row p at once."""
    N = spec.num_nodes
    dev = op_t.device
    DEPTH = constant(depth_table(N), dev).long()
    t = torch.arange(N, dtype=torch.int64, device=dev)
    a = a.long()[:, None]
    b = b.long()[:, None]
    k = DEPTH[None, :] - DEPTH[a.clamp(0, N - 1)]  # relative depth of t under a
    kc = k.clamp_min(0)
    in_sub = (k >= 0) & (((t + 1) >> kc) == (a + 1))
    rel = (t + 1) - ((a + 1) << kc)  # path suffix as offset in level k
    src1 = ((b + 1) << kc) + rel  # 1-based source slot
    valid = in_sub & (src1 <= N)
    src = (src1 - 1).clamp(0, N - 1)
    new_op = torch.where(valid, torch.gather(op_s, 1, src),
                         torch.where(in_sub, prim.EMPTY, op_t))
    new_arg = torch.where(valid, torch.gather(arg_s, 1, src),
                          torch.where(in_sub, 0, arg_t))
    # Depth-ceiling repair (I4): a function copied to the last level has no
    # room for children -> demote to a feature terminal.
    at_leaf = DEPTH == spec.max_depth
    dangling = at_leaf & (constant(prim.ARITY, dev)[new_op.long()] > 0)
    new_op = torch.where(dangling, prim.FEATURE, new_op).to(torch.int32)
    new_arg = torch.where(dangling, (t + new_arg) % spec.n_features,
                          new_arg).to(torch.int32)
    return new_op, new_arg


# --- postfix splicing (crossover + branch mutation on linear genomes) --------


def _splice_pop(op_a, arg_a, op_b, arg_b, sa, ea, sb, eb, spec: TreeSpec):
    """Replace the subexpression [sa[p], ea[p]] of postfix program A[p]
    with the subexpression [sb[p], eb[p]] of program B[p], for every row
    p at once: arange-mask splicing. Offspring longer than N or deeper
    than the operand stack (P5) are rejected: the row keeps parent A."""
    N = spec.num_nodes
    dev = op_a.device
    t = torch.arange(N, dtype=torch.int64, device=dev)
    sa, ea, sb, eb = (v.long()[:, None] for v in (sa, ea, sb, eb))
    len_a = (op_a != prim.EMPTY).sum(-1, keepdim=True)
    lb = eb - sb + 1
    new_len = len_a - (ea - sa + 1) + lb
    in_pre = t < sa
    in_ins = (t >= sa) & (t < sa + lb)
    in_tail = (t >= sa + lb) & (t < new_len)
    idx_b = (sb + t - sa).clamp(0, N - 1)
    idx_tail = (t - lb + (ea - sa + 1)).clamp(0, N - 1)
    cand_op = torch.where(in_pre, op_a, torch.where(
        in_ins, torch.gather(op_b, 1, idx_b),
        torch.where(in_tail, torch.gather(op_a, 1, idx_tail), prim.EMPTY)))
    cand_arg = torch.where(in_pre, arg_a, torch.where(
        in_ins, torch.gather(arg_b, 1, idx_b),
        torch.where(in_tail, torch.gather(arg_a, 1, idx_tail), 0)))
    # both spans are whole subexpressions, so the splice stays balanced;
    # only the length and peak-depth bounds can break
    S = torch.cumsum(1 - constant(prim.ARITY, dev)[cand_op.long()], dim=-1)
    peak = torch.where(t < new_len, S, 0).amax(-1, keepdim=True)
    ok = (new_len <= N) & (peak <= spec.stack_size)
    return (torch.where(ok, cand_op, op_a).to(torch.int32),
            torch.where(ok, cand_arg, arg_a).to(torch.int32))


def _random_subexpr(key, op):
    """(start, end) of a uniform random subexpression per postfix row:
    every active position ends exactly one subexpression."""
    end = _random_active_node(key, op)
    start = torch.gather(subtree_spans(op), 1, end.long()[:, None])[:, 0]
    return start, end


def crossover_postfix(key, op_a, arg_a, op_b, arg_b, spec: TreeSpec):
    """Subtree crossover on linear genomes: splice a random subexpression
    of B over a random subexpression of A."""
    ka, kb = prng.split(key).unbind(-2)
    sa, ea = _random_subexpr(ka, op_a)
    sb, eb = _random_subexpr(kb, op_b)
    return _splice_pop(op_a, arg_a, op_b, arg_b, sa, ea, sb, eb, spec)


def mutate_branch_postfix(key, op, arg, spec: TreeSpec):
    """Branch mutation on linear genomes: splice a fresh random program
    (its whole stream [0, len-1]) over a random subexpression."""
    P = op.shape[0]
    kp, kg = prng.split(key).unbind(-2)
    sa, ea = _random_subexpr(kp, op)
    fresh_op, fresh_arg = generate_population(kg, _per_key(kg, P), spec)
    sb = torch.zeros((P,), dtype=torch.int32, device=op.device)
    eb = tree_sizes(fresh_op) - 1
    return _splice_pop(op, arg, fresh_op, fresh_arg, sa, ea, sb, eb, spec)


# --- operators ----------------------------------------------------------------


def crossover(key, op_a, arg_a, op_b, arg_b, spec: TreeSpec):
    """Subtree crossover: offspring = parent A with a random branch of B
    grafted at a random point (Karoo's fx_evolve_crossover)."""
    ka, kb = prng.split(key).unbind(-2)
    pt_a = _random_active_node(ka, op_a)
    pt_b = _random_active_node(kb, op_b)
    return _transplant(op_a, arg_a, op_b, arg_b, pt_a, pt_b, spec)


def mutate_branch(key, op, arg, spec: TreeSpec):
    """Branch mutation: replace a random subtree with a fresh random tree
    (Karoo's fx_evolve_branch_mutate)."""
    P = op.shape[0]
    kp, kg = prng.split(key).unbind(-2)
    pt = _random_active_node(kp, op)
    fresh_op, fresh_arg = generate_population(kg, _per_key(kg, P), spec)
    root = torch.zeros((P,), dtype=torch.int32, device=op.device)
    return _transplant(op, arg, fresh_op, fresh_arg, pt, root, spec)


def mutate_point(key, op, arg, spec: TreeSpec, p=0.25):
    """Point mutation: independently redraw nodes in place, arity-preserving
    (Karoo's fx_evolve_point_mutate). `p` is the redraw probability: a
    float, or with a batch of keys an f32[I] rate per island."""
    dev = op.device
    R, N = op.shape
    shape = (_per_key(key, R), N)
    km, kf, ku, kt, ks = prng.split(key, 5).unbind(-2)

    def draw(sample, k, *a):
        return prng.merge_rows(key, sample(k, *a))

    hit = draw(prng.bernoulli, km, p, shape)
    arity = constant(prim.ARITY, dev)[op.long()]
    bin_ops = constant(spec.fn_set.binary_opcodes, dev, np.int32)
    new_bin = bin_ops[draw(prng.randint, kf, shape, 0, len(bin_ops)).long()]
    una = spec.fn_set.unary_opcodes
    new_una = (constant(una, dev, np.int32)[
        draw(prng.randint, ku, shape, 0, max(len(una), 1)).long()] if len(una) else op)
    is_const = draw(prng.bernoulli, kt, spec.p_const, shape)
    new_t_op = torch.where(is_const, prim.CONST, prim.FEATURE).to(torch.int32)
    new_t_arg = torch.where(is_const, draw(prng.randint, ks, shape, 0, spec.n_consts),
                            draw(prng.randint, ks, shape, 0, spec.n_features))
    new_op = torch.where(arity == 2, new_bin,
                         torch.where(arity == 1, new_una, new_t_op))
    new_arg = torch.where(arity == 0, new_t_arg, arg)
    keep = (op == prim.EMPTY) | ~hit
    return torch.where(keep, op, new_op), torch.where(keep, arg, new_arg)


def tournament(key, fitness, pop: int, size: int, active=None):
    """Minimizing tournament selection → int32[pop] winner indices.

    `size` is the candidate-draw count; `active` (optional int32 tensor,
    ≤ size) masks the tail candidates out of the argmin with +inf, so
    one draw serves per-island tournament sizes. With a batch of I keys,
    `fitness` is the flattened f32[I·P] population, each key draws `pop`
    tournaments among its own island's P rows, `active` is int32[I], and
    the winners are int32[I·pop] indices into the flattened rows."""
    I = prng.n_keys(key)
    n = fitness.shape[0] // I
    idx = prng.randint(key, (pop, size), 0, n).long()
    if key.dim() > 1:  # island i owns rows i·n to i·n + n - 1
        idx = idx + (torch.arange(I, device=idx.device) * n)[:, None, None]
    scores = fitness[idx]
    if active is not None:
        lim = active[:, None, None] if key.dim() > 1 else active
        slot = torch.arange(size, device=idx.device)
        scores = torch.where(slot < lim, scores, torch.inf)
    win = torch.argmin(scores, dim=-1, keepdim=True)
    return prng.merge_rows(key, torch.gather(idx, -1, win)[..., 0]).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class OperatorMix:
    """Karoo Table 2 defaults: 10% reproduction / 20% mutation / 70% crossover.
    Mutation is split evenly between point and branch mutation."""

    reproduce: float = 0.10
    mutate_point: float = 0.10
    mutate_branch: float = 0.10
    crossover: float = 0.70

    def __hash__(self):
        return hash((self.reproduce, self.mutate_point, self.mutate_branch, self.crossover))

    def probs(self) -> np.ndarray:
        """f32[4] probability vector in `next_generation_arrays` order."""
        return np.asarray([self.reproduce, self.mutate_point,
                           self.mutate_branch, self.crossover], np.float32)


def _rows(x, idx):
    return torch.index_select(x, 0, idx.long())


def next_generation_arrays(key, op, arg, fitness, spec: TreeSpec, probs,
                           tourn_size: int = 10, elitism: int = 1,
                           n_out: int | None = None, tourn_active=None,
                           point_rate=None):
    """One selection + variation step with the operator mix given as an
    f32[4] tensor of probabilities (reproduce, mutate_point,
    mutate_branch, crossover). Every offspring slot draws an operator;
    all operator outputs are computed and the per-slot result selected,
    so the step is the same fixed sequence of tensor ops every
    generation. [P,N] -> [n_out,N]: `n_out` (default P) decouples the
    offspring count from the parent pool, so that a mesh shard breeds
    only its slice of the next generation.

    `tourn_active` (int32, ≤ tourn_size) is the effective tournament
    size and `point_rate` (f32) the point-mutation rate; None gives the
    classic fixed-size tournament and 0.25, bit for bit. With a batch of
    I keys the population is the flattened [I·P, N] islands, `fitness`
    f32[I·P], `probs` f32[I, 4] and the two options int32[I]/f32[I]: one
    step breeds every island with its own parameters, and elitism is
    taken per island (`n_out` rows a key)."""
    I = prng.n_keys(key)
    R, N = op.shape
    P_in = R // I
    P = n_out or P_in
    k_op, k_t1, k_t2, k_x, k_mb, k_mp = prng.split(key, 6).unbind(-2)

    choice = prng.merge_rows(key, prng.categorical(k_op, prng.xla_log(probs), (P,)))

    parent_a = tournament(k_t1, fitness, P, tourn_size, tourn_active)
    parent_b = tournament(k_t2, fitness, P, tourn_size, tourn_active)
    op_a, arg_a = _rows(op, parent_a), _rows(arg, parent_a)
    op_b, arg_b = _rows(op, parent_b), _rows(arg, parent_b)

    if spec.genome == "postfix":
        op_x, arg_x = crossover_postfix(k_x, op_a, arg_a, op_b, arg_b, spec)
        op_mb, arg_mb = mutate_branch_postfix(k_mb, op_a, arg_a, spec)
    else:
        op_x, arg_x = crossover(k_x, op_a, arg_a, op_b, arg_b, spec)
        op_mb, arg_mb = mutate_branch(k_mb, op_a, arg_a, spec)
    # point mutation is arity-preserving in place: valid on both forms
    op_mp, arg_mp = mutate_point(k_mp, op_a, arg_a, spec,
                                 0.25 if point_rate is None else point_rate)

    c = choice[:, None]
    new_op = torch.where(c == 0, op_a, torch.where(c == 1, op_mp,
                                                   torch.where(c == 2, op_mb, op_x)))
    new_arg = torch.where(c == 0, arg_a, torch.where(c == 1, arg_mp,
                                                     torch.where(c == 2, arg_mb, arg_x)))
    if elitism:  # each island's best rows go to its first slots
        best = torch.argsort(fitness.reshape(I, P_in), dim=-1, stable=True)[:, :elitism]
        if I > 1:
            best = best + (torch.arange(I, device=best.device) * P_in)[:, None]
        best = best.reshape(-1)

        def place(new, old):
            head = _rows(old, best).reshape(I, elitism, N)
            return torch.cat([head, new.reshape(I, P, N)[:, elitism:]], 1).reshape(I * P, N)

        new_op, new_arg = place(new_op, op), place(new_arg, arg)
    return new_op, new_arg


def make_island_breeder(spec: TreeSpec, tourn_size: int, elitism: int,
                        n_out: int | None = None, fold=None):
    """The island engine's breeding step: breed(keys, op, arg, fitness,
    probs, tourn_active, point_rate) -> (advanced keys, new_op, new_arg)
    over island-batched tensors (keys [I, 2], op/arg int32[I, P, N],
    fitness f32[I, P], probs f32[I, 4], tourn_active int32[I],
    point_rate f32[I]). Each island's key splits as the reference's
    vmapped breeder splits it, and all islands breed in one batched
    `next_generation_arrays` call. `n_out` (default P) offspring an
    island; `fold` (an int: a mesh shard's model rank) is folded into
    each draw key after the split, so that shards breed decorrelated
    slices of one island."""

    def breed(keys, op, arg, fitness, probs, tourn_active, point_rate):
        I, P, N = op.shape
        keys, k_next = prng.split(keys).unbind(-2)
        if fold is not None:
            k_next = prng.fold_in(k_next, fold)
        new_op, new_arg = next_generation_arrays(
            k_next, op.reshape(I * P, N), arg.reshape(I * P, N), fitness.reshape(I * P),
            spec, probs, tourn_size, elitism, n_out, tourn_active=tourn_active,
            point_rate=point_rate)
        R = n_out or P
        return keys, new_op.reshape(I, R, N), new_arg.reshape(I, R, N)

    return breed


def next_generation(key, op, arg, fitness, spec: TreeSpec, mix: OperatorMix = OperatorMix(),
                    tourn_size: int = 10, elitism: int = 1, n_out: int | None = None):
    """One full selection + variation step. [P,N] -> [n_out,N] (default
    n_out = P), fixed shapes."""
    probs = constant(mix.probs(), op.device)
    return next_generation_arrays(key, op, arg, fitness, spec, probs,
                                  tourn_size, elitism, n_out)
