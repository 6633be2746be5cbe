"""Genetic operators on heap-tensor populations, in PyTorch.

Port of the heap half of `repro/core/evolve.py`. Karoo GP's tournament
selection, reproduction, mutation and crossover run branch-free over the
whole population, so a generation is a fixed sequence of tensor ops with
no host round-trip. Subtree crossover/mutation are integer path
arithmetic on heap indices:

  heap slot i ↔ 1-based code (i+1) whose binary digits below the leading 1
  spell the root-to-node path. Moving the subtree rooted at source slot b
  into target slot a maps every target descendant t (relative path suffix
  s, depth k below a) to source slot ((b+1) << k) + s - 1.

Transplants that would overflow the depth ceiling are repaired by demoting
dangling max-depth function nodes to terminals.

Ordering matches the reference: argsort is stable, argmin/argmax take
the first occurrence, and every gather clips its index.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import primitives as prim
from repro_torch.core import prng
from repro_torch.core.trees import TreeSpec, depth_table, generate_population
from repro_torch.device import constant

# --- random node choice ------------------------------------------------------


def _random_active_node(key, op):
    """Uniform random non-EMPTY slot per tree via Gumbel-argmax.

    op: int32[..., N] → int32[...] heap index."""
    g = prng.gumbel(key, tuple(op.shape))
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


# --- operators ----------------------------------------------------------------


def crossover(key, op_a, arg_a, op_b, arg_b, spec: TreeSpec):
    """Subtree crossover: offspring = parent A with a random branch of B
    grafted at a random point (Karoo's fx_evolve_crossover)."""
    ka, kb = prng.split(key)
    pt_a = _random_active_node(ka, op_a)
    pt_b = _random_active_node(kb, op_b)
    return _transplant(op_a, arg_a, op_b, arg_b, pt_a, pt_b, spec)


def mutate_branch(key, op, arg, spec: TreeSpec):
    """Branch mutation: replace a random subtree with a fresh random tree
    (Karoo's fx_evolve_branch_mutate)."""
    P = op.shape[0]
    kp, kg = prng.split(key)
    pt = _random_active_node(kp, op)
    fresh_op, fresh_arg = generate_population(kg, P, spec)
    root = torch.zeros((P,), dtype=torch.int32, device=op.device)
    return _transplant(op, arg, fresh_op, fresh_arg, pt, root, spec)


def mutate_point(key, op, arg, spec: TreeSpec, p: float = 0.25):
    """Point mutation: independently redraw nodes in place, arity-preserving
    (Karoo's fx_evolve_point_mutate)."""
    dev = op.device
    shape = tuple(op.shape)
    km, kf, ku, kt, ks = prng.split(key, 5)
    hit = prng.bernoulli(km, p, shape)
    arity = constant(prim.ARITY, dev)[op.long()]
    bin_ops = constant(spec.fn_set.binary_opcodes, dev, np.int32)
    new_bin = bin_ops[prng.randint(kf, shape, 0, len(bin_ops)).long()]
    una = spec.fn_set.unary_opcodes
    new_una = (constant(una, dev, np.int32)[
        prng.randint(ku, shape, 0, max(len(una), 1)).long()] if len(una) else op)
    is_const = prng.bernoulli(kt, spec.p_const, shape)
    new_t_op = torch.where(is_const, prim.CONST, prim.FEATURE).to(torch.int32)
    new_t_arg = torch.where(is_const, prng.randint(ks, shape, 0, spec.n_consts),
                            prng.randint(ks, shape, 0, spec.n_features))
    new_op = torch.where(arity == 2, new_bin,
                         torch.where(arity == 1, new_una, new_t_op))
    new_arg = torch.where(arity == 0, new_t_arg, arg)
    keep = (op == prim.EMPTY) | ~hit
    return torch.where(keep, op, new_op), torch.where(keep, arg, new_arg)


def tournament(key, fitness, pop: int, size: int):
    """Minimizing tournament selection → int32[pop] winner indices."""
    idx = prng.randint(key, (pop, size), 0, fitness.shape[0]).long()
    scores = fitness[idx]
    win = torch.argmin(scores, dim=-1, keepdim=True)
    return torch.gather(idx, 1, win)[:, 0].to(torch.int32)


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
                           tourn_size: int = 10, elitism: int = 1):
    """One selection + variation step with the operator mix given as an
    f32[4] tensor of probabilities (reproduce, mutate_point,
    mutate_branch, crossover). Every offspring slot draws an operator;
    all operator outputs are computed and the per-slot result selected,
    so the step is the same fixed sequence of tensor ops every
    generation. [P,N] -> [P,N]."""
    P = op.shape[0]
    k_op, k_t1, k_t2, k_x, k_mb, k_mp = prng.split(key, 6)

    choice = prng.categorical(k_op, prng.xla_log(probs), (P,))

    parent_a = tournament(k_t1, fitness, P, tourn_size)
    parent_b = tournament(k_t2, fitness, P, tourn_size)
    op_a, arg_a = _rows(op, parent_a), _rows(arg, parent_a)
    op_b, arg_b = _rows(op, parent_b), _rows(arg, parent_b)

    op_x, arg_x = crossover(k_x, op_a, arg_a, op_b, arg_b, spec)
    op_mb, arg_mb = mutate_branch(k_mb, op_a, arg_a, spec)
    op_mp, arg_mp = mutate_point(k_mp, op_a, arg_a, spec)

    c = choice[:, None]
    new_op = torch.where(c == 0, op_a, torch.where(c == 1, op_mp,
                                                   torch.where(c == 2, op_mb, op_x)))
    new_arg = torch.where(c == 0, arg_a, torch.where(c == 1, arg_mp,
                                                     torch.where(c == 2, arg_mb, arg_x)))
    if elitism:
        best = torch.argsort(fitness, stable=True)[:elitism]
        new_op = torch.cat([_rows(op, best), new_op[elitism:]])
        new_arg = torch.cat([_rows(arg, best), new_arg[elitism:]])
    return new_op, new_arg


def next_generation(key, op, arg, fitness, spec: TreeSpec, mix: OperatorMix = OperatorMix(),
                    tourn_size: int = 10, elitism: int = 1):
    """One full selection + variation step. [P,N] -> [P,N], fixed shapes."""
    probs = constant(mix.probs(), op.device)
    return next_generation_arrays(key, op, arg, fitness, spec, probs,
                                  tourn_size, elitism)
