"""The generation loop on one device, in PyTorch.

Port of the classic single-device layout of `repro/core/engine.py`.
Workflow (paper §2.4): build population → evaluate fitness → select →
apply genetic operators → repeat. `evolve_step` runs one generation;
`evolve_block` runs K of them as one Python loop of tensor ops that
never reads a value back to the host — the reference's `lax.scan` — with
early stop as a branch-free freeze, and returns the per-generation
best-fitness stream [K] and the int32[K, 7] telemetry counter stream, so
the host synchronises once per block.

`lax.cond` in the elite cache and the freeze become `torch.where`
selects, which give the same values: the cache evaluates the whole
population in one fused-kernel call and takes the head rows from the
cache on a hit (every evaluation path is row-independent, so this is
bitwise the reference's split evaluation). So the port evaluates all P
rows every generation: the `tree_evals` counter (P minus the rows a hit
serves) is the reference's count of evaluations, not the card's.

Inside a block nothing may synchronise with the host: no `.item()`,
`bool(t)`, `int(t)`, boolean-mask indexing or `torch.nonzero` on a
device tensor, and no copy of a host table to the card (device tables
come from `repro_torch.device.constant`, made before the first block).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import evolve as ev
from repro_torch.core import fitness as fit
from repro_torch.core import primitives as prim
from repro_torch.core import prng
from repro_torch.core.trees import (TreeSpec, depth_table, generate_population,
                                    tree_sizes)
from repro_torch.device import constant, resolve_device
from repro_torch.obs import counters as _tc


@dataclasses.dataclass(frozen=True)
class GPConfig:
    """Run-time parameters (paper Table 2 defaults).

    `dedup` is kept for parity with the reference and is a no-op on heap
    genomes, as it is there."""

    name: str = "karoo"
    pop_size: int = 100
    tree_spec: TreeSpec = TreeSpec()
    fitness: fit.FitnessSpec = fit.FitnessSpec()
    mix: ev.OperatorMix = ev.OperatorMix()
    tourn_size: int = 10
    generations: int = 30
    elitism: int = 1
    parsimony: float = 0.0  # bloat pressure: selection fitness += p * size
    stop_fitness: float | None = None  # early termination threshold
    eval_impl: str = "auto"  # a backend name in repro_torch.gp.backends; auto:
    # the CUDA kernel on a CUDA device, the plain version on the CPU
    data_tile: int = 1024  # upper bound of the kernel's data tile
    elite_cache: bool = True  # skip re-evaluating unchanged elites
    dedup: str = "exact"  # no-op on heap genomes (postfix dedup: ROADMAP)
    dedup_cap: int = 0

    def __post_init__(self):
        if self.dedup not in ("off", "exact", "semantic"):
            raise ValueError(f"dedup must be 'off', 'exact' or 'semantic', "
                             f"got {self.dedup!r}")


def cache_width(cfg: GPConfig) -> int:
    """E: rows of the cross-generation elite fitness cache carried in
    GPState (the rows elitism copies verbatim); 0 disables."""
    if cfg.elite_cache and 0 < cfg.elitism < cfg.pop_size:
        return cfg.elitism
    return 0


class GPState(NamedTuple):
    """Engine state, classic single-population layout:

        key           int64[2]   threefry key (two uint32 words)
        op/arg        int32[P, N]
        fitness       f32[P]     of the current population (minimize)
        best_op/arg   int32[N]
        best_fitness  f32[]
        generation    int32[]
        cache_op/arg  int32[E, N]  elite fitness cache
        cache_fit     f32[E]
    """

    key: torch.Tensor
    op: torch.Tensor
    arg: torch.Tensor
    fitness: torch.Tensor
    best_op: torch.Tensor
    best_arg: torch.Tensor
    best_fitness: torch.Tensor
    generation: torch.Tensor
    cache_op: torch.Tensor
    cache_arg: torch.Tensor
    cache_fit: torch.Tensor


_STATE_DTYPES = {"key": np.uint32, "op": np.int32, "arg": np.int32,
                 "fitness": np.float32, "best_op": np.int32, "best_arg": np.int32,
                 "best_fitness": np.float32, "generation": np.int32,
                 "cache_op": np.int32, "cache_arg": np.int32, "cache_fit": np.float32}


def state_from_numpy(d, device="cpu") -> GPState:
    """A GPState from numpy leaves — a dict, or a reference `GPState`
    whose leaves convert with `np.asarray` (key as uint32[2]) — bit for
    bit, on `device`."""
    if not isinstance(d, dict):
        d = d._asdict()
    dev = torch.device(device)
    leaves = {}
    for name in GPState._fields:
        a = np.asarray(d[name])
        if name == "key":
            leaves[name] = prng.key_from_numpy(a).to(dev)
        else:
            leaves[name] = torch.from_numpy(
                np.array(a, dtype=_STATE_DTYPES[name])).to(dev)
    return GPState(**leaves)


def state_to_numpy(state: GPState) -> dict:
    """The state's leaves as numpy arrays in the reference's dtypes
    (key as uint32[2]) — the inverse of `state_from_numpy`."""
    out = {}
    for name, t in state._asdict().items():
        if name == "key":
            out[name] = prng.key_to_numpy(t)
        else:
            out[name] = t.detach().cpu().numpy().astype(_STATE_DTYPES[name])
    return out


def _eval_fitness(cfg: GPConfig, op, arg, X, y, weight, const_table):
    """Dispatch to the EvalBackend registered under `cfg.eval_impl`."""
    from repro_torch.gp.backends import get_backend

    backend = get_backend(cfg.eval_impl, op.device)
    return backend.fitness(op, arg, X, y, const_table, cfg.tree_spec, cfg.fitness,
                           weight=weight, data_tile=cfg.data_tile)


def init_state(cfg: GPConfig, key, seeds=None, feature_names=None,
               device=None) -> GPState:
    """Fresh state on `device` (default: the card). `key` is a port key
    (`prng.PRNGKey`); the population is drawn from it exactly as the
    reference draws it."""
    if seeds:
        raise NotImplementedError("seed expressions are not ported yet "
                                  "(ROADMAP queue A: core/parse.py seeds)")
    dev = resolve_device(device)
    key = key.to(dev)
    k0, k1 = prng.split(key)
    N = cfg.tree_spec.num_nodes
    E = cache_width(cfg)
    op, arg = generate_population(k1, cfg.pop_size, cfg.tree_spec)
    _device_tables(cfg, dev)

    def i32(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=dev)

    return GPState(
        key=k0, op=op, arg=arg,
        fitness=torch.full((cfg.pop_size,), math.inf, device=dev),
        best_op=i32(N), best_arg=i32(N),
        best_fitness=torch.full((), math.inf, device=dev),
        generation=i32(),
        cache_op=i32(E, N), cache_arg=i32(E, N),
        cache_fit=torch.full((E,), math.inf, device=dev))


def _device_tables(cfg: GPConfig, dev) -> None:
    """Make every host table the step reads on `dev` now, so that no
    evolution block copies one to the card (a synchronising copy)."""
    spec = cfg.tree_spec
    spec.const_table(dev)
    constant(prim.ARITY, dev)
    constant(depth_table(spec.num_nodes), dev)
    for ops in (spec.fn_set.opcodes, spec.fn_set.binary_opcodes,
                spec.fn_set.unary_opcodes):
        constant(ops, dev, np.int32)
    constant(cfg.mix.probs(), dev)
    constant(_FROZEN_ROW, dev)


def _cache_hit(state: GPState):
    E = state.cache_op.shape[0]
    return ((state.op[:E] == state.cache_op).all()
            & (state.arg[:E] == state.cache_arg).all())


def _cached_fitness(state: GPState, eval_rows):
    """Evaluate `state`'s population, serving rows [:E] from the elite
    fitness cache when the cached genomes match exactly.

    `eval_rows(op, arg) -> f32[rows]`. The population is evaluated in
    one call and the head selected: the cached value IS last
    generation's evaluation of the identical rows, so the result is
    bitwise the reference's `lax.cond` split."""
    E = state.cache_op.shape[0]
    full = eval_rows(state.op, state.arg)
    if not E:
        return full
    head = torch.where(_cache_hit(state), state.cache_fit, full[:E])
    return torch.cat([head, full[E:]])


def _new_cache(state: GPState, fitness, sel_fitness, E: int):
    """(cache_op, cache_arg, cache_fit) for the next generation: the rows
    elitism will copy to [:E] (stable argsort on the selection fitness)
    with their raw fitness, taken from the evaluated population."""
    best = torch.argsort(sel_fitness, stable=True)[:E]
    return (torch.index_select(state.op, 0, best),
            torch.index_select(state.arg, 0, best),
            torch.index_select(fitness, 0, best))


def _step_body(cfg: GPConfig, state: GPState, X, y, weight) -> GPState:
    """One generation's computation — shared by `evolve_step` and
    `evolve_block`, so K block steps are bitwise K single steps."""
    const_table = cfg.tree_spec.const_table(state.op.device)
    fitness = _cached_fitness(
        state, lambda o, a: _eval_fitness(cfg, o, a, X, y, weight, const_table))
    # best tracked on RAW fitness; selection may add parsimony pressure
    i = torch.argmin(fitness).reshape(1)  # first minimum, as jnp.argmin
    f_i = torch.index_select(fitness, 0, i)[0]
    improved = f_i < state.best_fitness
    best_op = torch.where(improved, torch.index_select(state.op, 0, i)[0], state.best_op)
    best_arg = torch.where(improved, torch.index_select(state.arg, 0, i)[0],
                           state.best_arg)
    best_fit = torch.minimum(f_i, state.best_fitness)

    sel_fitness = fitness
    if cfg.parsimony:
        sel_fitness = fitness + cfg.parsimony * tree_sizes(state.op).float()

    E = state.cache_op.shape[0]
    cache_op, cache_arg, cache_fit = (
        _new_cache(state, fitness, sel_fitness, E) if E
        else (state.cache_op, state.cache_arg, state.cache_fit))

    key, k_next = prng.split(state.key)
    new_op, new_arg = ev.next_generation(
        k_next, state.op, state.arg, sel_fitness, cfg.tree_spec, cfg.mix,
        cfg.tourn_size, cfg.elitism)
    return GPState(key, new_op, new_arg, fitness, best_op, best_arg, best_fit,
                   state.generation + 1, cache_op, cache_arg, cache_fit)


def evolve_step(cfg: GPConfig, state: GPState, X, y, weight=None) -> GPState:
    """One generation. X: [F, D] feature-major, y: [D]; `weight` (f32[D]
    or None) masks dataset-padding points out of fitness."""
    return _step_body(cfg, state, X, y, weight)


_FROZEN_ROW = np.zeros(_tc.N_COUNTERS, np.int32)
_FROZEN_ROW[_tc.FROZEN] = 1


def _counter_row(cfg: GPConfig, state: GPState, done=None):
    """int32[C] telemetry row for one generation (columns:
    repro_torch.obs.counters), computed from the PRE-step state. A frozen
    step reports [0, 0, 1, 0, 0, 0, 0]."""
    dev = state.op.device
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    E = state.cache_op.shape[0]
    if E:
        hit = _cache_hit(state).to(torch.int32)
        queries = zero + 1
    else:
        hit, queries = zero, zero
    evals = cfg.pop_size - hit * E
    row = torch.stack([hit, queries, zero, zero, evals, zero, zero])
    if done is None:
        return row
    return torch.where(done, constant(_FROZEN_ROW, dev), row)


def _block_done(cfg: GPConfig, state: GPState, i: int, limit):
    """Branch-free freeze predicate for step `i` of a block: True once
    `best_fitness` has reached `cfg.stop_fitness` or `i` has reached the
    dynamic `limit` (a device int32 step budget)."""
    done = torch.zeros((), dtype=torch.bool, device=state.op.device)
    if cfg.stop_fitness is not None:
        done = state.best_fitness <= float(np.float32(cfg.stop_fitness))
    if limit is not None:
        done = done | (limit <= i)
    return done


def _freeze(done, prev: GPState, new: GPState) -> GPState:
    """Carry `prev` through unchanged (key and generation included) when
    `done` — frozen steps are no-ops."""
    return GPState(*(torch.where(done, p, n) for p, n in zip(prev, new)))


def evolve_block(cfg: GPConfig, state: GPState, X, y, weight=None, limit=None, *,
                 n_steps: int = 1):
    """Run up to `n_steps` generations with no host synchronisation.

    Returns (state, history, counters): history is the per-generation
    `best_fitness` stream f32[n_steps], counters the int32[n_steps, 7]
    telemetry stream. Steps freeze into no-ops once `cfg.stop_fitness`
    is reached or the step index reaches `limit` (device int32; None =
    run all `n_steps`); a frozen step still runs and is discarded."""
    can_freeze = cfg.stop_fitness is not None or limit is not None
    hist, rows = [], []
    s = state
    for i in range(n_steps):
        nxt = _step_body(cfg, s, X, y, weight)
        done = _block_done(cfg, s, i, limit)
        rows.append(_counter_row(cfg, s, done if can_freeze else None))
        if can_freeze:
            nxt = _freeze(done, s, nxt)
        hist.append(nxt.best_fitness)
        s = nxt
    return s, torch.stack(hist), torch.stack(rows)
