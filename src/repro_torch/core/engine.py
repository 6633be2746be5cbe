"""The generation loop on one device, in PyTorch.

Port of the single-device layouts of `repro/core/engine.py`: the
classic single population and the island model (`GPConfig.island`, I
islands of P trees evaluated as one flattened [I·P, N] population).
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

`chunked_fitness` evaluates a dataset streamed as fixed-shape chunks
(`data/loader.ChunkedDataset`): one backend `stream_moments` call per
chunk into an f32[P, M] accumulator, finalized once. Streamed and
host-only (`scalar`) runs step one generation at a time from
`GPSession`'s host loop, which evaluates and then calls `advance` /
`advance_islands`, the same tail as the device step. The reference's
mesh fold (`build_stream_fold`) waits for the multi-GPU port.

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

from repro_torch.core import eval as _eval
from repro_torch.core import evolve as ev
from repro_torch.core import fitness as fit
from repro_torch.core import primitives as prim
from repro_torch.core import prng
from repro_torch.core.islands import IslandConfig
from repro_torch.core.trees import (TreeSpec, depth_table, generate_population,
                                    heap_to_postfix, postorder_slots, tree_sizes)
from repro_torch.device import constant, resolve_device
from repro_torch.obs import counters as _tc


@dataclasses.dataclass(frozen=True)
class GPConfig:
    """Run-time parameters (paper Table 2 defaults).

    `dedup` is the population-wide subexpression dedup of postfix
    genomes (a no-op on heap genomes, as in the reference):
      "off"       evaluate every tree;
      "exact"     evaluate each distinct subexpression once (bitwise the
                  same fitness);
      "semantic"  exact, and the elite cache also hits on equal outputs
                  over the first 32 data columns (tolerance-pinned).
    `dedup_cap` is the unique table's rows; 0 = max(64, pop_size).

    `island` is the population layout: `islands > 1` makes the run I
    islands of `pop_size` trees (`op: int32[I, P, N]`). `migrate_every`/
    `migrate_k` are the reference's flat aliases: set away from their
    defaults they fold into `island` (where the island still holds the
    default), and afterwards they always mirror it."""

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
    dedup: str = "exact"
    dedup_cap: int = 0
    island: IslandConfig = IslandConfig()
    migrate_every: int = 10  # alias of island.migrate_every
    migrate_k: int = 4  # alias of island.migrate_k

    def __post_init__(self):
        if self.dedup not in ("off", "exact", "semantic"):
            raise ValueError(f"dedup must be 'off', 'exact' or 'semantic', "
                             f"got {self.dedup!r}")
        isl = self.island
        if self.migrate_every != 10 and isl.migrate_every == 10:
            isl = dataclasses.replace(isl, migrate_every=self.migrate_every)
        if self.migrate_k != 4 and isl.migrate_k == 4:
            isl = dataclasses.replace(isl, migrate_k=self.migrate_k)
        object.__setattr__(self, "island", isl)
        object.__setattr__(self, "migrate_every", isl.migrate_every)
        object.__setattr__(self, "migrate_k", isl.migrate_k)

    def __hash__(self):
        return hash((self.name, self.pop_size, self.tree_spec, self.fitness, self.mix,
                     self.tourn_size, self.generations, self.elitism, self.parsimony,
                     self.stop_fitness, self.eval_impl, self.data_tile,
                     self.elite_cache, self.dedup, self.dedup_cap, self.island))


def cache_width(cfg: GPConfig) -> int:
    """E: rows of the cross-generation elite fitness cache carried in
    GPState (the rows elitism copies verbatim); 0 disables."""
    if cfg.elite_cache and 0 < cfg.elitism < cfg.pop_size:
        return cfg.elitism
    return 0


class GPState(NamedTuple):
    """Engine state. With the classic layout (islands == 1) the shapes
    are the un-batched ones; with I > 1 islands every population leaf
    grows a leading island axis (`generation` stays a shared scalar:
    islands advance in lockstep):

                      islands == 1   islands == I
        key           int64[2]       int64[I, 2]    threefry keys (uint32 words)
        op/arg        int32[P, N]    int32[I, P, N]
        fitness       f32[P]         f32[I, P]      current population (minimize)
        best_op/arg   int32[N]       int32[I, N]    per-island champion
        best_fitness  f32[]          f32[I]
        generation    int32[]        int32[]
        cache_op/arg  int32[E, N]    int32[I, E, N] elite fitness cache
        cache_fit     f32[E]         f32[I, E]
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


def state_from_numpy(d, device=None) -> GPState:
    """A GPState from numpy leaves — a dict, or a reference `GPState`
    whose leaves convert with `np.asarray` (key as uint32[..., 2]) — bit
    for bit, on `device` (default: the card)."""
    if not isinstance(d, dict):
        d = d._asdict()
    dev = resolve_device(device)
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
    (key as uint32[..., 2]) — the inverse of `state_from_numpy`."""
    out = {}
    for name, t in state._asdict().items():
        if name == "key":
            out[name] = prng.key_to_numpy(t)
        else:
            out[name] = t.detach().cpu().numpy().astype(_STATE_DTYPES[name])
    return out


def _dedup_kwargs(cfg: GPConfig, fn) -> dict:
    """The dedup kwargs to forward to a backend callable: {} when dedup is
    off, or when the callable takes no such arguments (a user-registered
    backend keeps working; it never dedups)."""
    import inspect

    if cfg.dedup == "off":
        return {}
    try:
        params = inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return {}
    if "dedup" in params or any(p.kind == p.VAR_KEYWORD for p in params.values()):
        return {"dedup": cfg.dedup, "dedup_cap": cfg.dedup_cap}
    return {}


def _eval_fitness(cfg: GPConfig, op, arg, X, y, weight, const_table):
    """Dispatch to the EvalBackend registered under `cfg.eval_impl`, with
    `cfg.dedup`/`cfg.dedup_cap` for backends that take them."""
    from repro_torch.gp.backends import get_backend

    backend = get_backend(cfg.eval_impl, op.device)
    return backend.fitness(op, arg, X, y, const_table, cfg.tree_spec, cfg.fitness,
                           weight=weight, data_tile=cfg.data_tile,
                           **_dedup_kwargs(cfg, backend.fitness))


def init_state(cfg: GPConfig, key, seeds=None, feature_names=None,
               device=None) -> GPState:
    """Fresh state on `device` (default: the card). `key` is a port key
    (`prng.PRNGKey`); the population is drawn from it exactly as the
    reference draws it. `seeds` (expression strings, parsed against the
    config's TreeSpec with `feature_names`) fill the first slots: Karoo's
    customized seed populations (`core/parse.seed_population`).

    With `cfg.island.islands` = I > 1 the state is island-batched: island
    i draws its population from `fold_in(k1, i)` and keeps the key
    `fold_in(k0, i)`, and seeds fill the first slots of every island."""
    dev = resolve_device(device)
    key = key.to(dev)
    k0, k1 = prng.split(key)
    N = cfg.tree_spec.num_nodes
    E = cache_width(cfg)
    I = cfg.island.islands

    def one_island(k):
        if seeds:
            from repro_torch.core.parse import seed_population

            return seed_population(seeds, cfg.tree_spec, cfg.pop_size, k, feature_names,
                                   device=dev)
        return generate_population(k, cfg.pop_size, cfg.tree_spec)

    if I == 1:
        op, arg = one_island(k1)
        lead = ()
    else:
        if cfg.island.migrate_k > cfg.pop_size:
            raise ValueError(f"migrate_k {cfg.island.migrate_k} exceeds the "
                             f"per-island pop_size {cfg.pop_size}")
        pops = [one_island(prng.fold_in(k1, i)) for i in range(I)]
        op = torch.stack([p[0] for p in pops])
        arg = torch.stack([p[1] for p in pops])
        k0 = torch.stack([prng.fold_in(k0, i) for i in range(I)])
        lead = (I,)
    _device_tables(cfg, dev)

    def i32(*shape):
        return torch.zeros(lead + shape, dtype=torch.int32, device=dev)

    def inf(*shape):
        return torch.full(lead + shape, math.inf, device=dev)

    return GPState(
        key=k0, op=op, arg=arg, fitness=inf(cfg.pop_size),
        best_op=i32(N), best_arg=i32(N), best_fitness=inf(),
        generation=torch.zeros((), dtype=torch.int32, device=dev),
        cache_op=i32(E, N), cache_arg=i32(E, N), cache_fit=inf(E))


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
    if cfg.island.islands > 1:
        _island_tables(cfg, dev)
    if spec.genome == "postfix" or cfg.dedup == "semantic":  # heap_to_postfix
        constant(postorder_slots(spec.num_nodes), dev, np.int64)
    if spec.genome != "postfix":  # the B1 kernel's slot order
        constant(postorder_slots(spec.num_nodes), dev, np.int32)


def _cache_hit(state: GPState):
    """One predicate for every island: the cached rows equal the head
    rows [:E] of the population (of each island)."""
    E = state.cache_op.shape[-2]
    return ((state.op[..., :E, :] == state.cache_op).all()
            & (state.arg[..., :E, :] == state.cache_arg).all())


def _semantic_hit(state_slice, cache_slice, cache_fit, probe):
    """Semantic-tier cache predicate: the head rows give bitwise the same
    outputs as the cached rows on the probe batch (`probe(op, arg) ->
    f32[rows, Dp]`), and the cached fitness is all finite (so the zero
    cache, whose all-EMPTY rows probe to 0.0 like an x - x elite, never
    serves its +inf). A false hit needs two genomes equal on every probe
    point yet different elsewhere: the contract is tolerance-pinned."""
    (s_op, s_arg), (c_op, c_arg) = state_slice, cache_slice
    E = s_op.shape[0]  # both slices in one probe call
    out = probe(torch.cat([s_op, c_op]), torch.cat([s_arg, c_arg]))
    return (out[:E] == out[E:]).all() & torch.isfinite(cache_fit).all()


def _cached_fitness(state: GPState, eval_rows, probe=None):
    """Evaluate `state`'s population, serving rows [:E] from the elite
    fitness cache when the cached genomes match exactly, or (with a
    `probe`, dedup="semantic") when their probe outputs match.

    `eval_rows(op, arg) -> f32[rows]`. The population is evaluated in
    one call and the head selected: the cached value IS last
    generation's evaluation of the identical rows, so the result is
    bitwise the reference's `lax.cond` split."""
    E = state.cache_op.shape[0]
    full = eval_rows(state.op, state.arg)
    if not E:
        return full
    hit = _cache_hit(state)
    if probe is not None:
        hit = hit | _semantic_hit((state.op[:E], state.arg[:E]),
                                  (state.cache_op, state.cache_arg), state.cache_fit,
                                  probe)
    head = torch.where(hit, state.cache_fit, full[:E])
    return torch.cat([head, full[E:]])


_PROBE_COLS = 32  # semantic-tier fingerprint batch (first Dp data columns)


def _probe_fn(cfg: GPConfig, X, const_table):
    """Semantic-tier fingerprint closure, or None unless
    cfg.dedup == "semantic": the rows' predictions on the first
    min(D, 32) data columns, so no extra state rides GPState. They come
    from the postfix predict kernel (`kernels/gp_eval.predict_postfix`,
    heap rows converted first: the same predictions), which runs its
    plain version on CPU tensors; `eval_impl="torch"` takes the plain
    evaluator on any device."""
    if cfg.dedup != "semantic":
        return None
    from repro_torch.kernels import gp_eval

    spec = cfg.tree_spec
    Xp = X[:, :min(X.shape[1], _PROBE_COLS)].float().contiguous()
    const_table = const_table.float().contiguous()
    fn_codes = tuple(int(c) for c in spec.fn_set.opcodes)

    def probe(o, a):
        if cfg.eval_impl == "torch":
            return _eval.evaluate_population(o, a, Xp, const_table, spec)
        if spec.genome != "postfix":
            o, a = heap_to_postfix(o, a)
        return gp_eval.predict_postfix(o.contiguous(), a.contiguous(), Xp, const_table,
                                       stack_size=spec.stack_size, fn_codes=fn_codes)

    return probe


def _new_cache(state: GPState, fitness, sel_fitness, E: int):
    """(cache_op, cache_arg, cache_fit) for the next generation: the rows
    elitism will copy to [:E] (stable argsort on the selection fitness)
    with their raw fitness, taken from the evaluated population — never
    from the bred output, so a migrant landing in [:E] can only miss.
    Per island on [..., P] inputs."""
    best = torch.argsort(sel_fitness, dim=-1, stable=True)[..., :E]
    rows = best[..., None].expand(*best.shape, state.op.shape[-1])
    return (torch.gather(state.op, -2, rows), torch.gather(state.arg, -2, rows),
            torch.gather(fitness, -1, best))


def _step_body(cfg: GPConfig, state: GPState, X, y, weight) -> GPState:
    """One generation's computation — shared by `evolve_step` and
    `evolve_block`, so K block steps are bitwise K single steps."""
    const_table = cfg.tree_spec.const_table(state.op.device)
    fitness = _cached_fitness(
        state, lambda o, a: _eval_fitness(cfg, o, a, X, y, weight, const_table),
        probe=_probe_fn(cfg, X, const_table))
    return advance(cfg, state, fitness)


def advance(cfg: GPConfig, state: GPState, fitness) -> GPState:
    """The rest of a classic generation once the population's fitness
    f32[P] is known: champion tracking, the elite cache, selection and
    breeding (`evolve.next_generation`). The device step and the host
    generation loop (`GPSession`'s streamed and scalar runs) share it,
    so they take the same step."""
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


def _island_tables(cfg: GPConfig, dev):
    """(probs f32[I, 4], tourn draw size, tourn int32[I], point rate
    f32[I]): the heterogeneous-search tables of the batched breeder, as
    device constants."""
    icfg = cfg.island
    tourn_max, tourn = icfg.tourn_table(cfg.tourn_size)
    return (constant(icfg.prob_table(cfg.mix), dev), tourn_max, constant(tourn, dev),
            constant(icfg.point_rate_table(), dev))


def _island_step_body(cfg: GPConfig, state: GPState, X, y, weight) -> GPState:
    """One generation of the island layout: one evaluation of the
    flattened [I·P, N] population (one kernel call), one batched breeding
    step with per-island operator parameters, then migration across the
    island axis (`islands.migrate_local`)."""
    I, P, N = state.op.shape
    dev = state.op.device
    const_table = cfg.tree_spec.const_table(dev)
    fitness = _eval_fitness(cfg, state.op.reshape(I * P, N), state.arg.reshape(I * P, N),
                            X, y, weight, const_table).reshape(I, P)
    E = state.cache_op.shape[1]
    if E:
        # one hit gate for all islands, as the reference's single cond
        hit = _cache_hit(state)
        probe = _probe_fn(cfg, X, const_table)
        if probe is not None:
            hit = hit | _semantic_hit(
                (state.op[:, :E].reshape(-1, N), state.arg[:, :E].reshape(-1, N)),
                (state.cache_op.reshape(-1, N), state.cache_arg.reshape(-1, N)),
                state.cache_fit, probe)
        fitness = torch.cat([torch.where(hit, state.cache_fit, fitness[:, :E]),
                             fitness[:, E:]], 1)
    return advance_islands(cfg, state, fitness)


def advance_islands(cfg: GPConfig, state: GPState, fitness) -> GPState:
    """`advance` for the island layout, once the fitness f32[I, P] is
    known: per-island champions, the elite cache, one batched breeding
    step with each island's operator parameters
    (`evolve.make_island_breeder`), then migration across the island
    axis (`islands.migrate_local`)."""
    from repro_torch.core import islands as isl

    icfg = cfg.island
    I, P, N = state.op.shape
    # per-island champion tracking on RAW fitness (first minimum)
    i_best = torch.argmin(fitness, dim=1, keepdim=True)  # [I, 1]
    cand_fit = torch.gather(fitness, 1, i_best)[:, 0]
    rows = i_best[:, :, None].expand(I, 1, N)
    cand_op = torch.gather(state.op, 1, rows)[:, 0]
    cand_arg = torch.gather(state.arg, 1, rows)[:, 0]
    improved = (cand_fit < state.best_fitness)[:, None]
    best_op = torch.where(improved, cand_op, state.best_op)
    best_arg = torch.where(improved, cand_arg, state.best_arg)
    best_fit = torch.minimum(cand_fit, state.best_fitness)

    sel_fitness = fitness
    if cfg.parsimony:
        sizes = tree_sizes(state.op.reshape(I * P, N)).reshape(I, P)
        sel_fitness = fitness + cfg.parsimony * sizes.float()

    E = state.cache_op.shape[1]
    cache_op, cache_arg, cache_fit = (
        _new_cache(state, fitness, sel_fitness, E) if E
        else (state.cache_op, state.cache_arg, state.cache_fit))

    probs, tourn_max, tourn, p_point = _island_tables(cfg, state.op.device)
    breed = ev.make_island_breeder(cfg.tree_spec, tourn_max, cfg.elitism)
    keys, new_op, new_arg = breed(state.key, state.op, state.arg, sel_fitness, probs,
                                  tourn, p_point)
    if icfg.migrate_k and I > 1:
        e_op, e_arg = isl.island_elites(state.op, state.arg, fitness, icfg.migrate_k)
        new_op, new_arg = isl.migrate_local(icfg, new_op, new_arg, e_op, e_arg,
                                            state.generation, cand_fit)
    return GPState(keys, new_op, new_arg, fitness, best_op, best_arg, best_fit,
                   state.generation + 1, cache_op, cache_arg, cache_fit)


def _step_body_any(cfg: GPConfig, state: GPState, X, y, weight) -> GPState:
    """Layout dispatch: the classic body or the island-batched body."""
    if cfg.island.islands > 1:
        return _island_step_body(cfg, state, X, y, weight)
    return _step_body(cfg, state, X, y, weight)


def evolve_step(cfg: GPConfig, state: GPState, X, y, weight=None) -> GPState:
    """One generation. X: [F, D] feature-major, y: [D]; `weight` (f32[D]
    or None) masks dataset-padding points out of fitness. Island-batched
    states run the island body."""
    return _step_body_any(cfg, state, X, y, weight)


_FROZEN_ROW = np.zeros(_tc.N_COUNTERS, np.int32)
_FROZEN_ROW[_tc.FROZEN] = 1


def _counter_row(cfg: GPConfig, state: GPState, done=None):
    """int32[C] telemetry row for one generation (columns:
    repro_torch.obs.counters), computed from the PRE-step state. A frozen
    step reports [0, 0, 1, 0, 0, 0, 0]. On the island layout the cache
    gate is the one all-island predicate (`evals` = I·P − hit·I·E) and
    `migrations` is I on a generation where migration is due. The dedup
    columns come from `eval.dedup_stats` on the pre-step (flattened)
    population: 0 when dedup is off, on heap genomes, and (saved) on
    overflow."""
    dev = state.op.device
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    I = cfg.island.islands
    E = state.cache_op.shape[-2]
    if E:
        hit = _cache_hit(state).to(torch.int32)
        queries = zero + 1
    else:
        hit, queries = zero, zero
    evals = I * cfg.pop_size - hit * (I * E)
    migrations = zero
    if I > 1 and cfg.island.migrate_k:
        every = cfg.island.migrate_every
        due = (state.generation % every) == (every - 1)
        migrations = due.to(torch.int32) * I
    if cfg.dedup == "off" or cfg.tree_spec.genome != "postfix":
        saved = uniq = zero
    else:
        N = cfg.tree_spec.num_nodes
        o, a = state.op.reshape(-1, N), state.arg.reshape(-1, N)
        cap = _eval.resolve_dedup_cap(cfg.dedup_cap, o.shape[0], N)
        uniq, saved = _eval.dedup_stats(o, a, cfg.tree_spec, cap)
    row = torch.stack([hit, queries, zero, migrations, evals, saved, uniq])
    if done is None:
        return row
    return torch.where(done, constant(_FROZEN_ROW, dev), row)


def _block_done(cfg: GPConfig, state: GPState, i: int, limit):
    """Branch-free freeze predicate for step `i` of a block: True once
    `best_fitness` has reached `cfg.stop_fitness` or `i` has reached the
    dynamic `limit` (a device int32 step budget). On the island layout
    the best fitness is the min over islands: any island reaching the
    bar stops the run."""
    done = torch.zeros((), dtype=torch.bool, device=state.op.device)
    if cfg.stop_fitness is not None:
        best = state.best_fitness
        if best.dim():
            best = best.min()
        done = best <= float(np.float32(cfg.stop_fitness))
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
    `best_fitness` stream f32[n_steps] (f32[n_steps, I], a column per
    island, on the island layout), counters the int32[n_steps, 7]
    telemetry stream. Steps freeze into no-ops once `cfg.stop_fitness`
    is reached or the step index reaches `limit` (device int32; None =
    run all `n_steps`); a frozen step still runs and is discarded."""
    can_freeze = cfg.stop_fitness is not None or limit is not None
    hist, rows = [], []
    s = state
    for i in range(n_steps):
        nxt = _step_body_any(cfg, s, X, y, weight)
        done = _block_done(cfg, s, i, limit)
        rows.append(_counter_row(cfg, s, done if can_freeze else None))
        if can_freeze:
            nxt = _freeze(done, s, nxt)
        hist.append(nxt.best_fitness)
        s = nxt
    return s, torch.stack(hist), torch.stack(rows)


# --- streaming chunked fitness ------------------------------------------------


def _stream_kernel(cfg: GPConfig):
    kern = fit.get_kernel(cfg.fitness.kernel)
    if kern.moments is None:
        raise ValueError(
            f"fitness kernel {kern.name!r} defines no moment pass "
            f"(moments/reduce_moments), so it cannot accumulate across data "
            f"chunks; register it through the two-pass protocol or evaluate "
            f"monolithic")
    return kern


def _on(a, dev):
    """A chunk array (numpy, or a tensor; None passes) as a tensor on `dev`."""
    if a is None or isinstance(a, torch.Tensor):
        return a if a is None else a.to(dev)
    return torch.from_numpy(np.asarray(a)).to(dev)


def chunked_moments(cfg: GPConfig, op, arg, dataset, const_table=None, *,
                    impl: str | None = None):
    """Phase-1 moments of the WHOLE streamed dataset: fold every chunk of
    `dataset` (a `data/loader.ChunkedDataset`, or any iterable of
    fixed-shape `(X_fm, y, weight)` chunks) into an f32[P, M] accumulator
    on the population's device through the backend's `stream_moments`.
    Each chunk is placed on that device in turn and dropped after its
    step, so the device holds one chunk plus the accumulator whatever the
    total rows. The fold seeds with zeros (the merge identity); finalize
    with `chunked_fitness` or `reduce_moments`."""
    from repro_torch.gp.backends import get_backend

    dev = op.device
    backend = get_backend(impl or cfg.eval_impl, dev)
    kern = _stream_kernel(cfg)
    if backend.stream_moments is None:
        raise ValueError(f"eval backend {backend.name!r} exposes no "
                         f"stream_moments pass and cannot fold data chunks")
    if const_table is None:
        const_table = cfg.tree_spec.const_table(dev)
    acc = torch.zeros((op.shape[0], kern.n_moments), dtype=torch.float32, device=dev)
    for X, y, weight in dataset:
        acc = backend.stream_moments(acc, op, arg, _on(X, dev), _on(y, dev), const_table,
                                     cfg.tree_spec, cfg.fitness, weight=_on(weight, dev),
                                     data_tile=cfg.data_tile)
    return acc


def chunked_fitness(cfg: GPConfig, op, arg, dataset, const_table=None, *,
                    impl: str | None = None):
    """f32[P] fitness of every tree against a chunked data stream:
    `chunked_moments` folded over the chunks, finalized ONCE by the
    kernel's `reduce_moments`. Bitwise the monolithic fitness for the
    decomposable kernels on lattice data (their merge is an exact sum),
    within 1e-4 for pearson/r2, for any chunking including a ragged
    zero-weight-padded final chunk (tests/test_torch_stream.py)."""
    kern = _stream_kernel(cfg)
    m = chunked_moments(cfg, op, arg, dataset, const_table, impl=impl)
    return kern.reduce_moments(m, cfg.fitness)
