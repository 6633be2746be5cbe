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
`advance_islands`, the same tail as the device step.

On a mesh (`launch/mesh.py`, single-controller) `sharded_evolve_step`
and `sharded_evolve_block` run the reference's `shard_map` bodies shard
by shard:

    data axis   dataset columns split; each shard's f32[P*, M] moments
                are merged over the axis (`_merge_moments_on_mesh`: a
                psum, a hoisted psum, or a gather and an in-order fold)
                and finalized
    model axis  population rows split; selection gathers the pod's
                fitness and parent pool
    pod axis    the classic layout's sub-populations with ring
                migration, or the island layout's islands
                (`islands.migrate`, `islands.migrate_sharded`)

A shard's data-axis replicas hold the same population slice: after the
merge, each (pod, model) slice's step runs once, on its data-rank-0
shard (its lead), and its result is copied to the replicas; the leads
on one device breed in one batched call, so 8 shards on one card
launch one breeding's ops, not four. `build_stream_fold` is the mesh's
streaming fold.

Inside a block nothing may synchronise with the host: no `.item()`,
`bool(t)`, `int(t)`, boolean-mask indexing or `torch.nonzero` on a
device tensor, and no copy of a host table to the card (device tables
come from `repro_torch.device.constant`, made before the first block).
"""
from __future__ import annotations

import dataclasses
import math
import warnings
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
from repro_torch.launch import mesh as _mesh
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


def _eval_moments(cfg: GPConfig, op, arg, X, y, weight, const_table):
    """Phase 1 of the two-pass fitness protocol on the backend registered
    under `cfg.eval_impl`: f32[P, M] weighted moment partials of THIS
    shard's data, for the mesh step to merge across the data axis. Dedup
    engages per shard (each shard dedups its own population slice),
    bitwise like the single-device path."""
    from repro_torch.gp.backends import get_backend

    backend = get_backend(cfg.eval_impl, op.device)
    if backend.moments is None:
        raise ValueError(
            f"eval backend {backend.name!r} exposes no moment pass and cannot "
            f"evaluate fitness under a data-sharded mesh")
    return backend.moments(op, arg, X, y, const_table, cfg.tree_spec, cfg.fitness,
                           weight=weight, data_tile=cfg.data_tile,
                           **_dedup_kwargs(cfg, backend.moments))


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


def _island_champions(state, fitness):
    """Per-island champion tracking on RAW fitness f32[I, P] (first
    minimum) -> (this generation's best f32[I], best_op, best_arg,
    best_fitness): the island step's and the tenant step's."""
    I, _, N = state.op.shape
    i_best = torch.argmin(fitness, dim=1, keepdim=True)  # [I, 1]
    cand_fit = torch.gather(fitness, 1, i_best)[:, 0]
    rows = i_best[:, :, None].expand(I, 1, N)
    improved = (cand_fit < state.best_fitness)[:, None]
    best_op = torch.where(improved, torch.gather(state.op, 1, rows)[:, 0], state.best_op)
    best_arg = torch.where(improved, torch.gather(state.arg, 1, rows)[:, 0], state.best_arg)
    return cand_fit, best_op, best_arg, torch.minimum(cand_fit, state.best_fitness)


def advance_islands(cfg: GPConfig, state: GPState, fitness) -> GPState:
    """`advance` for the island layout, once the fitness f32[I, P] is
    known: per-island champions, the elite cache, one batched breeding
    step with each island's operator parameters
    (`evolve.make_island_breeder`), then migration across the island
    axis (`islands.migrate_local`)."""
    from repro_torch.core import islands as isl

    icfg = cfg.island
    I, P, N = state.op.shape
    cand_fit, best_op, best_arg, best_fit = _island_champions(state, fitness)

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


def _counter_row(cfg: GPConfig, state: GPState, done=None, *, mesh: bool = False,
                 n_pods: int = 1):
    """int32[C] telemetry row for one generation (columns:
    repro_torch.obs.counters), computed from the PRE-step state. A frozen
    step reports [0, 0, 1, 0, 0, 0, 0]. On the island layout the cache
    gate is the one all-island predicate (`evals` = I·P − hit·I·E) and
    `migrations` is I on a generation where migration is due. The dedup
    columns come from `eval.dedup_stats` on the pre-step (flattened)
    population: 0 when dedup is off, on heap genomes, and (saved) on
    overflow. With `mesh=True` the cache and dedup columns are 0 (mesh
    steps carry the cache untouched, and a per-shard signature sort for
    telemetry alone would double the plan's cost) and the classic
    layout counts `n_pods` pod-ring migrations when one is due."""
    dev = state.op.device
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    I = cfg.island.islands
    E = 0 if mesh else state.cache_op.shape[-2]
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
    elif I == 1 and mesh and n_pods > 1:
        every = cfg.migrate_every
        due = (state.generation % every) == (every - 1)
        migrations = due.to(torch.int32) * n_pods
    if mesh or cfg.dedup == "off" or cfg.tree_spec.genome != "postfix":
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


def run(cfg: GPConfig, X, y, key=None, generations: int | None = None,
        callback=None, seeds=None, feature_names=None, device=None) -> GPState:
    """DEPRECATED — thin forwarder to :class:`repro_torch.gp.GPSession`, kept
    so pre-session callers don't break. X is feature-major [F, D] (the old
    contract); the session's own `fit` takes row-major data. `device` as
    the session's (None: the card)."""
    warnings.warn(
        "repro_torch.core.run is deprecated; use repro_torch.gp.GPSession "
        "(session = GPSession(cfg); session.fit(X_rows, y)) instead",
        DeprecationWarning, stacklevel=2)
    from repro_torch.gp import GPSession

    sess = GPSession(cfg, feature_names=feature_names, callback=callback, device=device)
    sess.ingest(X, y, layout="features")
    sess.init(key=key, seeds=seeds)
    sess.evolve(generations)
    return sess.state


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


# --- multi-tenant step (repro_torch.service) ------------------------------------


class TenantParams(NamedTuple):
    """Per-slot search and termination parameters of a multi-tenant
    batch, every leaf [I]-leading. Admission and eviction rewrite rows;
    the tenant block stays the same object.

        probs       f32[I, 4]   operator-mix probabilities per slot
        tourn       int32[I]    active tournament size (<= the draw size)
        point_rate  f32[I]      point-mutation rate
        kernel_id   int32[I]    index into the block's kernel tuple
        n_classes   f32[I]      classify arity (unused by other kernels)
        precision   f32[I]      match tolerance (unused by other kernels)
        stop        f32[I]      stop_fitness; -inf disables early stop
        budget      int32[I]    generation budget; 0 marks an EMPTY slot

    The block reads `kernel_id`, `n_classes` and `precision` from a host
    copy of the table (the service keeps one) to pick each slot's
    fitness kernel, so that choice never reads the device."""

    probs: torch.Tensor
    tourn: torch.Tensor
    point_rate: torch.Tensor
    kernel_id: torch.Tensor
    n_classes: torch.Tensor
    precision: torch.Tensor
    stop: torch.Tensor
    budget: torch.Tensor


class TenantState(NamedTuple):
    """Island-batched engine state of a multi-tenant batch: the GPState
    island layout with the shared `generation` scalar replaced by
    per-slot `gens_done` counters, so every leaf is batched and
    `islands.take_island`/`splice_island` move a whole job in one slice.

        key           int64[I, 2]     per-slot threefry key (a solo run's stream)
        op/arg        int32[I, P, N]
        fitness       f32[I, P]
        best_op/arg   int32[I, N]
        best_fitness  f32[I]
        gens_done     int32[I]
        cache_op/arg  int32[I, E, N]  per-slot elite fitness cache
        cache_fit     f32[I, E]
    """

    key: torch.Tensor
    op: torch.Tensor
    arg: torch.Tensor
    fitness: torch.Tensor
    best_op: torch.Tensor
    best_arg: torch.Tensor
    best_fitness: torch.Tensor
    gens_done: torch.Tensor
    cache_op: torch.Tensor
    cache_arg: torch.Tensor
    cache_fit: torch.Tensor


_TENANT_DTYPES = {**_STATE_DTYPES, "gens_done": np.int32}


def tenant_state_from_numpy(d, device=None) -> TenantState:
    """A TenantState from numpy leaves — a dict, or a reference
    `TenantState` (or a checkpoint snapshot's) whose leaves convert with
    `np.asarray`, key as uint32[I, 2] — bit for bit, on `device`
    (default: the card)."""
    if not isinstance(d, dict):
        d = d._asdict()
    dev = resolve_device(device)
    leaves = {}
    for name in TenantState._fields:
        a = np.asarray(d[name])
        if name == "key":
            leaves[name] = prng.key_from_numpy(a).to(dev)
        else:
            leaves[name] = torch.from_numpy(np.array(a, dtype=_TENANT_DTYPES[name])).to(dev)
    return TenantState(**leaves)


def tenant_state_to_numpy(state: TenantState) -> TenantState:
    """The state's leaves as numpy arrays in the reference's dtypes (key
    as uint32[I, 2]), still a TenantState — the checkpoint payload's
    form; the inverse of `tenant_state_from_numpy`."""
    return TenantState(*(
        prng.key_to_numpy(t) if name == "key"
        else t.detach().cpu().numpy().astype(_TENANT_DTYPES[name])
        for name, t in state._asdict().items()))


def tenant_active(state: TenantState, params: TenantParams):
    """bool[I]: the slots that still evolve — budget not exhausted and
    the early-stop bar (`params.stop`, -inf = disabled) not reached.
    Works on tensors and on host numpy alike."""
    return (state.gens_done < params.budget) & ~(state.best_fitness <= params.stop)


def _tenant_cache_width(elitism: int, pop_size: int, elite_cache: bool) -> int:
    """The tenant batch's cache width (the session engine's guard)."""
    return elitism if (elite_cache and 0 < elitism < pop_size) else 0


def init_tenant_slot(key, pop_size: int, spec: TreeSpec, elitism: int = 1,
                     elite_cache: bool = True) -> TenantState:
    """One job's fresh sub-state (un-batched leaves, for
    `islands.splice_island`) on the key's device. Keyed exactly like
    `init_state` with islands == 1 — split once, the population from the
    second half, the slot key from the first — so a packed job replays a
    solo session's stream bit for bit. `elitism`/`elite_cache` size the
    slot's cache and must match the block's."""
    dev = key.device
    k0, k1 = prng.split(key)
    op, arg = generate_population(k1, pop_size, spec)
    N = spec.num_nodes
    E = _tenant_cache_width(elitism, pop_size, elite_cache)

    def i32(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=dev)

    return TenantState(
        key=k0, op=op, arg=arg, fitness=torch.full((pop_size,), math.inf, device=dev),
        best_op=i32(N), best_arg=i32(N), best_fitness=torch.full((), math.inf, device=dev),
        gens_done=i32(), cache_op=i32(E, N), cache_arg=i32(E, N),
        cache_fit=torch.full((E,), math.inf, device=dev))


def empty_tenant_state(islands: int, pop_size: int, spec: TreeSpec, elitism: int = 1,
                       elite_cache: bool = True, device=None) -> TenantState:
    """An all-empty batch on `device` (default: the card); pair it with
    budget-0 TenantParams rows: empty slots never advance."""
    dev = resolve_device(device)
    I, P, N = islands, pop_size, spec.num_nodes
    E = _tenant_cache_width(elitism, pop_size, elite_cache)

    def i32(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=dev)

    def inf(*shape):
        return torch.full(shape, math.inf, device=dev)

    return TenantState(
        key=torch.zeros((I, 2), dtype=torch.int64, device=dev), op=i32(I, P, N),
        arg=i32(I, P, N), fitness=inf(I, P), best_op=i32(I, N), best_arg=i32(I, N),
        best_fitness=inf(I), gens_done=i32(I), cache_op=i32(I, E, N),
        cache_arg=i32(I, E, N), cache_fit=inf(I, E))


def tenant_configs(spec: TreeSpec, kernels: tuple, host: TenantParams, *,
                   eval_impl: str = "auto", dedup: str = "off",
                   dedup_cap: int = 0) -> list[GPConfig]:
    """Each slot's evaluation config from the HOST copy of the parameter
    table (`kernel_id`, `n_classes`, `precision` as numpy): the GPConfig
    a solo session of that job evaluates with, so the slot reaches the
    same backend dispatch (`_eval_fitness`) and the same kernels."""
    dedup = "off" if dedup == "off" else "exact"
    made = {}
    out = []
    for kid, nc, prec in zip(np.asarray(host.kernel_id), np.asarray(host.n_classes),
                             np.asarray(host.precision)):
        fs = fit.FitnessSpec(kernels[int(kid)], n_classes=int(nc), precision=float(prec))
        if fs not in made:
            made[fs] = GPConfig(tree_spec=spec, fitness=fs, eval_impl=eval_impl,
                                dedup=dedup, dedup_cap=dedup_cap)
        out.append(made[fs])
    return out


def _slot_cache_hit(state: TenantState):
    """bool[I]: each slot's elite-cache gate — its cached rows equal the
    head rows [:E] of its population (the reference's per-slot cond)."""
    E = state.cache_op.shape[1]
    return ((state.op[:, :E] == state.cache_op).flatten(1).all(1)
            & (state.arg[:, :E] == state.cache_arg).flatten(1).all(1))


def tenant_step(spec: TreeSpec, tourn_draw: int, elitism: int, state: TenantState,
                X, y, weight, params: TenantParams, cfgs: list, hit=None) -> TenantState:
    """One generation of the whole batch. X f32[I, F, Dc], y and weight
    f32[I, Dc]: every slot carries its own zero-weight-padded data, so
    jobs never evaluate each other's rows.

    Evaluation is a loop over the slots: slot i goes through
    `_eval_fitness` with its own config `cfgs[i]` (`tenant_configs`, from
    the host table), the dispatch a solo session takes, so a packed job's
    fitness is bitwise its solo run's (B1 for heap trees on the card; B2,
    or the unique table and B3/B4 with dedup, for postfix). Every slot is
    evaluated, empty and frozen ones included; the freeze discards their
    results. Then one batched step over [I, ...]: the per-slot
    elite-cache gate (`hit`, `_slot_cache_hit(state)` when None), per-slot
    champions and the next cache (`argsort(fitness)[:E]`, both on raw
    fitness), one breeding call (`evolve.make_island_breeder`, each
    slot's mix, tournament size and point rate) and the freeze,
    `where(active, new, prev)` with `active` from the pre-step state."""
    I = state.op.shape[0]
    const_table = spec.const_table(state.op.device)
    fitness = torch.stack([
        _eval_fitness(cfgs[i], state.op[i], state.arg[i], X[i], y[i], weight[i], const_table)
        for i in range(I)])
    E = state.cache_op.shape[1]
    if E:
        hit = _slot_cache_hit(state) if hit is None else hit
        fitness = torch.cat([torch.where(hit[:, None], state.cache_fit, fitness[:, :E]),
                             fitness[:, E:]], 1)
    _, best_op, best_arg, best_fit = _island_champions(state, fitness)
    cache_op, cache_arg, cache_fit = (
        _new_cache(state, fitness, fitness, E) if E
        else (state.cache_op, state.cache_arg, state.cache_fit))
    breed = ev.make_island_breeder(spec, tourn_draw, elitism)
    keys, new_op, new_arg = breed(state.key, state.op, state.arg, fitness, params.probs,
                                  params.tourn, params.point_rate)
    nxt = TenantState(keys, new_op, new_arg, fitness, best_op, best_arg, best_fit,
                      state.gens_done + 1, cache_op, cache_arg, cache_fit)
    active = tenant_active(state, params)
    return TenantState(*(torch.where(active.reshape(I, *(1,) * (p.dim() - 1)), n, p)
                         for p, n in zip(state, nxt)))


def _tenant_counter_row(state: TenantState, params: TenantParams, hit=None):
    """int32[C] telemetry row of one tenant generation, from the PRE-step
    state (columns: repro_torch.obs.counters); `hit` is the step's
    `_slot_cache_hit(state)` (None without a cache). Cache hits and queries
    count per active slot; FROZEN counts the inactive slots (finished,
    early-stopped or empty) whose compute runs and is discarded;
    TREE_EVALS sums each active slot's rows the cache does not serve.
    The dedup columns are 0, as in the reference."""
    E = state.cache_op.shape[1]
    P = state.op.shape[1]
    a32 = tenant_active(state, params).to(torch.int32)
    zero = torch.zeros((), dtype=torch.int32, device=state.op.device)
    if E:
        h32 = hit.to(torch.int32)
        hits = (h32 * a32).sum().to(torch.int32)
        queries = a32.sum().to(torch.int32)
    else:
        h32 = torch.zeros_like(a32)
        hits = queries = zero
    frozen = (1 - a32).sum().to(torch.int32)
    evals = (a32 * (P - h32 * E)).sum().to(torch.int32)
    return torch.stack([hits, queries, frozen, zero, evals, zero, zero])


def build_tenant_block(spec: TreeSpec, kernels: tuple, tourn_draw: int, elitism: int,
                       n_steps: int, *, dedup: str = "off", dedup_cap: int = 0,
                       eval_impl: str = "auto"):
    """The service's block: block(state, X, y, weight, params, host=None)
    -> (state, history f32[n_steps, I], counters int32[n_steps, C]),
    `n_steps` tenant generations with no host read (given `host`, the
    host copy of `params`). Kernel names are canonicalised (aliases
    collapse) here, and a kernel without a whole-dataset
    `partial_fitness` is refused, as the reference refuses it; so is a
    host-only backend (`scalar`), which cannot run inside a block.
    Eager PyTorch compiles nothing: the scheduler builds this closure
    once and rebinds its operands as jobs come and go."""
    from repro_torch.gp.backends import get_backend

    kernels = tuple(fit.get_kernel(k).name for k in kernels)
    for name in kernels:
        if fit.get_kernel(name).partial_fitness is None:
            raise ValueError(f"fitness kernel {name!r} has no whole-dataset "
                             f"partial_fitness; the tenant block cannot "
                             f"switch over it")
    if eval_impl != "auto" and not get_backend(eval_impl).jittable:
        raise ValueError(f"eval backend {eval_impl!r} is host-only and cannot run "
                         f"inside the tenant block; use a device backend "
                         f"(auto, cuda or torch)")

    def block(state: TenantState, X, y, weight, params: TenantParams,
              host: TenantParams | None = None):
        if host is None:
            host = TenantParams(*(t.cpu().numpy() for t in params))
        cfgs = tenant_configs(spec, kernels, host, eval_impl=eval_impl, dedup=dedup,
                              dedup_cap=dedup_cap)
        hist, rows = [], []
        s = state
        for _ in range(n_steps):
            hit = _slot_cache_hit(s) if s.cache_op.shape[1] else None
            rows.append(_tenant_counter_row(s, params, hit))
            s = tenant_step(spec, tourn_draw, elitism, s, X, y, weight, params, cfgs, hit)
            hist.append(s.best_fitness)
        return s, torch.stack(hist), torch.stack(rows)

    return block


# --- mesh-sharded step ------------------------------------------------------------

P = _mesh.PartitionSpec


def _merge_moments_on_mesh(kern, fit_spec, partial_m, y, weight):
    """Complete phase 1 across one data-axis group WITHOUT finalizing: the
    group's per-shard moment partials f32[P*, M] (a list in data-rank
    order, with each shard's y and weight) -> the merged moments, a copy
    on every shard's device (`_merge_moments`). The generation step
    finalizes them at the leads (`_mesh_fitness`); the streaming fold
    (`build_stream_fold`) merges them into its accumulator instead."""
    y_m = None
    if _hoists_y(kern):
        y_m = [_y_moments(kern, fit_spec, yy, ww) for yy, ww in zip(y, weight)]
    return _merge_moments(kern, fit_spec, partial_m, y_m)


def _hoists_y(kern) -> bool:
    """Does the data-axis merge psum each shard's y moments apart?"""
    return kern.combine_moments is None and bool(kern.y_moment_idx)


def _y_moments(kern, fit_spec, y, weight):
    """A shard's y moments [My], made where its y lives: a group sends
    these, not its y and weight, across processes."""
    return kern.y_moments(y.float(), fit._weights(y, weight), fit_spec)


def _merge_moments(kern, fit_spec, partial_m, y_m=None):
    """The data-axis merge of `partial_m` (with each shard's y moments
    `y_m` where `_hoists_y`), in three lowerings picked by the kernel's
    protocol surface:

      plain sum          psum of the whole [P*, M] partials (r/c/m/mse)
      + y-hoisting       a kernel with `y_moment_idx` and no
                         `combine_moments`: psum of the per-tree columns
                         [P*, Mt] and of each shard's `y_moments` [My],
                         reassembled by `scatter_tree_y`
      pairwise combine   kernels with a non-additive merge (pearson, r2):
                         gather the partials (each shard's y columns
                         once) and fold them with `combine_moments` in
                         data-rank order
    """
    if kern.combine_moments is None:
        if not kern.y_moment_idx:
            return _mesh.psum(partial_m)
        tree_m = _mesh.psum([p[..., list(kern.tree_moment_idx)] for p in partial_m])[0]
        merged = fit.scatter_tree_y(kern, tree_m, _mesh.psum(y_m)[0])
    else:
        if kern.y_moment_idx:
            # row 0's y columns are every row's (tree-independent by contract)
            tree_parts = _mesh.all_gather([p[..., list(kern.tree_moment_idx)]
                                           for p in partial_m])[0]
            y_parts = _mesh.all_gather([p[0, list(kern.y_moment_idx)]
                                        for p in partial_m])[0]
            parts = [fit.scatter_tree_y(kern, tree_parts[s], y_parts[s])
                     for s in range(len(partial_m))]
        else:
            parts = list(_mesh.all_gather(partial_m)[0])
        merged = fit.fold_moment_partials(kern, parts, fit_spec)
    return [merged.to(p.device) for p in partial_m]


def _merge_over(mesh, kern, fit_spec, data_axis, partial: dict, y, weight) -> dict:
    """`_merge_moments` over every data-axis group holding a shard of
    `partial` ({shard: partials}, this process's) -> {shard: the merged
    moments}: each shard's y moments are made where its y lives, and a
    group spanning processes sends the moments only."""
    def merge(p, m=None):
        return _merge_moments(kern, fit_spec, p, m)

    if not _hoists_y(kern):
        return _mesh.over(mesh, data_axis, merge, partial)
    y_m = {s: _y_moments(kern, fit_spec, y[s], weight[s]) for s in partial}
    return _mesh.over(mesh, data_axis, merge, partial, y_m)


def _moment_kernel(cfg: GPConfig, data_axis):
    kern = fit.get_kernel(cfg.fitness.kernel)
    if kern.moments is None:
        raise ValueError(
            f"fitness kernel {kern.name!r} defines no moment pass "
            f"(moments/reduce_moments), so nothing can be reduced across the "
            f"{data_axis!r} axis; register it through the two-pass protocol or "
            f"run single-device")
    return kern


def _mesh_fitness(cfg: GPConfig, kern, mesh, data_axis, op, arg, X, y, weight,
                  leads) -> dict:
    """{lead: f32[R]} for this process's `leads`: each of its shards' rows
    (op/arg, {shard: rows}) evaluated on the shard's data slice (one
    backend call a shard), the moments merged over each data-axis group
    and finalized at the leads."""
    partial = {s: _eval_moments(cfg, op[s], arg[s], X[s], y[s], weight[s],
                                cfg.tree_spec.const_table(mesh.devices[s]))
               for s in mesh.local}
    merged = _merge_over(mesh, kern, cfg.fitness, data_axis, partial, y, weight)
    return {s: kern.reduce_moments(merged[s], cfg.fitness) for s in leads}


def _mesh_tables(cfg: GPConfig, mesh) -> None:
    for dev in dict.fromkeys(mesh.devices[s] for s in mesh.local):
        _device_tables(cfg, dev)


def _by_device(mesh, leads) -> list:
    """The leads grouped by device, in shard order: the leads of a group
    breed in one batched call (a lead's rows are bitwise its own call's),
    so 8 shards on one card make one breeding's launches, not four."""
    groups = {}
    for s in leads:
        groups.setdefault(mesh.devices[s], []).append(s)
    return list(groups.values())


def _unbatch(x, group) -> dict:
    """{lead: its rows} of a batched breeding output, equal blocks in
    group order."""
    return dict(zip(group, x.chunk(len(group))))


def _sharded_step_builder(cfg: GPConfig, mesh, *, data_axis="data", model_axis="model",
                          pod_axis: str | None = None):
    """The classic layout's generation step on a mesh and its specs:
    (step, state_specs, data_spec, y_spec, w_spec). The population's rows
    are split over (pod, model); each pod's slices are one
    sub-population. step(states, X, y, weight) takes per-shard lists
    (`Mesh.split` under the specs) and returns {lead: GPState}, the next
    state of every data-axis group's lead shard (its data replicas hold
    the same).

    A lead gathers its pod's fitness and parent pool over the model
    axis; its pod's champion, gathered over the pods, gives the global
    champion. It breeds its own slice of P/(pod·model) offspring
    (elitism 0; batched with the other leads of its device) from the key
    folded with its pod rank, the generation and its model rank; model
    rank 0 re-seeds slot 0 with the pod's champion,
    and the pods exchange their best `migrate_k` over the pod ring
    (`islands.migrate`). The key is not advanced and the elite cache
    rides through untouched, as in the reference."""
    from repro_torch.core import islands as isl

    kern = _moment_kernel(cfg, data_axis)
    n_model = mesh.axis_size(model_axis)
    n_shards = n_model * mesh.axis_size(pod_axis)
    if cfg.pop_size % n_shards:
        raise ValueError(f"pop_size {cfg.pop_size} % population shards {n_shards} != 0")
    pod_dims = (pod_axis,) if pod_axis else ()
    pop_spec = P((*pod_dims, model_axis))
    state_specs = GPState(
        key=P(), op=pop_spec, arg=pop_spec, fitness=pop_spec, best_op=P(), best_arg=P(),
        best_fitness=P(), generation=P(), cache_op=P(), cache_arg=P(), cache_fit=P())
    n_local = cfg.pop_size // n_shards
    every_lead = [g[0] for g in mesh.groups(data_axis)]
    leads = [s for s in every_lead if mesh.is_local(s)]
    _mesh_tables(cfg, mesh)
    breeding = [(g, constant(np.tile(cfg.mix.probs(), (len(g), 1)), mesh.devices[g[0]]))
                for g in _by_device(mesh, leads)]

    def step(states, X, y, weight):
        fit_local = _mesh_fitness(cfg, kern, mesh, data_axis,
                                  {s: states[s].op for s in mesh.local},
                                  {s: states[s].arg for s in mesh.local}, X, y, weight, leads)
        st = {s: states[s] for s in leads}
        fit_g = _mesh.over(mesh, model_axis, _mesh.all_gather, fit_local, tiled=True)
        op_g = _mesh.over(mesh, model_axis, _mesh.all_gather,
                          {s: t.op for s, t in st.items()}, tiled=True)
        arg_g = _mesh.over(mesh, model_axis, _mesh.all_gather,
                           {s: t.arg for s, t in st.items()}, tiled=True)
        # the pod's champion (first minimum), then the best over the pods
        i = {s: torch.argmin(fit_g[s]).reshape(1) for s in leads}
        pod_op = {s: op_g[s].index_select(0, i[s])[0] for s in leads}
        pod_arg = {s: arg_g[s].index_select(0, i[s])[0] for s in leads}
        c_fit = {s: fit_g[s].index_select(0, i[s])[0] for s in leads}
        c_op, c_arg = pod_op, pod_arg
        if pod_axis:
            pods = [_mesh.over(mesh, pod_axis, _mesh.all_gather, c) for c in
                    (c_fit, c_op, c_arg)]
            j = {s: torch.argmin(pods[0][s]).reshape(1) for s in leads}
            c_fit, c_op, c_arg = ({s: x[s].index_select(0, j[s])[0] for s in leads}
                                  for x in pods)
        best, keys = {}, {}
        for s in leads:
            t = st[s]
            improved = c_fit[s] < t.best_fitness
            best[s] = (torch.where(improved, c_op[s], t.best_op),
                       torch.where(improved, c_arg[s], t.best_arg),
                       torch.minimum(c_fit[s], t.best_fitness))
            key = t.key
            if pod_axis:
                key = prng.fold_in(key, mesh.rank(s, pod_axis))
            keys[s] = prng.fold_in(prng.fold_in(key, t.generation), mesh.rank(s, model_axis))
        new_op, new_arg = {}, {}
        for group, probs in breeding:  # each lead's slice from its pod's pool
            o, a = ev.next_generation_arrays(
                torch.stack([keys[s] for s in group]), torch.cat([op_g[s] for s in group]),
                torch.cat([arg_g[s] for s in group]), torch.cat([fit_g[s] for s in group]),
                cfg.tree_spec, probs, cfg.tourn_size, elitism=0, n_out=n_local)
            new_op.update(_unbatch(o, group))
            new_arg.update(_unbatch(a, group))
        for s in leads:
            if cfg.elitism and mesh.rank(s, model_axis) == 0:  # the pod's own champion
                new_op[s] = torch.cat([pod_op[s][None], new_op[s][1:]])
                new_arg[s] = torch.cat([pod_arg[s][None], new_arg[s][1:]])
        if pod_axis and leads:  # a process with no lead takes part in no pod group
            order = {s: torch.argsort(fit_g[s], stable=True)[:cfg.migrate_k] for s in leads}
            new_op, new_arg = _mesh.over(
                mesh, pod_axis, lambda *a: isl.migrate(cfg, *a), new_op, new_arg,
                {s: op_g[s].index_select(0, order[s]) for s in leads},
                {s: arg_g[s].index_select(0, order[s]) for s in leads},
                {s: st[s].generation for s in leads},
                {s: mesh.rank(s, model_axis) == n_model - 1 for s in every_lead})
        return {s: GPState(st[s].key, new_op[s], new_arg[s], fit_local[s], *best[s],
                           st[s].generation + 1, st[s].cache_op, st[s].cache_arg,
                           st[s].cache_fit)
                for s in leads}

    return step, state_specs, P(None, data_axis), P(data_axis), P(data_axis)


def _sharded_island_step_builder(cfg: GPConfig, mesh, *, data_axis="data",
                                 model_axis="model", pod_axis: str | None = None):
    """The island layout's generation step on a mesh (cfg.island.islands =
    I > 1), with the classic builder's tuple contract: the global state
    is `op int32[I, P, N]` with the island axis split over the pods
    (I/pod islands a pod) and each island's population over the model
    axis. Evaluation flattens a shard's islands into one backend call;
    each lead gathers its islands' populations over the model axis,
    tracks their champions, breeds its slice of each island with the
    pod's rows of the per-island tables (`make_island_breeder(...,
    n_out=P/model, fold=model rank)`: the islands' keys advance the same
    on every model rank), re-seeds slot 0 with the island's champion on
    model rank 0, and routes migrants over both levels
    (`islands.migrate_sharded`)."""
    from repro_torch.core import islands as isl

    icfg = cfg.island
    I = icfg.islands
    kern = _moment_kernel(cfg, data_axis)
    n_pods = mesh.axis_size(pod_axis)
    if I % n_pods:
        raise ValueError(f"islands {I} % pod axis {n_pods} != 0 — the pod axis shards "
                         f"whole islands")
    n_model = mesh.axis_size(model_axis)
    if cfg.pop_size % n_model:
        raise ValueError(f"per-island pop_size {cfg.pop_size} % model axis {n_model} != 0")
    n_local = cfg.pop_size // n_model
    if icfg.migrate_k > n_local:
        raise ValueError(f"migrate_k {icfg.migrate_k} exceeds the last model rank's "
                         f"{n_local}-tree slice that receives migrants")
    pod = pod_axis
    pop_spec = P(pod, model_axis, None)
    state_specs = GPState(
        key=P(pod, None), op=pop_spec, arg=pop_spec, fitness=P(pod, model_axis),
        best_op=P(pod, None), best_arg=P(pod, None), best_fitness=P(pod),
        generation=P(), cache_op=P(pod, None, None), cache_arg=P(pod, None, None),
        cache_fit=P(pod, None))
    every_lead = [g[0] for g in mesh.groups(data_axis)]
    leads = [s for s in every_lead if mesh.is_local(s)]
    _mesh_tables(cfg, mesh)
    I_local = I // n_pods
    breeding = []  # (leads, their islands' table rows, each island's model rank)
    for g in _by_device(mesh, leads):
        dev = mesh.devices[g[0]]
        rows = np.concatenate([np.arange(I_local) + mesh.rank(s, pod_axis) * I_local
                               for s in g])
        ranks = np.repeat([mesh.rank(s, model_axis) for s in g], I_local)
        breeding.append((g, constant(rows, dev, np.int64), constant(ranks, dev, np.int64)))

    def step(states, X, y, weight):
        Il, Pl, N = states[mesh.local[0]].op.shape
        flat = _mesh_fitness(cfg, kern, mesh, data_axis,
                             {s: states[s].op.reshape(Il * Pl, N) for s in mesh.local},
                             {s: states[s].arg.reshape(Il * Pl, N) for s in mesh.local},
                             X, y, weight, leads)
        fit_local = {s: f.reshape(Il, Pl) for s, f in flat.items()}
        st = {s: states[s] for s in leads}
        fit_g = _mesh.over(mesh, model_axis, _mesh.all_gather, fit_local, dim=1, tiled=True)
        op_g = _mesh.over(mesh, model_axis, _mesh.all_gather,
                          {s: t.op for s, t in st.items()}, dim=1, tiled=True)
        arg_g = _mesh.over(mesh, model_axis, _mesh.all_gather,
                           {s: t.arg for s, t in st.items()}, dim=1, tiled=True)
        best, c_fit, c_op, c_arg, sel = {}, {}, {}, {}, {}
        for s in leads:
            t = st[s]
            i = torch.argmin(fit_g[s], dim=1, keepdim=True)  # [Il, 1]
            rows = i[:, :, None].expand(Il, 1, N)
            c_fit[s] = torch.gather(fit_g[s], 1, i)[:, 0]
            c_op[s] = torch.gather(op_g[s], 1, rows)[:, 0]
            c_arg[s] = torch.gather(arg_g[s], 1, rows)[:, 0]
            improved = (c_fit[s] < t.best_fitness)[:, None]
            best[s] = (torch.where(improved, c_op[s], t.best_op),
                       torch.where(improved, c_arg[s], t.best_arg),
                       torch.minimum(c_fit[s], t.best_fitness))
            sel[s] = fit_g[s]
            if cfg.parsimony:
                sizes = tree_sizes(op_g[s].reshape(Il * cfg.pop_size, N))
                sel[s] = sel[s] + cfg.parsimony * sizes.reshape(Il, cfg.pop_size).float()
        keys, new_op, new_arg = {}, {}, {}
        for group, rows, ranks in breeding:  # a lead's slice of each of its pod's islands
            probs, tourn_max, tourn, p_point = _island_tables(cfg, rows.device)
            breed = ev.make_island_breeder(cfg.tree_spec, tourn_max, elitism=0,
                                           n_out=n_local, fold=ranks)
            k, o, a = breed(*(torch.cat([x[s] for s in group]) for x in (
                {s: st[s].key for s in group}, op_g, arg_g, sel)),
                probs[rows], tourn[rows], p_point[rows])
            for out, x in ((keys, k), (new_op, o), (new_arg, a)):
                out.update(_unbatch(x, group))
        for s in leads:
            if cfg.elitism and mesh.rank(s, model_axis) == 0:  # each island's champion
                new_op[s] = torch.cat([c_op[s][:, None], new_op[s][:, 1:]], 1)
                new_arg[s] = torch.cat([c_arg[s][:, None], new_arg[s][:, 1:]], 1)
        if icfg.migrate_k and I > 1 and leads:
            elites = {s: isl.island_elites(op_g[s], arg_g[s], fit_g[s], icfg.migrate_k)
                      for s in leads}
            new_op, new_arg = _mesh.over(
                mesh, pod_axis, lambda *a: isl.migrate_sharded(icfg, *a), new_op, new_arg,
                {s: e[0] for s, e in elites.items()}, {s: e[1] for s, e in elites.items()},
                {s: st[s].generation for s in leads}, c_fit,
                {s: mesh.rank(s, model_axis) == n_model - 1 for s in every_lead})
        return {s: GPState(keys[s], new_op[s], new_arg[s], fit_local[s], *best[s],
                           st[s].generation + 1, st[s].cache_op, st[s].cache_arg,
                           st[s].cache_fit)
                for s in leads}

    return step, state_specs, P(None, data_axis), P(data_axis), P(data_axis)


def _pick_step_builder(cfg: GPConfig):
    return (_sharded_island_step_builder if cfg.island.islands > 1
            else _sharded_step_builder)


def _split_state(mesh, state: GPState, specs: GPState) -> list:
    """Per-shard states (a list over the shards, None for another
    process's shard)."""
    leaves = [mesh.split(t, spec) for t, spec in zip(state, specs)]
    return [GPState(*(leaf[s] for leaf in leaves)) if mesh.is_local(s) else None
            for s in range(mesh.size)]


def _join_state(mesh, states, specs: GPState) -> GPState:
    """The global state from per-shard states (a list over the shards or a
    {shard: GPState} dict; over several processes, every shard of this
    process): the state specs name no data axis, so the leads hold every
    block."""
    items = (states.items() if isinstance(states, dict) else
             [(s, t) for s, t in enumerate(states) if t is not None])
    return GPState(*(mesh.join({s: getattr(t, name) for s, t in items}, spec)
                     for name, spec in zip(GPState._fields, specs)))


def _replicate(mesh, data_axis, leads: dict, like=None) -> list:
    """Per-shard states from the leads': each data-axis group's lead
    state, copied to its replicas' devices; a group spanning processes
    broadcasts it from the lead's process (`like`, the per-shard states,
    gives the shapes to the others)."""
    out = [None] * mesh.size
    for group in mesh.groups(data_axis):
        local = [s for s in group if mesh.is_local(s)]
        if not local:
            continue
        lead = group[0]
        if len(mesh.group_procs(group)) > 1:
            src = _mesh.exchange(mesh, [lead], {lead: leads[lead]} if lead in local else {},
                                 like=like[local[0]], procs=mesh.group_procs(group))[lead]
        else:
            src = leads[lead]
        for s in local:
            out[s] = GPState(*(t.to(mesh.devices[s]) for t in src))
    return out


def _shards(mesh, x, spec) -> list:
    """A dataset array's per-shard parts: split under `spec`, taken as
    they are when already a list (`data/loader.shard_dataset`), or all
    None for an absent weight."""
    if x is None:
        return [None] * mesh.size
    return x if isinstance(x, list) else mesh.split(x, spec)


def sharded_evolve_step(cfg: GPConfig, mesh, *, data_axis="data", model_axis="model",
                        pod_axis: str | None = None):
    """A generation step for `mesh` -> (step_fn, specs dict).

    step_fn(state, X, y, weight=None) takes the global state (on any
    device) and X [F, D], y [D] and the f32[D] padding mask (global
    tensors, or per-shard lists from `shard_dataset`; D % data == 0),
    and returns the global next state on the mesh's home device. Classic
    layout (islands == 1): the population rows on (pod, model), best_*
    replicated. Island layout: the island axis on pod, each island's
    rows on model, best_* per island."""
    step, state_specs, data_spec, y_spec, w_spec = _pick_step_builder(cfg)(
        cfg, mesh, data_axis=data_axis, model_axis=model_axis, pod_axis=pod_axis)

    def run(state: GPState, X, y, weight=None) -> GPState:
        states = _split_state(mesh, state, state_specs)
        leads = step(states, _shards(mesh, X, data_spec), _shards(mesh, y, y_spec),
                     _shards(mesh, weight, w_spec))
        return _join_state(mesh, _replicate(mesh, data_axis, leads, states), state_specs)

    return run, dict(state=state_specs, X=data_spec, y=y_spec, weight=w_spec)


def sharded_evolve_block(cfg: GPConfig, mesh, *, n_steps: int, data_axis="data",
                         model_axis="model", pod_axis: str | None = None):
    """A K-generation evolution block for `mesh` -> (block_fn, specs dict).

    block_fn(state, X, y, weight, limit) -> (state, history, counters)
    runs `n_steps` generations shard by shard with no host read: the
    state is split once, each step's collectives join the shards'
    tensors on the devices, and the global state is joined at the end.
    Steps freeze as the single-device block's do (`limit`, a 0-d int32
    tensor or None, and `cfg.stop_fitness`); on the island layout the
    stop test is the min over each pod's islands, `pmin` over the pods,
    so every shard takes the same decision. history is f32[n_steps]
    (classic) or f32[n_steps, I] (island, joined over the pods), and
    counters the int32[n_steps, C] telemetry stream (cache and dedup
    columns 0), all on the home device."""
    island = cfg.island.islands > 1
    n_pods = mesh.axis_size(pod_axis)
    step, state_specs, data_spec, y_spec, w_spec = _pick_step_builder(cfg)(
        cfg, mesh, data_axis=data_axis, model_axis=model_axis, pod_axis=pod_axis)
    hist_spec = P(None, pod_axis) if island else P()

    def done(cur, i, limit):
        if not (island and cfg.stop_fitness is not None):
            return {s: _block_done(cfg, t, i, limit[s]) for s, t in cur.items()}
        best = _mesh.over(mesh, pod_axis, _mesh.pmin,
                          {s: t.best_fitness.min() for s, t in cur.items()})
        bar = float(np.float32(cfg.stop_fitness))
        return {s: b <= bar if limit[s] is None else (b <= bar) | (limit[s] <= i)
                for s, b in best.items()}

    def block(state: GPState, X, y, weight, limit):
        X, y, weight = (_shards(mesh, X, data_spec), _shards(mesh, y, y_spec),
                        _shards(mesh, weight, w_spec))
        lim = {s: None if limit is None else limit.to(mesh.devices[s]) for s in mesh.local}
        states = _split_state(mesh, state, state_specs)
        first = mesh.local[0]  # every shard holds the replicated counters
        hist, rows = [], []
        for i in range(n_steps):
            d = done({s: states[s] for s in mesh.local}, i, lim)
            rows.append(_counter_row(cfg, states[first], d[first], mesh=True, n_pods=n_pods))
            nxt = _replicate(mesh, data_axis, step(states, X, y, weight), states)
            states = [None if t is None else _freeze(d[s], t, nxt[s])
                      for s, t in enumerate(states)]
            hist.append({s: states[s].best_fitness for s in mesh.local})
        hist = mesh.join({s: torch.stack([h[s] for h in hist]) for s in mesh.local}, hist_spec)
        return _join_state(mesh, states, state_specs), hist, torch.stack(rows)

    return block, dict(state=state_specs, X=data_spec, y=y_spec, weight=w_spec,
                       limit=P(), history=P(None, pod_axis) if island else P(),
                       counters=P())


def build_stream_fold(cfg: GPConfig, mesh, *, data_axis: str = "data"):
    """The mesh fold step of streamed chunks: fold(acc, op, arg, X, y,
    weight) -> acc, with acc f32[R, M], op/arg replicated (global
    tensors) and the chunk's X [F, Dc], y and weight [Dc] (numpy or
    tensors; Dc % data == 0, `GPSession.ingest` rounds `chunk_rows` up)
    split over the data axis. The chunk's moments are completed across
    the axis by `_merge_moments_on_mesh` (the generation step's
    reduction) and merged into the accumulator by the kernel's merge;
    finalize the last accumulator once with `reduce_moments`. Every
    replica along model and pod would compute the same merged moments,
    so the fold evaluates on one data-axis group, the first shard's (over
    several processes, each process's first shard's group)."""
    kern = _stream_kernel(cfg)
    # over several processes each folds on its first shard's group
    firsts = {mesh.procs.index(q) for q in mesh.processes}
    shards = [s for g in mesh.groups(data_axis) if firsts & set(g) for s in g
              if mesh.is_local(s)]
    for dev in dict.fromkeys(mesh.devices[s] for s in shards):
        _device_tables(cfg, dev)

    def fold(acc, op, arg, X, y, weight):
        Xs = mesh.split(X, P(None, data_axis), shards=shards)
        ys = mesh.split(y, P(data_axis), shards=shards)
        ws = [None] * len(shards) if weight is None else mesh.split(
            weight, P(data_axis), shards=shards)
        partial, yd, wd = {}, {}, {}
        for i, s in enumerate(shards):
            d = mesh.devices[s]
            partial[s] = _eval_moments(cfg, op.to(d), arg.to(d), Xs[i], ys[i], ws[i],
                                       cfg.tree_spec.const_table(d))
            yd[s], wd[s] = ys[i], ws[i]
        merged = _merge_over(mesh, kern, cfg.fitness, data_axis, partial, yd, wd)
        return kern.merge_moments(acc, merged[mesh.local[0]].to(acc.device), cfg.fitness)

    return fold
