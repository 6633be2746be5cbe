"""Island-model evolution on one device, in PyTorch.

Port of the single-device half of `repro/core/islands.py`. An evolution
run is I islands of P trees (`op: int32[I, P, N]`): independent
sub-populations with decorrelated keys, cross-pollinated by periodic
elite migration. The engine evaluates the flattened [I·P, N] population
in one kernel call, breeds the islands as one batch
(`evolve.make_island_breeder`) and routes elites across the island axis
here (`migrate_local`). On a mesh (`launch/mesh.py`) `migrate_sharded`
routes the island layout across pods and `migrate` is the classic
layout's pod ring; both take the per-shard tensors of one pod-axis group
in pod-rank order, the mesh's single-controller form of the reference's
per-shard functions and their collectives.

`IslandConfig` also carries the heterogeneous-search knobs: per-island
operator mixes, tournament sizes and point-mutation rates, which become
the [I]-leading tables the batched breeder takes.

Topologies (`IslandConfig.topology`):

  ring            island i's elites replace the last-k offspring slots
                  of island (i+1) mod I
  torus           islands on the squarest 2D grid of I (`torus_grid`);
                  migration events alternate east / south shifts
  broadcast-best  the island holding the generation's best tree sends
                  its elites to every island

Migration is a branch-free select on `generation % migrate_every`, so a
generation runs the same tensor ops whether or not migration is due.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.evolve import OperatorMix
from repro_torch.launch import mesh as _mesh

TOPOLOGIES = ("ring", "torus", "broadcast-best")


@dataclasses.dataclass(frozen=True)
class IslandConfig:
    """Island layout + migration policy + per-island search knobs.

    islands        number of islands I (1 = the classic single-population
                   layout; the state keeps its un-batched shapes)
    migrate_every  generations between migration events
    migrate_k      elites exchanged per event (replace the receiving
                   island's last k offspring slots)
    topology       "ring" | "torus" | "broadcast-best"
    mixes          optional per-island OperatorMix tuple (len == islands);
                   None = GPConfig.mix everywhere
    tourn_sizes    optional per-island tournament sizes; None =
                   GPConfig.tourn_size everywhere
    point_rates    optional per-island point-mutation redraw
                   probabilities; None = 0.25 everywhere
    """

    islands: int = 1
    migrate_every: int = 10
    migrate_k: int = 4
    topology: str = "ring"
    mixes: tuple = None
    tourn_sizes: tuple = None
    point_rates: tuple = None

    def __post_init__(self):
        if self.topology not in TOPOLOGIES:
            raise ValueError(f"unknown island topology {self.topology!r}; "
                             f"one of {TOPOLOGIES}")
        if self.islands < 1:
            raise ValueError(f"islands must be >= 1, got {self.islands}")
        if self.migrate_every < 1:
            raise ValueError(f"migrate_every must be >= 1, got "
                             f"{self.migrate_every}")
        if self.migrate_k < 0:
            raise ValueError(f"migrate_k must be >= 0, got {self.migrate_k}")
        for name in ("mixes", "tourn_sizes", "point_rates"):
            val = getattr(self, name)
            if val is not None:
                object.__setattr__(self, name, tuple(val))
                if len(getattr(self, name)) != self.islands:
                    raise ValueError(f"IslandConfig.{name} has "
                                     f"{len(getattr(self, name))} entries for "
                                     f"{self.islands} islands")

    def __hash__(self):
        return hash((self.islands, self.migrate_every, self.migrate_k,
                     self.topology, self.mixes, self.tourn_sizes,
                     self.point_rates))

    # --- heterogeneous-search parameter tables (host numpy) -----------------

    def prob_table(self, default_mix: OperatorMix) -> np.ndarray:
        """f32[I, 4] operator-mix probabilities per island."""
        mixes = self.mixes or (default_mix,) * self.islands
        return np.stack([m.probs() for m in mixes])

    def tourn_table(self, default_size: int) -> tuple[int, np.ndarray]:
        """(draw size = max over islands, int32[I] per-island active sizes)."""
        sizes = self.tourn_sizes or (default_size,) * self.islands
        return int(max(sizes)), np.asarray(sizes, np.int32)

    def point_rate_table(self) -> np.ndarray:
        """f32[I] per-island point-mutation redraw probabilities."""
        rates = self.point_rates or (0.25,) * self.islands
        return np.asarray(rates, np.float32)


def torus_grid(islands: int) -> tuple[int, int]:
    """The squarest (rows, cols) factorization of `islands`, the grid the
    torus topology routes on. Prime counts degenerate to (1, I): a ring."""
    r = 1
    for d in range(int(np.sqrt(islands)), 0, -1):
        if islands % d == 0:
            r = d
            break
    return r, islands // r


def take_island(state, idx: int):
    """Island `idx`'s slice of an island-batched state (a NamedTuple of
    tensors): leaves with a leading island axis lose it, scalar leaves
    (the shared generation counter) pass through. The inverse of
    `splice_island`."""
    return type(state)(*(a[idx] if a.dim() else a for a in state))


def splice_island(state, idx: int, sub):
    """Replace island slot `idx` of an island-batched state with `sub`
    (one island's un-batched leaves, as `take_island` gives them).
    Leaves whose rank matches the batched leaf's (shared scalars) keep
    the batched value. Returns a new state; the input is not modified."""
    def put(a, v):
        if a.dim() == v.dim():
            return a
        out = a.clone()
        out[idx] = v.to(a.device, a.dtype)
        return out

    return type(state)(*(put(a, v) for a, v in zip(state, sub)))


def island_elites(op, arg, fitness, k: int):
    """Per-island top-k trees of the just-evaluated population, best
    first (a stable sort: ties keep the lower slot, as `jnp.argsort`).

    op/arg: int32[I, P, N], fitness: f32[I, P] → int32[I, k, N] pairs."""
    order = torch.argsort(fitness, dim=-1, stable=True)[:, :k]
    idx = order[:, :, None].expand(-1, -1, op.shape[-1])
    return torch.gather(op, 1, idx), torch.gather(arg, 1, idx)


def _route_local(icfg: IslandConfig, elite_op, elite_arg, event_idx, fit_best):
    """[I, k, N] elites → the [I, k, N] arrivals each island receives,
    per `icfg.topology`. `event_idx` (int tensor) is the migration-event
    counter (torus alternates direction on its parity); `fit_best`
    (f32[I]) picks broadcast-best's champion (first index on ties)."""
    I = elite_op.shape[0]
    if icfg.topology == "ring":
        return torch.roll(elite_op, 1, 0), torch.roll(elite_arg, 1, 0)
    if icfg.topology == "torus":
        r, c = torus_grid(I)
        even = event_idx % 2 == 0

        def shift(x):
            g = x.reshape(r, c, *x.shape[1:])
            east = torch.roll(g, 1, 1).reshape(x.shape)
            south = torch.roll(g, 1, 0).reshape(x.shape)
            return torch.where(even, east, south)

        return shift(elite_op), shift(elite_arg)
    champ = torch.argmin(fit_best).reshape(1)
    return (torch.index_select(elite_op, 0, champ).expand_as(elite_op),
            torch.index_select(elite_arg, 0, champ).expand_as(elite_arg))


def migrate_local(icfg: IslandConfig, new_op, new_arg, elite_op, elite_arg,
                  generation, fit_best):
    """Single-device island migration.

    new_op/new_arg: int32[I, P, N], the bred next generation.
    elite_op/elite_arg: int32[I, k, N], each island's best k trees of
    the just-evaluated population (`island_elites`). generation: the
    int32 generation counter (a 0-d tensor). fit_best: f32[I], each
    island's best fitness this generation. When a migration comes due
    every island's last k offspring slots take the routed arrivals;
    otherwise the generation passes through unchanged (a select, so the
    same ops run every generation)."""
    k = icfg.migrate_k
    if k <= 0 or new_op.shape[0] <= 1:
        return new_op, new_arg
    event_idx = torch.div(generation, icfg.migrate_every, rounding_mode="floor")
    inc_op, inc_arg = _route_local(icfg, elite_op, elite_arg, event_idx, fit_best)
    due = (generation % icfg.migrate_every) == (icfg.migrate_every - 1)
    mig_op = torch.cat([new_op[:, :-k], inc_op], 1)
    mig_arg = torch.cat([new_arg[:, :-k], inc_arg], 1)
    return torch.where(due, mig_op, new_op), torch.where(due, mig_arg, new_arg)


def _due(every: int, generation, is_receiver):
    """A migration lands on this shard this generation: it is due, and
    the shard holds the receiving slots (`is_receiver`, a bool)."""
    return ((generation % every) == (every - 1)) & is_receiver


def migrate_sharded(icfg: IslandConfig, new_op, new_arg, elite_op, elite_arg,
                    generation, fit_best, is_receiver):
    """Island migration on a mesh: pods x in-device islands. Over several
    processes `launch.mesh.over` hands it the whole pod group (the remote
    pods' values fetched first), so its `all_gather`s and `ppermute`s
    cross the processes with the single controller's results.

    Every argument is a list over one pod-axis group (one entry a pod,
    in pod-rank order; one entry without a pod axis), each entry that
    shard's tensor: new_op/new_arg int32[I_local, P_local, N] (its model
    rank's slice of the pod's islands, bred), elite_op/elite_arg
    int32[I_local, k, N] and fit_best f32[I_local] (the same on every
    model rank of a pod), generation the 0-d counter and is_receiver a
    bool: the shard holds each island's last k offspring slots. Returns
    (new_op, new_arg) lists.

      ring            the global ring in pod-major order: local islands
                      roll in-device; local island 0 receives the
                      previous pod's last island
      torus           grid = (pods x local islands): east rolls
                      in-device (a 1-wide row takes the pod ring), south
                      takes the previous pod's elites; events alternate
      broadcast-best  each pod's champion is gathered over the pods and
                      the best of them (first on ties) goes everywhere
    """
    k = icfg.migrate_k
    n_pods = len(new_op)
    I_local = new_op[0].shape[0]
    if k <= 0 or I_local * n_pods <= 1:
        return new_op, new_arg
    every = icfg.migrate_every
    ring = [(i, (i + 1) % n_pods) for i in range(n_pods)]

    if icfg.topology == "broadcast-best":
        champ = [torch.argmin(f).reshape(1) for f in fit_best]
        c_fit = [f.index_select(0, c)[0] for f, c in zip(fit_best, champ)]
        c_op = [e.index_select(0, c)[0] for e, c in zip(elite_op, champ)]
        c_arg = [e.index_select(0, c)[0] for e, c in zip(elite_arg, champ)]
        if n_pods > 1:
            g = [torch.argmin(f).reshape(1) for f in _mesh.all_gather(c_fit)]
            c_op = [x.index_select(0, j)[0] for x, j in zip(_mesh.all_gather(c_op), g)]
            c_arg = [x.index_select(0, j)[0] for x, j in zip(_mesh.all_gather(c_arg), g)]
        inc = [(o.expand_as(e), a.expand_as(e)) for o, a, e in zip(c_op, c_arg, elite_op)]
    elif n_pods == 1:  # in-device islands only
        event_idx = torch.div(generation[0], every, rounding_mode="floor")
        inc = [_route_local(icfg, elite_op[0], elite_arg[0], event_idx, fit_best[0])]
    else:
        east = [(torch.roll(o, 1, 0), torch.roll(a, 1, 0))
                for o, a in zip(elite_op, elite_arg)]
        if icfg.topology == "ring":
            last = zip(_mesh.ppermute([e[-1] for e in elite_op], ring),
                       _mesh.ppermute([e[-1] for e in elite_arg], ring))
            inc = [(torch.cat([lo[None], eo[1:]]), torch.cat([la[None], ea[1:]]))
                   for (lo, la), (eo, ea) in zip(last, east)]
        else:  # torus
            south = list(zip(_mesh.ppermute(elite_op, ring),
                             _mesh.ppermute(elite_arg, ring)))
            if I_local == 1:  # a 1-wide row: east is the pod ring too
                east = south
            inc = []
            for g, (eo, ea), (so, sa) in zip(generation, east, south):
                alt = torch.div(g, every, rounding_mode="floor") % 2 == 0
                inc.append((torch.where(alt, eo, so), torch.where(alt, ea, sa)))
    out_op, out_arg = [], []
    for op, arg, (i_op, i_arg), gen, rec in zip(new_op, new_arg, inc, generation,
                                                is_receiver):
        due = _due(every, gen, rec)
        out_op.append(torch.where(due, torch.cat([op[:, :-k], i_op], 1), op))
        out_arg.append(torch.where(due, torch.cat([arg[:, :-k], i_arg], 1), arg))
    return out_op, out_arg


def migrate(cfg, op_local, arg_local, elite_op, elite_arg, generation, is_receiver):
    """The classic layout's pod ring on a mesh (islands=1, the population
    sharded over pods; over processes as `migrate_sharded`): the pod
    slices are the islands, and every
    `migrate_every` generations each pod's `migrate_k` best trees go to
    the next pod, replacing its receiving shard's last k offspring.

    Every argument is a list over one pod-axis group in pod-rank order:
    op_local/arg_local int32[P_local, N] (the shard's bred slice),
    elite_op/elite_arg int32[k, N] (its pod's best k of the evaluated
    population), generation the 0-d counter, is_receiver a bool (one
    model rank a pod). Returns (op, arg) lists."""
    n_pods = len(op_local)
    if n_pods <= 1:
        return op_local, arg_local
    k = cfg.migrate_k
    perm = [(i, (i + 1) % n_pods) for i in range(n_pods)]
    mig_op = _mesh.ppermute(elite_op, perm)
    mig_arg = _mesh.ppermute(elite_arg, perm)
    out_op, out_arg = [], []
    for op, arg, m_op, m_arg, gen, rec in zip(op_local, arg_local, mig_op, mig_arg,
                                              generation, is_receiver):
        due = _due(cfg.migrate_every, gen, rec)
        out_op.append(torch.where(due, torch.cat([op[:-k], m_op]), op))
        out_arg.append(torch.where(due, torch.cat([arg[:-k], m_arg]), arg))
    return out_op, out_arg
