"""GPSession — the front door of the port.

Port of the single-device subset of `repro/gp/session.py`:

    from repro_torch.gp import GPSession

    GPSession(pop_size=200, kernel="r").fit(X_rows, y)          # on the card
    GPSession(pop_size=200, device="cpu").fit(X_rows, y)        # on the CPU

The session owns data ingestion (feature-major transposition + device
placement), state init, the generation loop, early stopping and
best-tree decoding. The loop runs in evolution blocks: `evolve()` calls
`engine.evolve_block` (K generations with no host read-back) and
synchronises with the device once per block, reading back the final
generation counter, the [K] best-fitness history and the [K, 7] counter
stream in one copy. The block size is min(callback period, block_size,
remaining generations), phase-aligned to the absolute generation, and
one block length serves every ragged boundary through the dynamic
`limit`. `stats["host_syncs"]` counts the synchronisations, ≤ ⌈G/K⌉.

Every fitness kernel of the reference runs here, the two-pass `pearson`
and `r2` included, and `init(seeds=)`/`fit(seeds=)` seed the first slots
with parsed expressions.

`islands=I` (with `migrate_every=`, `migrate_k=`, `island_topology=`,
`island_mixes=`, `island_tourn_sizes=`, `island_point_rates=`) runs I
islands of `pop_size` trees: one kernel call a generation on the
flattened I·P population, the per-island best-fitness streams in
`island_history`. `checkpoint_dir=` saves every `checkpoint_every`
generations (block boundaries land on the period) in the reference's
on-disk layout and `init()` resumes from the newest checkpoint there.
`tracer=` (an `obs.Tracer`) records ingest/init/block/checkpoint spans
and `metrics=` (an `obs.Metrics`) the counters and gauges; neither
changes a trajectory.

Streaming, for datasets larger than the device's memory:
`chunk_rows=` (here or on `ingest`) evaluates the data as a fold over
fixed `[F, chunk_rows]` zero-weight-padded chunks, and `ingest(stream=)`
takes a `data/loader.ChunkedDataset`, a memmapped array, or a callable
or iterator of `(X, y[, weight])` row blocks (`data/datasets.stream_rows`
gives the paper's 5.5M-row stream). The device holds one chunk at a
time. Streamed runs and the host-only `scalar` backend (the paper's
1-CPU_SP baseline, `backend="scalar"`) advance one generation per host
step (`_host_span`, one host sync a generation) and take the same
step as the device loop.

`export_island`/`import_island`/`adopt_state` swap one island's
sub-state in and out of a live island run between blocks (the
multi-tenant scheduler's surface, `repro_torch.service`).

A mesh (`topology=MeshTopology(data=2, model=2, pod=2)`, or a
`launch/mesh.Mesh`) shards the run in this one process: the dataset's
columns over `data` (rows padded to the axis with zero weight, `n_rows`
the real count), the population over `model`, and the classic layout's
sub-populations or the island layout's islands over `pod`
(`engine.sharded_evolve_step`/`_block`). The shards go to the cards in
turn (all on one card when there is one; `device="cpu"` puts them on the
CPU), blocks still read the host once, and the global state lives on
the mesh's first device. Streamed sessions on a mesh fold each chunk
across the data axis (`engine.build_stream_fold`). After
`launch.cluster.init_cluster()` the same session runs with one process a
card: each process builds the same mesh over every process's cards,
holds its own shards, reads the host once a block, and returns the same
global state and history as one process would.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.core import fitness as fit
from repro_torch.core import primitives as prim
from repro_torch.core import prng
from repro_torch.core.engine import GPConfig, GPState
from repro_torch.core.trees import to_string
from repro_torch.data.loader import feature_major
from repro_torch.device import resolve_device
from repro_torch.gp import backends as _backends
from repro_torch.launch import mesh as _mesh
from repro_torch.obs import counters as _tc
from repro_torch.obs.metrics import BlockMonitor, Metrics
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.runtime.fault import StepMonitor

_TREE_KEYS = ("max_depth", "n_features", "n_consts", "fn_set", "p_const",
              "grow_p_fn", "genome")
_FIT_KEYS = ("kernel", "n_classes", "precision")
# flat spellings of IslandConfig fields (migrate_every/migrate_k ride the
# GPConfig aliases)
_ISLAND_KEYS = {"islands": "islands", "island_topology": "topology",
                "island_mixes": "mixes", "island_tourn_sizes": "tourn_sizes",
                "island_point_rates": "point_rates"}


@dataclasses.dataclass(frozen=True)
class MeshTopology:
    """Device-mesh shape for a sharded run.

    data   splits the dataset's columns (X f32[F, D], y and the padding
           mask f32[D]); each shard's [P, M] fitness moments are merged
           across this axis (the two-pass protocol, so every registered
           kernel, pearson and r2 included, shards here). Rows that do
           not divide it are zero-weight padded by `GPSession.ingest`.
    model  splits the population's rows; selection gathers the pod's
           fitness and parent pool.
    pod    island parallelism: with islands=1 each pod's slice is an
           independent sub-population with elite ring migration; with
           islands=I > 1 the pod axis splits the islands (I/pod a pod),
           migration composed across both levels.

    Declarative: `build(device)` makes the `launch/mesh.Mesh`, its
    shards on the cards of `device` in turn (`make_host_mesh`; once a
    cluster is up, on every process's cards, each process holding its
    own shards)."""

    data: int = 1
    model: int = 1
    pod: int = 1

    def build(self, device=None) -> _mesh.Mesh:
        return _mesh.make_host_mesh(data=self.data, model=self.model, pod=self.pod,
                                    device=device)


def make_config(config: GPConfig | None = None, **overrides) -> GPConfig:
    """GPConfig from flat keyword overrides — tree/fitness/island sub-spec
    keys (max_depth, kernel, islands, island_topology, ...) land on the
    right nested dataclass."""
    config = config if config is not None else GPConfig()
    tree_kw = {k: overrides.pop(k) for k in _TREE_KEYS if k in overrides}
    fit_kw = {k: overrides.pop(k) for k in _FIT_KEYS if k in overrides}
    island_kw = {v: overrides.pop(k) for k, v in _ISLAND_KEYS.items() if k in overrides}
    if island_kw:
        config = dataclasses.replace(
            config, island=dataclasses.replace(config.island, **island_kw))
    fn_set = tree_kw.get("fn_set")
    if isinstance(fn_set, str):
        tree_kw["fn_set"] = prim.FunctionSet.make(tuple(fn_set.split(",")))
    elif isinstance(fn_set, (list, tuple)):
        tree_kw["fn_set"] = prim.FunctionSet.make(tuple(fn_set))
    if tree_kw:
        config = dataclasses.replace(
            config, tree_spec=dataclasses.replace(config.tree_spec, **tree_kw))
    if fit_kw:
        config = dataclasses.replace(
            config, fitness=dataclasses.replace(config.fitness, **fit_kw))
    if overrides:
        config = dataclasses.replace(config, **overrides)
    fit.get_kernel(config.fitness.kernel)  # unknown kernels fail here
    return config


class GPSession:
    """Owns one GP run: config + backend + device + state + loop.

    Lifecycle: `ingest(X, y)` → `init(key=)` → `evolve(n)` (or `fit`,
    which chains all three). `device=` (default: the card) places the
    data and state; the `auto` backend is `cuda` there and `torch` on
    the CPU. `history` (floats, one per generation run: the min over
    islands), `island_history` (an f32[I] row per generation of an
    island run), `counter_history` (that generation's telemetry row from
    `evolve()`) and `stats` are host-side and free to read."""

    _STOP_CHECK_SPAN = 32  # block cap when only stop_fitness is armed

    def __init__(self, config: GPConfig | None = None, *, backend: str | None = None,
                 device=None, topology=None, checkpoint_dir: str | None = None,
                 checkpoint_every: int = 10, feature_names=None, callback=None,
                 callback_every: int = 1, block_size: int | None = None,
                 chunk_rows: int | None = None, tracer=None, metrics=None, **overrides):
        self.device = resolve_device(device)
        self._mesh = None
        if isinstance(topology, MeshTopology):
            self._mesh = topology.build(self.device)
        elif isinstance(topology, _mesh.Mesh):
            self._mesh = topology
        elif topology is not None:
            raise TypeError(f"topology must be a MeshTopology or a "
                            f"repro_torch.launch.mesh.Mesh, got {type(topology).__name__}")
        if self._mesh is not None:
            self.device = self._mesh.home  # where the global state lives
        explicit_features = (config is not None or "tree_spec" in overrides
                             or "n_features" in overrides)
        self._cfg = make_config(config, **overrides)
        self._backend = _backends.get_backend(backend or self._cfg.eval_impl,
                                              self.device)
        if self._backend.name == "cuda" and self.device.type != "cuda":
            raise ValueError("backend 'cuda' runs the CUDA kernel and needs a CUDA "
                             "device; use backend='torch' with device='cpu'")
        if self._backend.jittable:
            self._cfg = dataclasses.replace(self._cfg, eval_impl=self._backend.name)
        if self._mesh is not None and not self._backend.supports_topology:
            raise ValueError(f"backend {self._backend.name!r} does not support "
                             f"mesh topologies (host-only)")
        self._step_fn = None  # the mesh's generation step
        self._block_cache = {}  # n_steps -> the mesh's block
        self._built_for = None  # the config the mesh programs were built for
        self._stream_fold = None  # the mesh's chunk fold (engine.build_stream_fold)
        self._explicit_features = explicit_features
        self._X = self._y = self._weight = None
        self._chunk_rows = chunk_rows  # default for ingest(chunk_rows=)
        self._stream = None  # ChunkedDataset when the dataset is streamed
        self._n_rows = 0
        self._gen_host = 0  # host mirror of state.generation (no device read)
        self._gen_dirty = False  # mirror stale (raw evolve_block + stop_fitness)
        self.state: GPState | None = None
        self.history: list[float] = []
        self.island_history: list[np.ndarray] = []
        self.counter_history: list[list[int]] = []
        self.stats = {"host_syncs": 0, "blocks": 0, "block_s_ema": None,
                      "stragglers": [], "cache_hits": 0, "cache_queries": 0,
                      "cache_hit_rate": 0.0, "frozen": 0, "migrations": 0,
                      "tree_evals": 0, "tree_row_evals": 0}
        # observability is host-side only: the generation step is the same
        # with or without it, so enabling it changes no trajectory
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.metrics = metrics if metrics is not None else Metrics()
        self._monitor = StepMonitor()  # per-block wall time EMA + stragglers
        self._block_monitor = BlockMonitor(self._monitor, self.metrics, self.stats)
        self._last_counters = None  # device [K, C] from a raw evolve_block
        self.feature_names = list(feature_names) if feature_names else None
        self._callback = callback
        self._callback_every = max(1, int(callback_every))
        self._block_size = block_size
        self._manager = None
        if checkpoint_dir:
            from repro_torch.ckpt.checkpoint import CheckpointManager

            self._manager = CheckpointManager(checkpoint_dir, every=checkpoint_every)

    # --- introspection -------------------------------------------------------

    @property
    def config(self) -> GPConfig:
        return self._cfg

    @property
    def backend(self) -> str:
        return self._backend.name

    @property
    def generation(self) -> int:
        return int(self.state.generation) if self.state is not None else 0

    @property
    def islands(self) -> int:
        """Number of islands in the population layout (1 = classic)."""
        return self._cfg.island.islands

    @property
    def best_fitness(self) -> float:
        """Best fitness seen so far, the min over islands (one host sync)."""
        if self.state is None:
            return float("inf")
        return float(self.state.best_fitness.min())

    @property
    def island_best_fitness(self) -> np.ndarray:
        """f32[I] per-island champion fitness (one host sync)."""
        self._require_state()
        return np.atleast_1d(self.state.best_fitness.cpu().numpy())

    @property
    def n_rows(self) -> int:
        """Real data points ingested (0 before ingest; excludes the
        zero-weight padding a mesh adds)."""
        return self._n_rows

    @property
    def mesh(self):
        """The session's `launch/mesh.Mesh`, or None on one device."""
        return self._mesh

    def _pod_axis(self):
        return "pod" if self._mesh is not None and "pod" in self._mesh.axis_names else None

    def build_sharded_step(self):
        """(step_fn, specs) of the mesh generation step:
        step_fn(state, X, y, weight); `step()` drives it."""
        if self._mesh is None:
            raise ValueError("build_sharded_step needs a topology= mesh")
        return engine.sharded_evolve_step(self._cfg, self._mesh, pod_axis=self._pod_axis())

    def build_sharded_block(self, n_steps: int):
        """(block_fn, specs) of the K-generation mesh block:
        block_fn(state, X, y, weight, limit) -> (state, history,
        counters); `evolve()` drives it."""
        if self._mesh is None:
            raise ValueError("build_sharded_block needs a topology= mesh")
        return engine.sharded_evolve_block(self._cfg, self._mesh, n_steps=n_steps,
                                           pod_axis=self._pod_axis())

    def _mesh_step(self):
        """The mesh's step, built again only when the config changed."""
        if self._built_for != self._cfg:
            self._step_fn, _ = self.build_sharded_step()
            self._block_cache = {}
            self._built_for = self._cfg
        return self._step_fn

    # --- lifecycle -----------------------------------------------------------

    def ingest(self, X=None, y=None, *, layout: str = "rows", sample_weight=None,
               stream=None, chunk_rows: int | None = None) -> "GPSession":
        """Load the dataset onto the session's device. layout='rows' is
        [rows, features] (transposed to the paper's feature-major
        f32[F, D] form); layout='features' takes [features, rows].
        `sample_weight` (f32[D]) scales each point's contribution; 0.0
        excludes a point exactly.

        Streaming: `chunk_rows=` (here or on the constructor) evaluates
        X/y as a fold over fixed `[F, chunk_rows]` zero-weight-padded
        chunks, and `stream=` takes a `data/loader.ChunkedDataset`, a
        memmapped array, or a callable/iterator of `(X, y[, weight])` row
        blocks. The chunks stay on the host until the fold places each on
        the device; fitness equals the monolithic run's (bitwise for the
        decomposable kernels on lattice data, within 1e-4 for
        pearson/r2)."""
        with self.tracer.span("ingest"):
            if stream is not None or chunk_rows is not None or self._chunk_rows is not None:
                self._ingest_stream(X, y, layout=layout, sample_weight=sample_weight,
                                    stream=stream, chunk_rows=chunk_rows)
            else:
                self._ingest(X, y, layout=layout, sample_weight=sample_weight)
        self.metrics.gauge("rows", self._n_rows)
        return self

    def _set_features(self, F: int):
        spec = self._cfg.tree_spec
        if spec.n_features != F:
            if self._explicit_features:
                raise ValueError(f"TreeSpec.n_features={spec.n_features} but the "
                                 f"dataset has {F} features")
            self._cfg = dataclasses.replace(
                self._cfg, tree_spec=dataclasses.replace(spec, n_features=F))

    def _ingest(self, X, y, *, layout, sample_weight):
        self._stream = None
        if X is None or y is None:
            raise ValueError("ingest needs X and y (or stream=)")
        X = np.asarray(X, np.float32)
        y = np.asarray(y, np.float32)
        if layout == "rows":
            X_fm = feature_major(X)
        elif layout == "features":
            X_fm = np.ascontiguousarray(X)
        else:
            raise ValueError(f"layout must be 'rows' or 'features', got {layout!r}")
        F, D = X_fm.shape
        if y.shape != (D,):
            raise ValueError(f"y shape {y.shape} does not match {D} data points")
        self._set_features(F)
        if sample_weight is not None:
            sample_weight = np.asarray(sample_weight, np.float32)
            if sample_weight.shape != (D,):
                raise ValueError(f"sample_weight shape {sample_weight.shape} does "
                                 f"not match {D} data points")
        self._n_rows = D
        self._stream_fold = None
        if self._mesh is not None:
            from repro_torch.data.loader import pad_feature_major

            # pad the rows to the data axis; the zero-weight mask keeps
            # every fitness kernel exact, and sample weights compose with it
            X_fm, y, w = pad_feature_major(X_fm, y, self._mesh.axis_size("data"))
            if sample_weight is not None:
                w = w * np.pad(sample_weight, (0, w.shape[0] - D))
            self._mesh_step()  # an indivisible layout fails here
            P = _mesh.PartitionSpec
            self._X = self._mesh.split(X_fm, P(None, "data"))
            self._y = self._mesh.split(y, P("data"))
            self._weight = self._mesh.split(w, P("data"))
        else:
            self._X = torch.from_numpy(X_fm).to(self.device)
            self._y = torch.from_numpy(y).to(self.device)
            self._weight = (None if sample_weight is None
                            else torch.from_numpy(sample_weight).to(self.device))
        self._invalidate_elite_cache()

    def _ingest_stream(self, X, y, *, layout, sample_weight, stream, chunk_rows):
        """Streaming half of `ingest`: wrap the source in a fixed-shape
        `ChunkedDataset` (or adopt one), take n_features from it, and arm
        the per-generation chunk fold. On a mesh, `chunk_rows` rounds up
        to a multiple of the data axis and `engine.build_stream_fold`
        splits every chunk over it, as the mesh step splits the data."""
        from repro_torch.data.loader import ChunkedDataset

        if stream is not None and X is not None:
            raise ValueError("pass either X/y or stream=, not both")
        chunk_rows = chunk_rows if chunk_rows is not None else self._chunk_rows
        n_data = self._mesh.axis_size("data") if self._mesh is not None else 1
        if isinstance(stream, ChunkedDataset):
            ds = stream
            if chunk_rows is not None and int(chunk_rows) != ds.chunk_rows:
                raise ValueError(f"chunk_rows={chunk_rows} conflicts with the "
                                 f"ChunkedDataset's chunk_rows={ds.chunk_rows}")
            if ds.chunk_rows % n_data:
                raise ValueError(f"chunk_rows={ds.chunk_rows} must be a multiple of "
                                 f"the mesh data axis ({n_data})")
        else:
            if chunk_rows is None:
                raise ValueError("stream= needs chunk_rows= (constructor or "
                                 "ingest keyword), or pass a ChunkedDataset")
            rows = int(chunk_rows)
            rows += (-rows) % n_data  # on a mesh every chunk splits exactly
            ds = ChunkedDataset(stream if stream is not None else X, y,
                                chunk_rows=rows, layout=layout,
                                sample_weight=sample_weight)
        self._set_features(ds.n_features)
        self._stream = ds
        self._X = self._y = self._weight = None
        self._n_rows = ds.n_rows or 0
        self._stream_fold = (engine.build_stream_fold(self._cfg, self._mesh)
                             if self._mesh is not None else None)
        self._invalidate_elite_cache()

    def _invalidate_elite_cache(self):
        """New data invalidates the elite fitness cache."""
        if self.state is not None and self.state.cache_fit.numel():
            self.state = self.state._replace(
                cache_op=torch.zeros_like(self.state.cache_op),
                cache_arg=torch.zeros_like(self.state.cache_arg),
                cache_fit=torch.full_like(self.state.cache_fit, float("inf")))

    def init(self, *, key=None, seeds=None) -> "GPSession":
        """Fresh state from `key` (a port key, `core.prng.PRNGKey`;
        default PRNGKey(0), as in the reference), or the newest
        checkpoint when the session's checkpoint_dir holds one. `seeds`
        are expression strings (Karoo's customized seed populations),
        parsed against the session's TreeSpec and feature names into the
        first slots (of every island)."""
        if self._X is None and self._stream is None:
            raise ValueError("no dataset — call ingest()/fit() first")
        key = key if key is not None else prng.PRNGKey(0)
        with self.tracer.span("init"):
            self.state = engine.init_state(self._cfg, key, seeds=seeds,
                                           feature_names=self.feature_names,
                                           device=self.device)
            self.history = []
            self.island_history = []
            self.counter_history = []
            self._gen_host = 0
            self._gen_dirty = False
            if self._manager is not None:
                restored, step = self._manager.restore_latest(like=self.state)
                if restored is not None:
                    self.state = restored
                    self._gen_host = int(step)
        return self

    # --- slot-level state swap (the service scheduler's surface) -------------

    def _island_index(self, what: str, idx: int):
        self._require_state()
        if self.islands <= 1:
            raise ValueError(f"{what} needs an island-batched run (islands > 1)")
        if not 0 <= idx < self.islands:
            raise ValueError(f"island {idx} out of range [0, {self.islands})")

    def export_island(self, idx: int):
        """Island `idx`'s slice of the session state as an un-batched
        sub-state (the leading island axis dropped; the shared generation
        scalar rides along): what a multi-tenant scheduler lifts out of a
        batch when a slot's job finishes. No state is changed."""
        from repro_torch.core.islands import take_island

        self._island_index("export_island", idx)
        return take_island(self.state, idx)

    def import_island(self, idx: int, sub) -> "GPSession":
        """Replace island slot `idx` with `sub` (an `export_island` slice
        or any sub-state of the same shapes, e.g. a fresh one): the
        admission half of the slot swap, between blocks."""
        from repro_torch.core.islands import splice_island

        self._island_index("import_island", idx)
        self.state = splice_island(self.state, idx, sub)
        return self

    def adopt_state(self, state: GPState) -> "GPSession":
        """Install an externally built GPState (a restored checkpoint, a
        spliced batch, a reference state through
        `engine.state_from_numpy`) as the live state, on the session's
        device, and resynchronise the host generation mirror with one
        host read; the evolve loop continues from it."""
        self.state = GPState(*(t.to(self.device) for t in state))
        self._gen_host = int(self.state.generation)
        self._count_host_sync()
        self._gen_dirty = False
        return self

    def step(self) -> GPState:
        """One generation, unconditionally (no early-stop freeze). On the
        device path it does not synchronise; streamed datasets and
        host-only backends take the host step."""
        if self.state is None:
            self.init()
        if self._stream is not None or not self._backend.jittable:
            self.state = self._host_step(self.state)
        elif self._mesh is not None:
            self.state = self._mesh_step()(self.state, self._X, self._y, self._weight)
        else:
            self.state = engine.evolve_step(self._cfg, self.state, self._X, self._y,
                                            self._weight)
        self._gen_host += 1
        return self.state

    def evolve_block(self, n_steps: int):
        """Run `n_steps` generations with no host synchronisation; returns
        (state, history) with history the device f32[n_steps] stream. The
        counter stream stays on the device until
        `absorb_block_telemetry()`."""
        state, history, _ = self._dispatch_block(n_steps, n_steps)
        if self._cfg.stop_fitness is None:
            self._gen_host += n_steps
        else:
            self._gen_dirty = True
        return state, history

    def _dispatch_block(self, n_steps: int, limit: int):
        if self.state is None:
            self.init()
        if self._stream is not None:
            raise ValueError("streamed/chunked datasets advance one generation "
                             "per host-driven chunk fold; evolution blocks "
                             "need a device-resident dataset (drive the run "
                             "with evolve() instead)")
        if not self._backend.jittable:
            raise ValueError(f"backend {self._backend.name!r} is host-only; "
                             f"evolution blocks need a jittable backend")
        lim = torch.full((), limit, dtype=torch.int32, device=self.device)
        if self._mesh is not None:
            self._mesh_step()
            block_fn = self._block_cache.get(n_steps)
            if block_fn is None:
                block_fn = self._block_cache[n_steps] = self.build_sharded_block(n_steps)[0]
            self.state, history, counters = block_fn(self.state, self._X, self._y,
                                                     self._weight, lim)
        else:
            self.state, history, counters = engine.evolve_block(
                self._cfg, self.state, self._X, self._y, self._weight, lim,
                n_steps=n_steps)
        self._last_counters = counters
        return self.state, history, counters

    # --- telemetry accounting ------------------------------------------------

    def _count_host_sync(self, n: int = 1):
        self.stats["host_syncs"] += n
        self.metrics.inc("host_syncs", n)

    def _absorb_counters(self, rows):
        """Fold an int32[K, C] telemetry block into `stats` and the
        metrics registry (cache hits/queries and the hit rate, frozen
        steps, migrations, tree evaluations and × rows)."""
        tot = _tc.totals(rows)
        for name, v in tot.items():
            self.stats[name] = self.stats.get(name, 0) + v
            if v:
                self.metrics.inc(name, v)
        self.stats["cache_hit_rate"] = _tc.hit_rate(self.stats)
        self.metrics.gauge("cache_hit_rate", self.stats["cache_hit_rate"])
        self.stats["tree_row_evals"] += tot["tree_evals"] * self._n_rows
        if self._n_rows and tot["tree_evals"]:
            self.metrics.inc("tree_row_evals", tot["tree_evals"] * self._n_rows)
        self.metrics.emit("counters", **tot)

    def _record_host_eval(self, hit: int, queries: int, evals: int):
        """Host-loop twin of the device counter stream: the streamed and
        scalar generation loops gate the elite cache on the host, so the
        same telemetry columns (and trees × rows) land without device
        work."""
        if queries:
            self.stats["cache_queries"] += queries
            self.metrics.inc("cache_queries", queries)
        if hit:
            self.stats["cache_hits"] += hit
            self.metrics.inc("cache_hits", hit)
        self.stats["tree_evals"] += evals
        self.metrics.inc("tree_evals", evals)
        self.stats["tree_row_evals"] += evals * self._n_rows
        if self._n_rows and evals:
            self.metrics.inc("tree_row_evals", evals * self._n_rows)
        self.stats["cache_hit_rate"] = _tc.hit_rate(self.stats)

    def absorb_block_telemetry(self) -> dict:
        """Fold the latest raw `evolve_block()` counter stream into
        `stats` (one host sync) and return `stats`."""
        if self._last_counters is not None:
            rows = self._last_counters.cpu().numpy()
            self._last_counters = None
            self._count_host_sync()
            self._absorb_counters(rows)
        return self.stats

    def _eval_rows(self, op, arg):
        """Fitness f32[R] of genome rows [R, N] (device tensors) against
        the session's dataset, on the session's device: one backend call
        (host-only backends), or a chunk fold over the stream finalized
        once (`engine.chunked_fitness`) inside a `stream_fold` span. On a
        mesh each chunk is split over the data axis and folded by
        `engine.build_stream_fold` (a `chunk` span a chunk), the mesh
        step's reduction."""
        cfg = self._cfg
        if self._stream is None:
            return self._backend.fitness(
                op, arg, self._X, self._y, cfg.tree_spec.const_table(self.device),
                cfg.tree_spec, cfg.fitness, weight=self._weight, data_tile=cfg.data_tile)
        if self._stream_fold is not None:
            kern = fit.get_kernel(cfg.fitness.kernel)
            acc = torch.zeros((op.shape[0], kern.n_moments), dtype=torch.float32,
                              device=op.device)
            for X, y, w in self._stream:
                t0 = time.perf_counter()
                with self.tracer.span("chunk"):
                    acc = self._stream_fold(acc, op, arg, X, y, w)
                self.metrics.observe("chunk_s", time.perf_counter() - t0)
            fitness = kern.reduce_moments(acc, cfg.fitness)
        else:
            t0 = time.perf_counter()
            with self.tracer.span("stream_fold"):
                fitness = engine.chunked_fitness(cfg, op, arg, self._stream,
                                                 impl=self._backend.name)
            self.metrics.observe("stream_fold_s", time.perf_counter() - t0)
        n = self._stream.n_rows
        if n is not None and n != self._n_rows:  # a callable source's first pass
            self._n_rows = n
            self.metrics.gauge("rows", n)
        return fitness

    def _host_step(self, state: GPState) -> GPState:
        """One generation of the host loop (streamed datasets, host-only
        backends): the elite-cache gate is read on the host and a hit
        skips the head rows' evaluation, as the reference's host step
        does; the rest is `engine.advance`/`advance_islands`, the device
        step's own tail. Island states evaluate the flattened [I·P]
        population in one call."""
        cfg = self._cfg
        N = state.op.shape[-1]
        P = state.op.shape[-2]
        lead = state.op.shape[:-2]  # () or (I,)
        I = cfg.island.islands
        E = state.cache_op.shape[-2]
        hit = bool(E) and bool(engine._cache_hit(state))
        head = E if hit else 0
        fitness = self._eval_rows(state.op[..., head:, :].reshape(-1, N),
                                  state.arg[..., head:, :].reshape(-1, N))
        fitness = fitness.reshape(*lead, P - head)
        if hit:
            fitness = torch.cat([state.cache_fit, fitness], -1)
        self._record_host_eval(int(hit), 1 if E else 0, I * (P - head))
        if I > 1:
            return engine.advance_islands(cfg, state, fitness)
        return engine.advance(cfg, state, fitness)

    def _host_span(self, remaining: int):
        """One generation of the host loop (streamed datasets, host-only
        backends; each generation already synchronises, so blocks would
        buy nothing) -> (best f32[1] or [1, I], stopped), for `_drive`."""
        # the block monitor wraps every loop path (a host generation is a
        # one-step block), so block_s_ema/stragglers report here too
        with self._block_monitor:
            self.step()
        bf = self.state.best_fitness.cpu().numpy()
        self._count_host_sync()
        best = float(bf.min()) if bf.ndim else float(bf)
        stop = self._cfg.stop_fitness
        return bf[None], stop is not None and best <= stop

    def _block_span(self, remaining: int) -> int:
        """Block size K = min(checkpoint period, callback period, explicit
        block_size, remaining), phase-aligned to the absolute generation
        counter, so saves land on multiples of the checkpoint period."""
        k = remaining
        if self._manager is not None:
            every = self._manager.every
            k = min(k, every - self._gen_host % every)
        if self._callback is not None:
            k = min(k, self._callback_every - self._gen_host % self._callback_every)
        if self._block_size is not None:
            k = min(k, self._block_size)
        return max(1, k)

    def _block_quantum(self, total: int) -> int:
        """Block length run for every block: the smallest configured
        period, so ragged boundaries run the same loop with a `limit`."""
        periods = [p for p in (
            self._manager.every if self._manager is not None else None,
            self._callback_every if self._callback is not None else None,
            self._block_size) if p is not None]
        if periods:
            return max(1, min(periods))
        if self._cfg.stop_fitness is not None:
            return max(1, min(total, self._STOP_CHECK_SPAN))
        return max(1, total)

    def _resync_gen(self):
        if self._gen_dirty:
            self._gen_host = int(self.state.generation)
            self._count_host_sync()
            self._gen_dirty = False

    def _read_block(self, history, counters):
        """ONE device→host copy: generation, history ([K] or [K, I]) and
        counters packed into one int32 buffer (history as its f32 bits)."""
        buf = torch.cat([self.state.generation.reshape(1),
                         history.contiguous().view(torch.int32).reshape(-1),
                         counters.reshape(-1)]).cpu().numpy()
        K, n = history.shape[0], history.numel()
        hist = buf[1:1 + n].view(np.float32).reshape(history.shape)
        return int(buf[0]), hist, buf[1 + n:].reshape(K, -1)

    def _block_run(self, remaining: int, quantum: int):
        """One device block of at most `remaining` generations and its
        one host synchronisation -> (best f32[ran] or [ran, I], stopped),
        for `_drive`."""
        K = min(self._block_span(remaining), quantum)
        prev_gen = self._gen_host
        block_idx = self.stats["blocks"]
        # the monitor times the dispatch THROUGH the block's one read
        with self._block_monitor, self.tracer.span(
                "block", args={"k": K, "quantum": quantum}), \
                self.tracer.maybe_profile(block_idx):
            _, history, counters = self._dispatch_block(quantum, K)
            gen_now, hist, crows = self._read_block(history, counters)
        self._count_host_sync()
        self._last_counters = None
        self._absorb_counters(crows)
        ran = gen_now - prev_gen
        self._gen_host = gen_now
        self.metrics.gauge("generation", gen_now)
        if ran and self._monitor.last:
            self.metrics.gauge("gens_per_s", ran / self._monitor.last)
        self.counter_history.extend(crows[:ran].tolist())
        rows = hist[:ran]
        best = rows.min(axis=1) if rows.ndim == 2 else rows
        stop = self._cfg.stop_fitness
        return rows, ran < K or bool(stop is not None and ran
                                     and best[ran - 1] <= np.float32(stop))

    def _drive(self, total: int, run_span):
        """The generation loop of `evolve`, shared by the device blocks
        and the host loop: `run_span(remaining)` runs up to `remaining`
        generations with one host sync and returns (best fitness of each
        generation it ran, f32[ran] or [ran, I] for islands; whether the
        run stops). History, checkpoints and the callback run here, at
        span boundaries."""
        self._resync_gen()
        target = self._gen_host + total
        while self._gen_host < target:
            rows, stopped = run_span(target - self._gen_host)
            gen_now = self._gen_host
            if rows.ndim == 2:  # island run: keep the per-island streams too
                self.island_history.extend(rows.copy())
                rows = rows.min(axis=1)
            self.history.extend(float(b) for b in rows)
            if self._manager is not None:
                with self.tracer.span("checkpoint"):
                    self._manager.maybe_save(self.state, gen_now)
            if self._callback is not None and len(rows) and (
                    gen_now % self._callback_every == 0 or stopped or gen_now >= target):
                self._callback(gen_now - 1, self.state)
            if stopped:
                break

    def evolve(self, generations: int | None = None) -> GPState:
        """Drive `generations` generations (default: config.generations)
        in blocks: one block of tensor ops and one host synchronisation
        per block (a streamed dataset or a host-only backend: one
        generation per host step). Checkpoints, the callback, history and
        the stop check run at block boundaries; a run with a
        checkpoint_dir ends with a save of its last generation."""
        if self.state is None:
            self.init()
        cfg = self._cfg
        total = generations if generations is not None else cfg.generations
        if self._stream is not None or not self._backend.jittable:
            self._drive(total, self._host_span)
        else:
            quantum = self._block_quantum(total)
            self._drive(total, lambda remaining: self._block_run(remaining, quantum))
        if self._manager is not None:
            # final save, unless the last block boundary already saved here
            with self.tracer.span("checkpoint"):
                self._manager.wait()
                if (not self._manager.saved_steps
                        or self._manager.saved_steps[-1] != self._gen_host):
                    self._manager.maybe_save(self.state, self._gen_host, force=True)
                self._manager.wait()
        return self.state

    def fit(self, X, y, *, layout: str = "rows", generations: int | None = None,
            key=None, seeds=None, warm_start: bool = False) -> "GPSession":
        """ingest + init + evolve. With warm_start=True an existing evolved
        state continues on the new data instead of reinitializing."""
        self.ingest(X, y, layout=layout)
        if self.state is None or not warm_start:
            self.init(key=key, seeds=seeds)
        self.evolve(generations)
        return self

    # --- results -------------------------------------------------------------

    def _champion_rows(self):
        """(best_op, best_arg) device rows of the overall champion: for an
        island run the best across islands (first index on ties)."""
        self._require_state()
        s = self.state
        if s.best_fitness.dim():
            i = torch.argmin(s.best_fitness).reshape(1)
            return s.best_op.index_select(0, i)[0], s.best_arg.index_select(0, i)[0]
        return s.best_op, s.best_arg

    def _champion(self):
        op, arg = self._champion_rows()
        return op.cpu().numpy(), arg.cpu().numpy()

    def _decode(self, op, arg) -> str:
        return to_string(op, arg, feature_names=self.feature_names,
                         const_table=self._cfg.tree_spec.const_table_numpy(),
                         genome=self._cfg.tree_spec.genome)

    def best_expression(self) -> str:
        """The champion tree decoded to an infix string — the best across
        all islands for an island run (one host sync)."""
        return self._decode(*self._champion())

    def island_expressions(self) -> list[str]:
        """Each island's champion decoded to an infix string (a length-1
        list for the classic layout) — one host sync."""
        self._require_state()
        best_op = np.atleast_2d(self.state.best_op.cpu().numpy())
        best_arg = np.atleast_2d(self.state.best_arg.cpu().numpy())
        return [self._decode(o, a) for o, a in zip(best_op, best_arg)]

    def predict(self, X, *, layout: str = "rows") -> np.ndarray:
        """Best tree evaluated on new data: X [rows, features] (or
        [features, rows] with layout='features') -> f32[rows] on the host."""
        self._require_state()
        X = np.asarray(X, np.float32)
        X_fm = feature_major(X) if layout == "rows" else X
        spec = self._cfg.tree_spec
        best_op, best_arg = self._champion_rows()
        preds = self._backend.evaluate(
            best_op[None], best_arg[None],
            torch.from_numpy(np.ascontiguousarray(X_fm)).to(self.device),
            spec.const_table(self.device), spec)
        return preds[0].cpu().numpy()

    def score(self, X, y, *, layout: str = "rows") -> float:
        """The fitness kernel's human-facing metric (`FitnessKernel.metric`)
        of the best tree on (X, y): fraction correct for classify/match,
        mean |err| for regression, 1 - r² for pearson, R² for r2."""
        preds = torch.from_numpy(self.predict(X, layout=layout))[None]
        metric = fit.get_kernel(self._cfg.fitness.kernel).metric(
            preds, torch.from_numpy(np.asarray(y, np.float32)), self._cfg.fitness)
        return float(metric[0])

    def _require_state(self):
        if self.state is None:
            raise ValueError("session has no evolved state — call fit() first")

    # --- dataset convenience -------------------------------------------------

    @classmethod
    def from_dataset(cls, dataset: str, *, max_rows: int | None = None,
                     config: GPConfig | None = None, **kw) -> "GPSession":
        """Session pre-loaded with one of the paper's datasets, kernel and
        function set defaulted from its metadata."""
        from repro_torch.data.datasets import BY_NAME

        X_rows, y, meta = BY_NAME[dataset]()
        if max_rows is not None and X_rows.shape[0] > max_rows:
            X_rows, y = X_rows[:max_rows], y[:max_rows]
        if config is None:
            kw.setdefault("name", f"karoo-{dataset}")
            kw.setdefault("kernel", meta["kernel"])
            if "n_classes" in meta:
                kw.setdefault("n_classes", meta["n_classes"])
            kw.setdefault("fn_set", prim.KITCHEN_SINK if meta["kernel"] == "r"
                          else prim.CLASSIFY_SET)
            kw.setdefault("feature_names", meta.get("features"))
        sess = cls(config, **kw)
        return sess.ingest(X_rows, y)
