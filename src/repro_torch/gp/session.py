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

Not ported yet (each raises NotImplementedError naming its ROADMAP
item): islands, `topology=`, `chunk_rows=`/`stream=`, `checkpoint_dir=`,
`seeds=`, `tracer=`/`metrics=`, the `scalar` backend, `pearson`/`r2`.
"""
from __future__ import annotations

import dataclasses

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
from repro_torch.obs import counters as _tc

_TREE_KEYS = ("max_depth", "n_features", "n_consts", "fn_set", "p_const",
              "grow_p_fn", "genome")
_FIT_KEYS = ("kernel", "n_classes", "precision")
_NOT_PORTED = {
    "islands": "islands (core/islands.py)",
    "island_topology": "islands (core/islands.py)",
    "island_mixes": "islands (core/islands.py)",
    "island_tourn_sizes": "islands (core/islands.py)",
    "island_point_rates": "islands (core/islands.py)",
    "migrate_every": "islands (core/islands.py)",
    "migrate_k": "islands (core/islands.py)",
    "topology": "multi-GPU (MeshTopology)",
    "chunk_rows": "streaming (data/loader.py ChunkedDataset)",
    "stream": "streaming (data/loader.py ChunkedDataset)",
    "checkpoint_dir": "ckpt/checkpoint.py",
    "checkpoint_every": "ckpt/checkpoint.py",
    "seeds": "core/parse.py seeds",
    "tracer": "the obs Tracer/Metrics",
    "metrics": "the obs Tracer/Metrics",
}


def _not_ported(option: str):
    raise NotImplementedError(f"{option}= is not ported yet "
                              f"(ROADMAP queue A: {_NOT_PORTED[option]})")


def make_config(config: GPConfig | None = None, **overrides) -> GPConfig:
    """GPConfig from flat keyword overrides — tree/fitness sub-spec keys
    (max_depth, kernel, ...) land on the right nested dataclass."""
    config = config if config is not None else GPConfig()
    for k in overrides:
        if k in _NOT_PORTED and not (k == "islands" and overrides[k] == 1):
            _not_ported(k)
    overrides.pop("islands", None)
    tree_kw = {k: overrides.pop(k) for k in _TREE_KEYS if k in overrides}
    fit_kw = {k: overrides.pop(k) for k in _FIT_KEYS if k in overrides}
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
    fit.get_kernel(config.fitness.kernel)  # unknown / not-ported kernels fail here
    return config


class GPSession:
    """Owns one GP run: config + backend + device + state + loop.

    Lifecycle: `ingest(X, y)` → `init(key=)` → `evolve(n)` (or `fit`,
    which chains all three). `device=` (default: the card) places the
    data and state; the `auto` backend is `cuda` there and `torch` on
    the CPU. `history` (floats, one per generation run) and `stats` are
    host-side and free to read."""

    _STOP_CHECK_SPAN = 32  # block cap when only stop_fitness is armed

    def __init__(self, config: GPConfig | None = None, *, backend: str | None = None,
                 device=None, topology=None, checkpoint_dir: str | None = None,
                 feature_names=None, callback=None, callback_every: int = 1,
                 block_size: int | None = None, chunk_rows: int | None = None,
                 tracer=None, metrics=None, **overrides):
        for name, val in (("topology", topology), ("checkpoint_dir", checkpoint_dir),
                          ("chunk_rows", chunk_rows), ("tracer", tracer),
                          ("metrics", metrics)):
            if val is not None:
                _not_ported(name)
        self.device = resolve_device(device)
        explicit_features = (config is not None or "tree_spec" in overrides
                             or "n_features" in overrides)
        self._cfg = make_config(config, **overrides)
        self._backend = _backends.get_backend(backend or self._cfg.eval_impl,
                                              self.device)
        if self._backend.name == "cuda" and self.device.type != "cuda":
            raise ValueError("backend 'cuda' runs the CUDA kernel and needs a CUDA "
                             "device; use backend='torch' with device='cpu'")
        self._cfg = dataclasses.replace(self._cfg, eval_impl=self._backend.name)
        self._explicit_features = explicit_features
        self._X = self._y = self._weight = None
        self._n_rows = 0
        self._gen_host = 0  # host mirror of state.generation (no device read)
        self._gen_dirty = False  # mirror stale (raw evolve_block + stop_fitness)
        self.state: GPState | None = None
        self.history: list[float] = []
        self.stats = {"host_syncs": 0, "blocks": 0, "cache_hits": 0,
                      "cache_queries": 0, "cache_hit_rate": 0.0, "frozen": 0,
                      "migrations": 0, "tree_evals": 0, "tree_row_evals": 0}
        self._last_counters = None  # device [K, C] from a raw evolve_block
        self.feature_names = list(feature_names) if feature_names else None
        self._callback = callback
        self._callback_every = max(1, int(callback_every))
        self._block_size = block_size

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
    def best_fitness(self) -> float:
        """Best fitness seen so far (one host sync)."""
        if self.state is None:
            return float("inf")
        return float(self.state.best_fitness)

    @property
    def n_rows(self) -> int:
        return self._n_rows

    # --- lifecycle -----------------------------------------------------------

    def ingest(self, X=None, y=None, *, layout: str = "rows", sample_weight=None,
               stream=None, chunk_rows: int | None = None) -> "GPSession":
        """Load the dataset onto the session's device. layout='rows' is
        [rows, features] (transposed to the paper's feature-major
        f32[F, D] form); layout='features' takes [features, rows].
        `sample_weight` (f32[D]) scales each point's contribution; 0.0
        excludes a point exactly."""
        if stream is not None:
            _not_ported("stream")
        if chunk_rows is not None:
            _not_ported("chunk_rows")
        if X is None or y is None:
            raise ValueError("ingest needs X and y")
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
        spec = self._cfg.tree_spec
        if spec.n_features != F:
            if self._explicit_features:
                raise ValueError(f"TreeSpec.n_features={spec.n_features} but the "
                                 f"dataset has {F} features")
            self._cfg = dataclasses.replace(
                self._cfg, tree_spec=dataclasses.replace(spec, n_features=F))
        if sample_weight is not None:
            sample_weight = np.asarray(sample_weight, np.float32)
            if sample_weight.shape != (D,):
                raise ValueError(f"sample_weight shape {sample_weight.shape} does "
                                 f"not match {D} data points")
        self._n_rows = D
        self._X = torch.from_numpy(X_fm).to(self.device)
        self._y = torch.from_numpy(y).to(self.device)
        self._weight = (None if sample_weight is None
                        else torch.from_numpy(sample_weight).to(self.device))
        self._invalidate_elite_cache()
        return self

    def _invalidate_elite_cache(self):
        """New data invalidates the elite fitness cache."""
        if self.state is not None and self.state.cache_fit.numel():
            self.state = self.state._replace(
                cache_op=torch.zeros_like(self.state.cache_op),
                cache_arg=torch.zeros_like(self.state.cache_arg),
                cache_fit=torch.full_like(self.state.cache_fit, float("inf")))

    def init(self, *, key=None, seeds=None) -> "GPSession":
        """Fresh state from `key` (a port key, `core.prng.PRNGKey`;
        default PRNGKey(0), as in the reference)."""
        if seeds:
            _not_ported("seeds")
        if self._X is None:
            raise ValueError("no dataset — call ingest()/fit() first")
        key = key if key is not None else prng.PRNGKey(0)
        self.state = engine.init_state(self._cfg, key, device=self.device)
        self.history = []
        self._gen_host = 0
        self._gen_dirty = False
        return self

    def step(self) -> GPState:
        """One generation, unconditionally (no early-stop freeze, no sync)."""
        if self.state is None:
            self.init()
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
        lim = torch.full((), limit, dtype=torch.int32, device=self.device)
        self.state, history, counters = engine.evolve_block(
            self._cfg, self.state, self._X, self._y, self._weight, lim,
            n_steps=n_steps)
        self._last_counters = counters
        return self.state, history, counters

    # --- telemetry accounting ------------------------------------------------

    def _count_host_sync(self, n: int = 1):
        self.stats["host_syncs"] += n

    def _absorb_counters(self, rows):
        tot = _tc.totals(rows)
        for name, v in tot.items():
            self.stats[name] = self.stats.get(name, 0) + v
        self.stats["cache_hit_rate"] = _tc.hit_rate(self.stats)
        self.stats["tree_row_evals"] += tot["tree_evals"] * self._n_rows

    def absorb_block_telemetry(self) -> dict:
        """Fold the latest raw `evolve_block()` counter stream into
        `stats` (one host sync) and return `stats`."""
        if self._last_counters is not None:
            rows = self._last_counters.cpu().numpy()
            self._last_counters = None
            self._count_host_sync()
            self._absorb_counters(rows)
        return self.stats

    def _block_span(self, remaining: int) -> int:
        """Block size K = min(callback period, explicit block_size,
        remaining), phase-aligned to the absolute generation counter."""
        k = remaining
        if self._callback is not None:
            k = min(k, self._callback_every - self._gen_host % self._callback_every)
        if self._block_size is not None:
            k = min(k, self._block_size)
        return max(1, k)

    def _block_quantum(self, total: int) -> int:
        """Block length run for every block: the smallest configured
        period, so ragged boundaries run the same loop with a `limit`."""
        periods = [p for p in (
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
        """ONE device→host copy: generation, history and counters packed
        into one int32 buffer (history as its f32 bits)."""
        buf = torch.cat([self.state.generation.reshape(1),
                         history.contiguous().view(torch.int32),
                         counters.reshape(-1)]).cpu().numpy()
        K = history.shape[0]
        return int(buf[0]), buf[1:1 + K].view(np.float32), buf[1 + K:].reshape(K, -1)

    def evolve(self, generations: int | None = None) -> GPState:
        """Drive `generations` generations (default: config.generations)
        in blocks: one block of tensor ops and one host synchronisation
        per block. The callback, history and stop check run at block
        boundaries."""
        if self.state is None:
            self.init()
        cfg = self._cfg
        total = generations if generations is not None else cfg.generations
        self._resync_gen()
        target = self._gen_host + total
        quantum = self._block_quantum(total)
        while self._gen_host < target:
            K = min(self._block_span(target - self._gen_host), quantum)
            prev_gen = self._gen_host
            _, history, counters = self._dispatch_block(quantum, K)
            gen_now, hist, crows = self._read_block(history, counters)
            self._count_host_sync()
            self.stats["blocks"] += 1
            self._last_counters = None
            self._absorb_counters(crows)
            ran = gen_now - prev_gen
            self._gen_host = gen_now
            rows = hist[:ran]
            self.history.extend(float(b) for b in rows)
            stopped = ran < K or (cfg.stop_fitness is not None and ran
                                  and rows[ran - 1] <= np.float32(cfg.stop_fitness))
            last = stopped or gen_now >= target
            if self._callback is not None and ran and (
                    gen_now % self._callback_every == 0 or last):
                self._callback(gen_now - 1, self.state)
            if stopped:
                break
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

    def _champion(self):
        self._require_state()
        return (self.state.best_op.cpu().numpy(), self.state.best_arg.cpu().numpy())

    def best_expression(self) -> str:
        """The champion tree decoded to an infix string (one host sync)."""
        op, arg = self._champion()
        return to_string(op, arg, feature_names=self.feature_names,
                         const_table=self._cfg.tree_spec.const_table_numpy())

    def predict(self, X, *, layout: str = "rows") -> np.ndarray:
        """Best tree evaluated on new data: X [rows, features] (or
        [features, rows] with layout='features') -> f32[rows] on the host."""
        self._require_state()
        X = np.asarray(X, np.float32)
        X_fm = feature_major(X) if layout == "rows" else X
        spec = self._cfg.tree_spec
        preds = self._backend.evaluate(
            self.state.best_op[None], self.state.best_arg[None],
            torch.from_numpy(np.ascontiguousarray(X_fm)).to(self.device),
            spec.const_table(self.device), spec)
        return preds[0].cpu().numpy()

    def score(self, X, y, *, layout: str = "rows") -> float:
        """The fitness kernel's human-facing metric of the best tree on
        (X, y): fraction correct for classify/match, mean |err| for
        regression."""
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
