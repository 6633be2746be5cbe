"""sklearn-style facades over the port's GPSession, ported from
`repro/gp/estimators.py`.

`SymbolicRegressor` / `SymbolicClassifier` follow the estimator protocol
(constructor holds hyper-parameters; `fit`/`predict`/`score`; fitted
attributes carry a trailing underscore; `warm_start=True` continues
evolving the previous population on the next `fit`). They are thin: all
execution is the session's. `random_state` gives the run's key
(`prng.PRNGKey(random_state)`), and `device=` follows the port's rule:
the card unless the caller asks for the CPU.

`islands`, its migration settings, `checkpoint_dir`, `chunk_rows=`
(streaming chunked fitness: the data folds through the device in fixed
chunks), `backend="scalar"` (the paper's per-data-point baseline) and
`topology=` (a `MeshTopology`: the run sharded over a device mesh) run
as in the reference, e.g. `SymbolicRegressor(chunk_rows=4096,
device="cpu").fit(X, y)`.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import prng
from repro_torch.gp.session import GPSession


class _SymbolicBase:
    _kernel = "r"

    def __init__(self, *, pop_size: int = 100, generations: int = 30,
                 max_depth: int = 5, n_consts: int = 8, fn_set=None,
                 tourn_size: int = 10, elitism: int = 1, parsimony: float = 0.0,
                 stop_fitness: float | None = None, backend: str | None = None,
                 topology=None, checkpoint_dir: str | None = None,
                 random_state: int = 0, warm_start: bool = False,
                 block_size: int | None = None, chunk_rows: int | None = None,
                 islands: int = 1, migrate_every: int = 10, migrate_k: int = 4,
                 island_topology: str = "ring", island_mixes=None, device=None):
        self.pop_size = pop_size
        self.generations = generations
        self.max_depth = max_depth
        self.n_consts = n_consts
        self.fn_set = fn_set
        self.tourn_size = tourn_size
        self.elitism = elitism
        self.parsimony = parsimony
        self.stop_fitness = stop_fitness
        self.backend = backend
        self.topology = topology
        self.checkpoint_dir = checkpoint_dir
        self.random_state = random_state
        self.warm_start = warm_start
        # generations per device-resident evolution block (None = the whole
        # run in one block)
        self.block_size = block_size
        self.chunk_rows = chunk_rows
        self.islands = islands
        self.migrate_every = migrate_every
        self.migrate_k = migrate_k
        self.island_topology = island_topology
        self.island_mixes = island_mixes
        self.device = device

    def _kernel_overrides(self) -> dict:
        return {"kernel": self._kernel}

    def _make_session(self) -> GPSession:
        overrides = dict(pop_size=self.pop_size, generations=self.generations,
                         max_depth=self.max_depth, n_consts=self.n_consts,
                         tourn_size=self.tourn_size, elitism=self.elitism,
                         parsimony=self.parsimony, stop_fitness=self.stop_fitness,
                         islands=self.islands, migrate_every=self.migrate_every,
                         migrate_k=self.migrate_k, island_topology=self.island_topology,
                         **self._kernel_overrides())
        if self.island_mixes is not None:
            overrides["island_mixes"] = tuple(self.island_mixes)
        if self.fn_set is not None:
            overrides["fn_set"] = self.fn_set
        self._key = prng.PRNGKey(self.random_state)
        return GPSession(backend=self.backend, device=self.device, topology=self.topology,
                         checkpoint_dir=self.checkpoint_dir, block_size=self.block_size,
                         chunk_rows=self.chunk_rows, **overrides)

    def fit(self, X, y):
        """Evolve on X [n_samples, n_features], y [n_samples]. Blocks until
        the run finishes; fitted attributes `expression_` (str),
        `best_fitness_` (float, minimize) and `n_features_in_` are host
        values. With warm_start=True a second fit continues the evolved
        population instead of reinitializing."""
        cont = self.warm_start and getattr(self, "session_", None) is not None
        if not cont:
            self.session_ = self._make_session()
        self.session_.fit(X, y, key=self._key, warm_start=cont)
        self.expression_ = self.session_.best_expression()
        self.best_fitness_ = self.session_.best_fitness
        self.n_features_in_ = self.session_.config.tree_spec.n_features
        return self

    def _raw_predict(self, X) -> np.ndarray:
        if getattr(self, "session_", None) is None:
            raise ValueError("estimator is not fitted; call fit(X, y) first")
        return self.session_.predict(X)


class SymbolicRegressor(_SymbolicBase):
    """GP symbolic regression (the paper's (r) kernel)."""

    _kernel = "r"

    def predict(self, X) -> np.ndarray:
        """Champion expression on X [n_samples, n_features] -> f32[n_samples]
        host array (one device sync)."""
        return self._raw_predict(X)

    def score(self, X, y) -> float:
        """R² (sklearn's regressor convention), computed on the host in
        float64; 1.0 is a perfect fit, can be arbitrarily negative."""
        y = np.asarray(y, np.float64)
        pred = np.asarray(self.predict(X), np.float64)
        ss_res = float(((y - pred) ** 2).sum())
        ss_tot = float(((y - y.mean()) ** 2).sum())
        return 1.0 - ss_res / ss_tot if ss_tot > 0 else 0.0


class SymbolicClassifier(_SymbolicBase):
    """GP classification via Karoo's round-and-clip label binning: the
    evolved expression's output is rounded (half to even) and clipped into
    {0..n_classes-1}; fitness counts weighted hits, negated."""

    _kernel = "c"

    def __init__(self, *, n_classes: int = 3, **kw):
        super().__init__(**kw)
        self.n_classes = n_classes

    def _kernel_overrides(self) -> dict:
        return {"kernel": self._kernel, "n_classes": self.n_classes}

    def predict(self, X) -> np.ndarray:
        """Labels int32[n_samples] in {0..n_classes-1} for
        X [n_samples, n_features] (host array, one device sync)."""
        raw = np.nan_to_num(self._raw_predict(X))
        return np.clip(np.round(raw), 0, self.n_classes - 1).astype(np.int32)

    def score(self, X, y) -> float:
        """Accuracy in [0, 1] (sklearn's classifier convention)."""
        return float((self.predict(X) == np.asarray(y).astype(np.int64)).mean())
