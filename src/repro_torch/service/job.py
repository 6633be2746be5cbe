"""Job surface of the GP service (port of `repro/service/job.py`): what
a tenant submits and what they poll. A `JobSpec` is one user's GP run —
dataset, fitness kernel, search parameters, termination — i.e. exactly
the per-island degrees of freedom of the engine's multi-tenant batch
(`core.engine.TenantParams` plus the slot's data buffers), which is what
makes a job an island: everything job-specific is an operand of the one
tenant block.

`JobHandle` is the service-side record the submit/poll/result/cancel
API reads and the scheduler mutates at block boundaries. Handles are
plain host objects; nothing here touches a device.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import fitness as fit
from repro_torch.core.evolve import OperatorMix

# job lifecycle: PENDING -> RUNNING -> DONE, with CANCELLED reachable
# from both live states (a running job is cancelled at the next block
# boundary, partial results published)
PENDING = "pending"
RUNNING = "running"
DONE = "done"
CANCELLED = "cancelled"


@dataclasses.dataclass
class JobSpec:
    """One tenant's GP run request.

    X is row-major [rows, features] (sklearn layout, like GPSession.fit);
    y is f32[rows] targets (class ids as floats for the 'c' kernel). The
    remaining fields mirror a solo GPConfig: `kernel` picks the fitness
    objective, `mix`/`tourn_size`/`point_rate` the search behaviour,
    `stop_fitness` (None = run the full budget) and `generations` the
    termination. `seed` derives the job's private PRNG stream — a packed
    job replays the same stream a solo `islands=1` session with
    `PRNGKey(seed)` would, which is what the parity tests pin."""

    X: np.ndarray
    y: np.ndarray
    kernel: str = "r"
    mix: OperatorMix = dataclasses.field(default_factory=OperatorMix)
    tourn_size: int = 10
    point_rate: float = 0.25
    stop_fitness: float | None = None
    generations: int = 30
    n_classes: int = 3
    precision: float = 1e-4
    seed: int = 0
    name: str = ""
    feature_names: tuple | None = None

    def __post_init__(self):
        self.X = np.asarray(self.X, np.float32)
        self.y = np.asarray(self.y, np.float32)
        if self.X.ndim != 2:
            raise ValueError(f"X must be [rows, features], got shape "
                             f"{self.X.shape}")
        if self.y.shape != (self.X.shape[0],):
            raise ValueError(f"y shape {self.y.shape} does not match "
                             f"{self.X.shape[0]} rows")
        if self.generations < 1:
            raise ValueError("generations must be >= 1")
        if self.tourn_size < 1:
            raise ValueError("tourn_size must be >= 1")
        # canonicalize the kernel name now so packing compares apples
        self.kernel = fit.get_kernel(self.kernel).name

    @property
    def n_rows(self) -> int:
        return self.X.shape[0]

    @property
    def n_features(self) -> int:
        return self.X.shape[1]


class JobHandle:
    """The service's record of one submitted job — returned by
    `GPService.submit` and updated in place at block boundaries.

    Tenant-facing fields: `status` (PENDING/RUNNING/DONE/CANCELLED),
    `gens_done`, `best_fitness`, `history` (one best-fitness float per
    generation actually run), and — once published — `best_expression`
    plus the raw champion arrays `best_op`/`best_arg`.

    Scheduler-private fields (underscored): the occupied slot index, a
    cancel flag the next block boundary honours, and `_saved` — the
    job's island sub-state when it was preempted or repacked from a
    checkpoint taken at a different slot count, spliced back in instead
    of a fresh init on (re)admission."""

    def __init__(self, job_id: int, spec: JobSpec):
        self.job_id = job_id
        self.spec = spec
        self.status = PENDING
        self.gens_done = 0
        self.best_fitness = float("inf")
        self.history: list[float] = []
        self.best_expression: str | None = None
        self.best_op: np.ndarray | None = None
        self.best_arg: np.ndarray | None = None
        self._slot: int | None = None
        self._cancel = False
        self._saved = None  # TenantState sub-state of a preempted job

    @property
    def finished(self) -> bool:
        return self.status in (DONE, CANCELLED)

    def snapshot(self) -> dict:
        """The poll() payload: a plain-data view safe to hand out."""
        return {
            "job_id": self.job_id,
            "name": self.spec.name,
            "status": self.status,
            "gens_done": self.gens_done,
            "budget": self.spec.generations,
            "best_fitness": self.best_fitness,
            "best_expression": self.best_expression,
        }

    def __repr__(self):
        return (f"JobHandle(id={self.job_id}, name={self.spec.name!r}, "
                f"status={self.status}, gens={self.gens_done}/"
                f"{self.spec.generations}, best={self.best_fitness:g})")
