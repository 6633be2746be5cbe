"""Packing heterogeneous jobs into the engine's island layout (port of
`repro/service/packer.py`).

The batch shape is fixed at service construction — `[I, P, N]` state,
`[I, F_cap, D_cap]` data — and everything job-specific is an operand:
per-slot data buffers (a job's rows zero-weight padded to `D_cap`, its
feature columns zero-padded to `F_cap` — the same `weight` mask contract
every fitness kernel already honours for dataset padding) and the
`TenantParams` table. So packing a new job into a free slot is a row
write, and ragged datasets share one tenant block.

`JobBatch` owns the slot assignment plus the host-side mirrors of those
operands; the scheduler admits/evicts through it and asks for the device
operands per dispatch (uploaded again only when a slot changed). The
host mirror of the parameter table is also what the tenant block reads
to pick each slot's fitness kernel (`host_params`)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine import TenantParams
from repro_torch.device import resolve_device
from repro_torch.service.job import JobHandle, JobSpec

# a disabled early stop: best_fitness <= -inf is never true
NO_STOP = -np.inf


def slot_buffers(spec: JobSpec, n_features: int, data_cap: int):
    """One job's padded slot data: (X f32[F_cap, D_cap] feature-major,
    y f32[D_cap], w f32[D_cap]). Padded rows carry weight 0.0 (excluded
    from fitness exactly), padded feature columns are all-zero (the
    tree's terminal set may reference them; they read as the constant
    0)."""
    D, F = spec.X.shape
    if D > data_cap:
        raise ValueError(f"job {spec.name!r} has {D} rows > data_cap {data_cap}")
    if F > n_features:
        raise ValueError(f"job {spec.name!r} has {F} features > n_features "
                         f"{n_features}")
    X = np.zeros((n_features, data_cap), np.float32)
    X[:F, :D] = np.ascontiguousarray(spec.X.T)
    y = np.zeros((data_cap,), np.float32)
    y[:D] = spec.y
    w = np.zeros((data_cap,), np.float32)
    w[:D] = 1.0
    return X, y, w


def pack_order(pending: list[JobHandle], n_free: int,
               strategy: str = "fifo") -> list[JobHandle]:
    """Which pending jobs claim the free slots this boundary.

    fifo  submit order — deterministic, starvation-free; the default.
    lpt   longest-processing-time first: largest REMAINING generation
          budget admitted first (classic makespan heuristic for packing
          unequal jobs onto identical machines); submit order breaks
          ties so equal-budget jobs keep FIFO fairness.
    """
    if strategy == "fifo":
        ranked = pending
    elif strategy == "lpt":
        ranked = sorted(pending, key=lambda h: (-(h.spec.generations
                                                  - h.gens_done), h.job_id))
    else:
        raise ValueError(f"unknown packing strategy {strategy!r}; "
                         f"use 'fifo' or 'lpt'")
    return list(ranked[:n_free])


class JobBatch:
    """Slot assignment + host mirrors of the per-slot operands.

    `slots[i]` is the JobHandle occupying island slot `i` (None = empty).
    Data and parameter rows are written on admit/evict; `operands()`
    returns the (X, y, w, TenantParams) tensors on `device` (default: the
    card), uploading again only after a slot changed. Empty slots get a
    zero dataset, zero weights and a 0 generation budget —
    `tenant_active` freezes them, so their compute is discarded."""

    def __init__(self, islands: int, n_features: int, data_cap: int,
                 kernels: tuple, tourn_draw: int, device=None):
        self.islands = islands
        self.n_features = n_features
        self.data_cap = data_cap
        self.kernels = kernels
        self.tourn_draw = tourn_draw
        self.device = resolve_device(device)
        self.slots: list[JobHandle | None] = [None] * islands
        I = islands
        self._X = np.zeros((I, n_features, data_cap), np.float32)
        self._y = np.zeros((I, data_cap), np.float32)
        self._w = np.zeros((I, data_cap), np.float32)
        self._probs = np.tile(np.asarray([0.1, 0.1, 0.1, 0.7], np.float32),
                              (I, 1))
        self._tourn = np.full((I,), tourn_draw, np.int32)
        self._point_rate = np.full((I,), 0.25, np.float32)
        self._kernel_id = np.zeros((I,), np.int32)
        self._n_classes = np.full((I,), 2.0, np.float32)
        self._precision = np.full((I,), 1e-4, np.float32)
        self._stop = np.full((I,), NO_STOP, np.float32)
        self._budget = np.zeros((I,), np.int32)
        self._dirty = True
        self._device = None  # cached (X, y, w, TenantParams) on the device

    # --- queries --------------------------------------------------------------

    @property
    def free_slots(self) -> list[int]:
        return [i for i, h in enumerate(self.slots) if h is None]

    @property
    def occupied(self) -> list[tuple[int, JobHandle]]:
        return [(i, h) for i, h in enumerate(self.slots) if h is not None]

    def validate(self, spec: JobSpec):
        """Reject at submit time anything the fixed batch shape cannot
        hold — the service never changes its layout to fit a job."""
        slot_buffers(spec, self.n_features, self.data_cap)  # shape check
        if spec.kernel not in self.kernels:
            raise ValueError(f"job kernel {spec.kernel!r} is not in the "
                             f"service's compiled kernel set {self.kernels}")
        if spec.tourn_size > self.tourn_draw:
            raise ValueError(f"job tourn_size {spec.tourn_size} exceeds the "
                             f"service's tournament draw {self.tourn_draw}")

    # --- mutation -------------------------------------------------------------

    def admit(self, slot: int, handle: JobHandle):
        assert self.slots[slot] is None, f"slot {slot} is occupied"
        spec = handle.spec
        self.validate(spec)
        X, y, w = slot_buffers(spec, self.n_features, self.data_cap)
        self._X[slot], self._y[slot], self._w[slot] = X, y, w
        self._probs[slot] = spec.mix.probs()
        self._tourn[slot] = spec.tourn_size
        self._point_rate[slot] = spec.point_rate
        self._kernel_id[slot] = self.kernels.index(spec.kernel)
        self._n_classes[slot] = float(spec.n_classes)
        self._precision[slot] = float(spec.precision)
        self._stop[slot] = (NO_STOP if spec.stop_fitness is None
                            else float(spec.stop_fitness))
        self._budget[slot] = int(spec.generations)
        self.slots[slot] = handle
        handle._slot = slot
        self._dirty = True

    def evict(self, slot: int) -> JobHandle:
        handle = self.slots[slot]
        assert handle is not None, f"slot {slot} is empty"
        self.slots[slot] = None
        handle._slot = None
        # budget 0 freezes the slot; data can stay (compute is discarded)
        self._budget[slot] = 0
        self._stop[slot] = NO_STOP
        self._dirty = True
        return handle

    # --- operands -------------------------------------------------------------

    def host_params(self) -> TenantParams:
        """The live host-side TenantParams table (numpy, no copy): the
        kernel ids, `n_classes` and `precision` the tenant block reads
        to pick each slot's fitness kernel without a device read."""
        return TenantParams(
            probs=self._probs, tourn=self._tourn, point_rate=self._point_rate,
            kernel_id=self._kernel_id, n_classes=self._n_classes,
            precision=self._precision, stop=self._stop, budget=self._budget)

    def restore_params(self, params: TenantParams):
        """Overwrite the parameter table from a checkpoint (the data
        buffers are rebuilt by re-admitting the slotted jobs — they are
        derivable from the JobSpecs and never checkpointed)."""
        (self._probs, self._tourn, self._point_rate, self._kernel_id,
         self._n_classes, self._precision, self._stop, self._budget) = (
            np.asarray(leaf).copy() for leaf in params)
        self._dirty = True

    def operands(self):
        """(X, y, w, TenantParams) as tensors on the batch's device — the
        tenant block's operands; uploaded only when a slot changed since
        the last call."""
        if self._dirty or self._device is None:
            def up(a):  # a copy: the tensors never alias the host mirrors
                return torch.tensor(a, device=self.device)

            self._device = (up(self._X), up(self._y), up(self._w),
                            TenantParams(*(up(a) for a in self.host_params())))
            self._dirty = False
        return self._device
