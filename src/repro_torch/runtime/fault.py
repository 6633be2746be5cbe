"""Fault tolerance runtime: heartbeats, straggler detection, auto-restart.

The port's own copy of `repro/runtime/fault.py` (it imports no JAX).
On a multi-host deployment these hooks sit on top of the process group:
heartbeats go to a coordinator, a missed deadline marks the host
failed, and every process restores from the newest committed checkpoint
(`repro_torch.ckpt`). In one process the monitors run against local
threads and the restart policy is exercised with injected failures; the
control flow is the same.
"""
from __future__ import annotations

import threading
import time
from typing import Callable


class StepMonitor:
    """Per-step wall-time EMA + straggler flagging.

    A step slower than `threshold × EMA` is recorded as a straggler event.
    At fleet scale the same signal (per-host step time skew) is what
    triggers hot-spare swap-in; here it feeds metrics and tests."""

    def __init__(self, threshold: float = 3.0, alpha: float = 0.2):
        self.threshold = threshold
        self.alpha = alpha
        self.ema: float | None = None
        self.last: float | None = None
        self.stragglers: list[tuple[int, float]] = []
        self.step = 0

    def __enter__(self):
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        dt = time.monotonic() - self._t0
        self.last = dt
        if self.ema is not None and dt > self.threshold * self.ema:
            self.stragglers.append((self.step, dt))
        self.ema = dt if self.ema is None else (1 - self.alpha) * self.ema + self.alpha * dt
        self.step += 1
        return False


class HeartbeatMonitor:
    """Liveness tracking for worker threads/processes. Workers call
    `beat(worker_id)`; `dead_workers()` returns anything silent past the
    deadline."""

    def __init__(self, deadline_s: float = 10.0):
        self.deadline_s = deadline_s
        self._last: dict[str, float] = {}
        self._lock = threading.Lock()

    def beat(self, worker_id: str):
        with self._lock:
            self._last[worker_id] = time.monotonic()

    def dead_workers(self) -> list[str]:
        now = time.monotonic()
        with self._lock:
            return [w for w, t in self._last.items() if now - t > self.deadline_s]

    def remove(self, worker_id: str):
        """Forget a worker that left ON PURPOSE (job evicted, host drained).
        Without this, a worker that stops beating because its job finished
        is indistinguishable from a dead one and `dead_workers()` reports
        it forever. Unknown ids are a no-op — eviction paths may race a
        worker that never got its first beat in."""
        with self._lock:
            self._last.pop(worker_id, None)


def run_with_restarts(make_state: Callable, step_fn: Callable, n_steps: int,
                      manager, *, max_restarts: int = 3, on_step=None,
                      until: Callable | None = None):
    """Restart-from-checkpoint execution policy.

    make_state() builds a fresh state; step_fn(state, i) -> state may raise
    (node failure). On failure we restore the newest committed checkpoint
    and continue; state identity is preserved across restarts.
    `until(state) -> bool`, when given, ends the run early once it reports
    the state finished — `n_steps` is then just a runaway bound (how
    drain-until-idle loops, e.g. the GP service scheduler, ride this
    policy without knowing their step count up front). Returns
    (state, restarts)."""
    restarts = 0
    state = make_state()
    restored, step0 = manager.restore_latest(like=state)
    i = int(step0) if restored is not None else 0
    if restored is not None:
        state = restored
    while i < n_steps and not (until is not None and until(state)):
        try:
            state = step_fn(state, i)
            i += 1
            manager.maybe_save(state, i)
            if on_step:
                on_step(i, state)
        except Exception:
            restarts += 1
            if restarts > max_restarts:
                raise
            manager.wait()
            restored, step0 = manager.restore_latest(like=state)
            if restored is None:
                state, i = make_state(), 0
            else:
                state, i = restored, int(step0)
    manager.wait()
    return state, restarts
