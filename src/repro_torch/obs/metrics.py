"""Metrics registry for the GP stack: counters, gauges, EMA histograms.

One `Metrics` object per run. It is the single sink the session, the
service and the CLIs publish into; the legacy `GPSession.stats` /
`GPService.stats` dicts stay as views the tests pin, but their values
are produced here. Three instrument kinds:

  inc(name, n)        monotonic counter (host syncs, blocks, cache hits)
  gauge(name, v)      last-value gauge (slot occupancy, generation)
  observe(name, v)    streaming summary: count/sum/min/max + EMA —
                      a cheap fixed-size histogram substitute for
                      wall-time series (block seconds, chunk seconds)

`Metrics(path=...)` additionally appends one JSON object per `emit()`
call to a JSONL file (one line per event — block timings, chunk folds,
service dispatches), and `close()` writes a final `{"kind":
"snapshot"}` line holding every instrument, which is what
`python -m repro.obs.report` renders. With no path, everything stays
in memory and `snapshot()` serves programmatic readers.

`BlockMonitor` wraps `runtime.fault.StepMonitor` so EVERY block path
(jitted dispatch, host scalar fallback, service drain) reports through
the same timing instrument: one `with` block updates the StepMonitor
EMA + straggler list AND publishes `block_s` observations / legacy
stats keys.

The port's own copy of `repro/obs/metrics.py` (it imports no JAX); the
JSONL records and snapshot are the reference's.
"""
from __future__ import annotations

import json
import os
import threading
import time


class _Summary:
    __slots__ = ("count", "sum", "min", "max", "ema", "alpha")

    def __init__(self, alpha=0.2):
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None
        self.ema = None
        self.alpha = alpha

    def observe(self, v: float):
        v = float(v)
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)
        self.ema = v if self.ema is None else (
            self.alpha * v + (1 - self.alpha) * self.ema)

    def as_dict(self) -> dict:
        mean = self.sum / self.count if self.count else 0.0
        return {"count": self.count, "sum": self.sum, "mean": mean,
                "min": self.min, "max": self.max, "ema": self.ema}


class Metrics:
    """Thread-safe metrics registry with an optional JSONL sink."""

    def __init__(self, path: str | None = None):
        self.path = path
        self._lock = threading.Lock()
        self._counters: dict[str, int] = {}
        self._gauges: dict[str, float] = {}
        self._summaries: dict[str, _Summary] = {}
        self._file = None
        self._t0 = time.time()
        if path:
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            self._file = open(path, "a")

    # --- instruments ----------------------------------------------------------

    def inc(self, name: str, n: int = 1) -> int:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + int(n)
            return self._counters[name]

    def gauge(self, name: str, value: float):
        with self._lock:
            self._gauges[name] = float(value)

    def observe(self, name: str, value: float):
        with self._lock:
            s = self._summaries.get(name)
            if s is None:
                s = self._summaries[name] = _Summary()
            s.observe(value)

    def counter_value(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    def summary(self, name: str) -> dict | None:
        with self._lock:
            s = self._summaries.get(name)
            return s.as_dict() if s else None

    # --- sink -----------------------------------------------------------------

    def emit(self, kind: str, **fields):
        """Append one event line to the JSONL sink (no-op without a
        path). Every line carries `kind` and `t` (seconds since the
        registry was created)."""
        if self._file is None:
            return
        rec = {"kind": kind, "t": round(time.time() - self._t0, 6)}
        rec.update(fields)
        with self._lock:
            self._file.write(json.dumps(rec) + "\n")

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "summaries": {k: s.as_dict()
                              for k, s in self._summaries.items()},
            }

    def close(self):
        """Flush the final snapshot line and close the sink."""
        if self._file is None:
            return
        snap = self.snapshot()
        with self._lock:
            self._file.write(json.dumps({"kind": "snapshot", **snap}) + "\n")
            self._file.close()
            self._file = None


class BlockMonitor:
    """The one timing path for evolution blocks.

    Wraps a `runtime.fault.StepMonitor` (EMA + straggler detection) and
    publishes each step into a `Metrics` registry and, for
    compatibility, a legacy stats dict (`blocks`, `block_s_ema`,
    `stragglers`). Use as a context manager around each block dispatch,
    on every path — jitted, host fallback, and service drain.
    """

    def __init__(self, monitor, metrics: Metrics,
                 stats: dict | None = None, name: str = "block_s"):
        self.monitor = monitor
        self.metrics = metrics
        self.stats = stats
        self.name = name

    def __enter__(self):
        self.monitor.__enter__()
        return self

    def __exit__(self, *exc):
        out = self.monitor.__exit__(*exc)
        if exc[0] is None:
            self.metrics.inc("blocks")
            if self.monitor.ema is not None:
                self.metrics.observe(self.name, self.monitor.last)
                self.metrics.gauge(self.name + "_ema", self.monitor.ema)
            if self.stats is not None:
                self.stats["blocks"] = self.stats.get("blocks", 0) + 1
                self.stats["block_s_ema"] = self.monitor.ema
                self.stats["stragglers"] = self.monitor.stragglers
            self.metrics.emit("block", seconds=self.monitor.last,
                              ema=self.monitor.ema)
        return out
