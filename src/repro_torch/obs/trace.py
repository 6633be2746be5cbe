"""Chrome-trace-event tracing for the GP stack (host side).

A `Tracer` collects trace events in memory and writes the Chrome Trace
Event JSON object format (`{"traceEvents": [...]}`) — open the file at
`chrome://tracing` or https://ui.perfetto.dev to see ingest, block
dispatches, chunk folds, checkpoint saves and service admission/
eviction as nested spans on a per-thread timeline, and per-job
lifetimes as async tracks. `NULL_TRACER` is the always-on no-op every
instrumented call site defaults to, so tracing-off costs one attribute
lookup and no allocation — the generation step never sees the tracer at
all (the counter stream is unconditional; see obs/counters.py), which
is what keeps traced and untraced trajectories bitwise identical.

Port of `repro/obs/trace.py`; the events and `validate_trace` are the
reference's, so either package's validator accepts the other's traces.

Span discipline: `span()` emits a "B" event and ALWAYS emits the
matching "E" on exit (try/finally), so every written trace nests
properly — `validate_trace` walks the B/E stack per thread and
rejects orphans. Async job lifetimes use "b"/"e" events keyed by id.

An optional `torch.profiler` window can be armed around one chosen
evolution block (`profile_dir=`, `profile_block=`): the session asks
`maybe_profile(block_index)` at each dispatch and exactly that block
runs under the profiler (CPU activity, and CUDA activity when a card is
present), whose Chrome trace is written to
`<profile_dir>/block_<index>.json`: device-level kernel timing for one
block, without paying profiler overhead for the whole run.
"""
from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager, nullcontext


class NullTracer:
    """No-op tracer: every method returns immediately; `span`/`maybe_
    profile` return a shared nullcontext. Instrumented code calls the
    tracer unconditionally and never branches on enablement."""

    enabled = False

    def span(self, name, cat="repro", args=None):
        return nullcontext()

    def instant(self, name, cat="repro", args=None):
        pass

    def counter(self, name, values, cat="repro"):
        pass

    def begin_async(self, name, aid, cat="repro", args=None):
        pass

    def end_async(self, name, aid, cat="repro", args=None):
        pass

    def maybe_profile(self, block_index):
        return nullcontext()

    def save(self, path=None):
        return None


NULL_TRACER = NullTracer()


class Tracer:
    """Collects Chrome trace events; thread-safe appends; one process.

    `path` (optional) is where `save()` writes by default; pass
    `profile_dir`/`profile_block` to arm a torch.profiler window around
    the `profile_block`-th dispatched evolution block (`last_profile`
    then holds the profiler, for `key_averages()`)."""

    enabled = True

    def __init__(self, path: str | None = None, *,
                 profile_dir: str | None = None,
                 profile_block: int | None = None):
        self.path = path
        self.profile_dir = profile_dir
        self.profile_block = (profile_block if profile_block is not None
                              else (0 if profile_dir else None))
        self.last_profile = None
        self.events: list[dict] = []
        self._lock = threading.Lock()
        self._async_open: set[tuple] = set()
        self._t0 = time.perf_counter()
        self._pid = os.getpid()
        self._emit({"ph": "M", "name": "process_name", "pid": self._pid,
                    "tid": 0, "args": {"name": "repro-gp"}})

    # --- low level ------------------------------------------------------------

    def _ts(self) -> float:
        """Microseconds since tracer construction (Chrome trace unit)."""
        return (time.perf_counter() - self._t0) * 1e6

    def _emit(self, ev: dict):
        with self._lock:
            self.events.append(ev)

    def _base(self, ph, name, cat, args):
        ev = {"ph": ph, "name": name, "cat": cat, "ts": self._ts(),
              "pid": self._pid, "tid": threading.get_ident()}
        if args:
            ev["args"] = dict(args)
        return ev

    # --- spans / instants / counters ------------------------------------------

    @contextmanager
    def span(self, name, cat="repro", args=None):
        """Duration span: B on entry, E on exit — the E is emitted even
        when the body raises, so traces always nest."""
        self._emit(self._base("B", name, cat, args))
        try:
            yield self
        finally:
            self._emit(self._base("E", name, cat, None))

    def instant(self, name, cat="repro", args=None):
        ev = self._base("i", name, cat, args)
        ev["s"] = "t"  # thread-scoped instant
        self._emit(ev)

    def counter(self, name, values: dict, cat="repro"):
        """Chrome counter track: `values` is {series: number}."""
        self._emit(self._base("C", name, cat,
                              {k: float(v) for k, v in values.items()}))

    def begin_async(self, name, aid, cat="repro", args=None):
        """Open an async lifetime lane. Idempotent per (name, id): a
        rollback/replay path re-opening a live lane is a no-op, so the
        written trace always pairs b/e events."""
        ev = self._base("b", name, cat, args)
        ev["id"] = str(aid)
        with self._lock:
            key = (name, ev["id"])
            if key in self._async_open:
                return
            self._async_open.add(key)
            self.events.append(ev)

    def end_async(self, name, aid, cat="repro", args=None):
        """Close an async lane; a close with no open lane (replayed
        publish after a restart rollback) is a no-op."""
        ev = self._base("e", name, cat, args)
        ev["id"] = str(aid)
        with self._lock:
            key = (name, ev["id"])
            if key not in self._async_open:
                return
            self._async_open.discard(key)
            self.events.append(ev)

    # --- torch.profiler window ------------------------------------------------

    @contextmanager
    def _profile_window(self, block_index: int):
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.__enter__()
        try:
            yield self
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            prof.__exit__(None, None, None)
            self.last_profile = prof
            os.makedirs(self.profile_dir, exist_ok=True)
            prof.export_chrome_trace(
                os.path.join(self.profile_dir, f"block_{block_index}.json"))

    def maybe_profile(self, block_index: int):
        """Context manager: a torch.profiler window when this is the
        armed block, a no-op otherwise."""
        if self.profile_dir is not None and block_index == self.profile_block:
            return self._profile_window(block_index)
        return nullcontext()

    # --- output ---------------------------------------------------------------

    def save(self, path: str | None = None) -> str:
        """Write `{"traceEvents": [...]}` (the Chrome trace JSON object
        form — Perfetto and chrome://tracing both open it). Returns the
        path written."""
        path = path or self.path
        if path is None:
            raise ValueError("Tracer has no path — pass save(path) or "
                             "construct with Tracer(path)")
        with self._lock:
            events = list(self.events)
        payload = {"traceEvents": events, "displayTimeUnit": "ms"}
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(payload, f)
        return path


def validate_trace(payload: dict) -> list[str]:
    """Schema check for a Chrome trace object: returns a list of
    problems (empty = valid). Checks the envelope, per-(pid, tid) B/E
    stack discipline (no orphan E, no unclosed B, E names match their
    B), and that async b/e events pair up per (name, id)."""
    problems = []
    events = payload.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents is not a list"]
    stacks: dict[tuple, list] = {}
    async_open: dict[tuple, int] = {}
    for i, ev in enumerate(events):
        ph = ev.get("ph")
        if ph in ("B", "E"):
            key = (ev.get("pid"), ev.get("tid"))
            stack = stacks.setdefault(key, [])
            if ph == "B":
                stack.append(ev.get("name"))
            else:
                if not stack:
                    problems.append(f"event {i}: orphan E {ev.get('name')!r}")
                elif stack[-1] != ev.get("name"):
                    problems.append(
                        f"event {i}: E {ev.get('name')!r} closes "
                        f"B {stack[-1]!r} (misnested)")
                    stack.pop()
                else:
                    stack.pop()
        elif ph == "b":
            k = (ev.get("name"), ev.get("id"))
            async_open[k] = async_open.get(k, 0) + 1
        elif ph == "e":
            k = (ev.get("name"), ev.get("id"))
            if async_open.get(k, 0) < 1:
                problems.append(f"event {i}: async e without b for {k}")
            else:
                async_open[k] -= 1
    for (pid, tid), stack in stacks.items():
        for name in stack:
            problems.append(f"unclosed B {name!r} on (pid={pid}, tid={tid})")
    for k, n in async_open.items():
        if n:
            problems.append(f"async b without e for {k}")
    return problems
