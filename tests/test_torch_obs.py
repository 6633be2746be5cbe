"""The port's observability against the reference's: Chrome-trace spans
checked by both packages' `validate_trace`, the `Metrics` snapshot of a
session equal to the reference session's on the same run, telemetry on
and off bitwise (no observer effect), the block monitor's timing path,
`python -m repro_torch.obs.report` on a run's JSONL, and the
torch.profiler window (CPU activity here)."""
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.gp import GPSession as JSession
from repro.obs import Metrics as JMetrics
from repro.obs import Tracer as JTracer
from repro.obs import validate_trace as j_validate
from repro_torch.core import prng
from repro_torch.gp import GPSession
from repro_torch.obs import NULL_TRACER, Metrics, Tracer, report, validate_trace
from repro_torch.obs.metrics import BlockMonitor
from repro_torch.runtime.fault import StepMonitor
from jax_release import release_jax_programs  # noqa: F401  (frees compiled programs)

torch.set_num_threads(2)

LATTICE = dict(kernel="r", max_depth=3, p_const=0.0, fn_set="add,sub,mul")


def _lattice(rows=32, seed=5):
    rng = np.random.RandomState(seed)
    X = rng.randint(-2, 3, size=(rows, 2)).astype(np.float32)
    y = (X[:, 0] - X[:, 1] * X[:, 1]).astype(np.float32)
    return X, y


def test_trace_schema_and_nesting(tmp_path):
    """A session run writes valid Chrome trace JSON, by the port's
    validator and the reference's: nested B/E spans for ingest, init,
    block and checkpoint, each with ts/pid/tid."""
    X, y = _lattice()
    path = str(tmp_path / "t.json")
    tracer = Tracer(path)
    GPSession(device="cpu", pop_size=12, generations=9, block_size=3, islands=2,
              tracer=tracer, checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=3,
              **LATTICE).fit(X, y, key=prng.PRNGKey(0))
    tracer.save()
    with open(path) as f:
        payload = json.load(f)
    assert validate_trace(payload) == [] and j_validate(payload) == []
    names = [e["name"] for e in payload["traceEvents"] if e["ph"] == "B"]
    assert {"ingest", "init", "block", "checkpoint"} <= set(names)
    assert names.count("block") == 3
    for ev in payload["traceEvents"]:
        if ev["ph"] in ("B", "E"):
            assert {"ts", "pid", "tid"} <= set(ev)
    # and the reference's traces pass the port's validator
    jt = JTracer()
    with jt.span("outer"), jt.span("inner"):
        jt.begin_async("job", 1)
    jt.end_async("job", 1)
    assert validate_trace({"traceEvents": jt.events}) == []


def test_validate_trace_catches_malformed():
    """The port's validator reports what the reference's does."""
    cases = [{}, {"traceEvents": [{"ph": "E", "name": "x", "pid": 1, "tid": 1}]},
             {"traceEvents": [{"ph": "B", "name": "x", "pid": 1, "tid": 1}]},
             {"traceEvents": [{"ph": "B", "name": "x", "pid": 1, "tid": 1},
                              {"ph": "E", "name": "y", "pid": 1, "tid": 1}]},
             {"traceEvents": [{"ph": "e", "name": "job", "id": "1"}]},
             {"traceEvents": [{"ph": "b", "name": "job", "id": "1"}]}]
    for payload in cases:
        assert validate_trace(payload) == j_validate(payload)
        assert validate_trace(payload)
    t = Tracer()
    t.begin_async("job", 7)
    t.begin_async("job", 7)  # a replayed admission: no-op
    t.end_async("job", 7)
    t.end_async("job", 7)
    assert validate_trace({"traceEvents": t.events}) == []
    assert [e["ph"] for e in t.events if e["ph"] in "be"] == ["b", "e"]


def test_metrics_registry_matches_reference(tmp_path):
    """The same calls give the reference's snapshot and JSONL kinds."""
    regs = (Metrics(str(tmp_path / "t.jsonl")), JMetrics(str(tmp_path / "j.jsonl")))
    for m in regs:
        m.inc("widgets", 3)
        m.gauge("depth", 5.0)
        m.observe("lat_s", 0.5)
        m.observe("lat_s", 1.5)
        m.emit("custom", hello=1)
    assert regs[0].snapshot() == regs[1].snapshot()
    assert regs[0].summary("lat_s")["mean"] == pytest.approx(1.0)
    for m in regs:
        m.close()
    kinds = [[json.loads(ln)["kind"] for ln in open(tmp_path / f)]
             for f in ("t.jsonl", "j.jsonl")]
    assert kinds[0] == kinds[1] == ["custom", "snapshot"]


@pytest.mark.parametrize("islands", [1, 3])
def test_session_metrics_equal_reference(islands):
    """The counters of a session's Metrics snapshot (host syncs, blocks,
    cache hits/queries, migrations, tree evals, trees·rows, frozen)
    equal the reference session's on the same run, with its gauges."""
    X, y = _lattice()
    kw = dict(pop_size=12, generations=7, block_size=3, islands=islands,
              migrate_every=2, migrate_k=2, stop_fitness=-1.0, **LATTICE)
    mine, theirs = Metrics(), JMetrics()
    got = GPSession(device="cpu", metrics=mine, **kw).fit(X, y, key=prng.PRNGKey(1))
    want = JSession(backend="jnp", metrics=theirs, **kw).fit(X, y, key=jax.random.PRNGKey(1))
    assert got.history == want.history
    a, b = mine.snapshot(), theirs.snapshot()
    assert a["counters"] == b["counters"]
    for name in ("generation", "rows", "cache_hit_rate"):
        assert a["gauges"][name] == b["gauges"][name], name
    assert a["summaries"]["block_s"]["count"] == b["summaries"]["block_s"]["count"]
    if islands > 1:
        assert a["counters"]["migrations"] > 0


@pytest.mark.parametrize("islands", [1, 3])
@pytest.mark.parametrize("genome", ["tree", "postfix"])
def test_telemetry_on_off_bitwise(islands, genome, tmp_path):
    """Tracer and Metrics on give the same state, history and host-sync
    count as off: observability is host-side only."""
    X, y = _lattice()
    kw = dict(pop_size=12, generations=8, block_size=3, islands=islands, genome=genome,
              migrate_every=3, migrate_k=2, **LATTICE)
    off = GPSession(device="cpu", **kw).fit(X, y, key=prng.PRNGKey(0))
    tracer, mreg = Tracer(str(tmp_path / "t.json")), Metrics(str(tmp_path / "m.jsonl"))
    on = GPSession(device="cpu", tracer=tracer, metrics=mreg, **kw).fit(
        X, y, key=prng.PRNGKey(0))
    mreg.close()
    for a, b in zip(off.state, on.state):
        assert torch.equal(a, b)
    assert on.history == off.history and on.counter_history == off.counter_history
    assert on.stats["host_syncs"] == off.stats["host_syncs"] == 3
    np.testing.assert_array_equal(np.asarray(on.island_history),
                                  np.asarray(off.island_history))


def test_block_monitor_routes_all_timing():
    """BlockMonitor updates the metrics registry and the stats dict
    together; a session's stats carry block_s_ema and stragglers."""
    mon, m = StepMonitor(), Metrics()
    stats = {"blocks": 0, "block_s_ema": None, "stragglers": []}
    bm = BlockMonitor(mon, m, stats)
    for _ in range(3):
        with bm:
            pass
    assert stats["blocks"] == 3 and stats["block_s_ema"] == mon.ema
    assert m.counter_value("blocks") == 3 and m.summary("block_s")["count"] == 3
    X, y = _lattice()
    s = GPSession(device="cpu", pop_size=8, generations=4, block_size=2, **LATTICE)
    s.fit(X, y, key=prng.PRNGKey(0))
    assert s.stats["blocks"] == 2 and s.stats["block_s_ema"] > 0
    assert s.stats["stragglers"] == [] or isinstance(s.stats["stragglers"][0], tuple)
    assert s.metrics.counter_value("host_syncs") == s.stats["host_syncs"] == 2


def test_null_tracer_is_inert():
    with NULL_TRACER.span("x"), NULL_TRACER.maybe_profile(0):
        pass
    NULL_TRACER.instant("x")
    NULL_TRACER.counter("x", {"a": 1})
    NULL_TRACER.begin_async("x", 1)
    NULL_TRACER.end_async("x", 1)
    assert NULL_TRACER.save() is None and not NULL_TRACER.enabled


def test_report_summarizes_run_artifacts(tmp_path, capsys):
    """`python -m repro_torch.obs.report` renders a session's metrics
    JSONL and validates its trace."""
    X, y = _lattice()
    tpath, mpath = str(tmp_path / "t.json"), str(tmp_path / "m.jsonl")
    tracer, mreg = Tracer(tpath), Metrics(mpath)
    GPSession(device="cpu", pop_size=12, generations=6, block_size=3, tracer=tracer,
              metrics=mreg, **LATTICE).fit(X, y, key=prng.PRNGKey(0))
    tracer.save()
    mreg.close()
    assert report.main([mpath, "--trace", tpath]) == 0
    out = capsys.readouterr().out
    assert "trace: valid" in out and "cache hit rate" in out
    assert "block" in out and "counters" in out
    records = report.load_jsonl(mpath)
    assert records[-1]["kind"] == "snapshot"
    assert sum(r["kind"] == "block" for r in records) == 2


def test_maybe_profile_cpu_window(tmp_path):
    """A Tracer armed with profile_dir wraps exactly the chosen block in a
    torch.profiler window (CPU activity here) and writes its Chrome
    trace; the run's trajectory is unchanged."""
    X, y = _lattice()
    kw = dict(pop_size=8, generations=6, block_size=2, islands=2, **LATTICE)
    tracer = Tracer(str(tmp_path / "t.json"), profile_dir=str(tmp_path / "prof"),
                    profile_block=1)
    on = GPSession(device="cpu", tracer=tracer, **kw).fit(X, y, key=prng.PRNGKey(2))
    off = GPSession(device="cpu", **kw).fit(X, y, key=prng.PRNGKey(2))
    assert on.history == off.history
    assert os.listdir(tmp_path / "prof") == ["block_1.json"]
    with open(tmp_path / "prof" / "block_1.json") as f:
        assert json.load(f)["traceEvents"]
    assert len(tracer.last_profile.key_averages()) > 0
    assert Tracer(profile_dir=str(tmp_path)).profile_block == 0
