"""Streaming chunked fitness on the port against the reference
(`tests/test_stream.py`'s pins, each held against `repro` on the same
inputs).

  * `ChunkedDataset` and `stream_rows` give bitwise the reference's
    chunks and rows, for every source kind;
  * `ops.stream_moments` and `engine.chunked_fitness` (plain and the
    kernels' CPU route) equal the reference's fold;
  * streamed sessions (backends `torch` and `scalar`) walk the
    reference's streamed sessions: bitwise on integer-lattice data for
    the decomposable kernels (every partial sum is an exact integer),
    within 1e-4 for pearson/r2; ragged, all-padded and oversize chunks,
    heap and postfix genomes, islands; streamed == monolithic on the port;
  * the fold's algebra: the zero moment is the merge identity.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core import fitness as jfit
from repro.data import datasets as jdata
from repro.data import loader as jloader
from repro.gp import GPSession as JSession
from repro.kernels import ops as jops
from repro_torch.core import engine as tengine
from repro_torch.core import fitness as tfit
from repro_torch.core import prng
from repro_torch.data import datasets as tdata
from repro_torch.data.loader import ChunkedDataset
from repro_torch.gp import GPSession
from repro_torch.kernels import gp_eval
from repro_torch.kernels import ops as tops

torch.set_num_threads(2)

LATTICE = dict(fn_set="add,sub,mul", p_const=0.0, max_depth=3)
JBACKEND = {"torch": "jnp", "scalar": "scalar"}


def _dataset(rows=500, feats=5, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(rows, feats).astype(np.float32)
    y = (X[:, 0] * X[:, 1] + X[:, 2]).astype(np.float32)
    return X, y


def _lattice(rows=96, feats=4, seed=0, classes=None):
    """Small-integer data: with fn_set +,-,* and p_const=0 every depth-3
    prediction and every decomposable moment is an exact f32 integer
    well under 2^24, so partial sums do not depend on their order."""
    rng = np.random.RandomState(seed)
    X = rng.randint(-2, 3, size=(rows, feats)).astype(np.float32)
    if classes:
        y = rng.randint(0, classes, size=rows).astype(np.float32)
    else:
        y = rng.randint(-2, 3, size=rows).astype(np.float32)
    return X, y


def _sessions(backend, X, y, chunk_rows, *, seed=1, gens=1, **kw):
    """(reference streamed, port streamed, port monolithic) sessions after
    `gens` generations from the same key."""
    js = JSession(backend=JBACKEND[backend], **kw)
    js.ingest(X, y, chunk_rows=chunk_rows)
    js.init(key=jax.random.PRNGKey(seed))
    ts = GPSession(backend=backend, device="cpu", **kw)
    ts.ingest(X, y, chunk_rows=chunk_rows)
    ts.init(key=prng.PRNGKey(seed))
    tm = GPSession(backend=backend, device="cpu", **kw)
    tm.ingest(X, y)
    tm.init(key=prng.PRNGKey(seed))
    for s in (js, ts, tm):
        s.evolve(gens)
    return js, ts, tm


def _assert_state_equal(jstate, tstate):
    got = tengine.state_to_numpy(tstate)
    for name, leaf in jstate._asdict().items():
        np.testing.assert_array_equal(got[name], np.asarray(leaf), err_msg=f"GPState.{name}")


# --- sessions: the reference's grid of kernels, torch and scalar -------------


@pytest.mark.parametrize("backend", ["torch", "scalar"])
@pytest.mark.parametrize("kernel", ["mse", "c", "m"])
def test_stream_session_bitwise_on_lattice(backend, kernel):
    """Streamed sessions (ragged final chunk: 40 rows in chunks of 16)
    walk the reference's streamed session bit for bit over 3 generations
    — history, population, champion, cache — and equal the port's own
    monolithic run."""
    X, y = _lattice(rows=40, classes=3 if kernel == "c" else None)
    kw = dict(pop_size=12, kernel=kernel, **LATTICE)
    js, ts, tm = _sessions(backend, X, y, 16, gens=3, **kw)
    assert ts.history == js.history == tm.history
    _assert_state_equal(js.state, ts.state)
    _assert_state_equal(js.state, tm.state)
    assert ts.n_rows == 40 and ts.stats["host_syncs"] == js.stats["host_syncs"] == 3
    for k in ("cache_hits", "cache_queries", "tree_evals"):
        assert ts.stats[k] == js.stats[k], k
    assert ts.stats["tree_row_evals"] == ts.stats["tree_evals"] * 40


@pytest.mark.parametrize("backend", ["torch", "scalar"])
@pytest.mark.parametrize("kernel", ["pearson", "r2"])
def test_stream_session_two_pass(backend, kernel):
    """pearson/r2 (the Chan merge across chunks): the streamed first
    generation's fitness is within 1e-4 of the reference's streamed one
    and of the port's monolithic one, on real-valued data."""
    X, y = _dataset(rows=40 if backend == "scalar" else 500)
    kw = dict(pop_size=12, max_depth=3, kernel=kernel)
    js, ts, tm = _sessions(backend, X, y, 16 if backend == "scalar" else 128, **kw)
    want = np.asarray(js.state.fitness)
    for got in (ts.state.fitness.numpy(), tm.state.fitness.numpy()):
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("genome", ["tree", "postfix"])
def test_stream_genomes_match_reference(genome):
    """Heap and postfix genomes stream alike: B1 or B2's route on CPU
    tensors (`ops.stream_moments` under impl="cuda"), the plain fold, and
    the reference's fold, bitwise on lattice data."""
    X, y = _lattice(rows=90)
    kw = dict(pop_size=16, kernel="r", genome=genome, **LATTICE)
    js, ts, tm = _sessions("torch", X, y, 40, gens=2, **kw)
    assert ts.history == js.history == tm.history
    _assert_state_equal(js.state, ts.state)
    cfg = ts.config
    op, arg = ts.state.op, ts.state.arg
    ds = ChunkedDataset(X, y, chunk_rows=40)
    gp_eval.reset_launches()
    got = tengine.chunked_fitness(cfg, op, arg, ds, impl="cuda")
    assert sum(gp_eval.launches.values()) == 0  # CPU tensors: the plain versions
    want = tengine.chunked_fitness(cfg, op, arg, ds, impl="torch")
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_stream_chunking_edges():
    """All-padded, oversize and exact-multiple chunks: a dataset of 64
    rows in chunks of 4096 (one mostly padded chunk), of 32 (exact) and
    of 24 (ragged), all equal to the monolithic fitness bitwise on
    lattice data; a trailing all-zero-weight chunk changes nothing."""
    X, y = _lattice(rows=64)
    kw = dict(pop_size=16, kernel="r", **LATTICE)
    mono = GPSession(device="cpu", **kw).ingest(X, y).init(key=prng.PRNGKey(2))
    mono.step()
    for chunk in (4096, 32, 24):
        s = GPSession(device="cpu", **kw).ingest(X, y, chunk_rows=chunk)
        s.init(key=prng.PRNGKey(2))
        s.step()
        np.testing.assert_array_equal(s.state.fitness.numpy(), mono.state.fitness.numpy())
    cfg, st = mono.config, mono.state
    chunks = list(ChunkedDataset(X, y, chunk_rows=32))
    padded = chunks + [(np.full_like(chunks[0][0], 7.0), np.ones(32, np.float32),
                        np.zeros(32, np.float32))]
    np.testing.assert_array_equal(
        tengine.chunked_fitness(cfg, st.op, st.arg, padded, impl="torch").numpy(),
        tengine.chunked_fitness(cfg, st.op, st.arg, chunks, impl="torch").numpy())


def test_session_chunking_invariance():
    """Two streamed runs with different chunk sizes have identical
    histories on lattice data (fitness bitwise => the same selections)."""
    X, y = _lattice(rows=120)
    hist = []
    for chunk in (16, 64):
        s = GPSession(pop_size=24, kernel="r", device="cpu", **LATTICE)
        s.ingest(X, y, chunk_rows=chunk)
        s.init(key=prng.PRNGKey(7))
        s.evolve(4)
        hist.append(list(s.history))
    assert hist[0] == hist[1]


def test_stream_islands_match_reference():
    """Island-batched evolution streams too: the flattened [I*P] fold, one
    batched breeding step and migration, bitwise the reference's streamed
    island session on lattice data."""
    X, y = _lattice(rows=60)
    kw = dict(pop_size=10, kernel="r", islands=3, migrate_every=2, migrate_k=2, **LATTICE)
    js, ts, tm = _sessions("torch", X, y, 25, gens=3, **kw)
    assert ts.state.fitness.shape == (3, 10)
    assert ts.history == js.history == tm.history
    np.testing.assert_array_equal(np.asarray(ts.island_history),
                                  np.asarray(js.island_history))
    _assert_state_equal(js.state, ts.state)


def test_stream_front_doors():
    """Constructor chunk_rows=, ingest(stream=callable), a prebuilt
    ChunkedDataset and `from_dataset` all route to the same fold."""
    X, y = _dataset(rows=256)
    kw = dict(pop_size=16, max_depth=3, kernel="mse", device="cpu")
    s1 = GPSession(chunk_rows=64, **kw).ingest(X, y).init(key=prng.PRNGKey(0))
    s1.step()

    def blocks():
        yield X, y

    s2 = GPSession(**kw).ingest(stream=blocks, chunk_rows=64).init(key=prng.PRNGKey(0))
    s2.step()
    s3 = GPSession(**kw).ingest(stream=ChunkedDataset(X, y, chunk_rows=64))
    s3.init(key=prng.PRNGKey(0))
    s3.step()
    f1 = s1.state.fitness.numpy()
    np.testing.assert_array_equal(f1, s2.state.fitness.numpy())
    np.testing.assert_array_equal(f1, s3.state.fitness.numpy())
    with pytest.raises(ValueError, match="not both"):
        s3.ingest(X, y, stream=blocks)
    with pytest.raises(ValueError, match="chunk_rows"):
        GPSession(**kw).ingest(stream=blocks)
    with pytest.raises(ValueError, match="conflicts"):
        GPSession(**kw).ingest(stream=ChunkedDataset(X, y, chunk_rows=64), chunk_rows=32)
    s4 = GPSession.from_dataset("kepler", pop_size=8, chunk_rows=4, device="cpu")
    assert s4._stream.n_chunks == 3 and s4.n_rows == 9


def test_stream_blocks_rejected():
    """Evolution blocks need a device-resident dataset: a streamed
    session says so, with the reference's words."""
    X, y = _dataset(rows=200)
    s = GPSession(pop_size=16, max_depth=3, kernel="mse", device="cpu")
    s.ingest(X, y, chunk_rows=64).init(key=prng.PRNGKey(0))
    with pytest.raises(ValueError, match="chunk fold"):
        s.evolve_block(4)
    sc = GPSession(pop_size=8, backend="scalar", device="cpu").ingest(X[:8], y[:8])
    with pytest.raises(ValueError, match="host-only"):
        sc.evolve_block(2)


def test_stream_trace_and_metrics(tmp_path):
    """The host loop's telemetry: a `stream_fold` span and a
    `stream_fold_s` observation per evaluation, `tree_row_evals` on the
    real rows, and `rows` gauged once a callable source's first pass has
    counted them."""
    from repro_torch.obs import Metrics, Tracer

    tracer, metrics = Tracer(str(tmp_path / "t.json")), Metrics()
    s = GPSession(pop_size=8, max_depth=3, kernel="mse", device="cpu", tracer=tracer,
                  metrics=metrics)
    s.ingest(stream=tdata.stream_rows(rows=3000, block_rows=700), chunk_rows=1024)
    assert s.n_rows == 0 and s._stream.n_rows is None
    s.init(key=prng.PRNGKey(0)).evolve(2)
    assert s.n_rows == 3000 and metrics.snapshot()["gauges"]["rows"] == 3000
    assert metrics.summary("stream_fold_s")["count"] == 2
    assert s.stats["tree_row_evals"] == metrics.counter_value("tree_row_evals") > 0
    names = {e["name"] for e in tracer.events if e.get("ph") == "B"}
    assert {"ingest", "init", "stream_fold"} <= names


# --- the fold: ops.stream_moments, chunked_fitness, the merge identity -------


@pytest.mark.parametrize("kernel", ["r", "c", "mse", "pearson", "r2"])
def test_stream_moments_matches_reference(kernel):
    """One fold step, `ops.stream_moments` (plain and the kernels' CPU
    route) against the reference's `impl="jnp"` step, from a nonzero
    accumulator: bitwise for the decomposable kernels on lattice data,
    1e-4 for pearson/r2."""
    js = JSession(pop_size=12, kernel=kernel, backend="jnp", **LATTICE)
    X, y = _lattice(rows=48, classes=3 if kernel == "c" else None)
    js.ingest(X, y).init(key=jax.random.PRNGKey(5))
    cfg = js.config
    op, arg = np.array(js.state.op), np.array(js.state.arg)
    chunks = list(jloader.ChunkedDataset(X, y, chunk_rows=20))
    consts = np.array(cfg.tree_spec.const_table())
    acc_j = jnp.zeros((12, jfit.get_kernel(kernel).n_moments), jnp.float32)
    for Xc, yc, wc in chunks:
        acc_j = jops.stream_moments(acc_j, op, arg, Xc, yc, consts, cfg.tree_spec,
                                    cfg.fitness, weight=wc, impl="jnp")
    tcfg = GPSession(pop_size=12, kernel=kernel, n_features=4, device="cpu",
                     **LATTICE).config
    t = torch.from_numpy
    for impl in ("torch", "cuda"):
        acc = torch.zeros(acc_j.shape)
        for Xc, yc, wc in chunks:
            acc = tops.stream_moments(acc, t(op), t(arg), t(Xc), t(yc), t(consts),
                                      tcfg.tree_spec, tcfg.fitness, weight=t(wc),
                                      impl=impl, device="cpu")
        if kernel in ("pearson", "r2"):
            np.testing.assert_allclose(acc.numpy(), np.asarray(acc_j), rtol=1e-4, atol=1e-4)
        else:
            np.testing.assert_array_equal(acc.numpy(), np.asarray(acc_j))
    with pytest.raises(ValueError, match="population is on"):
        tops.stream_moments(acc, t(op), t(arg), t(Xc), t(yc), t(consts), tcfg.tree_spec,
                            tcfg.fitness, impl="torch", device="meta")


def test_chunked_fitness_matches_reference():
    """`engine.chunked_fitness` (the raw fold, sample weights on a
    prebuilt ChunkedDataset) against the reference's fold and the port's
    monolithic backend call, under r2: within 1e-4."""
    X, y = _dataset(rows=400)
    w = np.random.RandomState(5).rand(400).astype(np.float32)
    js = JSession(pop_size=16, max_depth=4, kernel="r2", backend="jnp")
    js.ingest(X, y).init(key=jax.random.PRNGKey(4))
    want = np.asarray(jengine.chunked_fitness(
        js.config, js.state.op, js.state.arg,
        jloader.ChunkedDataset(X, y, chunk_rows=96, sample_weight=w), impl="jnp"))
    ts = GPSession(pop_size=16, max_depth=4, kernel="r2", device="cpu").ingest(X, y)
    ts.init(key=prng.PRNGKey(4))
    cfg, op, arg = ts.config, ts.state.op, ts.state.arg
    got = tengine.chunked_fitness(cfg, op, arg,
                                  ChunkedDataset(X, y, chunk_rows=96, sample_weight=w))
    mono = tops.fitness(op, arg, torch.from_numpy(np.ascontiguousarray(X.T)),
                        torch.from_numpy(y), cfg.tree_spec.const_table("cpu"),
                        cfg.tree_spec, cfg.fitness, weight=torch.from_numpy(w),
                        impl="torch", device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), mono.numpy(), rtol=1e-4, atol=1e-4)
    from repro_torch.gp import backends as B

    B.register_backend(dataclasses.replace(B.get_backend("torch"), name="nostream",
                                           stream_moments=None))
    try:
        with pytest.raises(ValueError, match="no stream_moments pass"):
            tengine.chunked_fitness(cfg, op, arg, [], impl="nostream")
    finally:
        del B._REGISTRY["nostream"]


@pytest.mark.parametrize("kernel", tfit.available_kernels())
def test_all_padded_chunk_is_noop(kernel):
    """The zero moment is the fold's identity: merging an all-zero-weight
    chunk leaves an accumulator bitwise unchanged (right identity), and
    seeding with zeros gives the first chunk's moments to 1 ulp (left
    identity), as in the reference — whose merge gives the same bits."""
    rng = np.random.RandomState(0)
    preds, y = rng.randn(4, 32).astype(np.float32), rng.randn(32).astype(np.float32)
    pad_preds, pad_y = rng.randn(4, 32).astype(np.float32), rng.randn(32).astype(np.float32)
    kern, jkern = tfit.get_kernel(kernel), jfit.get_kernel(kernel)
    spec, jspec = tfit.FitnessSpec(kernel=kernel), jfit.FitnessSpec(kernel=kernel)
    t = torch.from_numpy
    m = tfit.moments_from_preds(t(preds), t(y), spec, weight=torch.ones(32))
    m_pad = tfit.moments_from_preds(t(pad_preds), t(pad_y), spec, weight=torch.zeros(32))
    np.testing.assert_array_equal(kern.merge_moments(m, m_pad, spec).numpy(), m.numpy())
    seeded = kern.merge_moments(torch.zeros_like(m), m, spec)
    np.testing.assert_allclose(seeded.numpy(), m.numpy(), rtol=1e-6, atol=1e-6)
    jm = np.asarray(m)
    np.testing.assert_array_equal(
        seeded.numpy(), np.asarray(jkern.merge_moments(jnp.zeros_like(jm), jm, jspec)))


def test_fractional_weight_mean_guard():
    """Total weight < 1: the merge of two fractionally weighted shards
    equals the whole-dataset moments (the mean divisor is the true Σw),
    and each merge is bitwise the reference's merge of the same inputs."""
    rng = np.random.RandomState(3)
    preds, y = rng.randn(3, 8).astype(np.float32), rng.randn(8).astype(np.float32)
    w = np.full(8, 0.06, np.float32)  # Σw = 0.48 < 1
    t = torch.from_numpy
    for kernel in ("pearson", "r2"):
        kern, spec = tfit.get_kernel(kernel), tfit.FitnessSpec(kernel=kernel)
        whole = tfit.moments_from_preds(t(preds), t(y), spec, weight=t(w))
        m1 = tfit.moments_from_preds(t(preds[:, :5]), t(y[:5]), spec, weight=t(w[:5]))
        m2 = tfit.moments_from_preds(t(preds[:, 5:]), t(y[5:]), spec, weight=t(w[5:]))
        merged = kern.merge_moments(m1, m2, spec)
        np.testing.assert_allclose(merged.numpy(), whole.numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=kernel)
        jmerged = jfit.get_kernel(kernel).merge_moments(
            jnp.asarray(m1.numpy()), jnp.asarray(m2.numpy()), jfit.FitnessSpec(kernel=kernel))
        np.testing.assert_array_equal(merged.numpy(), np.asarray(jmerged), err_msg=kernel)


# --- the host side: stream_rows and ChunkedDataset ---------------------------


def test_stream_rows_blocking_invariant():
    """`stream_rows` gives the reference's rows, the same for any block
    size (one RandomState across block boundaries)."""
    want = np.concatenate([b[0] for b in jdata.stream_rows(rows=1000, block_rows=1000)()])
    for block_rows in (170, 1000, 4096):
        got = list(tdata.stream_rows(rows=1000, block_rows=block_rows)())
        np.testing.assert_array_equal(np.concatenate([b[0] for b in got]), want)
        ys = np.concatenate([b[1] for b in got])
        np.testing.assert_array_equal(
            ys, np.concatenate([b[1] for b in jdata.stream_rows(rows=1000, block_rows=170)()]))
    assert want.shape == (1000, 8) and "stream_rows" not in tdata.BY_NAME
    with pytest.raises(ValueError):
        tdata.stream_rows(rows=10, feats=2)


def _same_chunks(ours, theirs):
    assert ours.n_rows == theirs.n_rows and ours.n_chunks == theirs.n_chunks
    assert ours.n_features == theirs.n_features
    a, b = list(ours), list(theirs)
    assert len(a) == len(b)
    for ca, cb in zip(a, b):
        for x, z in zip(ca, cb):
            assert x.dtype == z.dtype == np.float32
            np.testing.assert_array_equal(x, z)
    return a


def test_chunked_dataset_sources(tmp_path):
    """Every source kind gives the reference's chunks bit for bit: arrays
    (rows and features layout), memmapped .npy, a one-shot iterator
    (cached) and a callable (re-invoked, n_rows known after a pass)."""
    X = np.arange(20, dtype=np.float32).reshape(10, 2)
    y = np.arange(10, dtype=np.float32)
    chunks = _same_chunks(ChunkedDataset(X, y, chunk_rows=4),
                          jloader.ChunkedDataset(X, y, chunk_rows=4))
    assert len(chunks) == 3 and chunks[-1][2].tolist() == [1, 1, 0, 0]
    _same_chunks(ChunkedDataset(np.ascontiguousarray(X.T), y, chunk_rows=4, layout="features"),
                 jloader.ChunkedDataset(np.ascontiguousarray(X.T), y, chunk_rows=4,
                                        layout="features"))

    def blocks():
        return iter([(X[:6], y[:6]), (X[6:], y[6:])])

    _same_chunks(ChunkedDataset(blocks(), chunk_rows=4),
                 jloader.ChunkedDataset(blocks(), chunk_rows=4))
    ours, theirs = ChunkedDataset(blocks, chunk_rows=3), jloader.ChunkedDataset(blocks,
                                                                                chunk_rows=3)
    assert ours.n_rows is None and ours.n_chunks is None
    list(ours), list(theirs)
    _same_chunks(ours, theirs)
    np.save(tmp_path / "x.npy", X)
    np.save(tmp_path / "y.npy", y)
    mm = ChunkedDataset.from_npy(tmp_path / "x.npy", tmp_path / "y.npy", chunk_rows=4)
    assert isinstance(mm._array, np.memmap)
    _same_chunks(mm, jloader.ChunkedDataset.from_npy(tmp_path / "x.npy", tmp_path / "y.npy",
                                                     chunk_rows=4))
    stream = tdata.stream_rows(rows=5000, block_rows=700)
    _same_chunks(ChunkedDataset(stream, chunk_rows=1024),
                 jloader.ChunkedDataset(jdata.stream_rows(rows=5000, block_rows=700),
                                        chunk_rows=1024))


def test_chunked_dataset_weights_and_errors():
    """Sample weights and weighted blocks pad as the reference's do, and
    every refusal raises the reference's ValueError."""
    X = np.ones((5, 3), np.float32)
    y = np.zeros(5, np.float32)
    w = np.arange(1, 6, dtype=np.float32)
    _same_chunks(ChunkedDataset(X, y, chunk_rows=8, sample_weight=w),
                 jloader.ChunkedDataset(X, y, chunk_rows=8, sample_weight=w))
    _same_chunks(ChunkedDataset(iter([(X, y, w), (X[:2], y[:2], w[:2])]), chunk_rows=3),
                 jloader.ChunkedDataset(iter([(X, y, w), (X[:2], y[:2], w[:2])]),
                                        chunk_rows=3))
    bad = [
        (lambda m: m.ChunkedDataset(X, y, chunk_rows=0), "chunk_rows"),
        (lambda m: m.ChunkedDataset(X, y, chunk_rows=4, layout="cols"), "layout"),
        (lambda m: m.ChunkedDataset(X, chunk_rows=4), "need y"),
        (lambda m: m.ChunkedDataset(X, y[:3], chunk_rows=4), "does not match"),
        (lambda m: m.ChunkedDataset(X, y, chunk_rows=4, sample_weight=w[:2]),
         "sample_weight shape"),
        (lambda m: m.ChunkedDataset(X[0], y, chunk_rows=4), "2-D"),
        (lambda m: m.ChunkedDataset(iter([(X, y, w[:5]), (X, y)]), chunk_rows=4), "weights"),
        (lambda m: m.ChunkedDataset(lambda: iter([(X, y)]), y, chunk_rows=4),
         "inside the blocks"),
        (lambda m: m.ChunkedDataset(lambda: iter(()), chunk_rows=4), "yielded no blocks"),
        (lambda m: m.ChunkedDataset(iter([(X, y[:2])]), chunk_rows=4), "source blocks"),
        (lambda m: list(m.ChunkedDataset(lambda: iter([(X, y)]), chunk_rows=4,
                                         n_features=5)), "3 features, expected 5"),
    ]
    for make, msg in bad:
        errors = []
        for mod in (jloader, __import__("repro_torch.data.loader", fromlist=["x"])):
            with pytest.raises(ValueError, match=msg) as e:
                make(mod)
            errors.append(str(e.value))
        assert errors[0] == errors[1]


def test_chunked_dataset_empty():
    ds = ChunkedDataset(np.zeros((0, 3), np.float32), np.zeros(0, np.float32), chunk_rows=8)
    chunks = _same_chunks(ds, jloader.ChunkedDataset(np.zeros((0, 3), np.float32),
                                                     np.zeros(0, np.float32), chunk_rows=8))
    assert len(chunks) == 1 and ds.n_rows == 0
    Xc, yc, wc = chunks[0]
    assert Xc.shape == (3, 8) and wc.sum() == 0.0


def test_stream_large_callable():
    """A 600k-row callable stream (5 chunks, the last ragged) evolves on
    the plain path with its row count found on the first pass; the
    device never holds more than one chunk's tensors at once (CPU here:
    the fold drops each chunk after its step)."""
    s = GPSession(pop_size=16, max_depth=3, kernel="mse", device="cpu")
    s.ingest(stream=tdata.stream_rows(rows=600_000, block_rows=65_536), chunk_rows=131_072)
    assert s.n_rows == 0
    s.init(key=prng.PRNGKey(0))
    s.evolve(2)
    assert s.n_rows == 600_000 and s._stream.n_chunks == 5
    assert len(s.history) == 2 and np.isfinite(s.history[-1])
    assert s.stats["host_syncs"] == 2
