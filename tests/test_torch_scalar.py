"""The scalar baseline (the paper's 1-CPU_SP) on the port against the
reference: `core/scalar_eval` predictions and `fitness_scalar` bit for
bit (both are the same f32-rounded Python interpreter), the `scalar`
backend's registry entry, and the host generation loop — classic and
island sessions bitwise the reference's scalar sessions on lattice data
(at most 16 rows: every tree runs row by row in Python)."""
import jax
import numpy as np
import pytest
import torch

from repro.core import primitives as jprim
from repro.core import scalar_eval as jscalar
from repro.core import trees as jtrees
from repro.gp import GPSession as JSession
from repro.gp import backends as jbackends
from repro_torch.core import engine as tengine
from repro_torch.core import primitives as tprim
from repro_torch.core import prng
from repro_torch.core import scalar_eval as tscalar
from repro_torch.core import trees as ttrees
from repro_torch.core.fitness import FitnessSpec
from repro_torch.data import datasets as tdata
from repro_torch.gp import GPSession
from repro_torch.gp import backends as tbackends
from jax_release import release_jax_programs  # noqa: F401  (frees compiled programs)

torch.set_num_threads(2)

LATTICE = dict(kernel="r", max_depth=3, p_const=0.0, fn_set="add,sub,mul")
J_ARITH = jprim.FunctionSet.make(("add", "sub", "mul"))


def _lattice(rows=16, feats=3, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randint(-2, 3, size=(rows, feats)).astype(np.float32)
    y = rng.randint(-2, 3, size=rows).astype(np.float32)
    return X, y


def _population(genome, fn_set, P=10, F=3, depth=4, seed=0):
    """A reference population (numpy) of `genome` trees over `fn_set`."""
    spec = jtrees.TreeSpec(max_depth=depth, n_features=F, fn_set=fn_set, genome=genome)
    op, arg = jtrees.generate_population(jax.random.PRNGKey(seed), P, spec)
    return spec, np.asarray(op), np.asarray(arg), np.asarray(spec.const_table())


def _assert_state_equal(jstate, tstate):
    got = tengine.state_to_numpy(tstate)
    for name, leaf in jstate._asdict().items():
        np.testing.assert_array_equal(got[name], np.asarray(leaf), err_msg=f"GPState.{name}")


@pytest.mark.parametrize("genome", ["tree", "postfix"])
@pytest.mark.parametrize("fn_set", ["kitchen_sink", "arith"])
def test_scalar_predictions_bitwise(genome, fn_set):
    """`evaluate_population_scalar` (and the per-row interpreters beneath
    it) give the reference's predictions bit for bit, KITCHEN_SINK
    included: the f32 rounding at every node is the same Python."""
    fs = jprim.KITCHEN_SINK if fn_set == "kitchen_sink" else J_ARITH
    spec, op, arg, consts = _population(genome, fs, seed=3)
    X = np.random.RandomState(1).randn(12, 3).astype(np.float32)
    want = jscalar.evaluate_population_scalar(op, arg, X, consts, genome=genome)
    got = tscalar.evaluate_population_scalar(op, arg, X, consts, genome=genome)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    one = tscalar.eval_postfix_scalar if genome == "postfix" else tscalar.eval_tree_scalar
    assert one(op[0], arg[0], X[0], consts) == float(want[0, 0]) or np.isnan(want[0, 0])


@pytest.mark.parametrize("kernel", ["r", "c", "m", "mse", "pearson", "r2"])
def test_fitness_scalar_matches_reference(kernel):
    """`fitness_scalar` (the port's fitness kernels on CPU tensors) equals
    the reference's (jnp) on the same scalar predictions, with and
    without a padding weight: bitwise on lattice data for the
    decomposable kernels (integer sums), within 1e-6 for pearson/r2
    there (their centered sums are not integers: ROADMAP C12) and for
    every kernel on KITCHEN_SINK trees over real data (sums in another
    order), with the same non-finite pattern."""
    spec, op, arg, consts = _population("tree", J_ARITH, P=8, depth=3)
    X, y = _lattice()
    if kernel == "c":
        y = np.abs(y) % 3
    w = np.r_[np.ones(12), np.zeros(4)].astype(np.float32)
    for weight in (None, w):
        kw = dict(kernel=kernel, n_classes=3, weight=weight)
        want = jscalar.fitness_scalar(op, arg, X, y, consts, **kw)
        got = tscalar.fitness_scalar(op, arg, X, y, consts, **kw)
        assert got.dtype == np.float32
        if kernel in ("pearson", "r2"):
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(got, want)
    spec, op, arg, consts = _population("tree", jprim.KITCHEN_SINK, P=8, depth=3, seed=5)
    Xr = np.random.RandomState(2).randn(16, 3).astype(np.float32)
    yr = (Xr[:, 0] * Xr[:, 1]).astype(np.float32)
    want = jscalar.fitness_scalar(op, arg, Xr, yr, consts, kernel=kernel, n_classes=3)
    got = tscalar.fitness_scalar(op, arg, Xr, yr, consts, kernel=kernel, n_classes=3)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_scalar_backend_registry():
    """`scalar` is registered host-only with the reference's capabilities,
    its fitness/moments come back on the population's device and agree
    with the `torch` backend, and `auto` never yields it."""
    b = tbackends.get_backend("scalar")
    assert b.capabilities() == jbackends.get_backend("scalar").capabilities()
    assert b.jittable is False and b.supports_topology is False
    for name in ("torch", "cuda"):
        caps = tbackends.get_backend(name).capabilities()
        assert caps["jittable"] and caps["supports_topology"]
        assert tbackends.get_backend(name).stream_moments is not None
    assert {"scalar", "torch", "cuda"} <= set(tbackends.available_backends())
    for dev in (None, "cpu", "cuda", "cuda:0", torch.device("cpu")):
        assert tbackends.auto_select(dev) != "scalar"
    assert tbackends.get_backend("auto", "cpu").name == "torch"
    spec = ttrees.TreeSpec(max_depth=3, n_features=3,
                           fn_set=tprim.FunctionSet.make(("add", "sub", "mul")))
    op, arg = ttrees.generate_population(prng.PRNGKey(0), 8, spec)
    X, y = _lattice()
    Xt, yt = torch.from_numpy(np.ascontiguousarray(X.T)), torch.from_numpy(y)
    fs = FitnessSpec("mse")
    consts = spec.const_table("cpu")
    got = b.fitness(op, arg, Xt, yt, consts, spec, fs)
    want = tbackends.get_backend("torch").fitness(op, arg, Xt, yt, consts, spec, fs)
    assert got.device == op.device
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(
        b.moments(op, arg, Xt, yt, consts, spec, fs).numpy(),
        tbackends.get_backend("torch").moments(op, arg, Xt, yt, consts, spec, fs).numpy())
    np.testing.assert_array_equal(b.evaluate(op, arg, Xt, consts, spec).numpy(),
                                  tbackends.get_backend("torch").evaluate(
                                      op, arg, Xt, consts, spec).numpy())


@pytest.mark.parametrize("genome", ["tree", "postfix"])
def test_scalar_session_matches_reference(genome):
    """The scalar session (host loop, one sync a generation) walks the
    reference's scalar session bit for bit on lattice data: history,
    state, the cache counters; the unchunked run equals the same run in
    chunks of 6 rows (3 chunks, the last ragged)."""
    X, y = _lattice()
    kw = dict(pop_size=12, genome=genome, **LATTICE)
    js = JSession(backend="scalar", **kw).fit(X, y, generations=4, key=jax.random.PRNGKey(2))
    ts = GPSession(backend="scalar", device="cpu", **kw)
    ts.fit(X, y, generations=4, key=prng.PRNGKey(2))
    assert ts.history == js.history
    _assert_state_equal(js.state, ts.state)
    assert ts.stats["host_syncs"] == js.stats["host_syncs"] == 4
    for k in ("cache_hits", "cache_queries", "tree_evals"):
        assert ts.stats[k] == js.stats[k], k
    assert ts.stats["blocks"] == 4 and ts.stats["block_s_ema"] is not None
    chunked = GPSession(backend="scalar", device="cpu", chunk_rows=6, **kw)
    chunked.fit(X, y, generations=4, key=prng.PRNGKey(2))
    assert chunked.history == ts.history and chunked._stream.n_chunks == 3
    assert ts.best_expression() == js.best_expression()
    np.testing.assert_array_equal(ts.predict(X), np.asarray(js.predict(X)))


def test_scalar_island_session_matches_reference():
    """Scalar islands: one evaluation of the flattened [I*P] population,
    the batched breeder with each island's operators, migration — the
    reference's scalar island session bit for bit on lattice data."""
    X, y = _lattice()
    kw = dict(pop_size=8, islands=3, migrate_every=2, migrate_k=1, **LATTICE)
    js = JSession(backend="scalar", **kw).fit(X, y, generations=3,
                                               key=jax.random.PRNGKey(4))
    ts = GPSession(backend="scalar", device="cpu", **kw)
    ts.fit(X, y, generations=3, key=prng.PRNGKey(4))
    assert ts.history == js.history
    np.testing.assert_array_equal(np.asarray(ts.island_history), np.asarray(js.island_history))
    _assert_state_equal(js.state, ts.state)
    assert ts.state.op.shape == (3, 8, 15)


def test_scalar_session_cadence_and_stop(tmp_path):
    """The host loop keeps the session's contracts: the callback cadence,
    early stop after the generation that reaches `stop_fitness`, a
    checkpoint each period that a new session resumes from, and the CLI
    door with `--backend scalar`."""
    from repro_torch.launch import evolve as tevolve

    X, y = _lattice()
    seen = []
    s = GPSession(backend="scalar", device="cpu", pop_size=8, callback_every=2,
                  callback=lambda g, st: seen.append(g), **LATTICE)
    s.fit(X, y, generations=5, key=prng.PRNGKey(0))
    assert seen == [1, 3, 4] and s.generation == 5
    s2 = GPSession(backend="scalar", device="cpu", pop_size=8, stop_fitness=1e9, **LATTICE)
    s2.fit(X, y, generations=50, key=prng.PRNGKey(0))
    assert s2.generation == 1
    ck = str(tmp_path / "ck")
    first = GPSession(backend="scalar", device="cpu", pop_size=8, checkpoint_dir=ck,
                      checkpoint_every=2, **LATTICE)
    first.fit(X, y, generations=4, key=prng.PRNGKey(0))
    again = GPSession(backend="scalar", device="cpu", pop_size=8, checkpoint_dir=ck,
                      checkpoint_every=2, **LATTICE).ingest(X, y)
    again.init(key=prng.PRNGKey(0))
    assert again.generation == 4
    tevolve.main(["--dataset", "kepler", "--device", "cpu", "--backend", "scalar",
                  "--pop", "6", "--depth", "3", "--generations", "2"])
    X_rows, y_rows, _ = tdata.kepler()
    assert GPSession.from_dataset("kepler", backend="scalar", device="cpu").n_rows == 9
