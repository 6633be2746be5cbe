"""The port's front door as a whole against the reference: the
one-sync-per-block budget, callback cadence and early stop, telemetry
absorption, a full `GPSession` trajectory against `repro`'s, the kepler
quickstart shape, and the options not ported yet. Engine-level parity
(`evolve_block` bitwise) is in test_torch_engine.py."""
import math

import jax
import numpy as np
import pytest
import torch

from repro.gp import GPSession as JSession
from repro_torch.core import engine as tengine
from repro_torch.core import prng
from repro_torch.data import datasets as tdata
from repro_torch.gp import GPSession, MeshTopology
from jax_release import release_jax_programs  # noqa: F401  (frees compiled programs)

torch.set_num_threads(2)


def _assert_state_equal(jstate, tstate):
    got = tengine.state_to_numpy(tstate)
    for name, leaf in jstate._asdict().items():
        want = np.asarray(leaf)
        assert got[name].dtype == want.dtype, name
        np.testing.assert_array_equal(got[name], want, err_msg=f"GPState.{name}")


def test_session_syncs_once_per_block():
    X_rows, y, _ = tdata.kepler()
    s = GPSession(pop_size=16, generations=12, kernel="r", device="cpu", block_size=5)
    s.fit(X_rows, y, key=prng.PRNGKey(0))
    assert s.generation == 12 and len(s.history) == 12
    assert s.stats["host_syncs"] <= math.ceil(12 / 5), s.stats
    s2 = GPSession(pop_size=16, generations=12, kernel="r", device="cpu")
    s2.fit(X_rows, y, key=prng.PRNGKey(0))
    assert s2.stats["host_syncs"] == 1 and s2.stats["blocks"] == 1
    assert s.history == s2.history  # block partition does not change the run
    assert s2.stats["cache_queries"] == 12 and s2.stats["tree_evals"] > 0


def test_raw_block_then_absorb_telemetry():
    """A raw `evolve_block` leaves its counters on the device; one
    `absorb_block_telemetry` sync folds them into `stats`."""
    X_rows, y, _ = tdata.kepler()
    s = GPSession(pop_size=16, kernel="r", device="cpu").ingest(X_rows, y)
    s.init(key=prng.PRNGKey(3))
    _, hist = s.evolve_block(4)
    assert hist.shape == (4,) and s.stats["host_syncs"] == 0
    stats = s.absorb_block_telemetry()
    assert stats["host_syncs"] == 1 and stats["cache_queries"] == 4
    assert stats["tree_row_evals"] == stats["tree_evals"] * 9
    assert s.generation == 4


def test_datasets_and_loader_match_reference():
    """The port's numpy copies of the datasets and the padding helpers
    give the reference's arrays."""
    from repro.data import datasets as jdata
    from repro.data import loader as jloader
    from repro_torch.data import loader as tloader

    for name in ("kepler", "iris", "kat7", "ligo"):
        (jx, jy, jm), (tx, ty, tm) = jdata.BY_NAME[name](), tdata.BY_NAME[name]()
        np.testing.assert_array_equal(jx, tx)
        np.testing.assert_array_equal(jy, ty)
        assert jm == tm
    X, y, _ = tdata.iris()
    w = np.linspace(0.5, 1.0, 150).astype(np.float32)
    for mult in (1, 7, 64):
        for a, b in zip(jloader.pad_rows(X, y, mult, weight=w),
                        tloader.pad_rows(X, y, mult, weight=w)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(jloader.pad_feature_major(X.T, y, mult),
                        tloader.pad_feature_major(tloader.feature_major(X), y, mult)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        tloader.pad_rows(X, y, 0)


def test_session_callback_cadence_and_stop():
    X_rows, y, _ = tdata.kepler()
    seen = []
    s = GPSession(pop_size=16, generations=12, kernel="r", device="cpu",
                  callback=lambda g, st: seen.append(g), callback_every=4)
    s.fit(X_rows, y, key=prng.PRNGKey(0))
    assert seen == [3, 7, 11] and s.stats["blocks"] == 3
    s2 = GPSession(pop_size=16, generations=500, kernel="r", device="cpu",
                   stop_fitness=1e9)  # reached after generation 1
    s2.fit(X_rows, y, key=prng.PRNGKey(0))
    assert s2.generation == 1 and s2.stats["blocks"] == 1


def test_session_matches_reference_trajectory_on_lattice():
    """The session front door (fit with a port key) walks the reference
    session's trajectory: same history, same champion."""
    rng = np.random.RandomState(3)
    X = rng.randint(-2, 3, size=(80, 3)).astype(np.float32)
    y = rng.randint(-2, 3, size=80).astype(np.float32)
    kw = dict(pop_size=20, generations=6, kernel="r", max_depth=3, p_const=0.0,
              fn_set="add,sub,mul", block_size=3)
    js = JSession(backend="jnp", **kw).fit(X, y, key=jax.random.PRNGKey(1))
    ts = GPSession(device="cpu", **kw).fit(X, y, key=prng.PRNGKey(1))
    assert ts.history == js.history
    assert ts.best_expression() == js.best_expression()
    np.testing.assert_array_equal(ts.predict(X), np.asarray(js.predict(X)))
    assert ts.score(X, y) == pytest.approx(js.score(X, y), rel=1e-6)


def test_from_dataset_kepler_runs():
    """kepler quickstart shape on the CPU: generation-0 fitness matches the
    reference within rtol 1e-4 (KITCHEN_SINK trees pass through sin/cos/
    log, whose torch and XLA versions differ by ulps); the best fitness
    is finite and never increases."""
    ts = GPSession.from_dataset("kepler", pop_size=50, device="cpu")
    ts.init(key=prng.PRNGKey(0))
    js = JSession.from_dataset("kepler", pop_size=50, backend="jnp")
    js.init(key=jax.random.PRNGKey(0))
    _assert_state_equal(js.state, ts.state)
    ts.step()
    js.step()
    want, got = np.asarray(js.state.fitness), ts.state.fitness.numpy()
    np.testing.assert_array_equal(np.isfinite(want), np.isfinite(got))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-4, atol=1e-4)
    ts.evolve(4)
    h = np.asarray([float(ts.state.fitness.min())] + ts.history)
    assert np.isfinite(ts.history).all() and (np.diff(ts.history) <= 0).all(), h
    assert ts.generation == 5 and isinstance(ts.best_expression(), str)


def test_default_config_picks_the_device_backend(monkeypatch):
    """A default `GPConfig` resolves its backend from the device: the
    kernel on a CUDA device, the plain version on the CPU, whichever
    entry point it reaches (a session given the config, `from_dataset`
    with it, or the engine called directly)."""
    from repro_torch.core.trees import TreeSpec
    from repro_torch.gp import backends

    cfg = tengine.GPConfig(pop_size=8, tree_spec=TreeSpec(n_features=1))
    assert cfg.eval_impl == "auto"
    assert backends.get_backend(cfg.eval_impl, "cuda").name == "cuda"
    assert backends.get_backend(cfg.eval_impl, "cpu").name == "torch"
    assert GPSession(config=cfg, device="cpu").backend == "torch"
    s = GPSession.from_dataset("kepler", config=cfg, device="cpu")
    assert s.backend == "torch" and s.config.eval_impl == "torch"
    with pytest.raises(ValueError, match="cuda"):
        GPSession(config=tengine.GPConfig(eval_impl="cuda"), device="cpu")
    seen = []
    real = backends.get_backend
    monkeypatch.setattr(backends, "get_backend",
                        lambda name, device=None: seen.append(
                            real(name, device).name) or real(name, device))
    X, y = torch.ones(1, 9), torch.ones(9)
    state = tengine.init_state(cfg, prng.PRNGKey(0), device="cpu")
    tengine.evolve_step(cfg, state, X, y)
    assert seen == ["torch"]


def test_not_ported_options_raise(tmp_path):
    """Every option of the reference's session is ported now: a session
    with a `MeshTopology` (A11) runs, and the `scalar` backend refuses a
    topology with the reference's ValueError; streaming (constructor and
    ingest `chunk_rows=`), the `scalar` backend, islands, checkpoints and
    the tracer/metrics construct and run, an empty stream raises the
    reference's ValueError, and the slot swap runs (on a classic session
    it raises the reference's ValueError)."""
    X_rows, y, _ = tdata.kepler()
    meshed = GPSession(device="cpu", pop_size=8, max_depth=3,
                       topology=MeshTopology(data=2, model=2)).fit(X_rows, y, generations=2)
    assert meshed.generation == 2 and meshed.n_rows == 9 and meshed.mesh.size == 4
    assert math.isfinite(meshed.best_fitness)
    with pytest.raises(ValueError, match="does not support mesh topologies"):
        GPSession(device="cpu", backend="scalar", topology=MeshTopology(data=2))
    assert GPSession(device="cpu", chunk_rows=8)._chunk_rows == 8
    assert GPSession(device="cpu", backend="scalar").backend == "scalar"
    s = GPSession(device="cpu", pop_size=8).ingest(X_rows, y)
    s.ingest(X_rows, y, chunk_rows=4)
    assert s.n_rows == 9 and s._stream.n_chunks == 3
    with pytest.raises(ValueError, match="needs chunk_rows"):
        GPSession(device="cpu", pop_size=8).ingest(stream=iter(()))
    with pytest.raises(ValueError, match="yielded no blocks"):
        s.ingest(stream=iter(()), chunk_rows=4)
    s.ingest(X_rows, y).init(key=prng.PRNGKey(0))
    for call in (lambda: s.export_island(0), lambda: s.import_island(0, None)):
        with pytest.raises(ValueError, match="islands > 1"):
            call()
    assert s.adopt_state(s.state).generation == 0
    from repro_torch.obs import Metrics, Tracer

    for kw in (dict(islands=2), dict(checkpoint_dir=str(tmp_path / "x")),
               dict(tracer=Tracer(), metrics=Metrics())):
        assert GPSession(device="cpu", **kw).islands == kw.get("islands", 1)


@pytest.mark.parametrize("dedup", ["off", "exact"])
def test_postfix_session_matches_reference_on_lattice(dedup):
    """GPSession(genome="postfix") walks the reference session's
    trajectory (same history, champion, predictions and score), and its
    stats carry the dedup columns."""
    rng = np.random.RandomState(4)
    X = rng.randint(-2, 3, size=(80, 3)).astype(np.float32)
    y = rng.randint(-2, 3, size=80).astype(np.float32)
    kw = dict(pop_size=16, generations=6, kernel="r", max_depth=4, p_const=0.0,
              fn_set="add,sub,mul", genome="postfix", dedup=dedup, block_size=3)
    js = JSession(backend="jnp", **kw).fit(X, y, key=jax.random.PRNGKey(2))
    ts = GPSession(device="cpu", **kw).fit(X, y, key=prng.PRNGKey(2))
    assert ts.history == js.history
    text = ts.best_expression()
    assert text == js.best_expression() and "∅" not in text
    np.testing.assert_array_equal(ts.predict(X), np.asarray(js.predict(X)))
    assert ts.score(X, y) == pytest.approx(js.score(X, y), rel=1e-6)
    assert (ts.stats["unique_subtrees"] > 0) == (dedup == "exact")
    rows = np.asarray(ts.counter_history)  # one row per generation, summing to stats
    assert rows.shape == (len(ts.history), 7)
    assert rows[:, -1].sum() == ts.stats["unique_subtrees"]
    assert rows[:, -2].sum() == ts.stats["subtree_evals_saved"]
