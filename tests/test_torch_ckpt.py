"""The port's checkpoints against the reference's: the same on-disk
layout (paths, dtypes, sha256 per leaf), bitwise save/restore of plain
and island-batched states, corruption and torn-write detection,
retention, a resumed session equal to an uninterrupted one, checkpoints
crossing between the two packages in both directions, the restart
policy (`runtime.fault`) with injected failures, and the evolve CLI's
resume line."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jck
from repro.gp import GPSession as JSession
from repro_torch.ckpt import checkpoint as tck
from repro_torch.core import engine as tengine
from repro_torch.core import prng
from repro_torch.gp import GPSession
from repro_torch.launch import evolve as tevolve
from repro_torch.runtime.fault import HeartbeatMonitor, StepMonitor, run_with_restarts

torch.set_num_threads(2)

LATTICE = dict(kernel="r", max_depth=3, p_const=0.0, fn_set="add,sub,mul")
ISLANDS = dict(islands=3, migrate_every=3, migrate_k=2, island_topology="ring")


def _lattice(rows=32, seed=7):
    rng = np.random.RandomState(seed)
    X = rng.randint(-2, 3, size=(rows, 2)).astype(np.float32)
    y = (X[:, 0] * X[:, 1] + X[:, 1]).astype(np.float32)
    return X, y


def _tree(seed=0):
    r = np.random.RandomState(seed)
    return {"a": torch.from_numpy(r.randn(4, 8).astype(np.float32)),
            "nested": {"b": torch.from_numpy(r.randint(0, 9, (3,)).astype(np.int32)),
                       "c": [torch.from_numpy(r.randn(2).astype(np.float32)),
                             np.arange(3, dtype=np.int64)]}}


def _state(islands):
    X, y = _lattice()
    s = GPSession(device="cpu", pop_size=8, generations=3, islands=islands,
                  **LATTICE).fit(X, y, key=prng.PRNGKey(1))
    return s.state


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("islands", [1, 3])
def test_state_round_trip_and_reference_layout(islands, tmp_path):
    """A GPState (classic and island-batched) saves and restores bit for
    bit, and its files are the reference's: the same paths, shapes,
    dtypes and digests as `repro.ckpt.checkpoint.save` of the same
    state, and the same leaves in each file."""
    state = _state(islands)
    p = tck.save(state, str(tmp_path / "t"), 3)
    back = tck.restore(str(tmp_path / "t"), 3, like=state)
    assert isinstance(back, tengine.GPState)
    for a, b in zip(state, back):
        assert a.dtype == b.dtype and torch.equal(a, b)
    jstate = jax.tree.map(jnp.asarray, tengine.GPState(**tengine.state_to_numpy(state)))
    jp = jck.save(jstate, str(tmp_path / "j"), 3)
    mine, theirs = _manifest(p), _manifest(jp)
    assert mine["paths"] == theirs["paths"] == [f".{n}" for n in tengine.GPState._fields]
    assert mine["treedef"] == theirs["treedef"]
    for a, b in zip(mine["leaves"], theirs["leaves"]):
        assert {k: a[k] for k in ("file", "shape", "dtype", "sha256")} == \
            {k: b[k] for k in ("file", "shape", "dtype", "sha256")}
    if islands > 1:
        assert mine["leaves"][0]["shape"] == [3, 2] and mine["leaves"][0]["dtype"] == "uint32"


def test_plain_tree_round_trip(tmp_path):
    """Nested dicts and lists of tensors and arrays: the reference's
    paths and treedef, and the leaves back in the structure of `like`
    (tensors as tensors)."""
    t = _tree()
    p = tck.save(t, str(tmp_path), 5)
    back = tck.restore(str(tmp_path), 5, like=t)
    assert torch.equal(back["a"], t["a"]) and torch.equal(back["nested"]["b"], t["nested"]["b"])
    assert torch.equal(back["nested"]["c"][0], t["nested"]["c"][0])
    np.testing.assert_array_equal(back["nested"]["c"][1], t["nested"]["c"][1])
    jt = jax.tree.map(lambda a: jnp.asarray(np.asarray(a)), t)
    jp = jck.save(jt, str(tmp_path / "j"), 5)
    assert _manifest(p)["paths"] == _manifest(jp)["paths"]
    assert _manifest(p)["treedef"] == _manifest(jp)["treedef"]
    leaves, manifest = tck.restore(str(tmp_path), 5)
    assert len(leaves) == 4 and manifest["step"] == 5


def test_corruption_detected(tmp_path):
    p = tck.save(_tree(), str(tmp_path), 1)
    victim = os.path.join(p, "000000.npy")
    arr = np.load(victim)
    arr.flat[0] += 1.0
    np.save(victim, arr)
    with pytest.raises(IOError, match="corruption"):
        tck.restore(str(tmp_path), 1, like=_tree())
    with pytest.raises(ValueError, match="leaves"):
        tck.restore(str(tmp_path), 1, like={"a": 1}, verify=False)


def test_latest_step_ignores_tmp(tmp_path):
    assert tck.latest_step(str(tmp_path / "none")) is None
    tck.save(_tree(), str(tmp_path), 5)
    os.makedirs(tmp_path / "step_00000009.tmp")  # a crashed save
    os.makedirs(tmp_path / "step_00000011")  # no manifest: not committed
    assert tck.latest_step(str(tmp_path)) == 5


def test_manager_async_retention(tmp_path):
    """Saves come due on the period, run on the IO thread and keep the
    newest `keep` checkpoints."""
    t = _tree()
    m = tck.CheckpointManager(str(tmp_path), keep=2, every=2)
    saved = [m.maybe_save(t, s) for s in range(0, 7)]
    m.wait()
    assert saved == [False, False, True, False, True, False, True]
    assert m.saved_steps == [2, 4, 6]
    assert sorted(os.listdir(tmp_path)) == ["step_00000004", "step_00000006"]
    back, step = m.restore_latest(like=t)
    assert step == 6 and torch.equal(back["a"], t["a"])
    assert m.maybe_save(t, 7, force=True)
    m.wait()
    assert tck.latest_step(str(tmp_path)) == 7


def test_resumed_island_session_equals_uninterrupted(tmp_path):
    """10 generations, a new session resuming from the checkpoint to 20,
    against 20 uninterrupted: the same state bit for bit."""
    X, y = _lattice()
    kw = dict(pop_size=12, checkpoint_every=5, **ISLANDS, **LATTICE)
    first = GPSession(device="cpu", checkpoint_dir=str(tmp_path), **kw)
    first.fit(X, y, generations=10, key=prng.PRNGKey(4))
    assert first._manager.saved_steps == [5, 10]
    resumed = GPSession(device="cpu", checkpoint_dir=str(tmp_path), **kw).ingest(X, y)
    resumed.init(key=prng.PRNGKey(99))  # the checkpoint wins over the key
    assert resumed.generation == 10
    resumed.evolve(10)
    whole = GPSession(device="cpu", **kw).fit(X, y, generations=20, key=prng.PRNGKey(4))
    for a, b in zip(resumed.state, whole.state):
        assert torch.equal(a, b)
    assert first.history + resumed.history == whole.history
    np.testing.assert_array_equal(np.asarray(first.island_history + resumed.island_history),
                                  np.asarray(whole.island_history))
    assert tck.latest_step(str(tmp_path)) == 20


def test_checkpoints_cross_between_packages(tmp_path):
    """A checkpoint the reference's session writes restores in the port,
    which then evolves as the reference does; one the port writes
    restores in the reference."""
    X, y = _lattice()
    kw = dict(pop_size=12, checkpoint_every=4, **ISLANDS, **LATTICE)
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    ref = JSession(backend="jnp", checkpoint_dir=jdir, **kw)
    ref.fit(X, y, generations=4, key=jax.random.PRNGKey(3))
    port = GPSession(device="cpu", checkpoint_dir=jdir, **kw).ingest(X, y)
    port.init()
    assert port.generation == 4
    restored = tengine.state_to_numpy(port.state)
    for name in tengine.GPState._fields:
        np.testing.assert_array_equal(restored[name], np.asarray(getattr(ref.state, name)))
    port.evolve(4)
    ref.evolve(4)
    assert port.history == ref.history[4:]
    np.testing.assert_array_equal(np.asarray(port.island_history),
                                  np.asarray(ref.island_history[4:]))
    # the other way round: the port writes, the reference restores
    writer = GPSession(device="cpu", checkpoint_dir=tdir, **kw)
    writer.fit(X, y, generations=4, key=prng.PRNGKey(3))
    like = jax.device_get(ref.state)
    back = jck.restore(tdir, 4, like=like)
    got = tengine.state_to_numpy(writer.state)
    for name in tengine.GPState._fields:
        np.testing.assert_array_equal(np.asarray(getattr(back, name)), got[name])


def test_run_with_restarts_resumes_from_checkpoint(tmp_path):
    """Injected failures at steps 7 and 13: the run completes with the
    state of a failure-free run, restored each time from the newest
    committed checkpoint."""
    fails = {7: True, 13: True}

    def step(state, i):
        if fails.pop(i, False):
            raise RuntimeError(f"injected node failure at {i}")
        return {"x": state["x"] + 1.0}

    mgr = tck.CheckpointManager(str(tmp_path), keep=3, every=5)
    state, restarts = run_with_restarts(lambda: {"x": torch.zeros(())}, step, 20, mgr,
                                        max_restarts=5)
    assert restarts == 2 and float(state["x"]) == 20.0
    with pytest.raises(RuntimeError, match="always down"):
        def down(state, i):
            raise RuntimeError("always down")

        run_with_restarts(lambda: {"x": torch.zeros(())}, down, 5,
                          tck.CheckpointManager(str(tmp_path / "b"), every=100),
                          max_restarts=2)


def test_monitors():
    mon = StepMonitor(threshold=3.0)
    for _ in range(3):
        with mon:
            pass
    assert mon.step == 3 and mon.stragglers == []
    hb = HeartbeatMonitor(deadline_s=0.0)
    hb.beat("w0")
    assert hb.dead_workers() == ["w0"]
    hb.remove("w0")
    assert hb.dead_workers() == []


def test_cli_resume_line(tmp_path, capsys):
    """`python -m repro_torch.launch.evolve` with --ckpt-dir: the second
    run resumes from the first's last generation and says so; the
    archive gets a record a block. `--mesh` still raises (A11) and
    `--chunk-rows` runs."""
    args = ["--dataset", "kat7", "--device", "cpu", "--pop", "8", "--depth", "3",
            "--islands", "2", "--migrate-every", "2", "--ckpt-dir", str(tmp_path / "ck"),
            "--ckpt-every", "2", "--archive", str(tmp_path / "arch"), "--archive-every", "2"]
    tevolve.main(args + ["--generations", "4"])
    out = capsys.readouterr().out
    assert "resumed" not in out and "[kat7] 4 generations" in out
    tevolve.main(args + ["--generations", "6"])
    out = capsys.readouterr().out
    assert "resumed from generation 4" in out
    assert sorted(os.listdir(tmp_path / "arch")) == [
        "gen_0001.json", "gen_0003.json", "gen_0005.json"]
    with pytest.raises(NotImplementedError, match="A11"):
        tevolve.main(args + ["--generations", "1", "--mesh", "data=2"])
    # --chunk-rows streams the dataset: kepler's 9 rows in 4-row chunks
    tevolve.main(["--dataset", "kepler", "--device", "cpu", "--pop", "8", "--depth", "3",
                  "--generations", "2", "--chunk-rows", "4"])
    assert "[kepler] 2 generations" in capsys.readouterr().out
