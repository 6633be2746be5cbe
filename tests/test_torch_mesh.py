"""The port's mesh (`repro_torch.launch.mesh`, the engine's sharded step
and block, the data-axis moment merge, sharded migration, the mesh
stream fold, elastic resharding, `topology=` and `--mesh`) against the
reference's `shard_map` runs.

The reference needs 8 host devices, which XLA takes only before JAX
starts, so one subprocess (`_REFERENCE`, under
`XLA_FLAGS=--xla_force_host_platform_device_count=8`) runs every
reference scenario and writes an npz; a module fixture runs it once per
test run (a file lock shares it between test workers). The port runs
in-process on the CPU: its mesh needs no flags
(`make_host_mesh(..., device="cpu")` puts every shard on the CPU).

Trajectories are held bit for bit on integer-lattice data (add/sub/mul
trees, kernel r: every sum is exact, so the shard order of a sum does
not matter), pearson on the dyadic lattice of `test_torch_two_pass.py`;
one real-data case is held at rtol 1e-5 (ROADMAP C4)."""
import fcntl
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.ckpt import checkpoint as tckpt
from repro_torch.ckpt.elastic import gp_state_specs, reshard_gp_state
from repro_torch.core import engine as tengine
from repro_torch.core import fitness as tfit
from repro_torch.core import prng
from repro_torch.core.engine import GPConfig
from repro_torch.core.evolve import OperatorMix
from repro_torch.core.fitness import FitnessSpec
from repro_torch.core.islands import IslandConfig
from repro_torch.core.primitives import FunctionSet
from repro_torch.core.trees import TreeSpec
from repro_torch.data.loader import pad_feature_major, shard_dataset
from repro_torch.gp import GPSession, MeshTopology
from repro_torch.launch import evolve as tevolve
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.mesh import P
from jax_release import release_jax_programs  # noqa: F401  (frees compiled programs)
from torch_mp import run_processes
from torch_mesh_data import (HOIST, LAT3, MERGE_KERNELS, MIXES, POD_TOPOLOGIES, RATES,
                             TOPOLOGIES, TOURN, dyadic, hoist_kernel, lattice, merge_inputs,
                             real)

torch.set_num_threads(2)

_REFERENCE = textwrap.dedent("""
    import os, sys, tempfile
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro import compat
    from repro.ckpt.checkpoint import restore, save
    from repro.ckpt.elastic import gp_state_specs, reshard_gp_state
    from repro.core import engine, fitness as jfit
    from repro.core import (FitnessSpec, GPConfig, OperatorMix, TreeSpec, init_state,
                            sharded_evolve_block, sharded_evolve_step)
    from repro.core.primitives import FunctionSet
    from repro.data.loader import pad_feature_major
    from repro.gp import GPSession, MeshTopology
    from repro.launch.mesh import make_host_mesh
    from torch_mesh_data import *  # noqa: F403

    out = {}

    def put_state(tag, st):
        for name, leaf in zip(st._fields, st):
            out[tag + "." + name] = np.asarray(leaf)

    def put_session(tag, s):
        put_state(tag, s.state)
        out[tag + ".history"] = np.asarray(s.history, np.float32)
        if s.island_history:
            out[tag + ".island"] = np.asarray(s.island_history, np.float32)
        out[tag + ".n_rows"] = np.asarray(s.n_rows)

    def on(mesh, X, y, w):
        return (jax.device_put(jnp.asarray(X), NamedSharding(mesh, P(None, "data"))),
                jax.device_put(jnp.asarray(y), NamedSharding(mesh, P("data"))),
                jax.device_put(jnp.asarray(w), NamedSharding(mesh, P("data"))))

    def spec(depth):
        return TreeSpec(max_depth=depth, n_features=2, p_const=0.0,
                        fn_set=FunctionSet.make(("add", "sub", "mul")))

    def scen_classic():
        # (a) the classic layout's step on (pod 2, data 2, model 2), 6 generations
        cfg = GPConfig(pop_size=64, tree_spec=spec(5), fitness=FitnessSpec("r"),
                       migrate_every=3)
        X, y = lattice(128, 1, -1, 2)
        mesh = make_host_mesh(data=2, model=2, pod=2)
        step, _ = sharded_evolve_step(cfg, mesh, pod_axis="pod")
        s = init_state(cfg, jax.random.PRNGKey(0))
        with compat.set_mesh(mesh):
            js = jax.jit(step)
            for g in range(6):
                s = js(s, *on(mesh, X.T.copy(), y, np.ones(128, np.float32)))
                put_state("a%d" % g, s)
            # the same step on real data: generation 0's fitness, rtol 1e-5
            Xr, yr = real()
            put_state("real", js(init_state(cfg, jax.random.PRNGKey(0)),
                                 *on(mesh, Xr, yr, np.ones(128, np.float32))))

    def pod_session(topo):
        # (p) (c)'s session on (pod 2, data 2, model 1), whose pods span
        # processes when 4 processes hold one shard each
        X, y = lattice(40, 4)
        hetero = dict(islands=4, island_mixes=tuple(OperatorMix(*m) for m in MIXES),
                      island_tourn_sizes=TOURN, island_point_rates=RATES)
        s = GPSession(backend="jnp", pop_size=16, generations=6, migrate_every=2,
                      migrate_k=1, island_topology=topo,
                      topology=MeshTopology(data=2, model=1, pod=2), **hetero, **LAT3)
        s.fit(X, y, key=jax.random.PRNGKey(5))
        put_session("p_" + topo, s)

    def scen_pods_ring():
        pod_session("ring")

    def scen_pods_broadcast():
        pod_session("broadcast-best")

    def scen_blocks():
        # (b) 8-step blocks on (data 4, model 2): a limit of 5, then
        # stop_fitness reached mid-block
        X, y = lattice(128, 1, -1, 2)
        data = (X.T.copy(), y, np.ones(128, np.float32))
        mesh = make_host_mesh(data=4, model=2)
        stop = None
        for mode in ("limit", "stop"):
            cfg = GPConfig(pop_size=32, tree_spec=spec(3), fitness=FitnessSpec("r"),
                           migrate_every=3, stop_fitness=stop)
            blk, _ = sharded_evolve_block(cfg, mesh, n_steps=8)
            with compat.set_mesh(mesh):
                st, h, c = jax.jit(blk)(init_state(cfg, jax.random.PRNGKey(1)),
                                        *on(mesh, *data),
                                        jnp.asarray(5 if stop is None else 8, jnp.int32))
            put_state("b_" + mode, st)
            out["b_%s.hist" % mode], out["b_%s.counters" % mode] = np.asarray(h), np.asarray(c)
            h = np.asarray(h)
            stop = float(h[int(np.argmax(h < h[0]))])  # the first improvement
        out["b_stop.bar"] = np.asarray(cfg.stop_fitness, np.float32)

    def island_session(topo):
        # (c) the island layout, 4 islands on (pod 2, data 2, model 2)
        X, y = lattice(40, 4)
        hetero = dict(islands=4, island_mixes=tuple(OperatorMix(*m) for m in MIXES),
                      island_tourn_sizes=TOURN, island_point_rates=RATES)
        s = GPSession(backend="jnp", pop_size=16, generations=6, migrate_every=2,
                      migrate_k=1, island_topology=topo,
                      topology=MeshTopology(data=2, model=2, pod=2), **hetero, **LAT3)
        s.fit(X, y, key=jax.random.PRNGKey(5))
        put_session("c_" + topo, s)
        return s, X, y

    def scen_torus():
        island_session("torus")

    def scen_broadcast():
        island_session("broadcast-best")

    def scen_ring():
        ring, X, y = island_session("ring")
        # (h) the ring run's state, checkpointed, resharded onto
        # (pod 4, data 2, model 1), then one step there
        cfg = ring._cfg
        host = jax.tree.map(np.asarray, jax.device_get(ring.state))
        with tempfile.TemporaryDirectory() as d:
            save(host, d, 1)
            back = restore(d, 1, like=host)
        mesh_b = make_host_mesh(data=2, model=1, pod=4)
        state_b = reshard_gp_state(back, cfg, mesh_b, pod_axis="pod")
        put_state("h_resharded", state_b)
        out["h.specs"] = np.asarray(repr([tuple(p) for p in
                                          gp_state_specs(cfg, mesh_b, pod_axis="pod")]))
        step, _ = engine.sharded_evolve_step(cfg, mesh_b, pod_axis="pod")
        with compat.set_mesh(mesh_b):
            put_state("h_step", jax.jit(step)(
                state_b, *on(mesh_b, *pad_feature_major(X.T.copy(), y, 2))))

    def scen_sessions():
        # (d) the session on (data 4, model 2): 126 rows padded, sample weights
        Xd, yd = lattice(126, 6)
        wd = np.random.RandomState(6).randint(0, 3, size=126).astype(np.float32)
        s = GPSession(backend="jnp", pop_size=16, generations=5,
                      topology=MeshTopology(data=4, model=2), **LAT3)
        s.ingest(Xd, yd, sample_weight=wd)
        s.init(key=jax.random.PRNGKey(7))
        s.evolve()
        put_session("d", s)
        # (f) postfix with dedup exact on (data 2, model 2)
        X, y = lattice(40, 4)
        s = GPSession(backend="jnp", pop_size=16, generations=5, genome="postfix",
                      dedup="exact", topology=MeshTopology(data=2, model=2), **LAT3)
        s.fit(X, y, key=jax.random.PRNGKey(8))
        put_session("f", s)

    def scen_folds():
        # (e) pearson on the dyadic lattice, (data 4, model 2)
        Xe, ye = dyadic(11)
        s = GPSession(backend="jnp", pop_size=16, generations=8, kernel="pearson",
                      max_depth=2, p_const=0.0, fn_set="add,sub",
                      topology=MeshTopology(data=4, model=2))
        s.fit(Xe, ye, key=jax.random.PRNGKey(4))
        put_session("e", s)
        # (g) a streamed session on (data 4, model 2): 126 rows in chunks of 30 -> 32
        Xd, yd = lattice(126, 6)
        s = GPSession(backend="jnp", pop_size=16, generations=3, chunk_rows=30,
                      topology=MeshTopology(data=4, model=2), **LAT3)
        s.fit(Xd, yd, key=jax.random.PRNGKey(9))
        put_session("g", s)
        # the data-axis merge's three lowerings on (data 4), one kernel each
        jfit.register_kernel(hoist_kernel(jnp, jfit.FitnessKernel))
        mesh4 = make_host_mesh(data=4, model=1)
        for name in MERGE_KERNELS:
            kern = jfit.get_kernel(name)
            fs = FitnessSpec(name)
            preds, y, w = merge_inputs(name)
            parts = np.stack([np.asarray(kern.moments(
                jnp.asarray(preds[:, 12 * i:12 * i + 12]), jnp.asarray(y[12 * i:12 * i + 12]),
                jnp.asarray(w[12 * i:12 * i + 12]), fs)) for i in range(4)])
            out["merge.%s.parts" % name] = parts

            def body(pm, yy, ww, kern=kern, fs=fs):
                return engine._merge_moments_on_mesh(kern, fs, pm[0], yy, ww, "data", 4)[None]

            f = compat.shard_map(body, mesh=mesh4, in_specs=(P("data"), P("data"), P("data")),
                                 out_specs=P("data"))
            with compat.set_mesh(mesh4):
                out["merge.%s.out" % name] = np.asarray(jax.jit(f)(parts, y, w))

    for name in sys.argv[2].split(","):
        globals()["scen_" + name]()
    np.savez(sys.argv[1], **out)
    print("REFERENCE_OK")
""")
# scenario groups, one subprocess each, run at once (40-50 s each alone)
_GROUPS = ("classic", "blocks,torus,pods_broadcast", "ring,broadcast,pods_ring",
           "sessions,folds")


def _start_reference(path):
    """Start the reference groups at once -> [(their npz, process)]."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([os.path.join(here, "..", "src"), here]),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return [(f"{path}.{i}.npz", subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, f"{path}.{i}.npz", group], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for i, group in enumerate(_GROUPS)]


def _finish_reference(path, procs):
    """Wait for the groups and write their merged npz to `path`."""
    merged = {}
    try:
        for part, proc in procs:
            stdout, stderr = proc.communicate(timeout=600)
            assert proc.returncode == 0 and "REFERENCE_OK" in stdout, stderr[-3000:]
            with np.load(part) as z:
                merged.update(z)
    finally:
        for _, proc in procs:
            proc.kill()
            proc.wait()
    np.savez(f"{path}.tmp.npz", **merged)
    os.replace(f"{path}.tmp.npz", path)


class _Reference:
    """The reference scenarios' npz, made once per test run. The first
    worker to take the lock file (in the run's common temporary root)
    starts the subprocesses when the module starts, so that the tests
    that need no reference run meanwhile, and releases the lock once the
    npz is written; other workers wait on the lock and read it."""

    def __init__(self, tmp_path_factory):
        uid = os.environ.get("PYTEST_XDIST_TESTRUNUID")
        root = tmp_path_factory.getbasetemp()
        self.path = (root.parent if uid else root) / f"torch_mesh_reference_{uid or 'solo'}.npz"
        self.lock = open(f"{self.path}.lock", "w")
        self.procs = None
        try:
            fcntl.flock(self.lock, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except BlockingIOError:
            return
        if self.path.exists():
            self.release()
        else:
            self.procs = _start_reference(str(self.path))

    def release(self):
        if self.lock is not None:
            self.lock.close()
            self.lock = None

    def load(self) -> dict:
        if self.procs is not None:
            procs, self.procs = self.procs, None
            try:
                _finish_reference(str(self.path), procs)
            finally:
                self.release()
        if self.lock is not None:  # another worker makes it: wait for its lock
            fcntl.flock(self.lock, fcntl.LOCK_EX)
            if not self.path.exists():
                _finish_reference(str(self.path), _start_reference(str(self.path)))
            self.release()
        with np.load(self.path) as z:
            return dict(z)


@pytest.fixture(scope="module", autouse=True)
def _reference(tmp_path_factory):
    r = _Reference(tmp_path_factory)
    yield r
    if r.procs is not None:  # no test here read it: finish it for the other workers
        r.load()
    r.release()


@pytest.fixture(scope="module")
def ref(_reference):
    return _reference.load()


def _assert_state(ref, tag, state, fields=tengine.GPState._fields):
    got = tengine.state_to_numpy(state)
    for name in fields:
        want = ref[f"{tag}.{name}"]
        assert got[name].dtype == want.dtype, (tag, name)
        np.testing.assert_array_equal(got[name], want, err_msg=f"{tag}: GPState.{name}")


def _assert_session(ref, tag, s):
    _assert_state(ref, tag, s.state)
    np.testing.assert_array_equal(np.asarray(s.history, np.float32), ref[f"{tag}.history"])
    if f"{tag}.island" in ref:
        np.testing.assert_array_equal(np.asarray(s.island_history, np.float32),
                                      ref[f"{tag}.island"])
    assert s.n_rows == int(ref[f"{tag}.n_rows"])


def _spec(depth):
    return TreeSpec(max_depth=depth, n_features=2, p_const=0.0,
                    fn_set=FunctionSet.make(("add", "sub", "mul")))


def _cfg_a(pop_size=64, **kw):
    kw.setdefault("tree_spec", _spec(5))
    return GPConfig(pop_size=pop_size, fitness=FitnessSpec("r"), migrate_every=3,
                    eval_impl="torch", **kw)


def _data_a():
    X, y = lattice(128, 1, -1, 2)
    return torch.from_numpy(X.T.copy()), torch.from_numpy(y), torch.ones(128)


def _hetero():
    return dict(islands=4, island_mixes=tuple(OperatorMix(*m) for m in MIXES),
                island_tourn_sizes=TOURN, island_point_rates=RATES)


def _mesh(**kw):
    return tmesh.make_host_mesh(device="cpu", **kw)


# --- the mesh itself -------------------------------------------------------------


def test_host_mesh_axes_and_placement():
    m = _mesh(data=2, model=2, pod=2)
    assert m.axis_names == ("pod", "data", "model") and m.size == 8
    assert m.shape == {"pod": 2, "data": 2, "model": 2} and m.home == torch.device("cpu")
    assert _mesh(data=4, model=2).axis_names == ("data", "model")
    assert tmesh.batch_axes(m) == ("pod", "data")
    assert tmesh.batch_axes(_mesh(data=4)) == ("data",)
    assert m.coords(5) == {"pod": 1, "data": 0, "model": 1}
    assert m.groups("data") == [[0, 2], [1, 3], [4, 6], [5, 7]]
    assert m.groups("model") == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert m.groups("pod") == [[0, 4], [1, 5], [2, 6], [3, 7]]
    assert m.groups(None) == [[s] for s in range(8)]
    # shard s on card s mod count; an indexed device pins every shard
    cards = tmesh.Mesh({"data": 2, "model": 2}, ["cuda:0", "cuda:1", "cuda:0", "cuda:1"])
    assert [d.index for d in cards.devices] == [0, 1, 0, 1]
    with pytest.raises(ValueError, match="shards"):
        tmesh.Mesh({"data": 2}, ["cpu"])
    with pytest.raises(ValueError, match="unknown mesh axis"):
        tmesh.Mesh({"rows": 2}, ["cpu", "cpu"])


def test_partition_spec_matches_jax_tuples():
    assert tuple(P(("pod", "model"))) == (("pod", "model"),)
    assert tuple(P(("model",))) == ("model",)
    assert tuple(P()) == () and tuple(P(None, "data")) == (None, "data")
    assert isinstance(P("data"), tuple) and repr(P("data")) == "PartitionSpec('data',)"


@pytest.mark.parametrize("spec", [P(), P(("pod", "model")), P(None, "data"),
                                  P("pod", "model", None), P("pod", None)])
def test_split_join_round_trip(spec):
    m = _mesh(data=2, model=2, pod=2)
    t = torch.arange(8 * 4 * 3).reshape(8, 4, 3)
    parts = m.split(t, spec)
    assert len(parts) == 8 and all(p.is_contiguous() for p in parts)
    assert torch.equal(m.join(parts, spec), t)
    if spec == P(("pod", "model")):  # rows split pod-major over (pod, model)
        assert torch.equal(parts[5], t[6:8])  # pod 1, model 1
        assert torch.equal(parts[2], parts[0])  # a data replica
    with pytest.raises(ValueError, match="does not split"):
        m.split(torch.zeros(3, 5), P("model", "data"))


def test_collectives_in_rank_order():
    a = [torch.tensor([1.0, 2.0]), torch.tensor([3.0, -1.0]), torch.tensor([0.5, 4.0])]
    for got in tmesh.psum(a):
        assert torch.equal(got, torch.tensor([4.5, 5.0]))
    assert all(torch.equal(g, torch.tensor([0.5, -1.0])) for g in tmesh.pmin(a))
    g = tmesh.all_gather(a)[1]
    assert g.shape == (3, 2) and torch.equal(g[2], a[2])
    assert torch.equal(tmesh.all_gather(a, tiled=True)[0], torch.cat(a))
    moved = tmesh.ppermute(a, [(0, 1), (1, 2)])
    assert torch.equal(moved[0], torch.zeros(2)) and torch.equal(moved[2], a[1])
    m = _mesh(data=2, model=2)
    sums = tmesh.over(m, "data", tmesh.psum, {s: torch.tensor(float(s)) for s in range(4)})
    assert {s: float(v) for s, v in sums.items()} == {0: 2.0, 1: 4.0, 2: 2.0, 3: 4.0}


def test_fold_in_takes_a_device_counter():
    key = prng.PRNGKey(7)
    keys = torch.stack([key, prng.PRNGKey(3)])
    for data in (0, 5, 2 ** 31 - 1, -3):
        t = torch.tensor(data, dtype=torch.int32)
        assert torch.equal(prng.fold_in(key, t), prng.fold_in(key, data))
        assert torch.equal(prng.fold_in(keys, t), prng.fold_in(keys, data))


def test_shard_dataset_pads_to_the_data_axis():
    m = _mesh(data=4, model=2)
    X, y = lattice(126, 6)
    Xs, ys, ws = shard_dataset(X, y, m)
    assert len(Xs) == 8 and Xs[0].shape == (2, 32) and ws[6].shape == (32,)
    assert float(sum(w.sum() for w in ws[::2])) == 126.0  # one replica a data rank
    assert torch.equal(ws[6][-2:], torch.zeros(2))
    Xf, yf, wf = pad_feature_major(X.T.copy(), y, 4)
    assert torch.equal(m.join(Xs, P(None, "data")), torch.from_numpy(Xf))


# --- what needs no reference (these run while the reference is computed) ---


def test_data_replicas_agree_after_every_step():
    """The data-axis replicas of each (pod, model) slice hold the same
    state after every step, in both layouts."""
    X, y, w = _data_a()
    for cfg in (_cfg_a(16), _cfg_a(16, island=IslandConfig(islands=2, migrate_every=2,
                                                           migrate_k=1))):
        m = _mesh(data=2, model=2, pod=2)
        step, specs, data_spec, y_spec, w_spec = tengine._pick_step_builder(cfg)(
            cfg, m, pod_axis="pod")
        states = tengine._split_state(m, tengine.init_state(cfg, prng.PRNGKey(2),
                                                            device="cpu"), specs)
        for _ in range(3):
            leads = step(states, m.split(X, data_spec), m.split(y, y_spec),
                         m.split(w, w_spec))
            states = tengine._replicate(m, "data", leads)
            for group in m.groups("data"):
                for s in group[1:]:
                    for a, b in zip(states[group[0]], states[s]):
                        assert torch.equal(a, b)
            assert not torch.equal(states[0].op, states[1].op)  # model ranks differ


def test_builders_refuse_like_reference():
    m = _mesh(data=2, model=2, pod=2)
    with pytest.raises(ValueError, match="pop_size 30 % population shards 4"):
        tengine.sharded_evolve_step(_cfg_a(30), m, pod_axis="pod")
    isl = dict(eval_impl="torch", pop_size=16)
    with pytest.raises(ValueError, match="islands 3 % pod axis 2"):
        tengine.sharded_evolve_step(GPConfig(island=IslandConfig(islands=3), **isl), m,
                                    pod_axis="pod")
    with pytest.raises(ValueError, match="per-island pop_size 15 % model axis 2"):
        tengine.sharded_evolve_step(GPConfig(island=IslandConfig(islands=2),
                                             **{**isl, "pop_size": 15}), m, pod_axis="pod")
    with pytest.raises(ValueError, match="migrate_k 9 exceeds"):
        tengine.sharded_evolve_block(GPConfig(island=IslandConfig(islands=2, migrate_k=9),
                                              **isl), m, n_steps=2, pod_axis="pod")
    tfit.register_kernel(tfit.FitnessKernel(
        name="whole_only", partial_fitness=lambda p, y, w, s: (p - y).abs().sum(-1),
        decomposable=False), overwrite=True)
    try:
        with pytest.raises(ValueError, match="defines no moment pass"):
            tengine.sharded_evolve_step(GPConfig(fitness=FitnessSpec("whole_only"), **isl),
                                        m, pod_axis="pod")
    finally:
        tfit._REGISTRY.pop("whole_only", None)


def test_session_topology_surface():
    """A port Mesh is a topology too; the scalar backend refuses one, as
    the reference's does; build_sharded_* need a mesh."""
    m = _mesh(data=2, model=2)
    s = GPSession(device="cpu", pop_size=8, topology=m)
    assert s.mesh is m and s._pod_axis() is None and s.device == m.home
    with pytest.raises(ValueError, match="does not support mesh topologies"):
        GPSession(device="cpu", backend="scalar", topology=MeshTopology(data=2))
    with pytest.raises(TypeError, match="MeshTopology"):
        GPSession(device="cpu", topology=object())
    with pytest.raises(ValueError, match="needs a topology"):
        GPSession(device="cpu").build_sharded_block(2)
    with pytest.raises(ValueError, match="pop_size 10 % population shards 4"):
        GPSession(device="cpu", pop_size=10, topology=MeshTopology(data=2, model=2, pod=2)
                  ).ingest(*lattice(16, 1))


def test_cli_mesh_runs(capsys):
    """`--mesh data=2,model=2,pod=2` parses to a MeshTopology and runs."""
    assert tevolve.parse_mesh("data=2,model=2,pod=2") == MeshTopology(2, 2, 2)
    assert tevolve.parse_mesh(None) is None
    tevolve.main(["--dataset", "kepler", "--device", "cpu", "--pop", "16", "--depth", "3",
                  "--generations", "2", "--mesh", "data=2,model=2,pod=2"])
    assert "[kepler] 2 generations" in capsys.readouterr().out


# --- the data-axis merge -----------------------------------------------------------


@pytest.fixture(scope="module")
def hoist():
    kern = tfit.register_kernel(hoist_kernel(torch, tfit.FitnessKernel), overwrite=True)
    yield kern
    tfit._REGISTRY.pop(HOIST, None)


@pytest.mark.parametrize("name", MERGE_KERNELS)
def test_merge_lowerings_match_reference(ref, hoist, name):
    """psum (r), the hoisted psum (a kernel registered on both sides with
    y columns and no combine) and the gathered in-order fold (pearson,
    r2) give the reference's merged moments on every shard, as lists and
    over a mesh's data groups."""
    kern = tfit.get_kernel(name)
    assert (kern.combine_moments is None, bool(kern.y_moment_idx)) == {
        "r": (True, False), "hoist": (True, True), "pearson": (False, True),
        "r2": (False, True)}[name]
    _, y, w = merge_inputs(name)
    parts = [torch.from_numpy(p) for p in ref[f"merge.{name}.parts"]]
    ys = [torch.from_numpy(y[12 * i:12 * i + 12]) for i in range(4)]
    ws = [torch.from_numpy(w[12 * i:12 * i + 12]) for i in range(4)]
    got = tengine._merge_moments_on_mesh(kern, FitnessSpec(name), parts, ys, ws)
    for i, g in enumerate(got):
        np.testing.assert_array_equal(g.numpy(), ref[f"merge.{name}.out"][i])
    # the step's form over a mesh's data groups: each shard's y moments made
    # where its y lives, the same merged moments on every shard
    over = tengine._merge_over(_mesh(data=4), kern, FitnessSpec(name), "data",
                               dict(enumerate(parts)), dict(enumerate(ys)),
                               dict(enumerate(ws)))
    assert all(torch.equal(over[s], got[0]) for s in range(4))


# --- the classic layout -------------------------------------------------------------


def test_classic_step_bitwise(ref):
    """(a) six steps on (pod 2, data 2, model 2): every leaf of every
    generation is the reference's."""
    cfg = _cfg_a()
    step, specs = tengine.sharded_evolve_step(cfg, _mesh(data=2, model=2, pod=2),
                                              pod_axis="pod")
    assert specs["state"].op == P(("pod", "model")) and specs["X"] == P(None, "data")
    s = tengine.init_state(cfg, prng.PRNGKey(0), device="cpu")
    X, y, w = _data_a()
    for g in range(6):
        s = step(s, X, y, w)
        _assert_state(ref, f"a{g}", s)
    assert int(s.generation) == 6


def test_one_breeding_a_lead_matches(ref, monkeypatch):
    """With one lead a device (the layout of one shard a card) every lead
    breeds alone; the trajectories are the batched breeding's, the
    reference's: (a)'s first three steps and (c)'s ring session."""
    monkeypatch.setattr(tengine, "_by_device", lambda mesh, leads: [[s] for s in leads])
    cfg = _cfg_a()
    step, _ = tengine.sharded_evolve_step(cfg, _mesh(data=2, model=2, pod=2),
                                          pod_axis="pod")
    s = tengine.init_state(cfg, prng.PRNGKey(0), device="cpu")
    for g in range(3):
        s = step(s, *_data_a())
        _assert_state(ref, f"a{g}", s)
    X, y = lattice(40, 4)
    sess = GPSession(device="cpu", pop_size=16, generations=6, migrate_every=2, migrate_k=1,
                     topology=MeshTopology(data=2, model=2, pod=2), **_hetero(), **LAT3)
    _assert_session(ref, "c_ring", sess.fit(X, y, key=prng.PRNGKey(5)))


def test_classic_step_on_real_data(ref):
    """(a)'s step on real-valued data: the first generation's fitness
    within 1e-5 of the reference's (its sums run in another order), +inf
    at the same trees."""
    X, y = real()
    step, _ = tengine.sharded_evolve_step(_cfg_a(), _mesh(data=2, model=2, pod=2),
                                          pod_axis="pod")
    s = step(tengine.init_state(_cfg_a(), prng.PRNGKey(0), device="cpu"),
             torch.from_numpy(X), torch.from_numpy(y), torch.ones(128))
    want = ref["real.fitness"]
    assert np.isfinite(want).all() and len(set(want.tolist())) > 16
    np.testing.assert_allclose(s.fitness.numpy(), want, rtol=1e-5)


@pytest.mark.parametrize("mode", ["limit", "stop"])
def test_block_freezes_like_reference(ref, mode):
    """(b) an 8-step block on (data 4, model 2) frozen mid-block by a
    limit of 5, or by stop_fitness: state, history and counter rows."""
    kw = {} if mode == "limit" else {"stop_fitness": float(ref["b_stop.bar"])}
    cfg = _cfg_a(32, tree_spec=_spec(3), **kw)
    block, specs = tengine.sharded_evolve_block(cfg, _mesh(data=4, model=2), n_steps=8)
    assert specs["history"] == P() and specs["limit"] == P()
    limit = torch.tensor(5 if mode == "limit" else 8, dtype=torch.int32)
    s, hist, counters = block(tengine.init_state(cfg, prng.PRNGKey(1), device="cpu"),
                              *_data_a(), limit)
    tag = f"b_{mode}"
    _assert_state(ref, tag, s)
    np.testing.assert_array_equal(hist.numpy(), ref[f"{tag}.hist"])
    np.testing.assert_array_equal(counters.numpy(), ref[f"{tag}.counters"])
    assert counters[:, 2].sum() > 0  # some steps froze


# --- the island layout and the session ---------------------------------------------


@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_island_mesh_session_bitwise(ref, topology):
    """(c) 4 heterogeneous islands on (pod 2, data 2, model 2), migrating
    every 2 generations: the session's state, history and per-island
    history are the reference's."""
    X, y = lattice(40, 4)
    s = GPSession(device="cpu", pop_size=16, generations=6, migrate_every=2, migrate_k=1,
                  island_topology=topology, topology=MeshTopology(data=2, model=2, pod=2),
                  **_hetero(), **LAT3)
    assert s.mesh.shape == {"pod": 2, "data": 2, "model": 2} and s._pod_axis() == "pod"
    s.fit(X, y, key=prng.PRNGKey(5))
    _assert_session(ref, f"c_{topology}", s)
    assert s.stats["host_syncs"] == 1
    rows = np.asarray(s.counter_history)
    np.testing.assert_array_equal(rows[:, 3], [(g % 2 == 1) * 4 for g in range(6)])
    assert not rows[:, :2].any()  # no cache columns on a mesh


@pytest.mark.parametrize("topology", POD_TOPOLOGIES)
def test_pods_on_one_model_rank(ref, topology):
    """(p) (c)'s session on (pod 2, data 2, model 1), the layout whose
    pods span processes in `test_mesh_over_gloo_processes`: state,
    history and per-island history are the reference's."""
    X, y = lattice(40, 4)
    s = GPSession(device="cpu", pop_size=16, generations=6, migrate_every=2, migrate_k=1,
                  island_topology=topology, topology=MeshTopology(data=2, model=1, pod=2),
                  **_hetero(), **LAT3)
    _assert_session(ref, f"p_{topology}", s.fit(X, y, key=prng.PRNGKey(5)))


def test_padded_session_with_sample_weight(ref):
    """(d) 126 rows on (data 4, model 2): padded to 128 with zero weight,
    the sample weights multiplied in; n_rows is 126."""
    X, y = lattice(126, 6)
    w = np.random.RandomState(6).randint(0, 3, size=126).astype(np.float32)
    s = GPSession(device="cpu", pop_size=16, generations=5,
                  topology=MeshTopology(data=4, model=2), **LAT3)
    s.ingest(X, y, sample_weight=w)
    assert s.n_rows == 126 and [t.shape for t in s._X[:2]] == [(2, 32)] * 2
    s.init(key=prng.PRNGKey(7))
    s.evolve()
    _assert_session(ref, "d", s)


def test_pearson_combine_fold_on_the_mesh(ref):
    """(e) pearson on (data 4, model 2) over the dyadic lattice: every
    shard's 4 points fold by the Chan combine in data-rank order."""
    X, y = dyadic(11)
    s = GPSession(device="cpu", pop_size=16, generations=8, kernel="pearson", max_depth=2,
                  p_const=0.0, fn_set="add,sub", topology=MeshTopology(data=4, model=2))
    s.fit(X, y, key=prng.PRNGKey(4))
    _assert_session(ref, "e", s)
    assert len(set(s.state.fitness.tolist())) > 3


def test_postfix_dedup_on_the_mesh(ref):
    """(f) postfix genomes on (data 2, model 2): dedup exact (each shard
    dedups its slice) is the reference's and dedup off's, bit for bit."""
    X, y = lattice(40, 4)
    runs = {}
    for dedup in ("exact", "off"):
        runs[dedup] = GPSession(device="cpu", pop_size=16, generations=5, genome="postfix",
                                dedup=dedup, topology=MeshTopology(data=2, model=2), **LAT3)
        runs[dedup].fit(X, y, key=prng.PRNGKey(8))
    _assert_session(ref, "f", runs["exact"])
    _assert_session(ref, "f", runs["off"])


def test_streamed_session_on_the_mesh(ref):
    """(g) 126 rows streamed in chunks of 30 (rounded up to 32, a
    multiple of data 4), each chunk split over the data axis and folded
    into the accumulator."""
    X, y = lattice(126, 6)
    s = GPSession(device="cpu", pop_size=16, generations=3, chunk_rows=30,
                  topology=MeshTopology(data=4, model=2), **LAT3)
    s.fit(X, y, key=prng.PRNGKey(9))
    assert s._stream.chunk_rows == 32 and s._stream_fold is not None
    _assert_session(ref, "g", s)
    with pytest.raises(ValueError, match="chunk fold"):
        s.evolve_block(1)


def test_reshard_onto_another_mesh(ref, tmp_path):
    """(h) (c)'s ring run, an islands=4 state of (pod 2, data 2, model 2),
    checkpointed and resharded onto (pod 4, data 2, model 1) bit for bit
    (from the port's checkpoint and from the reference's leaves), with
    the reference's specs; one step there equals the reference's."""
    X, y = lattice(40, 4)
    s = GPSession(device="cpu", pop_size=16, generations=6, migrate_every=2, migrate_k=1,
                  topology=MeshTopology(data=2, model=2, pod=2), **_hetero(), **LAT3)
    s.fit(X, y, key=prng.PRNGKey(5))
    tckpt.save(s.state, str(tmp_path), 1)
    back = tckpt.restore(str(tmp_path), 1, like=s.state)
    mesh_b = _mesh(data=2, model=1, pod=4)
    from_ref = {n: ref[f"c_ring.{n}"] for n in tengine.GPState._fields}
    for host in (back, from_ref):
        state_b = reshard_gp_state(host, s.config, mesh_b, pod_axis="pod")
        _assert_state(ref, "h_resharded", state_b)
        assert state_b.op.device == mesh_b.home
    specs = gp_state_specs(s.config, mesh_b, pod_axis="pod")
    assert repr([tuple(p) for p in specs]) == str(ref["h.specs"])
    step, _ = tengine.sharded_evolve_step(s.config, mesh_b, pod_axis="pod")
    Xf, yf, wf = pad_feature_major(X.T.copy(), y, 2)
    state_b2 = step(state_b, torch.from_numpy(Xf), torch.from_numpy(yf), torch.from_numpy(wf))
    _assert_state(ref, "h_step", state_b2)
    with pytest.raises(ValueError, match="islands 4 % pod axis 8"):
        reshard_gp_state(back, s.config, _mesh(pod=8), pod_axis="pod")



# --- over several processes ----------------------------------------------------------


def test_mesh_over_gloo_processes(ref, tmp_path):
    """The mesh over 4 gloo processes (`init_cluster(device="cpu")`;
    `torch_mp_worker.py`): two shards a process on (pod 2, data 2,
    model 2), one on (data 2, model 2) and on (pod 2, data 2, model 1),
    whose pod groups span processes, so that migration crosses them. On
    every process (a)'s classic steps, (c)'s island sessions (one host
    read a block), (p)'s sessions and (f)'s postfix sessions with dedup
    exact at caps 1,400 and 6,301 are the reference's bit for bit; (p)'s
    classic steps and the postfix history are the in-process single
    controller's; (c)'s ring state, saved from the processes (process 0
    writes), restores in one process bit for bit."""
    outs = run_processes(tmp_path, "gp")
    assert [o["local"].tolist() for o in outs] == [[0, 4], [1, 5], [2, 6], [3, 7]]
    pods = _mesh(data=2, model=1, pod=2)
    assert [o["pods_local"].tolist() for o in outs] == [[0], [1], [2], [3]]
    owner = [q for q, _ in tmesh.shard_owners(pods.size, 4)]
    assert [[owner[s] for s in g] for g in pods.groups("pod")] == [[0, 2], [1, 3]]
    X, y = lattice(40, 4)
    one = GPSession(device="cpu", pop_size=16, generations=5, genome="postfix",
                    dedup="exact", dedup_cap=6301, topology=MeshTopology(data=2, model=2),
                    **LAT3).fit(X, y, key=prng.PRNGKey(8))
    step, _ = tengine.sharded_evolve_step(_cfg_a(), pods, pod_axis="pod")
    s = tengine.init_state(_cfg_a(), prng.PRNGKey(0), device="cpu")
    classic = []
    for _ in range(6):
        s = step(s, *_data_a())
        classic.append(tengine.state_to_numpy(s))
    for r, o in enumerate(outs):
        for tag, want in [(f"a{g}", f"a{g}") for g in range(6)] + [
                (f"c_{t}", f"c_{t}") for t in TOPOLOGIES] + [
                (f"p_{t}", f"p_{t}") for t in POD_TOPOLOGIES] + [
                ("f1400", "f"), ("f6301", "f")]:
            for name in tengine.GPState._fields:
                np.testing.assert_array_equal(o[f"{tag}.{name}"], ref[f"{want}.{name}"],
                                              err_msg=f"process {r} {tag}: GPState.{name}")
            for k in ("history", "island"):
                if f"{want}.{k}" in ref and not tag.startswith("a"):
                    np.testing.assert_array_equal(o[f"{tag}.{k}"], ref[f"{want}.{k}"],
                                                  err_msg=f"process {r} {tag} {k}")
            if not tag.startswith("a"):
                assert int(o[f"{tag}.host_syncs"]) == 1, (r, tag)
        for g, want in enumerate(classic):
            for name, leaf in want.items():
                np.testing.assert_array_equal(o[f"p_classic{g}.{name}"], leaf,
                                              err_msg=f"process {r} p_classic{g}: {name}")
        np.testing.assert_array_equal(o["f6301.history"], np.asarray(one.history, np.float32))
    back = tckpt.restore(str(tmp_path / "ckpt_gp"), 1,
                         like=tengine.init_state(_cfg_a(), prng.PRNGKey(0), device="cpu"))
    _assert_state(ref, "c_ring", back)
