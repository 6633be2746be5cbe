"""The reference's sharded LM runs for `test_torch_lm_mesh.py` and
`test_torch_dryrun.py`, on 8 fake XLA host devices: `python
tests/torch_lm_mesh_ref.py OUT.npz GROUP` (GROUP one of `GROUPS`) writes
the group's inputs and results to an npz; `Reference` runs every group
once per test run and shares the merged npz between test workers. XLA
takes the device count only before JAX starts, so the runs go in
processes of their own; importing this module (the tests do, for the
shapes) starts nothing and imports no JAX."""
import dataclasses
import fcntl
import os
import subprocess
import sys
import tempfile

import numpy as np

F32 = dict(compute_dtype="float32", cache_dtype="float32")
# the sharded train steps: (config, replace) on (data 2, model 2), B x S
TRAIN = {"gemma-2b": {}, "granite-moe-3b-a800m": {"moe_capacity_factor": 1.0,
                                                  "accum_steps": 2},
         "mamba2-370m": {}, "jamba-1.5-large-398b": {}}
TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 32, 2
# tests/test_moe_sharded.py's shapes (S 8: no shard drops at capacity
# factor 1.0, capacity's floor of 8 holds them all) and S 64, where
# shards drop
MOE = dict(d=16, ff=32, B=4, S=(8, 64), top_k=2)
CP = dict(d_model=32, n_heads=4, n_kv=2, d_head=8, B=2, S=64, cur_lens=(0, 7, 13, 40, 63))
GROUPS = {"moe,cp,elastic": ("moe", "cp", "elastic"),
          "gemma,mamba2": ("gemma-2b", "mamba2-370m"),
          "granite": ("granite-moe-3b-a800m",), "jamba": ("jamba-1.5-large-398b",),
          "dryrun": ("dryrun",)}

out = {}


def put_tree(tag, tree):
    import jax

    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[tag + jax.tree_util.keystr(path)] = np.asarray(leaf)


def scen_moe():
    """moe_apply_sharded on (data 2, model 4), 8 experts and 5 padded to
    8, at capacity factors 8 and 1; each shard's kept entries (the sorted
    order) recorded from inside its shard_map body."""
    import jax
    import jax.numpy as jnp

    from repro import compat
    from repro.launch.mesh import make_host_mesh
    from repro.models import moe as M
    from repro.models.transformer import ShardingPolicy

    mesh = make_host_mesh(data=2, model=4)
    pol = ShardingPolicy(batch=("data",), model="model", tp_size=4, dp_size=2)
    rng = np.random.RandomState(0)
    xs = {S: rng.randn(MOE["B"], S, MOE["d"]).astype(np.float32) * 0.5 for S in MOE["S"]}
    for S, x in xs.items():
        out[f"moe.S{S}.x"] = x
    original = M._dispatch_combine
    record = {}

    def recording(xt, logits, top_k, C, E, ffn):
        # the reference's keep mask, as its _dispatch_combine computes it
        probs = jax.nn.softmax(logits, axis=-1)
        _, gate_e = jax.lax.top_k(probs, top_k)
        flat_e = gate_e.reshape(-1)
        order = jnp.argsort(flat_e, stable=True)
        counts = jnp.zeros((E,), jnp.int32).at[flat_e].add(1)
        starts = jnp.cumsum(counts) - counts
        pos = jnp.arange(flat_e.shape[0], dtype=jnp.int32) - starts[flat_e[order]]
        jax.debug.callback(lambda i, m, k: record.__setitem__((int(i), int(m)), np.asarray(k)),
                           jax.lax.axis_index("data"), jax.lax.axis_index("model"), pos < C)
        return original(xt, logits, top_k, C, E, ffn)

    for E, seed in ((8, 0), (5, 1)):
        p = M.moe_init(jax.random.PRNGKey(seed), MOE["d"], MOE["ff"], E)
        put_tree(f"moe.E{E}.p", p)
        for S, cf in ((S, cf) for S in MOE["S"] for cf in (8.0, 1.0)):
            tag, x = f"moe.E{E}.S{S}.cf{cf:g}", xs[S]
            record.clear()
            M._dispatch_combine = recording
            try:
                with compat.set_mesh(mesh):
                    y, aux = jax.jit(lambda p, x: M.moe_apply_sharded(
                        p, x, top_k=MOE["top_k"], capacity_factor=cf, policy=pol))(p, x)
                    jax.block_until_ready(y)
                jax.effects_barrier()
            finally:
                M._dispatch_combine = original
            out[tag + ".y"], out[tag + ".aux"] = np.asarray(y), np.asarray(aux)
            for (i, m), keep in record.items():
                out[f"{tag}.keep.{i}.{m}"] = keep


def scen_cp():
    """cp_decode_attention on data 8 at tests/test_serving.py's shapes,
    the cache rolled forward through its cur_lens."""
    import jax
    import jax.numpy as jnp

    from repro import compat
    from repro.launch.mesh import make_host_mesh
    from repro.launch.serving import cp_decode_attention
    from repro.models.layers import AttnDims, attn_init

    mesh = make_host_mesh(data=8, model=1)
    dims = AttnDims(d_model=CP["d_model"], n_heads=CP["n_heads"], n_kv=CP["n_kv"],
                    d_head=CP["d_head"])
    p = attn_init(jax.random.PRNGKey(0), dims)
    put_tree("cp.p", p)
    rng = np.random.RandomState(0)
    shape = (CP["B"], CP["S"], CP["n_kv"], CP["d_head"])
    ck = rng.randn(*shape).astype(np.float32) * 0.3
    cv = rng.randn(*shape).astype(np.float32) * 0.3
    out["cp.ck"], out["cp.cv"] = ck, cv
    for cur_len in CP["cur_lens"]:
        x = rng.randn(CP["B"], 1, CP["d_model"]).astype(np.float32) * 0.3
        with compat.set_mesh(mesh):
            o, ck, cv = jax.jit(lambda p, x, ck, cv, n: cp_decode_attention(
                p, x, ck, cv, n, dims, mesh, seq_axis="data"))(
                p, x, ck, cv, jnp.asarray(cur_len, jnp.int32))
        out[f"cp.{cur_len}.x"] = x
        out[f"cp.{cur_len}.o"], out[f"cp.{cur_len}.k"], out[f"cp.{cur_len}.v"] = (
            np.asarray(o), np.asarray(ck), np.asarray(cv))


def _shard_shapes(tag, tree):
    import jax

    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[tag + jax.tree_util.keystr(path)] = np.asarray(
            leaf.addressable_shards[0].data.shape, np.int64)


def scen_elastic():
    """Reduced gemma's state built on (data 2, model 2), checkpointed,
    restored onto (4, 1) and (1, 2) (reshard_state), then one step each."""
    import jax
    import jax.numpy as jnp

    from repro import compat
    from repro.ckpt.checkpoint import restore, save
    from repro.ckpt.elastic import reshard_state
    from repro.configs import get_reduced
    from repro.launch import sharding as SH
    from repro.launch.mesh import batch_axes, make_host_mesh
    from repro.launch.train import build
    from repro.models import model as Md
    from repro.models.transformer import ShardingPolicy
    from repro.optim.adamw import for_config

    cfg = dataclasses.replace(get_reduced("gemma-2b"), **F32)
    _, state, _, _ = build(cfg, make_host_mesh(data=2, model=2))
    host_like = jax.device_get(state)
    put_tree("elastic.state", host_like)
    toks = np.random.RandomState(1).randint(0, cfg.vocab, (4, 17)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:], "mask": np.ones((4, 16), np.float32)}
    for k, v in batch.items():
        out["elastic.batch." + k] = v
    with tempfile.TemporaryDirectory() as d:
        save(state, d, 1)
        host = restore(d, 1, like=host_like)
        for data, model in ((4, 1), (1, 2)):
            mesh = make_host_mesh(data=data, model=model)
            cfg_b = cfg.with_policy(ShardingPolicy(batch=batch_axes(mesh), tp_size=model,
                                                   dp_size=data))
            state_b = reshard_state(host, cfg_b, mesh)
            tag = f"elastic.{data}x{model}"
            put_tree(tag + ".state", jax.device_get(state_b))
            _shard_shapes(tag + ".shards", state_b)
            shapes = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), state_b)
            specs = SH.train_state_specs(cfg_b, shapes, mesh)
            step = jax.jit(Md.make_train_step(cfg_b, for_config(cfg_b),
                                              param_specs=specs["params"]))
            with compat.set_mesh(mesh):
                _, m = step(state_b, {k: jnp.asarray(v) for k, v in batch.items()})
            out[tag + ".loss"] = np.asarray(m["loss"])


def scen_train(name):
    """`launch.train.build` on (data 2, model 2) and two train steps of
    `lm_batches`: the initial state, each step's metrics, the final state
    and each leaf's shard shape."""
    import jax

    from repro import compat
    from repro.configs import get_reduced
    from repro.data.loader import lm_batches
    from repro.launch.mesh import make_host_mesh
    from repro.launch.train import build

    cfg = dataclasses.replace(get_reduced(name), **F32, **TRAIN[name])
    mesh = make_host_mesh(data=2, model=2)
    cfg, state, step, _ = build(cfg, mesh)
    put_tree(f"train.{name}.init", jax.device_get(state))
    _shard_shapes(f"train.{name}.shards", state)
    stream = lm_batches(cfg.vocab, TRAIN_B, TRAIN_S)
    with compat.set_mesh(mesh):
        for i, b in zip(range(TRAIN_STEPS), stream):
            for k, v in b.items():
                out[f"train.{name}.batch{i}.{k}"] = np.asarray(v)
            state, m = step(state, b)
            for k, v in m.items():
                out[f"train.{name}.step{i}.{k}"] = np.asarray(v)
    put_tree(f"train.{name}.final", jax.device_get(state))


def scen_dryrun():
    """Reduced gemma-2b's train cell (f32, B 4 x S 32) on (data 2, model 2)
    lowered and compiled as the reference's dry run lowers a cell
    (`launch/dryrun.lower_cell`: the state donated, the out_shardings
    pinned), the shape added to the reference's SHAPES in this process:
    XLA's memory_analysis (argument, output, alias, temp bytes) of a
    device."""
    import jax

    jax.devices()  # the backend keeps its 8 devices: dryrun's import asks for 512
    from repro.configs import get_reduced
    from repro.launch import dryrun as JD
    from repro.launch.mesh import make_host_mesh
    from repro.models import model as JMd

    JMd.SHAPES["train_b4_s32"] = dict(kind="train", seq=TRAIN_S, batch=TRAIN_B)
    cfg = dataclasses.replace(get_reduced("gemma-2b"), **F32, **TRAIN["gemma-2b"])
    mem = JD.lower_cell(cfg, "train_b4_s32",
                        make_host_mesh(data=2, model=2)).compile().memory_analysis()
    out["dryrun.gemma-2b.memory"] = np.asarray(
        [mem.argument_size_in_bytes, mem.output_size_in_bytes, mem.alias_size_in_bytes,
         mem.temp_size_in_bytes], np.int64)


def _start(path):
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([os.path.join(here, "..", "src"), here]),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return [(f"{path}.{i}.npz", subprocess.Popen(
        [sys.executable, os.path.join(here, "torch_lm_mesh_ref.py"), f"{path}.{i}.npz", group],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for i, group in enumerate(GROUPS)]


def _finish(path, procs):
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


class Reference:
    """The reference runs' npz, made once per test run: the first worker
    to take the lock file starts the subprocesses when the module starts
    and releases the lock once the npz is written; other workers wait on
    the lock and read it."""

    def __init__(self, tmp_path_factory):
        uid = os.environ.get("PYTEST_XDIST_TESTRUNUID")
        root = tmp_path_factory.getbasetemp()
        self.path = (root.parent if uid else root) / f"torch_lm_mesh_ref_{uid or 'solo'}.npz"
        self.lock = open(f"{self.path}.lock", "w")
        self.procs = None
        try:
            fcntl.flock(self.lock, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except BlockingIOError:
            return
        if self.path.exists():
            self.release()
        else:
            self.procs = _start(str(self.path))

    def release(self):
        if self.lock is not None:
            self.lock.close()
            self.lock = None

    def load(self) -> dict:
        if self.procs is not None:
            procs, self.procs = self.procs, None
            try:
                _finish(str(self.path), procs)
            finally:
                self.release()
        if self.lock is not None:
            fcntl.flock(self.lock, fcntl.LOCK_EX)
            if not self.path.exists():
                _finish(str(self.path), _start(str(self.path)))
            self.release()
        with np.load(self.path) as z:
            return dict(z)




if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    for scen in GROUPS[sys.argv[2]]:
        {"moe": scen_moe, "cp": scen_cp, "elastic": scen_elastic, "dryrun": scen_dryrun}.get(
            scen, lambda: scen_train(scen))()
    np.savez(sys.argv[1], **out)
    print("REFERENCE_OK")
