"""The port's sharding rules (`repro_torch.launch.sharding`), its
production mesh and collectives (`launch.mesh`) and the cluster env
(`launch.cluster`) against the reference, in-process on the CPU.

The reference's rules read only `mesh.axis_names` and
`mesh.devices.shape`, so a stub mesh over `np.empty(shape)` runs them on
the production meshes without 256 or 512 devices (its own check,
tests/test_sharding.py, is tier 2: a subprocess with 512 fake devices).
Shapes come from `jax.eval_shape` on the reference's side and from the
`meta` device on the port's: nothing is allocated, jamba's 398 B
included."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_arch_names
from repro.configs import get_config as jget_config
from repro.launch import cluster as JC
from repro.launch import sharding as JSH
from repro.launch.dryrun import make_policy
from repro.models import model as JMd
from repro.optim.adamw import for_config as jfor_config
from repro_torch.configs import get_config
from repro_torch.launch import cluster as TC
from repro_torch.launch import mesh as TM
from repro_torch.launch import sharding as SH
from repro_torch.models import model as Md
from repro_torch.optim.adamw import for_config
from torch_mp import run_processes
from jax_release import release_jax_programs  # noqa: F401  (frees compiled programs)

torch.set_num_threads(2)

MESHES = ({"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
          {"data": 2, "model": 2}, {"data": 4, "model": 1}, {"data": 1, "model": 2})


class _StubMesh:
    """What the reference's rules read of a mesh."""

    def __init__(self, shape):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)
        self.devices = np.empty(tuple(shape.values()))


def _port_mesh(shape):
    return TM.Mesh(shape, ["meta"] * math.prod(shape.values()))


def _flat_ref(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {tuple(getattr(k, "key", str(k)) for k in p): tuple(v) for p, v in leaves}


def _flat(tree, path=()):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, path + (k,)).items()}
    return {path: tuple(tree)}


def _assert_same(got, want, tag):
    g, w = _flat(got), _flat_ref(want)
    assert g.keys() == w.keys(), (tag, sorted(set(g) ^ set(w))[:5])
    bad = [(k, g[k], w[k]) for k in w if g[k] != w[k]]
    assert not bad, (tag, bad[:3])


@pytest.fixture(scope="module")
def reference_shapes():
    """{config: the reference's train-state shapes}, `jax.eval_shape`."""
    out = {}
    for name in all_arch_names():
        cfg = jget_config(name)
        opt = jfor_config(cfg)

        def init(key, cfg=cfg, opt=opt):
            p = JMd.init_params(cfg, key)
            return {"params": p, "opt": opt.init(p), "step": jnp.zeros((), jnp.int32)}

        out[name] = jax.eval_shape(init, jax.random.PRNGKey(0))
    return out


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s.values())))
def test_train_state_specs_match_reference(reference_shapes, shape):
    """param_specs and train_state_specs (AdamW's m/v; Adafactor's r/c
    for jamba) equal the reference's leaf for leaf, for all ten configs
    at full size; the port's shapes come from the meta device."""
    stub, mesh = _StubMesh(shape), _port_mesh(shape)
    for name in all_arch_names():
        jcfg = jget_config(name).with_policy(make_policy(stub))
        cfg = get_config(name).with_policy(SH.policy_for(mesh))
        assert dataclasses.astuple(cfg.policy) == dataclasses.astuple(jcfg.policy)
        shapes = SH.state_shapes(cfg, for_config(cfg))
        assert all(t.device.type == "meta" for t in SH._leaves(shapes))
        want = JSH.train_state_specs(jcfg, reference_shapes[name], stub)
        _assert_same(SH.train_state_specs(cfg, shapes, mesh), want, f"{name} {shape}")
        _assert_same(SH.param_specs(cfg, shapes["params"], mesh),
                     JSH.param_specs(jcfg, reference_shapes[name]["params"], stub),
                     f"{name} {shape} params")


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s.values())))
def test_batch_and_cache_specs_match_reference(shape):
    """batch_specs of the train cell's inputs and cache_specs of the
    decode cells' caches (seq_shard off and on) equal the reference's."""
    stub, mesh = _StubMesh(shape), _port_mesh(shape)
    for name in all_arch_names():
        jcfg = jget_config(name).with_policy(make_policy(stub))
        cfg = get_config(name).with_policy(SH.policy_for(mesh))
        _, jb = JMd.input_specs(jcfg, "train_4k")
        _, tb = Md.input_specs(cfg, "train_4k")
        _assert_same(SH.batch_specs(cfg, tb), JSH.batch_specs(jcfg, jb), f"{name} batch")
        for cell in ("decode_32k", "long_500k"):
            _, jd = JMd.input_specs(jcfg, cell)
            _, td = Md.input_specs(cfg, cell)
            for seq_shard in (False, True):
                _assert_same(SH.cache_specs(cfg, td["cache"], mesh, seq_shard=seq_shard),
                             JSH.cache_specs(jcfg, jd["cache"], stub, seq_shard=seq_shard),
                             f"{name} {cell} seq_shard={seq_shard}")


def test_every_spec_is_legal_on_the_production_meshes():
    """tests/test_sharding.py's check, on the port: every train-state and
    cache spec divides its leaf on (16, 16) and (2, 16, 16)."""
    for multi in (False, True):
        mesh = TM.make_production_mesh(multi_pod=multi, device="cpu")
        assert mesh.shape == ({"pod": 2, "data": 16, "model": 16} if multi else
                              {"data": 16, "model": 16})
        for name in all_arch_names():
            cfg = get_config(name).with_policy(SH.policy_for(mesh))
            shapes = SH.state_shapes(cfg, for_config(cfg))
            specs = SH.train_state_specs(cfg, shapes, mesh)
            for leaf, spec in zip(SH._leaves(shapes),
                                  SH._leaves(specs, is_leaf=lambda x: isinstance(x, TM.P))):
                mesh.check(leaf.shape, spec)
            for cell in ("decode_32k", "long_500k"):
                if not Md.shape_supported(cfg, cell):
                    continue
                _, sp = Md.input_specs(cfg, cell)
                cs = SH.cache_specs(cfg, sp["cache"], mesh,
                                    seq_shard=Md.SHAPES[cell]["batch"] == 1)
                for leaf, spec in zip(SH._leaves(sp["cache"]),
                                      SH._leaves(cs, is_leaf=lambda x: isinstance(x, TM.P))):
                    mesh.check(leaf.shape, spec)


def test_shard_bytes_reckon_the_parts():
    """shard_bytes from the specs equals the bytes of the parts `named`
    places, shard by shard; the parts add up to the whole state plus the
    blocks the specs replicate."""
    from repro_torch.configs import get_reduced

    mesh = TM.make_host_mesh(data=2, model=2, device="cpu")
    cfg = get_reduced("gemma-2b").with_policy(SH.policy_for(mesh))
    params = Md.init_params(cfg, 0, device="cpu")
    shapes = SH.ref_layout(params.tree())
    specs = SH.param_specs(cfg, shapes, mesh)
    placed = SH.ShardedLM.place(cfg, mesh, params, specs)
    got = [0] * mesh.size
    for sh in placed.leaves():
        for s, p in enumerate(sh.parts):
            got[s] += p.numel() * p.element_size()
    reckoned = SH.shard_bytes(specs, shapes, mesh)
    assert got == reckoned
    whole = sum(p.numel() * 4 for p in params.parameters())
    # a block held by k shards is k - 1 copies more than the state's
    extra = sum(sh.parts[0].numel() * 4 * (mesh.size - math.prod(
        mesh.axis_size(a) for part in sh.spec for a in TM._names(part)))
        for sh in placed.leaves())
    assert sum(reckoned) == whole + extra and extra > 0  # wk/wv (kv=1), the norms
    for sh, leaf in zip(placed.leaves(), (p for p in SH._leaves(params.tree()))):
        assert torch.equal(sh.join(), leaf)
        assert all(p.data_ptr() != q.data_ptr() for i, p in enumerate(sh.parts)
                   for q in sh.parts[i + 1:])


@pytest.mark.parametrize("name", ["gemma-2b", "whisper-medium"])
def test_build_draws_the_state_part_by_part(monkeypatch, name):
    """`launch.train.build` on a mesh draws the params part by part (the
    embeddings, each stack group, the norms; whisper's encoder stack too),
    each placed before the next is drawn, and ends with the parts of the
    whole seed-0 state, bit for bit."""
    from repro_torch.configs import get_reduced
    from repro_torch.launch import train as TL

    mesh = TM.make_host_mesh(data=2, model=2, device="cpu")
    cfg = get_reduced(name)
    calls, original = [], Md.init_params

    def spy(cfg, key=0, device=None, place=None):
        def traced(k, sub):
            calls.append(k)
            return place(k, sub)
        return original(cfg, key, device, traced if place else None)

    monkeypatch.setattr(Md, "init_params", spy)
    pcfg, state, _, _ = TL.build(cfg, mesh, device="cpu")
    whole = original(pcfg, 0, device="cpu").tree()
    placed = state["params"].tree()
    stacks = [k for k in whole if k.endswith("stack")]
    assert sorted(calls) == sorted([k for k in whole if k not in stacks] + [
        k for k in stacks for _ in whole[k]])

    def keys(tree):  # the tree's structure, keys in their order
        if isinstance(tree, dict):
            return [(k, keys(v)) for k, v in tree.items()]
        return [keys(v) for v in tree] if isinstance(tree, list) else None

    assert keys(placed) == keys(whole)  # the layout and key order of a placed LM
    for sh, leaf in zip(SH._leaves(placed), SH._leaves(whole)):
        assert torch.equal(sh.join(), leaf)


def test_gather_backward_adds_into_every_part():
    """`Sharded.gather`'s backward hands each part its block of the
    gradient, replicas included, and the gradients of two gathers add up
    in the parts (a reduce-scatter of their sum)."""
    mesh = TM.make_host_mesh(data=2, model=2, device="cpu")
    t = torch.arange(24.0).reshape(4, 6)
    for spec in (TM.P("data", "model"), TM.P(None, "model"), TM.P()):
        sh = TM.Sharded.place(mesh, t, spec)
        for p in sh.parts:
            p.requires_grad_(True)
        w1, w2 = torch.randn(4, 6), torch.randn(4, 6)
        ((sh.gather() * w1).sum() + (sh.gather() * w2).sum()).backward()
        for s, p in enumerate(sh.parts):
            assert torch.equal(p.grad, (w1 + w2)[sh.block(s)]), (spec, s)
        sh.assign(t * 2)
        assert torch.equal(sh.join(), t * 2)


def test_collectives():
    """all_to_all (tiled and not) and pmean as jax.lax's, in rank order."""
    parts = [torch.arange(24.0).reshape(4, 6) + 100 * r for r in range(4)]
    got = TM.all_to_all(parts, split_dim=0, concat_dim=1)
    for j in range(4):
        assert torch.equal(got[j], torch.cat([p[j:j + 1] for p in parts], 1))
    back = TM.all_to_all(got, split_dim=1, concat_dim=0)
    assert all(torch.equal(a, b) for a, b in zip(back, parts))
    untiled = TM.all_to_all(parts, split_dim=0, concat_dim=0, tiled=False)
    assert torch.equal(untiled[2], torch.stack([p[2] for p in parts]))
    with pytest.raises(ValueError, match="does not split"):
        TM.all_to_all(parts, split_dim=1, concat_dim=0)
    assert all(torch.equal(m, sum(parts) / 4) for m in TM.pmean(parts))


# --- the cluster env ------------------------------------------------------------------


ENVS = [
    {},
    {"COORDINATOR_ADDRESS": "10.0.0.1:1234", "NUM_PROCESSES": "4", "PROCESS_ID": "2"},
    {"COORDINATOR_ADDRESS": "10.0.0.1:1234"},
    {"SLURM_NTASKS": "8", "SLURM_PROCID": "3", "SLURM_STEP_NODELIST": "node[01-04],x"},
    {"SLURM_NTASKS": "2", "SLURM_NODELIST": "gpu-a,gpu-b"},
    {"SLURM_NTASKS": "2", "SLURM_PROCID": "1"},
    {"SLURM_NTASKS": "1", "SLURM_PROCID": "0"},
]


@pytest.mark.parametrize("env", ENVS, ids=range(len(ENVS)))
def test_cluster_env_matches_reference(env):
    got, want = TC.cluster_env(env), JC.cluster_env(env)
    assert (got.num_processes, got.process_id, got.coordinator, got.is_coordinator) == \
        (want.num_processes, want.process_id, want.coordinator, want.is_coordinator)
    for batch in (8, 12, 16, 7):
        try:
            want_slice = JC.host_batch_slice(batch, want)
        except ValueError as e:
            with pytest.raises(ValueError, match="% hosts"):
                TC.host_batch_slice(batch, got)
            assert "% hosts" in str(e)
            continue
        assert TC.host_batch_slice(batch, got) == want_slice


def test_init_cluster_is_single_process(tmp_path):
    """One process: the reference's no-op. Two processes given a
    coordinator join one gloo group (`init_cluster(device="cpu")`) and
    share a mesh's shards, each holding its own, and a psum across them
    adds in rank order; several with no coordinator raise a clear error."""
    info = TC.init_cluster(TC.ClusterInfo(1, 0, None))
    assert info == TC.ClusterInfo(1, 0, None) and info.is_coordinator
    assert TC.init_cluster() == TC.cluster_env()
    with pytest.raises(ValueError, match="need a coordinator address"):
        TC.init_cluster(TC.ClusterInfo(2, 0, None))
    outs = run_processes(tmp_path, "init", n=2)
    assert [(int(o["world"]), str(o["backend"]), o["local"].tolist()) for o in outs] == [
        (2, "gloo", [0, 2]), (2, "gloo", [1, 3])]
    assert [float(o["psum"]) for o in outs] == [1.0 + 3.0, 2.0 + 4.0]
    mesh = TC.cluster_mesh(device="cpu")
    assert mesh.shape == {"data": 16, "model": 16} and mesh.home == torch.device("cpu")
    assert TC.cluster_mesh(multi_pod=True, device="cpu").shape["pod"] == 2


# --- the process layout -----------------------------------------------------------------

OWNERS = {  # (processes, cards a process) -> (process, local card) of shards 0..7
    (1, 1): [(0, 0)] * 8,
    (1, 2): [(0, 0), (0, 1)] * 4,
    (2, 1): [(0, 0), (1, 0)] * 4,
    (2, 2): [(0, 0), (0, 1), (1, 0), (1, 1)] * 2,
    (4, 1): [(0, 0), (1, 0), (2, 0), (3, 0)] * 2,
    (4, 2): [(0, 0), (0, 1), (1, 0), (1, 1), (2, 0), (2, 1), (3, 0), (3, 1)],
}


def _as_process(monkeypatch, world, rank, made=None):
    """This process seen as `rank` of `world` (no process group is made:
    the subgroups the mesh asks for are recorded in `made`)."""
    made = [] if made is None else made
    monkeypatch.setattr(TM, "process_rank", lambda: (world, rank))
    monkeypatch.setattr(TM, "_subgroup", made.append)


@pytest.mark.parametrize("processes,cards", list(OWNERS))
def test_shard_owners_and_locality(monkeypatch, processes, cards):
    """`make_host_mesh`'s placement over processes: the cards numbered
    process-major, shard s on global card s mod the card count; each
    process holds (`is_local`, `local`) exactly its own shards, and its
    home is its first shard's card."""
    owners = TM.shard_owners(8, processes, cards)
    assert owners == OWNERS[processes, cards]
    for rank in range(processes):
        _as_process(monkeypatch, processes, rank)
        devices = [f"cuda:{c}" if q == rank else "meta" for q, c in owners]
        mesh = TM.Mesh({"pod": 2, "data": 2, "model": 2}, devices,
                       procs=[q for q, _ in owners])
        mine = [s for s in range(8) if owners[s][0] == rank]
        assert list(mesh.local) == mine and mesh.multi == (processes > 1)
        assert [mesh.is_local(s) for s in range(8)] == [s in mine for s in range(8)]
        assert mesh.home == torch.device("cuda", owners[mine[0]][1])
        if processes > 1:
            with pytest.raises(ValueError, match="holds none"):
                TM.Mesh({"data": 1}, ["meta"], procs=[(rank + 1) % processes])


def test_every_rank_builds_the_subgroups_in_one_order(monkeypatch):
    """`new_group` needs every process to call it, in one order: each rank
    of 4 asks for the same subgroups (sorted process tuples), in the same
    order, when it builds a mesh, on (pod 2, data 2, model 2) with two
    shards a process and on (data 2, model 2) with one."""
    for shape in ({"data": 2, "model": 2, "pod": 2}, {"data": 2, "model": 2}):
        made = []
        for rank in range(4):
            seen = []
            _as_process(monkeypatch, 4, rank, seen)
            TM.make_host_mesh(device="cpu", **shape)
            made.append(seen)
        assert all(m == made[0] for m in made) and made[0]
        assert all(list(p) == sorted(set(p)) and len(p) > 1 for p in made[0])


@pytest.mark.parametrize("B", [4, 3])
def test_sharded_cache_holds_a_process_parts(monkeypatch, B):
    """`ShardedCache.place` for each process of 4 on (data 2, model 2),
    reckoned on `meta` tensors from reduced granite's `cache_specs`: the
    process holds exactly its own shard's part (its data shard's rows,
    its model rank's kv heads; all rows, replicated, for the one-pass
    B 3), cut from its own passes only, and None for the others."""
    from repro_torch.configs import get_reduced

    cfg = get_reduced("granite-moe-3b-a800m")
    G, S, KV, hd = cfg.n_groups, 12, cfg.n_kv, cfg.d_head
    for rank in range(4):
        _as_process(monkeypatch, 4, rank)
        mesh = TM.Mesh({"data": 2, "model": 2}, ["meta"] * 4, procs=[0, 1, 2, 3])
        pcfg = cfg.with_policy(SH.policy_for(mesh))
        n = B // 2 if B % 2 == 0 else B
        d = mesh.batch_rank(rank, ("data",)) if n < B else 0
        one = {"b0": {k: torch.empty((G, n, S, KV, hd), device="meta") for k in "kv"}}
        shapes = {"b0": {k: torch.empty((G, B, S, KV, hd), device="meta") for k in "kv"}}
        specs = SH.cache_specs(pcfg, shapes, mesh, seq_shard=False)
        cache = SH.ShardedCache.place(mesh, specs, [(slice(d * n, (d + 1) * n), one)], B)
        for k in "kv":
            sh = cache["b0"][k]
            assert tuple(sh.spec) == ((None, "data", None, "model", None) if B == 4
                                      else (None,) * 5)
            assert [s for s in range(4) if sh.parts[s] is not None] == [rank]
            want = (G, B // 2, S, KV // 2, hd) if B == 4 else (G, B, S, KV, hd)
            assert tuple(sh.parts[rank].shape) == want
            assert tuple(sh.shape) == (G, B, S, KV, hd)


def test_prefill_cache_shapes_hold_no_cache():
    """`prefill` reads `cache_specs` off the whole batch's cache shapes:
    those stand-ins (`models.model._cache_shape`) have the global shape
    and its specs (here qwen1.5-32b's head-dim split on (data 16, model
    16)) but one element of storage, so a dry run's memory count does
    not take the whole batch's cache for a prefill's temp (it did: 640
    GiB of qwen1.5-32b prefill_32k's 721 GiB)."""
    mesh = TM.make_host_mesh(data=16, model=16, device="meta")
    cfg = get_config("qwen1.5-32b").with_policy(SH.policy_for(mesh))
    rank_k = torch.empty((64, 2, 32768, 40, 128), dtype=torch.float8_e4m3fn, device="meta")
    for a in (rank_k, TM.Blocks([rank_k[..., :8]] * 16, 4)):
        stand_in = Md._cache_shape(a, 32, mesh)
        assert tuple(stand_in.shape) == (64, 32, 32768, 40, 128)
        assert stand_in.untyped_storage().nbytes() == 1
        specs = SH.cache_specs(cfg, {"b0": {"k": stand_in}}, mesh, seq_shard=False)
        assert tuple(specs["b0"]["k"]) == (None, "data", None, None, "model")
