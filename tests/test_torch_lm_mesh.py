"""The port's LM mesh (`repro_torch.models.moe.moe_apply_sharded`,
`launch.serving.cp_decode_attention`, the sharded train step of
`launch.train.build`, `ckpt.elastic.reshard_state`) against the
reference's sharded runs, on the CPU.

The reference needs 8 host devices, which XLA takes only before JAX
starts, so `torch_lm_mesh_ref.py` runs its scenarios in subprocesses
(one a group, all at once, started when the module starts) and writes
npz files; a module fixture runs them once per test run (a file lock
shares them between test workers). The port runs in-process: its mesh
needs no flags (`make_host_mesh(..., device="cpu")`).

Tolerances, all f32: the MoE's output at rtol/atol 2e-5 and its aux at
1e-6, its kept entries equal; the context-parallel decode at 2e-5 (out)
and 1e-6 (cache), as tests/test_serving.py holds the reference; train
steps at rtol 1e-4 / atol 1e-5 (jamba's and mamba2's params at atol
1e-4, ROADMAP C 22 and 25), the sum orders of the data shards' losses, gradients and norms
being the port's own (ROADMAP C 25); resharding bit for bit. Tensor
parallelism (the model ranks' partial sums in rank order, ROADMAP C 27):
each layer against one device at 1e-5, the embedding bitwise, serving
against the reference's sharded serving at 1e-4. Sequence parallelism
(Megatron-SP): `sum_scatter` and `gather_fanout` bitwise their plain
counterparts, each block kind against one device at 1e-5 with the same
tolerance, the long-context decode (batch 1, the cache's sequence over
the data axis) against the reference's at 1e-4."""
import dataclasses
import functools
import importlib

import jax
import numpy as np
import pytest
import torch

from repro_torch.ckpt.elastic import reshard_state
from repro_torch.configs import get_reduced
from repro_torch.launch import mesh as TM
from repro_torch.launch import sharding as SH
from repro_torch.launch import train as TL
from repro_torch.launch.serving import cp_decode_attention
from repro_torch.models import convert
from repro_torch.models import layers as L
from repro_torch.models import model as Md
from repro_torch.models import moe as M
from repro_torch.models.transformer import ShardingPolicy
from jax_release import release_jax_programs  # noqa: F401  (frees compiled programs)
from torch_lm_mesh_ref import CP, F32, LONG, MOE, SERVE, TRAIN, TRAIN_STEPS, Reference
from torch_dryrun_child import fixtures, moved_as_dry
from torch_mp import run_processes

TA = importlib.import_module("repro_torch.optim.adamw")

torch.set_num_threads(2)

RTOL, ATOL = 1e-4, 1e-5
# the first AdamW step is ill-conditioned where a gradient is near 0 (u = g /
# (|g| + 1e-8), ROADMAP C 22): mamba2's in_proj[0, 52, 197] has a step-1
# gradient of 3.6e-8 and ends 2.13e-5 from the reference's (ROADMAP C 25);
# jamba's 8 layers of SSD and MoE at capacity factor 1.0 as in C 22
PARAM_ATOL = {"jamba-1.5-large-398b": 1e-4, "mamba2-370m": 1e-4}


@pytest.fixture(scope="module", autouse=True)
def _reference(tmp_path_factory):
    r = Reference(tmp_path_factory)
    yield r
    if r.procs is not None:  # no test here read it: finish it for the other workers
        r.load()
    r.release()


@pytest.fixture(scope="module")
def ref(_reference):
    return _reference.load()


def _tree(ref, prefix):
    """The npz entries under `prefix` (keystr paths) as a nested dict."""
    out = {}
    for k, v in ref.items():
        if not k.startswith(prefix + "["):
            continue
        node, keys = out, [p.strip("'") for p in k[len(prefix) + 1:-1].split("][")]
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = v
    return out


def _t(a):
    return torch.from_numpy(np.array(a))


def _flat(tree, path=()):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, path + (k,)).items()}
    return {path: tree}


def _close(got, want, tag, rtol, atol):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys(), (tag, set(g) ^ set(w))
    for k in w:
        np.testing.assert_allclose(np.asarray(g[k], np.float32), np.asarray(w[k], np.float32),
                                   rtol=rtol, atol=atol, err_msg=f"{tag} {k}")


# --- moe_apply_sharded --------------------------------------------------------------


def _record_routes():
    routes, original = [], M._route

    def wrapped(logits, top_k, C, E):
        out = original(logits, top_k, C, E)
        routes.append(out)
        return out

    M._route = wrapped
    return routes, lambda: setattr(M, "_route", original)


def _kept(routes, top_k, T_loc):
    """Each route's kept entries per (local token, slot), unsorted."""
    out = []
    for *_, order, keep, _ in routes:
        flat = torch.empty_like(keep)
        flat[order] = keep
        out.append(flat.reshape(T_loc, top_k))
    return out


@pytest.mark.parametrize("E", [8, 5])
@pytest.mark.parametrize("S", MOE["S"])
@pytest.mark.parametrize("cf", [8.0, 1.0])
def test_moe_apply_sharded_matches_reference(ref, E, S, cf):
    """On (data 2, model 4), 8 experts and 5 padded to 8: the output at
    2e-5, aux at 1e-6, and every shard's kept entries equal to the
    reference's shard's. At capacity factor 1.0 and S 64 the shards drop,
    and the tokens they keep differ from the unsharded `moe_apply`'s."""
    pol = ShardingPolicy(batch=("data",), model="model", tp_size=4, dp_size=2)
    p = {k: _t(v) for k, v in _tree(ref, f"moe.E{E}.p").items()}
    x = _t(ref[f"moe.S{S}.x"])
    tag = f"moe.E{E}.S{S}.cf{cf:g}"
    routes, restore = _record_routes()
    try:
        y, aux = M.moe_apply_sharded(p, x, top_k=MOE["top_k"], capacity_factor=cf, policy=pol)
        sharded = list(routes)
        routes.clear()
        M.moe_apply(p, x, top_k=MOE["top_k"], capacity_factor=cf)
        whole = list(routes)
    finally:
        restore()
    np.testing.assert_allclose(y.numpy(), ref[tag + ".y"], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(aux.numpy(), ref[tag + ".aux"], rtol=1e-6, atol=1e-6)
    assert len(sharded) == 8  # the shards in order (data, model)
    for n, route in enumerate(sharded):
        assert torch.equal(route[4], _t(ref[f"{tag}.keep.{n // 4}.{n % 4}"])), n
    B, tp, k = MOE["B"], 4, MOE["top_k"]
    T_loc = B * S // 8
    per_shard = _kept(sharded, k, T_loc)
    glob = torch.empty((B, S, k), dtype=torch.bool)
    for n, kept in enumerate(per_shard):
        i, m = divmod(n, tp)
        glob[i * B // 2:(i + 1) * B // 2, m * S // tp:(m + 1) * S // tp] = \
            kept.reshape(B // 2, S // tp, k)
    unsharded = _kept(whole, k, B * S)[0].reshape(B, S, k)
    drops = int((~glob).sum())
    if cf == 1.0 and S == 64:
        assert drops > 0 and not torch.equal(glob, unsharded)
    if cf == 8.0:
        assert drops == 0 and bool(unsharded.all())


def test_moe_apply_sharded_gradients_flow():
    """Gradients through the dispatch, the all_to_alls and the remat'd
    expert FFN reach the router and every expert (tests/test_moe_sharded.py's
    finiteness check), and the padded experts get none."""
    pol = ShardingPolicy(batch=("data",), model="model", tp_size=4, dp_size=2)
    g = torch.Generator().manual_seed(0)
    p = {k: v.requires_grad_(True) for k, v in M.moe_init(g, 16, 32, 5).items()}
    x = torch.randn(4, 8, 16, generator=g, requires_grad=True)
    y, aux = M.moe_apply_sharded(p, x, top_k=2, policy=pol)
    (y.float().sum() + aux).backward()
    for name, t in [*p.items(), ("x", x)]:
        assert t.grad is not None and torch.isfinite(t.grad).all(), name
    assert p["router"].grad.abs().sum() > 0


def test_router_gradient_adds_the_model_ranks_in_order(monkeypatch):
    """The single controller's router gradient where the sequence splits
    over the model axis (tp 4, S 8) is its model ranks' partials (each
    rank's tokens through its own view of the router) added in rank
    order, bit for bit as the processes add them; at capacity factor 8
    (no drops) it is the unsharded `moe_apply`'s within the train steps'
    tolerance (through the output: the shards' aux is the mean of their
    own)."""
    pol = ShardingPolicy(batch=("data",), model="model", tp_size=4, dp_size=1)
    g = torch.Generator().manual_seed(1)
    p = {k: v.requires_grad_(True) for k, v in M.moe_init(g, 16, 32, 8).items()}
    x = torch.randn(2, 8, 16, generator=g)
    w = torch.randn(2, 8, 16, generator=g)
    views, fanout = [], TM.AxisGroup.fanout

    def keeping(self, t):
        out = fanout(self, t)
        for v in out:
            v.retain_grad()
        views.extend(out)
        return out

    monkeypatch.setattr(TM.AxisGroup, "fanout", keeping)
    y, aux = M.moe_apply_sharded(p, x, top_k=2, capacity_factor=8.0, policy=pol)
    ((y * w).sum() + aux).backward()
    assert len(views) == 4 and all(v.grad is not None for v in views)
    total = views[0].grad
    for v in views[1:]:
        total = total + v.grad
    assert torch.equal(p["router"].grad, total)
    grads = []  # through the output alone (the shards' aux is their mean, not moe_apply's)
    for fn in (functools.partial(M.moe_apply_sharded, policy=pol), M.moe_apply):
        q = {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
        (fn(q, x, top_k=2, capacity_factor=8.0)[0] * w).sum().backward()
        grads.append(q["router"].grad)
    torch.testing.assert_close(grads[0], grads[1], rtol=RTOL, atol=ATOL)


# --- context-parallel decode --------------------------------------------------------


@pytest.mark.parametrize("tensor_pos", [False, True])
def test_cp_decode_matches_reference(ref, tensor_pos):
    """tests/test_serving.py's case on data 8: each cur_len's output at
    2e-5 and the cache (rolled forward) at 1e-6 of the reference's
    `cp_decode_attention`, and of the port's own `attn_decode`."""
    mesh = TM.make_host_mesh(data=8, model=1, device="cpu")
    dims = L.AttnDims(d_model=CP["d_model"], n_heads=CP["n_heads"], n_kv=CP["n_kv"],
                      d_head=CP["d_head"])
    p = {k: _t(v) for k, v in _tree(ref, "cp.p").items()}
    ck, cv = _t(ref["cp.ck"]), _t(ref["cp.cv"])
    for cur_len in CP["cur_lens"]:
        x = _t(ref[f"cp.{cur_len}.x"])
        pos = torch.tensor(cur_len) if tensor_pos else cur_len
        want_o, want_k, want_v = L.attn_decode(p, x, ck.clone(), cv.clone(), pos, dims)
        o, ck, cv = cp_decode_attention(p, x, ck, cv, pos, dims, mesh, seq_axis="data")
        for got, want, tol in ((o, ref[f"cp.{cur_len}.o"], 2e-5), (o, want_o, 2e-5),
                               (ck, ref[f"cp.{cur_len}.k"], 1e-6), (ck, want_k, 1e-6),
                               (cv, ref[f"cp.{cur_len}.v"], 1e-6), (cv, want_v, 1e-6)):
            np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol,
                                       err_msg=f"cur_len {cur_len}")


# --- the sharded train step -----------------------------------------------------------


def _shapes_of(state) -> dict:
    """Each leaf's part shape, the reference's layout: a stack's groups'
    parts stacked (the lead of a stacked leaf's spec is None)."""
    def leaf(sh):
        return np.asarray(sh.parts[0].shape, np.int64)

    def walk(tree):
        if isinstance(tree, list):
            g = walk(tree[0])
            return jax.tree.map(lambda a: np.concatenate([[len(tree)], a]), g)
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        return leaf(tree)

    return {"params": walk(state["params"].tree()), "opt": walk(state["opt"]),
            "step": np.asarray(state["step"].shape, np.int64)}


def _train(ref, name):
    cfg = dataclasses.replace(get_reduced(name), **F32, **TRAIN[name])
    mesh = TM.make_host_mesh(data=2, model=2, device="cpu")
    cfg, _, step, specs = TL.build(cfg, mesh, device="cpu")
    state = reshard_state(_tree(ref, f"train.{name}.init"), cfg, mesh)
    shapes = _shapes_of(state)
    metrics = []
    for i in range(TRAIN_STEPS):
        batch = {k: _t(ref[f"train.{name}.batch{i}.{k}"]) for k in ("tokens", "labels", "mask")}
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return cfg, specs, state, shapes, metrics


_SINGLE = {}


def _single(ref, name):
    """`_train`'s run of `name`, made once a test worker (the gloo test
    holds the processes' steps to it)."""
    if name not in _SINGLE:
        _SINGLE[name] = _train(ref, name)
    return _SINGLE[name]


@pytest.mark.parametrize("name", list(TRAIN))
def test_sharded_train_steps_match_reference(ref, name):
    """Two `launch.train` steps on (data 2, model 2) from the reference's
    initial state: the losses, ce, aux and grad_norm of each step and the
    final params and optimizer state against the reference's; each part's
    shape the reference's shard shape. granite runs at capacity factor
    1.0 with 2 micro-batches (its drops depend on the accumulation
    order); jamba's optimizer is Adafactor."""
    cfg, specs, state, shapes, metrics = _single(ref, name)
    _close(shapes, _tree(ref, f"train.{name}.shards"), f"{name} shard shapes", 0, 0)
    for i, m in enumerate(metrics):
        for k, v in m.items():
            np.testing.assert_allclose(v, ref[f"train.{name}.step{i}.{k}"], rtol=RTOL,
                                       atol=ATOL, err_msg=f"{name} step {i} {k}")
    got = convert.train_state_to_numpy(state)
    want = _tree(ref, f"train.{name}.final")
    _close(got["params"], want["params"], f"{name} params", RTOL,
           PARAM_ATOL.get(name, ATOL))
    _close(got["opt"], want["opt"], f"{name} optimizer state", RTOL,
           PARAM_ATOL.get(name, ATOL))
    assert int(got["step"]) == int(want["step"]) == TRAIN_STEPS
    assert (cfg.optimizer == "adafactor") == ("stats" in state["opt"])


# --- elastic resharding ---------------------------------------------------------------


@pytest.mark.parametrize("shape", [(4, 1), (1, 2)])
def test_elastic_reshard_matches_reference(ref, shape, tmp_path):
    """Reduced gemma's state, built on (2, 2) and checkpointed, restored
    onto (4, 1) and (1, 2): every leaf bit for bit the reference's, each
    part the reference's shard shape; then one step's loss there."""
    from repro_torch.ckpt.checkpoint import restore, save

    data, model = shape
    host = _tree(ref, "elastic.state")
    mesh = TM.make_host_mesh(data=data, model=model, device="cpu")
    cfg = dataclasses.replace(get_reduced("gemma-2b"), **F32)
    cfg = cfg.with_policy(SH.policy_for(mesh))
    save(host, str(tmp_path), 1)
    state = reshard_state(restore(str(tmp_path), 1, like=host), cfg, mesh)
    tag = f"elastic.{data}x{model}"
    got = convert.train_state_to_numpy(state)
    for k, want in _flat(_tree(ref, tag + ".state")).items():
        g = _flat(got)[k]
        assert g.dtype == want.dtype and np.array_equal(g, want), k
    _close(_shapes_of(state), _tree(ref, tag + ".shards"), f"{tag} shard shapes", 0, 0)
    step = Md.make_train_step(cfg, TA.for_config(cfg),
                              param_specs=SH.train_state_specs(cfg, host, mesh)["params"])
    batch = {k: _t(ref[f"elastic.batch.{k}"]) for k in ("tokens", "labels", "mask")}
    _, m = step(state, batch)
    np.testing.assert_allclose(float(m["loss"]), ref[tag + ".loss"], rtol=RTOL, atol=ATOL)


# --- serving on a mesh (port only) ----------------------------------------------------


@pytest.mark.parametrize("cf", [8.0, 1.0])
def test_sharded_serving_equals_the_policy_path(cf):
    """Reduced granite's prefill and 3 greedy decode steps with the
    params placed on (data 2, model 2) and the cache split by
    `cache_specs` equal the same config's policy run on an unsharded LM
    (one process, the same per-shard MoE dispatch) within 1e-5; at
    capacity factor 8 (no drops) both equal the unsharded run without a
    policy within 1e-5."""
    mesh = TM.make_host_mesh(data=2, model=2, device="cpu")
    cfg = dataclasses.replace(get_reduced("granite-moe-3b-a800m"), **F32,
                              moe_capacity_factor=cf)
    pcfg = cfg.with_policy(SH.policy_for(mesh))
    params = Md.init_params(cfg, 0, device="cpu")
    shapes = SH.ref_layout(params.tree())
    sharded = SH.ShardedLM.place(pcfg, mesh, params, SH.param_specs(pcfg, shapes, mesh))
    tokens = torch.from_numpy(np.random.RandomState(0).randint(0, cfg.vocab, (4, 8)))

    def run(c, p):
        logits, cache = Md.prefill(c, p, {"tokens": tokens}, max_len=12)
        outs = [logits]
        for t in range(3):
            logits, cache = Md.decode_step(c, p, cache, logits.argmax(-1), 8 + t)
            outs.append(logits)
        return torch.cat(outs, 1), cache

    got, cache = run(pcfg, sharded)
    assert isinstance(cache, SH.ShardedCache)
    k = cache["b0"]["k"]
    assert tuple(k.spec) == (None, "data", None, "model", None)
    assert tuple(k.parts[0].shape) == (2, 2, 12, 1, 16)
    want, want_cache = run(pcfg, params)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    for b, c in convert.cache_to_numpy(cache).items():
        for n, a in c.items():
            np.testing.assert_allclose(a, convert.cache_to_numpy(want_cache)[b][n],
                                       rtol=1e-5, atol=1e-5)
    if cf == 8.0:
        plain, _ = run(cfg, params)
        torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", SERVE["names"])
def test_tp_serving_matches_reference(ref, name):
    """Reduced granite's and qwen's prefill and 3 decode steps on (data 2,
    model 4), tensor-parallel, from the reference's params and fed its
    greedy tokens: every step's logits within 1e-4 (f32) of the
    reference's sharded run under its own specs; the cache a
    `ShardedCache` split over the model axis by kv heads (qwen's 4) or,
    where they do not divide it, by head dim (granite's 2)."""
    mesh = TM.make_host_mesh(data=2, model=4, device="cpu")
    cfg = dataclasses.replace(get_reduced(name), **F32)
    pcfg = cfg.with_policy(SH.policy_for(mesh))
    params = convert.params_from_reference(cfg, _tree(ref, f"serve.{name}.p"))
    sharded = SH.ShardedLM.place(pcfg, mesh, params, SH.param_specs(
        pcfg, SH.ref_layout(params.tree()), mesh))
    tag = f"serve.{name}"
    logits, cache = Md.prefill(pcfg, sharded, {"tokens": _t(ref[tag + ".tokens"])},
                               max_len=SERVE["max_len"])
    got = [logits]
    for i in range(SERVE["steps"]):
        logits, cache = Md.decode_step(pcfg, sharded, cache, _t(ref[f"{tag}.token{i}"]),
                                       SERVE["P"] + i)
        got.append(logits)
    for i, g in enumerate(got):
        np.testing.assert_allclose(g.numpy(), ref[f"{tag}.logits{i}"], rtol=1e-4, atol=1e-4,
                                   err_msg=f"{name} step {i}")
    assert isinstance(cache, SH.ShardedCache)
    assert tuple(cache["b0"]["k"].spec) == ((None, "data", None, "model", None)
                                            if cfg.n_kv % 4 == 0 else
                                            (None, "data", None, None, "model"))


# `launch/dryrun.py`'s records of the steps the gloo processes count
_dryruns, dry = fixtures()


# --- over several processes ----------------------------------------------------------


def test_train_steps_over_gloo_processes(ref, dry, tmp_path):
    """gemma-2b and granite (capacity factor 1.0, 2 micro-batches) on
    (data 2, model 2) over 4 gloo processes, one shard a process
    (`torch_mp_worker.py`): two train steps from the reference's initial
    state give every process the single controller's losses, metrics and
    final state bit for bit, and the reference's within
    `test_sharded_train_steps_match_reference`'s tolerances; gemma's
    state, saved from the processes, restores in one process bit for
    bit; `compressed_psum` over the data axis is the single controller's;
    the bytes each process sends and receives in the first step are the
    dry run's of that step as the same rank (`launch/dryrun.py`)."""
    names = ("gemma-2b", "granite-moe-3b-a800m")
    rng = np.random.RandomState(3)
    grads, resid = (rng.randn(4, 8, 3).astype(np.float32) for _ in range(2))
    inputs = {"train": {n: (_tree(ref, f"train.{n}.init"),
                            [{k: ref[f"train.{n}.batch{i}.{k}"] for k in ("tokens", "labels",
                                                                           "mask")}
                             for i in range(TRAIN_STEPS)]) for n in names},
              "compress": (grads, resid)}
    outs = run_processes(tmp_path, "lm", inputs)
    assert [o["local"].tolist() for o in outs] == [[0], [1], [2], [3]]
    for name in names:
        _, _, state, _, metrics = _single(ref, name)
        host = convert.train_state_to_numpy(state)
        want = {"/" + "/".join(k): v for k, v in _flat(host).items()}
        for r, o in enumerate(outs):
            for i, m in enumerate(metrics):
                for k, v in m.items():
                    got = o[f"{name}.step{i}.{k}"]
                    np.testing.assert_array_equal(got, np.float32(v),
                                                  err_msg=f"process {r} {name} step {i} {k}")
                    np.testing.assert_allclose(got, ref[f"train.{name}.step{i}.{k}"],
                                               rtol=RTOL, atol=ATOL)
            for k, v in want.items():
                np.testing.assert_array_equal(o[f"{name}.final{k}"], v,
                                              err_msg=f"process {r} {name} {k}")
            moved_as_dry(o, f"lm.{name}.train", dry, r)
        _close(host["params"], _tree(ref, f"train.{name}.final")["params"], f"{name} params",
               RTOL, PARAM_ATOL.get(name, ATOL))
        if name == "gemma-2b":
            from repro_torch.ckpt import checkpoint as tckpt

            back = tckpt.restore(str(tmp_path / "ckpt_lm"), TRAIN_STEPS, like=host)
            for k, v in _flat(back).items():
                np.testing.assert_array_equal(v, _flat(host)[k], err_msg=f"restored {k}")
    from repro_torch.optim import compress as TC

    one = TM.make_host_mesh(data=2, model=2, device="cpu")
    mean, new_r = TM.over(one, "data", TC.compressed_psum,
                          {s: {"w": _t(grads[s])} for s in range(4)},
                          {s: {"w": _t(resid[s])} for s in range(4)})
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o[f"compress.{r}.mean"], mean[r]["w"].numpy())
        np.testing.assert_array_equal(o[f"compress.{r}.resid"], new_r[r]["w"].numpy())


def _serve_inputs():
    """`torch_mp_worker.serve_runs`' inputs, from numpy seeds: granite's
    prompts (B 4 and 3, 8 tokens), `forward_train`'s batches (B 4 x S 16),
    the SERVE_TRAIN steps' batches, and a cp decode layer at `CP`'s dims
    with its cache and one x a cur_len."""
    from torch_mp_worker import SERVE_TRAIN

    rng = np.random.RandomState(7)

    def batch(B, S, vocab=256):
        return {"tokens": rng.randint(0, vocab, (B, S)).astype(np.int32),
                "labels": rng.randint(0, vocab, (B, S)).astype(np.int32),
                "mask": (rng.rand(B, S) > 0.1).astype(np.float32)}

    dims = {k: CP[k] for k in ("d_model", "n_heads", "n_kv", "d_head")}
    g = torch.Generator().manual_seed(3)
    p = {k: v.numpy() for k, v in L.attn_init(g, L.AttnDims(**dims), torch.float32,
                                              "cpu").items()}
    kv = (CP["B"], CP["S"], CP["n_kv"], CP["d_head"])
    sp = {"x": rng.randn(2, 2, 2, 8, 3), "w": rng.randn(2, 2, 2, 4, 3),
          "y": rng.randn(2, 2, 2, 4, 3), "wa": rng.randn(2, 2, 2, 8, 3),
          "wb": rng.randn(2, 2, 8, 3)}
    return {"prompts": {B: rng.randint(0, 256, (B, 8)) for B in (4, 3)},
            "sp": {k: v.astype(np.float32) for k, v in sp.items()},
            "long": rng.randint(0, 256, (1, 8)),
            "forward": {n: batch(4, 16) for n in ("gemma-2b", "granite-moe-3b-a800m")},
            "train": {tag: [batch(*shape) for _ in range(2)] for tag, _, shape in SERVE_TRAIN},
            "cp": {"dims": dims, "p": p, "cur_lens": CP["cur_lens"],
                   "ck": (rng.randn(*kv) * 0.5).astype(np.float32),
                   "cv": (rng.randn(*kv) * 0.5).astype(np.float32),
                   "xs": [(rng.randn(CP["B"], 1, CP["d_model"]) * 0.5).astype(np.float32)
                          for _ in CP["cur_lens"]]}}


def test_serving_over_gloo_processes(dry, tmp_path):
    """Sharded serving and the MoE split over 4 gloo processes, one shard
    a process (`torch_mp_worker.serve_runs`): reduced granite's prefill
    and 3 greedy decode steps (capacity factors 8 and 1, B 4 and the
    one-pass B 3) give every process the single controller's logits and
    joined cache bit for bit, as do `forward_train` (gemma-2b, granite),
    granite's train steps where the sequence does not divide the model
    axis (5 experts) and where the expert dim lies on the model axis (6),
    and `cp_decode_attention` on (data 4, model 1) (its output, and each
    process's cache slices), `sum_scatter` and `gather_fanout` (each
    rank's value and gradient, and the single controller's the plain
    sum split), and reduced gemma's and jamba's long-context decode
    (batch 1, the cache's sequence over the data axis; its prefill
    sequence-parallel), with 0 B received inside the cache's reads
    and every cache part written in place. All of it runs tensor-parallel (the ranks'
    partial sums counted on every process). Granite's 5 experts do not
    divide the model axis, so their stacks are split by hidden dim and
    every expert FFN runs the 5 live experts on a rank's hidden block
    (the one-pass B 3 on `moe_apply`'s dispatch, as the reference's);
    with 6 experts each expert FFN runs E_loc = 3 experts and a pass
    gathers its ranks' 3 alone, in a process as in the single
    controller; a cp decode layer sends only the partials (o, m, l); the bytes each
    process sends and receives in a decode step of reduced granite and
    gemma-2b (B 4, a 12-row cache) are the dry run's of that step as the
    same rank (`launch/dryrun.py`)."""
    from torch_mp_worker import serve_runs

    inputs = _serve_inputs()
    outs = run_processes(tmp_path, "serve", inputs)
    want, experts = {}, {}
    serve_runs(inputs, want, experts)
    assert experts.pop("tp") > 0
    for run, sizes in experts.items():
        assert sizes == ({3} if run.startswith("window.") else
                         {(3, 3)} if run == "train.e6_s16" else {(5, 5)}), (run, sizes)
    assert sorted(k for k in experts if k.startswith("window.")) == ["window.train.e6_s16"]
    n = CP["S"] // 4
    for r, o in enumerate(outs):
        assert o["tp_sums"] > 0, r
        assert o["experts"].tolist() == sorted(experts), r
        for run, sizes in experts.items():
            got = o[f"experts.{run}"]
            assert ({int(e) for e in got} if got.ndim == 1 else
                    {tuple(e) for e in got}) == sizes, f"process {r} {run}"
        for k, v in want.items():
            if k.startswith("cp.") and k.split(".")[1] in "kv" or k.startswith("sp.rank."):
                continue
            np.testing.assert_array_equal(o[k], v, err_msg=f"process {r} {k}")
        mine = sorted(k for k in o if k.startswith("sp.rank."))
        assert len(mine) == 4  # its one model rank's four results
        for k in mine:
            np.testing.assert_array_equal(o[k], want[k], err_msg=f"process {r} {k}")
        for tag in "kv":
            np.testing.assert_array_equal(o[f"cp.{tag}.{r}"], want[f"cp.{tag}.{r}"],
                                          err_msg=f"process {r} cp cache {tag}")
        partials = CP["B"] * CP["n_heads"] * (CP["d_head"] + 2) * 4  # o, m, l in f32
        slice_bytes = CP["B"] * n * CP["n_kv"] * CP["d_head"] * 4
        assert o["cp.sent_bytes"].tolist() == [partials], o["cp.sent_bytes"]
        assert partials < slice_bytes
        for name in ("granite-moe-3b-a800m", "gemma-2b"):
            moved_as_dry(o, f"serve.{name}.decode", dry, r)
        for name in LONG["names"]:
            assert int(o[f"long.{name}.cache_received"]) == 0 and bool(o[f"long.{name}.in_place"])
    sp = inputs["sp"]
    for d in range(2):  # the single controller's: the plain sum, split; the joined rows
        total = sp["x"][d][0] + sp["x"][d][1]
        grad = sp["wa"][d][0] + sp["wa"][d][1] + sp["wb"][d]
        for m in range(2):
            tag = f"sp.rank.{d}.{m}"
            np.testing.assert_array_equal(want[f"{tag}.sum"], total[:, 4 * m:4 * m + 4])
            np.testing.assert_array_equal(want[f"{tag}.sum_grad"],
                                          np.concatenate(list(sp["w"][d]), 1))
            np.testing.assert_array_equal(want[f"{tag}.whole"],
                                          np.concatenate(list(sp["y"][d]), 1))
            np.testing.assert_array_equal(want[f"{tag}.whole_grad"], grad[:, 4 * m:4 * m + 4])
    for name in LONG["names"]:
        assert int(want[f"long.{name}.cache_received"]) == 0


# --- tensor parallelism, layer by layer (port only) -----------------------------------

TP = 4
TP_TOL = dict(rtol=1e-5, atol=1e-5)


def _tp_policy():
    """A pass's policy on (data 1, model 4) in one process: every rank in turn."""
    return ShardingPolicy(batch=("data",), model="model", tp_size=TP, dp_size=1).with_group(
        TM.AxisGroup(TP))


def _leaves(seed, shapes, scale=0.3):
    """f32 leaves from a numpy seed, each requiring grad."""
    rng = np.random.RandomState(seed)
    return {k: torch.from_numpy((rng.randn(*s) * scale).astype(np.float32)).requires_grad_(True)
            for k, s in shapes.items()}


def _by_rank(p, dims):
    """Each leaf of `p` named in `dims` ({name: dim}) as its TP ranks' blocks
    along that dim (views: their gradients reach the leaf)."""
    return {k: _blocks(v, dims[k]) if k in dims else v for k, v in p.items()}


def _blocks(t, dim):
    """`t` as the TP ranks' blocks along `dim`, as a pass reads a leaf the
    specs split over the model axis."""
    return TM.Blocks(torch.chunk(t, TP, dim), dim)


def _grads(ts):
    out = [torch.zeros_like(t) if t.grad is None else t.grad.clone() for t in ts]
    for t in ts:
        t.grad = None
    return out


def _fwd_bwd(fn, inputs, probe_seed=9):
    """fn()'s output and the gradients of a fixed random projection of it
    in every tensor of `inputs`."""
    out = fn()
    w = torch.from_numpy(np.random.RandomState(probe_seed).randn(*out.shape).astype(np.float32))
    (out * w).sum().backward()
    return out.detach(), _grads(inputs)


def _close_all(got, want, tag, **tol):
    for i, (g, w) in enumerate(zip(got, want)):
        torch.testing.assert_close(g, w, msg=lambda m: f"{tag} {i}: {m}", **(tol or TP_TOL))


ATTN_TP = {"kv heads": (4, 4), "one kv head": (4, 1), "row split": (6, 6)}


@pytest.mark.parametrize("case", sorted(ATTN_TP))
def test_tp_attention_matches_one_device(case):
    """`attn_apply` on (data 1, model 4) against one device, forward and
    gradients at 1e-5 (f32): q heads split (kv heads split with them, or
    one kv head every rank reads), and 6 heads, which do not divide the
    axis: x comes as the ranks' rows of the sequence and each rank
    attends with its own rows (the reference's row pin, `_attend_rows`)."""
    H, KV = ATTN_TP[case]
    dims = L.AttnDims(d_model=32, n_heads=H, n_kv=KV, d_head=8, qkv_bias=True)
    p = _leaves(0, {"wq": (32, H, 8), "wk": (32, KV, 8), "wv": (32, KV, 8),
                    "wo": (H, 8, 32), "bq": (H, 8), "bk": (KV, 8), "bv": (KV, 8)})
    x = _leaves(1, {"x": (2, 16, 32)})["x"]
    split = {**({"wq": 1, "bq": 0, "wo": 0} if H % TP == 0 else {}),
             **({"wk": 1, "wv": 1, "bk": 0, "bv": 0} if KV % TP == 0 else {})}
    ins = [x, *p.values()]
    kw = dict(causal=True, q_chunk=8, kv_chunk=8)
    pol = _tp_policy()

    def tp():
        if H % TP == 0:
            return L.attn_apply(_by_rank(p, split), x, dims, policy=pol, **kw)
        rows = L.attn_apply(p, pol.group.split(x, 1), dims, policy=pol, **kw)
        assert isinstance(rows, TM.Blocks) and rows.dim == 1
        return torch.cat(list(rows), 1)

    got = _fwd_bwd(tp, ins)
    want = _fwd_bwd(lambda: L.attn_apply(p, x, dims, **kw), ins)
    _close_all([got[0], *got[1]], [want[0], *want[1]], case)


def test_tp_decode_attention_on_a_head_dim_cache():
    """`attn_decode` on (data 1, model 4) with 2 kv heads, which do not
    divide the axis: the cache is split by head dim, as `cache_specs`
    places it, each rank writing its slice of the new k, v and taking
    partial scores over it. The output at 1e-5 and the written cache
    exactly against one device's, over three steps."""
    dims = L.AttnDims(d_model=32, n_heads=4, n_kv=2, d_head=16)
    p = {k: v.detach() for k, v in _leaves(2, {"wq": (32, 4, 16), "wk": (32, 2, 16),
                                                "wv": (32, 2, 16), "wo": (4, 16, 32)}).items()}
    rng = np.random.RandomState(3)
    ck, cv = (torch.from_numpy(rng.randn(2, 12, 2, 16).astype(np.float32)) for _ in "kv")
    tk, tv = ck.clone(), cv.clone()
    bk, bv = (_blocks(c.clone(), 3) for c in (ck, cv))
    for t in (5, 6, 7):
        x = torch.from_numpy(rng.randn(2, 1, 32).astype(np.float32))
        with torch.no_grad():
            o, bk, bv = L.attn_decode(_by_rank(p, {"wq": 1, "wo": 0}), x, bk, bv,
                                      torch.tensor(t), dims, policy=_tp_policy())
            want, tk, tv = L.attn_decode(p, x, tk, tv, torch.tensor(t), dims)
        torch.testing.assert_close(o, want, **TP_TOL)
        assert torch.equal(torch.cat(bk, 3), tk) and torch.equal(torch.cat(bv, 3), tv)


def test_tp_mlp_matches_one_device():
    """`mlp_apply` column/row-parallel on (data 1, model 4): forward and
    gradients at 1e-5 against one device."""
    p = _leaves(4, {"w_up": (32, 64), "w_gate": (32, 64), "w_down": (64, 32)})
    x = _leaves(5, {"x": (2, 8, 32)})["x"]
    ins = [x, *p.values()]
    got = _fwd_bwd(lambda: L.mlp_apply(_by_rank(p, {"w_up": 1, "w_gate": 1, "w_down": 0}), x,
                                       policy=_tp_policy()), ins)
    want = _fwd_bwd(lambda: L.mlp_apply(p, x), ins)
    _close_all([got[0], *got[1]], [want[0], *want[1]], "mlp")


@pytest.mark.parametrize("groups", [1, 2])
def test_tp_ssm_matches_one_device(groups):
    """`ssm_apply` on (data 1, model 4), 8 heads (2 a rank) in 1 or 2
    B/C groups: `in_proj` column-parallel (its blocks joined), the conv on
    each rank's channel block, the rank's heads, the gated norm from the
    ranks' partial sums, `out_proj` row-parallel. Forward, final state and
    gradients at 1e-5; then `ssm_decode` from that state and the conv
    tail, each rank its heads' state block and its conv channels."""
    from repro_torch.models import ssm as Sm

    dims = Sm.SSMDims(d_model=32, d_state=8, headdim=8, n_groups=groups, chunk=8)
    d_in = 2 * dims.d_inner + 2 * groups * dims.d_state + dims.n_heads
    shapes = {"in_proj": (32, d_in), "conv_w": (dims.d_conv, dims.conv_dim),
              "conv_b": (dims.conv_dim,), "A_log": (dims.n_heads,), "D": (dims.n_heads,),
              "dt_bias": (dims.n_heads,), "norm": (dims.d_inner,),
              "out_proj": (dims.d_inner, 32)}
    p = _leaves(6, shapes)
    x = _leaves(7, {"x": (2, 16, 32)})["x"]
    split = {"in_proj": 1, "conv_w": 1, "conv_b": 0, "out_proj": 0}
    ins = [x, *p.values()]
    got, want = [], []
    for out, q, pol in ((got, _by_rank(p, split), _tp_policy()), (want, p, None)):
        y, final, tail = Sm.ssm_apply(q, x, dims, policy=pol)
        w = torch.from_numpy(np.random.RandomState(9).randn(*y.shape).astype(np.float32))
        ((y * w).sum() + torch.cat(final, 1).sum() if pol else (y * w).sum()
         + final.sum()).backward()
        out += [y.detach(), (torch.cat(final, 1) if pol else final).detach(), tail.detach(),
                *_grads(ins)]
    _close_all(got, want, f"ssm g{groups}")
    xd = torch.from_numpy(np.random.RandomState(8).randn(2, 1, 32).astype(np.float32))
    with torch.no_grad():
        q = _by_rank({k: v.detach() for k, v in p.items()}, split)
        state, conv = got[1], got[2]
        y, ns, nc = Sm.ssm_decode(q, xd, _blocks(state, 1), _blocks(conv, 2), dims,
                                  policy=_tp_policy())
        wy, ws, wc = Sm.ssm_decode({k: v.detach() for k, v in p.items()}, xd, want[1],
                                   want[2], dims)
    _close_all([y, torch.cat(ns, 1), torch.cat(nc, 2)], [wy, ws, wc], f"ssm decode g{groups}")


def test_tp_vocab_parallel_head_matches_one_device():
    """The vocab-parallel embedding (bitwise: one rank's lookup is not
    zero; S 16 divides the model axis, so it leaves through the
    reduce-scatter as the ranks' rows, joined here), `logits_last` (each
    rank its vocab block, the blocks joined; its row the last rank's)
    and `chunked_ce_loss` (the log-sum-exp from the ranks' maxima and
    sums, the gold logit from its rank) on (data 1, model 4), tied and
    untied: forward and gradients at 1e-5 against one device."""
    from repro_torch.models import transformer as T

    rng = np.random.RandomState(10)
    tokens = torch.from_numpy(rng.randint(0, 256, (2, 16)))
    labels = torch.from_numpy(rng.randint(0, 256, (2, 16)))
    mask = torch.from_numpy((rng.rand(2, 16) > 0.2).astype(np.float32))
    for tie in (True, False):
        cfg = dataclasses.replace(get_reduced("gemma-2b"), **F32, tie_embeddings=tie)
        p = _leaves(11, {"embed": (256, 64), **({} if tie else {"unembed": (64, 256)})})
        tp_cfg = cfg.with_policy(_tp_policy())
        q = _by_rank(p, {"embed": 0, "unembed": 1})
        with torch.no_grad():
            rows = T.embed_tokens(tp_cfg, q, tokens)
            assert [tuple(t.shape) for t in rows] == [(2, 4, 64)] * TP
            assert torch.equal(T.seq_whole(tp_cfg, rows), T.embed_tokens(cfg, p, tokens))
        ins = list(p.values())
        for tag, fn in (("embed", lambda c, w: T.seq_whole(c, T.embed_tokens(c, w, tokens))),
                        ("logits", lambda c, w: T.logits_last(
                            c, w, T.last_row(c, T.embed_tokens(c, w, tokens)))),
                        ("ce", lambda c, w: T.chunked_ce_loss(
                            c, w, T.embed_tokens(c, w, tokens), labels, mask, chunk=8)[None])):
            got = _fwd_bwd(lambda: fn(tp_cfg, q), ins)
            want = _fwd_bwd(lambda: fn(cfg, p), ins)
            _close_all([got[0], *got[1]], [want[0], *want[1]], f"{tag} tie={tie}")


# --- sequence parallelism and the long-context decode ---------------------------------


def test_sum_scatter_and_gather_fanout_are_their_plain_counterparts():
    """`AxisGroup.sum_scatter` is `sum` then split bit for bit, and its
    gradient the ranks' slices joined; `gather_fanout` is the ranks' rows
    joined, a copy a rank, and its gradient the copies' gradients added in
    rank order, then the joined tensor's, split: the reduce-scatter."""
    g = TM.AxisGroup(TP)
    rng = np.random.RandomState(12)

    def leaf(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).requires_grad_(True)

    xs = [leaf(2, 8, 3) for _ in range(TP)]
    ws = [torch.from_numpy(rng.randn(2, 2, 3).astype(np.float32)) for _ in range(TP)]
    rows = g.sum_scatter(xs, 1)
    assert isinstance(rows, TM.Blocks) and rows.dim == 1
    want = torch.split(g.sum([x.detach() for x in xs]), 2, 1)
    assert all(torch.equal(a, b) for a, b in zip(rows, want))
    sum((r * w).sum() for r, w in zip(rows, ws)).backward()
    assert all(torch.equal(x.grad, torch.cat(ws, 1)) for x in xs)
    ys = [leaf(2, 2, 3) for _ in range(TP)]
    whole, each = g.gather_fanout(ys, 1)
    assert torch.equal(whole, torch.cat([y.detach() for y in ys], 1))
    assert len(each) == TP and all(torch.equal(c, whole) for c in each)
    wa = [torch.from_numpy(rng.randn(2, 8, 3).astype(np.float32)) for _ in range(TP)]
    wb = torch.from_numpy(rng.randn(2, 8, 3).astype(np.float32))
    (sum((c * w).sum() for c, w in zip(each, wa)) + (whole * wb).sum()).backward()
    total = g.sum(wa) + wb
    assert all(torch.equal(y.grad, t) for y, t in zip(ys, torch.split(total, 2, 1)))


# the block kinds under SP: (config, pattern entry, replace)
SP_BLOCKS = {"attn one kv head": ("gemma-2b", ("attn", "dense"), {}),
             "attn kv heads": ("minitron-8b", ("attn", "dense"), {}),
             "attn row split": ("qwen1.5-32b", ("attn", "dense"), {"n_heads": 3, "n_kv": 3}),
             "cross": ("llama-3.2-vision-90b", ("cross", "dense"), {}),
             "cross row split": ("llama-3.2-vision-90b", ("cross", "dense"),
                                 {"n_heads": 3, "n_kv": 1}),
             "mamba": ("jamba-1.5-large-398b", ("mamba", "dense"), {}),
             "moe by expert": ("qwen3-moe-30b-a3b", ("attn", "moe"),
                               {"moe_capacity_factor": 8.0}),
             "moe by hidden": ("granite-moe-3b-a800m", ("attn", "moe"),
                               {"moe_capacity_factor": 8.0})}
SP_MESHES = {"data 1 model 4": (1, 4), "data 2 model 2": (2, 2)}


def _rank_tree(cfg, p, tp):
    """A block's parameters as a tensor-parallel pass reads them: each
    leaf the specs split over the model axis (`spec_for_param` on (data
    1, model tp)) as its ranks' blocks (views: their gradients reach the
    leaf)."""
    def walk(path, node):
        if isinstance(node, dict):
            return {k: walk(path + (k,), v) for k, v in node.items()}
        spec = SH.spec_for_param(cfg, path, tuple(node.shape), {"data": 1, "model": tp})
        dim = next((d for d, a in enumerate(spec) if a == "model"), None)
        return node if dim is None else TM.Blocks(torch.chunk(node, tp, dim), dim)

    return walk(("block",), p)


@pytest.mark.parametrize("mesh", sorted(SP_MESHES))
@pytest.mark.parametrize("kind", sorted(SP_BLOCKS))
def test_sp_block_matches_one_device(kind, mesh):
    """`block_apply_train` on a sequence-parallel pass (B 4 x S 16 as the
    model ranks' rows, `Blocks` along dim 1) against one device with the
    same policy: the output (each rank's residual [B, S/tp, d]), the aux
    loss, and the gradients of x and of every weight at 1e-5 (f32). The
    kinds: attention with one kv head every rank reads, with kv heads
    split, with 3 heads and qkv biases (which do not divide the axis:
    each rank attends with its own rows, the row split of the replicated
    layout), cross attention with 4 heads and with 3, mamba with a dense
    FFN, the MoE's sequence-sharded path by expert (8 experts) and by
    hidden (5). (data 2, model 2) splits heads, FFN hidden and rows in two
    where (data 1, model 4) splits them in four, and the MoE's dispatch
    reads its data axis."""
    from repro_torch.models import transformer as T

    name, (mixer, mlp_kind), extra = SP_BLOCKS[kind]
    dp, tp = SP_MESHES[mesh]
    cfg = dataclasses.replace(get_reduced(name), **F32, **extra)
    pol = ShardingPolicy(batch=("data",), model="model", tp_size=tp, dp_size=dp)
    one, sp = cfg.with_policy(pol), cfg.with_policy(pol.with_group(TM.AxisGroup(tp)))
    p = T.block_init(one, torch.Generator().manual_seed(3), mixer, mlp_kind, torch.float32,
                     "cpu")
    leaves = {path: t.requires_grad_(True) for path, t in _flat(p).items()}
    rng = np.random.RandomState(4)
    B, S, d = 4, 16, cfg.d_model
    x = torch.from_numpy((rng.randn(B, S, d) * 0.5).astype(np.float32)).requires_grad_(True)
    memory = torch.from_numpy((rng.randn(B, 16, d) * 0.5).astype(np.float32))
    # a probe of 0.05 keeps the gradients O(1), as in the `test_tp_*` cases: at
    # N(0, 1) they reach 90 (the norm rescales x), where both paths' f32 sums
    # sit ~3e-5 from an f64 run's
    probe = torch.from_numpy((rng.randn(B, S, d) * 0.05).astype(np.float32))
    ins = [x, *leaves.values()]
    outs = []
    for c, q, xin in ((sp, _rank_tree(sp, p, tp), TM.AxisGroup(tp).split(x, 1)),
                      (one, p, x)):
        y, aux = T.block_apply_train(c, q, xin, mixer, mlp_kind, memory=memory)
        if c is sp:
            assert isinstance(y, TM.Blocks) and y.dim == 1
            assert [tuple(t.shape) for t in y] == [(B, S // tp, d)] * tp, kind
            y = torch.cat(y, 1)
        ((y * probe).sum() + aux).backward()
        outs.append([y.detach(), torch.as_tensor(aux).detach(), *_grads(ins)])
    _close_all(outs[0], outs[1], f"{kind} {mesh}")


def _joins(monkeypatch):
    """A counter of `Mesh.join` calls made inside `ShardedCache.rows`."""
    calls, inside = [0], [False]
    join, rows = TM.Mesh.join, SH.ShardedCache.rows

    def counting(self, *a, **k):
        calls[0] += inside[0]
        return join(self, *a, **k)

    def reading(self, *a, **k):
        inside[0] = True
        try:
            return rows(self, *a, **k)
        finally:
            inside[0] = False

    monkeypatch.setattr(TM.Mesh, "join", counting)
    monkeypatch.setattr(SH.ShardedCache, "rows", reading)
    return calls


@pytest.mark.parametrize("name", LONG["names"])
def test_long_decode_matches_reference(ref, name, monkeypatch):
    """Reduced gemma's and jamba's long-context decode on (data 2, model 2)
    in f32: a batch-1 prefill (sequence-parallel: its residual the model
    ranks' rows) into a cache placed with its sequence over the data axis
    (gemma's split over the model axis by head dim, jamba's by kv heads),
    then 3 decode steps fed the reference's greedy tokens: every step's
    logits within 1e-4 of the reference's sharded run; each step reads the
    cache's parts themselves (`Slices`, no leaf joined) and writes the
    new row into them in place; the cache at the end within 1e-5 of one
    device's decode."""
    mesh = TM.make_host_mesh(data=2, model=2, device="cpu")
    cfg = dataclasses.replace(get_reduced(name), **F32)
    pcfg = cfg.with_policy(dataclasses.replace(SH.policy_for(mesh), seq_axis_for_cache="data"))
    params = convert.params_from_reference(cfg, _tree(ref, f"long.{name}.p"))
    sharded = SH.ShardedLM.place(pcfg, mesh, params, SH.param_specs(
        pcfg, SH.ref_layout(params.tree()), mesh))
    tag, P = f"long.{name}", LONG["P"]
    tokens = _t(ref[tag + ".tokens"])
    logits, cache = Md.prefill(pcfg, sharded, {"tokens": tokens}, max_len=LONG["max_len"])
    assert cache.seq_sharded and tuple(cache["b0"]["k"].spec)[2] == "data"
    ptrs = {(b, n, s): sh.parts[s].data_ptr() for b, c in cache._tree.items()
            for n, sh in c.items() for s in mesh.local}
    joins = _joins(monkeypatch)
    seen = []
    rows = SH.ShardedCache.rows
    monkeypatch.setattr(SH.ShardedCache, "rows",
                        lambda self, *a, **k: seen.append(rows(self, *a, **k)) or seen[-1])
    want_logits, want_cache = Md.prefill(cfg, params, {"tokens": tokens},
                                         max_len=LONG["max_len"])
    got = [logits]
    for i in range(LONG["steps"]):
        tok = _t(ref[f"{tag}.token{i}"])
        logits, cache = Md.decode_step(pcfg, sharded, cache, tok, P + i)
        want_logits, want_cache = Md.decode_step(cfg, params, want_cache, tok, P + i)
        got.append(logits)
    for i, g in enumerate(got):
        np.testing.assert_allclose(g.numpy(), ref[f"{tag}.logits{i}"], rtol=1e-4, atol=1e-4,
                                   err_msg=f"{name} step {i}")
    assert joins[0] == 0 and len(seen) == LONG["steps"]
    k = seen[0]["b0"]["k"]
    assert isinstance(k, TM.Blocks) and all(isinstance(r, TM.Slices) for r in k)
    sh = cache["b0"]["k"]
    assert [[t.data_ptr() for t in r] for r in k] == [
        [sh.parts[s].data_ptr() for s in r.shards] for r in k]
    assert all(sh.parts[s].data_ptr() == p for (b, n, s), p in ptrs.items()
               for sh in [cache[b][n]])
    for b, c in convert.cache_to_numpy(cache).items():
        for n, a in c.items():
            np.testing.assert_allclose(a, convert.cache_to_numpy(want_cache)[b][n], rtol=1e-5,
                                       atol=1e-5, err_msg=f"{name} {b}/{n}")


@pytest.mark.parametrize("tp", [0, TP])
def test_prefill_conv_tail_holds_no_activation(tp):
    """A mamba block's prefill cache keeps the conv window's last d_conv - 1
    rows as a tensor of their own, in one device's pass and a
    tensor-parallel one: a view of the in_proj output would keep that
    [B, S, conv_dim] activation alive until the cache is placed, a
    layer's worth a mamba layer (jamba-1.5-large-398b prefill_32k: ≈ 4.3
    GB each on (data 16, model 16))."""
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_reduced("mamba2-370m"), **F32)
    if tp:
        cfg = cfg.with_policy(_tp_policy())
    p = T.block_init(cfg, torch.Generator().manual_seed(5), "mamba", "none", torch.float32,
                     "cpu")
    if tp:
        p = _rank_tree(cfg, p, tp)
    x = torch.from_numpy(np.random.RandomState(6).randn(2, 16, cfg.d_model).astype(np.float32))
    with torch.no_grad():
        _, cache = T.block_apply_prefill(cfg, p, x, "mamba", "none", 16, torch.float32)
    conv = cache["conv"]
    assert tuple(conv.shape) == (2, cfg.ssm_dims.d_conv - 1, cfg.ssm_dims.conv_dim)
    assert conv.untyped_storage().nbytes() == conv.numel() * conv.element_size()
