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
being the port's own (ROADMAP C 25); resharding bit for bit."""
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
from torch_lm_mesh_ref import CP, F32, MOE, TRAIN, TRAIN_STEPS, Reference
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
    return {"prompts": {B: rng.randint(0, 256, (B, 8)) for B in (4, 3)},
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
    process's cache slices). Every expert FFN of the sharded dispatch
    runs on E_loc = 3 experts' buffer and weights, in a process as in the
    single controller (the one-pass B 3 takes `moe_apply`'s 5, as the
    reference's does), and with 6 experts each process gathers its 3
    alone (the single controller gathers the 6 and splits them); a cp
    decode layer sends only the partials (o, m, l); the bytes each
    process sends and receives in a decode step of reduced granite and
    gemma-2b (B 4, a 12-row cache) are the dry run's of that step as the
    same rank (`launch/dryrun.py`)."""
    from torch_mp_worker import serve_runs

    inputs = _serve_inputs()
    outs = run_processes(tmp_path, "serve", inputs)
    want, experts = {}, {}
    serve_runs(inputs, want, experts)
    for run, sizes in experts.items():
        assert sizes == ({(5, 5)} if run.endswith(".B3") else {(3, 3)}), (run, sizes)
    n = CP["S"] // 4
    for r, o in enumerate(outs):
        assert o["experts"].tolist() == sorted([*experts, "window.train.e6_s16"]), r
        for run, sizes in experts.items():
            assert {tuple(e) for e in o[f"experts.{run}"]} == sizes, f"process {r} {run}"
        assert o["experts.window.train.e6_s16"].tolist() == [3], r
        for k, v in want.items():
            if k.startswith("cp.") and k.split(".")[1] in "kv":
                continue
            np.testing.assert_array_equal(o[k], v, err_msg=f"process {r} {k}")
        for tag in "kv":
            np.testing.assert_array_equal(o[f"cp.{tag}.{r}"], want[f"cp.{tag}.{r}"],
                                          err_msg=f"process {r} cp cache {tag}")
        partials = CP["B"] * CP["n_heads"] * (CP["d_head"] + 2) * 4  # o, m, l in f32
        slice_bytes = CP["B"] * n * CP["n_kv"] * CP["d_head"] * 4
        assert o["cp.sent_bytes"].tolist() == [partials], o["cp.sent_bytes"]
        assert partials < slice_bytes
        for name in ("granite-moe-3b-a800m", "gemma-2b"):
            moved_as_dry(o, f"serve.{name}.decode", dry, r)
