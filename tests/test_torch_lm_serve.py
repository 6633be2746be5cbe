"""The port's LM serving path (`repro_torch.models`) against the reference
`repro.models`, on the CPU: for each of the ten reduced configs, prefill
logits and cache and three greedy decode steps from the same weights (the
port's, in the reference's layout, carried back by `models.convert`), f32
at rtol/atol 1e-4 with the MoE routing equal; bf16 at the measured
tolerance; decode == forward on the port alone at 2e-3; parameter counts,
config fields, the cache layout and the `lm_serve` CLI."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_arch_names
from repro.configs import get_config as jget_config
from repro.configs import get_reduced as jget_reduced
from repro.models import model as JMd
from repro.models import moe as JMoE
from repro_torch.configs import ARCHS, IDS, get_config, get_reduced
from repro_torch.launch import lm_serve
from repro_torch.models import convert
from repro_torch.models import model as Md
from repro_torch.models import moe as TMoE
from repro_torch.models import transformer as T
from jax_release import release_jax_programs  # noqa: F401  (frees compiled programs)

torch.set_num_threads(2)

F32 = dict(compute_dtype="float32", cache_dtype="float32")
RTOL = ATOL = 1e-4  # f32: the two frameworks' sums differ in order only
B, S, STEPS = 2, 8, 3


def _inputs(cfg, seed=0):
    rng = np.random.RandomState(seed)
    batch = {"tokens": rng.randint(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = (rng.randn(B, cfg.n_memory, cfg.d_model) * 0.02).astype(np.float32)
    if cfg.family == "vlm":
        batch["memory"] = (rng.randn(B, cfg.n_memory, cfg.d_model) * 0.02).astype(np.float32)
    return batch


def _reference_tree(params) -> dict:
    """The port's `LM` as the reference's parameter pytree (numpy; each
    stack's leaves stacked on a leading [n_groups] axis)."""
    def stack(groups):
        return {b: {k: {n: np.stack([g[b][k][n].detach().numpy() for g in groups])
                        for n in groups[0][b][k]} for k in groups[0][b]}
                for b in groups[0]}

    return {k: stack(v) if k in ("stack", "enc_stack")
            else {n: t.detach().numpy() for n, t in v.items()}
            for k, v in params.tree().items()}


def _weights(cfg, seed=0):
    """(the reference's parameter pytree, the port's LM) holding the same
    weights: the port's `init_params` on the CPU in the reference's layout,
    carried back through `params_from_reference`. (The reference's own
    `init_params` runs eager, or compiles at length: seconds a config.)"""
    tree = _reference_tree(Md.init_params(cfg, seed, device="cpu"))
    return jax.tree.map(jnp.asarray, tree), convert.params_from_reference(cfg, tree)


def _reference_routes(monkeypatch):
    """Record, for every reference `moe_apply`, its expert ids [T, k] and
    the kept entries (in the stable sort's order), through a debug callback
    that also runs inside the stack's `lax.scan`."""
    routes = []
    original = JMoE._dispatch_combine

    def record(gate_e, C):
        flat = np.asarray(gate_e).reshape(-1)
        order = np.argsort(flat, kind="stable")
        counts = np.bincount(flat, minlength=int(np.max(flat)) + 1)
        starts = np.cumsum(counts) - counts
        pos = np.arange(flat.size) - starts[flat[order]]
        routes.append((np.asarray(gate_e), pos < C))

    def wrapped(xt, logits, top_k, C, E, ffn):
        gate_e = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), top_k)[1]
        jax.debug.callback(lambda e: record(e, C), gate_e)
        return original(xt, logits, top_k, C, E, ffn)

    monkeypatch.setattr(JMoE, "_dispatch_combine", wrapped)
    return routes


def _port_routes(monkeypatch):
    routes = []
    original = TMoE._route

    def wrapped(logits, top_k, C, E):
        out = original(logits, top_k, C, E)
        routes.append((out[2].numpy(), out[4].numpy()))
        return out

    monkeypatch.setattr(TMoE, "_route", wrapped)
    return routes


_j_prefill = jax.jit(JMd.prefill, static_argnums=(0, 3))
_j_decode = jax.jit(JMd.decode_step, static_argnums=0)


def _run_reference(cfg, params, batch):
    """The reference's prefill and STEPS greedy decode steps (jitted once
    a config: eager, each of their ops would compile on its own)."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    logits, cache = _j_prefill(cfg, params, jb, S + 4)
    out = [(np.asarray(logits, np.float32), jax.tree.map(lambda a: np.asarray(a, np.float32),
                                                         cache))]
    tokens = []
    for t in range(STEPS):
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        tokens.append(np.asarray(tok))
        logits, cache = _j_decode(cfg, params, cache, tok, jnp.asarray(S + t, jnp.int32))
        out.append((np.asarray(logits, np.float32),
                    jax.tree.map(lambda a: np.asarray(a, np.float32), cache)))
    return out, tokens


def _run_port(cfg, params, batch, tokens, cur_len_tensor=False):
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    logits, cache = Md.prefill(cfg, params, tb, max_len=S + 4)
    out = [(logits.numpy(), convert.cache_to_numpy(cache))]
    for t in range(STEPS):
        cur = torch.tensor(S + t) if cur_len_tensor else S + t
        logits, cache = Md.decode_step(cfg, params, cache, torch.from_numpy(tokens[t].copy()), cur)
        out.append((logits.numpy(), convert.cache_to_numpy(cache)))
    return out


def _assert_close(got, want, rtol, atol):
    for i, ((gl, gc), (wl, wc)) in enumerate(zip(got, want)):
        tag = "prefill" if i == 0 else f"decode step {i}"
        assert gl.shape == wl.shape, tag
        np.testing.assert_allclose(gl, wl, rtol=rtol, atol=atol, err_msg=f"{tag} logits")
        assert gc.keys() == wc.keys(), tag
        for b in wc:
            assert gc[b].keys() == wc[b].keys(), (tag, b)
            for n in wc[b]:
                assert gc[b][n].shape == wc[b][n].shape, (tag, b, n)
                np.testing.assert_allclose(gc[b][n], wc[b][n], rtol=rtol, atol=atol,
                                           err_msg=f"{tag} cache {b}.{n}")


@pytest.mark.parametrize("name", all_arch_names())
def test_reduced_config_serves_like_reference(name, monkeypatch):
    """Prefill logits and cache, then three decode steps (the reference's
    greedy tokens fed to both), in f32 from the same weights: within
    rtol/atol 1e-4 at every step, and every MoE call routes each token to
    the same experts and keeps the same entries. The port's position goes
    in as a 0-d tensor, the reference's as an int32 scalar."""
    jcfg = dataclasses.replace(jget_reduced(name), **F32)
    cfg = dataclasses.replace(get_reduced(name), **F32)
    jparams, params = _weights(cfg)
    batch = _inputs(cfg)
    want_routes = _reference_routes(monkeypatch)
    got_routes = _port_routes(monkeypatch)
    want, tokens = _run_reference(jcfg, jparams, batch)
    got = _run_port(cfg, params, batch, tokens, cur_len_tensor=True)
    _assert_close(got, want, RTOL, ATOL)
    n_moe = sum(ml == "moe" for _, ml in cfg.pattern) * cfg.n_groups * (1 + STEPS)
    assert len(got_routes) == len(want_routes) == n_moe
    for (ge, gk), (we, wk) in zip(got_routes, want_routes):
        np.testing.assert_array_equal(ge, we)
        np.testing.assert_array_equal(gk, wk)


# bf16 (the configs' own dtypes): the reference's XLA keeps f32 between the
# element-wise ops of a fusion (excess precision), the port rounds each op
# to bf16, so the two drift by a few bf16 ulps a layer (ROADMAP C17). The
# bounds are (logits, cache) max |diff|, about 3x the measured: gemma 0.028
# and 0.016, granite 0.038 and 0.023, mamba2 0.075 and 0.147, whisper 0.029
# and 0.031, qwen1.5 (float8 cache) 0.078 and 0.25, with |logits| <= 5.8.
BF16_ATOL = {"gemma-2b": (0.08, 0.05), "granite-moe-3b-a800m": (0.12, 0.07),
             "mamba2-370m": (0.25, 0.45), "whisper-medium": (0.09, 0.1),
             "qwen1.5-32b": (0.24, 0.75)}


@pytest.mark.parametrize("name", sorted(BF16_ATOL))
def test_reduced_config_bf16_within_measured_tolerance(name):
    """The configs' own dtypes (bf16 compute; bf16 or float8 cache) from the
    same weights, within the measured bounds above. jamba is left out: at
    its capacity factor of 1.0 a bf16 ulp can move a token past an
    expert's capacity (0.54 on its logits)."""
    jcfg, cfg = jget_reduced(name), get_reduced(name)
    jparams, params = _weights(cfg)
    batch = _inputs(cfg)
    want, tokens = _run_reference(jcfg, jparams, batch)
    got = _run_port(cfg, params, batch, tokens)
    logits_atol, cache_atol = BF16_ATOL[name]
    for i, ((gl, gc), (wl, wc)) in enumerate(zip(got, want)):
        np.testing.assert_allclose(gl, wl, rtol=0, atol=logits_atol, err_msg=f"step {i}")
        for b in wc:
            for n in wc[b]:
                np.testing.assert_allclose(gc[b][n], wc[b][n], rtol=0, atol=cache_atol,
                                           err_msg=f"step {i} {b}.{n}")


@pytest.mark.parametrize("name,f32", [("jamba-1.5-large-398b", True),
                                      ("whisper-medium", True), ("qwen1.5-32b", False)])
def test_decode_from_the_reference_cache(name, f32):
    """The reference's prefill cache carried across (`cache_from_reference`:
    every leaf bit for bit, qwen1.5's float8 K/V included), then one decode
    step on each side from it: f32 at 1e-4, bf16 at the bound above."""
    jcfg, cfg = jget_reduced(name), get_reduced(name)
    if f32:
        jcfg, cfg = dataclasses.replace(jcfg, **F32), dataclasses.replace(cfg, **F32)
    jparams, params = _weights(cfg)
    batch = {k: jnp.asarray(v) for k, v in _inputs(cfg).items()}
    logits, jcache = _j_prefill(jcfg, jparams, batch, S + 4)
    cache = convert.cache_from_reference(cfg, jax.tree.map(np.asarray, jcache))
    got = convert.cache_to_numpy(cache)
    for b, c in jcache.items():
        for n, a in c.items():
            assert cache[b][n].dtype == getattr(torch, str(a.dtype))
            np.testing.assert_array_equal(got[b][n], np.asarray(a, np.float32))
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    want, jcache = _j_decode(jcfg, jparams, jcache, tok, jnp.asarray(S, jnp.int32))
    out, cache = Md.decode_step(cfg, params, cache, torch.from_numpy(np.array(tok)), S)
    atol = ATOL if f32 else BF16_ATOL[name][0]
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=RTOL if f32 else 0,
                               atol=atol)


def _batch_like_reference_test(cfg, B_, S_, seed=0):
    """`tests/test_models.py::_batch`'s inputs, as numpy."""
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab, size=(B_, S_ + 1)).astype(np.int32)
    b = {"tokens": toks[:, :-1]}
    if cfg.family == "encdec":
        b["frames"] = (rng.randn(B_, S_, cfg.d_model).astype(np.float32) * 0.02)
    if cfg.family == "vlm":
        b["memory"] = (rng.randn(B_, cfg.n_memory, cfg.d_model).astype(np.float32) * 0.02)
    return b


def decode_vs_forward(cfg, params, batch, pfx):
    """(teacher-forced decode logits [S - pfx, V], the forward pass's
    logits at those positions), both f32 numpy."""
    dev = params.device
    tb = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    S_ = tb["tokens"].shape[1]
    pf = {"tokens": tb["tokens"][:, :pfx], **{k: tb[k] for k in ("frames", "memory")
                                               if k in tb}}
    _, cache = Md.prefill(cfg, params, pf, max_len=S_ + 2)
    got = []
    for t in range(pfx, S_):
        logits, cache = Md.decode_step(cfg, params, cache, tb["tokens"][:, t:t + 1], t)
        got.append(logits[0, 0])
    with torch.no_grad():
        x = T.embed_tokens(cfg, params["tok"], tb["tokens"])
        if cfg.pos_embed == "sinusoidal":
            x = x + Md._sinusoidal(S_, cfg.d_model, x.dtype, dev)[None]
        memory = Md._encode_memory(cfg, params, tb)
        x, _ = T.stack_apply_train(cfg, params["stack"], x, cfg.pattern, memory=memory)
        x = T._apply_norm(cfg, params["final_norm"], x)
        ref = x.float() @ T._unembed_matrix(cfg, params["tok"]).float()
    return torch.stack(got).cpu().numpy(), ref[0, pfx:].cpu().numpy()


@pytest.mark.parametrize("name", ["gemma-2b", "mamba2-370m", "qwen3-moe-30b-a3b",
                                  "jamba-1.5-large-398b"])
def test_decode_matches_forward(name):
    """The port alone (its own random weights): token-by-token decode
    reproduces the forward pass's next-token logits position by position,
    as the reference's `test_models.py::test_decode_matches_forward`."""
    cfg = dataclasses.replace(get_reduced(name), **F32, moe_capacity_factor=8.0)
    params = Md.init_params(cfg, 0, device="cpu")
    got, want = decode_vs_forward(cfg, params, _batch_like_reference_test(cfg, 1, 12), 4)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("name", all_arch_names())
def test_param_counts_match_reference(name):
    """The published configs' parameter counts, counted on the meta device
    (jamba's 398 B included), equal the reference's `eval_shape` counts."""
    want, got = jget_config(name), get_config(name)
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("name", all_arch_names())
def test_config_fields_match_reference(name, reduced):
    want = jget_reduced(name) if reduced else jget_config(name)
    got = get_reduced(name) if reduced else get_config(name)
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]
    for f in dataclasses.fields(want):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.n_groups == want.n_groups
    assert dataclasses.astuple(got.attn_dims) == dataclasses.astuple(want.attn_dims)
    assert dataclasses.astuple(got.ssm_dims) == dataclasses.astuple(want.ssm_dims)
    assert [Md.shape_supported(got, s) for s in Md.SHAPES] == \
        [JMd.shape_supported(want, s) for s in JMd.SHAPES]


def test_registry_matches_reference():
    from repro import configs as jconfigs

    assert ARCHS == jconfigs.ARCHS and IDS == jconfigs.IDS
    assert Md.SHAPES == JMd.SHAPES


@pytest.mark.parametrize("name", ["whisper-medium", "jamba-1.5-large-398b",
                                  "llama-3.2-vision-90b"])
def test_init_shapes_and_scale_match_reference(name):
    """`init_params` gives the reference's leaves, shapes and dtypes (its
    `eval_shape`), `params_from_reference` carries them back bit for bit,
    dense weights have the reference's scale (std 1/sqrt(fan_in)), and
    `init_cache` the reference's cache layout."""
    jcfg, cfg = jget_reduced(name), get_reduced(name)
    want = jax.eval_shape(lambda k: JMd.init_params(jcfg, k), jax.random.PRNGKey(0))
    params = Md.init_params(cfg, 0, device="cpu")
    tree = _reference_tree(params)
    flat = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]  # noqa: E731
    g, w = flat(tree), flat(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        assert a.shape == b.shape and a.dtype == b.dtype, path
    back = convert.params_from_reference(cfg, tree)
    for a, b in zip(back.parameters(), params.parameters()):
        assert torch.equal(a, b)
    wq = params["stack"][0]["b0"]["attn"]["wq"] if "attn" in params["stack"][0]["b0"] else None
    if wq is not None:
        assert abs(float(wq.std()) * np.sqrt(cfg.d_model) - 1.0) < 0.1
    jc = jax.eval_shape(lambda: JMd.init_cache(jcfg, 3, 20))
    tc = Md.init_cache(cfg, 3, 20, device="cpu")
    assert {b: {n: (tuple(a.shape), str(a.dtype)) for n, a in c.items()} for b, c in jc.items()} \
        == {b: {n: (tuple(a.shape), str(a.dtype).replace("torch.", "")) for n, a in c.items()}
            for b, c in tc.items()}


def test_decode_step_reads_nothing_back(monkeypatch):
    """A decode step with a 0-d tensor position converts no tensor to a
    host value (no `.item()`, `int()`, `bool()`...): on the card each would
    be a synchronisation. The first step warms the host-side caches."""
    cfg = get_reduced("whisper-medium")  # sinusoidal positions, cross attention
    params = Md.init_params(cfg, 0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _inputs(cfg).items()}
    logits, cache = Md.prefill(cfg, params, batch, max_len=S + 4)
    tok = logits.argmax(-1)
    cur = torch.tensor(S)
    logits, cache = Md.decode_step(cfg, params, cache, tok, cur)

    def refuse(*a, **k):
        raise AssertionError("a decode step read a tensor back to the host")

    for attr in ("item", "tolist", "numpy", "__bool__", "__int__", "__index__", "__float__"):
        monkeypatch.setattr(torch.Tensor, attr, refuse)
    Md.decode_step(cfg, params, cache, tok, cur + 1)


def test_cast_once_per_model():
    """The compute-dtype copy is made once and reused; an in-place change of
    a master weight makes it anew."""
    cfg = get_reduced("gemma-2b")
    params = Md.init_params(cfg, 0, device="cpu")
    a = Md._cast(params, torch.bfloat16)
    assert Md._cast(params, torch.bfloat16) is a
    assert a["tok"]["embed"].dtype == torch.bfloat16
    with torch.no_grad():
        params["final_norm"]["scale"].add_(1.0)
    b = Md._cast(params, torch.bfloat16)
    assert b is not a and torch.equal(b["final_norm"]["scale"].float(),
                                      params["final_norm"]["scale"])
    assert Md._cast(params, torch.float32) is params


def test_build_model_bundle_and_the_slices_still_to_come():
    """`build_model`'s serving entries run (its cache layout is prefill's);
    `forward_train` gives a finite loss, prefill under a sharding policy
    (the mesh slice) serves as without one where the policy changes no
    number (gemma: no MoE), and with no card an entry point raises
    instead of falling back to the CPU."""
    cfg = get_reduced("gemma-2b")
    model = Md.build_model(cfg)
    assert model["config"] is cfg
    params = model["init_params"](0, device="cpu")
    tokens = torch.zeros((2, 5), dtype=torch.int32)
    logits, cache = model["prefill"](params, {"tokens": tokens}, 9)
    empty = model["init_cache"](2, 9, device="cpu")
    assert {b: {n: a.shape for n, a in c.items()} for b, c in cache.items()} == \
        {b: {n: a.shape for n, a in c.items()} for b, c in empty.items()}
    step = Md.make_serve_step(cfg)
    out, _ = step(params, cache, logits.argmax(-1), 5)
    assert out.shape == (2, 1, cfg.vocab) and torch.isfinite(out).all()
    loss, _ = model["forward_train"](params, {"tokens": tokens, "labels": tokens,
                                              "mask": torch.ones((2, 5))})
    assert loss.shape == () and torch.isfinite(loss)
    under_policy = cfg.with_policy(T.ShardingPolicy(tp_size=2, dp_size=2))
    for batch in (tokens, tokens[:1]):  # B 2 splits over data 2, B 1 does not
        got, got_cache = Md.prefill(under_policy, params, {"tokens": batch}, 9)
        want, want_cache = model["prefill"](params, {"tokens": batch}, 9)
        assert torch.equal(got, want)
        assert all(torch.equal(got_cache[b][n], want_cache[b][n]) for b in want_cache
                   for n in want_cache[b])
    if not torch.cuda.is_available():  # no quiet fallback to the CPU
        with pytest.raises(RuntimeError, match="CUDA"):
            Md.init_params(cfg, 0)


def test_lm_serve_cli_on_cpu(capsys):
    seqs = lm_serve.main(["--arch", "jamba-1.5-large-398b", "--device", "cpu",
                          "--batch", "2", "--prompt-len", "8", "--tokens", "5"])
    out = capsys.readouterr().out
    assert seqs.shape == (2, 5) and seqs.dtype == np.int32
    assert "decoded 5 tokens x 2 seqs" in out and "greedy continuations" in out
    assert len(out.strip().splitlines()) == 4


def test_lm_serve_greedy_loop_is_the_decode_loop():
    """The CLI's loop (tensor position, token kept on the device) gives the
    tokens of prefill + decode_step driven with Python ints."""
    seqs = lm_serve.main(["--arch", "granite-moe-3b-a800m", "--device", "cpu",
                          "--batch", "2", "--prompt-len", "6", "--tokens", "4"])
    cfg = get_reduced("granite-moe-3b-a800m")
    params = Md.init_params(cfg, 0, device="cpu")
    rng = np.random.RandomState(0)
    tokens = torch.as_tensor(rng.randint(0, cfg.vocab, (2, 6)), dtype=torch.int32)
    logits, cache = Md.prefill(cfg, params, {"tokens": tokens}, max_len=6 + 4 + 1)
    out = []
    for t in range(4):
        tok = logits.argmax(-1).to(torch.int32)
        out.append(tok[:, 0])
        if t < 3:
            logits, cache = Md.decode_step(cfg, params, cache, tok, 6 + t)
    np.testing.assert_array_equal(seqs, torch.stack(out, 1).numpy())
