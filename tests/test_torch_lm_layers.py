"""Each layer of the port's model zoo (`repro_torch.models.{layers,ssm,moe}`)
against its reference in `repro.models`, on the CPU, on the same numpy
inputs: norms, RoPE, chunked attention (causal and full, MQA and GQA,
ragged q and kv), single-token decode attention with its clamped write,
the MLPs, MoE routing and combine, and the SSD scan, block and decode.
Tolerances are stated per test: f32 sums differ between the frameworks in
order only."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro.models import moe as JM
from repro.models import ssm as JS
from repro_torch.models import layers as TL
from repro_torch.models import moe as TM
from repro_torch.models import ssm as TS
from repro_torch.models.convert import _tensor
from jax_release import release_jax_programs  # noqa: F401  (frees compiled programs)

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)  # f32 layer outputs

# the reference's layers, each compiled once a shape (eager, each of their
# ops would compile on its own)
j_chunked_attention = jax.jit(JL.chunked_attention,
                              static_argnames=("causal", "q_chunk", "kv_chunk"))
j_attn_apply = jax.jit(JL.attn_apply, static_argnums=2,
                       static_argnames=("q_chunk", "kv_chunk"))
j_cross_attn_apply = jax.jit(JL.cross_attn_apply, static_argnums=4,
                             static_argnames=("q_chunk", "kv_chunk"))
j_attn_decode = jax.jit(JL.attn_decode, static_argnums=5)
j_moe_apply = jax.jit(JM.moe_apply, static_argnames=("top_k", "act", "capacity_factor"))
j_ssd_chunked = jax.jit(JS.ssd_chunked, static_argnames=("chunk",))
j_ssm_apply = jax.jit(JS.ssm_apply, static_argnums=2)
j_ssm_decode = jax.jit(JS.ssm_decode, static_argnums=4)


def _t(a):
    return _tensor(np.asarray(a), "cpu")


def _p(tree):
    return {k: _t(v) for k, v in tree.items()}


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               **(tol or TOL))


def _randn(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


@pytest.mark.parametrize("plus_one", [False, True])
def test_rms_norm(plus_one):
    x, s = _randn(2, 5, 32), _randn(32, seed=1)
    _close(TL.rms_norm(_t(x), _t(s), plus_one=plus_one),
           JL.rms_norm(jnp.asarray(x), jnp.asarray(s), plus_one=plus_one))


def test_layer_norm():
    x, s, b = _randn(2, 5, 32), _randn(32, seed=1), _randn(32, seed=2)
    _close(TL.layer_norm(_t(x), _t(s), _t(b)),
           JL.layer_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b)))


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope(theta):
    """Positions up to 40: the angles differ by the ulps of the two pows."""
    x = _randn(2, 40, 3, 16)
    pos = np.arange(40)
    _close(TL.rope(_t(x), torch.from_numpy(pos), theta=theta),
           JL.rope(jnp.asarray(x), jnp.asarray(pos), theta=theta), rtol=1e-5, atol=2e-5)


def test_gelu_is_the_tanh_form_and_softplus_is_logaddexp():
    """gelu: jax.nn.gelu's default (tanh); softplus: logaddexp(x, 0),
    bitwise-close in f32 over the range the model makes (dt + dt_bias),
    through F.softplus's switch to x at 20."""
    x = np.linspace(-40, 40, 4001, dtype=np.float32)
    _close(TL.gelu(_t(x)), jax.nn.gelu(jnp.asarray(x)), rtol=1e-6, atol=1e-6)
    _close(TS.softplus(_t(x)), jax.nn.softplus(jnp.asarray(x)), rtol=1e-7, atol=1e-7)


@pytest.mark.parametrize("heads", [(4, 1), (4, 2), (4, 4)], ids=["mqa", "gqa", "mha"])
@pytest.mark.parametrize("causal,lens", [(True, (16, 16)), (True, (13, 13)),
                                         (False, (16, 16)), (False, (13, 16)),
                                         (False, (16, 11)), (False, (20, 20))],
                         ids=["causal", "causal_ragged", "full", "full_ragged_q",
                              "full_ragged_kv", "full_ragged_both"])
def test_chunked_attention(causal, lens, heads):
    """q chunks of 8, kv chunks of 8: several chunks each way, the padded
    queries cut and the padded keys masked (whisper's 1,500 frames)."""
    (hq, hkv), (sq, sk) = heads, lens
    q, k, v = _randn(2, sq, hq, 8), _randn(2, sk, hkv, 8, seed=1), _randn(2, sk, hkv, 8, seed=2)
    got = TL.chunked_attention(_t(q), _t(k), _t(v), causal=causal, q_chunk=8, kv_chunk=8)
    want = j_chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                causal=causal, q_chunk=8, kv_chunk=8)
    _close(got, want)


def test_chunked_attention_with_positions_and_bf16():
    """Explicit positions (attn_apply passes them) and bf16 inputs: p is
    rounded to v's dtype before the PV product, as the reference's."""
    q, k, v = _randn(2, 12, 4, 8), _randn(2, 12, 2, 8, seed=1), _randn(2, 12, 2, 8, seed=2)
    pos = np.arange(12) + 3
    qb, kb, vb = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    got = TL.chunked_attention(_t(qb), _t(kb), _t(vb), causal=True, q_chunk=8, kv_chunk=8,
                               positions_q=torch.from_numpy(pos),
                               positions_k=torch.from_numpy(pos))
    want = j_chunked_attention(qb, kb, vb, causal=True, q_chunk=8, kv_chunk=8,
                                positions_q=jnp.asarray(pos), positions_k=jnp.asarray(pos))
    assert got.dtype == torch.bfloat16
    _close(got, want, rtol=1e-2, atol=1e-2)  # one bf16 rounding of the output


def _attn(n_kv, bias=False, seed=0):
    dims = JL.AttnDims(32, 4, n_kv, 8, qkv_bias=bias)
    p = JL.attn_init(jax.random.PRNGKey(seed), dims)
    if bias:
        p = {k: (v + 0.1 if k.startswith("b") else v) for k, v in p.items()}
    return dims, TL.AttnDims(32, 4, n_kv, 8, qkv_bias=bias), p


@pytest.mark.parametrize("n_kv,bias", [(1, False), (2, True), (4, False)])
def test_attn_apply_and_cross(n_kv, bias):
    dims, tdims, p = _attn(n_kv, bias)
    x, mem = _randn(2, 10, 32), _randn(2, 7, 32, seed=3)
    _close(TL.attn_apply(_p(p), _t(x), tdims, q_chunk=4, kv_chunk=4),
           j_attn_apply(p, jnp.asarray(x), dims, q_chunk=4, kv_chunk=4))
    ck, cv = JL.cross_kv(p, jnp.asarray(mem), dims)
    tk, tv = TL.cross_kv(_p(p), _t(mem), tdims)
    _close(tk, ck)
    _close(tv, cv)
    _close(TL.cross_attn_apply(_p(p), _t(x), tk, tv, tdims, q_chunk=4, kv_chunk=4),
           j_cross_attn_apply(p, jnp.asarray(x), ck, cv, dims, q_chunk=4, kv_chunk=4))


@pytest.mark.parametrize("n_heads,n_kv,tp", [(8, 2, 0), (8, 2, 4), (8, 1, 8), (6, 2, 4)])
def test_replicate_kv(n_heads, n_kv, tp):
    """KV heads repeated (each in place, not tiled) up to the TP degree when
    they do not divide it; unchanged on one device (tp = 0) or when the
    rule does not apply."""
    k, v = _randn(2, 3, n_kv, 4), _randn(2, 3, n_kv, 4, seed=1)
    jk, jv = JL.replicate_kv(jnp.asarray(k), jnp.asarray(v), n_heads, n_kv, tp)
    tk, tv = TL.replicate_kv(_t(k), _t(v), n_heads, n_kv, tp)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("n_kv", [1, 2])
@pytest.mark.parametrize("cur", [0, 5, 11, 12, 15])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_attn_decode_and_its_clamped_write(n_kv, cur, as_tensor):
    """The new row goes to `cur` clamped into [0, S-1] (`dynamic_update_slice`:
    cur = S - 1 writes the last row, cur = S and beyond write it too) while
    the mask reads positions <= cur; the cache is written in place."""
    dims, tdims, p = _attn(n_kv)
    S_max = 12
    x = _randn(2, 1, 32)
    ck, cv = _randn(2, S_max, n_kv, 8, seed=1), _randn(2, S_max, n_kv, 8, seed=2)
    o, nk, nv = j_attn_decode(p, jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv),
                               jnp.asarray(cur, jnp.int32), dims)
    tk, tv = _t(ck), _t(cv)
    cur_t = torch.tensor(cur) if as_tensor else cur
    to, tnk, tnv = TL.attn_decode(_p(p), _t(x), tk, tv, cur_t, tdims)
    assert tnk is tk and tnv is tv  # consumed: written in place
    _close(to, o)
    _close(tnk, nk, rtol=1e-6, atol=1e-6)
    _close(tnv, nv, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("gated", [True, False])
def test_mlp(act, gated):
    p = JL.mlp_init(jax.random.PRNGKey(0), 16, 48, gated=gated)
    x = _randn(2, 5, 16)
    _close(TL.mlp_apply(_p(p), _t(x), act=act), JL.mlp_apply(p, jnp.asarray(x), act=act))


def _reference_route(logits, top_k, C):
    """The reference's routing, by its own lines (`moe.py:68-87`)."""
    probs = jax.nn.softmax(logits, axis=-1)
    _, gate_e = jax.lax.top_k(probs, top_k)
    flat_e = gate_e.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    se = flat_e[order]
    E = logits.shape[-1]
    counts = jnp.zeros((E,), jnp.int32).at[flat_e].add(1)
    starts = jnp.cumsum(counts) - counts
    pos = jnp.arange(flat_e.shape[0]) - starts[se]
    return np.asarray(gate_e), np.asarray(order), np.asarray(pos < C)


@pytest.mark.parametrize("factor", [8.0, 1.0])
@pytest.mark.parametrize("act,gated", [("silu", True), ("gelu", False)])
def test_moe_apply(factor, act, gated):
    """Routing (experts, sort order, kept entries) bitwise; the output and
    aux loss within f32 tolerance; at capacity factor 1.0 some entries are
    dropped, the same ones; two calls give the same bits."""
    d, ff, E, k = 16, 32, 4, 2
    p = JM.moe_init(jax.random.PRNGKey(1), d, ff, E, gated=gated)
    x = _randn(4, 16, d, seed=1)
    y, aux = j_moe_apply(p, jnp.asarray(x), top_k=k, act=act, capacity_factor=factor)
    tp = _p(p)
    ty, taux = TM.moe_apply(tp, _t(x), top_k=k, act=act, capacity_factor=factor)
    _close(ty, y)
    np.testing.assert_allclose(float(taux), float(aux), rtol=1e-6)
    T = x.shape[0] * x.shape[1]
    C = TM.capacity(T, k, E, factor)
    assert C == JM.capacity(T, k, E, factor)
    logits = x.reshape(T, d) @ np.asarray(p["router"])
    tl = _t(x).reshape(T, d) @ tp["router"]
    _, _, gate_e, order, keep, _ = TM._route(tl, k, C, E)
    we, wo, wk = _reference_route(jnp.asarray(logits), k, C)
    np.testing.assert_array_equal(gate_e.numpy(), we)
    np.testing.assert_array_equal(order.numpy(), wo)
    np.testing.assert_array_equal(keep.numpy(), wk)
    assert keep.all() == (factor == 8.0)
    again, _ = TM.moe_apply(tp, _t(x), top_k=k, act=act, capacity_factor=factor)
    assert torch.equal(again, ty)


def test_moe_combine_adds_in_sort_order_in_bf16():
    """bf16: each token's contributions are added in the stable sort's
    order with a rounding after each add; the reference's scatter-add
    does the same, so the combine matches it to bf16's resolution."""
    d, ff, E, k = 16, 32, 5, 3
    p = jax.tree.map(lambda a: a.astype(jnp.bfloat16),
                     JM.moe_init(jax.random.PRNGKey(2), d, ff, E))
    x = jnp.asarray(_randn(2, 8, d, seed=2), jnp.bfloat16)
    y, _ = j_moe_apply(p, x, top_k=k, capacity_factor=8.0)
    ty, _ = TM.moe_apply(_p(p), _t(x), top_k=k, capacity_factor=8.0)
    assert ty.dtype == torch.bfloat16
    _close(ty, y, rtol=2e-2, atol=2e-2)


def _ssd_inputs(b=2, l=16, h=4, p=8, g=2, n=16, seed=0):
    r = np.random.RandomState(seed)
    f = lambda *s, sc=0.5: (r.randn(*s) * sc).astype(np.float32)  # noqa: E731
    return (f(b, l, h, p), np.abs(f(b, l, h)), f(h, sc=0.3), f(b, l, g, n), f(b, l, g, n),
            f(h, sc=1.0), f(b, h, n, p))


@pytest.mark.parametrize("l,with_h0", [(16, False), (13, False), (16, True), (11, True)])
def test_ssd_chunked(l, with_h0):
    """Chunks of 4; a ragged L pads with dt = 0 steps; h0 carries a state in."""
    x, dt, A, Bm, Cm, D, h0 = _ssd_inputs(l=l)
    y, fin = j_ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm, D)), chunk=4,
                            h0=jnp.asarray(h0) if with_h0 else None)
    ty, tfin = TS.ssd_chunked(*(_t(a) for a in (x, dt, A, Bm, Cm, D)), chunk=4,
                              h0=_t(h0) if with_h0 else None)
    _close(ty, y, rtol=1e-5, atol=2e-5)
    _close(tfin, fin, rtol=1e-5, atol=2e-5)


def _ssm(scan_block=4096):
    kw = dict(d_model=32, d_state=16, headdim=8, n_groups=2, chunk=4, scan_block=scan_block)
    dims, tdims = JS.SSMDims(**kw), TS.SSMDims(**kw)
    p = JS.ssm_init(jax.random.PRNGKey(0), dims)
    p = dict(p, A_log=p["A_log"] + 0.5, D=p["D"] * 0.5, dt_bias=p["dt_bias"] - 0.5)
    return dims, tdims, p


@pytest.mark.parametrize("L,scan_block", [(12, 4096), (16, 8)], ids=["one_block", "macro"])
def test_ssm_apply(L, scan_block):
    """With scan_block 8 and L 16 the macro-block branch runs (two blocks
    carrying the state), as `ssm.py:176-195` for L > 4096."""
    dims, tdims, p = _ssm(scan_block)
    x = _randn(2, L, 32, scale=0.5)
    y, fin, tail = j_ssm_apply(p, jnp.asarray(x), dims)
    ty, tfin, ttail = TS.ssm_apply(_p(p), _t(x), tdims)
    _close(ty, y)
    _close(tfin, fin, rtol=1e-5, atol=2e-5)
    _close(ttail, tail)


def test_ssm_decode():
    """Three steps of the recurrence from a prefill's state and conv tail."""
    dims, tdims, p = _ssm()
    x = _randn(2, 12, 32, scale=0.5)
    _, st, conv = j_ssm_apply(p, jnp.asarray(x[:, :9]), dims)
    tst, tconv = _t(st), _t(conv)
    for t in range(9, 12):
        y, st, conv = j_ssm_decode(p, jnp.asarray(x[:, t:t + 1]), st, conv, dims)
        ty, tst, tconv = TS.ssm_decode(_p(p), _t(x[:, t:t + 1]), tst, tconv, tdims)
        _close(ty, y)
        _close(tst, st, rtol=1e-5, atol=2e-5)
        _close(tconv, conv)


def test_policy_is_refused_until_the_mesh_slice():
    """The mesh slice has come: a policy is accepted, its pins change no
    number (chunked attention, the SSD scan), `replicate_kv` repeats kv
    heads to the model axis as the reference's does, and the MoE's
    sharded path is taken where the reference's is."""
    from repro_torch.models.transformer import ShardingPolicy

    pol = ShardingPolicy(tp_size=4, dp_size=2)
    q, k = torch.randn(1, 8, 4, 8), torch.randn(1, 8, 1, 8)
    assert torch.equal(TL.chunked_attention(q, k, k, causal=True, q_chunk=4, kv_chunk=4,
                                            policy=pol),
                       TL.chunked_attention(q, k, k, causal=True, q_chunk=4, kv_chunk=4))
    for tp in (0, 1, 2, 4, 3):
        got = TL.replicate_kv(k, k, 4, 1, tp)[0]
        want = JL.replicate_kv(jnp.asarray(k.numpy()), jnp.asarray(k.numpy()), 4, 1, tp)[0]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    dims, tdims, p = _ssm()
    x = _t(_randn(2, 12, 32, scale=0.5))
    assert all(torch.equal(a, b) for a, b in zip(TS.ssm_apply(_p(p), x, tdims, policy=pol),
                                                 TS.ssm_apply(_p(p), x, tdims)))
    assert not TM.sharded_path_ok(None, (2, 4, 8), 4)
    assert TM.sharded_path_ok(ShardingPolicy(dp_size=2), (2, 4, 8), 4) == \
        JM.sharded_path_ok(ShardingPolicy(dp_size=2), (2, 4, 8), 4)
