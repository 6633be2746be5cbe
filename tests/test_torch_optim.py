"""The port's optimizers and gradient compression (`repro_torch.optim`)
against the reference `repro.optim`, on the CPU: AdamW and Adafactor over
five updates of a tree with 1-, 2- and 3-axis leaves and a stack (the
reference's [G, ...] leaves, the port's list of groups), the cosine
schedule, `for_config`, `quantize`/`dequantize` bit for bit and
`compressed_psum` over a 4-shard group against the reference's formula;
then the reference's own properties on the port alone."""
import importlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from hypothesis_compat import given, settings, st

from repro.configs import get_reduced as jget_reduced
from repro.optim import compress as JC
from repro_torch import optim as TO
from repro_torch.configs import get_reduced
from repro_torch.launch import mesh as TM
from repro_torch.models.convert import tree_to_numpy
from repro_torch.optim import compress as TC
from jax_release import release_jax_programs  # noqa: F401  (frees compiled programs)

# the modules (each package's `adamw` name is the function)
JA = importlib.import_module("repro.optim.adamw")
TA = importlib.import_module("repro_torch.optim.adamw")

torch.set_num_threads(2)

G = 3  # groups of the stack


def _tree(seed):
    """(the port's tree, the reference's): plain leaves of 1, 2 and 3 axes
    and a stack of G groups holding a [d] scale, a [d, f] matrix and a
    [d, h, k] projection (the reference's leaves [G, ...])."""
    rng = np.random.RandomState(seed)
    f32 = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    groups = [{"b0": {"norm": {"scale": f32(6)}, "mlp": {"w": f32(6, 5)},
                      "attn": {"wq": f32(6, 2, 4)}}} for _ in range(G)]
    port = {"tok": {"embed": f32(7, 6)}, "final_norm": {"scale": f32(6)},
            "proj": {"w3": f32(2, 3, 4)},
            "stack": [{b: {k: {n: torch.from_numpy(a) for n, a in v.items()}
                           for k, v in blk.items()} for b, blk in g.items()} for g in groups]}
    port = {k: (v if k == "stack" else {n: torch.from_numpy(a) for n, a in v.items()})
            for k, v in port.items()}
    ref = jax.tree.map(jnp.asarray, tree_to_numpy(port))
    return port, ref


def _assert_tree(got, want, rtol, atol, tag):
    g = jax.tree_util.tree_flatten_with_path(got)[0]
    w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in g] == [p for p, _ in w], tag
    for (path, a), (_, b) in zip(g, w):
        assert np.shape(a) == np.shape(b), (tag, path)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol,
                                   err_msg=f"{tag} {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_matches_reference(name):
    """Five updates from the same params, gradients and schedule: params
    and optimizer state within rtol 1e-5 / atol 1e-6 (f32; the norms'
    and means' sums differ in order only), the state in the reference's
    shapes (Adafactor's stacked [G, d] scale factored into r [G], c [d]),
    and the port's masters written in place."""
    sched = (JA.cosine_schedule(1e-2, 2, 5), TA.cosine_schedule(1e-2, 2, 5))
    jopt = getattr(JA, name)(schedule=sched[0])
    topt = getattr(TA, name)(schedule=sched[1])
    params, jparams = _tree(0)
    jstate, tstate = jopt.init(jparams), topt.init(params)
    _assert_tree(jax.tree.map(np.shape, tree_to_numpy(tstate)),
                 jax.tree.map(np.shape, jstate), 0, 0, "state shapes")
    master = params["stack"][1]["b0"]["mlp"]["w"]
    jupdate = jax.jit(jopt.update)  # one compile (eager, each op compiles alone)
    for step in range(5):
        grads, jgrads = _tree(10 + step)
        jparams, jstate = jupdate(jgrads, jstate, jparams, jnp.asarray(step, jnp.int32))
        out, tstate = topt.update(grads, tstate, params, torch.tensor(step, dtype=torch.int32))
        assert out is params
    assert params["stack"][1]["b0"]["mlp"]["w"] is master and master._version > 0
    _assert_tree(tree_to_numpy(params), jparams, 1e-5, 1e-6, "params")
    _assert_tree(tree_to_numpy(tstate), jstate, 1e-5, 1e-6, "state")


def test_global_norm_sums_in_the_reference_leaf_order():
    """`_global_norm` over the stacked view: the reference's value within
    rtol 1e-6 (each stacked leaf's groups summed one by one, then added),
    and `_clip` the reference's clipped tree."""
    grads, jgrads = _tree(3)
    got = float(TA._global_norm(grads))
    want = float(JA._global_norm(jgrads))
    assert got == pytest.approx(want, rel=1e-6)
    scale = TA._clip_scale(grads, 1.0)
    assert float(scale) == pytest.approx(1.0 / want, rel=1e-6)
    _assert_tree(tree_to_numpy(TA._clip(grads, 1.0)), JA._clip(jgrads, 1.0), 1e-6, 1e-7,
                 "clipped")


@pytest.mark.parametrize("step", [0, 5, 10, 55, 100])
def test_cosine_schedule_matches_reference(step):
    """0, mid-warmup, warmup, mid-decay and total: the reference's f32 value
    within 1 ulp (cos in either library), from a Python int and from a 0-d
    int32 tensor."""
    want = float(JA.cosine_schedule(1e-3, warmup=10, total=100)(step))
    lr = TA.cosine_schedule(1e-3, warmup=10, total=100)
    for s in (step, torch.tensor(step, dtype=torch.int32)):
        got = lr(s)
        assert got.dtype == torch.float32 and got.shape == ()
        assert float(got) == pytest.approx(want, rel=2e-7, abs=1e-12)


def test_for_config_picks_the_configs_optimizer():
    """jamba's Adafactor (factored state), the others' AdamW (m, v), with
    the reference's defaults."""
    for name in ("jamba-1.5-large-398b", "gemma-2b"):
        got = TA.for_config(get_reduced(name)).init({"w": torch.zeros(4, 3)})
        want = JA.for_config(jget_reduced(name)).init({"w": jnp.zeros((4, 3))})
        assert jax.tree.map(np.shape, tree_to_numpy(got)) == jax.tree.map(np.shape, want)
    assert TO.adamw.__defaults__ == JA.adamw.__defaults__
    assert TO.adafactor.__defaults__ == JA.adafactor.__defaults__


def test_quantize_dequantize_bitwise():
    """Halves (round half to even at x / scale = ±0.5, ±1.5, ±2.5), zeros,
    the clip at ±127 and an all-zero tensor (scale 1): int8 grid, scale
    and dequantized values the reference's bit for bit."""
    rng = np.random.RandomState(0)
    halves = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 0.0, -0.0, 127.0, -127.0],
                      np.float32)
    cases = [halves, rng.randn(257).astype(np.float32) * 3.0, np.zeros(9, np.float32),
             (rng.randn(4, 33) * 1e-3).astype(np.float32)]
    for x in cases:
        jq, js = JC.quantize(jnp.asarray(x))
        tq, ts = TC.quantize(torch.from_numpy(x))
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert ts.numpy().tobytes() == np.asarray(js).tobytes()
        np.testing.assert_array_equal(TC.dequantize(tq, ts).numpy(),
                                      np.asarray(JC.dequantize(jq, js)))


def _reference_compressed(gs, rs):
    """The reference's `compressed_psum` body for one leaf over shards
    (its `quantize` on the shared scale, integer sums in int32)."""
    g_fb = [jnp.asarray(g) + jnp.asarray(r) for g, r in zip(gs, rs)]
    amax = jnp.max(jnp.stack([jnp.max(jnp.abs(g)) for g in g_fb]))
    scale = jnp.where(amax > 0, amax / 127.0, 1.0)
    qs = [jnp.clip(jnp.round(g / scale), -127, 127).astype(jnp.int8) for g in g_fb]
    summed = sum(q.astype(jnp.int32) for q in qs)
    mean = summed.astype(jnp.float32) * scale / len(gs)
    return np.asarray(mean), [np.asarray(g - JC.dequantize(q, scale)) for g, q in zip(g_fb, qs)]


def test_compressed_psum_matches_reference_formula():
    """Over a 4-shard data group of the port's mesh (`mesh.over`), two
    steps with the residual fed back: every shard's mean and residual the
    reference formula's bit for bit, the mean within scale / 2 of the
    true mean."""
    mesh = TM.make_host_mesh(data=4, model=1, device="cpu")
    rng = np.random.RandomState(0)
    resid = {s: {"w": torch.zeros(5, 3), "b": [torch.zeros(7)]} for s in range(4)}
    want_r = {s: {"w": np.zeros((5, 3), np.float32), "b": np.zeros(7, np.float32)}
              for s in range(4)}
    for _ in range(2):
        g = {s: {"w": rng.randn(5, 3).astype(np.float32),
                 "b": (rng.randn(7) * 10).astype(np.float32)} for s in range(4)}
        grads = {s: {"w": torch.from_numpy(v["w"]), "b": [torch.from_numpy(v["b"])]}
                 for s, v in g.items()}
        mean, resid = TM.over(mesh, "data", TC.compressed_psum, grads, resid)
        for leaf in ("w", "b"):
            wm, wr = _reference_compressed([g[s][leaf] for s in range(4)],
                                           [want_r[s][leaf] for s in range(4)])
            for s in range(4):
                got_m = mean[s][leaf] if leaf == "w" else mean[s][leaf][0]
                got_r = resid[s][leaf] if leaf == "w" else resid[s][leaf][0]
                np.testing.assert_array_equal(got_m.numpy(), wm)
                np.testing.assert_array_equal(got_r.numpy(), wr[s])
                want_r[s][leaf] = wr[s]
            true = np.mean([g[s][leaf] for s in range(4)], 0)
            bound = max(np.abs(g[s][leaf]).max() for s in range(4)) / 127
            assert np.abs(wm - true).max() <= 2 * bound


def test_compressed_psum_without_residual_and_pmax():
    grads = [{"w": torch.tensor([1.0, -2.0])}, {"w": torch.tensor([3.0, 0.5])}]
    mean, resid = TC.compressed_psum(grads)
    assert len(mean) == len(resid) == 2
    torch.testing.assert_close(mean[0]["w"], torch.tensor([2.0, -0.75]), atol=3 / 254,
                               rtol=0)
    assert torch.equal(mean[0]["w"], mean[1]["w"])
    hi = TM.pmax([torch.tensor([1.0, 5.0]), torch.tensor([3.0, -1.0])])
    assert all(torch.equal(h, torch.tensor([3.0, 5.0])) for h in hi)


# --- the reference's properties, on the port alone ------------------------------


@pytest.mark.parametrize("make", [TA.adamw, TA.adafactor], ids=["adamw", "adafactor"])
def test_optimizer_descends_quadratic(make):
    opt = make(lr=0.1)
    params = {"w": torch.from_numpy(np.random.RandomState(0).randn(8, 4).astype(np.float32)),
              "b": torch.from_numpy(np.random.RandomState(1).randn(4).astype(np.float32))}
    state = opt.init(params)

    def loss(p):
        return torch.sum(p["w"] ** 2) + torch.sum(p["b"] ** 2)

    l0 = float(loss(params))
    for step in range(50):
        g = {k: 2 * v for k, v in params.items()}
        params, state = opt.update(g, state, params, step)
    assert float(loss(params)) < 0.05 * l0


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), scale=st.floats(1e-6, 1e4))
def test_quantize_roundtrip_error_bound(seed, scale):
    x = np.random.RandomState(seed).randn(64).astype(np.float32) * scale
    q, s = TC.quantize(torch.from_numpy(x))
    back = TC.dequantize(q, s).numpy()
    assert np.abs(back - x).max() <= float(s) * 0.5 + 1e-12


def test_error_feedback_converges():
    """EF-compressed SGD must track uncompressed SGD on a quadratic."""
    w = torch.ones(32) * 5.0
    w_ref = torch.ones(32) * 5.0
    resid = torch.zeros(32)
    for _ in range(200):
        g = 2 * w
        g_fb = g + resid
        q, s = TC.quantize(g_fb)
        g_hat = TC.dequantize(q, s)
        resid = g_fb - g_hat
        w = w - 0.01 * g_hat
        w_ref = w_ref - 0.01 * (2 * w_ref)
    np.testing.assert_allclose(w.numpy(), w_ref.numpy(), atol=0.05)
