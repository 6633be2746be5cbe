"""The port's engine against the reference: state init and the numpy
round trip, `evolve_block` trajectories (state, history, counters)
bitwise, and the elite cache and block partition as internal bitwise
contracts. Session-level tests are in test_torch_session.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core import fitness as jfit
from repro.core import primitives as jprim
from repro.core import trees as jtrees
from repro_torch.core import engine as tengine
from repro_torch.core import fitness as tfit
from repro_torch.core import primitives as tprim
from repro_torch.core import prng
from repro_torch.core import trees as ttrees
from repro_torch.data import datasets as tdata
from jax_release import release_jax_programs  # noqa: F401  (frees compiled programs)

torch.set_num_threads(2)


def _configs(case, **kw):
    """(reference cfg, port cfg, X f32[F, D], y): 'lattice' is add/sub/mul
    trees on small-integer data with kernel r (every sum exact);
    'kat7' is a 256-row kat7 prefix, CLASSIFY_SET, kernel c."""
    if case == "lattice":
        rng = np.random.RandomState(0)
        X = rng.randint(-2, 3, size=(4, 96)).astype(np.float32)
        y = rng.randint(-2, 3, size=96).astype(np.float32)
        names, fk, tree_kw, pop = ("add", "sub", "mul"), dict(kernel="r"), dict(
            max_depth=3, p_const=0.0), 32
        jfs, tfs = jprim.FunctionSet.make(names), tprim.FunctionSet.make(names)
    else:
        Xr, y, _ = tdata.kat7()
        X, y = np.ascontiguousarray(Xr[:256].T), y[:256]
        fk, tree_kw, pop = dict(kernel="c", n_classes=2), dict(max_depth=5), 50
        jfs, tfs = jprim.CLASSIFY_SET, tprim.CLASSIFY_SET
    F = X.shape[0]
    jcfg = jengine.GPConfig(pop_size=pop, fitness=jfit.FitnessSpec(**fk),
                            tree_spec=jtrees.TreeSpec(n_features=F, fn_set=jfs,
                                                      **tree_kw), **kw)
    tcfg = tengine.GPConfig(pop_size=pop, fitness=tfit.FitnessSpec(**fk),
                            tree_spec=ttrees.TreeSpec(n_features=F, fn_set=tfs,
                                                      **tree_kw),
                            eval_impl="cuda", **kw)
    return jcfg, tcfg, X, y


def _assert_state_equal(jstate, tstate):
    got = tengine.state_to_numpy(tstate)
    for name, leaf in jstate._asdict().items():
        want = np.asarray(leaf)
        assert got[name].dtype == want.dtype, name
        np.testing.assert_array_equal(got[name], want, err_msg=f"GPState.{name}")


def test_init_state_and_numpy_round_trip():
    jcfg, tcfg, _, _ = _configs("kat7")
    jstate = jengine.init_state(jcfg, jax.random.PRNGKey(11))
    tstate = tengine.init_state(tcfg, prng.PRNGKey(11), device="cpu")
    _assert_state_equal(jstate, tstate)
    back = tengine.state_from_numpy(jstate, device="cpu")
    _assert_state_equal(jstate, back)
    again = tengine.state_from_numpy(tengine.state_to_numpy(back), device="cpu")
    for a, b in zip(back, again):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["lattice", "kat7"])
def test_evolve_block_bitwise_vs_reference(case):
    """Two K=5 blocks from the same state: state, history and counters
    equal the reference's bit for bit."""
    jcfg, tcfg, X, y = _configs(case)
    jstate = jengine.init_state(jcfg, jax.random.PRNGKey(5))
    tstate = tengine.state_from_numpy(jstate, device="cpu")
    Xj, yj = jnp.asarray(X), jnp.asarray(y)
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y)
    for _ in range(2):
        jstate, jh, jc = jengine.evolve_block(jcfg, jstate, Xj, yj, None, n_steps=5)
        tstate, th, tc = tengine.evolve_block(tcfg, tstate, Xt, yt, None, n_steps=5)
        _assert_state_equal(jstate, tstate)
        np.testing.assert_array_equal(np.asarray(jh), th.numpy())
        np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    assert tc.dtype == torch.int32 and tc.shape == (5, 7)


def test_elite_cache_on_off_bitwise():
    import dataclasses

    _, tcfg, X, y = _configs("kat7")
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y)
    out = []
    for cache in (True, False):
        cfg = dataclasses.replace(tcfg, elite_cache=cache)
        s = tengine.init_state(cfg, prng.PRNGKey(2), device="cpu")
        s, h, c = tengine.evolve_block(cfg, s, Xt, yt, None, n_steps=6)
        out.append((s, h, c))
    (s1, h1, c1), (s0, h0, c0) = out
    for name in ("key", "op", "arg", "fitness", "best_op", "best_arg",
                 "best_fitness", "generation"):
        assert torch.equal(getattr(s1, name), getattr(s0, name)), name
    assert torch.equal(h1, h0)
    assert int(c1[1:, 0].sum()) == 5 and int(c0[:, 1].sum()) == 0  # hits/queries


def test_block_equals_steps_and_partition():
    """K block steps == K single steps, and 3+3 == 6, bit for bit; a
    limit freezes the tail steps (key and generation included)."""
    _, tcfg, X, y = _configs("lattice")
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y)
    s0 = tengine.init_state(tcfg, prng.PRNGKey(4), device="cpu")
    s_step = s0
    for _ in range(6):
        s_step = tengine.evolve_step(tcfg, s_step, Xt, yt)
    s_blk, h6, _ = tengine.evolve_block(tcfg, s0, Xt, yt, None, n_steps=6)
    s_a, h_a, _ = tengine.evolve_block(tcfg, s0, Xt, yt, None, n_steps=3)
    s_b, h_b, _ = tengine.evolve_block(tcfg, s_a, Xt, yt, None, n_steps=3)
    for a, b, c in zip(s_step, s_blk, s_b):
        assert torch.equal(a, b) and torch.equal(b, c)
    assert torch.equal(h6, torch.cat([h_a, h_b]))
    lim = torch.tensor(2, dtype=torch.int32)
    s_l, h_l, c_l = tengine.evolve_block(tcfg, s0, Xt, yt, None, lim, n_steps=6)
    s_2, _, _ = tengine.evolve_block(tcfg, s0, Xt, yt, None, n_steps=2)
    for a, b in zip(s_l, s_2):  # frozen steps carried the state unchanged
        assert torch.equal(a, b)
    assert c_l[:, 2].tolist() == [0, 0, 1, 1, 1, 1]
    assert torch.equal(h_l[2:], h_l[1].expand(4))


def _postfix_configs(dedup, cap):
    """(reference cfg, port cfg, X, y): postfix genomes of depth 4 on
    lattice data (add/sub/mul, small integers, kernel r), pop 16, two
    elites; every sum is exact, so trajectories compare bitwise."""
    rng = np.random.RandomState(1)
    X = rng.randint(-2, 3, size=(3, 96)).astype(np.float32)
    y = rng.randint(-2, 3, size=96).astype(np.float32)
    names = ("add", "sub", "mul")
    tree_kw = dict(max_depth=4, n_features=3, p_const=0.0, genome="postfix")
    kw = dict(pop_size=16, elitism=2, dedup=dedup, dedup_cap=cap)
    jcfg = jengine.GPConfig(tree_spec=jtrees.TreeSpec(
        fn_set=jprim.FunctionSet.make(names), **tree_kw), eval_impl="pallas", **kw)
    tcfg = tengine.GPConfig(tree_spec=ttrees.TreeSpec(
        fn_set=tprim.FunctionSet.make(names), **tree_kw), eval_impl="cuda", **kw)
    return jcfg, tcfg, X, y


@pytest.mark.parametrize("dedup,cap", [("off", 0), ("exact", 0), ("exact", 20),
                                       ("exact", 100_000)])
def test_postfix_evolve_block_bitwise_vs_reference(dedup, cap):
    """Postfix `evolve_block` against the reference's Pallas path: state,
    history and the counter stream (dedup columns included) bit for bit,
    with dedup off, with a cap that overflows (20) and two that do not.
    The reference runs its B2/B3 kernels in interpret mode."""
    jcfg, tcfg, X, y = _postfix_configs(dedup, cap)
    jstate = jengine.init_state(jcfg, jax.random.PRNGKey(5))
    _assert_state_equal(jstate, tengine.init_state(tcfg, prng.PRNGKey(5), device="cpu"))
    tstate = tengine.state_from_numpy(jstate, device="cpu")
    Xj, yj = jnp.asarray(X), jnp.asarray(y)
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y)
    for _ in range(2):
        jstate, jh, jc = jengine.evolve_block(jcfg, jstate, Xj, yj, None, n_steps=4)
        tstate, th, tc = tengine.evolve_block(tcfg, tstate, Xt, yt, None, n_steps=4)
        _assert_state_equal(jstate, tstate)
        np.testing.assert_array_equal(np.asarray(jh), th.numpy())
        np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    ttrees.check_invariants(tstate.op, tcfg.tree_spec)
    uniq = tc[:, 6]
    assert (uniq > 0).all() if dedup == "exact" else (uniq == 0).all()
    if cap == 20:
        assert (tc[:, 5] == 0).all()  # overflow: nothing saved


def test_postfix_state_carried_in_and_dedup_on_off():
    """A reference postfix GPState carries in through state_from_numpy bit
    for bit and back out; from it, the port's dedup on and off runs are
    bitwise equal in everything but the dedup counter columns."""
    import dataclasses

    jcfg, tcfg, X, y = _postfix_configs("exact", 0)
    jstate = jengine.init_state(jcfg, jax.random.PRNGKey(8))
    tstate = tengine.state_from_numpy(jstate, device="cpu")
    _assert_state_equal(jstate, tstate)
    for name, leaf in tengine.state_to_numpy(tstate).items():
        np.testing.assert_array_equal(leaf, np.asarray(getattr(jstate, name)))
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y)
    s_on, h_on, c_on = tengine.evolve_block(tcfg, tstate, Xt, yt, None, n_steps=5)
    off = dataclasses.replace(tcfg, dedup="off")
    s_off, h_off, c_off = tengine.evolve_block(off, tstate, Xt, yt, None, n_steps=5)
    for a, b in zip(s_on, s_off):
        assert torch.equal(a, b)
    assert torch.equal(h_on, h_off) and torch.equal(c_on[:, :5], c_off[:, :5])
