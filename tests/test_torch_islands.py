"""The port's island model against the reference on the same seeds:
`IslandConfig` and the GPConfig aliases, the routing helpers
(`torus_grid`, `take_island`/`splice_island`, `island_elites`,
`migrate_local`), the batched threefry draws against `jax.vmap`, the
batched breeder, and whole island trajectories (engine blocks and
sessions) bit for bit on lattice data (add/sub/mul trees on
small-integer data, kernel r: every sum exact) and on kat7 under the hit
kernel c."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import GPConfig as JConfig
from repro.core import IslandConfig as JIslands
from repro.core import OperatorMix as JMix
from repro.core import engine as jengine
from repro.core import evolve as jev
from repro.core import fitness as jfit
from repro.core import islands as jisl
from repro.core import primitives as jprim
from repro.core import trees as jtrees
from repro.gp import GPSession as JSession
from repro.gp import SymbolicRegressor as JRegressor
from repro_torch.core import engine as tengine
from repro_torch.core import evolve as tev
from repro_torch.core import fitness as tfit
from repro_torch.core import islands as tisl
from repro_torch.core import primitives as tprim
from repro_torch.core import prng
from repro_torch.core import trees as ttrees
from repro_torch.data import datasets as tdata
from repro_torch.gp import GPSession, SymbolicRegressor
from jax_release import release_jax_programs  # noqa: F401  (frees compiled programs)

torch.set_num_threads(2)

MIXES = ((0.1, 0.1, 0.1, 0.7), (0.05, 0.05, 0.05, 0.85), (0.1, 0.3, 0.3, 0.3),
         (0.25, 0.25, 0.25, 0.25))
TOURN = (4, 10, 7, 3)
RATES = (0.1, 0.25, 0.5, 0.3)
LATTICE = dict(kernel="r", max_depth=3, p_const=0.0, fn_set="add,sub,mul")


def _lattice(rows=40, seed=4):
    rng = np.random.RandomState(seed)
    X = rng.randint(-2, 3, size=(rows, 2)).astype(np.float32)
    y = (X[:, 0] * X[:, 1] - X[:, 0] + rng.randint(-1, 2, size=rows)).astype(np.float32)
    return X, y


def _hetero(I):
    """(reference, port) heterogeneous island kwargs for I islands."""
    common = dict(islands=I, island_tourn_sizes=TOURN[:I], island_point_rates=RATES[:I])
    return ({**common, "island_mixes": tuple(JMix(*m) for m in MIXES[:I])},
            {**common, "island_mixes": tuple(tev.OperatorMix(*m) for m in MIXES[:I])})


def _assert_state_equal(jstate, tstate):
    got = tengine.state_to_numpy(tstate)
    for name, leaf in jstate._asdict().items():
        want = np.asarray(leaf)
        assert got[name].dtype == want.dtype, name
        np.testing.assert_array_equal(got[name], want, err_msg=f"GPState.{name}")


# --- IslandConfig and the GPConfig aliases -----------------------------------


def test_island_config_validation():
    for mod in (jisl, tisl):
        with pytest.raises(ValueError, match="topology"):
            mod.IslandConfig(topology="hypercube")
        with pytest.raises(ValueError, match="mixes"):
            mod.IslandConfig(islands=3, mixes=(tev.OperatorMix(),))
        with pytest.raises(ValueError, match="migrate_every"):
            mod.IslandConfig(migrate_every=0)
        with pytest.raises(ValueError, match="islands"):
            mod.IslandConfig(islands=0)
        with pytest.raises(ValueError, match="migrate_k"):
            mod.IslandConfig(migrate_k=-1)
    cfg = tengine.GPConfig(pop_size=4, island=tisl.IslandConfig(islands=2, migrate_k=8))
    with pytest.raises(ValueError, match="migrate_k"):
        tengine.init_state(cfg, prng.PRNGKey(0), device="cpu")
    t, j = tisl.IslandConfig(islands=3, tourn_sizes=[4, 9, 2], point_rates=[0.1, 0.2, 0.3]), \
        jisl.IslandConfig(islands=3, tourn_sizes=[4, 9, 2], point_rates=[0.1, 0.2, 0.3])
    assert t.tourn_sizes == (4, 9, 2) and hash(t) == hash(dataclasses.replace(t))
    np.testing.assert_array_equal(t.prob_table(tev.OperatorMix()), j.prob_table(JMix()))
    assert t.tourn_table(10)[0] == j.tourn_table(10)[0] == 9
    np.testing.assert_array_equal(t.tourn_table(10)[1], j.tourn_table(10)[1])
    np.testing.assert_array_equal(t.point_rate_table(), j.point_rate_table())


def test_legacy_migrate_aliases_fold_into_island_config():
    """The flat aliases fold into `island` exactly as the reference's do,
    and an explicit IslandConfig value beats a stale alias."""
    for C, I in ((JConfig, JIslands), (tengine.GPConfig, tisl.IslandConfig)):
        cfg = C(migrate_every=3, migrate_k=2)
        assert (cfg.island.migrate_every, cfg.island.migrate_k) == (3, 2)
        assert (cfg.migrate_every, cfg.migrate_k) == (3, 2)
        assert C(island=I(islands=2, migrate_every=7)).migrate_every == 7
        cfg3 = dataclasses.replace(cfg, island=I(islands=4, migrate_every=20))
        assert cfg3.island.migrate_every == 20 and cfg3.migrate_every == 20
        assert hash(cfg) == hash(C(migrate_every=3, migrate_k=2))


# --- routing helpers -----------------------------------------------------------


def test_torus_grid_matches_reference():
    for n in range(1, 17):
        assert tisl.torus_grid(n) == jisl.torus_grid(n)


def test_take_and_splice_island():
    """`take_island`/`splice_island` on an island state equal the
    reference's on the same state; splice(take) is the identity."""
    jcfg = JConfig(pop_size=6, tree_spec=jtrees.TreeSpec(max_depth=3, n_features=2),
                   island=JIslands(islands=3))
    jstate = jengine.init_state(jcfg, jax.random.PRNGKey(2))
    tstate = tengine.state_from_numpy(jstate, device="cpu")
    for idx in range(3):
        _assert_state_equal(jisl.take_island(jstate, idx), tisl.take_island(tstate, idx))
    sub_t = tisl.take_island(tstate, 0)
    sub_j = jisl.take_island(jstate, 0)
    _assert_state_equal(jisl.splice_island(jstate, 2, sub_j),
                        tisl.splice_island(tstate, 2, sub_t))
    for a, b in zip(tisl.splice_island(tstate, 1, tisl.take_island(tstate, 1)), tstate):
        assert torch.equal(a, b)


def test_island_elites_with_ties():
    """Tied fitness (kernel c gives many) resolves to the lower slot per
    island, as the reference's stable argsort."""
    rng = np.random.RandomState(0)
    I, P, N, k = 4, 12, 7, 3
    op = rng.randint(0, 9, size=(I, P, N)).astype(np.int32)
    arg = rng.randint(0, 9, size=(I, P, N)).astype(np.int32)
    fit = rng.randint(-3, 0, size=(I, P)).astype(np.float32)  # heavy ties
    fit[1, :] = 0.0
    want = jisl.island_elites(jnp.asarray(op), jnp.asarray(arg), jnp.asarray(fit), k)
    got = tisl.island_elites(torch.from_numpy(op), torch.from_numpy(arg),
                             torch.from_numpy(fit), k)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


@pytest.mark.parametrize("topology", ["ring", "torus", "broadcast-best"])
def test_migrate_local_matches_reference(topology):
    """Ring, torus (east/south alternating on the event's parity, on a
    2x2 and a 2x3 grid) and broadcast-best (the argmin island, first on
    ties) against the reference, on due and off-cycle generations."""
    rng = np.random.RandomState(1)
    for I in (4, 6):
        P, N, k = 5, 7, 2
        icfg_t = tisl.IslandConfig(islands=I, migrate_every=2, migrate_k=k, topology=topology)
        icfg_j = jisl.IslandConfig(islands=I, migrate_every=2, migrate_k=k, topology=topology)
        new_op = rng.randint(0, 50, size=(I, P, N)).astype(np.int32)
        new_arg = rng.randint(0, 50, size=(I, P, N)).astype(np.int32)
        e_op = rng.randint(100, 150, size=(I, k, N)).astype(np.int32)
        e_arg = rng.randint(100, 150, size=(I, k, N)).astype(np.int32)
        best = rng.randint(-2, 1, size=I).astype(np.float32)
        for gen in range(6):
            want = jisl.migrate_local(icfg_j, *map(jnp.asarray, (new_op, new_arg, e_op,
                                                                 e_arg)),
                                      jnp.asarray(gen, jnp.int32), jnp.asarray(best))
            got = tisl.migrate_local(icfg_t, *map(torch.from_numpy, (new_op, new_arg, e_op,
                                                                     e_arg)),
                                     torch.tensor(gen, dtype=torch.int32),
                                     torch.from_numpy(best))
            for w, g in zip(want, got):
                np.testing.assert_array_equal(np.asarray(w), g.numpy(),
                                              err_msg=f"I={I} gen={gen}")
            moved = not np.array_equal(got[0].numpy(), new_op)
            assert moved == (gen % 2 == 1)


# --- batched draws and breeding --------------------------------------------------


def test_batched_draws_match_jax_vmap():
    """Row i of each batched sampler is the single-key call on key i, as
    `jax.vmap` over the reference's sampler gives it."""
    jkeys = jnp.stack([jax.random.fold_in(jax.random.PRNGKey(3), i) for i in range(4)])
    tkeys = prng.key_from_numpy(np.asarray(jkeys))
    u32 = np.uint32
    shape = (6, 5)
    np.testing.assert_array_equal(np.asarray(jax.vmap(lambda k: jax.random.split(k, 5))(jkeys)),
                                  prng.split(tkeys, 5).numpy().astype(u32))
    np.testing.assert_array_equal(np.asarray(jax.vmap(lambda k: jax.random.fold_in(k, 9))(jkeys)),
                                  prng.fold_in(tkeys, 9).numpy().astype(u32))
    np.testing.assert_array_equal(
        np.asarray(jax.vmap(lambda k: jax.random.bits(k, shape))(jkeys)),
        prng.random_bits(tkeys, shape).numpy().astype(u32))
    np.testing.assert_array_equal(
        np.asarray(jax.vmap(lambda k: jax.random.uniform(k, shape))(jkeys)),
        prng.uniform(tkeys, shape).numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.vmap(lambda k: jax.random.randint(k, shape, 0, 13))(jkeys)),
        prng.randint(tkeys, shape, 0, 13).numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, shape))(jkeys)),
        prng.gumbel(tkeys, shape).numpy())
    rates = np.asarray(RATES, np.float32)
    np.testing.assert_array_equal(
        np.asarray(jax.jit(jax.vmap(lambda k, p: jax.random.bernoulli(k, p, shape)))(
            jkeys, jnp.asarray(rates))),
        prng.bernoulli(tkeys, torch.from_numpy(rates), shape).numpy())
    probs = np.stack([JMix(*m).probs() for m in MIXES])
    np.testing.assert_array_equal(
        np.asarray(jax.jit(jax.vmap(
            lambda k, p: jax.random.categorical(k, jnp.log(p), shape=(40,))))(
                jkeys, jnp.asarray(probs))),
        prng.categorical(tkeys, prng.xla_log(torch.from_numpy(probs)), (40,)).numpy())
    # a batched population draw is the per-key draws stacked
    spec_t, spec_j = ttrees.TreeSpec(max_depth=4, n_features=3), \
        jtrees.TreeSpec(max_depth=4, n_features=3)
    op, arg = ttrees.generate_population(tkeys, 9, spec_t)
    for i in range(4):
        jo, ja = jtrees.generate_population(jkeys[i], 9, spec_j)
        np.testing.assert_array_equal(np.asarray(jo), op[9 * i:9 * (i + 1)].numpy())
        np.testing.assert_array_equal(np.asarray(ja), arg[9 * i:9 * (i + 1)].numpy())


@pytest.mark.parametrize("genome", ["tree", "postfix"])
def test_island_breeder_matches_reference(genome):
    """One batched `make_island_breeder` step equals the reference's
    vmapped breeder on the same keys, population and tied fitness, with
    per-island mixes, tournament sizes and point rates."""
    I, P = 4, 16
    spec_t = ttrees.TreeSpec(max_depth=4, n_features=3, genome=genome)
    spec_j = jtrees.TreeSpec(max_depth=4, n_features=3, genome=genome)
    jkeys = jnp.stack([jax.random.fold_in(jax.random.PRNGKey(8), i) for i in range(I)])
    ops, args = zip(*(jtrees.generate_population(jax.random.fold_in(jax.random.PRNGKey(9), i),
                                                 P, spec_j) for i in range(I)))
    op, arg = jnp.stack(ops), jnp.stack(args)
    fit = jnp.asarray(np.random.RandomState(2).randint(-4, 0, size=(I, P)), jnp.float32)
    icfg = jisl.IslandConfig(islands=I, mixes=tuple(JMix(*m) for m in MIXES),
                             tourn_sizes=TOURN, point_rates=RATES)
    probs, (tmax, tourn), rates = (icfg.prob_table(JMix()), icfg.tourn_table(10),
                                   icfg.point_rate_table())
    jbreed = jev.make_island_breeder(spec_j, tmax, 1)
    want = jax.jit(jax.vmap(jbreed))(jkeys, op, arg, fit, jnp.asarray(probs),
                                     jnp.asarray(tourn), jnp.asarray(rates))
    tbreed = tev.make_island_breeder(spec_t, tmax, 1)
    got = tbreed(prng.key_from_numpy(np.asarray(jkeys)),
                 *(torch.from_numpy(np.array(a)) for a in (op, arg, fit, probs, tourn,
                                                             rates)))
    np.testing.assert_array_equal(np.asarray(want[0]), prng.key_to_numpy(got[0]))
    for w, g in zip(want[1:], got[1:]):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


# --- trajectories -------------------------------------------------------------------


def _engine_configs(case, topology):
    """(reference cfg, port cfg, X f32[F, D], y) for island engine runs:
    'lattice-*' is add/sub/mul trees on small-integer data (kernel r),
    'kat7' a 256-row kat7 prefix under kernel c (CLASSIFY_SET)."""
    jmix, tmix = _hetero(3)
    kw = dict(islands=3, migrate_every=2, migrate_k=2, topology=topology)
    jisland = JIslands(**kw, mixes=jmix["island_mixes"], tourn_sizes=TOURN[:3],
                       point_rates=RATES[:3])
    tisland = tisl.IslandConfig(**kw, mixes=tmix["island_mixes"], tourn_sizes=TOURN[:3],
                                point_rates=RATES[:3])
    if case == "kat7":
        Xr, y, _ = tdata.kat7()
        X, y = np.ascontiguousarray(Xr[:256].T), y[:256]
        fk, tree_kw, sets, rest = dict(kernel="c", n_classes=2), dict(max_depth=4), (
            jprim.CLASSIFY_SET, tprim.CLASSIFY_SET), {}
    else:
        Xr, y = _lattice()
        X = np.ascontiguousarray(Xr.T)
        genome = "postfix" if "postfix" in case else "tree"
        fk, tree_kw = dict(kernel="r"), dict(max_depth=3, p_const=0.0, genome=genome)
        sets = (jprim.FunctionSet.make(("add", "sub", "mul")),
                tprim.FunctionSet.make(("add", "sub", "mul")))
        rest = dict(dedup="off" if case.endswith("off") else "exact")
    F = X.shape[0]
    jcfg = jengine.GPConfig(pop_size=16, fitness=jfit.FitnessSpec(**fk), island=jisland,
                            tree_spec=jtrees.TreeSpec(n_features=F, fn_set=sets[0], **tree_kw),
                            **rest)
    tcfg = tengine.GPConfig(pop_size=16, fitness=tfit.FitnessSpec(**fk), island=tisland,
                            tree_spec=ttrees.TreeSpec(n_features=F, fn_set=sets[1], **tree_kw),
                            eval_impl="torch", **rest)
    return jcfg, tcfg, X, y


@pytest.mark.parametrize("case,topology", [("lattice", "ring"), ("kat7", "torus"),
                                           ("lattice-postfix-exact", "broadcast-best"),
                                           ("lattice-postfix-off", "torus")])
def test_island_evolve_block_bitwise_vs_reference(case, topology):
    """Two 3-generation blocks of a heterogeneous 3-island run: state,
    history f32[K, I] and counter rows (migrations and dedup columns
    included) equal the reference's bit for bit."""
    jcfg, tcfg, X, y = _engine_configs(case, topology)
    jstate = jengine.init_state(jcfg, jax.random.PRNGKey(5))
    tstate = tengine.init_state(tcfg, prng.PRNGKey(5), device="cpu")
    _assert_state_equal(jstate, tstate)
    Xj, yj = jnp.asarray(X), jnp.asarray(y)
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y)
    for _ in range(2):
        jstate, jh, jc = jengine.evolve_block(jcfg, jstate, Xj, yj, None, n_steps=3)
        tstate, th, tc = tengine.evolve_block(tcfg, tstate, Xt, yt, None, n_steps=3)
        _assert_state_equal(jstate, tstate)
        assert th.shape == (3, 3)
        np.testing.assert_array_equal(np.asarray(jh), th.numpy())
        np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    assert tc[:, 3].sum() > 0  # migrations were counted
    if case.endswith("exact"):
        assert (tc[:, 6] > 0).all()


def test_frozen_generations_do_not_migrate():
    """With migrate_every=1 and a stop bar reached at generation 1, an
    8-step block leaves the state where step 1 left it, and its frozen
    rows count no migration — as the reference's."""
    jcfg, tcfg, X, y = _engine_configs("lattice", "ring")
    jcfg = dataclasses.replace(jcfg, stop_fitness=1e9,
                               island=dataclasses.replace(jcfg.island, migrate_every=1))
    tcfg = dataclasses.replace(tcfg, stop_fitness=1e9,
                               island=dataclasses.replace(tcfg.island, migrate_every=1))
    jstate, jh, jc = jengine.evolve_block(jcfg, jengine.init_state(jcfg, jax.random.PRNGKey(0)),
                                          jnp.asarray(X), jnp.asarray(y), None, n_steps=8)
    t0 = tengine.init_state(tcfg, prng.PRNGKey(0), device="cpu")
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y)
    tstate, th, tc = tengine.evolve_block(tcfg, t0, Xt, yt, None, n_steps=8)
    _assert_state_equal(jstate, tstate)
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    np.testing.assert_array_equal(np.asarray(jh), th.numpy())
    one = tengine.evolve_step(tcfg, t0, Xt, yt)
    for a, b in zip(one, tstate):
        assert torch.equal(a, b)
    assert int(tstate.generation) == 1 and tc[0, 3] == 3
    assert (tc[1:, 3] == 0).all() and (tc[1:, 2] == 1).all()


@pytest.mark.parametrize("topology", ["ring", "torus", "broadcast-best"])
def test_island_session_matches_reference(topology):
    """GPSession(islands=4) with per-island mixes, tournament sizes and
    point rates walks the reference session's trajectory in ragged
    blocks (3, 3, 2): history, island_history, counters and champions."""
    X, y = _lattice()
    jkw, tkw = _hetero(4)
    kw = dict(pop_size=16, generations=8, migrate_every=2, migrate_k=2,
              island_topology=topology, block_size=3, **LATTICE)
    want = JSession(backend="jnp", **kw, **jkw).fit(X, y, key=jax.random.PRNGKey(2))
    got = GPSession(device="cpu", **kw, **tkw).fit(X, y, key=prng.PRNGKey(2))
    assert got.history == want.history
    np.testing.assert_array_equal(np.asarray(got.island_history),
                                  np.asarray(want.island_history))
    _assert_state_equal(want.state, got.state)
    for name in ("blocks", "host_syncs", "cache_hits", "cache_queries", "migrations",
                 "tree_evals", "frozen"):
        assert got.stats[name] == want.stats[name], name
    rows = np.asarray(got.counter_history)
    assert rows.shape == (8, 7)
    np.testing.assert_array_equal(rows[:, 3], [0, 4] * 4)  # due on odd generations
    assert got.islands == 4 and got.island_best_fitness.shape == (4,)
    np.testing.assert_array_equal(got.island_best_fitness,
                                  np.asarray(want.island_best_fitness))
    assert got.best_fitness == want.best_fitness
    assert got.best_expression() == want.best_expression()
    assert got.island_expressions() == want.island_expressions()
    np.testing.assert_array_equal(got.predict(X), np.asarray(want.predict(X)))


def test_migration_phase_stable_under_ragged_blocks():
    """Ragged block boundaries (callback period 3 against migrate_every 2)
    reproduce the monolithic run bit for bit (the monolithic block is
    held against the reference in the session tests above)."""
    X, y = _lattice()
    kw = dict(pop_size=12, generations=7, islands=3, migrate_every=2, migrate_k=2,
              **LATTICE)
    ragged = GPSession(device="cpu", callback=lambda g, s: None, callback_every=3, **kw)
    ragged.fit(X, y, key=prng.PRNGKey(1))
    mono = GPSession(device="cpu", **kw).fit(X, y, key=prng.PRNGKey(1))
    assert ragged.stats["blocks"] == 3 and mono.stats["blocks"] == 1
    for a, b in zip(ragged.state, mono.state):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(np.asarray(ragged.island_history),
                                  np.asarray(mono.island_history))
    assert ragged.history == mono.history


def test_postfix_island_session_dedup_exact_equals_off():
    """Postfix islands: dedup exact and off give the same trajectory
    (bitwise; each is held against the reference's engine in
    test_island_evolve_block_bitwise_vs_reference); only the dedup
    counter columns differ."""
    X, y = _lattice()
    kw = dict(pop_size=16, generations=6, islands=3, migrate_every=2, migrate_k=2,
              genome="postfix", **LATTICE)
    exact = GPSession(device="cpu", **kw).fit(X, y, key=prng.PRNGKey(3))
    off = GPSession(device="cpu", dedup="off", **kw).fit(X, y, key=prng.PRNGKey(3))
    for a, b in zip(exact.state, off.state):
        assert torch.equal(a, b)
    assert exact.history == off.history
    ce, co = np.asarray(exact.counter_history), np.asarray(off.counter_history)
    np.testing.assert_array_equal(ce[:, :5], co[:, :5])
    assert (ce[:, 6] > 0).all() and (co[:, 5:] == 0).all()
    assert exact.stats["unique_subtrees"] == ce[:, 6].sum() > 0


def test_islands_one_is_the_classic_layout():
    """islands=1 keeps the un-batched state and the trajectory of a
    session that never mentions islands."""
    X, y = _lattice()
    kw = dict(pop_size=16, generations=4, **LATTICE)
    s0 = GPSession(device="cpu", **kw).fit(X, y, key=prng.PRNGKey(0))
    s1 = GPSession(device="cpu", islands=1, **kw).fit(X, y, key=prng.PRNGKey(0))
    assert s1.state.op.dim() == 2 and s1.island_history == [] and s1.islands == 1
    for a, b in zip(s0.state, s1.state):
        assert torch.equal(a, b)
    assert s1.counter_history == s0.counter_history
    assert all(row[3] == 0 for row in s1.counter_history)


def test_symbolic_regressor_islands_matches_reference():
    X, y = _lattice()
    kw = dict(pop_size=12, generations=5, max_depth=3, fn_set="add,sub,mul", islands=4,
              migrate_every=2, migrate_k=1, island_topology="torus", random_state=6)
    want = JRegressor(backend="jnp", **kw).fit(X, y)
    got = SymbolicRegressor(device="cpu", **kw).fit(X, y)
    assert got.session_.history == want.session_.history
    assert got.expression_ == want.expression_
    assert got.best_fitness_ == want.best_fitness_
    np.testing.assert_array_equal(got.predict(X), np.asarray(want.predict(X)))
