"""Seed expressions (`core/parse.py`) and the sklearn-style estimators
(`gp/estimators.py`) of the port against `repro`: parsed op/arg rows and
seeded populations bitwise for heap and postfix genomes, the same
errors where the reference raises, seeded sessions and the estimators'
histories bit for bit on integer-lattice data (add/sub/mul trees over
features in {-1, 0, 1}, integer constants and targets: every prediction
and every fitness sum is an exact f32 integer), their predictions and
scores equal, and the options the port does not have yet raising
NotImplementedError with their ROADMAP item."""
import jax
import numpy as np
import pytest
import torch

from repro.core import parse as jparse
from repro.core import primitives as jprim
from repro.core import trees as jtrees
from repro.gp import GPSession as JSession
from repro.gp import SymbolicClassifier as JClassifier
from repro.gp import SymbolicRegressor as JRegressor
from repro_torch.core import parse as tparse
from repro_torch.core import primitives as tprim
from repro_torch.core import prng
from repro_torch.core import trees as ttrees
from repro_torch.gp import GPSession, SymbolicClassifier, SymbolicRegressor

torch.set_num_threads(2)

NAMES = ["mass", "radius", "temp"]
# every function of the primitive set, constants (positive and negative),
# x<i> and named features
EXPRS = [
    "(x0 + 1)",
    "((mass * radius) - (temp / -2))",
    "div(x0, sub(x1, add(x2, 3)))",
    "neg(abs(mul(x0, -4)))",
    "sin(cos(x1))",
    "sqrt(log(square(radius)))",
    "min(max(x0, 2), (x2 + -1))",
    "((x0 * x0) * x0)",
    "temp",
    "-3",
]


def _specs(genome, depth=5, F=3):
    kw = dict(max_depth=depth, n_features=F, genome=genome)
    return (jtrees.TreeSpec(fn_set=jprim.KITCHEN_SINK, **kw),
            ttrees.TreeSpec(fn_set=tprim.KITCHEN_SINK, **kw))


@pytest.mark.parametrize("genome", ["tree", "postfix"])
def test_parse_tree_bitwise(genome):
    js, ts = _specs(genome)
    assert set(tprim.FN_NAMES) <= {t for e in EXPRS for t in tparse._tokenize(e)}
    for e in EXPRS:
        jop, jarg = jparse.parse_tree(e, js, NAMES)
        top, targ = tparse.parse_tree(e, ts, NAMES)
        assert top.dtype == np.int32 and targ.dtype == np.int32
        np.testing.assert_array_equal(top, jop, err_msg=e)
        np.testing.assert_array_equal(targ, jarg, err_msg=e)
        # the parsed row renders back to the same text in both packages
        assert (ttrees.to_string(top, targ, NAMES, ts.const_table_numpy(), genome=genome)
                == jtrees.to_string(jop, jarg, NAMES, np.asarray(js.const_table()),
                                    genome=genome))


@pytest.mark.parametrize("genome,expr", [
    ("postfix", "(((x0 + x1) * (x0 + x1)) + x0)"),  # 9 nodes > 7 slots
    ("postfix", "(x0 + (x1 + (x0 + x1)))"),  # stack depth 4 > stack_size 3 (P5)
    ("tree", "(x0 + (x1 + (x0 + x1)))"),  # deeper than max_depth 2
    ("tree", "(x0 + 7)"),  # not in the const table
    ("tree", "sin(x0, x1)"),  # arity
    ("tree", "tan(x0)"),  # unknown function
    ("tree", "x5"),  # feature out of range
    ("tree", "(x0 % x1)"),  # bad token
    ("tree", "(x0 + x1) x0"),  # trailing input
])
def test_parse_tree_raises_where_the_reference_raises(genome, expr):
    js, ts = _specs(genome, depth=2)
    with pytest.raises(ValueError) as want:
        jparse.parse_tree(expr, js, NAMES)
    with pytest.raises(ValueError) as got:
        tparse.parse_tree(expr, ts, NAMES)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("genome", ["tree", "postfix"])
def test_seed_population_bitwise(genome):
    js, ts = _specs(genome)
    jop, jarg = jparse.seed_population(EXPRS[:6], js, 20, jax.random.PRNGKey(5), NAMES)
    top, targ = tparse.seed_population(EXPRS[:6], ts, 20, prng.PRNGKey(5), NAMES)
    assert top.dtype == torch.int32 and top.device.type == "cpu"
    np.testing.assert_array_equal(top.numpy(), np.asarray(jop))
    np.testing.assert_array_equal(targ.numpy(), np.asarray(jarg))
    # the unseeded slots are the population the key draws
    rop, _ = ttrees.generate_population(prng.PRNGKey(5), 20, ts)
    np.testing.assert_array_equal(top[6:].numpy(), rop[6:].numpy())
    with pytest.raises(ValueError, match="more seeds"):
        tparse.seed_population(EXPRS, ts, 4, prng.PRNGKey(5), NAMES)


def _lattice(seed, rows=64, F=3):
    rng = np.random.RandomState(seed)
    X = rng.randint(-1, 2, size=(rows, F)).astype(np.float32)
    y = (X[:, 0] * X[:, 1] + 2 * X[:, 2] + rng.randint(-1, 2, size=rows)).astype(np.float32)
    return X, y


@pytest.mark.parametrize("genome", ["tree", "postfix"])
def test_seeded_session_bitwise(genome):
    X, y = _lattice(1)
    seeds = ["(x0 * x1)", "((x0 * x1) + (x2 + x2))", "(x2 - 1)"]
    kw = dict(pop_size=20, generations=6, kernel="r", max_depth=3, p_const=0.0,
              fn_set="add,sub,mul", genome=genome, block_size=3)
    js = JSession(backend="jnp", **kw).fit(X, y, key=jax.random.PRNGKey(3), seeds=seeds)
    ts = GPSession(device="cpu", **kw).fit(X, y, key=prng.PRNGKey(3), seeds=seeds)
    assert ts.history == js.history
    assert ts.best_expression() == js.best_expression()
    assert ts.history[0] <= 64.0  # the second seed misses by at most 1 a row
    # named features reach the parser through the session
    s = GPSession(device="cpu", feature_names=["a", "b", "c"], **kw).ingest(X, y)
    s.init(key=prng.PRNGKey(3), seeds=["(a * b)"])
    np.testing.assert_array_equal(s.state.op[0].numpy(),
                                  tparse.parse_tree("(x0 * x1)", s.config.tree_spec)[0])


_EST = dict(pop_size=24, generations=6, max_depth=3, fn_set="add,sub,mul", block_size=3)


def test_regressor_walks_the_reference():
    X, y = _lattice(2)
    want = JRegressor(random_state=7, backend="jnp", **_EST).fit(X, y)
    got = SymbolicRegressor(random_state=7, device="cpu", **_EST).fit(X, y)
    assert got.session_.history == want.session_.history
    assert got.expression_ == want.expression_
    assert got.best_fitness_ == want.best_fitness_ and got.n_features_in_ == 3
    np.testing.assert_array_equal(got.predict(X), np.asarray(want.predict(X)))
    assert got.score(X, y) == want.score(X, y)
    # warm start continues the evolved population, as the reference's does
    want.warm_start = got.warm_start = True
    want.fit(X, y)
    got.fit(X, y)
    assert got.session_.history == want.session_.history


def test_classifier_walks_the_reference():
    X, _ = _lattice(3)
    y = np.clip(X[:, 0] + X[:, 1] + 1, 0, 2).astype(np.float32)
    want = JClassifier(n_classes=3, random_state=4, backend="jnp", **_EST).fit(X, y)
    got = SymbolicClassifier(n_classes=3, random_state=4, device="cpu", **_EST).fit(X, y)
    assert got.session_.history == want.session_.history
    assert got.expression_ == want.expression_
    pred = got.predict(X)
    assert pred.dtype == np.int32
    np.testing.assert_array_equal(pred, np.asarray(want.predict(X)))
    assert got.score(X, y) == want.score(X, y)


@pytest.mark.parametrize("option,item", [
    (dict(topology=object()), "A11"), (dict(checkpoint_dir="ck"), None),
    (dict(chunk_rows=16), None), (dict(islands=2), None)])
def test_estimator_unported_options_raise(option, item, tmp_path):
    """Options not ported yet raise with their ROADMAP item; those that
    are (item None: checkpoints, streaming with 16-row chunks, islands)
    fit."""
    X, y = _lattice(4, rows=16)
    for est in (SymbolicRegressor, SymbolicClassifier):
        if "checkpoint_dir" in option:  # a directory of its own per estimator
            option = dict(checkpoint_dir=str(tmp_path / est.__name__))
        if item is None:
            fitted = est(device="cpu", pop_size=8, generations=2, **option).fit(X, y)
            assert fitted.session_.generation == 2
            continue
        with pytest.raises(NotImplementedError, match=f"ROADMAP queue A: {item}"):
            est(device="cpu", **option).fit(X, y)
    with pytest.raises(ValueError, match="not fitted"):
        SymbolicRegressor(device="cpu").predict(X)
