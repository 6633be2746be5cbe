"""The port's level-sweep evaluator against `repro.core.eval`.

add/sub/mul/div/abs/min/max trees: bitwise (each node is one IEEE f32
operation in both). KITCHEN_SINK (sin/cos/log/sqrt): stated tolerance,
because torch's and XLA's transcendental functions differ by ulps and a
depth-5 tree can amplify an ulp (rtol 1e-4, atol 1e-5; elements where
either side is non-finite must agree in kind)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import eval as jeval
from repro.core import primitives as jprim
from repro.core import trees as jtrees
from repro_torch.core import eval as teval
from repro_torch.core import primitives as tprim
from repro_torch.core import prng
from repro_torch.core import trees as ttrees

torch.set_num_threads(2)


def _case(fn_set, depth, F, D, pop, seed):
    js = jtrees.TreeSpec(max_depth=depth, n_features=F, fn_set=getattr(jprim, fn_set))
    ts = ttrees.TreeSpec(max_depth=depth, n_features=F, fn_set=getattr(tprim, fn_set))
    op, arg = ttrees.generate_population(prng.PRNGKey(seed), pop, ts)
    X = np.random.RandomState(seed).randn(F, D).astype(np.float32) * 3
    want = np.asarray(jeval.evaluate_population(
        jnp.asarray(op.numpy()), jnp.asarray(arg.numpy()), jnp.asarray(X),
        js.const_table(), js))
    got = teval.evaluate_population(op, arg, torch.from_numpy(X),
                                    ts.const_table(), ts).numpy()
    return want, got


@pytest.mark.parametrize("fn_set", ["ARITHMETIC", "CLASSIFY_SET"])
@pytest.mark.parametrize("depth,F,D", [(2, 1, 9), (4, 3, 257), (5, 9, 300)])
def test_predictions_bitwise(fn_set, depth, F, D):
    want, got = _case(fn_set, depth, F, D, pop=37, seed=depth * 10 + F)
    np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize("depth,F,D", [(3, 2, 100), (5, 4, 300)])
def test_predictions_kitchen_sink_tolerance(depth, F, D):
    want, got = _case("KITCHEN_SINK", depth, F, D, pop=37, seed=depth + F)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(fin, np.isfinite(got))
    np.testing.assert_array_equal(np.isnan(want), np.isnan(got))
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-4, atol=1e-5)


def test_evaluate_tree_and_select_default():
    """Single-tree wrapper, and an opcode outside the run's set
    evaluates to 0 as the reference's select default does."""
    ts = ttrees.TreeSpec(max_depth=2, n_features=2, fn_set=tprim.ARITHMETIC)
    js = jtrees.TreeSpec(max_depth=2, n_features=2, fn_set=jprim.ARITHMETIC)
    op = np.array([tprim.opcode_of("sin"), 2, 0, 0, 0, 0, 0], np.int32)
    arg = np.array([0, 1, 0, 0, 0, 0, 0], np.int32)
    X = np.array([[1.0, 2.0], [3.0, 4.0]], np.float32)
    got = teval.evaluate_tree(torch.from_numpy(op), torch.from_numpy(arg),
                              torch.from_numpy(X), ts.const_table(), ts).numpy()
    want = np.asarray(jeval.evaluate_tree(jnp.asarray(op), jnp.asarray(arg),
                                          jnp.asarray(X), js.const_table(), js))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [0.0, 0.0])
