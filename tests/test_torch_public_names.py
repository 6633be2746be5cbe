"""The port's public names against the reference's: the exports of
`repro_torch.core` and `repro_torch.gp`, and `engine.run` (the deprecated
forwarder), `fitness.accuracy_from_preds` and `trees.subtree_mask_table`,
each bitwise with its reference on the same inputs."""
import inspect

import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.gp as jgp
import repro_torch.core as tcore
import repro_torch.gp as tgp
from repro.core import fitness as jfit
from repro.core import trees as jtrees
from repro_torch.core import engine as tengine
from repro_torch.core import fitness as tfit
from repro_torch.core import islands as tislands
from repro_torch.core import prng
from repro_torch.core import trees as ttrees
from jax_release import release_jax_programs  # noqa: F401  (frees compiled programs)

torch.set_num_threads(2)


def _public(mod):
    return sorted(n for n in dir(mod) if not n.startswith("_") and n != "annotations"
                  and not inspect.ismodule(getattr(mod, n)))


@pytest.mark.parametrize("ref,port", [(jcore, tcore), (jgp, tgp)], ids=["core", "gp"])
def test_package_exports_match_reference(ref, port):
    assert _public(port) == _public(ref)


def test_island_config_is_the_engine_one():
    assert tgp.IslandConfig is tcore.IslandConfig is tislands.IslandConfig
    assert tcore.run is tengine.run


@pytest.mark.parametrize("depth", range(7))
def test_subtree_mask_table_bitwise(depth):
    n = ttrees.n_nodes(depth)
    got, want = ttrees.subtree_mask_table(n), jtrees.subtree_mask_table(n)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kernel", ["r", "c", "m", "mse", "pearson", "r2"])
def test_accuracy_from_preds_bitwise(kernel):
    """On integer-lattice predictions and targets, where every sum is exact
    in any order, the metric is the reference's bit for bit. 40 points for
    the means (a division by 40 rounds), 32 under pearson/r2 (their centred
    moments are exact only where the mean is)."""
    rng = np.random.RandomState(0)
    D = 32 if kernel in ("pearson", "r2") else 40
    preds = rng.randint(-3, 4, size=(9, D)).astype(np.float32)
    y = rng.randint(-3, 4, size=D).astype(np.float32)
    if kernel == "c":
        preds, y = np.abs(preds) % 3, np.abs(y) % 3
    kw = dict(n_classes=3) if kernel == "c" else {}
    want = jfit.accuracy_from_preds(jax.numpy.asarray(preds), jax.numpy.asarray(y),
                                    jfit.FitnessSpec(kernel, **kw))
    got = tfit.accuracy_from_preds(torch.from_numpy(preds), torch.from_numpy(y),
                                   tfit.FitnessSpec(kernel, **kw))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_run_forwards_with_deprecation_bitwise():
    """`engine.run` warns, then walks the reference `run`'s trajectory on
    lattice data: the final state bit for bit."""
    rng = np.random.RandomState(5)
    X = rng.randint(-2, 3, size=(2, 48)).astype(np.float32)
    y = rng.randint(-2, 3, size=48).astype(np.float32)
    jcfg = jcore.GPConfig(pop_size=24, generations=4, fitness=jcore.FitnessSpec("r"),
                          tree_spec=jcore.TreeSpec(max_depth=3, n_features=2, p_const=0.0))
    tcfg = tcore.GPConfig(pop_size=24, generations=4, fitness=tcore.FitnessSpec("r"),
                          tree_spec=tcore.TreeSpec(max_depth=3, n_features=2, p_const=0.0))
    with pytest.warns(DeprecationWarning, match="GPSession"):
        want = jcore.run(jcfg, X, y, key=jax.random.PRNGKey(7))
    with pytest.warns(DeprecationWarning, match="GPSession"):
        got = tcore.run(tcfg, X, y, key=prng.PRNGKey(7), device="cpu")
    got = tengine.state_to_numpy(got)
    for name, leaf in want._asdict().items():
        np.testing.assert_array_equal(got[name], np.asarray(leaf), err_msg=f"GPState.{name}")
