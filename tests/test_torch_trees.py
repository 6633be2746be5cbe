"""Heap-tree generation in the port against `repro.core.trees`, bitwise:
the same key gives the same population, and the rows satisfy I1–I4."""
import jax
import numpy as np
import pytest
import torch

from repro.core import primitives as jprim
from repro.core import trees as jtrees
from repro_torch.core import primitives as tprim
from repro_torch.core import prng
from repro_torch.core import trees as ttrees

torch.set_num_threads(2)

FN_SETS = ["ARITHMETIC", "CLASSIFY_SET", "KITCHEN_SINK"]


def _specs(depth, fn_set, F, **kw):
    return (jtrees.TreeSpec(max_depth=depth, n_features=F,
                            fn_set=getattr(jprim, fn_set), **kw),
            ttrees.TreeSpec(max_depth=depth, n_features=F,
                            fn_set=getattr(tprim, fn_set), **kw))


@pytest.mark.parametrize("depth", [1, 3, 5])
@pytest.mark.parametrize("fn_set", FN_SETS)
@pytest.mark.parametrize("F", [1, 9, 1373])
def test_generate_population_bitwise(depth, fn_set, F):
    js, ts = _specs(depth, fn_set, F)
    seed = depth * 1000 + F
    jop, jarg = jtrees.generate_population(jax.random.PRNGKey(seed), 40, js)
    top, targ = ttrees.generate_population(prng.PRNGKey(seed), 40, ts)
    assert top.dtype == torch.int32 and targ.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(jop), top.numpy())
    np.testing.assert_array_equal(np.asarray(jarg), targ.numpy())
    ttrees.check_invariants(top, ts)
    consts = ts.const_table_numpy()
    np.testing.assert_array_equal(np.asarray(js.const_table()), consts)
    for i in range(0, 40, 7):
        assert (ttrees.to_string(top[i], targ[i], const_table=consts)
                == jtrees.to_string(jop[i], jarg[i], const_table=consts))
    np.testing.assert_array_equal(np.asarray(jtrees.tree_sizes(jop)),
                                  ttrees.tree_sizes(top).numpy())


def test_spec_options_bitwise():
    """p_const / grow_p_fn / n_consts reach the draws the same way."""
    js, ts = _specs(4, "CLASSIFY_SET", 3, p_const=0.5, grow_p_fn=0.3, n_consts=5)
    jop, jarg = jtrees.generate_population(jax.random.PRNGKey(9), 64, js)
    top, targ = ttrees.generate_population(prng.PRNGKey(9), 64, ts)
    np.testing.assert_array_equal(np.asarray(jop), top.numpy())
    np.testing.assert_array_equal(np.asarray(jarg), targ.numpy())


def test_check_invariants_catches_faults():
    _, ts = _specs(3, "ARITHMETIC", 2)
    op, _ = ttrees.generate_population(prng.PRNGKey(0), 8, ts)
    bad = op.clone()
    bad[:, 0] = 0
    with pytest.raises(AssertionError, match="I1"):
        ttrees.check_invariants(bad, ts)
    bad = op.clone()
    bad[:, -1] = tprim.opcode_of("add")
    with pytest.raises(AssertionError):
        ttrees.check_invariants(bad, ts)


def test_postfix_genome_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ttrees.TreeSpec(genome="postfix")
