"""The port's breeding operators against `repro.core.evolve`, bitwise:
the same key and population give the same offspring, and every output
satisfies the heap invariants I1–I4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import evolve as jev
from repro.core import primitives as jprim
from repro.core import trees as jtrees
from repro_torch.core import evolve as tev
from repro_torch.core import primitives as tprim
from repro_torch.core import prng
from repro_torch.core import trees as ttrees
from jax_release import release_jax_programs  # noqa: F401  (frees compiled programs)

torch.set_num_threads(2)


def _setup(fn_set, depth=5, F=9, pop=48):
    js = jtrees.TreeSpec(max_depth=depth, n_features=F, fn_set=getattr(jprim, fn_set))
    ts = ttrees.TreeSpec(max_depth=depth, n_features=F, fn_set=getattr(tprim, fn_set))
    a = ttrees.generate_population(prng.PRNGKey(3), pop, ts)
    b = ttrees.generate_population(prng.PRNGKey(4), pop, ts)
    # duplicate fitness values: ties decide tournaments and elites
    fit = np.random.RandomState(0).randint(0, 5, pop).astype(np.float32)
    return js, ts, a, b, fit


def _j(t):
    return jnp.asarray(t.numpy())


def _same(jres, tres, ts):
    np.testing.assert_array_equal(np.asarray(jres[0]), tres[0].numpy())
    np.testing.assert_array_equal(np.asarray(jres[1]), tres[1].numpy())
    assert tres[0].dtype == torch.int32 and tres[1].dtype == torch.int32
    ttrees.check_invariants(tres[0], ts)


@pytest.mark.parametrize("fn_set", ["ARITHMETIC", "CLASSIFY_SET", "KITCHEN_SINK"])
@pytest.mark.parametrize("seed", [0, 7])
def test_operators_bitwise(fn_set, seed):
    js, ts, (op, arg), (op2, arg2), _ = _setup(fn_set)
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    _same(jev.crossover(jk, _j(op), _j(arg), _j(op2), _j(arg2), js),
          tev.crossover(tk, op, arg, op2, arg2, ts), ts)
    _same(jev.mutate_branch(jk, _j(op), _j(arg), js),
          tev.mutate_branch(tk, op, arg, ts), ts)
    _same(jev.mutate_point(jk, _j(op), _j(arg), js),
          tev.mutate_point(tk, op, arg, ts), ts)
    _same(jev.mutate_point(jk, _j(op), _j(arg), js, p=0.9),
          tev.mutate_point(tk, op, arg, ts, p=0.9), ts)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("size", [2, 10])
def test_tournament_bitwise(seed, size):
    _, _, _, _, fit = _setup("ARITHMETIC")
    want = jev.tournament(jax.random.PRNGKey(seed), jnp.asarray(fit), 48, size)
    got = tev.tournament(prng.PRNGKey(seed), torch.from_numpy(fit), 48, size)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("fn_set", ["ARITHMETIC", "CLASSIFY_SET"])
@pytest.mark.parametrize("mix,elitism", [
    (jev.OperatorMix(), 1),
    (jev.OperatorMix(0.25, 0.25, 0.25, 0.25), 3),
    (jev.OperatorMix(0.0, 0.5, 0.0, 0.5), 0),
])
def test_next_generation_bitwise(fn_set, mix, elitism):
    js, ts, (op, arg), _, fit = _setup(fn_set)
    tmix = tev.OperatorMix(mix.reproduce, mix.mutate_point, mix.mutate_branch,
                           mix.crossover)
    for seed in (0, 5):
        want = jev.next_generation(jax.random.PRNGKey(seed), _j(op), _j(arg),
                                   jnp.asarray(fit), js, mix, 10, elitism)
        got = tev.next_generation(prng.PRNGKey(seed), op, arg, torch.from_numpy(fit),
                                  ts, tmix, 10, elitism)
        _same(want, got, ts)
