"""The port's threefry keys and samplers against `jax.random`, bitwise.

Every draw of the port (`repro_torch.core.prng`) must equal the
reference's bit for bit — the population, the parents and the offspring
of an evolution trajectory all come from these functions."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import prng
from jax_release import release_jax_programs  # noqa: F401  (frees compiled programs)

torch.set_num_threads(2)

SEEDS = [0, 1, 42, 2**31 - 1]
SHAPES = [(5,), (3, 7), (100, 63)]


def _keys(seed):
    return jax.random.PRNGKey(seed), prng.PRNGKey(seed)


def test_partitionable_threefry_is_on():
    """The port reproduces the partitionable threefry layout; a JAX
    upgrade that flips the default must fail here, loudly."""
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in(seed):
    jk, tk = _keys(seed)
    np.testing.assert_array_equal(np.asarray(jk), prng.key_to_numpy(tk))
    for n in (2, 3, 4, 6, 7):
        np.testing.assert_array_equal(np.asarray(jax.random.split(jk, n)),
                                      prng.key_to_numpy(prng.split(tk, n)))
    for data in (0, 5, 12345):
        np.testing.assert_array_equal(np.asarray(jax.random.fold_in(jk, data)),
                                      prng.key_to_numpy(prng.fold_in(tk, data)))
    # round trip through the reference's uint32 form
    np.testing.assert_array_equal(
        prng.key_to_numpy(prng.key_from_numpy(np.asarray(jk))), np.asarray(jk))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_bits_uniform_bernoulli(seed, shape):
    jk, tk = _keys(seed)
    np.testing.assert_array_equal(
        np.asarray(jax.random.bits(jk, shape)),
        prng.random_bits(tk, shape).numpy().astype(np.uint32))
    np.testing.assert_array_equal(np.asarray(jax.random.uniform(jk, shape)),
                                  prng.uniform(tk, shape).numpy())
    for p in (0.2, 0.5, 0.6):
        np.testing.assert_array_equal(
            np.asarray(jax.random.bernoulli(jk, p, shape)),
            prng.bernoulli(tk, p, shape).numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("lo,hi", [(0, 1), (0, 3), (1, 6), (0, 100), (0, 1373),
                                   (0, 100_000)])
def test_randint(seed, lo, hi):
    jk, tk = _keys(seed)
    for shape in SHAPES:
        np.testing.assert_array_equal(
            np.asarray(jax.random.randint(jk, shape, lo, hi)),
            prng.randint(tk, shape, lo, hi).numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_gumbel(seed, shape):
    """Bitwise, including the two logs: the port emulates XLA's CPU
    float32 log (`prng.xla_log`)."""
    jk, tk = _keys(seed)
    np.testing.assert_array_equal(np.asarray(jax.random.gumbel(jk, shape)),
                                  prng.gumbel(tk, shape).numpy())


def test_xla_log_matches_jnp_log():
    """`xla_log` against `jnp.log` over the gumbel inputs (uniform f32 in
    [tiny, 1)), their -log, operator-mix probabilities, and the special
    values."""
    rng = np.random.RandomState(0)
    bits = rng.randint(0, 2**23, size=200_000).astype(np.uint32)
    u = (bits | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    u = np.maximum(u + np.finfo(np.float32).tiny, np.finfo(np.float32).tiny)
    xs = [u, -np.log(u.astype(np.float64)).astype(np.float32),
          np.array([0.1, 0.7, 0.2, 0.25, 1.0, 0.0, np.inf, -1.0, 3e38], np.float32),
          np.exp(rng.uniform(-80, 80, size=50_000)).astype(np.float32)]
    for x in xs:
        np.testing.assert_array_equal(np.asarray(jnp.log(jnp.asarray(x))),
                                      prng.xla_log(torch.from_numpy(x)).numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_categorical(seed):
    jk, tk = _keys(seed)
    for probs in ([0.1, 0.1, 0.1, 0.7], [0.25, 0.25, 0.25, 0.25], [0.0, 0.5, 0.0, 0.5]):
        p = np.asarray(probs, np.float32)
        want = jax.random.categorical(jk, jnp.log(p), shape=(500,))
        got = prng.categorical(tk, prng.xla_log(torch.from_numpy(p)), (500,))
        np.testing.assert_array_equal(np.asarray(want), got.numpy())
