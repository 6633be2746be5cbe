"""Threefry-2x32 keys and samplers, bit-for-bit with `jax.random`.

Evolution draws random numbers at every step, so the port reproduces the
reference's generator exactly rather than using `torch.Generator`: the
same key gives the same population, the same parents and the same
offspring as `repro`, which is what lets the tests hold whole evolution
trajectories against the JAX package.

The spec is JAX 0.9's own source under `jax_threefry_partitionable=True`
(`jax/_src/prng.py`: `_threefry2x32_lowering`, `_threefry_split_foldlike`,
`_threefry_fold_in`, `_threefry_random_bits_partitionable`;
`jax/_src/random.py`: `_uniform`, `_randint`, `_bernoulli`, `_gumbel`,
`categorical`).

A key is an int64 tensor `[..., 2]` holding two uint32 words. All
arithmetic runs in int64 masked to 32 bits (PyTorch's uint32 lacks ops
on some devices), on whatever device the key lives on, so draws never
leave the card.

`log` inside `gumbel`/`categorical` is XLA's CPU float32 logarithm (the
Cephes polynomial with fused multiply-adds), emulated with exact f32
steps: `torch.log` differs from it in about a quarter of all inputs, and
the same emulation runs identically on the CPU and the card.
"""
from __future__ import annotations

import math

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_TINY = float(np.finfo(np.float32).tiny)


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """`jax.random.PRNGKey(seed)` as an int64 `[2]` tensor."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & MASK, seed & MASK], dtype=torch.int64,
                        device=device)


def key_from_numpy(key) -> torch.Tensor:
    """A reference key (`uint32[..., 2]` numpy array) as a port key."""
    return torch.from_numpy(np.asarray(key, np.uint32).astype(np.int64))


def key_to_numpy(key: torch.Tensor) -> np.ndarray:
    """A port key as the reference's `uint32[..., 2]` numpy array."""
    return key.detach().cpu().numpy().astype(np.uint32)


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block (5 x 4 rounds), elementwise over
    broadcastable int64 tensors of uint32 values → (y1, y2).

    Only the low 32 bits of x1 matter until the end, so its sums are not
    masked (20 rounds of 33-bit adds stay far inside int64); x2 is
    masked once per round, before the next rotation reads it."""
    ks = (k1, k2, (k1 ^ k2 ^ 0x1BD11BDA) & MASK)
    x1 = x1 + ks[0]
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = x1 + x2
            x2 = (((x2 << r) | (x2 >> (32 - r))) ^ x1) & MASK
        x1 = x1 + ks[(i + 1) % 3]
        x2 = (x2 + (ks[(i + 2) % 3] + (i + 1))) & MASK
    return x1 & MASK, x2


def _counts(shape, device):
    """(hi, lo) words of a flat uint64 iota reshaped to `shape` (hi is the
    scalar 0 below 2**32 elements)."""
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    if n <= 2 ** 32:
        return 0, idx
    return idx >> 32, idx & MASK


def _hash(key, shape):
    hi, lo = _counts(shape, key.device)
    return threefry2x32(key[0], key[1], hi, lo)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`jax.random.split(key, num)` → int64 `[num, 2]`."""
    b1, b2 = _hash(key, (num,))
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """`jax.random.fold_in(key, data)` for a non-negative int32 `data`."""
    data = torch.full((), int(data) & MASK, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[0], key[1], torch.zeros_like(data), data)
    return torch.stack([b1, b2])


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """`jax.random.bits(key, shape)` for 32-bit words, as int64 values."""
    shape = tuple(shape)
    b1, b2 = _hash(key, shape)
    return b1 ^ b2


def _f32(x) -> float:
    """`x` rounded to float32, as a Python float: every f32 op with it
    as the scalar operand then rounds exactly as the reference's."""
    return float(np.float32(x))


def uniform(key, shape, minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """`jax.random.uniform(key, shape, float32, minval, maxval)`."""
    bits = random_bits(key, shape)
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    floats = mant - 1.0
    span = _f32(np.float32(maxval) - np.float32(minval))
    return torch.clamp_min(_fma(floats, span, _f32(minval)), _f32(minval))


def randint(key, shape, minval: int, maxval: int) -> torch.Tensor:
    """`jax.random.randint(key, shape, minval, maxval)` (int32): two
    32-bit draws folded into the span with the reference's multiplier
    arithmetic (uint32 wrap-around included)."""
    shape = tuple(shape)
    k1, k2 = split(key)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    span = (maxval - minval) if maxval > minval else 1
    mult = (2 ** 16) % span
    mult = ((mult * mult) & MASK) % span  # uint32 product wraps, as in XLA
    off = (((higher % span) * mult) & MASK) + (lower % span)
    off = (off & MASK) % span
    return (off + minval).to(torch.int32)


def bernoulli(key, p: float, shape) -> torch.Tensor:
    """`jax.random.bernoulli(key, p, shape)` with a float32 `p`."""
    return uniform(key, shape) < _f32(p)


# --- XLA's CPU float32 log (Cephes with fused multiply-adds) -----------------

_LOG_P = tuple(np.float32(v) for v in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))
_LOG_Q1 = np.float32(-2.12194440e-4)
_LOG_Q2 = np.float32(0.693359375)


def _fma(a, b, c):
    """f32 fused multiply-add: the f32 x f32 product is exact in f64, so
    one f64 add rounded to f32 is the fused result."""
    return (a.double() * (b.double() if torch.is_tensor(b) else float(b))
            + (c.double() if torch.is_tensor(c) else float(c))).float()


def xla_log(x: torch.Tensor) -> torch.Tensor:
    """float32 natural log, bitwise equal to XLA's CPU `log` (the
    function `jnp.log` runs inside the reference's jitted programs)."""
    x = x.float()
    t = torch.clamp_min(x, _F32_TINY)  # denormals cut off, as in XLA
    bits = t.view(torch.int32)
    e = ((bits >> 23) - 0x7F).float() + 1.0
    m = ((bits & 0x007FFFFF) | 0x3F000000).view(torch.float32)  # [0.5, 1)
    small = m < _f32(0.707106781186547524)
    e = e - small.float()
    m = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    x2 = m * m
    x3 = x2 * m
    p = _LOG_P
    y = _fma(m, p[0], p[1])
    y1 = _fma(m, p[3], p[4])
    y2 = _fma(m, p[6], p[7])
    y = _fma(y, m, p[2])
    y1 = _fma(y1, m, p[5])
    y2 = _fma(y2, m, p[8])
    y = _fma(y, x3, y1)
    y = _fma(y, x3, y2)
    y = _fma(y, x3, e * float(_LOG_Q1))
    r = _fma(-0.5 * torch.ones_like(x2), x2, m)
    r = r + y
    r = _fma(e, float(_LOG_Q2), r)
    r = torch.where(x == 0, torch.full_like(r, -math.inf), r)
    r = torch.where(x == math.inf, torch.full_like(r, math.inf), r)
    return torch.where((x < 0) | torch.isnan(x), torch.full_like(r, math.nan), r)


def gumbel(key, shape) -> torch.Tensor:
    """`jax.random.gumbel(key, shape)` (float32, mode "low")."""
    u = uniform(key, shape, _F32_TINY, 1.0)
    return -xla_log(-xla_log(u))


def categorical(key, logits: torch.Tensor, shape) -> torch.Tensor:
    """`jax.random.categorical(key, logits, shape=shape)` for 1-D logits:
    Gumbel-max over the last axis, first index on ties."""
    shape = tuple(shape)
    g = gumbel(key, (*shape, logits.shape[-1]))
    return torch.argmax(g + logits, dim=-1)
