"""int8 gradient compression with error feedback; port of
`repro/optim/compress.py`.

Drops the data-parallel all-reduce volume 4x (f32→int8 + a shared f32
scale). Error feedback keeps the quantization residual locally and adds
it to the next step's gradient, which is the standard convergence fix
(1-bit Adam / EF-SGD lineage). Exposed two ways:

  * `compressed_psum(grads, residual)` — drop-in for `launch.mesh.psum`
    over one axis group of the port's mesh (each argument a list of the
    shards' gradient trees in rank order; `mesh.over` applies it to every
    group of an axis, over several processes too: the remote shards'
    trees are fetched first, so every process gets the same sums).
  * `quantize/dequantize` — used by tests and by the checkpoint codec.

`torch.round` rounds half to even, as `jnp.round` does.
"""
from __future__ import annotations

import torch

from repro_torch.launch import mesh as M
from repro_torch.optim.adamw import _tree_map


def quantize(x):
    """f32 → (int8, scale). Symmetric per-tensor scaling."""
    amax = torch.max(torch.abs(x))
    scale = torch.where(amax > 0, amax / 127.0, 1.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q, scale):
    return q.to(torch.float32) * scale


def _one(gs, rs):
    """One leaf over the group's shards (lists in rank order)."""
    n = len(gs)
    g_fb = [g + r for g, r in zip(gs, rs)]
    # shared scale via a scalar pmax so every shard's int8 grid aligns —
    # per-element error of the mean is then ≤ scale/2 exactly.
    amax = M.pmax([torch.max(torch.abs(g)) for g in g_fb])
    scales = [torch.where(a > 0, a / 127.0, 1.0) for a in amax]
    qs = [torch.clamp(torch.round(g / s), -127, 127).to(torch.int8)
          for g, s in zip(g_fb, scales)]
    # int8 tensors all-reduce in int32 to avoid overflow across shards
    summed = M.psum([q.to(torch.int32) for q in qs])
    mean = [t.to(torch.float32) * s / n for t, s in zip(summed, scales)]
    new_r = [g - dequantize(q, s) for g, q, s in zip(g_fb, qs, scales)]
    return mean, new_r


def compressed_psum(grads: list, residual: list | None = None):
    """Quantize → psum → dequantize with error feedback, over one axis
    group: `grads` (and `residual`) list each shard's f32 gradient tree
    in rank order. Returns (mean_grads, new_residual), each a list of
    trees in rank order, each tree on its shard's device."""
    n = len(grads)
    if residual is None:
        residual = [_tree_map(torch.zeros_like, g) for g in grads]
    out = _tree_map(lambda *leaves: _one(list(leaves[:n]), list(leaves[n:])),
                    *grads, *residual)
    return ([_tree_map(lambda o: o[0][k], out) for k in range(n)],
            [_tree_map(lambda o: o[1][k], out) for k in range(n)])
