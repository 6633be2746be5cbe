"""Context-parallel decode: flash-merge attention over a sequence-sharded
KV cache (port of `repro/launch/serving.py`).

The long-context decode cells (batch 1) shard the KV cache on the
sequence dim over the `data` axis (`launch/sharding.cache_specs` with
`seq_shard`). Every shard computes a partial attention over its local
cache slice and the shards merge with the flash identity

    m  = pmax(m_i)
    l  = psum(l_i · exp(m_i − m))
    o  = psum(o_i · exp(m_i − m)) / l

so the traffic per layer is O(B·H·hd) instead of O(B·H·S/shards). The
cache write lands only on the owning shard. In one process each shard
of a sequence group runs in turn, and the merge is the mesh module's
`pmax`/`psum` in rank order. Over several processes
(`launch.cluster.init_cluster`) each process computes its own shards'
partials over its own cache slices, the partials alone cross processes
(one exchange over the group), and every process merges them in the
same rank order: the single controller's bits, with the cache slices
never leaving their process. The partial, the owner's write and the
merge live in `models/layers.py`, whose decode attention runs the same
merge on a `ShardedCache` of this layout (`decode_step` at batch 1);
numerics are held against `layers.attn_decode`.
"""
from __future__ import annotations

import torch

from repro_torch.launch.mesh import P, Sharded, over
from repro_torch.models.layers import AttnDims, _cp_merge, _cp_partial


def make_cp_decode_attention(dims: AttnDims, seq_axis: str = "data"):
    """The group function of one decode-attention layer with a seq-sharded
    cache: fn(ps, xs, ks, vs, lens) over one `seq_axis` group's per-shard
    lists in rank order (params, x [B,1,d], cache slices [B,S_loc,KV,hd],
    cur_len) → (attn outputs [B,1,d], new k slices, new v slices), one a
    shard: each shard's partial (`_cp_partial`), then their merge
    (`_cp_merge`). The cache slices are written in place and returned.
    `seq_axis` names the axis the group runs over."""

    def attend(ps, xs, ks, vs, lens):
        got = [_cp_partial(dims, p, x, ck, cv, n, r)
               for r, (p, x, ck, cv, n) in enumerate(zip(ps, xs, ks, vs, lens))]
        return (_cp_merge([g[0] for g in got], ps, xs), [g[1] for g in got],
                [g[2] for g in got])

    return attend


def cp_decode_attention(p, x, cache_k, cache_v, cur_len, dims: AttnDims,
                        mesh, *, seq_axis: str = "data", batch_axes: tuple = ()):
    """One decode-attention layer over `mesh` with the cache's sequence dim
    on `seq_axis` (the long-context layout): x [B,1,d] a global tensor, the
    cache [B,S,KV,hd] global tensors or `Sharded` parts under that layout
    → (attn_out [B,1,d] on the mesh's home, new_k, new_v): the cache as
    given, global tensors joined on the home or the parts written in
    place. `cur_len` is an int or a 0-d tensor.

    Each shard's partial runs in turn, then each sequence group's merge
    in rank order. Over several processes a process runs its own
    shards' partials, and only the partials (o, m, l) cross processes,
    exchanged over each sequence group: every process merges them in
    rank order, so the output is the single controller's bit for bit.
    The cache slices never cross: the cache comes back as `Sharded`, this
    process's slices written in place, even where it was given whole."""
    b = tuple(batch_axes) if batch_axes else None
    cache_spec, xspec = P(b, seq_axis, None, None), P(b, None, None)
    local = mesh.local
    ps = {s: {n: w.to(mesh.devices[s]) for n, w in p.items()} if s in local else None
          for s in range(mesh.size)}
    xs = dict(enumerate(mesh.split(x, xspec)))
    lens = {s: cur_len.to(mesh.devices[s]) if isinstance(cur_len, torch.Tensor) else cur_len
            for s in local}
    ks, vs = (c.parts if isinstance(c, Sharded) else mesh.split(c, cache_spec)
              for c in (cache_k, cache_v))
    partials = {}
    for s in local:
        partials[s], ks[s], vs[s] = _cp_partial(dims, ps[s], xs[s], ks[s], vs[s], lens[s],
                                                mesh.rank(s, seq_axis))
    outs = over(mesh, seq_axis, _cp_merge, partials, ps, xs)
    new_k, new_v = [ks[s] for s in local], [vs[s] for s in local]
    out = mesh.join(outs, xspec)
    caches = []
    for given, new in ((cache_k, new_k), (cache_v, new_v)):
        parts = [None] * mesh.size
        for s, t in zip(local, new):
            parts[s] = t
        sh = Sharded(mesh, cache_spec, parts, given.shape)
        if isinstance(given, Sharded):
            given.parts = parts
            caches.append(given)
        else:
            caches.append(sh if mesh.multi else mesh.join(parts, cache_spec))
    return out, caches[0], caches[1]
