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
cache write lands only on the owning shard. The mesh is single-controller
(`launch/mesh.py`): each shard of a sequence group runs in turn, and the
merge is the mesh module's `pmax`/`psum` in rank order. As in the
reference, `decode_step` does not use it; numerics are held against
`layers.attn_decode`.
"""
from __future__ import annotations

import math

import torch

from repro_torch.launch.mesh import P, over, pmax, psum
from repro_torch.models.layers import AttnDims, _positions, _proj_out, _qkv


def _local_attend(q, k, v, valid, scale):
    """q:[B,1,H,hd]; k,v:[B,S_loc,KV,hd]; valid:[S_loc] bool.
    Returns (o [B,1,H,hd] f32 unnormalized, m [B,1,H], l [B,1,H])."""
    groups = q.shape[2] // k.shape[2]
    kq = k.repeat_interleave(groups, dim=2)
    vq = v.repeat_interleave(groups, dim=2)
    s = torch.einsum("bthk,bshk->bhts", q.float(), kq.to(q.dtype).float()) * scale
    s = torch.where(valid[None, None, None, :], s, -math.inf)
    m = s.amax(-1)  # [B,H,1]
    m_safe = torch.where(torch.isfinite(m), m, -1e30)
    p = torch.where(torch.isfinite(s), torch.exp(s - m_safe[..., None]), 0.0)
    l = p.sum(-1)
    o = torch.einsum("bhts,bshk->bthk", p.to(vq.dtype).float(), vq.float())
    return o, m_safe.transpose(1, 2), l.transpose(1, 2)


def _write_owned(cache, new, cur_len, offset: int):
    """Write `new` ([B,1,...]) at row cur_len - offset of this shard's
    cache slice, in place, only where the shard owns cur_len (the row is
    clamped into the slice, and a shard that does not own it writes its
    own row back). `cur_len` is an int or a 0-d device tensor."""
    S_loc = cache.shape[1]
    new = new.to(cache.dtype)
    if not isinstance(cur_len, torch.Tensor):
        if offset <= int(cur_len) < offset + S_loc:
            cache[:, int(cur_len) - offset:int(cur_len) - offset + 1] = new
        return cache
    idx = (cur_len - offset).reshape(1).clamp(0, S_loc - 1).to(torch.long)
    owns = (cur_len >= offset) & (cur_len < offset + S_loc)
    cache.index_copy_(1, idx, torch.where(owns, new, cache.index_select(1, idx)))
    return cache


def make_cp_decode_attention(dims: AttnDims, seq_axis: str = "data"):
    """The group function of one decode-attention layer with a seq-sharded
    cache: fn(ps, xs, ks, vs, lens) over one `seq_axis` group's per-shard
    lists in rank order (params, x [B,1,d], cache slices [B,S_loc,KV,hd],
    cur_len) → (attn outputs [B,1,d], new k slices, new v slices), one a
    shard. The cache slices are written in place and returned. `seq_axis`
    names the axis the group runs over (`cp_decode_attention` passes the
    function to `mesh.over`)."""
    scale = 1.0 / math.sqrt(dims.d_head)

    def attend(ps, xs, ks, vs, lens):
        partial = []
        for r, (p, x, ck, cv, cur_len) in enumerate(zip(ps, xs, ks, vs, lens)):
            S_loc = ck.shape[1]
            offset = r * S_loc
            q, k, v = _qkv(p, x, dims, _positions(cur_len, x.shape[0], x.device))
            ck = _write_owned(ck, k, cur_len, offset)
            cv = _write_owned(cv, v, cur_len, offset)
            valid = (torch.arange(S_loc, device=x.device) + offset) <= cur_len
            partial.append((_local_attend(q, ck, cv, valid, scale), ck, cv))
        # flash merge across the shards: O(B·H·hd) moves
        ms = [m for (_, m, _), _, _ in partial]
        m_g = pmax(ms)
        cs = [torch.exp(m - mg) for m, mg in zip(ms, m_g)]
        l_g = psum([l * c for ((_, _, l), _, _), c in zip(partial, cs)])
        o_g = psum([o * c[..., None] for ((o, _, _), _, _), c in zip(partial, cs)])
        outs = [_proj_out((o / torch.clamp_min(l, 1e-30)[..., None]).to(x.dtype), p["wo"])
                for o, l, x, p in zip(o_g, l_g, xs, ps)]
        return outs, [ck for _, ck, _ in partial], [cv for _, _, cv in partial]

    return attend


def cp_decode_attention(p, x, cache_k, cache_v, cur_len, dims: AttnDims,
                        mesh, *, seq_axis: str = "data", batch_axes: tuple = ()):
    """One decode-attention layer over `mesh` with the cache's sequence dim
    on `seq_axis` (the long-context layout): x [B,1,d], cache [B,S,KV,hd]
    global tensors → (attn_out [B,1,d], new_k, new_v) on the mesh's home.
    `cur_len` is an int or a 0-d tensor."""
    attend = make_cp_decode_attention(dims, seq_axis)
    b = tuple(batch_axes) if batch_axes else None
    cache_spec, xspec = P(b, seq_axis, None, None), P(b, None, None)
    shards = range(mesh.size)
    ps = {s: {n: w.to(mesh.devices[s]) for n, w in p.items()} for s in shards}
    lens = {s: cur_len.to(mesh.devices[s]) if isinstance(cur_len, torch.Tensor) else cur_len
            for s in shards}
    outs, ks, vs = over(mesh, seq_axis, attend, ps, dict(enumerate(mesh.split(x, xspec))),
                        dict(enumerate(mesh.split(cache_k, cache_spec))),
                        dict(enumerate(mesh.split(cache_v, cache_spec))), lens)
    return (mesh.join(outs, xspec), mesh.join(ks, cache_spec), mesh.join(vs, cache_spec))
