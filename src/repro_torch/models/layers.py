"""Shared neural layers: norms, RoPE, chunked (flash-style) attention, MLPs
(port of `repro/models/layers.py`).

Plain functions on tensors: a layer's parameters are a mapping of name to
tensor (`dict` or `nn.ParameterDict`). Attention never materialises an
[S, S] score matrix: training/prefill run a q-chunk x kv-chunk double
loop with a running max and denominator, and decode does a single-token
pass over the cache.

Numerics follow the reference's. A product the reference takes with
`preferred_element_type=f32` upcasts its operands to f32 here; the
others (`_qkv`, `mlp_apply`, the `wo` projection) stay in the compute
dtype. The GQA head repeat is `repeat_interleave` (head h reads kv head
h // groups), as `jnp.repeat` does. gelu is the tanh form, `jax.nn.gelu`'s
default.

A ShardingPolicy (`policy`) is accepted where the reference's is. Where
it carries a pass's model group (`tp_group`) the layers run tensor
parallel, as XLA partitions the reference's pinned layouts: a weight the
specs split over the model axis arrives as the ranks' blocks, q/k/v are
column-parallel by heads and `wo` row-parallel, where the heads do not
divide the axis each rank takes its rows of every q chunk (the
reference's `pin(allow_row_shard=True)`), a head-dim-split cache is read
by partial scores, and the FFN is column/row-parallel. Without a group
`replicate_kv` repeats kv heads up to the model axis as the reference
does.

Training differentiates these functions with autograd. Where the
reference remats (`jax.checkpoint`) the port does too, through `_remat`
(`torch.utils.checkpoint`, non-reentrant): each kv chunk of the attention
here, each group of the stack in `transformer.py`. It applies only while
autograd is recording, so prefill and decode run the plain loop.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.launch.mesh import Blocks

# --------------------------------------------------------------------------
# initializers / norms
# --------------------------------------------------------------------------


def _recording(*tensors) -> bool:
    """Is autograd recording a graph through any of `tensors`?"""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _remat(fn, *args, record: bool):
    """`fn(*args)`, under a rematerialising checkpoint when `record`: its
    activations are recomputed in the backward pass instead of kept, as
    the reference's `jax.checkpoint`. The model draws no random numbers,
    so no RNG state is stashed."""
    if record:
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


def dense_init(gen, shape, in_axes=(0,), dtype=torch.float32, device=None):
    """N(0, 1) / sqrt(fan_in) in f32, cast to `dtype` (the reference's
    distribution and scale, drawn from the torch generator `gen`). On the
    `meta` device only the shape is made."""
    fan_in = max(int(np.prod([shape[a] for a in in_axes])), 1)
    dev = torch.device(device) if device is not None else gen.device
    if dev.type == "meta":
        return torch.empty(shape, dtype=dtype, device=dev)
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
    return (w / math.sqrt(fan_in)).to(dtype)


def rms_norm(x, scale, *, eps: float = 1e-6, plus_one: bool = False):
    x32 = x.float()
    inv = torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    s = (1.0 + scale) if plus_one else scale
    return (x32 * inv).to(x.dtype) * s.to(x.dtype)


def layer_norm(x, scale, bias, *, eps: float = 1e-5):
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * scale.to(x.dtype) + bias.to(x.dtype)


def gelu(x):
    return F.gelu(x, approximate="tanh")


def _act(x, act: str):
    return gelu(x) if act == "gelu" else F.silu(x)


# --------------------------------------------------------------------------
# rotary position embedding
# --------------------------------------------------------------------------


def rope(x, positions, *, theta: float = 10000.0):
    """x: [..., S, H, hd]; positions: [..., S] (broadcastable)."""
    hd = x.shape[-1]
    exps = torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd
    freqs = 1.0 / (theta ** exps)
    ang = positions[..., :, None, None].float() * freqs  # [..., S, 1, hd/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# chunked causal/full attention (training & prefill)
# --------------------------------------------------------------------------


def _chunk_attend(q, k, v, mask, scale):
    """q:[B,Hq,Lq,hd] k,v:[B,Hkv,Lk,hd] mask:[Lq,Lk] bool|None.
    Returns (o_unnormalized [B,Hq,Lq,hd] f32, m [B,Hq,Lq] f32, l [B,Hq,Lq] f32)."""
    groups = q.shape[1] // k.shape[1]
    kq = k.repeat_interleave(groups, dim=1)
    vq = v.repeat_interleave(groups, dim=1)
    s = torch.matmul(q.float(), kq.float().transpose(-1, -2)) * scale
    if mask is not None:
        s = torch.where(mask[None, None], s, -math.inf)
    m = s.amax(-1)  # -inf for fully-masked rows
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(torch.isfinite(s), p, 0.0)
    l = p.sum(-1)
    o = torch.matmul(p.to(v.dtype).float(), vq.float())
    return o, m_safe, l


def _pad_seq(t, pad: int):
    """Zero-pad dim 1 by `pad` (the reference's `jnp.pad` on the sequence)."""
    return torch.cat([t, t.new_zeros((t.shape[0], pad) + tuple(t.shape[2:]))], 1)


def chunked_attention(q, k, v, *, causal: bool, q_chunk: int = 512, kv_chunk: int = 1024,
                      positions_q=None, positions_k=None, policy=None):
    """Memory-efficient attention. q:[B,S_q,Hq,hd] k,v:[B,S_k,Hkv,hd] →
    [B,S_q,Hq,hd]. Never materializes more than [B,H,q_chunk,kv_chunk].

    Python loops over the q and kv chunks, with the reference's running
    max (started at -1e30) and denominator, every kv chunk visited (a
    fully masked one too, as the scan does) and `max(l, 1e-30)` at the end.
    `policy` is accepted as the reference's; the split over the model
    ranks happens in its callers (`_attend_tp`)."""
    B, Sq0, Hq, hd = q.shape
    Sk0 = k.shape[1]
    q_chunk = min(q_chunk, Sq0)
    kv_chunk = min(kv_chunk, Sk0)
    # pad ragged lengths (e.g. whisper's 1500-frame memory) up to the tile;
    # padded keys are masked out via sentinel positions, padded queries cut.
    pad_q = (-Sq0) % q_chunk
    pad_k = (-Sk0) % kv_chunk
    if pad_q:
        q = _pad_seq(q, pad_q)
    if pad_k:
        k, v = _pad_seq(k, pad_k), _pad_seq(v, pad_k)
    Sq, Sk = Sq0 + pad_q, Sk0 + pad_k
    dev = q.device
    kv_valid = torch.arange(Sk, device=dev) < Sk0
    scale = 1.0 / math.sqrt(hd)
    qT = q.transpose(1, 2)  # [B,H,S,d]
    kT = k.transpose(1, 2)
    vT = v.transpose(1, 2)
    nq, nk = Sq // q_chunk, Sk // kv_chunk

    pos_q = positions_q if positions_q is not None else torch.arange(Sq, device=dev)
    pos_k = positions_k if positions_k is not None else torch.arange(Sk, device=dev)
    if positions_q is not None and pad_q:
        pos_q = F.pad(pos_q, (0, pad_q))
    if positions_k is not None and pad_k:
        pos_k = F.pad(pos_k, (0, pad_k))

    def kv_body(o_acc, m_acc, l_acc, qi, ki, vi, mask):
        o, m, l = _chunk_attend(qi, ki, vi, mask, scale)
        m_new = torch.maximum(m_acc, m)
        c_old = torch.exp(m_acc - m_new)
        c_new = torch.exp(m - m_new)
        o_acc = o_acc * c_old[..., None] + o * c_new[..., None]
        l_acc = l_acc * c_old + l * c_new
        return o_acc, m_new, l_acc

    # the backward recomputes each [qc, kc] score block instead of keeping
    # it, as the reference's checkpointed kv scan does
    record = _recording(q, k, v)
    outs = []
    for iq in range(nq):
        qi = qT[:, :, iq * q_chunk:(iq + 1) * q_chunk]
        o_acc = torch.zeros(qi.shape, dtype=torch.float32, device=dev)
        m_acc = torch.full(qi.shape[:-1], -1e30, dtype=torch.float32, device=dev)
        l_acc = torch.zeros(qi.shape[:-1], dtype=torch.float32, device=dev)
        for ik in range(nk):
            ks = slice(ik * kv_chunk, (ik + 1) * kv_chunk)
            vk = kv_valid[ks]
            if causal:
                mq = pos_q[iq * q_chunk:(iq + 1) * q_chunk]
                mask = (mq[:, None] >= pos_k[ks][None, :]) & vk[None, :]
            elif pad_k:
                mask = vk[None, :].expand(q_chunk, kv_chunk)
            else:
                mask = None
            o_acc, m_acc, l_acc = _remat(kv_body, o_acc, m_acc, l_acc, qi, kT[:, :, ks],
                                         vT[:, :, ks], mask, record=record)
        outs.append((o_acc / torch.clamp_min(l_acc[..., None], 1e-30)).to(q.dtype))
    out = torch.cat(outs, dim=2)  # [B,H,Sq,hd]
    return out.transpose(1, 2)[:, :Sq0]


# --------------------------------------------------------------------------
# GQA attention layer (params + apply for train/prefill/decode)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttnDims:
    d_model: int
    n_heads: int
    n_kv: int
    d_head: int
    qkv_bias: bool = False
    rope_theta: float = 10000.0


def attn_init(gen, dims: AttnDims, dtype=torch.float32, device=None):
    dev = device if device is not None else gen.device
    p = {
        "wq": dense_init(gen, (dims.d_model, dims.n_heads, dims.d_head), (0,), dtype, device),
        "wk": dense_init(gen, (dims.d_model, dims.n_kv, dims.d_head), (0,), dtype, device),
        "wv": dense_init(gen, (dims.d_model, dims.n_kv, dims.d_head), (0,), dtype, device),
        "wo": dense_init(gen, (dims.n_heads, dims.d_head, dims.d_model), (0, 1), dtype,
                         device),
    }
    if dims.qkv_bias:
        p["bq"] = torch.zeros((dims.n_heads, dims.d_head), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((dims.n_kv, dims.d_head), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((dims.n_kv, dims.d_head), dtype=dtype, device=dev)
    return p


def _proj_in(x, w):
    """einsum("bsd,dhk->bshk") in the compute dtype."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).unflatten(-1, (h, k))


def _proj_out(o, w):
    """einsum("bshk,hkd->bsd") in the compute dtype."""
    h, k, d = w.shape
    return o.flatten(-2) @ w.reshape(h * k, d)


def _qkv(p, x, dims: AttnDims, positions, *, use_rope=True):
    q = _proj_in(x, p["wq"])
    k = _proj_in(x, p["wk"])
    v = _proj_in(x, p["wv"])
    if dims.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if use_rope:
        q = rope(q, positions, theta=dims.rope_theta)
        k = rope(k, positions, theta=dims.rope_theta)
    return q, k, v


def replicate_kv(k, v, n_heads: int, n_kv: int, tp: int):
    """Replicate KV heads up to the TP degree when they don't divide it
    (the reference's layout rule for a mesh: gemma's kv=1 becomes tp kv
    heads; with tp = 0, no policy, it returns k, v unchanged). Head h then
    reads kv head h // (n_heads / tp), the same values as before."""
    if tp and n_heads % tp == 0 and n_kv < tp and tp % n_kv == 0:
        r = tp // n_kv
        k = k.repeat_interleave(r, dim=2)
        v = v.repeat_interleave(r, dim=2)
    return k, v


def attn_forward(p, x, dims: AttnDims, *, causal=True, positions=None, q_chunk=512,
                 kv_chunk=1024, use_rope=True, policy=None):
    """Training / prefill self-attention. x: [B, S, d] -> (out [B, S, d],
    k, v): k and v as a cache keeps them ([B, S, n_kv, hd]; in a
    tensor-parallel pass the ranks' `Blocks` of kv heads where `wk` is
    split over the model axis)."""
    B, S, _ = x.shape
    pos = positions if positions is not None else torch.arange(S, device=x.device)
    group = tp_group(policy)
    if group is not None:
        q, k, v = _qkv_tp(p, x, dims, pos, group, use_rope=use_rope)
        out = _attend_tp(q, k, v, p["wo"], dims, group, causal=causal, pos=pos,
                         q_chunk=q_chunk, kv_chunk=kv_chunk, policy=policy)
        return out, k, v
    tp = policy.tp_size if policy else 0
    q, k, v = _qkv(p, x, dims, pos, use_rope=use_rope)
    kr, vr = replicate_kv(k, v, dims.n_heads, dims.n_kv, tp)
    o = chunked_attention(q, kr, vr, causal=causal, q_chunk=q_chunk, kv_chunk=kv_chunk,
                          positions_q=pos, positions_k=pos, policy=policy)
    return _proj_out(o, p["wo"]), k, v


def attn_apply(p, x, dims: AttnDims, *, causal=True, positions=None,
               q_chunk=512, kv_chunk=1024, use_rope=True, policy=None):
    """Training / prefill self-attention. x: [B, S, d]."""
    return attn_forward(p, x, dims, causal=causal, positions=positions, q_chunk=q_chunk,
                        kv_chunk=kv_chunk, use_rope=use_rope, policy=policy)[0]


def cross_attn_apply(p, x, kv_cache_k, kv_cache_v, dims: AttnDims,
                     q_chunk=512, kv_chunk=1024, policy=None):
    """Cross attention to precomputed memory K/V: [B, S_kv, n_kv, hd] (in
    a tensor-parallel pass the ranks' `Blocks` of kv heads or, from a
    cache, of the head dim, `cross_kv`)."""
    group = tp_group(policy)
    if group is not None:
        (q,) = _heads_proj(p, x, dims, group, ("wq",))
        if isinstance(kv_cache_k, Blocks) and kv_cache_k.dim == 3:
            o = _attend_hd_blocks(whole(q, group, 2), kv_cache_k, kv_cache_v, None,
                                  dims.d_head, group, x.dtype)
            return _out_tp(o, p["wo"], group)
        return _attend_tp(q, kv_cache_k, kv_cache_v, p["wo"], dims, group, causal=False,
                          pos=None, q_chunk=q_chunk, kv_chunk=kv_chunk, policy=policy)
    q = _proj_in(x, p["wq"])
    if dims.qkv_bias:
        q = q + p["bq"]
    o = chunked_attention(q, kv_cache_k, kv_cache_v, causal=False,
                          q_chunk=q_chunk, kv_chunk=kv_chunk, policy=policy)
    return _proj_out(o, p["wo"])


def cross_kv(p, mem, dims: AttnDims, policy=None):
    """Precompute cross-attention K/V from encoder/image memory [B, S, d]
    (in a tensor-parallel pass each the ranks' `Blocks` of kv heads where
    `wk` is split over the model axis)."""
    group = tp_group(policy)
    if group is not None:
        k, v = _heads_proj(p, mem, dims, group, ("wk", "wv"))
        return k, v
    k = _proj_in(mem, p["wk"])
    v = _proj_in(mem, p["wv"])
    if dims.qkv_bias:
        k, v = k + p["bk"], v + p["bv"]
    return k, v


def _write_at(cache, new, cur_len):
    """cache[:, clamp(cur_len)] = new, in place: `dynamic_update_slice`'s
    clamp of a one-row update into [0, S - 1]. `cur_len` is a Python int or
    a 0-d device tensor; neither reads the device."""
    S = cache.shape[1]
    new = new.to(cache.dtype)
    if isinstance(cur_len, torch.Tensor):
        idx = cur_len.reshape(1).clamp(0, S - 1).to(torch.long)
        if cache.element_size() == 1:  # float8: no index_copy_, move the bytes
            cache.view(torch.uint8).index_copy_(1, idx, new.view(torch.uint8))
        else:
            cache.index_copy_(1, idx, new)
        return cache
    c = min(max(int(cur_len), 0), S - 1)
    cache[:, c:c + 1] = new
    return cache


def _positions(cur_len, B, device):
    """[B, 1] positions, all `cur_len`."""
    if isinstance(cur_len, torch.Tensor):
        return cur_len.reshape(1, 1).expand(B, 1)
    return torch.full((B, 1), int(cur_len), dtype=torch.int32, device=device)


def _decode_attend(q, k, v, valid, d_head: int, dtype):
    """One token's attention over a cache: q [B,1,H,hd], k, v [B,S,KV,hd]
    (H a multiple of KV), `valid` [1,1,1,S] -> o [B,1,H,hd] in `dtype`."""
    groups = q.shape[2] // k.shape[2]
    # the casts commute with the repeat; made first, as float8 has no repeat
    kq = k.to(q.dtype).float().repeat_interleave(groups, dim=2)
    vq = v.float().repeat_interleave(groups, dim=2)
    s = torch.einsum("bshk,bthk->bhst", q.float(), kq) / math.sqrt(d_head)
    s = torch.where(valid, s, -1e30)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhst,bthk->bshk", w.to(v.dtype).float(), vq).to(dtype)


def attn_decode(p, x, cache_k, cache_v, cur_len, dims: AttnDims, *, use_rope=True,
                policy=None):
    """Single-token decode. x:[B,1,d]; cache:[B,S_max,n_kv,hd]. Returns
    (out [B,1,d], new_k, new_v).

    The new key and value are written into `cache_k`/`cache_v` in place at
    `cur_len` (clamped as `dynamic_update_slice` clamps), and the same
    tensors come back: the cache passed in is consumed, as a donated buffer
    is in JAX. The softmax runs over the full cache with positions > cur_len
    masked; nothing reads the device back. In a tensor-parallel pass the
    cache comes as the ranks' blocks (`ShardedCache.rows`), of kv heads or
    of the head dim, or whole: each rank writes and reads its own block
    (`_attn_decode_tp`).
    """
    group = tp_group(policy)
    if group is not None:
        return _attn_decode_tp(p, x, cache_k, cache_v, cur_len, dims, group, use_rope)
    B = x.shape[0]
    pos = _positions(cur_len, B, x.device)
    q, k, v = _qkv(p, x, dims, pos, use_rope=use_rope)
    new_k = _write_at(cache_k, k, cur_len)
    new_v = _write_at(cache_v, v, cur_len)
    valid = (torch.arange(cache_k.shape[1], device=x.device) <= cur_len)[None, None, None, :]
    o = _decode_attend(q, new_k, new_v, valid, dims.d_head, x.dtype)
    return _proj_out(o, p["wo"]), new_k, new_v


# --------------------------------------------------------------------------
# tensor parallelism over a pass's model group
# --------------------------------------------------------------------------


def tp_group(policy):
    """The model group of a tensor-parallel pass (`launch.mesh.AxisGroup`,
    carried on the policy by `models.model._shard_plan`), or None: no
    policy, an unsharded `LM` (no group), or a model axis of 1."""
    group = getattr(policy, "group", None)
    return group if group is not None and group.size > 1 else None


def blocks(t, group, dim: int) -> list:
    """The group's ranks' blocks of `t` along `dim`: `t` itself where it
    is already that list, else its slices (`AxisGroup.split`)."""
    return t if isinstance(t, list) else group.split(t, dim)


def whole(t, group, dim: int):
    """`t` whole: its ranks' blocks joined along `dim` where it is a list
    (`AxisGroup.gather`)."""
    return group.gather(t, dim) if isinstance(t, list) else t


def _heads_of(t, lo: int, n: int, groups: int):
    """The kv heads (dim 2 of `t`) that q heads [lo, lo + n) read, head h
    reading kv head h // groups: a run of them where the heads align (n /
    run q heads a kv head), else one kv head a q head."""
    first, last = lo // groups, (lo + n - 1) // groups
    if first == last or (lo % groups == 0 and n % groups == 0):
        return t[:, :, first:last + 1]
    return t.index_select(2, torch.arange(lo, lo + n, device=t.device) // groups)


def _heads_proj(p, x, dims: AttnDims, group, names) -> list:
    """The projections `names` of x ([B, S, heads, hd]): the ranks' heads
    (`Blocks` along dim 2) where the weight is split over the model axis
    (column-parallel, x fanned out to the ranks), else whole; with the
    weights' biases."""
    xs = group.fanout(x) if any(isinstance(p[n], list) for n in names) else None
    out = []
    for n in names:
        b = "b" + n[1]
        if isinstance(p[n], list):
            t = Blocks([_proj_in(xr, w) for xr, w in zip(xs, p[n])], 2)
            if dims.qkv_bias:
                t = Blocks([a + c for a, c in zip(t, blocks(p[b], group, 0))], 2)
        else:
            t = _proj_in(x, p[n])
            if dims.qkv_bias:
                t = t + whole(p[b], group, 0)
        out.append(t)
    return out


def _qkv_tp(p, x, dims: AttnDims, positions, group, *, use_rope=True):
    """`_qkv` of a tensor-parallel pass: q, k, v each the ranks' heads or
    whole (`_heads_proj`), rope applied to each block (it acts per head)."""
    out = _heads_proj(p, x, dims, group, ("wq", "wk", "wv"))
    if use_rope:
        for i in (0, 1):
            t = out[i]
            out[i] = (t.map(lambda a: rope(a, positions, theta=dims.rope_theta))
                      if isinstance(t, Blocks) else rope(t, positions, theta=dims.rope_theta))
    return out


def _out_tp(o, wo, group):
    """The output projection of attention output `o` ([B,S,H,hd], whole or
    the ranks' heads): row-parallel where `wo` is split by heads, the
    ranks' partials added in rank order (`AxisGroup.sum`), else whole."""
    if isinstance(wo, list):
        return group.sum([_proj_out(a, w) for a, w in zip(blocks(o, group, 2), wo)])
    return _proj_out(whole(o, group, 2), wo)


def _attend_tp(q, k, v, wo, dims: AttnDims, group, *, causal, pos, q_chunk, kv_chunk,
               policy):
    """Chunked attention and its output projection in a tensor-parallel
    pass -> [B, Sq, d]. Where q comes as the ranks' heads, each rank
    attends with its heads against the kv heads they read, then `_out_tp`.
    Where q is whole (heads that do not divide the model axis), each rank
    takes its rows of every q chunk, as the reference's row pin does, runs
    them against the whole k, v and the whole `wo`, and the rows join;
    where the chunk does not split (decode), every rank runs it whole."""
    kw = dict(causal=causal, kv_chunk=kv_chunk, positions_k=pos, policy=policy)
    if isinstance(q, list):
        Hr, g = q[0].shape[2], dims.n_heads // dims.n_kv
        if not isinstance(k, list):
            k, v = ([_heads_of(t, r * Hr, Hr, g) for r, t in zip(group.ranks, group.fanout(a))]
                    for a in (k, v))
        o = [chunked_attention(qr, kr, vr, q_chunk=q_chunk, positions_q=pos, **kw)
             for qr, kr, vr in zip(q, k, v)]
        return _out_tp(o, wo, group)
    k, v = whole(k, group, 2), whole(v, group, 2)
    B, Sq = q.shape[:2]
    qc = min(q_chunk, Sq)
    if Sq % qc or qc % group.size or isinstance(wo, list):
        o = chunked_attention(q, k, v, q_chunk=q_chunk, positions_q=pos, **kw)
        return _out_tp(o, wo, group)
    nq, m = Sq // qc, qc // group.size
    pq = (pos if pos is not None else torch.arange(Sq, device=q.device)).reshape(nq, qc)
    rows = blocks(q.unflatten(1, (nq, qc)), group, 2)  # [B, nq, m, H, hd] a rank
    outs = []
    for r, qr, kr, vr, w in zip(group.ranks, rows, group.fanout(k), group.fanout(v),
                                group.fanout(wo)):
        o = chunked_attention(qr.flatten(1, 2), kr, vr, q_chunk=m,
                              positions_q=pq[:, r * m:(r + 1) * m].reshape(-1), **kw)
        outs.append(_proj_out(o, w).unflatten(1, (nq, m)))
    return group.gather(outs, 2).flatten(1, 2)


def _attend_hd_blocks(q, ks, vs, valid, d_head: int, group, dtype):
    """Attention over a cache split over the model axis by head dim: each
    rank's partial scores over its slice of the head dim (q [B,Sq,H,hd]
    whole, its slice taken), added in rank order, then the softmax and each
    rank's product with its own v slice; the slices join -> o [B,Sq,H,hd].
    The cache never crosses the model axis."""
    groups = q.shape[2] // ks[0].shape[2]
    s = group.sum([torch.einsum("bshk,bthk->bhst", qr.float(), kr.to(q.dtype).float()
                                .repeat_interleave(groups, dim=2))
                   for qr, kr in zip(blocks(q, group, 3), ks)]) / math.sqrt(d_head)
    if valid is not None:
        s = torch.where(valid, s, -1e30)
    w = torch.softmax(s, dim=-1)
    return group.gather([torch.einsum("bhst,bthk->bshk", wr.to(vr.dtype).float(),
                                      vr.float().repeat_interleave(groups, dim=2)).to(dtype)
                         for wr, vr in zip(group.fanout(w), vs)], 3)


def _attn_decode_tp(p, x, cache_k, cache_v, cur_len, dims: AttnDims, group, use_rope):
    """`attn_decode` in a tensor-parallel pass. The cache is the ranks'
    `Blocks` of kv heads (dim 2: each rank attends with its q heads over
    its own block), of the head dim (dim 3, `_attend_hd_blocks`), or whole
    (one cache; each rank its q heads over the kv heads they read)."""
    B = x.shape[0]
    blocked = isinstance(cache_k, Blocks)
    S = (cache_k[0] if blocked else cache_k).shape[1]
    q, k, v = _qkv_tp(p, x, dims, _positions(cur_len, B, x.device), group,
                      use_rope=use_rope)
    by_hd = blocked and cache_k.dim == 3
    if by_hd:
        k, v = (blocks(whole(t, group, 2), group, 3) for t in (k, v))
    elif blocked:
        k, v = blocks(k, group, 2), blocks(v, group, 2)
    if blocked:
        new_k = Blocks([_write_at(c, t, cur_len) for c, t in zip(cache_k, k)], cache_k.dim)
        new_v = Blocks([_write_at(c, t, cur_len) for c, t in zip(cache_v, v)], cache_v.dim)
    else:
        new_k = _write_at(cache_k, whole(k, group, 2), cur_len)
        new_v = _write_at(cache_v, whole(v, group, 2), cur_len)
    valid = (torch.arange(S, device=x.device) <= cur_len)[None, None, None, :]
    if by_hd:
        o = _attend_hd_blocks(whole(q, group, 2), new_k, new_v, valid, dims.d_head, group,
                              x.dtype)
    elif blocked:
        o = [_decode_attend(qr, kr, vr, valid, dims.d_head, x.dtype)
             for qr, kr, vr in zip(blocks(q, group, 2), new_k, new_v)]
    elif isinstance(q, list):
        Hr, g = q[0].shape[2], dims.n_heads // dims.n_kv
        o = [_decode_attend(qr, _heads_of(kr, r * Hr, Hr, g), _heads_of(vr, r * Hr, Hr, g),
                            valid, dims.d_head, x.dtype)
             for r, qr, kr, vr in zip(group.ranks, q, group.fanout(new_k),
                                      group.fanout(new_v))]
    else:
        o = _decode_attend(q, new_k, new_v, valid, dims.d_head, x.dtype)
    return _out_tp(o, p["wo"], group), new_k, new_v


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------


def mlp_init(gen, d_model, d_ff, *, gated=True, dtype=torch.float32, device=None):
    p = {"w_up": dense_init(gen, (d_model, d_ff), (0,), dtype, device),
         "w_down": dense_init(gen, (d_ff, d_model), (0,), dtype, device)}
    if gated:
        p["w_gate"] = dense_init(gen, (d_model, d_ff), (0,), dtype, device)
    return p


def _mlp(p, x, act: str):
    up = x @ p["w_up"]
    if "w_gate" in p:
        h = _act(x @ p["w_gate"], act) * up
    else:
        h = _act(up, act)
    return h @ p["w_down"]


def mlp_apply(p, x, *, act: str = "silu", policy=None):
    """The FFN. In a tensor-parallel pass whose weights come as the ranks'
    blocks of the hidden dim: column-parallel `w_up`/`w_gate`, row-parallel
    `w_down`, the ranks' partials added in rank order."""
    group = tp_group(policy)
    if group is None or not isinstance(p["w_up"], list):
        return _mlp(p, x, act)
    ranks = [{k: w[i] for k, w in p.items()} for i in range(len(p["w_up"]))]
    return group.sum([_mlp(pr, xr, act) for pr, xr in zip(ranks, group.fanout(x))])
