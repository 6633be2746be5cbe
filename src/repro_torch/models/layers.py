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

A ShardingPolicy (`policy`) is accepted where the reference's is. Its
pins (`with_sharding_constraint` on the chunk stacks) are layouts, which
the single-controller port has no use for: they change no number here.
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
    `policy`'s pins are layouts, with no numeric effect in one process."""
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


def attn_apply(p, x, dims: AttnDims, *, causal=True, positions=None,
               q_chunk=512, kv_chunk=1024, use_rope=True, policy=None):
    """Training / prefill self-attention. x: [B, S, d]."""
    B, S, _ = x.shape
    tp = policy.tp_size if policy else 0
    pos = positions if positions is not None else torch.arange(S, device=x.device)
    q, k, v = _qkv(p, x, dims, pos, use_rope=use_rope)
    k, v = replicate_kv(k, v, dims.n_heads, dims.n_kv, tp)
    o = chunked_attention(q, k, v, causal=causal, q_chunk=q_chunk, kv_chunk=kv_chunk,
                          positions_q=pos, positions_k=pos, policy=policy)
    return _proj_out(o, p["wo"])


def cross_attn_apply(p, x, kv_cache_k, kv_cache_v, dims: AttnDims,
                     q_chunk=512, kv_chunk=1024, policy=None):
    """Cross attention to precomputed memory K/V: [B, S_kv, n_kv, hd]."""
    q = _proj_in(x, p["wq"])
    if dims.qkv_bias:
        q = q + p["bq"]
    o = chunked_attention(q, kv_cache_k, kv_cache_v, causal=False,
                          q_chunk=q_chunk, kv_chunk=kv_chunk, policy=policy)
    return _proj_out(o, p["wo"])


def cross_kv(p, mem, dims: AttnDims):
    """Precompute cross-attention K/V from encoder/image memory [B, S, d]."""
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


def attn_decode(p, x, cache_k, cache_v, cur_len, dims: AttnDims, *, use_rope=True):
    """Single-token decode. x:[B,1,d]; cache:[B,S_max,n_kv,hd]. Returns
    (out [B,1,d], new_k, new_v).

    The new key and value are written into `cache_k`/`cache_v` in place at
    `cur_len` (clamped as `dynamic_update_slice` clamps), and the same
    tensors come back: the cache passed in is consumed, as a donated buffer
    is in JAX. The softmax runs over the full cache with positions > cur_len
    masked; nothing reads the device back.
    """
    B = x.shape[0]
    pos = _positions(cur_len, B, x.device)
    q, k, v = _qkv(p, x, dims, pos, use_rope=use_rope)
    new_k = _write_at(cache_k, k, cur_len)
    new_v = _write_at(cache_v, v, cur_len)
    groups = dims.n_heads // dims.n_kv
    # the casts commute with the repeat; made first, as float8 has no repeat
    kq = new_k.to(q.dtype).float().repeat_interleave(groups, dim=2)
    vq = new_v.float().repeat_interleave(groups, dim=2)
    s = torch.einsum("bshk,bthk->bhst", q.float(), kq) / math.sqrt(dims.d_head)
    valid = (torch.arange(cache_k.shape[1], device=x.device) <= cur_len)[None, None, None, :]
    s = torch.where(valid, s, -1e30)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhst,bthk->bshk", w.to(new_v.dtype).float(), vq).to(x.dtype)
    return _proj_out(o, p["wo"]), new_k, new_v


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------


def mlp_init(gen, d_model, d_ff, *, gated=True, dtype=torch.float32, device=None):
    p = {"w_up": dense_init(gen, (d_model, d_ff), (0,), dtype, device),
         "w_down": dense_init(gen, (d_ff, d_model), (0,), dtype, device)}
    if gated:
        p["w_gate"] = dense_init(gen, (d_model, d_ff), (0,), dtype, device)
    return p


def mlp_apply(p, x, *, act: str = "silu"):
    up = x @ p["w_up"]
    if "w_gate" in p:
        h = _act(x @ p["w_gate"], act) * up
    else:
        h = _act(up, act)
    return h @ p["w_down"]
