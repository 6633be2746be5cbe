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
divide the axis each rank attends with its own rows of the sequence (the
reference's `pin(allow_row_shard=True)`, `_attend_rows`), a head-dim-split
cache is read by partial scores, and the FFN is column/row-parallel. Without a group
`replicate_kv` repeats kv heads up to the model axis as the reference
does.

Megatron's sequence parallelism (`seq_parallel`, the reference's
`_residual_spec`): where a tensor-parallel pass keeps its sequence as
the model ranks' rows between blocks, a layer takes its input as those
rows (`launch.mesh.Blocks` along dim 1), joins them on the way in
(`_enter`: an all-gather) and leaves its output as the ranks' rows: the
row-parallel partials through a reduce-scatter (`_sum_out`), an output
every rank computes alike cut to each rank's rows (`_cut`, no traffic).

A decode over a cache whose sequence lies on the batch axes (the
long-context layout, `launch.mesh.Slices`) runs the reference's flash
merge (`launch/serving.py`) inside the layer (`_attend_slices`): each
slice its partial on its own device, the partials merged over the batch
axes; no cache row moves.

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

from repro_torch.launch.mesh import Blocks, Slices, over, pmax, psum

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
    split over the model axis). In a sequence-parallel pass x and out are
    the ranks' rows, k and v the whole sequence's."""
    group = tp_group(policy)
    S = seq_len(x, group)
    dev = x[0].device if isinstance(x, Blocks) else x.device
    pos = positions if positions is not None else torch.arange(S, device=dev)
    if group is not None and isinstance(x, Blocks) and not isinstance(p["wq"], list):
        # heads that do not divide the axis (nor, then, kv heads): k and v
        # from the joined rows, each rank attends with its own rows
        k, v = _heads_proj(p, group.gather(x, x.dim), dims, group, ("wk", "wv"))
        if use_rope:
            k = rope(k, pos, theta=dims.rope_theta)
        out = _attend_rows(p, x, k, v, dims, group, causal=causal, pos=pos, q_chunk=q_chunk,
                           kv_chunk=kv_chunk, use_rope=use_rope, policy=policy)
        return out, k, v
    if group is not None:
        q, k, v = _qkv_tp(p, x, dims, pos, group, use_rope=use_rope)
        out = _attend_tp(q, k, v, p["wo"], dims, group, causal=causal, pos=pos,
                         q_chunk=q_chunk, kv_chunk=kv_chunk, policy=policy,
                         sp=isinstance(x, Blocks))
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
    if group is not None and isinstance(x, Blocks) and not isinstance(p["wq"], list):
        return _attend_rows(p, x, kv_cache_k, kv_cache_v, dims, group, causal=False, pos=None,
                            q_chunk=q_chunk, kv_chunk=kv_chunk, use_rope=False, policy=policy)
    if group is not None:
        sp = isinstance(x, Blocks)
        (q,) = _heads_proj(p, x, dims, group, ("wq",))
        if isinstance(kv_cache_k, Blocks) and kv_cache_k.dim == 3:
            o = _attend_hd_blocks(whole(q, group, 2), kv_cache_k, kv_cache_v, None,
                                  dims.d_head, group, (x[0] if sp else x).dtype)
            return _out_tp(o, p["wo"], group, sp)
        return _attend_tp(q, kv_cache_k, kv_cache_v, p["wo"], dims, group, causal=False,
                          pos=None, q_chunk=q_chunk, kv_chunk=kv_chunk, policy=policy, sp=sp)
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
    (`_attn_decode_tp`). A cache whose sequence lies on the batch axes
    comes as its slices (`launch.mesh.Slices`, in `Blocks` where the model
    axis splits it too) and is read by the flash merge (`_attend_slices`).
    """
    group = tp_group(policy)
    if group is None and _sliced(cache_k):  # a model axis of 1
        group = policy.group
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


def seq_parallel(policy, S: int) -> bool:
    """Does a pass of `policy` keep a sequence of S rows as its model
    ranks' rows between blocks (Megatron-SP, the reference's
    `_residual_spec`)? In a tensor-parallel pass whose policy asks for it
    (`seq_shard_residual`) and whose sequence divides over the ranks;
    else (decode's one row, a prompt of another length) the residual
    stays replicated, where XLA would pad the uneven shard instead."""
    group = tp_group(policy)
    return group is not None and policy.seq_shard_residual and S % group.size == 0


def seq_len(x, group) -> int:
    """The sequence length of x [B, S, ...], or of the whole tensor whose
    ranks' rows x is (`Blocks` along dim 1: this process's ranks')."""
    return x[0].shape[1] * group.size if isinstance(x, Blocks) else x.shape[1]


def _enter(x, group, fan: bool):
    """A tensor-parallel layer's input: (x whole, x for each rank this
    process runs, or None without `fan`). A replicated x is fanned out
    (`AxisGroup.fanout`); a sequence-parallel pass's rows (`Blocks`) are
    joined, an all-gather (`AxisGroup.gather_fanout`, whose backward is
    the reduce-scatter; without `fan`, `gather`: every rank computes
    from x alike)."""
    if isinstance(x, Blocks):
        if fan:
            return group.gather_fanout(x, x.dim)
        return group.gather(x, x.dim), None
    return x, (group.fanout(x) if fan else None)


def _sum_out(parts: list, group, sp: bool):
    """The ranks' row-parallel partials added in rank order: whole, or in
    a sequence-parallel pass each rank its rows (`sum_scatter`)."""
    return group.sum_scatter(parts, 1) if sp else group.sum(parts)


def _cut(y, group, sp: bool):
    """An output every rank computes alike: whole, or in a
    sequence-parallel pass each rank its rows (a cut; its backward joins
    the ranks' gradients)."""
    return group.split(y, 1) if sp else y


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
    x, xs = _enter(x, group, any(isinstance(p[n], list) for n in names))
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


def _out_tp(o, wo, group, sp: bool = False):
    """The output projection of attention output `o` ([B,S,H,hd], whole or
    the ranks' heads): row-parallel where `wo` is split by heads, the
    ranks' partials added in rank order (`_sum_out`), else whole (`_cut`
    in a sequence-parallel pass)."""
    if isinstance(wo, list):
        return _sum_out([_proj_out(a, w) for a, w in zip(blocks(o, group, 2), wo)], group, sp)
    return _cut(_proj_out(whole(o, group, 2), wo), group, sp)


def _attend_tp(q, k, v, wo, dims: AttnDims, group, *, causal, pos, q_chunk, kv_chunk,
               policy, sp=False):
    """Chunked attention and its output projection in a tensor-parallel
    pass -> [B, Sq, d]. Where q comes as the ranks' heads, each rank
    attends with its heads against the kv heads they read; where q is
    whole (heads that do not divide the model axis, with a replicated x:
    decode, a sequence that does not divide) every rank attends alike
    (a sequence-parallel pass's rows take `_attend_rows`). Then `_out_tp`
    (with `sp` the output is the ranks' rows)."""
    kw = dict(causal=causal, q_chunk=q_chunk, kv_chunk=kv_chunk, positions_q=pos,
              positions_k=pos, policy=policy)
    if isinstance(q, list):
        Hr, g = q[0].shape[2], dims.n_heads // dims.n_kv
        if not isinstance(k, list):
            k, v = ([_heads_of(t, r * Hr, Hr, g) for r, t in zip(group.ranks, group.fanout(a))]
                    for a in (k, v))
        o = [chunked_attention(qr, kr, vr, **kw) for qr, kr, vr in zip(q, k, v)]
    else:
        o = chunked_attention(q, whole(k, group, 2), whole(v, group, 2), **kw)
    return _out_tp(o, wo, group, sp)


def _attend_rows(p, x, k, v, dims: AttnDims, group, *, causal, pos, q_chunk, kv_chunk,
                 use_rope, policy):
    """Attention and its output projection in a sequence-parallel pass
    whose heads do not divide the model axis (`wq`, `wo` whole): each rank
    its own rows of the sequence (x, the ranks' `Blocks` along dim 1)
    against the whole k, v (each rank's view: `fanout`), with its own view
    of `wq`, `bq` and `wo`, whose gradients add over the ranks in rank
    order (the reference's row pin with a rank's rows its sequence block),
    so the output leaves as the ranks' rows and nothing is joined on the
    way out."""
    n = x[0].shape[1]
    dev = x[0].device
    names = ["wq", "wo"] + (["bq"] if dims.qkv_bias else [])
    views = {m: group.fanout(whole(p[m], group, 0)) for m in names}
    outs = []
    for i, (r, xr, kr, vr) in enumerate(zip(group.ranks, x, group.fanout(k), group.fanout(v))):
        rows = (pos[r * n:(r + 1) * n] if pos is not None else
                torch.arange(r * n, (r + 1) * n, device=dev))
        q = _proj_in(xr, views["wq"][i])
        if dims.qkv_bias:
            q = q + views["bq"][i]
        if use_rope:
            q = rope(q, rows, theta=dims.rope_theta)
        o = chunked_attention(q, kr, vr, causal=causal, q_chunk=min(q_chunk, n),
                              kv_chunk=kv_chunk, positions_q=rows, positions_k=pos,
                              policy=policy)
        outs.append(_proj_out(o, views["wo"][i]))
    return Blocks(outs, 1)


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
    (one cache; each rank its q heads over the kv heads they read), or
    its sequence slices (`_attend_slices`)."""
    B = x.shape[0]
    blocked = isinstance(cache_k, Blocks)
    q, k, v = _qkv_tp(p, x, dims, _positions(cur_len, B, x.device), group,
                      use_rope=use_rope)
    if _sliced(cache_k):
        o = _attend_slices(q, k, v, cache_k, cache_v, cur_len, dims, group, x.dtype)
        return _out_tp(o, p["wo"], group), cache_k, cache_v
    S = (cache_k[0] if blocked else cache_k).shape[1]
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
# context-parallel decode: the flash merge over a sequence-sharded cache
# --------------------------------------------------------------------------


def _sliced(cache) -> bool:
    """Is `cache` a leaf's sequence slices (`Slices`, or the model ranks'
    `Blocks` of them)?"""
    return isinstance(cache[0] if isinstance(cache, Blocks) else cache, Slices)


def _scores(q, k):
    """q [B,1,H,hd] . k [B,S,KV,hd] -> [B,H,1,S] f32 (unscaled), head h
    reading kv head h // (H / KV)."""
    kq = k.repeat_interleave(q.shape[2] // k.shape[2], dim=2)
    return torch.einsum("bthk,bshk->bhts", q.float(), kq.to(q.dtype).float())


def _flash_partial(s, v, valid):
    """One slice's partial attention from its scaled scores s [B,H,1,S_loc]
    f32 and values v [B,S_loc,KV,hd], rows past `valid` ([S_loc] bool)
    masked -> (o [B,1,H,hd] f32 unnormalized, m [B,1,H], l [B,1,H])."""
    vq = v.repeat_interleave(s.shape[1] // v.shape[2], dim=2)
    s = torch.where(valid[None, None, None, :], s, -math.inf)
    m = s.amax(-1)  # [B,H,1]
    m_safe = torch.where(torch.isfinite(m), m, -1e30)
    p = torch.where(torch.isfinite(s), torch.exp(s - m_safe[..., None]), 0.0)
    l = p.sum(-1)
    o = torch.einsum("bhts,bshk->bthk", p.to(vq.dtype).float(), vq.float())
    return o, m_safe.transpose(1, 2), l.transpose(1, 2)


def _local_attend(q, k, v, valid, scale):
    """q:[B,1,H,hd]; k,v:[B,S_loc,KV,hd]; valid:[S_loc] bool.
    Returns (o [B,1,H,hd] f32 unnormalized, m [B,1,H], l [B,1,H])."""
    return _flash_partial(_scores(q, k) * scale, v, valid)


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
    dst = cache.view(torch.uint8) if cache.element_size() == 1 else cache  # float8
    src = new.view(torch.uint8) if cache.element_size() == 1 else new
    dst.index_copy_(1, idx, torch.where(owns, src, dst.index_select(1, idx)))
    return cache


def _cp_partial(dims: AttnDims, p, x, ck, cv, cur_len, rank: int):
    """One shard's part of a decode-attention layer over its cache slices
    [B,S_loc,KV,hd] (rank `rank` along the sequence axis): the owner's
    write of the new k, v (in place), then the partial attention ->
    ((o, m, l), ck, cv)."""
    S_loc = ck.shape[1]
    offset = rank * S_loc
    q, k, v = _qkv(p, x, dims, _positions(cur_len, x.shape[0], x.device))
    ck = _write_owned(ck, k, cur_len, offset)
    cv = _write_owned(cv, v, cur_len, offset)
    valid = (torch.arange(S_loc, device=x.device) + offset) <= cur_len
    return _local_attend(q, ck, cv, valid, 1.0 / math.sqrt(dims.d_head)), ck, cv


def _flash_merge(partials: list) -> list:
    """The flash merge of one sequence group's partials (o, m, l), in rank
    order -> the normalized attention output [B,1,H,hd] f32, a copy a
    member: m = max m_i, l = sum l_i exp(m_i - m), o = sum o_i exp(m_i -
    m) / l."""
    ms = [m for _, m, _ in partials]
    m_g = pmax(ms)
    cs = [torch.exp(m - mg) for m, mg in zip(ms, m_g)]
    l_g = psum([l * c for (_, _, l), c in zip(partials, cs)])
    o_g = psum([o * c[..., None] for (o, _, _), c in zip(partials, cs)])
    return [o / torch.clamp_min(l, 1e-30)[..., None] for o, l in zip(o_g, l_g)]


def _cp_merge(partials: list, ps: list, xs: list) -> list:
    """The flash merge of one sequence group's partials (o, m, l), in rank
    order: O(B·H·hd) a shard -> the attention output [B,1,d] of each rank
    whose x is given (None for the others)."""
    return [None if x is None else _proj_out(o.to(x.dtype), p["wo"])
            for o, x, p in zip(_flash_merge(partials), xs, ps)]


def _attend_slices(q, k, v, cache_k, cache_v, cur_len, dims: AttnDims, group, dtype):
    """One token's attention over a cache whose sequence lies on the batch
    axes, as this process's slices of it (`Slices`: the long-context
    layout, `cache_specs` with `seq_shard`): the reference's flash merge
    (`launch/serving.py`) in the decode layer. Each slice writes the new
    row where it owns `cur_len` (in place) and computes its partial (o,
    m, l) on its own device; the partials merge over the batch axes in
    rank order (`launch.mesh.over`: over processes only the partials
    cross; no cache row moves). A cache split over the model axis by kv
    heads (`Blocks` along dim 2) merges each rank's heads; by head dim
    (dim 3) the ranks' partial scores add first within each slice, in
    rank order as `_attend_hd_blocks` adds them, and each rank's partial
    reads its own v slice. q, k, v: the new token's ([B,1,H|KV,hd], whole
    or the ranks' heads) -> o [B,1,H,hd] in `dtype`, whole or the ranks'
    heads."""
    scale = 1.0 / math.sqrt(dims.d_head)
    by_hd = isinstance(cache_k, Blocks) and cache_k.dim == 3
    if by_hd:
        qs, ks, vs = (blocks(whole(t, group, 2), group, 3) for t in (q, k, v))
    elif isinstance(cache_k, Blocks):
        qs, ks, vs = (blocks(t, group, 2) for t in (q, k, v))
    else:  # not split over the model axis: every rank the whole token
        qs, ks, vs = ([whole(t, group, 2)] for t in (q, k, v))
        cache_k, cache_v = [cache_k], [cache_v]
    scores, valid = [], []
    for qr, ck, cv, kr, vr in zip(qs, cache_k, cache_v, ks, vs):
        row = []
        for ct, vt, off in zip(ck, cv, ck.offsets):
            n = cur_len.to(ct.device) if isinstance(cur_len, torch.Tensor) else cur_len
            _write_owned(ct, kr.to(ct.device), n, off)
            _write_owned(vt, vr.to(vt.device), n, off)
            row.append(_scores(qr.to(ct.device), ct))
            if len(valid) < len(ck):
                valid.append((torch.arange(ct.shape[1], device=ct.device) + off) <= n)
        scores.append(row)
    if by_hd:  # the ranks' partial scores of each slice, added in rank order
        summed = [group.sum([row[i] for row in scores]) for i in range(len(valid))]
        scores = [summed] * len(scores)
    partials = {}  # each on its slice's device (a rank's shard may sit on another card)
    for row, cv in zip(scores, cache_v):
        for s, vt, m, ok in zip(row, cv, cv.shards, valid):
            partials[m] = _flash_partial(s.to(vt.device) * scale, vt, ok.to(vt.device))
    merged = over(cache_v[0].mesh, cache_v[0].axes, _flash_merge, partials)
    o = [merged[cv.shards[0]].to(qr.device, dtype) for cv, qr in zip(cache_v, qs)]
    if by_hd:
        return group.gather(o, 3)
    return Blocks(o, 2) if isinstance(cache_v, Blocks) else o[0]


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
    `w_down`, the ranks' partials added in rank order (in a
    sequence-parallel pass x and the output are the ranks' rows)."""
    group = tp_group(policy)
    sp = isinstance(x, Blocks)  # a sequence-parallel pass's rows
    if group is None or not isinstance(p["w_up"], list):
        return _cut(_mlp(p, group.gather(x, 1), act), group, True) if sp else _mlp(p, x, act)
    ranks = [{k: w[i] for k, w in p.items()} for i in range(len(p["w_up"]))]
    _, xs = _enter(x, group, True)
    return _sum_out([_mlp(pr, xr, act) for pr, xr in zip(ranks, xs)], group, sp)
