"""Mamba-2 SSD (state-space duality) block — chunked dual form for
training/prefill, O(1)-state recurrence for decode (port of
`repro/models/ssm.py`).

Follows the SSD algorithm of arXiv:2405.21060 §6: the sequence is split
into chunks; within a chunk the (semi-separable) attention-like quadratic
form runs as batched matrix products, and a short loop passes the
[B, H, d_state, headdim] state between chunks. Sequences longer than
`scan_block` run in macro-blocks that carry the state, as the reference's.

Jamba's mamba layers reuse this block. Numerics follow the reference: the
products it takes with `preferred_element_type=f32` upcast their operands
here, and `M`, `prev_states` and the state inputs are rounded to the
compute dtype on purpose before their products. softplus is
`logaddexp(x, 0)`, as `jax.nn.softplus` is.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.launch.mesh import Blocks
from repro_torch.models.layers import (_cut, _enter, _heads_of, _pad_seq, _sum_out, blocks,
                                       dense_init, rms_norm, tp_group, whole)


@dataclasses.dataclass(frozen=True)
class SSMDims:
    d_model: int
    d_state: int = 128
    headdim: int = 64
    n_groups: int = 1
    expand: int = 2
    d_conv: int = 4
    chunk: int = 128
    scan_block: int = 4096  # macro-block: bounds SSD transients at long seq

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.headdim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state


def ssm_init(gen, dims: SSMDims, dtype=torch.float32, device=None):
    dev = device if device is not None else gen.device
    d_in_proj = 2 * dims.d_inner + 2 * dims.n_groups * dims.d_state + dims.n_heads
    f32 = torch.float32
    return {
        "in_proj": dense_init(gen, (dims.d_model, d_in_proj), (0,), dtype, device),
        "conv_w": dense_init(gen, (dims.d_conv, dims.conv_dim), (0,), dtype, device),
        "conv_b": torch.zeros((dims.conv_dim,), dtype=dtype, device=dev),
        "A_log": torch.zeros((dims.n_heads,), dtype=f32, device=dev),
        "D": torch.ones((dims.n_heads,), dtype=f32, device=dev),
        "dt_bias": torch.zeros((dims.n_heads,), dtype=f32, device=dev),
        "norm": torch.ones((dims.d_inner,), dtype=dtype, device=dev),
        "out_proj": dense_init(gen, (dims.d_inner, dims.d_model), (0,), dtype, device),
    }


def softplus(x):
    """`jax.nn.softplus`: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def _split_zxbcdt(zxbcdt, dims: SSMDims):
    di, gn = dims.d_inner, dims.n_groups * dims.d_state
    z = zxbcdt[..., :di]
    xBC = zxbcdt[..., di:di + di + 2 * gn]
    dt = zxbcdt[..., di + di + 2 * gn:]
    return z, xBC, dt


def _causal_conv(xBC, w, b):
    """Depthwise causal conv over seq. xBC: [B, L, Cd]; w: [K, Cd]. The
    K taps are summed in the reference's order, from 0."""
    K, L = w.shape[0], xBC.shape[1]
    pad = torch.cat([xBC.new_zeros((xBC.shape[0], K - 1, xBC.shape[2])), xBC], 1)
    out = 0
    for i in range(K):
        out = out + pad[:, i:i + L] * w[i]
    return F.silu(out + b)


def _segsum(a):
    """a: [..., T] log-decays → [..., T, T] with S[i,j] = sum_{j<k<=i} a_k
    (lower-triangular; -inf above diagonal)."""
    T = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    s = cum[..., :, None] - cum[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=a.device))
    return torch.where(mask, s, -torch.inf)


def ssd_chunked(x, dt, A_log, B, C, D, chunk: int, h0=None, policy=None):
    """SSD dual-form scan.

    x: [b,l,h,p]  dt: [b,l,h] (post-softplus)  A_log: [h]
    B, C: [b,l,g,n]  D: [h]  h0: [b,h,n,p] initial state (macro-block carry)
    → (y [b,l,h,p], final_state [b,h,n,p])

    `policy` is accepted as the reference's; its `shard_h` (the head dim
    on the model axis) is `_ssm_tp`'s split of the heads over the ranks.
    """
    b, l0, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    # pad ragged lengths with dt=0 steps: decay exp(0)=1 and B·dt=0, so the
    # state passes through padding untouched and y[:l0] is exact
    pad = (-l0) % chunk
    if pad:
        x, dt, B, C = (_pad_seq(t, pad) for t in (x, dt, B, C))
    l = l0 + pad
    nc = l // chunk
    rep = h // g
    a = (-torch.exp(A_log))[None, None, :] * dt  # [b,l,h] log decay

    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h)
    ac = a.reshape(b, nc, chunk, h)
    Bh = B.reshape(b, nc, chunk, g, n).repeat_interleave(rep, dim=3)
    Ch = C.reshape(b, nc, chunk, g, n).repeat_interleave(rep, dim=3)

    a_cum = torch.cumsum(ac, dim=2)  # [b,nc,cl,h]
    # --- intra-chunk (the attention-like quadratic form) --------------------
    Ldec = torch.exp(_segsum(ac.permute(0, 1, 3, 2)))  # [b,nc,h,cl,cl]
    S = torch.einsum("bzihn,bzjhn->bzhij", Ch.float(), Bh.float())
    M = S * Ldec
    xdt = xc * dtc[..., None]
    Ydiag = torch.einsum("bzhij,bzjhp->bzihp", M.to(x.dtype).float(), xdt.float())

    # --- chunk-final states ---------------------------------------------------
    decay_states = torch.exp(a_cum[:, :, -1:, :] - a_cum)  # [b,nc,cl,h]
    states = torch.einsum("bzjhn,bzjhp->bzhnp",
                          (Bh * (dtc * decay_states)[..., None]).to(x.dtype).float(),
                          xc.float())  # [b,nc,h,n,p]

    # --- inter-chunk recurrence (short loop over nc) --------------------------
    chunk_decay = torch.exp(a_cum[:, :, -1, :])  # [b,nc,h]
    prev = h0 if h0 is not None else torch.zeros((b, h, n, p), dtype=torch.float32,
                                                 device=x.device)
    prevs = []
    for z in range(nc):
        prevs.append(prev)
        prev = prev * chunk_decay[:, z, :, None, None] + states[:, z]
    final = prev
    prev_states = torch.stack(prevs, dim=1)  # [b,nc,h,n,p]

    # --- state → output (off-diagonal term) ----------------------------------
    Yoff = torch.einsum("bzihn,bzhnp->bzihp", (Ch * torch.exp(a_cum)[..., None]).float(),
                        prev_states.to(x.dtype).float())

    y = (Ydiag + Yoff).reshape(b, l, h, p).to(x.dtype)
    y = y + D[None, None, :, None] * x
    return y[:, :l0], final


def _scan(xs, dt, A_log, Bm, Cm, D, dims: SSMDims):
    """`ssd_chunked` over [B, L, h, p] heads, in macro-blocks that carry
    the state where L is longer than `dims.scan_block` (and a multiple of
    it), bounding the SSD transients to one block, as the reference's
    `lax.scan` does -> (y, final state)."""
    B, L, h, hp = xs.shape
    blk = dims.scan_block
    if not (L > blk and L % blk == 0):
        return ssd_chunked(xs, dt, A_log, Bm, Cm, D, dims.chunk)
    state = torch.zeros((B, h, dims.d_state, hp), dtype=torch.float32, device=xs.device)
    ys = []
    for i in range(L // blk):
        s = slice(i * blk, (i + 1) * blk)
        y_b, state = ssd_chunked(xs[:, s], dt[:, s], A_log, Bm[:, s], Cm[:, s], D,
                                 dims.chunk, h0=state)
        ys.append(y_b)
    return torch.cat(ys, dim=1), state


def ssm_apply(p, x, dims: SSMDims, policy=None):
    """Train/prefill. x: [B, L, d] → (y [B, L, d], final_state, conv_tail).
    In a tensor-parallel pass whose heads divide the model axis each rank
    runs its own heads (`_ssm_tp`). In a sequence-parallel pass x and y
    are the model ranks' rows: the scan needs the whole sequence, so the
    rows are joined first."""
    group = tp_group(policy)
    if group is not None and any(isinstance(p[n], list) for n in ("in_proj", "out_proj")):
        return _ssm_tp(p, x, None, None, dims, group)
    if isinstance(x, Blocks):  # weights not split: every rank runs the sequence
        y, final, tail = ssm_apply(p, group.gather(x, x.dim), dims)
        return _cut(y, group, True), final, tail
    B, L, _ = x.shape
    zxbcdt = x @ p["in_proj"]
    z, xBC, dt = _split_zxbcdt(zxbcdt, dims)
    # decode warm-start: a copy, so that the cache does not keep xBC alive
    conv_tail = xBC[:, -(dims.d_conv - 1):, :].clone()
    xBC = _causal_conv(xBC, p["conv_w"], p["conv_b"])
    di, gn = dims.d_inner, dims.n_groups * dims.d_state
    xs = xBC[..., :di].reshape(B, L, dims.n_heads, dims.headdim)
    Bm = xBC[..., di:di + gn].reshape(B, L, dims.n_groups, dims.d_state)
    Cm = xBC[..., di + gn:].reshape(B, L, dims.n_groups, dims.d_state)
    dt = softplus(dt.float() + p["dt_bias"])
    y, final = _scan(xs, dt, p["A_log"], Bm, Cm, p["D"], dims)
    y = y.reshape(B, L, di)
    y = rms_norm(y * F.silu(z), p["norm"])
    return y @ p["out_proj"], final, conv_tail


def _step(xs, Bm, Cm, dt, A_log, D, dt_bias, ssm_state, dims: SSMDims, n_groups: int):
    """One token's state update and readout over h heads: xs [B, h, P],
    Bm, Cm [B, g, N] (head i reads group i // (h / g)), dt [B, h] before
    the softplus -> (y [B, h, P] f32, new state)."""
    rep = xs.shape[1] // n_groups
    Bh = Bm.repeat_interleave(rep, dim=1).float()  # [B, H, N]
    Ch = Cm.repeat_interleave(rep, dim=1).float()
    dt = softplus(dt.float() + dt_bias)  # [B, H]
    dA = torch.exp(-torch.exp(A_log)[None] * dt)  # [B, H]
    upd = (dt[..., None] * Bh)[..., :, None] * xs.float()[:, :, None, :]
    new_state = ssm_state * dA[..., None, None] + upd  # [B,H,N,P]
    y = torch.einsum("bhn,bhnp->bhp", Ch, new_state) + D[None, :, None] * xs
    return y, new_state


def ssm_decode(p, x, ssm_state, conv_state, dims: SSMDims, policy=None):
    """Single-token recurrence. x: [B, 1, d]; ssm_state: [B, H, N, P] f32;
    conv_state: [B, d_conv-1, conv_dim]. Returns (y, new_ssm, new_conv).
    In a tensor-parallel pass the states may come as the ranks' blocks
    (of heads, of conv channels; `ShardedCache.rows`) and come back so."""
    group = tp_group(policy)
    if group is not None and any(isinstance(p[n], list) for n in ("in_proj", "out_proj")):
        return _ssm_tp(p, x, ssm_state, conv_state, dims, group)
    B = x.shape[0]
    zxbcdt = x @ p["in_proj"]
    z, xBC, dt = _split_zxbcdt(zxbcdt, dims)
    window = torch.cat([conv_state, xBC.to(conv_state.dtype)], dim=1)
    new_conv = window[:, 1:]
    conv_out = F.silu((window * p["conv_w"][None]).sum(1) + p["conv_b"])  # [B, Cd]
    di, gn = dims.d_inner, dims.n_groups * dims.d_state
    xs = conv_out[:, :di].reshape(B, dims.n_heads, dims.headdim)
    Bm = conv_out[:, di:di + gn].reshape(B, dims.n_groups, dims.d_state)
    Cm = conv_out[:, di + gn:].reshape(B, dims.n_groups, dims.d_state)
    y, new_state = _step(xs, Bm, Cm, dt[:, 0], p["A_log"], p["D"], p["dt_bias"], ssm_state,
                         dims, dims.n_groups)
    y = y.reshape(B, 1, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"])
    return y @ p["out_proj"], new_state, new_conv


# --------------------------------------------------------------------------
# tensor parallelism: each model rank its heads (the reference's shard_h)
# --------------------------------------------------------------------------


def _ssm_tp(p, x, ssm_state, conv_state, dims: SSMDims, group):
    """`ssm_apply` (states None) or `ssm_decode` in a tensor-parallel pass.
    `in_proj` is column-parallel: its column blocks do not line up with
    z/x/B/C/dt, so the ranks' blocks of zxbcdt join over the ranks (an
    activation all-gather); the depthwise conv runs on each rank's
    channel block of `conv_w`, its blocks joined likewise. Where the heads
    divide the model axis each rank then runs its own heads (their x, dt,
    z, and the B/C groups they read), the gated norm takes its mean square
    from the ranks' partial sums (in rank order) and `out_proj` is
    row-parallel; else every rank runs every head. -> (y, final state or
    new ssm state, conv tail or new conv state), a state in the layout it
    came in (blocks or whole). In a sequence-parallel pass (x the ranks'
    rows) the rows are joined on the way in and y leaves as the ranks'
    rows (`_sum_out`, `_cut`)."""
    sp = isinstance(x, Blocks)
    x, xs = _enter(x, group, isinstance(p["in_proj"], list))
    B, L, _ = x.shape
    H, P, G, N = dims.n_heads, dims.headdim, dims.n_groups, dims.d_state
    di, gn, K = dims.d_inner, G * dims.d_state, dims.d_conv
    tp = group.size
    if isinstance(p["in_proj"], list):
        zxbcdt = group.gather([xr @ w for xr, w in zip(xs, p["in_proj"])], 2)
    else:
        zxbcdt = x @ p["in_proj"]
    z, xBC, dt = _split_zxbcdt(zxbcdt, dims)
    decode = ssm_state is not None
    if decode:  # the conv over the cached window, per channel block where it is split
        blocked = isinstance(conv_state, list)
        if isinstance(p["conv_w"], list):
            cs = blocks(conv_state, group, 2)
            wins = [torch.cat([c, xb.to(c.dtype)], 1)
                    for c, xb in zip(cs, blocks(xBC, group, 2))]
            new_conv = Blocks([w_[:, 1:] for w_ in wins], 2)
            conv = group.gather([F.silu((w_ * cw[None]).sum(1) + cb) for w_, cw, cb in zip(
                wins, p["conv_w"], blocks(p["conv_b"], group, 0))], 1)
            if not blocked:
                new_conv = group.gather(new_conv, 2)
        else:
            cs = whole(conv_state, group, 2)
            win = torch.cat([cs, xBC.to(cs.dtype)], 1)
            new_conv = win[:, 1:]
            conv = F.silu((win * p["conv_w"][None]).sum(1) + whole(p["conv_b"], group, 0))
            if blocked:
                new_conv = blocks(new_conv, group, 2)
        conv = conv[:, None]  # [B, 1, Cd]
    else:
        tail = xBC[:, -(K - 1):, :].clone()  # decode warm-start (not a view of zxbcdt)
        if isinstance(p["conv_w"], list):
            conv = group.gather([_causal_conv(xb, cw, cb) for xb, cw, cb in zip(
                blocks(xBC, group, 2), p["conv_w"], blocks(p["conv_b"], group, 0))], 2)
        else:
            conv = _causal_conv(xBC, p["conv_w"], whole(p["conv_b"], group, 0))
    xs = conv[..., :di].reshape(B, L, H, P)
    Bm = conv[..., di:di + gn].reshape(B, L, G, N)
    Cm = conv[..., di + gn:].reshape(B, L, G, N)
    if H % tp:  # every rank every head; out_proj row-parallel where it is split
        if decode:
            y, new_state = _step(xs[:, 0], Bm[:, 0], Cm[:, 0], dt[:, 0], p["A_log"], p["D"],
                                 p["dt_bias"], whole(ssm_state, group, 1), dims, G)
            new_state = blocks(new_state, group, 1) if isinstance(ssm_state, list) else new_state
        else:
            y, new_state = _scan(xs, softplus(dt.float() + p["dt_bias"]), p["A_log"], Bm, Cm,
                                 p["D"], dims)
        y = rms_norm(y.reshape(B, L, di).to(x.dtype) * F.silu(z), p["norm"])
        if isinstance(p["out_proj"], list):
            out = _sum_out([a @ w for a, w in zip(blocks(y, group, 2), p["out_proj"])], group,
                           sp)
        else:
            out = _cut(y @ p["out_proj"], group, sp)
        return out, new_state, (new_conv if decode else tail)
    Hr = H // tp
    heads = [blocks(t, group, 2) for t in (xs, dt)]
    per = [blocks(p[n], group, 0) for n in ("A_log", "D", "dt_bias")]
    Bs, Cs = ([_heads_of(t, r * Hr, Hr, H // G) for r, t in zip(group.ranks, group.fanout(a))]
              for a in (Bm, Cm))
    states = blocks(ssm_state, group, 1) if decode else [None] * len(group.ranks)
    ys, finals = [], []
    for i, (xr, dr, Br, Cr) in enumerate(zip(*heads, Bs, Cs)):
        A_log, D, dt_bias = (a[i] for a in per)
        if decode:
            y, st = _step(xr[:, 0], Br[:, 0], Cr[:, 0], dr[:, 0], A_log, D, dt_bias,
                          states[i], dims, Br.shape[2])
        else:
            y, st = _scan(xr, softplus(dr.float() + dt_bias), A_log, Br, Cr, D, dims)
        ys.append(y.reshape(B, L, Hr * P).to(x.dtype))
        finals.append(st)
    # the gated RMSNorm over d_inner: the ranks' sums of squares in rank order
    gated = [y * F.silu(zr) for y, zr in zip(ys, blocks(z, group, 2))]
    ms = group.sum([(g.float() * g.float()).sum(-1, keepdim=True) for g in gated]) / di
    inv = torch.rsqrt(ms + 1e-6)
    normed = [(g.float() * iv).to(x.dtype) * s.to(x.dtype) for g, iv, s in zip(
        gated, group.fanout(inv), blocks(p["norm"], group, 0))]
    out = _sum_out([a @ w for a, w in zip(normed, blocks(p["out_proj"], group, 0))], group, sp)
    if decode and not isinstance(ssm_state, list):
        return out, group.gather(finals, 1), new_conv
    return out, Blocks(finals, 1), (new_conv if decode else tail)
