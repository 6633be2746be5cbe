"""Mixture-of-Experts FFN: token-choice top-k routing, capacity-bounded,
sort-based dispatch (dropless up to the capacity factor). Port of
`repro/models/moe.py`'s single-device path, `moe_apply`.

The combine adds each token's top_k contributions in the order of the
stable expert sort, rounding to the compute dtype after each add, as the
reference's `.at[st].add` does; it is a loop of top_k adds, not an
`index_add_` (atomics on the card would make the bits vary from run to
run). Nothing in the dispatch reads the device back. `moe_apply_sharded`,
the expert-parallel path, waits for the mesh slice (A13c).
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.layers import _act, dense_init


def moe_init(gen, d_model: int, d_ff: int, n_experts: int, *, gated=True,
             dtype=torch.float32, device=None):
    p = {
        "router": dense_init(gen, (d_model, n_experts), (0,), torch.float32, device),
        "w_up": dense_init(gen, (n_experts, d_model, d_ff), (1,), dtype, device),
        "w_down": dense_init(gen, (n_experts, d_ff, d_model), (1,), dtype, device),
    }
    if gated:
        p["w_gate"] = dense_init(gen, (n_experts, d_model, d_ff), (1,), dtype, device)
    return p


def capacity(tokens: int, top_k: int, n_experts: int, factor: float = 1.25) -> int:
    c = int(math.ceil(tokens * top_k / n_experts * factor))
    return max(8, -(-c // 8) * 8)  # round up to 8 for lane alignment


def _expert_ffn(buf, p_up, p_gate, p_down, act: str):
    """buf: [E, C, d] → [E, C, d] through the per-expert gated FFN."""
    up = torch.bmm(buf, p_up)
    if p_gate is not None:
        h = _act(torch.bmm(buf, p_gate), act) * up
    else:
        h = _act(up, act)
    return torch.bmm(h, p_down)


def _route(logits, top_k: int, C: int, E: int):
    """The routing of `_dispatch_combine`: (probs [T, E], gate_w [T, k],
    gate_e [T, k], order [T·k], keep [T·k], slot [T·k]). `order` is the
    stable sort of the flat expert ids; `keep` marks the sorted entries
    within their expert's capacity C, `slot` their row of the [E·C] buffer
    (E·C, the dropped row, when not kept)."""
    T = logits.shape[0]
    dev = logits.device
    probs = torch.softmax(logits, dim=-1)
    gate_w, gate_e = torch.topk(probs, top_k, dim=-1)  # [T, k]
    gate_w = gate_w / torch.clamp_min(gate_w.sum(-1, keepdim=True), 1e-9)
    flat_e = gate_e.reshape(T * top_k)
    order = torch.sort(flat_e, stable=True).indices
    se = flat_e[order]
    counts = torch.zeros(E, dtype=torch.int64, device=dev).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T * top_k, device=dev) - starts[se]
    keep = pos < C
    slot = torch.where(keep, se * C + pos, E * C)  # overflow slot dropped
    return probs, gate_w, gate_e, order, keep, slot


def _dispatch_combine(xt, logits, top_k: int, C: int, E: int, ffn):
    """Shared local dispatch: sort-by-expert, capacity-bounded scatter,
    expert FFN callback, weighted combine. xt: [T, d] (local)."""
    T, d = xt.shape
    dev = xt.device
    probs, gate_w, gate_e, order, keep, slot = _route(logits, top_k, C, E)

    # load-balancing auxiliary loss (Switch-style), local statistics; the
    # counts are small integers, exact in f32 in any order
    me = torch.zeros(E, dtype=torch.float32, device=dev).scatter_add_(
        0, gate_e.reshape(-1), torch.ones(T * top_k, dtype=torch.float32, device=dev))
    me = me / (T * top_k)
    aux = E * torch.sum(me * probs.mean(0))

    st = order // top_k  # the sorted entries' tokens
    buf = torch.zeros((E * C + 1, d), dtype=xt.dtype, device=dev)
    buf[slot] = xt[st]
    out = ffn(buf[: E * C].reshape(E, C, d))  # [E, C, d]

    vals = out.reshape(E * C, d)[slot.clamp(0, E * C - 1)]
    w = (gate_w.reshape(T * top_k)[order] * keep).to(xt.dtype)
    contrib = vals * w[:, None]  # [T·k, d] in sorted order
    # token t's k entries, in the order the sort visits them
    rank = torch.empty_like(order)
    rank[order] = torch.arange(T * top_k, device=dev)
    visit = rank.reshape(T, top_k).sort(dim=1).values  # sorted positions
    y = torch.zeros((T, d), dtype=xt.dtype, device=dev)
    for j in range(top_k):
        y = y + contrib[visit[:, j]]
    return y, aux


def moe_apply(p, x, *, top_k: int, act: str = "silu", capacity_factor: float = 1.25):
    """Reference path. x: [B, S, d] -> (y [B, S, d], aux_loss scalar)."""
    B, S, d = x.shape
    T = B * S
    E = p["router"].shape[1]
    C = capacity(T, top_k, E, capacity_factor)
    xt = x.reshape(T, d)
    logits = xt.float() @ p["router"].float()
    ffn = lambda buf: _expert_ffn(buf, p["w_up"], p.get("w_gate"), p["w_down"], act)  # noqa: E731
    y, aux = _dispatch_combine(xt, logits, top_k, C, E, ffn)
    return y.reshape(B, S, d), aux


def sharded_path_ok(policy, x_shape, n_experts: int) -> bool:
    """Static check: can moe_apply_sharded run for these shapes? (False
    with no policy: the one-device port always takes `moe_apply`.)"""
    if policy is None:
        return False
    B, S, _ = x_shape
    return (B * S) % policy.dp_size == 0 and B % policy.dp_size == 0
