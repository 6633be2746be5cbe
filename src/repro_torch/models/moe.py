"""Mixture-of-Experts FFN: token-choice top-k routing, capacity-bounded,
sort-based dispatch (dropless up to the capacity factor). Port of
`repro/models/moe.py`.

Two dispatch paths, as the reference's:

  moe_apply          one dispatch over all tokens into an [E, C, d] buffer.
  moe_apply_sharded  expert parallelism over a ShardingPolicy's mesh: the
                     tokens split into dp shards (dp·tp when the sequence
                     divides the model axis), each dispatching its own
                     T_loc tokens at C_loc = capacity(T_loc, ...) over
                     E_pad experts (dead experts zero-padded, their logits
                     -inf); two `all_to_all`s over each data group's model
                     ranks carry every expert's buffer to the rank that
                     stores it and back (where the sequence does not
                     divide, the ranks share one dispatch and each runs
                     its experts' slice of the buffer). Per-shard capacity
                     decides which tokens drop, so its output is the
                     reference's sharded output, not `moe_apply`'s.

In a sequence-parallel pass (the residual as the model ranks' rows,
`layers.seq_parallel`) `moe_apply_sharded` takes each rank's rows as its
tokens and returns each rank's output rows: no split and no join of the
sequence. `moe_apply` joins the rows (an all-gather) and cuts its output
back to them: the combine reads every expert's whole output, a sum over
the ranks' hidden blocks where they split it, so the output is the
replicated layout's, bit for bit, cut, not reduce-scattered.

In one process the model ranks run in turn on the tokens' device, and
the collectives are plain list functions in rank order. Over several
processes (`launch.cluster.init_cluster`, one a card) the process of
model rank m runs rank m only: it gathers and runs its E_loc experts
alone, and the `all_to_all`s, the join of the ranks' outputs and the
router's gradient cross the model group's processes
(`launch.mesh.AxisGroup`), with the single controller's bits.

The combine adds each token's top_k contributions in the order of the
stable expert sort, rounding to the compute dtype after each add, as the
reference's `.at[st].add` does; it is a loop of top_k adds, not an
`index_add_` (atomics on the card would make the bits vary from run to
run). Nothing in the dispatch reads the device back.
"""
from __future__ import annotations

import math

import torch

from repro_torch.launch import mesh as Mesh
from repro_torch.models.layers import _act, _recording, _remat, dense_init, tp_group


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


def _dispatch(xt, logits, top_k: int, C: int, E: int):
    """Sort-by-expert, capacity-bounded scatter. xt: [T, d] (local) ->
    (the [E, C, d] expert buffer, the aux loss, the routing `_combine`
    reads)."""
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
    return buf[: E * C].reshape(E, C, d), aux, (gate_w, order, keep, slot, T, top_k)


def _combine(out, xt, routing):
    """The weighted combine of the experts' output `out` [E, C, d] into
    the tokens' [T, d]."""
    gate_w, order, keep, slot, T, top_k = routing
    E, C, d = out.shape
    dev = xt.device
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
    return y


def _dispatch_combine(xt, logits, top_k: int, C: int, E: int, ffn):
    """Shared local dispatch: sort-by-expert, capacity-bounded scatter,
    expert FFN callback, weighted combine. xt: [T, d] (local)."""
    buf, aux, routing = _dispatch(xt, logits, top_k, C, E)
    return _combine(ffn(buf), xt, routing), aux


def moe_apply(p, x, *, top_k: int, act: str = "silu", capacity_factor: float = 1.25,
              policy=None):
    """Reference path. x: [B, S, d] -> (y [B, S, d], aux_loss scalar). In
    a tensor-parallel pass (a batch run as one pass) whose expert stacks
    come as the ranks' blocks, each rank runs its block on this one
    global dispatch (`_ranks_ffn`). In a sequence-parallel pass x and y
    are the model ranks' rows (`Blocks`), joined on the way in and cut on
    the way out."""
    sp = isinstance(x, Mesh.Blocks)
    if sp:
        group = tp_group(policy)
        y, aux = moe_apply(p, group.gather(x, x.dim), top_k=top_k, act=act,
                           capacity_factor=capacity_factor, policy=policy)
        return group.split(y, 1), aux
    B, S, d = x.shape
    T = B * S
    E = p["router"].shape[1]
    C = capacity(T, top_k, E, capacity_factor)
    xt = x.reshape(T, d)
    logits = _router_logits(xt, p["router"], E)
    if isinstance(p["w_up"], list):
        group = tp_group(policy)
        ws = {k: p[k] for k in ("w_up", "w_gate", "w_down") if k in p}

        def ffn(buf):
            return _ranks_ffn(buf, ws, group, E, act)
    else:
        def ffn(buf):
            return _expert_ffn(buf, p["w_up"], p.get("w_gate"), p["w_down"], act)
    y, aux = _dispatch_combine(xt, logits, top_k, C, E, ffn)
    return y.reshape(B, S, d), aux


def _by_ff(ws) -> bool:
    """Do the ranks' blocks `ws` (`launch.mesh.Blocks`) split each
    expert's hidden dim (the specs' fallback where the experts do not
    divide the model axis), not the experts (dim 0)?"""
    return ws["w_up"].dim != 0


def _rank_ffn(buf, ws, j, act):
    return _expert_ffn(buf, ws["w_up"][j], ws["w_gate"][j] if "w_gate" in ws else None,
                       ws["w_down"][j], act)


def _ranks_ffn(buf, ws, group, E: int, act: str, record: bool = False):
    """The expert FFN of a whole [E', C, d] buffer (E' >= E: the experts
    and any dead padding) over the ranks' blocks `ws`: by expert, each
    rank its slice of the buffer, the slices joined; by hidden dim, each
    rank every live expert on its hidden block (column/row-parallel), the
    partials added in rank order, the dead experts' rows zero."""
    if not _by_ff(ws):
        return group.gather([_remat(_rank_ffn, b, ws, j, act, record=record)
                             for j, b in enumerate(group.split(buf, 0))], 0)
    live = group.fanout(buf[:E])
    out = group.sum([_remat(_rank_ffn, b, ws, j, act, record=record)
                     for j, b in enumerate(live)])
    return _pad_e(out, buf.shape[0])


def _router_logits(xt, router, E_pad: int):
    """[T, E_pad] f32 logits, the dead experts' pinned to -inf."""
    logits = xt.float() @ router.float()
    E = logits.shape[1]
    if E_pad > E:
        logits = torch.cat([logits, logits.new_full((logits.shape[0], E_pad - E),
                                                    -math.inf)], 1)
    return logits


def moe_apply_sharded(p, x, *, top_k: int, act: str = "silu",
                      capacity_factor: float = 1.25, policy=None):
    """Expert-parallel path (see the module docstring). x: [B, S, d], the
    global tokens -> (y [B, S, d], aux_loss scalar). Requires: policy set,
    B divisible by the batch axes (`sharded_path_ok`).

    Shard (i, m) of the policy's (data dp, model tp) grid holds rows
    [i·B/dp, (i+1)·B/dp). Expert e lives on model rank e // (E_pad / tp);
    rank m runs the FFN of its E_loc experts only, with the weights
    gathered over the batch axes (here: the weights as given, or, from a
    pass over processes, rank m's slice of them), a remat unit under
    autograd as the reference's `jax.checkpoint`.

      * Where the sequence divides the model axis, rank m holds sequence
        block m: it dispatches its own tokens, two `all_to_all`s carry
        every expert's buffer to the rank that stores it and back, it
        combines its own tokens, and the ranks' outputs join over the
        model axis (the dense layers replicate the data shard's tokens);
        each rank routes with its own view of the router, whose
        gradients add up in rank order.
      * Else (decode among them) every rank's tokens are the data shard's
        whole tokens, as the reference's re-dispatch: one dispatch, each
        rank's experts run on its slice of the expert buffer, and the
        slices join into the whole buffer before the combine.

    The ranks are the policy's `group` (`launch.mesh.AxisGroup`): all of
    them in turn in one process, its own over processes. `aux` is the
    mean over the shards (the reference's `pmean`), in rank order. In a
    sequence-parallel pass x comes as the ranks' rows (`Blocks` along dim
    1), which are the ranks' tokens as they stand, and y leaves as them:
    the sequence is neither split nor joined."""
    E = p["router"].shape[1]
    tp = policy.tp_size
    sp = isinstance(x, Mesh.Blocks)
    B, S, d = x[0].shape if sp else x.shape
    S = S * tp if sp else S
    dp = policy.dp_size
    E_pad = -(-E // tp) * tp  # zero-pad dead experts (granite: 40 -> 48)
    # split tokens over the model axis too when the sequence divides: each
    # token is dispatched once (with batch-only sharding every model rank
    # re-dispatches the same tokens)
    seq_sharded = S % tp == 0 and S > 1
    n_shards = dp * (tp if seq_sharded else 1)
    T_loc = (B * S) // n_shards
    C_loc = capacity(T_loc, top_k, E_pad, capacity_factor)
    Bl, Sl = B // dp, (S // tp if seq_sharded else S)
    group = policy.group if policy.group is not None else Mesh.AxisGroup(tp)
    ws = {k: _expert_slices(p[k], group, E_pad) for k in ("w_up", "w_gate", "w_down")
          if k in p}
    record = _recording(*(x if sp else [x]), *(t for v in ws.values() for t in v))
    by_ff = _by_ff(ws)

    ys, auxes = [], []
    for i in range(dp):
        rows = [r[i * Bl:(i + 1) * Bl] for r in x] if sp else x[i * Bl:(i + 1) * Bl]
        if seq_sharded:
            xts = [r.reshape(T_loc, d) for r in (rows if sp else group.split(rows, 1))]
            sent = [_dispatch(xt, _router_logits(xt, router, E_pad), top_k, C_loc, E_pad)
                    for xt, router in zip(xts, group.fanout(p["router"]))]
            if by_ff:  # every rank's tokens, each rank every expert on its hidden block
                back = group.split(_ranks_ffn(group.gather([b for b, _, _ in sent], 1), ws,
                                              group, E, act, record), 1)
            else:
                # experts to their owner rank; every rank's tokens concatenate
                # on the capacity axis: [E_loc, C_loc * tp, d] a rank
                bufs = group.all_to_all([b for b, _, _ in sent], 0, 1)
                outs = [_remat(_rank_ffn, b, ws, j, act, record=record)
                        for j, b in enumerate(bufs)]
                back = group.all_to_all(outs, 1, 0)  # [E_pad, C_loc, d]
            outs = [_combine(o, xt, r).reshape(Bl, Sl, d)
                    for o, xt, (_, _, r) in zip(back, xts, sent)]
            ys.append(outs if sp else group.gather(outs, 1))
            auxes.extend(group.every([a for _, a, _ in sent]))
        else:
            xt = rows.reshape(T_loc, d)
            buf, aux, routing = _dispatch(xt, _router_logits(xt, p["router"], E_pad), top_k,
                                          C_loc, E_pad)
            out = _ranks_ffn(buf, ws, group, E, act, record)  # [E_pad, C_loc, d]
            ys.append(_combine(out, xt, routing).reshape(Bl, S, d))
            auxes.append(aux)
    if sp:
        return Mesh.Blocks([torch.cat([y[j] for y in ys], 0) for j in range(len(ys[0]))],
                           1), Mesh.pmean(auxes)[0]
    return torch.cat(ys, 0), Mesh.pmean(auxes)[0]


def _expert_slices(w, group, E_pad) -> Mesh.Blocks:
    """The ranks' blocks of `w` for the ranks `group` runs: `w` as given
    where it is already them (a pass's gather: by expert, or by hidden
    dim where the experts do not divide the model axis), else the expert
    slices [E_loc, ...] split from the zero-padded whole."""
    if isinstance(w, Mesh.Blocks):
        return w
    return group.split(_pad_e(w, E_pad), 0)


def _pad_e(w, E_pad):
    if w is None or w.shape[0] == E_pad:
        return w
    return torch.cat([w, w.new_zeros((E_pad - w.shape[0],) + tuple(w.shape[1:]))], 0)


def sharded_path_ok(policy, x_shape, n_experts: int) -> bool:
    """Static check: can moe_apply_sharded run for these shapes?"""
    if policy is None:
        return False
    B, S, _ = x_shape
    return (B * S) % policy.dp_size == 0 and B % policy.dp_size == 0
