"""Generic decoder stack: every assigned architecture is a layer *pattern*
(port of `repro/models/transformer.py`).

A model is `n_groups` repetitions of a static pattern of blocks, e.g.

    dense LM     : [("attn", "dense")]                       × n_layers
    MoE LM       : [("attn", "moe")]                         × n_layers
    Mamba-2      : [("mamba", "none")]                       × n_layers
    Jamba (1:7)  : [(attn,dense), (mamba,moe), (mamba,dense), ...] × 9
    Whisper dec  : [("attn", "none"), ("cross", "dense")]    × 24
    Llama-Vision : [(cross,dense), (attn,dense) × 4]         × 20

The reference stacks a group's parameters on a leading [n_groups] axis
and scans; the port holds one `Block` module a block (`Stack`: a list of
groups, each a `{"b{i}": Block}` dict) and loops over the groups in
Python. A block's parameters keep the reference's names
(`block["attn"]["wq"]`), so the layer functions take them as they are.
The serving cache keeps the reference's layout: `{"b{i}": {"k", "v" |
"ck", "cv" | "ssm", "conv"}}`, each leaf stacked on n_groups.

Training runs the same functions under autograd: `stack_apply_train`
remats each group (the reference's `jax.checkpoint(group_body)`) while
autograd records, and `chunked_ce_loss` is the loss head.

Under a ShardingPolicy the MoE takes `moe_apply_sharded` wherever
`sharded_path_ok` says so, as the reference's does. In a pass on a mesh
the policy carries the pass's model group, and the layers run tensor
parallel over it: the logits and the loss vocab-parallel (the
reference's `_shard` of the logits), attention, FFN and SSM heads per
rank. Between blocks the residual stream is sequence-parallel, as the
reference's `_residual_spec` (Megatron-SP): where the policy asks for it
(`seq_shard_residual`) and the sequence divides over the model ranks
(`layers.seq_parallel`), the residual is the ranks' rows (`Blocks`
along dim 1) from `embed_tokens`' reduce-scatter to the final norm. A
block's norm and residual add run on a rank's rows (the norm weights'
gradients added over the ranks in rank order); its mixer and FFN join
the rows on the way in and leave them through a reduce-scatter; a
group's remat unit saves a rank's rows. The loss head joins the
sequence back, prefill's logits read the last row. Elsewhere (decode's
one row, a sequence that does not divide) the residual is replicated
over the model ranks. The stack functions take a `gather`
hook: on a mesh, each group's weights are gathered from their parts
inside the group's remat unit (`launch/sharding.gather_tree`), so no
step holds more than one group's gathered weights.
"""
from __future__ import annotations

import dataclasses
import functools

import torch
from torch import nn

from repro_torch.launch.mesh import Blocks, Sharded, Slices
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S

# --------------------------------------------------------------------------
# sharding policy
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    """Mesh-axis names and sizes of a sharded run. None = one device.
    The sizes pick the MoE's sharded path and its per-shard capacity, and
    `replicate_kv`'s kv repeat; on a mesh a pass's policy also carries
    its model group (`group`), over which the layers run tensor
    parallel."""

    batch: tuple = ("data",)  # axes sharding the batch dim
    model: str = "model"  # tensor-parallel axis
    tp_size: int = 16  # size of the model axis (for divisibility rules)
    dp_size: int = 16  # product of batch-axis sizes (for divisibility rules)
    seq_shard_residual: bool = True  # Megatron-SP style residual layout
    seq_axis_for_cache: str | None = None  # context-parallel KV/long-context
    # not a field (the layout is the same): a pass's model group over
    # processes (`launch.mesh.AxisGroup`), whose own ranks the MoE runs;
    # None runs every rank in turn
    group = None

    def __hash__(self):
        return hash((self.batch, self.model, self.tp_size, self.dp_size,
                     self.seq_shard_residual, self.seq_axis_for_cache))

    def with_group(self, group) -> "ShardingPolicy":
        """This policy for a pass that runs `group`'s own model ranks."""
        out = dataclasses.replace(self)
        object.__setattr__(out, "group", group)
        return out


# --------------------------------------------------------------------------
# parameter modules
# --------------------------------------------------------------------------


def _frozen(t):
    return nn.Parameter(t, requires_grad=False)


class Block(nn.ModuleDict):
    """One block of a pattern: `norm1`, a mixer (`attn` or `ssm`) and,
    unless the MLP kind is "none", `norm2` and `mlp`; each a
    `nn.ParameterDict` of the reference's leaves."""

    def __init__(self, params: dict):
        super().__init__({k: nn.ParameterDict({n: _frozen(t) for n, t in v.items()})
                          for k, v in params.items()})

    def tree(self) -> dict:
        return {k: dict(v.items()) for k, v in self.items()}


class Stack(nn.ModuleList):
    """`n_groups` groups of a pattern; group g is `{"b{i}": Block}`."""

    def __init__(self, groups: list):
        super().__init__(nn.ModuleDict({b: Block(p) for b, p in g.items()}) for g in groups)

    def tree(self) -> list:
        return [{k: b.tree() for k, b in g.items()} for g in self]


# --------------------------------------------------------------------------
# block init / apply
# --------------------------------------------------------------------------


def _norm_init(cfg, dtype, device):
    if cfg.norm == "ln":
        return {"scale": torch.ones((cfg.d_model,), dtype=dtype, device=device),
                "bias": torch.zeros((cfg.d_model,), dtype=dtype, device=device)}
    init = torch.zeros if cfg.norm_plus_one else torch.ones
    return {"scale": init((cfg.d_model,), dtype=dtype, device=device)}


def _apply_norm(cfg, p, x):
    """The norm of x [.., d]; of each rank's rows where x is a
    sequence-parallel pass's (`Blocks`), each rank with its own view of
    the weights (`fanout`: their gradients add over the ranks in rank
    order, on every process)."""
    if isinstance(x, Blocks):
        views = {n: L.tp_group(cfg.policy).fanout(w) for n, w in p.items()}
        return Blocks([_norm(cfg, {n: v[i] for n, v in views.items()}, t)
                       for i, t in enumerate(x)], x.dim)
    return _norm(cfg, p, x)


def _norm(cfg, p, x):
    if cfg.norm == "ln":
        return L.layer_norm(x, p["scale"], p["bias"])
    return L.rms_norm(x, p["scale"], plus_one=cfg.norm_plus_one)


def block_init(cfg, gen, mixer: str, mlp_kind: str, dtype, device=None) -> dict:
    """One block's parameters, as the reference's `block_init` tree."""
    dev = device if device is not None else gen.device
    p = {"norm1": _norm_init(cfg, dtype, dev)}
    if mixer in ("attn", "attn_full", "cross"):
        p["attn"] = L.attn_init(gen, cfg.attn_dims, dtype, dev)
    elif mixer == "mamba":
        p["ssm"] = S.ssm_init(gen, cfg.ssm_dims, dtype, dev)
    else:
        raise ValueError(mixer)
    if mlp_kind == "dense":
        p["norm2"] = _norm_init(cfg, dtype, dev)
        p["mlp"] = L.mlp_init(gen, cfg.d_model, cfg.d_ff, gated=cfg.gated_mlp, dtype=dtype,
                              device=dev)
    elif mlp_kind == "moe":
        p["norm2"] = _norm_init(cfg, dtype, dev)
        p["mlp"] = M.moe_init(gen, cfg.d_model, cfg.moe_d_ff, cfg.moe_experts,
                              gated=cfg.gated_mlp, dtype=dtype, device=dev)
    elif mlp_kind != "none":
        raise ValueError(mlp_kind)
    return p


def _apply_mlp(cfg, p, x, mlp_kind: str):
    if mlp_kind == "none":
        return x, 0.0
    h = _apply_norm(cfg, p["norm2"], x)
    if mlp_kind == "dense":
        return _add(x, L.mlp_apply(p["mlp"], h, act=cfg.act, policy=cfg.policy)), 0.0
    if M.sharded_path_ok(cfg.policy, _shape(cfg, h), cfg.moe_experts):
        # its own remat unit, as the reference's: the expert hiddens are
        # recomputed in the backward pass, and with them, over processes,
        # the unit's collectives, which every process of the model group
        # recomputes in one order (its graph is the others'); under
        # no_grad (serving) nothing is recomputed
        def moe_fn(pp, hh):
            return M.moe_apply_sharded(pp, hh, top_k=cfg.moe_top_k, act=cfg.act,
                                       capacity_factor=cfg.moe_capacity_factor,
                                       policy=cfg.policy)

        y, aux = L._remat(moe_fn, p["mlp"], h,
                          record=L._recording(*_tensors(h), *_tensors(p["mlp"])))
    else:
        y, aux = M.moe_apply(p["mlp"], h, top_k=cfg.moe_top_k, act=cfg.act,
                             capacity_factor=cfg.moe_capacity_factor, policy=cfg.policy)
    return _add(x, y), aux


def block_apply_train(cfg, p, x, mixer: str, mlp_kind: str, memory=None, causal=True):
    """Forward of one block over a whole sequence (whisper's encoder, the
    decode == forward checks). x: [B,S,d], or a sequence-parallel pass's
    rows (`Blocks`); memory: [B,M,d] for cross blocks. Returns (x,
    aux_loss)."""
    h = _apply_norm(cfg, p["norm1"], x)
    if mixer in ("attn", "attn_full"):
        x = _add(x, L.attn_apply(p["attn"], h, cfg.attn_dims,
                                 causal=(mixer == "attn") and causal, q_chunk=cfg.q_chunk,
                                 kv_chunk=cfg.kv_chunk, policy=cfg.policy))
    elif mixer == "cross":
        ck, cv = L.cross_kv(p["attn"], memory, cfg.attn_dims, policy=cfg.policy)
        x = _add(x, L.cross_attn_apply(p["attn"], h, ck, cv, cfg.attn_dims,
                                       q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk,
                                       policy=cfg.policy))
    elif mixer == "mamba":
        o, _, _ = S.ssm_apply(p["ssm"], h, cfg.ssm_dims, policy=cfg.policy)
        x = _add(x, o)
    return _apply_mlp(cfg, p, x, mlp_kind)


def _add(x, y):
    """x + y, rank by rank where both are a sequence-parallel pass's rows."""
    if isinstance(x, Blocks):
        return Blocks([a + b for a, b in zip(x, y)], x.dim)
    return x + y


def _shape(cfg, x) -> tuple:
    """x's shape, or the whole tensor's where x is a sequence-parallel
    pass's rows."""
    if isinstance(x, Blocks):
        return (x[0].shape[0], L.seq_len(x, L.tp_group(cfg.policy)), *x[0].shape[2:])
    return tuple(x.shape)


def seq_rows(cfg, x):
    """x [B, S, ..] as the model ranks' rows where a pass of `cfg` keeps its
    sequence sequence-parallel (`layers.seq_parallel`: a cut), else x."""
    if L.seq_parallel(cfg.policy, x.shape[1]):
        return L.tp_group(cfg.policy).split(x, 1)
    return x


def seq_whole(cfg, x):
    """x whole: a sequence-parallel pass's rows joined (an all-gather)."""
    return L.tp_group(cfg.policy).gather(x, x.dim) if isinstance(x, Blocks) else x


def block_cache_init(cfg, mixer: str, batch: int, max_len: int, dtype, device=None):
    d = cfg.attn_dims
    if mixer in ("attn", "attn_full"):
        shp = (batch, max_len, d.n_kv, d.d_head)
        return {"k": torch.zeros(shp, dtype=dtype, device=device),
                "v": torch.zeros(shp, dtype=dtype, device=device)}
    if mixer == "cross":
        shp = (batch, cfg.n_memory, d.n_kv, d.d_head)
        return {"ck": torch.zeros(shp, dtype=dtype, device=device),
                "cv": torch.zeros(shp, dtype=dtype, device=device)}
    if mixer == "mamba":
        sd = cfg.ssm_dims
        return {"ssm": torch.zeros((batch, sd.n_heads, sd.d_state, sd.headdim),
                                   dtype=torch.float32, device=device),
                "conv": torch.zeros((batch, sd.d_conv - 1, sd.conv_dim), dtype=dtype,
                                    device=device)}
    raise ValueError(mixer)


def _copy_into(dst, src) -> None:
    """`dst.copy_(src)`, block by block for the ranks' blocks."""
    for d, s in zip(dst, src) if isinstance(dst, list) else ((dst, src),):
        d.copy_(s)


def block_apply_decode(cfg, p, x, cache, cur_len, mixer: str, mlp_kind: str):
    """x: [B,1,d]; `cache` is this block's (one group's views of the stacked
    leaves; in a tensor-parallel pass a leaf may be the ranks' blocks),
    written in place. Returns (x, cache)."""
    h = _apply_norm(cfg, p["norm1"], x)
    if mixer in ("attn", "attn_full"):
        o, nk, nv = L.attn_decode(p["attn"], h, cache["k"], cache["v"], cur_len,
                                  cfg.attn_dims, policy=cfg.policy)
        x, cache = x + o, {"k": nk, "v": nv}
    elif mixer == "cross":
        x = x + L.cross_attn_apply(p["attn"], h, cache["ck"], cache["cv"], cfg.attn_dims,
                                   q_chunk=1, kv_chunk=cfg.kv_chunk, policy=cfg.policy)
    elif mixer == "mamba":
        o, ns, nc = S.ssm_decode(p["ssm"], h, cache["ssm"], cache["conv"], cfg.ssm_dims,
                                 policy=cfg.policy)
        _copy_into(cache["ssm"], ns)
        _copy_into(cache["conv"], nc)
        x = x + o
    x, _ = _apply_mlp(cfg, p, x, mlp_kind)
    return x, cache


# --------------------------------------------------------------------------
# stack init / apply (a Python loop over the groups)
# --------------------------------------------------------------------------


def stack_init(cfg, gen, pattern, n_groups: int, dtype, device=None):
    """`n_groups` groups' parameter trees (a `Stack` holds them), made one
    at a time as they are drawn."""
    for _ in range(n_groups):
        yield {f"b{i}": block_init(cfg, gen, mx, ml, dtype, device)
               for i, (mx, ml) in enumerate(pattern)}


def _tensors(tree) -> list:
    if isinstance(tree, nn.Module):
        return list(tree.parameters())
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, list):  # a pass's expert slices (`gather_tree`)
        return [t for v in tree for t in _tensors(v)]
    if isinstance(tree, Sharded):
        return tree.local()
    return [tree]


def _group(gp, gather):
    return gp if gather is None else gather(gp)


def stack_apply_train(cfg, gparams, x, pattern, memory=None, causal=True, gather=None):
    """The groups in order; while autograd records, each group is one
    remat unit (its activations recomputed in the backward pass), as the
    reference's checkpointed scan body. `gather` (on a mesh) turns a
    group's parts into its weights inside the unit. x is [B, S, d] or a
    sequence-parallel pass's rows (`Blocks`), which is what a unit then
    takes and saves: a rank's rows."""
    def group_body(h, aux, gp):
        gp = _group(gp, gather)
        for i, (mx, ml) in enumerate(pattern):
            h, a = block_apply_train(cfg, gp[f"b{i}"], h, mx, ml, memory, causal)
            aux = aux + a
        return h, aux

    aux = 0.0
    for gp in gparams:
        record = torch.is_grad_enabled() and L._recording(*_tensors(x), *_tensors(gp))
        x, aux = L._remat(functools.partial(group_body, gp=gp), x, aux, record=record)
    return x, aux


def block_apply_prefill(cfg, p, x, mixer: str, mlp_kind: str, max_len: int,
                        cache_dtype, memory=None):
    """Train-path compute + cache construction. x: [B,S,d] (or a
    sequence-parallel pass's rows) → (x, cache): the cache of the whole
    sequence."""
    Sq = _shape(cfg, x)[1]
    d = cfg.attn_dims
    h = _apply_norm(cfg, p["norm1"], x)
    if mixer in ("attn", "attn_full"):
        o, k, v = L.attn_forward(p["attn"], h, d, causal=(mixer == "attn"),
                                 q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk,
                                 policy=cfg.policy)
        x = _add(x, o)
        pad = max_len - Sq
        cache = {"k": _each(k, lambda t: L._pad_seq(t.to(cache_dtype), pad)),
                 "v": _each(v, lambda t: L._pad_seq(t.to(cache_dtype), pad))}
    elif mixer == "cross":
        ck, cv = L.cross_kv(p["attn"], memory, d, policy=cfg.policy)
        x = _add(x, L.cross_attn_apply(p["attn"], h, ck, cv, d, q_chunk=cfg.q_chunk,
                                       kv_chunk=cfg.kv_chunk, policy=cfg.policy))
        cache = {"ck": _each(ck, lambda t: t.to(cache_dtype)),
                 "cv": _each(cv, lambda t: t.to(cache_dtype))}
    elif mixer == "mamba":
        o, final, conv_tail = S.ssm_apply(p["ssm"], h, cfg.ssm_dims, policy=cfg.policy)
        x = _add(x, o)
        cache = {"ssm": final, "conv": conv_tail.to(cache_dtype)}  # final: f32
    else:
        raise ValueError(mixer)
    x, _ = _apply_mlp(cfg, p, x, mlp_kind)
    return x, cache


def _each(t, fn, shift: int = 0):
    """`fn` of `t`, or of each of the ranks' blocks where `t` is `Blocks`,
    or of each sequence slice where it is `Slices` (`shift`: the leading
    dims `fn` adds or drops)."""
    if isinstance(t, Blocks):
        return t.map(lambda b: _each(b, fn, shift), shift)
    return t.map(fn) if isinstance(t, Slices) else fn(t)


def _stack_leaves(per_group: list) -> dict:
    """The groups' caches stacked on a leading [n_groups] axis (a leaf of
    the ranks' blocks stacked block by block)."""
    def stack(ts):
        if isinstance(ts[0], Blocks):
            return Blocks([torch.stack([t[i] for t in ts]) for i in range(len(ts[0]))],
                          ts[0].dim + 1)
        return torch.stack(ts)

    return {b: {n: stack([g[b][n] for g in per_group]) for n in per_group[0][b]}
            for b in per_group[0]}


def stack_apply_prefill(cfg, gparams, x, pattern, max_len, cache_dtype, memory=None,
                        gather=None):
    per_group = []
    for gp in gparams:
        gp = _group(gp, gather)
        caches = {}
        for i, (mx, ml) in enumerate(pattern):
            x, caches[f"b{i}"] = block_apply_prefill(cfg, gp[f"b{i}"], x, mx, ml,
                                                     max_len, cache_dtype, memory)
        per_group.append(caches)
    return x, _stack_leaves(per_group)


def stack_cache_init(cfg, pattern, n_groups, batch, max_len, dtype, device=None):
    def one(mx):
        c = block_cache_init(cfg, mx, batch, max_len, dtype, device)
        return {n: a[None].expand((n_groups,) + a.shape).contiguous() for n, a in c.items()}

    return {f"b{i}": one(mx) for i, (mx, ml) in enumerate(pattern)}


def stack_apply_decode(cfg, gparams, x, cache, cur_len, pattern, gather=None):
    """One token through every group; the stacked cache is written in
    place (group g's rows) and returned: the cache passed in is consumed."""
    for g, gp in enumerate(gparams):
        gp = _group(gp, gather)
        for i, (mx, ml) in enumerate(pattern):
            bc = {n: _each(a, lambda t: t[g], -1) for n, a in cache[f"b{i}"].items()}
            x, _ = block_apply_decode(cfg, gp[f"b{i}"], x, bc, cur_len, mx, ml)
    return x, cache


# --------------------------------------------------------------------------
# embeddings + loss + head
# --------------------------------------------------------------------------


def embed_init(cfg, gen, dtype, device=None) -> dict:
    dev = device if device is not None else gen.device
    e = {"embed": L.dense_init(gen, (cfg.vocab, cfg.d_model), (1,), dtype, dev)}
    if not cfg.tie_embeddings:
        e["unembed"] = L.dense_init(gen, (cfg.d_model, cfg.vocab), (0,), dtype, dev)
    return e


@functools.lru_cache(maxsize=None)
def _rounded(value: float, dtype: torch.dtype) -> float:
    """`value` rounded to `dtype`, as a host scalar (no copy to the card)."""
    return torch.tensor(value, dtype=dtype).item()


def embed_tokens(cfg, params, tokens):
    """The token embeddings [B, S, d]. In a tensor-parallel pass whose
    `embed` comes as the ranks' vocab blocks, each rank looks up the tokens
    of its block (zero elsewhere) and the ranks add in rank order: one
    term is not zero, so the sum is exact. In a sequence-parallel pass
    (`layers.seq_parallel`) the sum is a reduce-scatter and the embeddings
    the ranks' rows (`Blocks` along dim 1; a whole table's lookup is
    cut)."""
    e = params["embed"]
    sp = L.seq_parallel(cfg.policy, tokens.shape[1])
    group = L.tp_group(cfg.policy)
    if isinstance(e, list):
        parts = []
        for r, w in zip(group.ranks, e):
            n = w.shape[0]
            local = tokens - r * n
            hit = (local >= 0) & (local < n)
            rows = w[local.clamp(0, n - 1)]
            parts.append(torch.where(hit[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                                       device=rows.device)))
        x = L._sum_out(parts, group, sp)
    else:
        x = L._cut(e[tokens], group, sp)
    if cfg.embed_scale:
        # the scale rounded to the compute dtype first, as the reference's
        # asarray(d ** 0.5, x.dtype)
        scale = _rounded(cfg.d_model ** 0.5, e[0].dtype if isinstance(e, list) else e.dtype)
        x = _each(x, lambda t: t * scale)
    return x


def _unembed_matrix(cfg, params):
    """[d, V], or in a tensor-parallel pass the list of the ranks' [d,
    V/tp] vocab blocks."""
    if cfg.tie_embeddings:
        e = params["embed"]
        return [w.T for w in e] if isinstance(e, list) else e.T
    return params["unembed"]


def _ce_chunk(xc, W, yc, mc):
    """One chunk's (sum of masked nll, mask sum): the logits in f32 (the
    reference's bf16 product with f32 output; both operands upcast here),
    `logsumexp`, the gold logit by `gather`."""
    logits = xc.float() @ W.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, yc[..., None].long())[..., 0]
    nll = (lse - gold) * mc
    return nll.sum(), mc.sum()


def _ce_chunk_tp(group, xc, yc, mc, *Ws):
    """`_ce_chunk` over the vocab blocks of a tensor-parallel pass: each
    rank its block's logits, the log-sum-exp from the ranks' maxima and
    their sums of exponentials (added in rank order), the gold logit from
    the rank whose block holds the label."""
    logits = [x.float() @ w.float() for x, w in zip(group.fanout(xc), Ws)]
    top = group.gather([t.detach().amax(-1, keepdim=True) for t in logits], -1).amax(-1)
    lse = top + torch.log(group.sum([torch.exp(t - top[..., None]).sum(-1) for t in logits]))
    golds = []
    for r, t in zip(group.ranks, logits):
        n = t.shape[-1]
        local = yc.long() - r * n
        hit = (local >= 0) & (local < n)
        g = torch.gather(t, -1, local.clamp(0, n - 1)[..., None])[..., 0]
        golds.append(torch.where(hit, g, torch.zeros((), dtype=g.dtype, device=g.device)))
    nll = (lse - group.sum(golds)) * mc
    return nll.sum(), mc.sum()


def chunked_ce_loss(cfg, params, x, labels, mask, *, chunk: int = 512, count=None):
    """Cross-entropy without a [B,S,V] resident: a loop over seq chunks,
    each a remat unit while autograd records (the backward recomputes the
    [B, chunk, V] logits block rather than keeping one a chunk). `count`
    (a data shard's part of a sharded batch) is the whole batch's mask
    sum: the shard's nll sum over it, so that the shards' parts add up to
    the reference's Σ nll / Σ mask. In a tensor-parallel pass each rank
    computes its vocab block's logits (`_ce_chunk_tp`); a
    sequence-parallel pass's rows are joined first."""
    x = seq_whole(cfg, x)
    B, Sq, d = x.shape
    W = _unembed_matrix(cfg, params)
    chunk = min(chunk, Sq)
    assert Sq % chunk == 0
    mask = mask.to(torch.float32)
    Ws = W if isinstance(W, list) else [W]
    record = L._recording(x, *Ws)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(Sq // chunk):
        s = slice(i * chunk, (i + 1) * chunk)
        if isinstance(W, list):
            nll, m = L._remat(functools.partial(_ce_chunk_tp, L.tp_group(cfg.policy)),
                              x[:, s], labels[:, s], mask[:, s], *W, record=record)
        else:
            nll, m = L._remat(_ce_chunk, x[:, s], W, labels[:, s], mask[:, s], record=record)
        tot, cnt = tot + nll, cnt + m
    return tot / torch.clamp_min(cnt if count is None else count, 1.0)


def last_row(cfg, x):
    """x[:, -1:], the last row of the sequence: from a sequence-parallel
    pass's rows the last rank's, each rank's last row joined (one row a
    rank crosses, not the sequence)."""
    if isinstance(x, Blocks):
        return L.tp_group(cfg.policy).gather([t[:, -1:] for t in x], 1)[:, -1:]
    return x[:, -1:]


def logits_last(cfg, params, x_last):
    """x_last: [B, 1, d] → [B, 1, V] f32 (decode head; the product in f32).
    In a tensor-parallel pass each rank its vocab block, the blocks joined
    over the ranks."""
    W = _unembed_matrix(cfg, params)
    if isinstance(W, list):
        group = L.tp_group(cfg.policy)
        return group.gather([x.float() @ w.float()
                             for x, w in zip(group.fanout(x_last), W)], -1)
    return x_last.float() @ W.float()
