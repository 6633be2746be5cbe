"""ArchConfig + model assembly + step factories + input specs (port of
`repro/models/model.py`).

`init_params(cfg, key, device)` builds an `LM` module of f32 master
weights; `prefill` and `decode_step` serve from it. The reference casts
the parameters to the compute dtype on every call; a cast gives the same
bits each time, so serving casts once per model and keeps that copy
(`_cast`). Training casts anew on every call (`_train_cast`), inside the
graph, so the f32 masters get their gradients through the cast's
backward. Entry points run on the card unless given `device="cpu"`.

Under a ShardingPolicy (`cfg.with_policy`) the entry points take an
`LM` as before (the MoE then dispatches per shard, `moe_apply_sharded`)
or a `ShardedLM`, the parameters placed on a mesh as per-shard parts
(`launch/sharding.py`). On a mesh the port runs the reference's
ZeRO-3 layout in turn, in one process:

  * each data shard runs its rows of the batch on its model-rank-0
    shard's device, with the policy as one data shard sees it (dp 1);
    a batch that does not divide over the data shards runs whole, and
    its MoE takes `moe_apply`, as the reference's does;
  * each group's weights are gathered from their parts inside the
    group's remat unit, and the gather's backward adds each data shard's
    gradient into the parts (the reduce-scatter); the whole model is
    never gathered at once;
  * the dense layers' model axis is storage only in compute (a split
    matmul would change only the order of a sum); the MoE's expert
    parallelism runs per shard.

A data shard's loss is its nll sum over the whole batch's mask count plus
its share of the aux loss (the reference's `pmean`), so the shards'
parts add up to the reference's loss.

Over several processes (`launch.cluster.init_cluster`, one a card) each
process runs its own data shards' passes (`_shard_plan`): the processes
of a data shard's model group run its rows through the same dense
weights, and each runs its own model ranks of the MoE, gathering only
those ranks' experts (`launch.mesh.AxisGroup` carries the all-to-alls
across the group). `make_train_step`, `forward_train`, `prefill` and
`decode_step` all run there: a process keeps its own parts of the state
and of the cache (`ShardedCache`), and every process returns the single
controller's losses, metrics and [B, 1, V] logits bit for bit, gathered
over the batch axes.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import numpy as np
import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.launch import mesh as TM
from repro_torch.launch import sharding as SH
from repro_torch.models import transformer as T
from repro_torch.models.layers import AttnDims
from repro_torch.models.ssm import SSMDims
from repro_torch.models.transformer import ShardingPolicy
from repro_torch.optim.adamw import _global_norm

# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_head: int
    d_ff: int
    vocab: int
    act: str = "silu"
    gated_mlp: bool = True
    qkv_bias: bool = False
    rope_theta: float = 1e4
    pos_embed: str = "rope"  # rope | sinusoidal
    norm: str = "rms"  # rms | ln
    norm_plus_one: bool = False
    embed_scale: bool = False
    tie_embeddings: bool = False
    # moe
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    # ssm
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_groups: int = 1
    ssm_chunk: int = 128
    # structure: pattern repeated n_layers/len(pattern) times
    pattern: tuple = (("attn", "dense"),)
    enc_layers: int = 0  # whisper encoder depth
    n_memory: int = 0  # cross-attn memory tokens (enc output / image patches)
    # attention chunking
    q_chunk: int = 512
    kv_chunk: int = 1024
    # numerics / optimizer
    compute_dtype: str = "bfloat16"
    cache_dtype: str = "bfloat16"
    optimizer: str = "adamw"  # adamw | adafactor
    moe_capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    accum_steps: int = 1
    # sharding (None → one device; launch/train.build installs a mesh's policy)
    policy: ShardingPolicy | None = None
    # shape-cell support (full attention archs skip long_500k)
    subquadratic: bool = False

    @property
    def attn_dims(self) -> AttnDims:
        return AttnDims(self.d_model, self.n_heads, self.n_kv, self.d_head,
                        self.qkv_bias, self.rope_theta)

    @property
    def ssm_dims(self) -> SSMDims:
        return SSMDims(self.d_model, self.ssm_state, self.ssm_headdim,
                       self.ssm_groups, chunk=self.ssm_chunk)

    @property
    def n_groups(self) -> int:
        assert self.n_layers % len(self.pattern) == 0, (self.n_layers, self.pattern)
        return self.n_layers // len(self.pattern)

    def with_policy(self, policy: ShardingPolicy | None) -> "ArchConfig":
        return dataclasses.replace(self, policy=policy)

    def param_count(self) -> int:
        """Parameters of `init_params`, counted on the `meta` device: no
        weight is allocated (jamba's 398 B included)."""
        return sum(p.numel() for p in init_params(self, 0, device="meta").parameters())

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of moe_experts)."""
        total = self.param_count()
        if not self.moe_experts:
            return total
        n_moe_layers = sum(1 for _, ml in self.pattern if ml == "moe") * self.n_groups
        per = self.d_model * self.moe_d_ff * (3 if self.gated_mlp else 2)
        expert = n_moe_layers * per
        return total - expert * self.moe_experts + expert * self.moe_top_k


ENC_PATTERN = (("attn_full", "dense"),)


# --------------------------------------------------------------------------
# params
# --------------------------------------------------------------------------


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


class LM(nn.ModuleDict):
    """The parameter tree of one architecture: `tok` (embed, unembed),
    `stack`, `final_norm`, and for encdec `enc_stack` and `enc_norm`, under
    the reference's names. `tree()` is the nested dict (stacks as lists of
    groups); `LM(cfg, tree)` builds the module from it."""

    def __init__(self, cfg: ArchConfig, tree: dict):
        mods: dict[str, nn.Module] = {}
        for k, v in tree.items():
            if k in ("stack", "enc_stack"):
                mods[k] = T.Stack(v)
            else:
                mods[k] = nn.ParameterDict({n: T._frozen(t) for n, t in v.items()})
        super().__init__(mods)
        self.cfg = cfg
        self._casts = {}  # dtype -> (master versions, cast LM)

    def tree(self) -> dict:
        return {k: (m.tree() if isinstance(m, T.Stack) else dict(m.items()))
                for k, m in self.items()}

    @property
    def device(self) -> torch.device:
        return self["tok"]["embed"].device


def _map_tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_tree(v, fn) for v in tree]
    return fn(tree)


def _generator(key, device: torch.device):
    if device.type == "meta":
        return None
    if isinstance(key, torch.Generator):
        return key
    return torch.Generator(device=device).manual_seed(int(key))


def init_params(cfg: ArchConfig, key=0, device=None, place=None):
    """Full parameter module (f32 master copies; served through the
    compute-dtype copy `_cast` makes). `key` is a seed or a
    `torch.Generator` on `device`; the weights have the reference's
    distribution and scale, not its bits (`models.convert` carries the
    reference's across). `device="meta"` builds shapes only. With
    `place(name, subtree)` each top-level subtree, and each group of a
    stack on its own, goes through `place` as soon as it is drawn, so the
    whole tree never exists at once: the result is the tree of what
    `place` returned (`launch.train.build` keeps a process's parts)."""
    dev = resolve_device(device)
    gen = _generator(key, dev)
    f32 = torch.float32

    def keep(name, sub):  # in the LM's own layout (its key order), then placed
        if place is None:
            return sub
        stack = name.endswith("stack")
        sub = LM(cfg, {name: [sub] if stack else sub}).tree()[name]
        return place(name, sub[0] if stack else sub)

    tree: dict[str, Any] = {
        "tok": keep("tok", T.embed_init(cfg, gen, f32, dev)),
        "stack": [keep("stack", g)
                  for g in T.stack_init(cfg, gen, cfg.pattern, cfg.n_groups, f32, dev)],
        "final_norm": keep("final_norm", T._norm_init(cfg, f32, dev)),
    }
    if cfg.family == "encdec":
        tree["enc_stack"] = [keep("enc_stack", g) for g in
                             T.stack_init(cfg, gen, ENC_PATTERN, cfg.enc_layers, f32, dev)]
        tree["enc_norm"] = keep("enc_norm", T._norm_init(cfg, f32, dev))
    return tree if place else LM(cfg, tree)


def _cast(params: LM, dtype) -> LM:
    """`params` with every floating leaf in `dtype`, as the reference's
    `_cast`: `params` itself when they already are, else a copy made once
    and kept on `params` (remade when a master weight changes in place)."""
    leaves = list(params.parameters())
    if all(p.dtype == dtype or not p.is_floating_point() for p in leaves):
        return params
    versions = tuple(p._version for p in leaves)
    hit = params._casts.get(dtype)
    if hit is None or hit[0] != versions:
        params._casts.clear()
        cast = LM(params.cfg, _map_tree(
            params.tree(), lambda a: a.detach().to(dtype) if a.is_floating_point() else a))
        hit = params._casts[dtype] = (versions, cast)
    return hit[1]


@functools.lru_cache(maxsize=16)
def _sinusoidal_table(max_len: int, d: int, dtype: torch.dtype, device: torch.device):
    pos = np.arange(max_len)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * i / d)
    emb = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.from_numpy(emb).to(dtype).to(device)


def _sinusoidal(max_len, d, dtype, device="cpu"):
    """Sinusoidal positions [max_len, d]: numpy f64, then a cast, as the
    reference's; made once per shape, dtype and device and kept there, so
    a decode step copies nothing to the card."""
    return _sinusoidal_table(int(max_len), int(d), dtype, torch.device(device))


def _train_cast(params: LM, dtype) -> dict:
    """The parameter tree (`LM.tree()`) with every floating leaf cast to
    `dtype` inside autograd's graph, made anew each call as the
    reference's in-loss `_cast`: the masters' gradients flow back through
    the casts (a leaf already in `dtype` is the master itself)."""
    return _map_tree(params.tree(),
                     lambda a: a.to(dtype) if a.is_floating_point() else a)


def _encode_memory(cfg, params, batch, gather=None, device=None):
    """Cross-attention memory: whisper runs the encoder over (stubbed) frame
    embeddings; VLM consumes (stubbed) patch embeddings directly. `params`
    (an `LM` or its tree) is already in the compute dtype, or on a mesh
    its parts, which `gather` turns into a group's weights."""
    dev = params["tok"]["embed"].device if device is None else device
    if cfg.family == "encdec":
        mem = batch["frames"].to(dev, _dtype(cfg))
        mem = mem + _sinusoidal(mem.shape[1], cfg.d_model, mem.dtype, dev)[None]
        mem, _ = T.stack_apply_train(cfg, params["enc_stack"], mem, ENC_PATTERN,
                                     causal=False, gather=gather)
        norm = params["enc_norm"] if gather is None else gather(params["enc_norm"])
        return T._apply_norm(cfg, norm, mem)
    if cfg.family == "vlm":
        return batch["memory"].to(dev, _dtype(cfg))
    return None


def _shard_plan(cfg, params, B: int) -> list:
    """The passes of a batch of B rows: [(rows, device, cfg, aux share,
    pass key)]. One pass on the params' device for an `LM`. On a mesh,
    each data shard in turn (its rows, its model-rank-0 shard's device,
    the policy as one data shard sees it, 1/dp of the aux loss), or one
    pass over all rows on the mesh's home where B does not divide over the
    data shards. Over several processes a process runs its own data
    shards' passes, each keyed by its batch rank so that
    `ShardedLM.settle` adds the passes' gradients in rank order: the
    processes of one data shard's model group run the same rows through
    the same dense weights (the model axis stores, it does not split the
    dense compute), and each runs its own model ranks of the MoE (the
    pass's policy carries its model group, `AxisGroup`)."""
    if not isinstance(params, SH.ShardedLM):
        return [(slice(0, B), params.device, cfg, 1.0, None)]
    dp, tp = cfg.policy.dp_size, cfg.policy.tp_size
    mesh = params.mesh
    if B % dp:
        return [(slice(0, B), mesh.home, cfg, 1.0, None)]
    local = cfg.with_policy(dataclasses.replace(cfg.policy, dp_size=1))
    n = B // dp
    if not mesh.multi:
        return [(slice(d * n, (d + 1) * n), mesh.devices[d * tp], local, 1.0 / dp, None)
                for d in range(dp)]
    axes = TM.batch_axes(mesh)
    mine = {}
    for s in mesh.local:
        mine.setdefault(mesh.batch_rank(s, axes), s)
    return [(slice(d * n, (d + 1) * n), mesh.devices[mine[d]],
             local.with_policy(local.policy.with_group(mesh.axis_group(cfg.policy.model,
                                                                       mine[d]))), 1.0 / dp, d)
            for d in sorted(mine)]


def _weights(cfg, params, device, cast, key=None):
    """(the tree the model reads, the gather hook, the `tok` and
    `final_norm` weights in the compute dtype): an `LM` through `cast`
    (`_train_cast` in the graph to train, `_cast`'s cached copy to serve),
    or a `ShardedLM`'s parts with a hook that gathers a group onto
    `device` (for pass `key` over several processes; where the pass's
    model group spans processes, the MoE's experts of its own ranks
    only)."""
    dtype = _dtype(cfg)
    if isinstance(params, SH.ShardedLM):
        p = params.tree()
        group = cfg.policy.group
        experts = group.ranks if group is not None and group.spans else None

        def gather(tree):
            return SH.gather_tree(tree, device, dtype, key, experts)

        return p, gather, gather(p["tok"]), gather(p["final_norm"])
    p = cast(params, dtype)
    return p, None, p["tok"], p["final_norm"]


def _forward(cfg, params, batch, device, count=None, key=None):
    """forward_train's (ce, aux) of one pass of `_shard_plan`."""
    p, gather, tok, norm = _weights(cfg, params, device, _train_cast, key)
    tokens = batch["tokens"].to(device)
    x = T.embed_tokens(cfg, tok, tokens)
    if cfg.pos_embed == "sinusoidal":
        x = x + _sinusoidal(x.shape[1], cfg.d_model, x.dtype, device)[None]
    memory = _encode_memory(cfg, p, batch, gather, device)
    x, aux = T.stack_apply_train(cfg, p["stack"], x, cfg.pattern, memory=memory,
                                 gather=gather)
    x = T._apply_norm(cfg, norm, x)
    ce = T.chunked_ce_loss(cfg, tok, x, batch["labels"].to(device),
                           batch["mask"].to(device), count=count)
    if not torch.is_tensor(aux):  # no MoE layer: 0.0, made on the device (no copy)
        aux = torch.full((), aux, dtype=torch.float32, device=device)
    return ce, aux


def _rows(batch, rows):
    return {k: v[rows] for k, v in batch.items()}


def _shard_losses(cfg, params, batch):
    """Per pass of `_shard_plan`: (loss, ce, aux), each the pass's part of
    the whole batch's (its nll sum over the batch's mask count, its share
    of the aux loss), so the parts add up to the batch's."""
    plan = _shard_plan(cfg, params, batch["tokens"].shape[0])
    count = None
    if len(plan) > 1 or plan[0][4] is not None:  # the batch's rows over several passes
        count = batch["mask"].to(torch.float32).sum()
    for rows, dev, pcfg, share, key in plan:
        ce, aux = _forward(pcfg, params, _rows(batch, rows), dev,
                           None if count is None else count.to(dev), key)
        aux = aux * share if share != 1.0 else aux
        yield ce + cfg.aux_loss_weight * aux, ce, aux


def forward_train(cfg: ArchConfig, params, batch):
    """batch: tokens [B,S], labels [B,S], mask [B,S] (+frames|memory).
    Returns (loss, {"ce", "aux"}), 0-d f32 tensors; `loss = ce +
    aux_loss_weight * aux`. Differentiable in the masters wherever they
    require grad (`make_train_step` turns that on). `params` is an `LM`
    or, on a mesh, a `ShardedLM` (the data shards' parts added on the
    mesh's home in pass order). Over several processes every process
    gets the single controller's values: its passes' parts and the
    others', gathered over the batch axes as `make_train_step` gathers
    them (the others' are values; `make_train_step` differentiates
    every pass)."""
    home = params.device
    keys = [k for *_, k in _shard_plan(cfg, params, batch["tokens"].shape[0])]
    parts = list(_shard_losses(cfg, params, batch))
    if len(parts) == 1 and keys[0] is None:
        loss, ce, aux = parts[0]
        return loss, {"ce": ce, "aux": aux}
    loss, ms = _pass_losses(params, [[torch.stack([t.to(home) for t in part])
                                      for part in parts]], keys)
    return loss, ms[0]


# --------------------------------------------------------------------------
# serve: cache init / prefill / decode
# --------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device=None):
    return T.stack_cache_init(cfg, cfg.pattern, cfg.n_groups, batch, max_len,
                              getattr(torch, cfg.cache_dtype), resolve_device(device))


def _cache_rows(cache, rows, device, key=None):
    """The rows of a cache (dim 1 of its stacked leaves): a slice view of a
    plain cache, or joined onto `device` from a sharded one's parts (over
    several processes, pass `key`'s from its data shard's model group)."""
    if isinstance(cache, SH.ShardedCache):
        mesh, group = cache.mesh, None
        if mesh.multi and key is not None:
            axes = TM.batch_axes(mesh)
            group = next(g for g in mesh.groups("model") if mesh.batch_rank(g[0], axes) == key)
        return cache.rows(rows, device, group)
    return {b: {n: a[:, rows] for n, a in c.items()} for b, c in cache.items()}


def _gather_passes(params, keys: list, values: list):
    """The passes' `values` (one a pass, batch-major; `keys` the passes'
    keys of `_shard_plan`) joined on dim 0 on the params' device, in pass
    order. Over several processes every pass's value is fetched over the
    batch axes first, so every process gets the single controller's
    tensor."""
    home = params.device
    if keys[0] is None:
        return torch.cat([v.to(home) for v in values], 0)
    mesh = params.mesh
    axes = TM.batch_axes(mesh)
    got = TM.over(mesh, axes, lambda vs: [torch.cat(vs, 0)] * len(vs),
                  {s: values[keys.index(mesh.batch_rank(s, axes))] for s in mesh.local})
    return got[mesh.local[0]].to(home)


@torch.no_grad()
def _decode(cfg, params, cache, token, cur_len, device):
    p, gather, tok, norm = _weights(cfg, params, device, _cast)
    x = T.embed_tokens(cfg, tok, token)
    if cfg.pos_embed == "sinusoidal":
        pe = _sinusoidal(cache_max_len(cache), cfg.d_model, x.dtype, x.device)
        if isinstance(cur_len, torch.Tensor):
            row = cur_len.reshape(1).clamp(0, pe.shape[0] - 1).to(torch.long)
            x = x + pe.index_select(0, row)[None]
        else:
            c = min(max(int(cur_len), 0), pe.shape[0] - 1)
            x = x + pe[c:c + 1][None]
    x, cache = T.stack_apply_decode(cfg, p["stack"], x, cache, cur_len, cfg.pattern,
                                    gather=gather)
    x = T._apply_norm(cfg, norm, x)
    return T.logits_last(cfg, tok, x), cache


@torch.no_grad()
def decode_step(cfg: ArchConfig, params, cache, token, cur_len):
    """One token for every sequence. token: [B,1] int; cur_len: a Python int
    or a 0-d int tensor on the params' device. Returns (logits [B,1,V] f32,
    cache). The cache is written in place and returned: the cache passed in
    is consumed. Nothing in a step reads the device back.

    On a mesh (`ShardedLM` params and the `ShardedCache` `prefill` made)
    each data shard decodes its rows in turn: its cache rows joined from
    their parts (the model axis is storage only), the step run, the rows
    written back into the parts. Over several processes a process steps
    its own data shards' rows: it reads them from its model group's parts
    (the other processes' fetched), writes back its own parts, and gets
    every pass's logits over the batch axes: every process returns the
    single controller's [B, 1, V]."""
    plan = _shard_plan(cfg, params, token.shape[0])
    if len(plan) == 1 and not isinstance(cache, SH.ShardedCache):
        return _decode(plan[0][2], params, cache, token, cur_len, plan[0][1])
    outs = []
    for rows, dev, pcfg, _, key in plan:
        pos = cur_len.to(dev) if isinstance(cur_len, torch.Tensor) else cur_len
        local = _cache_rows(cache, rows, dev, key)
        logits, local = _decode(pcfg, params, local, token[rows].to(dev), pos, dev)
        if isinstance(cache, SH.ShardedCache):  # a plain cache's rows are views
            cache.write_rows(rows, local)
        outs.append(logits)
    return _gather_passes(params, [k for *_, k in plan], outs), cache


def cache_max_len(cache) -> int:
    for k in cache:
        if "k" in cache[k]:
            return cache[k]["k"].shape[2]
    return 1


@torch.no_grad()
def _prefill(cfg, params, batch, max_len, device):
    p, gather, tok, norm = _weights(cfg, params, device, _cast)
    tokens = batch["tokens"].to(device)
    Sq = tokens.shape[1]
    x = T.embed_tokens(cfg, tok, tokens)
    if cfg.pos_embed == "sinusoidal":
        x = x + _sinusoidal(Sq, cfg.d_model, x.dtype, device)[None]
    memory = _encode_memory(cfg, p, batch, gather, device)
    x, cache = T.stack_apply_prefill(cfg, p["stack"], x, cfg.pattern, max_len,
                                     getattr(torch, cfg.cache_dtype), memory=memory,
                                     gather=gather)
    x = T._apply_norm(cfg, norm, x)
    return T.logits_last(cfg, tok, x[:, -1:]), cache


@torch.no_grad()
def prefill(cfg: ArchConfig, params, batch, max_len: int):
    """Process the full prompt, build the cache, return last-token logits.

    tokens: [B, S] → (logits [B,1,V] f32, cache); the next position is S.
    On a mesh (`ShardedLM` params) each data shard prefills its rows in
    turn, and the cache comes back placed on the mesh by `cache_specs`
    (a `ShardedCache`; sequence-sharded when the policy names a
    `seq_axis_for_cache`). Over several processes a process prefills its
    own data shards' rows and places its own parts of the cache from
    them; every process returns the single controller's logits."""
    B = batch["tokens"].shape[0]
    plan = _shard_plan(cfg, params, B)
    if not isinstance(params, SH.ShardedLM):
        return _prefill(plan[0][2], params, batch, max_len, plan[0][1])
    logits, passes = [], []
    for rows, dev, pcfg, _, _ in plan:
        lg, c = _prefill(pcfg, params, _rows(batch, rows), max_len, dev)
        logits.append(lg)
        passes.append((rows, c))
    first = passes[0][1]
    shapes = {b: {n: torch.empty((a.shape[0], B, *a.shape[2:]), dtype=a.dtype, device="meta")
                  for n, a in c.items()} for b, c in first.items()}
    specs = SH.cache_specs(cfg, shapes, params.mesh,
                           seq_shard=cfg.policy.seq_axis_for_cache is not None)
    return (_gather_passes(params, [k for *_, k in plan], logits),
            SH.ShardedCache.place(params.mesh, specs, passes, B))


# --------------------------------------------------------------------------
# step factories
# --------------------------------------------------------------------------


def _grads(params: LM) -> dict:
    """The masters' gradients as a tree (zeros for a leaf the loss does
    not reach, as JAX's gradient of an unused input)."""
    return _map_tree(params.tree(),
                     lambda a: torch.zeros_like(a) if a.grad is None else a.grad)


def _sharded_grads(params) -> dict:
    """A `ShardedLM`'s gradients: a tree of `Sharded` of the parts' grads
    (zeros for a part the loss does not reach)."""
    return SH.map_sharded(lambda sh: sh.with_parts(
        [p if p is None else torch.zeros_like(p) if p.grad is None else p.grad
         for p in sh.parts]), params.tree())


def _pass_losses(params, table: list, keys: list):
    """(loss, [per micro-batch {"ce", "aux"}]) from `table`: each
    micro-batch's f32[3] (loss, ce, aux) of this process's passes (batch
    ranks `keys`), added pass after pass in rank order, micro-batch after
    micro-batch, as one process adds them. Over several processes
    (keyed passes) every pass's rows are gathered over the batch axes
    first, so every process adds the same numbers in the same order."""
    if keys and keys[0] is not None:
        mine = torch.stack([torch.stack(rows) for rows in table], 1)  # [passes, A, 3]
        whole = _gather_passes(params, keys, list(mine[:, None]))  # [dp, A, 3]
        table = [list(whole[:, i]) for i in range(whole.shape[1])]
    loss, ms = 0.0, []
    for rows in table:
        m = {"ce": 0.0, "aux": 0.0}
        for r in rows:
            loss = loss + r[0]
            m = {"ce": m["ce"] + r[1], "aux": m["aux"] + r[2]}
        ms.append(m)
    return loss, ms


def make_train_step(cfg: ArchConfig, optimizer, param_specs=None) -> Callable:
    """(train_state, batch) → (train_state, metrics). Optimizer from
    `repro_torch.optim` (init/update pair over `LM.tree()`). Supports
    gradient accumulation.

    The state is {"params": LM, "opt": the optimizer's state, "step": a
    0-d int32 tensor}; the masters and the optimizer state are updated in
    place (the state passed in is consumed, as a donated one is in JAX).
    With `accum_steps` A > 1 the batch splits into A contiguous
    micro-batches; each one's gradients add into the masters' `.grad`
    (the first add fills it), so no second f32 tree is held, then divide
    by A; the loss is summed and divided alike, `ce` and `aux` averaged.
    metrics: {"loss", "ce", "aux", "grad_norm"} (0-d device tensors; a
    step reads nothing back to the host).

    With `param_specs` (`launch/sharding.param_specs`) the state is placed
    on a mesh (`launch/train.build`): a `ShardedLM` and the optimizer
    state as `Sharded` parts. Micro-batch i's data shard d is then rows
    [i·B/A + d·B/(A·dp), ...), as the reference reshapes the batch into
    micro-batches and shards each one; each data shard's backward runs
    right after its forward, adding its gradients into the parts. Over
    several processes each process runs its own data shards' passes and
    the passes' gradients, losses and norms are added across the
    processes in the single controller's order (`ShardedLM.settle`,
    `_pass_losses`): every process ends the step with the same state and
    metrics as one process holding every shard."""

    def train_step(state, batch):
        params, opt_state, step = state["params"], state["opt"], state["step"]
        sharded = isinstance(params, SH.ShardedLM)
        if param_specs is not None and not sharded:
            raise TypeError("make_train_step(param_specs=...) steps a state placed on a "
                            "mesh (launch.train.build); got an unsharded LM")
        params.requires_grad_(True)
        for p in params.parameters():
            p.grad = None
        home = params.device
        A = cfg.accum_steps
        n = batch["tokens"].shape[0] // A
        keys = [k for *_, k in _shard_plan(cfg, params, n)]
        table = []
        for i in range(A):
            rows = []
            for part_loss, ce, aux in _shard_losses(cfg, params,
                                                    _rows(batch, slice(i * n, (i + 1) * n))):
                part_loss.backward()
                rows.append(torch.stack([part_loss.detach().to(home), ce.detach().to(home),
                                         aux.detach().to(home)]))
            if sharded:
                params.settle()
            table.append(rows)
        loss, ms = _pass_losses(params, table, keys)
        if A > 1:
            with torch.no_grad():
                for p in params.parameters():
                    if p.grad is not None:
                        p.grad.div_(A)
        loss = loss / A
        metrics = {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}
        grads = _sharded_grads(params) if sharded else _grads(params)
        with torch.no_grad():
            grad_norm = _global_norm(grads)
        _, new_opt = optimizer.update(grads, opt_state, params.tree(), step)
        for p in params.parameters():
            p.grad = None
        new_state = {"params": params, "opt": new_opt, "step": step + 1}
        return new_state, {"loss": loss, **metrics, "grad_norm": grad_norm}

    return train_step


def make_serve_step(cfg: ArchConfig) -> Callable:
    def serve_step(params, cache, token, cur_len):
        return decode_step(cfg, params, cache, token, cur_len)

    return serve_step


def build_model(cfg: ArchConfig):
    """Bundle the functional API for one architecture."""
    return {
        "config": cfg,
        "init_params": lambda key, device=None: init_params(cfg, key, device),
        "forward_train": lambda p, b: forward_train(cfg, p, b),
        "prefill": lambda p, b, m: prefill(cfg, p, b, m),
        "decode_step": lambda p, c, t, n: decode_step(cfg, p, c, t, n),
        "init_cache": lambda b, m, device=None: init_cache(cfg, b, m, device),
    }


SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}


def shape_supported(cfg: ArchConfig, shape: str) -> bool:
    if shape == "long_500k" and not cfg.subquadratic:
        return False  # full-attention archs skip
    return True


def input_specs(cfg: ArchConfig, shape: str):
    """Shape-and-dtype stand-ins for every model input of a (arch × shape)
    cell: tensors on the `meta` device, no allocation.

    Returns (kind, specs_dict). kind ∈ {train, prefill, decode} selects
    which step function the cell runs. `shape` is a `SHAPES` name or a
    dict of the same keys (kind, seq, batch).
    """
    s = SHAPES[shape] if isinstance(shape, str) else shape
    B, S = s["batch"], s["seq"]
    f32, i32, bf16 = torch.float32, torch.int32, torch.bfloat16

    def sds(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    if s["kind"] == "train":
        specs = {"tokens": sds((B, S), i32), "labels": sds((B, S), i32),
                 "mask": sds((B, S), f32)}
        if cfg.family == "encdec":
            specs["frames"] = sds((B, S, cfg.d_model), bf16)
        if cfg.family == "vlm":
            specs["memory"] = sds((B, cfg.n_memory, cfg.d_model), bf16)
        return "train", specs
    if s["kind"] == "prefill":
        specs = {"tokens": sds((B, S), i32)}
        if cfg.family == "encdec":
            specs["frames"] = sds((B, cfg.n_memory, cfg.d_model), bf16)
        if cfg.family == "vlm":
            specs["memory"] = sds((B, cfg.n_memory, cfg.d_model), bf16)
        return "prefill", specs
    # decode: one new token against a seq_len cache
    return "decode", {
        "cache": init_cache(cfg, B, S, device="meta"),
        "token": sds((B, 1), i32),
        "cur_len": sds((), i32),
    }
