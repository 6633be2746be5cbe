"""Parameter / state / batch / cache sharding rules (FSDP x TP), and the
placement of a tree on the port's mesh (port of `repro/launch/sharding.py`).

Every model in the zoo follows one set of path-based rules:

  * tensor-parallel (`model` axis): attention heads, FFN hidden, experts
    (or per-expert ff when E doesn't divide the axis), vocab.
  * FSDP (`data` (+`pod`) axes): the other large dim of every matrix —
    params, master copies and optimizer moments all shard over the full
    mesh.

The rules are the reference's letter for letter: the candidate order,
the divisibility fallbacks (gemma's kv=1 falls back from head-sharding
to replication, never to d_head), and the stacked-leaf lead. They run on
trees in the reference's layout (a stack's leaves stacked on a leading
[n_groups] axis), on anything with a `.shape`: `state_shapes` makes such
a tree on the `meta` device, so the specs of a 398 B model are reckoned
without allocating it, as the reference's `jax.eval_shape` does.

`named` places a tree on the mesh: each leaf becomes a `Sharded`, its
per-shard parts split by its spec (the counterpart of `device_put` with a
`NamedSharding`). A stack in the port's layout (a list of groups) takes
each group's slice of the stacked spec (the spec minus its lead).
`ShardedLM` is the parameter tree of a train state placed so, and
`ShardedCache` a serving cache placed by `cache_specs`. A pass gathers a
group's weights over the batch axes only: a leaf the specs split over
the model axis as its model ranks' blocks (`gather_tree`), which the
layers compute with tensor parallel; a decode reads each rank's own
cache part (`ShardedCache.rows`). Over several processes both hold this
process's parts only, and a cache is placed from each process's own
passes.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.launch.mesh import Blocks, Mesh, P, Sharded, Slices, _names, batch_axes

_TP = "model"


def _fsdp(policy) -> tuple:
    return tuple(policy.batch)  # ("data",) or ("pod", "data")


def _axis_sizes(mesh) -> dict:
    return {name: int(mesh.shape[name]) for name in mesh.axis_names}


def policy_for(mesh):
    """The ShardingPolicy of `mesh` (the reference's `launch/train.py`
    build and `dryrun.make_policy`): batch over the batch axes, tensor
    parallelism over `model`."""
    from repro_torch.models.transformer import ShardingPolicy

    dp = math.prod(mesh.shape[a] for a in batch_axes(mesh))
    return ShardingPolicy(batch=batch_axes(mesh), model="model",
                          tp_size=mesh.shape["model"], dp_size=dp)


def _fit(shape, lead, candidates, sizes) -> P:
    """First candidate whose named axes evenly divide the dims they shard.
    Uneven tiling is refused, so e.g. gemma's kv=1 falls back from
    head-sharding to head-dim-sharding to replication."""
    for cand in candidates:
        ok = True
        for dim, ax in zip(shape[len(lead):], cand):
            if ax is None:
                continue
            axes = ax if isinstance(ax, tuple) else (ax,)
            n = 1
            for a in axes:
                n *= sizes[a]
            if dim % n:
                ok = False
                break
        if ok:
            return P(*lead, *cand)
    return P(*lead, *([None] * (len(shape) - len(lead))))


def spec_for_param(cfg, path: tuple, shape: tuple, sizes: dict) -> P:
    """PartitionSpec for one parameter leaf, by path name. Candidates are
    ordered best-first; divisibility picks the first legal one."""
    names = [str(k) for k in path]
    leaf = names[-1]
    fs = _fsdp(cfg.policy)
    stacked = any(n in ("stack", "enc_stack") for n in names)
    lead = (None,) if stacked else ()

    def fit(*cands):
        return _fit(shape, lead, cands, sizes)

    if leaf == "embed":
        return _fit(shape, (), [(_TP, fs), (None, fs), (None, None)], sizes)
    if leaf == "unembed":
        return _fit(shape, (), [(fs, _TP), (fs, None), (None, None)], sizes)
    if leaf in ("wq", "wk", "wv"):
        # never shard d_head: rope splits it in half
        return fit((fs, _TP, None), (fs, None, None), (None,) * 3)
    if leaf == "wo":
        return fit((_TP, None, fs), (None, None, fs), (None,) * 3)
    if leaf in ("bq", "bk", "bv"):
        return fit((_TP, None), (None, None))
    if leaf in ("w_up", "w_gate", "w_down"):
        if len(shape) - len(lead) == 3:  # MoE expert stacks [E, ., .]
            if leaf == "w_down":  # [E, ff, d]
                return fit((_TP, None, fs), (None, _TP, fs), (None, None, fs))
            return fit((_TP, fs, None), (None, fs, _TP), (None, fs, None))
        if leaf == "w_down":  # [ff, d]
            return fit((_TP, fs), (None, fs), (None, None))
        return fit((fs, _TP), (fs, None), (None, None))
    if leaf == "router":
        return fit((None, None))
    if leaf == "in_proj":
        return fit((fs, _TP), (fs, None), (None, None))
    if leaf == "out_proj":
        return fit((_TP, fs), (None, fs), (None, None))
    if leaf == "conv_w":
        return fit((None, _TP), (None, None))
    if leaf == "conv_b":
        return fit((_TP,), (None,))
    # norms, scalars (A_log, D, dt_bias), biases → replicated
    return P(*lead, *([None] * (len(shape) - len(lead))))


def _map_with_path(fn, tree, path=()):
    """`fn(path, leaf)` over the leaves of a tree of dicts (the
    reference's layout), `path` the tuple of keys."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def _shape(leaf) -> tuple:
    return tuple(getattr(leaf, "shape", ()))


def param_specs(cfg, param_shapes, mesh) -> Any:
    sizes = _axis_sizes(mesh)
    return _map_with_path(lambda path, leaf: spec_for_param(cfg, path, _shape(leaf), sizes),
                          param_shapes)


def _opt_specs(cfg, pspecs, opt_shapes) -> Any:
    """Mirror param specs onto optimizer slots (AdamW m/v: same shape;
    Adafactor r/c: param spec minus the averaged dim)."""

    def mirror(path, leaf):
        names = [str(k) for k in path]
        shape = _shape(leaf)
        # strip the optimizer container prefix ("m"/"v"/"stats") and the
        # factored suffix ("r"/"c"/"v") to locate the param path
        core = [n for n in names if n not in ("m", "v", "stats", "r", "c")]
        suffix = names[-1] if names[-1] in ("r", "c", "v") else None
        node = pspecs
        try:
            for n in core:
                node = node[n]
        except (KeyError, TypeError):
            return P(*([None] * len(shape)))
        if not isinstance(node, P):
            return P(*([None] * len(shape)))
        if len(node) == len(shape):
            return node
        if suffix == "r":  # param spec minus last dim
            return P(*node[:-1])
        if suffix == "c":  # param spec minus second-to-last dim
            return P(*node[:-2], node[-1])
        return P(*([None] * len(shape)))

    return _map_with_path(mirror, opt_shapes)


def train_state_specs(cfg, state_shapes, mesh) -> Any:
    pspecs = param_specs(cfg, state_shapes["params"], mesh)
    return {"params": pspecs,
            "opt": _opt_specs(cfg, pspecs, state_shapes["opt"]),
            "step": P()}


def batch_specs(cfg, batch_shapes) -> Any:
    b = tuple(cfg.policy.batch)
    return _map_with_path(lambda _, leaf: P(b, *([None] * (len(_shape(leaf)) - 1))),
                          batch_shapes)


def cache_specs(cfg, cache_shapes, mesh, *, seq_shard: bool) -> Any:
    """KV/SSM cache sharding. Normal decode: batch over data, kv-heads/ssm
    heads over model. long-context (batch=1): sequence over data
    (context parallelism) — the flash-merge decode in launch/serving.py
    consumes the same layout."""
    b = tuple(cfg.policy.batch)
    sizes = _axis_sizes(mesh)
    bb = None if seq_shard else b
    sq = b if seq_shard else None

    def one(path, leaf):
        leafname = str(path[-1])
        shape = _shape(leaf)
        lead = (None,)
        if leafname in ("k", "v"):  # [G, B, S, KV, hd]
            return _fit(shape, lead,
                        [(bb, sq, _TP, None), (bb, sq, None, _TP), (bb, sq, None, None)],
                        sizes)
        if leafname in ("ck", "cv"):  # [G, B, M, KV, hd]
            return _fit(shape, lead,
                        [(bb, None, _TP, None), (bb, None, None, _TP),
                         (bb, None, None, None)], sizes)
        if leafname == "ssm":  # [G, B, H, N, P]
            return _fit(shape, lead,
                        [(bb, _TP, None, None), (None, _TP, None, None),
                         (None, None, None, None)], sizes)
        if leafname == "conv":  # [G, B, K-1, conv_dim]
            return _fit(shape, lead,
                        [(bb, None, _TP), (None, None, _TP), (None, None, None)],
                        sizes)
        return P(*([None] * len(shape)))

    return _map_with_path(one, cache_shapes)


# --- shapes without allocation --------------------------------------------------


def ref_layout(tree):
    """A port tree (`LM.tree()`, AdamW's `m`/`v`) in the reference's
    layout, as `meta` tensors of the same shapes and dtypes: a stack (a
    list of groups) becomes one tree of [n_groups, ...] leaves."""
    if isinstance(tree, dict):
        return {k: ref_layout(v) for k, v in tree.items()}
    if isinstance(tree, list):
        per = [ref_layout(g) for g in tree]

        def stack(parts):
            if isinstance(parts[0], dict):
                return {k: stack([p[k] for p in parts]) for k in parts[0]}
            return torch.empty((len(parts),) + tuple(parts[0].shape), dtype=parts[0].dtype,
                               device="meta")

        return stack(per)
    return torch.empty(_shape(tree), dtype=tree.dtype, device="meta")


def state_shapes(cfg, opt) -> dict:
    """The train state {"params", "opt", "step"} of `cfg` and optimizer
    `opt` in the reference's layout, on the `meta` device: shapes and
    dtypes only (the reference's `jax.eval_shape(init_state)`)."""
    from repro_torch.models import model as Md

    params = Md.init_params(cfg, 0, device="meta").tree()
    return {"params": ref_layout(params), "opt": ref_layout(opt.init(params)),
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def shard_bytes(spec_tree, shape_tree, mesh) -> list:
    """Each shard's bytes of a tree (the reference's layout) placed by
    `spec_tree`, reckoned from the shapes: a shard holds its block of
    every leaf, replicated blocks included."""
    out = [0] * mesh.size
    specs = _leaves(spec_tree, is_leaf=lambda x: isinstance(x, P))
    shapes = _leaves(shape_tree)
    for spec, leaf in zip(specs, shapes):
        n = math.prod(_shape(leaf)) * leaf.dtype.itemsize
        split = math.prod(mesh.axis_size(a) for part in spec for a in _names(part))
        for s in range(mesh.size):
            out[s] += n // split
    return out


# --- placement ------------------------------------------------------------------


def _leaves(tree, is_leaf=None) -> list:
    if is_leaf is not None and is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k], is_leaf)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v, is_leaf)]
    return [tree]


def _group_spec(spec) -> P:
    """A stacked leaf's spec for one group's slice: the spec minus its lead."""
    return P(*spec[1:])


def named(mesh: Mesh, spec_tree, tree):
    """`tree` placed on `mesh`: every tensor leaf a `Sharded` split by its
    spec in `spec_tree` (the reference's layout). Where `tree` holds a
    stack in the port's layout (a list of groups), each group's leaves
    take their stacked spec minus the lead; a stacked leaf (the reference's
    layout) takes the spec as it is."""
    if isinstance(tree, list):
        return [named(mesh, _map_with_path(lambda _, s: _group_spec(s), spec_tree), g)
                for g in tree]
    if isinstance(tree, dict):
        return {k: named(mesh, spec_tree[k], v) for k, v in tree.items()}
    return Sharded.place(mesh, tree, spec_tree)


def zeros(mesh: Mesh, spec_tree, shape_tree):
    """A tree of `Sharded` zeros with the shapes and dtypes of `shape_tree`
    (`meta` tensors), placed as `named` places: no global tensor is made."""
    if isinstance(shape_tree, list):
        return [zeros(mesh, _map_with_path(lambda _, s: _group_spec(s), spec_tree), g)
                for g in shape_tree]
    if isinstance(shape_tree, dict):
        return {k: zeros(mesh, spec_tree[k], v) for k, v in shape_tree.items()}
    return Sharded.zeros(mesh, spec_tree, shape_tree.shape, shape_tree.dtype)


def map_sharded(fn, tree):
    """`fn` over the `Sharded` leaves of a tree (dicts, lists); other
    leaves as they are."""
    if isinstance(tree, dict):
        return {k: map_sharded(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_sharded(fn, v) for v in tree]
    return fn(tree) if isinstance(tree, Sharded) else tree


def gather_tree(tree, device, dtype=None, key=None, ranks=None):
    """Every `Sharded` leaf of `tree` gathered onto `device` (autograd
    records the gather where the parts require grad), a floating leaf cast
    to `dtype` after the gather: one group's weights, in a ZeRO-3 step
    (for pass `key` over several processes, `Sharded.gather`). With
    `ranks` (the model ranks a tensor-parallel pass runs) a leaf whose
    spec names the model axis comes as `Blocks` (split along the spec's
    model dim), each rank's block gathered over the batch axes only, and
    any other leaf whole, read from the replicas of the pass's first
    rank: no leaf is gathered over the model axis, and a process never
    fetches another model rank's block."""
    def one(sh, window=None):
        t = sh.gather(device, key, window)
        return t.to(dtype) if dtype is not None and t.is_floating_point() else t

    def walk(node):
        if isinstance(node, Sharded):
            if ranks is None:
                return one(node)
            if node.names(_TP):
                return Blocks([one(node, (_TP, r)) for r in ranks], _tp_dim(node.spec))
            return one(node, (_TP, ranks[0]))
        if isinstance(node, list):
            return [walk(v) for v in node]
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return node

    return walk(tree)


class ShardedLM:
    """An LM's parameter tree placed on a mesh: the port's layout
    (`LM.tree()`: a stack a list of groups), each leaf a `Sharded`. It
    reads as an `LM` does (`params["tok"]["embed"]`, `tree()`), and
    `parameters()` are the parts."""

    def __init__(self, cfg, mesh: Mesh, tree: dict):
        self.cfg, self.mesh, self._tree = cfg, mesh, tree

    @classmethod
    def place(cls, cfg, mesh: Mesh, params, spec_tree) -> "ShardedLM":
        """`params` (an `LM`, or its tree) split by `spec_tree` (the
        reference's layout, `param_specs`)."""
        tree = params.tree() if hasattr(params, "tree") else params
        with torch.no_grad():
            return cls(cfg, mesh, named(mesh, spec_tree, tree))

    def __getitem__(self, k):
        return self._tree[k]

    def tree(self) -> dict:
        return self._tree

    def leaves(self) -> list:
        return _leaves(self._tree)

    def parameters(self):
        """This process's parts."""
        return (p for sh in self.leaves() for p in sh.local())

    def settle(self) -> None:
        """Add the passes' kept gradients into the parts (`Sharded.settle`
        over the batch axes), leaf by leaf in tree order on every process."""
        axes = batch_axes(self.mesh)
        for sh in self.leaves():
            sh.settle(axes)

    def requires_grad_(self, flag: bool = True) -> "ShardedLM":
        for p in self.parameters():
            p.requires_grad_(flag)
        return self

    @property
    def device(self) -> torch.device:
        return self.mesh.home


def _overlap(sh: Sharded, s: int, dim: int, rows: slice, window=None):
    """(the part's slices, the window's slices) of the block shard `s`
    holds within `rows` of dimension `dim` (in the coordinates of
    `window`, `Sharded.block`), or None."""
    blk = sh.block(s, window)
    lo, hi = max(blk[dim].start, rows.start), min(blk[dim].stop, rows.stop)
    if lo >= hi:
        return None
    src = [slice(None)] * sh.ndim
    src[dim] = slice(lo - blk[dim].start, hi - blk[dim].start)
    dst = list(blk)
    dst[dim] = slice(lo - rows.start, hi - rows.start)
    return tuple(src), tuple(dst)


def write_rows(sh: Sharded, dim: int, rows: slice, value, window=None) -> None:
    """Write `value` (rows `rows` of dimension `dim` of the global tensor,
    or of its `window`) into every part of this process that holds them,
    the replicas too; a part that is `value` itself is left as it is."""
    for s in sh.mesh.local:
        part = sh.parts[s]
        if part is value or (window is not None and not sh.in_window(s, window)):
            continue
        hit = _overlap(sh, s, dim, rows, window)
        if hit is not None:
            part[hit[0]] = value[hit[1]].to(part.device)


def _tp_dim(spec):
    return next((d for d, part in enumerate(spec) if _TP in _names(part)), None)


def _seq_split(sh: Sharded) -> bool:
    """Does the spec put a stacked cache leaf's sequence (dim 2 of
    [G, B, S, ...] k/v) on the batch axes (the long-context layout)?"""
    axes = set(batch_axes(sh.mesh))
    return sh.ndim == 5 and len(sh.spec) > 2 and bool(axes & set(_names(sh.spec[2])))


class ShardedCache:
    """A serving cache (`{"b{i}": {name: [n_groups, B, ...]}}`) placed on
    a mesh by `cache_specs`, each leaf a `Sharded`. A data shard's decode
    reads its rows (dim 1) from the parts (`rows`) and writes them back
    (`write_rows`). With tensor parallelism a pass reads each model rank's
    own block of a leaf the specs split over the model axis: the rank's
    part itself where it holds the pass's rows, so the decode writes into
    it in place and no cache crosses the model axis. Over several
    processes a process holds its own parts only, as a `Sharded` does,
    and the whole cache is never built on one process. A leaf whose
    sequence the specs put on the batch axes (`seq_sharded`, the
    long-context layout) is read as this process's slices of it, in
    place (`launch.mesh.Slices`)."""

    def __init__(self, mesh: Mesh, tree: dict):
        self.mesh, self._tree = mesh, tree

    @classmethod
    def place(cls, mesh: Mesh, spec_tree, passes: list, B: int) -> "ShardedCache":
        """The cache of a batch of B rows computed in passes (`passes`:
        [(rows, the rows' cache, the pass's model group, which a pass of
        whole leaves may leave out)], this process's, in row order) placed
        by `spec_tree`: each of this process's parts
        cut from the passes that computed its rows. A leaf a pass computed
        by rank (`Blocks`) gives each part its own rank's block, or, where
        the spec splits it along another dim or not over the model axis,
        is joined over the pass's ranks first (an activation gather)."""
        passes = [(*item, None)[:3] for item in passes]
        tree = {}
        for b, leaves in passes[0][1].items():
            tree[b] = {}
            for n, first in leaves.items():
                spec = P(*spec_tree[b][n])
                D = _tp_dim(spec)
                vals = []
                for r, c, g in passes:
                    v = c[b][n]
                    if isinstance(v, Blocks) and v.dim != D:
                        v = g.gather(v, v.dim)
                    vals.append((r, v, g))
                like = vals[0][1]
                shape = [*(like[0] if isinstance(like, list) else like).shape]
                if isinstance(like, list):
                    shape[D] *= mesh.axis_size(_TP)
                shape[1] = B
                parts = [None] * mesh.size
                for s in mesh.local:
                    blk = mesh._block(s, shape, spec)
                    got = []
                    for r, v, g in vals:
                        if not (r.start < blk[1].stop and blk[1].start < r.stop):
                            continue
                        if isinstance(v, list):
                            v = v[g.ranks.index(mesh.rank(s, _TP))]
                        got.append(v[:, max(blk[1].start, r.start) - r.start:
                                     min(blk[1].stop, r.stop) - r.start])
                    if sum(t.shape[1] for t in got) != blk[1].stop - blk[1].start:
                        raise ValueError(f"{b}/{n}: shard {s}'s rows {blk[1]} span passes of "
                                         "other processes (a cache not split by batch)")
                    cut = [slice(None) if d == D and isinstance(vals[0][1], list) else blk[d]
                           for d in range(2, len(shape))]
                    src = torch.cat(got, 1)[(slice(None), slice(None), *cut)]
                    parts[s] = torch.empty(src.shape, dtype=src.dtype,
                                           device=mesh.devices[s]).copy_(src)
                tree[b][n] = Sharded(mesh, spec, parts, shape)
        return cls(mesh, tree)

    def __getitem__(self, b):
        return self._tree[b]

    @property
    def seq_sharded(self) -> bool:
        """Does a leaf lie with its sequence on the batch axes?"""
        return any(_seq_split(sh) for c in self._tree.values() for sh in c.values())

    def __iter__(self):
        return iter(self._tree)

    def rows(self, rows: slice, device, group) -> dict:
        """Rows `rows` (dim 1) of every leaf on `device` for a pass of the
        model group `group` (`launch.mesh.AxisGroup`, whose `members` are
        its ranks' shards): with tensor parallelism (`group.size` > 1) a
        leaf the specs split over the model axis comes as the pass's ranks'
        `Blocks` (split along the spec's model dim), and any other leaf
        whole, from the pass's first rank. A block is its shard's part
        itself where that part holds just these rows on `device` (a view:
        the decode writes into it in place), else it is joined over the
        batch axes only (a batch run as one pass; over several processes
        with the other processes of the block's model rank). A leaf whose
        sequence lies on the batch axes comes as a rank's `Slices`: the
        parts of this process's shards of that model rank themselves (their
        rows `rows` as views), in batch-rank order; nothing is joined."""
        tp = group.size
        first = group.ranks[0]
        mesh = self.mesh

        def slices(sh, r):
            axes = batch_axes(mesh)
            shards = sorted((s for s in mesh.local if mesh.rank(s, _TP) == r),
                            key=lambda s: mesh.batch_rank(s, axes))
            parts = [sh.parts[s] if rows == slice(0, sh.parts[s].shape[1]) else
                     sh.parts[s][:, rows] for s in shards]
            return Slices(parts, shards, [sh.block(s)[2].start for s in shards],
                          sh.shape[2], mesh, axes)

        def block(sh, r):
            window = (_TP, r) if tp > 1 else None
            s = group.members[r]
            part = sh.parts[s]
            if part is not None and part.device == torch.device(device):
                blk, whole = sh.block(s, window), sh.window_shape(window)
                if blk[1] == rows and all(blk[d] == slice(0, whole[d])
                                          for d in range(sh.ndim) if d != 1):
                    return part
            return sh.mesh.join(sh.parts, sh.spec, device, window)[:, rows]

        def leaf(sh):
            one = slices if _seq_split(sh) else block
            if tp > 1 and sh.names(_TP):
                return Blocks([one(sh, r) for r in group.ranks], _tp_dim(sh.spec))
            return one(sh, first)

        return {b: {n: leaf(sh) for n, sh in c.items()} for b, c in self._tree.items()}

    def write_rows(self, rows: slice, local: dict, group) -> None:
        """Write a pass's rows back (`rows`' structure): into every part of
        this process holding them, but the parts the decode wrote in
        place (a sequence-sharded leaf's slices are those parts)."""
        for b, c in self._tree.items():
            for n, sh in c.items():
                v = local[b][n]
                if _seq_split(sh):
                    continue
                if isinstance(v, list):
                    for r, t in zip(group.ranks, v):
                        write_rows(sh, 1, rows, t, (_TP, r))
                else:
                    write_rows(sh, 1, rows, v)

    def join(self, device=None) -> dict:
        """The global cache (a plain one) on `device` (default: home)."""
        return {b: {n: sh.join(device) for n, sh in c.items()} for b, c in self._tree.items()}

