"""AdamW and Adafactor, functional (init/update pairs); port of
`repro/optim/adamw.py`.

Both apply global-norm clipping and an optional cosine schedule, and both
keep f32 master params (the forward casts them to the compute dtype).

A parameter tree is the port's (`LM.tree()`): dicts of tensors, a stack a
list of groups. The reference stacks a stack's leaves on a leading
[n_groups] axis; where that matters the port reads the tree in the
reference's layout (`_views`): the global norm sums the reference's
leaves in its order (dict keys sorted, all groups of a stacked leaf
together), and Adafactor, whose factoring and update clip depend on a
leaf's shape, runs on each stacked leaf and keeps its state stacked.
AdamW is elementwise and keeps `m` and `v` in the port's layout.

On a mesh (`launch/train.build`) the leaves of the params, the gradients
and the optimizer state are `Sharded`, stored as per-shard parts. AdamW
updates each part in place, element by element. The global norm sums
the squares of the parts that hold each block once (not the replicas),
in shard order. Adafactor's row and column means span the shards, so it
updates one leaf at a time: the leaf and its stats gathered, the
reference's update, the results written back into the parts (the peak
grows by one leaf, never the model).

`step` is a 0-d int tensor on the parameters' device (a Python int works
too): the schedule and the bias corrections are computed on the device,
so an update reads nothing back to the host. An update writes the
master params (and AdamW's `m` and `v`) in place, as `torch.optim` does,
and returns them; the in-place write bumps each tensor's `_version`, so
the serving copy (`models.model._cast`) is made anew.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.launch.mesh import Sharded, exchange


def cosine_schedule(base_lr: float, warmup: int, total: int) -> Callable:
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * 0.5 * (1.0 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)

    return lr


# --- trees ---------------------------------------------------------------------


class _Stacked(list):
    """One leaf of the reference's layout: the groups' tensors of a stack
    leaf, in group order (the reference's [n_groups, ...] array)."""


def _views(tree):
    """`tree` in the reference's layout: dicts as they are, a stack (a list
    of groups) as one tree whose leaves are `_Stacked` lists of the
    groups' tensors; any other leaf a tensor."""
    if isinstance(tree, dict):
        return {k: _views(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return _merge([_views(g) for g in tree])
    return tree


def _merge(per_group):
    if isinstance(per_group[0], dict):
        return {k: _merge([g[k] for g in per_group]) for k in per_group[0]}
    return _Stacked(per_group)


def _value(leaf):
    """A view leaf as one tensor (a stacked leaf as a fresh [G, ...] copy;
    a `Sharded` one joined from its parts)."""
    if isinstance(leaf, _Stacked):
        return torch.stack([_value(g) for g in leaf])
    return leaf.join() if isinstance(leaf, Sharded) else leaf


def _write(leaf, value):
    """Write `value` into a view leaf, in place (a stacked leaf's groups,
    a `Sharded` leaf's parts)."""
    if isinstance(leaf, _Stacked):
        for g, v in zip(leaf, value):
            _write(g, v)
    elif isinstance(leaf, Sharded):
        leaf.assign(value)
    else:
        leaf.copy_(value)


def _part_sq(p):
    return torch.sum(p.to(torch.float32) ** 2)


def _sq_sum(g, owned=None):
    """Σ g² in f32: a `Sharded` leaf's parts that hold each block once,
    added in shard order on the mesh's home (`owned`: each owner part's
    sum, where they come from other processes, `_owned_sums`)."""
    if isinstance(g, Sharded):
        s = 0
        for k in g.owners():
            part = _part_sq(g.parts[k]) if owned is None else owned[k]
            s = s + part.to(g.mesh.home)
        return s
    return torch.sum(g.to(torch.float32) ** 2)


def _owned_sums(leaves) -> dict:
    """{id(leaf): {owner shard: Σ part²}} for the `Sharded` leaves of a
    mesh of several processes: each process sums its own parts, and one
    exchange hands every process every owner's sum."""
    sharded = [g for g in leaves if isinstance(g, Sharded) and g.mesh.multi]
    if not sharded:
        return {}
    mesh = sharded[0].mesh
    home = mesh.home
    mine = {s: torch.stack([_part_sq(g.parts[s]).to(home) for g in sharded])
            for s in mesh.local}
    every = exchange(mesh, range(mesh.size), mine, procs=mesh.processes)
    return {id(g): {k: every[k][i] for k in g.owners()} for i, g in enumerate(sharded)}


def _view_items(tree, path=()):
    """[(path, view leaf)] in the reference's leaf order (keys sorted)."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree) for item in _view_items(tree[k], path + (k,))]
    return [(path, tree)]


def _tree_map(fn, tree, *rest):
    """`fn` over the leaves of trees of the same structure (dicts, lists)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _global_norm(tree):
    """sqrt of the sum of squares: one partial sum a reference leaf (a
    stacked leaf's groups added in order), the leaves added in the
    reference's order."""
    items = [list(leaf) if isinstance(leaf, _Stacked) else [leaf]
             for _, leaf in _view_items(_views(tree))]
    owned = _owned_sums([g for parts in items for g in parts])
    total = 0
    for parts in items:
        s = 0
        for g in parts:
            s = s + _sq_sum(g, owned.get(id(g)))
        total = total + s
    return torch.sqrt(total)


def _clip_scale(grads, max_norm: float):
    """The factor `_clip` multiplies every gradient by, on the device."""
    gn = _global_norm(grads)
    return torch.clamp(max_norm / torch.clamp_min(gn, 1e-9), max=1.0)


def _clip(grads, max_norm: float):
    scale = _clip_scale(grads, max_norm)
    return _tree_map(lambda g: g * scale, grads)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, Any], tuple]  # (grads, state, params, step)


def _step_t(step):
    """t = step + 1 in f32, on `step`'s device (the host's for an int)."""
    return torch.as_tensor(step).to(torch.float32) + 1.0


def adamw(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, clip_norm=1.0,
          schedule: Callable | None = None) -> Optimizer:
    sched = schedule or (lambda s: lr)

    def init(params):
        z = lambda: _tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                                    device=p.device), params)
        return {"m": z(), "v": z()}

    @torch.no_grad()
    def update(grads, state, params, step):
        """One step: params, `m` and `v` are written in place and returned."""
        scale = _clip_scale(grads, clip_norm)
        t = _step_t(step)
        lr_t = sched(step)
        bc1 = 1.0 - b1 ** t
        bc2 = 1.0 - b2 ** t

        def upd_t(p, g, m, v, scale, lr_t, bc1, bc2):
            g = g.to(torch.float32) * scale
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            p.sub_(lr_t * (u + weight_decay * p))

        def upd(p, g, m, v):
            if not isinstance(p, Sharded):
                return upd_t(p, g, m, v, scale, lr_t, bc1, bc2)
            for k in p.mesh.local:  # this process's parts
                pk = p.parts[k]
                on = [x.to(pk.device) if torch.is_tensor(x) else x
                      for x in (scale, lr_t, bc1, bc2)]
                upd_t(pk, g.parts[k], m.parts[k], v.parts[k], *on)

        _tree_map(upd, params, grads, state["m"], state["v"])
        return params, state

    return Optimizer(init, update)


def adafactor(lr=1e-3, decay=0.8, eps=1e-30, clip_norm=1.0,
              schedule: Callable | None = None) -> Optimizer:
    """Factored second moment: O(rows+cols) state for matrices, O(n) for
    vectors. No first moment → ~0.01–1 byte/param of optimizer state.

    Runs on the reference's layout: a stack leaf is updated as its
    [n_groups, ...] stack (a norm scale [G, d] is a matrix, factored into
    r [G] and c [d]; the update clip spans all G groups), then written
    back into the groups' tensors. `stats` is in the reference's layout."""
    sched = schedule or (lambda s: lr)

    def stat(shape, device):
        z = lambda s: torch.zeros(s, dtype=torch.float32, device=device)  # noqa: E731
        if len(shape) >= 2:
            return {"r": z(shape[:-1]), "c": z(shape[:-2] + shape[-1:])}
        return {"v": z(shape)}

    def _shape(leaf):
        if isinstance(leaf, _Stacked):
            return (len(leaf),) + tuple(leaf[0].shape), leaf[0].device
        return tuple(leaf.shape), leaf.device

    # a sharded state's stats are made by launch/train.build (placed by
    # `_opt_specs`); `update` reads and writes them through their parts
    def init(params):
        stats = {}
        for path, leaf in _view_items(_views(params)):
            _set(stats, path, stat(*_shape(leaf)))
        return {"stats": stats}

    @torch.no_grad()
    def update(grads, state, params, step):
        """One step: params are written in place and returned with new stats."""
        scale = _clip_scale(grads, clip_norm)
        gviews = _views(grads)
        items = _view_items(_views(params))
        t = _step_t(step)
        beta = 1.0 - t ** (-decay)
        lr_t = sched(step)
        new_stats = {}
        for path, pleaf in items:
            s_leaves = _get(state["stats"], path)
            s = {k: _value(v) for k, v in s_leaves.items()}
            p = _value(pleaf)
            g = _value(_get(gviews, path)).to(torch.float32) * scale
            g2 = g * g + eps
            if p.ndim >= 2:
                r = beta * s["r"] + (1 - beta) * g2.mean(-1)
                c = beta * s["c"] + (1 - beta) * g2.mean(-2)
                denom = (r[..., None] * c[..., None, :]) / torch.clamp_min(
                    r.mean(-1, keepdim=True)[..., None], eps)
                u = g * torch.rsqrt(torch.clamp_min(denom, eps))
                new_s = {"r": r, "c": c}
            else:
                v = beta * s["v"] + (1 - beta) * g2
                u = g * torch.rsqrt(torch.clamp_min(v, eps))
                new_s = {"v": v}
            # relative step size (Adafactor's update clipping, d=1.0)
            rms_u = torch.sqrt(torch.mean(u * u) + eps)
            u = u / torch.clamp_min(rms_u, 1.0)
            _write(pleaf, p - lr_t * u)
            if any(isinstance(v, Sharded) for v in s_leaves.values()):
                for k, v in new_s.items():  # the stats' parts, in place
                    s_leaves[k].assign(v)
                new_s = s_leaves
            _set(new_stats, path, new_s)
        return params, {"stats": new_stats}

    return Optimizer(init, update)


def for_config(cfg) -> Optimizer:
    if cfg.optimizer == "adafactor":
        return adafactor()
    return adamw()
