"""Carry the reference's weights, caches and train states across to the
port, and back.

The reference's `init_params` pytree holds each stack's leaves stacked on a
leading [n_groups] axis; the port's `LM` holds one `Block` a block. The
cache layout is the same in both (`{"b{i}": {name: [n_groups, ...]}}`).
A train state is {"params", "opt", "step"}: AdamW's `m` and `v` have the
params' layout in each package, Adafactor's `stats` the reference's in
both. Leaves come as numpy arrays (or anything `np.asarray` takes);
numpy's extension dtypes bfloat16 and float8_e4m3fn are read bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.launch.mesh import Sharded
from repro_torch.models.model import ENC_PATTERN, LM

# numpy extension dtypes (ml_dtypes) → (unsigned view, torch dtype)
_VIEWS = {"bfloat16": (np.uint16, torch.bfloat16),
          "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn)}


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name in _VIEWS:
        view, dt = _VIEWS[a.dtype.name]
        return torch.from_numpy(np.ascontiguousarray(a).view(view).copy()).view(dt).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _unstack(tree: dict, n_groups: int, device) -> list:
    """{"b{i}": {...: [G, ...]}} → [{"b{i}": {...: [...]}} for each group]."""
    return [{b: {k: {n: _tensor(np.asarray(a)[g], device) for n, a in v.items()}
                 for k, v in blk.items()} for b, blk in tree.items()}
            for g in range(n_groups)]


def _port_tree(cfg, tree: dict, device) -> dict:
    """A tree in the reference's params layout → the port's (`LM.tree()`)."""
    out = {"tok": {n: _tensor(a, device) for n, a in tree["tok"].items()},
           "stack": _unstack(tree["stack"], cfg.n_groups, device),
           "final_norm": {n: _tensor(a, device) for n, a in tree["final_norm"].items()}}
    if "enc_stack" in tree:
        out["enc_stack"] = _unstack(tree["enc_stack"], cfg.enc_layers // len(ENC_PATTERN),
                                    device)
        out["enc_norm"] = {n: _tensor(a, device) for n, a in tree["enc_norm"].items()}
    return out


def params_from_reference(cfg, tree: dict, device="cpu") -> LM:
    """The reference's `init_params(cfg, key)` pytree → the port's `LM`
    on `device`, every leaf bit for bit."""
    return LM(cfg, _port_tree(cfg, tree, device))


def _value(t) -> torch.Tensor:
    """A leaf's global value on its device (a leaf placed on a mesh joined
    on the mesh's home)."""
    return t.join() if isinstance(t, Sharded) else t.detach()


def _numpy(t) -> np.ndarray:
    return _value(t).to("cpu", copy=True).numpy()


def _stack(groups):
    """A stack's groups, leaf by leaf, stacked on the device and copied to
    the host once a leaf."""
    if isinstance(groups[0], dict):
        return {k: _stack([g[k] for g in groups]) for k in groups[0]}
    return torch.stack([_value(g) for g in groups]).cpu().numpy()


def tree_to_numpy(tree):
    """A port tree (`LM.tree()`, AdamW's `m`/`v`, or any tree of dicts and
    tensors; on a mesh, of `Sharded` leaves) → numpy in the reference's
    layout: a stack's groups stacked on a leading [n_groups] axis."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return _stack(tree)
    return _numpy(tree)


def _map_numpy(tree, device):
    if isinstance(tree, dict):
        return {k: _map_numpy(v, device) for k, v in tree.items()}
    return _tensor(tree, device)


def train_state_from_reference(cfg, state: dict, device="cpu") -> dict:
    """The reference's train state {"params", "opt", "step"} → the port's
    on `device`, every leaf bit for bit: an `LM`, the optimizer state
    (AdamW's `m`/`v` in the port's layout, Adafactor's `stats` as they
    are) and `step` a 0-d int32 tensor."""
    opt = state["opt"]
    if "stats" in opt:
        port_opt = {"stats": _map_numpy(opt["stats"], device)}
    else:
        port_opt = {k: _port_tree(cfg, v, device) for k, v in opt.items()}
    return {"params": params_from_reference(cfg, state["params"], device),
            "opt": port_opt,
            "step": torch.as_tensor(np.asarray(state["step"], np.int32)).to(device)}


def train_state_to_numpy(state: dict) -> dict:
    """The port's train state → numpy in the reference's layout (stacks
    on a leading [n_groups] axis), for comparisons and checkpoints."""
    return {"params": tree_to_numpy(state["params"].tree()),
            "opt": tree_to_numpy(state["opt"]),
            "step": _numpy(state["step"])}


def cache_from_reference(cfg, tree: dict, device="cpu") -> dict:
    """The reference's serving cache → the port's (the same layout)."""
    return {b: {n: _tensor(a, device) for n, a in c.items()} for b, c in tree.items()}


def cache_to_numpy(cache: dict) -> dict:
    """A copy of the port's cache as numpy (a decode step writes the cache
    in place), for comparisons: f32 for the dtypes numpy lacks (bfloat16,
    float8), which f32 holds exactly."""
    if hasattr(cache, "join"):  # a cache placed on a mesh
        cache = cache.join("cpu")

    def one(t):
        t = t.detach().to("cpu", copy=True)
        if t.dtype in (torch.bfloat16, torch.float8_e4m3fn):
            t = t.float()
        return t.numpy()

    return {b: {n: one(t) for n, t in c.items()} for b, c in cache.items()}
