"""Carry the reference's weights and caches across to the port, and back.

The reference's `init_params` pytree holds each stack's leaves stacked on a
leading [n_groups] axis; the port's `LM` holds one `Block` a block. The
cache layout is the same in both (`{"b{i}": {name: [n_groups, ...]}}`).
Leaves come as numpy arrays (or anything `np.asarray` takes); numpy's
extension dtypes bfloat16 and float8_e4m3fn are read bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

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


def params_from_reference(cfg, tree: dict, device="cpu") -> LM:
    """The reference's `init_params(cfg, key)` pytree → the port's `LM`
    on `device`, every leaf bit for bit."""
    out = {"tok": {n: _tensor(a, device) for n, a in tree["tok"].items()},
           "stack": _unstack(tree["stack"], cfg.n_groups, device),
           "final_norm": {n: _tensor(a, device) for n, a in tree["final_norm"].items()}}
    if "enc_stack" in tree:
        out["enc_stack"] = _unstack(tree["enc_stack"], cfg.enc_layers // len(ENC_PATTERN),
                                    device)
        out["enc_norm"] = {n: _tensor(a, device) for n, a in tree["enc_norm"].items()}
    return LM(cfg, out)


def cache_from_reference(cfg, tree: dict, device="cpu") -> dict:
    """The reference's serving cache → the port's (the same layout)."""
    return {b: {n: _tensor(a, device) for n, a in c.items()} for b, c in tree.items()}


def cache_to_numpy(cache: dict) -> dict:
    """A copy of the port's cache as numpy (a decode step writes the cache
    in place), for comparisons: f32 for the dtypes numpy lacks (bfloat16,
    float8), which f32 holds exactly."""
    def one(t):
        t = t.detach().to("cpu", copy=True)
        if t.dtype in (torch.bfloat16, torch.float8_e4m3fn):
            t = t.float()
        return t.numpy()

    return {b: {n: one(t) for n, t in c.items()} for b, c in cache.items()}
