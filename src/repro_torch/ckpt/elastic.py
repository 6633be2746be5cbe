"""Elastic scaling: a restored state onto another mesh (port of
`repro/ckpt/elastic.py`).

Checkpoints hold whole (host-gathered) leaves, so resuming on a mesh of
another shape is a re-placement: compute the sharding rules for the NEW
mesh and place each leaf. The divisibility fallbacks of
`launch/sharding.py` give legal layouts at any axis size.

  * An LM train state (`reshard_state`) becomes the state `launch.train`
    steps: each leaf split into its per-shard parts by `train_state_specs`
    (a `ShardedLM`, the optimizer state as `Sharded`), each host leaf (a
    stack's: each group's slice) copied to the mesh's home once and split
    there: no second host copy of the state is made.
  * A GP state (`reshard_gp_state`) goes to the new mesh's home device as
    the global tensors its mesh step splits (`launch/mesh.Mesh.split`),
    after a check that the new mesh's axes divide it under the specs
    `engine._pick_step_builder` gives (islands % pod == 0, pop_size %
    model == 0; it validates the rest). A reference checkpoint's leaves
    (numpy, key as uint32[..., 2]) come across bit for bit.

Over several processes every process reads the same host state and
places its own shards' parts (`Sharded.place`); the GP state stays
whole on each process's home.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import engine, prng
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import Sharded
from repro_torch.models import convert


def _tensor(leaf):
    """A leaf as a tensor: numpy uint32 arrays are threefry keys, which
    the port holds as int64 words."""
    if torch.is_tensor(leaf):
        return leaf
    a = np.asarray(leaf)
    if a.dtype == np.uint32:
        return prng.key_from_numpy(a)
    return torch.from_numpy(np.array(a))


def _host(leaf) -> torch.Tensor:
    """A host leaf as a tensor, without a copy where numpy allows one
    (bfloat16 and float8 leaves are read bit for bit)."""
    if torch.is_tensor(leaf):
        return leaf
    a = np.asarray(leaf)
    if a.dtype.name in ("bfloat16", "float8_e4m3fn"):
        return convert._tensor(a, "cpu")
    if not (a.flags.c_contiguous and a.flags.writeable):
        a = np.array(a)
    return torch.from_numpy(a)


def _place(mesh, spec_tree, host, groups: bool):
    """`host` (the reference's layout) placed on `mesh` by `spec_tree`:
    each leaf a `Sharded`; with `groups`, a stack (`stack`, `enc_stack`)
    in the port's layout, one tree a group, each group's leaf slice
    placed by the stacked spec minus its lead."""
    if not isinstance(host, dict):
        return Sharded.place(mesh, _host(host).to(mesh.home), spec_tree)
    out = {}
    for k, v in host.items():
        if groups and k in ("stack", "enc_stack"):
            G = len(SH._leaves(v)[0])
            out[k] = [_place_group(mesh, spec_tree[k], v, g) for g in range(G)]
        else:
            out[k] = _place(mesh, spec_tree[k], v, groups)
    return out


def _place_group(mesh, spec_tree, host, g: int):
    if isinstance(host, dict):
        return {k: _place_group(mesh, spec_tree[k], v, g) for k, v in host.items()}
    return Sharded.place(mesh, _host(host)[g].to(mesh.home), spec_tree[1:])


def reshard_state(state_host, cfg, mesh):
    """A host train state (the reference's layout: a checkpoint, or
    `convert.train_state_to_numpy`) → the port's state on `mesh`: a
    `ShardedLM`, the optimizer state as `Sharded` (AdamW's `m`/`v` in the
    port's layout, Adafactor's `stats` in the reference's), `step` on the
    mesh's home. `cfg` takes the mesh's policy where it has none."""
    cfg = cfg if cfg.policy else cfg.with_policy(SH.policy_for(mesh))
    specs = SH.train_state_specs(cfg, state_host, mesh)
    opt = state_host["opt"]
    groups = "stats" not in opt
    with torch.no_grad():
        return {"params": SH.ShardedLM(cfg, mesh, _place(mesh, specs["params"],
                                                         state_host["params"], True)),
                "opt": {k: _place(mesh, specs["opt"][k], v, groups) for k, v in opt.items()},
                "step": _host(np.asarray(state_host["step"], np.int32)).to(mesh.home)}


def reshard_tree(tree_host, spec_tree, mesh):
    """Each leaf of `tree_host` (a GP state: a NamedTuple of numpy arrays
    or tensors) on `mesh`'s home device, checked to split under its spec
    in `spec_tree` (the same structure)."""
    leaves = []
    for leaf, spec in zip(tree_host, spec_tree):
        t = _tensor(leaf).to(mesh.home)
        mesh.check(t.shape, spec)
        leaves.append(t)
    return type(tree_host)(*leaves)


def gp_state_specs(cfg, mesh, *, data_axis="data", model_axis="model", pod_axis=None):
    """The PartitionSpecs of a GPState on `mesh`: exactly the specs the
    engine's step builder splits the state with (classic: the population
    on (pod, model); island layout: the island axis on pod, each island's
    population on model)."""
    _, state_specs, *_ = engine._pick_step_builder(cfg)(
        cfg, mesh, data_axis=data_axis, model_axis=model_axis, pod_axis=pod_axis)
    return state_specs


def reshard_gp_state(state_host, cfg, mesh, *, data_axis="data", model_axis="model",
                     pod_axis=None):
    """A host GPState (a restored checkpoint: the port's, or the
    reference's leaves as numpy) -> the port's mesh state for `mesh`,
    bit for bit: a state saved from an `islands=I` run on one pod and
    device count resumes on another wherever the new axes divide the
    layout."""
    if isinstance(state_host, dict):
        state_host = engine.GPState(**state_host)
    elif not isinstance(state_host, engine.GPState):
        state_host = engine.GPState(*state_host)
    return reshard_tree(state_host, gp_state_specs(
        cfg, mesh, data_axis=data_axis, model_axis=model_axis, pod_axis=pod_axis), mesh)
