"""Elastic scaling of a GP run: a restored state onto another mesh.

Port of the GP half of `repro/ckpt/elastic.py`. Checkpoints hold whole
leaves, so resuming on a mesh of another shape is a re-placement: each
leaf goes to the new mesh's home device as the global tensor its mesh
step splits (`launch/mesh.Mesh.split`), after a check that the new
mesh's axes divide it under the specs the engine's step builder gives
(islands % pod == 0, pop_size % model == 0; the builder validates the
rest). A reference checkpoint's leaves (numpy, key as uint32[..., 2])
come across bit for bit, so a run saved on one mesh resumes on another.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import engine, prng


def _tensor(leaf):
    """A leaf as a tensor: numpy uint32 arrays are threefry keys, which
    the port holds as int64 words."""
    if torch.is_tensor(leaf):
        return leaf
    a = np.asarray(leaf)
    if a.dtype == np.uint32:
        return prng.key_from_numpy(a)
    return torch.from_numpy(np.array(a))


def reshard_tree(tree_host, spec_tree, mesh):
    """Each leaf of `tree_host` (a NamedTuple of numpy arrays or tensors)
    on `mesh`'s home device, checked to split under its spec in
    `spec_tree` (the same structure)."""
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
