"""Async, integrity-checked, retention-managed checkpoints.

Port of `repro/ckpt/checkpoint.py`, in the same on-disk layout, so a
checkpoint written by either package restores in the other:

    <dir>/step_00000420/
        manifest.json   tree structure, paths, shapes/dtypes, per-leaf
                        sha256; written last, then the directory is
                        renamed from `.tmp` (torn-write detection)
        000000.npy ...  one file per leaf

A state is flattened in the reference's pytree order: NamedTuple fields
in order (path `.name`), dict keys sorted (`['k']`), list and tuple items
(`[i]`). A `GPState` is written in the reference's dtypes (its key as
uint32 words, `engine.state_to_numpy`), so the digests are the ones the
reference computes; restoring into a `GPState` goes back through
`engine.state_from_numpy` onto the device of the state it is shaped
like.

`CheckpointManager` copies the state to the host on the calling thread
and hands the numpy snapshot to one background IO thread: the thread
never touches a CUDA tensor, and the generation loop waits only for the
copy.

Over several processes (`launch.cluster.init_cluster`) every process
calls a save with the whole state (a mesh state joins its leaves to
every process first), process 0 alone writes it, and a barrier follows,
so no process reads a checkpoint before it is committed.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time

import numpy as np
import torch

from repro_torch.core.engine import GPState, state_from_numpy, state_to_numpy


def _flatten(tree, path: str = ""):
    """[(path, leaf)] in the reference's pytree order (a GPState of
    tensors in the reference's dtypes)."""
    if isinstance(tree, GPState) and torch.is_tensor(tree.key):
        tree = GPState(**state_to_numpy(tree))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [item for name in tree._fields
                for item in _flatten(getattr(tree, name), f"{path}.{name}")]
    if isinstance(tree, dict):
        return [item for k in sorted(tree) for item in _flatten(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree) for item in _flatten(v, f"{path}[{i}]")]
    if tree is None:
        return []
    return [(path, tree)]


def _treedef(tree) -> str:
    """The structure in the notation of `str(jax PyTreeDef)`."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        inner = ", ".join(_treedef(getattr(tree, n)) for n in tree._fields)
        return f"CustomNode(namedtuple[{type(tree).__name__}], [{inner}])"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, list):
        return "[" + ", ".join(_treedef(v) for v in tree) + "]"
    if isinstance(tree, tuple):
        return "(" + ", ".join(_treedef(v) for v in tree) + ("," if len(tree) == 1 else "") + ")"
    return "None" if tree is None else "*"


def _host_leaves(tree):
    """(treedef, [(path, host numpy array)]): the state copied to the
    host, what the IO thread writes."""
    flat = [(p, leaf.detach().cpu().numpy() if torch.is_tensor(leaf) else np.asarray(leaf))
            for p, leaf in _flatten(tree)]
    return f"PyTreeDef({_treedef(tree)})", flat


def _cluster():
    """torch.distributed where several processes run, else None."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return dist
    return None


def _writes() -> bool:
    """Does this process write checkpoints (process 0, or the only one)?"""
    d = _cluster()
    return d is None or d.get_rank() == 0


def save(tree, directory: str, step: int) -> str:
    """Synchronous save (process 0 writes, every process waits for it).
    Returns the checkpoint path."""
    snap = _host_leaves(tree)
    path = os.path.join(directory, f"step_{step:08d}")
    if _writes():
        _write(directory, step, *snap)
    if _cluster():
        _cluster().barrier()
    return path


def _write(directory: str, step: int, treedef: str, flat) -> str:
    path = os.path.join(directory, f"step_{step:08d}")
    tmp = path + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "treedef": treedef, "time": time.time(),
                "paths": [p for p, _ in flat], "leaves": []}
    for i, (_, arr) in enumerate(flat):
        fname = f"{i:06d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        digest = hashlib.sha256(arr.tobytes()).hexdigest()
        manifest["leaves"].append({"file": fname, "shape": list(arr.shape),
                                   "dtype": str(arr.dtype), "sha256": digest})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)  # atomic commit
    return path


def _unflatten(like, leaves):
    """`leaves` (an iterator of numpy arrays) in the structure of `like`;
    a leaf that is a tensor in `like` comes back a tensor on its device."""
    if isinstance(like, GPState):
        arrays = {name: next(leaves) for name in GPState._fields}
        return state_from_numpy(arrays, device=like.op.device)
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(getattr(like, n), leaves) for n in like._fields))
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    if like is None:
        return None
    arr = next(leaves)
    if torch.is_tensor(like):
        return torch.from_numpy(np.array(arr)).to(like.device)
    return arr


def restore(directory: str, step: int, like=None, *, verify: bool = True):
    """Load a checkpoint and verify its digests. With `like` (a state of
    the same structure, e.g. a freshly initialized GPState) the leaves
    come back in that structure, tensors on its device; without it,
    (leaves, manifest)."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = []
    for meta in manifest["leaves"]:
        arr = np.load(os.path.join(path, meta["file"]))
        if verify:
            digest = hashlib.sha256(arr.tobytes()).hexdigest()
            if digest != meta["sha256"]:
                raise IOError(f"checkpoint corruption in {path}/{meta['file']}")
        leaves.append(arr)
    if like is None:
        return leaves, manifest
    expected = len(_flatten(like))
    if expected != len(leaves):
        raise ValueError(
            f"checkpoint at {path} has {len(leaves)} leaves but the restore "
            f"target expects {expected}: the state format changed between "
            f"writer and reader; restore with like=None, or re-initialize")
    return _unflatten(like, iter(leaves))


def latest_step(directory: str) -> int | None:
    """The newest committed step in `directory` (a `.tmp` directory or
    one without a manifest is no checkpoint), or None."""
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")
             and os.path.exists(os.path.join(directory, d, "manifest.json"))]
    return max(steps) if steps else None


class CheckpointManager:
    """Async save + retention: one background IO thread; `wait()` joins."""

    def __init__(self, directory: str, *, keep: int = 3, every: int = 100):
        self.directory = directory
        self.keep = keep
        self.every = every
        self._thread: threading.Thread | None = None
        self.saved_steps: list[int] = []

    def maybe_save(self, tree, step: int, *, force: bool = False) -> bool:
        """Save `tree` as `step` when the period comes due (or `force`):
        the host copy happens here, the file IO on the thread."""
        if not force and (step == 0 or step % self.every):
            return False
        snap = _host_leaves(tree)  # blocks for the device-to-host copy only
        self.wait()
        if _writes():
            self._thread = threading.Thread(target=self._save, args=(snap, step),
                                            daemon=True)
            self._thread.start()
        return True

    def _save(self, snap, step: int):
        _write(self.directory, step, *snap)
        self.saved_steps.append(step)
        self._retain()

    def _retain(self):
        steps = sorted({int(d.split("_")[1]) for d in os.listdir(self.directory)
                        if d.startswith("step_") and not d.endswith(".tmp")})
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    def wait(self):
        """Join the IO thread; over several processes, a barrier after it."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if _cluster():
            _cluster().barrier()

    def restore_latest(self, like):
        """(state restored in the structure of `like`, step) of the
        newest committed checkpoint, or (None, None)."""
        step = latest_step(self.directory)
        if step is None:
            return None, None
        return restore(self.directory, step, like=like), step
