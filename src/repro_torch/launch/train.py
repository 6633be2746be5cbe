"""LM training entry point: config → mesh → sharded train loop with
checkpoint/restart (port of `repro/launch/train.py`). Runs reduced
configs end to end on the CPU and on the card, and full configs on a
mesh of the cards: one process holding every shard (`launch/mesh.py`),
or one process a card after `launch.cluster.init_cluster`, each holding
its own shards' parts.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b --reduced \\
        --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt [--device cpu]

`train` runs on `make_host_mesh(data=<cards>, model=1)` unless given a
mesh (over several processes, every process's cards): on one card a
one-shard mesh, which keeps the state an `LM` (the single-device step). On a larger mesh `build` places the state by
`train_state_specs` (a `ShardedLM` and `Sharded` optimizer state).
Checkpoints hold the train state in the reference's layout, whole
host-gathered leaves (`models.convert.train_state_to_numpy`); a restore
places them on the run's mesh (`ckpt.elastic.reshard_state`), whatever
mesh saved them. A resumed run skips the batches of the steps it
restored, so its history continues the uninterrupted run's (the
reference restarts the stream from its first batch). Over several
processes every process makes the same batches, joins the state for a
checkpoint (process 0 writes it, `ckpt.checkpoint`) and only the
coordinator logs.
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import time

import torch

from repro_torch.ckpt.checkpoint import CheckpointManager, latest_step, restore
from repro_torch.ckpt.elastic import reshard_state
from repro_torch.configs import get_config, get_reduced
from repro_torch.data.loader import lm_batches
from repro_torch.device import resolve_device
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import make_host_mesh, process_rank
from repro_torch.models import convert
from repro_torch.models import model as Md
from repro_torch.optim.adamw import for_config
from repro_torch.runtime.fault import StepMonitor


def build(cfg, mesh=None, seed: int = 0, device=None):
    """(cfg with the mesh's policy, train state, train step, state specs):
    params from `seed`, the config's optimizer, step 0. With no mesh, or
    a one-shard mesh, the state is one device's (`specs` None); else it
    is placed on `mesh` by `train_state_specs` and the step built with
    `param_specs`: the params drawn part by part on the process's home
    device (each stack group, the embeddings, the norms) in one seeded
    stream, as one device draws them, each placed at once, so a process
    keeps its own parts and never holds the whole state."""
    if mesh is not None:
        cfg = cfg.with_policy(SH.policy_for(mesh))
        device = mesh.home
    dev = resolve_device(device)
    opt = for_config(cfg)
    if mesh is None or mesh.size == 1:
        params = Md.init_params(cfg, seed, device=dev)
        state = {"params": params, "opt": opt.init(params.tree()),
                 "step": torch.zeros((), dtype=torch.int32, device=dev)}
        return cfg, state, Md.make_train_step(cfg, opt), None
    shapes = SH.state_shapes(cfg, opt)
    specs = SH.train_state_specs(cfg, shapes, mesh)
    pspecs = specs["params"]

    def place(name, sub):  # a group of a stack is a one-group stack's
        if name in ("stack", "enc_stack"):
            return SH.named(mesh, pspecs[name], [sub])[0]
        return SH.named(mesh, pspecs[name], sub)

    with torch.no_grad():
        sharded = SH.ShardedLM(cfg, mesh, Md.init_params(cfg, seed, device=dev, place=place))
    meta_opt = opt.init(Md.init_params(cfg, 0, device="meta").tree())
    state = {"params": sharded, "opt": SH.zeros(mesh, specs["opt"], meta_opt),
             "step": torch.zeros((), dtype=torch.int32, device=mesh.home)}
    return cfg, state, Md.make_train_step(cfg, opt, param_specs=specs["params"]), specs


def train(cfg, *, steps: int, batch: int, seq: int, ckpt_dir: str | None = None,
          ckpt_every: int = 50, mesh=None, log=print, seed: int = 0, device=None):
    dev = resolve_device(device)
    world, rank = process_rank()
    if mesh is None:
        cards = torch.cuda.device_count() if dev.type == "cuda" and dev.index is None else 1
        mesh = make_host_mesh(data=max(1, cards) * world, model=1, device=dev)
    if rank:
        log = _quiet
    cfg, state, step, specs = build(cfg, mesh, seed)
    dev = mesh.home
    manager = CheckpointManager(ckpt_dir, every=ckpt_every) if ckpt_dir else None
    s0 = latest_step(ckpt_dir) if manager else None
    if s0 is not None:
        restored = restore(ckpt_dir, s0, like=convert.train_state_to_numpy(state))
        if specs is None:
            state = convert.train_state_from_reference(cfg, restored, device=dev)
        else:
            state = reshard_state(restored, cfg, mesh)
        log(f"resumed from step {s0}")
    monitor = StepMonitor()
    start = int(state["step"])
    stream = itertools.islice(lm_batches(cfg.vocab, batch, seq, device=dev), start, None)
    history = []
    for i, b in zip(range(start, steps), stream):
        with monitor:
            state, metrics = step(state, b)
        loss = float(metrics["loss"])
        history.append(loss)
        if manager and (i + 1) % ckpt_every == 0:
            manager.maybe_save(convert.train_state_to_numpy(state), i + 1)
        if i % 10 == 0 or i == steps - 1:
            log(f"step {i} loss {loss:.4f} ema_s {monitor.ema and round(monitor.ema, 3)}")
    if manager:
        manager.maybe_save(convert.train_state_to_numpy(state), steps, force=True)
        manager.wait()
    return state, history, monitor


def _quiet(*_):
    pass


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    if args.reduced and cfg.accum_steps > 1 and args.batch % cfg.accum_steps:
        cfg = dataclasses.replace(cfg, accum_steps=1)
    t0 = time.time()
    _, history, monitor = train(cfg, steps=args.steps, batch=args.batch,
                                seq=args.seq, ckpt_dir=args.ckpt_dir,
                                ckpt_every=args.ckpt_every, device=args.device)
    print(f"final loss {history[-1]:.4f} (from {history[0]:.4f}) "
          f"in {time.time()-t0:.1f}s; stragglers: {len(monitor.stragglers)}")
    return history


if __name__ == "__main__":
    main()
