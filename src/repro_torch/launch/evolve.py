"""GP evolution from the command line — the paper's workload, end to end, on the port.

Port of `repro/launch/evolve.py`: Karoo GP's scriptable runs with
per-generation archiving, through `repro_torch.gp.GPSession`, on the card
unless `--device cpu` is given:

    PYTHONPATH=src python -m repro_torch.launch.evolve --dataset kat7 \\
        --generations 30 --pop 200 --islands 4 --migrate-every 3 \\
        --ckpt-dir /tmp/ck --trace /tmp/t.json --metrics /tmp/m.jsonl

A rerun with the same `--ckpt-dir` resumes from the newest checkpoint
and prints "resumed from generation N". `--chunk-rows N` streams the
dataset through the device in fixed chunks of N rows (one host step a
generation), and `--backend
scalar` runs the paper's per-data-point baseline (1-CPU_SP):

    PYTHONPATH=src python -m repro_torch.launch.evolve --dataset kat7 \\
        --chunk-rows 4096 --generations 10
    PYTHONPATH=src python -m repro_torch.launch.evolve --dataset kepler \\
        --backend scalar --pop 50 --generations 5 --device cpu

`--mesh data=2,model=2[,pod=2]` shards the run over a device mesh in
this one process (`GPSession(topology=MeshTopology(...))`; on one card
every shard shares it):

    PYTHONPATH=src python -m repro_torch.launch.evolve --dataset kat7 \\
        --islands 4 --pop 200 --mesh data=2,model=2,pod=2 --generations 3
"""
from __future__ import annotations

import argparse
import json
import os
import time

from repro_torch.core import prng
from repro_torch.data.datasets import BY_NAME
from repro_torch.gp import GPSession, MeshTopology


def parse_mesh(spec: str | None) -> MeshTopology | None:
    """'data=2,model=2[,pod=2]' -> MeshTopology."""
    if not spec:
        return None
    kw = {}
    for part in spec.split(","):
        k, _, v = part.partition("=")
        kw[k.strip()] = int(v)
    return MeshTopology(**kw)


def run_dataset(name: str, *, generations: int = 30, pop: int = 100,
                depth: int = 5, backend: str = "auto", device=None,
                fn_set: str = "auto", archive: str | None = None, seed: int = 0,
                log=print, ckpt_dir: str | None = None, ckpt_every: int = 10,
                seeds=None, archive_every: int = 1, islands: int = 1,
                migrate_every: int = 10, migrate_k: int = 4,
                island_topology: str = "ring", mesh: str | None = None,
                chunk_rows: int | None = None, trace: str | None = None,
                metrics: str | None = None, profile_dir: str | None = None,
                profile_block: int | None = None):
    """One archived GP run on a named dataset through the GPSession door.

    `archive_every` is the callback (= evolution-block) period: the run
    stays on the device for that many generations per block, and the
    archive gets one record per block boundary (the per-generation
    best-fitness curve still lands in full via `sess.history`).
    `islands > 1` runs the island model, `pop` trees per island. `trace`
    / `metrics` are output paths arming the obs Tracer (Chrome trace
    JSON) and Metrics JSONL sink; `profile_dir`/`profile_block` arm a
    torch.profiler window around one evolution block. `mesh` (a
    `parse_mesh` string or a MeshTopology) shards the run. Returns
    (state, wall seconds, per-generation best-fitness history)."""
    from repro_torch.obs import Metrics, Tracer

    tracer = (Tracer(trace, profile_dir=profile_dir, profile_block=profile_block)
              if (trace or profile_dir) else None)
    mreg = Metrics(metrics) if metrics else None
    kw = dict(pop_size=pop, max_depth=depth, n_consts=8, generations=generations,
              backend=backend, device=device, checkpoint_dir=ckpt_dir,
              checkpoint_every=ckpt_every, islands=islands, migrate_every=migrate_every,
              migrate_k=migrate_k, island_topology=island_topology,
              chunk_rows=chunk_rows, tracer=tracer, metrics=mreg,
              topology=parse_mesh(mesh) if isinstance(mesh, str) else mesh)
    if fn_set != "auto":
        kw["fn_set"] = fn_set
    history = []

    def archive_gen(_, state):
        g = int(state.generation) - 1  # absolute index, stable across resumes
        best = float(state.best_fitness.min())  # min across islands
        history.extend(sess.history[len(history):])
        if archive:
            os.makedirs(archive, exist_ok=True)
            rec = {"generation": g, "best_fitness": best,
                   "best_tree": sess.best_expression(),
                   "population_fitness": state.fitness.cpu().numpy().tolist()}
            with open(os.path.join(archive, f"gen_{g:04d}.json"), "w") as f:
                json.dump(rec, f)
        if g % 5 < archive_every or g == generations - 1:
            log(f"gen {g:3d} best_fitness {best:.5f}")

    sess = GPSession.from_dataset(name, callback=archive_gen,
                                  callback_every=archive_every, **kw)
    sess.init(key=prng.PRNGKey(seed), seeds=seeds)
    if sess.generation:
        log(f"resumed from generation {sess.generation}")
    t0 = time.time()
    sess.evolve(max(0, generations - sess.generation))
    wall = time.time() - t0
    history.extend(sess.history[len(history):])
    tree = sess.best_expression()
    log(f"[{name}] {generations} generations in {wall:.2f}s — best: {tree} "
        f"({sess.stats['blocks']} blocks, {sess.stats['host_syncs']} host syncs)")
    if sess.stats["cache_queries"]:
        log(f"  elite cache: {sess.stats['cache_hits']}/"
            f"{sess.stats['cache_queries']} hits "
            f"({sess.stats['cache_hit_rate']:.2f})")
    if tracer is not None and trace:
        log(f"  trace written to {tracer.save()}")
    if mreg is not None:
        mreg.close()
        log(f"  metrics written to {metrics} "
            f"(summarize: python -m repro_torch.obs.report {metrics})")
    return sess.state, wall, history


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.evolve")
    ap.add_argument("--dataset", default="kepler", choices=sorted(BY_NAME))
    ap.add_argument("--generations", type=int, default=30)
    ap.add_argument("--pop", type=int, default=100)
    ap.add_argument("--depth", type=int, default=5)
    ap.add_argument("--backend", "--impl", dest="backend", default="auto",
                    choices=["auto", "cuda", "torch", "scalar"],
                    help="eval backend: cuda (the kernels), torch (plain tensor "
                         "ops), scalar (the paper's per-data-point baseline) "
                         "or auto (cuda on the card, torch on the CPU)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs on the CPU)")
    ap.add_argument("--mesh", default=None,
                    help="mesh topology, e.g. data=2,model=2,pod=2 (one process; "
                         "the shards take the cards in turn)")
    ap.add_argument("--archive", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10,
                    help="generations between checkpoints")
    ap.add_argument("--seed-exprs", nargs="*", default=None,
                    help="seed population expressions, e.g. '(x0 * x1)'")
    ap.add_argument("--archive-every", type=int, default=1,
                    help="generations per evolution block / archive record "
                         "(larger = fewer host syncs)")
    ap.add_argument("--islands", type=int, default=1,
                    help="island-model layout: islands of --pop trees each")
    ap.add_argument("--migrate-every", type=int, default=10,
                    help="generations between island migration events")
    ap.add_argument("--migrate-k", type=int, default=4,
                    help="elites exchanged per migration event")
    ap.add_argument("--island-topology", default="ring",
                    choices=["ring", "torus", "broadcast-best"],
                    help="migration routing between islands")
    ap.add_argument("--chunk-rows", type=int, default=None,
                    help="streaming chunked fitness: evaluate the dataset as "
                         "a fold over fixed-size chunks of this many rows "
                         "(bounded device memory)")
    ap.add_argument("--trace", default=None,
                    help="write a Chrome trace JSON (open in Perfetto / "
                         "chrome://tracing) of the run's spans here")
    ap.add_argument("--metrics", default=None,
                    help="append metrics JSONL here (summarize with "
                         "python -m repro_torch.obs.report)")
    ap.add_argument("--profile-dir", default=None,
                    help="arm a torch.profiler window (kernel timing) writing "
                         "its Chrome trace to this directory")
    ap.add_argument("--profile-block", type=int, default=None,
                    help="which evolution block the profiler window wraps "
                         "(default 0)")
    args = ap.parse_args(argv)
    run_dataset(args.dataset, generations=args.generations, pop=args.pop,
                depth=args.depth, backend=args.backend, device=args.device,
                archive=args.archive, seed=args.seed, ckpt_dir=args.ckpt_dir,
                ckpt_every=args.ckpt_every, seeds=args.seed_exprs,
                archive_every=args.archive_every, islands=args.islands,
                migrate_every=args.migrate_every, migrate_k=args.migrate_k,
                island_topology=args.island_topology, mesh=args.mesh,
                chunk_rows=args.chunk_rows, trace=args.trace, metrics=args.metrics,
                profile_dir=args.profile_dir, profile_block=args.profile_block)


if __name__ == "__main__":
    main()
