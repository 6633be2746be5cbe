"""GP service driver — a multi-tenant job stream through
`repro_torch.service` (port of `repro/launch/serve_gp.py`), on the card
unless `--device cpu` is given.

Feeds a batch of heterogeneous GP jobs (from a JSON job file, or a
synthetic stream) into one `GPService` and drains the queue, printing
each job's published result:

    # 12 synthetic ragged jobs packed into 4 slots
    PYTHONPATH=src python -m repro_torch.launch.serve_gp --jobs 12 --slots 4

    # jobs from a file, with checkpoint/restart armed, on the CPU
    PYTHONPATH=src python -m repro_torch.launch.serve_gp --device cpu \
        --job-file jobs.json --slots 8 --ckpt-dir /tmp/gp-svc

A job file is a JSON list; each entry names a dataset from
repro_torch.data.datasets plus any JobSpec overrides:

    [{"dataset": "kepler", "generations": 30, "seed": 0},
     {"dataset": "iris", "kernel": "c", "n_classes": 3, "rows": 60}]
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.data.datasets import BY_NAME
from repro_torch.service import GPService, JobSpec


def synthetic_stream(n_jobs: int, *, seed: int = 0, max_rows: int = 96,
                     n_features: int = 3) -> list[JobSpec]:
    """A ragged, heterogeneous job stream: varied row counts, kernels,
    operator mixes, budgets and stop bars — the tens-to-hundreds-of-rows
    regime the service exists for."""
    from repro_torch.core.evolve import OperatorMix

    r = np.random.RandomState(seed)
    kernels = ("r", "mse", "pearson")
    mixes = (OperatorMix(), OperatorMix(0.05, 0.05, 0.05, 0.85),
             OperatorMix(0.10, 0.30, 0.30, 0.30))
    jobs = []
    for i in range(n_jobs):
        rows = int(r.randint(max_rows // 4, max_rows + 1))
        X = r.randn(rows, n_features).astype(np.float32)
        y = (X[:, 0] * X[:, 1] + np.sin(X[:, 0])).astype(np.float32)
        jobs.append(JobSpec(
            X, y, kernel=kernels[i % len(kernels)], mix=mixes[i % len(mixes)],
            generations=int(r.randint(10, 40)),
            stop_fitness=1e-5 if i % 4 == 0 else None,
            seed=i, name=f"synthetic-{i}"))
    return jobs


def load_job_file(path: str, *, data_cap: int) -> list[JobSpec]:
    """JSON job list → JobSpecs; each entry names a dataset (optionally
    truncated via "rows") plus JobSpec overrides."""
    with open(path) as f:
        entries = json.load(f)
    jobs = []
    for i, e in enumerate(entries):
        e = dict(e)
        name = e.pop("dataset")
        X_rows, y, meta = BY_NAME[name]()
        rows = int(e.pop("rows", min(len(y), data_cap)))
        X_rows, y = X_rows[:rows], y[:rows]
        e.setdefault("kernel", meta["kernel"])
        if "n_classes" in meta:
            e.setdefault("n_classes", meta["n_classes"])
        e.setdefault("name", f"{name}-{i}")
        jobs.append(JobSpec(X_rows, y, **e))
    return jobs


def serve(jobs: list[JobSpec], *, slots: int = 4, pop: int = 64,
          depth: int = 5, data_cap: int = 128, block_size: int = 8,
          strategy: str = "fifo", ckpt_dir: str | None = None,
          ckpt_every: int = 1, log=print, trace: str | None = None,
          metrics: str | None = None, device=None):
    """Submit every job, drain the queue, report. Returns (service,
    handles in submit order). `trace`/`metrics` are output paths arming
    the repro_torch.obs Tracer (Chrome trace JSON with per-job lifetime
    lanes) and Metrics JSONL sink — see docs/observability.md. `device`
    (default: the card) places the service."""
    from repro_torch.obs import Metrics, Tracer

    tracer = Tracer(trace) if trace else None
    mreg = Metrics(metrics) if metrics else None
    n_features = max(j.n_features for j in jobs)
    data_cap = max(data_cap, max(j.n_rows for j in jobs))
    svc = GPService(slots=slots, pop_size=pop, max_depth=depth,
                    n_features=n_features, data_cap=data_cap,
                    block_size=block_size, strategy=strategy,
                    checkpoint_dir=ckpt_dir, checkpoint_every=ckpt_every,
                    tracer=tracer, metrics=mreg, device=device)
    handles = [svc.submit(j) for j in jobs]
    t0 = time.time()
    svc.run()
    wall = time.time() - t0
    for h in handles:
        log(f"  [{h.status:9s}] {h.spec.name:16s} kernel={h.spec.kernel:8s} "
            f"gens={h.gens_done:3d}/{h.spec.generations:3d} "
            f"best={h.best_fitness:12.5f}  {h.best_expression}")
    s = svc.stats
    log(f"{len(jobs)} jobs / {slots} slots: {s['blocks']} blocks in "
        f"{wall:.2f}s — {s['admissions']} admissions, {s['evictions']} "
        f"evictions, {s['restarts']} restarts, {s['compiles']} compiled "
        f"program(s)")
    if s["cache_queries"]:
        log(f"  elite cache: {s['cache_hits']}/{s['cache_queries']} hits "
            f"({s['cache_hit_rate']:.2f})")
    if tracer is not None:
        log(f"  trace written to {tracer.save()}")
    if mreg is not None:
        mreg.close()
        log(f"  metrics written to {metrics} "
            f"(summarize: python -m repro_torch.obs.report {metrics})")
    return svc, handles


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve_gp")
    ap.add_argument("--job-file", default=None,
                    help="JSON job list (see module docstring); default is "
                         "a synthetic stream")
    ap.add_argument("--jobs", type=int, default=8,
                    help="synthetic-stream job count (ignored with --job-file)")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--pop", type=int, default=64)
    ap.add_argument("--depth", type=int, default=5)
    ap.add_argument("--data-cap", type=int, default=128,
                    help="per-slot row capacity (auto-raised to the largest job)")
    ap.add_argument("--block-size", type=int, default=8,
                    help="generations per dispatch = admission/eviction quantum")
    ap.add_argument("--strategy", default="fifo", choices=["fifo", "lpt"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=1,
                    help="blocks between committed service checkpoints")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs on the CPU)")
    ap.add_argument("--trace", default=None,
                    help="write a Chrome trace JSON (admit/dispatch spans + "
                         "per-job lifetime lanes; open in Perfetto) here")
    ap.add_argument("--metrics", default=None,
                    help="append metrics JSONL here (summarize with "
                         "python -m repro_torch.obs.report)")
    args = ap.parse_args(argv)
    jobs = (load_job_file(args.job_file, data_cap=args.data_cap)
            if args.job_file
            else synthetic_stream(args.jobs, seed=args.seed))
    serve(jobs, slots=args.slots, pop=args.pop, depth=args.depth,
          data_cap=args.data_cap, block_size=args.block_size,
          strategy=args.strategy, ckpt_dir=args.ckpt_dir,
          ckpt_every=args.ckpt_every, trace=args.trace,
          metrics=args.metrics, device=args.device)


if __name__ == "__main__":
    main()
