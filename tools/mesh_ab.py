"""Phase 13 (b) of chip_smoke.py (gemma-2b's bf16 train step, one process
driving (data 2, model 2) over the card or cards) for another tree and
this one, in the order parent, change, change, parent, one process each;
the first run of this tree also runs phase 14 (the mesh over processes)
and what it needs: phase 10 (a), phase 13 (c) and phase 12 (b)'s granite
step:

    python3 tools/mesh_ab.py PARENT_DIR

PARENT_DIR holds another checkout (`git archive` unpacked). Each run
prints one `AB {json}` line (the tree, the card, phase 12 (b)'s one-device
and phase 13 (b)'s step times, peak MB, launches, idle share and losses);
phase 14 prints its own lines. Every run's whole output goes to
chiprun_out/mesh_ab.log.

    python3 tools/mesh_ab.py --train

runs only this tree's LM half: phase 13 (b) in one process, then phase
14 (c) and (d) over min(4, cards) processes (NCCL), each process's
losses held bit for bit to the one process's and its reduced state's
digests to the same steps in this process; prints one `TRAIN {json}`
line (step ms and peak MB a process). Needs a CUDA device."""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

RUN = r'''
import gc, json, sys, traceback
tag, with_mp = sys.argv[1], sys.argv[2] == "1"
sys.argv = ["chip_smoke.py"]
import torch
import chip_smoke as c
single, _ = c._train_timed("gemma-2b", 4, 1024, 2)
gc.collect(); torch.cuda.empty_cache()
r, holder, _ = c._lm_mesh_train_timed(single)
holder.clear(); gc.collect(); torch.cuda.empty_cache()
print("AB " + json.dumps({"tree": tag, "card": c.card_line(),
      "single_step_ms_all": single["step_ms_all"], "single_step_ms": single["step_ms"],
      "mesh_step_ms_all": r["step_ms_all"], "mesh_step_ms": r["step_ms"],
      "mesh_peak_mb": r["peak_mb"], "mesh_launches": r["cuda_launches_per_step"],
      "mesh_idle": r["idle_share"], "mesh_profiled_ms": r["profiled_step_ms"],
      "losses": r["losses"]}), flush=True)
if with_mp:
    try:
        c.build.load("gp_eval")
        _, _, isl = c._mesh_islands()
        serve = c._lm_mesh_serve()
        granite, _ = c._train_timed("granite-moe-3b-a800m", 8, 512)
        gc.collect(); torch.cuda.empty_cache()
        c.mp_paths(isl, r, serve, granite)
        print("MP_OK", flush=True)
    except Exception:
        traceback.print_exc()
        print("MP_FAILED", flush=True)
'''


def _train_child(rank, world, addr, outdir):
    """One process of `--train`: phase 14 (c)'s timed steps and (d)'s
    reduced state, written to outdir/rank{rank}.json."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as c
    from repro_torch.launch import cluster

    os.environ.update(COORDINATOR_ADDRESS=addr, NUM_PROCESSES=str(world),
                      PROCESS_ID=str(rank))
    cluster.init_cluster()
    out = {"train": c._mp_train(profile=False),
           "digests": c._mp_digests(c._mp_reduced_state())}
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    cluster.close_cluster()


def train_only():
    import multiprocessing
    import socket
    import tempfile

    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as c

    single, _ = c._train_timed("gemma-2b", 4, 1024, 2)
    one, holder, _ = c._lm_mesh_train_timed(single)
    holder.clear()
    torch.cuda.empty_cache()
    world = min(4, torch.cuda.device_count())
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    outdir = tempfile.mkdtemp(dir=ROOT / "chiprun_out")
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        addr = f"localhost:{sk.getsockname()[1]}"
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_train_child, args=(r, world, addr, outdir))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(300)
        if p.is_alive():
            p.terminate()
            p.join()
    if any(p.exitcode for p in procs):
        raise SystemExit(f"exit codes {[p.exitcode for p in procs]}")
    ranks = [json.load(open(os.path.join(outdir, f"rank{r}.json"))) for r in range(world)]
    here = c._mp_digests(c._mp_reduced_state())
    print("TRAIN " + json.dumps({
        "card": c.card_line(), "ranks": world,
        "losses_bitwise": all(r["train"]["losses"] == one["losses"] for r in ranks),
        "digests_bitwise": all(r["digests"] == here for r in ranks),
        "step_ms_all": [r["train"]["step_ms_all"] for r in ranks],
        "peak_mb": [r["train"]["peak_mb"] for r in ranks],
        "one_process_step_ms_all": one["step_ms_all"],
        "one_process_peak_mb": one["peak_mb"]}), flush=True)


def main():
    if sys.argv[1] == "--train":
        return train_only()
    parent = Path(sys.argv[1]).resolve()
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    with open(out / "mesh_ab.log", "w") as log:
        for i, (tag, tree) in enumerate([("parent", parent), ("change", ROOT),
                                         ("change", ROOT), ("parent", parent)]):
            t0 = time.time()
            try:
                p = subprocess.run([sys.executable, "-c", RUN, tag, str(int(i == 1))],
                                   cwd=tree, capture_output=True, text=True,
                                   timeout=240 if i == 1 else 100)
            except subprocess.TimeoutExpired as e:
                log.write(f"=== {tag} timed out\n{e.stdout}\n{e.stderr}\n")
                print(tag, "timed out", flush=True)
                continue
            log.write(f"=== {tag} rc={p.returncode} {time.time() - t0:.1f}s\n"
                      f"{p.stdout}\n{p.stderr[-6000:]}\n")
            log.flush()
            for ln in p.stdout.splitlines():
                if ln.startswith(("AB ", "MP_")) or '"phase": "mp"' in ln:
                    print(ln, flush=True)
            print(tag, "rc", p.returncode, round(time.time() - t0, 1), flush=True)


if __name__ == "__main__":
    main()
