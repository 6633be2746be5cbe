"""Every production dry-run cell (`repro_torch.launch.dryrun`): each arch
x shape on (data 16, model 16) and (pod 2, data 16, model 16), and the
GP pod cells on both, one process a cell, JOBS at a time, on the CPU:

    python3 tools/dryrun_sweep.py OUT [--jobs 4] [--table]

A cell whose record is in OUT already is not run again; the cheap shapes
run first (long_500k, decode_32k, the GP cells, train_4k, prefill_32k).
Each cell's output goes to OUT/log_{cell}.txt. Then, or with --table
alone, it prints the markdown table of OUT's records: a row a cell,
each mesh's argument + temp GB a card (marked where it passes the
H100's 80 GB), GB received a step with each collective kind's result
GB, the FLOPs and trace_s; then the cells above 80 GB, those not run and
those skipped."""
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import all_arch_names  # noqa: E402
from repro_torch.launch.dryrun import GP_CELLS  # noqa: E402

CARD_GB = 80  # an H100's memory
ORDER = ("long_500k", "decode_32k", "gp", "train_4k", "prefill_32k")


def cells() -> list:
    """(stem, argv) of every cell, in ORDER."""
    out = []
    for shape in ORDER:
        for tag, flag in (("sp", []), ("mp", ["--multi-pod"])):
            if shape == "gp":
                out += [(f"{g}_{tag}", ["--gp", g, *flag]) for g in GP_CELLS]
            else:
                out += [(f"{a}_{shape}_{tag}", ["--arch", a, "--shape", shape, *flag])
                        for a in all_arch_names()]
    return out


def run(out: Path, jobs: int) -> None:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    todo = [(stem, argv) for stem, argv in cells() if not (out / f"{stem}.json").exists()]

    def one(cell):
        stem, argv = cell
        t0 = time.time()
        with open(out / f"log_{stem}.txt", "w") as log:
            p = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", *argv,
                                "--out", str(out)], stdout=log, stderr=subprocess.STDOUT,
                               env=env, cwd=ROOT)
        print(f"{stem} rc={p.returncode} wall_s={time.time() - t0:.1f}", flush=True)

    with ThreadPoolExecutor(jobs) as ex:
        list(ex.map(one, todo))


def _gb(x) -> str:
    return f"{x:.3f}" if x < 10 else f"{x:.1f}"


def _mesh_cols(rec) -> tuple:
    """(arg + temp, received GB by kind, trace_s) of one mesh's record."""
    if rec is None:
        return "not run", "", ""
    if rec["status"] != "ok":
        return rec["status"], "", ""
    mem = rec["memory"]
    total = mem["argument_gb"] + mem["temp_gb"]
    kinds = ", ".join(f"{k.split('-')[-1]} {_gb(v / 2**30)}"
                      for k, v in rec["collective_bytes"].items())
    fits = "" if total <= CARD_GB else " **over**"
    return (f"{_gb(mem['argument_gb'])} + {_gb(mem['temp_gb'])} = {_gb(total)}{fits}",
            f"{_gb(rec['received_bytes'] / 2**30)} ({kinds or 'none'})",
            f"{rec['trace_s']:.0f}")


def table(out: Path) -> str:
    """A row a cell: per mesh (sp, mp) argument + temp GB a card (over 80
    marked), GB received a step (the kinds' RESULT GB: gather, all,
    reduce), trace_s; the single-pod TFLOP."""
    recs = {p.stem: json.loads(p.read_text()) for p in out.glob("*.json")}
    lines = ["| cell | sp: arg + temp GB | sp: received GB (result GB by kind) | mp: arg + "
             "temp GB | mp: received GB | TFLOP (sp) | trace_s sp / mp |",
             "|---|---|---|---|---|---|---|"]
    over, missing, skipped = [], [], []
    for stem, _ in cells():
        name, tag = stem.rsplit("_", 1)
        rec = recs.get(stem)
        if rec is None:
            missing.append(stem)
        elif rec["status"] == "ok" and (rec["memory"]["argument_gb"]
                                        + rec["memory"]["temp_gb"]) > CARD_GB:
            over.append(stem)
        if tag == "mp":
            continue
        sp, mp = rec, recs.get(f"{name}_mp")
        if sp is not None and sp["status"].startswith("skip"):
            skipped.append(name)
            continue
        a, b, c = _mesh_cols(sp)
        d, e, f = _mesh_cols(mp)
        flops = f"{sp['flops'] / 1e12:.4g}" if sp and sp["status"] == "ok" else ""
        lines.append(f"| {name} | {a} | {b} | {d} | {e} | {flops} | {c} / {f} |")
    lines.append("")
    lines.append(f"above {CARD_GB} GB: {', '.join(over) or 'none'}")
    lines.append(f"not run: {', '.join(missing) or 'none'}")
    lines.append(f"skipped, full attention (as the reference): {', '.join(skipped) or 'none'}")
    return "\n".join(lines)


def main():
    out = Path(sys.argv[1])
    out.mkdir(parents=True, exist_ok=True)
    if "--table" not in sys.argv:
        jobs = int(sys.argv[sys.argv.index("--jobs") + 1]) if "--jobs" in sys.argv else 4
        run(out, jobs)
    print(table(out))


if __name__ == "__main__":
    main()
