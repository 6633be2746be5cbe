"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from `src/repro_torch/kernels/csrc/`,
holds each against its plain PyTorch version on the card, drives the
port's main path (`GPSession` with its defaults: heap trees of depth 5,
one device, elite cache, K-generation blocks) through the user's entry
points, and checks the results against the same sessions run on the CPU.
Every phase prints one JSON line; any failure raises, so the exit code is
non-zero. The last line is the contract line
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.

Phases:
  1. card: name and power limit (nvidia-smi), torch/CUDA versions, build
  2. kernel vs plain version at the paper's dataset shapes (depth 5,
     kernels r and c; m and mse on lattice data), without a weight and
     with a weight of zeros and fractions plus NaN-producing trees:
     exact on integer-lattice data and hit counts, stated tolerance
     elsewhere; warm median time of kernel and plain version, and the
     bound (the larger of bytes / 3.35 TB/s and f32 ops / 67 TFLOP/s)
  3. main path: kat7 (Table 2, CLASSIFY_SET, kernel c), 30 generations on
     the card; one block under torch.cuda.set_sync_debug_mode("error");
     history bitwise equal to the CPU run; launches counted
  4. ligo: the same over 5 generations
  5. the kepler quickstart (KITCHEN_SINK, pop 200, 30 generations)

`python3 chip_smoke.py --profile` instead profiles three main-path
generations with torch.profiler (where a generation's time goes).
"""
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device is available; nothing was run")

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.core import engine  # noqa: E402
from repro_torch.core import primitives as prim  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core import trees  # noqa: E402
from repro_torch.gp import GPSession  # noqa: E402
from repro_torch.kernels import build, gp_eval, ops  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
DEV = torch.device("cuda")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Warm median of `reps` runs, each timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# --- phase 2: the kernel against its plain version ---------------------------

SHAPES = [("kepler", 200, 1, 9), ("kat7", 100, 9, 10_000),
          ("ligo", 100, 1_373, 4_000), ("large", 1024, 8, 32_768)]


def _population(P, F, fn_set, seed, p_const=0.2):
    spec = trees.TreeSpec(max_depth=5, n_features=F, fn_set=fn_set, p_const=p_const)
    op, arg = trees.generate_population(prng.PRNGKey(seed, DEV), P, spec)
    return spec, op, arg


def _bound_ms(op, F, D, weight):
    """Least time for the work of one call on this card: bytes read once
    (op, arg, X, y, weight, constants) and written once (f32[P]), against
    the f32 operations these trees need (one per function node per point,
    plus three per tree and point for the epilogue). -> (ms, "bytes" |
    "operations")."""
    P, N = op.shape
    nbytes = 2 * P * N * 4 + F * D * 4 + D * 4 + (D * 4 if weight is not None else 0)
    nbytes += 8 * 4 + P * 4
    n_ops = D * (int((op >= 3).sum()) + 3 * P)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _nan_rows(F, weight):
    """Hand-made depth-5 rows (x_f*x_f) - (x_f*x_f), NaN wherever x_f
    overflows: on x0 at point 0, which `weight` zeroes (fitness must stay
    finite), and for F > 1 on x1 at point 1, which it weighs (fitness
    must be +inf). Sets weight[0] = 0 and weight[1] = 1; the caller puts
    the overflowing values into X."""
    rows = []
    for f in range(min(F, 2)):
        op = np.zeros(63, np.int32)
        arg = np.zeros(63, np.int32)
        op[:7] = [prim.opcode_of("sub"), prim.opcode_of("mul"),
                  prim.opcode_of("mul"), 2, 2, 2, 2]
        arg[3:7] = f
        rows.append((op, arg))
    weight[0], weight[min(1, len(weight) - 1)] = 0.0, 1.0
    return (torch.from_numpy(np.stack([r[0] for r in rows])).to(DEV),
            torch.from_numpy(np.stack([r[1] for r in rows])).to(DEV))


def _compare(got, want, kname, lattice, tag):
    """Hold the kernel's moments against the plain version's -> (max abs
    err, max rel err). c/m sums of hits times weights in {0, 1/4, 1/2,
    1} are exact below 2**22 in any order; lattice r/mse sums are sums of
    non-negative exact integers, exact below 2**24 (every partial sum is
    bounded by the total); real-valued r/mse sums are taken in another
    order -> rtol 1e-4."""
    g, w = got[:, 0].cpu().numpy(), want[:, 0].cpu().numpy()
    if not np.array_equal(np.isfinite(g), np.isfinite(w)):
        raise AssertionError(f"{tag}: non-finite rows differ")
    fin = np.isfinite(w)
    err = float(np.abs(g[fin] - w[fin]).max(initial=0.0))
    rel = float((np.abs(g[fin] - w[fin])
                 / np.maximum(np.abs(w[fin]), 1.0)).max(initial=0.0))
    if kname in ("c", "m") or lattice:
        exact = fin & (np.abs(w) < (2 ** 22 if kname in ("c", "m") else 2 ** 24))
        if not np.array_equal(g[exact], w[exact]):
            raise AssertionError(f"{tag}: kernel != plain, max err {err}")
    np.testing.assert_allclose(g[fin], w[fin], rtol=1e-4, atol=1e-3, err_msg=tag)
    return err, rel


def kernel_vs_plain():
    """-> ({(shape, kernel): timings}, {shape: max |kernel - plain|},
    max relative error over every comparison). Every shape runs without
    a weight and with one of zeros and fractions (the padding-mask and
    `sample_weight` path), each with kernels r and c, plus m and mse on
    lattice data."""
    rng = np.random.RandomState(0)
    results, max_err, max_rel = {}, {}, 0.0
    for name, P, F, D in SHAPES:
        for lattice in (True, False):
            for kname in ("r", "c", "m", "mse") if lattice else ("r", "c"):
                if lattice:
                    fn_set = prim.FunctionSet.make(("add", "sub", "mul"))
                    X = rng.randint(-1, 2, size=(F, D)).astype(np.float32)
                    y = rng.randint(0, 3, size=D).astype(np.float32)
                else:
                    fn_set = prim.KITCHEN_SINK if kname == "r" else prim.CLASSIFY_SET
                    X = rng.randn(F, D).astype(np.float32)
                    y = (rng.rand(D) > 0.5).astype(np.float32)
                spec, op, arg = _population(P, F, fn_set, seed=P + F + D,
                                            p_const=0.0 if lattice else 0.2)
                Xd, yd = torch.from_numpy(X).to(DEV), torch.from_numpy(y).to(DEV)
                consts = spec.const_table(DEV)
                _, tile = ops.pick_tiles(F, spec.num_nodes, P, D)
                kw = dict(max_depth=5, kernel=kname, n_classes=2, data_tile=tile,
                          fn_codes=tuple(int(c) for c in fn_set.opcodes))
                got = gp_eval.eval_fitness(op, arg, Xd, yd, None, consts, **kw)
                want = gp_eval.eval_fitness_plain(op, arg, Xd, yd, None, consts, **kw)
                err, rel = _compare(got, want, kname, lattice,
                                    f"{name} {kname} lattice={lattice}")

                wt = rng.choice(np.float32([0.0, 0.25, 0.5, 1.0]), size=D)
                nop, narg = _nan_rows(F, wt)
                Xw = X.copy()
                Xw[0, 0] = 1e30
                if F > 1:
                    Xw[1, min(1, D - 1)] = 1e30
                opw, argw = torch.cat([op, nop]), torch.cat([arg, narg])
                Xwd, wd = torch.from_numpy(Xw).to(DEV), torch.from_numpy(wt).to(DEV)
                got_w = gp_eval.eval_fitness(opw, argw, Xwd, yd, wd, consts, **kw)
                want_w = gp_eval.eval_fitness_plain(opw, argw, Xwd, yd, wd, consts, **kw)
                err_w, rel_w = _compare(got_w, want_w, kname, lattice,
                                        f"{name} {kname} lattice={lattice} weighted")
                nan_fit = got_w[P:, 0].cpu().numpy()
                if not (np.isfinite(nan_fit[0]) and np.isinf(nan_fit[1:]).all()):
                    raise AssertionError(f"{name} {kname}: NaN at a zero-weight point "
                                         f"must be masked, at a weighted one +inf: "
                                         f"{nan_fit}")
                max_err[name] = max(max_err.get(name, 0.0), err, err_w)
                max_rel = max(max_rel, rel, rel_w)
                if lattice:
                    continue
                reps = 20 if P * D < 1e7 else 5
                ms = time_ms(lambda: gp_eval.eval_fitness(op, arg, Xd, yd, None,
                                                          consts, **kw), 50)
                plain_ms = time_ms(lambda: gp_eval.eval_fitness_plain(
                    op, arg, Xd, yd, None, consts, **kw), reps)
                bound, bound_by = _bound_ms(op, F, D, None)
                results[(name, kname)] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                                              bound_by=bound_by)
                emit("kernel", shape=name, P=P, F=F, D=D, kernel=kname, tile=tile,
                     fn_set=fn_set.name, max_abs_err=err, max_rel_err=rel, ms=ms,
                     plain_ms=plain_ms,
                     bound_ms=bound, bound_by=bound_by,
                     fn_nodes=int((op >= 3).sum()))
    return results, max_err, max_rel


# --- phases 3-5: the main path --------------------------------------------------


def _history_vs_cpu(dataset, gens, pop, gpu_history):
    """The same session on the CPU: its history must equal the card's
    bit for bit (the c kernel's hit counts are exact integers, and every
    draw comes from the same threefry key)."""
    cpu = GPSession.from_dataset(dataset, pop_size=pop, generations=gens, device="cpu")
    cpu.init(key=prng.PRNGKey(0))
    cpu.evolve(gens)
    a = np.asarray(gpu_history[:gens], np.float32)
    b = np.asarray(cpu.history, np.float32)
    if not np.array_equal(a, b):
        first = int(np.nonzero(a != b)[0][0])
        raise AssertionError(f"{dataset}: card and CPU histories part at "
                             f"generation {first}: {a[first]} vs {b[first]}")
    return b


def run_dataset(dataset, pop, gens, cpu_gens, block_check):
    sess = GPSession.from_dataset(dataset, pop_size=pop, generations=gens)
    assert sess.backend == "cuda", sess.backend
    sess.init(key=prng.PRNGKey(0))
    torch.cuda.synchronize()
    gp_eval.reset_launches()
    t0 = time.perf_counter()
    sess.evolve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = gp_eval.launches
    if launches <= 0:
        raise AssertionError(f"{dataset}: the CUDA kernel was never launched")
    hist = np.asarray(sess.history, np.float32)
    if not (np.isfinite(hist).all() and (np.diff(hist) <= 0).all()):
        raise AssertionError(f"{dataset}: best fitness not finite/non-increasing")
    _history_vs_cpu(dataset, cpu_gens, pop, sess.history)
    out = dict(dataset=dataset, pop=pop, generations=gens, rows=sess.n_rows,
               launches=launches, host_syncs=sess.stats["host_syncs"],
               wall_s=wall, gens_per_s=gens / wall,
               tree_rows_per_s=sess.stats["tree_row_evals"] / wall,
               best_fitness=float(hist[-1]), cpu_bitwise_generations=cpu_gens,
               best=sess.best_expression())
    if block_check:
        syncs = sess.stats["host_syncs"]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            sess.evolve_block(5)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        assert sess.stats["host_syncs"] == syncs
        out["sync_debug_block"] = "no synchronisation in a 5-generation block"
    return out


def profile_main_path():
    """`--profile`: where a main-path generation spends its time. Times
    3 warm kat7 generations with torch.profiler (CPU + CUDA activities)
    and prints the device busy time, the CUDA launches, the fused eval
    kernel's device time and the busiest device ops."""
    from torch.profiler import ProfilerActivity, profile

    sess = GPSession.from_dataset("kat7", pop_size=100, generations=3)
    sess.init(key=prng.PRNGKey(0))
    sess.evolve(2)  # warm: kernel library loaded, device tables made
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sess.evolve(3)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0.0)

    kernels = [e for e in events if dev_us(e) > 0]
    launches = sum(e.count for e in events if "LaunchKernel" in e.key)
    fused = sum(dev_us(e) for e in kernels
                if "eval_partial_kernel" in e.key or "merge_tiles" in e.key)
    busy = sum(dev_us(e) for e in kernels)
    top = sorted(events, key=lambda e: e.count, reverse=True)[:12]
    emit("profile", dataset="kat7", generations=3, wall_ms_per_gen=1e3 * wall / 3,
         device_busy_ms_per_gen=busy / 3e3, idle_share=1 - busy / (1e6 * wall),
         cuda_launches_per_gen=launches / 3, fused_eval_ms_per_gen=fused / 3e3,
         top_ops_by_count=[(e.key, e.count // 3, dev_us(e) / 3e3) for e in top])


def main():
    if "--profile" in sys.argv[1:]:
        print(card_line(), flush=True)
        build.load("gp_eval")
        profile_main_path()
        return
    card = card_line()
    t0 = time.perf_counter()
    build.load("gp_eval")
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in build.BUILD_INFO["gp_eval"]["ptxas"].splitlines()
             if "registers" in ln or "Compiling" in ln]
    emit("card", nvidia_smi=card, torch=torch.__version__, cuda=torch.version.cuda,
         name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         build_s=build_s, ptxas=ptxas)

    perf, max_err, max_rel = kernel_vs_plain()

    gp_eval.reset_launches()
    main_run = run_dataset("kat7", 100, 30, 10, block_check=True)
    main_launches = main_run["launches"]
    emit("main_path", **main_run)

    emit("ligo", **run_dataset("ligo", 100, 5, 5, block_check=False))

    q = GPSession.from_dataset("kepler", name="kepler-quickstart", pop_size=200,
                               generations=30)
    q.init(key=prng.PRNGKey(0))
    q.evolve()
    resid = q.best_fitness
    if not math.isfinite(resid):
        raise AssertionError("kepler quickstart: non-finite residual")
    # a session given a config picks the card's backend as the default one does
    configured = GPSession.from_dataset("kepler", config=engine.GPConfig(
        pop_size=8, tree_spec=trees.TreeSpec(n_features=1)))
    if configured.backend != "cuda" or q.backend != "cuda":
        raise AssertionError(f"sessions on the card resolved to {q.backend!r} and "
                             f"{configured.backend!r}, not 'cuda'")
    emit("quickstart", best=q.best_expression(), residual=resid, backend=q.backend)

    main = perf[("kat7", "c")]
    print(json.dumps({"kernels": [{
        "name": "eval_fitness", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gp_eval.cu",
        "replaces": "src/repro/kernels/gp_eval.py:423",
        "launches": main_launches, "max_abs_err": max_err["kat7"],
        "max_rel_err": max_rel,
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": None}]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
