"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from `src/repro_torch/kernels/csrc/`,
holds each against its plain PyTorch version on the card, drives the
port's paths (`GPSession` with its defaults: heap trees of depth 5, one
device, elite cache, K-generation blocks; then postfix genomes with and
without subexpression dedup; then the two-pass fitness kernels pearson
and r2 on those paths; the island model; streaming at the paper's 5.5M
rows and the scalar baseline) through the user's entry points, and checks the
results against the same sessions run on the CPU. Every phase prints
one JSON line; any failure raises, so the exit code is non-zero. The
last line is the contract line
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.

Phases:
  1. card: name and power limit (nvidia-smi), torch/CUDA versions, build
     and ptxas -v (registers, shared memory, spills of every kernel)
  2. every kernel vs its plain version at the paper's dataset shapes
     (depth 5, kernels r and c; m and mse on lattice data), without a
     weight and with a weight of zeros and fractions plus NaN-producing
     trees: B1 on the heap population; B2, the unique table, B3 and B4
     on its postfix form and dedup plan, and the semantic tier's probe
     predictions on its first 32 points and on all D. Exact on integer-lattice data
     and hit counts (and the unique table and probe predictions on
     lattice and CLASSIFY_SET trees), rtol 1e-4 elsewhere. On the card
     B1 == B2 == B3 == B4 bitwise (heap vs postfix, dedup on vs off),
     KITCHEN_SINK included.
     Each kernel's warm median time per call (CUDA events: `ms`), its
     device time per call (torch.profiler, a window that recorded no
     kernel taken again up to 3 times: `device_ms`) and CUDA launches
     per call (every kernel must make one, of its own kernel; no
     `merge_tiles_kernel` is left), the plain version's time, the bound
     (the larger of bytes / 3.35 TB/s and f32 ops / 67 TFLOP/s), and for
     B4 with kernel r the library yardstick `torch.cdist(preds, y[None],
     p=1)` (`library_ms`). Then the unique table under each of its
     schedules (staged at the default and at the narrowest tile, and the
     scan), bitwise against its plain version, and an ungated call on a
     plan that overflows its cap, which must run without a fault; B1-B4
     with 1, 2 and 4 points a thread (data tiles of 256, 512 and 1024
     points), with and without a weight, B1 == B2 == B3 == B4 bitwise
     and B1 against its plain version on lattice data; and B1-B4 on
     P = 70,000 trees at the kepler shape (two launches each: at most
     65,535 trees a launch), each against its plain version and
     B1 == B2 == B3 == B4 bitwise
  2b. the two-pass kernels pearson and r2 on B1-B4 at the four shapes
     (KITCHEN_SINK trees, real-valued data), without a weight and with one
     plus the NaN rows: each against its plain version (moments rtol 1e-4
     with atol 1e-4 x the column's largest value, the non-finite count
     exactly; fitness within 1e-4, +inf at the same trees), B1 == B2 ==
     B3 == B4 bitwise, one launch per call of the kernel's own name; at
     kat7 and large each kernel's device time under r, pearson and r2 on
     the same inputs, beside the bound; and P = 70,000 trees under pearson
     (two launches each)
  3. main path: kat7 (Table 2, CLASSIFY_SET, kernel c), 30 generations on
     the card; one block under torch.cuda.set_sync_debug_mode("error");
     history bitwise equal to the CPU run; launches counted
  4. ligo: the same over 5 generations
  5. the kepler quickstart (KITCHEN_SINK, pop 200, 30 generations)
  6. postfix kat7 at full width, 30 generations each: dedup="exact" with
     the default cap (100: the table overflows and B2 does the work), with
     dedup="off" (B2), dedup_cap=1400 (B3) and dedup_cap=6301 (B4), then
     dedup="semantic" (cap 100, and the probe kernel); per-kernel
     launches and the dedup counters of each run, each generation's
     counter row showing the branch it took (the table overflowed in
     every generation of the cap-100 runs and in none of the others),
     its first 10 generations bitwise equal to the CPU's, the exact/off
     histories equal to each other, no synchronisation in a block
  6b. kat7 at full width under pearson, 30 generations each: the heap path
     (B1), postfix with dedup off (B2) and exact at caps 1,400 (B3) and
     6,301 (B4), the exact histories equal to the off one bit for bit;
     and under r2 on the heap path. Each history finite and
     non-increasing. The dyadic lattice sessions of the CPU tests, card
     against CPU bit for bit, and kat7's first generation card against
     CPU within 1e-4 (the CPU takes the whole dataset in one pass)
  7. islands at full width: kat7, 4 islands x 200 trees (the flattened
     800-tree population, one kernel call a generation), ring migration
     every 3 generations of 2 elites, the four operator mixes and
     tournament sizes 4, 7, 10, 13 of the reference's island bench: 20
     generations on the card with `eval_fitness` launched exactly once a
     generation and no other port kernel, one block under
     torch.cuda.set_sync_debug_mode("error"), the first 3 generations'
     history and per-island history bitwise equal to the CPU's; torus
     and broadcast-best, 5 generations each; postfix islands with dedup
     exact at cap I·P·N + 1 = 50,401 (the table and B4, with B2 gated)
     equal to dedup off (B2) bit for bit; a checkpoint resume (10
     generations, then a new session +10) equal to the uninterrupted 20,
     with a Tracer whose JSON must validate and hold ingest, init, block
     and checkpoint spans; and `python -m repro_torch.launch.evolve
     --islands 4 --pop 200` as a subprocess twice on one checkpoint
     directory, the second printing "resumed from generation 3"
  8. streaming and the scalar baseline: the paper's 5.5M x 8 stream
     (`stream_rows`, seed 0) in 21 chunks of 262,144 rows (the last
     ragged: 257,120 real rows) through `GPSession` on the card under
     mse, m and pearson (init, one step, evolve(3)): B1 exactly once a
     chunk a generation and no other kernel, the streamed evolve(3)'s
     peak memory below the 220 MB the monolithic dataset takes,
     generation 0 against B1's plain version folded over the same chunks
     on the card and against the same rows ingested whole (bitwise under
     m, rtol 1e-4 with the same non-finite pattern under mse and
     pearson); where a streamed generation's time goes (the host's chunk
     preparation, the copies, one profiled generation retaken until its
     trace holds every launch: B1's device time a chunk, the idle
     share); kat7 in chunks of 4,096 rows under c
     (heap 10 generations, postfix 5 with B2, 4 x 200 islands 3), each
     bitwise with the CPU's streamed run and the heap run with phase 3's
     monolithic history; the scalar baseline (kepler, pop 50, 5
     generations) on the card bitwise its CPU run, within rtol 1e-5 of
     the cuda backend at generation 0, and chunked against unchunked
     (within rtol 1e-5 on kepler under mse, bitwise on an integer
     lattice); one JSON line of the phase's figures

Options:
  --parent DIR  also runs phase 2 of another tree of the repo (e.g. the
                parent commit, `git archive` unpacked into a directory
                that .gitignore lists) before and after this tree's, in
                a child process, and prints "ab" lines: every kernel's
                (B1-B4, the table, the probe) ms, device_ms and CUDA
                launches per call in both trees at every shape, beside
                the bound
  --profile     instead profiles three kat7 generations of the heap main
                path and of four postfix paths with torch.profiler, then of
                the heap and cap-6,301 paths under pearson, then of the
                4 x 200 island path (where a generation's time goes; the
                port's kernels by name); the island path must make at most
                1.25x the heap path's CUDA launches a generation
"""
import dataclasses
import json
import math
import os
import shutil
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
from repro_torch.core import eval as eval_mod  # noqa: E402
from repro_torch.core import fitness as fit  # noqa: E402
from repro_torch.core import primitives as prim  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core import trees  # noqa: E402
from repro_torch.gp import GPSession  # noqa: E402
from repro_torch.kernels import build, gp_eval, ops  # noqa: E402
from repro_torch.obs import counters  # noqa: E402

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


def device_ms(fn, calls: int = 20, windows: int = 3) -> dict:
    """The device's own time per call of `fn`, from torch.profiler over
    `calls` warm calls: the mean device time of the recorded kernels (the
    tracer may drop a few) times the CUDA launches per call that the host
    side counts -> {"device_ms", "cuda_launches_per_call",
    "device_kernels" (short names), "recorded_share",
    "device_ms_source", "profiler_windows"}. A window in which the tracer
    recorded no kernel is taken again, up to `windows` in all; after that
    the device time is the CUDA-event time of `calls` calls queued back to
    back, over `calls` (which holds the host's launch time too)."""
    import re
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for window in range(1, windows + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        total, recorded, launches, names = 0.0, 0, 0, set()
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", None) or getattr(
                e, "self_cuda_time_total", 0.0)
            if "LaunchKernel" in e.key:
                launches += e.count
            elif us > 0:
                total += us
                recorded += e.count
                m = re.search(r"(\w+)(<[^(]*>)?\(", e.key)
                names.add(m.group(1) if m else e.key[:40])
        per_call = launches / calls
        if recorded:
            return dict(device_ms=total / recorded * per_call / 1e3,
                        cuda_launches_per_call=per_call, device_kernels=sorted(names),
                        recorded_share=recorded / max(launches, 1),
                        device_ms_source="torch.profiler", profiler_windows=window)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return dict(device_ms=start.elapsed_time(end) / calls, cuda_launches_per_call=per_call,
                device_kernels=[], recorded_share=0.0,
                device_ms_source="cuda events, queued calls", profiler_windows=windows)


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


# --- phase 2: each kernel against its plain version ---------------------------

SHAPES = [("kepler", 200, 1, 9), ("kat7", 100, 9, 10_000),
          ("ligo", 100, 1_373, 4_000), ("large", 1024, 8, 32_768)]
POSTFIX_KERNELS = ("eval_fitness_postfix", "unique_table", "eval_fitness_from_subtrees",
                   "eval_fitness_from_preds", "predict_postfix")


def _population(P, F, fn_set, seed, p_const=0.2):
    spec = trees.TreeSpec(max_depth=5, n_features=F, fn_set=fn_set, p_const=p_const)
    op, arg = trees.generate_population(prng.PRNGKey(seed, DEV), P, spec)
    return spec, op, arg


def _ms_bound(nbytes, n_ops):
    """(bound ms, "bytes" | "operations"): the larger of the bytes over
    the card's memory rate and the f32 operations over its peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _bound_ms(op, F, D, weight):
    """Least time for B1's or B2's work on one call: bytes read once (op,
    arg, X, y, weight, constants) and written once (f32[P]), against the
    f32 operations these trees need (one per function node per point,
    plus three per tree and point for the epilogue)."""
    P, N = op.shape
    nbytes = 2 * P * N * 4 + F * D * 4 + D * 4 + (D * 4 if weight is not None else 0)
    nbytes += 8 * 4 + P * 4
    return _ms_bound(nbytes, D * (int((op >= 3).sum()) + 3 * P))


def _gather_bound_ms(P, D, rows_read):
    """B3/B4: the prediction rows they must read (`rows_read` distinct
    rows of D floats), y, root or nothing, and f32[P] out; three f32
    operations per tree and point (the epilogue)."""
    return _ms_bound(rows_read * D * 4 + D * 4 + 2 * P * 4, 3 * P * D)


def _live_rows(plan):
    """The unique-table rows anything reads: the n_unique live slots and
    the reserved all-EMPTY slot cap - 1 (every slot on overflow)."""
    U = plan.uop.shape[0]
    n = int(plan.n_unique)
    if n > U - 1:
        return torch.arange(U, device=DEV)
    return torch.cat([torch.arange(n, device=DEV), torch.tensor([U - 1], device=DEV)])


def _unique_bound_ms(plan, D):
    """The unique table: the live plan entries read once (5 int32 per
    slot, plus n_unique), the feature rows its terminals name, the live
    rows and the reserved one written once (the rows anything reads); one
    f32 operation per function slot and point."""
    live = _live_rows(plan)
    valid = plan.ulen > 0
    feats = int(torch.unique(plan.uarg[valid & (plan.uop == prim.FEATURE)]).numel())
    nbytes = live.numel() * 5 * 4 + 4 + feats * D * 4 + live.numel() * D * 4
    return _ms_bound(nbytes, D * int((valid & (plan.ulen >= 2)).sum()))


def _predict_bound_ms(op, F, D, C):
    """The probe predictions: op/arg, X[:, :D] and the constants read
    once, f32[P, D] written once; one f32 operation per function node
    and point."""
    P, N = op.shape
    nbytes = 2 * P * N * 4 + F * D * 4 + C * 4 + P * D * 4
    return _ms_bound(nbytes, D * int((op >= 3).sum()))


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
    """Hold a kernel's moments against the plain version's -> (max abs
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


def _compare_table(got, want, exact, tag):
    """Predictions (the unique table's read rows, the probe's) against
    their plain version: bitwise where the trees use no sin/cos/sqrt/log
    (the device's and torch's versions of those may round apart), rtol
    1e-4 on the finite values otherwise."""
    g, w = got.cpu().numpy(), want.cpu().numpy()
    if exact:
        if not np.array_equal(g, w, equal_nan=True):
            raise AssertionError(f"{tag}: unique table != plain")
        return 0.0
    if not np.array_equal(np.isfinite(g), np.isfinite(w)):
        raise AssertionError(f"{tag}: unique table: non-finite entries differ")
    fin = np.isfinite(w)
    np.testing.assert_allclose(g[fin], w[fin], rtol=1e-4, atol=1e-3, err_msg=tag)
    return float(np.abs(g[fin] - w[fin]).max(initial=0.0))


def _same_bits(a, b, tag):
    if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
        raise AssertionError(f"{tag}: not bitwise equal")


def _postfix_case(op, arg, Xd, yd, wd, consts, fn_set, cap, kw, tag):
    """B2, the unique table, B3, B4 and the probe predictions on the
    postfix form of (op, arg), each against its plain version and B2-B4
    against each other: -> (postfix op, arg, plan, uniq, preds, {kernel:
    (out, err)})."""
    pop, parg = trees.heap_to_postfix(op, arg)
    spec = trees.TreeSpec(max_depth=5, n_features=Xd.shape[0], fn_set=fn_set,
                          genome="postfix")
    plan = eval_mod.build_dedup_plan(pop, parg, spec, cap)
    if bool(plan.overflow):
        raise AssertionError(f"{tag}: the plan overflows its cap {cap}")
    codes = kw["fn_codes"]
    fk = {k: v for k, v in kw.items() if k not in ("max_depth", "fn_codes", "lattice")}
    b2 = gp_eval.eval_fitness_postfix(pop, parg, Xd, yd, wd, consts, stack_size=6,
                                      fn_codes=codes, **fk)
    b2_plain = gp_eval.eval_fitness_postfix_plain(pop, parg, Xd, yd, wd, consts,
                                                  stack_size=6, fn_codes=codes, **fk)
    uniq = gp_eval.unique_table(plan, Xd, consts, fn_codes=codes)
    uniq_plain = gp_eval.unique_table_plain(plan, Xd, consts, fn_codes=codes)
    transcendental = any(prim.FN_NAMES[c - 3] in ("sin", "cos", "sqrt", "log")
                         for c in codes)
    live = _live_rows(plan)
    u_err = _compare_table(uniq[live], uniq_plain[live], not transcendental,
                           tag + " unique_table")
    p_err = 0.0
    # the probe at its path's width (the first 32 points), then at the full D
    for Xp in (Xd[:, :min(Xd.shape[1], 32)].contiguous(), Xd):
        probe = gp_eval.predict_postfix(pop, parg, Xp, consts, stack_size=6, fn_codes=codes)
        probe_plain = gp_eval.predict_postfix_plain(pop, parg, Xp, consts, stack_size=6,
                                                    fn_codes=codes)
        p_err = max(p_err, _compare_table(probe, probe_plain, not transcendental,
                                          f"{tag} predict_postfix, D={Xp.shape[1]}"))
    b3 = gp_eval.eval_fitness_from_subtrees(plan.root, uniq, yd, wd, **fk)
    b3_plain = gp_eval.eval_fitness_from_subtrees_plain(plan.root, uniq, yd, wd, **fk)
    preds = uniq.index_select(0, plan.root.long())
    b4 = gp_eval.eval_fitness_from_preds(preds, yd, wd, **fk)
    b4_plain = gp_eval.eval_fitness_from_preds_plain(preds, yd, wd, **fk)
    kname, lattice = kw["kernel"], kw["lattice"]
    res = {"unique_table": (uniq, u_err), "predict_postfix": (probe, p_err)}
    for name, got, want in (("eval_fitness_postfix", b2, b2_plain),
                            ("eval_fitness_from_subtrees", b3, b3_plain),
                            ("eval_fitness_from_preds", b4, b4_plain)):
        res[name] = (got, _compare(got, want, kname, lattice, f"{tag} {name}")[0])
    _same_bits(b3, b2, tag + ": dedup on (B3) vs off (B2)")
    _same_bits(b4, b2, tag + ": dedup on (B4) vs off (B2)")
    return pop, parg, plan, uniq, preds, res


def _cdist_ms(preds, yd, fk):
    """B4's library yardstick for kernel r with no weight: one PyTorch call,
    `torch.cdist(preds, y[None], p=1)`, the same sum of |pred - y| per
    tree where no NaN is present (held to rtol 1e-4 against B4 on the
    rows where both are finite: another summation order) -> its warm
    median ms."""
    def lib():
        return torch.cdist(preds, yd[None], p=1)

    got = lib()[:, 0].cpu().numpy()
    want = gp_eval.eval_fitness_from_preds(preds, yd, None, **fk)[:, 0].cpu().numpy()
    fin = np.isfinite(got) & np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-4, atol=1e-3,
                               err_msg="torch.cdist vs B4")
    return time_ms(lib, 50)


def _table_cap(name, op, arg, spec):
    """The dedup cap of the kernel comparisons: P*N + 1, the cap no
    population can overflow (kat7: 6,301, as on the B4 path); at "large"
    the population's own unique count + 1, which keeps the f32[cap, D]
    table at a few hundred MB instead of 8 GB."""
    P, N = op.shape
    if name != "large":
        return P * N + 1
    pop, parg = trees.heap_to_postfix(op, arg)
    pspec = dataclasses.replace(spec, genome="postfix")
    return int(eval_mod.dedup_stats(pop, parg, pspec, P * N + 1)[0]) + 1


def kernel_vs_plain():
    """-> ({(shape, kernel): {kernel name: timings}}, {(shape, kernel name):
    max |kernel - plain|}, max relative error of B1 over every
    comparison). Every shape runs without a weight and with one of zeros
    and fractions (the padding-mask and `sample_weight` path), each with
    kernels r and c, plus m and mse on lattice data. The postfix kernels
    take the postfix form of B1's population and its dedup plan
    (`_table_cap`: no overflow)."""
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
                tag = f"{name} {kname} lattice={lattice}"
                err, rel = _compare(got, want, kname, lattice, tag)
                pkw = dict(kw, lattice=lattice)
                cap = _table_cap(name, op, arg, spec)
                pop, parg, plan, uniq, preds, pres = _postfix_case(
                    op, arg, Xd, yd, None, consts, fn_set, cap, pkw, tag)
                _same_bits(pres["eval_fitness_postfix"][0], got, tag + ": heap (B1) vs "
                           "postfix (B2)")

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
                err_w, rel_w = _compare(got_w, want_w, kname, lattice, tag + " weighted")
                nan_fit = got_w[P:, 0].cpu().numpy()
                if not (np.isfinite(nan_fit[0]) and np.isinf(nan_fit[1:]).all()):
                    raise AssertionError(f"{name} {kname}: NaN at a zero-weight point "
                                         f"must be masked, at a weighted one +inf: "
                                         f"{nan_fit}")
                *_, pres_w = _postfix_case(opw, argw, Xwd, yd, wd, consts, fn_set,
                                           _table_cap(name, opw, argw, spec), pkw,
                                           tag + " weighted")
                _same_bits(pres_w["eval_fitness_postfix"][0], got_w,
                           tag + " weighted: heap (B1) vs postfix (B2)")
                max_err[name, "eval_fitness"] = max(max_err.get((name, "eval_fitness"),
                                                                0.0), err, err_w)
                for k in POSTFIX_KERNELS:
                    max_err[name, k] = max(max_err.get((name, k), 0.0), pres[k][1],
                                           pres_w[k][1])
                max_rel = max(max_rel, rel, rel_w)
                if lattice:
                    continue
                reps = 20 if P * D < 1e7 else 5
                fk = {k: v for k, v in kw.items() if k not in ("max_depth", "fn_codes")}
                codes = kw["fn_codes"]
                # the probe at the path's shape: one elite row and one cached
                # row (elitism 1) on the first 32 points
                Xp = Xd[:, :min(D, 32)].contiguous()
                pop2, parg2 = pop[:2].contiguous(), parg[:2].contiguous()
                timed = {
                    "eval_fitness": (
                        lambda: gp_eval.eval_fitness(op, arg, Xd, yd, None, consts, **kw),
                        lambda: gp_eval.eval_fitness_plain(op, arg, Xd, yd, None, consts,
                                                           **kw),
                        _bound_ms(op, F, D, None)),
                    "eval_fitness_postfix": (
                        lambda: gp_eval.eval_fitness_postfix(
                            pop, parg, Xd, yd, None, consts, stack_size=6,
                            fn_codes=codes, **fk),
                        lambda: gp_eval.eval_fitness_postfix_plain(
                            pop, parg, Xd, yd, None, consts, stack_size=6,
                            fn_codes=codes, **fk),
                        _bound_ms(pop, F, D, None)),
                    "unique_table": (
                        lambda: gp_eval.unique_table(plan, Xd, consts, fn_codes=codes),
                        lambda: gp_eval.unique_table_plain(plan, Xd, consts,
                                                           fn_codes=codes),
                        _unique_bound_ms(plan, D)),
                    "eval_fitness_from_subtrees": (
                        lambda: gp_eval.eval_fitness_from_subtrees(plan.root, uniq, yd,
                                                                   None, **fk),
                        lambda: gp_eval.eval_fitness_from_subtrees_plain(
                            plan.root, uniq, yd, None, **fk),
                        _gather_bound_ms(P, D, int(torch.unique(plan.root).numel()))),
                    "eval_fitness_from_preds": (
                        lambda: gp_eval.eval_fitness_from_preds(preds, yd, None, **fk),
                        lambda: gp_eval.eval_fitness_from_preds_plain(preds, yd, None,
                                                                      **fk),
                        _gather_bound_ms(P, D, P)),
                    "predict_postfix": (
                        lambda: gp_eval.predict_postfix(pop2, parg2, Xp, consts,
                                                        stack_size=6, fn_codes=codes),
                        lambda: gp_eval.predict_postfix_plain(pop2, parg2, Xp, consts,
                                                              stack_size=6,
                                                              fn_codes=codes),
                        _predict_bound_ms(pop2, F, Xp.shape[1], consts.shape[0])),
                }
                row = {}
                for kern_name, (fn, plain_fn, (bound, bound_by)) in timed.items():
                    row[kern_name] = dict(ms=time_ms(fn, 50), **device_ms(fn),
                                          plain_ms=time_ms(plain_fn, reps),
                                          bound_ms=bound, bound_by=bound_by,
                                          library_ms=None)
                if kname == "r":
                    row["eval_fitness_from_preds"]["library_ms"] = _cdist_ms(preds, yd, fk)
                _one_launch(row, f"{name} {kname}")
                results[(name, kname)] = row
                emit("kernel", shape=name, P=P, F=F, D=D, kernel=kname, tile=tile,
                     fn_set=fn_set.name, dedup_cap=cap,
                     n_unique=int(plan.n_unique), max_abs_err=err, max_rel_err=rel,
                     fn_nodes=int((op >= 3).sum()),
                     **{k: {kk: round(vv, 6) if isinstance(vv, float) else vv
                            for kk, vv in v.items()} for k, v in row.items()})
    return results, max_err, max_rel


# --- the unique table's schedules, and B1's and B2's points per thread ---------

def _table_case(name, P, F, D, seed):
    """A CLASSIFY_SET population at one of SHAPES, its postfix form, the
    plan at `_table_cap` and at cap 100 (which overflows), and the data."""
    rng = np.random.RandomState(seed)
    spec, op, arg = _population(P, F, prim.CLASSIFY_SET, seed=seed)
    Xd = torch.from_numpy(rng.randn(F, D).astype(np.float32)).to(DEV)
    yd = torch.from_numpy((rng.rand(D) > 0.5).astype(np.float32)).to(DEV)
    pop, parg = trees.heap_to_postfix(op, arg)
    pspec = dataclasses.replace(spec, genome="postfix")
    plan = eval_mod.build_dedup_plan(pop, parg, pspec, _table_cap(name, op, arg, spec))
    over = eval_mod.build_dedup_plan(pop, parg, pspec, 100)
    codes = tuple(int(c) for c in prim.CLASSIFY_SET.opcodes)
    return pop, parg, plan, over, Xd, yd, spec.const_table(DEV), codes


def _table_budgets(n, max_len):
    """Shared memory budgets for the table kernel with n live slots whose
    longest span is max_len: the default, the least that stages one
    point's values (tiles of one point), and 1 KB (the scan)."""
    return gp_eval.TABLE_SMEM_BYTES, (gp_eval.table_words(n, max_len) + n) * 4, 1024


def table_modes():
    """The unique table's schedules (`gp_eval.table_schedule`), forced
    through gp_eval.TABLE_SMEM_BYTES: staged at the default tile and at
    one point a tile, and the scan; each bitwise equal to the plain
    version on the read rows of a CLASSIFY_SET plan at every shape. Then,
    with each, an ungated call on a plan that overflows its cap (100),
    which must run without a fault."""
    saved = gp_eval.TABLE_SMEM_BYTES
    out = []
    try:
        for name, P, F, D in SHAPES:
            _, _, plan, over, Xd, _, consts, codes = _table_case(name, P, F, D, 7)
            if not bool(over.overflow) or bool(plan.overflow):
                raise AssertionError(f"{name}: the plans must overflow at cap 100 only")
            live = _live_rows(plan)
            want = gp_eval.unique_table_plain(plan, Xd, consts, fn_codes=codes)[live]
            U, n, max_len = plan.uop.shape[0], int(plan.n_unique), int(plan.ulen.max())
            held = []
            for budget in _table_budgets(n, max_len):
                gp_eval.TABLE_SMEM_BYTES = budget
                blocks, smem = gp_eval.table_geometry(D)
                label = "%s, %d points a tile" % gp_eval.table_schedule(n, max_len, D, blocks,
                                                                          smem)
                got = gp_eval.unique_table(plan, Xd, consts, fn_codes=codes)[live]
                _compare_table(got, want, True, f"{name} table, {label}, smem {smem}")
                o = gp_eval.unique_table(over, Xd, consts, fn_codes=codes)
                torch.cuda.synchronize()
                if o.shape != (over.uop.shape[0], D):
                    raise AssertionError(f"{name}: overflow table shape {o.shape}")
                held.append(dict(smem_bytes=smem, schedule=label))
            gp_eval.TABLE_SMEM_BYTES = saved
            out.append(dict(shape=name, n_unique=n, cap=U,
                            overflow_n_unique=int(over.n_unique),
                            blocks_and_smem_bytes=gp_eval.table_geometry(D), held=held))
    finally:
        gp_eval.TABLE_SMEM_BYTES = saved
    emit("table_modes", overflow_call="ran without a fault with every budget",
         shapes=out)


def points_per_thread():
    """B1-B4 with V, the points a thread carries through the program
    at once, forced to 1, 2 and 4 through the data tile (256, 512 and
    1024 points: V = tile / 256) at every shape, without a weight and
    with one of zeros and fractions (B3/B4 then load three arrays). On
    lattice data (add/sub/mul trees, X in {-1, 0, 1}) with kernels r and
    c each unweighted B1 call is held against its plain version at that
    tile (`_compare`: exact where the sums are); on KITCHEN_SINK trees
    and real-valued data (kernel r) too, B1 == B2 == B3 == B4 bitwise
    (B2 on the postfix form, B3 and B4 on its dedup plan's table)."""
    rng = np.random.RandomState(3)
    held = []
    for name, P, F, D in SHAPES:
        for lattice in (True, False):
            if lattice:
                fn_set = prim.FunctionSet.make(("add", "sub", "mul"))
                X = rng.randint(-1, 2, size=(F, D)).astype(np.float32)
            else:
                fn_set = prim.KITCHEN_SINK
                X = rng.randn(F, D).astype(np.float32)
            y = rng.randint(0, 3, size=D).astype(np.float32)
            wt = rng.choice(np.float32([0.0, 0.25, 0.5, 1.0]), size=D)
            spec, op, arg = _population(P, F, fn_set, seed=P + F + D + 1,
                                        p_const=0.0 if lattice else 0.2)
            pop, parg = trees.heap_to_postfix(op, arg)
            Xd, yd = torch.from_numpy(X).to(DEV), torch.from_numpy(y).to(DEV)
            consts = spec.const_table(DEV)
            codes = tuple(int(c) for c in fn_set.opcodes)
            plan = eval_mod.build_dedup_plan(pop, parg,
                                             dataclasses.replace(spec, genome="postfix"),
                                             _table_cap(name, op, arg, spec))
            uniq = gp_eval.unique_table(plan, Xd, consts, fn_codes=codes)
            preds = uniq.index_select(0, plan.root.long())
            for tile in (256, 512, 1024):
                for kname in ("r", "c") if lattice else ("r",):
                    for wd in (None, torch.from_numpy(wt).to(DEV)):
                        fk = dict(kernel=kname, n_classes=3, data_tile=tile)
                        tag = (f"{name} {kname} lattice={lattice} tile={tile} "
                               f"weighted={wd is not None}")
                        b1 = gp_eval.eval_fitness(op, arg, Xd, yd, wd, consts, max_depth=5,
                                                  fn_codes=codes, **fk)
                        b2 = gp_eval.eval_fitness_postfix(pop, parg, Xd, yd, wd, consts,
                                                          stack_size=6, fn_codes=codes, **fk)
                        b3 = gp_eval.eval_fitness_from_subtrees(plan.root, uniq, yd, wd, **fk)
                        b4 = gp_eval.eval_fitness_from_preds(preds, yd, wd, **fk)
                        _same_bits(b1, b2, tag + ": B1 vs B2")
                        _same_bits(b1, b3, tag + ": B1 vs B3")
                        _same_bits(b1, b4, tag + ": B1 vs B4")
                        if lattice and wd is None:
                            want = gp_eval.eval_fitness_plain(op, arg, Xd, yd, None, consts,
                                                              max_depth=5, fn_codes=codes,
                                                              **fk)
                            _compare(b1, want, kname, True, tag + ": B1 vs plain")
                        held.append(f"{tag} V={tile // 256}")
    emit("points_per_thread", held=held,
         checks="B1 == B2 == B3 == B4 bitwise; B1 vs plain on lattice data (exact "
                "where the sums are)")


def many_trees():
    """B1-B4 on P = 70,000 trees at the kepler shape (F = 1, D = 9, depth
    5): more than the 65,535 trees a launch takes (gridDim.y), so each
    wrapper launches twice (`gp_eval.pop_chunks`). On lattice data
    (add/sub/mul trees, X in {-1, 0, 1}) with kernels r and c, each
    kernel is held against its plain version (exact), and B1 == B2 == B3
    == B4 bitwise (B3/B4 on the population's dedup plan at cap P*N + 1)."""
    P, F, D = 70_000, 1, 9
    rng = np.random.RandomState(11)
    fn_set = prim.FunctionSet.make(("add", "sub", "mul"))
    codes = tuple(int(c) for c in fn_set.opcodes)
    Xd = torch.from_numpy(rng.randint(-1, 2, size=(F, D)).astype(np.float32)).to(DEV)
    yd = torch.from_numpy(rng.randint(0, 3, size=D).astype(np.float32)).to(DEV)
    spec, op, arg = _population(P, F, fn_set, seed=P, p_const=0.0)
    consts = spec.const_table(DEV)
    pop, parg = trees.heap_to_postfix(op, arg)
    plan = eval_mod.build_dedup_plan(pop, parg, dataclasses.replace(spec, genome="postfix"),
                                     P * op.shape[1] + 1)
    uniq = gp_eval.unique_table(plan, Xd, consts, fn_codes=codes)
    preds = uniq.index_select(0, plan.root.long())
    held = []
    for kname in ("r", "c"):
        fk = dict(kernel=kname, n_classes=3, data_tile=256)
        tag = f"P={P} kepler {kname}"
        gp_eval.reset_launches()
        got = {
            "eval_fitness": gp_eval.eval_fitness(op, arg, Xd, yd, None, consts, max_depth=5,
                                                 fn_codes=codes, **fk),
            "eval_fitness_postfix": gp_eval.eval_fitness_postfix(
                pop, parg, Xd, yd, None, consts, stack_size=6, fn_codes=codes, **fk),
            "eval_fitness_from_subtrees": gp_eval.eval_fitness_from_subtrees(
                plan.root, uniq, yd, None, **fk),
            "eval_fitness_from_preds": gp_eval.eval_fitness_from_preds(preds, yd, None, **fk)}
        torch.cuda.synchronize()
        launched = {k: gp_eval.launches[k] for k in got}
        if any(n != 2 for n in launched.values()):
            raise AssertionError(f"{tag}: launches {launched}; want 2 each")
        want = {
            "eval_fitness": gp_eval.eval_fitness_plain(op, arg, Xd, yd, None, consts,
                                                       max_depth=5, fn_codes=codes, **fk),
            "eval_fitness_postfix": gp_eval.eval_fitness_postfix_plain(
                pop, parg, Xd, yd, None, consts, stack_size=6, fn_codes=codes, **fk),
            "eval_fitness_from_subtrees": gp_eval.eval_fitness_from_subtrees_plain(
                plan.root, uniq, yd, None, **fk),
            "eval_fitness_from_preds": gp_eval.eval_fitness_from_preds_plain(
                preds, yd, None, **fk)}
        for k in got:
            _compare(got[k], want[k], kname, True, f"{tag} {k}")
            _same_bits(got[k], got["eval_fitness"], f"{tag}: {k} vs B1")
        held.append(dict(kernel=kname, launches=launched))
    emit("many_trees", P=P, F=F, D=D, n_unique=int(plan.n_unique), held=held,
         checks="each of B1-B4 vs plain (exact); B1 == B2 == B3 == B4 bitwise")


# --- phase 2b: the two-pass kernels pearson and r2 on B1-B4 -------------------

TWO_PASS = ("pearson", "r2")
FITNESS_KERNELS = ("eval_fitness", "eval_fitness_postfix", "eval_fitness_from_subtrees",
                   "eval_fitness_from_preds")
# f32 operations of the epilogue per tree and point: r/c three (phase 2);
# pearson's two passes 8 + 10, r2's 8 + 4 (fold_pass1 / fold_pass2 in
# csrc/gp_eval.cu)
EPILOGUE_OPS = {"r": 3, "c": 3, "pearson": 18, "r2": 12}


def _two_pass_bounds(kname, op, F, D, weight, rows_read=None):
    """(B1/B2 bound, B3 bound, B4 bound) for fitness kernel `kname`: the
    bytes of `_bound_ms` / `_gather_bound_ms` with out f32[P, M], and the
    epilogue's f32 operations per tree and point."""
    P = op.shape[0]
    M = {"pearson": 7, "r2": 5}.get(kname, 1)
    wb = D * 4 if weight is not None else 0
    ep = EPILOGUE_OPS[kname] * P * D
    rows = _ms_bound(2 * op.numel() * 4 + F * D * 4 + D * 4 + wb + 8 * 4 + P * M * 4,
                     D * int((op >= 3).sum()) + ep)
    b3 = _ms_bound(rows_read * D * 4 + D * 4 + wb + P * 4 + P * M * 4, ep)
    b4 = _ms_bound(P * D * 4 + D * 4 + wb + P * M * 4, ep)
    return rows, b3, b4


def _compare_two_pass(got, want, kname, tag):
    """A two-pass kernel's [P, M] moments against the plain version's: the
    non-finite count exactly; every other column within rtol 1e-4 with
    atol 1e-4 x the column's largest |value| (the card sums in another
    order); the fitness after reduce_moments within 1e-4 absolute (r2's
    fitness is unbounded: 1e-4 relative as well), +inf at the same trees
    -> (max |fitness error|, max |fitness error| / max(|fitness|, 1)) over
    the finite trees."""
    g, w = got.cpu().numpy(), want.cpu().numpy()
    if g.shape != w.shape or not np.array_equal(np.isfinite(g), np.isfinite(w)):
        raise AssertionError(f"{tag}: shapes or non-finite moments differ")
    if not np.array_equal(g[:, -1], w[:, -1]):
        raise AssertionError(f"{tag}: non-finite counts differ")
    fin = np.isfinite(w)
    gz, wz = np.where(fin, g, 0.0), np.where(fin, w, 0.0)
    atol = 1e-4 * np.abs(wz).max(axis=0, keepdims=True)
    bad = np.abs(gz - wz) > 1e-4 * np.abs(wz) + atol
    if bad.any():
        raise AssertionError(f"{tag}: moments differ at {np.argwhere(bad)[:4].tolist()}: "
                             f"{gz[bad][:4]} vs {wz[bad][:4]}")
    fg, fw = fit_reduce(kname, got), fit_reduce(kname, want)
    if not np.array_equal(np.isposinf(fg), np.isposinf(fw)) or np.isnan(fg).any():
        raise AssertionError(f"{tag}: +inf fitness sets differ")
    ok = np.isfinite(fw)
    rtol = 1e-4 if kname == "r2" else 0.0
    np.testing.assert_allclose(fg[ok], fw[ok], rtol=rtol, atol=1e-4, err_msg=tag)
    err = np.abs(fg[ok] - fw[ok])
    return (float(err.max(initial=0.0)),
            float((err / np.maximum(np.abs(fw[ok]), 1.0)).max(initial=0.0)))


def _fitness_calls(op, arg, pop, parg, plan, uniq, preds, Xd, yd, wd, consts, codes, fk):
    """{kernel name: (card call, plain call)} of B1-B4 on one case."""
    return {
        "eval_fitness": (
            lambda: gp_eval.eval_fitness(op, arg, Xd, yd, wd, consts, max_depth=5,
                                         fn_codes=codes, **fk),
            lambda: gp_eval.eval_fitness_plain(op, arg, Xd, yd, wd, consts, max_depth=5,
                                               fn_codes=codes, **fk)),
        "eval_fitness_postfix": (
            lambda: gp_eval.eval_fitness_postfix(pop, parg, Xd, yd, wd, consts, stack_size=6,
                                                 fn_codes=codes, **fk),
            lambda: gp_eval.eval_fitness_postfix_plain(pop, parg, Xd, yd, wd, consts,
                                                       stack_size=6, fn_codes=codes, **fk)),
        "eval_fitness_from_subtrees": (
            lambda: gp_eval.eval_fitness_from_subtrees(plan.root, uniq, yd, wd, **fk),
            lambda: gp_eval.eval_fitness_from_subtrees_plain(plan.root, uniq, yd, wd, **fk)),
        "eval_fitness_from_preds": (
            lambda: gp_eval.eval_fitness_from_preds(preds, yd, wd, **fk),
            lambda: gp_eval.eval_fitness_from_preds_plain(preds, yd, wd, **fk)),
    }


def two_pass_kernels():
    """Phase 2b -> ({kernel name: {fitness kernel: timings at kat7}},
    {(shape, fitness kernel): {kernel name: device ms}} at kat7 and large,
    {fitness kernel: {kernel name: (max |fitness error|, max relative)}}
    at kat7). At every
    shape, B1-B4 under pearson and r2 (KITCHEN_SINK trees, real-valued X
    and y), without a weight and with one of zeros and fractions plus the
    NaN rows: each against its plain version (`_compare_two_pass`), and
    B1 == B2 == B3 == B4 bit for bit. At kat7 and large, each kernel's
    time under r, pearson and r2 on the same inputs (the one-moment
    instantiation beside the two-pass one), one CUDA launch per call of
    the kernel's own name. Then P = 70,000 trees (kepler shape) under
    pearson: two launches each, against the plain versions, bitwise
    alike."""
    rng = np.random.RandomState(21)
    timed, device, errs = {}, {}, {}
    held = []
    for name, P, F, D in SHAPES:
        X = rng.randn(F, D).astype(np.float32)
        y = rng.randn(D).astype(np.float32)
        spec, op, arg = _population(P, F, prim.KITCHEN_SINK, seed=P + F + D + 5)
        codes = tuple(int(c) for c in prim.KITCHEN_SINK.opcodes)
        consts = spec.const_table(DEV)
        _, tile = ops.pick_tiles(F, spec.num_nodes, P, D)
        wt = rng.choice(np.float32([0.0, 0.25, 0.5, 1.0]), size=D)
        nop, narg = _nan_rows(F, wt)
        Xw = X.copy()
        Xw[0, 0] = 1e30
        if F > 1:
            Xw[1, min(1, D - 1)] = 1e30
        for weighted in (False, True):
            o, a = (torch.cat([op, nop]), torch.cat([arg, narg])) if weighted else (op, arg)
            Xd = torch.from_numpy(Xw if weighted else X).to(DEV)
            yd = torch.from_numpy(y).to(DEV)
            wd = torch.from_numpy(wt).to(DEV) if weighted else None
            pop, parg = trees.heap_to_postfix(o, a)
            plan = eval_mod.build_dedup_plan(pop, parg, dataclasses.replace(spec, genome="postfix"),
                                             _table_cap(name, o, a, spec))
            if bool(plan.overflow):
                raise AssertionError(f"two-pass {name}: the plan overflows")
            uniq = gp_eval.unique_table(plan, Xd, consts, fn_codes=codes)
            preds = uniq.index_select(0, plan.root.long())
            for kname in TWO_PASS:
                fk = dict(kernel=kname, n_classes=3, data_tile=tile)
                tag = f"two-pass {name} {kname} weighted={weighted}"
                calls = _fitness_calls(o, a, pop, parg, plan, uniq, preds, Xd, yd, wd, consts,
                                       codes, fk)
                gp_eval.reset_launches()
                got = {k: card() for k, (card, _) in calls.items()}
                torch.cuda.synchronize()
                if any(gp_eval.launches[k] != 1 for k in calls):
                    raise AssertionError(f"{tag}: launches {gp_eval.launches}")
                for k, (_, plain) in calls.items():
                    err = _compare_two_pass(got[k], plain(), kname, f"{tag} {k}")
                    if name == "kat7":
                        by = errs.setdefault(kname, {})
                        by[k] = tuple(map(max, by.get(k, (0.0, 0.0)), err))
                    _same_bits(got[k], got["eval_fitness"], f"{tag}: {k} vs B1")
                if weighted:
                    f = fit_reduce(kname, got["eval_fitness"])[P:]
                    if not (np.isfinite(f[0]) and np.isinf(f[1:]).all()):
                        raise AssertionError(f"{tag}: NaN at a zero-weight point must be "
                                             f"masked, at a weighted one +inf: {f}")
                held.append(tag)
            if weighted or name not in ("kat7", "large"):
                continue
            bounds = {k: _two_pass_bounds(k, op, F, D, None,
                                          int(torch.unique(plan.root).numel()))
                      for k in ("r",) + TWO_PASS}
            for kname in ("r",) + TWO_PASS:
                fk = dict(kernel=kname, n_classes=3, data_tile=tile)
                calls = _fitness_calls(op, arg, pop, parg, plan, uniq, preds, Xd, yd, None,
                                       consts, codes, fk)
                row = {}
                for k, (card, plain) in calls.items():
                    b = bounds[kname]
                    bound, bound_by = b[0] if k in FITNESS_KERNELS[:2] else (
                        b[1] if k == "eval_fitness_from_subtrees" else b[2])
                    dm = device_ms(card)
                    if (dm["cuda_launches_per_call"] != 1.0
                            or dm["device_kernels"] not in ([], [ONE_LAUNCH[k]])):
                        raise AssertionError(f"two-pass {name} {kname} {k}: {dm}")
                    row[k] = dict(device_ms=dm["device_ms"],
                                  cuda_launches_per_call=dm["cuda_launches_per_call"],
                                  device_ms_source=dm["device_ms_source"],
                                  bound_ms=bound, bound_by=bound_by)
                    if name == "kat7" and kname in TWO_PASS:
                        row[k].update(ms=time_ms(card, 50), plain_ms=time_ms(plain, 20))
                        timed.setdefault(k, {})[kname] = row[k]
                device[name, kname] = {k: v["device_ms"] for k, v in row.items()}
                emit("two_pass_kernel", shape=name, P=P, F=F, D=D, kernel=kname, tile=tile,
                     n_unique=int(plan.n_unique), **row)
    for k, by_kernel in timed.items():  # both weightings' errors are in by now
        for kname, row in by_kernel.items():
            row["max_abs_err"], row["max_rel_err"] = errs[kname][k]
    ratios = {f"{name}/{kname}": {k: device[name, kname][k] / device[name, "r"][k]
                                   for k in FITNESS_KERNELS}
              for name in ("kat7", "large") for kname in TWO_PASS}
    # this PR's predictions (PERF.md §6), reported, not enforced: B3/B4 at
    # kat7 <= 1.5x and at large <= 1.3x their r time, B1/B2 at kat7 <= 1.2x
    limits = {("kat7", "eval_fitness"): 1.2, ("kat7", "eval_fitness_postfix"): 1.2,
              ("kat7", "eval_fitness_from_subtrees"): 1.5,
              ("kat7", "eval_fitness_from_preds"): 1.5,
              ("large", "eval_fitness_from_subtrees"): 1.3,
              ("large", "eval_fitness_from_preds"): 1.3}
    predictions = {f"{shape}/{kname} {k}": {"over_r": ratios[f"{shape}/{kname}"][k],
                                            "limit": lim,
                                            "held": ratios[f"{shape}/{kname}"][k] <= lim}
                   for (shape, k), lim in limits.items() for kname in TWO_PASS}
    chunked = _two_pass_many_trees()
    emit("two_pass", held=held, device_ms_over_r=ratios, predictions=predictions,
         many_trees=chunked,
         checks="B1-B4 vs plain (moments rtol 1e-4, atol 1e-4 x column max; fitness "
                "1e-4); B1 == B2 == B3 == B4 bitwise; one launch per call")
    return timed, device, errs


def fit_reduce(kname, moments):
    """The fitness f32[P] (host) of a two-pass kernel's [P, M] moments."""
    return fit.get_kernel(kname).reduce_moments(moments, fit.FitnessSpec(kname)).cpu().numpy()


def _two_pass_many_trees():
    """B1-B4 under pearson on P = 70,000 trees at the kepler shape: two
    launches each (65,535 trees a launch), each against its plain version,
    B1 == B2 == B3 == B4 bitwise."""
    P, F, D = 70_000, 1, 9
    rng = np.random.RandomState(12)
    fn_set = prim.FunctionSet.make(("add", "sub", "mul"))
    codes = tuple(int(c) for c in fn_set.opcodes)
    Xd = torch.from_numpy(rng.randint(-1, 2, size=(F, D)).astype(np.float32)).to(DEV)
    yd = torch.from_numpy(rng.randint(0, 3, size=D).astype(np.float32)).to(DEV)
    spec, op, arg = _population(P, F, fn_set, seed=P + 1, p_const=0.0)
    consts = spec.const_table(DEV)
    pop, parg = trees.heap_to_postfix(op, arg)
    plan = eval_mod.build_dedup_plan(pop, parg, dataclasses.replace(spec, genome="postfix"),
                                     P * op.shape[1] + 1)
    uniq = gp_eval.unique_table(plan, Xd, consts, fn_codes=codes)
    preds = uniq.index_select(0, plan.root.long())
    fk = dict(kernel="pearson", n_classes=3, data_tile=256)
    calls = _fitness_calls(op, arg, pop, parg, plan, uniq, preds, Xd, yd, None, consts,
                           codes, fk)
    gp_eval.reset_launches()
    got = {k: card() for k, (card, _) in calls.items()}
    torch.cuda.synchronize()
    launched = {k: gp_eval.launches[k] for k in calls}
    if any(n != 2 for n in launched.values()):
        raise AssertionError(f"two-pass P={P}: launches {launched}; want 2 each")
    for k, (_, plain) in calls.items():
        _compare_two_pass(got[k], plain(), "pearson", f"two-pass P={P} {k}")
        _same_bits(got[k], got["eval_fitness"], f"two-pass P={P}: {k} vs B1")
    return dict(P=P, D=D, kernel="pearson", launches=launched)


# --- the parent commit's phase 2, for an A/B inside one call --------------------

_PARENT_SHIM = """
import sys
sys.path.insert(0, {root!r})
sys.argv = ["chip_smoke.py"]
import chip_smoke as cs
import torch
{device_ms}
cs.device_ms = device_ms
cs.build.load("gp_eval")
cs.kernel_vs_plain()
"""


def parent_phase2(root):
    """Phase 2 (`kernel_vs_plain`) of another tree of the repo, e.g. the
    parent commit unpacked with `git archive`, in a child process (both
    trees name their package repro_torch), its device times taken by this
    tree's `device_ms` -> {(shape, kernel): row}."""
    import inspect

    code = _PARENT_SHIM.format(root=str(Path(root).resolve()),
                               device_ms=inspect.getsource(device_ms))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=root, timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"parent phase 2 failed:\n{proc.stdout[-3000:]}\n"
                             f"{proc.stderr[-3000:]}")
    rows = {}
    for ln in proc.stdout.splitlines():
        if ln.startswith("{"):
            rec = json.loads(ln)
            if rec.get("phase") == "kernel":
                rows[rec["shape"], rec["kernel"]] = rec
    return rows


AB_KERNELS = ("eval_fitness", "predict_postfix", "eval_fitness_postfix", "unique_table",
              "eval_fitness_from_subtrees", "eval_fitness_from_preds")


def ab_lines(label, rows, perf):
    """One "ab" line per shape: every kernel's (B1, the probe, B2, the
    table, B3, B4) ms, device_ms and CUDA launches per call in the other
    tree (`label`) and in this one, beside the bound."""
    fields = ("ms", "device_ms", "cuda_launches_per_call", "device_ms_source")
    for (shape, kname), mine in perf.items():
        other = rows.get((shape, kname), {})
        emit("ab", other=label, shape=shape, kernel=kname, **{
            k: {"other": {f: other.get(k, {}).get(f) for f in fields},
                "this": {f: mine[k].get(f) for f in fields},
                "bound_ms": mine[k]["bound_ms"]}
            for k in AB_KERNELS})


# --- phases 3-6: the paths ------------------------------------------------------


def _history_vs_cpu(dataset, gens, pop, gpu_history, **kw):
    """The same session on the CPU: its history must equal the card's
    bit for bit (the c kernel's hit counts are exact integers, and every
    draw comes from the same threefry key)."""
    cpu = GPSession.from_dataset(dataset, pop_size=pop, generations=gens, device="cpu",
                                 **kw)
    cpu.init(key=prng.PRNGKey(0))
    cpu.evolve(gens)
    a = np.asarray(gpu_history[:gens], np.float32)
    b = np.asarray(cpu.history, np.float32)
    if not np.array_equal(a, b):
        first = int(np.nonzero(a != b)[0][0])
        raise AssertionError(f"{dataset} {kw}: card and CPU histories part at "
                             f"generation {first}: {a[first]} vs {b[first]}")
    return b


def run_dataset(dataset, pop, gens, cpu_gens, block_check, expect=("eval_fitness",),
                overflow=None, **kw):
    """Drive `GPSession.from_dataset(dataset, **kw)` for `gens`
    generations on the card with the launch counts set to 0 just before
    and read just after: every kernel in `expect` must have launched,
    every other kernel not at all. With dedup on, `overflow` (True or
    False) is what each generation's counter row must show: the unique
    table overflowed its cap (B2 did the work, nothing saved) in every
    generation, or in none (the table and B3/B4 did it); None leaves it
    to the run. The first `cpu_gens` generations must equal the CPU
    run's bit for bit (0: no CPU run)."""
    sess = GPSession.from_dataset(dataset, pop_size=pop, generations=gens, **kw)
    assert sess.backend == "cuda", sess.backend
    sess.init(key=prng.PRNGKey(0))
    torch.cuda.synchronize()
    gp_eval.reset_launches()
    t0 = time.perf_counter()
    sess.evolve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(gp_eval.launches)
    for name, n in launches.items():
        if (n > 0) != (name in expect):
            raise AssertionError(f"{dataset} {kw}: kernel {name} launched {n} times; "
                                 f"this path must launch exactly {expect}")
    hist = np.asarray(sess.history, np.float32)
    if not (np.isfinite(hist).all() and (np.diff(hist) <= 0).all()):
        raise AssertionError(f"{dataset}: best fitness not finite/non-increasing")
    if cpu_gens:
        _history_vs_cpu(dataset, cpu_gens, pop, sess.history, **kw)
    out = dict(dataset=dataset, options=kw, pop=pop, generations=gens, rows=sess.n_rows,
               launches={k: v for k, v in launches.items() if v},
               host_syncs=sess.stats["host_syncs"],
               wall_s=wall, gens_per_s=gens / wall,
               tree_rows_per_s=sess.stats["tree_row_evals"] / wall,
               best_fitness=float(hist[-1]), cpu_bitwise_generations=cpu_gens,
               best=sess.best_expression(), history=hist.tolist())
    if sess.config.tree_spec.genome == "postfix" and sess.config.dedup != "off":
        cap = eval_mod.resolve_dedup_cap(sess.config.dedup_cap, pop,
                                         sess.config.tree_spec.num_nodes)
        rows = np.asarray(sess.counter_history)
        uniq = rows[:, counters.UNIQUE_SUBTREES]
        saved = rows[:, counters.SUBTREE_EVALS_SAVED]
        over = uniq > cap - 1
        if len(rows) != gens or not np.array_equal(saved == 0, over):
            raise AssertionError(f"{dataset} {kw}: counter rows disagree with the "
                                 f"cap {cap}: unique {uniq}, saved {saved}")
        if overflow is not None and not (over == overflow).all():
            raise AssertionError(f"{dataset} {kw}: the table must overflow in "
                                 f"{'every' if overflow else 'no'} generation; "
                                 f"unique per generation {uniq.tolist()}")
        out.update(dedup_cap=cap, unique_subtrees=int(uniq.sum()),
                   subtree_evals_saved=int(saved.sum()),
                   unique_per_generation=uniq.tolist(),
                   overflowed_generations=int(over.sum()))
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


_B2_GATED = ("eval_fitness_postfix", "unique_table")  # + B3 or B4: the dedup path
POSTFIX_RUNS = (  # (label, session options, kernels the run must launch, overflow)
    ("exact_cap100", {}, _B2_GATED + ("eval_fitness_from_subtrees",), True),
    ("off", {"dedup": "off"}, ("eval_fitness_postfix",), None),
    ("exact_cap1400", {"dedup_cap": 1400}, _B2_GATED + ("eval_fitness_from_subtrees",),
     False),
    ("exact_cap6301", {"dedup_cap": 6301}, _B2_GATED + ("eval_fitness_from_preds",),
     False),
    ("semantic", {"dedup": "semantic"},
     _B2_GATED + ("eval_fitness_from_subtrees", "predict_postfix"), True),
)


def postfix_paths():
    """Phase 6 -> {label: run}: kat7 with postfix genomes at full width
    (P = 100, depth 5, F = 9, D = 10,000, kernel c, CLASSIFY_SET), 30
    generations per run. Every exact/off run's history must equal the
    dedup-off run's (dedup is bitwise); the semantic tier's is
    tolerance-pinned (rtol 1e-5 against dedup off)."""
    runs = {}
    for label, kw, expect, overflow in POSTFIX_RUNS:
        run = run_dataset("kat7", 100, 30, 10, block_check=True, expect=expect,
                          overflow=overflow, genome="postfix", **kw)
        runs[label] = run
        emit("postfix_path", run=label, **run)
    off = np.asarray(runs["off"]["history"], np.float32)
    for label, run in runs.items():
        h = np.asarray(run["history"], np.float32)
        if label == "semantic":
            np.testing.assert_allclose(h, off, rtol=1e-5, err_msg="semantic vs off")
        elif not np.array_equal(h, off):
            raise AssertionError(f"postfix {label}: history differs from dedup off")
    return runs


TWO_PASS_RUNS = (  # (label, session options, kernels the run must launch, overflow)
    ("pearson_heap", {"kernel": "pearson"}, ("eval_fitness",), None),
    ("pearson_off", {"kernel": "pearson", "genome": "postfix", "dedup": "off"},
     ("eval_fitness_postfix",), None),
    ("pearson_exact_cap1400", {"kernel": "pearson", "genome": "postfix", "dedup_cap": 1400},
     _B2_GATED + ("eval_fitness_from_subtrees",), None),
    ("pearson_exact_cap6301", {"kernel": "pearson", "genome": "postfix", "dedup_cap": 6301},
     _B2_GATED + ("eval_fitness_from_preds",), False),
    ("r2_heap", {"kernel": "r2"}, ("eval_fitness",), None),
)


def _dyadic_lattice(kernel):
    """The CPU tests' lattice session (tests/test_torch_two_pass.py): 16
    rows of features in {-1, 0, 1}, an integer target, add/sub trees of
    depth 2 and no constants, where every moment sum is exact in f32: the
    card's history (tiles merged in the kernel, then reduce_moments) must
    equal the CPU's (the whole-dataset form) bit for bit."""
    rng = np.random.RandomState(11)
    X = rng.randint(-1, 2, size=(16, 3)).astype(np.float32)
    y = (X[:, 0] - X[:, 1] + rng.randint(-1, 2, size=16)).astype(np.float32)
    kw = dict(pop_size=16, generations=8, kernel=kernel, max_depth=2, p_const=0.0,
              fn_set="add,sub")
    card = GPSession(**kw).fit(X, y, key=prng.PRNGKey(4))
    cpu = GPSession(device="cpu", **kw).fit(X, y, key=prng.PRNGKey(4))
    if card.backend != "cuda" or card.history != cpu.history:
        raise AssertionError(f"lattice {kernel}: card {card.history} vs CPU {cpu.history}")
    if not torch.equal(card.state.fitness.cpu(), cpu.state.fitness):
        raise AssertionError(f"lattice {kernel}: last fitness vectors differ")
    return card.history


def _first_generation_vs_cpu(kernel):
    """kat7 at full width: the first generation's fitness on the card (the
    kernel path, tiles merged by the Chan combine) against the CPU's (the
    whole dataset in one pass) within 1e-4 absolute, +inf at the same
    trees -> max |difference|."""
    got = GPSession.from_dataset("kat7", pop_size=100, kernel=kernel)
    want = GPSession.from_dataset("kat7", pop_size=100, kernel=kernel, device="cpu")
    for s in (got, want):
        s.init(key=prng.PRNGKey(0))
        s.step()
    g, w = got.state.fitness.cpu().numpy(), want.state.fitness.numpy()
    if not np.array_equal(np.isposinf(g), np.isposinf(w)) or np.isnan(g).any():
        raise AssertionError(f"kat7 {kernel}: +inf fitness sets differ")
    ok = np.isfinite(w)
    np.testing.assert_allclose(g[ok], w[ok], rtol=1e-4 if kernel == "r2" else 0.0,
                               atol=1e-4, err_msg=f"kat7 {kernel} first generation")
    return float(np.abs(g[ok] - w[ok]).max(initial=0.0))


def two_pass_paths():
    """Phase 6b -> {label: run}: kat7 at full width (P = 100, depth 5, F =
    9, D = 10,000, CLASSIFY_SET), 30 generations each, under pearson on
    the heap path (B1), on postfix genomes with dedup off (B2) and exact
    at caps 1,400 (the table + B3) and 6,301 (the table + B4), and under
    r2 on the heap path: each history finite and non-increasing, no
    synchronisation in a block, the exact runs' histories equal to the
    dedup-off run's bit for bit. Then the dyadic lattice sessions card
    against CPU bit for bit, and kat7's first generation card against CPU
    within 1e-4."""
    runs = {}
    for label, kw, expect, overflow in TWO_PASS_RUNS:
        run = run_dataset("kat7", 100, 30, 0, block_check=label == "pearson_heap",
                          expect=expect, overflow=overflow, **kw)
        runs[label] = run
        emit("two_pass_path", run=label, **run)
    off = np.asarray(runs["pearson_off"]["history"], np.float32)
    for label in ("pearson_exact_cap1400", "pearson_exact_cap6301"):
        if not np.array_equal(np.asarray(runs[label]["history"], np.float32), off):
            raise AssertionError(f"{label}: history differs from dedup off")
    emit("two_pass_vs_cpu",
         lattice={k: _dyadic_lattice(k) for k in TWO_PASS},
         kat7_first_generation_max_abs_err={k: _first_generation_vs_cpu(k) for k in TWO_PASS},
         checks="lattice histories and last fitness vectors card == CPU bitwise; kat7 "
                "first generation within 1e-4")
    return runs


# --- phase 7: the island model ---------------------------------------------------

ISLAND_MIXES = ((0.10, 0.10, 0.10, 0.70), (0.05, 0.05, 0.05, 0.85),  # Table 2; crossover-
                (0.10, 0.30, 0.30, 0.30), (0.30, 0.10, 0.10, 0.50))  # mutation-, reproduction-heavy
ISLAND_P, ISLAND_I = 200, 4
SCRATCH = Path(__file__).resolve().parent / "build" / "chip_smoke"


def _island_kw(**kw):
    """kat7 island options: 4 islands x 200 trees, ring migration every 3
    generations of 2 elites, the reference island bench's mixes and
    tournament sizes (benchmarks/smoke_bench.py, bench_islands)."""
    from repro_torch.core.evolve import OperatorMix

    return {"pop_size": ISLAND_P, "islands": ISLAND_I, "migrate_every": 3, "migrate_k": 2,
            "island_mixes": tuple(OperatorMix(*m) for m in ISLAND_MIXES),
            "island_tourn_sizes": (4, 7, 10, 13), **kw}


def _island_run(gens, expect, block_check=False, **kw):
    """Drive a kat7 island session for `gens` generations on the card,
    the launch counts set to 0 just before and read just after: each
    kernel of `expect` ({name: launches}) must have launched exactly
    that often, every other kernel not at all. Returns (the state after
    the run, its per-island history, the run's record)."""
    sess = GPSession.from_dataset("kat7", generations=gens, **_island_kw(**kw))
    assert sess.backend == "cuda", sess.backend
    sess.init(key=prng.PRNGKey(0))
    torch.cuda.synchronize()
    gp_eval.reset_launches()
    t0 = time.perf_counter()
    sess.evolve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in gp_eval.launches.items() if v}
    if launches != expect:
        raise AssertionError(f"islands {kw}: launches {launches}, want {expect}")
    hist = np.asarray(sess.history, np.float32)
    isl = np.asarray(sess.island_history, np.float32)
    rows = np.asarray(sess.counter_history)
    due = [(g % 3 == 2) * ISLAND_I for g in range(gens)]
    if not (np.isfinite(isl).all() and (np.diff(isl, axis=0) <= 0).all()
            and isl.shape == (gens, ISLAND_I) and np.array_equal(hist, isl.min(axis=1))
            and np.array_equal(rows[:, counters.MIGRATIONS], due)):
        raise AssertionError(f"islands {kw}: history {isl.tolist()}, counter rows "
                             f"{rows.tolist()}")
    out = dict(options=kw, islands=ISLAND_I, pop=ISLAND_P,
               generations=gens, launches=launches, wall_s=wall, gens_per_s=gens / wall,
               tree_rows_per_s=sess.stats["tree_row_evals"] / wall,
               host_syncs=sess.stats["host_syncs"], migrations=sess.stats["migrations"],
               best_fitness=float(hist[-1]), island_best=isl[-1].tolist(),
               best=sess.best_expression(), history=hist.tolist())
    state = tuple(t.clone() for t in sess.state)
    if block_check:
        syncs = sess.stats["host_syncs"]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            sess.evolve_block(3)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        assert sess.stats["host_syncs"] == syncs
        out["sync_debug_block"] = "no synchronisation in a 3-generation island block"
    return state, sess.island_history, out


def _island_resume(main_state):
    """10 generations with checkpoints every 5 and a Tracer, then a new
    session resuming from the checkpoint for 10 more: its state must
    equal the uninterrupted 20-generation run's bit for bit, and the
    Tracer's JSON must validate and hold the session's spans."""
    from repro_torch.obs import Tracer, validate_trace

    ck = SCRATCH / "ck"
    tracer = Tracer(str(SCRATCH / "trace.json"))
    kw = _island_kw(checkpoint_dir=str(ck), checkpoint_every=5, tracer=tracer)
    first = GPSession.from_dataset("kat7", **kw)
    first.init(key=prng.PRNGKey(0))
    first.evolve(10)
    second = GPSession.from_dataset("kat7", **kw)
    second.init(key=prng.PRNGKey(0))
    if second.generation != 10:
        raise AssertionError(f"resumed at generation {second.generation}, want 10")
    second.evolve(10)
    for name, a, b in zip(engine.GPState._fields, second.state, main_state):
        if not torch.equal(a, b):
            raise AssertionError(f"resumed run's GPState.{name} differs from the "
                                 f"uninterrupted run's")
    payload = json.load(open(tracer.save()))
    problems = validate_trace(payload)
    names = {e["name"] for e in payload["traceEvents"] if e.get("ph") == "B"}
    if problems or not {"ingest", "init", "block", "checkpoint"} <= names:
        raise AssertionError(f"trace: {problems}, spans {sorted(names)}")
    return dict(saved_steps=first._manager.saved_steps + second._manager.saved_steps,
                trace_events=len(payload["traceEvents"]), spans=sorted(names),
                check="10 + 10 generations from a checkpoint == 20 uninterrupted, bitwise")


def _island_cli():
    """`python -m repro_torch.launch.evolve` at 4 x 200 on kat7, twice on
    one checkpoint directory: the second run must resume."""
    ck = SCRATCH / "cli_ck"
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent / "src"))
    outs = []
    for gens in (3, 5):
        cmd = [sys.executable, "-m", "repro_torch.launch.evolve", "--dataset", "kat7",
               "--islands", "4", "--pop", "200", "--generations", str(gens),
               "--migrate-every", "3", "--migrate-k", "2", "--ckpt-dir", str(ck),
               "--ckpt-every", "3", "--archive-every", "3",
               "--metrics", str(SCRATCH / "cli_metrics.jsonl")]
        proc = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=300)
        if proc.returncode != 0:
            raise AssertionError(f"evolve CLI failed:\n{proc.stdout}\n{proc.stderr}")
        outs.append(proc.stdout)
    if "resumed" in outs[0] or "resumed from generation 3" not in outs[1]:
        raise AssertionError(f"evolve CLI resume: {outs}")
    return [o.strip().splitlines()[-3:] for o in outs]


def island_paths():
    """Phase 7 -> {label: run}."""
    shutil.rmtree(SCRATCH, ignore_errors=True)
    SCRATCH.mkdir(parents=True)
    runs = {}
    main_state, main_isl, runs["ring"] = _island_run(20, {"eval_fitness": 20},
                                                     block_check=True)
    cpu = GPSession.from_dataset("kat7", generations=3, device="cpu", **_island_kw())
    cpu.init(key=prng.PRNGKey(0))
    cpu.evolve()
    card_isl = np.asarray(runs["ring"]["history"][:3], np.float32)
    if not (np.array_equal(card_isl, np.asarray(cpu.history, np.float32)) and np.array_equal(
            np.asarray(cpu.island_history), np.asarray(main_isl[:3]))):
        raise AssertionError(f"island card vs CPU: {main_isl[:3]} vs {cpu.island_history}")
    runs["ring"]["cpu_bitwise_generations"] = 3
    emit("islands", run="ring", **runs["ring"])
    for topology in ("torus", "broadcast-best"):
        *_, runs[topology] = _island_run(5, {"eval_fitness": 5}, island_topology=topology)
        emit("islands", run=topology, **runs[topology])
    cap = ISLAND_I * ISLAND_P * 63 + 1
    *_, runs["postfix_off"] = _island_run(5, {"eval_fitness_postfix": 5}, genome="postfix",
                                          dedup="off")
    *_, runs["postfix_exact"] = _island_run(
        5, {"eval_fitness_postfix": 5, "unique_table": 5, "eval_fitness_from_preds": 5},
        genome="postfix", dedup_cap=cap)
    if runs["postfix_exact"]["history"] != runs["postfix_off"]["history"]:
        raise AssertionError("postfix islands: dedup exact history differs from off")
    for label in ("postfix_off", "postfix_exact"):
        emit("islands", run=label, **runs[label])
    emit("islands_resume", **_island_resume(main_state))
    emit("islands_cli", tail=_island_cli())
    shutil.rmtree(SCRATCH, ignore_errors=True)
    return runs


# --- phase 8: streaming chunked fitness and the scalar baseline -------------------

STREAM_ROWS, STREAM_CHUNK = 5_500_000, 262_144  # the paper's largest dataset
STREAM_KERNELS = ("mse", "m", "pearson")


def _n_chunks():
    return -(-STREAM_ROWS // STREAM_CHUNK)  # 21, the last with 257,120 real rows


def _mono_bytes():
    return STREAM_ROWS * (8 + 1 + 1) * 4  # X + y + weight of the 5.5M rows on the card
KAT7_CHUNK = 4_096  # kat7's 10,000 rows: 3 chunks, 1,808 real rows in the last


def _stream_source():
    from repro_torch.data.datasets import stream_rows

    return stream_rows(rows=STREAM_ROWS, feats=8, seed=0)


def _fitness_vs(got, want, tag, exact):
    """Generation 0's fitness vectors: bitwise when `exact`, else the same
    non-finite pattern and rtol 1e-4 on the finite entries; a miss names
    each tree and its two values. -> max relative difference."""
    g, w = got.cpu().numpy(), want.cpu().numpy()
    if exact:
        if not np.array_equal(g, w, equal_nan=True):
            bad = np.nonzero(g != w)[0]
            raise AssertionError(f"{tag}: trees {bad.tolist()} differ: "
                                 f"{g[bad].tolist()} vs {w[bad].tolist()}")
        return 0.0
    if not np.array_equal(np.isfinite(g), np.isfinite(w)):
        bad = np.nonzero(np.isfinite(g) != np.isfinite(w))[0]
        raise AssertionError(f"{tag}: non-finite pattern differs at trees {bad.tolist()}: "
                             f"{g[bad].tolist()} vs {w[bad].tolist()}")
    ok = np.isfinite(w)
    rel = np.abs(g[ok] - w[ok]) / np.maximum(np.abs(w[ok]), 1e-30)
    bad = np.nonzero(~np.isclose(g[ok], w[ok], rtol=1e-4, atol=0.0))[0]
    if len(bad):
        idx = np.nonzero(ok)[0][bad]
        raise AssertionError(f"{tag}: trees {idx.tolist()} miss rtol 1e-4: "
                             f"{g[idx].tolist()} vs {w[idx].tolist()}")
    return float(rel.max(initial=0.0))


def _fold_vs_plain(cfg, op, arg, ds, fit0, kernel):
    """B1 against its plain version at the stream's own shapes: generation
    0's population folded over the same 21 chunks (D = 262,144 a launch,
    256 data tiles, the ragged zero-weight tail) by the cuda backend and
    by the plain tiled oracle on the card. The cuda fold must be bitwise
    the session's generation 0 (the same launches); the plain fold
    bitwise under m, else rtol 1e-4 with the same non-finite pattern.
    These launches are outside every counted run."""
    out = {}
    folds = {}
    for impl in ("cuda", "torch"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        folds[impl] = engine.chunked_fitness(cfg, op, arg, ds, impl=impl)
        torch.cuda.synchronize()
        out[f"{impl}_fold_s"] = time.perf_counter() - t0
    _fitness_vs(folds["cuda"], fit0, f"stream {kernel}: cuda fold vs the session", exact=True)
    out["max_rel_vs_plain"] = _fitness_vs(folds["cuda"], folds["torch"],
                                          f"stream {kernel}: B1 fold vs plain fold",
                                          exact=kernel == "m")
    return out


def _stream_scale(kernel, mono_rows):
    """Phase 8.1-8.3 under one fitness kernel: the 5.5M-row stream in 21
    chunks through GPSession on the card (init, one step, evolve(3)),
    B1 exactly once a chunk a generation and no other kernel, peak memory
    of the streamed evolve(3) below the monolithic dataset's, generation
    0 against B1's plain version folded over the same chunks and against
    the same rows ingested whole."""
    s = GPSession(pop_size=100, kernel=kernel)
    assert s.backend == "cuda", s.backend
    s.ingest(stream=_stream_source(), chunk_rows=STREAM_CHUNK)
    s.init(key=prng.PRNGKey(0))
    op0, arg0 = s.state.op.clone(), s.state.arg.clone()
    torch.cuda.synchronize()
    gp_eval.reset_launches()
    t0 = time.perf_counter()
    s.step()
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    n = _n_chunks()
    if s.n_rows != STREAM_ROWS or s._stream.n_chunks != n:
        raise AssertionError(f"stream {kernel}: n_rows {s.n_rows}, chunks {s._stream.n_chunks}")
    fit0 = s.state.fitness.clone()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    s.evolve(3)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {k: v for k, v in gp_eval.launches.items() if v}
    if launches != {"eval_fitness": n * 4}:
        raise AssertionError(f"stream {kernel}: launches {launches}, want eval_fitness "
                             f"{n * 4} ({n} chunks x 4 generations)")
    if peak >= _mono_bytes():
        raise AssertionError(f"stream {kernel}: peak {peak} bytes >= the monolithic "
                             f"dataset's {_mono_bytes()}")
    hist = np.asarray(s.history, np.float32)
    if not (np.isfinite(hist).all() and (np.diff(hist) <= 0).all()):
        raise AssertionError(f"stream {kernel}: history {hist.tolist()}")
    plain = _fold_vs_plain(s.config, op0, arg0, s._stream, fit0, kernel)
    del s, op0, arg0
    m = GPSession(pop_size=100, kernel=kernel)
    t0 = time.perf_counter()
    m.ingest(*mono_rows)
    m.init(key=prng.PRNGKey(0))
    m.step()
    torch.cuda.synchronize()
    mono_step_s = time.perf_counter() - t0
    rel = _fitness_vs(fit0, m.state.fitness, f"stream vs monolithic {kernel}",
                      exact=kernel == "m")
    t0 = time.perf_counter()
    m.evolve(3)
    torch.cuda.synchronize()
    mono_wall = time.perf_counter() - t0
    del m
    torch.cuda.empty_cache()
    return dict(kernel=kernel, rows=STREAM_ROWS, chunk_rows=STREAM_CHUNK, chunks=n,
                launches=launches, generations=4, first_step_s=step_s,
                evolve3_wall_s=wall, gens_per_s=3 / wall, mono_ingest_step_s=mono_step_s,
                mono_evolve3_wall_s=mono_wall, mono_gens_per_s=3 / mono_wall,
                peak_bytes=peak, allocated_before_bytes=base, mono_dataset_bytes=_mono_bytes(),
                gen0_max_rel_vs_monolithic=rel, gen0_max_rel_vs_plain=plain["max_rel_vs_plain"],
                b1_fold_s=plain["cuda_fold_s"], plain_fold_s=plain["torch_fold_s"],
                history=hist.tolist(),
                check="B1 once a chunk a generation; peak below the monolithic dataset; "
                      + ("gen 0 bitwise B1's plain fold and the monolithic run"
                         if kernel == "m" else "gen 0 within rtol 1e-4 of B1's plain fold "
                         "and of the monolithic run"))


def _device_events(prof):
    """The device's own events (kernels, copies, memsets) of a
    torch.profiler window."""
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def _busy_us(dev):
    """Device busy time in us: the union of the device events' intervals
    (a sum of self device time over `key_averages()` also counts a kernel
    under the CPU op that launched it)."""
    busy, end = 0.0, -math.inf
    for lo, hi in sorted((e.time_range.start, e.time_range.end) for e in dev):
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    return busy


def _trace_window(s, windows=3):
    """Profile one streamed generation of session `s` until the trace is
    complete: every B1 launch the wrapper counted and every kernel,
    copy and memset call the runtime made is recorded on the device
    (the tracer may drop events). Up to `windows` tries -> (device events
    of the last window, wall s, complete, B1 launches, runtime calls,
    windows, the window's self device time summed over `key_averages()`
    in us, the way earlier figures were taken, which may count a kernel
    under its CPU op too)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    runtime_calls = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpy", "cudaMemset")
    for window in range(1, windows + 1):
        torch.cuda.synchronize()
        gp_eval.reset_launches()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            s.step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = gp_eval.launches["eval_fitness"]
        events = prof.events()
        dev = _device_events(prof)
        calls = sum(1 for e in events if e.device_type == DeviceType.CPU
                    and e.name.startswith(runtime_calls))
        b1 = sum(1 for e in dev if "eval_partial_kernel" in e.name)
        complete = b1 == launches and len(dev) >= calls
        if complete:
            break
    summed = sum(getattr(e, "self_device_time_total", None)
                 or getattr(e, "self_cuda_time_total", 0.0) for e in prof.key_averages())
    return dev, wall, complete, launches, calls, window, summed


def _stream_split():
    """Where a streamed generation's time goes at 5.5M rows (kernel mse):
    the host's chunk preparation (one pass of the callable source:
    RandomState draws, re-chunking, transpose, padding), the copies of
    the chunks to the card, and one profiled generation (B1's device
    time a chunk, device busy time as the union of the device events'
    intervals, idle share). When no window recorded every launch, the
    busy time is a lower bound and the idle share an upper bound
    (`trace_complete` false)."""
    from repro_torch.data.loader import ChunkedDataset

    ds = ChunkedDataset(_stream_source(), chunk_rows=STREAM_CHUNK)
    t0 = time.perf_counter()
    chunks = list(ds)
    prep_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for X, y, w in chunks:
        for a in (X, y, w):
            torch.from_numpy(a).to(DEV)
    torch.cuda.synchronize()
    copy_s = time.perf_counter() - t0
    del chunks
    s = GPSession(pop_size=100, kernel="mse")
    s.ingest(stream=_stream_source(), chunk_rows=STREAM_CHUNK).init(key=prng.PRNGKey(0))
    s.step()
    dev, wall, complete, launches, calls, windows, summed = _trace_window(s)
    busy = _busy_us(dev)
    b1 = [e.time_range.elapsed_us() for e in dev if "eval_partial_kernel" in e.name]
    htod = [e.time_range.elapsed_us() for e in dev if "Memcpy HtoD" in e.name]
    return dict(host_chunk_prep_ms_per_gen=1e3 * prep_s, copy_ms_per_gen=1e3 * copy_s,
                copy_bytes_per_gen=_n_chunks() * STREAM_CHUNK * 10 * 4,
                profiled_wall_ms_per_gen=1e3 * wall, device_busy_ms_per_gen=busy / 1e3,
                idle_share=1 - busy / (1e6 * wall),
                summed_self_device_ms_per_gen=summed / 1e3, trace_complete=complete, profiler_windows=windows,
                b1_launches=launches, b1_recorded_calls=len(b1),
                runtime_calls=calls, device_events_recorded=len(dev),
                b1_device_ms_per_chunk=(sum(b1) / len(b1) / 1e3) if b1 else None,
                htod_recorded=len(htod), htod_device_ms_per_gen=sum(htod) / 1e3,
                b1_share_of_wall=sum(b1) / (1e6 * wall))


def _stream_kat7(main_history):
    """Phase 8.4-8.6 at kat7 in chunks of 4,096 rows (3 chunks, the last
    with 1,808 real rows) under kernel c: heap (10 generations), postfix
    (5) and 4 x 200 islands (3), each bitwise with the CPU's streamed run,
    the heap one also with the card's monolithic run; the kernel (B1 or
    B2) once a chunk a generation and no other kernel."""
    runs = {}
    for label, kw, gens, name in (("heap", {"pop_size": 100}, 10, "eval_fitness"),
                                  ("postfix", {"pop_size": 100, "genome": "postfix"}, 5,
                                   "eval_fitness_postfix"),
                                  ("islands", _island_kw(), 3, "eval_fitness")):
        sess = GPSession.from_dataset("kat7", chunk_rows=KAT7_CHUNK, **kw)
        sess.init(key=prng.PRNGKey(0))
        torch.cuda.synchronize()
        gp_eval.reset_launches()
        t0 = time.perf_counter()
        sess.evolve(gens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in gp_eval.launches.items() if v}
        if launches != {name: 3 * gens}:
            raise AssertionError(f"kat7 stream {label}: launches {launches}, want "
                                 f"{name} {3 * gens}")
        cpu = GPSession.from_dataset("kat7", chunk_rows=KAT7_CHUNK, device="cpu", **kw)
        cpu.init(key=prng.PRNGKey(0))
        cpu.evolve(gens)
        if cpu.backend != "torch" or cpu.history != sess.history or (
                label == "islands" and not np.array_equal(np.asarray(cpu.island_history),
                                                          np.asarray(sess.island_history))):
            raise AssertionError(f"kat7 stream {label}: card {sess.history} vs CPU "
                                 f"{cpu.history}")
        runs[label] = dict(options={k: v for k, v in kw.items() if k != "island_mixes"},
                           chunk_rows=KAT7_CHUNK, chunks=sess._stream.n_chunks,
                           generations=gens, launches=launches, wall_s=wall,
                           gens_per_s=gens / wall, host_syncs=sess.stats["host_syncs"],
                           history=sess.history, cpu_bitwise_generations=gens)
    mono = main_history
    if mono is None:
        m = GPSession.from_dataset("kat7", pop_size=100)
        m.init(key=prng.PRNGKey(0))
        m.evolve(10)
        mono = m.history
    if list(np.asarray(mono[:10], np.float32)) != list(np.asarray(runs["heap"]["history"],
                                                                  np.float32)):
        raise AssertionError(f"kat7 stream vs monolithic: {runs['heap']['history']} vs "
                             f"{mono[:10]}")
    runs["heap"]["monolithic_bitwise_generations"] = 10
    return runs


def _scalar_lattice_chunks():
    """The scalar backend chunked (rows of 16 in chunks of 6) against
    unchunked under mse on an integer lattice, where every sum is exact:
    5 generations bit for bit on the card."""
    rng = np.random.RandomState(5)
    X = rng.randint(-2, 3, size=(16, 3)).astype(np.float32)
    y = rng.randint(-2, 3, size=16).astype(np.float32)
    kw = dict(pop_size=16, kernel="mse", max_depth=3, p_const=0.0, fn_set="add,sub,mul",
              backend="scalar")
    whole = GPSession(**kw).fit(X, y, generations=5, key=prng.PRNGKey(1))
    chunked = GPSession(chunk_rows=6, **kw).fit(X, y, generations=5, key=prng.PRNGKey(1))
    if chunked.history != whole.history or not torch.equal(chunked.state.op, whole.state.op):
        raise AssertionError(f"scalar lattice: chunked {chunked.history} vs {whole.history}")
    return whole.history


def _scalar_baseline():
    """Phase 8.7: the paper's 1-CPU_SP baseline (backend="scalar") on
    kepler, pop 50, 5 generations, driven from the card: evaluation reads
    the population to the host, breeding runs on the card. Its history
    must equal the device="cpu" run's bit for bit; generation 0's fitness
    must be within rtol 1e-5 of the cuda backend's (tests/test_gp_api.py's
    bound); one counted host sync a generation. In 3 chunks of 4 rows
    under mse the real-valued sums merge in another order, so generation
    0 is held within rtol 1e-5 there, and bitwise on an integer lattice."""
    out = {}
    runs = {}
    for dev in ("cuda", "cpu"):
        s = GPSession.from_dataset("kepler", pop_size=50, backend="scalar", device=dev)
        s.init(key=prng.PRNGKey(0))
        t0 = time.perf_counter()
        s.step()
        fit0 = s.state.fitness.cpu().clone()
        s.evolve(4)
        runs[dev] = (s, fit0, time.perf_counter() - t0)
    (card, fit0, wall), (cpu, cpu_fit0, _) = runs["cuda"], runs["cpu"]
    if card.history != cpu.history or not torch.equal(fit0, cpu_fit0):
        raise AssertionError(f"scalar card {card.history} vs CPU {cpu.history}")
    if card.stats["host_syncs"] != 4 or card.state.op.device.type != DEV.type:
        raise AssertionError(f"scalar on the card: {card.stats['host_syncs']} syncs")
    vec = GPSession.from_dataset("kepler", pop_size=50)
    vec.init(key=prng.PRNGKey(0))
    vec.step()
    g, w = fit0.numpy(), vec.state.fitness.cpu().numpy()
    np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w))
    ok = np.isfinite(w)
    np.testing.assert_allclose(g[ok], w[ok], rtol=1e-5, atol=1e-4,
                               err_msg="scalar vs cuda backend, generation 0")
    out.update(history=card.history, wall_s=wall, gens_per_s=5 / wall,
               host_syncs=card.stats["host_syncs"],
               gen0_max_abs_vs_cuda=float(np.abs(g[ok] - w[ok]).max(initial=0.0)))
    fits = []
    for kw in ({}, {"chunk_rows": 4}):
        s = GPSession.from_dataset("kepler", pop_size=50, backend="scalar", kernel="mse", **kw)
        s.init(key=prng.PRNGKey(0))
        s.step()
        fits.append(s.state.fitness)
    out["mse_chunked_gen0_max_rel"] = _fitness_vs(fits[1], fits[0], "scalar kepler chunked",
                                                  exact=False)
    out["lattice_chunked_history"] = _scalar_lattice_chunks()
    return out


def stream_paths(main_history=None):
    """Phase 8 -> (runs, figures). `main_history` is phase 3's monolithic
    kat7 history on the card (None: run 10 generations of it here)."""
    t_phase = time.perf_counter()
    blocks = list(_stream_source()())
    mono_rows = (np.concatenate([b[0] for b in blocks]), np.concatenate([b[1] for b in blocks]))
    del blocks
    scale = {}
    for kernel in STREAM_KERNELS:
        scale[kernel] = _stream_scale(kernel, mono_rows)
        emit("stream_scale", **scale[kernel])
    del mono_rows
    split = _stream_split()
    emit("stream_split", **split)
    kat7 = _stream_kat7(main_history)
    for label, run in kat7.items():
        emit("stream_kat7", run=label, **run)
    scalar = _scalar_baseline()
    emit("scalar_baseline", **scalar)
    figures = dict(
        nvidia_smi=card_line(),
        stream_gens_per_s={k: v["gens_per_s"] for k, v in scale.items()},
        monolithic_gens_per_s={k: v["mono_gens_per_s"] for k, v in scale.items()},
        peak_mb={k: v["peak_bytes"] / 1e6 for k, v in scale.items()},
        monolithic_dataset_mb=_mono_bytes() / 1e6,
        evolve3_wall_s={k: v["evolve3_wall_s"] for k, v in scale.items()},
        **{k: split[k] for k in ("host_chunk_prep_ms_per_gen", "copy_ms_per_gen",
                                 "b1_device_ms_per_chunk", "idle_share", "trace_complete",
                                 "profiled_wall_ms_per_gen", "device_busy_ms_per_gen")},
        kat7_stream_gens_per_s={k: v["gens_per_s"] for k, v in kat7.items()},
        scalar_gens_per_s=scalar["gens_per_s"],
        phase_s=time.perf_counter() - t_phase)
    emit("stream_figures", **figures)
    return {"scale": scale, "kat7": kat7}, figures


PROFILED = (("heap", {}), ("postfix_off", {"genome": "postfix", "dedup": "off"}),
            ("postfix_exact_cap100", {"genome": "postfix"}),
            ("postfix_exact_cap6301", {"genome": "postfix", "dedup_cap": 6301}),
            ("postfix_semantic", {"genome": "postfix", "dedup": "semantic"}),
            ("heap_pearson", {"kernel": "pearson"}),
            ("postfix_exact_cap6301_pearson", {"genome": "postfix", "dedup_cap": 6301,
                                               "kernel": "pearson"}),
            ("islands_4x200", "islands"))
_OUR_KERNELS = ("eval_partial_kernel", "postfix_partial_kernel", "from_subtrees_kernel",
                "from_preds_kernel", "unique_table_kernel", "postfix_predict_kernel")


def profile_main_path():
    """`--profile`: where a generation spends its time, on the heap main
    path and on the postfix paths (dedup off, exact with the default cap,
    exact with cap 6,301, semantic), then on the heap and cap-6,301 paths
    under pearson, then on the island path (4 x 200 trees). Times 3 warm
    kat7 generations of each with torch.profiler (CPU + CUDA activities)
    and prints the device busy time, the CUDA launches, the port's
    kernels' device time and the busiest device ops. The island path must
    make at most 1.25x the heap path's CUDA launches a generation."""
    from torch.profiler import ProfilerActivity, profile

    per_gen = {}
    for label, kw in PROFILED:
        kw = _island_kw() if kw == "islands" else {"pop_size": 100, **kw}
        sess = GPSession.from_dataset("kat7", generations=3, **kw)
        sess.init(key=prng.PRNGKey(0))
        sess.evolve(2)  # warm: kernel library loaded, device tables made
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            sess.evolve(3)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = prof.key_averages()
        stale = [e.key for e in events if "merge_tiles" in e.key]
        if stale:
            raise AssertionError(f"{label}: the profiler recorded {stale}; every port "
                                 f"kernel merges its tiles inside one launch")

        def dev_us(e):
            return getattr(e, "self_device_time_total", None) or getattr(
                e, "self_cuda_time_total", 0.0)

        kernels = [e for e in events if dev_us(e) > 0]
        launches = sum(e.count for e in events if "LaunchKernel" in e.key)
        mine = [e for e in kernels if any(k in e.key for k in _OUR_KERNELS)]
        ours = sum(dev_us(e) for e in mine)
        dev = _device_events(prof)
        busy = _busy_us(dev)
        top = sorted(events, key=lambda e: e.count, reverse=True)[:12]
        per_gen[label] = launches / 3
        emit("profile", path=label, dataset="kat7", generations=3,
             trees=kw["pop_size"] * kw.get("islands", 1),
             wall_ms_per_gen=1e3 * wall / 3, device_busy_ms_per_gen=busy / 3e3,
             idle_share=1 - busy / (1e6 * wall), cuda_launches_per_gen=launches / 3,
             device_events_recorded_per_gen=len(dev) / 3,
             port_kernels_ms_per_gen=ours / 3e3,
             port_kernels=[(next(k for k in _OUR_KERNELS if k in e.key), e.count / 3,
                            dev_us(e) / 3e3) for e in mine],
             top_ops_by_count=[(e.key, e.count // 3, dev_us(e) / 3e3) for e in top])
    ratio = per_gen["islands_4x200"] / per_gen["heap"]
    emit("profile_islands_vs_heap", cuda_launches_per_gen_islands=per_gen["islands_4x200"],
         cuda_launches_per_gen_heap=per_gen["heap"], ratio=ratio)
    if ratio > 1.25:
        raise AssertionError(f"the island path makes {ratio:.3f}x the heap path's CUDA "
                             f"launches a generation (at most 1.25x)")


# the kernels whose call is one CUDA launch of one kernel at every shape
ONE_LAUNCH = {"eval_fitness": "eval_partial_kernel",
              "eval_fitness_postfix": "postfix_partial_kernel",
              "eval_fitness_from_subtrees": "from_subtrees_kernel",
              "eval_fitness_from_preds": "from_preds_kernel",
              "unique_table": "unique_table_kernel",
              "predict_postfix": "postfix_predict_kernel"}


def _one_launch(row, tag):
    """Each kernel of ONE_LAUNCH made one CUDA launch per timed call (the
    host-side count under the profiler), and the profiler recorded only
    its own kernel: no call ends with a second, merging kernel."""
    for name, kernel in ONE_LAUNCH.items():
        got = row[name]
        if got["cuda_launches_per_call"] != 1.0 or got["device_kernels"] not in ([], [kernel]):
            raise AssertionError(f"{tag} {name}: {got['cuda_launches_per_call']} CUDA launches "
                                 f"per call of {got['device_kernels']}; want one "
                                 f"{kernel}")


def _ptxas_lines():
    """ptxas -v's lines for each kernel: name, registers, shared memory,
    spills."""
    return [ln.strip() for ln in build.BUILD_INFO["gp_eval"]["ptxas"].splitlines()
            if any(k in ln for k in ("registers", "Compiling", "spill"))]


# registers of the one-moment (r/c/m/mse) kernels as built before the
# two-pass overloads were added (ptxas -v): B1/B2 by <S, V>, B3/B4 by <V>
ONE_MOMENT_REGISTERS = {(8, 4): 57, (12, 4): 73, (8, 2): 48, (12, 2): 55, (8, 1): 32, (12, 1): 39,
                  (16,): 64, (8,): 48, (4,): 32, (2,): 32, (1,): 32}


def _registers():
    """{kernel<template args, two-pass flag>: registers} from ptxas -v, and
    whether every one-moment instantiation kept its ONE_MOMENT_REGISTERS
    count."""
    import re

    regs, entry = {}, None
    for ln in build.BUILD_INFO["gp_eval"]["ptxas"].splitlines():
        m = re.search(r"Compiling entry function '.*?\d+([a-z_]+_kernel)I(\w*?)EEv", ln)
        if m:
            entry = (m.group(1), tuple(int(v) for v in re.findall(r"Li(\d+)E", m.group(2))),
                     "Lb1E" in m.group(2))
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and entry is not None:
            regs[entry] = int(m.group(1))
            entry = None
    b1_b4 = {ONE_LAUNCH[k] for k in FITNESS_KERNELS}
    fitness = {k: v for k, v in regs.items() if k[0] in b1_b4}
    same = all(v == ONE_MOMENT_REGISTERS.get(k[1]) for k, v in fitness.items() if not k[2])
    return {f"{n}<{','.join(map(str, t))}>{' two-pass' if two else ''}": v
            for (n, t, two), v in sorted(fitness.items())}, same and bool(fitness)


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
    registers, unchanged = _registers()
    emit("card", nvidia_smi=card, torch=torch.__version__, cuda=torch.version.cuda,
         name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         build_s=build_s, ptxas=_ptxas_lines(), registers=registers,
         one_moment_registers_unchanged=unchanged)

    parent = sys.argv[sys.argv.index("--parent") + 1] if "--parent" in sys.argv else None
    before = parent_phase2(parent) if parent else None
    perf, max_err, max_rel = kernel_vs_plain()
    if parent:
        ab_lines("parent, before", before, perf)
        ab_lines("parent, after", parent_phase2(parent), perf)
    two_timed, _, two_errs = two_pass_kernels()
    table_modes()
    points_per_thread()
    many_trees()

    main_run = run_dataset("kat7", 100, 30, 10, block_check=True)
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

    runs = postfix_paths()
    two_runs = two_pass_paths()
    isl_runs = island_paths()
    stream_runs, _ = stream_paths(main_run["history"])
    # the streaming path's launches: B1 in the 5.5M-row mse run, B2 in kat7's
    # postfix run; no other kernel is on it
    stream_paths_of = {"eval_fitness": stream_runs["scale"]["mse"],
                       "eval_fitness_postfix": stream_runs["kat7"]["postfix"]}
    # the island path's launches (4 x 200 trees), from the run whose work
    # each kernel does there; B3 and the probe are not on it
    isl_paths = {"eval_fitness": "ring", "eval_fitness_postfix": "postfix_off",
                 "eval_fitness_from_preds": "postfix_exact",
                 "unique_table": "postfix_exact"}
    # each kernel's launches come from the path whose work it does
    paths = {"eval_fitness": main_run, "eval_fitness_postfix": runs["off"],
             "eval_fitness_from_subtrees": runs["exact_cap1400"],
             "eval_fitness_from_preds": runs["exact_cap6301"],
             "unique_table": runs["exact_cap6301"], "predict_postfix": runs["semantic"]}
    replaces = {"eval_fitness": "src/repro/kernels/gp_eval.py:423",
                "eval_fitness_postfix": "src/repro/kernels/gp_eval.py:227",
                "eval_fitness_from_subtrees": "src/repro/kernels/gp_eval.py:308",
                "eval_fitness_from_preds": "src/repro/kernels/gp_eval.py:377",
                "unique_table": "src/repro/core/eval.py:248",
                "predict_postfix": "src/repro/core/eval.py:79"}
    main = perf[("kat7", "c")]
    library = perf[("kat7", "r")]  # B4's yardstick sums kernel r's |pred - y|
    # under pearson and r2 (B1-B4 only; the table and the probe carry no
    # fitness kernel): launches on that kernel's session paths (r2 drives
    # the heap path only), and phase 2b's numbers at kat7
    two_paths = {"pearson": {"eval_fitness": "pearson_heap",
                             "eval_fitness_postfix": "pearson_off",
                             "eval_fitness_from_subtrees": "pearson_exact_cap1400",
                             "eval_fitness_from_preds": "pearson_exact_cap6301"},
                 "r2": {"eval_fitness": "r2_heap"}}

    def two_pass_fields(name):
        if name not in FITNESS_KERNELS:
            return {k: None for k in TWO_PASS}
        out = {}
        for k in TWO_PASS:
            run = two_paths[k].get(name)
            t = two_timed[name][k]
            out[k] = {"launches": two_runs[run]["launches"][name] if run else None,
                      "max_abs_err": two_errs[k][name][0],
                      "max_rel_err": two_errs[k][name][1], "ms": t["ms"],
                      "device_ms": t["device_ms"], "plain_ms": t["plain_ms"],
                      "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                      "library_ms": None}
        return out

    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gp_eval.cu",
        "replaces": replaces[name],
        "launches": paths[name]["launches"][name],
        "max_abs_err": max_err["kat7", name],
        **({"max_rel_err": max_rel} if name == "eval_fitness" else {}),
        "ms": main[name]["ms"], "device_ms": main[name]["device_ms"],
        "plain_ms": main[name]["plain_ms"],
        "bound_ms": main[name]["bound_ms"], "bound_by": main[name]["bound_by"],
        "library_ms": library[name]["library_ms"],
        "island_launches": (isl_runs[isl_paths[name]]["launches"][name]
                            if name in isl_paths else 0),
        "island_generations": (isl_runs[isl_paths[name]]["generations"]
                               if name in isl_paths else None),
        "stream_launches": (stream_paths_of[name]["launches"][name]
                            if name in stream_paths_of else 0),
        "stream_generations": (stream_paths_of[name]["generations"]
                               if name in stream_paths_of else None),
        **two_pass_fields(name)}
        for name in gp_eval.KERNELS]}),
        flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
