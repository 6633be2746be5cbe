"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from `src/repro_torch/kernels/csrc/`,
holds each against its plain PyTorch version on the card, drives the
port's paths (`GPSession` with its defaults: heap trees of depth 5, one
device, elite cache, K-generation blocks; then postfix genomes with and
without subexpression dedup; then the two-pass fitness kernels pearson
and r2 on those paths; the island model; streaming at the paper's 5.5M
rows and the scalar baseline; the multi-tenant service; the mesh, in one
process and one process a card; LM serving and training of the model
zoo) through the
user's entry points, and checks the
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
     `merge_tiles_kernel` is left), the plain version's time (kernel c), the bound
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
  6. postfix kat7 at full width, 10 generations each: dedup="exact" with
     the default cap (100: the table overflows and B2 does the work), with
     dedup="off" (B2), dedup_cap=1400 (B3) and dedup_cap=6301 (B4), then
     dedup="semantic" (cap 100, and the probe kernel); per-kernel
     launches and the dedup counters of each run, each generation's
     counter row showing the branch it took (the table overflowed in
     every generation of the cap-100 runs and in none of the others),
     its first 2 generations bitwise equal to the CPU's, the exact/off
     histories equal to each other, no synchronisation in a block
  6b. kat7 at full width under pearson, 10 generations each: the heap path
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
     torch.cuda.set_sync_debug_mode("error"), the first 2 generations'
     history and per-island history bitwise equal to the CPU's; torus
     and broadcast-best, 5 generations each; postfix islands with dedup
     exact at cap I·P·N + 1 = 50,401 (the table and B4, with B2 gated)
     equal to dedup off (B2) bit for bit; a checkpoint resume (10
     generations, then a new session +5) equal to the uninterrupted 10,
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
     (heap 5 generations, postfix 3 with B2, 4 x 200 islands 3), each
     bitwise with the CPU's streamed run and the heap run with phase 3's
     monolithic history; the scalar baseline (kepler, pop 50, 5
     generations) on the card bitwise its CPU run, within rtol 1e-5 of
     the cuda backend at generation 0, and chunked against unchunked
     (within rtol 1e-5 on kepler under mse, bitwise on an integer
     lattice); one JSON line of the phase's figures
  9. the multi-tenant service (`repro_torch.service.GPService` on the
     card): serve_gp's synthetic stream of 32 jobs (24-96 rows, 3
     features, kernels r/mse/pearson, 10-39 generations) through 64
     slots of 64 depth-5 trees in blocks of 8 generations: every job
     done, one tenant block built, B1 launched exactly slots x 8 x blocks
     times (empty and frozen slots are evaluated too) and no other
     kernel, one more block under torch.cuda.set_sync_debug_mode("error")
     and one generation under torch.profiler (its CUDA launches, device
     busy time and idle share);
     wall, blocks, tenant generations and jobs a second, peak memory;
     the shortest r, mse and pearson job of the first eight against the
     port's solo GPSession on the card
     on their slot buffers, bitwise; the CPU test's 8 lattice jobs through
     3 slots on the card and on the CPU, every handle bitwise; postfix
     depth 5, 4 slots, 8 jobs of 2-4 generations in blocks of 4 with
     dedup exact at cap 2,957 (B3) and
     4,033 (B4) and dedup off (B2), bitwise equal, the unique table and
     B3/B4 launched
  10. the mesh (`GPSession(topology=MeshTopology(...))`, one process; its
     shard -> device placement printed: 8 shards share one card, and take
     one card each where there are more): (a) kat7 4 x 200 islands with
     phase 7's options on (pod 2, data 2, model 2), 5 generations, B1
     exactly 8 launches a generation (one a shard) and no other kernel,
     one block under torch.cuda.set_sync_debug_mode("error"), the first
     generation's history and per-island history bitwise the same mesh's
     on the CPU, wall ms a generation and peak memory, and one profiled
     generation (CUDA launches, device busy time, idle share) beside the
     single-device 4 x 200 session's; (b) the classic layout, kat7 pop 100
     on the same mesh, 10 generations, the first 3 card == CPU bitwise; (c) each
     shard's kernel against the plain torch backend on the card at the
     mesh's shapes (B1 under c, r, mse and pearson; B2, and the table with
     B3 and B4, on (d)'s population; bitwise under c, rtol 1e-4 under
     r/mse, phase 2b's rule under pearson), and each data group's merged
     moments against one device's moments of the whole dataset; (d)
     postfix kat7 on (data 2, model 2) with dedup off (B2) and exact at
     caps 1,400 (the table + B3) and 6,301 (the table + B4), each kernel
     once a shard a generation, exact == off bitwise; (e) pearson on
     (data 4, model 2): kat7 finite and non-increasing, the dyadic
     lattice card == CPU; (f) kat7 in chunks of 4,096 rows on (data 2,
     model 2), card == CPU; (g) (a)'s state checkpointed and resharded
     onto (pod 4, data 2, model 1), bitwise, then 2 generations card ==
     CPU; (h) `python -m repro_torch.launch.evolve --mesh
     data=2,model=2,pod=2` as a subprocess
  11. LM serving on the card (`repro_torch.models`: prefill, then greedy
     decode over the KV/SSM cache; no Pallas kernel is on this path, so it
     adds no kernel to the `kernels` line): (a) the ten reduced configs in
     f32 (capacity factor 8), card against CPU from the same seeded
     weights, prefill and 4 decode steps within rtol/atol 1e-4, the MoE
     routing equal; (b) gemma-2b, mamba2-370m, granite-moe-3b-a800m and
     whisper-medium at their published widths and depths in f32:
     teacher-forced decode logits == the forward pass's within 2e-3 (B 1,
     12 tokens, a prefix of 4); (c) the same four in bf16: B 8, a
     1,024-token prompt (whisper: stub frames [8, 1500, 1024]), 16 greedy
     tokens, twice with the tokens bitwise equal; prefill ms, decode ms a
     token (median of the warm steps' CUDA events), tokens/s, peak MB,
     the bound (bf16 weights + the cache over 3.35 TB/s), and one profiled
     step (CUDA launches, device busy, idle share) and one step under
     torch.cuda.set_sync_debug_mode("error")
  12. LM training on the card (`forward_train`, `make_train_step`, the
     optimizers, `launch.train`; no Pallas kernel, no kernel added to the
     `kernels` line): (a) the ten reduced configs in f32, and gemma with
     accum_steps=2 at B 4, card against CPU from the same seeded weights:
     the loss, ce, aux, every gradient leaf, then one train step's params,
     optimizer state (jamba: Adafactor) and metrics, rtol 1e-4 / atol 1e-5
     (jamba's gradients atol 1e-4; a param whose first update is
     ill-conditioned at its gradient's tolerance carried through the
     update), the MoE routing equal; (b) gemma-2b, mamba2-370m and
     whisper-medium at B 4 x S 1,024 and granite-moe-3b-a800m at B 8 x S
     512 in its 4 micro-batches, bf16 at full width with the published
     optimizer: one warm and one timed step (CUDA events), tokens/s, peak
     MB beside the memory reckoning, one profiled step (CUDA launches,
     device busy, idle share) beside the bound, one step under
     set_sync_debug_mode("error"); (c) two runs of reduced granite and of
     gemma-2b at full width: the losses agree; (d) `python -m
     repro_torch.launch.train --arch gemma-2b --reduced --steps 30 --seq
     32`: the loss falls, and a run stopped at step 10 and resumed from
     its checkpoint continues the uninterrupted history
  13. the LM mesh on the one card (`launch.sharding`'s specs, the
     sharded train step of `launch.train.build`, tensor parallelism over
     the model axis (each model rank its own blocks, the ranks in turn)
     with the residual sequence-parallel between blocks (each rank its
     rows, where the sequence divides over the ranks),
     `moe_apply_sharded`, `launch.serving.cp_decode_attention`,
     `ckpt.elastic.reshard_state`; no Pallas kernel, no kernel added to
     the `kernels` line; each run's figures printed beside those before
     sequence parallelism under "prior"): (a) the ten
     reduced configs in f32 on (data 2, model 2), qwen3-moe and granite at
     capacity factor 1.0: one sharded train step card against CPU from the
     same seeded state, metrics, gradients, params and optimizer state as
     phase 12 (a) holds them, the MoE routing and kept entries equal; (b)
     gemma-2b at full width, bf16, B 4 x S 1,024 on (data 2, model 2): one
     warm and 2 timed steps (CUDA events), the first loss within 4e-3 of
     phase 12's single-device step, tokens/s, peak MB, each shard's state
     bytes reckoned from the specs (the parts add up to the single-device
     state plus the replicated leaves), one profiled step (CUDA launches,
     idle share) under set_sync_debug_mode("error"); (e) (b)'s state saved
     whole and resharded onto (data 4, model 1) bit for bit, then a step;
     (c) granite-moe-3b-a800m at full width, bf16, capacity factor 8: B 8,
     a 512-token prompt and 8 greedy tokens with the params on (data 2,
     model 2) and the cache split by `cache_specs`, every MoE call
     sharded, twice with the tokens bitwise equal, the same weights on one
     device fed the same tokens within 2e-3 in f32 (in bf16 the difference
     reported), peak MB; (d) `cp_decode_attention` at gemma-2b's
     attention dims, a 32,768-token cache on data 8, cur_len 0, 7,
     16,383, 16,384 and 32,767, against `attn_decode` (out 2e-5, cache
     1e-6); (f) the long-context decode: gemma-2b at full width, B 1, an
     8,192-token prompt (its prefill sequence-parallel) into a
     32,768-row cache whose sequence lies on the data axis (`cache_specs`
     with `seq_shard`) on (data 2, model 2), 8 greedy tokens in bf16,
     twice with the tokens bitwise equal; each decode step reads the
     cache's slices in place (no cache leaf joined: a join inside the
     cache's reads fails the phase) and merges the flash partials; the
     same weights on one device fed the same tokens within 2e-3 in f32
     (prefill and 2 decode steps); prefill ms, decode ms a token, peak MB
  14. the mesh over processes (`launch.cluster.init_cluster`, one process
     a card, NCCL): W = the smaller of 4 and the card count processes
     from multiprocessing's spawn, each given COORDINATOR_ADDRESS,
     NUM_PROCESSES and PROCESS_ID (on one card W = 1, a group of one:
     the line says `"multi_rank": false` and why); (a) phase 10 (a)'s
     islands, 5 generations: every process's history and per-island
     history bit for bit phase 10 (a)'s, B1 exactly once a local shard a
     generation and no other kernel, one block under
     set_sync_debug_mode("error"), wall ms a generation, each process's
     peak MB and one profiled generation; (b) postfix kat7 on (data 2,
     model 2) with dedup exact at cap 6,301 (B2's siblings, the table and
     B4 once a local shard a generation), 5 generations, bit for bit the
     same session in one process; (c) gemma-2b at full width in bf16, B 4
     x S 1,024 on (data 2, model 2), AdamW: the first loss bit for bit
     phase 13 (b)'s, step ms (CUDA events), tokens/s, each card's peak MB,
     one profiled step on process 0; (d) reduced gemma-2b's state after 2
     steps saved from the processes (process 0 writes) and restored here
     bit for bit every process's; (e) granite-moe-3b-a800m's sharded
     serve of phase 13 (c) (full width, bf16, capacity factor 8, B 8, a
     512-token prompt, 8 greedy tokens, one shard a process): every
     process's tokens and last logits bit for bit phase 13 (c)'s, prefill
     ms, decode ms a token, tokens/s, each card's peak MB, the bytes a
     process sent and received in a decode step, those its cache reads
     received apart (0: each model rank reads its own part, else the
     phase fails), CUDA launches and idle share of one profiled decode
     step on process 0; (f) granite's train step of phase 12 (b) (B 8 x S 512
     in 4 micro-batches, AdamW) on (data 2, model 2): every process's
     losses the same, the first bit for bit the same step in the parent
     process (phase 12 (b)'s one-device loss beside it),
     every expert FFN on E_loc = 20 experts, step ms after a warm step
     and tokens/s (on one card, where the step is the single
     controller's, only the first step, cold, as `cold_step_ms`), peak MB,
     one profiled step on process 0 where W > 1, one device's figures
     beside; (g)
     reduced granite in f32 (capacity factor 1.0, 2 micro-batches): 2
     train steps, prefill and 3 decode steps, every process's metrics,
     state digests and logits bit for bit the same run in this process;
     (h) `cp_decode_attention` at phase 13 (d)'s dims and cur_lens on
     data W: against `attn_decode` (out 2e-5, cache 1e-6), bit for bit
     the same calls in this process, the bytes a process sent in one
     layer (the partials' only); (i) phase 13 (f)'s long-context decode
     (bf16) over the processes: every process's tokens and last logits
     bit for bit phase 13 (f)'s, prefill ms, decode ms a token, peak MB,
     and in one more decode step the bytes a process sent and received
     (those its cache reads received apart: 0, else the phase fails). A
     process that fails fails the phase
  15. the dry run held against the card (`repro_torch.launch.dryrun`:
     the port's own code on `meta` tensors, as process r of a fake
     process group; no value computed, no byte moved). One child process
     (`--dryrun`, started after phase 11 and read here; CUDA is never
     initialized in it; a failed child fails the phase) runs: (a) phase
     13 (b)'s gemma-2b bf16 step (B 4 x S 1,024 on (data 2, model 2)) as
     the single controller: its argument bytes must equal the bytes
     phase 13 (b) placed on the card (its state's storages and one
     batch) exactly, and its argument + temp GB print beside that step's
     `max_memory_allocated`; (b) phase 10 (a)'s islands with the cuda
     backend on `meta`, one block of phase 10 (a)'s generations: its B1
     launches must equal phase 10 (a)'s count; (c) phase 14 (e)'s
     granite decode step as each rank of 4: with four processes in phase
     14 each process's bytes sent and received and its collectives must
     equal the dry run's of its rank, with one card they print with
     `"multi_rank": false`; (d) gemma-2b's train_4k cell on (data 16,
     model 16), rank 0: its record and trace_s; (e) phase 14 (i)'s long
     decode step (gemma-2b, B 1, a 32,768-row cache) as each rank of 4:
     its cache reads receive nothing, and with four processes each
     process's bytes sent and received and its collectives must equal
     the dry run's of its rank

Options:
  --parent DIR  also runs phase 2 of another tree of the repo (e.g. the
                parent commit, `git archive` unpacked into a directory
                that .gitignore lists) before and after this tree's, in
                a child process, and prints "ab" lines: every kernel's
                (B1-B4, the table, the probe) ms, device_ms and CUDA
                launches per call in both trees at every shape, beside
                the bound
  --lm-mesh     instead runs phase 10 (a) and phases 12-15 alone, with
                every check they make in the whole script: run on four
                cards, phase 13's single controller spreads its shards
                over the cards and phase 14 holds four processes (NCCL)
                bit for bit against it and each rank's bytes against
                phase 15's dry run; prints no kernels line
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
import tempfile
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
from repro_torch import configs as lm_configs  # noqa: E402
from repro_torch.gp import GPSession, MeshTopology  # noqa: E402
from repro_torch.kernels import build, gp_eval, ops  # noqa: E402
from repro_torch.models import convert as lm_convert  # noqa: E402
from repro_torch.models import model as lm_model  # noqa: E402
from repro_torch.models import moe as lm_moe  # noqa: E402
from repro_torch.models import transformer as lm_T  # noqa: E402
from repro_torch.obs import counters  # noqa: E402
from repro_torch.data import loader as lm_data  # noqa: E402
from repro_torch.launch import train as lm_train  # noqa: E402
from repro_torch.launch import dryrun as lm_dryrun  # noqa: E402
from repro_torch.launch import mesh as lm_mesh  # noqa: E402
from repro_torch.launch import serving as lm_serving  # noqa: E402
from repro_torch.launch import sharding as lm_SH  # noqa: E402
from repro_torch.ckpt.elastic import reshard_state as lm_reshard_state  # noqa: E402
from repro_torch.optim.adamw import for_config as lm_optimizer_for  # noqa: E402

lm_optim = sys.modules["repro_torch.optim.adamw"]  # the module, not the function

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12  # H100 SXM bf16 tensor cores, dense
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


def device_ms(fn, calls: int = 10, windows: int = 3) -> dict:
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
                # the plain versions take 0.04-13 s a call, 10^3-10^5 x the
                # kernels': timed on the main path's kernel c only, once
                # after the warm call at the large shape
                reps = (5 if P * D < 1e7 else 1) if kname == "c" else 0
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
                                          plain_ms=(time_ms(plain_fn, reps) if reps
                                                    else None),
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
                        row[k].update(ms=time_ms(card, 50), plain_ms=time_ms(plain, 5))
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
    (P = 100, depth 5, F = 9, D = 10,000, kernel c, CLASSIFY_SET), 10
    generations per run, the first 2 card == CPU bitwise (the plain
    postfix stack machine on the CPU takes seconds a generation). Every
    exact/off run's history must equal the dedup-off run's (dedup is
    bitwise); the semantic tier's is tolerance-pinned (rtol 1e-5 against
    dedup off)."""
    runs = {}
    for label, kw, expect, overflow in POSTFIX_RUNS:
        run = run_dataset("kat7", 100, 10, 2, block_check=True, expect=expect,
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
    9, D = 10,000, CLASSIFY_SET), 10 generations each, under pearson on
    the heap path (B1), on postfix genomes with dedup off (B2) and exact
    at caps 1,400 (the table + B3) and 6,301 (the table + B4), and under
    r2 on the heap path: each history finite and non-increasing, no
    synchronisation in a block, the exact runs' histories equal to the
    dedup-off run's bit for bit. Then the dyadic lattice sessions card
    against CPU bit for bit, and kat7's first generation card against CPU
    within 1e-4."""
    runs = {}
    for label, kw, expect, overflow in TWO_PASS_RUNS:
        run = run_dataset("kat7", 100, 10, 0, block_check=label == "pearson_heap",
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
    """5 generations with checkpoints every 5 and a Tracer, then a new
    session resuming from the checkpoint for 5 more: its state must
    equal the uninterrupted 10-generation run's bit for bit, and the
    Tracer's JSON must validate and hold the session's spans."""
    from repro_torch.obs import Tracer, validate_trace

    ck = SCRATCH / "ck"
    tracer = Tracer(str(SCRATCH / "trace.json"))
    kw = _island_kw(checkpoint_dir=str(ck), checkpoint_every=5, tracer=tracer)
    first = GPSession.from_dataset("kat7", **kw)
    first.init(key=prng.PRNGKey(0))
    first.evolve(5)
    second = GPSession.from_dataset("kat7", **kw)
    second.init(key=prng.PRNGKey(0))
    if second.generation != 5:
        raise AssertionError(f"resumed at generation {second.generation}, want 5")
    second.evolve(5)
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
                check="5 + 5 generations from a checkpoint == 10 uninterrupted, bitwise")


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
    main_state, main_isl, runs["ring"] = _island_run(10, {"eval_fitness": 10},
                                                     block_check=True)
    cpu = GPSession.from_dataset("kat7", generations=2, device="cpu", **_island_kw())
    cpu.init(key=prng.PRNGKey(0))
    cpu.evolve()
    card_isl = np.asarray(runs["ring"]["history"][:2], np.float32)
    if not (np.array_equal(card_isl, np.asarray(cpu.history, np.float32)) and np.array_equal(
            np.asarray(cpu.island_history), np.asarray(main_isl[:2]))):
        raise AssertionError(f"island card vs CPU: {main_isl[:2]} vs {cpu.island_history}")
    runs["ring"]["cpu_bitwise_generations"] = 2
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


def _trace_window(s, windows=2):
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
    with 1,808 real rows) under kernel c: heap (5 generations), postfix
    (3) and 4 x 200 islands (3), each bitwise with the CPU's streamed run,
    the heap one also with the card's monolithic run; the kernel (B1 or
    B2) once a chunk a generation and no other kernel."""
    runs = {}
    for label, kw, gens, name in (("heap", {"pop_size": 100}, 5, "eval_fitness"),
                                  ("postfix", {"pop_size": 100, "genome": "postfix"}, 3,
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
    if list(np.asarray(mono[:5], np.float32)) != list(np.asarray(runs["heap"]["history"],
                                                                 np.float32)):
        raise AssertionError(f"kat7 stream vs monolithic: {runs['heap']['history']} vs "
                             f"{mono[:5]}")
    runs["heap"]["monolithic_bitwise_generations"] = 5
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
    kat7 history on the card (None: run 10 generations of it here; the
    first 5 are compared)."""
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


# --- phase 9: the multi-tenant service --------------------------------------------

SVC_SLOTS, SVC_POP, SVC_BLOCK, SVC_CAP = 64, 64, 8, 128  # docs/service.md's regime
# the CPU test's lattice configuration (tests/test_torch_service.py)
LAT_POP, LAT_FEATS, LAT_CAP, LAT_TOURN = 16, 2, 32, 6
LAT_KERNELS = ("r", "c", "m", "mse")
LAT_MIXES = ((0.1, 0.1, 0.1, 0.7), (0.05, 0.05, 0.05, 0.85), (0.2, 0.2, 0.2, 0.4))


def _handle_record(h):
    return (h.status, h.gens_done, h.best_fitness, tuple(h.history), h.best_expression)


def _slots_vs_plain(svc, tag, modes=(("off", 0),), lattice=False):
    """Every slot of `svc`'s batch as it stands (state, operands, host
    table), under every kernel of the block, evaluated as the tenant
    block evaluates a slot (the slot's cuda config from
    `engine.tenant_configs`) and by the plain torch backend on the card,
    once for each (dedup, cap) of `modes`. One-moment kernels compare
    `engine._eval_fitness`: bitwise under c and m, and under every kernel
    on lattice data; else the same non-finite pattern and rtol 1e-4
    (real-valued sums are taken in another order). The two-pass kernels
    compare the backends' moments by phase 2b's rule
    (`_compare_two_pass`), and the block's fitness must be bitwise the
    cuda moments reduced: the torch backend's fitness takes the kernel's
    `partial_fitness`, which has no variance noise floor, so at a tree of
    constant predictions it reads 0.99868 where the moments reduce to 1.
    These launches are outside every counted run. -> {kernel: max rel
    diff}, plus the slots and modes checked."""
    from repro_torch.gp.backends import get_backend

    X, y, w, _ = svc.batch.operands()
    host = svc.batch.host_params()
    state = svc._state
    const_table = svc.tree_spec.const_table(state.op.device)
    worst = {}
    for dedup, cap in modes:
        for kid, kname in enumerate(svc.kernels):
            one = host._replace(kernel_id=np.full_like(host.kernel_id, kid))
            cfgs = {impl: engine.tenant_configs(svc.tree_spec, svc.kernels, one,
                                                eval_impl=impl, dedup=dedup, dedup_cap=cap)
                    for impl in ("cuda", "torch")}
            for i in range(state.op.shape[0]):
                where = f"{tag} slot {i}, {kname}, dedup {dedup} cap {cap}"
                operands = (state.op[i], state.arg[i], X[i], y[i], w[i], const_table)
                if kname in TWO_PASS:
                    moments = {}
                    for impl, cfg in ((k, c[i]) for k, c in cfgs.items()):
                        be = get_backend(impl)
                        moments[impl] = be.moments(
                            state.op[i], state.arg[i], X[i], y[i], const_table,
                            svc.tree_spec, cfg.fitness, weight=w[i],
                            data_tile=cfg.data_tile, **engine._dedup_kwargs(cfg, be.moments))
                    fitness = engine._eval_fitness(cfgs["cuda"][i], *operands)
                    _fitness_vs(fitness, torch.from_numpy(fit_reduce(kname, moments["cuda"])),
                                f"{where}: the block's fitness vs its moments", exact=True)
                    rel = _compare_two_pass(moments["cuda"], moments["torch"], kname,
                                            f"{where}: kernel vs plain moments")[1]
                else:
                    got, want = (engine._eval_fitness(cfgs[impl][i], *operands)
                                 for impl in ("cuda", "torch"))
                    rel = _fitness_vs(got, want, f"{where}: kernel vs plain",
                                      exact=lattice or kname in ("c", "m"))
                worst[kname] = max(worst.get(kname, 0.0), rel)
    return dict(max_rel_vs_plain=worst, slots=state.op.shape[0],
                modes=[f"{d}/{c}" for d, c in modes])


def _service_block_probe(svc, extra):
    """One more block of `svc` on a batch that holds live jobs (`extra`
    admitted first), outside the service's bookkeeping: first every
    slot against the plain version (`_slots_vs_plain`: B1 at the
    service's shape), then the block under
    torch.cuda.set_sync_debug_mode("error") (no host read inside a
    block), then one generation of the same step under torch.profiler
    (a one-step tenant block) -> {its CUDA launches (the runtime's
    kernel launches), wall ms, device busy ms (the union of its device
    events; the tracer may drop some: a lower bound then) and idle
    share}."""
    from torch.profiler import ProfilerActivity, profile

    for j in extra:
        svc.submit(j)
    svc._admit()
    vs_plain = _slots_vs_plain(svc, "service")
    X, y, w, params = svc.batch.operands()
    host = svc.batch.host_params()
    state = svc._state
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        svc._block(state, X, y, w, params, host)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    one_step = engine.build_tenant_block(svc.tree_spec, svc.kernels, svc.tourn_draw,
                                         svc.elitism, 1, eval_impl=svc.backend)
    one_step(state, X, y, w, params, host)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one_step(state, X, y, w, params, host)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = sum(e.count for e in prof.key_averages() if "LaunchKernel" in e.key)
    dev = _device_events(prof)
    busy = _busy_us(dev) / 1e3
    return dict(vs_plain=vs_plain, cuda_launches_per_block_generation=launches,
                profiled_generation_wall_ms=wall * 1e3, device_busy_ms=busy,
                idle_share=1 - busy / (wall * 1e3), device_events=len(dev),
                b1_device_events=sum(1 for e in dev if "eval_partial_kernel" in e.name))


def _service_scale():
    """(a) serve_gp's synthetic stream of 32 jobs through 64 slots of 64
    depth-5 trees (4,096 trees a block generation) on the card."""
    from repro_torch.launch.serve_gp import synthetic_stream
    from repro_torch.service import DONE, GPService

    jobs = synthetic_stream(32, seed=0)
    svc = GPService(slots=SVC_SLOTS, pop_size=SVC_POP, max_depth=5, n_features=3,
                    data_cap=SVC_CAP, block_size=SVC_BLOCK)
    assert svc.backend == "cuda", svc.backend
    handles = [svc.submit(j) for j in jobs]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gp_eval.reset_launches()
    t0 = time.perf_counter()
    svc.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in gp_eval.launches.items() if v}
    blocks = svc.stats["blocks"]
    want = {"eval_fitness": SVC_SLOTS * SVC_BLOCK * blocks}
    if launches != want:
        raise AssertionError(f"service: launches {launches}, want {want} (every slot, "
                             f"empty and frozen ones too, once a block generation)")
    if not all(h.status == DONE for h in handles) or svc.stats["compiles"] != 1:
        raise AssertionError(f"service: statuses {sorted({h.status for h in handles})}, "
                             f"compiles {svc.stats['compiles']}")
    for h in handles:
        hist = np.asarray(h.history, np.float32)
        if not (len(hist) == h.gens_done and (np.diff(hist) <= 0).all()
                and h.best_expression is not None):
            raise AssertionError(f"service: {h!r} history {hist.tolist()}")
    peak = torch.cuda.max_memory_allocated()
    probe = _service_block_probe(svc, synthetic_stream(8, seed=1))
    gens = sum(h.gens_done for h in handles)
    out = dict(jobs=len(jobs), slots=SVC_SLOTS, pop=SVC_POP, block_size=SVC_BLOCK,
               data_cap=SVC_CAP, trees_per_block_generation=SVC_SLOTS * SVC_POP,
               wall_s=wall, blocks=blocks, tenant_generations=gens,
               tenant_gens_per_s=gens / wall, jobs_per_s=len(jobs) / wall,
               peak_mb=peak / 1e6, **probe,
               launches=launches, host_syncs=svc.stats["host_syncs"],
               compiles=svc.stats["compiles"], admissions=svc.stats["admissions"],
               cache_hit_rate=svc.stats["cache_hit_rate"], frozen=svc.stats["frozen"],
               tree_evals=svc.stats["tree_evals"],
               sync_debug_block="no synchronisation in an 8-generation tenant block")
    return out, jobs[:8], handles[:8]


def _service_vs_solo(jobs, handles):
    """(b) of the jobs given, the shortest of each kernel (r, mse, pearson)
    against the port's solo GPSession on the card, on their slot buffers:
    generations, best fitness, history and champion bit for bit."""
    from repro_torch.service import slot_buffers

    shortest = {}
    for j, h in zip(jobs, handles):
        if j.kernel not in shortest or j.generations < shortest[j.kernel][0].generations:
            shortest[j.kernel] = (j, h)
    jobs = [j for j, _ in shortest.values()]
    for j, h in shortest.values():
        Xs, ys, ws = slot_buffers(j, 3, SVC_CAP)
        sess = GPSession(pop_size=SVC_POP, max_depth=5, kernel=j.kernel, mix=j.mix,
                         tourn_size=j.tourn_size, elitism=1, stop_fitness=j.stop_fitness,
                         generations=j.generations)
        assert sess.backend == "cuda", sess.backend
        sess.ingest(Xs.T, ys, sample_weight=ws)
        sess.init(key=prng.PRNGKey(j.seed))
        sess.evolve(j.generations)
        if (h.gens_done != sess.generation or h.best_fitness != float(sess.state.best_fitness)
                or h.history != sess.history or h.best_expression != sess.best_expression()):
            raise AssertionError(f"service vs solo {j.name}: {_handle_record(h)} vs "
                                 f"{sess.generation}, {sess.history}, {sess.best_expression()}")
    return [j.name for j in jobs]


def _lattice_jobs():
    """The CPU test's 8 lattice jobs (kernels r, c, m, mse; integer rows)."""
    from repro_torch.core.evolve import OperatorMix
    from repro_torch.service import JobSpec

    jobs = []
    for i in range(8):
        r = np.random.RandomState(100 + i)
        rows = 10 + 4 * (i % 5)
        X = r.randint(-2, 3, size=(rows, LAT_FEATS)).astype(np.float32)
        k = LAT_KERNELS[i % 4]
        y = (np.clip(X[:, 0] * X[:, 1], 0, 2) if k == "c" else
             X[:, 0] * X[:, 1] - X[:, 1] + r.randint(-1, 2, size=rows)).astype(np.float32)
        jobs.append(JobSpec(X, y, kernel=k, mix=OperatorMix(*LAT_MIXES[i % 3]),
                            tourn_size=3 + i % 4, point_rate=(0.25, 0.5, 0.1)[i % 3],
                            n_classes=3, precision=(1e-4, 0.5)[i % 2],
                            stop_fitness=0.0 if i % 4 == 1 else None,
                            generations=4 + i % 5, seed=i, name=f"lat-{i}"))
    return jobs


def _service_card_vs_cpu():
    """(c) the CPU test's 8-job, 3-slot lattice configuration on the card
    and on the CPU: every handle bitwise equal; then B1 bitwise its plain
    version on the card's final batch. -> (jobs, `_slots_vs_plain`)"""
    from repro_torch.service import GPService

    spec = trees.TreeSpec(max_depth=3, n_features=LAT_FEATS, p_const=0.0,
                          fn_set=prim.FunctionSet.make(("add", "sub", "mul")))
    runs = {}
    for dev in ("cuda", "cpu"):
        svc = GPService(slots=3, pop_size=LAT_POP, tree_spec=spec, n_features=LAT_FEATS,
                        data_cap=LAT_CAP, kernels=LAT_KERNELS, tourn_draw=LAT_TOURN,
                        block_size=3, device=dev)
        handles = [svc.submit(j) for j in _lattice_jobs()]
        svc.run()
        runs[dev] = [_handle_record(h) for h in handles]
        if dev == "cuda":  # the last jobs' evolved populations and lattice rows
            vs_plain = _slots_vs_plain(svc, "service lattice", lattice=True)
    if runs["cuda"] != runs["cpu"]:
        raise AssertionError(f"service card vs CPU: {runs['cuda']} vs {runs['cpu']}")
    return len(runs["cuda"]), vs_plain


def _service_postfix():
    """(d) postfix depth 5, 4 slots, 8 jobs of 2-4 generations in blocks
    of 4: dedup exact at a cap that
    keeps B3 (2,957, the largest the reference's rule allows here), at
    one that spills to B4 (P·N + 1 = 4,033: never overflows) and dedup
    off; the three runs bitwise equal; then every slot of the last batch
    against the plain version under the three settings ->
    ({label: (launches, block generations)}, `_slots_vs_plain`)."""
    from repro_torch.launch.serve_gp import synthetic_stream
    from repro_torch.service import GPService

    jobs = [dataclasses.replace(j, generations=2 + i % 3)
            for i, j in enumerate(synthetic_stream(8, seed=2))]
    spec = trees.TreeSpec(max_depth=5, n_features=3, genome="postfix")
    cap_b4 = SVC_POP * spec.num_nodes + 1
    assert ops._tpu_dedup_fits(3, spec.stack_size, SVC_CAP, 2957)
    assert not ops._tpu_dedup_fits(3, spec.stack_size, SVC_CAP, 2958)
    runs, records = {}, {}
    for label, kw, must in (
            ("off", {"dedup": "off"}, {"eval_fitness_postfix"}),
            ("exact_b3", {"dedup": "exact", "dedup_cap": 2957},
             {"eval_fitness_postfix", "unique_table", "eval_fitness_from_subtrees"}),
            ("exact_b4", {"dedup": "exact", "dedup_cap": cap_b4},
             {"eval_fitness_postfix", "unique_table", "eval_fitness_from_preds"})):
        svc = GPService(slots=4, pop_size=SVC_POP, tree_spec=spec, data_cap=SVC_CAP,
                        block_size=4, **kw)
        handles = [svc.submit(j) for j in jobs]
        torch.cuda.synchronize()
        gp_eval.reset_launches()
        svc.run()
        torch.cuda.synchronize()
        launches = {k: v for k, v in gp_eval.launches.items() if v}
        if set(launches) != must:
            raise AssertionError(f"service postfix {label}: launches {launches}, "
                                 f"want {sorted(must)}")
        runs[label] = dict(launches=launches,
                           block_generations=svc.stats["blocks"] * svc.block_size)
        records[label] = [_handle_record(h) for h in handles]
    if not records["off"] == records["exact_b3"] == records["exact_b4"]:
        raise AssertionError("service postfix: dedup exact differs from off")
    # B2, and the unique table with B3 or B4, against the plain version on
    # the last batch's evolved populations, under each of the three settings
    vs_plain = _slots_vs_plain(svc, "service postfix",
                               modes=(("off", 0), ("exact", 2957), ("exact", cap_b4)))
    return runs, vs_plain


def service_paths():
    """Phase 9 -> (figures, {kernel: (launches, block generations)})."""
    t_phase = time.perf_counter()
    timings = {}

    def timed(label, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        timings[label] = time.perf_counter() - t0
        return out

    scale, jobs, handles = timed("scale_s", _service_scale)
    emit("service_scale", **scale)
    emit("service_vs_solo", jobs=timed("vs_solo_s", _service_vs_solo, jobs, handles),
         check="packed == the port's solo GPSession on the card, bitwise")
    n_lat, lat_plain = timed("card_vs_cpu_s", _service_card_vs_cpu)
    emit("service_card_vs_cpu", jobs=n_lat, vs_plain=lat_plain,
         check="lattice jobs through 3 slots: card == CPU, every handle bitwise; "
               "B1 == plain on the final batch, bitwise")
    postfix, postfix_plain = timed("postfix_s", _service_postfix)
    emit("service_postfix", runs=postfix, vs_plain=postfix_plain,
         check="dedup exact (B3 and B4 caps) == off, bitwise; every slot's B2/B3/B4 "
               "against plain under the three settings")
    # each kernel's launches on the service path, from the run whose work it does
    service_of = {"eval_fitness": (scale["launches"]["eval_fitness"],
                                   scale["blocks"] * SVC_BLOCK)}
    for name, run in (("eval_fitness_postfix", "off"),
                      ("eval_fitness_from_subtrees", "exact_b3"),
                      ("eval_fitness_from_preds", "exact_b4"), ("unique_table", "exact_b4")):
        service_of[name] = (postfix[run]["launches"][name],
                            postfix[run]["block_generations"])
    figures = dict(nvidia_smi=card_line(), **{k: scale[k] for k in (
        "wall_s", "blocks", "tenant_gens_per_s", "jobs_per_s",
        "cuda_launches_per_block_generation", "peak_mb", "profiled_generation_wall_ms",
        "device_busy_ms", "idle_share")}, **timings,
        phase_s=time.perf_counter() - t_phase)
    emit("service_figures", **figures)
    return figures, service_of


# --- phase 10: the mesh -----------------------------------------------------------

MESH3 = {"data": 2, "model": 2, "pod": 2}
_B2_TABLE = ("eval_fitness_postfix", "unique_table")
MESH_POSTFIX = (  # (label, session options, kernels launched once a shard a generation)
    ("off", {"dedup": "off"}, ("eval_fitness_postfix",)),
    ("exact_cap1400", {"dedup_cap": 1400}, _B2_TABLE + ("eval_fitness_from_subtrees",)),
    ("exact_cap6301", {"dedup_cap": 6301}, _B2_TABLE + ("eval_fitness_from_preds",)),
)


def _placement(mesh):
    """Shard -> device, as 'pod0/data1/model0 -> cuda:0'."""
    return [f"{'/'.join(f'{a}{r}' for a, r in mesh.coords(s).items())} -> {d}"
            for s, d in enumerate(mesh.devices)]


def _mesh_run(sess, gens, expect, tag):
    """Drive `sess` for `gens` generations on the card, the launch counts
    set to 0 just before and read just after: each kernel of `expect`
    ({name: launches}) must have launched exactly that often, every other
    kernel not at all -> (wall s, peak memory bytes, launches). Over
    several processes (phase 14) they start the clock together."""
    sess.init(key=prng.PRNGKey(0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gp_eval.reset_launches()
    if torch.distributed.is_initialized():
        torch.distributed.barrier()
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    sess.evolve(gens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in gp_eval.launches.items() if v}
    if launches != expect:
        raise AssertionError(f"mesh {tag}: launches {launches}, want {expect}")
    hist = np.asarray(sess.history, np.float32)
    if not (np.isfinite(hist).all() and (np.diff(hist) <= 0).all()):
        raise AssertionError(f"mesh {tag}: best fitness not finite/non-increasing: {hist}")
    return wall, torch.cuda.max_memory_allocated(), launches


def _vs_cpu(card, gens, tag, **kw):
    """The same session on a mesh of the CPU: the first `gens` generations'
    history (and per-island history) must equal the card's bit for bit."""
    cpu = GPSession.from_dataset("kat7", device="cpu", **kw)
    cpu.init(key=prng.PRNGKey(0))
    cpu.evolve(gens)
    same = cpu.history == card.history[:gens] and np.array_equal(
        np.asarray(cpu.island_history), np.asarray(card.island_history[:gens]))
    if cpu.backend != "torch" or not same:
        raise AssertionError(f"mesh {tag}: card {card.history[:gens]} vs CPU {cpu.history}")
    return gens


def _profiled_generation(sess):
    """One block generation of `sess` under torch.profiler -> {CUDA
    launches (the runtime's kernel launches), wall ms, device busy ms
    (the union of its device events), idle share}."""
    from torch.profiler import ProfilerActivity, profile

    sess.evolve_block(1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sess.evolve_block(1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = _busy_us(_device_events(prof)) / 1e3
    return dict(cuda_launches=sum(e.count for e in prof.key_averages()
                                  if "LaunchKernel" in e.key),
                wall_ms=wall * 1e3, device_busy_ms=busy, idle_share=1 - busy / (wall * 1e3))


def _mesh_islands(gens=5):
    """(a) kat7 4 x 200 islands (phase 7's options) on (pod 2, data 2,
    model 2): B1 exactly 8 launches a generation (one a shard) and no other
    kernel, one block under set_sync_debug_mode("error"), the first
    generation card == CPU bitwise; a profiled generation beside the
    single-device 4 x 200 session's."""
    top = MeshTopology(**MESH3)
    sess = GPSession.from_dataset("kat7", topology=top, **_island_kw())
    mesh = sess.mesh
    cards = torch.cuda.device_count()
    if sess.backend != "cuda" or len(set(mesh.devices)) != min(cards, mesh.size):
        raise AssertionError(f"mesh on {cards} cards: {_placement(mesh)}, {sess.backend}")
    wall, peak, launches = _mesh_run(sess, gens, {"eval_fitness": 8 * gens}, "islands")
    isl = np.asarray(sess.island_history, np.float32)
    rows = np.asarray(sess.counter_history)
    due = [(g % 3 == 2) * ISLAND_I for g in range(gens)]
    if not ((np.diff(isl, axis=0) <= 0).all() and isl.shape == (gens, ISLAND_I)
            and np.array_equal(rows[:, counters.MIGRATIONS], due)):
        raise AssertionError(f"mesh islands: {isl.tolist()}, counter rows {rows.tolist()}")
    out = dict(placement=_placement(mesh), generations=gens, launches=launches,
               wall_s=wall, gens_per_s=gens / wall, wall_ms_per_generation=wall / gens * 1e3,
               peak_memory_bytes=peak, host_syncs=sess.stats["host_syncs"],
               history=sess.history, island_best=isl[-1].tolist(),
               island_history=isl.tolist(),
               cpu_bitwise_generations=_vs_cpu(sess, 1, "islands", topology=top,
                                               **_island_kw()))
    saved = engine.GPState(*(t.clone() for t in sess.state))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sess.evolve_block(3)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    out["sync_debug_block"] = "no synchronisation in a 3-generation mesh block"
    out["profiled_generation"] = _profiled_generation(sess)
    solo = GPSession.from_dataset("kat7", **_island_kw())
    solo.init(key=prng.PRNGKey(0))
    out["single_device_profiled_generation"] = _profiled_generation(solo)
    return sess, saved, out


def _mesh_classic(gens=10):
    """(b) the classic layout, kat7 pop 100 on (pod 2, data 2, model 2):
    B1 8 launches a generation, the pod ring's migrations in the counter
    rows, the first 2 generations card == CPU bitwise."""
    top = MeshTopology(**MESH3)
    sess = GPSession.from_dataset("kat7", pop_size=100, topology=top)
    wall, _, launches = _mesh_run(sess, gens, {"eval_fitness": 8 * gens}, "classic")
    rows = np.asarray(sess.counter_history)
    if not np.array_equal(rows[:, counters.MIGRATIONS], [(g % 10 == 9) * 2 for g in range(gens)]):
        raise AssertionError(f"mesh classic: counter rows {rows.tolist()}")
    return dict(generations=gens, launches=launches, wall_s=wall, history=sess.history,
                cpu_bitwise_generations=_vs_cpu(sess, 2, "classic", pop_size=100,
                                                topology=top))


def _shard_moments(cfg, mesh, states, X, y, w, impl, rows=None, **kw):
    """Each shard's moments as the mesh step takes them (`_eval_moments`)
    under backend `impl` (the kernels, or the plain torch backend, on the
    card)."""
    cfg = dataclasses.replace(cfg, eval_impl=impl, **kw)
    N = cfg.tree_spec.num_nodes
    return [engine._eval_moments(cfg, t.op.reshape(-1, N), t.arg.reshape(-1, N), X[s], y[s],
                                 w[s], cfg.tree_spec.const_table(mesh.devices[s]))
            for s, t in enumerate(states)]


def _hold(got, want, kname, tag):
    """Moments of a kernel against the plain version's: bitwise under c,
    rtol 1e-4 under r and mse (`_compare`), phase 2b's rule under pearson
    -> max relative error."""
    if kname in TWO_PASS:
        return _compare_two_pass(got, want, kname, tag)[1]
    return _compare(got, want, kname, False, tag)[1]


def _mesh_shards_vs_plain(islands, postfix):
    """(c) each shard's kernel against the plain torch backend on the card
    at the mesh's shapes: B1 on (a)'s 8 shards (2 islands x 100 trees x
    5,000 rows each) under c, r, mse and pearson, and each data group's
    merged moments against one device's moments of the whole dataset;
    B2, and the table with B3 (cap 1,400) and B4 (cap 6,301), on (d)'s
    4 shards of 50 postfix trees under c. Launches here count for no
    path."""
    from repro_torch.ckpt.elastic import gp_state_specs
    from repro_torch.launch.mesh import P

    worst = {}
    for sess, cases in ((islands, [(k, {}) for k in ("c", "r", "mse", "pearson")]),
                        (postfix, [("c", {"dedup": "off"}), ("c", {"dedup_cap": 1400}),
                                   ("c", {"dedup_cap": 6301})])):
        cfg, mesh = sess.config, sess.mesh
        states = engine._split_state(mesh, sess.state,
                                     gp_state_specs(cfg, mesh, pod_axis=sess._pod_axis()))
        X, y, w = sess._X, sess._y, sess._weight
        for kname, kw in cases:
            fs = fit.FitnessSpec(kname, n_classes=cfg.fitness.n_classes)
            tag = f"mesh shards {cfg.tree_spec.genome} {kname} {kw}"
            gp_eval.reset_launches()
            got = _shard_moments(cfg, mesh, states, X, y, w, "cuda", fitness=fs, **kw)
            ran = {k for k, v in gp_eval.launches.items() if v}
            want = _shard_moments(cfg, mesh, states, X, y, w, "torch", fitness=fs, **kw)
            err = max(_hold(g, t, kname, f"{tag} shard {s}")
                      for s, (g, t) in enumerate(zip(got, want)))
            kern = fit.get_kernel(kname)
            Xw, yw, ww = (mesh.join(X, P(None, "data")), mesh.join(y, P("data")),
                          mesh.join(w, P("data")))
            N = cfg.tree_spec.num_nodes
            for group in mesh.groups("data"):
                merged = engine._merge_moments_on_mesh(
                    kern, fs, [got[s] for s in group], [y[s] for s in group],
                    [w[s] for s in group])[0]
                t = states[group[0]]
                whole = engine._eval_moments(
                    dataclasses.replace(cfg, eval_impl="cuda", fitness=fs, **kw),
                    t.op.reshape(-1, N).to(Xw.device), t.arg.reshape(-1, N).to(Xw.device),
                    Xw, yw, ww, cfg.tree_spec.const_table(Xw.device))
                err = max(err, _hold(merged, whole, kname, f"{tag} merged, group {group}"))
            worst[f"{cfg.tree_spec.genome}/{kname}/{kw}"] = dict(max_rel_err=err,
                                                                 kernels=sorted(ran))
    return worst


def _mesh_postfix(gens=3):
    """(d) postfix kat7 pop 100 on (data 2, model 2): dedup off (B2) and
    exact at caps 1,400 (the table + B3) and 6,301 (the table + B4), each
    kernel once a shard a generation; the exact histories equal the off
    one bit for bit."""
    runs, last = {}, None
    for label, kw, names in MESH_POSTFIX:
        sess = GPSession.from_dataset("kat7", pop_size=100, genome="postfix",
                                      topology=MeshTopology(data=2, model=2), **kw)
        wall, _, launches = _mesh_run(sess, gens, {n: 4 * gens for n in names},
                                      f"postfix {label}")
        runs[label] = dict(generations=gens, launches=launches, wall_s=wall,
                           history=sess.history)
        last = sess
    for label in ("exact_cap1400", "exact_cap6301"):
        if runs[label]["history"] != runs["off"]["history"]:
            raise AssertionError(f"mesh postfix {label}: history differs from dedup off")
    return last, runs


def _mesh_pearson(gens=5):
    """(e) pearson on (data 4, model 2): kat7 finite and non-increasing (B1
    8 launches a generation), and the dyadic lattice card == CPU."""
    top = MeshTopology(data=4, model=2)
    sess = GPSession.from_dataset("kat7", pop_size=100, kernel="pearson", topology=top)
    wall, _, launches = _mesh_run(sess, gens, {"eval_fitness": 8 * gens}, "pearson")
    rng = np.random.RandomState(11)
    X = rng.randint(-1, 2, size=(16, 3)).astype(np.float32)
    y = (X[:, 0] - X[:, 1] + rng.randint(-1, 2, size=16)).astype(np.float32)
    kw = dict(pop_size=16, generations=8, kernel="pearson", max_depth=2, p_const=0.0,
              fn_set="add,sub")
    card = GPSession(topology=top, **kw).fit(X, y, key=prng.PRNGKey(4))
    cpu = GPSession(device="cpu", topology=top, **kw).fit(X, y, key=prng.PRNGKey(4))
    if card.history != cpu.history or not torch.equal(card.state.fitness.cpu(),
                                                       cpu.state.fitness):
        raise AssertionError(f"mesh pearson lattice: card {card.history} vs {cpu.history}")
    return dict(generations=gens, launches=launches, wall_s=wall, history=sess.history,
                lattice_history=card.history, lattice_cpu_bitwise=True)


def _mesh_stream(gens=3):
    """(f) kat7 in chunks of 4,096 rows on (data 2, model 2): each chunk
    split over the data axis (B1 once a data shard a chunk: 6 a
    generation), card == CPU bitwise."""
    kw = dict(pop_size=100, chunk_rows=KAT7_CHUNK, topology=MeshTopology(data=2, model=2))
    sess = GPSession.from_dataset("kat7", **kw)
    wall, peak, launches = _mesh_run(sess, gens, {"eval_fitness": 6 * gens}, "stream")
    return dict(generations=gens, launches=launches, wall_s=wall, peak_memory_bytes=peak,
                history=sess.history, cpu_bitwise_generations=_vs_cpu(sess, gens, "stream",
                                                                       **kw))


def _mesh_reshard(saved, cfg, gens=2):
    """(g) (a)'s state checkpointed and resumed on (pod 4, data 2, model 1)
    through `reshard_gp_state`: every leaf bitwise, then `gens` more
    generations card == CPU bitwise."""
    from repro_torch.ckpt import checkpoint as ck
    from repro_torch.ckpt.elastic import reshard_gp_state

    shutil.rmtree(SCRATCH, ignore_errors=True)
    SCRATCH.mkdir(parents=True)
    ck.save(saved, str(SCRATCH / "mesh_ck"), 20)
    back = ck.restore(str(SCRATCH / "mesh_ck"), 20, like=saved)
    top = MeshTopology(data=2, model=1, pod=4)
    mesh_b = top.build()
    state_b = reshard_gp_state(back, cfg, mesh_b, pod_axis="pod")
    for name, a, b in zip(engine.GPState._fields, state_b, saved):
        if not torch.equal(a, b):
            raise AssertionError(f"resharded GPState.{name} differs")
    runs = []
    for device in (None, "cpu"):
        s = GPSession.from_dataset("kat7", topology=top.build(device), **_island_kw())
        s.adopt_state(engine.state_from_numpy(engine.state_to_numpy(state_b),
                                              device=s.device))
        s.evolve(gens)
        runs.append(s.history)
    shutil.rmtree(SCRATCH, ignore_errors=True)
    if runs[0] != runs[1]:
        raise AssertionError(f"resharded run: card {runs[0]} vs CPU {runs[1]}")
    return dict(placement=_placement(mesh_b), generations=gens, history=runs[0],
                cpu_bitwise_generations=gens)


def _mesh_cli():
    """(h) `python -m repro_torch.launch.evolve --mesh data=2,model=2,pod=2`
    at 4 x 200 on kat7, as a subprocess."""
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.evolve", "--dataset", "kat7",
           "--islands", "4", "--pop", "200", "--mesh", "data=2,model=2,pod=2",
           "--generations", "3", "--archive-every", "3"]
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=300)
    if proc.returncode != 0 or "[kat7] 3 generations" not in proc.stdout:
        raise AssertionError(f"evolve CLI --mesh failed:\n{proc.stdout}\n{proc.stderr}")
    return proc.stdout.strip().splitlines()[-2:]


def mesh_paths():
    """Phase 10 -> {label: run}, the runs whose launches the kernel line
    reports. Each emitted line carries its seconds, CPU halves included
    (`run_s`)."""
    t_phase = time.perf_counter()
    runs = {}

    def timed(fn, *a):
        t0 = time.perf_counter()
        return fn(*a), time.perf_counter() - t0

    (isl_sess, saved, runs["islands"]), dt = timed(_mesh_islands)
    emit("mesh", run="islands", run_s=dt, **runs["islands"])
    runs["classic"], dt = timed(_mesh_classic)
    emit("mesh", run="classic", run_s=dt, **runs["classic"])
    (post_sess, post), dt = timed(_mesh_postfix)
    runs.update({f"postfix_{k}": v for k, v in post.items()})
    emit("mesh", run="postfix", run_s=dt, **post)
    shards, dt = timed(_mesh_shards_vs_plain, isl_sess, post_sess)
    emit("mesh", run="shards_vs_plain", run_s=dt, **shards)
    runs["pearson"], dt = timed(_mesh_pearson)
    emit("mesh", run="pearson", run_s=dt, **runs["pearson"])
    runs["stream"], dt = timed(_mesh_stream)
    emit("mesh", run="stream", run_s=dt, **runs["stream"])
    reshard, dt = timed(_mesh_reshard, saved, isl_sess.config)
    emit("mesh", run="reshard", run_s=dt, **reshard)
    tail, dt = timed(_mesh_cli)
    emit("mesh", run="cli", run_s=dt, tail=tail, phase_s=time.perf_counter() - t_phase)
    return runs


# --- phase 11: LM serving on one card ---------------------------------------------

LM_F32 = dict(compute_dtype="float32", cache_dtype="float32", moe_capacity_factor=8.0)
LM_FULL = ("gemma-2b", "mamba2-370m", "granite-moe-3b-a800m", "whisper-medium")


def _lm_inputs(cfg, B, S, device, seed=0):
    """Prompt tokens (and whisper's stub frames, the VLM's stub patches)
    from a numpy seed, on `device`."""
    rng = np.random.RandomState(seed)
    batch = {"tokens": torch.as_tensor(rng.randint(0, cfg.vocab, (B, S)), dtype=torch.int32)}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(
            (rng.randn(B, cfg.n_memory, cfg.d_model) * 0.02).astype(np.float32))
    if cfg.family == "vlm":
        batch["memory"] = torch.from_numpy(
            (rng.randn(B, cfg.n_memory, cfg.d_model) * 0.02).astype(np.float32))
    return {k: v.to(device) for k, v in batch.items()}


def _record_routes():
    """Wrap `moe._route` to record each call's expert ids and kept entries
    (on the host) -> (the record list, a function that restores it)."""
    routes, original = [], lm_moe._route

    def wrapped(logits, top_k, C, E):
        out = original(logits, top_k, C, E)
        routes.append((out[2].cpu(), out[4].cpu()))
        return out

    lm_moe._route = wrapped
    return routes, lambda: setattr(lm_moe, "_route", original)


def _lm_run(cfg, params, batch, steps, feed=None, tensor_pos=False):
    """Prefill + `steps` decode steps, fed `feed`'s tokens (else greedy) ->
    ([(logits, cache) on the host after each call], the tokens fed, routes)."""
    routes, restore = _record_routes()
    try:
        S = batch["tokens"].shape[1]
        logits, cache = lm_model.prefill(cfg, params, batch, max_len=S + steps + 1)
        out = [(logits.cpu(), lm_convert.cache_to_numpy(cache))]
        fed = []
        for t in range(steps):
            tok = feed[t].to(logits.device) if feed else logits.argmax(-1).to(torch.int32)
            fed.append(tok.cpu())
            pos = torch.tensor(S + t, device=logits.device) if tensor_pos else S + t
            logits, cache = lm_model.decode_step(cfg, params, cache, tok, pos)
            out.append((logits.cpu(), lm_convert.cache_to_numpy(cache)))
    finally:
        restore()
    return out, fed, routes


def _lm_card_vs_cpu(steps=4):
    """(a) every reduced config in f32 (capacity factor 8): the same weights
    (made on the CPU from a seed, copied to the card), prefill logits and
    cache and `steps` decode steps (the CPU's greedy tokens fed to both;
    the card's position a 0-d device tensor) within rtol/atol 1e-4; the MoE
    routing (expert ids, kept entries) equal."""
    out = {}
    for name in lm_configs.all_arch_names():
        cfg = dataclasses.replace(lm_configs.get_reduced(name), **LM_F32)
        cpu_params = lm_model.init_params(cfg, 0, device="cpu")
        card_params = lm_model.init_params(cfg, 0, device="cpu").to(DEV)
        want, fed, want_routes = _lm_run(cfg, cpu_params, _lm_inputs(cfg, 2, 8, "cpu"), steps)
        got, _, got_routes = _lm_run(cfg, card_params, _lm_inputs(cfg, 2, 8, DEV), steps,
                                     feed=fed, tensor_pos=True)
        err = 0.0
        for i, ((gl, gc), (wl, wc)) in enumerate(zip(got, want)):
            np.testing.assert_allclose(gl.numpy(), wl.numpy(), rtol=1e-4, atol=1e-4,
                                       err_msg=f"lm card vs cpu {name} step {i} logits")
            err = max(err, float((gl - wl).abs().max()))
            for b in wc:
                for n in wc[b]:
                    np.testing.assert_allclose(gc[b][n], wc[b][n], rtol=1e-4, atol=1e-4,
                                               err_msg=f"lm card vs cpu {name} {b}.{n}")
        if len(got_routes) != len(want_routes) or not all(
                torch.equal(ge, we) and torch.equal(gk, wk)
                for (ge, gk), (we, wk) in zip(got_routes, want_routes)):
            raise AssertionError(f"lm card vs cpu {name}: the MoE routing differs")
        out[name] = dict(max_abs_err=err, moe_calls=len(got_routes))
    return out


def _lm_decode_vs_forward(name, S=12, pfx=4):
    """(b) a published config at full width in f32 on the card (its own
    weights from a seed): teacher-forced decode logits against the forward
    pass's (`block_apply_train` over the whole sequence) position by
    position within 2e-3, as the reference's test_decode_matches_forward."""
    cfg = dataclasses.replace(lm_configs.get_config(name), **LM_F32)
    params = lm_model.init_params(cfg, 0, device=DEV)
    rng = np.random.RandomState(0)
    tokens = torch.as_tensor(rng.randint(0, cfg.vocab, (1, S)), dtype=torch.int32, device=DEV)
    batch = {"tokens": tokens}
    if cfg.family == "encdec":  # the reference test's S frames
        batch["frames"] = torch.from_numpy(
            (rng.randn(1, S, cfg.d_model) * 0.02).astype(np.float32)).to(DEV)
    _, cache = lm_model.prefill(cfg, params, {**batch, "tokens": tokens[:, :pfx]},
                                max_len=S + 2)
    got = []
    for t in range(pfx, S):
        logits, cache = lm_model.decode_step(cfg, params, cache, tokens[:, t:t + 1], t)
        got.append(logits[0, 0])
    with torch.no_grad():
        x = lm_T.embed_tokens(cfg, params["tok"], tokens)
        if cfg.pos_embed == "sinusoidal":
            x = x + lm_model._sinusoidal(S, cfg.d_model, x.dtype, DEV)[None]
        memory = lm_model._encode_memory(cfg, params, batch)
        x, _ = lm_T.stack_apply_train(cfg, params["stack"], x, cfg.pattern, memory=memory)
        x = lm_T._apply_norm(cfg, params["final_norm"], x)
        ref = (x.float() @ lm_T._unembed_matrix(cfg, params["tok"]).float())[0, pfx:]
    got = torch.stack(got)
    torch.testing.assert_close(got, ref, rtol=2e-3, atol=2e-3,
                               msg=lambda m: f"lm decode vs forward {name}: {m}")
    out = dict(params=cfg.param_count(), max_abs_err=float((got - ref).abs().max()),
               positions=S - pfx)
    del params, cache
    torch.cuda.empty_cache()
    return out


def _lm_bound_ms(cfg, served, cache):
    """The least time of one decode step: the bf16 weights it reads (the
    embedding table only as the tied head; an untied one's B rows are
    nothing) and the whole cache, over the HBM rate."""
    weights = sum(p.numel() * p.element_size() for p in served.parameters())
    if not cfg.tie_embeddings:
        emb = served["tok"]["embed"]
        weights -= emb.numel() * emb.element_size()
    cache_bytes = sum(a.numel() * a.element_size() for c in cache.values() for a in c.values())
    return (weights + cache_bytes) / HBM_BYTES_PER_S * 1e3, weights, cache_bytes


def _lm_serve_timed(name, B=8, P=1024, tokens=16):
    """(c) a bf16 serve at full width: prefill of B x P tokens, then
    `tokens` greedy tokens with the position and the token on the card,
    twice (the tokens bitwise equal); the second run timed (prefill by
    CUDA events, each decode step by CUDA events, the loop by the host
    clock), its peak memory; one more step under torch.profiler (CUDA
    launches, device busy, idle share) and one under
    torch.cuda.set_sync_debug_mode("error")."""
    from torch.profiler import ProfilerActivity, profile

    cfg = lm_configs.get_config(name)
    params = lm_model.init_params(cfg, 0, device=DEV)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    served = lm_model._cast(params, torch.bfloat16)
    torch.cuda.synchronize()
    cast_s = time.perf_counter() - t0
    batch = _lm_inputs(cfg, B, P, DEV)
    max_len = P + tokens + 1

    def serve():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2 * tokens)]
        torch.cuda.synchronize()
        t_pf = time.perf_counter()
        ev[0].record()
        logits, cache = lm_model.prefill(cfg, params, batch, max_len=max_len)
        ev[1].record()
        tok = logits.argmax(-1).to(torch.int32)
        out = [tok[:, 0]]
        cur = torch.tensor(P, dtype=torch.int32, device=DEV)
        torch.cuda.synchronize()
        prefill_wall = time.perf_counter() - t_pf
        t_loop = time.perf_counter()
        for i in range(tokens - 1):
            ev[2 + 2 * i].record()
            logits, cache = lm_model.decode_step(cfg, params, cache, tok, cur)
            ev[3 + 2 * i].record()
            tok = logits.argmax(-1).to(torch.int32)
            out.append(tok[:, 0])
            cur = cur + 1
        seqs = torch.stack(out, 1)
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t_loop
        steps = [ev[2 + 2 * i].elapsed_time(ev[3 + 2 * i]) for i in range(tokens - 1)]
        return seqs.cpu(), cache, tok, cur, dict(
            prefill_ms=ev[0].elapsed_time(ev[1]), prefill_wall_ms=prefill_wall * 1e3,
            decode_ms_per_token=statistics.median(steps[2:]),
            decode_ms_min=min(steps[2:]), loop_s=loop_s,
            tokens_per_s=B * (tokens - 1) / loop_s)

    first, _, _, _, _ = serve()
    torch.cuda.reset_peak_memory_stats()
    second, cache, tok, cur, fig = serve()
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    if not torch.equal(first, second):
        raise AssertionError(f"lm serve {name}: two runs' greedy tokens differ")
    bound_ms, w_bytes, c_bytes = _lm_bound_ms(cfg, served, cache)
    # one more step under the profiler, then one under the sync check
    lm_model.decode_step(cfg, params, cache, tok, cur)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        lm_model.decode_step(cfg, params, cache, tok, cur)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_events = _device_events(prof)
    busy = _busy_us(dev_events) / 1e3
    averages = prof.key_averages()
    launches = sum(e.count for e in averages if "LaunchKernel" in e.key)
    # the step's most frequent aten calls: where its launches come from
    top_ops = sorted(((e.key, e.count) for e in averages if e.key.startswith("aten::")),
                     key=lambda kv: -kv[1])[:12]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits, cache = lm_model.decode_step(cfg, params, cache, tok, cur)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if not torch.isfinite(logits).all():
        raise AssertionError(f"lm serve {name}: non-finite logits")
    out = dict(params=cfg.param_count(), batch=B, prompt=P, tokens=tokens, cast_s=cast_s,
               **fig, peak_mb=peak_mb, bound_ms=bound_ms, bound_by="bytes",
               weight_bytes=w_bytes, cache_bytes=c_bytes,
               cuda_launches_per_step=launches, device_events_per_step=len(dev_events),
               profiled_step_ms=wall * 1e3, device_busy_ms=busy, top_ops=top_ops,
               idle_share=1 - busy / (wall * 1e3), sync_free_step=True,
               tokens_equal=True, first_tokens=second[0, :8].tolist())
    del params, served, cache  # the bf16 copy lives on `params`
    torch.cuda.empty_cache()
    return out


def lm_paths():
    """Phase 11: the LM serving path (`repro_torch.models`) -> {run: figures}."""
    t_phase = time.perf_counter()
    card = card_line()
    runs = {}
    t0 = time.perf_counter()
    runs["card_vs_cpu"] = _lm_card_vs_cpu()
    emit("lm", run="card_vs_cpu", nvidia_smi=card, run_s=time.perf_counter() - t0,
         configs=runs["card_vs_cpu"])
    for name in LM_FULL:
        t0 = time.perf_counter()
        runs[f"decode_vs_forward_{name}"] = r = _lm_decode_vs_forward(name)
        emit("lm", run="decode_vs_forward", arch=name, nvidia_smi=card,
             run_s=time.perf_counter() - t0, **r)
    for name in LM_FULL:
        t0 = time.perf_counter()
        runs[f"serve_{name}"] = r = _lm_serve_timed(name)
        emit("lm", run="serve_bf16", arch=name, nvidia_smi=card,
             run_s=time.perf_counter() - t0, **r)
    emit("lm", run="done", phase_s=time.perf_counter() - t_phase)
    return runs


# --- phase 12: LM training on one card ---------------------------------------------

# (config, B, S): lm_batches' traffic; granite in its published 4 micro-batches
LM_TRAIN_FULL = (("gemma-2b", 4, 1024), ("mamba2-370m", 4, 1024),
                 ("whisper-medium", 4, 1024), ("granite-moe-3b-a800m", 8, 512))
TRAIN_RTOL, TRAIN_ATOL = 1e-4, 1e-5  # card == CPU in f32 (tests/test_torch_lm_train.py)
# jamba's gradients: 8 layers of SSD and MoE at capacity factor 1.0 (grad norm
# 27, the others' <= 8) carry f32 sum-order differences further: measured
# 1.92e-5 on one of 16,384 elements of tok.embed (H100 80GB HBM3, 700 W)
TRAIN_GRAD_ATOL = {"jamba-1.5-large-398b": 1e-4}


def _train_batches(cfg, B, S, device, n):
    """`n` batches of `lm_batches` at B x S on `device`; whisper's stub
    frames [B, S, d] (the reference test's `_batch`), the VLM's stub
    patches, from numpy seed 0."""
    rng = np.random.RandomState(0)
    out = []
    for batch in lm_data.lm_batches(cfg.vocab, B, S, n_batches=n, device=device):
        if cfg.family == "encdec":
            batch["frames"] = torch.from_numpy(
                (rng.randn(B, S, cfg.d_model) * 0.02).astype(np.float32)).to(device)
        if cfg.family == "vlm":
            batch["memory"] = torch.from_numpy(
                (rng.randn(B, cfg.n_memory, cfg.d_model) * 0.02).astype(np.float32)).to(device)
        out.append(batch)
    return out


def _new_train_state(cfg, params):
    opt = lm_optimizer_for(cfg)
    state = {"params": params, "opt": opt.init(params.tree()),
             "step": torch.zeros((), dtype=torch.int32, device=params.device)}
    return state, lm_model.make_train_step(cfg, opt)


def _train_once(cfg, device, batch):
    """forward_train's (loss, ce, aux) and gradients, then one train step,
    from the seed-0 weights made on the CPU -> numpy, and the MoE routes."""
    params = lm_model.init_params(cfg, 0, device="cpu").to(device)
    routes, restore = _record_routes()
    try:
        params.requires_grad_(True)
        loss, m = lm_model.forward_train(cfg, params, batch)
        loss.backward()
        fwd = {"loss": loss.item(), "ce": m["ce"].item(), "aux": m["aux"].item()}
        grads = lm_convert.tree_to_numpy(lm_model._grads(params))
        for p in params.parameters():
            p.grad = None
        state, step = _new_train_state(cfg, params)
        state, metrics = step(state, batch)
    finally:
        restore()
    return (fwd, grads, lm_convert.train_state_to_numpy(state),
            {k: v.item() for k, v in metrics.items()}, routes)


def _tree_err(got, want, tag, rtol=TRAIN_RTOL, atol=TRAIN_ATOL):
    """(max |got - want|, its largest share of the tolerance) over two
    numpy trees of one structure, each leaf held at rtol / atol."""
    if isinstance(want, dict):
        assert got.keys() == want.keys(), tag
        errs = [_tree_err(got[k], want[k], f"{tag}.{k}", rtol, atol) for k in want]
        return (max((e for e, _ in errs), default=0.0), max((r for _, r in errs), default=0.0))
    d = np.abs(np.asarray(got, np.float64) - want)
    share = float((d / (atol + rtol * np.abs(np.asarray(want, np.float64)))).max(initial=0.0))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=tag)
    return float(d.max(initial=0.0)), share


def _params_err(got, want, grads, lr, tag):
    """The params after one step: each element within TRAIN_ATOL +
    TRAIN_RTOL x |p|, or, where the optimizer's first update is
    ill-conditioned (AdamW's u = g / (|g| + 1e-8), Adafactor's vector
    u = g / |g|: a gradient near 0), within lr x min(2, (TRAIN_ATOL +
    TRAIN_RTOL x |g|) / (|g| + 1e-8)), the gradients' own tolerance
    carried through the update's slope (|u| <= 1 before the weight decay)
    -> (max |got - want|, elements held by the second bound)."""
    if isinstance(want, dict):
        errs = [_params_err(got[k], want[k], grads[k], lr, f"{tag}.{k}") for k in want]
        return max((e for e, _ in errs), default=0.0), sum(n for _, n in errs)
    d = np.abs(np.asarray(got, np.float64) - want)
    plain = d <= TRAIN_ATOL + TRAIN_RTOL * np.abs(want)
    g = np.abs(np.asarray(grads, np.float64))
    carried = d <= lr * np.minimum(2.0, (TRAIN_ATOL + TRAIN_RTOL * g) / (g + 1e-8))
    if not (plain | carried).all():
        i = np.unravel_index(np.argmax(np.where(plain | carried, 0, d)), d.shape)
        raise AssertionError(f"{tag}: {got[i]} vs {want[i]} (gradient {grads[i]})")
    return float(d.max(initial=0.0)), int((~plain).sum())


def _train_card_vs_cpu():
    """(a) every reduced config in f32 (and gemma with accum_steps=2 at
    B 4): forward_train's loss, ce, aux and every gradient leaf, then one
    train step's params, optimizer state (jamba: Adafactor) and metrics,
    card against CPU from the same weights and batch at TRAIN_RTOL /
    TRAIN_ATOL (the params where the first update is ill-conditioned at
    `_params_err`'s carried bound); the MoE routing of every call (the
    forward, the remat's recompute) equal."""
    out = {}
    cases = [(n, {}) for n in lm_configs.all_arch_names()] + [("gemma-2b", {"accum_steps": 2})]
    for name, extra in cases:
        cfg = dataclasses.replace(lm_configs.get_reduced(name), compute_dtype="float32",
                                  **extra)
        batch = _train_batches(cfg, 2 * cfg.accum_steps, 32, "cpu", 1)[0]
        want = _train_once(cfg, "cpu", batch)
        got = _train_once(cfg, DEV, {k: v.to(DEV) for k, v in batch.items()})
        tag = f"lm train card vs cpu {name}{extra or ''}"
        lr = (lm_optim.adafactor if cfg.optimizer == "adafactor"
              else lm_optim.adamw).__defaults__[0]
        params_err, carried = _params_err(got[2].pop("params"), want[2].pop("params"),
                                          want[1], lr, f"{tag} params")
        err = {"forward": _tree_err(got[0], want[0], f"{tag} forward"),
               "grads": _tree_err(got[1], want[1], f"{tag} grads",
                                  atol=TRAIN_GRAD_ATOL.get(name, TRAIN_ATOL)),
               "params": params_err,
               "optimizer_state": _tree_err(got[2], want[2], f"{tag} state"),
               "metrics": _tree_err(got[3], want[3], f"{tag} metrics")}
        if len(got[4]) != len(want[4]) or not all(
                torch.equal(ge, we) and torch.equal(gk, wk)
                for (ge, gk), (we, wk) in zip(got[4], want[4])):
            raise AssertionError(f"{tag}: the MoE routing differs")
        key = name + ("_accum2" if extra else "")
        out[key] = dict(max_abs_err=err, params_held_by_carried_bound=carried,
                        moe_calls=len(got[4]), optimizer=cfg.optimizer, loss=got[3]["loss"])
    return out


def _attention_flops(cfg, B, S):
    """Forward FLOPs of the score and value products at sequence S (a
    causal one needs half its pairs; cross attention in training reads
    the S stub frames' encoding)."""
    def one(mixer, Sq, Sk):
        f = 4 * B * cfg.n_heads * Sq * Sk * cfg.d_head
        return f / 2 if mixer == "attn" else f

    total = cfg.n_groups * sum(one(mx, S, S) for mx, _ in cfg.pattern
                               if mx in ("attn", "attn_full", "cross"))
    if cfg.family == "encdec":
        total += cfg.enc_layers * one("attn_full", S, S)
    return total


def _ssd_flops(cfg, B, S):
    """Forward FLOPs of the SSD chunked form's products a mamba layer."""
    if not any(mx == "mamba" for mx, _ in cfg.pattern):
        return 0
    sd = cfg.ssm_dims
    per = (2 * B * S * sd.chunk * sd.n_heads * (sd.d_state + sd.headdim)
           + 4 * B * S * sd.n_heads * sd.d_state * sd.headdim)
    return cfg.n_groups * sum(mx == "mamba" for mx, _ in cfg.pattern) * per


def _train_bound(cfg, B, S, n_params):
    """The least time of one train step: the larger of its FLOPs over the
    bf16 peak (6 x active params x tokens for the forward and backward, 2
    more for the group remat's second forward; attention and the SSD's
    products 4x their forward: the forward, a backward of twice it, the
    recompute) and the bytes of the masters, gradients and AdamW's m and
    v, each read once and each written once, over the HBM rate."""
    tokens = B * S
    flops = (8 * cfg.active_param_count() * tokens
             + 4 * (_attention_flops(cfg, B, S) + _ssd_flops(cfg, B, S)))
    nbytes = n_params * 4 * (4 + 3)  # read p, g, m, v; write p, m, v
    f_ms, b_ms = flops / BF16_OPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(f_ms, b_ms), ("operations" if f_ms >= b_ms else "bytes"), flops, nbytes


def _train_losses(cfg, B, S, n):
    """The losses of `n` train steps from the seed-0 weights on the card."""
    params = lm_model.init_params(cfg, 0, device=DEV)
    state, step = _new_train_state(cfg, params)
    losses = []
    for b in _train_batches(cfg, B, S, DEV, n):
        state, m = step(state, b)
        losses.append(m["loss"].item())
    return losses


def _train_timed(name, B, S, steps=1):
    """(b) a bf16 train step at full width (the published optimizer and
    accum_steps): one warm step, `steps` timed by CUDA events (the
    median), then one under torch.profiler (CUDA launches, device busy,
    idle share) and under torch.cuda.set_sync_debug_mode("error") (no
    host read in a step); the loss is read after each step's end."""
    from torch.profiler import ProfilerActivity, profile

    cfg = lm_configs.get_config(name)
    n_params = cfg.param_count()
    params = lm_model.init_params(cfg, 0, device=DEV)
    state, step = _new_train_state(cfg, params)
    batches = _train_batches(cfg, B, S, DEV, steps + 2)
    probe = params["final_norm"]["scale"].detach().clone()
    probe_w = params["tok"]["embed"][:64].detach().clone()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, norms, times = [], [], []
    for i in range(steps + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        state, m = step(state, batches[i])
        ev[1].record()
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
        if i:
            times.append(ev[0].elapsed_time(ev[1]))
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            state, m = step(state, batches[steps + 1])
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    losses.append(m["loss"].item())
    norms.append(m["grad_norm"].item())
    launches, busy, n_dev, top_ops = _raw_trace(prof)
    del prof
    moved = not (torch.equal(probe, params["final_norm"]["scale"])
                 and torch.equal(probe_w, params["tok"]["embed"][:64]))
    if not (all(math.isfinite(x) for x in losses) and all(g > 0 and math.isfinite(g)
                                                         for g in norms) and moved):
        raise AssertionError(f"lm train {name}: losses {losses}, grad norms {norms}, "
                             f"params moved {moved}")
    bound_ms, bound_by, flops, nbytes = _train_bound(cfg, B, S, n_params)
    step_ms = statistics.median(times)
    out = dict(params=n_params, active_params=cfg.active_param_count(), batch=B, seq=S,
               accum_steps=cfg.accum_steps, optimizer=cfg.optimizer,
               step_ms=step_ms, step_ms_all=times, tokens_per_s=B * S / step_ms * 1e3,
               peak_mb=peak_mb,
               reckoning_mb={"masters_grads_adamw": n_params * 16 / 2**20,
                             "with_bf16_copy_and_grads": n_params * 20 / 2**20},
               bound_ms=bound_ms, bound_by=bound_by, flops=flops, bytes=nbytes,
               cuda_launches_per_step=launches, device_events_per_step=n_dev,
               profiled_step_ms=wall * 1e3, device_busy_ms=busy,
               idle_share=1 - busy / (wall * 1e3), top_ops=top_ops, sync_free_step=True,
               losses=losses, grad_norms=norms, params_moved=moved)
    del params, state, step, batches, m
    torch.cuda.empty_cache()
    return out, losses[:steps + 1]


def _raw_trace(prof):
    """(CUDA launches, device busy ms, device events, the most frequent aten
    calls) of a torch.profiler window, read from its raw kineto events: a
    train step's 15k-110k events would take minutes through `events()` and
    `key_averages()`. Launches and busy are counted as `_device_events`,
    `_busy_us` and the "LaunchKernel" keys count them."""
    from collections import Counter

    from torch.autograd import DeviceType

    raw = prof.profiler.kineto_results.events()
    dev = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in raw
           if e.device_type() == DeviceType.CUDA]
    busy, end = 0, -math.inf
    for lo, hi in sorted(dev):
        busy += max(0, hi - max(lo, end))
        end = max(end, hi)
    names = Counter(e.name() for e in raw)
    launches = sum(n for k, n in names.items() if "LaunchKernel" in k)
    top = [kv for kv in names.most_common() if kv[0].startswith("aten::")][:10]
    return launches, busy / 1e6, len(dev), top


def _device_split(prof) -> dict:
    """The device ms of a torch.profiler window by kind of kernel, each
    kernel's duration summed (overlapping kernels count twice): NCCL's
    collectives, matrix products (cuBLAS and CUTLASS gemm kernels), copies
    and fills, and the rest."""
    from torch.autograd import DeviceType

    out = {"nccl": 0.0, "gemm": 0.0, "memcpy_memset": 0.0, "other": 0.0}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        n = e.name().lower()
        kind = ("nccl" if "nccl" in n else
                "gemm" if any(w in n for w in ("gemm", "cutlass", "xmma", "sm90_", "cublas"))
                else "memcpy_memset" if n.startswith(("memcpy", "memset")) else "other")
        out[kind] += e.duration_ns() / 1e6
    return out


class _HostTimes:
    """Host ms and calls of each of `targets` ({name: (owner, attribute)},
    a function or method) while on: wall time from entry to return, each
    call whole (a timed call inside another counts in both)."""

    def __init__(self, targets):
        self.targets = targets
        self.ms = {k: 0.0 for k in targets}
        self.calls = {k: 0 for k in targets}

    def __enter__(self):
        self.saved = {k: getattr(o, a) for k, (o, a) in self.targets.items()}
        for k, (owner, attr) in self.targets.items():
            setattr(owner, attr, self._timed(k, self.saved[k]))
        return self

    def _timed(self, k, fn):
        def timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                self.ms[k] += (time.perf_counter() - t0) * 1e3
                self.calls[k] += 1
        return timed

    def __exit__(self, *exc):
        for k, (owner, attr) in self.targets.items():
            setattr(owner, attr, self.saved[k])


def _lm_host_targets():
    """The host spans of an LM step over a mesh that `_HostTimes` reads:
    the weights' gathers over the batch axes (`gather_tree`), the
    gradients' reduce-scatter (`ShardedLM.settle`), the model group's sums
    (`AxisGroup._reduce`, also inside `sum`'s and `fanout`'s autograd
    Functions), the group's byte exchanges (`_swap`) and every
    `all_to_all_single`."""
    import torch.distributed as dist

    return {"gather_tree": (lm_SH, "gather_tree"), "settle": (lm_SH.ShardedLM, "settle"),
            "axis_reduce": (lm_mesh.AxisGroup, "_reduce"), "axis_swap": (lm_mesh, "_swap"),
            "all_to_all_single": (dist, "all_to_all_single")}


def _agree(a, b, tag, atol):
    """Two runs' losses: equal bit for bit, else within `atol`."""
    bitwise = a == b
    diff = max(abs(x - y) for x, y in zip(a, b))
    if not bitwise and diff > atol:
        raise AssertionError(f"{tag}: two runs' losses differ by {diff}: {a} vs {b}")
    return dict(bitwise=bitwise, max_abs_diff=diff, losses=a)


# two card runs of one train, bf16: held to the bf16 loss bound of
# tests/test_torch_lm_train.py (the CE head's and the MoE's gathers add
# their gradients with atomics on the card)
TWO_RUNS_ATOL = 4e-3


def _train_two_runs(gemma_losses):
    """(c) reduced granite (MoE, bf16, B 8, S 64) for 3 steps twice, and
    gemma-2b at full width for (b)'s first 3 steps again: the losses."""
    cfg = lm_configs.get_reduced("granite-moe-3b-a800m")
    runs = [_train_losses(cfg, 8, 64, 3) for _ in range(2)]
    out = {"granite_reduced": _agree(runs[0], runs[1], "lm train granite reduced",
                                     TWO_RUNS_ATOL)}
    again = _train_losses(lm_configs.get_config("gemma-2b"), 4, 1024, len(gemma_losses))
    torch.cuda.empty_cache()
    out["gemma-2b"] = _agree(again, gemma_losses, "lm train gemma-2b", TWO_RUNS_ATOL)
    return out


def _train_cli():
    """(d) the CLI `python -m repro_torch.launch.train --arch gemma-2b
    --reduced --steps 30 --seq 32`, through its `main` in this process (a
    new interpreter costs ~10 s; the CLI's default S 128 costs ~1.2 s a
    step, 64 remat'd kv chunks a layer: 36 s on an H100 at 700 W) on the
    card: the loss falls. Then with --ckpt-dir, stopped at step 10 and
    run again to 30: "resumed from step 10", and the history after the
    resume equals the uninterrupted run's."""
    from contextlib import redirect_stdout
    from io import StringIO

    root = Path(__file__).resolve().parent
    args = ["--arch", "gemma-2b", "--reduced", "--seq", "32"]
    out = StringIO()
    t0 = time.perf_counter()
    with redirect_stdout(out):
        whole = lm_train.main(args + ["--steps", "30"])
    cli_s = time.perf_counter() - t0
    lines = out.getvalue().strip().splitlines()
    if not (len(whole) == 30 and whole[-1] < whole[0]
            and lines[-1].startswith(f"final loss {whole[-1]:.4f} (from {whole[0]:.4f})")):
        raise AssertionError(f"train CLI: the loss did not fall: {lines[-3:]}")
    ck = root / "build" / "chip_smoke" / "lm_train_ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    resumed_out = StringIO()
    try:
        with redirect_stdout(StringIO()):
            head = lm_train.main(args + ["--steps", "10", "--ckpt-dir", str(ck),
                                         "--ckpt-every", "5"])
        with redirect_stdout(resumed_out):
            tail = lm_train.main(args + ["--steps", "30", "--ckpt-dir", str(ck),
                                         "--ckpt-every", "5"])
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    if "resumed from step 10" not in resumed_out.getvalue():
        raise AssertionError(f"train resume: {resumed_out.getvalue()[-500:]}")
    resumed = _agree(head + tail, whole, "train resume vs uninterrupted", TWO_RUNS_ATOL)
    return dict(cli_first=whole[0], cli_last=whole[-1], cli_s=cli_s, cli_tail=lines[-3:],
                resumed=resumed)


def lm_train_paths():
    """Phase 12: LM training (`repro_torch.models` forward_train,
    make_train_step; `repro_torch.optim`; `launch.train`) -> {run: figures}."""
    t_phase = time.perf_counter()
    card = card_line()
    runs = {}
    t0 = time.perf_counter()
    runs["card_vs_cpu"] = _train_card_vs_cpu()
    emit("lm_train", run="card_vs_cpu", nvidia_smi=card, run_s=time.perf_counter() - t0,
         configs=runs["card_vs_cpu"])
    gemma_losses = None
    for name, B, S in LM_TRAIN_FULL:
        t0 = time.perf_counter()
        runs[f"train_{name}"], losses = _train_timed(name, B, S)
        if name == "gemma-2b":
            gemma_losses = losses
        emit("lm_train", run="train_bf16", arch=name, nvidia_smi=card,
             run_s=time.perf_counter() - t0, **runs[f"train_{name}"])
    t0 = time.perf_counter()
    runs["two_runs"] = _train_two_runs(gemma_losses)
    emit("lm_train", run="two_runs", nvidia_smi=card, run_s=time.perf_counter() - t0,
         atol=TWO_RUNS_ATOL, **runs["two_runs"])
    t0 = time.perf_counter()
    runs["cli"] = _train_cli()
    emit("lm_train", run="cli", nvidia_smi=card, run_s=time.perf_counter() - t0, **runs["cli"])
    emit("lm_train", run="done", phase_s=time.perf_counter() - t_phase)
    return runs


# --- phase 13: the LM mesh on one card ---------------------------------------------

LM_MESH = dict(data=2, model=2)
# capacity factor 1.0 in (a), where the shards drop tokens
MESH_CF1 = ("qwen3-moe-30b-a3b", "granite-moe-3b-a800m")
# (c): the sharded serve against one device's in f32, phase 11 (b)'s bound at
# full width (decode == forward)
MESH_SERVE_F32_ATOL = 2e-3
F32_STEPS = 2  # (c)'s f32 comparison: prefill and 2 decode steps


def _lm_mesh_host_state(cfg):
    """The seed-0 train state made on the CPU, as host numpy in the
    reference's layout (what a checkpoint holds)."""
    params = lm_model.init_params(cfg, 0, device="cpu")
    opt = lm_optimizer_for(cfg)
    return lm_convert.train_state_to_numpy({"params": params, "opt": opt.init(params.tree()),
                                            "step": torch.zeros((), dtype=torch.int32)})


def _lm_mesh_train_once(cfg, device, host, batch):
    """One sharded train step on a (data 2, model 2) mesh over `device`
    from the host state `host` -> (metrics, gradients, the new state, as
    host numpy; the MoE routes of every call)."""
    mesh = lm_mesh.make_host_mesh(**LM_MESH, device=device)
    pcfg = cfg.with_policy(lm_SH.policy_for(mesh))
    state = lm_reshard_state(host, pcfg, mesh)
    opt, seen = lm_optimizer_for(pcfg), {}

    def update(grads, st, params, step):
        seen["grads"] = lm_convert.tree_to_numpy(grads)
        return opt.update(grads, st, params, step)

    step = lm_model.make_train_step(pcfg, lm_optim.Optimizer(opt.init, update),
                                    param_specs=lm_SH.train_state_specs(pcfg, host,
                                                                        mesh)["params"])
    routes, restore = _record_routes()
    try:
        state, m = step(state, {k: v.to(mesh.home) for k, v in batch.items()})
    finally:
        restore()
    return ({k: v.item() for k, v in m.items()}, seen["grads"],
            lm_convert.train_state_to_numpy(state), routes)


def _lm_mesh_card_vs_cpu():
    """(a) every reduced config in f32 on (data 2, model 2), qwen3-moe and
    granite at capacity factor 1.0 (the shards drop): one sharded train
    step on the card against the same on the CPU from the same seeded
    state and batch, the metrics, every gradient, the params (at
    `_params_err`'s bound) and the optimizer state at TRAIN_RTOL /
    TRAIN_ATOL; the MoE routing and kept entries of every call equal."""
    out = {}
    for name in lm_configs.all_arch_names():
        extra = {"moe_capacity_factor": 1.0} if name in MESH_CF1 else {}
        cfg = dataclasses.replace(lm_configs.get_reduced(name), compute_dtype="float32",
                                  **extra)
        batch = _train_batches(cfg, 2 * LM_MESH["data"] * cfg.accum_steps, 32, "cpu", 1)[0]
        host = _lm_mesh_host_state(cfg)
        want = _lm_mesh_train_once(cfg, "cpu", host, batch)
        got = _lm_mesh_train_once(cfg, DEV, host, batch)
        tag = f"lm mesh card vs cpu {name}"
        lr = (lm_optim.adafactor if cfg.optimizer == "adafactor"
              else lm_optim.adamw).__defaults__[0]
        params_err, carried = _params_err(got[2].pop("params"), want[2].pop("params"),
                                          want[1], lr, f"{tag} params")
        err = {"metrics": _tree_err(got[0], want[0], f"{tag} metrics"),
               "grads": _tree_err(got[1], want[1], f"{tag} grads",
                                  atol=TRAIN_GRAD_ATOL.get(name, TRAIN_ATOL)),
               "params": params_err,
               "optimizer_state": _tree_err(got[2], want[2], f"{tag} state")}
        if len(got[3]) != len(want[3]) or not all(
                torch.equal(ge, we) and torch.equal(gk, wk)
                for (ge, gk), (we, wk) in zip(got[3], want[3])):
            raise AssertionError(f"{tag}: the MoE routing or its kept entries differ")
        out[name] = dict(max_abs_err=err, params_held_by_carried_bound=carried,
                         moe_calls=len(got[3]),
                         dropped_entries=int(sum(int((~k).sum()) for _, k in got[3])),
                         capacity_factor=cfg.moe_capacity_factor, loss=got[0]["loss"])
    return out


def _lm_mesh_state_bytes(specs, shapes, mesh):
    """Each shard's bytes of the state reckoned from the specs, the
    single-device state's bytes, and the leaves whose blocks the specs
    replicate (held by more than one shard)."""
    per_shard = lm_SH.shard_bytes(specs, shapes, mesh)
    leaves = lm_SH._leaves(shapes)
    spec_leaves = lm_SH._leaves(specs, is_leaf=lambda x: isinstance(x, lm_mesh.P))
    whole = sum(math.prod(t.shape) * t.dtype.itemsize for t in leaves)
    replicated, extra = set(), 0
    paths = _lm_mesh_leaf_paths(shapes)
    for path, t, spec in zip(paths, leaves, spec_leaves):
        split = math.prod(mesh.axis_size(a) for part in spec for a in lm_mesh._names(part))
        if split < mesh.size:
            replicated.add(path[-1])
            extra += math.prod(t.shape) * t.dtype.itemsize * (mesh.size - split) // split
    if sum(per_shard) != whole + extra:
        raise AssertionError(f"lm mesh: the parts' {sum(per_shard)} bytes are not the "
                             f"state's {whole} plus the replicas' {extra}")
    return dict(per_shard_mb=[b / 2**20 for b in per_shard], sum_mb=sum(per_shard) / 2**20,
                single_device_mb=whole / 2**20, replicated_extra_mb=extra / 2**20,
                replicated_leaves=sorted(replicated))


def _lm_mesh_leaf_paths(tree, path=()):
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _lm_mesh_leaf_paths(v, path + (k,))]
    return [path]


def _lm_mesh_train_timed(single, B=4, S=1024, steps=2):
    """(b) gemma-2b at full width in bf16 on (data 2, model 2) on the one
    card (`launch.train.build`: the seed-0 weights phase 12 trained, placed
    by `train_state_specs`): one warm step and `steps` timed by CUDA
    events, then one under torch.profiler (CUDA launches, device busy, idle
    share) and set_sync_debug_mode("error"); the first step's loss within
    TWO_RUNS_ATOL of phase 12's single-device step on the same weights and
    batch; each shard's state bytes reckoned from the specs. Returns (the
    figures, {"state": the state after the steps}, the config)."""
    from torch.profiler import ProfilerActivity, profile

    cfg = lm_configs.get_config("gemma-2b")
    mesh = lm_mesh.make_host_mesh(**LM_MESH, device=DEV)
    pcfg, state, step, specs = lm_train.build(cfg, mesh)
    shapes = lm_SH.state_shapes(pcfg, lm_optimizer_for(pcfg))
    batches = _train_batches(cfg, B, S, DEV, steps + 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, norms, times = [], [], []
    for i in range(steps + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        state, m = step(state, batches[i])
        ev[1].record()
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
        if i:
            times.append(ev[0].elapsed_time(ev[1]))
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            state, m = step(state, batches[steps + 1])
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    losses.append(m["loss"].item())
    launches, busy, n_dev, top_ops = _raw_trace(prof)
    del prof
    diff = abs(losses[0] - single["losses"][0])
    if not (diff <= TWO_RUNS_ATOL and all(math.isfinite(x) for x in losses + norms)):
        raise AssertionError(f"lm mesh gemma-2b: losses {losses} against one device's "
                             f"{single['losses'][0]} (|diff| {diff})")
    step_ms = statistics.median(times)
    out = dict(mesh=mesh.shape, batch=B, seq=S, step_ms=step_ms, step_ms_all=times,
               tokens_per_s=B * S / step_ms * 1e3, peak_mb=peak_mb,
               state=_lm_mesh_state_bytes(specs, shapes, mesh),
               cuda_launches_per_step=launches, device_events_per_step=n_dev,
               profiled_step_ms=wall * 1e3, device_busy_ms=busy,
               idle_share=1 - busy / (wall * 1e3), top_ops=top_ops, sync_free_step=True,
               losses=losses, grad_norms=norms, single_device_first_loss=single["losses"][0],
               first_loss_abs_diff=diff, single_device_step_ms=single["step_ms"],
               single_device_tokens_per_s=single["tokens_per_s"],
               single_device_peak_mb=single["peak_mb"],
               single_device_cuda_launches=single["cuda_launches_per_step"],
               single_device_idle_share=single["idle_share"])
    del step, batches, m
    torch.cuda.empty_cache()
    return out, {"state": state}, pcfg


def _lm_mesh_same_leaves(got, want, tag):
    """Every leaf of two placed states, joined from their parts on the
    device, equal bit for bit."""
    def walk(a, b, path):
        if isinstance(a, (list, dict)):
            for k in (range(len(a)) if isinstance(a, list) else a):
                walk(a[k], b[k], path + (k,))
        elif not torch.equal(a.join() if isinstance(a, lm_mesh.Sharded) else a,
                             b.join() if isinstance(b, lm_mesh.Sharded) else b):
            raise AssertionError(f"{tag}: {path} differs after resharding")

    walk(got["params"].tree(), want["params"].tree(), ("params",))
    walk(got["opt"], want["opt"], ("opt",))
    walk(got["step"], want["step"], ("step",))


def _lm_mesh_reshard(holder, pcfg, B=4, S=1024):
    """(e) (b)'s state saved whole from (data 2, model 2) (host numpy in
    the reference's layout, what a checkpoint holds) and placed on (data 4,
    model 1) by `ckpt.elastic.reshard_state`: every leaf bit for bit the
    saved state's, then one step there (a finite loss). `holder["state"]`
    is taken and freed here."""
    state = holder.pop("state")
    t0 = time.perf_counter()
    host = lm_convert.train_state_to_numpy(state)
    save_s = time.perf_counter() - t0
    mesh = lm_mesh.make_host_mesh(data=4, model=1, device=DEV)
    cfg = pcfg.with_policy(lm_SH.policy_for(mesh))
    t0 = time.perf_counter()
    resharded = lm_reshard_state(host, cfg, mesh)
    torch.cuda.synchronize()
    place_s = time.perf_counter() - t0
    specs = lm_SH.train_state_specs(cfg, host, mesh)
    del host
    t0 = time.perf_counter()
    _lm_mesh_same_leaves(resharded, state, "lm mesh reshard (2,2) -> (4,1)")
    compare_s = time.perf_counter() - t0
    del state
    torch.cuda.empty_cache()
    step = lm_model.make_train_step(cfg, lm_optimizer_for(cfg), param_specs=specs["params"])
    resharded, m = step(resharded, _train_batches(cfg, B, S, DEV, 1)[0])
    loss = m["loss"].item()
    if not math.isfinite(loss):
        raise AssertionError(f"lm mesh reshard: the step on (4, 1) gave loss {loss}")
    del resharded, step, m
    torch.cuda.empty_cache()
    return dict(mesh=mesh.shape, save_s=save_s, place_s=place_s, compare_s=compare_s,
                bitwise=True, step_loss=loss)


def _lm_mesh_serve(B=8, P=512, tokens=8):
    """(c) granite-moe-3b-a800m at full width, capacity factor 8 (no
    drops): the params placed on (data 2, model 2), prefill of B x P and
    `tokens` greedy tokens in bf16 with the cache split by `cache_specs` (a
    ShardedCache), every MoE call through moe_apply_sharded; twice, the
    tokens bitwise equal. The same weights on one device fed the same
    tokens: in f32 (prefill and F32_STEPS decode steps) the logits within
    MESH_SERVE_F32_ATOL (phase 11 (b)'s full-width bound), in bf16 the
    difference reported (each data shard's sub-batch rounds its products
    apart: no bound is measured at this depth)."""
    cfg = dataclasses.replace(lm_configs.get_config("granite-moe-3b-a800m"),
                              moe_capacity_factor=8.0)
    mesh = lm_mesh.make_host_mesh(**LM_MESH, device=DEV)
    pcfg = cfg.with_policy(lm_SH.policy_for(mesh))
    params = lm_model.init_params(cfg, 0, device=DEV)
    sharded = lm_SH.ShardedLM.place(pcfg, mesh, params, lm_SH.param_specs(
        pcfg, lm_SH.ref_layout(params.tree()), mesh))
    batch = _lm_inputs(cfg, B, P, DEV)
    calls = {"sharded": 0, "whole": 0}
    orig = (lm_moe.moe_apply_sharded, lm_moe.moe_apply)

    def counting(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    def run(c, p, feed=None, steps=tokens):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = lm_model.prefill(c, p, batch, max_len=P + tokens + 1)
        outs, toks = [logits], []
        cur = torch.tensor(P, dtype=torch.int32, device=DEV)
        for t in range(steps):
            tok = feed[:, t:t + 1] if feed is not None else logits.argmax(-1).to(torch.int32)
            toks.append(tok)
            logits, cache = lm_model.decode_step(c, p, cache, tok, cur)
            outs.append(logits)
            cur = cur + 1
        torch.cuda.synchronize()
        return torch.cat(outs, 1), torch.cat(toks, 1), cache, time.perf_counter() - t0

    lm_moe.moe_apply_sharded = counting("sharded", orig[0])
    lm_moe.moe_apply = counting("whole", orig[1])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        got, toks, cache, first_s = run(pcfg, sharded)
        routed = dict(calls)
        _, again, _, second_s = run(pcfg, sharded)
    finally:
        lm_moe.moe_apply_sharded, lm_moe.moe_apply = orig
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    if not isinstance(cache, lm_SH.ShardedCache) or routed["whole"] or not routed["sharded"]:
        raise AssertionError(f"lm mesh serve: cache {type(cache).__name__}, MoE calls {routed}")
    if not torch.equal(toks, again):
        raise AssertionError("lm mesh serve: two runs' greedy tokens differ")
    spec_k = tuple(cache["b0"]["k"].spec)
    del cache
    want, single_toks, _, single_s = run(cfg, params)
    bf16_err = float((got - want).abs().max())
    same_tokens = float((single_toks == toks).float().mean())
    f32 = dict(compute_dtype="float32", cache_dtype="float32")
    got32, _, _, _ = run(dataclasses.replace(pcfg, **f32), sharded, feed=toks, steps=F32_STEPS)
    want32, _, _, _ = run(dataclasses.replace(cfg, **f32), params, feed=toks, steps=F32_STEPS)
    err = float((got32 - want32).abs().max())
    if not err <= MESH_SERVE_F32_ATOL:
        raise AssertionError(f"lm mesh serve: f32 logits {err} from the single-device run's")
    out = dict(mesh=mesh.shape, batch=B, prompt=P, tokens=tokens, moe_calls=routed,
               cache_k_spec=spec_k, tokens_equal=True, f32_max_abs_err=err,
               f32_atol=MESH_SERVE_F32_ATOL, f32_decode_steps=F32_STEPS,
               bf16_max_abs_diff=bf16_err,
               bf16_logit_scale=float(want.abs().max()),
               bf16_greedy_tokens_as_single_device=same_tokens,
               serve_s=second_s, first_serve_s=first_s, single_device_serve_s=single_s,
               peak_mb=peak_mb, first_tokens=toks[0, :8].tolist(), tokens_all=toks.tolist(),
               last_logits_sha256=_sha(got[:, -1]))
    del params, sharded, got, want, got32, want32
    torch.cuda.empty_cache()
    return out


def _sha(t) -> str:
    """sha256 of a tensor's dtype, shape and bytes (a bitwise comparison
    across processes through JSON)."""
    import hashlib

    a = t.detach().contiguous().cpu()
    head = f"{a.dtype}{tuple(a.shape)}".encode()
    return hashlib.sha256(head + a.reshape(-1).view(torch.uint8).numpy().tobytes()).hexdigest()


CP_LENS = (0, 7, 16_383, 16_384, 32_767)


def _lm_mesh_cp_decode(S=32_768, cur_lens=CP_LENS):
    """(d) cp_decode_attention at gemma-2b's attention dims (d 2,048, 8
    heads, kv 1, d_head 256) in f32, B 1, a 32,768-token cache on data 8,
    the cache rolled forward through `cur_lens`: against attn_decode on
    the card, out at 2e-5 and the cache at 1e-6 (tests/test_serving.py's
    bounds); each call's time by CUDA events beside attn_decode's."""
    from repro_torch.models.layers import AttnDims, attn_decode, attn_init

    dims = AttnDims(d_model=2048, n_heads=8, n_kv=1, d_head=256)
    gen = torch.Generator(device=DEV).manual_seed(0)
    p = attn_init(gen, dims, torch.float32, DEV)
    mesh = lm_mesh.make_host_mesh(data=8, model=1, device=DEV)
    ck = torch.randn((1, S, 1, 256), generator=gen, device=DEV) * 0.3
    cv = torch.randn((1, S, 1, 256), generator=gen, device=DEV) * 0.3
    errs, times = [], []
    for cur_len in cur_lens:
        x = torch.randn((1, 1, 2048), generator=gen, device=DEV) * 0.3
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        want = attn_decode(p, x, ck.clone(), cv.clone(), cur_len, dims)
        ev[1].record()
        ev[2].record()
        got = lm_serving.cp_decode_attention(p, x, ck, cv, torch.tensor(cur_len, device=DEV),
                                             dims, mesh, seq_axis="data")
        ev[3].record()
        for g, w, tol, what in zip(got, want, (2e-5, 1e-6, 1e-6), ("out", "k", "v")):
            torch.testing.assert_close(g, w, rtol=tol, atol=tol,
                                       msg=lambda m: f"cp decode {what} cur_len {cur_len}: {m}")
        errs.append(float((got[0] - want[0]).abs().max()))
        torch.cuda.synchronize()
        times.append((ev[2].elapsed_time(ev[3]), ev[0].elapsed_time(ev[1])))
        ck, cv = got[1], got[2]
    return dict(cache=S, shards=8, cur_lens=list(cur_lens), out_max_abs_err=errs,
                cp_ms=[t[0] for t in times], attn_decode_ms=[t[1] for t in times])


# the figures recorded with tensor parallelism before the residual was
# sequence-parallel, for the runs that change (PERF.md §5-§6; NVIDIA H100
# 80GB HBM3, 700.00 W), printed beside this run's under "prior": then a
# pass kept its residual whole on every model rank
def _prior(key, cards=1):
    """PRIOR[key], marked comparable where it was taken on as many cards
    as this run's `cards`."""
    prior = PRIOR[key]
    return {**prior, "comparable": prior.get("cards", 1) == cards}


PRIOR = {
    "13b": dict(source="PERF.md §5-§6", step_ms=[1994.2, 2500.9],
                cuda_launches_per_step=57685, peak_mb=[45297, 45304]),
    "14c": dict(source="PERF.md §5-§6", cards=4, step_ms=[959.2, 967.6], peak_mb=13605),
    "14e": dict(source="PERF.md §5-§6", cards=4, decode_ms_per_token=[343.7, 344.8],
                decode_step_bytes_received=3389137968, decode_step_cache_bytes_received=0),
    "14f": dict(source="PERF.md §5-§6", cards=4, seq=512, step_ms=[5801.7, 5846.3]),
    "15c": dict(source="PERF.md §6", received=3389137968),
    "15d": dict(source="PERF.md §6", argument_gb=0.222, temp_gb=8.601, received_gb=36.1),
}


LONG_DECODE = dict(P=8192, S=32_768, tokens=8)  # (f) and phase 14 (i)
LONG_F32_ATOL = 2e-3  # (f): the sharded decode against one device's, in f32


def _long_run(c, p, batch, S, steps, feed=None):
    """Prefill `batch` (B 1) into an S-row cache and `steps` greedy decode
    steps (or those of the tokens `feed`) -> (logits [1, 1 + steps, V],
    tokens [1, steps], prefill ms, decode ms a token, the cache)."""
    dev = batch["tokens"].device
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    logits, cache = lm_model.prefill(c, p, batch, max_len=S)
    ev[1].record()
    cur = torch.tensor(batch["tokens"].shape[1], dtype=torch.int32, device=dev)
    outs, toks = [logits], []
    for t in range(steps):
        tok = feed[:, t:t + 1] if feed is not None else logits.argmax(-1).to(torch.int32)
        toks.append(tok)
        logits, cache = lm_model.decode_step(c, p, cache, tok, cur)
        outs.append(logits)
        cur = cur + 1
    ev[2].record()
    torch.cuda.synchronize()
    return (torch.cat(outs, 1), torch.cat(toks, 1), ev[0].elapsed_time(ev[1]),
            ev[1].elapsed_time(ev[2]) / max(steps, 1), cache)


def _long_placed(mesh):
    """gemma-2b's seed-0 weights placed on `mesh`, with the policy that
    places a prefill's cache with its sequence on the batch axes ->
    (config, one-device config, one-device LM or None, ShardedLM)."""
    cfg = lm_configs.get_config("gemma-2b")
    pcfg = cfg.with_policy(dataclasses.replace(lm_SH.policy_for(mesh),
                                               seq_axis_for_cache="data"))
    params = lm_model.init_params(cfg, 0, device=mesh.home)
    sharded = lm_SH.ShardedLM.place(pcfg, mesh, params, lm_SH.param_specs(
        pcfg, lm_SH.ref_layout(params.tree()), mesh))
    return pcfg, cfg, params, sharded


def _lm_mesh_long_decode(P=LONG_DECODE["P"], S=LONG_DECODE["S"],
                         tokens=LONG_DECODE["tokens"]):
    """(f) gemma-2b's long-context decode on (data 2, model 2): B 1, a
    P-token prompt into an S-row cache placed with its sequence on the
    data axis, `tokens` greedy tokens in bf16, twice, the tokens bitwise
    equal; no `Mesh.join` inside the cache's reads (each rank's slices
    are its parts, written in place); the same weights on one device fed
    the same tokens in f32 (prefill and F32_STEPS steps) within
    LONG_F32_ATOL."""
    mesh = lm_mesh.make_host_mesh(**LM_MESH, device=DEV)
    pcfg, cfg, params, sharded = _long_placed(mesh)
    batch = _lm_inputs(cfg, 1, P, DEV)
    join, rows = lm_mesh.Mesh.join, lm_SH.ShardedCache.rows
    joins, inside, kinds = [0], [False], set()

    def counting(self, *a, **k):
        joins[0] += inside[0]
        return join(self, *a, **k)

    def reading(self, *a, **k):
        inside[0] = True
        try:
            got = rows(self, *a, **k)
        finally:
            inside[0] = False
        kinds.update(type(v[0] if isinstance(v, lm_mesh.Blocks) else v).__name__
                     for c in got.values() for v in c.values())
        return got

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lm_mesh.Mesh.join, lm_SH.ShardedCache.rows = counting, reading
    try:
        got, toks, prefill_ms, decode_ms, _ = _long_run(pcfg, sharded, batch, S, tokens)
        again, toks2, _, _, _ = _long_run(pcfg, sharded, batch, S, tokens)
    finally:
        lm_mesh.Mesh.join, lm_SH.ShardedCache.rows = join, rows
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    if joins[0] or kinds != {"Slices"}:
        raise AssertionError(f"long decode: {joins[0]} joins inside the cache's reads, "
                             f"leaves read as {kinds}")
    if not torch.equal(toks, toks2):
        raise AssertionError("long decode: two runs' greedy tokens differ")
    f32 = dict(compute_dtype="float32", cache_dtype="float32")
    got32 = _long_run(dataclasses.replace(pcfg, **f32), sharded, batch, S, F32_STEPS,
                      feed=toks)[0]
    want32 = _long_run(dataclasses.replace(cfg, **f32), params, batch, S, F32_STEPS,
                       feed=toks)[0]
    err = float((got32 - want32).abs().max())
    if not err <= LONG_F32_ATOL:
        raise AssertionError(f"long decode: f32 logits {err} from the single-device run's")
    out = dict(mesh=mesh.shape, batch=1, prompt=P, cache=S, tokens=tokens,
               cache_leaves_read_as=sorted(kinds), joins_in_cache_reads=joins[0],
               tokens_equal=True, f32_max_abs_err=err, f32_atol=LONG_F32_ATOL,
               f32_decode_steps=F32_STEPS, prefill_ms=prefill_ms, decode_ms_per_token=decode_ms,
               peak_mb=peak_mb, tokens_all=toks.tolist(), last_logits_sha256=_sha(got[:, -1]),
               runs_bitwise=torch.equal(got, again))
    del params, sharded, got, again, got32, want32
    torch.cuda.empty_cache()
    return out


def lm_mesh_paths(single):
    """Phase 13: the LM mesh on one card (`launch.sharding`, the sharded
    train step, `moe_apply_sharded`, `launch.serving`, `ckpt.elastic`)
    -> {run: figures}. `single` is phase 12's gemma-2b step."""
    t_phase = time.perf_counter()
    card = card_line()
    runs = {}
    t0 = time.perf_counter()
    runs["card_vs_cpu"] = _lm_mesh_card_vs_cpu()
    emit("lm_mesh", run="card_vs_cpu", nvidia_smi=card, run_s=time.perf_counter() - t0,
         configs=runs["card_vs_cpu"])
    t0 = time.perf_counter()
    runs["train_gemma-2b"], holder, pcfg = _lm_mesh_train_timed(single)
    # phase 15 (a)'s yardstick: the state's storages on the card
    runs["train_gemma-2b"]["placed_state_bytes"] = sum(
        lm_dryrun._storages(holder["state"]).values())
    emit("lm_mesh", run="train_bf16", arch="gemma-2b", nvidia_smi=card,
         run_s=time.perf_counter() - t0, bytes_received_per_step=0,
         bytes_note="one process: the model ranks run in turn, nothing crosses processes",
         prior=_prior("13b"), **runs["train_gemma-2b"])
    t0 = time.perf_counter()
    runs["reshard"] = _lm_mesh_reshard(holder, pcfg)
    emit("lm_mesh", run="reshard", nvidia_smi=card, run_s=time.perf_counter() - t0,
         **runs["reshard"])
    t0 = time.perf_counter()
    runs["serve_granite"] = _lm_mesh_serve()
    emit("lm_mesh", run="serve_bf16", arch="granite-moe-3b-a800m", nvidia_smi=card,
         run_s=time.perf_counter() - t0, **runs["serve_granite"])
    t0 = time.perf_counter()
    runs["cp_decode"] = _lm_mesh_cp_decode()
    emit("lm_mesh", run="cp_decode", nvidia_smi=card, run_s=time.perf_counter() - t0,
         **runs["cp_decode"])
    t0 = time.perf_counter()
    runs["long_decode"] = _lm_mesh_long_decode()
    emit("lm_mesh", run="long_decode_bf16", arch="gemma-2b", nvidia_smi=card,
         run_s=time.perf_counter() - t0, **runs["long_decode"])
    emit("lm_mesh", run="done", phase_s=time.perf_counter() - t_phase)
    return runs


# --- phase 14: the mesh over processes -----------------------------------------------

MP_GENS = 5  # (a): phase 10 (a)'s generations
MP_POSTFIX_GENS = 5  # (b)
MP_TIMEOUT_S = 600


def _mp_islands(gens=MP_GENS):
    """(a) phase 10 (a)'s session (kat7 4 x 200 islands on (pod 2, data 2,
    model 2)) with this process's shards: B1 exactly once a local shard a
    generation and no other kernel, then one block under
    set_sync_debug_mode("error") and one generation under torch.profiler
    (each process's CUDA launches, device busy time and idle share)."""
    sess = GPSession.from_dataset("kat7", topology=MeshTopology(**MESH3), **_island_kw())
    mesh = sess.mesh
    n = len(mesh.local)
    wall, peak, launches = _mesh_run(sess, gens, {"eval_fitness": n * gens}, "mp islands")
    out = dict(local_shards=list(mesh.local), placement=_placement(mesh), generations=gens,
               launches=launches, wall_ms_per_generation=wall / gens * 1e3,
               peak_mb=peak / 2**20, host_syncs=sess.stats["host_syncs"],
               history=sess.history, island_history=np.asarray(
                   sess.island_history, np.float32).tolist())
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sess.evolve_block(1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    out["sync_debug_block"] = "no synchronisation in a 1-generation block"
    out["profiled_generation"] = _profiled_generation(sess)
    return out


def _mp_postfix_session():
    return GPSession.from_dataset("kat7", pop_size=100, genome="postfix",
                                  topology=MeshTopology(data=2, model=2), dedup_cap=6301)


def _mp_postfix(gens=MP_POSTFIX_GENS):
    """(b) postfix kat7 pop 100 on (data 2, model 2), dedup exact at cap
    6,301: B2's siblings, the unique table and B4 each once a local shard
    a generation."""
    sess = _mp_postfix_session()
    n = len(sess.mesh.local)
    names = dict((label, k) for label, _, k in MESH_POSTFIX)["exact_cap6301"]
    wall, peak, launches = _mesh_run(sess, gens, {k: n * gens for k in names}, "mp postfix")
    return dict(local_shards=list(sess.mesh.local), generations=gens, launches=launches,
                wall_ms_per_generation=wall / gens * 1e3, peak_mb=peak / 2**20,
                history=sess.history)


def _mp_train(profile, B=4, S=1024, steps=2):
    """(c) gemma-2b at full width in bf16 on (data 2, model 2) (phase 13
    (b)'s seed-0 state and batches): one warm step and `steps` timed by
    CUDA events on every process, then one more, profiled on process 0;
    every step's loss, as phase 13 (b) records them. The split of a step:
    the host ms of the last timed step in the mesh's spans
    (`_lm_host_targets`) beside its wall ms, and the profiled step's
    device ms by kind of kernel (`_device_split`)."""
    from torch.profiler import ProfilerActivity, profile as profiler

    cfg = lm_configs.get_config("gemma-2b")
    mesh = lm_mesh.make_host_mesh(**LM_MESH)
    _, state, step, _ = lm_train.build(cfg, mesh)
    batches = _train_batches(cfg, B, S, mesh.home, steps + 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    host = _HostTimes(_lm_host_targets())
    for i in range(steps + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        if i == steps:  # the last timed step: its host spans
            host.__enter__()
            t0 = time.perf_counter()
        ev[0].record()
        state, m = step(state, batches[i])
        ev[1].record()
        losses.append(m["loss"].item())
        if i == steps:
            wall_ms = (time.perf_counter() - t0) * 1e3
            host.__exit__()
        if i:
            times.append(ev[0].elapsed_time(ev[1]))
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    torch.cuda.synchronize()
    out = dict(local_shards=list(mesh.local), batch=B, seq=S, losses=losses,
               step_ms=statistics.median(times), step_ms_all=times,
               tokens_per_s=B * S / statistics.median(times) * 1e3, peak_mb=peak_mb,
               host_split_ms=host.ms, host_split_calls=host.calls,
               host_split_step_ms=times[-1], host_split_wall_ms=wall_ms)
    if not profile:
        state, m = step(state, batches[steps + 1])
        losses.append(m["loss"].item())
        return out
    with profiler(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = step(state, batches[steps + 1])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    losses.append(m["loss"].item())
    launches, busy, n_dev, top_ops = _raw_trace(prof)
    out.update(cuda_launches_per_step=launches, device_events_per_step=n_dev,
               profiled_step_ms=wall * 1e3, device_busy_ms=busy,
               idle_share=1 - busy / (wall * 1e3), top_ops=top_ops,
               device_split_ms=_device_split(prof))
    return out


def _mp_reduced_state(steps=2):
    """Reduced gemma-2b in f32 on (data 2, model 2) from seed 0, `steps`
    train steps -> the state joined as host numpy (the reference's layout)."""
    cfg = dataclasses.replace(lm_configs.get_reduced("gemma-2b"), compute_dtype="float32")
    mesh = lm_mesh.make_host_mesh(**LM_MESH)
    _, state, step, _ = lm_train.build(cfg, mesh)
    for b in _train_batches(cfg, 4, 32, mesh.home, steps):
        state, _ = step(state, b)
    return lm_convert.train_state_to_numpy(state)


def _mp_digests(tree, path=""):
    """{leaf path: sha256 of its dtype, shape and bytes} of a host tree."""
    import hashlib

    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _mp_digests(v, f"{path}/{k}").items()}
    a = np.asarray(tree)
    return {path: hashlib.sha256(f"{a.dtype}{a.shape}".encode() + a.tobytes()).hexdigest()}


def _mp_tree_of(paths):
    """A nested dict with a leaf at each "/a/b" path: the structure to
    restore a checkpoint into."""
    tree = {}
    for p in paths:
        node, keys = tree, p.strip("/").split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = 0
    return tree


class _Moved:
    """The bytes this process's `torch.distributed` collectives sent and
    received while the block runs (the module's functions wrapped; a
    collective's own part of its output is not counted as received)."""

    NAMES = ("all_gather", "all_gather_into_tensor", "all_to_all_single", "all_reduce",
             "broadcast")

    def __enter__(self):
        import torch.distributed as dist

        self.sent = self.received = self.calls = 0
        self.originals = {n: getattr(dist, n) for n in self.NAMES}
        for name, fn in self.originals.items():
            setattr(dist, name, self._wrap(name, fn))
        return self

    def _wrap(self, name, fn):
        import torch.distributed as dist

        def nbytes(t):
            return t.numel() * t.element_size()

        def wrapped(*a, **k):
            group = k.get("group")
            n = dist.get_world_size(group)
            me = dist.get_rank(group)
            self.calls += 1
            if name == "all_gather":
                self.sent += nbytes(a[1])
                self.received += sum(nbytes(o) for o in a[0]) - nbytes(a[1])
            elif name == "all_gather_into_tensor":
                self.sent += nbytes(a[1])
                self.received += nbytes(a[0]) - nbytes(a[1])
            elif name == "all_to_all_single":
                out_sizes = a[2] if len(a) > 2 else k.get("output_split_sizes")
                own = (out_sizes[me] if out_sizes else a[0].numel() // n) * a[0].element_size()
                self.sent += nbytes(a[1]) - own
                self.received += nbytes(a[0]) - own
            else:
                self.sent += nbytes(a[0]) * (n > 1)
                self.received += nbytes(a[0]) * (n > 1)
            return fn(*a, **k)

        return wrapped

    def __exit__(self, *exc):
        import torch.distributed as dist

        for name, fn in self.originals.items():
            setattr(dist, name, fn)


def _mp_serve(profile, B=8, P=512, tokens=8):
    """(e) phase 13 (c)'s serve over the processes: granite-moe-3b-a800m at
    full width, bf16, capacity factor 8, its seed-0 weights placed on
    (data 2, model 2) (this process's parts only), B 8, a 512-token prompt
    and 8 greedy tokens; prefill and decode timed by CUDA events, then one
    more decode step (profiled on process 0) with the bytes its
    collectives moved. Returns the figures with the tokens and the last
    logits' digest."""
    from torch.profiler import ProfilerActivity, profile as profiler

    cfg = dataclasses.replace(lm_configs.get_config("granite-moe-3b-a800m"),
                              moe_capacity_factor=8.0)
    mesh = lm_mesh.make_host_mesh(**LM_MESH)
    pcfg = cfg.with_policy(lm_SH.policy_for(mesh))
    params = lm_model.init_params(cfg, 0, device=mesh.home)
    sharded = lm_SH.ShardedLM.place(pcfg, mesh, params, lm_SH.param_specs(
        pcfg, lm_SH.ref_layout(params.tree()), mesh))
    del params
    torch.cuda.empty_cache()
    batch = _lm_inputs(cfg, B, P, mesh.home)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    logits, cache = lm_model.prefill(pcfg, sharded, batch, max_len=P + tokens + 1)
    ev[1].record()
    cur = torch.tensor(P, dtype=torch.int32, device=mesh.home)
    toks = []
    for _ in range(tokens):
        tok = logits.argmax(-1).to(torch.int32)
        toks.append(tok)
        logits, cache = lm_model.decode_step(pcfg, sharded, cache, tok, cur)
        cur = cur + 1
    ev[2].record()
    torch.cuda.synchronize()
    last = _sha(logits[:, -1])
    prefill_ms, decode_ms = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2]) / tokens
    tok = logits.argmax(-1).to(torch.int32)
    # the bytes the step's cache reads receive (`ShardedCache.rows`,
    # counted apart): each rank reads its own part
    rows, cache_rx = lm_SH.ShardedCache.rows, [0]

    def counted_rows(*a, **k):
        with _Moved() as m:
            out = rows(*a, **k)
        cache_rx[0] += m.received
        return out

    lm_SH.ShardedCache.rows = counted_rows
    try:
        with _Moved() as moved:
            if profile:
                with profiler(activities=[ProfilerActivity.CPU,
                                          ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    lm_model.decode_step(pcfg, sharded, cache, tok, cur)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
            else:
                lm_model.decode_step(pcfg, sharded, cache, tok, cur)
                torch.cuda.synchronize()
    finally:
        lm_SH.ShardedCache.rows = rows
    cache_rx = cache_rx[0]
    out = dict(local_shards=list(mesh.local), batch=B, prompt=P, tokens=tokens,
               tokens_all=torch.cat(toks, 1).tolist(), last_logits_sha256=last,
               prefill_ms=prefill_ms, decode_ms_per_token=decode_ms,
               tokens_per_s=B / decode_ms * 1e3,
               peak_mb=torch.cuda.max_memory_allocated() / 2**20,
               decode_step_bytes_received=moved.received, decode_step_bytes_sent=moved.sent,
               decode_step_cache_bytes_received=cache_rx,
               decode_step_collectives=moved.calls)
    if profile:
        launches, busy, n_dev, _ = _raw_trace(prof)
        out.update(cuda_launches_per_decode_step=launches, device_busy_ms=busy,
                   profiled_decode_step_ms=wall * 1e3, idle_share=1 - busy / (wall * 1e3))
    del sharded, cache, logits
    torch.cuda.empty_cache()
    return out


def _mp_train_granite(profile, third=True, warm=True, B=8, S=512):
    """(f) phase 12 (b)'s granite step over the processes: granite-moe-3b-a800m
    at full width, bf16, B 8 x S 512 in its 4 micro-batches, AdamW, on
    (data 2, model 2) from the seed-0 state (`launch.train.build`) and
    phase 12 (b)'s batches: one warm step and one timed by CUDA events
    (`step_ms`; without `warm` the first step alone, `cold_step_ms`), and
    with `third` a third (under torch.profiler with `profile`, on one
    process); each expert FFN call's buffer and weight shapes."""
    from torch.profiler import ProfilerActivity, profile as profiler

    cfg = lm_configs.get_config("granite-moe-3b-a800m")
    mesh = lm_mesh.make_host_mesh(**LM_MESH)
    _, state, step, _ = lm_train.build(cfg, mesh)
    batches = _train_batches(cfg, B, S, mesh.home, 3)
    shapes, ffn = set(), lm_moe._expert_ffn

    def recording(buf, w_up, w_gate, w_down, act):
        shapes.add((tuple(buf.shape), tuple(w_up.shape)))
        return ffn(buf, w_up, w_gate, w_down, act)

    lm_moe._expert_ffn = recording
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses = []
        if warm:
            state, m = step(state, batches[0])
            losses.append(m["loss"].item())
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        state, m = step(state, batches[len(losses)])
        ev[1].record()
        losses.append(m["loss"].item())
        step_ms = ev[0].elapsed_time(ev[1])
        peak_mb = torch.cuda.max_memory_allocated() / 2**20
        out = dict(local_shards=list(mesh.local), batch=B, seq=S,
                   accum_steps=cfg.accum_steps, peak_mb=peak_mb,
                   **(dict(step_ms=step_ms, tokens_per_s=B * S / step_ms * 1e3) if warm
                      else dict(cold_step_ms=step_ms)))
        torch.cuda.synchronize()
        if profile:
            with profiler(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                state, m = step(state, batches[2])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            launches, busy, n_dev, _ = _raw_trace(prof)
            del prof
            out.update(cuda_launches_per_step=launches, device_events_per_step=n_dev,
                       profiled_step_ms=wall * 1e3, device_busy_ms=busy,
                       idle_share=1 - busy / (wall * 1e3))
        if third:
            if not profile:  # the processes take every step together
                state, m = step(state, batches[2])
            losses.append(m["loss"].item())
    finally:
        lm_moe._expert_ffn = ffn
    out.update(losses=losses, expert_ffn_shapes=sorted(shapes))
    del state, step, batches
    torch.cuda.empty_cache()
    return out


def _mp_granite_first(B=8, S=512):
    """(f)'s first step in this one process, on the same mesh and from the
    same state and batch: the single controller's loss, which every
    process's first loss equals bit for bit. (One device's loss, phase 12
    (b), is another function: its dispatch's capacity and aux statistics
    span the micro-batch's tokens, a shard's only its own.)"""
    cfg = lm_configs.get_config("granite-moe-3b-a800m")
    mesh = lm_mesh.make_host_mesh(**LM_MESH)
    _, state, step, _ = lm_train.build(cfg, mesh)
    _, m = step(state, _train_batches(cfg, B, S, mesh.home, 1)[0])
    loss = m["loss"].item()
    del state, step, m
    torch.cuda.empty_cache()
    return loss


def _mp_bits(steps=2, decode=3):
    """(g) reduced granite in f32, capacity factor 1.0, 2 micro-batches:
    `steps` train steps on (data 2, model 2) from seed 0, then prefill and
    `decode` greedy steps with the trained params -> (each step's metrics,
    the state's leaf digests, the logits' digests), for the processes and
    for the single controller in this process alike."""
    cfg = dataclasses.replace(lm_configs.get_reduced("granite-moe-3b-a800m"),
                              compute_dtype="float32", cache_dtype="float32",
                              moe_capacity_factor=1.0, accum_steps=2)
    mesh = lm_mesh.make_host_mesh(**LM_MESH)
    pcfg, state, step, _ = lm_train.build(cfg, mesh)
    metrics = []
    for b in _train_batches(cfg, 4, 32, mesh.home, steps):
        state, m = step(state, b)
        metrics.append({k: v.item() for k, v in m.items()})
    digests = _mp_digests(lm_convert.train_state_to_numpy(state))
    params = state["params"]
    logits, cache = lm_model.prefill(pcfg, params, _lm_inputs(cfg, 4, 8, mesh.home),
                                     max_len=8 + decode)
    seen = [_sha(logits)]
    for t in range(decode):
        logits, cache = lm_model.decode_step(pcfg, params, cache, logits.argmax(-1), 8 + t)
        seen.append(_sha(logits))
    return dict(metrics=metrics, state=digests, logits=seen)


def _mp_cp_decode(world, S=32_768, cur_lens=CP_LENS):
    """(h) phase 13 (d)'s `cp_decode_attention` on data `world` (over the
    processes one slice a process, or in one process): gemma-2b's
    attention dims in f32, B 1, a 32,768-token cache rolled forward
    through `cur_lens`, each output against `attn_decode` at 2e-5 and this
    process's cache slices at 1e-6 (the reference cache rolled forward by
    `attn_decode`); the outputs' and slices' digests and the bytes this
    process sent in one layer."""
    from repro_torch.models.layers import AttnDims, attn_decode, attn_init

    mesh = lm_mesh.make_host_mesh(data=world, model=1)
    dev = mesh.home
    dims = AttnDims(d_model=2048, n_heads=8, n_kv=1, d_head=256)
    gen = torch.Generator(device=dev).manual_seed(0)
    p = attn_init(gen, dims, torch.float32, dev)
    ck = torch.randn((1, S, 1, 256), generator=gen, device=dev) * 0.3
    cv = torch.randn((1, S, 1, 256), generator=gen, device=dev) * 0.3
    ref_k, ref_v, n = ck.clone(), cv.clone(), S // world
    outs, errs, moved = [], [], None
    for i, cur_len in enumerate(cur_lens):
        x = torch.randn((1, 1, 2048), generator=gen, device=dev) * 0.3
        want, ref_k, ref_v = attn_decode(p, x, ref_k, ref_v, cur_len, dims)
        pos = torch.tensor(cur_len, device=dev)
        if i == 0:
            with _Moved() as moved:
                o, ck, cv = lm_serving.cp_decode_attention(p, x, ck, cv, pos, dims, mesh)
        else:
            o, ck, cv = lm_serving.cp_decode_attention(p, x, ck, cv, pos, dims, mesh)
        torch.testing.assert_close(o, want, rtol=2e-5, atol=2e-5,
                                   msg=lambda m: f"mp cp decode out cur_len {cur_len}: {m}")
        errs.append(float((o - want).abs().max()))
        outs.append(_sha(o))
    slices = {}
    for s in mesh.local:
        for tag, got, ref in (("k", ck, ref_k), ("v", cv, ref_v)):
            part = got.parts[s] if isinstance(got, lm_mesh.Sharded) else got[:, s * n:(s + 1) * n]
            torch.testing.assert_close(part, ref[:, s * n:(s + 1) * n], rtol=1e-6, atol=1e-6,
                                       msg=lambda m: f"mp cp decode cache {tag} slice {s}: {m}")
            slices[f"{tag}{s}"] = _sha(part)
    return dict(shards=world, cache=S, cur_lens=list(cur_lens), out=outs, out_max_abs_err=errs,
                slices=slices, layer_bytes_sent=moved.sent if mesh.multi else 0,
                partial_bytes=(8 * 256 + 2 * 8) * 4,
                cache_slice_bytes=2 * n * 256 * 4)


def _mp_long(P=LONG_DECODE["P"], S=LONG_DECODE["S"], tokens=LONG_DECODE["tokens"]):
    """(i) phase 13 (f)'s long-context decode in bf16 over the processes
    (this process's parts only): prefill ms, decode ms a token, the tokens
    and the last logits' digest, peak MB, then one more decode step with
    the bytes its collectives moved and those its cache reads received
    (`ShardedCache.rows`, counted apart)."""
    mesh = lm_mesh.make_host_mesh(**LM_MESH)
    pcfg, cfg, params, sharded = _long_placed(mesh)
    del params
    torch.cuda.empty_cache()
    batch = _lm_inputs(cfg, 1, P, mesh.home)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    got, toks, prefill_ms, decode_ms, cache = _long_run(pcfg, sharded, batch, S, tokens)
    rows, cache_rx = lm_SH.ShardedCache.rows, [0]

    def counted_rows(*a, **k):
        with _Moved() as m:
            out = rows(*a, **k)
        cache_rx[0] += m.received
        return out

    cur = torch.tensor(P + tokens, dtype=torch.int32, device=mesh.home)
    lm_SH.ShardedCache.rows = counted_rows
    try:
        with _Moved() as moved:
            lm_model.decode_step(pcfg, sharded, cache, got[:, -1:].argmax(-1).to(torch.int32),
                                 cur)
            torch.cuda.synchronize()
    finally:
        lm_SH.ShardedCache.rows = rows
    out = dict(local_shards=list(mesh.local), batch=1, prompt=P, cache=S, tokens=tokens,
               tokens_all=toks.tolist(), last_logits_sha256=_sha(got[:, -1]),
               prefill_ms=prefill_ms, decode_ms_per_token=decode_ms,
               peak_mb=torch.cuda.max_memory_allocated() / 2**20,
               decode_step_bytes_received=moved.received, decode_step_bytes_sent=moved.sent,
               decode_step_cache_bytes_received=cache_rx[0],
               decode_step_collectives=moved.calls)
    del sharded, cache, got
    torch.cuda.empty_cache()
    return out


MP_PARTS = ("islands", "postfix", "train", "checkpoint", "serve", "granite", "bits", "cp",
            "long")


def _mp_child(rank, world, addr, outdir, parts=MP_PARTS):
    """One process of phase 14: the launch environment a user sets, then
    `init_cluster()` (NCCL, its card cuda:{rank mod cards}), the kernels'
    library (built once by the parent), (a)-(h) (`parts`: those named),
    and its figures written to outdir/rank{rank}.json. An error ends the
    process with a non-zero code, which fails the phase."""
    from repro_torch.ckpt import checkpoint as lm_ckpt
    from repro_torch.launch import cluster

    import torch.distributed as dist

    os.environ.update(COORDINATOR_ADDRESS=addr, NUM_PROCESSES=str(world),
                      PROCESS_ID=str(rank))
    cluster.init_cluster()
    if "islands" in parts or "postfix" in parts:
        build.load("gp_eval")
    out = dict(rank=rank, world=dist.get_world_size(), backend=dist.get_backend(),
               card=str(torch.device("cuda", torch.cuda.current_device())))
    t0 = time.perf_counter()
    if "islands" in parts:
        out["islands"] = _mp_islands()
    if "postfix" in parts:
        out["postfix"] = _mp_postfix()
    if "train" in parts:
        out["train"] = _mp_train(profile=rank == 0)
    if "checkpoint" in parts:
        host = _mp_reduced_state()
        lm_ckpt.save(host, os.path.join(outdir, "ckpt"), 2)
        out["checkpoint"] = _mp_digests(host)
    out["run_s"] = time.perf_counter() - t0
    if "serve" in parts:
        out["serve"] = _mp_serve(profile=rank == 0)
    if "granite" in parts:
        # on one card (W = 1) the step is the single controller's, whose
        # profile and trace cost more than the rest of (f): runs with W > 1
        # profile it, and time a step after a warm one; one card times its
        # first step (the one held to the parent's), cold
        out["granite"] = _mp_train_granite(profile=rank == 0 and world > 1,
                                           third=world > 1, warm=world > 1)
    if "bits" in parts:
        out["bits"] = _mp_bits()
    if "cp" in parts:
        out["cp"] = _mp_cp_decode(world)
    if "long" in parts:
        out["long"] = _mp_long()
    out["run_efgh_s"] = time.perf_counter() - t0 - out["run_s"]
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    cluster.close_cluster()


def _mp_spawn(world, outdir, parts=MP_PARTS):
    """Start `world` processes of `_mp_child` (multiprocessing's spawn) and
    wait for them: one that fails stops the others (they would wait for
    it in a collective) and fails the phase."""
    import multiprocessing
    import socket

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        addr = f"localhost:{sk.getsockname()[1]}"
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_mp_child, args=(r, world, addr, outdir, parts))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + MP_TIMEOUT_S
    while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
        if any(p.exitcode for p in procs):
            break
        time.sleep(0.2)
    for p in procs:
        if p.is_alive():
            p.terminate()
        p.join()
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise AssertionError(f"mp: process exit codes {codes} (a failed or timed-out rank)")
    out = []
    for r in range(world):
        with open(os.path.join(outdir, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def mp_profile_main():
    """`python3 chip_smoke.py --mp-profile`: phase 14 (c), (e) and (f) alone
    over min(4, cards) processes, for their figures on four cards: every
    process's (c) and (f) losses and (e) tokens the same and (e)'s cache
    reads receiving nothing (the bitwise checks against one process are
    the whole script's); one line each with (c)'s split of a step."""
    card = card_line()
    print(card, flush=True)
    world = min(4, torch.cuda.device_count())
    root = Path(__file__).resolve().parent / "build" / "chip_smoke"
    root.mkdir(parents=True, exist_ok=True)
    outdir = tempfile.mkdtemp(prefix="mp-", dir=root)
    t0 = time.perf_counter()
    try:
        ranks = _mp_spawn(world, outdir, ("train", "serve", "granite"))
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    for part, key in (("train", "losses"), ("serve", "tokens_all"), ("granite", "losses")):
        if any(r[part][key] != ranks[0][part][key] for r in ranks):
            raise AssertionError(f"mp profile: the processes' {part} {key} differ")
    if any(r["serve"]["decode_step_cache_bytes_received"] for r in ranks):
        raise AssertionError("mp profile: a decode step's cache reads received bytes")
    for part in ("train", "serve", "granite"):
        emit("mp_profile", run=part, nvidia_smi=card, ranks=world,
             **{k: [r[part].get(k) for r in ranks] for k in sorted(ranks[0][part])
                if k not in ("tokens_all", "expert_ffn_shapes")})
    emit("mp_profile", run="done", spawn_s=time.perf_counter() - t0)


def mp_paths(islands, gemma, serve, granite, long):
    """Phase 14: the mesh over processes, one a card (W = the smaller of 4
    and the card count): (a) phase 10 (a)'s session on every process, the
    history and per-island history bit for bit `islands`' (phase 10 (a),
    one process); (b) the postfix session on (data 2, model 2) at cap
    6,301, bit for bit the same session in this one process; (c) gemma-2b's
    train steps, every loss bit for bit `gemma`'s (phase 13 (b), the same
    state and batches in one process); (d) reduced gemma-2b's state after
    2 steps, saved from the processes (process 0 writes) and restored here
    bit for bit every process's, and every process's the same 2 steps'
    in this one process (each leaf's digest); (e) granite's sharded serve,
    every process's greedy tokens and last logits bit for bit `serve`'s
    (phase 13 (c), one process); (f) granite's train step, every
    process's losses the same and the first bit for bit the same step in
    this one process (`granite`'s, phase 12 (b) on one device, beside it),
    every expert FFN on E_loc experts; (g)
    reduced granite's train steps, prefill and decode steps, every
    process's metrics and digests bit for bit the same run in this one
    process; (h) `cp_decode_attention` on data W against `attn_decode` and
    bit for bit the same calls in this one process, only the partials
    sent; (i) phase 13 (f)'s long-context decode (`long`), every
    process's tokens and last logits bit for bit its, 0 B received in the
    cache's reads. -> {run: figures} (launches from process 0)."""
    import gc

    from repro_torch.ckpt import checkpoint as lm_ckpt

    t_phase = time.perf_counter()
    card = card_line()
    world = min(4, torch.cuda.device_count())
    gc.collect()
    torch.cuda.empty_cache()
    root = Path(__file__).resolve().parent / "build" / "chip_smoke"
    root.mkdir(parents=True, exist_ok=True)
    outdir = tempfile.mkdtemp(prefix="mp-", dir=root)
    try:
        t0 = time.perf_counter()
        ranks = _mp_spawn(world, outdir)
        spawn_s = time.perf_counter() - t0
        multi = dict(ranks=world, multi_rank=world > 1, backend=ranks[0]["backend"],
                     cards=[r["card"] for r in ranks])
        if world == 1:
            multi["multi_rank_reason"] = ("one card: NCCL takes one rank a card, so the "
                                          "group holds one process and no value crosses "
                                          "processes; the gloo tests hold several on the CPU")
        if [r["world"] for r in ranks] != [world] * world or ranks[0]["backend"] != "nccl":
            raise AssertionError(f"mp: worlds {[r['world'] for r in ranks]}, "
                                 f"backend {ranks[0]['backend']}")
        for r in ranks:
            a = r["islands"]
            if a["history"] != islands["history"] or a["island_history"] != islands[
                    "island_history"] or a["host_syncs"] != 1:
                raise AssertionError(f"mp islands, process {r['rank']}: history "
                                     f"{a['history']} vs one process's {islands['history']}")
            if r["train"]["losses"] != gemma["losses"]:
                raise AssertionError(f"mp train, process {r['rank']}: losses "
                                     f"{r['train']['losses']} vs one process's "
                                     f"{gemma['losses']}")
        one = _mp_postfix_session()
        one.init(key=prng.PRNGKey(0))
        one.evolve(MP_POSTFIX_GENS)
        if any(r["postfix"]["history"] != one.history for r in ranks):
            raise AssertionError(f"mp postfix: {[r['postfix']['history'] for r in ranks]} "
                                 f"vs one process's {one.history}")
        back = lm_ckpt.restore(os.path.join(outdir, "ckpt"), 2,
                               like=_mp_tree_of(ranks[0]["checkpoint"]))
        if any(r["checkpoint"] != _mp_digests(back) for r in ranks):
            raise AssertionError("mp checkpoint: the restored state differs from a "
                                 "process's state")
        here = _mp_digests(_mp_reduced_state())  # the single controller, this process
        if any(r["checkpoint"] != here for r in ranks):
            bad = sorted(k for k in here if ranks[0]["checkpoint"].get(k) != here[k])
            raise AssertionError(f"mp checkpoint: the processes' state differs from the "
                                 f"same steps in one process at {bad[:5]}")
        e_loc = -(-40 // LM_MESH["model"])  # granite's 40 experts over the model axis
        t1 = time.perf_counter()
        first = _mp_granite_first()  # the single controller, this process
        for r in ranks:
            e, f = r["serve"], r["granite"]
            if (e["tokens_all"] != serve["tokens_all"]
                    or e["last_logits_sha256"] != serve["last_logits_sha256"]):
                raise AssertionError(f"mp serve, process {r['rank']}: tokens "
                                     f"{e['tokens_all'][0][:8]} vs one process's "
                                     f"{serve['tokens_all'][0][:8]}, or the last logits differ")
            if not (f["losses"][0] == first and all(math.isfinite(x) for x in f["losses"])
                    and f["losses"] == ranks[0]["granite"]["losses"]):
                raise AssertionError(f"mp granite train, process {r['rank']}: losses "
                                     f"{f['losses']} vs one process's first {first}")
            if any(b[0] != e_loc or w[0] != e_loc for b, w in f["expert_ffn_shapes"]):
                raise AssertionError(f"mp granite train, process {r['rank']}: expert FFN "
                                     f"shapes {f['expert_ffn_shapes']}, not {e_loc} experts")
        cache_rx = [r["serve"]["decode_step_cache_bytes_received"] for r in ranks]
        if any(cache_rx):
            raise AssertionError(f"mp serve: a decode step's cache reads received {cache_rx} "
                                 "B: a rank reads its own part")
        bits = _mp_bits()  # the single controller, this process
        for r in ranks:
            if r["bits"] != bits:
                bad = [k for k in ("metrics", "logits") if r["bits"][k] != bits[k]] + sorted(
                    k for k in bits["state"] if r["bits"]["state"].get(k) != bits["state"][k])
                raise AssertionError(f"mp bits, process {r['rank']}: differs from one "
                                     f"process at {bad[:5]}")
        cp = _mp_cp_decode(world)  # the same calls in this one process
        for r in ranks:
            c = r["cp"]
            if c["out"] != cp["out"] or any(v != cp["slices"][k] for k, v in c["slices"].items()):
                raise AssertionError(f"mp cp decode, process {r['rank']}: differs from the "
                                     f"same calls in one process")
            if world > 1 and c["layer_bytes_sent"] != c["partial_bytes"]:
                raise AssertionError(f"mp cp decode, process {r['rank']}: sent "
                                     f"{c['layer_bytes_sent']} B in a layer, not the "
                                     f"partials' {c['partial_bytes']}")
            i = r["long"]
            if (i["tokens_all"] != long["tokens_all"]
                    or i["last_logits_sha256"] != long["last_logits_sha256"]):
                raise AssertionError(f"mp long decode, process {r['rank']}: tokens "
                                     f"{i['tokens_all']} vs one process's {long['tokens_all']}, "
                                     "or the last logits differ")
            if i["decode_step_cache_bytes_received"]:
                raise AssertionError(f"mp long decode, process {r['rank']}: the cache's reads "
                                     f"received {i['decode_step_cache_bytes_received']} B")
        here_s = time.perf_counter() - t1
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    t = [r["train"] for r in ranks]
    emit("mp", run="islands", nvidia_smi=card, **multi,
         launches=[r["islands"]["launches"] for r in ranks],
         local_shards=[r["islands"]["local_shards"] for r in ranks],
         wall_ms_per_generation=[r["islands"]["wall_ms_per_generation"] for r in ranks],
         peak_mb=[r["islands"]["peak_mb"] for r in ranks],
         profiled_generation=[r["islands"]["profiled_generation"] for r in ranks],
         single_process_wall_ms_per_generation=islands["wall_ms_per_generation"],
         single_process_profiled_generation=islands["profiled_generation"],
         history_bitwise_phase10=True, sync_debug_block=True)
    emit("mp", run="postfix", nvidia_smi=card, **multi,
         launches=[r["postfix"]["launches"] for r in ranks],
         wall_ms_per_generation=[r["postfix"]["wall_ms_per_generation"] for r in ranks],
         history_bitwise_one_process=True)
    emit("mp", run="train_bf16", arch="gemma-2b", nvidia_smi=card, **multi,
         losses=t[0]["losses"], losses_bitwise_phase13=True,
         step_ms=[x["step_ms"] for x in t], step_ms_all=[x["step_ms_all"] for x in t],
         tokens_per_s=t[0]["tokens_per_s"], peak_mb=[x["peak_mb"] for x in t],
         **{k: t[0][k] for k in ("cuda_launches_per_step", "device_events_per_step",
                                 "profiled_step_ms", "device_busy_ms", "idle_share",
                                 "device_split_ms")},
         host_split_ms=[x["host_split_ms"] for x in t], host_split_calls=t[0]["host_split_calls"],
         host_split_step_ms=[x["host_split_step_ms"] for x in t],
         host_split_wall_ms=[x["host_split_wall_ms"] for x in t],
         single_process_step_ms=gemma["step_ms"], single_process_peak_mb=gemma["peak_mb"],
         prior=_prior("14c", world))
    emit("mp", run="checkpoint", nvidia_smi=card, **multi, restored_bitwise=True,
         one_process_bitwise=True, spawn_s=spawn_s, child_run_s=[r["run_s"] for r in ranks])
    e = [r["serve"] for r in ranks]
    emit("mp", run="serve_bf16", arch="granite-moe-3b-a800m", nvidia_smi=card, **multi,
         batch=e[0]["batch"], prompt=e[0]["prompt"], tokens=e[0]["tokens"],
         tokens_bitwise_phase13=True, last_logits_bitwise_phase13=True,
         first_tokens=e[0]["tokens_all"][0][:8],
         prefill_ms=[x["prefill_ms"] for x in e],
         decode_ms_per_token=[x["decode_ms_per_token"] for x in e],
         tokens_per_s=e[0]["tokens_per_s"], peak_mb=[x["peak_mb"] for x in e],
         decode_step_bytes_received=[x["decode_step_bytes_received"] for x in e],
         decode_step_bytes_sent=[x["decode_step_bytes_sent"] for x in e],
         decode_step_cache_bytes_received=[x["decode_step_cache_bytes_received"] for x in e],
         decode_step_collectives=[x["decode_step_collectives"] for x in e],
         **{k: e[0][k] for k in ("cuda_launches_per_decode_step", "profiled_decode_step_ms",
                                 "device_busy_ms", "idle_share")},
         single_process_serve_s=serve["serve_s"], prior=_prior("14e", world))
    f = [r["granite"] for r in ranks]
    emit("mp", run="train_granite_bf16", arch="granite-moe-3b-a800m", nvidia_smi=card,
         **multi, batch=f[0]["batch"], seq=f[0]["seq"], accum_steps=f[0]["accum_steps"],
         losses=f[0]["losses"], first_loss_bitwise_one_process=True,
         single_device_loss_abs_diff=abs(f[0]["losses"][0] - granite["losses"][0]),
         single_device_note=("one device's step is another function: its MoE dispatch "
                             "takes capacity and aux statistics over the micro-batch's "
                             "tokens, a shard over its own"),
         **{k: [x[k] for x in f] for k in ("step_ms", "cold_step_ms") if k in f[0]},
         tokens_per_s=f[0].get("tokens_per_s"), peak_mb=[x["peak_mb"] for x in f],
         expert_ffn_shapes=[x["expert_ffn_shapes"] for x in f], experts_per_process=e_loc,
         **{k: f[0].get(k) for k in ("cuda_launches_per_step", "device_events_per_step",
                                     "profiled_step_ms", "device_busy_ms", "idle_share")},
         profiled=("process 0's third step" if world > 1 else
                   "not profiled on one card: the step is the single controller's"),
         single_device_first_loss=granite["losses"][0],
         single_device_step_ms=granite["step_ms"],
         single_device_tokens_per_s=granite["tokens_per_s"],
         single_device_peak_mb=granite["peak_mb"],
         single_device_cuda_launches=granite["cuda_launches_per_step"],
         single_device_idle_share=granite["idle_share"],
         single_device_expert_buffer="moe_apply: [40, C, 1536], all 40 experts",
         prior=_prior("14f", world))
    emit("mp", run="bits_granite_f32", nvidia_smi=card, **multi,
         metrics=ranks[0]["bits"]["metrics"], state_leaves=len(bits["state"]),
         logits_steps=len(bits["logits"]), bitwise_one_process=True)
    i = [r["long"] for r in ranks]
    emit("mp", run="long_decode_bf16", arch="gemma-2b", nvidia_smi=card, **multi,
         batch=1, prompt=i[0]["prompt"], cache=i[0]["cache"], tokens=i[0]["tokens"],
         tokens_bitwise_phase13=True, last_logits_bitwise_phase13=True,
         prefill_ms=[x["prefill_ms"] for x in i],
         decode_ms_per_token=[x["decode_ms_per_token"] for x in i],
         peak_mb=[x["peak_mb"] for x in i],
         decode_step_bytes_received=[x["decode_step_bytes_received"] for x in i],
         decode_step_bytes_sent=[x["decode_step_bytes_sent"] for x in i],
         decode_step_cache_bytes_received=[x["decode_step_cache_bytes_received"] for x in i],
         decode_step_collectives=[x["decode_step_collectives"] for x in i],
         single_process_prefill_ms=long["prefill_ms"],
         single_process_decode_ms_per_token=long["decode_ms_per_token"])
    c = [r["cp"] for r in ranks]
    emit("mp", run="cp_decode", nvidia_smi=card, **multi, shards=world, cache=cp["cache"],
         cur_lens=cp["cur_lens"], out_max_abs_err=[x["out_max_abs_err"] for x in c],
         bitwise_one_process=True, layer_bytes_sent=[x["layer_bytes_sent"] for x in c],
         partial_bytes=cp["partial_bytes"], cache_slice_bytes=cp["cache_slice_bytes"],
         child_run_efgh_s=[r["run_efgh_s"] for r in ranks], parent_check_s=here_s,
         phase_s=time.perf_counter() - t_phase)
    return {"islands": ranks[0]["islands"], "postfix": ranks[0]["postfix"], "serve": e,
            "long": i, "world": world}


# --- phase 15: the dry run held against the card ----------------------------------------

DRY_TRAIN = dict(B=4, S=1024)  # phase 13 (b)'s step (`_lm_mesh_train_timed`)
DRY_SERVE = dict(B=8, P=512, tokens=8)  # phase 14 (e)'s decode (`_mp_serve`)
DRY_RANKS = 4  # (c): the ranks of phase 14 on four cards
DRY_TIMEOUT_S = 900


def _dryrun_child(out_path, gens):
    """Phase 15's dry runs (`python3 chip_smoke.py --dryrun OUT GENS`), in
    a process of their own: a dry run joins a fake process group for the
    whole process. Writes {part: record} to OUT; nothing touches the
    card (CUDA must stay uninitialized)."""

    def strip(rec):
        return {k: v for k, v in rec.items() if k != "not_portable"}

    res = {}
    t0 = time.perf_counter()
    res["a"] = strip(lm_dryrun.run_cell(
        "gemma-2b", {"kind": "train", "batch": DRY_TRAIN["B"], "seq": DRY_TRAIN["S"]}, False,
        "", processes=1, mesh=LM_MESH))
    res["b"] = strip(lm_dryrun.run_gp_cell(dict(
        name="karoo-kat7", rows=10_000, n_features=9, kernel="c", n_classes=2,
        fn_set=prim.CLASSIFY_SET, topology=MESH3, **_island_kw()), False, "",
        eval_impl="cuda", block_steps=gens, processes=1))
    granite = dataclasses.replace(lm_configs.get_config("granite-moe-3b-a800m"),
                                  moe_capacity_factor=8.0)
    decode = {"kind": "decode", "batch": DRY_SERVE["B"],
              "seq": DRY_SERVE["P"] + DRY_SERVE["tokens"] + 1}
    res["c"] = [strip(lm_dryrun.run_cell("granite-moe-3b-a800m", decode, False, "", rank=r,
                                         processes=DRY_RANKS, cfg=granite, mesh=LM_MESH))
                for r in range(DRY_RANKS)]
    res["d"] = strip(lm_dryrun.run_cell("gemma-2b", "train_4k", False, ""))
    long = {"kind": "decode", "batch": 1, "seq": LONG_DECODE["S"]}
    res["e"] = [strip(lm_dryrun.run_cell("gemma-2b", long, False, "", rank=r,
                                         processes=DRY_RANKS, mesh=LM_MESH))
                for r in range(DRY_RANKS)]
    res["child_s"] = time.perf_counter() - t0
    res["cuda_initialized"] = torch.cuda.is_initialized()
    with open(out_path, "w") as f:
        json.dump(res, f)


def _dryrun_start(gens):
    """Start phase 15's child (it runs while phases 12-14 use the card)
    -> (the process, its output path, its start time)."""
    SCRATCH.mkdir(parents=True, exist_ok=True)
    out = SCRATCH / "dryrun.json"
    if out.exists():
        out.unlink()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--dryrun",
                             str(out), str(gens)], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, out, time.perf_counter()


def _batch_bytes(cfg, B, S) -> int:
    batch = _train_batches(cfg, B, S, DEV, 1)[0]
    return sum(t.numel() * t.element_size() for t in batch.values())


def dryrun_paths(child, islands, gemma, mp):
    """Phase 15: phase 15's child read and held against phases 10 (a), 13
    (b) and 14 (e) (see the docstring)."""
    t_phase = time.perf_counter()
    card = card_line()
    proc, out, started = child
    try:
        log, _ = proc.communicate(timeout=max(1.0, DRY_TIMEOUT_S - (t_phase - started)))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError(f"dry run: the child ran past {DRY_TIMEOUT_S} s")
    waited = time.perf_counter() - t_phase
    if proc.returncode:
        raise AssertionError(f"dry run: the child exited {proc.returncode}:\n{log[-4000:]}")
    with open(out) as f:
        res = json.load(f)
    out.unlink()
    bad = [k for k in "abd" if res[k]["status"] != "ok"] + [
        f"{k}{r}" for k in "ce" for r, c in enumerate(res[k]) if c["status"] != "ok"]
    if bad or res["cuda_initialized"]:
        raise AssertionError(f"dry run: cells {bad} failed or CUDA was initialized: "
                             f"{[res[k].get('error') for k in 'abd']}")
    # (a) the arguments against the bytes phase 13 (b) placed on the card
    a = res["a"]
    if (gemma["batch"], gemma["seq"]) != (DRY_TRAIN["B"], DRY_TRAIN["S"]):
        raise AssertionError(f"dry run (a): phase 13 (b) ran B {gemma['batch']} x S "
                             f"{gemma['seq']}, not {DRY_TRAIN}")
    placed = gemma["placed_state_bytes"] + _batch_bytes(
        lm_configs.get_config("gemma-2b"), DRY_TRAIN["B"], DRY_TRAIN["S"])
    argument = a["memory"]["argument_gb"] * 2**30
    if argument != placed:
        raise AssertionError(f"dry run (a): argument {argument} B, placed on the card "
                             f"{placed} B")
    reckoned_gb = a["memory"]["argument_gb"] + a["memory"]["temp_gb"]
    cards = len(set(lm_mesh.make_host_mesh(**LM_MESH, device=DEV).devices))
    emit("dryrun", run="a_gemma_train_single_controller", nvidia_smi=card, mesh=LM_MESH,
         batch=DRY_TRAIN["B"], seq=DRY_TRAIN["S"], argument_bytes=int(argument),
         placed_bytes=placed, argument_equal_placed=True, memory=a["memory"],
         argument_plus_temp_gb=reckoned_gb, card_peak_gb=gemma["peak_mb"] / 1024,
         reckoned_over_peak=reckoned_gb / (gemma["peak_mb"] / 1024), shard_cards=cards,
         **({} if cards == 1 else {"peak_note": (
             f"the shards took {cards} cards: the peak is cuda:0's alone, the reckoning "
             "every shard's")}),
         flops=a["flops"], trace_s=a["trace_s"])
    # (b) B1's launches against phase 10 (a)'s
    b = res["b"]
    want = {"eval_fitness": islands["launches"]["eval_fitness"]}
    if b["kernel_launches"] != want:
        raise AssertionError(f"dry run (b): launches {b['kernel_launches']}, phase 10 (a) "
                             f"{want} in {islands['generations']} generations")
    emit("dryrun", run="b_gp_mesh_cuda_meta", nvidia_smi=card, shape=b["shape"],
         generations=islands["generations"], kernel_launches=b["kernel_launches"],
         phase10_launches=islands["launches"], launches_equal=True,
         received_bytes=b["received_bytes"], collective_calls=b["collective_calls"],
         memory=b["memory"], trace_s=b["trace_s"])
    # (c) each rank's bytes against phase 14 (e)'s processes
    e = mp["serve"]
    if (e[0]["batch"], e[0]["prompt"], e[0]["tokens"]) != (
            DRY_SERVE["B"], DRY_SERVE["P"], DRY_SERVE["tokens"]):
        raise AssertionError(f"dry run (c): phase 14 (e) served B {e[0]['batch']}, a "
                             f"{e[0]['prompt']}-token prompt, {e[0]['tokens']} tokens")
    c = res["c"]
    dry = [[x["sent_bytes"], x["received_bytes"], x["collective_calls"]] for x in c]
    multi = mp["world"] == DRY_RANKS
    if multi:
        got = [[x["decode_step_bytes_sent"], x["decode_step_bytes_received"],
                x["decode_step_collectives"]] for x in e]
        if got != dry:
            raise AssertionError(f"dry run (c): processes {got}, dry run {dry}")
    emit("dryrun", run="c_granite_decode_ranks", nvidia_smi=card, ranks=DRY_RANKS,
         multi_rank=multi, **({} if multi else {"multi_rank_reason": (
             f"phase 14 ran {mp['world']} process(es): no byte crossed, so each rank's "
             "dry-run bytes print alone")}),
         dry_sent_received_calls=dry, phase14_equal=multi or None, prior=_prior("15c"),
         collective_bytes=[x["collective_bytes"] for x in c],
         memory=[x["memory"] for x in c], trace_s=[x["trace_s"] for x in c])
    # (d) one production cell
    d = res["d"]
    emit("dryrun", run="d_gemma_train_4k_sp", nvidia_smi=card, record=d, trace_s=d["trace_s"],
         prior=_prior("15d"))
    # (e) the long decode step's bytes against phase 14 (i)'s processes
    i = mp["long"]
    e_ = res["e"]
    dry = [[x["sent_bytes"], x["received_bytes"], x["collective_calls"]] for x in e_]
    if any(x["cache_received_bytes"] for x in e_):
        raise AssertionError(f"dry run (e): the cache's reads received "
                             f"{[x['cache_received_bytes'] for x in e_]} B")
    if multi:
        got = [[x["decode_step_bytes_sent"], x["decode_step_bytes_received"],
                x["decode_step_collectives"]] for x in i]
        if got != dry:
            raise AssertionError(f"dry run (e): processes {got}, dry run {dry}")
    emit("dryrun", run="e_gemma_long_decode_ranks", nvidia_smi=card, ranks=DRY_RANKS,
         cache=LONG_DECODE["S"], multi_rank=multi, **({} if multi else {"multi_rank_reason": (
             f"phase 14 ran {mp['world']} process(es): no byte crossed, so each rank's "
             "dry-run bytes print alone")}),
         dry_sent_received_calls=dry, phase14_equal=multi or None,
         phase14_sent_received_calls=[[x["decode_step_bytes_sent"],
                                       x["decode_step_bytes_received"],
                                       x["decode_step_collectives"]] for x in i],
         cache_received_bytes=[x["cache_received_bytes"] for x in e_],
         collective_bytes=[x["collective_bytes"] for x in e_],
         memory=[x["memory"] for x in e_], trace_s=[x["trace_s"] for x in e_])
    emit("dryrun", run="done", child_s=res["child_s"], waited_s=waited,
         phase_s=time.perf_counter() - t_phase)
    return res


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


class Laps(dict):
    """Each phase's seconds: `lap(name)` ends the phase begun at the last
    call (or at `t0`)."""

    def __init__(self, t0):
        super().__init__()
        self.last = t0

    def __call__(self, name):
        now = time.perf_counter()
        self[name] = now - self.last
        self.last = now


def lm_mesh_phases(islands, lap):
    """Phases 12-15, given phase 10 (a)'s `islands`; phase 15's child runs
    beside phases 12-14 -> phase 14's runs."""
    dry_child = _dryrun_start(islands["generations"])
    lm_train_runs = lm_train_paths()
    lap("12 lm train")
    lm_mesh_runs = lm_mesh_paths(lm_train_runs["train_gemma-2b"])
    lap("13 lm mesh")
    mp_runs = mp_paths(islands, lm_mesh_runs["train_gemma-2b"], lm_mesh_runs["serve_granite"],
                       lm_train_runs["train_granite-moe-3b-a800m"], lm_mesh_runs["long_decode"])
    lap("14 mesh over processes")
    dryrun_paths(dry_child, islands, lm_mesh_runs["train_gemma-2b"], mp_runs)
    lap("15 dry run")
    return mp_runs


def lm_mesh_main():
    """`python3 chip_smoke.py --lm-mesh`: phase 10 (a), then phases 12-15
    (`lm_mesh_phases`), each with its checks; ends with its timing line."""
    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    build.load("gp_eval")
    lap = Laps(t0)
    _, _, islands = _mesh_islands()
    emit("mesh", run="islands", nvidia_smi=card, **islands)
    lap("10 (a) islands")
    mp_runs = lm_mesh_phases(islands, lap)
    emit("timing", nvidia_smi=card, cards=torch.cuda.device_count(), ranks=mp_runs["world"],
         phase_s=lap, total_s=time.perf_counter() - t0)


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
    lap = Laps(t0)
    registers, unchanged = _registers()
    emit("card", nvidia_smi=card, torch=torch.__version__, cuda=torch.version.cuda,
         name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         build_s=build_s, ptxas=_ptxas_lines(), registers=registers,
         one_moment_registers_unchanged=unchanged)

    parent = sys.argv[sys.argv.index("--parent") + 1] if "--parent" in sys.argv else None
    before = parent_phase2(parent) if parent else None
    lap("1 build")
    perf, max_err, max_rel = kernel_vs_plain()
    if parent:
        ab_lines("parent, before", before, perf)
        ab_lines("parent, after", parent_phase2(parent), perf)
    two_timed, _, two_errs = two_pass_kernels()
    table_modes()
    points_per_thread()
    many_trees()
    lap("2 kernels, 2b two-pass kernels")

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

    lap("3-5 main path, ligo, quickstart")
    runs = postfix_paths()
    lap("6 postfix")
    two_runs = two_pass_paths()
    lap("6b two-pass")
    isl_runs = island_paths()
    lap("7 islands")
    stream_runs, _ = stream_paths(main_run["history"])
    lap("8 stream")
    _, service_of = service_paths()
    lap("9 service")
    mesh_runs = mesh_paths()
    lap("10 mesh")
    lm_paths()
    lap("11 lm serve")
    mp_runs = lm_mesh_phases(mesh_runs["islands"], lap)
    emit("timing", phase_s=lap, total_s=time.perf_counter() - t0)
    # the mesh path's launches (phase 10), from the run whose work each
    # kernel does there; the probe is not on it (mesh steps carry no cache)
    mesh_of = {"eval_fitness": "islands", "eval_fitness_postfix": "postfix_off",
               "eval_fitness_from_subtrees": "postfix_exact_cap1400",
               "eval_fitness_from_preds": "postfix_exact_cap6301",
               "unique_table": "postfix_exact_cap6301"}
    # the multi-process path's launches (phase 14, process 0): B1 in (a),
    # B2, the table and B4 in (b); B3 and the probe are not on it
    mp_of = {"eval_fitness": "islands", "eval_fitness_postfix": "postfix",
             "eval_fitness_from_preds": "postfix", "unique_table": "postfix"}
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
        # the tenant block has no semantic tier: the probe is not on the path
        "service_launches": service_of.get(name, (0, None))[0],
        "service_block_generations": service_of.get(name, (0, None))[1],
        "mesh_launches": (mesh_runs[mesh_of[name]]["launches"][name]
                          if name in mesh_of else 0),
        "mesh_generations": (mesh_runs[mesh_of[name]]["generations"]
                             if name in mesh_of else None),
        "mp_launches": (mp_runs[mp_of[name]]["launches"].get(name, 0)
                        if name in mp_of else 0),
        "mp_generations": (mp_runs[mp_of[name]]["generations"]
                           if name in mp_of else None),
        **two_pass_fields(name)}
        for name in gp_eval.KERNELS]}),
        flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dryrun"]:
        _dryrun_child(sys.argv[2], int(sys.argv[3]))
    elif sys.argv[1:2] == ["--mp-profile"]:
        mp_profile_main()
    elif sys.argv[1:2] == ["--lm-mesh"]:
        lm_mesh_main()
    else:
        main()
