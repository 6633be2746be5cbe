"""GPService — multi-tenant GP-as-a-service on one tenant block (port of
`repro/service/scheduler.py`).

The scheduler drives `core.engine.build_tenant_block` — one K-generation
block over a fixed `[I, P, N]` island batch — and does all job
management at block boundaries on the host:

    submit()   validate + enqueue (a JobHandle is returned immediately)
    admit      free slots are filled from the queue (packer.pack_order);
               a job's island sub-state is spliced in
               (islands.splice_island) — fresh, or the saved sub-state of
               a preempted/repacked job
    dispatch   one block = K generations for every slot, then ONE host
               read of the block's results; finished slots are frozen on
               the device (tenant_active), so ragged budgets never block
               the batch
    publish    finished/cancelled jobs are lifted out of the host copy,
               their champion decoded, their slot freed for the next
               queued job — all operand rebinding, never a new block

Each slot is evaluated through the backend a solo `GPSession` takes on
the service's device (`cuda` on the card: B1 for heap trees, B2 or the
unique table and B3/B4 for postfix; `torch` on the CPU), so a packed job
is bitwise its solo run.

Fault tolerance: the drain loop is `runtime.fault.run_with_restarts`
steps (one step = one block, checkpointed by `ckpt.CheckpointManager`,
restored after an injected or real failure), every occupied slot beats a
`HeartbeatMonitor` worker that is `remove()`d on eviction, and a
`StepMonitor` tracks per-block wall time. A checkpoint taken at one slot
count can be repacked onto a service with another via `adopt()` — jobs
are slot-position independent because every slot-varying value is an
operand.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.core import fitness as fit
from repro_torch.core import prng
from repro_torch.core.engine import TenantParams, TenantState
from repro_torch.core.islands import splice_island, take_island
from repro_torch.core.trees import TreeSpec, to_string
from repro_torch.device import resolve_device
from repro_torch.gp.backends import get_backend
from repro_torch.obs import counters as _tc
from repro_torch.obs.metrics import BlockMonitor, Metrics
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.runtime.fault import HeartbeatMonitor, StepMonitor, run_with_restarts
from repro_torch.service.job import CANCELLED, DONE, PENDING, RUNNING, JobHandle, JobSpec
from repro_torch.service.packer import JobBatch, pack_order, slot_buffers

# every registered kernel with a whole-dataset partial_fitness — the
# default kernel set of a service
DEFAULT_KERNELS = ("r", "c", "m", "mse", "pearson", "r2")


def _host_copy(tensors) -> list[np.ndarray]:
    """Device tensors of 4- or 8-byte dtypes -> numpy arrays in ONE
    device-to-host copy (their bytes packed into one int32 buffer)."""
    flat = [t.contiguous().view(torch.int32).reshape(-1) for t in tensors]
    buf = torch.cat(flat).cpu().numpy()
    out, at = [], 0
    for t, f in zip(tensors, flat):
        n = f.numel()
        dtype = torch.empty((), dtype=t.dtype).numpy().dtype
        out.append(buf[at:at + n].view(dtype).reshape(t.shape))
        at += n
    return out


class GPService:
    """A multi-tenant GP scheduler with a fixed packed layout.

    Static shape (chosen once): `slots` islands of `pop_size` trees over
    `tree_spec` (or max_depth/n_features shorthand), per-slot data
    capacity `data_cap`, the `kernels` a job may pick from, the
    tournament draw size `tourn_draw` (an upper bound on any job's
    tourn_size) and `elitism`. Everything else is per job.

    `device=` (default: the card) places the batch; the slots are
    evaluated with the backend `GPSession(backend="auto")` resolves
    there (`cuda` on the card, `torch` on the CPU).

    `block_size` is K, the generations per dispatch — the admission/
    eviction (and checkpoint/restart) quantum. `checkpoint_dir` arms
    restart-from-checkpoint; `checkpoint_every` counts blocks.
    `fault_hook(block_index)` is the failure-injection point the tests
    use — it runs at the top of every scheduler step and may raise.
    `dedup`/`dedup_cap` engage exact-tier subexpression dedup in every
    slot's evaluation (postfix genomes; bitwise the same fitness).

    `stats["compiles"]` counts the tenant blocks the service built. Eager
    PyTorch compiles nothing: the service builds its block once and
    rebinds the operands on every admission and eviction, so the count
    stays 1 (the reference's count of jit compilations)."""

    def __init__(self, *, slots: int = 8, pop_size: int = 64,
                 tree_spec: TreeSpec | None = None, max_depth: int = 5,
                 n_features: int = 4, data_cap: int = 256,
                 kernels: tuple = DEFAULT_KERNELS, tourn_draw: int = 10,
                 elitism: int = 1, block_size: int = 8,
                 strategy: str = "fifo", checkpoint_dir: str | None = None,
                 checkpoint_every: int = 1, checkpoint_keep: int = 4,
                 heartbeat_deadline_s: float = 10.0, fault_hook=None,
                 tracer=None, metrics=None, dedup: str = "off",
                 dedup_cap: int = 0, device=None):
        if slots < 1:
            raise ValueError("slots must be >= 1")
        self.device = resolve_device(device)
        self.tree_spec = (tree_spec if tree_spec is not None
                          else TreeSpec(max_depth=max_depth,
                                        n_features=n_features))
        self.slots = slots
        self.pop_size = pop_size
        self.kernels = tuple(fit.get_kernel(k).name for k in kernels)
        self.tourn_draw = tourn_draw
        self.elitism = elitism
        self.block_size = block_size
        self.strategy = strategy
        self.backend = get_backend("auto", self.device).name
        self.batch = JobBatch(slots, self.tree_spec.n_features, data_cap,
                              self.kernels, tourn_draw, device=self.device)
        self.dedup = dedup
        self.dedup_cap = dedup_cap
        self._block = engine.build_tenant_block(
            self.tree_spec, self.kernels, tourn_draw, elitism, block_size,
            dedup=dedup, dedup_cap=dedup_cap, eval_impl=self.backend)
        self._builds = 1
        self._state = engine.empty_tenant_state(slots, pop_size, self.tree_spec,
                                                elitism=elitism, device=self.device)
        # every table a block reads is on the device before the first block
        engine._device_tables(engine.GPConfig(tree_spec=self.tree_spec, dedup=dedup),
                              self.device)
        self._gens = np.zeros((slots,), np.int64)  # host mirror of gens_done
        self._jobs: dict[int, JobHandle] = {}
        self._pending: list[JobHandle] = []
        self._next_id = 0
        self._fault_hook = fault_hook
        self.heartbeats = HeartbeatMonitor(deadline_s=heartbeat_deadline_s)
        self.monitor = StepMonitor()
        self.stats = {"blocks": 0, "admissions": 0, "evictions": 0,
                      "restarts": 0, "compiles": 0, "block_s_ema": None,
                      "stragglers": [], "cache_hits": 0, "cache_queries": 0,
                      "cache_hit_rate": 0.0, "frozen": 0, "tree_evals": 0,
                      "host_syncs": 0}
        # observability is host-side only: the tenant block is the same
        # with or without a tracer/metrics sink (the counter stream is
        # unconditional), so enabling them changes no trajectory
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.metrics = metrics if metrics is not None else Metrics()
        self._block_monitor = BlockMonitor(self.monitor, self.metrics,
                                           self.stats)
        self._manager = None
        if checkpoint_dir:
            from repro_torch.ckpt.checkpoint import CheckpointManager

            self._manager = CheckpointManager(checkpoint_dir,
                                              keep=checkpoint_keep,
                                              every=checkpoint_every)
        self._host_state = None  # the last block's full state on the host
        self._live_snap = None
        self._ckpt_step = 0  # block index of the restart policy's clock

    # --- tenant API -----------------------------------------------------------

    def submit(self, spec: JobSpec) -> JobHandle:
        """Validate against the service's layout and enqueue. Returns the
        job's handle immediately — the scheduler loop (`run`/`result`)
        does the work."""
        self.batch.validate(spec)
        handle = JobHandle(self._next_id, spec)
        self._next_id += 1
        self._jobs[handle.job_id] = handle
        self._pending.append(handle)
        return handle

    def poll(self, job_id: int) -> dict:
        """Plain-data progress snapshot of one job (no device sync — the
        scheduler mirrors everything host-side at block boundaries)."""
        return self._jobs[job_id].snapshot()

    def result(self, job_id: int, *, drive: bool = True,
               max_blocks: int = 100_000) -> JobHandle:
        """The job's handle once it finished. With drive=True (default)
        the calling thread runs the scheduler loop until the whole
        queue drains — this is a single-process service; the caller IS
        the scheduler."""
        handle = self._jobs[job_id]
        if not handle.finished and drive:
            self.run(max_blocks=max_blocks)
        if not handle.finished:
            raise RuntimeError(f"job {job_id} is {handle.status} after the "
                               f"scheduler loop — raise max_blocks?")
        return handle

    def cancel(self, job_id: int) -> bool:
        """Cancel a job: a pending one leaves the queue immediately; a
        running one is evicted at the next block boundary with partial
        results. Returns False if it already finished."""
        handle = self._jobs[job_id]
        if handle.finished:
            return False
        if handle.status == PENDING:
            self._pending.remove(handle)
            handle.status = CANCELLED
            return True
        handle._cancel = True
        return True

    # --- scheduler loop -------------------------------------------------------

    def idle(self) -> bool:
        return not self._pending and not self.batch.occupied

    def run(self, *, max_blocks: int = 100_000, max_restarts: int = 3) -> "GPService":
        """Drain the queue: admit → dispatch → publish per block until no
        job is pending or resident (or `max_blocks` safety-stops).

        With a checkpoint manager, the loop runs as
        `run_with_restarts` steps — a failure (anything `fault_hook` or
        the dispatch raises) rolls back to the newest committed
        checkpoint and replays; determinism makes the replay
        bit-identical, so restarts are invisible in the results."""
        if self.idle():
            return self
        if self._manager is None:
            for _ in range(max_blocks):
                if self.idle():
                    break
                self._scheduler_step(None, self._ckpt_step)
            return self

        # commit the live state before entering the restart policy, so a
        # failure in the FIRST block of this run() cannot roll back past
        # work from a previous run() on the same service (skipped when the
        # directory is already at or past this clock — e.g. a fresh
        # process resuming someone else's checkpoints)
        from repro_torch.ckpt.checkpoint import latest_step

        latest = latest_step(self._manager.directory)
        if latest is None or latest < self._ckpt_step:
            self._live_snap = self._make_snapshot()
            self._manager.maybe_save(self._live_snap, self._ckpt_step,
                                     force=True)
            self._manager.wait()

        _, restarts = run_with_restarts(
            lambda: self._live_snap if self._live_snap is not None
            else self._make_snapshot(),
            self._scheduler_step,
            self._ckpt_step + max_blocks, self._manager,
            max_restarts=max_restarts,
            until=lambda _snap: self.idle())
        self.stats["restarts"] += restarts
        return self

    def _scheduler_step(self, snap, i):
        """One restart-policy step == one block boundary: (re)load state
        if the policy rolled back, inject faults, admit, dispatch,
        publish. Returns the committed-checkpoint payload (None without
        a checkpoint manager, which needs none)."""
        if snap is not None and snap is not self._live_snap:
            self._load_snapshot(snap)  # restored after a failure
        if self._fault_hook is not None:
            self._fault_hook(i)
        self._admit()
        self._dispatch_and_publish()
        self._ckpt_step = i + 1  # the restart policy's committed clock
        if self._manager is not None:
            self._live_snap = self._make_snapshot()
        return self._live_snap

    def _admit(self):
        free = self.batch.free_slots
        if not free or not self._pending:
            return
        with self.tracer.span("admit", args={"free": len(free),
                                             "pending": len(self._pending)}):
            chosen = pack_order(self._pending, len(free), self.strategy)
            for slot, handle in zip(free, chosen):
                self._pending.remove(handle)
                if handle._saved is not None:  # preempted/repacked: resume
                    sub, gens = handle._saved, handle.gens_done
                    handle._saved = None
                else:
                    sub, gens = engine.init_tenant_slot(
                        prng.PRNGKey(handle.spec.seed, device=self.device),
                        self.pop_size, self.tree_spec, elitism=self.elitism), 0
                self._state = splice_island(self._state, slot, sub)
                self._host_state = None  # the device state moved on
                self._gens[slot] = gens
                # a job re-admitted fresh after a rollback starts over
                handle.gens_done = gens
                handle.history = handle.history[:gens]
                self.batch.admit(slot, handle)
                handle.status = RUNNING
                self.heartbeats.beat(self._worker_id(handle))
                self.stats["admissions"] += 1
                self.metrics.inc("admissions")
                # async track: one lifetime lane per job, admission → publish
                self.tracer.begin_async("job", handle.job_id, cat="service",
                                        args={"slot": slot})
        self.metrics.gauge("occupied_slots", len(self.batch.occupied))

    def _dispatch_and_publish(self):
        X, y, w, params = self.batch.operands()
        host_params = self.batch.host_params()
        with self._block_monitor, self.tracer.span(
                "dispatch", args={"occupied": len(self.batch.occupied)}):
            self._state, hist, counters = self._block(self._state, X, y, w,
                                                      params, host_params)
            # ONE host read per block: the whole state (it is the
            # checkpoint payload and the published champions), the
            # per-generation streams and the counters come back together
            *leaves, hist, crows = _host_copy([*self._state, hist, counters])
        self.stats["host_syncs"] += 1
        host = TenantState(*leaves)
        self._host_state = host
        self._absorb_counters(crows)
        self.stats["compiles"] = self._builds
        self.metrics.gauge("compiles", self.stats["compiles"])

        budgets = host_params.budget.copy()  # publishing rewrites the live rows
        stops = host_params.stop.copy()
        total_ran = 0
        for slot, handle in self.batch.occupied:
            ran = int(host.gens_done[slot]) - int(self._gens[slot])
            total_ran += ran
            self._gens[slot] = int(host.gens_done[slot])
            handle.gens_done = int(host.gens_done[slot])
            handle.best_fitness = float(host.best_fitness[slot])
            handle.history.extend(float(b) for b in hist[:ran, slot])
            self.heartbeats.beat(self._worker_id(handle))
            if ran and self.monitor.last:
                # per-tenant progress rate over this block's wall time
                self.metrics.observe("tenant_gens_per_s",
                                     ran / self.monitor.last)
            finished = (handle.gens_done >= int(budgets[slot])
                        or handle.best_fitness <= float(stops[slot]))
            if finished or handle._cancel:
                self._publish(slot, handle, host,
                              DONE if finished else CANCELLED)
        if total_ran and self.monitor.last:
            self.metrics.gauge("gens_per_s", total_ran / self.monitor.last)
        self.metrics.gauge("occupied_slots", len(self.batch.occupied))

    def _absorb_counters(self, rows):
        """Fold a tenant block's int32[K, C] telemetry stream
        (repro_torch.obs.counters) into `stats` + the metrics registry;
        the elite-cache hit rate is derived from the accumulated totals."""
        tot = _tc.totals(rows)
        tot.pop("migrations", None)  # tenant slots never migrate
        for name, v in tot.items():
            self.stats[name] = self.stats.get(name, 0) + v
            if v:
                self.metrics.inc(name, v)
        self.stats["cache_hit_rate"] = _tc.hit_rate(self.stats)
        self.metrics.gauge("cache_hit_rate", self.stats["cache_hit_rate"])
        self.metrics.emit("counters", **tot)

    def _publish(self, slot: int, handle: JobHandle, host: TenantState,
                 status: str):
        handle.best_op = np.asarray(host.best_op[slot]).copy()
        handle.best_arg = np.asarray(host.best_arg[slot]).copy()
        if np.isfinite(handle.best_fitness):
            handle.best_expression = to_string(
                handle.best_op, handle.best_arg,
                feature_names=handle.spec.feature_names,
                const_table=self.tree_spec.const_table_numpy(),
                genome=self.tree_spec.genome)
        handle.status = status
        handle._cancel = False
        self.batch.evict(slot)
        # the slot's worker left on purpose — forget it, or dead_workers()
        # would report every finished job forever
        self.heartbeats.remove(self._worker_id(handle))
        self.stats["evictions"] += 1
        self.metrics.inc("evictions")
        self.tracer.end_async("job", handle.job_id, cat="service",
                              args={"status": status,
                                    "gens": handle.gens_done})
        self.tracer.instant("publish", cat="service",
                            args={"job": handle.job_id, "status": status})

    def _worker_id(self, handle: JobHandle) -> str:
        return f"job-{handle.job_id}"

    # --- checkpoint payload ---------------------------------------------------

    def _make_snapshot(self) -> dict:
        """Committed-checkpoint payload, in the reference's layout: the
        state as numpy leaves (key as uint32 words; the last block's host
        copy when it is current, so no second read), the parameter table
        and the slot→job map. Data buffers are NOT checkpointed — they
        are derivable from the JobSpecs, which the submitting process
        re-provides (`submit` is the durable log)."""
        slot_ids = np.full((self.slots,), -1, np.int64)
        for i, h in self.batch.occupied:
            slot_ids[i] = h.job_id
        host = self._host_state
        if host is None:
            state = engine.tenant_state_to_numpy(self._state)
        else:
            state = TenantState(*(a.astype(np.uint32) if name == "key" else a.copy()
                                  for name, a in host._asdict().items()))
        params = TenantParams(*(a.copy() for a in self.batch.host_params()))
        return {"state": state, "params": params, "slot_ids": slot_ids}

    def _load_snapshot(self, snap: dict):
        """Roll the whole service back to a committed checkpoint: device
        state, parameter table, slot map, and every affected handle's
        host mirror (status, counters, history truncation). Jobs that
        finished AFTER the checkpoint return to their slots and re-run
        their tail — determinism republishes identical results."""
        self._state = engine.tenant_state_from_numpy(snap["state"], device=self.device)
        self._host_state = None
        self.batch.restore_params(snap["params"])
        gens = np.asarray(snap["state"].gens_done)
        best = np.asarray(snap["state"].best_fitness)
        slot_ids = np.asarray(snap["slot_ids"])
        self.batch.slots = [None] * self.slots
        slotted = set()
        for i, jid in enumerate(slot_ids):
            if jid < 0:
                continue
            handle = self._jobs[int(jid)]
            slotted.add(int(jid))
            self.batch.slots[i] = handle
            handle._slot = i
            handle._saved = None
            handle.status = RUNNING
            # a rollback puts the job back in flight: reopen its lifetime
            # lane (idempotent — a still-open lane is untouched)
            self.tracer.begin_async("job", handle.job_id, cat="service",
                                    args={"slot": i, "rollback": True})
            handle.gens_done = int(gens[i])
            handle.best_fitness = float(best[i])
            handle.history = handle.history[:int(gens[i])]
            # rebuild the slot's data row from the spec (not checkpointed)
            X, yb, wb = slot_buffers(handle.spec, self.batch.n_features,
                                     self.batch.data_cap)
            self.batch._X[i], self.batch._y[i], self.batch._w[i] = X, yb, wb
        self.batch._dirty = True
        # everything not finished and not resident goes back to the queue
        self._pending = [h for jid, h in sorted(self._jobs.items())
                         if jid not in slotted and not h.finished
                         and h.status != CANCELLED]
        for h in self._pending:
            h.status = PENDING
            h._slot = None
        self._gens = gens.astype(np.int64).copy()
        self._live_snap = snap

    def adopt(self, snap: dict) -> "GPService":
        """Repack a checkpoint taken at a DIFFERENT slot count onto this
        service (elastic resume): every occupied slot's island sub-state
        is lifted out (`take_island`) and parked on its job's handle;
        the normal admission path splices it into whatever slot this
        layout has free. `snap["state"]` holds numpy leaves (this
        package's or the reference's snapshot) or a TenantState of
        tensors (`engine.tenant_state_from_numpy`). Requires the jobs to
        have been re-submitted (ids must match) and the static
        tree/population shape to agree; slot positions don't matter —
        every slot-varying value is an operand."""
        state = snap["state"]
        if not torch.is_tensor(state.op):
            state = engine.tenant_state_from_numpy(state, device=self.device)
        if tuple(state.op.shape[1:]) != (self.pop_size, self.tree_spec.num_nodes):
            raise ValueError(
                f"checkpoint population shape {tuple(state.op.shape[1:])} does not "
                f"match this service's ({self.pop_size}, "
                f"{self.tree_spec.num_nodes}) — elastic resume only varies "
                f"the slot count")
        gens = state.gens_done.cpu().numpy()
        best = state.best_fitness.cpu().numpy()
        for i, jid in enumerate(np.asarray(snap["slot_ids"])):
            if jid < 0:
                continue
            handle = self._jobs[int(jid)]
            handle._saved = take_island(state, i)
            handle.gens_done = int(gens[i])
            handle.history = handle.history[:handle.gens_done]
            handle.best_fitness = float(best[i])
            if handle not in self._pending:
                self._pending.append(handle)
            handle.status = PENDING
            handle._slot = None
        self._pending.sort(key=lambda h: h.job_id)
        return self


def run_jobs(specs: list[JobSpec], **service_kw) -> list[JobHandle]:
    """Convenience one-shot: submit every spec, drain, return handles in
    submit order (the launch CLI rides this)."""
    svc = GPService(**service_kw)
    handles = [svc.submit(s) for s in specs]
    svc.run()
    return handles
