"""GP-as-a-service: multi-tenant job scheduling on the island layout
(port of `repro/service`).

Many concurrent SMALL GP runs — the tens-to-hundreds-of-rows regime
where the paper measures its vectorization wins — packed into one
island batch. A user job is an island with no migration; everything
job-specific (data slice, fitness kernel, operator mix, tournament size,
point rate, stop bar, budget) is an operand, so jobs are admitted and
evicted at block boundaries while the tenant block stays the same.

    from repro_torch.service import GPService, JobSpec

    svc = GPService(slots=8, pop_size=64, n_features=3, data_cap=128)
    h = svc.submit(JobSpec(X, y, kernel="r", generations=40, seed=7))
    svc.run()                  # drain the queue (the caller is the scheduler)
    print(svc.result(h.job_id).best_expression)

`device=` (default: the card) places the batch; `device="cpu"` runs it
on the CPU. See docs/service.md for the job lifecycle, the packing
layout and the checkpoint/restart + elastic-resume story."""
from repro_torch.service.job import (CANCELLED, DONE, PENDING, RUNNING, JobHandle,
                                     JobSpec)
from repro_torch.service.packer import JobBatch, pack_order, slot_buffers
from repro_torch.service.scheduler import DEFAULT_KERNELS, GPService, run_jobs

__all__ = [
    "CANCELLED", "DONE", "PENDING", "RUNNING",
    "JobHandle", "JobSpec", "JobBatch", "pack_order", "slot_buffers",
    "DEFAULT_KERNELS", "GPService", "run_jobs",
]
