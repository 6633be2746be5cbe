"""Cluster bring-up: the launch environment, each process's batch slice
and the production mesh (port of `repro/launch/cluster.py`).

On a multi-host deployment every host runs the same entry point. This
module (a) reads the process layout from the environment
(COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID, or SLURM's), (b)
builds the production mesh over the cards, and (c) gives each process its
disjoint slice of the global batch.

The port's mesh is single-controller (`launch/mesh.py`): one process
holds every shard and runs the collectives in turn. So `init_cluster`
for one process is the reference's no-op, and a layout of several
processes raises: a multi-process mesh over `torch.distributed`, whose
collectives replace the single controller's in-turn ones, is ROADMAP
item A13d.
"""
from __future__ import annotations

import dataclasses
import os

import torch

from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_production_mesh


@dataclasses.dataclass(frozen=True)
class ClusterInfo:
    num_processes: int
    process_id: int
    coordinator: str | None

    @property
    def is_coordinator(self) -> bool:
        return self.process_id == 0


def cluster_env(environ=None) -> ClusterInfo:
    """Parse the launch environment (explicit vars > SLURM > single)."""
    env = environ if environ is not None else os.environ
    if "COORDINATOR_ADDRESS" in env:
        return ClusterInfo(int(env.get("NUM_PROCESSES", "1")),
                           int(env.get("PROCESS_ID", "0")),
                           env["COORDINATOR_ADDRESS"])
    if "SLURM_NTASKS" in env and int(env["SLURM_NTASKS"]) > 1:
        nodelist = env.get("SLURM_STEP_NODELIST", env.get("SLURM_NODELIST", ""))
        head = nodelist.split(",")[0].replace("[", "").split("-")[0]
        return ClusterInfo(int(env["SLURM_NTASKS"]),
                           int(env.get("SLURM_PROCID", "0")),
                           f"{head}:12345" if head else None)
    return ClusterInfo(1, 0, None)


def init_cluster(info: ClusterInfo | None = None) -> ClusterInfo:
    """The process layout, checked: one process is the whole cluster."""
    info = info or cluster_env()
    if info.num_processes > 1:
        raise NotImplementedError(
            f"{info.num_processes} processes: the port's mesh is single-controller; a "
            "multi-process mesh over torch.distributed is ROADMAP A13d")
    return info


def host_batch_slice(global_batch: int, info: ClusterInfo) -> slice:
    """Disjoint per-host slice of the global batch."""
    if global_batch % info.num_processes:
        raise ValueError(f"global batch {global_batch} % hosts "
                         f"{info.num_processes} != 0")
    per = global_batch // info.num_processes
    return slice(info.process_id * per, (info.process_id + 1) * per)


def cluster_mesh(*, multi_pod: bool | None = None, device=None):
    """The production mesh over the process's cards (`device`'s, default
    every card). multi_pod defaults to whether there are more than 256."""
    dev = resolve_device(device)
    n = torch.cuda.device_count() if dev.type == "cuda" and dev.index is None else 1
    if multi_pod is None:
        multi_pod = n > 256
    return make_production_mesh(multi_pod=multi_pod, device=device)
