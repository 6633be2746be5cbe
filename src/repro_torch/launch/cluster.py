"""Cluster bring-up: the launch environment, each process's batch slice
and the production mesh (port of `repro/launch/cluster.py`).

On a multi-host deployment every host runs the same entry point. This
module (a) reads the process layout from the environment
(COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID, or SLURM's), (b)
builds the production mesh over the cards, and (c) gives each process its
disjoint slice of the global batch.

`init_cluster` for one process is the reference's no-op: the mesh is
single-controller (`launch/mesh.py`). For several processes it joins
them in a `torch.distributed` group, one process a card: NCCL on the
cards, gloo only when the caller asks for the CPU. After it, every
process builds the same mesh (`make_host_mesh`, `cluster_mesh`,
`GPSession(topology=...)`) and holds its own shards' parts, and the
mesh's group collectives cross the processes. Launch N processes with

    COORDINATOR_ADDRESS=host:port NUM_PROCESSES=N PROCESS_ID=i python ...

each calling `init_cluster()` first (SLURM's variables do as well).
"""
from __future__ import annotations

import dataclasses
import os

import torch

from repro_torch.device import resolve_device, set_process_card
from repro_torch.launch.mesh import make_production_mesh, process_rank


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


def init_cluster(info: ClusterInfo | None = None, device=None) -> ClusterInfo:
    """Join the processes of `info` (default: `cluster_env()`). One
    process with no coordinator: nothing to do. Several (or one given a
    coordinator, a group of one that runs the same path): `torch.distributed` at
    `tcp://{coordinator}` (or the coordinator as given where it is a URL,
    such as `file://` in the tests) with the world size and rank of
    `info`. The process's card is `device`, default
    `cuda:{process_id mod the card count}`, and the group's backend NCCL;
    `device="cpu"` asks for the CPU and gloo. No card raises, as
    `resolve_device` does: there is no fallback to gloo or the CPU."""
    import torch.distributed as dist

    info = info or cluster_env()
    if info.num_processes <= 1 and not info.coordinator:
        return info
    if not info.coordinator:
        raise ValueError(f"{info.num_processes} processes need a coordinator address "
                         "(COORDINATOR_ADDRESS=host:port)")
    if device is None:
        resolve_device("cuda")
        device = torch.device("cuda", info.process_id % torch.cuda.device_count())
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", info.process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        set_process_card(dev)
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"init_cluster runs on a card or on the CPU, got {dev}")
    url = info.coordinator if "://" in info.coordinator else f"tcp://{info.coordinator}"
    if dist.is_initialized():
        raise RuntimeError("init_cluster: this process already joined a process group")
    dist.init_process_group(backend, init_method=url, world_size=info.num_processes,
                            rank=info.process_id)
    return info


def close_cluster() -> None:
    """Leave the process group `init_cluster` joined (a no-op without one)."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def host_batch_slice(global_batch: int, info: ClusterInfo) -> slice:
    """Disjoint per-host slice of the global batch."""
    if global_batch % info.num_processes:
        raise ValueError(f"global batch {global_batch} % hosts "
                         f"{info.num_processes} != 0")
    per = global_batch // info.num_processes
    return slice(info.process_id * per, (info.process_id + 1) * per)


def cluster_mesh(*, multi_pod: bool | None = None, device=None):
    """The production mesh over the cards (`device`'s, default every card;
    after `init_cluster`, every process's). multi_pod defaults to whether
    there are more than 256."""
    dev = resolve_device(device)
    n = torch.cuda.device_count() if dev.type == "cuda" and dev.index is None else 1
    n *= process_rank()[0]
    if multi_pod is None:
        multi_pod = n > 256
    return make_production_mesh(multi_pod=multi_pod, device=device)
