"""The dry run: every (architecture x shape x mesh) cell and the GP pod
cells traced on `meta` tensors, with no card and no allocation (port of
`repro/launch/dryrun.py`). Records each cell's memory a card, its
collective bytes and its FLOPs for the roofline.

MUST run in a process of its own: a cell joins a fake process group
(`torch.distributed`'s "fake" backend, with `FakeStore` from
`torch.testing._internal.distributed.fake_pg`, a module private to
PyTorch) for the whole process, and refuses to start where
`torch.distributed` is already initialized.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-32b \\
        --shape train_4k [--multi-pod] [--out artifacts/dryrun]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --gp karoo-kat7-pod [--gp-impl cuda]

The reference compiles each cell for its 256 or 512 devices; the port has
no compiler to ask, so it runs its own code as the deployment runs it,
one process a card: process `rank` of a fake group of `processes` (by
default one a shard of the mesh, rank 0) builds the production mesh
(`launch/mesh.make_production_mesh` on `meta`), its own parts of the
state, params or cache, and steps the cell once. The fake group runs
every collective's bookkeeping and moves no byte; `meta` tensors carry
shapes and dtypes and compute nothing. `processes=1` is the single
controller: every shard in this process, no group.

The record keeps the reference's keys (`benchmarks/roofline.py` reads
them); what each column is here:

  trace_s            the wall time of building the cell and its one step
                     on `meta` (the reference's `compile_s`)
  flops              `torch.utils.flop_counter.FlopCounterMode` over the
                     step, forward and backward: matmul, convolution and
                     attention ops only (`flops_counted`); XLA's count also
                     includes element-wise work
  collective_bytes   {kind: bytes} of this process's collectives, each
                     counted by its RESULT (the reference's convention:
                     the gathered size of an all-gather, the output of an
                     all-to-all, the tensor of an all-reduce or broadcast),
                     under XLA's kind names
  sent_bytes, received_bytes, collective_calls
                     what this process sends and receives, counted as
                     `chip_smoke.py`'s `_Moved` counts a real run's
                     (a collective's own part of its output is neither)
  memory.argument_gb this process's parts of the state, params or cache,
                     and its blocks of the inputs (the batch rows, the
                     tokens its shards read), as the reference's per-device
                     argument holds them
  memory.output_gb   what the step returns on this process
  memory.alias_gb    the part of the output that is the arguments written
                     in place (the state in train, the cache in decode:
                     the reference's donation)
  memory.temp_gb     `torch.distributed._tools.mem_tracker.MemTracker`'s
                     peak over the step less the bytes live when it starts
  kernel_launches    each kernel wrapper's launches a card would make
                     (`kernels/gp_eval.meta_launches`: a GP cell with
                     `--gp-impl cuda`; the LM cells run no kernel)

Not portable, and recorded as null with the reason under `not_portable`:
`code_mb` (XLA's generated code: eager PyTorch generates none, and the
CUDA kernels' code is the build's) and `bytes_accessed` (XLA's count of
the bytes each HLO op touches: no eager counterpart; an analytic count
replaces it in the roofline). `--keep-hlo` writes the step's dispatched
aten ops with their shapes and dtypes to `<cell>.ops.txt`, where the
reference writes the HLO text: what the cell runs and where its
collectives sit.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import all_arch_names, get_config
from repro_torch.launch import mesh as TM
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import P, Sharded
from repro_torch.models import model as Md

NOT_PORTABLE = {
    "code_mb": "XLA's generated code has no eager counterpart: PyTorch generates no "
               "program, and the CUDA kernels' code is the build's",
    "bytes_accessed": "XLA's bytes per HLO op have no eager counterpart; an analytic "
                      "count replaces it in the roofline",
}
FLOPS_COUNTED = ("matmul, convolution and attention ops (torch.utils.flop_counter), "
                 "forward and backward; XLA's count also includes element-wise work")

# ---------------------------------------------------------------------------
# the fake process group
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def fake_group(processes: int, rank: int = 0):
    """This process as process `rank` of a fake group of `processes`
    (none for one): collectives keep their bookkeeping and move nothing.
    On exit the group is destroyed and `launch/mesh.py`'s cache of
    subgroups cleared (they belong to the group)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        raise RuntimeError("the dry run needs a process of its own: torch.distributed is "
                           "already initialized here")
    if not 0 <= rank < max(processes, 1):
        raise ValueError(f"rank {rank} of {processes} processes")
    if processes <= 1:
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=processes)
    try:
        yield
    finally:
        dist.destroy_process_group()
        TM._GROUPS.clear()


# ---------------------------------------------------------------------------
# collective accounting
# ---------------------------------------------------------------------------

# c10d ops -> XLA's kind names (broadcast has none there)
_KINDS = {"allgather_": "all-gather", "_allgather_base_": "all-gather",
          "allgather_into_tensor_coalesced_": "all-gather",
          "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
          "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
          "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
          "broadcast_": "broadcast", "send": "collective-permute",
          "recv_": "collective-permute"}


def _nbytes(t) -> int:
    if isinstance(t, (list, tuple)):
        return sum(_nbytes(x) for x in t)
    return t.numel() * t.element_size()


class _Wire(TorchDispatchMode):
    """Counts the c10d ops a step dispatches: each kind's RESULT bytes
    (`collective_bytes`), and the bytes this process sends and receives
    as `chip_smoke.py`'s `_Moved` counts them."""

    def __init__(self):
        super().__init__()
        self.kinds, self.sent, self.received, self.calls = {}, 0, 0, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.name().split("::")[-1].split(".")[0]
        if func.namespace == "c10d" and name in _KINDS:
            a = dict(zip((x.name for x in func._schema.arguments), args))
            a.update(kwargs)
            self._count(name, a)
        return func(*args, **kwargs)

    def _count(self, name, a):
        import torch.distributed as dist

        pg = a["process_group"]
        if not isinstance(pg, dist.ProcessGroup):  # the op's boxed form
            pg = dist.ProcessGroup.unbox(pg)
        n, me = pg.size(), pg.rank()
        kind = _KINDS[name]
        self.calls += 1
        if name in ("allgather_", "_allgather_base_", "allgather_into_tensor_coalesced_"):
            out = a.get("output_tensors", a.get("output_tensor", a.get("outputs")))
            inp = a.get("input_tensors", a.get("input_tensor", a.get("inputs")))
            result = _nbytes(out)
            self.sent += _nbytes(inp)
            self.received += result - _nbytes(inp)
        elif name in ("alltoall_base_", "alltoall_"):
            out = a.get("output", a.get("output_tensors"))
            inp = a.get("input", a.get("input_tensors"))
            result = _nbytes(out)
            if name == "alltoall_base_":
                sizes = a.get("output_split_sizes")
                own = (sizes[me] if sizes else out.numel() // n) * out.element_size()
            else:
                own = _nbytes(out[me])
            self.sent += _nbytes(inp) - own
            self.received += result - own
        else:
            t = a.get("tensors", a.get("output_tensors", a.get("output_tensor")))
            result = _nbytes(t)
            self.sent += result * (n > 1)
            self.received += result * (n > 1)
        self.kinds[kind] = self.kinds.get(kind, 0) + result


def collective_bytes(wire: _Wire) -> dict:
    """{kind: bytes} of the collectives a `_Wire` saw, by their RESULT
    shape (`dryrun.py:64` of the reference): for an all-gather the
    gathered size, for an all-to-all its output, for an all-reduce or a
    broadcast its tensor. Raw sizes; the wire cost is modelled in the
    roofline."""
    return dict(sorted(wire.kinds.items()))


class _Ops(TorchDispatchMode):
    """The step's dispatched aten ops, one line each with the shapes and
    dtypes of its tensor arguments (`--keep-hlo`)."""

    def __init__(self):
        super().__init__()
        self.lines = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        def desc(x):
            if isinstance(x, torch.Tensor):
                return f"{str(x.dtype).removeprefix('torch.')}{list(x.shape)}"
            if isinstance(x, (list, tuple)) and any(isinstance(y, torch.Tensor) for y in x):
                return "[" + ", ".join(desc(y) for y in x) + "]"
            return None

        parts = [d for d in map(desc, list(args) + list((kwargs or {}).values())) if d]
        self.lines.append(f"{func}({', '.join(parts)})")
        return func(*args, **(kwargs or {}))


# ---------------------------------------------------------------------------
# bytes a process holds
# ---------------------------------------------------------------------------


def _tensors(tree) -> list:
    """This process's tensors of a tree: a `Sharded`'s local parts, the
    leaves of a `ShardedLM` / `ShardedCache`, dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, Sharded):
        return tree.local()
    if isinstance(tree, (SH.ShardedLM, SH.ShardedCache)):
        return _tensors(tree._tree)
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def _storages(tree) -> dict:
    """{storage: bytes} of the tensors of `tree`, each storage once."""
    out = {}
    for t in _tensors(tree):
        s = t.untyped_storage()
        out[s._cdata] = s.nbytes()
    return out


def _input_bytes(mesh, t, spec) -> int:
    """The bytes of this process's blocks of input `t` under `spec`: the
    blocks its shards read, each once."""
    blocks = {tuple((b.start, b.stop) for b in mesh._block(s, t.shape, spec))
              for s in mesh.local}
    per = math.prod(t.shape) * t.element_size() // math.prod(
        mesh.axis_size(a) for part in spec for a in TM._names(part))
    return len(blocks) * per


# ---------------------------------------------------------------------------
# cell lowering
# ---------------------------------------------------------------------------


def make_policy(mesh):
    """The ShardingPolicy of `mesh` (`launch/sharding.policy_for`)."""
    return SH.policy_for(mesh)


@dataclasses.dataclass
class Cell:
    """One cell ready to step on `meta`: `run()` steps it once; `held`
    the arguments this process holds (its parts), `inputs` [(tensor,
    spec)] the inputs it takes."""

    run: Callable
    held: object
    inputs: list
    mesh: object


def _shape_name(shape) -> str:
    if isinstance(shape, str):
        return shape
    return f"{shape['kind']}_B{shape['batch']}_S{shape['seq']}"


def _batch_inputs(cfg, batch) -> list:
    """[(tensor, spec)] of a batch placed by `batch_specs`."""
    return list(zip(SH._leaves(batch), SH._leaves(SH.batch_specs(cfg, batch),
                                                   is_leaf=lambda x: isinstance(x, P))))


def lower_cell(cfg, shape, mesh) -> Cell:
    """The `Cell` of one (arch x shape x mesh) cell: `shape` a `SHAPES`
    name or {kind, batch, seq}. train: `launch/train.build` on `mesh`
    and `Md.input_specs`' batch; prefill: a `ShardedLM` placed by
    `param_specs`, then `Md.prefill`; decode: a `ShardedCache` of zeros
    placed by `cache_specs` (sequence-sharded at batch 1, as the
    reference's long-context cells), then `Md.make_serve_step`."""
    from repro_torch.launch import train as TL

    cfg = cfg.with_policy(make_policy(mesh))
    kind, specs = Md.input_specs(cfg, shape)
    b_axes = tuple(cfg.policy.batch)
    s = Md.SHAPES[shape] if isinstance(shape, str) else shape
    if kind == "train":
        cfg, state, step, _ = TL.build(cfg, mesh)
        return Cell(lambda: step(state, specs), state, _batch_inputs(cfg, specs), mesh)
    params = Md.init_params(cfg, 0, device="meta")
    sharded = SH.ShardedLM.place(cfg, mesh, params, SH.param_specs(
        cfg, SH.ref_layout(params.tree()), mesh))
    del params
    if kind == "prefill":
        return Cell(lambda: Md.prefill(cfg, sharded, specs, max_len=s["seq"]), sharded,
                    _batch_inputs(cfg, specs), mesh)
    seq_shard = s["batch"] == 1  # long-context: the cache's sequence over the batch axes
    cache_specs = SH.cache_specs(cfg, specs["cache"], mesh, seq_shard=seq_shard)
    cache = SH.ShardedCache(mesh, SH.zeros(mesh, cache_specs, specs["cache"]))
    token, cur_len = specs["token"], specs["cur_len"]
    step = Md.make_serve_step(cfg)
    inputs = [(token, P(None, None) if seq_shard else P(b_axes, None)), (cur_len, P())]
    return Cell(lambda: step(sharded, cache, token, cur_len), (sharded, cache), inputs, mesh)


def argument_bytes(cell: Cell) -> int:
    """The bytes of `cell`'s arguments on this process: its parts (each
    storage once) and its blocks of the inputs."""
    return sum(_storages(cell.held).values()) + sum(
        _input_bytes(cell.mesh, t, spec) for t, spec in cell.inputs)


def analyze(cell: Cell, *, want_hlo: bool = False) -> dict:
    """Step `cell` once under three modes (the collectives, `MemTracker`
    and `FlopCounterMode`) -> the record's figures."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels import gp_eval

    held = _storages(cell.held)
    argument = argument_bytes(cell)
    tracker = MemTracker()
    tracker.track_external(*_tensors(cell.held), *(t for t, _ in cell.inputs))
    wire, flops = _Wire(), FlopCounterMode(display=False)
    ops = _Ops() if want_hlo else contextlib.nullcontext()
    gp_eval.reset_launches()
    t0 = time.perf_counter()
    with tracker:
        live = _total(tracker.get_tracker_snapshot("current"))
        with flops, wire, ops:
            out = cell.run()
        peak = _total(tracker.get_tracker_snapshot("peak"))
    trace_s = time.perf_counter() - t0
    produced = _storages(out)
    rec = {
        "trace_s": trace_s,
        "flops": float(flops.get_total_flops()),
        "flops_counted": FLOPS_COUNTED,
        "bytes_accessed": None,
        "collective_bytes": collective_bytes(wire),
        "sent_bytes": wire.sent,
        "received_bytes": wire.received,
        "collective_calls": wire.calls,
        "memory": {
            "argument_gb": argument / 2**30,
            "output_gb": sum(produced.values()) / 2**30,
            "temp_gb": max(peak - live, 0) / 2**30,
            "alias_gb": sum(b for s, b in produced.items() if s in held) / 2**30,
            "code_mb": None,
        },
        "kernel_launches": {k: v for k, v in gp_eval.meta_launches.items() if v},
        "not_portable": NOT_PORTABLE,
    }
    if want_hlo:
        rec["hlo"] = "\n".join(ops.lines) + "\n"
    return rec


def _total(snapshot: dict) -> int:
    return sum(d.get("Total", 0) for d in snapshot.values())


def _cell_mesh(shape: dict):
    return TM.make_host_mesh(**shape, device="meta")


def _production(multi_pod: bool) -> dict:
    return {"pod": 2, "data": 16, "model": 16} if multi_pod else {"data": 16, "model": 16}


def _write(rec: dict, out_dir: str, stem: str) -> None:
    hlo = rec.pop("hlo", None)
    if not out_dir:
        return
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, stem + ".json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    if hlo is not None:
        with open(path.replace(".json", ".ops.txt"), "w") as f:
            f.write(hlo)


def run_cell(arch: str, shape, multi_pod: bool, out_dir: str, keep_hlo: bool = False, *,
             rank: int = 0, processes: int | None = None, cfg=None,
             mesh: dict | None = None) -> dict:
    """Dry-run one cell as process `rank` of `processes` (default one a
    shard of the mesh; 1: the single controller) -> its record, written
    to `out_dir` as `{arch}_{shape}_{sp|mp}.json`. `cfg` replaces the
    arch's config and `mesh` ({axis: size}) the production mesh (the
    tests' reduced cells). A cell that raises gets status FAIL with the
    trace: a fault of the port."""
    shape_axes = mesh or _production(multi_pod)
    n = processes if processes is not None else math.prod(shape_axes.values())
    cfg = cfg if cfg is not None else get_config(arch)
    base = {"arch": arch, "shape": _shape_name(shape), "multi_pod": multi_pod,
            "processes": n, "rank": rank}
    if isinstance(shape, str) and not Md.shape_supported(cfg, shape):
        rec = {**base, "status": "skip:full-attn"}
    else:
        with fake_group(n, rank):
            try:
                t0 = time.perf_counter()
                cell = lower_cell(cfg, shape, _cell_mesh(shape_axes))
                built = time.perf_counter() - t0
                rec = {**base, "status": "ok", **analyze(cell, want_hlo=keep_hlo)}
                rec["trace_s"] += built
            except Exception as e:  # a failure here is a fault of the port
                rec = {**base, "status": "FAIL", "error": f"{type(e).__name__}: {e}",
                       "trace": traceback.format_exc()[-4000:]}
    _write(rec, out_dir, f"{arch}_{_shape_name(shape)}_{'mp' if multi_pod else 'sp'}")
    return rec


# ---------------------------------------------------------------------------
# GP (paper-workload) cells
# ---------------------------------------------------------------------------

GP_CELLS = {
    # name: (pop, n_features, rows, kernel)  — production-scale Karoo runs
    "karoo-kat7-pod": (4096, 9, 4_194_304, "c"),
    "karoo-ligo-pod": (1024, 1373, 524_288, "c"),
    "karoo-kepler-pod": (8192, 2, 1_048_576, "r"),
}


def _gp_session(name, mesh_axes):
    """(label, GPSession keywords, rows, mesh axes) of a GP_CELLS name or
    of a dict of session keywords with `rows` (the dataset's), `topology`
    ({axis: size}) and an optional `name`."""
    if isinstance(name, str):
        pop, F, rows, kern = GP_CELLS[name]
        kw = dict(name=name, pop_size=pop, max_depth=5, n_features=F, n_consts=8,
                  kernel=kern)
        return name, kw, rows, mesh_axes
    kw = dict(name)
    rows, topology = kw.pop("rows"), kw.pop("topology", None)
    label = kw.setdefault("name", "session")
    return label, kw, rows, topology or mesh_axes


def run_gp_cell(name, multi_pod: bool, out_dir: str, keep_hlo: bool = False,
                eval_impl: str = "torch", block_steps: int = 10, *, rank: int = 0,
                processes: int | None = None) -> dict:
    """Dry-run one GP cell as a K-generation evolution block, the block
    `GPSession.evolve()` dispatches on a mesh (`build_sharded_block`), on
    a `meta` state and dataset. `name` is a `GP_CELLS` name or a dict of
    session keywords (see `_gp_session`); `eval_impl` the port's backend
    (`torch`, or `cuda`: each kernel wrapper counts a card's launches on
    `meta`, `kernel_launches`)."""
    from repro_torch.core import engine, prng
    from repro_torch.gp import GPSession

    label, kw, rows, axes = _gp_session(name, _production(multi_pod))
    n = processes if processes is not None else math.prod(axes.values())
    base = {"arch": label, "multi_pod": multi_pod, "processes": n, "rank": rank}
    with fake_group(n, rank):
        try:
            t0 = time.perf_counter()
            mesh = _cell_mesh(axes)
            sess = GPSession(backend=eval_impl, topology=mesh, device="meta", **kw)
            cfg = sess.config
            block, _ = sess.build_sharded_block(block_steps)
            state = engine.init_state(cfg, prng.PRNGKey(0), device="meta")
            data = mesh.axis_size("data")
            D = -(-rows // data) * data  # zero-weight padded to the data axis, as ingest pads
            F = cfg.tree_spec.n_features
            X = torch.empty((F, D), device="meta")
            y, w = torch.empty((D,), device="meta"), torch.empty((D,), device="meta")
            limit = torch.empty((), dtype=torch.int32, device="meta")
            inputs = [(X, P(None, "data")), (y, P("data")), (w, P("data")), (limit, P())]
            cell = Cell(lambda: block(state, X, y, w, limit), state, inputs, mesh)
            built = time.perf_counter() - t0
            rec = {**base, "shape": f"pop{cfg.pop_size}_rows{D}_F{F}_K{block_steps}",
                   "status": "ok", **analyze(cell, want_hlo=keep_hlo)}
            rec["trace_s"] += built
        except Exception as e:
            rec = {**base, "status": "FAIL", "error": f"{type(e).__name__}: {e}",
                   "trace": traceback.format_exc()[-4000:]}
    _write(rec, out_dir, f"{label}_{'mp' if multi_pod else 'sp'}")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--gp")
    ap.add_argument("--gp-impl", default="torch", help="the port's backend: torch or cuda")
    ap.add_argument("--gp-block", type=int, default=10,
                    help="generations per lowered GP evolution block")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--keep-hlo", action="store_true")
    ap.add_argument("--out", default="benchmarks/artifacts/dryrun")
    args = ap.parse_args(argv)

    if args.gp:
        rec = run_gp_cell(args.gp, args.multi_pod, args.out, args.keep_hlo,
                          args.gp_impl, block_steps=args.gp_block)
        print(json.dumps({k: v for k, v in rec.items() if k != "trace"}, indent=1))
        raise SystemExit(0 if rec["status"] != "FAIL" else 1)

    cells = ([(args.arch, args.shape)] if args.arch and args.shape else
             [(a, s) for a in all_arch_names() for s in Md.SHAPES])
    if not args.all and not (args.arch and args.shape):
        ap.error("need --arch+--shape, --gp, or --all")
    failures = 0
    for arch, shape in cells:
        rec = run_cell(arch, shape, args.multi_pod, args.out, args.keep_hlo)
        line = {k: rec.get(k) for k in ("arch", "shape", "status", "trace_s",
                                        "flops", "error")}
        print(json.dumps(line), flush=True)
        failures += rec["status"] == "FAIL"
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
