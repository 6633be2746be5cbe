"""The port's dry runs (`repro_torch.launch.dryrun`) for the tests, in a
process of their own: `python tests/torch_dryrun_child.py OUT.json`
writes every record the tests read. A dry run joins a fake process group
for its whole process, which a test worker must never hold, so they all
go in this one child; `DryRuns` starts it once per test run and shares
its output between test workers through a lock file, as
`torch_lm_mesh_ref.Reference` shares the reference's runs. Importing
this module starts nothing and imports neither JAX nor the port.

What it runs (the keys of the JSON):

  args.{sp|mp}.{arch}.{shape}   rank 0's argument bytes of every runnable
                                cell on the production meshes (no step)
  cell.{name}.{rank}            the records of the cells the gloo tests
                                count (`GLOO_LM`, the GP block), ranks 0-3 of 4 on
                                (data 2, model 2), and reduced gemma-2b's
                                train cell as the single controller
  cuda                          a GP cell on `meta` with the `cuda`
                                backend (`CUDA_CELL`), rank 0 of 2
  cli                           `main` on one production cell: its exit
                                code and the record it wrote
  rules                         the fake group's rules
  fake                          what the dry run takes from the fake backend
"""
import dataclasses
import fcntl
import json
import math
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))

# the steps the gloo worker counts (`torch_mp_worker.py`): (kind, batch, seq)
GLOO_LM = {"lm.gemma-2b.train": ("gemma-2b", "train", 4, 32),
           "lm.granite-moe-3b-a800m.train": ("granite-moe-3b-a800m", "train", 4, 32),
           "serve.granite-moe-3b-a800m.decode": ("granite-moe-3b-a800m", "decode", 4, 12),
           "serve.gemma-2b.decode": ("gemma-2b", "decode", 4, 12)}
GP_BLOCK = 1  # the gp scenario's counted block (generations)
# a GP cell on the cuda backend: 140,000 trees on (data 2, model 2), two
# launches of B1 a shard a generation (`pop_chunks`: 70,000 trees a shard)
CUDA_CELL = dict(name="cuda-chunks", rows=64, n_features=3, pop_size=140_000, max_depth=3,
                 kernel="r", topology={"data": 2, "model": 2})
CUDA_K, CUDA_PROCESSES = 2, 2  # rank 0 holds shards 0 and 2
CLI_CELL = ("gemma-2b", "decode_32k")


def _reduced(name, kind):
    from repro_torch.configs import get_reduced
    from torch_lm_mesh_ref import F32, TRAIN
    from torch_mp_worker import DECODE_COUNTED

    extra = TRAIN[name] if kind == "train" else DECODE_COUNTED[name]
    return dataclasses.replace(get_reduced(name), **F32, **extra)


def gp_block_cell():
    """The session keywords of the gp scenario's counted block (its ring
    island session on (pod 2, data 2, model 2), 40 rows of 2 features)."""
    from repro_torch.core.evolve import OperatorMix
    from torch_mesh_data import LAT3, MIXES, RATES, TOURN

    return dict(name="gp-block", rows=40, n_features=2, topology={"pod": 2, "data": 2, "model": 2},
                pop_size=16, migrate_every=2, migrate_k=1, island_topology="ring", islands=4,
                island_mixes=tuple(OperatorMix(*m) for m in MIXES), island_tourn_sizes=TOURN,
                island_point_rates=RATES, **LAT3)


def _arguments(res):
    from repro_torch.configs import all_arch_names, get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.models import model as Md

    for tag, multi_pod in (("sp", False), ("mp", True)):
        axes = D._production(multi_pod)
        with D.fake_group(math.prod(axes.values()), 0):
            mesh = D._cell_mesh(axes)
            for arch in all_arch_names():
                cfg = get_config(arch)
                for shape in Md.SHAPES:
                    if Md.shape_supported(cfg, shape):
                        res[f"args.{tag}.{arch}.{shape}"] = D.argument_bytes(
                            D.lower_cell(cfg, shape, mesh))


def _fake_store():
    """What the dry run takes from the fake backend (`FakeStore`, a module
    private to PyTorch): a group of any size in one process, subgroups,
    collectives on `meta` tensors that return the shapes asked for, and
    c10d ops that a dispatch mode sees."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch import dryrun as D

    with D.fake_group(4, 2):
        sub = dist.new_group([1, 2])
        x = torch.empty((3, 5), dtype=torch.bfloat16, device="meta")
        outs = [torch.empty_like(x) for _ in range(2)]
        got = torch.empty(8, dtype=torch.uint8, device="meta")
        with D._Wire() as wire:
            dist.all_gather(outs, x, group=sub)
            dist.all_to_all_single(got, torch.empty(8, dtype=torch.uint8, device="meta"),
                                   [4, 4], [4, 4], group=sub)
            dist.all_reduce(torch.empty(6, device="meta"))
        return {"world": dist.get_world_size(), "rank": dist.get_rank(),
                "backend": str(dist.get_backend()), "sub_rank": dist.get_rank(sub),
                "outs": [[str(o.device), list(o.shape), str(o.dtype)] for o in outs],
                "kinds": wire.kinds, "sent": wire.sent, "received": wire.received,
                "calls": wire.calls}


def _strip(rec):
    return {k: v for k, v in rec.items() if k not in ("trace", "not_portable")}


def main(out):
    import torch
    import torch.distributed as dist

    from repro_torch.launch import dryrun as D
    from repro_torch.launch import mesh as TM

    torch.set_num_threads(1)
    res = {}
    mesh = {"data": 2, "model": 2}
    for key, (name, kind, B, S) in GLOO_LM.items():
        shape = {"kind": kind, "batch": B, "seq": S}
        for r in range(4):
            res[f"cell.{key}.{r}"] = _strip(D.run_cell(name, shape, False, "", rank=r,
                                                       cfg=_reduced(name, kind), mesh=mesh))
    res["cell.lm.gemma-2b.train.single"] = _strip(D.run_cell(
        "gemma-2b", {"kind": "train", "batch": 4, "seq": 32}, False, "", processes=1,
        cfg=_reduced("gemma-2b", "train"), mesh=mesh))
    for r in range(4):
        res[f"cell.gp.block.{r}"] = _strip(D.run_gp_cell(gp_block_cell(), False, "",
                                                         block_steps=GP_BLOCK, rank=r,
                                                         processes=4))
    res["cuda"] = _strip(D.run_gp_cell(CUDA_CELL, False, "", eval_impl="cuda",
                                       block_steps=CUDA_K, processes=CUDA_PROCESSES))
    _arguments(res)
    res["fake"] = _fake_store()
    # the rules: no dry run under a live group; nothing left after a cell
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        D.run_cell("gemma-2b", {"kind": "decode", "batch": 4, "seq": 12}, False, "",
                   cfg=_reduced("gemma-2b", "decode"), mesh=mesh)
        refused = None
    except RuntimeError as e:
        refused = str(e)
    dist.destroy_process_group()
    res["rules"] = {"refused": refused, "initialized_after": dist.is_initialized(),
                    "groups_after": len(TM._GROUPS)}
    with tempfile.TemporaryDirectory() as d:
        arch, shape = CLI_CELL
        try:
            D.main(["--arch", arch, "--shape", shape, "--out", d])
            code = None
        except SystemExit as e:
            code = e.code
        with open(os.path.join(d, f"{arch}_{shape}_sp.json")) as f:
            res["cli"] = {"exit": code, "record": json.load(f),
                          "files": sorted(os.listdir(d))}
    res["rules"]["initialized_after_cli"] = dist.is_initialized()
    res["rules"]["groups_after_cli"] = len(TM._GROUPS)
    res["cuda_initialized"] = torch.cuda.is_initialized()
    assert "jax" not in sys.modules, "the dry run imported jax"
    with open(out + ".tmp", "w") as f:
        json.dump(res, f)
    os.replace(out + ".tmp", out)
    print("DRYRUN_OK")


class DryRuns:
    """This child's JSON, made once per test run: the first worker to
    take the lock file starts the child when its module starts, and
    releases the lock once the JSON is written; other workers wait on the
    lock and read it."""

    def __init__(self, tmp_path_factory):
        uid = os.environ.get("PYTEST_XDIST_TESTRUNUID")
        root = tmp_path_factory.getbasetemp()
        self.path = (root.parent if uid else root) / f"torch_dryrun_{uid or 'solo'}.json"
        self.lock = open(f"{self.path}.lock", "w")
        self.proc = None
        try:
            fcntl.flock(self.lock, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except BlockingIOError:
            return
        if self.path.exists():
            self.release()
        else:
            self.proc = self._start()

    def _start(self):
        env = dict(os.environ, PYTHONPATH=os.pathsep.join([os.path.join(HERE, "..", "src"),
                                                          HERE]), OMP_NUM_THREADS="1")
        env.pop("XLA_FLAGS", None)
        return subprocess.Popen([sys.executable, os.path.join(HERE, "torch_dryrun_child.py"),
                                 str(self.path)], env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)

    def _finish(self, proc):
        try:
            stdout, stderr = proc.communicate(timeout=600)
            assert proc.returncode == 0 and "DRYRUN_OK" in stdout, stderr[-4000:]
        finally:
            proc.kill()
            proc.wait()

    def release(self):
        if self.lock is not None:
            self.lock.close()
            self.lock = None

    def load(self) -> dict:
        if self.proc is not None:
            proc, self.proc = self.proc, None
            try:
                self._finish(proc)
            finally:
                self.release()
        if self.lock is not None:
            fcntl.flock(self.lock, fcntl.LOCK_EX)
            if not self.path.exists():
                self._finish(self._start())
            self.release()
        with open(self.path) as f:
            return json.load(f)


def fixtures():
    """The module fixtures a test module takes with `_dryruns, dry =
    fixtures()`: `_dryruns` (autouse) starts or joins the child when the
    module starts, `dry` is its JSON."""
    import pytest

    @pytest.fixture(scope="module", autouse=True)
    def _dryruns(tmp_path_factory):
        r = DryRuns(tmp_path_factory)
        yield r
        if r.proc is not None:  # no test read it: finish it for the other workers
            r.load()
        r.release()

    @pytest.fixture(scope="module")
    def dry(_dryruns):
        return _dryruns.load()

    return _dryruns, dry


def moved_as_dry(o, tag, dry, r):
    """A gloo process's bytes sent and received and collectives in a
    counted step (`torch_mp_worker.Moved`, `o["moved.{tag}"]`) equal the
    dry run's of the same step as rank r of 4."""
    rec = dry[f"cell.{tag}.{r}"]
    assert rec["status"] == "ok", rec.get("error")
    assert o[f"moved.{tag}"].tolist() == [rec["sent_bytes"], rec["received_bytes"],
                                          rec["collective_calls"]], (tag, r)


if __name__ == "__main__":
    sys.path.insert(0, HERE)
    main(sys.argv[1])
