"""The port's dry run (`repro_torch.launch.dryrun`) against the reference
and against gloo runs, on the CPU.

Every dry run goes in one child process (`torch_dryrun_child.py`, shared
between test workers by a lock file): a dry run joins a fake process
group for its whole process, which a test worker must never hold. The
reference's side runs here: its sharding rules on a stub mesh (what they
read of a mesh, as `test_torch_lm_sharding.py` runs them), shapes from
`jax.eval_shape`, and for XLA's own memory figures reduced gemma-2b's
train cell compiled in `torch_lm_mesh_ref.py`'s 8-device subprocess
(the `dryrun` group). The gloo side (each process's bytes over a real
gloo group) is held to the same child's records in
`test_torch_mesh.py` and `test_torch_lm_mesh.py`, whose worker counts
them.

All comparisons are exact: bytes are integers."""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_arch_names
from repro.configs import get_config as jget_config
from repro.launch import sharding as JSH
from repro.launch.dryrun import make_policy
from repro.models import model as JMd
from repro.optim.adamw import for_config as jfor_config
from repro_torch.configs import get_reduced
from repro_torch.gp import GPSession
from repro_torch.kernels import gp_eval
from repro_torch.launch import dryrun as D
from repro_torch.launch import sharding as SH
from repro_torch.optim.adamw import for_config
from jax_release import release_jax_programs  # noqa: F401  (frees compiled programs)
from torch_dryrun_child import CLI_CELL, CUDA_CELL, CUDA_K, fixtures
from torch_lm_mesh_ref import F32, TRAIN, Reference

torch.set_num_threads(2)

GB = 2**30
PRODUCTION = {"sp": {"data": 16, "model": 16}, "mp": {"pod": 2, "data": 16, "model": 16}}

_dryruns, dry = fixtures()


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    r = Reference(tmp_path_factory)
    try:
        return r.load()
    finally:
        r.release()


class _StubMesh:
    """What the reference's rules read of a mesh."""

    def __init__(self, shape):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)
        self.devices = np.empty(tuple(shape.values()))


def _device_bytes(specs, shapes, stub) -> int:
    """A device's bytes of a tree placed by the reference's `specs`: every
    leaf's size over the shards its spec splits it into."""
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    leaves = jax.tree_util.tree_leaves(shapes)
    assert len(spec_leaves) == len(leaves)
    total = 0
    for spec, leaf in zip(spec_leaves, leaves):
        names = [a for part in spec if part is not None
                 for a in (part if isinstance(part, tuple) else (part,))]
        n = math.prod(leaf.shape) * np.dtype(leaf.dtype).itemsize
        split = math.prod(stub.shape[a] for a in names)
        assert n % split == 0
        total += n // split
    return total


@functools.lru_cache(maxsize=None)
def _state_shapes(name):
    cfg = jget_config(name)
    opt = jfor_config(cfg)

    def init(key):
        p = JMd.init_params(cfg, key)
        return {"params": p, "opt": opt.init(p), "step": jnp.zeros((), jnp.int32)}

    return jax.eval_shape(init, jax.random.PRNGKey(0))


def _reference_argument(name, shape, stub) -> int:
    """A device's argument bytes of the reference's dry-run cell
    (`repro/launch/dryrun.py` lower_cell): the train state, or the params
    (and for decode the cache), plus the inputs, each placed by the
    reference's specs."""
    cfg = jget_config(name).with_policy(make_policy(stub))
    kind, specs = JMd.input_specs(cfg, shape)
    state = _state_shapes(name)
    if kind == "train":
        return (_device_bytes(JSH.train_state_specs(cfg, state, stub), state, stub)
                + _device_bytes(JSH.batch_specs(cfg, specs), specs, stub))
    params = state["params"]
    held = _device_bytes(JSH.param_specs(cfg, params, stub), params, stub)
    if kind == "prefill":
        return held + _device_bytes(JSH.batch_specs(cfg, specs), specs, stub)
    seq_shard = JMd.SHAPES[shape]["batch"] == 1
    cache = specs["cache"]
    b_axes = tuple(cfg.policy.batch)
    tok = JSH.P(None, None) if seq_shard else JSH.P(b_axes, None)
    return (held + _device_bytes(JSH.cache_specs(cfg, cache, stub, seq_shard=seq_shard),
                                 cache, stub)
            + _device_bytes(tok, specs["token"], stub) + 4)  # cur_len: a replicated int32


@pytest.mark.parametrize("name", all_arch_names())
@pytest.mark.parametrize("mesh", sorted(PRODUCTION))
def test_arguments_match_reference(dry, mesh, name):
    """Rank 0's argument bytes of every runnable cell of `name` on the
    production mesh (one process a shard) equal a device's of the
    reference's cell: its state, params or cache plus its inputs, placed
    by the reference's specs; the long-context cell only where the
    reference runs it (a subquadratic model)."""
    stub = _StubMesh(PRODUCTION[mesh])
    cfg = jget_config(name)
    shapes = [s for s in JMd.SHAPES if JMd.shape_supported(cfg, s)]
    got = {s: dry[f"args.{mesh}.{name}.{s}"] for s in shapes}
    assert not [k for k in dry if k.startswith(f"args.{mesh}.{name}.")
                and k.split(".")[-1] not in shapes]
    assert got == {s: _reference_argument(name, s, stub) for s in shapes}


def _train_state_leaves(name) -> int:
    cfg = dataclasses.replace(get_reduced(name), **F32, **TRAIN[name])
    return len(SH._leaves(SH.state_shapes(cfg, for_config(cfg))))


def test_memory_matches_xla(dry, ref):
    """Reduced gemma-2b's train cell (f32, B 4 x S 32) on (data 2, model 2),
    rank 0 of 4, against XLA's memory_analysis of the reference's cell on
    a device: the arguments exactly; the output by XLA's tuple index
    table (8 bytes a buffer of the output tuple: the state's leaves and
    the 4 metrics); the aliased bytes by the step counter's 4 (XLA
    donates it; the port's `step + 1` is a new tensor, so only the
    params and the optimizer state are written in place)."""
    arg, out, alias, temp = (int(x) for x in ref["dryrun.gemma-2b.memory"])
    rec = dry["cell.lm.gemma-2b.train.0"]
    assert rec["status"] == "ok" and rec["processes"] == 4 and rec["rank"] == 0
    mem = {k: v * GB for k, v in rec["memory"].items() if k != "code_mb"}
    assert all(v == int(v) for v in mem.values())
    buffers = _train_state_leaves("gemma-2b") + 4
    assert mem["argument_gb"] == arg
    assert mem["output_gb"] + 8 * buffers == out
    assert mem["alias_gb"] + 4 == alias
    assert rec["memory"]["code_mb"] is None and rec["bytes_accessed"] is None
    assert 0 < mem["temp_gb"] < 4 * temp


def test_single_controller_holds_every_shard(dry):
    """As the single controller (`processes=1`) the same cell's arguments
    are every shard's parts, each replica its own tensor, with one step
    counter, plus the whole batch: what `chip_smoke.py` phase 15 (a)
    holds against the bytes placed on the card. No collective runs."""
    from repro_torch.launch import mesh as TM

    cfg = dataclasses.replace(get_reduced("gemma-2b"), **F32)
    mesh = TM.Mesh({"data": 2, "model": 2}, ["meta"] * 4)
    pcfg = cfg.with_policy(SH.policy_for(mesh))
    shapes = SH.state_shapes(pcfg, for_config(pcfg))
    parts = sum(SH.shard_bytes(SH.train_state_specs(pcfg, shapes, mesh), shapes, mesh))
    batch = 4 * 32 * (4 + 4 + 4)  # tokens, labels (int32), mask (f32)
    rec = dry["cell.lm.gemma-2b.train.single"]
    assert rec["processes"] == 1 and rec["collective_calls"] == 0 == rec["sent_bytes"]
    assert rec["memory"]["argument_gb"] * GB == parts - 3 * 4 + batch
    per_rank = dry["cell.lm.gemma-2b.train.0"]["memory"]["argument_gb"] * GB
    assert per_rank == SH.shard_bytes(SH.train_state_specs(pcfg, shapes, mesh), shapes,
                                      mesh)[0] + batch // 2
    assert rec["flops"] == 2 * dry["cell.lm.gemma-2b.train.0"]["flops"]


@pytest.mark.parametrize("cell", ["lm.gemma-2b.train", "lm.granite-moe-3b-a800m.train",
                                  "serve.granite-moe-3b-a800m.decode", "serve.gemma-2b.decode",
                                  "gp.block"])
def test_cells_record_every_column(dry, cell):
    """Each rank's record of a cell the gloo tests count: status ok, the
    reference's keys (with `trace_s` for `compile_s`), the wire's kinds
    adding up to each collective's result, and the memory columns
    positive, the aliased bytes within the output."""
    for r in range(4):
        rec = dry[f"cell.{cell}.{r}"]
        assert rec["status"] == "ok", rec.get("error")
        assert (rec["processes"], rec["rank"]) == (4, r)
        assert set(rec) >= {"arch", "shape", "multi_pod", "status", "trace_s", "flops",
                            "bytes_accessed", "collective_bytes", "memory", "sent_bytes",
                            "received_bytes", "collective_calls"}
        kinds = rec["collective_bytes"]
        assert set(kinds) <= {"all-gather", "all-to-all", "all-reduce", "broadcast"}
        # a collective's result holds what a process sends and receives in it
        assert 0 < rec["received_bytes"] <= sum(kinds.values())
        mem = rec["memory"]
        assert mem["argument_gb"] > 0 and mem["output_gb"] > 0 and mem["temp_gb"] > 0
        assert 0 <= mem["alias_gb"] <= mem["output_gb"]
        assert rec["trace_s"] > 0
        assert (rec["flops"] > 0) == (not cell.startswith("gp"))


def test_gp_cell_counts_a_cards_launches(dry):
    """A GP cell with the cuda backend on `meta`: B1 launches =
    `pop_chunks` of a shard's trees x this process's shards x K (70,000
    trees a shard: 2 launches; rank 0 of 2 holds 2 of the 4 shards), and
    no other kernel; a cuda session still refuses the CPU."""
    rec = dry["cuda"]
    assert rec["status"] == "ok", rec.get("error")
    shard_trees = CUDA_CELL["pop_size"] // CUDA_CELL["topology"]["model"]
    chunks = len(gp_eval.pop_chunks(shard_trees))
    assert chunks == 2
    assert rec["kernel_launches"] == {"eval_fitness": chunks * 2 * CUDA_K}
    with pytest.raises(ValueError, match="cuda"):
        GPSession(backend="cuda", device="cpu")


def test_cli_writes_the_reference_keys(dry):
    """`main` on one production cell exits 0 and writes
    `{arch}_{shape}_sp.json` (no ops file without `--keep-hlo`) with the
    reference's record keys, `trace_s` for `compile_s`, and the columns
    that do not port null with their reason."""
    cli = dry["cli"]
    arch, shape = CLI_CELL
    assert cli["exit"] == 0 and cli["files"] == [f"{arch}_{shape}_sp.json"]
    rec = cli["record"]
    assert rec["status"] == "ok" and (rec["processes"], rec["rank"]) == (256, 0)
    assert set(rec) >= {"arch", "shape", "multi_pod", "status", "trace_s", "flops",
                        "bytes_accessed", "collective_bytes", "memory"}
    assert set(rec["memory"]) == {"argument_gb", "output_gb", "temp_gb", "alias_gb",
                                  "code_mb"}
    assert rec["memory"]["code_mb"] is None and rec["bytes_accessed"] is None
    assert set(rec["not_portable"]) == {"code_mb", "bytes_accessed"}
    assert (rec["arch"], rec["shape"], rec["multi_pod"]) == (arch, shape, False)
    assert rec["collective_bytes"]["all-gather"] > 0 and rec["flops"] > 0


def test_fake_group_rules(dry):
    """The dry run refuses to start under an initialized group; after a
    cell, and after the CLI, torch.distributed is uninitialized and the
    mesh's cache of subgroups is empty; the child never touched CUDA."""
    rules = dry["rules"]
    assert "process of its own" in rules["refused"]
    assert rules == {**rules, "initialized_after": False, "groups_after": 0,
                     "initialized_after_cli": False, "groups_after_cli": 0}
    assert dry["cuda_initialized"] is False
    with pytest.raises(ValueError, match="rank 4 of 4"):
        with D.fake_group(4, 4):
            pass


def test_fake_store_backend(dry):
    """What the dry run takes from PyTorch's private fake backend
    (`FakeStore`): process 2 of a group of 4 in one process, a subgroup,
    collectives on `meta` tensors that return the shapes asked for, and
    c10d ops a dispatch mode sees, counted as `_Moved` counts them."""
    fake = dry["fake"]
    assert (fake["world"], fake["rank"], fake["sub_rank"], fake["backend"]) == (4, 2, 1, "fake")
    assert fake["outs"] == [["meta", [3, 5], "torch.bfloat16"]] * 2
    assert fake["kinds"] == {"all-gather": 60, "all-to-all": 8, "all-reduce": 24}
    # all-gather: 30 sent, 30 received; all-to-all: 4 each way (4 kept);
    # all-reduce over 4: its 24 bytes each way
    assert (fake["sent"], fake["received"], fake["calls"]) == (58, 58, 3)


def test_every_reference_module_has_a_counterpart():
    """With the dry run ported, every module of `src/repro/` has one of
    the same path in `src/repro_torch/`, but `compat.py` (it bridges JAX
    versions; the port has none)."""
    import pathlib

    src = pathlib.Path(__file__).resolve().parent.parent / "src"

    def modules(pkg):
        return {p.relative_to(src / pkg).as_posix() for p in (src / pkg).rglob("*.py")}

    assert modules("repro") - modules("repro_torch") == {"compat.py"}
