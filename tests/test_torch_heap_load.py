"""How the port's kernels lay a program out, against the reference.

The B1 kernel (`csrc/gp_eval.cu::load_program`) reads a heap row in the
order `trees.postorder_slots(N)` gives and compacts its non-EMPTY slots
with a warp ballot and a prefix over the warps, 256 positions a pass; the
probe kernel's warps compact their postfix rows the same way, 32 slots a
round. `_load_program` below repeats that arithmetic on the host. The
result must be bitwise the reference's `repro.core.trees.heap_to_postfix`
row, for pruned populations and for rows with EMPTY slots anywhere. The
probe's launch geometry (`gp_eval.probe_geometry`) is checked at the
population sizes that bound it."""
import numpy as np
import pytest
import torch

from repro.core import trees as jtrees
from repro_torch.core import prng
from repro_torch.core import trees as ttrees
from repro_torch.device import constant
from repro_torch.kernels import gp_eval
from jax_release import release_jax_programs  # noqa: F401  (frees compiled programs)

torch.set_num_threads(2)


def _load_program(op_row, arg_row, slots, width):
    """The kernel loader's instruction list for one row: in each pass of
    `width` positions, position t reads slot slots[t]; a slot's place is
    the non-EMPTY slots of the earlier passes, of the earlier warps of
    this pass (their ballot counts) and of the lower lanes of its warp."""
    N = op_row.shape[0]
    code, args = np.zeros(N, np.int32), np.zeros(N, np.int32)
    length = 0
    for t0 in range(0, N, width):
        t = np.arange(t0, t0 + width)
        i = np.where(t < N, slots[np.minimum(t, N - 1)], 0)
        o = np.where(t < N, op_row[i], 0)
        keep = (o != 0).reshape(-1, 32)  # warps x lanes
        counts = keep.sum(1)
        at = length + (np.cumsum(counts) - counts)[:, None] + np.cumsum(keep, 1) - keep
        for w, lane in zip(*np.nonzero(keep)):
            code[at[w, lane]] = o[w * 32 + lane]
            args[at[w, lane]] = arg_row[i[w * 32 + lane]]
        length += int(counts.sum())
    return code, args, length


@pytest.mark.parametrize("depth", range(11))
def test_slot_order_is_reference_postorder(depth):
    N = 2 ** (depth + 1) - 1
    want = np.argsort(jtrees.postorder_table(N))
    slots = ttrees.postorder_slots(N)
    assert slots.dtype == np.int32 and not slots.flags.writeable
    np.testing.assert_array_equal(slots, want)
    # the device constant the B1 wrapper passes to the kernel
    np.testing.assert_array_equal(constant(slots, "cpu", np.int32).numpy(), want)


@pytest.mark.parametrize("width", [256, 32])
@pytest.mark.parametrize("depth", [1, 5, 8, 10])
def test_compacted_heap_rows_match_reference_heap_to_postfix(depth, width):
    """Generated (pruned) trees, then rows whose slots are EMPTY at
    random: either way the loader's list is the reference's postfix row,
    followed by EMPTY padding."""
    spec = ttrees.TreeSpec(max_depth=depth, n_features=5)
    op, arg = ttrees.generate_population(prng.PRNGKey(depth), 6, spec)
    op, arg = op.numpy(), arg.numpy()
    N = op.shape[1]
    rng = np.random.RandomState(depth + width)
    rop = np.where(rng.rand(4, N) < 0.5, 0, rng.randint(1, 16, size=(4, N))).astype(np.int32)
    rarg = rng.randint(0, 5, size=(4, N)).astype(np.int32)
    op, arg = np.concatenate([op, rop]), np.concatenate([arg, rarg])
    want_op, want_arg = (np.asarray(a) for a in jtrees.heap_to_postfix(op, arg))
    slots = ttrees.postorder_slots(N)
    for p in range(op.shape[0]):
        code, args, length = _load_program(op[p], arg[p], slots, width)
        assert length == int((op[p] != 0).sum())
        np.testing.assert_array_equal(code, want_op[p], err_msg=f"row {p}")
        np.testing.assert_array_equal(args, want_arg[p], err_msg=f"row {p}")


@pytest.mark.parametrize("P", [1, 2, 7, 8, 9, 65_535, 65_536, 10**6, 2**31 - 1])
def test_probe_geometry_covers_every_row(P):
    rows, blocks, smem = gp_eval.probe_geometry(P, 63)
    assert rows == min(gp_eval.PROBE_ROWS, P)
    assert blocks == -(-P // rows) and (blocks - 1) * rows < P <= blocks * rows
    assert blocks <= 2**31 - 1
    assert smem == rows * 4 * (3 * 63 + 32 + 32 * 32) <= 48 * 1024


def test_probe_geometry_limits():
    # depth 11 (the 12-float stack's deepest heap): one row a block, past 48 KB
    rows, blocks, smem = gp_eval.probe_geometry(5, 4095)
    assert (rows, blocks) == (1, 5) and 48 * 1024 < smem <= 227 * 1024
    with pytest.raises(ValueError, match="probe launch"):
        gp_eval.probe_geometry(2**31, 63)  # past the kernel's int32 row count
    with pytest.raises(ValueError, match="probe launch"):
        gp_eval.probe_geometry(2, 20_000)  # one row's program past 227 KB
