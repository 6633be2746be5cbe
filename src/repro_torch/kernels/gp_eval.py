"""GP population evaluation + fitness moments: the CUDA kernels' wrappers.

Each wrapper replaces one TPU kernel of `repro/kernels/gp_eval.py` and
returns the tree's fitness moments f32[P, M] (M = the fitness kernel's
`n_moments`: 1 for r/c/m/mse, 7 for pearson, 5 for r2), merged over data
tiles in order (pearson/r2 by their Chan combine):

    eval_fitness               B1  eval_fitness_pallas: heap trees
    eval_fitness_postfix       B2  eval_fitness_pallas_postfix: postfix streams
    eval_fitness_from_subtrees B3  eval_fitness_pallas_from_subtrees:
                                   preds = uniq[root], gathered in the kernel
    eval_fitness_from_preds    B4  eval_fitness_pallas_from_preds: preds given

and two kernels stand in for jnp code of the reference, with the same
device functions as B2, so dedup on/off stay bitwise on the card for
every function set: `unique_table` computes the dedup layer's
unique-subtree table f32[U, D] (`core/eval.evaluate_unique_subtrees`),
and `predict_postfix` the semantic tier's probe predictions f32[P, D]
(`core/eval.evaluate_population_postfix`).

The kernels are hand-written CUDA C++ for Hopper (`csrc/gp_eval.cu`,
sm_90a), built by `kernels/build.py` at first use and called through
ctypes on PyTorch's current stream. What bounds them on the card: B1/B2
read only op/arg (P·N·8 bytes), X (F·D·4), y and w (D·8) and write P·4
bytes, while they execute one interpreted node per active tree node per
data point, so instruction issue, not memory, is the limit; they keep
each tree's instruction list in shared memory and its operand stack in
registers; both load the list with all their threads (B1 reads its heap
row in postorder through a slot table, which compacts it to the tree's
postfix program) and carry up to four points per thread through it at
once: B1 and B2 are one block body. B3/B4 read one
prediction row per tree (P·D·4 bytes) plus y and w: memory-bound at
large shapes, near the launch floor at the paper's; each thread loads
all its points of a tile at once, so a block has its whole slice in
flight. Every B1-B4 call merges its data tiles inside the kernel. The
unique table writes
n_unique rows of D floats; its persistent blocks group the slots by
subtree height in shared memory, so a tile of points costs one barrier
per height (`unique_table`). The probe's predictions are B2's
interpreter on a few rows and 32 points, latency-bound: one warp per row
loads its program by ballot and gathers its terminals' values into
shared memory at once before it interprets (`probe_geometry`).

B2-B4 and the unique table take an optional device flag `gate` (a bool
tensor, e.g. `DedupPlan.overflow`) and `run_when`: with a gate they do
their work only where `gate == run_when` and otherwise leave `out`
untouched, so the dedup path launches both branches of the reference's
`lax.cond` into one output with no host read.

On CPU tensors each wrapper runs its plain PyTorch version (the
`*_plain` function beside it); on CUDA tensors it launches the kernel or
raises; on `meta` tensors (the dry run, `launch/dryrun.py`) it checks
its inputs as for a launch, launches nothing and returns its output
empty on `meta`. `launches[name]` counts each wrapper's kernel launches
on CUDA tensors (the tests and `chip_smoke.py` read it): one a call, or
one per chunk of at most POP_CHUNK trees for B1-B4 (`pop_chunks`).
`meta_launches[name]` counts, on `meta` tensors, the launches a card
would make for the same call.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core import eval as _eval
from repro_torch.core import fitness as fit
from repro_torch.core import primitives as prim
from repro_torch.core.trees import TreeSpec, postorder_slots
from repro_torch.device import constant
from repro_torch.kernels import ref as _ref

KERNELS = ("eval_fitness", "eval_fitness_postfix", "eval_fitness_from_subtrees",
           "eval_fitness_from_preds", "unique_table", "predict_postfix")
# launches of each kernel by its wrapper on CUDA tensors. Each is one CUDA
# launch of the kernel alone (B1-B4 merge their data tiles inside it); a
# call makes one, B1-B4 one per POP_CHUNK trees.
launches = dict.fromkeys(KERNELS, 0)
# the launches each wrapper would make on the card, for calls on `meta` tensors
meta_launches = dict.fromkeys(KERNELS, 0)
STACK_TEMPLATES = (8, 12)  # register-stack sizes compiled into csrc/gp_eval.cu
SMS = 132  # streaming multiprocessors of an H100 SXM
# the unique table: dynamic shared memory of its persistent block (nearly
# all of an SM's 228 KB)
TABLE_SMEM_BYTES = 226 * 1024
# the probe: rows (one warp each) a block at most, feature terminals a row
# gathers into shared memory up front, and the limits of its launch
PROBE_ROWS = 8
PROBE_TERMS = 32
_SMEM_DEFAULT = 48 * 1024  # dynamic shared memory a block gets without opting in
_SMEM_MAX = 227 * 1024
_GRID_X_MAX = 2**31 - 1
# B1-B4 put trees on the grid's y dimension: at most this many a launch
POP_CHUNK = 65535

_LIB = None
_vp, _i, _f32, _u = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
_ARGTYPES = {
    "gp_eval_fitness": [_vp, _vp, _vp, _i, _i, _i, _vp, _i, _i, _vp, _vp, _vp, _i, _u, _i,
                        _f32, _f32, _i, _vp, _vp, _vp, _vp],
    "gp_eval_postfix": [_vp, _vp, _i, _i, _i, _vp, _i, _i, _vp, _vp, _vp, _i, _u, _i,
                        _f32, _f32, _i, _vp, _i, _vp, _vp, _vp, _vp],
    "gp_fitness_from_subtrees": [_vp, _i, _vp, _i, _i, _vp, _vp, _i, _f32, _f32, _i,
                                 _vp, _i, _vp, _vp, _vp, _vp],
    "gp_fitness_from_preds": [_vp, _i, _i, _vp, _vp, _i, _f32, _f32, _i, _vp, _i,
                              _vp, _vp, _vp, _vp],
    "gp_unique_table": [_vp, _vp, _vp, _vp, _vp, _vp, _i, _vp, _i, _i, _vp, _i, _u, _vp, _i,
                        _i, _i, _vp, _vp],
    "gp_predict_postfix": [_vp, _vp, _i, _i, _i, _vp, _i, _i, _vp, _i, _u, _i, _vp, _vp],
}


_TICKETS: dict[torch.device, torch.Tensor] = {}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0
        meta_launches[k] = 0


def _lib():
    """The kernels' library, built and bound on first use."""
    global _LIB
    if _LIB is None:
        from repro_torch.kernels import build

        lib = build.load("gp_eval")
        for name, argtypes in _ARGTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _call(name: str, entry: str, dev, *args) -> None:
    """Launch `entry` on `dev`'s current stream (passed as the last
    argument) with `dev` the current device, so a tensor on another card
    than the current one launches in its own card's context."""
    with torch.cuda.device(dev):
        err = getattr(_lib(), entry)(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
    launches[name] += 1


def _fn_set(fn_codes) -> prim.FunctionSet:
    if fn_codes is None:
        return prim.KITCHEN_SINK
    return prim.FunctionSet(np.asarray(fn_codes, np.int32))


def _fit_spec(kernel, n_classes, precision) -> fit.FitnessSpec:
    return fit.FitnessSpec(kernel, n_classes=n_classes, precision=precision)


def _device_kernel(kernel: str):
    kern = fit.get_kernel(kernel)
    if kern.device_id is None:
        raise NotImplementedError(
            f"fitness kernel {kernel!r} has no device form in csrc/gp_eval.cu")
    return kern


def _check_rows_smem(kern, N: int, data_tile: int) -> None:
    """B1/B2 keep the program (3N words) in shared memory, and pearson
    also the tile's points (data_tile floats), at most _SMEM_MAX bytes."""
    need = 4 * (3 * N + (data_tile if kern.name == "pearson" else 0))
    if need > _SMEM_MAX:
        raise ValueError(f"unsupported launch: {need} bytes of shared memory a block "
                         f"(N={N}, data_tile={data_tile}, kernel {kern.name!r}); at most "
                         f"{_SMEM_MAX}")


def _check(dev, **tensors) -> None:
    """Each (name -> (tensor, dtype, shape)) must be a contiguous tensor of
    that dtype and shape on `dev` (None: an absent optional input)."""
    for name, spec in tensors.items():
        t, dt, shape = spec
        if t is None:
            continue
        if (t.device != dev or t.dtype != dt or not t.is_contiguous()
                or tuple(t.shape) != tuple(shape)):
            raise ValueError(f"{name} must be a contiguous {dt} tensor of shape "
                             f"{tuple(shape)} on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device} "
                             f"(contiguous={t.is_contiguous()})")


def _planned(name: str, n: int, out, gate=None):
    """A call on `meta` tensors: check the gate, count the `n` launches a
    card would make and return `out` (empty, on `meta`) with nothing run."""
    _check(out.device, gate=(gate, torch.bool, ()))
    meta_launches[name] += n
    return out


def _ptr(t):
    return None if t is None else t.data_ptr()


def _at(t, first: int, per_tree: int = 1):
    """The address of tree `first`'s entries in `t` (`per_tree` elements a
    tree)."""
    return t.data_ptr() + first * per_tree * t.element_size()


def pop_chunks(P: int, limit: int = POP_CHUNK) -> list[tuple[int, int]]:
    """(first tree, trees) of each B1-B4 launch for P trees: consecutive
    runs of at most `limit` trees, in order, covering [0, P) (one launch
    when P <= limit)."""
    return [(s, min(limit, P - s)) for s in range(0, P, limit)]


def _tile_buffers(P: int, D: int, data_tile: int, M: int, out, dev):
    """(tiles, partial, out) for a fitness launch of M moments: `partial`
    holds P·tiles·M floats, `out` f32[P, M] (made when the caller gives
    none)."""
    if data_tile <= 0:
        raise ValueError(f"unsupported launch: data_tile={data_tile}")
    if out is None:
        out = torch.empty((P, M), dtype=torch.float32, device=dev)
    elif out.shape != (P, M) or out.dtype != torch.float32 or not out.is_contiguous():
        raise ValueError(f"out must be a contiguous float32 [P, {M}] tensor")
    tiles = -(-D // data_tile)
    partial = torch.empty((P * tiles * M if tiles > 1 else 1,), dtype=torch.float32,
                          device=dev)
    return tiles, partial, out


def _gated(result, gate, run_when: bool, out):
    """The plain versions' form of the kernels' gate: `result` where
    `gate == run_when`, else `out` unchanged."""
    if gate is None:
        return result
    if out is None:
        raise ValueError("a gated call needs `out`")
    return torch.where(gate == run_when, result, out)


def _gate_args(gate, run_when: bool, dev):
    if gate is None:
        return None, 0
    _check(dev, gate=(gate, torch.bool, ()))
    return gate.data_ptr(), int(bool(run_when))


# --- B1: heap trees -------------------------------------------------------------


def eval_fitness_plain(op, arg, X, y, weight, const_table, *, max_depth: int,
                       kernel: str = "r", n_classes: int = 3, precision: float = 1e-4,
                       data_tile: int = 1024, fn_codes=None):
    """Plain PyTorch version of B1: `kernels/ref.py`'s `moments_ref_tiled`
    at the kernel's data tile (`evaluate_population` per tile, the
    registered kernel's `moments` on it, tiles merged in order: the
    reference kernel's j == 0 store / j != 0 merge)."""
    spec = TreeSpec(max_depth=max_depth, fn_set=_fn_set(fn_codes))
    return _ref.moments_ref_tiled(op, arg, X, y, const_table, spec,
                                  _fit_spec(kernel, n_classes, precision),
                                  weight=weight, tile=data_tile)


def eval_fitness(op, arg, X, y, weight, const_table, *, max_depth: int,
                 kernel: str = "r", n_classes: int = 3, precision: float = 1e-4,
                 gather: str | None = None, data_tile: int = 1024, fn_codes=None):
    """B1: fused heap eval+moments -> f32[P, M] (M = the fitness kernel's
    `n_moments`), one CUDA launch: B2's block body, its program loaded from
    the heap row in full-heap postorder (`trees.postorder_slots`, a device
    constant), the tiles merged in order inside the kernel.

    op, arg:  int32[P, N]   heap population, N = 2**(max_depth+1) - 1
    X:        f32[F, D]     feature-major data (any D: the kernel masks
                            the ragged last tile itself)
    y:        f32[D]
    weight:   f32[D] | None 0.0 on padding points; None = all ones
    const:    f32[C]
    data_tile              points per block (the kernel's data tile)
    fn_codes               the run's opcodes; others evaluate to 0

    `gather` ("onehot" | "vmem") is accepted for parity with the TPU
    kernel and ignored: an indexed load of X[arg, d] does the job here.
    """
    del gather
    if not (op.is_cuda or op.is_meta):
        return eval_fitness_plain(op, arg, X, y, weight, const_table,
                                  max_depth=max_depth, kernel=kernel,
                                  n_classes=n_classes, precision=precision,
                                  data_tile=data_tile, fn_codes=fn_codes)
    kern = _device_kernel(kernel)
    P, N = op.shape
    F, D = X.shape
    dev = op.device
    _check(dev, op=(op, torch.int32, (P, N)), arg=(arg, torch.int32, (P, N)),
           X=(X, torch.float32, (F, D)), y=(y, torch.float32, (D,)),
           weight=(weight, torch.float32, (D,)),
           const_table=(const_table, torch.float32, const_table.shape))
    if N != 2 ** (max_depth + 1) - 1 or not 0 <= max_depth <= 10:
        raise ValueError(f"op has {N} slots; max_depth={max_depth} (<= 10) needs "
                         f"{2 ** (max_depth + 1) - 1}")
    _check_rows_smem(kern, N, data_tile)
    M = kern.n_moments
    tiles, partial, out = _tile_buffers(P, D, data_tile, M, None, dev)
    if P == 0:
        return out
    if op.is_meta:
        return _planned("eval_fitness", len(pop_chunks(P)), out)
    slots = constant(postorder_slots(N), dev, np.int32)
    tickets = _tickets(P, dev)
    for s, n in pop_chunks(P):
        _call("eval_fitness", "gp_eval_fitness", dev, _at(op, s, N), _at(arg, s, N),
              slots.data_ptr(), n, N, max_depth, X.data_ptr(), F, D, y.data_ptr(),
              _ptr(weight), const_table.data_ptr(), const_table.shape[0],
              _fn_set(fn_codes).mask, kern.device_id, float(n_classes - 1),
              float(np.float32(precision)), data_tile, _at(partial, s, tiles * M),
              _at(tickets, s), _at(out, s, M))
    return out


# --- B2: postfix streams --------------------------------------------------------


def eval_fitness_postfix_plain(op, arg, X, y, weight, const_table, *, stack_size: int,
                               kernel: str = "r", n_classes: int = 3,
                               precision: float = 1e-4, data_tile: int = 1024,
                               fn_codes=None):
    """Plain PyTorch version of B2: the stack machine
    (`evaluate_population_postfix`) per data tile, moments merged in
    order."""
    # a spec whose stack_size (max_depth + 1) is the kernel's
    spec = TreeSpec(max_depth=stack_size - 1, fn_set=_fn_set(fn_codes), genome="postfix")
    return _ref.moments_ref_tiled(op, arg, X, y, const_table, spec,
                                  _fit_spec(kernel, n_classes, precision),
                                  weight=weight, tile=data_tile)


def eval_fitness_postfix(op, arg, X, y, weight, const_table, *, stack_size: int,
                         kernel: str = "r", n_classes: int = 3, precision: float = 1e-4,
                         data_tile: int = 1024, fn_codes=None, gate=None,
                         run_when: bool = True, out=None):
    """B2: fused postfix eval+moments -> f32[P, M], one CUDA launch (the
    tiles' partials are merged in tile order inside the kernel, by the
    block that draws a tree's last ticket; `_tickets`).

    op, arg:    int32[P, N]  postfix streams (any N)
    stack_size               the programs' operand-stack bound
                             (TreeSpec.stack_size, invariant P5); the
                             kernel's register stack is the smallest of
                             STACK_TEMPLATES that holds it
    gate, run_when, out      see the module docstring
    Other arguments as `eval_fitness`."""
    if not (op.is_cuda or op.is_meta):
        res = eval_fitness_postfix_plain(op, arg, X, y, weight, const_table,
                                         stack_size=stack_size, kernel=kernel,
                                         n_classes=n_classes, precision=precision,
                                         data_tile=data_tile, fn_codes=fn_codes)
        return _gated(res, gate, run_when, out)
    kern = _device_kernel(kernel)
    if not 1 <= stack_size <= max(STACK_TEMPLATES):
        raise ValueError(f"stack_size={stack_size} exceeds the kernel's register "
                         f"stacks {STACK_TEMPLATES} (max_depth <= "
                         f"{max(STACK_TEMPLATES) - 1})")
    P, N = op.shape
    F, D = X.shape
    dev = op.device
    _check(dev, op=(op, torch.int32, (P, N)), arg=(arg, torch.int32, (P, N)),
           X=(X, torch.float32, (F, D)), y=(y, torch.float32, (D,)),
           weight=(weight, torch.float32, (D,)),
           const_table=(const_table, torch.float32, const_table.shape))
    _check_rows_smem(kern, N, data_tile)
    M = kern.n_moments
    tiles, partial, out = _tile_buffers(P, D, data_tile, M, out, dev)
    if P == 0:
        return out
    if op.is_meta:
        return _planned("eval_fitness_postfix", len(pop_chunks(P)), out, gate)
    g, rw = _gate_args(gate, run_when, dev)
    tickets = _tickets(P, dev)
    for s, n in pop_chunks(P):
        _call("eval_fitness_postfix", "gp_eval_postfix", dev, _at(op, s, N), _at(arg, s, N), n,
              N, stack_size, X.data_ptr(), F, D, y.data_ptr(),
              _ptr(weight), const_table.data_ptr(), const_table.shape[0],
              _fn_set(fn_codes).mask, kern.device_id, float(n_classes - 1),
              float(np.float32(precision)), data_tile, g, rw, _at(partial, s, tiles * M),
              _at(tickets, s), _at(out, s, M))
    return out


def _tickets(P: int, dev) -> torch.Tensor:
    """B1-B4's per-tree ticket counters on `dev`: int32 zeros, made once (and
    again only for a larger P); every launch leaves them zero. Launches
    that share them must run in stream order, as the port's do."""
    t = _TICKETS.get(dev)
    if t is None or t.numel() < P:
        t = _TICKETS[dev] = torch.zeros(max(P, 1024), dtype=torch.int32, device=dev)
    return t


# --- B3 / B4: moments over the unique-subtree table -----------------------------



def eval_fitness_from_subtrees_plain(root, uniq, y, weight, *, kernel: str = "r",
                                     n_classes: int = 3, precision: float = 1e-4,
                                     data_tile: int = 1024):
    """Plain PyTorch version of B3: preds = uniq[clamp(root)], moments per
    data tile merged in order."""
    preds = uniq[root.long().clamp(0, uniq.shape[0] - 1)]
    return eval_fitness_from_preds_plain(preds, y, weight, kernel=kernel,
                                         n_classes=n_classes, precision=precision,
                                         data_tile=data_tile)


def eval_fitness_from_subtrees(root, uniq, y, weight, *, kernel: str = "r",
                               n_classes: int = 3, precision: float = 1e-4,
                               data_tile: int = 1024, gate=None, run_when: bool = False,
                               out=None):
    """B3: moments of preds = uniq[clamp(root, 0, U-1)] -> f32[P, M], one
    CUDA launch: a block reads root[p] once, its threads load all their
    points of the tile at once and fold them in B1's and B2's point
    order; the tiles merge inside the kernel.

    root:  int32[P]     unique-slot id per tree (DedupPlan.root)
    uniq:  f32[U, D]    unique-subexpression values (`unique_table`)"""
    if not (root.is_cuda or root.is_meta):
        res = eval_fitness_from_subtrees_plain(root, uniq, y, weight, kernel=kernel,
                                               n_classes=n_classes, precision=precision,
                                               data_tile=data_tile)
        return _gated(res, gate, run_when, out)
    kern = _device_kernel(kernel)
    (P,) = root.shape
    U, D = uniq.shape
    dev = root.device
    _check(dev, root=(root, torch.int32, (P,)), uniq=(uniq, torch.float32, (U, D)),
           y=(y, torch.float32, (D,)), weight=(weight, torch.float32, (D,)))
    M = kern.n_moments
    tiles, partial, out = _tile_buffers(P, D, data_tile, M, out, dev)
    if P == 0:
        return out
    if root.is_meta:
        return _planned("eval_fitness_from_subtrees", len(pop_chunks(P)), out, gate)
    g, rw = _gate_args(gate, run_when, dev)
    tickets = _tickets(P, dev)
    for s, n in pop_chunks(P):
        _call("eval_fitness_from_subtrees", "gp_fitness_from_subtrees", dev, _at(root, s), n,
              uniq.data_ptr(), U, D, y.data_ptr(), _ptr(weight), kern.device_id,
              float(n_classes - 1), float(np.float32(precision)), data_tile, g, rw,
              _at(partial, s, tiles * M), _at(tickets, s), _at(out, s, M))
    return out


def eval_fitness_from_preds_plain(preds, y, weight, *, kernel: str = "r",
                                  n_classes: int = 3, precision: float = 1e-4,
                                  data_tile: int = 1024):
    """Plain PyTorch version of B4: moments of preds per data tile,
    merged in order."""
    return _ref.moments_tiled(lambda lo, hi: preds[:, lo:hi], preds.shape[1], y,
                              _fit_spec(kernel, n_classes, precision), weight=weight,
                              tile=data_tile)


def eval_fitness_from_preds(preds, y, weight, *, kernel: str = "r", n_classes: int = 3,
                            precision: float = 1e-4, data_tile: int = 1024, gate=None,
                            run_when: bool = False, out=None):
    """B4: moments of pre-gathered predictions preds f32[P, D] -> f32[P, M],
    one CUDA launch: B3's block body on row preds[p]. The gather stays
    outside, as the reference's XLA-level `uniq[root]` does."""
    if not (preds.is_cuda or preds.is_meta):
        res = eval_fitness_from_preds_plain(preds, y, weight, kernel=kernel,
                                            n_classes=n_classes, precision=precision,
                                            data_tile=data_tile)
        return _gated(res, gate, run_when, out)
    kern = _device_kernel(kernel)
    P, D = preds.shape
    dev = preds.device
    _check(dev, preds=(preds, torch.float32, (P, D)), y=(y, torch.float32, (D,)),
           weight=(weight, torch.float32, (D,)))
    M = kern.n_moments
    tiles, partial, out = _tile_buffers(P, D, data_tile, M, out, dev)
    if P == 0:
        return out
    if preds.is_meta:
        return _planned("eval_fitness_from_preds", len(pop_chunks(P)), out, gate)
    g, rw = _gate_args(gate, run_when, dev)
    tickets = _tickets(P, dev)
    for s, n in pop_chunks(P):
        _call("eval_fitness_from_preds", "gp_fitness_from_preds", dev, _at(preds, s, D), n, D,
              y.data_ptr(), _ptr(weight), kern.device_id, float(n_classes - 1),
              float(np.float32(precision)), data_tile, g, rw, _at(partial, s, tiles * M),
              _at(tickets, s), _at(out, s, M))
    return out


# --- the unique-subtree table ---------------------------------------------------


def unique_table_plain(plan: _eval.DedupPlan, X, const_table, *, fn_codes=None):
    """Plain PyTorch version of the unique-table kernel:
    `core/eval.evaluate_unique_subtrees`."""
    spec = TreeSpec(fn_set=_fn_set(fn_codes), genome="postfix")
    return _eval.evaluate_unique_subtrees(plan, X, const_table, spec)


def table_geometry(D: int) -> tuple[int, int]:
    """(blocks, dynamic shared memory bytes per block) of the unique-table
    kernel on D points: one persistent block per SM (no more than there
    are points), each with TABLE_SMEM_BYTES."""
    return min(SMS, D), TABLE_SMEM_BYTES


def table_words(n_live: int, max_len: int) -> int:
    """32-bit words of the table kernel's shared memory before the slots'
    values: each live slot's place, word and operands (3), and the counts
    and bounds of its (height, kind) bins (heights below max_len, 32
    kinds), rounded up to 16 bytes."""
    cap = min(max(max_len - 1, 0), n_live)
    return -(-(3 * n_live + 2 * ((cap + 1) * 32 + 1)) // 4) * 4


def table_schedule(n_live: int, max_len: int, D: int, blocks: int,
                   smem_bytes: int) -> tuple[str, int]:
    """(schedule, points per tile) that the table kernel takes for n_live
    live slots whose longest span is max_len: "staged" (metadata and the
    slots' values at a tile's points in shared memory, the tile as wide
    as fits, up to 32) or "scan" (nothing staged, 32 points a tile: more
    than 65,535 live slots, or too little shared memory for one point's
    values). The kernel decides on the device (`unique_table_kernel` and
    `table_tile` in csrc/gp_eval.cu); this mirrors it for reports and
    tests."""
    words = table_words(n_live, max_len)
    if n_live > 65535 or 4 * n_live * 4 > smem_bytes or (words + n_live) * 4 > smem_bytes:
        return "scan", 32
    free = smem_bytes // 4 - words
    w = 32
    while w > 1 and (n_live * w > free or -(-D // w) < blocks):
        w //= 2

    def share(t):
        return -(-(-(-D // t)) // blocks) * t

    if w > 1 and 8 * share(w // 2) <= 7 * share(w):
        w //= 2
    return "staged", w


def unique_table(plan: _eval.DedupPlan, X, const_table, *, fn_codes=None, gate=None,
                 run_when: bool = False):
    """f32[U, D] value of every unique subexpression of `plan`, U = the
    plan's cap: rows [0, n_unique) and the reserved all-EMPTY row U - 1
    (0.0), the rows anything reads.

    One launch, no sort: one persistent block per SM (`table_geometry`)
    stages the live slots' metadata in shared memory, reading n_unique on
    the device (the host never does), groups the slots by subtree height
    (a slot's operands are lower), then evaluates its tiles of points one
    height at a time with every value in shared memory, and writes each
    tile's rows once (`table_schedule`). A plan with more than 65,535
    live slots, or too many for one point's values to fit, takes the
    kernel's slower scan over span lengths instead.

    The kernel leaves the other unused rows unwritten (the plain version
    holds 0.0 there). On overflow (n_unique > U - 1) every row is written,
    from operand ids clamped to [0, U - 1]; nothing reads those rows (the
    session path gates them off), and an ungated call must only run
    without a fault. With a gate, the kernel fills the table only where
    `gate == run_when` (the table is then left unwritten: its readers are
    gated the same way)."""
    if not (plan.uop.is_cuda or plan.uop.is_meta):
        return unique_table_plain(plan, X, const_table, fn_codes=fn_codes)
    (U,) = plan.uop.shape
    F, D = X.shape
    dev = plan.uop.device
    _check(dev, **{f: (getattr(plan, f), torch.int32, (U,))
                   for f in ("uop", "uarg", "ulhs", "urhs", "ulen")},
           n_unique=(plan.n_unique, torch.int32, ()), X=(X, torch.float32, (F, D)),
           const_table=(const_table, torch.float32, const_table.shape))
    uniq = torch.empty((U, D), dtype=torch.float32, device=dev)
    if plan.uop.is_meta:
        return _planned("unique_table", 1, uniq, gate)
    blocks, smem = table_geometry(D)
    g, rw = _gate_args(gate, run_when, dev)
    _call("unique_table", "gp_unique_table", dev, plan.uop.data_ptr(), plan.uarg.data_ptr(),
          plan.ulhs.data_ptr(), plan.urhs.data_ptr(), plan.ulen.data_ptr(),
          plan.n_unique.data_ptr(), U, X.data_ptr(), F, D, const_table.data_ptr(),
          const_table.shape[0], _fn_set(fn_codes).mask, g, rw, blocks, smem,
          uniq.data_ptr())
    return uniq


# --- postfix predictions (the semantic tier's probe) ----------------------------


def predict_postfix_plain(op, arg, X, const_table, *, stack_size: int, fn_codes=None):
    """Plain PyTorch version of the predict kernel: the stack machine
    `core/eval.evaluate_population_postfix`."""
    spec = TreeSpec(max_depth=stack_size - 1, fn_set=_fn_set(fn_codes), genome="postfix")
    return _eval.evaluate_population_postfix(op, arg, X, const_table, spec)


def probe_geometry(P: int, N: int) -> tuple[int, int, int]:
    """(rows a block, blocks, dynamic shared memory bytes) of the probe
    kernel for P rows of N slots: one warp per row, as many rows a block
    as fit the default 48 KB of shared memory, at most PROBE_ROWS and at
    most P (a lone row may take up to 227 KB). A row's shared memory holds
    its program (3 words a slot), its first PROBE_TERMS feature terminals'
    rows and their values at 32 points. Raises where one row does not fit
    or the grid (ceil(P / rows) blocks, the kernel's int32 row count)
    passes 2**31 - 1."""
    row_bytes = 4 * (3 * N + PROBE_TERMS + 32 * PROBE_TERMS)
    rows = max(1, min(PROBE_ROWS, P, _SMEM_DEFAULT // row_bytes))
    blocks = -(-P // rows)
    if row_bytes > _SMEM_MAX or P > _GRID_X_MAX or blocks > _GRID_X_MAX:
        raise ValueError(f"unsupported probe launch: P={P} rows of N={N} slots "
                         f"({row_bytes} bytes of shared memory a row, at most "
                         f"{_SMEM_MAX}; P at most {_GRID_X_MAX})")
    return rows, blocks, rows * row_bytes


def predict_postfix(op, arg, X, const_table, *, stack_size: int, fn_codes=None):
    """f32[P, D] predictions of postfix streams op/arg int32[P, N] on
    X f32[F, D]: B2's interpreter without the epilogue (the semantic
    dedup tier's probe), one warp per row (`probe_geometry`); any D, 32
    points a warp at a time. `stack_size` and `fn_codes` as for B2."""
    if not (op.is_cuda or op.is_meta):
        return predict_postfix_plain(op, arg, X, const_table, stack_size=stack_size,
                                     fn_codes=fn_codes)
    if not 1 <= stack_size <= max(STACK_TEMPLATES):
        raise ValueError(f"stack_size={stack_size} exceeds the kernel's register "
                         f"stacks {STACK_TEMPLATES}")
    P, N = op.shape
    F, D = X.shape
    dev = op.device
    _check(dev, op=(op, torch.int32, (P, N)), arg=(arg, torch.int32, (P, N)),
           X=(X, torch.float32, (F, D)),
           const_table=(const_table, torch.float32, const_table.shape))
    rows, _, _ = probe_geometry(P, N)
    preds = torch.empty((P, D), dtype=torch.float32, device=dev)
    if P == 0 or D == 0:
        return preds
    if op.is_meta:
        return _planned("predict_postfix", 1, preds)
    _call("predict_postfix", "gp_predict_postfix", dev, op.data_ptr(), arg.data_ptr(), P, N,
          stack_size, X.data_ptr(), F, D, const_table.data_ptr(), const_table.shape[0],
          _fn_set(fn_codes).mask, rows, preds.data_ptr())
    return preds
