"""Public wrappers for the GP eval+fitness kernels.

Port of `repro/kernels/ops.py`. Picks the data tile for Hopper, passes
the weight mask and the run's function set, and dispatches on `impl`:

    impl="cuda"   the fused kernels (kernels/gp_eval.py; their plain
                  versions when the tensors lie on the CPU): B1 for heap
                  genomes; for postfix ones B2, or with dedup the unique
                  table and B3/B4, B2 taking over on overflow
    impl="torch"  the plain oracle (kernels/ref.py)

Two surfaces, as in the reference:

    fitness(...)  f32[P] finalized fitness: the kernels' f32[P, M]
                  moments, then the fitness kernel's `reduce_moments`
                  (a few elementwise ops; pearson and r2 finish there)
    moments(...)  f32[P, M] phase-1 moments only
"""
from __future__ import annotations

import torch

from repro_torch.core import eval as _eval
from repro_torch.core import fitness as fit
from repro_torch.core.fitness import FitnessSpec
from repro_torch.core.trees import TreeSpec
from repro_torch.device import resolve_device
from repro_torch.kernels import gp_eval
from repro_torch.kernels import ref as _ref

SMS = gp_eval.SMS
BLOCK_THREADS = 256  # threads per block of csrc/gp_eval.cu
_MIN_BLOCKS = 4 * SMS


def pick_tiles(n_features: int, n_nodes: int, pop: int, data: int,
               data_tile: int = 4096) -> tuple[int, int]:
    """(threads per block, data tile) for the Hopper kernel.

    The TPU version sized the tile to a VMEM budget; here a block's
    footprint is tiny (the tree's instruction list in shared memory,
    N·8 bytes, and its operand stack in registers), so the tile is
    chosen for parallelism instead: the largest power of two in
    [BLOCK_THREADS, data_tile] that still gives the grid at least
    four blocks per SM (pop × ceil(data / tile) >= 528). Larger tiles
    give each thread more points to amortise its tree's setup; smaller
    ones fill the card when the population is small."""
    del n_features, n_nodes
    tile = BLOCK_THREADS
    while tile * 2 <= max(data_tile, BLOCK_THREADS):
        tile *= 2
    while tile > BLOCK_THREADS and pop * -(-max(data, 1) // tile) < _MIN_BLOCKS:
        tile //= 2
    return BLOCK_THREADS, tile


# The reference's TPU budget test for its dedup kernels, kept for
# correspondence: on the TPU the f32[cap, Db] unique table had to fit
# VMEM beside the postfix kernel's working set at the plain tile pick.
_TPU_VMEM_BUDGET = 12 * 2**20
_TPU_POP_TILE = 8


def _tpu_postfix_vmem(n_features: int, stack_size: int, Db: int, dedup_rows: int) -> int:
    return 4 * (n_features * Db + _TPU_POP_TILE * (stack_size + 8) * Db + dedup_rows * Db)


def _tpu_dedup_fits(n_features: int, stack_size: int, data: int, cap: int,
                    data_tile: int = 1024) -> bool:
    """Whether the reference runs its in-VMEM gather kernel (B3) rather
    than the spill kernel (B4) for this configuration: its
    `pick_tiles_postfix` data tile from the caller's `data_tile` (the
    reference's default and GPConfig's: 1024), then its `_postfix_vmem`
    charged with the cap's rows, against its 12 MiB budget. The rule is
    the TPU's; the port follows it so that a configuration runs the
    counterpart of the kernel the reference runs. (kat7 at 1024: B3 up to
    a cap of 1,415, B4 above.) `data_tile` is the caller's, before
    `pick_tiles` turns it into the card's tile."""
    Db = data_tile
    while (Db * 2 <= data and Db < 2048
           and _tpu_postfix_vmem(n_features, stack_size, Db * 2, 0) <= _TPU_VMEM_BUDGET):
        Db *= 2
    while Db > 128 and _tpu_postfix_vmem(n_features, stack_size, Db, 0) > _TPU_VMEM_BUDGET:
        Db //= 2
    return _tpu_postfix_vmem(n_features, stack_size, Db, cap) <= _TPU_VMEM_BUDGET


def _fused_moments(op, arg, X, y, const_table, tree_spec: TreeSpec,
                   fit_spec: FitnessSpec, weight, data_tile: int, gather,
                   dedup: str = "off", dedup_cap: int = 0):
    """Run the fused kernels: f32[P, M] moments — the counterpart of the
    reference's `_moments_padded`. The kernels mask the ragged last data
    tile themselves and take any row count, so neither X (F·D floats,
    22 MB for ligo) nor the population is copied into a padded buffer
    every generation; a caller's `weight` (0.0 on dataset padding) is the
    only mask.

    Every kernel takes the same `pick_tiles` tile, partial layout and
    ordered tile merge, so dedup on/off and heap/postfix are bitwise on
    the card. The reference sorts postfix rows by length so that a TPU
    pop tile's trip count is its own longest program; with one tree per
    block the port needs no sort (moments are per row).

    Dedup (postfix, `dedup != "off"`): the plan is built on the device,
    then the unique table and B3 (or B4, where the reference's TPU rule
    says the table would spill) run when `plan.overflow` is False and B2
    when it is True, both into one output: the reference's
    `lax.cond(plan.overflow, ...)` with no host read. On CPU tensors the
    plain versions run both branches and select the same way."""
    P, N = op.shape
    F, D = X.shape
    kern = fit.get_kernel(fit_spec.kernel)
    _, tile = pick_tiles(F, N, P, D, data_tile)
    fn_codes = tuple(int(c) for c in tree_spec.fn_set.opcodes)
    X = X.float().contiguous()
    y = y.float().contiguous()
    weight = None if weight is None else weight.float().contiguous()
    const_table = const_table.float().contiguous()
    fk = dict(kernel=fit_spec.kernel, n_classes=fit_spec.n_classes,
              precision=fit_spec.precision, data_tile=tile)
    if tree_spec.genome != "postfix":
        return gp_eval.eval_fitness(op.contiguous(), arg.contiguous(), X, y, weight,
                                    const_table, max_depth=tree_spec.max_depth,
                                    gather=gather, fn_codes=fn_codes, **fk)
    S = tree_spec.stack_size
    plain = dict(stack_size=S, fn_codes=fn_codes, **fk)
    if dedup == "off":
        return gp_eval.eval_fitness_postfix(op.contiguous(), arg.contiguous(), X, y,
                                            weight, const_table, **plain)
    cap = _eval.resolve_dedup_cap(dedup_cap, P, N)
    plan = _eval.build_dedup_plan(op, arg, tree_spec, cap)
    gate = plan.overflow
    out = torch.empty((P, kern.n_moments), dtype=torch.float32, device=op.device)
    uniq = gp_eval.unique_table(plan, X, const_table, fn_codes=fn_codes, gate=gate,
                                run_when=False)
    if _tpu_dedup_fits(F, S, D, cap, data_tile):
        out = gp_eval.eval_fitness_from_subtrees(plan.root, uniq, y, weight, gate=gate,
                                                 run_when=False, out=out, **fk)
    else:
        preds = uniq.index_select(0, plan.root.long().clamp(0, cap - 1))
        out = gp_eval.eval_fitness_from_preds(preds, y, weight, gate=gate,
                                              run_when=False, out=out, **fk)
    return gp_eval.eval_fitness_postfix(op.contiguous(), arg.contiguous(), X, y, weight,
                                        const_table, gate=gate, run_when=True, out=out,
                                        **plain)


def _check_device(op, device):
    """The entry points run where the caller says (default: the card)
    and refuse tensors that lie elsewhere, so a call meant for the card
    never runs on the CPU by accident."""
    dev = resolve_device(device)
    if op.device.type != dev.type:
        raise ValueError(f"population is on {op.device}, not on {dev}; pass "
                         f"device='cpu' to evaluate CPU tensors")


def moments(op, arg, X, y, const_table, tree_spec: TreeSpec, fit_spec: FitnessSpec,
            *, weight=None, data_tile: int = 1024, gather: str | None = None,
            impl: str = "cuda", device=None, dedup: str = "off", dedup_cap: int = 0):
    """f32[P, M] phase-1 moments of every tree against (X:[F,D], y:[D]).
    Any `dedup != "off"` engages the exact-tier subexpression dedup on
    postfix genomes (bitwise the same moments)."""
    _check_device(op, device)
    if fit.get_kernel(fit_spec.kernel).moments is None:
        raise ValueError(f"fitness kernel {fit_spec.kernel!r} defines no moment "
                         f"pass; it cannot accumulate across data tiles")
    if impl == "torch":
        return _ref.moments_ref_tiled(op, arg, X, y, const_table, tree_spec,
                                      fit_spec, weight=weight, dedup=dedup,
                                      dedup_cap=dedup_cap)
    if impl != "cuda":
        raise ValueError(f"impl must be 'cuda' or 'torch', got {impl!r}")
    return _fused_moments(op, arg, X, y, const_table, tree_spec, fit_spec,
                          weight, data_tile, gather, dedup, dedup_cap)


def fitness(op, arg, X, y, const_table, tree_spec: TreeSpec, fit_spec: FitnessSpec,
            *, weight=None, data_tile: int = 1024, gather: str | None = None,
            impl: str = "cuda", device=None, dedup: str = "off", dedup_cap: int = 0):
    """f32[P] fitness (minimize) of every tree against (X:[F,D], y:[D]).

    `device=` (default: the card) must be where the tensors lie. `weight`
    is an optional f32[D] mask (0.0 on dataset-padding points).
    `data_tile` (default 1024, the reference's and GPConfig's) bounds the
    card's tile (`pick_tiles`) and starts the reference's B3-or-B4 rule
    (`_tpu_dedup_fits`)."""
    _check_device(op, device)
    kern = fit.get_kernel(fit_spec.kernel)
    if impl == "torch":
        return _ref.fitness_ref_tiled(op, arg, X, y, const_table, tree_spec,
                                      fit_spec, weight=weight, dedup=dedup,
                                      dedup_cap=dedup_cap)
    m = moments(op, arg, X, y, const_table, tree_spec, fit_spec, weight=weight,
                data_tile=data_tile, gather=gather, impl=impl, device=op.device,
                dedup=dedup, dedup_cap=dedup_cap)
    return kern.reduce_moments(m, fit_spec)
