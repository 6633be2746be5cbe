"""Public wrappers for the GP eval+fitness kernel.

Port of `repro/kernels/ops.py` (heap genomes). Picks the data tile for
Hopper, composes the weight mask, passes the run's function set, and
dispatches on `impl`:

    impl="cuda"   the fused kernel (kernels/gp_eval.py; its plain version
                  when the tensors lie on the CPU)
    impl="torch"  the plain oracle (kernels/ref.py)

Two surfaces, as in the reference:

    fitness(...)  f32[P] finalized fitness
    moments(...)  f32[P, M] phase-1 moments only
"""
from __future__ import annotations

from repro_torch.core import fitness as fit
from repro_torch.core.fitness import FitnessSpec
from repro_torch.core.trees import TreeSpec
from repro_torch.device import resolve_device
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.gp_eval import eval_fitness

SMS = 132  # streaming multiprocessors of an H100 SXM
BLOCK_THREADS = 256  # threads per block of csrc/gp_eval.cu
_MIN_BLOCKS = 4 * SMS


def pick_tiles(n_features: int, n_nodes: int, pop: int, data: int,
               data_tile: int = 4096) -> tuple[int, int]:
    """(threads per block, data tile) for the Hopper kernel.

    The TPU version sized the tile to a VMEM budget; here a block's
    footprint is tiny (the tree's instruction list in shared memory,
    N·12 bytes, and its operand stack in registers), so the tile is
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


def _fused_moments(op, arg, X, y, const_table, tree_spec: TreeSpec,
                   fit_spec: FitnessSpec, weight, data_tile: int, gather):
    """Run the fused kernel: f32[P, M] moments — the counterpart of the
    reference's `_moments_padded`. The kernel masks the ragged last data
    tile itself and takes any row count, so neither X (F·D floats, 22 MB
    for ligo) nor the population is copied into a padded buffer every
    generation; a caller's `weight` (0.0 on dataset padding) is the only
    mask."""
    if tree_spec.genome != "tree":
        raise NotImplementedError("postfix genomes are not ported yet "
                                  "(ROADMAP queue A item 5, kernel B2)")
    P, N = op.shape
    F, D = X.shape
    _, tile = pick_tiles(F, N, P, D, data_tile)
    fn_codes = tuple(int(c) for c in tree_spec.fn_set.opcodes)
    return eval_fitness(
        op.contiguous(), arg.contiguous(), X.float().contiguous(),
        y.float().contiguous(), None if weight is None else weight.float().contiguous(),
        const_table.float().contiguous(), max_depth=tree_spec.max_depth,
        kernel=fit_spec.kernel, n_classes=fit_spec.n_classes,
        precision=fit_spec.precision, gather=gather, data_tile=tile,
        fn_codes=fn_codes)


def _check_device(op, device):
    """The entry points run where the caller says (default: the card)
    and refuse tensors that lie elsewhere, so a call meant for the card
    never runs on the CPU by accident."""
    dev = resolve_device(device)
    if op.device.type != dev.type:
        raise ValueError(f"population is on {op.device}, not on {dev}; pass "
                         f"device='cpu' to evaluate CPU tensors")


def moments(op, arg, X, y, const_table, tree_spec: TreeSpec, fit_spec: FitnessSpec,
            *, weight=None, data_tile: int = 4096, gather: str | None = None,
            impl: str = "cuda", device=None):
    """f32[P, M] phase-1 moments of every tree against (X:[F,D], y:[D])."""
    _check_device(op, device)
    if fit.get_kernel(fit_spec.kernel).moments is None:
        raise ValueError(f"fitness kernel {fit_spec.kernel!r} defines no moment "
                         f"pass; it cannot accumulate across data tiles")
    if impl == "torch":
        return _ref.moments_ref_tiled(op, arg, X, y, const_table, tree_spec,
                                      fit_spec, weight=weight)
    if impl != "cuda":
        raise ValueError(f"impl must be 'cuda' or 'torch', got {impl!r}")
    return _fused_moments(op, arg, X, y, const_table, tree_spec, fit_spec,
                          weight, data_tile, gather)


def fitness(op, arg, X, y, const_table, tree_spec: TreeSpec, fit_spec: FitnessSpec,
            *, weight=None, data_tile: int = 4096, gather: str | None = None,
            impl: str = "cuda", device=None):
    """f32[P] fitness (minimize) of every tree against (X:[F,D], y:[D]).

    `device=` (default: the card) must be where the tensors lie. `weight`
    is an optional f32[D] mask (0.0 on dataset-padding points)."""
    _check_device(op, device)
    kern = fit.get_kernel(fit_spec.kernel)
    if impl == "torch":
        return _ref.fitness_ref_tiled(op, arg, X, y, const_table, tree_spec,
                                      fit_spec, weight=weight)
    m = moments(op, arg, X, y, const_table, tree_spec, fit_spec, weight=weight,
                data_tile=data_tile, gather=gather, impl=impl, device=op.device)
    return kern.reduce_moments(m, fit_spec)
