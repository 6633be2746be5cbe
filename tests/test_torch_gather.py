"""The port's B3/B4 wrappers (`eval_fitness_from_subtrees`,
`eval_fitness_from_preds`) against the reference's Pallas kernels
`eval_fitness_pallas_from_subtrees` / `_from_preds` in interpret mode,
and the host-side helpers of their launches.

The geometries are the ones the CUDA kernel treats specially: D = 9
(fewer points than one tile, not a multiple of 4 floats), D = 1,001
(several data tiles, the last one ragged) and D = 2·128 + 37 (a ragged
last tile after two whole ones), at a data tile of 128. The
reference takes only whole tiles, so its inputs are padded to the tile
with zero weights, as its ops pad them; the port takes D as it is.

Tolerances: on integer-lattice data (add/sub/mul trees, X in {-1, 0,
1}, small-integer y, weights in {0, 0.5, 1}) every prediction and
partial sum is exact, so the match is bitwise for r, c, m and mse. On
real-valued data the r/mse sums are taken in another order (torch's
reduction vs the Pallas block's), so they hold to rtol 1e-5. The CUDA
kernels themselves are held against the same plain versions, and
against B1/B2 bit for bit, on the card by chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import gp_eval as jk
from repro_torch.core import eval as teval
from repro_torch.core import primitives as tprim
from repro_torch.core import prng
from repro_torch.core import trees as ttrees
from repro_torch.kernels import gp_eval

torch.set_num_threads(2)

TILE = 128
POP_TILE = 8
GEOMETRIES = [9, 1001, 2 * TILE + 37]


def _table(D, lattice, seed=0, P=16):
    """(root int32[P], uniq f32[U, D]): the unique-subtree table of a
    postfix population with repeated rows (so roots repeat), evaluated by
    the port's plain table on lattice or real-valued data, and y f32[D]."""
    names = ("add", "sub", "mul") if lattice else ("add", "sub", "mul", "div")
    ts = ttrees.TreeSpec(max_depth=4, n_features=3, genome="postfix",
                         fn_set=tprim.FunctionSet.make(names),
                         p_const=0.0 if lattice else 0.2)
    op, arg = ttrees.generate_population(prng.PRNGKey(seed + D), P, ts)
    op[P // 2:], arg[P // 2:] = op[:P - P // 2].clone(), arg[:P - P // 2].clone()
    rng = np.random.RandomState(seed + D)
    if lattice:
        X = rng.randint(-1, 2, size=(3, D)).astype(np.float32)
    else:
        X = (rng.randn(3, D) * 2).astype(np.float32)
    y = rng.randint(0, 3, size=D).astype(np.float32)
    plan = teval.build_dedup_plan(op, arg, ts, teval.resolve_dedup_cap(0, P, op.shape[1]))
    uniq = gp_eval.unique_table(plan, torch.from_numpy(X), ts.const_table(),
                                fn_codes=tuple(int(c) for c in ts.fn_set.opcodes))
    return plan.root, uniq, y


def _weight(D, kind, seed=0):
    if kind is None:
        return None
    return np.random.RandomState(seed + 7).choice(np.float32([0.0, 0.5, 1.0]), D)


def _pad(a, D_pad):
    """`a` with its last axis zero-padded to D_pad (the reference's tile
    padding; zero weight there masks the padded points)."""
    width = [(0, 0)] * (a.ndim - 1) + [(0, D_pad - a.shape[-1])]
    return np.pad(a, width)


def _reference(name, root, uniq, y, w, fk):
    """The reference's Pallas kernel in interpret mode on inputs padded to
    whole data tiles (weights 0 on the padding; all ones on [0, D) where
    the port's weight is None)."""
    D = y.shape[0]
    D_pad = -(-D // TILE) * TILE
    wj = _pad(np.ones(D, np.float32) if w is None else w, D_pad)
    uj = _pad(uniq.numpy(), D_pad)
    kw = dict(pop_tile=POP_TILE, data_tile=TILE, interpret=True, **fk)
    if name == "b3":
        out = jk.eval_fitness_pallas_from_subtrees(
            jnp.asarray(root.numpy()), jnp.asarray(uj), jnp.asarray(_pad(y, D_pad)),
            jnp.asarray(wj), **kw)
    else:
        preds = uj[np.clip(root.numpy(), 0, uj.shape[0] - 1)]
        out = jk.eval_fitness_pallas_from_preds(jnp.asarray(preds),
                                                jnp.asarray(_pad(y, D_pad)),
                                                jnp.asarray(wj), **kw)
    return np.asarray(out)


def _port(name, root, uniq, y, w, fk, **gate):
    yt = torch.from_numpy(y)
    wt = None if w is None else torch.from_numpy(w)
    if name == "b3":
        return gp_eval.eval_fitness_from_subtrees(root, uniq, yt, wt, data_tile=TILE,
                                                  **fk, **gate)
    preds = uniq[root.long().clamp(0, uniq.shape[0] - 1)]
    return gp_eval.eval_fitness_from_preds(preds, yt, wt, data_tile=TILE, **fk, **gate)


@pytest.mark.parametrize("weighted", [None, "fractions"])
@pytest.mark.parametrize("kernel", ["r", "c", "m", "mse"])
@pytest.mark.parametrize("D", GEOMETRIES)
def test_b3_b4_vs_reference_kernels_on_lattice_data(D, kernel, weighted):
    """B3 and B4 equal the reference's kernels bit for bit on lattice
    data, with and without a weight of zeros and fractions, including a
    NaN prediction at a zero-weight point (masked) and one at a weighted
    point (+inf for every kernel)."""
    root, uniq, y = _table(D, lattice=True)
    w = _weight(D, weighted)
    if w is not None:  # NaN at a masked point of tree 0, at a weighted one of tree 1
        w[0], w[1] = 0.0, 1.0
        uniq = uniq.clone()
        uniq[root[0], 0] = float("nan")
        uniq[root[1], 1] = float("nan")
    fk = dict(kernel=kernel, n_classes=3, precision=0.5)
    for name in ("b3", "b4"):
        got = _port(name, root, uniq, y, w, fk).numpy()
        want = _reference(name, root, uniq, y, w, fk)
        assert got.shape == want.shape == (root.shape[0], 1)
        np.testing.assert_array_equal(got, want, err_msg=name)
        if w is not None:
            assert np.isinf(got[1, 0]), name
    b3 = _port("b3", root, uniq, y, w, fk).numpy()
    np.testing.assert_array_equal(b3, _port("b4", root, uniq, y, w, fk).numpy())


@pytest.mark.parametrize("kernel", ["r", "mse"])
@pytest.mark.parametrize("D", [1001, 2 * TILE + 37])
def test_b3_b4_vs_reference_kernels_on_real_data(D, kernel):
    """On real-valued data with division the r/mse sums hold to rtol 1e-5
    (another summation order), and B3 == B4 in the port."""
    root, uniq, y = _table(D, lattice=False, seed=3)
    w = _weight(D, "fractions", seed=3)
    fk = dict(kernel=kernel, n_classes=3, precision=1e-4)
    for name in ("b3", "b4"):
        got = _port(name, root, uniq, y, w, fk).numpy()
        want = _reference(name, root, uniq, y, w, fk)
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(_port("b3", root, uniq, y, w, fk).numpy(),
                                  _port("b4", root, uniq, y, w, fk).numpy())


@pytest.mark.parametrize("name", ["b3", "b4"])
@pytest.mark.parametrize("D", [9, 1001])
def test_b3_b4_gates(name, D):
    """With a gate, B3/B4 write their moments only where gate ==
    run_when (the reference's result there); elsewhere `out` is left as
    it was, as the card's gated-off blocks leave it."""
    root, uniq, y = _table(D, lattice=True, seed=5)
    fk = dict(kernel="c", n_classes=3, precision=0.5)
    want = _reference(name, root, uniq, y, None, fk)
    for flag in (False, True):
        out = torch.full((root.shape[0], 1), 7.0)
        got = _port(name, root, uniq, y, None, fk, gate=torch.tensor(flag), run_when=False,
                    out=out)
        if flag:
            np.testing.assert_array_equal(got.numpy(), np.full_like(want, 7.0))
        else:
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("P", [0, 1, 65534, 65535, 65536, 70_000, 131_070, 200_001])
def test_pop_chunks_cover_the_population_in_order(P):
    """B1-B4 launch at most 65,535 trees at a time (the grid's y
    dimension): the chunks are consecutive, in order, cover [0, P)
    exactly, and P <= 65,535 is one launch."""
    chunks = gp_eval.pop_chunks(P)
    assert gp_eval.POP_CHUNK == 65535
    assert all(0 < n <= 65535 for _, n in chunks)
    assert [s for s, _ in chunks] == [sum(n for _, n in chunks[:i]) for i in range(len(chunks))]
    assert sum(n for _, n in chunks) == P
    assert len(chunks) == -(-P // 65535)


@pytest.mark.parametrize("P,limit", [(10, 3), (9, 3), (2, 5)])
def test_pop_chunks_with_a_small_limit(P, limit):
    chunks = gp_eval.pop_chunks(P, limit)
    covered = [i for s, n in chunks for i in range(s, s + n)]
    assert covered == list(range(P))
    assert all(n <= limit for _, n in chunks)


def test_chunk_addresses_follow_the_trees():
    """`_at` gives the address of tree s's entries, as the wrappers pass
    it for each chunk's op/arg, root or preds, out, tickets and partial."""
    t = torch.zeros((7, 5), dtype=torch.int32)
    for s in range(7):
        assert gp_eval._at(t, s, 5) == t[s].data_ptr()
    v = torch.zeros(7)
    assert gp_eval._at(v, 3) == v[3:].data_ptr()
