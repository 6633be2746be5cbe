"""The two-pass fitness kernels `pearson` and `r2` in the port against
`repro` on the same numpy inputs: the fitness module (moments, the Chan
combine folded over tiles, reduce, the whole-dataset partial, metric,
y-moments), the plain versions of B1-B4 against the reference's Pallas
functions in interpret mode, `ops.fitness` on every path, and sessions.

Every moment case holds these edge cases: weights of 0 with ±3.4e38,
±inf and NaN predictions at those points; fractional weights with
Σw < 1; a tile that is all padding; a ragged last tile; constant-
prediction trees (the noise floor gives them fitness 1, not 0); NaN or
inf at a valid point (fitness +inf); and a target 1e4 + N(0, 1), where
raw moments would cancel.

Tolerances: moments rtol 1e-5 with atol 1e-5 × the column's largest
|value| (the sums run in another order than XLA's; a sum of a few
hundred terms of both signs that cancels to ~1e-3 of the column's
largest entry rounds apart at ~1e-6 of it, so 1e-6 of the column is too
tight there); fitness within 1e-5 absolute where the tile partitions
agree, 1e-4 where they differ (the reference's own tiled-vs-untiled
bound, tests/test_blocks.py), and for r2, whose fitness and metric are
unbounded, relatively as well; +inf at exactly the same trees. A tree
with a non-finite prediction at a valid point (+inf) is held by its count
column and its fitness: its x0 = 0 there is an outlier that dominates
its other moments. The Chan combine itself is bitwise: the port's
fold of the reference's tile partials is the reference's fold.

One bound is wider, and only for the 1e4 + N(0, 1) target once tiles
merge (or the single-pass form subtracts its mean): a tile's f32 mean
near 1e4 differs by an ulp (~1e-3) between two summation orders, and the
merge's δ·δ·n1·n2/n term carries that into M2y and Cxy at ~ulp(ȳ)·|δ|·n,
5e-5 to 1e-4 of them here, and the fitness up to 1.04e-4. That is the
resolution the reference's own noise floor (`_VAR_NOISE_FLOOR`, ~256
ulps of the mean) is built on, so those comparisons hold moments to
1e-4 (relative) and fitness to 2e-4 (absolute).
pearson's merged Cxy is the exception: its merge term δx·δy·n1·n2/n
carries the ulp of ȳ times the spread of the tiles' x̄, which can be
larger than 1e-4 of a small Cxy, so there it is held through the fitness
(1e-4) alone.
Session histories are bitwise on a dyadic lattice, where every sum is
exact in f32."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fitness as jfit
from repro.core import primitives as jprim
from repro.core import trees as jtrees
from repro.gp import GPSession as JSession
from repro.kernels import gp_eval as jk
from repro.kernels import ops as jops
from repro_torch.core import eval as teval
from repro_torch.core import fitness as tfit
from repro_torch.core import primitives as tprim
from repro_torch.core import prng
from repro_torch.core import trees as ttrees
from repro_torch.gp import GPSession
from repro_torch.kernels import gp_eval
from repro_torch.kernels import ops as tops
from jax_release import release_jax_programs  # noqa: F401  (frees compiled programs)

torch.set_num_threads(2)

TWO_PASS = ["pearson", "r2"]
_BIG = np.float32(3.4e38)


def _weights(rng, D, kind):
    """f32[D] weights: "mixed" (0, 1/4, 1/2, 1 with points 210-314 all 0:
    a padding tile at a tile of 105), "small" (fractional, Σw < 1), "ones"."""
    if kind == "ones":
        return np.ones(D, np.float32)
    if kind == "small":
        w = (rng.rand(D) * 0.9 / D).astype(np.float32)
    else:
        w = rng.choice(np.float32([0.0, 0.25, 0.5, 1.0]), D)
    w[:6] = 0.0
    w[210:315] = 0.0
    return w


def _edge_case(seed, target, wkind, P=12, D=523):
    """(preds f32[P, D], y f32[D], w f32[D]): predictions near the target
    (so r2's fitness is of order 1), with the edge cases of the module
    docstring."""
    rng = np.random.RandomState(seed)
    if target == "offset":
        y = (1e4 + rng.randn(D)).astype(np.float32)
    else:
        y = rng.randn(D).astype(np.float32)
    scale = rng.uniform(0.1, 2.0, size=(P, 1))
    slope = rng.uniform(-1.5, 0.5, size=(P, 1))
    preds = (y[None, :] + slope * (y - y.mean())[None, :]
             + scale * rng.randn(P, D)).astype(np.float32)
    w = _weights(rng, D, wkind)
    # zero-weight points (w[:6] == 0) carry saturated and non-finite values
    preds[:, 0], preds[:, 1], preds[:, 2] = _BIG, -_BIG, np.inf
    preds[:, 3], preds[:, 4] = -np.inf, np.nan
    preds[2] = np.float32(y.mean() + 0.5)  # constant-prediction trees
    preds[3] = np.float32(y.mean() - 2.0)
    valid = np.nonzero(w > 0)[0]
    preds[4, valid[3]] = np.nan  # invalid at a weighted point: +inf
    preds[5, valid[-1]] = np.inf
    return preds, y, w


def _tiles(D, T):
    t = -(-D // T)
    return [(lo, min(lo + t, D)) for lo in range(0, D, t)]


def _close_moments(got, want, tag="", rtol=1e-5, skip=()):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, tag
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want), err_msg=tag)
    g, w = np.where(np.isfinite(want), got, 0.0), np.where(np.isfinite(want), want, 0.0)
    valid = w[:, -1:] == 0  # the non-finite count column
    np.testing.assert_array_equal(g[:, -1], w[:, -1], err_msg=tag)
    g, w = np.where(valid, g, 0.0), np.where(valid, w, 0.0)
    keep = np.ones(g.shape[1], bool)
    keep[list(skip)] = False
    g, w = g[:, keep], w[:, keep]
    atol = rtol * np.abs(w).max(axis=0, keepdims=True)  # per column
    bad = np.abs(g - w) > rtol * np.abs(w) + atol
    assert not bad.any(), (f"{tag}: moments differ at {np.argwhere(bad)[:5].tolist()}: "
                           f"{g[bad][:5]} vs {w[bad][:5]} (column atol {atol.ravel()})")


def _close_fitness(got, want, atol=1e-5, tag="", rtol=0.0):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want), err_msg=tag)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want), err_msg=tag)
    assert not np.isnan(want).any() and not np.isnan(got).any(), tag
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=atol, err_msg=tag)


def _rt(kernel, tol):
    """The relative part of a fitness bound: r2's fitness and metric are
    unbounded, pearson's lie in [0, 1]."""
    return tol if kernel == "r2" else 0.0


def _pair(kernel):
    return (jfit.get_kernel(kernel), jfit.FitnessSpec(kernel),
            tfit.get_kernel(kernel), tfit.FitnessSpec(kernel))


# --- 1. the fitness module --------------------------------------------------------


@pytest.mark.parametrize("kernel", TWO_PASS)
@pytest.mark.parametrize("target", ["standard", "offset"])
@pytest.mark.parametrize("wkind", ["mixed", "small"])
def test_moments_combine_reduce_vs_reference(kernel, target, wkind):
    """moments, combine_moments folded over 1, 2 and 5 tiles (tile 2 of
    5 all padding, the last tile ragged), reduce_moments and y_moments."""
    jk_, js, tk, ts = _pair(kernel)
    preds, y, w = _edge_case(1, target, wkind)
    D = y.shape[0]
    merged_tol = 1e-4 if target == "offset" else 1e-5  # see the module docstring
    fit_tol = 2e-4 if target == "offset" else 1e-5
    np.testing.assert_allclose(
        tk.y_moments(torch.from_numpy(y), torch.from_numpy(w), ts).numpy(),
        np.asarray(jk_.y_moments(jnp.asarray(y), jnp.asarray(w), js)), rtol=1e-5,
        atol=1e-6 * np.abs(y).max())
    for T in (1, 2, 5):
        jparts, tparts = [], []
        for lo, hi in _tiles(D, T):
            jparts.append(jk_.moments(jnp.asarray(preds[:, lo:hi]), jnp.asarray(y[lo:hi]),
                                      jnp.asarray(w[lo:hi]), js))
            tparts.append(tk.moments(torch.from_numpy(preds[:, lo:hi]),
                                     torch.from_numpy(y[lo:hi]),
                                     torch.from_numpy(w[lo:hi]), ts))
            _close_moments(tparts[-1].numpy(), jparts[-1], f"T={T} tile [{lo}, {hi})")
        if T == 5:
            assert float(tparts[2][0, 0]) == 0.0  # the all-padding tile
        jm = jfit.fold_moment_partials(jk_, jparts, js)
        # the combine alone: the reference's partials, folded by the port
        same = tfit.fold_moment_partials(
            tk, [torch.from_numpy(np.array(p)) for p in jparts], ts)
        np.testing.assert_array_equal(same.numpy(), np.asarray(jm), err_msg=f"T={T}")
        tm = tfit.fold_moment_partials(tk, tparts, ts)
        tol = 1e-5 if T == 1 else merged_tol
        skip = (5,) if kernel == "pearson" and target == "offset" and T > 1 else ()
        _close_moments(tm.numpy(), jm, f"T={T} merged", rtol=tol, skip=skip)
        jf = np.asarray(jk_.reduce_moments(jm, js))
        tf = tk.reduce_moments(tm, ts).numpy()
        ftol = 1e-5 if T == 1 else fit_tol
        _close_fitness(tf, jf, atol=ftol, tag=f"T={T}", rtol=_rt(kernel, ftol))
        # the reference's own reduce of the port's moments: the same fitness
        _close_fitness(np.asarray(jk_.reduce_moments(jnp.asarray(tm.numpy()), js)), jf,
                       atol=ftol, tag=f"T={T} reference reduce", rtol=_rt(kernel, ftol))
        assert np.isposinf(tf[4]) and np.isposinf(tf[5])
        if kernel == "pearson":  # the noise floor: constant trees score 1, not 0
            assert tf[2] == 1.0 and tf[3] == 1.0


@pytest.mark.parametrize("kernel", TWO_PASS)
def test_zero_partial_is_a_merge_identity(kernel):
    """The all-zeros partial is an identity of the merge, and the y-only
    columns scatter back into place (`scatter_tree_y`) as in `repro`."""
    jk_, js, tk, ts = _pair(kernel)
    preds, y, w = _edge_case(2, "offset", "mixed")
    m = tk.moments(torch.from_numpy(preds), torch.from_numpy(y), torch.from_numpy(w), ts)
    zero = torch.zeros_like(m)
    for merged in (tk.merge_moments(zero, m, ts), tk.merge_moments(m, zero, ts)):
        torch.testing.assert_close(merged, m, rtol=1e-6, atol=0)
    torch.testing.assert_close(tk.merge_moments(m, zero, ts), m, rtol=0, atol=0)
    # the hoisted columns reassemble as the reference's scatter_tree_y does
    tm = m[:, list(tk.tree_moment_idx)]
    ym = tk.y_moments(torch.from_numpy(y), torch.from_numpy(w), ts)
    np.testing.assert_array_equal(
        tfit.scatter_tree_y(tk, tm, ym).numpy(),
        np.asarray(jfit.scatter_tree_y(jk_, jnp.asarray(tm.numpy()), jnp.asarray(ym.numpy()))))
    # a padding-only tile gives the all-zeros partial, in both packages
    pad = tk.moments(torch.from_numpy(preds[:, 210:315]), torch.from_numpy(y[210:315]),
                     torch.from_numpy(w[210:315]), ts)
    assert not pad.any()
    assert not np.asarray(jk_.moments(jnp.asarray(preds[:, 210:315]),
                                      jnp.asarray(y[210:315]),
                                      jnp.asarray(w[210:315]), js)).any()


@pytest.mark.parametrize("kernel", TWO_PASS)
@pytest.mark.parametrize("target", ["standard", "offset"])
@pytest.mark.parametrize("wkind", ["mixed", "small", "ones"])
def test_partial_fitness_and_metric_vs_reference(kernel, target, wkind):
    """The whole-dataset single-pass forms. The constant-prediction rows
    are left out of the partial_fitness comparison: that form has no
    noise floor, so its value there is a ratio of the means' rounding in
    either package (their two-pass fitness is held above)."""
    jk_, js, tk, ts = _pair(kernel)
    preds, y, w = _edge_case(3, target, wkind)
    tol = 1e-4 if target == "offset" else 1e-5  # see the module docstring
    keep = np.r_[0:2, 4:preds.shape[0]]
    got = tk.partial_fitness(torch.from_numpy(preds), torch.from_numpy(y),
                             torch.from_numpy(w), ts).numpy()
    want = np.asarray(jk_.partial_fitness(jnp.asarray(preds), jnp.asarray(y),
                                          jnp.asarray(w), js))
    _close_fitness(got[keep], want[keep], atol=tol, rtol=_rt(kernel, tol))
    assert np.isposinf(got[4]) and np.isposinf(got[5])
    # the metric (all weights 1) on the valid points: every point but the
    # saturated and non-finite columns
    pts = np.ascontiguousarray(np.where(np.isfinite(preds), preds, 0.0)[keep][:, 6:])
    got = tk.metric(torch.from_numpy(pts), torch.from_numpy(y[6:]), ts).numpy()
    want = np.asarray(jk_.metric(jnp.asarray(pts), jnp.asarray(y[6:]), js))
    _close_fitness(got, want, atol=tol, rtol=_rt(kernel, tol))


# --- 2. the plain B1-B4 against the reference's Pallas functions ------------------


def _nan_rows(depth, F):
    """(x_f*x_f) - (x_f*x_f) heap rows: NaN where x_f overflows."""
    N = 2 ** (depth + 1) - 1
    op = np.zeros((F, N), np.int32)
    arg = np.zeros((F, N), np.int32)
    for f in range(F):
        op[f, :7] = [tprim.opcode_of("sub"), tprim.opcode_of("mul"),
                     tprim.opcode_of("mul"), 2, 2, 2, 2]
        arg[f, 3:7] = f
    return torch.from_numpy(op), torch.from_numpy(arg)


def _b_case(seed, target, weighted, P=16, depth=3, F=2, D=700):
    """A heap population (with a NaN row at a weighted and one at a
    zero-weight point, and a constant row), its postfix form, data,
    weight and the reference's padded copies (D -> 768, weight 0)."""
    names = ("add", "sub", "mul", "div")
    kw = dict(max_depth=depth, n_features=F)
    ts = ttrees.TreeSpec(fn_set=tprim.FunctionSet.make(names), **kw)
    js = jtrees.TreeSpec(fn_set=jprim.FunctionSet.make(names), **kw)
    op, arg = ttrees.generate_population(prng.PRNGKey(seed), P - 3, ts)
    nop, narg = _nan_rows(depth, F)
    cop, carg = torch.zeros_like(nop[:1]), torch.zeros_like(narg[:1])
    cop[0, 0] = tprim.CONST  # a constant tree
    op, arg = torch.cat([op, nop, cop]), torch.cat([arg, narg, carg])
    rng = np.random.RandomState(seed)
    X = rng.randn(F, D).astype(np.float32)
    y = rng.randn(D).astype(np.float32) + (1e4 if target == "offset" else 0.0)
    y = y.astype(np.float32)
    w = _weights(rng, D, "mixed") if weighted else np.ones(D, np.float32)
    X[0, 0] = 1e30  # x0 overflows at point 0: weight 0 when weighted
    X[1, 700 - 1] = 1e30  # x1 at the last point: always weighted
    pad = 768 - D
    Xp, yp = np.pad(X, ((0, 0), (0, pad))), np.pad(y, (0, pad))
    wp = np.pad(w, (0, pad))
    return ts, js, op, arg, X, y, (w if weighted else None), Xp, yp, wp


@pytest.mark.parametrize("kernel", TWO_PASS)
@pytest.mark.parametrize("target,weighted", [("standard", False), ("standard", True),
                                             ("offset", True)])
def test_plain_b1_b4_vs_reference_kernels(kernel, target, weighted):
    """P=16, depth 3, D=700 at data_tile=256 (3 tiles, the last ragged; the
    reference's copy padded to 768 with weight 0): [P, M] moments to
    rtol 1e-5, fitness to 1e-5 (the same tile partition; 1e-4 for the
    offset target, whose three tiles merge: see the module docstring)."""
    ts, js, op, arg, X, y, w, Xp, yp, wp = _b_case(5, target, weighted)
    tol = 1e-4 if target == "offset" else 1e-5
    codes = tuple(int(c) for c in ts.fn_set.opcodes)
    fk = dict(kernel=kernel, n_classes=3, precision=1e-4, data_tile=256)
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y)
    wt = None if w is None else torch.from_numpy(w)
    j = dict(interpret=True, pop_tile=8, **fk)
    ct = ts.const_table()
    tk = tfit.get_kernel(kernel)
    spec = tfit.FitnessSpec(kernel)

    b1 = gp_eval.eval_fitness(op, arg, Xt, yt, wt, ct, max_depth=3, fn_codes=codes, **fk)
    want = jk.eval_fitness_pallas(jnp.asarray(op.numpy()), jnp.asarray(arg.numpy()),
                                  jnp.asarray(Xp), jnp.asarray(yp), jnp.asarray(wp),
                                  js.const_table(), max_depth=3, fn_codes=codes, **j)
    pop, parg = ttrees.heap_to_postfix(op, arg)
    b2 = gp_eval.eval_fitness_postfix(pop, parg, Xt, yt, wt, ct, stack_size=4,
                                      fn_codes=codes, **fk)
    lens = (pop != 0).sum(-1).to(torch.int32)
    want2 = jk.eval_fitness_pallas_postfix(
        jnp.asarray(pop.numpy()), jnp.asarray(parg.numpy()), jnp.asarray(lens.numpy()),
        jnp.asarray(Xp), jnp.asarray(yp), jnp.asarray(wp), js.const_table(), stack_size=4,
        fn_codes=codes, **j)
    pspec = ttrees.TreeSpec(max_depth=3, n_features=2, fn_set=ts.fn_set, genome="postfix")
    plan = teval.build_dedup_plan(pop, parg, pspec, pop.shape[0] * pop.shape[1] + 1)
    uniq = gp_eval.unique_table(plan, torch.from_numpy(Xp), ct, fn_codes=codes)
    b3 = gp_eval.eval_fitness_from_subtrees(plan.root, uniq[:, :700].contiguous(), yt, wt,
                                            **fk)
    want3 = jk.eval_fitness_pallas_from_subtrees(
        jnp.asarray(plan.root.numpy()), jnp.asarray(uniq.numpy()), jnp.asarray(yp),
        jnp.asarray(wp), **j)
    preds = uniq[plan.root.long()]
    b4 = gp_eval.eval_fitness_from_preds(preds[:, :700].contiguous(), yt, wt, **fk)
    want4 = jk.eval_fitness_pallas_from_preds(jnp.asarray(preds.numpy()), jnp.asarray(yp),
                                              jnp.asarray(wp), **j)
    for name, got, ref in (("B1", b1, want), ("B2", b2, want2), ("B3", b3, want3),
                           ("B4", b4, want4)):
        assert got.shape == (16, tk.n_moments), name
        _close_moments(got.numpy(), np.asarray(ref), name, rtol=tol,
                       skip=(5,) if kernel == "pearson" and target == "offset" else ())
        f = tk.reduce_moments(got, spec).numpy()
        _close_fitness(f, np.asarray(jfit.get_kernel(kernel).reduce_moments(
            ref, jfit.FitnessSpec(kernel))), atol=tol, tag=name, rtol=_rt(kernel, tol))
        assert np.isposinf(f[-2]) and np.isfinite(f[-3]) == weighted, (name, f[-3:])
        if kernel == "pearson":
            assert f[-1] == 1.0, name  # the constant tree
    # the plain versions share one tiled moment pass: bitwise alike
    for other in (b2, b3, b4):
        torch.testing.assert_close(other, b1, rtol=0, atol=0)


# --- 3. ops.fitness on every path ---------------------------------------------------


def _ops_case(genome, seed=7, P=24, D=900):
    names = ("add", "sub", "mul", "div")
    kw = dict(max_depth=4, n_features=3, genome=genome)
    ts = ttrees.TreeSpec(fn_set=tprim.FunctionSet.make(names), **kw)
    js = jtrees.TreeSpec(fn_set=jprim.FunctionSet.make(names), **kw)
    op, arg = ttrees.generate_population(prng.PRNGKey(seed), P, ts)
    op[P // 2:], arg[P // 2:] = op[:P - P // 2].clone(), arg[:P - P // 2].clone()
    rng = np.random.RandomState(seed)
    X = rng.randn(3, D).astype(np.float32)
    y = (1e4 + rng.randn(D)).astype(np.float32)
    w = _weights(rng, D, "mixed")
    return ts, js, op, arg, X, y, w


@pytest.mark.parametrize("kernel", TWO_PASS)
@pytest.mark.parametrize("path", ["heap", "off", "exact_overflow", "exact_fits"])
def test_ops_fitness_vs_reference(kernel, path):
    """ops.fitness (the kernel wrappers' plain versions on CPU tensors)
    against the reference's Pallas path (interpret mode) under the same
    weight: heap trees (B1), postfix with dedup off (B2), and dedup exact
    at a cap that overflows (B2 takes over) and one that does not (the
    table + B3/B4). Tile partitions differ (the port's pick_tiles vs the
    reference's VMEM pick), so fitness holds to 1e-4. In the port, dedup
    on equals dedup off bit for bit."""
    ts, js, op, arg, X, y, w = _ops_case("tree" if path == "heap" else "postfix")
    dd = {"heap": {}, "off": {}, "exact_overflow": dict(dedup="exact", dedup_cap=8),
          "exact_fits": dict(dedup="exact", dedup_cap=100_000)}[path]
    Xt, yt, wt = torch.from_numpy(X), torch.from_numpy(y), torch.from_numpy(w)
    got = tops.fitness(op, arg, Xt, yt, ts.const_table(), ts, tfit.FitnessSpec(kernel),
                       weight=wt, data_tile=256, device="cpu", **dd)
    want = np.asarray(jops.fitness(
        jnp.asarray(op.numpy()), jnp.asarray(arg.numpy()), jnp.asarray(X), jnp.asarray(y),
        js.const_table(), js, jfit.FitnessSpec(kernel), weight=jnp.asarray(w),
        data_tile=256, impl="pallas", **dd))
    _close_fitness(got.numpy(), want, atol=1e-4, rtol=_rt(kernel, 1e-4))
    mom = tops.moments(op, arg, Xt, yt, ts.const_table(), ts, tfit.FitnessSpec(kernel),
                       weight=wt, data_tile=256, device="cpu", **dd)
    assert mom.shape == (op.shape[0], tfit.get_kernel(kernel).n_moments)
    if dd:
        off = tops.fitness(op, arg, Xt, yt, ts.const_table(), ts, tfit.FitnessSpec(kernel),
                           weight=wt, data_tile=256, device="cpu")
        torch.testing.assert_close(got, off, rtol=0, atol=0)


# --- 4. sessions ------------------------------------------------------------------


def _lattice(seed):
    """16 rows of features in {-1, 0, 1} and an integer target. With the
    add/sub set, p_const=0 and depth 2 every prediction is an integer in
    [-4, 4]; with 16 points (a power of two) every mean is a multiple of
    1/16, every centered value and product a multiple of 1/256 below 2**8,
    so every sum, in any order, is exact in f32 and both packages compute
    the same moments; the final divisions are single IEEE operations on
    equal inputs."""
    rng = np.random.RandomState(seed)
    X = rng.randint(-1, 2, size=(16, 3)).astype(np.float32)
    y = (X[:, 0] - X[:, 1] + rng.randint(-1, 2, size=16)).astype(np.float32)
    return X, y


@pytest.mark.parametrize("kernel", TWO_PASS)
@pytest.mark.parametrize("genome", ["tree", "postfix"])
def test_session_history_bitwise_on_lattice(kernel, genome):
    X, y = _lattice(11)
    kw = dict(pop_size=16, generations=8, kernel=kernel, max_depth=2, p_const=0.0,
              fn_set="add,sub", genome=genome)
    js = JSession(backend="jnp", **kw).fit(X, y, key=jax.random.PRNGKey(4))
    ts = GPSession(device="cpu", **kw).fit(X, y, key=prng.PRNGKey(4))
    assert len(ts.history) == 8 and ts.history == js.history
    # the last generation's whole fitness vector, not only its best
    np.testing.assert_array_equal(ts.state.fitness.numpy(), np.asarray(js.state.fitness))
    assert len(set(ts.state.fitness.tolist())) > 3
    assert ts.best_expression() == js.best_expression()
    assert ts.score(X, y) == js.score(X, y)


@pytest.mark.parametrize("kernel", TWO_PASS)
def test_session_first_generation_on_real_data(kernel):
    """General data (kat7, first 1,000 rows): the first generation's
    fitness vector within 1e-5 of the reference's, +inf at the same trees;
    and through the kernel backend (4 tiles of 256 merged by the Chan
    combine, where the torch backend takes the whole dataset at once)
    within 1e-4."""
    import dataclasses

    from repro_torch.core import engine as tengine

    kw = dict(pop_size=32, kernel=kernel, max_rows=1000)
    ts = GPSession.from_dataset("kat7", device="cpu", **kw)
    js = JSession.from_dataset("kat7", backend="jnp", **kw)
    ts.init(key=prng.PRNGKey(2))
    js.init(key=jax.random.PRNGKey(2))
    op, arg = ts.state.op, ts.state.arg
    ts.step()
    js.step()
    want = np.asarray(js.state.fitness)
    assert np.isfinite(want).sum() > 16
    _close_fitness(ts.state.fitness.numpy(), want, rtol=_rt(kernel, 1e-5))
    cfg = dataclasses.replace(ts.config, eval_impl="cuda")
    got = tengine._eval_fitness(cfg, op, arg, ts._X, ts._y, None,
                                cfg.tree_spec.const_table())
    assert tops.pick_tiles(9, 63, 32, 1000, cfg.data_tile)[1] == 256
    _close_fitness(got.numpy(), want, atol=1e-4, rtol=_rt(kernel, 1e-4))


def test_r2_kernel_end_to_end():
    """The reference's test_gp_api.py::test_r2_kernel_end_to_end in the port."""
    from repro_torch.data.datasets import kepler

    X_rows, y, _ = kepler()
    s = GPSession(pop_size=24, generations=4, kernel="r2", device="cpu")
    s.fit(X_rows, y, key=prng.PRNGKey(0))
    assert np.isfinite(s.best_fitness) and s.best_fitness >= 0.0
    assert len(s.history) == 4
    assert s.score(X_rows, y) <= 1.0  # metric is R² (1 = perfect)
