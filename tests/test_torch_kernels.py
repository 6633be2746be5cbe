"""The port's fused eval+fitness wrappers against the reference kernel.

`repro_torch.kernels.ops.fitness` / `.moments` on CPU tensors (where the
CUDA kernel's wrapper runs its plain PyTorch version) against
`repro.kernels.ops.fitness(impl="pallas")` in interpret mode, as
tests/test_kernels.py runs it.

Tolerances: on integer-lattice data (add/sub/mul trees, X in {-1, 0,
1}, small-integer y) every prediction and every partial sum is an exact
f32 integer below 2**24, so the match is bitwise. With division on real-valued data the
r/mse sums are taken in a different order (torch's reduction vs the
Pallas grid's), so they hold to rtol 1e-5; the c/m hit counts are exact
integers either way and stay bitwise. The CUDA kernel itself is held
against the same plain version on the card by chip_smoke.py."""
import json
import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fitness as jfit
from repro.core import primitives as jprim
from repro.core import trees as jtrees
from repro.kernels import ops as jops
from repro_torch.core import fitness as tfit
from repro_torch.core import primitives as tprim
from repro_torch.core import prng
from repro_torch.core import trees as ttrees
from repro_torch.kernels import gp_eval
from repro_torch.kernels import ops as tops
from jax_release import release_jax_programs  # noqa: F401  (frees compiled programs)

torch.set_num_threads(2)

KERNELS = ["r", "c", "m", "mse"]


def _nan_rows(depth, F):
    """Hand-made rows: (x0*x0) - (x0*x0), NaN wherever x0 overflows, and
    (for F > 1) the same on x1, which overflows only at a zero-weight
    point — its fitness must stay finite."""
    N = 2 ** (depth + 1) - 1
    rows = []
    for f in range(min(F, 2)):
        op = np.zeros(N, np.int32)
        arg = np.zeros(N, np.int32)
        op[:7] = [tprim.opcode_of("sub"), tprim.opcode_of("mul"),
                  tprim.opcode_of("mul"), 2, 2, 2, 2]
        arg[3:7] = f
        rows.append((op, arg))
    return np.stack([r[0] for r in rows]), np.stack([r[1] for r in rows])


def _case(depth, F, D, lattice, kernel):
    names = ("add", "sub", "mul") if lattice else ("add", "sub", "mul", "div")
    kw = dict(max_depth=depth, n_features=F, p_const=0.0 if lattice else 0.2)
    js = jtrees.TreeSpec(fn_set=jprim.FunctionSet.make(names), **kw)
    ts = ttrees.TreeSpec(fn_set=tprim.FunctionSet.make(names), **kw)
    op, arg = ttrees.generate_population(prng.PRNGKey(depth * 31 + F), 21, ts)
    rng = np.random.RandomState(depth + F + D)
    if lattice:
        X = rng.randint(-1, 2, size=(F, D)).astype(np.float32)
    else:
        X = (rng.randn(F, D) * 2).astype(np.float32)
    y = rng.randint(0, 3, size=D).astype(np.float32)
    w = (rng.rand(D) > 0.25).astype(np.float32)
    if depth >= 2:  # NaN-producing trees at a weighted and a padded point
        nop, narg = _nan_rows(depth, F)
        op = torch.cat([op, torch.from_numpy(nop)])
        arg = torch.cat([arg, torch.from_numpy(narg)])
        w[0], w[min(2, D - 1)] = 1.0, 0.0
        X[0, 0] = 1e30
        if F > 1:
            X[1, min(2, D - 1)] = 1e30
    jspec = jfit.FitnessSpec(kernel, n_classes=3, precision=0.5)
    tspec = tfit.FitnessSpec(kernel, n_classes=3, precision=0.5)
    want = np.asarray(jops.fitness(
        jnp.asarray(op.numpy()), jnp.asarray(arg.numpy()), jnp.asarray(X),
        jnp.asarray(y), js.const_table(), js, jspec, weight=jnp.asarray(w),
        impl="pallas"))
    args = (op, arg, torch.from_numpy(X), torch.from_numpy(y), ts.const_table(),
            ts, tspec)
    got = tops.fitness(*args, weight=torch.from_numpy(w), device="cpu").numpy()
    mom = tops.moments(*args, weight=torch.from_numpy(w), device="cpu").numpy()
    return want, got, mom


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("depth", [2, 5])
@pytest.mark.parametrize("F,D", [(1, 9), (9, 500), (16, 1030)])
def test_fitness_matches_pallas(kernel, depth, F, D):
    for lattice in (True, False):
        want, got, mom = _case(depth, F, D, lattice, kernel)
        assert got.shape == want.shape and mom.shape == (want.shape[0], 1)
        np.testing.assert_array_equal(mom[:, 0], got)
        np.testing.assert_array_equal(np.isinf(want), np.isinf(got))
        if lattice or kernel in ("c", "m"):
            np.testing.assert_array_equal(got, want, err_msg=f"lattice={lattice}")
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        if depth >= 2:  # the NaN rows: +inf at a valid point, finite if masked
            assert np.isinf(got[21])
            if F > 1:
                assert np.isfinite(got[22])


def test_plain_tiles_merge_in_order():
    """`eval_fitness_plain` over several data tiles equals one tile on
    lattice data (exact sums), for every built-in kernel."""
    ts = ttrees.TreeSpec(max_depth=3, n_features=2, p_const=0.0,
                         fn_set=tprim.FunctionSet.make(("add", "sub", "mul")))
    op, arg = ttrees.generate_population(prng.PRNGKey(1), 10, ts)
    rng = np.random.RandomState(0)
    X = torch.from_numpy(rng.randint(-2, 3, size=(2, 700)).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 3, size=700).astype(np.float32))
    for k in KERNELS:
        kw = dict(max_depth=3, kernel=k, precision=0.5,
                  fn_codes=tuple(ts.fn_set.opcodes))
        one = gp_eval.eval_fitness_plain(op, arg, X, y, None, ts.const_table(),
                                         data_tile=1024, **kw)
        many = gp_eval.eval_fitness_plain(op, arg, X, y, None, ts.const_table(),
                                          data_tile=256, **kw)
        np.testing.assert_array_equal(one.numpy(), many.numpy())


def test_pick_tiles_fills_the_card():
    for P, D in ((100, 10_000), (100, 4_000), (1024, 32_768), (200, 9)):
        threads, tile = tops.pick_tiles(9, 63, P, D)
        assert threads == 256 and tile >= 256 and tile & (tile - 1) == 0
        assert tile == 256 or P * -(-D // tile) >= 4 * 132


def test_wrapper_runs_plain_on_cpu_without_nvcc():
    """Importing and calling the wrapper on CPU tensors never builds or
    launches the CUDA kernel (this machine may have no nvcc at all)."""
    gp_eval.reset_launches()
    ts = ttrees.TreeSpec(max_depth=2, n_features=1)
    op, arg = ttrees.generate_population(prng.PRNGKey(0), 5, ts)
    X, y = torch.ones(1, 9), torch.ones(9)
    out = gp_eval.eval_fitness(op, arg, X, y, None, ts.const_table(), max_depth=2,
                               fn_codes=tuple(ts.fn_set.opcodes))
    assert out.shape == (5, 1)
    assert not any(gp_eval.launches.values()) and gp_eval._LIB is None
    if shutil.which("nvcc") is None:
        with pytest.raises(RuntimeError, match="nvcc"):
            from repro_torch.kernels import build
            build.nvcc()


def test_entry_points_refuse_quiet_cpu_fallback(monkeypatch):
    """With no card, entry points raise unless the caller asks for the
    CPU; the cuda backend refuses a CPU session."""
    from repro_torch.core import engine
    from repro_torch.gp import GPSession

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        GPSession()
    with pytest.raises(ValueError, match="cuda"):
        GPSession(backend="cuda", device="cpu")
    cfg = engine.GPConfig(pop_size=4, tree_spec=ttrees.TreeSpec(max_depth=2))
    with pytest.raises(RuntimeError, match="CUDA"):
        engine.init_state(cfg, prng.PRNGKey(0))
    op, arg = ttrees.generate_population(prng.PRNGKey(0), 4, cfg.tree_spec)
    X, y = torch.ones(2, 9), torch.ones(9)
    with pytest.raises(RuntimeError, match="CUDA"):
        tops.fitness(op, arg, X, y, cfg.tree_spec.const_table(), cfg.tree_spec,
                     cfg.fitness)
    out = tops.fitness(op, arg, X, y, cfg.tree_spec.const_table(), cfg.tree_spec,
                       cfg.fitness, device="cpu")
    assert out.shape == (4,)
    assert GPSession(device="cpu").backend == "torch"


_BUILT_IN = (
    "import json\n"
    "from repro.core import fitness as j\n"
    "from repro_torch.core import fitness as t\n"
    "print(json.dumps([j.available_kernels(), t.available_kernels()]))\n")


def _built_in_kernels():
    """(the reference's, the port's) kernel names as each registers them
    at import, read in a fresh interpreter: a test that ran earlier in
    this process may have registered more (the reference's
    `test_gp_api.py` leaves `test-legacy-full` in its registry)."""
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([src, os.environ.get("PYTHONPATH", "")]))
    r = subprocess.run([sys.executable, "-c", _BUILT_IN], env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    ref, port = json.loads(r.stdout.strip().splitlines()[-1])
    return set(ref), set(port)


def test_not_ported_kernels_raise():
    """Every built-in kernel of the reference resolves in the port, the
    two-pass pearson and r2 (alias r-squared) with the reference's
    moments, hoisted columns and device ids 4 and 5; a kernel with no
    device form raises NotImplementedError when a wrapper would launch
    it, and an unknown name raises ValueError. The built-ins are compared
    as each package registers them at import, whatever ran before here."""
    ref_built_in, port_built_in = _built_in_kernels()
    assert port_built_in == ref_built_in
    assert port_built_in <= set(tfit.available_kernels())
    for name, device_id in (("pearson", 4), ("r2", 5), ("r-squared", 5)):
        t, j = tfit.get_kernel(name), jfit.get_kernel(name)
        assert t.name == j.name and t.n_moments == j.n_moments
        assert t.y_moment_idx == j.y_moment_idx and t.tree_moment_idx == j.tree_moment_idx
        assert t.device_id == device_id and not t.decomposable
        assert gp_eval._device_kernel(name) is t
    host_only = tfit.register_kernel(tfit.FitnessKernel(
        name="host_only_test", partial_fitness=tfit.get_kernel("r").partial_fitness),
        overwrite=True)
    try:
        assert host_only.device_id is None
        with pytest.raises(NotImplementedError, match="device form"):
            gp_eval._device_kernel("host_only_test")
    finally:
        del tfit._REGISTRY["host_only_test"]
    with pytest.raises(ValueError, match="unknown fitness kernel"):
        tfit.get_kernel("no_such_kernel")


def test_wrappers_on_meta_count_a_cards_launches():
    """On `meta` tensors (the dry run) every wrapper checks its inputs,
    launches nothing and returns its output empty on `meta` with the
    shape and dtype a launch gives, counting the launches a card would
    make in `meta_launches` (B1-B4 one per POP_CHUNK trees) and none in
    `launches`; the same calls on CPU tensors still give exactly the
    plain versions' results."""
    from repro_torch.core import eval as teval

    spec = ttrees.TreeSpec(max_depth=3, n_features=2, genome="postfix")
    heap = ttrees.TreeSpec(max_depth=3, n_features=2)
    op, arg = ttrees.generate_population(prng.PRNGKey(1), 9, spec)
    hop, harg = ttrees.generate_population(prng.PRNGKey(2), 9, heap)
    rng = np.random.RandomState(0)
    X = torch.from_numpy(rng.randn(2, 40).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 3, 40).astype(np.float32))
    w = torch.ones(40)
    const = spec.const_table()
    codes = tuple(spec.fn_set.opcodes)
    plan = teval.build_dedup_plan(op, arg, spec, 64)
    uniq = gp_eval.unique_table_plain(plan, X, const, fn_codes=codes)
    preds = uniq[plan.root.long()]
    calls = {  # name -> (wrapper call on a device's tensors, its plain version)
        "eval_fitness": lambda t: (gp_eval.eval_fitness(
            t(hop), t(harg), t(X), t(y), t(w), t(const), max_depth=3, kernel="mse",
            fn_codes=codes), (9, 1)),
        "eval_fitness_postfix": lambda t: (gp_eval.eval_fitness_postfix(
            t(op), t(arg), t(X), t(y), t(w), t(const), stack_size=spec.stack_size,
            kernel="pearson", fn_codes=codes), (9, 7)),
        "eval_fitness_from_subtrees": lambda t: (gp_eval.eval_fitness_from_subtrees(
            t(plan.root), t(uniq), t(y), t(w), kernel="r2"), (9, 5)),
        "eval_fitness_from_preds": lambda t: (gp_eval.eval_fitness_from_preds(
            t(preds), t(y), t(w), kernel="c"), (9, 1)),
        "unique_table": lambda t: (gp_eval.unique_table(
            teval.DedupPlan(*(t(f) for f in plan)), t(X), t(const), fn_codes=codes),
            (64, 40)),
        "predict_postfix": lambda t: (gp_eval.predict_postfix(
            t(op), t(arg), t(X), t(const), stack_size=spec.stack_size, fn_codes=codes),
            (9, 40)),
    }
    plain = {
        "eval_fitness": lambda: gp_eval.eval_fitness_plain(
            hop, harg, X, y, w, const, max_depth=3, kernel="mse", fn_codes=codes),
        "eval_fitness_postfix": lambda: gp_eval.eval_fitness_postfix_plain(
            op, arg, X, y, w, const, stack_size=spec.stack_size, kernel="pearson",
            fn_codes=codes),
        "eval_fitness_from_subtrees": lambda: gp_eval.eval_fitness_from_subtrees_plain(
            plan.root, uniq, y, w, kernel="r2"),
        "eval_fitness_from_preds": lambda: gp_eval.eval_fitness_from_preds_plain(
            preds, y, w, kernel="c"),
        "unique_table": lambda: gp_eval.unique_table_plain(plan, X, const, fn_codes=codes),
        "predict_postfix": lambda: gp_eval.predict_postfix_plain(
            op, arg, X, const, stack_size=spec.stack_size, fn_codes=codes),
    }
    assert set(calls) == set(gp_eval.KERNELS)
    for name, call in calls.items():
        gp_eval.reset_launches()
        out, shape = call(lambda a: a.to("meta"))
        assert out.device.type == "meta" and out.dtype == torch.float32, name
        assert tuple(out.shape) == shape, (name, out.shape)
        assert gp_eval.meta_launches == {**dict.fromkeys(gp_eval.KERNELS, 0), name: 1}, name
        assert not any(gp_eval.launches.values()), name
        got, _ = call(lambda a: a)
        assert torch.equal(got, plain[name]()), name
        # the CPU call counts nothing in either
        assert not any(gp_eval.launches.values()) and sum(gp_eval.meta_launches.values()) == 1
    gp_eval.reset_launches()
    big = torch.empty((gp_eval.POP_CHUNK + 1, 40), device="meta")
    gp_eval.eval_fitness_from_preds(big, y.to("meta"), None)
    assert gp_eval.meta_launches["eval_fitness_from_preds"] == 2
    with pytest.raises(ValueError, match="contiguous"):
        gp_eval.eval_fitness_from_preds(big, y.to("meta")[:20], None)
    gp_eval.reset_launches()
