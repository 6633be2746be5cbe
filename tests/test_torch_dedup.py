"""The port's population-wide subexpression dedup against `repro`:
signatures, plan buffers and `dedup_stats` bitwise on the same
populations; the plain unique-table evaluator and B3/B4 against the
reference's; the port's dedup on/off contract through the kernel path
(B3 and B4 chosen by the reference's TPU rule, overflow handing over to
B2); and the semantic tier, tolerance-pinned as the reference's own
tests pin it (rtol 1e-5).

Every buffer test is bitwise; so are predictions and moments on
add/sub/mul/div trees and on lattice data."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core import eval as jeval
from repro.core import fitness as jfit
from repro.core import primitives as jprim
from repro.core import trees as jtrees
from repro.kernels import gp_eval as jk
from repro.kernels import ops as jops
from repro_torch.core import engine as tengine
from repro_torch.core import eval as teval
from repro_torch.core import fitness as tfit
from repro_torch.core import primitives as tprim
from repro_torch.core import prng
from repro_torch.core import trees as ttrees
from repro_torch.kernels import gp_eval
from repro_torch.kernels import ops as tops

torch.set_num_threads(2)


def _population(seed, P=16, depth=4, F=3, fn_set="ARITHMETIC", dup=True):
    """(reference spec, port spec, op, arg): a postfix population with
    repeated rows (crossover's regime), a one-terminal row and an
    all-EMPTY row."""
    kw = dict(max_depth=depth, n_features=F, genome="postfix")
    if isinstance(fn_set, tuple):  # opcode names
        jfs, tfs = jprim.FunctionSet.make(fn_set), tprim.FunctionSet.make(fn_set)
    else:
        jfs, tfs = getattr(jprim, fn_set), getattr(tprim, fn_set)
    js = jtrees.TreeSpec(fn_set=jfs, **kw)
    ts = ttrees.TreeSpec(fn_set=tfs, **kw)
    op, arg = ttrees.generate_population(prng.PRNGKey(seed), P, ts)
    if dup:
        op[P // 2:], arg[P // 2:] = op[:P - P // 2].clone(), arg[:P - P // 2].clone()
    op[1], arg[1] = 0, 0
    op[1, 0], arg[1, 0] = tprim.FEATURE, F - 1
    op[2], arg[2] = 0, 0
    return js, ts, op, arg


def _j(t):
    return jnp.asarray(t.numpy())


def _data(seed, F, D, lattice):
    rng = np.random.RandomState(seed)
    if lattice:
        X = rng.randint(-1, 2, size=(F, D)).astype(np.float32)
    else:
        X = (rng.randn(F, D) * 2).astype(np.float32)
    y = rng.randint(0, 3, size=D).astype(np.float32)
    return X, y


@pytest.mark.parametrize("F,n_consts", [(3, 8), (9, 8), (1373, 8)])
def test_signatures_bitwise(F, n_consts):
    js, ts, op, arg = _population(1, F=F)
    js = dataclasses.replace(js, n_consts=n_consts)
    ts = dataclasses.replace(ts, n_consts=n_consts)
    assert ttrees.signature_geometry(ts, 63) == jtrees.signature_geometry(js, 63)
    got = ttrees.subtree_signatures(op, arg, ts)
    assert got.dtype == torch.int32 and (got >= 0).all()
    np.testing.assert_array_equal(np.asarray(jtrees.subtree_signatures(_j(op), _j(arg), js)),
                                  got.numpy())
    assert (got[2] == 0).all()  # the all-EMPTY row


def test_signature_geometry_of_the_paper_shapes():
    """kat7 (F = 9) packs 3 codes of 8 bits a word, 21 words at depth 5;
    ligo (F = 1,373) 2 codes of 15 bits, 32 words; too-wide codes raise."""
    assert ttrees.signature_geometry(ttrees.TreeSpec(n_features=9), 63) == (8, 3, 21)
    assert ttrees.signature_geometry(ttrees.TreeSpec(n_features=1373), 63) == (15, 2, 32)
    with pytest.raises(ValueError, match="30 bits"):
        ttrees.signature_geometry(ttrees.TreeSpec(n_features=2 ** 27), 63)


@pytest.mark.parametrize("cap", [0, 12, 100_000])
@pytest.mark.parametrize("depth", [3, 4])
def test_plan_buffers_and_stats_bitwise(cap, depth):
    """Every DedupPlan buffer and `dedup_stats` equal the reference's,
    with a cap that overflows (12) and two that do not."""
    js, ts, op, arg = _population(depth, depth=depth)
    c = teval.resolve_dedup_cap(cap, *op.shape)
    assert c == jeval.resolve_dedup_cap(cap, *op.shape)
    want = jeval.build_dedup_plan(_j(op), _j(arg), js, c)
    got = teval.build_dedup_plan(op, arg, ts, c)
    for name in teval.DedupPlan._fields:
        w, g = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert w.dtype == g.dtype, name
        np.testing.assert_array_equal(w, g, err_msg=name)
    assert bool(got.overflow) == (cap == 12)
    for w, g in zip(jeval.dedup_stats(_j(op), _j(arg), js, c),
                    teval.dedup_stats(op, arg, ts, c)):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


@pytest.mark.parametrize("fn_set", ["ARITHMETIC", "KITCHEN_SINK"])
def test_unique_table_and_dedup_predictions(fn_set):
    """The plain unique-table evaluator equals the reference's (bitwise on
    add/sub/mul/div, rtol 1e-4 on KITCHEN_SINK); inside the port, dedup
    predictions are bitwise the stack machine's, with and without
    overflow."""
    js, ts, op, arg = _population(5, fn_set=fn_set)
    X, _ = _data(0, 3, 200, lattice=False)
    Xt, ct = torch.from_numpy(X), ts.const_table()
    cap = teval.resolve_dedup_cap(0, *op.shape)
    plan = teval.build_dedup_plan(op, arg, ts, cap)
    want = np.asarray(jeval.evaluate_unique_subtrees(
        jeval.build_dedup_plan(_j(op), _j(arg), js, cap), jnp.asarray(X),
        js.const_table(), js))
    got = gp_eval.unique_table(plan, Xt, ct, fn_codes=tuple(ts.fn_set.opcodes)).numpy()
    if fn_set == "KITCHEN_SINK":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)
    plain = teval.evaluate_population_postfix(op, arg, Xt, ct, ts)
    for c in (0, 12, 100_000):
        torch.testing.assert_close(
            teval.evaluate_population_dedup(op, arg, Xt, ct, ts,
                                            teval.resolve_dedup_cap(c, *op.shape)),
            plain, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("kernel", ["r", "c", "m", "mse"])
def test_plain_b2_b3_b4_vs_reference_kernels(kernel):
    """The plain versions of B2, B3 and B4 against the reference's Pallas
    kernels (interpret mode) on lattice data at one tile geometry
    (pop_tile 8, two data tiles of 128): every sum is exact, so bitwise."""
    js, ts, op, arg = _population(9, fn_set=("add", "sub", "mul"))
    X, y = _data(3, 3, 256, lattice=True)
    w = np.random.RandomState(4).choice(np.float32([0.0, 0.5, 1.0]), 256)
    ct, codes = ts.const_table(), tuple(int(c) for c in ts.fn_set.opcodes)
    fk = dict(kernel=kernel, n_classes=3, precision=0.5, data_tile=128)
    Xt, yt, wt = torch.from_numpy(X), torch.from_numpy(y), torch.from_numpy(w)
    Xj, yj, wj = jnp.asarray(X), jnp.asarray(y), jnp.asarray(w)
    lens = (op != 0).sum(-1).to(torch.int32)
    want = jk.eval_fitness_pallas_postfix(
        _j(op), _j(arg), _j(lens), Xj, yj, wj, js.const_table(), stack_size=5,
        pop_tile=8, interpret=True, fn_codes=codes, **fk)
    got = gp_eval.eval_fitness_postfix(op, arg, Xt, yt, wt, ct, stack_size=5,
                                       fn_codes=codes, **fk)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    cap = 100_000
    plan = teval.build_dedup_plan(op, arg, ts, teval.resolve_dedup_cap(cap, *op.shape))
    uniq = gp_eval.unique_table(plan, Xt, ct, fn_codes=codes)
    want = jk.eval_fitness_pallas_from_subtrees(_j(plan.root), jnp.asarray(uniq.numpy()),
                                                yj, wj, pop_tile=8, interpret=True, **fk)
    got_b3 = gp_eval.eval_fitness_from_subtrees(plan.root, uniq, yt, wt, **fk)
    np.testing.assert_array_equal(np.asarray(want), got_b3.numpy())
    preds = uniq[plan.root.long()]
    want = jk.eval_fitness_pallas_from_preds(jnp.asarray(preds.numpy()), yj, wj,
                                             pop_tile=8, interpret=True, **fk)
    got_b4 = gp_eval.eval_fitness_from_preds(preds, yt, wt, **fk)
    np.testing.assert_array_equal(np.asarray(want), got_b4.numpy())
    np.testing.assert_array_equal(got.numpy(), got_b3.numpy())  # dedup on = off
    np.testing.assert_array_equal(got.numpy(), got_b4.numpy())


def test_plain_versions_honour_the_gate():
    """With a gate, a wrapper's result lands only where gate == run_when;
    elsewhere `out` is left as it was (the card's early return)."""
    _, ts, op, arg = _population(2)
    X, y = _data(1, 3, 64, lattice=True)
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y)
    out = torch.full((op.shape[0], 1), 7.0)
    kw = dict(stack_size=5, fn_codes=tuple(ts.fn_set.opcodes), out=out)
    full = gp_eval.eval_fitness_postfix(op, arg, Xt, yt, None, ts.const_table(),
                                        stack_size=5, fn_codes=kw["fn_codes"])
    for flag in (False, True):
        gate = torch.tensor(flag)
        got = gp_eval.eval_fitness_postfix(op, arg, Xt, yt, None, ts.const_table(),
                                           gate=gate, run_when=True, **kw)
        torch.testing.assert_close(got, full if flag else out, rtol=0, atol=0)
    with pytest.raises(ValueError, match="out"):
        gp_eval.eval_fitness_from_preds(full.expand(-1, 64).contiguous(), yt, None,
                                        gate=torch.tensor(True))


def test_b3_b4_choice_follows_the_reference_rule():
    """`ops._tpu_dedup_fits` is the reference's VMEM test
    (`pick_tiles_postfix` from its default data tile + `_postfix_vmem`
    against its budget): kat7 runs B3 up to a cap of 1,415 and B4 above;
    ligo always spills."""
    for F, S, D, cap in ((9, 6, 10_000, 1415), (9, 6, 10_000, 1416), (9, 6, 10_000, 6301),
                         (9, 6, 10_000, 100), (1373, 6, 4000, 100), (1, 6, 9, 6301),
                         (8, 6, 32_768, 2000), (3, 5, 256, 497), (3, 5, 256, 3000)):
        _, Db, _ = jops.pick_tiles_postfix(F, S, 100, D)
        want = jops._postfix_vmem(F, S, 8, Db, dedup_rows=cap) <= jops._VMEM_BUDGET
        assert tops._tpu_dedup_fits(F, S, D, cap) == want, (F, D, cap)
    assert tops._tpu_dedup_fits(9, 6, 10_000, 1415)
    assert not tops._tpu_dedup_fits(9, 6, 10_000, 1416)


def test_b3_b4_choice_ignores_the_card_tile(monkeypatch):
    """The rule starts from the reference's own data tile, not from the
    port's card-tile bound: `ops.fitness` at its default `data_tile`
    (4096) runs B3 at a cap the reference keeps in VMEM (2,000 at F = 3,
    S = 6, D = 256), where a rule started from 4096 would spill to B4."""
    called = []
    for name in ("eval_fitness_from_subtrees", "eval_fitness_from_preds"):
        real = getattr(gp_eval, name)
        monkeypatch.setattr(gp_eval, name,
                            lambda *a, _n=name, _f=real, **k: called.append(_n) or _f(*a, **k))
    ts = ttrees.TreeSpec(max_depth=5, n_features=3, genome="postfix")
    op, arg = ttrees.generate_population(prng.PRNGKey(3), 40, ts)
    X, y = _data(9, 3, 256, lattice=True)
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y)
    _, Db, _ = jops.pick_tiles_postfix(3, 6, 40, 256)
    assert jops._postfix_vmem(3, 6, 8, Db, dedup_rows=2000) <= jops._VMEM_BUDGET
    on = tops.fitness(op, arg, Xt, yt, ts.const_table(), ts, tfit.FitnessSpec("r"),
                      device="cpu", dedup="exact", dedup_cap=2000)
    assert called == ["eval_fitness_from_subtrees"]
    off = tops.fitness(op, arg, Xt, yt, ts.const_table(), ts, tfit.FitnessSpec("r"),
                       device="cpu")
    torch.testing.assert_close(on, off, rtol=0, atol=0)


@pytest.mark.parametrize("kernel", ["r", "c"])
@pytest.mark.parametrize("cap", [0, 12, 200, 100_000])
def test_port_dedup_on_off_bitwise(kernel, cap):
    """ops.fitness with dedup="exact" equals dedup="off" bit for bit in
    the port, whichever branch runs: B2 on overflow (cap 12), B3 (cap 200
    fits the reference's budget) or B4 (cap 100,000 spills); and equals
    the reference's dedup fitness within rtol 1e-5 (real-valued sums in
    another order)."""
    js, ts, op, arg = _population(11, fn_set="KITCHEN_SINK")
    X, y = _data(5, 3, 300, lattice=False)
    Xt, yt, ct = torch.from_numpy(X), torch.from_numpy(y), ts.const_table()
    fs = tfit.FitnessSpec(kernel, n_classes=3)
    off = tops.fitness(op, arg, Xt, yt, ct, ts, fs, data_tile=128, device="cpu")
    on = tops.fitness(op, arg, Xt, yt, ct, ts, fs, data_tile=128, device="cpu",
                      dedup="exact", dedup_cap=cap)
    torch.testing.assert_close(on, off, rtol=0, atol=0)
    ref = tops.fitness(op, arg, Xt, yt, ct, ts, fs, device="cpu", impl="torch",
                       dedup="exact", dedup_cap=cap)
    torch.testing.assert_close(ref, off, rtol=1e-5, atol=1e-5)
    want = np.asarray(jops.fitness(_j(op), _j(arg), jnp.asarray(X), jnp.asarray(y),
                                   js.const_table(), js, jfit.FitnessSpec(kernel, n_classes=3),
                                   impl="jnp", dedup="exact", dedup_cap=cap))
    np.testing.assert_allclose(on.numpy(), want, rtol=1e-5, atol=1e-5)


# --- the semantic tier ------------------------------------------------------------


def _commute_adds(op, arg):
    """Swap the terminal operands of each row's first add of two
    terminals: semantically equal (IEEE addition commutes), bytes differ."""
    op, arg = op.clone(), arg.clone()
    add = tprim.opcode_of("add")
    for p in range(op.shape[0]):
        for i in range(2, op.shape[1]):
            if (op[p, i] == add and tprim.ARITY[op[p, i - 1]] == 0
                    and tprim.ARITY[op[p, i - 2]] == 0):
                op[p, [i - 2, i - 1]] = op[p, [i - 1, i - 2]].clone()
                arg[p, [i - 2, i - 1]] = arg[p, [i - 1, i - 2]].clone()
                break
    return op, arg


def test_semantic_hit_serves_rewritten_elites():
    """A commuted rewrite of the cached elite misses the exact gate and
    hits the semantic one; the served fitness equals re-evaluation."""
    ts = ttrees.TreeSpec(max_depth=4, n_features=3, genome="postfix")
    cfg = tengine.GPConfig(pop_size=16, tree_spec=ts, elitism=2, dedup="semantic")
    X, y = _data(21, 3, 120, lattice=False)
    Xt, yt, ct = torch.from_numpy(X), torch.from_numpy(y), ts.const_table()
    op, arg = ttrees.generate_population(prng.PRNGKey(2), 16, ts)
    op2, arg2 = _commute_adds(op[:2], arg[:2])
    assert not (torch.equal(op2, op[:2]) and torch.equal(arg2, arg[:2]))

    def eval_rows(o, a):
        return tops.fitness(o, a, Xt, yt, ct, ts, cfg.fitness, device="cpu")

    full = eval_rows(op, arg)
    state = tengine.init_state(cfg, prng.PRNGKey(0), device="cpu")._replace(
        op=op, arg=arg, cache_op=op2, cache_arg=arg2, cache_fit=full[:2] + 1)
    probe = tengine._probe_fn(cfg, Xt, ct)
    served = tengine._cached_fitness(state, eval_rows, probe=probe)
    assert not bool(tengine._cache_hit(state))
    torch.testing.assert_close(served[:2], full[:2] + 1)  # the cache served it
    torch.testing.assert_close(served[2:], full[2:], rtol=0, atol=0)
    assert tengine._probe_fn(dataclasses.replace(cfg, dedup="exact"), Xt, ct) is None


@pytest.mark.parametrize("genome", ["postfix", "tree"])
@pytest.mark.parametrize("impl", ["auto", "torch"])
def test_probe_predictions_match_reference(genome, impl):
    """The semantic probe (the predict kernel's wrapper, heap rows
    converted to postfix; the plain evaluator under eval_impl="torch")
    gives the reference probe's predictions bit for bit on add/sub/mul/div
    trees, on the first 32 points."""
    kw = dict(max_depth=4, n_features=3, fn_set=jprim.ARITHMETIC, genome=genome)
    js = jtrees.TreeSpec(**kw)
    ts = ttrees.TreeSpec(**dict(kw, fn_set=tprim.ARITHMETIC))
    op, arg = ttrees.generate_population(prng.PRNGKey(6), 12, ts)
    X, _ = _data(13, 3, 50, lattice=False)
    cfg = tengine.GPConfig(pop_size=12, tree_spec=ts, dedup="semantic", eval_impl=impl)
    jcfg = jengine.GPConfig(pop_size=12, tree_spec=js, dedup="semantic")
    got = tengine._probe_fn(cfg, torch.from_numpy(X), ts.const_table())(op, arg)
    want = jengine._probe_fn(jcfg, jnp.asarray(X), js.const_table())(_j(op), _j(arg))
    assert got.shape == (12, 32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_predict_postfix_plain_vs_reference():
    """The predict kernel's plain version is the reference's stack machine:
    bitwise on add/sub/mul/div trees, rtol 1e-4 on KITCHEN_SINK."""
    for fn_set in ("ARITHMETIC", "KITCHEN_SINK"):
        js, ts, op, arg = _population(8, fn_set=fn_set)
        X, _ = _data(10, 3, 40, lattice=False)
        codes = tuple(int(c) for c in ts.fn_set.opcodes)
        got = gp_eval.predict_postfix(op, arg, torch.from_numpy(X), ts.const_table(),
                                      stack_size=ts.stack_size, fn_codes=codes).numpy()
        want = np.asarray(jeval.evaluate_population_postfix(
            _j(op), _j(arg), jnp.asarray(X), js.const_table(), js))
        if fn_set == "ARITHMETIC":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert gp_eval.launches["predict_postfix"] == 0  # CPU tensors: no kernel


def test_semantic_zero_cache_never_hits():
    """x0 - x0 heads probe to 0.0 like the zero cache's all-EMPTY rows,
    but the all-finite guard keeps the +inf sentinel from being served."""
    ts = ttrees.TreeSpec(max_depth=4, n_features=3, genome="postfix")
    cfg = tengine.GPConfig(pop_size=8, tree_spec=ts, elitism=2, dedup="semantic")
    X, y = _data(8, 3, 80, lattice=False)
    Xt, yt, ct = torch.from_numpy(X), torch.from_numpy(y), ts.const_table()
    row = torch.zeros(ts.num_nodes, dtype=torch.int32)
    row[:3] = torch.tensor([tprim.FEATURE, tprim.FEATURE, tprim.opcode_of("sub")])
    op = row.expand(8, -1).contiguous()
    state = tengine.init_state(cfg, prng.PRNGKey(0), device="cpu")._replace(
        op=op, arg=torch.zeros_like(op))
    probe = tengine._probe_fn(cfg, Xt, ct)
    torch.testing.assert_close(probe(state.op[:2], state.arg[:2]),
                               probe(state.cache_op, state.cache_arg))
    served = tengine._cached_fitness(
        state, lambda o, a: tops.fitness(o, a, Xt, yt, ct, ts, cfg.fitness, device="cpu"),
        probe=probe)
    assert torch.isfinite(served).all()


def test_semantic_trajectory_vs_reference_within_tolerance():
    """dedup="semantic" walks the reference's semantic trajectory and the
    port's dedup="off" one, fitness within rtol 1e-5 (the tier's
    tolerance-pinned contract; real-valued sums)."""
    X, y = _data(13, 3, 160, lattice=False)
    base = dict(pop_size=24, elitism=2)
    jts = jtrees.TreeSpec(max_depth=4, n_features=3, genome="postfix")
    tts = ttrees.TreeSpec(max_depth=4, n_features=3, genome="postfix")
    jcfg = jengine.GPConfig(tree_spec=jts, eval_impl="jnp", dedup="semantic", **base)
    tsem = tengine.GPConfig(tree_spec=tts, dedup="semantic", **base)
    toff = dataclasses.replace(tsem, dedup="off")
    js = jengine.init_state(jcfg, jax.random.PRNGKey(1))
    s_sem = s_off = tengine.state_from_numpy(js)
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y)
    for _ in range(5):
        js = jengine.evolve_step(jcfg, js, jnp.asarray(X), jnp.asarray(y))
        s_sem = tengine.evolve_step(tsem, s_sem, Xt, yt)
        s_off = tengine.evolve_step(toff, s_off, Xt, yt)
        np.testing.assert_allclose(s_sem.fitness.numpy(), np.asarray(js.fitness),
                                   rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(s_sem.fitness, s_off.fitness, rtol=1e-5, atol=1e-5)
    assert s_sem.best_fitness.item() == pytest.approx(float(js.best_fitness), rel=1e-5)


# --- the unique-table kernel's schedule: what it relies on ---------------------


def _paper_plan(P, F, fn_set, seed):
    """A heap population of depth 5 (`generate_population`), its postfix
    form and its dedup plan at the cap no population can overflow
    (P·N + 1), as `chip_smoke.py` builds them for the table kernel."""
    spec = ttrees.TreeSpec(max_depth=5, n_features=F, fn_set=getattr(tprim, fn_set))
    op, arg = ttrees.generate_population(prng.PRNGKey(seed), P, spec)
    pop, parg = ttrees.heap_to_postfix(op, arg)
    pspec = dataclasses.replace(spec, genome="postfix")
    plan = teval.build_dedup_plan(pop, parg, pspec, P * pop.shape[1] + 1)
    assert not bool(plan.overflow)
    return pspec, plan


def _heights(plan):
    """Subtree height of every live slot (terminals 0), slot by slot in
    ascending span length; -1 on the other slots."""
    n = int(plan.n_unique)
    uop, ulen = plan.uop.numpy(), plan.ulen.numpy()
    ulhs, urhs = plan.ulhs.numpy(), plan.urhs.numpy()
    h = np.full(len(uop), -1)
    for s in sorted(range(n), key=lambda s: ulen[s]):
        h[s] = 0 if ulen[s] == 1 else 1 + max(h[ulhs[s]], h[urhs[s]])
    return h


@pytest.mark.parametrize("fn_set", ["CLASSIFY_SET", "KITCHEN_SINK"])
@pytest.mark.parametrize("P,F", [(100, 9), (1024, 8)])  # kat7, "large"
def test_plan_invariants_the_table_schedule_relies_on(P, F, fn_set):
    """The unique-table kernel groups the live slots by subtree height and
    evaluates one height at a time. That is sound because the live slots
    are exactly [0, n_unique), each function slot's operands have strictly
    shorter spans (so a slot's height is above its operands' and every
    live operand is reached first), and heights stay within max_depth (6
    groups at depth 5)."""
    spec, plan = _paper_plan(P, F, fn_set, seed=P + F)
    n, cap = int(plan.n_unique), plan.uop.shape[0]
    ulen = plan.ulen.numpy()
    np.testing.assert_array_equal(np.flatnonzero(ulen > 0), np.arange(n))
    arity = tprim.ARITY[plan.uop.numpy()[:n]]
    fn = np.flatnonzero(arity >= 1)
    for ids in (plan.ulhs.numpy()[fn], plan.urhs.numpy()[fn]):
        assert ((ids >= 0) & (ids < n)).all()
        assert (ulen[ids] < ulen[fn]).all()
    h = _heights(plan)
    assert (h[:n] >= 0).all() and (h[n:] == -1).all()
    assert h.max() <= spec.max_depth
    assert (ulen[:n] >= h[:n] + 1).all()  # a height is below the span length
    assert cap - 1 >= n  # the reserved all-EMPTY slot stays free


def _table_by_groups(plan, X, ct, fn_set, key, rng):
    """The table evaluated one group of slots at a time (groups in
    ascending `key`), and inside a group slot by slot in the order `rng`
    gives (None: reversed): the schedule the kernel's blocks follow."""
    vals = torch.zeros((plan.uop.shape[0], X.shape[1]))
    n = int(plan.n_unique)
    uarg = plan.uarg.long()
    for g in np.unique(key[:n]):
        slots = np.flatnonzero(key[:n] == g)
        slots = slots[::-1] if rng is None else rng.permutation(slots)
        for s in slots.tolist():
            if plan.ulen[s] == 1:
                a = uarg[s]
                vals[s] = (X[a.clamp(0, X.shape[0] - 1)] if plan.uop[s] == tprim.FEATURE
                           else ct[a.clamp(0, ct.shape[0] - 1)].expand(X.shape[1]))
            else:
                vals[s] = tprim.apply_function(plan.uop[s:s + 1, None],
                                               vals[plan.ulhs[s:s + 1].long()],
                                               vals[plan.urhs[s:s + 1].long()], fn_set)[0]
    return vals


@pytest.mark.parametrize("order", ["reversed", "shuffled"])
@pytest.mark.parametrize("group_by", ["height", "span length"])
@pytest.mark.parametrize("fn_set", ["CLASSIFY_SET", "KITCHEN_SINK"])
def test_table_by_groups_in_any_order_is_bitwise_the_plain_table(fn_set, group_by, order):
    """Evaluating the table group by group, in any order inside a group,
    gives `unique_table_plain` bit for bit (every slot applies the same
    primitive to the same operand bits), for height groups (the kernel's)
    and span-length groups (the plain version's)."""
    spec, plan = _paper_plan(100, 9, fn_set, seed=3)
    X = torch.from_numpy(np.random.RandomState(5).randn(9, 48).astype(np.float32))
    ct = spec.const_table()
    key = _heights(plan) if group_by == "height" else plan.ulen.numpy()
    rng = None if order == "reversed" else np.random.RandomState(11)
    got = _table_by_groups(plan, X, ct, spec.fn_set, key, rng)
    want = gp_eval.unique_table_plain(plan, X, ct, fn_codes=tuple(spec.fn_set.opcodes))
    live = np.r_[np.arange(int(plan.n_unique)), plan.uop.shape[0] - 1]
    np.testing.assert_array_equal(got[live].numpy().view(np.int32),
                                  want[live].numpy().view(np.int32))


@pytest.mark.parametrize("n_live,max_len,D,tile", [
    (757, 61, 9, 1), (632, 60, 10_000, 16), (1138, 60, 4_000, 16), (4844, 62, 32_768, 8)])
def test_table_schedule_at_the_chip_shapes(n_live, max_len, D, tile):
    """The table kernel's geometry at the four `chip_smoke.py` shapes
    (their plans' live slots and longest spans): one block per SM (no
    more than the points), every block with a tile of points, and every
    slot's values for the tile in shared memory."""
    blocks, smem = gp_eval.table_geometry(D)
    assert blocks == min(gp_eval.SMS, D) and smem <= 227 * 1024
    assert gp_eval.table_schedule(n_live, max_len, D, blocks, smem) == ("staged", tile)
    assert -(-D // tile) >= blocks
    assert gp_eval.table_schedule(70_000, max_len, D, blocks, smem)[0] == "scan"
