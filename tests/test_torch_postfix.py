"""The port's postfix genome against `repro`: the heap <-> postfix round
trip, span/lhs/depth tables, rendering and invariants, the postfix
breeding operators and the stack-machine evaluator, bitwise on the same
numpy-seeded inputs; plus the port's own heap-vs-postfix contract.

Tolerances: integer buffers and add/sub/mul/div/abs/min/max predictions
are bitwise; KITCHEN_SINK predictions hold to rtol 1e-4, because
torch's sin/cos/log and XLA's differ by ulps (as for the heap
evaluator)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import eval as jeval
from repro.core import evolve as jev
from repro.core import primitives as jprim
from repro.core import trees as jtrees
from repro_torch.core import eval as teval
from repro_torch.core import evolve as tev
from repro_torch.core import primitives as tprim
from repro_torch.core import prng
from repro_torch.core import trees as ttrees
from repro_torch.kernels import ops as tops
from jax_release import release_jax_programs  # noqa: F401  (frees compiled programs)

torch.set_num_threads(2)

FN_SETS = ["ARITHMETIC", "CLASSIFY_SET", "KITCHEN_SINK"]


def _specs(depth, fn_set, F, genome="postfix", **kw):
    return (jtrees.TreeSpec(max_depth=depth, n_features=F, genome=genome,
                            fn_set=getattr(jprim, fn_set), **kw),
            ttrees.TreeSpec(max_depth=depth, n_features=F, genome=genome,
                            fn_set=getattr(tprim, fn_set), **kw))


def _eq(jres, tres):
    for a, b in zip(jres, tres):
        b = b.numpy() if torch.is_tensor(b) else b
        assert b.dtype == np.asarray(a).dtype
        np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("depth", [1, 3, 4])
@pytest.mark.parametrize("fn_set", FN_SETS)
def test_generate_and_round_trip_bitwise(depth, fn_set):
    """Postfix generation equals the reference's; heap_to_postfix and
    postfix_to_heap equal the reference's and invert each other."""
    js, ts = _specs(depth, fn_set, 3)
    jop, jarg = jtrees.generate_population(jax.random.PRNGKey(depth), 16, js)
    top, targ = ttrees.generate_population(prng.PRNGKey(depth), 16, ts)
    _eq((jop, jarg), (top, targ))
    ttrees.check_invariants(top, ts)
    jh, th = jtrees.postfix_to_heap(jop, jarg, js), ttrees.postfix_to_heap(top, targ, ts)
    _eq(jh, th)
    hs = ttrees.TreeSpec(max_depth=depth, n_features=3, fn_set=ts.fn_set)
    ttrees.check_invariants(th[0], hs)
    back = ttrees.heap_to_postfix(torch.from_numpy(th[0]), torch.from_numpy(th[1]))
    _eq((top, targ), back)
    _eq(jtrees.heap_to_postfix(jnp.asarray(th[0]), jnp.asarray(th[1])), back)
    consts = ts.const_table_numpy()
    for i in range(0, 16, 5):
        text = ttrees.to_string(top[i], targ[i], const_table=consts, genome="postfix")
        assert text == jtrees.to_string(jop[i], jarg[i], const_table=consts,
                                        genome="postfix")
        assert text == ttrees.to_string(th[0][i], th[1][i], const_table=consts)


def test_postorder_table_matches_reference():
    for N in (1, 3, 15, 63):
        np.testing.assert_array_equal(ttrees.postorder_table(N), jtrees.postorder_table(N))


@pytest.mark.parametrize("depth", [2, 4])
def test_spans_lhs_depths_bitwise(depth):
    """postfix_stack_depths, subtree_spans and postfix_lhs_index equal
    the reference's, including a one-terminal row, a full row and an
    all-EMPTY row."""
    js, ts = _specs(depth, "KITCHEN_SINK", 4)
    op, _ = ttrees.generate_population(prng.PRNGKey(7 + depth), 16, ts)
    op[1] = 0
    op[1, 0] = tprim.FEATURE
    op[2] = 0
    full = ttrees.heap_to_postfix(
        *ttrees.generate_population(prng.PRNGKey(1), 8, ttrees.TreeSpec(
            max_depth=depth, n_features=4, fn_set=tprim.ARITHMETIC, grow_p_fn=1.0)))[0]
    op = torch.cat([op, full])
    jop = jnp.asarray(op.numpy())
    for name in ("postfix_stack_depths", "subtree_spans", "postfix_lhs_index"):
        want, got = np.asarray(getattr(jtrees, name)(jop)), getattr(ttrees, name)(op)
        assert got.dtype == torch.int32, name
        np.testing.assert_array_equal(want, got.numpy(), err_msg=name)
    start = ttrees.subtree_spans(op)
    assert (start[1, :1] == 0).all() and (start[1:2] <= torch.arange(op.shape[1])).all()


def test_check_invariants_names_the_other_form():
    js, ts = _specs(3, "ARITHMETIC", 2)
    hs = ttrees.TreeSpec(max_depth=3, n_features=2)
    heap, _ = ttrees.generate_population(prng.PRNGKey(0), 8, hs)
    with pytest.raises(ValueError, match="'tree' form"):
        ttrees.check_invariants(heap, ts)
    post, _ = ttrees.generate_population(prng.PRNGKey(0), 8, ts)
    with pytest.raises(ValueError, match="'postfix' form"):
        ttrees.check_invariants(post, hs)
    bad = post.clone()
    bad[:, 0] = tprim.opcode_of("add")
    with pytest.raises(AssertionError, match="P2"):
        ttrees.check_invariants(bad, ts)


@pytest.mark.parametrize("fn_set", ["ARITHMETIC", "KITCHEN_SINK"])
@pytest.mark.parametrize("seed", [0, 1])
def test_postfix_operators_bitwise(fn_set, seed):
    """crossover_postfix, mutate_branch_postfix and the postfix branch of
    next_generation give the reference's offspring from the same key, and
    keep P1–P5."""
    js, ts = _specs(4, fn_set, 3)
    a = ttrees.generate_population(prng.PRNGKey(3 + seed), 24, ts)
    b = ttrees.generate_population(prng.PRNGKey(40 + seed), 24, ts)
    ja = [jnp.asarray(t.numpy()) for t in a]
    jb = [jnp.asarray(t.numpy()) for t in b]
    got = tev.crossover_postfix(prng.PRNGKey(seed), *a, *b, ts)
    _eq(jev.crossover_postfix(jax.random.PRNGKey(seed), *ja, *jb, js), got)
    ttrees.check_invariants(got[0], ts)
    got = tev.mutate_branch_postfix(prng.PRNGKey(seed), *a, ts)
    _eq(jev.mutate_branch_postfix(jax.random.PRNGKey(seed), *ja, js), got)
    ttrees.check_invariants(got[0], ts)
    fit = np.random.RandomState(seed).randint(0, 4, 24).astype(np.float32)
    got = tev.next_generation(prng.PRNGKey(seed), *a, torch.from_numpy(fit), ts)
    _eq(jev.next_generation(jax.random.PRNGKey(seed), *ja, jnp.asarray(fit), js), got)
    ttrees.check_invariants(got[0], ts)


def test_splice_rejects_oversize_offspring():
    """Splicing a whole program over the first leaf of another: the full
    depth-3 rows would grow past N, so they keep parent A (the
    reference's rule); every row equals the reference's."""
    js, ts = _specs(3, "ARITHMETIC", 2)
    heap_op = np.zeros((1, 15), np.int32)
    heap_op[0, :7] = tprim.opcode_of("add")
    heap_op[0, 7:] = tprim.FEATURE
    full = ttrees.heap_to_postfix(torch.from_numpy(heap_op), torch.zeros_like(
        torch.from_numpy(heap_op)))
    rand = ttrees.generate_population(prng.PRNGKey(2), 7, ts)
    pop = (torch.cat([full[0], rand[0]]), torch.cat([full[1], rand[1]]))
    P = pop[0].shape[0]
    zero = torch.zeros(P, dtype=torch.int32)
    eb = ttrees.tree_sizes(pop[0]).to(torch.int32) - 1
    got = tev._splice_pop(*pop, *pop, zero, zero, zero, eb, ts)
    _eq((pop[0][:1], pop[1][:1]), (got[0][:1], got[1][:1]))
    want = jev._splice_pop(*[jnp.asarray(t.numpy()) for t in (*pop, *pop)], jnp.asarray(
        zero.numpy()), jnp.asarray(zero.numpy()), jnp.asarray(zero.numpy()),
        jnp.asarray(eb.numpy()), js)
    _eq(want, got)


@pytest.mark.parametrize("fn_set", FN_SETS)
def test_postfix_predictions_vs_reference(fn_set):
    """evaluate_population on postfix genomes: bitwise on add/sub/mul/div
    and CLASSIFY_SET trees, rtol 1e-4 on KITCHEN_SINK; all-EMPTY rows
    predict 0."""
    js, ts = _specs(4, fn_set, 3)
    op, arg = ttrees.generate_population(prng.PRNGKey(11), 16, ts)
    op[4], arg[4] = 0, 0
    X = (np.random.RandomState(1).randn(3, 200) * 2).astype(np.float32)
    want = np.asarray(jeval.evaluate_population(jnp.asarray(op.numpy()),
                                                jnp.asarray(arg.numpy()), jnp.asarray(X),
                                                js.const_table(), js))
    got = teval.evaluate_population(op, arg, torch.from_numpy(X), ts.const_table(),
                                    ts).numpy()
    assert (got[4] == 0).all()
    if fn_set == "KITCHEN_SINK":
        np.testing.assert_array_equal(np.isfinite(want), np.isfinite(got))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fn_set", FN_SETS)
@pytest.mark.parametrize("kernel", ["r", "c"])
def test_heap_vs_postfix_bitwise_in_port(fn_set, kernel):
    """The port's own contract: the heap and postfix forms of one
    population give bitwise the same predictions and fitness, for every
    function set (both forms run the same torch primitives, and on the
    card B1 and B2 the same device functions)."""
    hs = ttrees.TreeSpec(max_depth=4, n_features=3, fn_set=getattr(tprim, fn_set))
    ps = ttrees.TreeSpec(max_depth=4, n_features=3, fn_set=hs.fn_set, genome="postfix")
    op, arg = ttrees.generate_population(prng.PRNGKey(5), 16, hs)
    pop, parg = ttrees.heap_to_postfix(op, arg)
    rng = np.random.RandomState(2)
    X = torch.from_numpy((rng.randn(3, 300) * 2).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 2, 300).astype(np.float32))
    ct = hs.const_table()
    torch.testing.assert_close(teval.evaluate_population(op, arg, X, ct, hs),
                               teval.evaluate_population(pop, parg, X, ct, ps),
                               rtol=0, atol=0, equal_nan=True)
    from repro_torch.core.fitness import FitnessSpec

    fs = FitnessSpec(kernel, n_classes=2)
    a = tops.fitness(op, arg, X, y, ct, hs, fs, data_tile=256, device="cpu")
    b = tops.fitness(pop, parg, X, y, ct, ps, fs, data_tile=256, device="cpu",
                     dedup="off")
    torch.testing.assert_close(a, b, rtol=0, atol=0)
