"""The port's multi-tenant GP service against the reference and against
its own solo sessions.

The tenant family of `repro_torch.core.engine` (slot setup, one tenant
block with its state, history and counters), the scheduler
(`repro_torch.service`), the session's slot swap and the serve CLI, on
the CPU:

- a packed job is bitwise the port's own solo `GPSession` on the same
  padded slot buffers, on real-valued data (the reference's acceptance
  scenario, all 8 jobs): each slot is evaluated through the solo
  session's backend dispatch, so their fitness reductions are the same;
- on integer-lattice data (add/sub/mul trees, small-integer rows: every
  sum exact, so summation order cannot matter) the port's tenant block
  and service are bitwise the reference's, and a reference snapshot
  adopted by the port finishes with the reference's results;
- the reference's own service and obs tests, ported.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core import primitives as jprim
from repro.core import trees as jtrees
from repro.core.evolve import OperatorMix as JMix
from repro.gp import GPSession as JSession
from repro.service import GPService as JService
from repro.service import JobSpec as JJobSpec
from repro_torch.core import engine as tengine
from repro_torch.core import islands as tisl
from repro_torch.core import primitives as tprim
from repro_torch.core import prng
from repro_torch.core import trees as ttrees
from repro_torch.core.evolve import OperatorMix
from repro_torch.gp import GPSession
from repro_torch.obs import Metrics, Tracer, validate_trace
from repro_torch.service import (CANCELLED, DONE, PENDING, GPService, JobSpec, pack_order,
                                 slot_buffers)
from jax_release import release_jax_programs  # noqa: F401  (frees compiled programs)

torch.set_num_threads(2)

POP, DEPTH, FEATS, DCAP = 16, 3, 2, 32
TOURN = 6
MIXES = ((0.1, 0.1, 0.1, 0.7), (0.05, 0.05, 0.05, 0.85), (0.2, 0.2, 0.2, 0.4))
LATTICE_SET = ("add", "sub", "mul")


def _dataset(seed, rows):
    r = np.random.RandomState(seed)
    X = r.randn(rows, FEATS).astype(np.float32)
    y = (X[:, 0] * X[:, 1] + 0.5 * X[:, 0]).astype(np.float32)
    return X, y


def _jobs(n, kernels=("r", "mse", "pearson"), tourn=TOURN, spec_cls=JobSpec, mix_cls=OperatorMix):
    """The reference's acceptance jobs (tests/test_service.py::_jobs)."""
    jobs = []
    for i in range(n):
        X, y = _dataset(i, 12 + 5 * (i % 5))
        jobs.append(spec_cls(
            X, y, kernel=kernels[i % len(kernels)], mix=mix_cls(*MIXES[i % 3]),
            tourn_size=tourn, stop_fitness=0.3 if i in (2, 5) else None,
            generations=4 + i % 6, seed=i, name=f"job-{i}"))
    return jobs


def _spec(seed, rows, **kw):
    kw.setdefault("tourn_size", TOURN)
    kw.setdefault("seed", seed)
    return JobSpec(*_dataset(seed, rows), **kw)


def _service(**kw):
    kw.setdefault("slots", 3)
    kw.setdefault("pop_size", POP)
    kw.setdefault("max_depth", DEPTH)
    kw.setdefault("n_features", FEATS)
    kw.setdefault("data_cap", DCAP)
    kw.setdefault("kernels", ("r",))
    kw.setdefault("tourn_draw", TOURN)
    kw.setdefault("block_size", 3)
    kw.setdefault("device", "cpu")
    return GPService(**kw)


def _tree_specs(genome="tree", lattice=True, depth=DEPTH):
    """(reference, port) TreeSpecs of the same shape."""
    kw = dict(max_depth=depth, n_features=FEATS, genome=genome)
    if lattice:
        kw["p_const"] = 0.0
    j = jtrees.TreeSpec(**kw, **({"fn_set": jprim.FunctionSet.make(LATTICE_SET)}
                                 if lattice else {}))
    t = ttrees.TreeSpec(**kw, **({"fn_set": tprim.FunctionSet.make(LATTICE_SET)}
                                 if lattice else {}))
    return j, t


def _assert_tenant_equal(jstate, tstate, what=""):
    got = tengine.tenant_state_to_numpy(tstate)
    for name, leaf in jstate._asdict().items():
        want = np.asarray(leaf)
        have = np.asarray(getattr(got, name))
        assert have.dtype == want.dtype, (what, name)
        np.testing.assert_array_equal(have, want, err_msg=f"{what} TenantState.{name}")


# --- slot setup -------------------------------------------------------------------


@pytest.mark.parametrize("genome", ["tree", "postfix"])
@pytest.mark.parametrize("seed", [0, 7, 123])
def test_init_tenant_slot_matches_reference(genome, seed):
    """A fresh slot and an empty batch are bitwise the reference's (key,
    population, infinities, zero cache) for both genomes."""
    jspec, tspec = _tree_specs(genome, lattice=False)
    want = jengine.init_tenant_slot(jax.random.PRNGKey(seed), POP, jspec, elitism=2)
    got = tengine.init_tenant_slot(prng.PRNGKey(seed), POP, tspec, elitism=2)
    _assert_tenant_equal(want, got, "slot")
    want = jengine.empty_tenant_state(3, POP, jspec, elitism=2)
    got = tengine.empty_tenant_state(3, POP, tspec, elitism=2, device="cpu")
    _assert_tenant_equal(want, got, "empty")
    assert tengine._tenant_cache_width(2, POP, False) == 0
    assert tengine._tenant_cache_width(POP, POP, True) == 0


def test_tenant_state_round_trip_and_island_slices():
    """tenant_state_to/from_numpy invert each other bit for bit, and
    take_island/splice_island move one job's whole sub-state (every
    TenantState leaf is batched)."""
    _, tspec = _tree_specs()
    batch = tengine.empty_tenant_state(3, POP, tspec, device="cpu")
    sub = tengine.init_tenant_slot(prng.PRNGKey(5), POP, tspec)
    sub = sub._replace(gens_done=torch.tensor(4, dtype=torch.int32))
    batch = tisl.splice_island(batch, 1, sub)
    back = tengine.tenant_state_from_numpy(tengine.tenant_state_to_numpy(batch), device="cpu")
    for a, b in zip(batch, back):
        assert a.dtype == b.dtype and torch.equal(a, b)
    out = tisl.take_island(back, 1)
    for name, a, b in zip(tengine.TenantState._fields, out, sub):
        assert torch.equal(a, b), name
    assert int(tisl.take_island(back, 0).gens_done) == 0
    assert tengine.tenant_state_to_numpy(batch).key.dtype == np.uint32


# --- one tenant block against the reference's -------------------------------------


KERNELS = ("r", "c", "m", "mse")


def _lattice_slots(I, rows, seed=3):
    """Per-slot lattice data [I, F, rows] with ragged zero-weight tails."""
    r = np.random.RandomState(seed)
    X = r.randint(-2, 3, size=(I, FEATS, rows)).astype(np.float32)
    y = (X[:, 0] * X[:, 1] - X[:, 0] + r.randint(-1, 2, size=(I, rows))).astype(np.float32)
    y[1] = np.clip(np.abs(y[1]), 0, 2)  # class ids for the classify slot
    w = np.ones((I, rows), np.float32)
    w[0, rows - 5:] = 0.0
    w[2, rows - 9:] = 0.0
    return X, y, w


def _params(I=3):
    """Heterogeneous TenantParams (numpy): slot 0 r with an early stop,
    slot 1 c, slot 2 empty (budget 0)."""
    return jengine.TenantParams(
        probs=np.asarray(MIXES, np.float32)[:I],
        tourn=np.asarray([6, 3, 5], np.int32)[:I],
        point_rate=np.asarray([0.25, 0.5, 0.1], np.float32)[:I],
        kernel_id=np.asarray([0, 1, 3], np.int32)[:I],
        n_classes=np.asarray([2.0, 3.0, 2.0], np.float32)[:I],
        precision=np.asarray([1e-4, 1e-4, 0.5], np.float32)[:I],
        stop=np.asarray([30.0, -np.inf, -np.inf], np.float32)[:I],
        budget=np.asarray([5, 5, 0], np.int32)[:I])


def _block_inputs(genome, K=3, I=3, rows=24):
    jspec, tspec = _tree_specs(genome)
    jst = jengine.empty_tenant_state(I, POP, jspec, elitism=2)
    for i, seed in enumerate((11, 12, 13)[:I]):
        from repro.core.islands import splice_island

        jst = splice_island(jst, i, jengine.init_tenant_slot(
            jax.random.PRNGKey(seed), POP, jspec, elitism=2))
    X, y, w = _lattice_slots(I, rows)
    return jspec, tspec, jst, (X, y, w), _params(I)


@pytest.fixture(scope="module")
def ref_block_heap():
    """The reference's jitted tenant block (K=3, I=3, elitism 2) on the
    heap lattice batch: (inputs, state, history, counters)."""
    jspec, tspec, jst, data, params = _block_inputs("tree")
    block = jax.jit(jengine.build_tenant_block(jspec, KERNELS, 6, 2, 3))
    out = block(jst, *(jnp.asarray(a) for a in data),
                jengine.TenantParams(*(jnp.asarray(a) for a in params)))
    return (tspec, jst, data, params), jax.device_get(out)


def _port_block(tspec, jst, data, params, **kw):
    block = tengine.build_tenant_block(tspec, KERNELS, 6, 2, 3, **kw)
    state = tengine.tenant_state_from_numpy(jax.device_get(jst), device="cpu")
    tparams = tengine.TenantParams(*(torch.from_numpy(np.asarray(a)) for a in params))
    return block(state, *(torch.from_numpy(a) for a in data), tparams,
                 tengine.TenantParams(*params))


def test_tenant_block_matches_reference(ref_block_heap):
    """One K=3 block over 3 heterogeneous slots (r with an early stop
    reached in the block, c, and an empty slot) on lattice data: state,
    history f32[3, 3] and counters int32[3, 7] bitwise the reference's
    jitted block; the empty slot never advances and the stopped one
    freezes."""
    (tspec, jst, data, params), (jstate, jhist, jrows) = ref_block_heap
    state, hist, rows = _port_block(tspec, jst, data, params)
    _assert_tenant_equal(jstate, state, "block")
    np.testing.assert_array_equal(hist.numpy(), np.asarray(jhist))
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    assert hist.shape == (3, 3) and rows.shape == (3, 7)
    assert state.gens_done.tolist() == [1, 3, 0]  # stopped after 1; empty
    assert (rows[:, 2] >= 1).all()  # the empty slot counts as frozen


def test_tenant_block_reads_params_when_given_no_host_table(ref_block_heap):
    """Without the host table the block reads `params` back itself (a
    host read) and takes the same step."""
    (tspec, jst, data, params), (jstate, jhist, _) = ref_block_heap
    block = tengine.build_tenant_block(tspec, ("r", "classify", "match", "mse"), 6, 2, 3)
    state = tengine.tenant_state_from_numpy(jax.device_get(jst), device="cpu")
    tparams = tengine.TenantParams(*(torch.from_numpy(np.asarray(a)) for a in params))
    state, hist, _ = block(state, *(torch.from_numpy(a) for a in data), tparams)
    _assert_tenant_equal(jstate, state, "block")
    np.testing.assert_array_equal(hist.numpy(), np.asarray(jhist))


def test_postfix_tenant_block_matches_reference_and_dedup_is_bitwise():
    """Postfix genomes: the block is bitwise the reference's, and
    dedup="exact" (the unique table and B3/B4's plain versions, at a cap
    that holds and one that overflows) equals dedup="off" bit for bit."""
    jspec, tspec, jst, data, params = _block_inputs("postfix")
    block = jax.jit(jengine.build_tenant_block(jspec, KERNELS, 6, 2, 3))
    jstate, jhist, jrows = jax.device_get(block(
        jst, *(jnp.asarray(a) for a in data),
        jengine.TenantParams(*(jnp.asarray(a) for a in params))))
    off = _port_block(tspec, jst, data, params)
    _assert_tenant_equal(jstate, off[0], "postfix")
    np.testing.assert_array_equal(off[1].numpy(), np.asarray(jhist))
    np.testing.assert_array_equal(off[2].numpy(), np.asarray(jrows))
    for cap in (0, 8):
        exact = _port_block(tspec, jst, data, params, dedup="exact", dedup_cap=cap)
        for a, b in zip(off, exact):
            for x, z in zip(a if isinstance(a, tuple) else (a,),
                            b if isinstance(b, tuple) else (b,)):
                assert torch.equal(x, z), cap


def test_build_tenant_block_refusals():
    """A host-only backend cannot run inside the block; kernel aliases
    collapse to their canonical names; the service refuses a job kernel
    outside its set."""
    _, tspec = _tree_specs()
    with pytest.raises(ValueError, match="host-only"):
        tengine.build_tenant_block(tspec, ("r",), 6, 1, 2, eval_impl="scalar")
    with pytest.raises(ValueError, match="unknown fitness kernel"):
        tengine.build_tenant_block(tspec, ("no-such-kernel",), 6, 1, 2)
    svc = _service(kernels=("regression", "r-squared"))
    assert svc.kernels == ("r", "r2") and svc.backend == "torch"


# --- the acceptance scenario: packed == the port's solo sessions ------------------


@pytest.fixture(scope="module")
def packed_run():
    """The reference's acceptance scenario through a 3-slot port service."""
    jobs = _jobs(8)
    svc = _service(kernels=("r", "mse", "pearson"), block_size=4)
    handles = [svc.submit(j) for j in jobs]
    svc.run()
    return svc, jobs, handles


def test_packed_service_compiles_once(packed_run):
    svc, _, handles = packed_run
    assert all(h.status == DONE for h in handles)
    assert svc.stats["compiles"] == 1, "admission/eviction must not rebuild the block"
    assert svc.stats["admissions"] == 8 and svc.stats["evictions"] == 8
    assert svc.stats["host_syncs"] == svc.stats["blocks"]  # one read per block
    assert svc.heartbeats.dead_workers() == []


@pytest.mark.parametrize("job", range(8))
def test_parity_packed_vs_port_solo(packed_run, job):
    """Each of the 8 heterogeneous jobs (3 kernels, 3 operator mixes,
    ragged rows, unequal budgets, two early-stop bars; several
    admission waves) publishes the same generation count, best fitness,
    history and champion as the port's own solo islands=1 session on the
    same padded buffers, bit for bit, on real-valued data — job-2
    (pearson) and job-6 (r, 17 rows) included."""
    _, jobs, handles = packed_run
    h, j = handles[job], jobs[job]
    Xs, ys, ws = slot_buffers(j, FEATS, DCAP)
    sess = GPSession(pop_size=POP, max_depth=DEPTH, kernel=j.kernel, mix=j.mix,
                     tourn_size=j.tourn_size, elitism=1, stop_fitness=j.stop_fitness,
                     generations=j.generations, backend="torch", device="cpu")
    sess.ingest(Xs.T, ys, sample_weight=ws)
    sess.init(key=prng.PRNGKey(j.seed))
    sess.evolve(j.generations)
    assert h.gens_done == sess.generation, j.name
    assert h.best_fitness == float(sess.state.best_fitness), j.name
    assert h.history == sess.history, j.name
    assert h.best_expression == sess.best_expression(), j.name
    assert len(h.history) == h.gens_done


# --- against the reference's service on lattice data ------------------------------


def _lattice_job(i, spec_cls, mix_cls, kernels=KERNELS, rows=None, generations=None):
    r = np.random.RandomState(100 + i)
    rows = rows or 10 + 4 * (i % 5)
    X = r.randint(-2, 3, size=(rows, FEATS)).astype(np.float32)
    k = kernels[i % len(kernels)]
    if k == "c":
        y = np.clip(X[:, 0] * X[:, 1], 0, 2).astype(np.float32)
    else:
        y = (X[:, 0] * X[:, 1] - X[:, 1] + r.randint(-1, 2, size=rows)).astype(np.float32)
    return spec_cls(X, y, kernel=k, mix=mix_cls(*MIXES[i % 3]), tourn_size=3 + i % 4,
                    point_rate=(0.25, 0.5, 0.1)[i % 3], n_classes=3,
                    precision=(1e-4, 0.5)[i % 2],
                    stop_fitness=0.0 if i % 4 == 1 else None,
                    generations=generations or 4 + i % 5, seed=i, name=f"lat-{i}")


def _lattice_services(slots=3, n=8, **kw):
    jspec, tspec = _tree_specs()
    common = dict(slots=slots, pop_size=POP, n_features=FEATS, data_cap=DCAP,
                  tourn_draw=TOURN, block_size=3, **kw)
    return JService(tree_spec=jspec, **common), GPService(tree_spec=tspec, device="cpu",
                                                            **common)


@pytest.fixture(scope="module")
def lattice_runs():
    ref, port = _lattice_services(kernels=KERNELS)
    jh = [ref.submit(_lattice_job(i, JJobSpec, JMix)) for i in range(8)]
    th = [port.submit(_lattice_job(i, JobSpec, OperatorMix)) for i in range(8)]
    ref.run()
    port.run()
    return ref, port, jh, th


@pytest.mark.parametrize("job", range(8))
def test_service_matches_reference_on_lattice(lattice_runs, job):
    """8 lattice jobs over kernels r, c, m and mse (heterogeneous mixes,
    tournament sizes, point rates, precisions, stop bars) through 3 slots:
    every handle's generations, best fitness, history, champion arrays
    and expression are bitwise the reference service's."""
    _, _, jh, th = lattice_runs
    want, got = jh[job], th[job]
    assert got.status == want.status == DONE
    assert got.gens_done == want.gens_done
    assert got.best_fitness == want.best_fitness
    assert got.history == want.history
    np.testing.assert_array_equal(got.best_op, want.best_op)
    np.testing.assert_array_equal(got.best_arg, want.best_arg)
    assert got.best_expression == want.best_expression


def test_service_stats_match_reference_on_lattice(lattice_runs):
    ref, port, _, _ = lattice_runs
    for name in ("blocks", "admissions", "evictions", "cache_hits", "cache_queries",
                 "frozen", "tree_evals"):
        assert port.stats[name] == ref.stats[name], name
    assert port.stats["compiles"] == ref.stats["compiles"] == 1


def test_reference_snapshot_adopted_by_the_port(tmp_path):
    """A reference snapshot taken mid-flight (2 blocks on 2 slots),
    carried into the port through `tenant_state_from_numpy` and adopted
    by a 3-slot port service, finishes with the reference's
    uninterrupted results; the snapshot also round-trips through the
    port's checkpoint files."""
    from repro_torch.ckpt import checkpoint as tckpt

    jobs = [(_lattice_job(i, JJobSpec, JMix, kernels=("r", "mse"), generations=8),
             _lattice_job(i, JobSpec, OperatorMix, kernels=("r", "mse"), generations=8))
            for i in (0, 2, 4)]
    for pair in jobs:
        for j in pair:
            j.stop_fitness = None
    ref, _ = _lattice_services(slots=2, kernels=("r", "mse"))
    ref_handles = [ref.submit(j) for j, _ in jobs]
    ref.run()
    a, _ = _lattice_services(slots=2, kernels=("r", "mse"))
    for j, _ in jobs:
        a.submit(j)
    a.run(max_blocks=2)
    snap = a._make_snapshot()
    assert not a.idle()
    tckpt.save(snap, str(tmp_path), 2)
    on_disk = tckpt.restore(str(tmp_path), 2, like=jax.tree.map(np.asarray, snap))
    _, b = _lattice_services(slots=3, kernels=("r", "mse"))
    handles = [b.submit(t) for _, t in jobs]
    b.adopt({"state": tengine.tenant_state_from_numpy(on_disk["state"], device="cpu"),
             "params": on_disk["params"], "slot_ids": on_disk["slot_ids"]})
    b.run()
    for h, r in zip(handles, ref_handles):
        assert h.status == DONE
        assert h.gens_done == r.gens_done
        assert h.best_fitness == r.best_fitness
        resumed_from = r.gens_done - len(h.history)  # adopt keeps no earlier history
        assert h.history == r.history[resumed_from:]
        assert h.best_expression == r.best_expression
    assert sorted(h.gens_done - len(h.history) for h in handles) == [0, 6, 6]


# --- the reference's service tests, ported ----------------------------------------


def test_pack_order_fifo_and_lpt():
    jobs = [JobSpec(*_dataset(i, 16), generations=g, seed=i)
            for i, g in enumerate([5, 20, 10, 20])]
    from repro_torch.service.job import JobHandle
    handles = [JobHandle(i, j) for i, j in enumerate(jobs)]
    assert [h.job_id for h in pack_order(handles, 3, "fifo")] == [0, 1, 2]
    # lpt: largest REMAINING budget first, job_id breaks the 20/20 tie
    assert [h.job_id for h in pack_order(handles, 3, "lpt")] == [1, 3, 2]
    handles[1].gens_done = 15  # 5 remaining now
    assert [h.job_id for h in pack_order(handles, 2, "lpt")] == [3, 2]
    with pytest.raises(ValueError, match="strategy"):
        pack_order(handles, 1, "sjf")


def test_single_slot_runs_jobs_in_submit_order():
    """slots=1 + FIFO: the slot's occupant sequence is the submit order,
    observed at every block boundary via the fault hook."""
    occupancy = []

    def spy(i):
        occupancy.extend(h.job_id for _, h in svc.batch.occupied)

    svc = _service(slots=1, fault_hook=spy)
    handles = [svc.submit(_spec(i, 16, generations=4)) for i in range(3)]
    svc.run()
    assert all(h.status == DONE for h in handles)
    assert occupancy == sorted(occupancy)
    assert set(occupancy) == {0, 1, 2}


def test_cancel_pending_and_running():
    svc = _service(slots=1, block_size=3)
    running = svc.submit(_spec(0, 16, generations=9))
    queued = svc.submit(_spec(1, 16, generations=4))
    assert svc.cancel(queued.job_id) is True
    assert queued.status == CANCELLED and queued.gens_done == 0
    svc._fault_hook = lambda i: svc.cancel(running.job_id) if i == 1 else None
    svc.run()
    assert running.status == CANCELLED
    assert 0 < running.gens_done < 9
    assert running.best_expression is not None
    assert svc.cancel(running.job_id) is False  # already finished
    assert svc.idle()


def test_restart_replays_to_identical_results(tmp_path):
    """Kill the scheduler mid-queue (injected fault), restart from the
    newest committed checkpoint: every published result is identical to
    a fault-free run's, history included."""
    jobs = _jobs(4, kernels=("r",))
    ref = _service()
    ref_handles = [ref.submit(j) for j in jobs]
    ref.run()
    boom = {2: True}

    def fault(i):
        if boom.pop(i, False):
            raise RuntimeError("injected scheduler failure")

    svc = _service(checkpoint_dir=str(tmp_path), checkpoint_every=1, fault_hook=fault)
    handles = [svc.submit(j) for j in jobs]
    svc.run()
    assert svc.stats["restarts"] == 1
    for h, r in zip(handles, ref_handles):
        assert h.status == DONE
        assert h.gens_done == r.gens_done
        assert h.best_fitness == r.best_fitness
        assert h.best_expression == r.best_expression
        assert h.history == r.history


def _one_slot_jobs():
    return [_spec(i, 12 + 4 * i, generations=4, name=f"job-{i}") for i in range(4)]


@pytest.fixture(scope="module")
def one_slot_run():
    """The fault-free run of `_one_slot_jobs` through one slot."""
    svc = _service(slots=1)
    handles = [svc.submit(j) for j in _one_slot_jobs()]
    svc.run()
    return handles


@pytest.mark.parametrize("fault_at", [3, 4, 5])
def test_rollback_readmits_a_job_with_its_history_cut(tmp_path, one_slot_run, fault_at):
    """A failure at block 3, 4 or 5 of one-slot jobs, with a checkpoint
    every 3 blocks, must not show in the results. At block 5 the rollback
    passes a job's admission: the job goes back to the queue, is
    re-admitted fresh and must publish the fault-free run's history, not
    the rolled-back generations followed by the replayed ones (the
    reference keeps both: ROADMAP queue C, item 14)."""
    boom = {fault_at: True}

    def fault(i):
        if boom.pop(i, False):
            raise RuntimeError("injected scheduler failure")

    svc = _service(slots=1, checkpoint_dir=str(tmp_path), checkpoint_every=3,
                   fault_hook=fault)
    handles = [svc.submit(j) for j in _one_slot_jobs()]
    svc.run()
    assert svc.stats["restarts"] == 1
    for h, r in zip(handles, one_slot_run):
        assert h.status == DONE
        assert (h.gens_done, h.best_fitness, h.history) == (r.gens_done, r.best_fitness,
                                                            r.history)


def test_slot_invariance():
    """The same job publishes identical results from any slot, next to
    any neighbour, with its own tournament size and point rate."""
    target = _spec(7, 20, generations=6, tourn_size=3, point_rate=0.5, name="target")
    results = []
    for fillers in ([_spec(1, 16, generations=8)], []):
        svc = _service(slots=2)
        handles = [svc.submit(f) for f in fillers]
        t = svc.submit(target)
        svc.run()
        assert all(h.status == DONE for h in handles + [t])
        results.append((t.best_fitness, t.best_expression, t.gens_done, tuple(t.history)))
    assert results[0] == results[1]


def test_adopt_resumes_at_different_slot_count():
    """A snapshot taken mid-flight on a 2-slot service, adopted by a
    3-slot service, finishes with the uninterrupted run's results."""
    jobs = _jobs(3, kernels=("r",))
    for j in jobs:
        j.stop_fitness = None
        j.generations = 8
    ref = _service(slots=2)
    ref_handles = [ref.submit(j) for j in jobs]
    ref.run()
    a = _service(slots=2)
    for j in jobs:
        a.submit(j)
    a.run(max_blocks=2)
    snap = a._make_snapshot()
    assert not a.idle()
    b = _service(slots=3)
    handles = [b.submit(j) for j in jobs]
    b.adopt(snap)
    b.run()
    for h, r in zip(handles, ref_handles):
        assert h.status == DONE
        assert h.gens_done == r.gens_done
        assert h.best_fitness == r.best_fitness
        assert h.best_expression == r.best_expression
    with pytest.raises(ValueError, match="population shape"):
        _service(slots=2, pop_size=POP + 1).adopt(snap)


def test_submit_validation():
    svc = _service()
    with pytest.raises(ValueError, match="rows"):
        svc.submit(JobSpec(*_dataset(0, DCAP + 1)))
    with pytest.raises(ValueError, match="features"):
        X, y = _dataset(0, 16)
        svc.submit(JobSpec(np.concatenate([X, X], axis=1), y))
    with pytest.raises(ValueError, match="kernel"):
        svc.submit(JobSpec(*_dataset(0, 16), kernel="mse"))
    with pytest.raises(ValueError, match="tourn"):
        svc.submit(JobSpec(*_dataset(0, 16), tourn_size=TOURN + 1))
    with pytest.raises(ValueError, match="slots"):
        _service(slots=0)


def test_jobspec_validation_and_poll():
    X, y = _dataset(0, 16)
    with pytest.raises(ValueError, match="rows"):
        JobSpec(X, y[:-1])
    with pytest.raises(ValueError, match="generations"):
        JobSpec(X, y, generations=0)
    with pytest.raises(ValueError, match="unknown fitness kernel"):
        JobSpec(X, y, kernel="no-such-kernel")
    svc = _service(slots=1)
    h = svc.submit(JobSpec(X, y, generations=3, tourn_size=TOURN, name="polled"))
    snap = svc.poll(h.job_id)
    assert snap["status"] == PENDING and snap["gens_done"] == 0
    assert snap["name"] == "polled" and snap["budget"] == 3
    done = svc.result(h.job_id)
    assert done is h and h.status == DONE
    assert svc.poll(h.job_id)["best_expression"] == h.best_expression
    assert "status=done" in repr(h)


def test_operands_upload_only_when_a_slot_changed():
    """The device operands are uploaded once per change of the slot table
    and are copies: rewriting the host rows leaves them untouched."""
    svc = _service(slots=2)
    svc.submit(_spec(0, 16, generations=6))
    ops1 = svc.batch.operands()
    assert svc.batch.operands() is ops1
    svc._admit()
    ops2 = svc.batch.operands()
    assert ops2 is not ops1 and svc.batch.operands() is ops2
    assert int(ops2[3].budget[0]) == 6 and int(ops1[3].budget[0]) == 0


# --- the reference's obs tests of the service, ported -----------------------------


def _obs_jobs(n=3, rows=48, seed=0):
    r = np.random.RandomState(seed)
    out = []
    for i in range(n):
        X = r.randn(rows, 3).astype(np.float32)
        y = (X[:, 0] * X[:, 1]).astype(np.float32)
        out.append(JobSpec(X, y, kernel="r", generations=8, seed=i, name=f"obs-{i}"))
    return out


def test_service_cache_hit_rate_and_no_recompile(tmp_path):
    """The service aggregates slot-level cache counters; a tracer and a
    metrics sink keep the one-block guarantee and the trace validates."""
    tracer = Tracer(str(tmp_path / "svc.json"))
    mreg = Metrics(str(tmp_path / "svc.jsonl"))
    svc = GPService(slots=2, pop_size=32, n_features=3, data_cap=64, block_size=4,
                    tracer=tracer, metrics=mreg, device="cpu")
    for j in _obs_jobs(3):
        svc.submit(j)
    svc.run()
    mreg.close()
    assert svc.stats["compiles"] == 1, svc.stats
    assert svc.stats["cache_queries"] > 0
    assert svc.stats["tree_evals"] > 0
    assert 0.0 <= svc.stats["cache_hit_rate"] <= 1.0
    payload = json.load(open(tracer.save()))
    assert validate_trace(payload) == []
    phases = {e["ph"] for e in payload["traceEvents"]}
    assert {"b", "e", "B", "E"} <= phases
    names = {e["name"] for e in payload["traceEvents"]}
    assert {"admit", "dispatch", "job", "publish"} <= names
    kinds = [json.loads(ln)["kind"] for ln in open(tmp_path / "svc.jsonl")]
    assert "counters" in kinds and "block" in kinds


def test_service_elitism_zero_disables_cache_counters():
    svc = GPService(slots=2, pop_size=32, n_features=3, data_cap=64, block_size=4,
                    elitism=0, device="cpu")
    for j in _obs_jobs(2):
        svc.submit(j)
    svc.run()
    assert svc.stats["cache_hits"] == 0 and svc.stats["cache_queries"] == 0
    assert svc.stats["cache_hit_rate"] == 0.0


# --- the session's slot swap ------------------------------------------------------


def _swap_sessions():
    X = np.random.RandomState(4).randint(-2, 3, size=(40, 2)).astype(np.float32)
    y = (X[:, 0] * X[:, 1] - X[:, 0]).astype(np.float32)
    kw = dict(pop_size=16, generations=4, islands=3, migrate_every=2, migrate_k=2,
              kernel="r", max_depth=3, p_const=0.0, fn_set="add,sub,mul", block_size=2)
    want = JSession(backend="jnp", **kw).fit(X, y, key=jax.random.PRNGKey(2))
    got = GPSession(device="cpu", **kw).fit(X, y, key=prng.PRNGKey(2))
    return want, got


def test_session_slot_swap_matches_reference():
    """export_island/import_island/adopt_state on an islands=3 session
    against the reference's: the exported slice, the state after a swap,
    and the trajectory of 2 more generations after adopt_state, bit for
    bit; and the reference's errors."""
    want, got = _swap_sessions()
    for idx in range(3):
        w, g = want.export_island(idx), got.export_island(idx)
        for name, a, b in zip(tengine.GPState._fields, w, tengine.state_to_numpy(g).values()):
            np.testing.assert_array_equal(b, np.asarray(a), err_msg=name)
    want.import_island(0, want.export_island(2))
    got.import_island(0, got.export_island(2))
    np.testing.assert_array_equal(got.state.op.numpy(), np.asarray(want.state.op))
    want.adopt_state(want.state)
    got.adopt_state(tengine.state_from_numpy(jax.device_get(want.state), device="cpu"))
    assert got.generation == want.generation == 4
    want.evolve(2)
    got.evolve(2)
    assert got.history == want.history
    np.testing.assert_array_equal(np.asarray(got.island_history),
                                  np.asarray(want.island_history))
    for name, a, b in zip(tengine.GPState._fields, want.state,
                          tengine.state_to_numpy(got.state).values()):
        np.testing.assert_array_equal(b, np.asarray(a), err_msg=name)
    for bad in (-1, 3):
        with pytest.raises(ValueError, match="out of range"):
            got.export_island(bad)
        with pytest.raises(ValueError, match="out of range"):
            got.import_island(bad, got.export_island(0))
    solo = GPSession(device="cpu", pop_size=8).fit(np.ones((5, 1), np.float32),
                                                   np.ones(5, np.float32), generations=1)
    with pytest.raises(ValueError, match="islands > 1"):
        solo.export_island(0)
    with pytest.raises(ValueError, match="islands > 1"):
        solo.import_island(0, None)
    with pytest.raises(ValueError, match="no evolved state"):
        GPSession(device="cpu", islands=2).export_island(0)


# --- the CLI ----------------------------------------------------------------------


def test_serve_cli_prints_one_line_per_job_and_resumes(tmp_path, capsys):
    """`serve_gp --device cpu --jobs 4 --slots 2 --pop 16 --depth 3`
    prints one line per job and the summary; a rerun on the same
    --ckpt-dir publishes the same results."""
    from repro_torch.launch import serve_gp

    argv = ["--device", "cpu", "--jobs", "4", "--slots", "2", "--pop", "16",
            "--depth", "3", "--block-size", "4"]
    serve_gp.main(argv)
    plain = capsys.readouterr().out.splitlines()
    job_lines = [ln for ln in plain if ln.lstrip().startswith("[")]
    assert len(job_lines) == 4 and all("done" in ln for ln in job_lines)
    assert any(ln.startswith("4 jobs / 2 slots:") for ln in plain)
    assert "1 compiled program(s)" in "\n".join(plain)
    ck = str(tmp_path / "ck")
    outs = []
    for _ in range(2):
        serve_gp.main(argv + ["--ckpt-dir", ck, "--metrics", str(tmp_path / "m.jsonl")])
        outs.append([ln for ln in capsys.readouterr().out.splitlines()
                     if ln.lstrip().startswith("[")])
    assert outs[0] == job_lines
    assert len(outs[1]) == 4
    jobs = serve_gp.synthetic_stream(6, seed=0)
    assert [j.kernel for j in jobs] == ["r", "mse", "pearson"] * 2
    assert all(24 <= j.n_rows <= 96 for j in jobs)
    assert [j.stop_fitness for j in jobs[:5]] == [1e-5, None, None, None, 1e-5]


def test_serve_job_file(tmp_path):
    """A JSON job file names datasets with JobSpec overrides."""
    from repro_torch.launch import serve_gp

    path = tmp_path / "jobs.json"
    path.write_text(json.dumps([{"dataset": "kepler", "generations": 3, "seed": 1},
                                {"dataset": "kat7", "rows": 40, "generations": 2}]))
    jobs = serve_gp.load_job_file(str(path), data_cap=64)
    assert [j.name for j in jobs] == ["kepler-0", "kat7-1"]
    assert jobs[1].n_rows == 40 and jobs[1].kernel == "c"
    lines = []
    svc, handles = serve_gp.serve(jobs, slots=2, pop=16, depth=3, data_cap=64,
                                  log=lines.append, device="cpu")
    assert all(h.status == DONE for h in handles)
    assert len(lines) >= 3 and svc.device.type == "cpu"


def test_dataclass_fields_match_reference():
    """JobSpec carries the reference's fields, in order."""
    assert ([f.name for f in dataclasses.fields(JobSpec)]
            == [f.name for f in dataclasses.fields(JJobSpec)])
    assert tengine.TenantParams._fields == jengine.TenantParams._fields
    assert tengine.TenantState._fields == jengine.TenantState._fields
