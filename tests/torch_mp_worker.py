"""One process of the multi-process mesh tests (`torch_mp.run_processes`):
`python tests/torch_mp_worker.py SCENARIO TMPDIR`, with COORDINATOR_ADDRESS,
NUM_PROCESSES and PROCESS_ID set. It joins the gloo group through
`init_cluster(device="cpu")`, runs the scenario's sessions and train
steps on meshes whose shards the processes share, and writes what it
got to TMPDIR/mp_SCENARIO.RANK.npz. Imports no JAX."""
import dataclasses
import os
import pickle
import sys

import numpy as np
import torch

torch.set_num_threads(2)


def _put_state(out, tag, state):
    from repro_torch.core import engine

    for name, a in engine.state_to_numpy(state).items():
        out[f"{tag}.{name}"] = a


def _put_session(out, tag, s):
    _put_state(out, tag, s.state)
    out[f"{tag}.history"] = np.asarray(s.history, np.float32)
    if s.island_history:
        out[f"{tag}.island"] = np.asarray(s.island_history, np.float32)
    out[f"{tag}.host_syncs"] = np.asarray(s.stats["host_syncs"])


class Moved:
    """The bytes this process's `torch.distributed` collectives send and
    receive while the block runs, as `chip_smoke.py`'s `_Moved` counts
    them (the module's functions wrapped; a collective's own part of its
    output is neither sent nor received): what `launch/dryrun.py` reckons
    for the same step (`tests/test_torch_dryrun.py`)."""

    NAMES = ("all_gather", "all_gather_into_tensor", "all_to_all_single", "all_reduce",
             "broadcast")

    def __enter__(self):
        import torch.distributed as dist

        self.sent = self.received = self.calls = 0
        self.originals = {n: getattr(dist, n) for n in self.NAMES}
        for name, fn in self.originals.items():
            setattr(dist, name, self._wrap(name, fn))
        return self

    def _wrap(self, name, fn):
        import torch.distributed as dist

        def nbytes(t):
            return t.numel() * t.element_size()

        def wrapped(*a, **k):
            group = k.get("group")
            n = dist.get_world_size(group)
            me = dist.get_rank(group)
            self.calls += 1
            if name == "all_gather":
                self.sent += nbytes(a[1])
                self.received += sum(nbytes(o) for o in a[0]) - nbytes(a[1])
            elif name == "all_gather_into_tensor":
                self.sent += nbytes(a[1])
                self.received += nbytes(a[0]) - nbytes(a[1])
            elif name == "all_to_all_single":
                out_sizes = a[2] if len(a) > 2 else k.get("output_split_sizes")
                own = (out_sizes[me] if out_sizes else a[0].numel() // n) * a[0].element_size()
                self.sent += nbytes(a[1]) - own
                self.received += nbytes(a[0]) - own
            else:
                self.sent += nbytes(a[0]) * (n > 1)
                self.received += nbytes(a[0]) * (n > 1)
            return fn(*a, **k)

        return wrapped

    def __exit__(self, *exc):
        import torch.distributed as dist

        for name, fn in self.originals.items():
            setattr(dist, name, fn)

    def put(self, out, tag):
        out[f"moved.{tag}"] = np.asarray([self.sent, self.received, self.calls], np.int64)


def _flat(tree, path=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{path}/{k}").items()}
    return {path: np.asarray(tree)}


def init(tmp, inputs, out):
    """The process group and a (data 2, model 2) mesh over it: each
    process's shards, and a psum over the data axis."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as TM

    mesh = TM.make_host_mesh(data=2, model=2, device="cpu")
    out["world"], out["backend"] = dist.get_world_size(), dist.get_backend()
    out["local"] = np.asarray(mesh.local)
    got = TM.over(mesh, "data", TM.psum, {s: torch.tensor(float(s + 1)) for s in mesh.local})
    out["psum"] = got[mesh.local[0]].numpy()


def gp(tmp, inputs, out):
    """The GP mesh scenarios of `test_torch_mesh.py`: (a) the classic
    step on (pod 2, data 2, model 2), (c) the island sessions there (two
    shards a process), (p) the classic step and (c)'s ring and
    broadcast-best sessions on (pod 2, data 2, model 1), whose pods span
    processes (one shard a process), (f) postfix with dedup exact on
    (data 2, model 2) at two caps, and (c)'s ring state checkpointed from
    the processes."""
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.core import engine, prng
    from repro_torch.core.engine import GPConfig
    from repro_torch.core.evolve import OperatorMix
    from repro_torch.core.fitness import FitnessSpec
    from repro_torch.core.primitives import FunctionSet
    from repro_torch.core.trees import TreeSpec
    from repro_torch.gp import GPSession, MeshTopology
    from repro_torch.launch import mesh as tmesh
    from torch_mesh_data import LAT3, MIXES, POD_TOPOLOGIES, RATES, TOPOLOGIES, TOURN, lattice

    mesh = tmesh.make_host_mesh(data=2, model=2, pod=2, device="cpu")
    out["local"] = np.asarray(mesh.local)
    spec = TreeSpec(max_depth=5, n_features=2, p_const=0.0,
                    fn_set=FunctionSet.make(("add", "sub", "mul")))
    cfg = GPConfig(pop_size=64, tree_spec=spec, fitness=FitnessSpec("r"), migrate_every=3,
                   eval_impl="torch")
    X, y = lattice(128, 1, -1, 2)
    data = torch.from_numpy(X.T.copy()), torch.from_numpy(y), torch.ones(128)
    pods = tmesh.make_host_mesh(data=2, model=1, pod=2, device="cpu")
    out["pods_local"] = np.asarray(pods.local)
    for tag, on in (("a", mesh), ("p_classic", pods)):
        step, _ = engine.sharded_evolve_step(cfg, on, pod_axis="pod")
        s = engine.init_state(cfg, prng.PRNGKey(0), device="cpu")
        for g in range(6):
            s = step(s, *data)
            _put_state(out, f"{tag}{g}", s)
    X, y = lattice(40, 4)
    hetero = dict(islands=4, island_mixes=tuple(OperatorMix(*m) for m in MIXES),
                  island_tourn_sizes=TOURN, island_point_rates=RATES)
    for topo in TOPOLOGIES:
        sess = GPSession(device="cpu", pop_size=16, generations=6, migrate_every=2,
                         migrate_k=1, island_topology=topo,
                         topology=MeshTopology(data=2, model=2, pod=2), **hetero, **LAT3)
        sess.fit(X, y, key=prng.PRNGKey(5))
        _put_session(out, f"c_{topo}", sess)
        if topo == "ring":
            ckpt.save(sess.state, os.path.join(tmp, "ckpt_gp"), 1)
            with Moved() as moved:  # one 1-generation block more, counted
                sess.evolve_block(1)
            moved.put(out, "gp.block")
    for topo in POD_TOPOLOGIES:
        sess = GPSession(device="cpu", pop_size=16, generations=6, migrate_every=2,
                         migrate_k=1, island_topology=topo,
                         topology=MeshTopology(data=2, model=1, pod=2), **hetero, **LAT3)
        sess.fit(X, y, key=prng.PRNGKey(5))
        _put_session(out, f"p_{topo}", sess)
    for cap in (1400, 6301):
        sess = GPSession(device="cpu", pop_size=16, generations=5, genome="postfix",
                         dedup="exact", dedup_cap=cap, topology=MeshTopology(data=2, model=2),
                         **LAT3)
        sess.fit(X, y, key=prng.PRNGKey(8))
        _put_session(out, f"f{cap}", sess)


def lm(tmp, inputs, out):
    """The sharded train steps of `test_torch_lm_mesh.py` on (data 2,
    model 2), one shard a process, from the reference's initial states
    and batches (`inputs`); gemma-2b's final state checkpointed from the
    processes; `compressed_psum` over the data axis."""
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.ckpt.elastic import reshard_state
    from repro_torch.configs import get_reduced
    from repro_torch.launch import mesh as TM
    from repro_torch.launch import train as TL
    from repro_torch.models import convert
    from repro_torch.optim import compress as TC
    from torch_lm_mesh_ref import F32, TRAIN

    mesh = TM.make_host_mesh(data=2, model=2, device="cpu")
    out["local"] = np.asarray(mesh.local)
    for name, (init, batches) in inputs["train"].items():
        cfg = dataclasses.replace(get_reduced(name), **F32, **TRAIN[name])
        cfg, _, step, _ = TL.build(cfg, mesh, device="cpu")
        state = reshard_state(init, cfg, mesh)
        for i, b in enumerate(batches):
            with Moved() as moved:
                state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
            if i == 0:
                moved.put(out, f"lm.{name}.train")
            for k, v in m.items():
                out[f"{name}.step{i}.{k}"] = v.numpy()
        host = convert.train_state_to_numpy(state)
        for k, v in _flat(host).items():
            out[f"{name}.final{k}"] = v
        if name == "gemma-2b":
            ckpt.save(host, os.path.join(tmp, "ckpt_lm"), 2)
    grads, resid = inputs["compress"]
    mean, new_r = TM.over(mesh, "data", TC.compressed_psum,
                          {s: {"w": torch.from_numpy(grads[s])} for s in mesh.local},
                          {s: {"w": torch.from_numpy(resid[s])} for s in mesh.local})
    for s in mesh.local:
        out[f"compress.{s}.mean"], out[f"compress.{s}.resid"] = (
            mean[s]["w"].numpy(), new_r[s]["w"].numpy())


GRANITE = "granite-moe-3b-a800m"
# the train steps of `serve_runs`: (tag, replace, B x S); granite's 5 experts
# lie on the model axis' FFN split (its expert stacks are (None, data,
# model)), 6 put the expert dim on the model axis (each rank's slice
# gathered alone); S 15 does not divide the model axis (the re-dispatch)
SERVE_TRAIN = (("e5_s15", {"moe_capacity_factor": 1.0, "accum_steps": 2}, (4, 15)),
               ("e6_s16", {"moe_capacity_factor": 1.0, "accum_steps": 2,
                           "moe_experts": 6}, (4, 16)))


# the decode steps `serve` counts: reduced configs in f32 on (data 2, model 2),
# B 4, a cache of 12 rows after an 8-token prompt
DECODE_COUNTED = {GRANITE: {"moe_capacity_factor": 8.0}, "gemma-2b": {}}


def serve_runs(inputs, out, experts=None):
    """The `serve` scenario on this process's meshes (one process: the
    single controller), every result into `out`: reduced granite's
    prefill and 3 greedy decode steps at capacity factors 8 and 1 for B 4
    and B 3 (the one-pass branch) on (data 2, model 2), the logits and
    the joined cache; `forward_train`'s (loss, ce, aux) of reduced
    gemma-2b and granite; the SERVE_TRAIN granite train steps (metrics
    and the final state); `cp_decode_attention` on (data 4, model 1)
    through the cur_lens of `inputs["cp"]` (the outputs, the cache
    slices); `AxisGroup.sum_scatter` and `gather_fanout` over each data
    shard's model group (each rank's value and gradient, under
    "sp.rank.{data}.{model}"); reduced gemma's and jamba's long-context
    decode (batch 1, the cache's sequence over the data axis: its logits,
    the bytes received inside the cache's reads, whether every cache part
    kept its storage, and the joined cache). `experts`, a dict, gets each run's set of (the expert
    buffer's, the weights') leading sizes over its expert FFN calls, and
    under "window.{run}" the leading sizes of the expert slices a pass
    gathered (`gather_tree`: an expert stack split over the model axis by
    expert comes as the ranks' slices); under "tp" the count of the
    ranks' partial sums (`AxisGroup.sum`) tensor parallelism added."""
    from repro_torch.configs import get_reduced
    from repro_torch.launch import mesh as TM
    from repro_torch.launch import sharding as SH
    from repro_torch.launch import train as TL
    from repro_torch.launch.serving import cp_decode_attention
    from repro_torch.models import convert
    from repro_torch.models import layers as L
    from repro_torch.models import model as Md
    from repro_torch.models import moe as M
    from torch_lm_mesh_ref import F32

    ffn, gather, tp_sum, run = M._expert_ffn, SH.gather_tree, TM.AxisGroup.sum, [None]
    if experts is not None:
        def recording(buf, w_up, w_gate, w_down, act):
            experts.setdefault(run[0], set()).add((buf.shape[0], w_up.shape[0]))
            return ffn(buf, w_up, w_gate, w_down, act)

        def gathering(tree, *a, **k):
            got = gather(tree, *a, **k)
            for name, b in tree.items() if isinstance(tree, dict) else ():
                moe = b.get("mlp") if isinstance(b, dict) else None
                if (isinstance(moe, dict) and "router" in moe and moe["w_up"].spec[0] == "model"
                        and isinstance(got[name]["mlp"]["w_up"], list)):
                    experts.setdefault(f"window.{run[0]}", set()).update(
                        t.shape[0] for t in got[name]["mlp"]["w_up"])
            return got

        def summing(self, xs):
            experts["tp"] = experts.get("tp", 0) + 1
            return tp_sum(self, xs)

        M._expert_ffn, SH.gather_tree, TM.AxisGroup.sum = recording, gathering, summing
    try:
        mesh = TM.make_host_mesh(data=2, model=2, device="cpu")

        def placed(cfg):
            pcfg = cfg.with_policy(SH.policy_for(mesh))
            params = Md.init_params(cfg, 0, device="cpu")
            return pcfg, SH.ShardedLM.place(pcfg, mesh, params, SH.param_specs(
                pcfg, SH.ref_layout(params.tree()), mesh))

        for cf in (8.0, 1.0):
            pcfg, params = placed(dataclasses.replace(get_reduced(GRANITE), **F32,
                                                      moe_capacity_factor=cf))
            for B in (4, 3):
                tag = run[0] = f"serve.cf{cf:g}.B{B}"
                tokens = torch.from_numpy(inputs["prompts"][B])
                logits, cache = Md.prefill(pcfg, params, {"tokens": tokens}, max_len=12)
                outs = [logits]
                for t in range(3):
                    logits, cache = Md.decode_step(pcfg, params, cache, logits.argmax(-1),
                                                   torch.tensor(8 + t))
                    outs.append(logits)
                out[f"{tag}.logits"] = torch.cat(outs, 1).numpy()
                for k, v in _flat(convert.cache_to_numpy(cache)).items():
                    out[f"{tag}.cache{k}"] = v
        for name, batch in inputs["forward"].items():
            run[0] = f"forward.{name}"
            pcfg, params = placed(dataclasses.replace(get_reduced(name), **F32))
            loss, m = Md.forward_train(pcfg, params, {k: torch.from_numpy(v)
                                                      for k, v in batch.items()})
            out[f"forward.{name}"] = torch.stack([loss, m["ce"], m["aux"]]).detach().numpy()
        for tag, extra, _ in SERVE_TRAIN:
            run[0] = f"train.{tag}"
            cfg = dataclasses.replace(get_reduced(GRANITE), **F32, **extra)
            _, state, step, _ = TL.build(cfg, mesh, device="cpu")
            for i, b in enumerate(inputs["train"][tag]):
                state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
                for k, v in m.items():
                    out[f"train.{tag}.step{i}.{k}"] = v.numpy()
            for k, v in _flat(convert.train_state_to_numpy(state)).items():
                out[f"train.{tag}.final{k}"] = v
        cp = inputs["cp"]
        cmesh = TM.make_host_mesh(data=4, model=1, device="cpu")
        dims = L.AttnDims(**cp["dims"])
        p = {k: torch.from_numpy(v) for k, v in cp["p"].items()}
        ck, cv = torch.from_numpy(cp["ck"]), torch.from_numpy(cp["cv"])
        for cur_len, x in zip(cp["cur_lens"], cp["xs"]):
            o, ck, cv = cp_decode_attention(p, torch.from_numpy(x), ck, cv,
                                            torch.tensor(cur_len), dims, cmesh,
                                            seq_axis="data")
            out[f"cp.{cur_len}.o"] = o.numpy()
        n = cp["ck"].shape[1] // 4
        for s in cmesh.local:
            for tag, c in (("k", ck), ("v", cv)):
                out[f"cp.{tag}.{s}"] = (c.parts[s] if hasattr(c, "parts") else
                                        c[:, s * n:(s + 1) * n]).numpy()
    finally:
        M._expert_ffn, SH.gather_tree, TM.AxisGroup.sum = ffn, gather, tp_sum
    _sp_collectives(mesh, inputs["sp"], out)
    _long_decode(mesh, inputs["long"], out)
    return cmesh, dims, p


def _sp_collectives(mesh, sp, out):
    """`sum_scatter` (dim 1) and `gather_fanout` over each data shard's
    model group this process runs, forward and backward (a projection of
    the outputs by `sp`'s probes), each rank's result under
    "sp.rank.{data}.{model}"."""
    for d in range(mesh.axis_size("data")):
        shards = [s for s in mesh.local if mesh.rank(s, "data") == d]
        if not shards:
            continue
        g = mesh.axis_group("model", shards[0])
        xs = [torch.from_numpy(sp["x"][d][r]).requires_grad_(True) for r in g.ranks]
        rows = g.sum_scatter(xs, 1)
        sum((o * torch.from_numpy(sp["w"][d][r])).sum() for o, r in zip(rows, g.ranks)).backward()
        ys = [torch.from_numpy(sp["y"][d][r]).requires_grad_(True) for r in g.ranks]
        whole, each = g.gather_fanout(ys, 1)
        (sum((c * torch.from_numpy(sp["wa"][d][r])).sum() for c, r in zip(each, g.ranks))
         + (whole * torch.from_numpy(sp["wb"][d])).sum()).backward()
        for r, o, x, y in zip(g.ranks, rows, xs, ys):
            tag = f"sp.rank.{d}.{r}"
            out[f"{tag}.sum"], out[f"{tag}.sum_grad"] = o.detach().numpy(), x.grad.numpy()
            out[f"{tag}.whole"], out[f"{tag}.whole_grad"] = whole.detach().numpy(), y.grad.numpy()


def _long_decode(mesh, tokens, out):
    """The long-context decode of each of `LONG`'s configs (f32): a
    batch-1 prefill into a cache of `LONG["max_len"]` rows placed with its
    sequence over the data axis, then `LONG["steps"]` greedy decode steps; the bytes this process's collectives
    receive inside the cache's reads (`Moved`: 0 where no cache row
    crosses), whether every local cache part kept its storage (the decode
    writes in place), the logits and the joined cache."""
    from repro_torch.configs import get_reduced
    from repro_torch.launch import sharding as SH
    from repro_torch.models import convert
    from repro_torch.models import model as Md
    from torch_lm_mesh_ref import F32, LONG

    rows, received = SH.ShardedCache.rows, [0]

    def counted(self, *a, **k):
        with Moved() as moved:
            got = rows(self, *a, **k)
        received[0] += moved.received
        return got

    for name in LONG["names"]:
        cfg = dataclasses.replace(get_reduced(name), **F32)
        pcfg = cfg.with_policy(dataclasses.replace(SH.policy_for(mesh),
                                                   seq_axis_for_cache="data"))
        params = Md.init_params(cfg, 0, device="cpu")
        sharded = SH.ShardedLM.place(pcfg, mesh, params, SH.param_specs(
            pcfg, SH.ref_layout(params.tree()), mesh))
        logits, cache = Md.prefill(pcfg, sharded, {"tokens": torch.from_numpy(tokens)},
                                   max_len=LONG["max_len"])
        ptrs = [p.data_ptr() for c in cache._tree.values() for sh in c.values()
                for p in sh.local()]
        outs, received[0] = [logits], 0
        SH.ShardedCache.rows = counted
        try:
            for t in range(LONG["steps"]):
                logits, cache = Md.decode_step(pcfg, sharded, cache, logits.argmax(-1),
                                               torch.tensor(tokens.shape[1] + t))
                outs.append(logits)
        finally:
            SH.ShardedCache.rows = rows
        tag = f"long.{name}"
        out[f"{tag}.logits"] = torch.cat(outs, 1).numpy()
        out[f"{tag}.cache_received"] = np.asarray(received[0])
        out[f"{tag}.in_place"] = np.asarray(ptrs == [p.data_ptr() for c in cache._tree.values()
                                                     for sh in c.values() for p in sh.local()])
        for k, v in _flat(convert.cache_to_numpy(cache)).items():
            out[f"{tag}.cache{k}"] = v


def serve(tmp, inputs, out):
    """`serve_runs` on this process's shards (one a process), the expert
    FFN's leading sizes, and the bytes `torch.distributed` moved out of
    this process in one more cp decode layer (its collectives wrapped)."""
    import torch.distributed as dist

    from repro_torch.launch.serving import cp_decode_attention

    from repro_torch.configs import get_reduced
    from repro_torch.launch import mesh as TM
    from repro_torch.launch import sharding as SH
    from repro_torch.models import model as Md
    from torch_lm_mesh_ref import F32

    experts = {}
    cmesh, dims, p = serve_runs(inputs, out, experts)
    mesh = TM.make_host_mesh(data=2, model=2, device="cpu")
    for name, extra in DECODE_COUNTED.items():  # one decode step each, counted
        cfg = dataclasses.replace(get_reduced(name), **F32, **extra)
        pcfg = cfg.with_policy(SH.policy_for(mesh))
        params = Md.init_params(cfg, 0, device="cpu")
        sharded = SH.ShardedLM.place(pcfg, mesh, params, SH.param_specs(
            pcfg, SH.ref_layout(params.tree()), mesh))
        tokens = torch.from_numpy(inputs["prompts"][4])
        logits, cache = Md.prefill(pcfg, sharded, {"tokens": tokens}, max_len=12)
        with Moved() as moved:
            Md.decode_step(pcfg, sharded, cache, logits.argmax(-1), torch.tensor(8))
        moved.put(out, f"serve.{name}.decode")
    out["tp_sums"] = np.asarray(experts.pop("tp", 0))
    for run, sizes in experts.items():
        out[f"experts.{run}"] = np.asarray(sorted(sizes), np.int64)
    out["experts"] = np.asarray(sorted(experts))
    sent, originals = [], {n: getattr(dist, n) for n in (
        "all_gather", "all_gather_into_tensor", "all_to_all_single", "all_reduce",
        "broadcast", "reduce_scatter_tensor", "send", "isend")}

    def counting(name, fn):
        def wrapped(*a, **k):
            t = a[0] if name in ("all_reduce", "broadcast", "send", "isend") else a[1]
            sent.append(t.numel() * t.element_size())
            return fn(*a, **k)
        return wrapped

    cp = inputs["cp"]
    ck, cv = torch.from_numpy(cp["ck"]), torch.from_numpy(cp["cv"])
    for name, fn in originals.items():
        setattr(dist, name, counting(name, fn))
    try:
        cp_decode_attention(p, torch.from_numpy(cp["xs"][0]), ck, cv, torch.tensor(3), dims,
                            cmesh, seq_axis="data")
    finally:
        for name, fn in originals.items():
            setattr(dist, name, fn)
    out["cp.sent_bytes"] = np.asarray(sent, np.int64)


def main():
    scenario, tmp = sys.argv[1], sys.argv[2]
    from repro_torch.launch.cluster import close_cluster, init_cluster

    info = init_cluster(device="cpu")
    with open(os.path.join(tmp, "mp_inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    out = {}
    {"init": init, "gp": gp, "lm": lm, "serve": serve}[scenario](tmp, inputs, out)
    assert "jax" not in sys.modules, "a process of the port imported jax"
    np.savez(os.path.join(tmp, f"mp_{scenario}.{info.process_id}.npz"), **out)
    close_cluster()


if __name__ == "__main__":
    main()
