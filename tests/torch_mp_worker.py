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
            state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
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


def main():
    scenario, tmp = sys.argv[1], sys.argv[2]
    from repro_torch.launch.cluster import close_cluster, init_cluster

    info = init_cluster(device="cpu")
    with open(os.path.join(tmp, "mp_inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    out = {}
    {"init": init, "gp": gp, "lm": lm}[scenario](tmp, inputs, out)
    assert "jax" not in sys.modules, "a process of the port imported jax"
    np.savez(os.path.join(tmp, f"mp_{scenario}.{info.process_id}.npz"), **out)
    close_cluster()


if __name__ == "__main__":
    main()
