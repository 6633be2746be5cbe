"""Tensor parallelism against one device, on the CPU in f32: each reduced
config's prefill and 3 greedy decode steps, and its `forward_train` ce,
with the params placed on a (data, model) mesh (`ShardedLM`, one process:
the model ranks in turn) against the same seed-0 `LM` unsharded:

    PYTHONPATH=src python3 tools/tp_parity.py [--mesh 1,4] [--cf 8]

Prints one line a config: the largest |logit difference| over the serve
steps and |ce difference|. The MoE configs' sharded dispatch is another
function than one device's `moe_apply` (per-shard capacity), so their
difference includes it; capacity factor 8 keeps every token."""
import argparse
import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import all_arch_names, get_reduced  # noqa: E402
from repro_torch.launch import mesh as TM  # noqa: E402
from repro_torch.launch import sharding as SH  # noqa: E402
from repro_torch.models import model as Md  # noqa: E402

F32 = dict(compute_dtype="float32", cache_dtype="float32")


def _inputs(cfg, rng, B, S):
    batch = {"tokens": torch.from_numpy(rng.randint(0, cfg.vocab, (B, S)))}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(
            rng.randn(B, cfg.n_memory, cfg.d_model).astype(np.float32))
    if cfg.family == "vlm":
        batch["memory"] = torch.from_numpy(
            rng.randn(B, cfg.n_memory, cfg.d_model).astype(np.float32))
    return batch


def _serve(cfg, params, batch, P):
    logits, cache = Md.prefill(cfg, params, batch, max_len=P + 4)
    outs = [logits]
    for t in range(3):
        logits, cache = Md.decode_step(cfg, params, cache, logits.argmax(-1), P + t)
        outs.append(logits)
    return torch.cat(outs, 1)


def parity(name, data, model, cf, B=4, P=8, S=16):
    mesh = TM.make_host_mesh(data=data, model=model, device="cpu")
    cfg = dataclasses.replace(get_reduced(name), **F32, moe_capacity_factor=cf)
    pcfg = cfg.with_policy(SH.policy_for(mesh))
    params = Md.init_params(cfg, 0, device="cpu")
    sharded = SH.ShardedLM.place(pcfg, mesh, params, SH.param_specs(
        pcfg, SH.ref_layout(params.tree()), mesh))
    rng = np.random.RandomState(0)
    serve = _inputs(cfg, rng, B, P)
    logits = float((_serve(pcfg, sharded, serve, P) - _serve(cfg, params, serve, P)).abs().max())
    train = _inputs(cfg, rng, B, S)
    if cfg.family == "encdec":
        train["frames"] = torch.from_numpy(rng.randn(B, S, cfg.d_model).astype(np.float32))
    train["labels"] = torch.from_numpy(rng.randint(0, cfg.vocab, (B, S)))
    train["mask"] = torch.ones(B, S)
    ce = abs(float(Md.forward_train(pcfg, sharded, train)[1]["ce"])
             - float(Md.forward_train(cfg, params, train)[1]["ce"]))
    return logits, ce


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="1,4", help="data,model")
    ap.add_argument("--cf", type=float, default=8.0, help="the MoE capacity factor")
    args = ap.parse_args(argv)
    data, model = (int(v) for v in args.mesh.split(","))
    torch.set_num_threads(4)
    for name in all_arch_names():
        logits, ce = parity(name, data, model, args.cf)
        print(f"{name} (data {data}, model {model}): logits max |diff| {logits:.3g}, "
              f"ce |diff| {ce:.3g}", flush=True)


if __name__ == "__main__":
    main()
