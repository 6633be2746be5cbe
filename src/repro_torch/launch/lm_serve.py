"""Serve a reduced LM: batched prefill + token-by-token greedy decode with
the KV/SSM cache (port of `examples/lm_serve.py`), on the card unless
`--device cpu` is given.

    PYTHONPATH=src python -m repro_torch.launch.lm_serve --arch mamba2-370m --tokens 24
    PYTHONPATH=src python -m repro_torch.launch.lm_serve --arch gemma-2b --device cpu

The weights are random, from seed 0 (the reference's distribution, not
its bits). The greedy token and the position stay on the device through
the loop; the continuations are read back once, at the end.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_reduced
from repro_torch.device import resolve_device
from repro_torch.models import model as Md


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_reduced(args.arch)
    params = Md.init_params(cfg, 0, device=dev)
    rng = np.random.RandomState(0)
    B, P = args.batch, args.prompt_len
    batch = {"tokens": torch.as_tensor(rng.randint(0, cfg.vocab, (B, P)), dtype=torch.int32,
                                       device=dev)}
    if cfg.family == "encdec":
        batch["frames"] = torch.zeros((B, cfg.n_memory, cfg.d_model), dtype=torch.bfloat16,
                                      device=dev)
    if cfg.family == "vlm":
        batch["memory"] = torch.zeros((B, cfg.n_memory, cfg.d_model), dtype=torch.bfloat16,
                                      device=dev)

    max_len = P + args.tokens + 1
    t0 = time.perf_counter()
    logits, cache = Md.prefill(cfg, params, batch, max_len=max_len)
    tok = logits.argmax(-1).to(torch.int32)
    decode = Md.make_serve_step(cfg)
    cur = torch.tensor(P, dtype=torch.int32, device=dev)
    out = [tok[:, 0]]
    for _ in range(args.tokens - 1):
        logits, cache = decode(params, cache, tok, cur)
        tok = logits.argmax(-1).to(torch.int32)
        out.append(tok[:, 0])
        cur = cur + 1
    seqs = torch.stack(out, 1).cpu().numpy()
    wall = time.perf_counter() - t0
    print(f"decoded {args.tokens} tokens x {B} seqs in {wall:.2f}s "
          f"({args.tokens*B/wall:.1f} tok/s incl. prefill) on {dev}")
    print("greedy continuations (token ids):")
    for row in seqs:
        print("  ", row[:12], "...")
    return seqs


if __name__ == "__main__":
    main()
