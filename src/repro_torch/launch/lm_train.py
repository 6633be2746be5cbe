"""Train a reduced-config LM from the model zoo, end to end: train step,
checkpoint/resume, straggler monitor (port of `examples/lm_train.py`), on
the card unless `--device cpu` is given.

    PYTHONPATH=src python -m repro_torch.launch.lm_train --arch gemma-2b --steps 60

Any of the 10 architectures whose batches are tokens alone works (--arch
qwen3-moe-30b-a3b, mamba2-370m, jamba-1.5-large-398b, ...); reduced
configs keep it CPU-friendly while running the production code path
(`launch/train.py` drives full configs that fit one card).
"""
from __future__ import annotations

import argparse
import dataclasses
import tempfile

from repro_torch.configs import get_reduced
from repro_torch.launch.train import train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)
    cfg = get_reduced(args.arch)
    if cfg.accum_steps > 1 and args.batch % cfg.accum_steps:
        cfg = dataclasses.replace(cfg, accum_steps=1)
    with tempfile.TemporaryDirectory() as ckpt:
        _, history, monitor = train(cfg, steps=args.steps, batch=args.batch,
                                    seq=args.seq, ckpt_dir=ckpt, ckpt_every=25,
                                    device=args.device)
    print(f"loss: {history[0]:.3f} -> {history[-1]:.3f} over {args.steps} steps")
    assert history[-1] < history[0], "loss should fall on the synthetic stream"
    return history


if __name__ == "__main__":
    main()
