"""B4 with its tile's slices staged in shared memory (`staging.cu`: one bulk
copy per array on an mbarrier, or 16-byte cp.async by every thread) against
the package's B4, which loads each thread's points directly, in one process
on one card:

    python3 tools/gather_staging/run.py

At chip_smoke.py's kat7, ligo and large shapes (its tile pick; kepler's D
is not a multiple of 4), kernels c and r, without and with a weight, each
variant is first held bitwise against the package's B4, then timed with
chip_smoke.py's `device_ms` (torch.profiler) in the order direct, bulk,
cp.async, cp.async, bulk, direct. Prints the card, then one JSON line per
case. Needs a CUDA device and nvcc."""
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
import chip_smoke as cs  # noqa: E402  (exits without a card)
from repro_torch.core import fitness  # noqa: E402
from repro_torch.kernels import build, gp_eval, ops  # noqa: E402

SHAPES = [s for s in cs.SHAPES if s[3] % 4 == 0]


def load():
    here = Path(__file__).resolve().parent
    lib = build.build_dir() / "libgather_staging.so"
    lib.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                           str(here / "staging.cu")], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for staging.cu:\n{proc.stdout}{proc.stderr}")
    so = ctypes.CDLL(str(lib))
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    so.gp_staged_preds.argtypes = [i, vp, i, i, vp, vp, i, f, f, i, vp, vp, vp, vp]
    so.gp_staged_preds.restype = ctypes.c_int
    return so


def main():
    so = load()
    print(cs.card_line(), flush=True)
    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    for name, P, F, D in SHAPES:
        _, tile = ops.pick_tiles(F, 63, P, D)
        preds = torch.from_numpy(rng.randn(P, D).astype(np.float32)).to(dev)
        y = torch.from_numpy((rng.rand(D) > 0.5).astype(np.float32)).to(dev)
        weight = torch.from_numpy(rng.choice(np.float32([0, .25, .5, 1]), D)).to(dev)
        tiles = -(-D // tile)
        for kname in ("c", "r"):
            for w in (None, weight):
                fk = dict(kernel=kname, n_classes=2, data_tile=tile)
                want = gp_eval.eval_fitness_from_preds(preds, y, w, **fk)
                partial = torch.empty(P * tiles, device=dev)
                tickets = torch.zeros(P, dtype=torch.int32, device=dev)
                out = torch.empty(P, 1, device=dev)

                def staged(bulk):
                    err = so.gp_staged_preds(
                        bulk, preds.data_ptr(), P, D, y.data_ptr(),
                        None if w is None else w.data_ptr(),
                        fitness.get_kernel(kname).device_id, 1.0, float(np.float32(1e-4)),
                        tile, partial.data_ptr(), tickets.data_ptr(),
                        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
                    if err:
                        raise RuntimeError(f"gp_staged_preds: CUDA error {err}")
                    return out

                fns = {"direct": lambda: gp_eval.eval_fitness_from_preds(preds, y, w, **fk),
                       "bulk": lambda: staged(1), "cp_async": lambda: staged(0)}
                for label in ("bulk", "cp_async"):
                    cs._same_bits(fns[label](), want, f"{name} {kname} {label}")
                times = {k: [] for k in fns}
                for label in ("direct", "bulk", "cp_async", "cp_async", "bulk", "direct"):
                    times[label].append(cs.device_ms(fns[label], calls=50)["device_ms"])
                print(json.dumps(dict(shape=name, P=P, D=D, tile=tile, kernel=kname,
                                      weighted=w is not None, device_ms=times,
                                      bound_ms=cs._gather_bound_ms(P, D, P)[0])), flush=True)


if __name__ == "__main__":
    main()
