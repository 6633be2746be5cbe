"""Build the port's CUDA sources into shared libraries and load them.

Each `csrc/<name>.cu` has a plain C interface and is compiled by `nvcc`
(no PyTorch headers, so a build takes seconds) for Hopper:

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false -std=c++17 \
         -shared -Xcompiler -fPIC -Xptxas -v -o lib<name>.so csrc/<name>.cu

`-fmad=false` keeps every f32 multiply and add separately rounded, as
the reference's per-node operations are. The library goes under
`build/repro_torch/` at the repository root (or `$REPRO_TORCH_BUILD_DIR`),
named by a hash of its source and flags, and is loaded with `ctypes` at
first use. Nothing here runs at import time: importing the package never
needs `nvcc`.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-fmad=false",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_INFO: dict[str, dict] = {}  # name -> {"seconds", "ptxas", "path"}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                           "with the CUDA toolkit (set CUDA_HOME)")
    return found


def _compile(name: str) -> Path:
    """The library of `csrc/<name>.cu`, compiled unless already built; the
    processes of one launch build it once, under a file lock."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    lib = build_dir() / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if lib.exists():
        BUILD_INFO[name] = {"seconds": 0.0, "ptxas": "", "path": str(lib)}
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    with open(lib.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists():  # another process built it meanwhile
            BUILD_INFO[name] = {"seconds": 0.0, "ptxas": "", "path": str(lib)}
            return lib
        return _nvcc(name, src, lib)


def _nvcc(name: str, src: Path, lib: Path) -> Path:
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{proc.stdout}")
    os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    BUILD_INFO[name] = {"seconds": time.perf_counter() - t0, "ptxas": proc.stdout,
                        "path": str(lib)}
    return lib


def load(name: str) -> ctypes.CDLL:
    """The built library for `csrc/<name>.cu`, compiling it on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = _LIBS[name] = ctypes.CDLL(str(_compile(name)))
    return lib
