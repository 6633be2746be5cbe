"""EvalBackend registry — the paper's platform axis as pluggable objects.

Port of `repro/gp/backends.py`. Each platform is an `EvalBackend`
registered by name:

    scalar   the paper-faithful per-data-point interpreter (1-CPU_SP,
             core/scalar_eval.py) — host-only, the baseline every
             speedup figure divides by; asked for by name, never by auto
    torch    the plain tensor level sweep + fitness (the oracle; runs on
             the CPU and on the card)
    cuda     the hand-written fused eval+fitness kernel
             (kernels/csrc/gp_eval.cu) — the card's path

`auto` picks `cuda` when the session's device is a CUDA device and
`torch` otherwise. Host-only backends (`jittable=False`) and streamed
datasets run through `GPSession`'s host generation loop, one generation
at a time: `GPSession(backend="scalar", device="cpu").fit(X, y)`, or
`GPSession(chunk_rows=...)` on any backend. The scalar backend reads the
population and the dataset back from the session's device (X as [D, F]
rows) and returns the fitness there, so breeding stays on that device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class EvalBackend:
    """One evaluation platform.

    evaluate: (op[P,N], arg[P,N], X[F,D], const_table[C], tree_spec) -> preds[P,D]
    fitness:  (op, arg, X, y, const_table, tree_spec, fit_spec,
               weight=None, data_tile=..., dedup="off", dedup_cap=0) -> f32[P]
    moments:  same signature as fitness -> f32[P, M], phase 1 of the
              two-pass fitness protocol (summed over this backend's tiles
              but not finalized)
    stream_moments: (acc[P, M], op, arg, X, y, const_table, tree_spec,
              fit_spec, weight=None, data_tile=...) -> f32[P, M], one
              streaming fold step: this chunk's moments merged into the
              accumulator by the kernel's merge. None = cannot stream.

    `weight` is an optional f32[D] dataset-padding mask (0.0 on padded
    points). `jittable` backends run inside the engine's device
    generation step (`evolve_block`); host-only ones are driven by
    GPSession's host generation loop. `supports_topology` says whether a
    mesh could shard the backend (the mesh is not ported yet).

    `dedup`/`dedup_cap` engage the exact-tier subexpression dedup on
    postfix genomes (bitwise the same fitness); a backend whose fitness
    takes no such arguments simply never dedups.
    """

    name: str
    evaluate: Callable
    fitness: Callable
    moments: Callable = None
    stream_moments: Callable = None
    jittable: bool = True
    supports_topology: bool = True
    fused_fitness: bool = False  # evaluation+reduction in one kernel
    description: str = ""

    def capabilities(self) -> dict:
        return {"name": self.name, "jittable": self.jittable,
                "supports_topology": self.supports_topology,
                "fused_fitness": self.fused_fitness,
                "description": self.description}


_REGISTRY: dict[str, EvalBackend] = {}


def register_backend(backend: EvalBackend, *, overwrite: bool = False) -> EvalBackend:
    if backend.name in _REGISTRY and not overwrite:
        raise ValueError(f"eval backend {backend.name!r} already registered "
                         f"(pass overwrite=True to replace)")
    _REGISTRY[backend.name] = backend
    return backend


def get_backend(name: str, device=None) -> EvalBackend:
    if name == "auto":
        return _REGISTRY[auto_select(device)]
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown eval backend {name!r}; registered: "
                         f"{available_backends()}") from None


def available_backends() -> list[str]:
    return sorted(_REGISTRY)


def auto_select(device=None) -> str:
    """`cuda` (the hand-written kernel) when the device is a CUDA device,
    `torch` otherwise. `scalar` is never auto-selected: it exists to be
    measured against."""
    dev = torch.device("cuda" if device is None else device)
    return "cuda" if dev.type == "cuda" else "torch"


# --- built-in backends --------------------------------------------------------


def _evaluate(op, arg, X, const_table, tree_spec):
    from repro_torch.core.eval import evaluate_population

    return evaluate_population(op, arg, X, const_table, tree_spec)


def _fitness(impl):
    def fn(op, arg, X, y, const_table, tree_spec, fit_spec, weight=None,
           data_tile=1024, dedup="off", dedup_cap=0):
        from repro_torch.kernels import ops

        return ops.fitness(op, arg, X, y, const_table, tree_spec, fit_spec,
                           weight=weight, data_tile=data_tile, impl=impl,
                           device=op.device, dedup=dedup, dedup_cap=dedup_cap)
    return fn


def _moments(impl):
    def fn(op, arg, X, y, const_table, tree_spec, fit_spec, weight=None,
           data_tile=1024, dedup="off", dedup_cap=0):
        from repro_torch.kernels import ops

        return ops.moments(op, arg, X, y, const_table, tree_spec, fit_spec,
                           weight=weight, data_tile=data_tile, impl=impl,
                           device=op.device, dedup=dedup, dedup_cap=dedup_cap)
    return fn


def _stream_moments(impl):
    def fn(acc, op, arg, X, y, const_table, tree_spec, fit_spec, weight=None,
           data_tile=1024, dedup="off", dedup_cap=0):
        from repro_torch.kernels import ops

        return ops.stream_moments(acc, op, arg, X, y, const_table, tree_spec, fit_spec,
                                  weight=weight, data_tile=data_tile, impl=impl,
                                  device=op.device, dedup=dedup, dedup_cap=dedup_cap)
    return fn


def _host(t):
    return None if t is None else t.cpu().numpy()


def _scalar_preds(op, arg, X, const_table, tree_spec) -> np.ndarray:
    from repro_torch.core.scalar_eval import evaluate_population_scalar

    X_rows = np.ascontiguousarray(np.asarray(_host(X), np.float32).T)  # [F,D] -> [D,F]
    return evaluate_population_scalar(_host(op), _host(arg), X_rows, _host(const_table),
                                      genome=tree_spec.genome)


def _scalar_evaluate(op, arg, X, const_table, tree_spec):
    return torch.from_numpy(_scalar_preds(op, arg, X, const_table, tree_spec)).to(op.device)


def _scalar_fitness(op, arg, X, y, const_table, tree_spec, fit_spec, weight=None,
                    data_tile=1024, dedup="off", dedup_cap=0):
    # dedup ignored: the scalar baseline exists to be measured against,
    # and the exact tier is bitwise-identical by contract anyway
    from repro_torch.core.scalar_eval import fitness_scalar

    X_rows = np.ascontiguousarray(np.asarray(_host(X), np.float32).T)
    out = fitness_scalar(_host(op), _host(arg), X_rows, _host(y), _host(const_table),
                         kernel=fit_spec.kernel, n_classes=fit_spec.n_classes,
                         precision=fit_spec.precision, weight=_host(weight),
                         genome=tree_spec.genome)
    return torch.from_numpy(out).to(op.device)


def _scalar_moments(op, arg, X, y, const_table, tree_spec, fit_spec, weight=None,
                    data_tile=1024, dedup="off", dedup_cap=0):
    # host-only: the moment pass exists so that the streaming fold and
    # host-side tools reach every backend through one contract
    from repro_torch.core.fitness import moments_from_preds

    preds = torch.from_numpy(_scalar_preds(op, arg, X, const_table, tree_spec))
    w = None if weight is None else torch.from_numpy(np.asarray(_host(weight), np.float32))
    m = moments_from_preds(preds, torch.from_numpy(np.asarray(_host(y), np.float32)),
                           fit_spec, weight=w)
    return m.to(op.device)


def _scalar_stream_moments(acc, op, arg, X, y, const_table, tree_spec, fit_spec,
                           weight=None, data_tile=1024, dedup="off", dedup_cap=0):
    # host fold: scalar evaluation of the chunk, then the kernel's merge —
    # the streaming contract holds on the paper-faithful baseline too
    from repro_torch.core.fitness import get_kernel

    m = _scalar_moments(op, arg, X, y, const_table, tree_spec, fit_spec, weight=weight)
    return get_kernel(fit_spec.kernel).merge_moments(acc, m, fit_spec)


register_backend(EvalBackend(
    name="torch", evaluate=_evaluate, fitness=_fitness("torch"),
    moments=_moments("torch"), stream_moments=_stream_moments("torch"),
    description="plain tensor level sweep + fitness (the oracle)"))
register_backend(EvalBackend(
    name="cuda", evaluate=_evaluate, fitness=_fitness("cuda"),
    moments=_moments("cuda"), stream_moments=_stream_moments("cuda"),
    fused_fitness=True,
    description="hand-written fused eval+fitness CUDA kernels (sm_90a)"))
register_backend(EvalBackend(
    name="scalar", evaluate=_scalar_evaluate, fitness=_scalar_fitness,
    moments=_scalar_moments, stream_moments=_scalar_stream_moments,
    jittable=False, supports_topology=False,
    description="paper-faithful per-data-point interpreter (1-CPU_SP)"))
