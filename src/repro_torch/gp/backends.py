"""EvalBackend registry — the paper's platform axis as pluggable objects.

Port of `repro/gp/backends.py`. Each platform is an `EvalBackend`
registered by name:

    torch    the plain tensor level sweep + fitness (the oracle; runs on
             the CPU and on the card)
    cuda     the hand-written fused eval+fitness kernel
             (kernels/csrc/gp_eval.cu) — the card's path

`auto` picks `cuda` when the session's device is a CUDA device and
`torch` otherwise. The reference's `scalar` baseline is not ported yet
(ROADMAP queue A: the scalar backend with core/scalar_eval.py).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class EvalBackend:
    """One evaluation platform.

    evaluate: (op[P,N], arg[P,N], X[F,D], const_table[C], tree_spec) -> preds[P,D]
    fitness:  (op, arg, X, y, const_table, tree_spec, fit_spec,
               weight=None, data_tile=...) -> f32[P]
    """

    name: str
    evaluate: Callable
    fitness: Callable
    fused_fitness: bool = False  # evaluation+reduction in one kernel
    description: str = ""


_REGISTRY: dict[str, EvalBackend] = {}
_NOT_PORTED = {"scalar": "the scalar backend with core/scalar_eval.py"}


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
        if name in _NOT_PORTED:
            raise NotImplementedError(f"backend {name!r} is not ported yet (ROADMAP "
                                      f"queue A: {_NOT_PORTED[name]})") from None
        raise ValueError(f"unknown eval backend {name!r}; registered: "
                         f"{available_backends()}") from None


def available_backends() -> list[str]:
    return sorted(_REGISTRY)


def auto_select(device=None) -> str:
    """`cuda` (the hand-written kernel) when the device is a CUDA device,
    `torch` otherwise."""
    dev = torch.device("cuda" if device is None else device)
    return "cuda" if dev.type == "cuda" else "torch"


# --- built-in backends --------------------------------------------------------


def _evaluate(op, arg, X, const_table, tree_spec):
    from repro_torch.core.eval import evaluate_population

    return evaluate_population(op, arg, X, const_table, tree_spec)


def _fitness(impl):
    def fn(op, arg, X, y, const_table, tree_spec, fit_spec, weight=None,
           data_tile=1024):
        from repro_torch.kernels import ops

        return ops.fitness(op, arg, X, y, const_table, tree_spec, fit_spec,
                           weight=weight, data_tile=data_tile, impl=impl,
                           device=op.device)
    return fn


register_backend(EvalBackend(
    name="torch", evaluate=_evaluate, fitness=_fitness("torch"),
    description="plain tensor level sweep + fitness (the oracle)"))
register_backend(EvalBackend(
    name="cuda", evaluate=_evaluate, fitness=_fitness("cuda"),
    fused_fitness=True,
    description="hand-written fused eval+fitness CUDA kernel (sm_90a)"))
