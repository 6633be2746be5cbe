"""Primitive (opcode) table for tensorized GP trees, in PyTorch.

Port of `repro/core/primitives.py`. The population is data: every node
is an (opcode, argument) pair in a fixed-size heap tensor, and one
interpreter evaluates all trees at once.

Opcode space
------------
  0            EMPTY      unused slot (evaluates to 0.0, never selected)
  1            CONST      terminal: const_table[arg]
  2            FEATURE    terminal: X[arg]  (arg = feature column index)
  3..          functions  (see FUNCTIONS below; unary ops ignore rhs)

Division, log and sqrt are protected as in Karoo GP. `torch.minimum` /
`torch.maximum` propagate NaN, as `jnp.minimum` / `jnp.maximum` do.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

# --- opcode constants -------------------------------------------------------
EMPTY = 0
CONST = 1
FEATURE = 2
_FN_BASE = 3

_EPS = float(np.float32(1e-9))  # the reference's 1e-9, as the f32 it rounds to


def _protected_div(a, b):
    small = b.abs() < _EPS
    return torch.where(small, torch.ones_like(a),
                       a / torch.where(small, torch.ones_like(b), b))


def _protected_log(a, _):
    return torch.log(a.abs() + _EPS)


def _protected_sqrt(a, _):
    return torch.sqrt(a.abs())


@dataclasses.dataclass(frozen=True)
class Primitive:
    name: str
    arity: int  # 1 or 2
    fn: Callable  # (lhs, rhs) -> value; unary ops ignore rhs


# Order matters: opcode = _FN_BASE + index into FUNCTIONS.
FUNCTIONS: tuple[Primitive, ...] = (
    Primitive("add", 2, lambda a, b: a + b),
    Primitive("sub", 2, lambda a, b: a - b),
    Primitive("mul", 2, lambda a, b: a * b),
    Primitive("div", 2, _protected_div),
    Primitive("neg", 1, lambda a, _: -a),
    Primitive("abs", 1, lambda a, _: a.abs()),
    Primitive("sin", 1, lambda a, _: torch.sin(a)),
    Primitive("cos", 1, lambda a, _: torch.cos(a)),
    Primitive("sqrt", 1, _protected_sqrt),
    Primitive("log", 1, _protected_log),
    Primitive("square", 1, lambda a, _: a * a),
    Primitive("min", 2, torch.minimum),
    Primitive("max", 2, torch.maximum),
)

N_OPCODES = _FN_BASE + len(FUNCTIONS)
FN_NAMES = tuple(p.name for p in FUNCTIONS)
ARITY = np.array([0, 0, 0] + [p.arity for p in FUNCTIONS], dtype=np.int32)


def opcode_of(name: str) -> int:
    return _FN_BASE + FN_NAMES.index(name)


@dataclasses.dataclass(frozen=True)
class FunctionSet:
    """A user-selected subset of FUNCTIONS, as opcode arrays."""

    opcodes: np.ndarray  # int32[num_fns] opcodes drawn from FUNCTIONS
    name: str = "custom"

    @staticmethod
    def make(names: Sequence[str], name: str = "custom") -> "FunctionSet":
        return FunctionSet(np.array([opcode_of(n) for n in names], dtype=np.int32), name)

    @property
    def binary_opcodes(self) -> np.ndarray:
        return self.opcodes[ARITY[self.opcodes] == 2]

    @property
    def unary_opcodes(self) -> np.ndarray:
        return self.opcodes[ARITY[self.opcodes] == 1]

    @property
    def mask(self) -> int:
        """Bit c set for every opcode c in the set (the CUDA kernel's
        form of the select chain)."""
        return int(sum(1 << int(c) for c in set(self.opcodes.tolist())))


ARITHMETIC = FunctionSet.make(("add", "sub", "mul", "div"), "arithmetic")
KITCHEN_SINK = FunctionSet.make(FN_NAMES, "kitchen_sink")
CLASSIFY_SET = FunctionSet.make(("add", "sub", "mul", "div", "abs", "min", "max"), "classify")


def apply_function(op, lhs, rhs, fn_set: "FunctionSet | None" = None):
    """Elementwise select over function opcodes.

    op:        int tensor broadcastable against lhs/rhs
    lhs, rhs:  float tensors (children values)
    fn_set:    restrict the select chain to a run's operator set

    Computes each candidate primitive, then selects; an opcode outside
    the set evaluates to 0.0, as the reference's `jnp.select` default.
    """
    if fn_set is not None:
        codes = [int(c) for c in fn_set.opcodes]
    else:
        codes = list(range(_FN_BASE, _FN_BASE + len(FUNCTIONS)))
    out = torch.zeros_like(lhs)
    for c in reversed(codes):  # first matching code wins, as in jnp.select
        out = torch.where(op == c, FUNCTIONS[c - _FN_BASE].fn(lhs, rhs), out)
    return out
