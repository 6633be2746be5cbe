"""Expression parser: strings → trees (Karoo's "customized seed
populations", §2.2), ported from `repro/core/parse.py`.

Accepts the grammar `trees.to_string` emits, so round-trips hold:

    expr    := '(' expr op expr ')' | name '(' expr [',' expr] ')'
             | feature | number
    op      := '+' | '-' | '*' | '/'
    feature := 'x' INT | any name in feature_names
    number  := integer/float present in the const table

Seeded trees are validated against the TreeSpec (depth ceiling, feature
count, const table membership; for postfix genomes the instruction count
and the operand-stack bound P5): a seed that cannot be represented raises
rather than being truncated. The parse runs on the host with numpy; the
seeded population goes to its device once.
"""
from __future__ import annotations

import re

import numpy as np
import torch

from repro_torch.core import primitives as prim
from repro_torch.core.trees import TreeSpec, generate_population

_SYM = {"+": "add", "-": "sub", "*": "mul", "/": "div"}
_TOKEN = re.compile(r"\s*([A-Za-z_]\w*|-?\d+\.?\d*|[(),+\-*/])")


def _tokenize(s: str):
    out, i = [], 0
    while i < len(s):
        m = _TOKEN.match(s, i)
        if not m:
            raise ValueError(f"bad token at ...{s[i:i+12]!r}")
        out.append(m.group(1))
        i = m.end()
    return out


class _Parser:
    def __init__(self, tokens, spec: TreeSpec, feature_names):
        self.t = tokens
        self.i = 0
        self.spec = spec
        self.names = list(feature_names or [])
        self.consts = spec.const_table_numpy()

    def peek(self):
        return self.t[self.i] if self.i < len(self.t) else None

    def eat(self, tok=None):
        cur = self.peek()
        if tok is not None and cur != tok:
            raise ValueError(f"expected {tok!r}, got {cur!r}")
        self.i += 1
        return cur

    def parse(self):
        node = self.expr()
        if self.peek() is not None:
            raise ValueError(f"trailing input: {self.t[self.i:]}")
        return node

    def expr(self):
        cur = self.peek()
        if cur == "(":
            self.eat("(")
            lhs = self.expr()
            op = self.eat()
            if op not in _SYM:
                raise ValueError(f"unknown operator {op!r}")
            rhs = self.expr()
            self.eat(")")
            return (prim.opcode_of(_SYM[op]), lhs, rhs)
        if re.fullmatch(r"-?\d+\.?\d*", cur or ""):
            self.eat()
            val = float(cur)
            idx = np.where(np.isclose(self.consts, val))[0]
            if len(idx) == 0:
                raise ValueError(f"constant {val} not in const table {self.consts}")
            return ("const", int(idx[0]))
        name = self.eat()
        if self.peek() == "(":  # function call
            if name not in prim.FN_NAMES:
                raise ValueError(f"unknown function {name!r}")
            self.eat("(")
            a = self.expr()
            b = None
            if self.peek() == ",":
                self.eat(",")
                b = self.expr()
            self.eat(")")
            code = prim.opcode_of(name)
            arity = prim.ARITY[code]
            if (b is None) != (arity == 1):
                raise ValueError(f"{name} expects arity {arity}")
            return (code, a, b)
        # terminal feature
        if name in self.names:
            return ("feat", self.names.index(name))
        m = re.fullmatch(r"x(\d+)", name)
        if m and int(m.group(1)) < self.spec.n_features:
            return ("feat", int(m.group(1)))
        raise ValueError(f"unknown terminal {name!r}")


def _fill(node, op, arg, idx, spec):
    if idx >= spec.num_nodes:
        raise ValueError(f"expression deeper than max_depth={spec.max_depth}")
    if node[0] == "feat":
        op[idx], arg[idx] = prim.FEATURE, node[1]
    elif node[0] == "const":
        op[idx], arg[idx] = prim.CONST, node[1]
    else:
        code, a, b = node
        op[idx] = code
        _fill(a, op, arg, 2 * idx + 1, spec)
        if b is not None:
            _fill(b, op, arg, 2 * idx + 2, spec)


def _emit_postfix(node, out):
    """Postorder walk → list of (op, arg) instructions. Postfix genomes are
    bounded by instruction count and operand-stack depth, not by the
    heap's depth ceiling, so deep-but-narrow expressions parse."""
    if node[0] == "feat":
        out.append((prim.FEATURE, node[1]))
    elif node[0] == "const":
        out.append((prim.CONST, node[1]))
    else:
        code, a, b = node
        _emit_postfix(a, out)
        if b is not None:
            _emit_postfix(b, out)
        out.append((code, 0))


def parse_tree(expr: str, spec: TreeSpec, feature_names=None):
    """One expression string → (op, arg) int32 numpy rows of length
    num_nodes, in the spec's genome form."""
    node = _Parser(_tokenize(expr), spec, feature_names).parse()
    op = np.zeros(spec.num_nodes, np.int32)
    arg = np.zeros(spec.num_nodes, np.int32)
    if spec.genome == "postfix":
        prog: list = []
        _emit_postfix(node, prog)
        if len(prog) > spec.num_nodes:
            raise ValueError(f"expression has {len(prog)} nodes; postfix "
                             f"genomes hold at most {spec.num_nodes}")
        depth = 0
        for code, _ in prog:
            depth += 1 - int(prim.ARITY[code])
            if depth > spec.stack_size:
                raise ValueError(
                    f"expression needs operand-stack depth {depth} > "
                    f"stack_size={spec.stack_size} (P5)")
        for t, (code, a) in enumerate(prog):
            op[t], arg[t] = code, a
        return op, arg
    _fill(node, op, arg, 0, spec)
    return op, arg


def seed_population(exprs, spec: TreeSpec, pop_size: int, key, feature_names=None,
                    device=None):
    """Seed the first len(exprs) slots with parsed trees and fill the rest
    with the ramped random population drawn from `key` (Karoo's
    seed-population semantics) -> (op, arg) int32[pop_size, N] on
    `device` (default: the key's). The random population is drawn on the
    host from the same key (the same bits as on the card), the seeds
    written into it there, and the result moved to `device` once."""
    if len(exprs) > pop_size:
        raise ValueError("more seeds than population slots")
    dev = key.device if device is None else torch.device(device)
    op, arg = generate_population(key.cpu(), pop_size, spec)
    op, arg = op.numpy().copy(), arg.numpy().copy()
    for i, e in enumerate(exprs):
        op[i], arg[i] = parse_tree(e, spec, feature_names)
    return torch.from_numpy(op).to(dev), torch.from_numpy(arg).to(dev)
