"""Predictable-Scale calculator: optimal batch size & learning rate.

A copy of gdkvm_tpu/utils/scaling.py (pure Python; the port imports nothing
of the JAX package).  The documented scaling-law formulas, with liberal
numeric input parsing, as a library and the ``scale`` command:

    bs(D)    = 0.58 · D^0.571
    lr(N, D) = 1.79 · N^−0.713 · D^0.307

with N = model parameters, D = training tokens (both counts).  The batch
size is token-wise; divide by sequence length for a sequence-wise batch.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Union

Number = Union[int, float, str]


_NUM_RE = re.compile(r"[+-]?(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?")


def _parse_expr(s: str, pos: int = 0):
    """Tiny recursive-descent parser for products/powers of numbers.

    Grammar (all arithmetic in float — ``math.pow`` saturates to inf
    instead of building astronomically large ints, so hostile inputs like
    ``9**9**9`` return inf and are rejected by the finiteness check, never
    hung on):

        expr   := factor (('*' | '/') factor)*
        factor := atom ('**' factor)?          (right-assoc power)
        atom   := NUMBER | '(' expr ')'
    """
    def skip_ws(p):
        while p < len(s) and s[p] == " ":
            p += 1
        return p

    def atom(p):
        p = skip_ws(p)
        if p < len(s) and s[p] == "(":
            val, p = expr(p + 1)
            p = skip_ws(p)
            if p >= len(s) or s[p] != ")":
                raise ValueError("unbalanced parenthesis")
            return val, p + 1
        m = _NUM_RE.match(s, p)
        if not m:
            raise ValueError(f"expected a number at position {p}")
        return float(m.group()), m.end()

    def factor(p):
        base, p = atom(p)
        p = skip_ws(p)
        if s.startswith("**", p):
            exp, p = factor(p + 2)
            return math.pow(base, exp), p
        return base, p

    def expr(p):
        val, p = factor(p)
        while True:
            p = skip_ws(p)
            if p < len(s) and s[p] == "*" and not s.startswith("**", p):
                rhs, p = factor(p + 1)
                val *= rhs
            elif p < len(s) and s[p] == "/":
                rhs, p = factor(p + 1)
                val /= rhs
            else:
                return val, p

    val, end = expr(pos)
    if skip_ws(end) != len(s):
        raise ValueError(f"trailing input at position {end}")
    return val


def parse_count(value: Number) -> float:
    """Parse liberal numeric notations: 1e8, 3.5×10^6, 2*10^7, 1_000_000.

    Uses a closed arithmetic grammar (numbers, ``*``, ``/``, ``**``,
    parens) evaluated in float — no ``eval``, no unbounded integer powers.
    """
    if isinstance(value, (int, float)):
        out = float(value)
    else:
        s = value.strip().replace(",", "").replace("_", "")
        s = s.replace("×", "*").replace("x", "*").replace("X", "*")
        s = s.replace("^", "**")
        try:
            out = float(_parse_expr(s))
        except (ValueError, ZeroDivisionError, OverflowError) as exc:
            raise ValueError(f"cannot parse numeric input {value!r}") from exc
    if not math.isfinite(out) or out <= 0:
        raise ValueError(f"value must be a positive finite number, "
                         f"got {value!r}")
    return out


def optimal_bs_lr(model_params: Number, tokens: Number) -> Dict[str, float]:
    """Token-wise optimal batch size and learning rate (documented laws)."""
    n = parse_count(model_params)
    d = parse_count(tokens)
    log_bs = math.log(0.58) + 0.571 * math.log(d)
    log_lr = math.log(1.79) - 0.713 * math.log(n) + 0.307 * math.log(d)
    return {
        "batch_size_tokens": math.exp(log_bs),
        "learning_rate": math.exp(log_lr),
        "model_params": n,
        "tokens": d,
    }
