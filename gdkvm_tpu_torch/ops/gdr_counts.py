"""Operation counts of the GDR scan's functions, from their shapes.

A count is the function's products, not a design's own work.  With
``exact`` given (True when q and k are bf16, hence exact in TF32) the
products are counted in TF32 passes at the card's fp32-accurate rate,
whatever unit a design runs them on: a product of fp32 operands is three
passes (3xTF32, ``csrc/gdr_mma.cuh``), one fewer for each operand exact in
TF32, so A = ηKKᵀ of bf16 K is one.  With ``exact=None`` every product
counts once: plain FLOPs (2 a multiply-add), for a FLOP/s figure beside
``torch.utils.flop_counter``'s, which cannot see a kernel launched through
ctypes.

Shapes as everywhere: B, H, T frames, N tokens a frame, d_k, d_v.
"""

from __future__ import annotations

from typing import Optional


def passes(exact_a: bool, exact_b: bool, exact: Optional[bool] = True) -> int:
    """TF32 passes of one product by its operands' exactness (1 under
    ``exact=None``: plain FLOPs)."""
    return 1 if exact is None else 3 - exact_a - exact_b


def solve_ops(b: int, h: int, t: int, n: int, dk: int, dv: int,
              exact: Optional[bool]) -> int:
    """The WY solve of every frame: A (N(N-1)/2 entries of 2 d_k; K exact
    when bf16) and the substitution (N(N-1)/2 entries times d_v + d_k
    columns, 2 each; fp32 operands).  A design's own work (the 16 × 16
    inverses) is not counted."""
    e = bool(exact)
    a, subst = b * h * t * n * (n - 1) * dk, b * h * t * n * (n - 1) * (dk + dv)
    return a * passes(e, e, exact) + subst * passes(False, False, exact)


def chain_ops(b: int, h: int, t: int, n: int, dk: int, dv: int,
              exact: Optional[bool]) -> int:
    """Q S̃, W S̃ and Kᵀ M of every frame (2 N d_k d_v each): Q and K exact
    when bf16, W, S̃ and M fp32."""
    e = bool(exact)
    one = 2 * b * h * t * n * dk * dv
    return one * (2 * passes(e, False, exact) + passes(False, False, exact))


def fwd_ops(b: int, h: int, t: int, n: int, dk: int, dv: int,
            exact: Optional[bool]) -> int:
    """The forward: every frame's solve, then the chain."""
    return solve_ops(b, h, t, n, dk, dv, exact) + chain_ops(b, h, t, n, dk, dv, exact)


def bwd_ops(b: int, h: int, t: int, n: int, dk: int, dv: int,
            exact: Optional[bool]) -> int:
    """The backward recomputing each frame's solve: the WY solve as
    :func:`solve_ops`; the transposed solve and dA = stril(Y Xᵀ) (N(N-1)
    times d_v + d_k each, fp32 operands), dA K (K exact when bf16) and
    dAᵀ(ηK) (N(N-1) d_k each), and seven N × d_k × d_v products: K g and
    Qᵀ dO (K, Q exact when bf16), dO S̃ᵀ, W S̃, (K g) S̃ᵀ, Wᵀ(K g) and M gᵀ.
    What a design repeats (A's blocks, K g, S̃ gᵀ in the adjoint) is its
    own work, not counted."""
    e = bool(exact)
    full = passes(False, False, exact)
    frames, nn = b * h * t, n * (n - 1)
    return solve_ops(b, h, t, n, dk, dv, exact) + frames * (
        nn * (2 * full * (dk + dv) + dk * (passes(False, e, exact) + full))
        + 2 * n * dk * dv * (2 * passes(e, False, exact) + 5 * full))
