"""FLOPs of a call of the model, the same whichever GDR route runs.

``torch.utils.flop_counter.FlopCounterMode`` counts the matrix products and
convolutions it sees, 2 a multiply-add.  It cannot see a kernel launched
through ctypes, and on the CPU it sees the plain GDR's own products, which
differ from route to route (``chunked``, ``ref``, ``assoc``).  So while
:func:`count_flops` runs, every GDR scan an LKVA module calls is hidden from
the counter and counted once from its shape by ``ops/gdr_counts.py`` (plain
FLOPs, ``exact=None``): the forward each call, and the backward each call
whose gradient is taken.  W8A8's int8 products (``aten._int_mm``, for which
the counter has no formula) count as the products they are, padding
included, so a quantized model's convolutions stay in the count.

The scan is reached through ``models/lkva.py::GDR_TAP``, a context variable:
a count sees the calls made in its own thread and context, not those of
other threads (a serving engine's, say).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch
from torch.utils.flop_counter import FlopCounterMode

from gdkvm_tpu_torch.models import lkva
from gdkvm_tpu_torch.ops import gdr_counts

Tensor = torch.Tensor


def _int_mm_flops(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    """(M, K) × (K, N): 2 M K N, as ``aten.mm``."""
    return 2 * a_shape[0] * a_shape[1] * b_shape[1]


class _Tally:
    """The counter, the products it saw inside the scans (to take away) and
    the scans' own counts by shape."""

    def __init__(self, counter: FlopCounterMode) -> None:
        self.counter, self.hidden, self.gdr = counter, 0, 0

    @contextlib.contextmanager
    def unseen(self):
        """What the counter counts in this block is taken away again."""
        before = self.counter.get_total_flops()
        try:
            yield
        finally:
            self.hidden += self.counter.get_total_flops() - before

    def scan(self, impl: Callable, q: Tensor, k: Tensor, v: Tensor, beta: Tensor,
             alpha: Tensor, s0: Tensor, eta: Optional[Tensor] = None):
        """``impl``'s call, counted by its shape (B, H, T, N, d_k, d_v)."""
        shape = (*q.shape[:4], q.shape[-1], v.shape[-1])
        self.gdr += gdr_counts.fwd_ops(*shape, None)
        xs = (q, k, v, beta, alpha, s0, eta)
        if torch.is_grad_enabled() and any(x is not None and x.requires_grad for x in xs):
            return _Hidden.apply(self, impl, shape, *xs)
        with self.unseen():
            return impl(*xs)

    def total(self) -> int:
        return self.counter.get_total_flops() - self.hidden + self.gdr


class _Hidden(torch.autograd.Function):
    """A scan under a gradient: its forward and backward hidden from the
    counter, the backward counted by shape."""

    @staticmethod
    def forward(ctx, tally, impl, shape, *xs):
        ctx.tally, ctx.shape = tally, shape
        with torch.enable_grad(), tally.unseen():
            ctx.ins = [None if x is None else x.detach().requires_grad_(need)
                       for x, need in zip(xs, ctx.needs_input_grad[3:])]
            ctx.outs = impl(*ctx.ins)
        return tuple(o.detach() for o in ctx.outs)

    @staticmethod
    def backward(ctx, *grads):
        wrt = [x for x in ctx.ins if x is not None and x.requires_grad]
        with ctx.tally.unseen():
            got = iter(torch.autograd.grad(ctx.outs, wrt, grads, allow_unused=True))
        ctx.tally.gdr += gdr_counts.bwd_ops(*ctx.shape, None)
        return (None, None, None) + tuple(
            next(got) if x is not None and x.requires_grad else None for x in ctx.ins)


def count_flops(fn: Callable[[], object]) -> int:
    """FLOPs of one call of ``fn()``: every matrix product and convolution
    outside the GDR as ``FlopCounterMode`` counts it, plus each GDR scan's
    count from its shape (forward, and backward where its gradient is
    taken).  ``fn()`` runs once."""
    with FlopCounterMode(display=False,
                         custom_mapping={torch.ops.aten._int_mm: _int_mm_flops}) as counter:
        tally = _Tally(counter)
        token = lkva.GDR_TAP.set(tally.scan)
        try:
            fn()
        finally:
            lkva.GDR_TAP.reset(token)
    return tally.total()
