"""Layers that compute as the JAX package's flax layers do.

Parameters are fp32; each op casts its input and its parameters to the
compute dtype (as flax ``Dense``/``Conv`` with ``dtype=bf16`` do), so a
model is never converted with ``.to(torch.bfloat16)`` and never runs under
autocast.  Parameter names follow the flax tree (``weight`` for flax
``kernel``), so the weight converter maps one leaf to one parameter.
Convolutions run NCHW.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

Tensor = torch.Tensor


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(low, high) padding of a "SAME" conv as XLA computes it: the output
    has ceil(size / stride) positions and the odd pad goes at the high end.
    A stride-2 3×3 conv on an even size pads (0, 1), where torch's
    ``padding=1`` would pad (1, 1) and shift the sampling grid."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """2-D conv with "SAME" padding, fp32 weight (O, I/groups, kh, kw).

    With an activation scale (:meth:`set_act_scale`, from
    ``ops.quant.w8a8_model``) the conv runs the W8A8 route of
    ``ops/quant.py`` on the input as it arrives, not on its compute-dtype
    cast: int8 weights packed from the fp32 weight, packed again by an
    eager call (or :meth:`refresh_w8a8`) after the weight changed in place.
    That route is inference-only."""

    def __init__(self, cin: int, cout: int, kernel: int, *, stride: int = 1,
                 groups: int = 1, bias: bool = False,
                 dtype: torch.dtype = torch.bfloat16,
                 device: torch.device | str | None = None) -> None:
        super().__init__()
        self.ksize, self.stride, self.groups, self.dtype = (
            kernel, stride, groups, dtype)
        self.weight = nn.Parameter(torch.empty(
            (cout, cin // groups, kernel, kernel), device=device))
        self.bias = (nn.Parameter(torch.zeros(cout, device=device))
                     if bias else None)
        self.act_scale: float | None = None
        # The packed int8 weight and its dequantization scales: buffers, so
        # that they follow .to() and an exported program holds them.
        self.register_buffer("qweight", None, persistent=False)
        self.register_buffer("qdeq", None, persistent=False)
        self._qversion: int | None = None

    def set_act_scale(self, act_scale: float) -> None:
        """Run this conv W8A8 with input scale ``act_scale``."""
        if self.groups != 1:
            raise ValueError("a depthwise conv stays on the float route")
        self.act_scale = float(act_scale)
        self._qversion = None              # packed on the next refresh

    @torch.no_grad()
    def _pack(self) -> None:
        from gdkvm_tpu_torch.ops import quant
        with torch.inference_mode(False):
            self.qweight, self.qdeq = quant.pack_weight(self.weight, self.act_scale)
        self._qversion = self._weight_version()

    def _weight_version(self) -> int:
        """The weight's in-place version (an inference tensor, made under
        ``inference_mode``, has none: -1)."""
        return -1 if self.weight.is_inference() else self.weight._version

    def forward(self, x: Tensor) -> Tensor:
        if self.act_scale is not None:
            return self._forward_w8a8(x)
        ph = same_padding(x.shape[-2], self.ksize, self.stride)
        pw = same_padding(x.shape[-1], self.ksize, self.stride)
        x = F.pad(x.to(self.dtype), (*pw, *ph))
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x, self.weight.to(self.dtype), b, stride=self.stride,
                        groups=self.groups)

    def refresh_w8a8(self) -> None:
        """Re-pack the int8 weight if the fp32 weight changed in place since
        it was packed (an eager call does this itself; a trace cannot)."""
        if self.act_scale is not None and self._qversion != self._weight_version():
            self._pack()

    def _forward_w8a8(self, x: Tensor) -> Tensor:
        from gdkvm_tpu_torch.ops import quant
        if torch.is_grad_enabled() and self.weight.requires_grad:
            raise RuntimeError("the W8A8 route is inference-only: run it under "
                               "torch.no_grad() or torch.inference_mode()")
        if not torch.compiler.is_compiling():
            self.refresh_w8a8()
        return quant.int8_conv(x, self.qweight, self.qdeq, self.act_scale,
                               ksize=self.ksize, stride=self.stride,
                               bias=self.bias, out_dtype=self.dtype)


class Dense(nn.Module):
    """Linear layer over the last axis, fp32 weight (out, in)."""

    def __init__(self, cin: int, cout: int, *, bias: bool = True,
                 dtype: torch.dtype = torch.bfloat16,
                 device: torch.device | str | None = None) -> None:
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty((cout, cin), device=device))
        self.bias = (nn.Parameter(torch.zeros(cout, device=device))
                     if bias else None)

    def forward(self, x: Tensor) -> Tensor:
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), b)


class BareKernel(nn.Module):
    """A bare (in, out) fp32 matrix, the squeezed (1, 1, in, out) kernel of
    a flax 1×1 conv that the KPFF block folds in weight space."""

    def __init__(self, cin: int, cout: int,
                 device: torch.device | str | None = None) -> None:
        super().__init__()
        self.kernel = nn.Parameter(torch.empty((cin, cout), device=device))


class RMSNorm(nn.Module):
    """flax ``RMSNorm`` in fp32: ``x · (rsqrt(mean(x²) + ε) · scale)`` over
    the last axis, ε = 1e-6."""

    def __init__(self, dim: int, eps: float = 1e-6,
                 device: torch.device | str | None = None) -> None:
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x: Tensor) -> Tensor:
        x = x.to(torch.float32)
        var = (x * x).mean(-1, keepdim=True)
        return x * (torch.rsqrt(var + self.eps) * self.scale)
