"""GroupNorm with the JAX package's math (gdkvm_tpu/ops/norms.py).

Statistics in fp32, variance as E[x²] − E[x]² clamped at 0, ε inside the
rsqrt, and the affine folded into one ``x·a + b`` pass in fp32.  The result
is cast back to the input's dtype.
"""

from __future__ import annotations

import torch
from torch import nn

Tensor = torch.Tensor


def group_norm(x: Tensor, scale: Tensor, bias: Tensor, num_groups: int,
               eps: float = 1e-6) -> Tensor:
    """GroupNorm over a channel-first map x (B, C, *spatial), with at least
    one spatial dim; scale, bias (C,).  Statistics reduce over the group's
    channels and all spatial positions, per batch element."""
    b, c = x.shape[:2]
    gs = c // num_groups
    red = tuple(range(2, x.dim()))
    n_el = gs
    for i in red:
        n_el *= x.shape[i]
    xf = x.to(torch.float32)
    s1 = xf.sum(red)
    s2 = (xf * xf).sum(red)
    m = s1.reshape(b, num_groups, gs).sum(-1) / n_el
    m2 = s2.reshape(b, num_groups, gs).sum(-1) / n_el
    inv = torch.rsqrt(torch.clamp(m2 - m * m, min=0.0) + eps)
    a = inv.repeat_interleave(gs, dim=-1) * scale.to(torch.float32)[None]
    off = bias.to(torch.float32)[None] - m.repeat_interleave(gs, dim=-1) * a
    bshape = (b, c) + (1,) * len(red)
    return (xf * a.reshape(bshape) + off.reshape(bshape)).to(x.dtype)


class GroupNorm(nn.Module):
    """GroupNorm with fp32 ``scale`` (ones) and ``bias`` (zeros) of shape
    (C,), the JAX package's parameter names."""

    def __init__(self, channels: int, num_groups: int, eps: float = 1e-6,
                 device: torch.device | str | None = None) -> None:
        super().__init__()
        if channels % num_groups:
            raise ValueError(f"channels {channels} not divisible by "
                             f"num_groups {num_groups}")
        self.num_groups = num_groups
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x: Tensor) -> Tensor:
        return group_norm(x, self.scale, self.bias, self.num_groups, self.eps)
