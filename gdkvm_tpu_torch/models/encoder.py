"""Per-frame CNN encoder producing features at strides 4, 8 and 16.

Port of gdkvm_tpu/models/encoder.py.  Input frames are NHWC as in the JAX
package; the convs run NCHW and the three feature maps come out NCHW in the
compute dtype.  Submodules carry the flax auto-names (``Conv_0``,
``GroupNorm_0``, ``ConvBlock_0``, …) in flax's creation order.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from gdkvm_tpu_torch.models.layers import Conv
from gdkvm_tpu_torch.ops.norms import GroupNorm

Tensor = torch.Tensor


def _gn_groups(c: int) -> int:
    for g in (32, 16, 8, 4, 2, 1):
        if c % g == 0:
            return g
    return 1


class ConvBlock(nn.Module):
    """Residual conv block: 3×3 → GN → SiLU → 3×3 → GN, skip, SiLU."""

    def __init__(self, cin: int, channels: int, dtype: torch.dtype,
                 device: torch.device | str | None = None) -> None:
        super().__init__()
        g = _gn_groups(channels)
        self.Conv_0 = Conv(cin, channels, 3, dtype=dtype, device=device)
        self.GroupNorm_0 = GroupNorm(channels, g, device=device)
        self.Conv_1 = Conv(channels, channels, 3, dtype=dtype, device=device)
        self.GroupNorm_1 = GroupNorm(channels, g, device=device)
        self.Conv_2 = (Conv(cin, channels, 1, dtype=dtype, device=device)
                       if cin != channels else None)

    def forward(self, x: Tensor) -> Tensor:
        h = F.silu(self.GroupNorm_0(self.Conv_0(x)))
        h = self.GroupNorm_1(self.Conv_1(h))
        if self.Conv_2 is not None:
            x = self.Conv_2(x)
        return F.silu(x + h)


def space_to_depth(x: Tensor, p: int) -> Tensor:
    """(B, H, W, C) → (B, H/p, W/p, C·p²) by p×p patch folding."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // p, p, w // p, p, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // p, w // p, c * p * p)


class Encoder(nn.Module):
    """Stem (/4) and two downsampling stages (/8, /16).

    ``stem="s2d"``: 4×4 space-to-depth, then one 3×3 conv at stride 4.
    ``stem="conv"``: two stride-2 3×3 convs.
    """

    def __init__(self, in_channels: int, channels: Sequence[int] = (32, 64, 96, 128),
                 blocks: Sequence[int] = (1, 2, 2, 2),
                 dtype: torch.dtype = torch.bfloat16, stem: str = "s2d",
                 device: torch.device | str | None = None) -> None:
        super().__init__()
        if stem not in ("s2d", "conv"):
            raise ValueError(f"Encoder.stem must be 's2d' or 'conv', got {stem!r}")
        self.dtype, self.stem = dtype, stem
        c0, c4, c8, c16 = channels
        b0, b4, b8, b16 = blocks
        counts = {"Conv": 0, "ConvBlock": 0}

        def add(kind: str, module: nn.Module) -> str:
            name = f"{kind}_{counts[kind]}"
            counts[kind] += 1
            self.add_module(name, module)
            return name

        kw = dict(dtype=dtype, device=device)

        def stage(conv_in: int, cout: int, n_blocks: int, stride: int,
                  stem_norm: bool = False) -> list[str]:
            names = [add("Conv", Conv(conv_in, cout, 3, stride=stride, **kw))]
            if stem_norm:
                self.GroupNorm_0 = GroupNorm(cout, _gn_groups(cout), device=device)
                names.append("GroupNorm_0")
            names += [add("ConvBlock", ConvBlock(cout, cout, **kw))
                      for _ in range(n_blocks)]
            return names

        # Each entry: the modules of one stretch, in order; a SiLU follows
        # the stem's GroupNorm.  f4, f8, f16 are the outputs of the last
        # three stretches.
        if stem == "s2d":
            self._stages = [stage(16 * in_channels, c4, max(b0 + b4 - 1, 1), 1,
                                  stem_norm=True)]
        else:
            self._stages = [stage(in_channels, c0, b0, 2, stem_norm=True),
                            stage(c0, c4, b4, 2)]
        self._stages += [stage(c4, c8, b8, 2), stage(c8, c16, b16, 2)]

    def forward(self, x: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
        """x: (B, H, W, C_in) → f4, f8, f16 (B, C, h, w) in compute dtype."""
        x = x.to(self.dtype)
        if self.stem == "s2d":
            x = space_to_depth(x, 4)
        h = x.permute(0, 3, 1, 2)
        feats = []
        for names in self._stages:
            for name in names:
                h = getattr(self, name)(h)
                if name == "GroupNorm_0":
                    h = F.silu(h)
            feats.append(h)
        return feats[-3], feats[-2], feats[-1]
