"""KPFF fusion and the multi-scale decoder (port of gdkvm_tpu/models/decoder.py).

Maps are NCHW inside; the logits come out NHWC, as in the JAX package.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from gdkvm_tpu_torch.models.encoder import _gn_groups
from gdkvm_tpu_torch.models.layers import BareKernel, Conv, Dense
from gdkvm_tpu_torch.ops.norms import GroupNorm
from gdkvm_tpu_torch.ops.preproc import resize_matrix

Tensor = torch.Tensor


@functools.lru_cache(maxsize=64)
def _resize_tensor(src: int, dst: int, device: torch.device,
                   dtype: torch.dtype) -> Tensor:
    # Made outside inference mode: an entry first asked for there would be
    # an inference tensor, which a later training step could not save.
    with torch.inference_mode(False):
        return torch.tensor(resize_matrix(src, dst), device=device).to(dtype)


def _resize_matrix(src: int, dst: int, device: torch.device,
                   dtype: torch.dtype) -> Tensor:
    """The (dst, src) resize matrix: cached for eager calls, made anew while
    ``torch.export`` or ``torch.compile`` traces, whose tensors are fake and
    must not reach the cache (a later eager call would get a fake one)."""
    if torch.compiler.is_compiling():
        return torch.tensor(resize_matrix(src, dst), device=device).to(dtype)
    return _resize_tensor(src, dst, device, dtype)


def resize_bilinear(x: Tensor, hw: Tuple[int, int]) -> Tensor:
    """Bilinear resize of NCHW maps as two products with the (dst, src)
    triangle-filter matrices: antialiased when downscaling, as
    ``jax.image.resize(..., "bilinear")`` (``F.interpolate`` differs)."""
    h, w = x.shape[-2:]
    if (h, w) == tuple(hw):
        return x
    r_h = _resize_matrix(h, hw[0], x.device, x.dtype)
    r_w = _resize_matrix(w, hw[1], x.device, x.dtype)
    y = torch.einsum("oh,bchw->bcow", r_h, x)
    return torch.einsum("pw,bchw->bchp", r_w, y)


def _pointwise(x: Tensor, w: Tensor) -> Tensor:
    """1×1 conv of an NCHW map with an (in, out) matrix."""
    return torch.einsum("bchw,cd->bdhw", x, w)


class KPFFBlock(nn.Module):
    """Key-Pixel Feature Fusion at one scale.

    The concat → 1×1 mix of (pixel projection, local depthwise feature,
    upsampled memory readout, coarser decoder stream) is a sum of per-branch
    maps, so the mix kernel's row blocks are folded into each branch's
    projection in fp32 and cast once to the compute dtype.  The SE gate
    pools the raw readout map and projects it with the fp32 ``global_proj``.
    """

    def __init__(self, channels: int, pixel_channels: int, global_channels: int,
                 up_channels: int = 0, dtype: torch.dtype = torch.bfloat16,
                 device: torch.device | str | None = None) -> None:
        super().__init__()
        ch, cp, cg = channels, pixel_channels, global_channels
        self.channels, self.dtype = ch, dtype
        kw = dict(dtype=dtype, device=device)
        self.global_proj = BareKernel(cg, ch, device=device)
        self.local_pw = BareKernel(cp, ch, device=device)
        self.pixel_proj = BareKernel(cp, ch, device=device)
        self.Conv_0 = BareKernel(3 * ch + up_channels, ch, device=device)
        self.local_dw = Conv(cp, cp, 3, groups=cp, **kw)
        self.GroupNorm_0 = GroupNorm(ch, _gn_groups(ch), device=device)
        self.Conv_1 = Conv(ch, ch, 3, **kw)
        self.GroupNorm_1 = GroupNorm(ch, _gn_groups(ch), device=device)
        self.Dense_0 = Dense(ch, max(ch // 4, 8), **kw)
        self.Dense_1 = Dense(max(ch // 4, 8), ch, **kw)

    def forward(self, pixel: Tensor, global_key: Tensor,
                up: Optional[Tensor] = None) -> Tensor:
        """pixel (B, Cp, h, w) encoder skip; global_key (B, Cg, hg, wg)
        memory readout; up: decoder stream from the coarser scale."""
        hw = pixel.shape[-2:]
        ch, dt = self.channels, self.dtype
        m = self.Conv_0.kernel.to(torch.float32)
        w_g = self.global_proj.kernel.to(torch.float32)
        w_px_m = (self.pixel_proj.kernel.to(torch.float32) @ m[:ch]).to(dt)
        w_loc_m = (self.local_pw.kernel.to(torch.float32) @ m[ch:2 * ch]).to(dt)
        w_g_m = (w_g @ m[2 * ch:3 * ch]).to(dt)

        px = pixel.to(dt)
        loc = self.local_dw(px)
        h = _pointwise(px, w_px_m)
        h = h + _pointwise(loc, w_loc_m)
        h = h + resize_bilinear(_pointwise(global_key.to(dt), w_g_m), hw)
        if up is not None:
            h = h + resize_bilinear(_pointwise(up.to(dt), m[3 * ch:].to(dt)), hw)

        h = F.silu(self.GroupNorm_0(h))
        h = F.silu(self.GroupNorm_1(self.Conv_1(h)))

        se = (global_key.to(torch.float32).mean((2, 3)) @ w_g).to(dt)
        se = torch.sigmoid(self.Dense_1(F.silu(self.Dense_0(se))))
        return h * se[:, :, None, None]


class Decoder(nn.Module):
    """KPFF blocks from stride 16 down, then logits resized to the input.

    ``channels`` with 3 entries: KPFF at strides 16/8/4 and a 1×1 head.
    With 2 entries: stop at stride 8 with a sub-pixel head that predicts
    K·4 channels and rearranges them to stride-4 logits.
    """

    def __init__(self, channels: Sequence[int], enc_channels: Sequence[int],
                 global_channels: int, num_classes: int = 2,
                 dtype: torch.dtype = torch.bfloat16,
                 device: torch.device | str | None = None) -> None:
        super().__init__()
        if not 2 <= len(channels) <= 3:
            raise ValueError(
                f"Decoder.channels needs 2 (head at stride 8) or 3 (head "
                f"at stride 4) entries, got {tuple(channels)}")
        self.num_classes, self.n_scales = num_classes, len(channels)
        pixel = (enc_channels[3], enc_channels[2], enc_channels[1])
        up = 0
        for ch, cp, name in zip(channels, pixel, ("kpff16", "kpff8", "kpff4")):
            self.add_module(name, KPFFBlock(ch, cp, global_channels, up,
                                            dtype=dtype, device=device))
            up = ch
        p = 2 if len(channels) == 2 else 1
        self.head = Conv(channels[-1], num_classes * p * p, 1, bias=True,
                         dtype=dtype, device=device)

    def forward(self, f4: Tensor, f8: Tensor, f16: Tensor, readout: Tensor,
                out_hw: Tuple[int, int]) -> Tensor:
        """NCHW maps → logits (B, H, W, K) fp32."""
        d = None
        for feat, name in zip((f16, f8, f4)[:self.n_scales],
                              ("kpff16", "kpff8", "kpff4")):
            d = getattr(self, name)(feat, readout, d)
        hs = self.head(d)
        if self.n_scales == 2:
            hs = subpixel_to_nhwc(hs, self.num_classes).permute(0, 3, 1, 2)
        logits = resize_bilinear(hs.to(torch.float32), out_hw)
        return logits.permute(0, 2, 3, 1)


def subpixel_to_nhwc(hs: Tensor, num_classes: int, p: int = 2) -> Tensor:
    """(B, p²·K, h, w) → (B, h·p, w·p, K), channel (py·p + px)·K + k going to
    pixel (y·p + py, x·p + px), class k.  ``F.pixel_shuffle`` reads channel
    k·p² + py·p + px instead, a different order."""
    b, _, hh, ww = hs.shape
    hs = hs.permute(0, 2, 3, 1).reshape(b, hh, ww, p, p, num_classes)
    return hs.permute(0, 1, 3, 2, 4, 5).reshape(b, hh * p, ww * p, num_classes)
