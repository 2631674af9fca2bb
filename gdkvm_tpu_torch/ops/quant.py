"""Post-training W8A8 quantization of the conv backbone for serving (port of
gdkvm_tpu/ops/quant.py).

W8A8: int8 weights and int8 activations.  A calibrated conv runs as

    quantize(x) → SAME pad → im2col → int8 × int8 product (int32, exact)
    → dequantize by s_w · s_x in fp32 (+ bias in fp32) → cast

with a symmetric scale per output channel for the weights, made from the
model's fp32 weights, and one static scale per conv for its input,
calibrated offline from the abs-max or a high percentile of |x| over
calibration clips.  Everything else (GroupNorm, SiLU, the GDR memory, the
decoder's einsums) runs as in the float model.

The int8 product is ``torch._int_mm`` on an im2col matrix (PyTorch has no
int8 convolution on CUDA).  On the CPU the same code runs, so the CPU is a
bit-exact reference for the card.  On CUDA ``torch._int_mm`` wants more
than 16 rows and inner and output sizes that are multiples of 8: the input
channels and the weight's output rows are padded with zeros (exact), and a
matrix of 16 rows or fewer is padded and sliced.  Where the library still
refuses, the call raises: there is no float fallback.

Whether W8A8 pays on a given card is a measurement, not a property of the
module: it adds launches (quantize, pad, im2col copy, product, dequantize)
where the float conv has one.  It is off by default and gated per
checkpoint by ``quant --check`` (the Dice delta against full precision).

Eligible convs: every non-depthwise conv of the model (``groups == 1``; all
the port's convs are 2-D with "SAME" padding), the 1×1 skip convs of the
encoder and the decoder's head included; the KPFF depthwise ``local_dw``
stays float.  Scale keys are module paths in the flax tree's spelling
(``encoder/ConvBlock_0/Conv_0``), so a scales JSON written by either package
loads in the other.  The W8A8 route is inference-only.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from gdkvm_tpu_torch.models.layers import Conv, same_padding

Tensor = torch.Tensor

SCOPES = ("encoder", "decoder", "all")
METHODS = ("absmax", "percentile")


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def quantize_act(x: Tensor, act_scale: float) -> Tensor:
    """x (any float dtype) → int8 ``clip(round(x·127/s_x), ±127)``, the
    product in fp32 and rounding half to even.  127/s_x is computed in
    Python float and rounded to fp32, as JAX's ``np.float32(127.0 /
    max(act_scale, 1e-12))``."""
    inv = float(np.float32(127.0 / max(act_scale, 1e-12)))
    return torch.clamp(torch.round(x.to(torch.float32) * inv), -127, 127
                       ).to(torch.int8)


def quantize_weight(weight: Tensor) -> Tuple[Tensor, Tensor]:
    """OIHW fp32 weight → (int8 OIHW, w_scale (O,) fp32) with
    ``w_scale = max(amax_o, 1e-12) / 127`` per output channel."""
    w = weight.detach().to(torch.float32)
    w_scale = torch.clamp_min(w.abs().amax(dim=(1, 2, 3)), 1e-12) / 127.0
    w8 = torch.clamp(torch.round(w / w_scale[:, None, None, None]), -127, 127)
    return w8.to(torch.int8), w_scale


def pack_weight(weight: Tensor, act_scale: float) -> Tuple[Tensor, Tensor]:
    """Quantize an OIHW weight for :func:`int8_conv` at input scale
    ``act_scale`` → (mat, deq): ``mat`` (O_pad, K) int8, the product's
    right-hand matrix with K = C_pad·kh·kw in the im2col columns' order
    (kh, kw, c), the input channels zero-padded so that K is a multiple of
    8 and the output channels to a multiple of 8; ``deq`` (O,) fp32 =
    w_scale · fp32(s_x / 127), as JAX's ``deq``."""
    cout, cin, kh, kw = weight.shape
    w8, w_scale = quantize_weight(weight)
    cin_pad = cin if (cin * kh * kw) % 8 == 0 else _round_up(cin, 8)
    w8 = F.pad(w8, (0, 0, 0, 0, 0, cin_pad - cin, 0, _round_up(cout, 8) - cout))
    mat = w8.permute(0, 2, 3, 1).reshape(w8.shape[0], -1).contiguous()
    deq = w_scale * torch.tensor(np.float32(act_scale / 127.0),
                                 device=w_scale.device)
    return mat, deq


def _int_mm(a: Tensor, mat: Tensor) -> Tensor:
    """int8 (M, K) × int8 (O_pad, K)ᵀ → int32 (M, O_pad), exact.  M ≤ 16
    is padded with zero rows (``torch._int_mm`` on CUDA wants M > 16)."""
    m = a.shape[0]
    if m <= 16:
        a = F.pad(a, (0, 0, 0, 32 - m))
    return torch._int_mm(a, mat.t())[:m]


def int8_conv(x: Tensor, mat: Tensor, deq: Tensor, act_scale: float, *,
              ksize: int, stride: int, bias: Optional[Tensor],
              out_dtype: torch.dtype) -> Tensor:
    """The W8A8 conv of an NCHW map x (B, C, H, W) with a weight packed by
    :func:`pack_weight` → (B, O, H_out, W_out) in ``out_dtype``."""
    b, c, h, w = x.shape
    k, cout = ksize, deq.shape[0]
    x8 = quantize_act(x, act_scale)
    x8 = F.pad(x8, (*same_padding(w, k, stride), *same_padding(h, k, stride),
                    0, mat.shape[1] // (k * k) - c))
    # im2col (Tensor.unfold: F.unfold has no int8 kernel): rows (b, y, x),
    # columns (kh, kw, c) as the packed weight's.
    cols = x8.unfold(2, k, stride).unfold(3, k, stride)   # B,C,Ho,Wo,kh,kw
    ho, wo = cols.shape[2], cols.shape[3]
    a = cols.permute(0, 2, 3, 4, 5, 1).reshape(b * ho * wo, -1)
    out = _int_mm(a, mat)[:, :cout].to(torch.float32) * deq
    if bias is not None:
        out = out + bias.to(torch.float32)
    return out.to(out_dtype).reshape(b, ho, wo, cout).permute(0, 3, 1, 2)


def quantized_conv(x: Tensor, weight: Tensor, act_scale: float, *,
                   stride: int = 1, bias: Optional[Tensor] = None,
                   out_dtype: torch.dtype = torch.float32) -> Tensor:
    """W8A8 "SAME" conv: x (B, C, H, W) float, weight (O, C, kh, kw) fp32
    (quantized here per output channel), ``act_scale`` the static input
    scale.  Accumulates in int32 and dequantizes once; the counterpart of
    JAX's ``quantized_conv`` (NHWC/HWIO there)."""
    mat, deq = pack_weight(weight, act_scale)
    return int8_conv(x, mat, deq, act_scale, ksize=weight.shape[-1],
                     stride=stride, bias=bias, out_dtype=out_dtype)


# ---------------------------------------------------------------------------
# Scale tables.
# ---------------------------------------------------------------------------

def eligible_convs(model) -> Dict[str, "torch.nn.Module"]:
    """{flax path: conv} of every conv the W8A8 route takes: non-depthwise
    ``models.layers.Conv`` modules, in the model's order."""
    return {name.replace(".", "/"): mod for name, mod in model.named_modules()
            if isinstance(mod, Conv) and mod.groups == 1}


def quant_tag(scales: Mapping[str, float]) -> str:
    """``cfg.quant`` of a W8A8 model: ``w8a8-`` and the first 8 hex digits
    of the SHA-1 of the scale table's sorted JSON, as the JAX package's."""
    digest = hashlib.sha1(json.dumps(dict(scales), sort_keys=True).encode()
                          ).hexdigest()[:8]
    return f"w8a8-{digest}"


def linear_percentile(a: Tensor, q: float) -> Tensor:
    """The ``q``-th percentile of a 1-D tensor by linear interpolation
    between the two neighbouring order statistics, with the position and
    the weights in fp32 arithmetic as ``jnp.percentile`` computes them (so
    a calibration agrees with the JAX package's, where the gap between the
    neighbours is wide).  ``torch.quantile`` refuses inputs over 2²⁴
    elements; ``kthvalue`` has no such limit."""
    f32 = np.float32
    n = a.numel()
    pos = f32(f32(q) / f32(100.0)) * f32(n - 1)
    lo = min(max(int(np.floor(pos)), 0), n - 1)
    hi = min(max(int(np.ceil(pos)), 0), n - 1)
    w_hi = f32(pos - f32(np.floor(pos)))
    w_lo = f32(f32(1.0) - w_hi)
    v_lo = torch.kthvalue(a, lo + 1).values
    v_hi = v_lo if hi == lo else torch.kthvalue(a, hi + 1).values
    return v_lo * float(w_lo) + v_hi * float(w_hi)


@torch.no_grad()
def calibrate_act_scales(model, batches: Iterable, scope: str = "encoder",
                         headroom: float = 1.0, method: str = "absmax",
                         percentile: float = 99.9) -> Dict[str, float]:
    """Run calibration clips through the float model, collect each eligible
    conv's input statistic, return {flax path: act_scale}.

    batches: (B, T, H, W, C) float clips (numpy or tensors), normalized as
    inference sees them; each runs on the model's device.  ``method``
    "absmax" takes max|x|, "percentile" the ``percentile``-th percentile
    of |x| (robust to sparse outliers).  A conv called more than once in a
    clip takes the maximum over its calls; clips combine by maximum.  Kept:
    paths in ``scope`` ("encoder", "decoder" or "all") with a positive
    statistic, times ``headroom``.
    """
    if method not in METHODS:
        raise ValueError(f"unknown calibration method {method!r}")
    if scope not in SCOPES:
        raise ValueError(f"scope must be one of {SCOPES}, got {scope!r}")
    device = next(model.parameters()).device
    sink: Dict[str, list] = {}

    def hook_for(path: str):
        def hook(_mod, args):
            a = args[0].detach().to(torch.float32).abs().reshape(-1)
            sink.setdefault(path, []).append(
                linear_percentile(a, percentile) if method == "percentile"
                else a.max())
        return hook

    handles = [conv.register_forward_pre_hook(hook_for(path))
               for path, conv in eligible_convs(model).items()]
    stats: Dict[str, float] = {}
    try:
        for clip in batches:
            frames = torch.as_tensor(np.asarray(clip), dtype=torch.float32).to(device)
            sink.clear()
            model(frames)
            # One fetch a clip: every conv's statistic at once.
            paths = list(sink)
            vals = torch.stack([torch.stack(sink[p]).max() for p in paths]).tolist()
            for p, v in zip(paths, vals):
                stats[p] = max(stats.get(p, 0.0), v)
    finally:
        for h in handles:
            h.remove()
    return {p: v * headroom for p, v in stats.items()
            if (scope == "all" or p.startswith(scope)) and v > 0.0}


def save_scales(path: str, scales: Mapping[str, float]) -> None:
    with open(path, "w") as f:
        json.dump(dict(scales), f, indent=2, sort_keys=True)


def load_scales(path: str) -> Dict[str, float]:
    with open(path) as f:
        return {str(k): float(v) for k, v in json.load(f).items()}


def w8a8_model(model, scales: Mapping[str, float]):
    """A W8A8 copy of ``model`` (its weights as they are now, on its device)
    whose calibrated convs run int8; ``cfg.quant`` is ``quant_tag(scales)``.
    Raises where a key names no eligible conv of the model."""
    from gdkvm_tpu_torch.models.gdkvm import GDKVM
    device = next(model.parameters()).device
    cfg = dataclasses.replace(model.cfg, quant=quant_tag(scales))
    # Made outside inference mode, so that its weights are ordinary
    # tensors whose in-place changes the convs see (Conv._weight_version).
    with torch.inference_mode(False):
        qmodel = GDKVM(cfg, device=device, quant_scales=scales)
        qmodel.load_state_dict(model.state_dict())
    refresh_w8a8(qmodel)
    return qmodel.train(model.training)


def refresh_w8a8(model) -> None:
    """Re-pack every W8A8 conv of ``model`` whose weight changed in place
    (a checkpoint copied in): before a trace, which cannot."""
    for conv in eligible_convs(model).values():
        conv.refresh_w8a8()
