"""Masks from logits and the evaluation metrics (port of
gdkvm_tpu/eval/metrics.py).

Dice is hard and per class, accumulated as partial sums (intersection,
prediction sum, label sum) so that aggregation over frames, batches and
videos is exact: never a mean of Dice values.  The sums are tensors on the
logits' device; a pass adds them there and :func:`dice_finalize` fetches
them once.  ``hd95`` and ``temporal_consistency`` are host numpy/scipy.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

Tensor = torch.Tensor


def mask_from_logits(logits: Tensor) -> Tensor:
    """uint8 argmax masks from (..., H, W, K) logits; ties go to the lower
    class, as in the JAX package."""
    return logits.argmax(dim=-1).to(torch.uint8)


def dice_sums(pred: Tensor, labels: Tensor, valid: Tensor,
              num_classes: int) -> Dict[str, Tensor]:
    """Partial sums from hard predictions: pred, labels (B, T, H, W) class
    ids, valid (B, T) → {"inter", "psum", "lsum"} (K,) fp32 and "frames"
    (), on ``pred``'s device.  Frames with valid 0 add nothing."""
    classes = torch.arange(num_classes, device=pred.device).reshape(
        1, 1, num_classes, 1, 1)
    v = valid.to(torch.float32)[:, :, None, None, None]
    pred1 = (pred[:, :, None].long() == classes).to(torch.float32) * v
    lab1 = (labels[:, :, None].long() == classes).to(torch.float32) * v
    return {"inter": (pred1 * lab1).sum((0, 1, 3, 4)),
            "psum": pred1.sum((0, 1, 3, 4)),
            "lsum": lab1.sum((0, 1, 3, 4)),
            "frames": valid.to(torch.float32).sum()}


def dice_accumulate(logits: Tensor, labels: Tensor, valid: Tensor,
                    num_classes: int) -> Dict[str, Tensor]:
    """Partial sums for per-class Dice from logits (B, T, H, W, K), labels
    (B, T, H, W) and valid (B, T); see :func:`dice_sums`."""
    return dice_sums(logits.argmax(dim=-1), labels, valid, num_classes)


def dice_merge(a: Dict[str, Tensor], b: Dict[str, Tensor]) -> Dict[str, Tensor]:
    return {k: a[k] + b[k] for k in a}


def dice_finalize(acc: Dict[str, Tensor], eps: float = 1e-7) -> Dict[str, float]:
    """Per-class Dice and the foreground mean from accumulated sums, after
    one fetch of them (fp32 throughout, as the JAX package)."""
    k = acc["inter"].numel()
    host = torch.cat([acc["inter"], acc["psum"], acc["lsum"],
                      acc["frames"].reshape(1)]).cpu()
    inter, psum, lsum, frames = host[:k], host[k:2 * k], host[2 * k:3 * k], host[3 * k]
    dice = (2 * inter + eps) / (psum + lsum + eps)
    out = {f"dice_class{i}": float(d) for i, d in enumerate(dice)}
    out["dice_fg_mean"] = float(dice[1:].mean()) if k > 1 else float("nan")
    out["frames"] = float(frames)
    return out


def hd95(pred: np.ndarray, label: np.ndarray, num_classes: int,
         spacing=1.0) -> Dict[str, float]:
    """95th-percentile symmetric Hausdorff distance per foreground class,
    the standard CAMUS boundary metric beside Dice.  Host numpy/scipy on
    hard masks, at eval time only.

    pred, label: (H, W) integer class maps (one frame).  ``spacing``: the
    physical pixel size, a scalar or an (sy, sx) pair in mm (raw CAMUS is
    anisotropic; the distance transform samples each axis at its spacing,
    so distances are physical lengths).  Returns {"hd95_class{k}":
    distance} for foreground classes; a class absent from both maps is
    skipped, absent from one gives inf.
    """
    from scipy.ndimage import binary_erosion, distance_transform_edt

    samp = ((float(spacing),) * 2 if np.isscalar(spacing)
            else tuple(float(s) for s in spacing))
    out: Dict[str, float] = {}
    for k in range(1, num_classes):
        p = pred == k
        l = label == k
        if not p.any() and not l.any():
            continue
        if not p.any() or not l.any():
            out[f"hd95_class{k}"] = float("inf")
            continue
        pb = p & ~binary_erosion(p)            # boundaries
        lb = l & ~binary_erosion(l)
        dist_to_l = distance_transform_edt(~lb, sampling=samp)
        dist_to_p = distance_transform_edt(~pb, sampling=samp)
        both = np.concatenate([dist_to_l[pb], dist_to_p[lb]])
        out[f"hd95_class{k}"] = float(np.percentile(both, 95))
    return out


def temporal_consistency(masks: np.ndarray) -> Dict[str, float]:
    """Frame-to-frame stability of a predicted mask sequence (T, H, W):
    the mean foreground IoU between consecutive frames' predictions and the
    flicker rate (fraction of pixels that change class per frame pair);
    nan when T < 2.  Cardiac motion bounds the true change, so a higher IoU
    and lower flicker at equal Dice mean the memory steadies predictions.
    """
    t = masks.shape[0]
    if t < 2:
        return {"temporal_fg_iou": float("nan"),
                "flicker_rate": float("nan")}
    a = masks[:-1]
    b = masks[1:]
    fg_a = a > 0
    fg_b = b > 0
    inter = (fg_a & fg_b & (a == b)).sum(axis=(1, 2)).astype(np.float64)
    union = (fg_a | fg_b).sum(axis=(1, 2)).astype(np.float64)
    iou = np.where(union > 0, inter / np.maximum(union, 1), 1.0)
    flicker = (a != b).mean(axis=(1, 2))
    return {"temporal_fg_iou": float(iou.mean()),
            "flicker_rate": float(flicker.mean())}
