"""Overlay PNGs of the eval stage (``eval_stage.num_vis`` a pass): the
prediction's classes coloured over the grayscale frame, the ground truth
beside it.  Copy of gdkvm_tpu/eval/vis.py; PIL is imported when a panel is
saved.
"""

from __future__ import annotations

import os

import numpy as np

from gdkvm_tpu_torch.utils.optional import require_pil

# Class colors (RGB): bg, LV endo, myocardium, LA.
_COLORS = np.array([
    [0, 0, 0],
    [220, 60, 60],
    [60, 200, 90],
    [70, 110, 230],
], np.float32)


def overlay(frame: np.ndarray, mask: np.ndarray,
            alpha: float = 0.45) -> np.ndarray:
    """frame: (H,W) or (H,W,1) uint8; mask: (H,W) class ids → (H,W,3) uint8."""
    if frame.ndim == 3:
        frame = frame[..., 0]
    rgb = np.repeat(frame[..., None].astype(np.float32), 3, axis=-1)
    k = int(mask.max()) + 1
    colors = _COLORS[:max(k, 1)] if k <= len(_COLORS) else np.concatenate(
        [_COLORS, np.random.RandomState(0).randint(0, 255, (k - len(_COLORS), 3))])
    color_map = colors[np.clip(mask, 0, len(colors) - 1)]
    fg = (mask > 0)[..., None].astype(np.float32)
    out = rgb * (1 - alpha * fg) + color_map * (alpha * fg)
    return np.clip(out, 0, 255).astype(np.uint8)


def save_vis(out_dir: str, step: int, idx: int, frame: np.ndarray,
             pred: np.ndarray, gt: np.ndarray | None = None) -> str:
    """Save a side-by-side [image | pred | gt] panel; returns the path."""
    Image = require_pil("save_vis")
    os.makedirs(out_dir, exist_ok=True)
    panels = [np.repeat(frame[..., :1] if frame.ndim == 3 else
                        frame[..., None], 3, axis=-1).astype(np.uint8),
              overlay(frame, pred)]
    if gt is not None:
        panels.append(overlay(frame, gt))
    panel = np.concatenate(panels, axis=1)
    path = os.path.join(out_dir, f"vis_step{step:06d}_{idx:02d}.png")
    Image.fromarray(panel).save(path)
    return path
