"""CAMUS processed-artifact dataset (copy of gdkvm_tpu/data/camus.py).

The documented training recipe reads a processed CAMUS artifact,
``camus_png256x256_10f``: 256×256 PNG frames, 10 frames a clip, under the
config's ``data_path``.  This module defines the on-disk layout, a loader
for it, and a materializer that writes synthetic clips in the same layout
(tests, offline runs).  PIL is imported when a PNG is read or written.

Layout (one directory per clip = patient + view):

    <root>/
      train/ | val/ | test/
        <clip_id>/                  e.g. patient0001_2CH
          frame_00.png .. frame_09.png   grayscale, 256×256 (or any size)
          mask_00.png  .. mask_09.png    uint8 class ids (0..K-1)
          meta.json                      optional: physical pixel spacing

Classes follow CAMUS: 0 background, 1 LV endocardium, 2 myocardium, 3 left
atrium.  Binary LV configs keep {0, 1}.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple

import numpy as np

from gdkvm_tpu_torch.data import synthetic
from gdkvm_tpu_torch.utils.optional import require_pil


class CamusDataset:
    """Loads processed-CAMUS clips; resizes to ``image_size`` on the host."""

    def __init__(self, root: str, split: str = "train",
                 image_size: int = 256, clip_len: int = 10,
                 num_classes: int = 4):
        self.root = os.path.join(root, split)
        self.image_size = image_size
        self.clip_len = clip_len
        self.num_classes = num_classes
        if not os.path.isdir(self.root):
            raise FileNotFoundError(
                f"CAMUS split directory not found: {self.root} "
                f"(expected the camus_png256x256_10f layout; see module "
                f"docstring; use materialize_synthetic_camus() for a "
                f"synthetic stand-in)")
        self.clips: List[str] = sorted(
            d for d in os.listdir(self.root)
            if os.path.isdir(os.path.join(self.root, d)))
        if not self.clips:
            raise FileNotFoundError(f"no clip directories under {self.root}")

    def __len__(self) -> int:
        return len(self.clips)

    def spacing(self, idx: int) -> Optional[Tuple[float, float]]:
        """Physical pixel spacing (sy, sx) in mm AT THIS LOADER'S
        image_size, from the clip's meta.json sidecar (written by the raw
        converter / synthetic materializer); None when the clip predates
        the sidecar — callers then score in pixel units and say so.

        The sidecar records spacing at its stored resolution ``size``; a
        loader resizing to a different image_size scales mm-per-pixel by
        stored/target per axis."""
        cache = getattr(self, "_spacing_cache", None)
        if cache is None:
            cache = self._spacing_cache = {}
        if idx in cache:
            return cache[idx]
        path = os.path.join(self.root, self.clips[idx], "meta.json")
        out: Optional[Tuple[float, float]] = None
        if os.path.exists(path):
            with open(path) as f:
                meta = json.load(f)
            sp = meta.get("spacing_mm")
            size = meta.get("size", [self.image_size, self.image_size])
            if sp is not None:
                out = (float(sp[0]) * size[0] / self.image_size,
                       float(sp[1]) * size[1] / self.image_size)
        cache[idx] = out
        return out

    def _load_png(self, path: str, is_mask: bool) -> np.ndarray:
        Image = require_pil("CamusDataset")
        img = Image.open(path)
        if is_mask:
            img = img.convert("L").resize(
                (self.image_size, self.image_size), Image.NEAREST)
            return np.asarray(img, np.uint8)
        img = img.convert("L").resize(
            (self.image_size, self.image_size), Image.BILINEAR)
        return np.asarray(img, np.uint8)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        clip_dir = os.path.join(self.root, self.clips[idx])
        frames, masks = [], []
        for t in range(self.clip_len):
            fp = os.path.join(clip_dir, f"frame_{t:02d}.png")
            mp = os.path.join(clip_dir, f"mask_{t:02d}.png")
            frames.append(self._load_png(fp, is_mask=False))
            masks.append(self._load_png(mp, is_mask=True)
                         if os.path.exists(mp)
                         else np.zeros((self.image_size,) * 2, np.uint8))
        valid = np.array([os.path.exists(os.path.join(
            clip_dir, f"mask_{t:02d}.png")) for t in range(self.clip_len)],
            np.float32)
        f = np.stack(frames)[..., None]          # (T,H,W,1) uint8
        m = np.clip(np.stack(masks), 0, self.num_classes - 1)
        return f, m, valid


def materialize_synthetic_camus(root: str, num_train: int = 16,
                                num_val: int = 4, image_size: int = 256,
                                clip_len: int = 10, num_classes: int = 4,
                                seed: int = 0,
                                difficulty: float = 0.0,
                                spacing_mm: Tuple[float, float] | None
                                = (0.6, 0.4)) -> None:
    """Write synthetic clips in the camus_png256x256_10f layout.

    ``spacing_mm``: declared (sy, sx) physical spacing written to each
    clip's meta.json sidecar — deliberately anisotropic by default so the
    physical-units parity path (HD95 in mm, EF volumes in mL) is exercised
    end-to-end on the stand-in; None omits the sidecar (pixel-units mode,
    the pre-sidecar layout)."""
    Image = require_pil("materialize_synthetic_camus")
    counters = {"train": num_train, "val": num_val}
    idx = 0
    for split, count in counters.items():
        for i in range(count):
            # Consecutive clips pair into one patient with BOTH views —
            # the real CAMUS structure (each patient has 2CH and 4CH),
            # which a biplane-EF protocol depends on.  `count` stays the
            # CLIP count.
            view = "2CH" if i % 2 == 0 else "4CH"
            clip_dir = os.path.join(root, split,
                                    f"patient{i // 2 + 1:04d}_{view}")
            os.makedirs(clip_dir, exist_ok=True)
            frames, masks = synthetic.generate_clip(
                seed * 7919 + idx, clip_len, image_size, image_size,
                num_classes, difficulty)
            idx += 1
            for t in range(clip_len):
                Image.fromarray(frames[t, :, :, 0]).save(
                    os.path.join(clip_dir, f"frame_{t:02d}.png"))
                Image.fromarray(masks[t]).save(
                    os.path.join(clip_dir, f"mask_{t:02d}.png"))
            if spacing_mm is not None:
                with open(os.path.join(clip_dir, "meta.json"), "w") as f:
                    json.dump({"spacing_mm": list(spacing_mm),
                               "size": [image_size, image_size],
                               "source": "synthetic"}, f)
