"""EchoNet-Dynamic dataset: 112×112 apical-4-chamber cine loops (copy of
gdkvm_tpu/data/echonet.py).  The public layout:

    <root>/
      Videos/<FileName>.avi            112×112 grayscale cine loops
      FileList.csv                     FileName,EF,...,Split (TRAIN/VAL/TEST)
      VolumeTracings.csv               FileName,X1,Y1,X2,Y2,Frame

Ground truth exists only at the traced ED/ES frames: LV masks are rebuilt
by rasterizing the tracing chords (the standard EchoNet protocol: the first
chord is the long axis, the rest are parallel perpendicular chords; the
polygon between the chord endpoints is filled).  Frames without a trace
carry valid=0, so the loss and the metrics skip them.

AVI decode uses OpenCV on the host, imported when a dataset is opened; a
synthetic materializer writes the same layout.
"""

from __future__ import annotations

import csv
import os
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np

from gdkvm_tpu_torch.data import synthetic
from gdkvm_tpu_torch.utils.optional import require_cv2


def _fill_trace_mask(xs1, ys1, xs2, ys2, hw: Tuple[int, int]) -> np.ndarray:
    """Rasterize an EchoNet LV tracing into a binary mask.

    The tracing is a set of chords; the polygon formed by endpoint chains
    (side 1 forward, side 2 backward) is filled.
    """
    pts1 = np.stack([xs1, ys1], axis=1)
    pts2 = np.stack([xs2, ys2], axis=1)
    poly = np.concatenate([pts1, pts2[::-1]], axis=0).astype(np.float32)
    mask = np.zeros(hw, np.uint8)
    try:
        cv2 = require_cv2("_fill_trace_mask")
    except ImportError:
        cv2 = None
    if cv2 is not None:
        cv2.fillPoly(mask, [np.round(poly).astype(np.int32)], 1)
        return mask
    # Without OpenCV: point-in-polygon over the pixel grid.
    from matplotlib.path import Path
    yy, xx = np.mgrid[0:hw[0], 0:hw[1]]
    pts = np.stack([xx.ravel(), yy.ravel()], axis=1)
    mask = Path(poly).contains_points(pts).reshape(hw).astype(np.uint8)
    return mask


class EchoNetDataset:
    """Clip sampler over EchoNet videos with per-frame validity flags."""

    # __getitem__ draws a RANDOM clip window per access: the device cache
    # must not snapshot it (data/device_cache.py's resolve rules).
    stochastic_items = True

    def __init__(self, root: str, split: str = "train",
                 image_size: int = 112, clip_len: int = 16,
                 num_classes: int = 2, seed: int = 0):
        self._cv2 = require_cv2("EchoNetDataset")
        self.root = root
        self.image_size = image_size
        self.clip_len = clip_len
        self.num_classes = num_classes
        self.rng = np.random.default_rng(seed)

        filelist = os.path.join(root, "FileList.csv")
        if not os.path.exists(filelist):
            raise FileNotFoundError(
                f"{filelist} not found (expected EchoNet-Dynamic layout; "
                f"use materialize_synthetic_echonet() for a stand-in)")
        self.videos: List[str] = []
        with open(filelist) as f:
            for row in csv.DictReader(f):
                if row.get("Split", "").upper() == split.upper():
                    name = row["FileName"]
                    if not name.endswith(".avi"):
                        name += ".avi"
                    self.videos.append(name)

        # Tracings: video → frame → list of chords.
        self.traces: Dict[str, Dict[int, list]] = defaultdict(
            lambda: defaultdict(list))
        tpath = os.path.join(root, "VolumeTracings.csv")
        if os.path.exists(tpath):
            with open(tpath) as f:
                for row in csv.DictReader(f):
                    name = row["FileName"]
                    if not name.endswith(".avi"):
                        name += ".avi"
                    self.traces[name][int(float(row["Frame"]))].append(
                        (float(row["X1"]), float(row["Y1"]),
                         float(row["X2"]), float(row["Y2"])))

    def __len__(self) -> int:
        return len(self.videos)

    def full_video(self, idx: int
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Whole video with per-frame masks and validity, for the device
        video cache (data/device_cache.py): windows are then sampled on the
        device, which keeps __getitem__'s random-window distribution.

        Returns (frames (F,H,W,1) u8, masks (F,H,W) u8, valid (F,) f32).
        """
        name = self.videos[idx]
        video = self.decode_video(name)
        f = video.shape[0]
        masks = np.zeros((f, self.image_size, self.image_size), np.uint8)
        valid = np.zeros((f,), np.float32)
        for t in sorted(self.traces.get(name, {}).keys()):
            if 0 <= t < f:
                m = self.mask_for(name, int(t), video.shape[1:3])
                if m is not None:
                    masks[t] = m
                    valid[t] = 1.0
        return video, masks, valid

    def decode_video(self, name: str) -> np.ndarray:
        """Decode a full video → (T, H, W, 1) uint8 at image_size."""
        cv2 = self._cv2
        cap = cv2.VideoCapture(os.path.join(self.root, "Videos", name))
        frames = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            if frame.ndim == 3:
                frame = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
            if frame.shape[:2] != (self.image_size, self.image_size):
                frame = cv2.resize(frame, (self.image_size, self.image_size),
                                   interpolation=cv2.INTER_AREA)
            frames.append(frame)
        cap.release()
        if not frames:
            raise IOError(f"failed to decode {name}")
        return np.stack(frames)[..., None]

    def mask_for(self, name: str, frame_idx: int,
                 src_hw: Tuple[int, int]) -> np.ndarray | None:
        chords = self.traces.get(name, {}).get(frame_idx)
        if not chords:
            return None
        arr = np.array(chords, np.float32)
        mask = _fill_trace_mask(arr[:, 0], arr[:, 1], arr[:, 2], arr[:, 3],
                                src_hw)
        if src_hw != (self.image_size, self.image_size):
            mask = self._cv2.resize(mask, (self.image_size, self.image_size),
                              interpolation=self._cv2.INTER_NEAREST)
        return mask

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Sample a clip containing at least one traced frame when possible."""
        name = self.videos[idx]
        video = self.decode_video(name)           # (T,H,W,1)
        t_total = video.shape[0]
        traced = sorted(self.traces.get(name, {}).keys())
        if traced:
            anchor = int(self.rng.choice(traced))
            start = int(np.clip(anchor - self.rng.integers(0, self.clip_len),
                                0, max(t_total - self.clip_len, 0)))
        else:
            start = int(self.rng.integers(
                0, max(t_total - self.clip_len + 1, 1)))
        idxs = np.arange(start, start + self.clip_len) % max(t_total, 1)
        frames = video[idxs]
        masks = np.zeros((self.clip_len, self.image_size, self.image_size),
                         np.uint8)
        valid = np.zeros((self.clip_len,), np.float32)
        for j, t in enumerate(idxs):
            m = self.mask_for(name, int(t), video.shape[1:3])
            if m is not None:
                masks[j] = m
                valid[j] = 1.0
        return frames, masks, valid


def materialize_synthetic_echonet(root: str, num_train: int = 8,
                                  num_val: int = 2, num_frames: int = 32,
                                  image_size: int = 112, seed: int = 0,
                                  difficulty: float = 0.0,
                                  fps_cycle=(30.0,)
                                  ) -> None:
    """Write synthetic cine loops in the EchoNet-Dynamic layout (AVI +
    FileList.csv + VolumeTracings.csv with rectangle-ish LV traces).

    fps_cycle: per-video FPS values, cycled: real EchoNet mixes frame
    rates, and an FPS-aware beat-wise EF protocol must read each video's
    own rate; pass e.g. (30, 50) to exercise that.
    """
    cv2 = require_cv2("materialize_synthetic_echonet")
    # Area–length EF from the ground-truth masks (eval/parity.py), so a
    # perfect model scores ~0 EF error on this stand-in, as on real
    # EchoNet's EF column.
    from gdkvm_tpu_torch.eval.parity import beatwise_ef, lv_volume_area_length
    os.makedirs(os.path.join(root, "Videos"), exist_ok=True)
    rows = [("FileName", "EF", "FPS", "Split")]
    trows = [("FileName", "X1", "Y1", "X2", "Y2", "Frame")]
    splits = ["TRAIN"] * num_train + ["VAL"] * num_val
    for i, split in enumerate(splits):
        fps = float(fps_cycle[i % len(fps_cycle)])
        name = f"synth{i:04d}.avi"
        frames, masks = synthetic.generate_video(
            seed * 104729 + i, num_frames, image_size, image_size, 2,
            difficulty)
        path = os.path.join(root, "Videos", name)
        vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), int(fps),
                             (image_size, image_size), isColor=False)
        for t in range(num_frames):
            vw.write(frames[t, :, :, 0])
        vw.release()
        vols = np.array([lv_volume_area_length(masks[t] == 1)
                         for t in range(num_frames)])
        # Label EF with the same FPS-aware rule the protocol applies, so a
        # perfect model reads EF MAE = 0 on the stand-in.
        ef, _ = beatwise_ef(vols, fps=fps)
        rows.append((name, f"{ef:.4f}", f"{fps:g}", split))
        # Trace ED (frame 0) and ES (mid) as parallel chords of the mask.
        for fr in (0, num_frames // 2):
            m = masks[fr]
            ys = np.where(m.any(axis=1))[0]
            if len(ys) < 4:
                continue
            # Long axis chord first (EchoNet convention), then parallels.
            xs0 = np.where(m[ys[0]])[0]
            xs1 = np.where(m[ys[-1]])[0]
            trows.append((name, float(xs0.mean()), float(ys[0]),
                          float(xs1.mean()), float(ys[-1]), fr))
            for y in np.linspace(ys[0], ys[-1], 12)[1:-1]:
                xs = np.where(m[int(y)])[0]
                if len(xs) < 2:
                    continue
                trows.append((name, float(xs[0]), float(y),
                              float(xs[-1]), float(y), fr))
    with open(os.path.join(root, "FileList.csv"), "w", newline="") as f:
        csv.writer(f).writerows(rows)
    with open(os.path.join(root, "VolumeTracings.csv"), "w", newline="") as f:
        csv.writer(f).writerows(trows)
