"""Procedural echo-like video generator (numpy only).

A copy of gdkvm_tpu/data/synthetic.py: that package cannot be imported
where JAX is missing, and the port needs the same clips.  A test holds the
two to identical arrays.  It fabricates echocardiography-like cine loops —
sector-scan cone, pulsating left-ventricle cavity, myocardial ring, atrium,
multiplicative speckle noise — for tests, overfit runs and throughput runs.

Classes (multi-class mode, matching CAMUS semantics): 0 background,
1 LV endocardium (cavity), 2 myocardium (epi ring), 3 left atrium.
Binary mode: 0 background, 1 LV cavity.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _ellipse_mask(h: int, w: int, cy: float, cx: float, ry: float, rx: float,
                  angle: float = 0.0) -> np.ndarray:
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    y = yy - cy
    x = xx - cx
    ca, sa = np.cos(angle), np.sin(angle)
    yr = ca * y + sa * x
    xr = -sa * y + ca * x
    return (yr / ry) ** 2 + (xr / rx) ** 2 <= 1.0


def _cone_mask(h: int, w: int) -> np.ndarray:
    """Ultrasound sector: apex at top-center, opening downward."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    y = yy / h
    x = (xx - w / 2) / (w / 2)
    ang = np.arctan2(np.abs(x), y + 1e-6)
    r = np.sqrt(x ** 2 + y ** 2)
    return (ang < 0.75) & (r < 0.98)


def generate_clip(seed: int, num_frames: int = 10, height: int = 112,
                  width: int = 112, num_classes: int = 2,
                  difficulty: float = 0.0,
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Generate one echo-like clip.

    ``difficulty`` ∈ [0, 1] blends in the clinical-artifact bank (0 keeps
    the original easy generator bit-for-bit).  The artifacts degrade the
    IMAGE while the masks keep tracking the true anatomy — exactly the
    regime where temporal memory must carry the segmentation:

      - rib shadowing: a drifting angular wedge attenuating the sector;
      - probe drift: slow translation + rotation random walk of the view;
      - depth-dependent contrast decay (imperfect TGC);
      - near-field clutter: bright haze blobs under the apex;
      - valve/papillary clutter: a bright mobile speck inside the cavity;
      - out-of-plane swings: periodic anatomy-scale wobble whose troughs
        also fade the wall/cavity contrast (the boundary dissolves);
      - stronger, frame-to-frame decorrelating speckle.

    Returns:
      frames: (T, H, W, 1) uint8.
      masks:  (T, H, W) uint8 class ids.
    """
    rng = np.random.default_rng(seed)
    d = float(np.clip(difficulty, 0.0, 1.0))
    t_ax = np.arange(num_frames, dtype=np.float32)
    # Cardiac cycle ~ 1 beat per ~0.8-1.2× clip; phase & anatomy vary by seed.
    freq = rng.uniform(0.8, 1.4) / max(num_frames, 1)
    phase = rng.uniform(0, 2 * np.pi)
    contract = 0.5 + 0.5 * np.cos(2 * np.pi * freq * t_ax * num_frames
                                  / max(num_frames, 1) + phase)  # ∈[0,1]

    cy0 = rng.uniform(0.40, 0.52) * height
    cx0 = rng.uniform(0.44, 0.56) * width
    ry0 = rng.uniform(0.16, 0.24) * height
    rx0 = rng.uniform(0.11, 0.17) * width
    ang = rng.uniform(-0.3, 0.3)
    wall = rng.uniform(0.28, 0.42)          # myocardium thickness ratio
    cone = _cone_mask(height, width)

    # --- difficulty>0 artifact parameters (drawn up front; the d==0 path
    # must not consume extra rng draws so legacy clips stay bit-identical).
    if d > 0:
        yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
        ang_field = np.arctan2(xx - width / 2, yy + 1e-6)   # sector angle
        r_field = np.sqrt(((yy) / height) ** 2
                          + ((xx - width / 2) / (width / 2)) ** 2)
        shadow_c0 = rng.uniform(-0.5, 0.5)       # wedge center (rad)
        shadow_drift = rng.uniform(-0.6, 0.6) / max(num_frames, 1)
        shadow_hw = rng.uniform(0.08, 0.18)      # wedge half-width (rad)
        drift_y = rng.uniform(-1, 1) * 0.05 * d * height / max(num_frames, 1)
        drift_x = rng.uniform(-1, 1) * 0.05 * d * width / max(num_frames, 1)
        drift_a = rng.uniform(-1, 1) * 0.25 * d / max(num_frames, 1)
        swing_f = rng.uniform(0.5, 1.5) / max(num_frames, 1)
        swing_ph = rng.uniform(0, 2 * np.pi)
        n_clutter = rng.integers(1, 4)
        clutter = [(rng.uniform(0.05, 0.22) * height,
                    rng.uniform(0.35, 0.65) * width,
                    rng.uniform(0.03, 0.07) * height)
                   for _ in range(n_clutter)]
        valve_ph = rng.uniform(0, 2 * np.pi)

    frames = np.empty((num_frames, height, width, 1), np.uint8)
    masks = np.empty((num_frames, height, width), np.uint8)
    base_speckle = rng.standard_normal((height, width)).astype(np.float32)

    for t in range(num_frames):
        s = 1.0 - 0.25 * contract[t]         # systolic shrink of the cavity
        jit_y = rng.normal(0, 0.01) * height
        jit_x = rng.normal(0, 0.01) * width
        cy, cx = cy0 + jit_y, cx0 + jit_x
        a_t = ang
        swing = 0.0
        if d > 0:
            # Probe drift + out-of-plane swing move the TRUE anatomy; the
            # masks below track it exactly.
            cy += drift_y * t
            cx += drift_x * t
            a_t = ang + drift_a * t
            swing = 0.5 + 0.5 * np.sin(2 * np.pi * swing_f * t * num_frames
                                       / max(num_frames, 1) + swing_ph)
            s = s * (1.0 - 0.12 * d * swing)
        lv = _ellipse_mask(height, width, cy, cx, ry0 * s, rx0 * s, a_t)
        epi = _ellipse_mask(height, width, cy, cx,
                            ry0 * s * (1 + wall), rx0 * s * (1 + wall), a_t)
        la = _ellipse_mask(height, width, cy + ry0 * (1.6 + wall), cx,
                           ry0 * 0.55, rx0 * 0.8, a_t)

        mask = np.zeros((height, width), np.uint8)
        if num_classes >= 4:
            mask[epi & cone] = 2             # myocardium ring (under cavity)
            mask[lv & cone] = 1
            mask[la & cone & ~epi] = 3
        else:
            mask[lv & cone] = 1

        # Image: bright myocardium, dark cavity/atrium, speckle, cone gate.
        # Out-of-plane troughs fade the wall/cavity contrast toward the
        # background level (the boundary dissolves; GT unchanged).
        fade = 1.0 - 0.6 * d * swing if d > 0 else 1.0
        img = np.full((height, width), 0.18, np.float32)
        img[epi] = 0.18 + (0.75 - 0.18) * fade
        img[lv] = 0.18 + (0.12 - 0.18) * fade
        img[la] = 0.18 + (0.15 - 0.18) * fade
        if d > 0:
            # Valve/papillary speck: bright mobile clutter inside the cavity.
            vr = 0.45 + 0.3 * np.sin(2 * np.pi * freq * t * num_frames
                                     / max(num_frames, 1) + valve_ph)
            valve = _ellipse_mask(height, width,
                                  cy + vr * ry0 * s * 0.6, cx,
                                  0.06 * height * 0.5, 0.10 * width * 0.5,
                                  a_t)
            img[valve & lv] = 0.55 * d + img[valve & lv] * (1 - d)
        # Blur-ish boundary: average with shifted copies (cheap smoothing).
        img = (img + np.roll(img, 1, 0) + np.roll(img, -1, 0)
               + np.roll(img, 1, 1) + np.roll(img, -1, 1)) / 5.0
        if d > 0:
            # Decorrelating speckle: AR(1) evolution of the base field.
            rho = 1.0 - 0.35 * d
            base_speckle = (rho * base_speckle
                            + np.sqrt(1 - rho * rho)
                            * rng.standard_normal((height, width))
                            .astype(np.float32))
            amp = 0.35 * (1 + 0.8 * d)
            speckle = 0.85 + amp * (0.7 * base_speckle + 0.3 * rng
                                    .standard_normal((height, width)))
            img = np.clip(img * speckle.astype(np.float32), 0, 1)
            # Rib shadow: drifting angular wedge attenuation.
            sc = shadow_c0 + shadow_drift * t * num_frames \
                / max(num_frames, 1)
            wedge = np.exp(-0.5 * ((ang_field - sc) / shadow_hw) ** 2)
            img *= 1.0 - 0.85 * d * wedge.astype(np.float32)
            # Depth-dependent contrast decay (imperfect TGC).
            img *= 1.0 - 0.45 * d * np.clip(r_field, 0, 1)
            # Near-field clutter haze.
            for (ccy, ccx, cr) in clutter:
                blob = np.exp(-0.5 * (((yy - ccy) ** 2 + (xx - ccx) ** 2)
                                      / (cr * cr)))
                img = img + 0.5 * d * blob.astype(np.float32)
            img = np.clip(img, 0, 1)
        else:
            speckle = 0.85 + 0.35 * (0.7 * base_speckle
                                     + 0.3 * rng.standard_normal(
                                         (height, width)))
            img = np.clip(img * speckle.astype(np.float32), 0, 1)
        img[~cone] = 0.0
        frames[t, :, :, 0] = (img * 255).astype(np.uint8)
        masks[t] = mask

    return frames, masks


def generate_video(seed: int, num_frames: int, height: int = 112,
                   width: int = 112, num_classes: int = 2,
                   difficulty: float = 0.0
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Long multi-beat video (for streaming eval); same contract as
    :func:`generate_clip`."""
    return generate_clip(seed, num_frames, height, width, num_classes,
                         difficulty)


class SyntheticDataset:
    """Deterministic synthetic clip dataset."""

    def __init__(self, num_clips: int = 64, clip_len: int = 10,
                 image_size: int = 112, num_classes: int = 2, seed: int = 0,
                 difficulty: float = 0.0):
        self.num_clips = num_clips
        self.clip_len = clip_len
        self.image_size = image_size
        self.num_classes = num_classes
        self.seed = seed
        self.difficulty = difficulty

    def __len__(self) -> int:
        return self.num_clips

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        frames, masks = generate_clip(self.seed * 100003 + idx,
                                      self.clip_len, self.image_size,
                                      self.image_size, self.num_classes,
                                      self.difficulty)
        valid = np.ones((self.clip_len,), np.float32)
        return frames, masks, valid
