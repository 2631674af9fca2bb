"""Left-ventricle volume and ejection fraction from masks: the part of
gdkvm_tpu/eval/parity.py that the synthetic EchoNet materializer needs to
label its videos (``lv_volume_area_length``, ``beatwise_ef`` and what they
call).  Host numpy.  The CAMUS and EchoNet scoring protocols of that module
are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

MM3_PER_ML = 1000.0


def lv_long_axis_px(mask: np.ndarray, spacing=None) -> float:
    """Long-axis length of a binary mask: extent along the first principal
    axis of the foreground pixel cloud.

    ``spacing``: optional (sy, sx) physical pixel size in mm — the cloud
    is scaled to physical coordinates BEFORE the PCA, so both the axis
    direction and its extent are anisotropic-correct (raw CAMUS pixels
    are ~2× taller than wide; a pixel-space axis is wrong there).
    Returns pixels when spacing is None, mm otherwise."""
    ys, xs = np.nonzero(mask)
    if ys.size < 2:
        return 0.0
    pts = np.stack([ys, xs], axis=1).astype(np.float64)
    if spacing is not None:
        pts *= np.asarray(spacing, np.float64)[None, :]
    pts -= pts.mean(axis=0)
    # Principal axis via the 2×2 covariance eigenvector.
    cov = pts.T @ pts / pts.shape[0]
    w, v = np.linalg.eigh(cov)
    axis = v[:, int(np.argmax(w))]
    proj = pts @ axis
    return float(proj.max() - proj.min())


def lv_area(mask: np.ndarray, spacing=None) -> float:
    """Foreground area: pixel count, or mm² when (sy, sx) spacing given."""
    n = float(np.asarray(mask, bool).sum())
    if spacing is None:
        return n
    return n * float(spacing[0]) * float(spacing[1])


def lv_volume_area_length(mask: np.ndarray, spacing=None) -> float:
    """Monoplane area–length LV volume estimate V = 8·A²/(3π·L).

    Voxel units when ``spacing`` is None; with (sy, sx) in mm the area is
    mm², the length mm, and the volume mm³ (divide by MM3_PER_ML for mL).
    Anisotropic spacing does NOT cancel in EF — A² grows with sy²·sx²
    while L grows with the spacing along the long axis only — so physical
    units matter even for the ratio.  Returns 0 for an empty mask."""
    area = lv_area(mask, spacing)
    if area <= 0:
        return 0.0
    length = lv_long_axis_px(mask, spacing)
    if length <= 0:
        return 0.0
    return 8.0 * area * area / (3.0 * np.pi * length)


def detect_ed_es(volumes: np.ndarray, smooth: int = 3
                 ) -> Tuple[int, int]:
    """Pick (ED, ES) frame indices from a per-frame volume trace.

    ED = global max, ES = global min of the lightly-smoothed trace — the
    simple robust rule; with multiple beats the global extremes still land
    on a genuine ED/ES pair of some beat, which is what EF needs.
    """
    v = _smooth_trace(volumes, smooth)
    if v.size == 0:
        return 0, 0
    return int(np.argmax(v)), int(np.argmin(v))


def _smooth_trace(volumes: np.ndarray, smooth: int) -> np.ndarray:
    v = np.asarray(volumes, np.float64)
    if smooth > 1 and v.size > smooth:
        v = np.convolve(v, np.ones(smooth) / smooth, mode="same")
    return v


def beatwise_ef(volumes: np.ndarray, smooth: int = 3,
                min_beat_frames: int = 8,
                fps: Optional[float] = None,
                min_beat_s: float = 0.3) -> Tuple[float, int]:
    """Beat-aware EF: segment the volume trace into beats at the ES minima
    (the EchoNet-protocol shape: EF is estimated per beat and averaged —
    robust to arrhythmia and to a lucky/unlucky global extreme).

    Beats = intervals between successive local minima separated by at
    least ``min_beat_frames``; per beat, EF from the max/min volume inside
    it.  Falls back to the global-extreme EF when the trace is too short
    to segment.  Returns (ef_percent, n_beats_used).

    ``fps`` (EchoNet FileList.csv carries per-video FPS; ~50 typical but
    it varies) makes the separation frame-rate-aware: min separation =
    ``min_beat_s``·fps frames (0.3 s ≈ a 200 bpm ceiling — filters noise
    wiggles without dropping real beats).  A fixed frame count misreads
    slow-frame-rate videos: 8 frames is 0.16 s at 50 fps but 0.27 s at
    30 fps.  Without fps the legacy fixed ``min_beat_frames`` applies.
    """
    if fps is not None and fps > 0:
        min_beat_frames = max(3, int(round(min_beat_s * fps)))
    v = _smooth_trace(volumes, smooth)
    if v.size < 2 * min_beat_frames:
        i_ed, i_es = detect_ed_es(volumes, smooth)
        return ef_from_volumes(volumes[i_ed], volumes[i_es]), 1
    # Local minima with a minimum separation (greedy by depth).
    cand = [i for i in range(1, v.size - 1)
            if v[i] <= v[i - 1] and v[i] <= v[i + 1]]
    cand.sort(key=lambda i: v[i])
    minima: list = []
    for i in cand:
        if all(abs(i - j) >= min_beat_frames for j in minima):
            minima.append(i)
    minima.sort()
    if len(minima) < 2:
        i_ed, i_es = detect_ed_es(volumes, smooth)
        return ef_from_volumes(volumes[i_ed], volumes[i_es]), 1
    efs = []
    for lo, hi in zip(minima[:-1], minima[1:]):
        seg = v[lo:hi + 1]
        if seg.size < 3:
            continue
        v_ed, v_es = float(seg.max()), float(seg.min())
        if v_ed > 0:
            efs.append(ef_from_volumes(v_ed, v_es))
    if not efs:
        i_ed, i_es = detect_ed_es(volumes, smooth)
        return ef_from_volumes(volumes[i_ed], volumes[i_es]), 1
    return float(np.mean(efs)), len(efs)


def ef_from_volumes(v_ed: float, v_es: float) -> float:
    """Ejection fraction (%) from ED/ES volumes; 0 when V_ED is empty."""
    if v_ed <= 0:
        return 0.0
    return 100.0 * (v_ed - v_es) / v_ed
