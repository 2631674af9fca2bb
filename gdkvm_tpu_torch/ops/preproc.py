"""Interpolation matrices for resizes written as two matrix products.

Port of ``_resize_matrix`` in gdkvm_tpu/ops/preproc.py: the triangle
(bilinear) filter with half-pixel centers, antialiased when downscaling
(support max(scale, 1)), rows summing to 1.
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=64)
def resize_matrix(src: int, dst: int, antialias: bool = True) -> np.ndarray:
    """(dst, src) fp32 triangle-filter interpolation matrix.  The cached
    array is shared: callers copy it (``torch.as_tensor(...).to(...)``)."""
    if src == dst:
        return np.eye(dst, dtype=np.float32)
    scale = src / dst
    support = max(scale, 1.0) if antialias else 1.0
    out_centers = (np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5
    src_idx = np.arange(src, dtype=np.float64)
    w = 1.0 - np.abs(out_centers[:, None] - src_idx[None, :]) / support
    w = np.maximum(w, 0.0)
    w /= np.maximum(w.sum(axis=1, keepdims=True), 1e-12)
    w = w.astype(np.float32)
    w.flags.writeable = False
    return w
