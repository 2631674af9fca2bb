"""Resizes written as two matrix products, and the device-side resize of
uint8 frames (port of gdkvm_tpu/ops/preproc.py).

``resize_matrix`` is ``_resize_matrix``: the triangle (bilinear) filter with
half-pixel centers, antialiased when downscaling (support max(scale, 1)),
rows summing to 1.  ``resize_normalize`` and ``resize_u8`` apply one matrix
per axis, ``out[t, o, p] = R_h[o, h] · x[t, h, w] · R_w[p, w]``, in fp32 on
the frames' device.  The products are fp32 as long as
``torch.backends.cuda.matmul.allow_tf32`` is False, PyTorch's default (the
JAX package asks for ``Precision.HIGHEST``).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

Tensor = torch.Tensor


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


def resize_matrices(src_hw: Tuple[int, int], dst_hw: Tuple[int, int],
                    device: torch.device | str) -> Tuple[Tensor, Tensor]:
    """(R_h (h, H), R_w (w, W)) fp32 on ``device``, for callers that keep
    them (the serving engine caches them per source shape)."""
    return tuple(torch.from_numpy(resize_matrix(s, d).copy()).to(device)
                 for s, d in zip(src_hw, dst_hw))


def resize_normalize(frames_u8: Tensor, out_hw: Tuple[int, int],
                     dtype: torch.dtype = torch.float32,
                     matrices: Optional[Tuple[Tensor, Tensor]] = None
                     ) -> Tensor:
    """uint8 (..., H, W, C) → ``dtype`` (..., h, w, C) in [0, 1].

    Identity-size input skips the products.  ``matrices`` are
    :func:`resize_matrices` of this resize, made here when not given.
    """
    *lead, src_h, src_w, c = frames_u8.shape
    dst_h, dst_w = out_hw
    x = frames_u8.to(torch.float32) * (1.0 / 255.0)
    if (src_h, src_w) == (dst_h, dst_w):
        return x.to(dtype)
    r_h, r_w = matrices or resize_matrices((src_h, src_w), out_hw, x.device)
    x = r_h @ x.reshape(-1, src_h, src_w * c)                  # (b, h, W·C)
    x = x.reshape(-1, dst_h, src_w, c)
    x = torch.einsum("pw,bhwc->bhpc", r_w, x)
    return x.reshape(*lead, dst_h, dst_w, c).to(dtype)


def resize_u8(frames_u8: Tensor, out_hw: Tuple[int, int],
              matrices: Optional[Tuple[Tensor, Tensor]] = None) -> Tensor:
    """uint8 (..., H, W, C) → uint8 (..., h, w, C) on the frames' device:
    rounded half to even, as ``jnp.round``, then clipped to [0, 255]."""
    x = resize_normalize(frames_u8, out_hw, matrices=matrices)
    return torch.round(x * 255.0).clamp(0, 255).to(torch.uint8)
