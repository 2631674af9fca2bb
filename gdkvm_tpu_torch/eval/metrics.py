"""Masks from logits (port of ``mask_from_logits`` in
gdkvm_tpu/eval/metrics.py)."""

from __future__ import annotations

import torch


def mask_from_logits(logits: torch.Tensor) -> torch.Tensor:
    """uint8 argmax masks from (..., H, W, K) logits; ties go to the lower
    class, as in the JAX package."""
    return logits.argmax(dim=-1).to(torch.uint8)
