"""Streaming throughput on a CUDA device (port of ``measure_streaming_fps``
in gdkvm_tpu/eval/throughput.py).

Each chunk's step returns a 4-byte checksum of its masks.  The timer ends on
``.item()`` of the last chunk's checksum: the carried state chains every
chunk to the one before, so that one fetch waits for the whole run.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from gdkvm_tpu_torch.eval.metrics import mask_from_logits
from gdkvm_tpu_torch.models.gdkvm import GDKVM, StreamState

Tensor = torch.Tensor


def streaming_step(model: GDKVM, frames_u8: Tensor,
                   state: Optional[StreamState]
                   ) -> Tuple[Tensor, Tensor, StreamState]:
    """One chunk: uint8 frames (B, T, H, W, 1) → (masks, checksum, state)."""
    logits, new_state = model(frames_u8.to(torch.float32) / 255.0, state)
    masks = mask_from_logits(logits)
    return masks, masks.to(torch.int32).sum(), new_state


@torch.inference_mode()
def measure_streaming_fps(model: GDKVM, device: torch.device, *,
                          image_size: int = 112, chunk: int = 16,
                          batch: int = 1, warmup_chunks: int = 3,
                          timed_chunks: int = 20, seed: int = 0
                          ) -> Dict[str, float]:
    """Frames/s of chunked streaming inference with the state carried.

    ``batch`` streams run as one batch; frames/s counts all of them.  The
    model runs ``1 + warmup_chunks + timed_chunks`` chunks.  Raises unless
    ``device`` is a CUDA device: frames/s is a device measurement.
    """
    if device.type != "cuda":
        raise ValueError(f"measure_streaming_fps times a CUDA device, got {device}")
    rng = np.random.default_rng(seed)
    frames = torch.from_numpy(rng.integers(
        0, 255, (batch, chunk, image_size, image_size, 1), np.uint8)).to(device)

    _, checksum, state = streaming_step(model, frames, None)
    checksum.item()
    for _ in range(warmup_chunks):
        _, checksum, state = streaming_step(model, frames, state)
    checksum.item()

    t0 = time.perf_counter()
    for _ in range(timed_chunks):
        _, checksum, state = streaming_step(model, frames, state)
    checksum.item()
    dt = time.perf_counter() - t0

    total = timed_chunks * chunk * batch
    return {
        "frames_per_sec": total / dt,
        "ms_per_frame": 1e3 * dt / total,
        "chunk": chunk,
        "batch": batch,
        "image_size": image_size,
        "timed_frames": total,
        "elapsed_sec": dt,
        "device": torch.cuda.get_device_name(device),
    }
