"""Throughput and latency on a CUDA device (port of
gdkvm_tpu/eval/throughput.py): streaming frames/s, per-call serving
latency, and seconds a training step.

Each function measures on the ``device`` it is given and names it in its
result (``"device"``: the card's name, or ``"cpu"``: a host number, never
the card's).  None has a default device: the caller says where.

Each chunk's step returns a 4-byte checksum of its masks.  A timer ends on
``.item()`` of a checksum (or of the loss): work on one CUDA stream runs in
order, so that one fetch waits for everything queued before it.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from gdkvm_tpu_torch.eval.metrics import mask_from_logits
from gdkvm_tpu_torch.models.gdkvm import GDKVM, StreamState

Tensor = torch.Tensor


def _device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


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
    model runs ``1 + warmup_chunks + timed_chunks`` chunks.
    """
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
        "device": _device_name(device),
    }


@torch.inference_mode()
def measure_streaming_latency(model: GDKVM, device: torch.device, *,
                              image_size: int = 112, chunk: int = 1,
                              batch: int = 1, warmup: int = 5,
                              timed: int = 50, seed: int = 0
                              ) -> Dict[str, float]:
    """Per-call serving latency (distinct from throughput): one chunk goes
    from host memory to the device, through the model, and its checksum
    comes back, synchronously: what a live scanner feed waits for.
    ``chunk=1`` gives per-frame latency.  Percentiles over ``timed`` calls
    after ``warmup``."""
    rng = np.random.default_rng(seed)
    host = torch.from_numpy(rng.integers(
        0, 255, (batch, chunk, image_size, image_size, 1), np.uint8))

    _, checksum, state = streaming_step(model, host.to(device), None)
    checksum.item()
    lats = []
    for i in range(warmup + timed):
        t0 = time.perf_counter()
        _, checksum, state = streaming_step(model, host.to(device), state)
        checksum.item()                       # the whole round trip
        if i >= warmup:
            lats.append(time.perf_counter() - t0)
    lats_ms = np.asarray(lats) * 1e3
    return {
        "chunk": chunk,
        "batch": batch,
        "image_size": image_size,
        "calls": timed,
        "latency_ms_p50": float(np.percentile(lats_ms, 50)),
        "latency_ms_p95": float(np.percentile(lats_ms, 95)),
        "latency_ms_p99": float(np.percentile(lats_ms, 99)),
        "latency_ms_mean": float(lats_ms.mean()),
        "latency_ms_per_frame_p50": float(np.percentile(lats_ms, 50) / chunk),
        "device": _device_name(device),
    }


def measure_train_step_time(step: Callable[[], Dict[str, Tensor]],
                            device: torch.device,
                            warmup: int = 2, timed: int = 10
                            ) -> Dict[str, float]:
    """Seconds a training step: ``step()`` runs one step on its own state
    and batch on ``device`` (e.g. ``lambda: train_step(state, batch, cfg)``)
    and returns its metrics.  The clock stops after a fetch of the last
    step's loss and, on a CUDA device, ``torch.cuda.synchronize``."""
    sync = ((lambda: torch.cuda.synchronize(device)) if device.type == "cuda"
            else (lambda: None))
    for _ in range(warmup):
        metrics = step()
    metrics["loss"].item()
    sync()
    t0 = time.perf_counter()
    for _ in range(timed):
        metrics = step()
    metrics["loss"].item()
    sync()
    dt = (time.perf_counter() - t0) / timed
    return {"sec_per_step": dt, "steps_per_sec": 1.0 / dt}
