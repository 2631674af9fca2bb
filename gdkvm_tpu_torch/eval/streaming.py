"""In-process streaming inference: frames in, masks out, with the memory
state carried (port of ``StreamingSegmenter``, ``stream_video`` and
``_chunk_video`` in gdkvm_tpu/eval/streaming.py).

The model runs on the device its parameters are on.  Every chunk step runs
under ``torch.inference_mode()``: uint8 frames are divided by 255, go through
the model, and the argmax gives uint8 masks.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from gdkvm_tpu_torch.eval.metrics import mask_from_logits
from gdkvm_tpu_torch.models.gdkvm import GDKVM, StreamState

Tensor = torch.Tensor


def model_device(model: GDKVM) -> torch.device:
    return next(model.parameters()).device


class StreamingSegmenter:
    """Stateful wrapper: feed chunks of frames, get per-frame logits."""

    def __init__(self, model: GDKVM, chunk: int = 16) -> None:
        self.model = model
        self.chunk = chunk
        self.device = model_device(model)
        self.state: Optional[StreamState] = None

    def reset(self) -> None:
        """Drop the carried memory (the next feed starts a fresh
        recurrence)."""
        self.state = None

    @torch.inference_mode()
    def feed(self, frames_u8) -> Tensor:
        """frames_u8: (T ≤ chunk, H, W, 1) uint8 (numpy or tensor) → logits
        (T, H, W, K) fp32.  A short chunk is padded with zero frames to the
        chunk length; their outputs are dropped and, the recurrence being
        causal, change nothing before them."""
        x = torch.as_tensor(frames_u8).to(self.device)
        t = x.shape[0]
        if t < self.chunk:
            x = torch.cat([x, x.new_zeros((self.chunk - t,) + x.shape[1:])])
        logits, self.state = self.model(x[None].to(torch.float32) / 255.0,
                                        self.state)
        return logits[0, :t]


def _chunk_video(video_u8: np.ndarray, chunk: int) -> List[np.ndarray]:
    """Split (T, H, W, 1) into fixed-size chunks, edge-padding the tail."""
    out = []
    for lo in range(0, video_u8.shape[0], chunk):
        piece = video_u8[lo:lo + chunk]
        if piece.shape[0] < chunk:
            pad = chunk - piece.shape[0]
            piece = np.concatenate([piece, np.repeat(piece[-1:], pad, axis=0)])
        out.append(piece)
    return out


@torch.inference_mode()
def stream_video(model: GDKVM, video_u8: np.ndarray, chunk: int = 16,
                 prompt_mask: Optional[np.ndarray] = None) -> np.ndarray:
    """Segment a whole video (T, H, W, 1) uint8 by chunked streaming →
    (T, H, W) uint8 argmax masks.  T is padded up to a multiple of
    ``chunk`` by repeating the last frame; the padded outputs are dropped.
    ``prompt_mask`` (H, W) class ids is written into the memory before
    frame 0, inside the first chunk's call."""
    device = model_device(model)
    state = None
    outs = []
    for i, piece in enumerate(_chunk_video(video_u8, chunk)):
        x = torch.from_numpy(np.ascontiguousarray(piece)).to(device)
        x = x[None].to(torch.float32) / 255.0
        if i == 0 and prompt_mask is not None:
            prompt = torch.from_numpy(np.asarray(prompt_mask, np.int32))
            logits, state = model(x, None, prompt[None].to(device))
        else:
            logits, state = model(x, state)
        outs.append(mask_from_logits(logits[0]))
    return torch.cat(outs).cpu().numpy()[:video_u8.shape[0]]
