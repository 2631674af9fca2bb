"""In-process streaming inference: frames in, masks out, with the memory
state carried (port of gdkvm_tpu/eval/streaming.py: ``StreamingSegmenter``,
``stream_video``, ``stream_evaluate`` and its multi-stream form).

The model runs on the device its parameters are on.  Every chunk step runs
under ``torch.inference_mode()``: uint8 frames are divided by 255, go through
the model, and the argmax gives uint8 masks.
"""

from __future__ import annotations

import time
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from gdkvm_tpu_torch.eval import metrics as M
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


Video = Tuple[np.ndarray, np.ndarray, np.ndarray]   # frames, masks, valid


def _eval_videos(cfg, num_videos: int, video_len: int) -> List[Video]:
    """Whole videos with per-frame ground truth and validity: the
    configured EchoNet val split's, else synthetic ones (seeds 1000 + i)."""
    k = cfg.model.num_classes
    videos = []
    if cfg.data.dataset == "echonet":
        from gdkvm_tpu_torch.data.echonet import EchoNetDataset
        ds = EchoNetDataset(cfg.data.data_path, cfg.data.val_split,
                            image_size=cfg.data.image_size,
                            clip_len=cfg.data.clip_len, num_classes=k)
        for i in range(min(num_videos, len(ds))):
            name = ds.videos[i]
            vid = ds.decode_video(name)
            masks = np.zeros(vid.shape[:3], np.uint8)
            valid = np.zeros((vid.shape[0],), np.float32)
            for t in range(vid.shape[0]):
                m = ds.mask_for(name, t, vid.shape[1:3])
                if m is not None:
                    masks[t] = m
                    valid[t] = 1.0
            videos.append((vid, masks, valid))
    else:
        from gdkvm_tpu_torch.data import synthetic
        for i in range(num_videos):
            f, m = synthetic.generate_video(1000 + i, video_len,
                                            cfg.data.image_size,
                                            cfg.data.image_size, k,
                                            cfg.data.synth_difficulty)
            videos.append((f, m, np.ones((video_len,), np.float32)))
    return videos


def _probe(videos: List[Video], occlude: bool, window_only: bool) -> List[Video]:
    """The acoustic-dropout probe: blank a region that covers the LV over
    the 4 frames ending at the last traced (else the middle) frame
    (``occlude``), and/or score those frames only (``window_only``)."""
    probed = []
    for vid, gt, valid in videos:
        anchors = np.where(valid > 0)[0]
        es = int(anchors[-1]) if anchors.size else vid.shape[0] // 2
        lo = max(es - 3, 0)
        if occlude:
            vid = vid.copy()
            hh, ww = vid.shape[1:3]
            for t in range(lo, es + 1):
                vid[t, int(0.27 * hh):int(0.76 * hh),
                    int(0.22 * ww):int(0.80 * ww)] = 0
        if window_only:
            window = np.zeros_like(valid)
            window[lo:es + 1] = 1.0
            valid = valid * window
        probed.append((vid, gt, valid))
    return probed


def _stage(device: torch.device, *arrays: np.ndarray) -> Tuple[Tensor, ...]:
    """Copies of ``arrays`` on ``device``: through pinned memory and without
    blocking for a card, so that a run's uploads queue up behind each other
    and overlap its compute."""
    out = []
    for a in arrays:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out.append(t)
    return tuple(out)


@torch.inference_mode()
def stream_evaluate(cfg, model: GDKVM, num_videos: int = 8,
                    video_len: int = 128, reset_state: bool = False,
                    occlude: bool = False, streams: int = 1,
                    consistency: bool = False,
                    probe_window_only: bool = False) -> Dict[str, float]:
    """Full-sequence streaming eval: each video through the chunked
    recurrence (``eval_stage.stream_chunk`` frames a call), Dice on its
    valid frames, end-to-end frames/s.

    Videos come from the configured dataset when it has whole videos
    (EchoNet), else from the synthetic generator.

    Ablation knobs: ``reset_state`` zeroes the memory between chunks (with
    ``stream_chunk=1``, a per-frame baseline without memory); ``occlude``
    blanks a region over the LV around the last traced (or middle) frame;
    ``probe_window_only`` scores only the 4 frames the probe covers, also
    on clean runs, so that carry and reset compare like with like;
    ``consistency`` adds the predictions' temporal stability.

    ``streams`` > 1 runs that many videos in flight as one batched
    recurrence (serving mode): videos are grouped and padded to the group's
    longest with valid=0 frames, which add nothing to the Dice sums, and
    each stream carries its own state.

    One pass runs untimed first (kernel builds, cuDNN's search).  The clock
    stops at the one fetch of the pass's Dice sums, which waits for every
    chunk queued before it.
    """
    k = cfg.model.num_classes
    chunk = cfg.eval_stage.stream_chunk
    videos = _eval_videos(cfg, num_videos, video_len)
    if occlude or probe_window_only:
        videos = _probe(videos, occlude, probe_window_only)

    if streams > 1:
        if consistency:
            warnings.warn("consistency is computed in single-stream mode "
                          "only; ignoring it for streams > 1")
        return _stream_evaluate_ms(model, videos, k, chunk, streams, reset_state)

    device = model_device(model)

    def run_video(vid, gt, valid, acc):
        """One video: every chunk staged up front, then the chunk steps and
        their Dice sums queued with no fetch in between."""
        v_pad = np.zeros((-(-vid.shape[0] // chunk) * chunk,), np.float32)
        v_pad[: valid.shape[0]] = valid
        staged = [_stage(device, c, g[..., 0], v_pad[i * chunk:(i + 1) * chunk])
                  for i, (c, g) in enumerate(zip(
                      _chunk_video(vid, chunk), _chunk_video(gt[..., None], chunk)))]
        state, mask_chunks = None, []
        for c, g, v in staged:
            logits, state = model(c[None].to(torch.float32) / 255.0, state)
            if reset_state:
                state = None      # ablation: no memory across chunks
            masks = mask_from_logits(logits)
            part = M.dice_sums(masks, g[None], v[None], k)
            acc = part if acc is None else M.dice_merge(acc, part)
            if consistency:
                mask_chunks.append(masks[0])
        return acc, mask_chunks

    if videos:                                    # the untimed pass
        M.dice_finalize(run_video(*videos[0], None)[0])

    acc, frames_done, per_video_masks = None, 0, []
    t0 = time.perf_counter()
    for vid, gt, valid in videos:
        acc, mask_chunks = run_video(vid, gt, valid, acc)
        per_video_masks.append((mask_chunks, vid.shape[0]))
        frames_done += vid.shape[0]
    out = M.dice_finalize(acc) if acc is not None else {}     # the fetch
    elapsed = time.perf_counter() - t0
    out["stream_frames_per_sec"] = frames_done / max(elapsed, 1e-9)
    out["videos"] = float(len(videos))
    if consistency:
        # Fetched after the clock stopped.
        cons = [M.temporal_consistency(
                    torch.cat(chunks).cpu().numpy()[:n_frames])
                for chunks, n_frames in per_video_masks if chunks]
        if cons:
            out["temporal_fg_iou"] = float(
                np.mean([c["temporal_fg_iou"] for c in cons]))
            out["flicker_rate"] = float(
                np.mean([c["flicker_rate"] for c in cons]))
    return out


def _stream_evaluate_ms(model: GDKVM, videos: List[Video], num_classes: int,
                        chunk: int, streams: int, reset_state: bool
                        ) -> Dict[str, float]:
    """Multi-stream body of :func:`stream_evaluate`: groups of ``streams``
    videos run as one batched chunked recurrence.  Group members are padded
    to the group's longest (rounded up to the chunk) with valid=0 frames, so
    the Dice sums are exact; a short last group is padded with empty
    streams of valid=0, which keeps the batch shape and adds nothing."""
    device = model_device(model)

    def build_group(group):
        t_max = max(v[0].shape[0] for v in group)
        t_pad = -(-t_max // chunk) * chunk
        hh, ww = group[0][0].shape[1:3]
        frames = np.zeros((streams, t_pad, hh, ww, 1), np.uint8)
        gt = np.zeros((streams, t_pad, hh, ww), np.uint8)
        valid = np.zeros((streams, t_pad), np.float32)
        for j, (vid, g, v) in enumerate(group):
            t = vid.shape[0]
            frames[j, :t] = vid if vid.ndim == 4 else vid[..., None]
            gt[j, :t] = g
            valid[j, :t] = v
        return [_stage(device, frames[:, lo:lo + chunk], gt[:, lo:lo + chunk],
                       valid[:, lo:lo + chunk])
                for lo in range(0, t_pad, chunk)]

    def run_group(chunks, acc):
        state = None
        for f_c, g_c, v_c in chunks:
            logits, state = model(f_c.to(torch.float32) / 255.0, state)
            if reset_state:
                state = None
            part = M.dice_sums(mask_from_logits(logits), g_c, v_c, num_classes)
            acc = part if acc is None else M.dice_merge(acc, part)
        return acc

    groups = [build_group(videos[i:i + streams])
              for i in range(0, len(videos), streams)]
    M.dice_finalize(run_group(groups[0], None))   # the untimed pass

    frames_done = sum(v[0].shape[0] for v in videos)
    acc = None
    t0 = time.perf_counter()
    for g in groups:
        acc = run_group(g, acc)
    out = M.dice_finalize(acc)                    # the fetch
    elapsed = time.perf_counter() - t0
    out["stream_frames_per_sec"] = frames_done / max(elapsed, 1e-9)
    out["videos"] = float(len(videos))
    out["streams"] = float(streams)
    return out
