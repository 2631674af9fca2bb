"""Device-resident dataset cache with sampling and augmentation on the
device (port of gdkvm_tpu/data/device_cache.py).

Echo datasets are small (a CAMUS split at 256² is 1-2 GB of uint8), so the
whole training split is uploaded once and a batch is assembled where the
model runs: index sampling, gather, flip, gain/gamma and occlusion are
plain tensor ops on uint8 tensors on the card, and a step moves no batch
over PCIe.

Sampling is uniform with replacement, drawn from a ``torch.Generator`` on
the cache's device that the train step reseeds every step
(:func:`step_seed`), so a batch is a pure function of the seeds and the
step and a resumed run sees the batches an unbroken run would have seen.
Augmentation follows the host pipeline's semantics (data/pipeline.py
``_augment``): per clip a horizontal flip (p = 0.5), gain and gamma jitter
(p = 0.5, both U[0.8, 1.25]) and acoustic-dropout occlusion (1-4
consecutive frames, never frame 0, a region of U[0.4, 0.7] of each side
blanked; frames blanked, ground truth kept).  The draws are torch's, not
``jax.random``'s: the two packages agree in distribution, not in bits.

Datasets above ``data.device_cache_max_mb`` keep the threaded host
pipeline (``data.device_cache``: auto | on | off).
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, fields
from typing import Optional, Sequence

import numpy as np
import torch

from gdkvm_tpu_torch.data.pipeline import Batch

Tensor = torch.Tensor


@dataclass
class DeviceDataset:
    """All clips of a split on the device: frames (N, T, H, W, C) uint8,
    masks (N, T, H, W) uint8, valid (N, T) float32."""
    frames: Tensor
    masks: Tensor
    valid: Tensor


def dataset_nbytes(dataset) -> int:
    """Estimated resident size of a clip dataset (uint8 frames and masks)."""
    f, m, v = dataset[0]
    per_clip = f.nbytes + m.nbytes + v.nbytes
    return per_clip * len(dataset)


def video_nbytes_estimate(dataset, sample: int = 4) -> int:
    """Estimated resident size of a whole-video cache.  Every video is
    padded to the longest at build time, so the estimate takes the longest
    of a small sample of videos; ``build_video_cache`` checks the true size
    against the limit before it uploads."""
    n = len(dataset)
    stride = max(n // min(sample, n), 1)
    per_frame = 0
    f_max = 0
    for i in list(range(0, n, stride))[:sample]:
        f, m, v = dataset.full_video(i)
        f_max = max(f_max, f.shape[0])
        per_frame = (f.nbytes + m.nbytes) // max(f.shape[0], 1) + 4
    return per_frame * f_max * n


def resolve_cache_mode(data_cfg, dataset) -> str:
    """Pick the cache strategy: "clip" (snapshot of fixed clips), "video"
    (whole videos, windows sampled on the device, which keeps a stochastic
    dataset's random-window distribution), or "off"."""
    mode = getattr(data_cfg, "device_cache", "auto")
    if mode == "off":
        return "off"
    if mode not in ("auto", "on"):
        raise ValueError(f"data.device_cache must be auto|on|off, "
                         f"got {mode!r}")
    stochastic = getattr(dataset, "stochastic_items", False)
    has_videos = hasattr(dataset, "full_video")
    if mode == "on":
        if stochastic and not has_videos:
            warnings.warn(
                "device_cache=on with a stochastic dataset (random clip "
                "window per access) and no full_video() accessor: caching "
                "FREEZES one window per video for the whole run.")
            return "clip"
        return "video" if stochastic else "clip"
    # auto: cache only when the estimated resident size fits.
    limit = getattr(data_cfg, "device_cache_max_mb", 2048) * 1024 * 1024
    if stochastic:
        if not has_videos:
            return "off"
        return "video" if video_nbytes_estimate(dataset) <= limit else "off"
    return "clip" if dataset_nbytes(dataset) <= limit else "off"


def _upload(host, device: torch.device | str):
    """A copy of the dataclass ``host`` of numpy arrays as tensors on
    ``device``."""
    return type(host)(**{f.name: torch.from_numpy(getattr(host, f.name)).to(device)
                         for f in fields(host)})


def build_device_cache(dataset, device: torch.device | str) -> DeviceDataset:
    """Stack every clip on the host and upload once."""
    frames, masks, valid = [], [], []
    for i in range(len(dataset)):
        f, m, v = dataset[i]
        frames.append(f)
        masks.append(m)
        valid.append(v)
    return _upload(DeviceDataset(
        frames=np.stack(frames), masks=np.stack(masks),
        valid=np.stack(valid).astype(np.float32)), device)


@dataclass
class VideoDeviceCache:
    """Whole videos on the device, padded to the longest; windows are
    sampled on the device (EchoNet-style stochastic datasets).

    frames (N, F, H, W, C) u8; masks (N, F, H, W) u8; valid (N, F) f32;
    length (N,) i32 true frame counts; traced_idx (N, M) i32 traced-frame
    indices (rows padded with 0); n_traced (N,) i32.
    """
    frames: Tensor
    masks: Tensor
    valid: Tensor
    length: Tensor
    traced_idx: Tensor
    n_traced: Tensor


def build_video_cache(dataset, clip_len: int, device: torch.device | str,
                      max_bytes: Optional[int] = None
                      ) -> Optional[VideoDeviceCache]:
    """Decode every video once (the only host pass), pad, upload.

    Videos shorter than ``clip_len`` are tiled up to it so that any window
    is in bounds.  Known difference from the host path: for such videos
    every sampled window sees the same tiled prefix anchored at frame 0,
    where the host loader (echonet.py ``idxs % t_total``) wraps from any
    start.  With ``max_bytes`` the true padded size (known after decoding;
    the estimate can undershoot when lengths vary) is checked before the
    upload; returns None over budget, so the caller can keep the host
    pipeline instead of running the device out of memory.
    """
    frames, masks, valid = [], [], []
    for i in range(len(dataset)):
        f, m, v = dataset.full_video(i)
        if f.shape[0] < clip_len:                 # tile up to clip_len
            reps = -(-clip_len // f.shape[0])
            f = np.concatenate([f] * reps)[:clip_len]
            m = np.concatenate([m] * reps)[:clip_len]
            v = np.concatenate([v] * reps)[:clip_len]
        frames.append(f)
        masks.append(m)
        valid.append(v.astype(np.float32))
    n = len(frames)
    f_max = max(x.shape[0] for x in frames)
    length = np.array([x.shape[0] for x in frames], np.int32)
    traced = [np.nonzero(v > 0)[0].astype(np.int32) for v in valid]
    n_traced = np.array([len(t) for t in traced], np.int32)
    m_max = max(int(n_traced.max()), 1)
    traced_idx = np.zeros((n, m_max), np.int32)
    for i, t in enumerate(traced):
        traced_idx[i, : len(t)] = t

    def pad_to(x, f):
        if x.shape[0] == f:
            return x
        pad = [(0, f - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
        return np.pad(x, pad)

    host = VideoDeviceCache(
        frames=np.stack([pad_to(x, f_max) for x in frames]),
        masks=np.stack([pad_to(x, f_max) for x in masks]),
        valid=np.stack([pad_to(x, f_max) for x in valid]),
        length=length, traced_idx=traced_idx, n_traced=n_traced)
    if max_bytes is not None:
        total = sum(getattr(host, f.name).nbytes for f in fields(host))
        if total > max_bytes:
            warnings.warn(
                f"video cache padded size {total/2**20:.0f} MB exceeds "
                f"device_cache_max_mb ({max_bytes/2**20:.0f} MB): "
                f"keeping the host pipeline")
            return None
    return _upload(host, device)


def step_seed(parts: Sequence[int]) -> int:
    """A 64-bit seed mixed from a tuple of integers (numpy's SeedSequence),
    for reseeding a generator as a pure function of e.g. ``(train.seed, 17,
    data.seed, step)``."""
    return int(np.random.SeedSequence([int(p) for p in parts])
               .generate_state(1, np.uint64)[0])


def _uniform(gen: torch.Generator, shape, lo: float = 0.0, hi: float = 1.0) -> Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=gen.device)


def sample_video_batch(cache: VideoDeviceCache, gen: torch.Generator,
                       batch_size: int, clip_len: int, *,
                       augment: bool = False,
                       occlude_prob: float = 0.0) -> Batch:
    """Draw anchor-biased windows on the device, as
    ``EchoNetDataset.__getitem__`` does on the host: pick a video; if it
    has traced frames, anchor the window to one (start = clip(anchor −
    U{0..clip_len−1}, 0, len − clip_len)); otherwise a uniform start.  A
    pure function of the cache and the generator's state."""
    dev = cache.frames.device
    n = cache.frames.shape[0]
    idx = torch.randint(0, n, (batch_size,), generator=gen, device=dev)
    length = cache.length[idx]
    ntr = cache.n_traced[idx]
    hi = (length - clip_len).clamp_min(0)

    j = (_uniform(gen, (batch_size,)) * ntr.clamp_min(1)).floor().long()
    anchor = cache.traced_idx[idx].gather(1, j[:, None])[:, 0]
    off = torch.randint(0, clip_len, (batch_size,), generator=gen, device=dev)
    start_tr = torch.minimum((anchor - off).clamp_min(0), hi)
    start_rand = (_uniform(gen, (batch_size,)) * (hi + 1)).floor().to(hi.dtype)
    start = torch.where(ntr > 0, start_tr, start_rand).long()

    window = start[:, None] + torch.arange(clip_len, device=dev)[None, :]
    rows = idx[:, None]
    frames = cache.frames[rows, window]
    masks = cache.masks[rows, window]
    valid = cache.valid[rows, window]
    if augment:
        frames, masks = _augment_device(gen, frames, masks, occlude_prob)
    return Batch(frames=frames, masks=masks, valid=valid)


def sample_batch(cache: DeviceDataset, gen: torch.Generator, batch_size: int,
                 *, augment: bool = False, occlude_prob: float = 0.0) -> Batch:
    """Draw and augment one batch on the device: a pure function of the
    cache and the generator's state."""
    n = cache.frames.shape[0]
    idx = torch.randint(0, n, (batch_size,), generator=gen,
                        device=cache.frames.device)
    frames, masks, valid = cache.frames[idx], cache.masks[idx], cache.valid[idx]
    if augment:
        frames, masks = _augment_device(gen, frames, masks, occlude_prob)
    return Batch(frames=frames, masks=masks, valid=valid)


def _augment_device(gen: torch.Generator, frames: Tensor, masks: Tensor,
                    occlude_prob: float):
    """Device mirror of pipeline._augment (draws per clip)."""
    b, t, h, w, _ = frames.shape
    dev = frames.device

    # Horizontal flip (W axis), p = 0.5 per clip.
    flip = _uniform(gen, (b,)) < 0.5
    frames = torch.where(flip[:, None, None, None, None], frames.flip(3), frames)
    masks = torch.where(flip[:, None, None, None], masks.flip(3), masks)

    # Brightness gain and gamma, p = 0.5 per clip.
    photo = _uniform(gen, (b,)) < 0.5
    gain = _uniform(gen, (b,), 0.8, 1.25)[:, None, None, None, None]
    gamma = _uniform(gen, (b,), 0.8, 1.25)[:, None, None, None, None]
    x = frames.to(torch.float32) * (1.0 / 255.0)
    y = (gain * torch.pow(x, gamma)).clamp(0.0, 1.0)
    frames = torch.where(photo[:, None, None, None, None],
                         (y * 255.0).to(torch.uint8), frames)

    # Acoustic-dropout occlusion: blank a region over 1-4 consecutive
    # frames (never frame 0); ground truth untouched.
    if occlude_prob > 0.0 and t > 1:
        occ = _uniform(gen, (b,)) < occlude_prob
        max_span = min(4, t - 1)
        span = torch.randint(1, max_span + 1, (b,), generator=gen, device=dev)
        u = _uniform(gen, (b, 3))
        start = 1 + (u[:, 0] * (t - span)).floor().long()     # in [1, t - span]
        oh = (_uniform(gen, (b,), 0.4, 0.7) * h).floor().long()
        ow = (_uniform(gen, (b,), 0.4, 0.7) * w).floor().long()
        oy = (u[:, 1] * (h - oh + 1)).floor().long()
        ox = (u[:, 2] * (w - ow + 1)).floor().long()
        it = torch.arange(t, device=dev)[None, :]
        iy = torch.arange(h, device=dev)[None, :]
        ix = torch.arange(w, device=dev)[None, :]
        m_t = (it >= start[:, None]) & (it < (start + span)[:, None])
        m_y = (iy >= oy[:, None]) & (iy < (oy + oh)[:, None])
        m_x = (ix >= ox[:, None]) & (ix < (ox + ow)[:, None])
        blank = (occ[:, None, None, None] & m_t[:, :, None, None]
                 & m_y[:, None, :, None] & m_x[:, None, None, :])     # (B,T,H,W)
        frames = frames.masked_fill(blank[..., None], 0)
    return frames, masks
