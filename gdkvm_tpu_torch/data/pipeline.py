"""Host input pipeline: dataset factory, augmentation, batching (numpy).

Port of the host part of gdkvm_tpu/data/pipeline.py.  Batches stay uint8
on the host; the train step moves them to the device and normalizes there
(train/loop.py).  ``_augment`` and ``_occlude`` draw from a
``np.random.Generator`` exactly as the JAX package's do, so the same
generator gives identical arrays.  Prefetching, pinned memory and a device
cache are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np

from gdkvm_tpu_torch.config.schema import DataConfig


@dataclass
class Batch:
    """One batch: frames (B, T, H, W, 1) uint8; masks (B, T, H, W) uint8
    class ids; valid (B, T) float32, 1 where the frame has ground truth."""
    frames: np.ndarray
    masks: np.ndarray
    valid: np.ndarray


def make_dataset(cfg: DataConfig, split: str, num_classes: int):
    """Dataset factory keyed by ``cfg.dataset``; only "synthetic" is
    ported."""
    if cfg.dataset == "synthetic":
        from gdkvm_tpu_torch.data.synthetic import SyntheticDataset
        n = 64 if split == "train" else 8
        return SyntheticDataset(num_clips=n, clip_len=cfg.clip_len,
                                image_size=cfg.image_size,
                                num_classes=num_classes,
                                seed=cfg.seed + (0 if split == "train" else 1),
                                difficulty=cfg.synth_difficulty)
    raise NotImplementedError(
        f"dataset={cfg.dataset!r} is not ported (ROADMAP Queue 1, item 6); "
        f"use dataset='synthetic'")


def _augment(rng: np.random.Generator, frames: np.ndarray,
             masks: np.ndarray, occlude_prob: float = 0.0
             ) -> tuple[np.ndarray, np.ndarray]:
    """Horizontal flip, brightness/gamma, and optional acoustic-dropout
    occlusion (frames blanked, ground truth kept)."""
    if rng.random() < 0.5:
        frames = frames[:, :, ::-1]
        masks = masks[:, :, ::-1]
    if rng.random() < 0.5:
        gain = rng.uniform(0.8, 1.25)
        gamma = rng.uniform(0.8, 1.25)
        x = frames.astype(np.float32) / 255.0
        x = np.clip(gain * np.power(x, gamma), 0, 1)
        frames = (x * 255).astype(np.uint8)
    if occlude_prob > 0:
        frames = _occlude(rng, np.ascontiguousarray(frames), occlude_prob)
    return np.ascontiguousarray(frames), np.ascontiguousarray(masks)


def _occlude(rng: np.random.Generator, frames: np.ndarray,
             occlude_prob: float) -> np.ndarray:
    """Blank a region over 1-4 consecutive frames (never frame 0), in
    place."""
    if rng.random() >= occlude_prob:
        return frames
    t_total, hh, ww = frames.shape[:3]
    if t_total <= 1:
        return frames
    span = int(rng.integers(1, min(4, t_total - 1) + 1))
    start = int(rng.integers(1, t_total - span + 1))
    oh = int(rng.uniform(0.4, 0.7) * hh)
    ow = int(rng.uniform(0.4, 0.7) * ww)
    oy = int(rng.integers(0, hh - oh + 1))
    ox = int(rng.integers(0, ww - ow + 1))
    frames[start:start + span, oy:oy + oh, ox:ox + ow] = 0
    return frames


def batch_iterator(dataset, batch_size: int, *, shuffle: bool = True,
                   augment: bool = False, occlude_prob: float = 0.0,
                   seed: int = 0) -> Iterator[Batch]:
    """Yield batches forever, dropping each epoch's ragged tail.

    Every draw comes from a generator seeded by ``(seed, epoch)`` (the
    order) or ``(seed, epoch, batch, slot)`` (a clip's augmentation), as in
    the JAX package's host path, so the stream is a pure function of the
    seed.  Clips load one after another on the calling thread.
    """
    n = len(dataset)
    if n < batch_size:
        raise ValueError(f"{n} clips cannot fill a batch of {batch_size}")
    epoch = 0
    while True:
        order = np.arange(n)
        if shuffle:
            np.random.default_rng((seed, epoch, 0x0D0E)).shuffle(order)
        for bi, lo in enumerate(range(0, n - batch_size + 1, batch_size)):
            items = []
            for j, idx in enumerate(order[lo:lo + batch_size]):
                frames, masks, valid = dataset[int(idx)]
                if augment:
                    frames, masks = _augment(
                        np.random.default_rng((seed, epoch, bi, j)), frames,
                        masks, occlude_prob)
                items.append((frames, masks, valid))
            yield Batch(frames=np.stack([it[0] for it in items]),
                        masks=np.stack([it[1] for it in items]),
                        valid=np.stack([it[2] for it in items]))
        epoch += 1
