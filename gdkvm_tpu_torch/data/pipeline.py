"""Input pipeline: dataset factory, host batching and augmentation, and
the prefetch to the device (port of gdkvm_tpu/data/pipeline.py).

Batches stay uint8 on the host (a quarter of fp32's bytes over PCIe); the
train step normalizes on the device (train/loop.py).  Decode and
augmentation run in a thread pool; :func:`prefetch_to_device` keeps
``size`` batches in flight: a producer thread stages each batch in pinned
memory and copies it on a side CUDA stream, so the copy of batch N+1
overlaps the step on batch N.  Every random draw is made as the JAX
package's iterator makes it, so the same seed gives the same bytes.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, Iterator, Tuple, Union

import numpy as np
import torch

from gdkvm_tpu_torch.config.schema import DataConfig

Array = Union[np.ndarray, torch.Tensor]


@dataclass
class Batch:
    """One batch: frames (B, T, H, W, 1) uint8; masks (B, T, H, W) uint8
    class ids; valid (B, T) float32, 1 where the frame has ground truth.
    numpy arrays from :func:`batch_iterator`, tensors after the prefetch or
    from the device cache."""
    frames: Array
    masks: Array
    valid: Array


def make_dataset(cfg: DataConfig, split: str, num_classes: int):
    """Dataset factory keyed by ``cfg.dataset``."""
    if cfg.dataset == "synthetic":
        from gdkvm_tpu_torch.data.synthetic import SyntheticDataset
        n = 64 if split == "train" else 8
        return SyntheticDataset(num_clips=n, clip_len=cfg.clip_len,
                                image_size=cfg.image_size,
                                num_classes=num_classes,
                                seed=cfg.seed + (0 if split == "train" else 1),
                                difficulty=cfg.synth_difficulty)
    if cfg.dataset == "camus":
        from gdkvm_tpu_torch.data.camus import CamusDataset
        return CamusDataset(cfg.data_path, split=split,
                            image_size=cfg.image_size,
                            clip_len=cfg.clip_len, num_classes=num_classes)
    if cfg.dataset == "echonet":
        from gdkvm_tpu_torch.data.echonet import EchoNetDataset
        return EchoNetDataset(cfg.data_path, split=split,
                              image_size=cfg.image_size,
                              clip_len=cfg.clip_len, num_classes=num_classes,
                              seed=cfg.seed)
    if cfg.dataset == "packed":
        from gdkvm_tpu_torch.data.packed import PackedDataset
        return PackedDataset(os.path.join(cfg.data_path, f"{split}.pck"),
                             num_workers=cfg.num_workers)
    raise ValueError(f"unknown dataset {cfg.dataset!r}")


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
                   seed: int = 0, num_workers: int = 4,
                   drop_last: bool = True, loop: bool = True,
                   start_step: int = 0,
                   shard: Tuple[int, int] = (0, 1)) -> Iterator[Batch]:
    """Yield host batches (numpy) forever (``loop``) or for one epoch.

    Every draw comes from a generator seeded by ``(seed, epoch)`` (the
    order), ``(seed, epoch, batch, slot)`` (a clip's augmentation) or
    ``(seed, epoch, batch)`` (a gathered batch's flips), so the stream is a
    pure function of the seed whatever the threads do, and ``start_step``
    fast-forwards the schedule without touching data: a resumed run sees
    the batches an unbroken run would have seen.  Clips load in a pool of
    ``num_workers`` threads; a dataset with ``gather`` (the packed format)
    loads a whole batch in one call.

    ``shard=(r, W)``: yield only rows [r·n/W, (r+1)·n/W) of each batch of n
    (a data-parallel rank's share), loading only those clips; every draw is
    made as for the whole batch, so the W shards put together are the
    unsharded batch.
    """
    pool = ThreadPoolExecutor(max_workers=max(num_workers, 1))
    n = len(dataset)
    if drop_last:
        batches_per_epoch = max(n // batch_size, 1)
    else:
        batches_per_epoch = max(-(-n // batch_size), 1)

    def load(args) -> tuple:
        idx, erng = args
        frames, masks, valid = dataset[idx]
        if augment:
            f, m = _augment(erng, frames, masks, occlude_prob)
            return f, m, valid
        return frames, masks, valid

    has_gather = hasattr(dataset, "gather")

    epoch = (start_step // batches_per_epoch) if loop else 0
    step = epoch * batches_per_epoch
    try:
        while True:
            order = np.arange(n)
            if shuffle:
                np.random.default_rng((seed, epoch, 0x0D0E)).shuffle(order)
            for bi, lo in enumerate(range(0, n, batch_size)):
                idxs = order[lo:lo + batch_size]
                if len(idxs) < batch_size and drop_last:
                    continue
                if step < start_step:
                    step += 1
                    continue
                step += 1
                rows = range(len(idxs) * shard[0] // shard[1],
                             len(idxs) * (shard[0] + 1) // shard[1])
                if has_gather:
                    yield _gathered(dataset, idxs, augment, occlude_prob,
                                    (seed, epoch, bi), rows)
                    continue
                items = list(pool.map(load, [
                    (int(idxs[j]), np.random.default_rng((seed, epoch, bi, j)))
                    for j in rows]))
                yield Batch(frames=np.stack([it[0] for it in items]),
                            masks=np.stack([it[1] for it in items]),
                            valid=np.stack([it[2] for it in items]))
            epoch += 1
            if not loop:
                break
    finally:
        pool.shutdown(wait=False)


def _gathered(dataset, idxs: np.ndarray, augment: bool, occlude_prob: float,
              key: Tuple[int, int, int], rows: range) -> Batch:
    """The ``rows`` of one batch through ``dataset.gather``: the gather
    flips (without the GIL in the native library); gain and gamma apply
    here as a 256-entry uint8 table per clip, one ``take`` and no per-pixel
    power."""
    brng = np.random.default_rng(key)
    flips = ((brng.random(len(idxs)) < 0.5).astype(np.uint8)[rows.start:rows.stop]
             if augment else None)
    frames, masks, valid = dataset.gather(idxs[rows.start:rows.stop], flips)
    if augment:
        for i, j in enumerate(rows):
            crng = np.random.default_rng((*key, j, 1))
            if crng.random() < 0.5:
                gain = crng.uniform(0.8, 1.25)
                gamma = crng.uniform(0.8, 1.25)
                lut = (np.clip(gain * (np.arange(256) / 255.0) ** gamma,
                               0, 1) * 255).astype(np.uint8)
                frames[i] = lut[frames[i]]
        if occlude_prob > 0:
            for i, j in enumerate(rows):
                frames[i] = _occlude(np.random.default_rng((*key, j)),
                                     frames[i], occlude_prob)
    return Batch(frames=frames, masks=masks, valid=valid)


class _PinnedRing:
    """``slots`` sets of pinned staging buffers, used in turn.  A slot is
    written again only after the copy that last read it has finished (its
    event), so ``slots`` = batches in the queue + the one being staged + the
    one the consumer holds never waits in practice."""

    def __init__(self, slots: int) -> None:
        self.buffers: list[Dict[tuple, torch.Tensor]] = [{} for _ in range(slots)]
        self.events: list[torch.cuda.Event | None] = [None] * slots
        self.turn = 0

    def stage(self, arrays: Tuple[np.ndarray, ...], device: torch.device,
              stream: torch.cuda.Stream) -> Tuple[Tuple[torch.Tensor, ...], torch.cuda.Event]:
        slot = self.turn % len(self.buffers)
        self.turn += 1
        if self.events[slot] is not None:
            self.events[slot].synchronize()
        out = []
        with torch.cuda.stream(stream):
            for i, arr in enumerate(arrays):
                src = torch.from_numpy(np.ascontiguousarray(arr))
                key = (i, tuple(src.shape), src.dtype)
                buf = self.buffers[slot].get(key)
                if buf is None:
                    buf = self.buffers[slot][key] = torch.empty(
                        src.shape, dtype=src.dtype, pin_memory=True)
                buf.copy_(src)
                out.append(buf.to(device, non_blocking=True))
            event = torch.cuda.Event()
            event.record(stream)
        self.events[slot] = event
        return tuple(out), event


def prefetch_to_device(iterator: Iterator[Batch], size: int = 2,
                       device: torch.device | str = "cuda") -> Iterator[Batch]:
    """Keep ``size`` batches in flight to ``device``.

    A daemon thread pulls host batches from ``iterator``.  For a CUDA
    device it stages each in pinned memory (a ring of ``size + 2`` buffers)
    and queues ``to(device, non_blocking=True)`` on a side stream, then
    hands the tensors over with the copy's event; the consumer's current
    stream waits on that event before the batch is yielded, and the tensors
    are recorded on it, so the allocator does not reuse them under the
    step.  For a CPU device the thread only runs the iterator ahead and
    the batches come out as CPU tensors.

    When the consumer abandons the generator the producer stops at its next
    batch; an exception in the producer (or in ``iterator``) is raised in
    the consumer.
    """
    device = torch.device(device)
    q: queue.Queue = queue.Queue(maxsize=max(size, 1))
    stop = object()
    cancel = threading.Event()

    def q_put(item) -> bool:
        while not cancel.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            on_card = device.type == "cuda"
            if on_card:
                stream = torch.cuda.Stream(device)
                ring = _PinnedRing(max(size, 1) + 2)
            for batch in iterator:
                if cancel.is_set():
                    return
                arrays = (batch.frames, batch.masks, batch.valid)
                if on_card:
                    tensors, event = ring.stage(arrays, device, stream)
                else:
                    tensors, event = tuple(torch.as_tensor(a) for a in arrays), None
                if not q_put((Batch(*tensors), event)):
                    return
        except BaseException as exc:   # surface the thread's death in the
            q_put(exc)                 # consumer instead of hanging q.get()
            return
        finally:
            close = getattr(iterator, "close", None)
            if close is not None:      # a generator: let it release its pool
                close()
        q_put(stop)

    threading.Thread(target=producer, daemon=True, name="prefetch_to_device").start()
    try:
        while True:
            item = q.get()
            if item is stop:
                return
            if isinstance(item, BaseException):
                raise item
            batch, event = item
            if event is not None:
                current = torch.cuda.current_stream(device)
                current.wait_event(event)
                for t in (batch.frames, batch.masks, batch.valid):
                    t.record_stream(current)
            yield batch
    finally:
        cancel.set()
