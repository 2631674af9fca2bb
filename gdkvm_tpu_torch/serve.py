"""Serving: a slot-pool batching engine with a stdlib HTTP front end and
client (port of gdkvm_tpu/serve.py: the live model on one device or split
over a mesh of devices, or an exported artifact of io/export.py).

Design:
  - A fixed pool of ``streams`` slots.  Every tick advances all slots in one
    batched model call.  Slots with no pending work are computed too, but
    their state is frozen (``torch.where`` on an active flag), so the batch
    never changes shape.
  - Session resets ride the tick as a per-slot flag applied on the device;
    only active slots' masks are gathered on the device, and they cross to
    the host bit-packed (1/2/4 bits a pixel for ≤2/4/16 classes, an exact
    transform), in a power-of-two bucket of slots.
  - One-deep pipelining: tick t+1 is launched before tick t's masks are
    fetched.  The masks are copied into pinned host memory without
    blocking, a CUDA event is recorded after the copy, and the delivery
    waits on that event alone, so host delivery overlaps device compute.
  - Each request thread stages its video on the device (pinned host copy,
    non-blocking upload), resizes it there when its frames are not at the
    engine size, splits it into ``chunk``-frame pieces and enqueues them in
    order; pieces of different sessions ride the same tick.  Uploads and
    ticks are issued from different threads to the device's current stream
    (the default stream unless a caller changes it), so they run in the
    order they were issued.
  - Backpressure: in-flight request bytes are bounded (``max_inflight_mb``);
    beyond the bound ``infer`` raises :class:`EngineOverloaded` (HTTP 429).
  - Idle sessions are reclaimed after ``session_ttl`` seconds.
  - Over a mesh (``mesh=``, parallel/mesh.py, ``data`` × ``model``
    devices) the S slots split into D groups of S/D, one group per row of
    the mesh, each with its own state.  With ``model`` = 1 a group holds
    the model's replica on its device (one replica a distinct device); with
    ``model`` = M > 1 it spreads the model over its row's M devices
    (models/gdkvm.py's ``HeadParallel``): each device holds a shard of the
    LKVA heads and those heads of each slot's state, and the row's first
    device runs the encoder and the decoder and sums the shards' partial
    readouts.  A request is staged on its group's first device; a tick
    launches every group's step, then gathers each group's masks.  Slots
    never interact, so with ``model`` = 1 the masks are the one-device
    engine's, and with M > 1 they differ only by the order of the heads'
    sum.

The engine runs on its model's device (an artifact's: where it was
exported; a mesh's devices) and never moves work elsewhere: a CUDA model
runs on its card, a CPU model on the CPU.  Grad mode is
thread-local in PyTorch, so the engine's threads enter
``torch.inference_mode()`` themselves: the GDR runs its residual-free
forward whatever the caller's mode.

Endpoints:
  POST   /v1/sessions                  → {"session": id, "slot": n}
  POST   /v1/sessions/<id>/infer       .npy (T,H,W[,1]) u8 → .npy (T,H,W) u8
  DELETE /v1/sessions/<id>             → {"closed": true}
  GET    /healthz                      → model/config info JSON
"""

from __future__ import annotations

import copy
import io
import json
import re
import threading
import time
import uuid
from collections import OrderedDict, deque
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from gdkvm_tpu_torch.eval.metrics import mask_from_logits
from gdkvm_tpu_torch.eval.streaming import model_device
from gdkvm_tpu_torch.io.export import ServingModel, load_artifact
from gdkvm_tpu_torch.models.gdkvm import GDKVM, HeadParallel, StreamState
from gdkvm_tpu_torch.ops.preproc import resize_matrices, resize_u8

Tensor = torch.Tensor

_RESIZE_CACHE_MAX = 8        # distinct source resolutions whose matrices are kept


def _np_bytes(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def _np_from_bytes(data: bytes) -> np.ndarray:
    return np.load(io.BytesIO(data), allow_pickle=False)


class EngineOverloaded(RuntimeError):
    """Raised when the in-flight byte budget is exhausted (HTTP 429)."""


class _Piece:
    """One chunk-sized unit of work for a slot."""

    __slots__ = ("frames_dev", "done", "masks", "error", "nbytes",
                 "t_enq", "t_disp", "depth")

    def __init__(self, frames_dev: Optional[Tensor], nbytes: int):
        self.frames_dev = frames_dev
        self.nbytes = nbytes
        self.done = threading.Event()
        self.masks: Optional[np.ndarray] = None
        self.error: Optional[Exception] = None
        # Enqueue time, dispatch time and the queue depth at enqueue split
        # a request's latency into waiting and device work (drain_stats).
        self.t_enq: Optional[float] = None
        self.t_disp: Optional[float] = None
        self.depth: int = 0


def _model_step(model: GDKVM | HeadParallel):
    """The engine's step around ``model``: (frames_u8, mems, seen) →
    (logits, mems, seen), ``mems`` the tuple of the state's memory tensors
    (one; a HeadParallel model's, one a device)."""
    spread = isinstance(model, HeadParallel)

    def step(frames_u8, mems, seen):
        logits, st = model(frames_u8.to(torch.float32) / 255.0,
                           StreamState(mem=mems if spread else mems[0], frames_seen=seen))
        return logits, st.mem if spread else (st.mem,), st.frames_seen
    return step


def _artifact_step(sm: ServingModel):
    """The engine's step around an artifact (one memory tensor)."""
    def step(frames_u8, mems, seen):
        logits, mem, seen = sm.step(frames_u8, mems[0], seen)
        return logits, (mem,), seen
    return step


class _Group:
    """One row of the mesh's share of the slot pool: slots [lo, hi), the
    step of the model there, and the slots' state: ``mem`` a tuple of the
    memory of each of the row's devices (their heads; one device without a
    model axis)."""

    def __init__(self, lo: int, hi: int, device: torch.device, raw_step) -> None:
        self.lo, self.hi, self.device, self.raw_step = lo, hi, device, raw_step
        self.mem: Tuple[Tensor, ...] = ()
        self.seen: Optional[Tensor] = None
        self.zero: Optional[Tensor] = None


class BatchingEngine:
    """Slot-pool batching engine around one multi-stream step a tick: the
    model's, or an exported artifact's (``artifact``: its directory or a
    loaded :class:`~gdkvm_tpu_torch.io.export.ServingModel`, exported for
    batch ``streams`` and chunk ``chunk``; the image size is its own).
    ``mesh`` (a :class:`~gdkvm_tpu_torch.parallel.mesh.Mesh` of D × M
    devices in this process, model path only) splits the slots into D
    groups, one per row of M devices, the heads split over the row;
    ``streams`` must divide by D."""

    def __init__(self, *, model: Optional[GDKVM] = None, streams: int = 4,
                 chunk: int = 16, image_size: int = 112, warmup: bool = True,
                 max_inflight_mb: float = 256.0, pack_masks: bool = True,
                 session_ttl: Optional[float] = None, mesh=None,
                 artifact: Optional[str | ServingModel] = None):
        self.streams = streams
        self.chunk = chunk
        self._mesh = mesh
        if mesh is not None:
            if artifact is not None:
                raise ValueError(
                    "mesh serving requires the model path — an exported "
                    "artifact is already lowered for one device")
            if mesh.distributed:
                raise ValueError("mesh serving drives every device from one process; "
                                 "a mesh over a process group has one")
            if streams % mesh.data:
                raise ValueError(
                    f"streams={streams} must be divisible by the mesh "
                    f"data axis ({mesh.data}) so every device owns whole slots")
        if artifact is not None:
            sm = load_artifact(artifact) if isinstance(artifact, str) else artifact
            sig = sm.meta["signature"]
            if sig["frames_u8"][0] != streams or sig["frames_u8"][1] != chunk:
                raise ValueError(
                    f"artifact was exported for batch={sig['frames_u8'][0]} "
                    f"chunk={sig['frames_u8'][1]}; serve requested "
                    f"streams={streams} chunk={chunk} — re-export with "
                    f"--batch/--chunk matching the serve config")
            self.image_size, self.in_channels = sig["frames_u8"][2], sig["frames_u8"][4]
            self.num_classes = sm.meta["num_classes"]
            mem_shapes = [((sm.device,), tuple(sig["mem"][1:]))]
            self._groups = [_Group(0, streams, sm.device, _artifact_step(sm))]
        else:
            cfg = model.cfg
            self.image_size, self.in_channels = image_size, cfg.in_channels
            self.num_classes = cfg.num_classes
            rows = ([mesh.row(d) for d in range(mesh.data)] if mesh is not None
                    else [(model_device(model),)])
            per = streams // len(rows)
            replicas: Dict[torch.device, GDKVM] = {model_device(model): model}
            self._groups = []
            for g, row in enumerate(rows):
                if len(row) > 1:
                    step_model = HeadParallel(model, row)
                else:
                    if row[0] not in replicas:
                        replicas[row[0]] = copy.deepcopy(model).to(row[0])
                    step_model = replicas[row[0]]
                self._groups.append(_Group(g * per, (g + 1) * per, row[0],
                                           _model_step(step_model)))
            heads = (cfg.num_heads // len(rows[0]), cfg.head_dim_k, cfg.head_dim_v)
            mem_shapes = [(row, heads) for row in rows]
        self.device = self._groups[0].device

        # Mask transfer packing: exact b-bit encoding, b = bits needed for
        # num_classes, provided the row length divides the pixels/byte.
        bits = 1 if self.num_classes <= 2 else \
            2 if self.num_classes <= 4 else \
            4 if self.num_classes <= 16 else 8
        self._pack_bits = bits if (pack_masks and bits < 8 and
                                   self.image_size % (8 // bits) == 0) else 8

        with torch.inference_mode():
            for g, (row, shape) in zip(self._groups, mem_shapes):
                g.mem = tuple(torch.zeros((g.hi - g.lo, *shape), dtype=torch.float32,
                                          device=dev) for dev in row)
                g.seen = torch.zeros((g.hi - g.lo,), dtype=torch.int32,
                                     device=g.device)
                g.zero = torch.zeros((chunk, self.image_size, self.image_size,
                                      self.in_channels), dtype=torch.uint8,
                                     device=g.device)

        self._resize_cache: "OrderedDict[tuple, Tuple[Tensor, Tensor]]" = \
            OrderedDict()
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._queues: Dict[int, deque] = {}      # slot → deque[_Piece]
        self._sessions: Dict[str, int] = {}      # session id → slot
        self._free = list(range(streams))[::-1]  # pop() yields slot 0 first
        # Idle-session GC: a crashed client would otherwise hold its slot
        # forever.  A session with no queued work whose last activity
        # (open / enqueue / tick) is older than session_ttl seconds is
        # reclaimed by the batcher thread.
        self.session_ttl = session_ttl
        self._last_active: Dict[int, float] = {}  # slot → monotonic time
        self.sessions_reclaimed = 0
        # Per-piece (queue wait ms, service ms, depth at enqueue), bounded;
        # samples pushed out of a full deque before a drain are counted.
        self._stats: deque = deque(maxlen=8192)
        self.stats_dropped = 0
        self._reset_slots: set = set()
        self._closed = False
        self._paused = False
        self._inflight_bytes = 0
        self._max_inflight = int(max_inflight_mb * 1e6)
        self.ticks = 0
        # The batcher thread warms up before it takes work, and the
        # constructor waits for it (a failed warm-up raises here).
        self._ready = threading.Event()
        self._warmup_error: Optional[Exception] = None
        self._thread = threading.Thread(target=self._run, args=(warmup,),
                                        daemon=True)
        self._thread.start()
        self._ready.wait()
        if self._warmup_error is not None:
            self._thread.join()
            raise self._warmup_error

    # -- device side -----------------------------------------------------------

    def _group_of(self, slot: int) -> _Group:
        return self._groups[slot // (self.streams // len(self._groups))]

    @staticmethod
    def _to_device(arr: np.ndarray, device: torch.device) -> Tensor:
        """A copy of ``arr`` on ``device``: through pinned host memory,
        without blocking, on a card."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t.clone()

    def _step(self, g: _Group, frames: Tensor, flags: Tensor) -> Tensor:
        """One tick of group ``g``: advance its slots, freeze inactive
        slots' state.

        frames (S_g, chunk, H, W, C) uint8; flags (2, S_g) fp32: flags[0] =
        1 for an active slot (inactive slots compute, but their state does
        not move and their masks are dropped), flags[1] = 1 for a slot whose
        state is zeroed before the tick (a new session).  → masks (S_g,
        chunk, H, W) uint8.  The state tensors are replaced, never written
        in place.
        """
        active, resets = flags[0], flags[1]
        per_slot = (-1, 1, 1, 1)
        mem_in = tuple(m * (1.0 - resets.to(m.device)).view(per_slot) for m in g.mem)
        seen_in = g.seen * (1 - resets.to(torch.int32))
        logits, mem, seen = g.raw_step(frames, mem_in, seen_in)
        masks = mask_from_logits(logits)
        g.mem = tuple(torch.where(active.to(m.device).view(per_slot) > 0, m, m0)
                      for m, m0 in zip(mem, mem_in))
        g.seen = torch.where(active > 0, seen, seen_in)
        return masks

    def _post_bucket(self, n_active: int) -> int:
        """Gather size for n_active slots of a group: the next power of
        two, capped at the group's size.  At most log2(S)+1 transfer shapes,
        each warmed up by the constructor, for at most twice the bytes on
        odd counts."""
        b = 1
        while b < n_active:
            b *= 2
        return min(b, self.streams // len(self._groups))

    def _post(self, masks: Tensor, idx: Tensor) -> Tensor:
        """Gather the slots ``idx`` of (S, chunk, H, W) uint8 masks and
        bit-pack them along W, on the masks' device."""
        m = masks.index_select(0, idx)
        bits = self._pack_bits
        if bits >= 8:
            return m
        ppb = 8 // bits
        m = m.reshape(*m.shape[:-1], m.shape[-1] // ppb, ppb).to(torch.int32)
        weights = 2 ** (bits * torch.arange(ppb, dtype=torch.int32,
                                            device=m.device))
        return (m * weights).sum(-1).to(torch.uint8)

    def _unpack(self, packed: np.ndarray) -> np.ndarray:
        """Host-side exact inverse of the device bit-pack."""
        bits = self._pack_bits
        if bits >= 8:
            return packed
        ppb = 8 // bits
        lanes = [(packed >> (bits * i)) & ((1 << bits) - 1)
                 for i in range(ppb)]
        out = np.stack(lanes, axis=-1)               # (..., W/ppb, ppb)
        return out.reshape(packed.shape[:-1] + (packed.shape[-1] * ppb,))

    @staticmethod
    def _fetch_async(out: Tensor):
        """Start the copy of ``out`` to the host → (host tensor, event to
        wait on, or None where the copy is already complete)."""
        if out.device.type != "cuda":
            return out, None
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(out.device))
        return host, event

    @staticmethod
    def _frames(g: _Group, batch_pieces: Dict[int, "_Piece"]) -> Tensor:
        """Group ``g``'s (S_g, chunk, H, W, C) frames of the tick: each
        slot's staged piece, idle slots a zero chunk."""
        frames = [g.zero] * (g.hi - g.lo)
        for slot, piece in batch_pieces.items():
            if g.lo <= slot < g.hi:
                frames[slot - g.lo] = piece.frames_dev
        return torch.stack(frames)

    def _warmup(self) -> None:
        """One tick and every post bucket of each group on the batcher
        thread, before it takes work, so that the first request does not
        pay the kernels' build and first launches (nor, on the CPU, oneDNN's
        per-thread set-up of its convolutions, ~1 s)."""
        for g in self._groups:
            n = g.hi - g.lo
            masks = self._step(g, self._frames(g, {}), self._to_device(
                np.zeros((2, n), np.float32), g.device))
            for nb in sorted({self._post_bucket(i) for i in range(1, n + 1)}):
                self._post(masks, self._to_device(np.zeros(nb, np.int64), g.device)).cpu()

    # -- session management ----------------------------------------------------

    def open_session(self) -> Optional[dict]:
        with self._lock:
            if not self._free:
                return None
            slot = self._free.pop()
            sid = uuid.uuid4().hex[:12]
            self._sessions[sid] = slot
            self._queues[slot] = deque()
            self._reset_slots.add(slot)     # zero state before first use
            self._last_active[slot] = time.monotonic()
            return {"session": sid, "slot": slot}

    def close_session(self, sid: str) -> bool:
        with self._lock:
            slot = self._sessions.pop(sid, None)
            if slot is None:
                return False
            pending = self._queues.pop(slot, None)
            self._last_active.pop(slot, None)
            self._free.append(slot)
        # Fail any queued pieces so a concurrent infer() unblocks instead
        # of waiting forever on work that will never be scheduled.
        for piece in (pending or ()):
            self._finish(piece, error=KeyError(
                f"session {sid!r} closed with work pending"))
        return True

    def slot_of(self, sid: str) -> Optional[int]:
        with self._lock:
            return self._sessions.get(sid)

    def pause(self) -> None:
        """Hold the batcher: queued work stays queued until resume()."""
        with self._work:
            self._paused = True

    def resume(self) -> None:
        with self._work:
            self._paused = False
            self._work.notify_all()

    # -- inference ---------------------------------------------------------------

    def _device_resize(self, video: Tensor) -> Tensor:
        """Resize a staged (T, H, W, C) uint8 video to the engine size on
        its device, with the resize matrices kept per source shape in an
        LRU of ``_RESIZE_CACHE_MAX``; masks are then at the engine size."""
        # Over a mesh, the other devices' matrices are kept apart.
        key = ("resize", tuple(video.shape[1:3])) + (
            (video.device,) if video.device != self.device else ())
        size = (self.image_size, self.image_size)
        with self._lock:
            mats = self._resize_cache.get(key)
            if mats is not None:
                self._resize_cache.move_to_end(key)
        if mats is None:
            mats = resize_matrices(key[1], size, video.device)
            with self._lock:
                self._resize_cache[key] = mats
                while len(self._resize_cache) > _RESIZE_CACHE_MAX:
                    self._resize_cache.popitem(last=False)
        return resize_u8(video, size, matrices=mats)

    def _split(self, video: Tensor) -> Tuple[Tensor, ...]:
        """A staged, padded video → its ``chunk``-frame pieces (views)."""
        return video.split(self.chunk)

    def _finish(self, piece: _Piece, masks=None, error=None) -> None:
        now = time.monotonic()
        with self._lock:
            self._inflight_bytes -= piece.nbytes
            if piece.t_enq is not None and piece.t_disp is not None \
                    and error is None:
                self.stats_dropped += len(self._stats) == self._stats.maxlen
                self._stats.append(
                    ((piece.t_disp - piece.t_enq) * 1e3,   # queue wait ms
                     (now - piece.t_disp) * 1e3,           # service ms
                     piece.depth))
        piece.masks = masks
        piece.error = error
        piece.done.set()

    def drain_stats(self):
        """Return and clear the per-piece (wait_ms, service_ms,
        depth_at_enqueue) samples collected since the last drain."""
        with self._lock:
            out = list(self._stats)
            self._stats.clear()
        return out

    def infer(self, sid: str, video_u8: np.ndarray) -> np.ndarray:
        """Blocking: segment (T, H, W[, 1]) uint8, threading the session's
        state → (T, S, S) uint8 masks at the engine size S.

        One in-flight infer per session: the memory is a causal recurrence,
        so a second concurrent call on the same session would interleave
        its chunks into the first call's state timeline.  Different
        sessions batch together freely."""
        slot = self.slot_of(sid)
        if slot is None:
            raise KeyError(f"unknown session {sid!r}")
        if video_u8.ndim == 3:
            video_u8 = video_u8[..., None]
        if video_u8.ndim != 4 or video_u8.shape[0] < 1 \
                or video_u8.shape[-1] != self.in_channels:
            raise ValueError(f"frames must be (T, H, W[, {self.in_channels}]) "
                             f"with T >= 1, got {video_u8.shape}")
        t_total, hh, ww = video_u8.shape[:3]
        with self._lock:
            if self._inflight_bytes + video_u8.nbytes > self._max_inflight:
                raise EngineOverloaded(
                    f"in-flight request bytes would exceed the "
                    f"{self._max_inflight // 10**6} MB budget — retry later")
        n_pieces = -(-t_total // self.chunk)
        pad = n_pieces * self.chunk - t_total
        # Stage the whole request on the device in one upload, resize it
        # there if needed, pad the tail by repeating the last frame (as
        # stream_video does), and split it into pieces.
        with torch.inference_mode():
            video = self._to_device(video_u8, self._group_of(slot).device)
            if (hh, ww) != (self.image_size, self.image_size):
                video = self._device_resize(video)
            if pad:
                video = torch.cat([video, video[-1:].expand(
                    pad, *video.shape[1:])])
            devs = self._split(video)
        piece_bytes = video.numel() // n_pieces
        pieces = [_Piece(d, piece_bytes) for d in devs]
        with self._work:
            # Re-validate the SESSION, not just the slot: while this request
            # was staged, idle-session GC may have reclaimed the session and
            # open_session() handed the slot to a new client, whose state
            # these frames must not enter.
            if self._sessions.get(sid) != slot:
                raise KeyError(f"session {sid!r} closed")
            q = self._queues.get(slot)
            if q is None:
                raise KeyError(f"session {sid!r} closed")
            q.extend(pieces)
            now = time.monotonic()
            for i, p in enumerate(pieces):
                p.t_enq = now
                p.depth = len(q) - len(pieces) + i  # pieces ahead of it
            self._last_active[slot] = now
            self._inflight_bytes += sum(p.nbytes for p in pieces)
            self._work.notify()
        outs = []
        for p in pieces:
            p.done.wait()
            if p.error is not None:
                raise p.error
            outs.append(p.masks)
        return np.concatenate(outs)[:t_total]

    # -- batcher loop --------------------------------------------------------------

    def _deliver(self, pending) -> None:
        """Wait for one launched tick's (gathered, packed) masks to reach
        the host, group by group, and wake the waiting request threads."""
        fetched, batch_pieces = pending
        try:
            for host, event, idx in fetched:
                if event is not None:
                    event.synchronize()
                masks = self._unpack(host.numpy())
                for j, slot in enumerate(idx):
                    self._finish(batch_pieces[slot], masks=masks[j])
        except Exception as exc:          # deliver, don't kill the loop
            for piece in batch_pieces.values():
                self._finish(piece, error=exc)

    def _stale_sids(self):
        """Sessions idle past session_ttl with no queued work (caller
        holds self._lock)."""
        ttl = self.session_ttl
        if not ttl:
            return []
        now = time.monotonic()
        return [sid for sid, slot in self._sessions.items()
                if not self._queues.get(slot)
                and now - self._last_active.get(slot, now) > ttl]

    def _close_if_stale(self, sid: str) -> bool:
        """Re-check staleness and close under one lock (GC path only), so a
        request that lands between the GC's scan and the close keeps its
        session."""
        ttl = self.session_ttl
        with self._lock:
            slot = self._sessions.get(sid)
            if slot is None:
                return False
            now = time.monotonic()
            if (self._queues.get(slot) or not ttl
                    or now - self._last_active.get(slot, now) <= ttl):
                return False            # became active again — keep it
            self._sessions.pop(sid)
            self._queues.pop(slot, None)
            self._last_active.pop(slot, None)
            self._free.append(slot)
        return True

    def _reclaim_idle(self) -> None:
        """Idle-session GC (batcher thread): reclaim slots whose client
        went away."""
        with self._lock:
            stale = self._stale_sids()
        for sid in stale:
            if self._close_if_stale(sid):
                self.sessions_reclaimed += 1

    def _run(self, warmup: bool) -> None:
        with torch.inference_mode():
            try:
                if warmup:
                    self._warmup()
            except Exception as exc:         # handed to the constructor
                self._warmup_error = exc
                return
            finally:
                self._ready.set()
            self._loop()

    def _loop(self) -> None:
        pending = None        # ([(host, event, slots) a group], batch_pieces) of tick t
        while True:
            self._reclaim_idle()
            with self._work:
                while not self._closed and pending is None and \
                        (self._paused or not any(
                            self._queues.get(s) for s in self._queues)):
                    if self._stale_sids():
                        break            # release lock; reclaim up top
                    self._work.wait(timeout=0.5)
                closed = self._closed
                batch_pieces: Dict[int, _Piece] = {}
                resets: set = set()
                if not closed and not self._paused:
                    now = time.monotonic()
                    for slot, q in self._queues.items():
                        if q:
                            piece = q.popleft()
                            piece.t_disp = now
                            batch_pieces[slot] = piece
                            self._last_active[slot] = now
                    resets = self._reset_slots
                    self._reset_slots = set()
            if closed:
                if pending is not None:
                    self._deliver(pending)
                return
            nxt = None
            if batch_pieces or resets:
                try:
                    flags = np.zeros((2, self.streams), np.float32)
                    for slot in resets:
                        flags[1, slot] = 1.0
                    for slot in batch_pieces:
                        flags[0, slot] = 1.0
                    # Every group's step is launched before any gather.
                    masks = [self._step(g, self._frames(g, batch_pieces),
                                        self._to_device(flags[:, g.lo:g.hi], g.device))
                             for g in self._groups]
                    fetched = []
                    for g, m in zip(self._groups, masks):
                        idx = sorted(s for s in batch_pieces if g.lo <= s < g.hi)
                        if not idx:
                            continue
                        nb = self._post_bucket(len(idx))
                        local = [s - g.lo for s in idx]
                        local += [local[-1]] * (nb - len(local))
                        out = self._post(m, self._to_device(
                            np.asarray(local, np.int64), g.device))
                        fetched.append((*self._fetch_async(out), idx))
                    if fetched:
                        nxt = (fetched, batch_pieces)
                    self.ticks += 1
                except Exception as exc:   # deliver, don't kill the loop
                    with self._lock:       # resets were not applied
                        self._reset_slots |= resets
                    for piece in batch_pieces.values():
                        self._finish(piece, error=exc)
            # Overlap: tick t+1 is already launched; now deliver tick t.
            if pending is not None:
                self._deliver(pending)
            pending = nxt

    def close(self) -> None:
        with self._work:
            self._closed = True
            self._work.notify_all()
        self._thread.join(timeout=30)
        # Fail anything still queued so no request thread waits forever.
        with self._lock:
            leftover = [p for q in self._queues.values() for p in q]
            self._queues.clear()
        for piece in leftover:
            self._finish(piece, error=RuntimeError("engine closed"))


# ---------------------------------------------------------------------------
# HTTP layer (stdlib only).
# ---------------------------------------------------------------------------

_SESS_RE = re.compile(r"^/v1/sessions/([0-9a-f]+)(/infer)?$")


def make_server(engine: BatchingEngine, host: str = "127.0.0.1",
                port: int = 0):
    """Build a ThreadingHTTPServer bound to (host, port)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # TCP_NODELAY: the handler writes status, headers and body as
        # separate small sends; with Nagle on, the last one waits for the
        # client's delayed ACK, about 40 ms a request on loopback.
        disable_nagle_algorithm = True

        def log_message(self, *args):          # quiet by default
            pass

        def _json(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _bytes(self, code: int, body: bytes,
                   ctype: str = "application/octet-stream"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {
                    "ok": True,
                    "streams": engine.streams,
                    "chunk": engine.chunk,
                    "image_size": engine.image_size,
                    "num_classes": engine.num_classes,
                    "ticks": engine.ticks,
                    "session_ttl": engine.session_ttl,
                    "sessions_reclaimed": engine.sessions_reclaimed,
                    "stats_dropped": engine.stats_dropped,
                    "mesh": (engine._mesh.shape if engine._mesh is not None
                             else None),
                    "device": str(engine.device),
                })
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            if self.path == "/v1/sessions":
                out = engine.open_session()
                if out is None:
                    self._json(409, {"error": "all stream slots busy",
                                     "streams": engine.streams})
                else:
                    self._json(200, out)
                return
            m = _SESS_RE.match(self.path)
            if m and m.group(2):
                sid = m.group(1)
                length = int(self.headers.get("Content-Length", "0"))
                data = self.rfile.read(length)
                try:
                    video = _np_from_bytes(data)
                    if video.dtype != np.uint8:
                        raise ValueError("frames must be uint8")
                    masks = engine.infer(sid, video)
                except KeyError as exc:
                    self._json(404, {"error": str(exc)})
                    return
                except EngineOverloaded as exc:
                    self._json(429, {"error": str(exc)})
                    return
                except Exception as exc:
                    self._json(400, {"error": f"{type(exc).__name__}: "
                                              f"{exc}"})
                    return
                self._bytes(200, _np_bytes(masks))
                return
            self._json(404, {"error": "not found"})

        def do_DELETE(self):
            m = _SESS_RE.match(self.path)
            if m and not m.group(2):
                ok = engine.close_session(m.group(1))
                self._json(200 if ok else 404, {"closed": ok})
                return
            self._json(404, {"error": "not found"})

    return ThreadingHTTPServer((host, port), Handler)


class ServeClient:
    """Minimal stdlib client: one session = one streaming video.

    Session-management calls (health/open/close) retry on transient
    connection errors.  infer() is never retried: the server threads each
    chunk through a causal memory state, so a blind resend could replay
    frames into the recurrence; a stalled server surfaces as a clean
    TimeoutError instead."""

    def __init__(self, host: str, port: int, timeout: float = 120.0,
                 retries: int = 1):
        self.host, self.port, self.timeout = host, port, timeout
        self.retries = retries
        self.session: Optional[str] = None
        self._c = None          # persistent keep-alive connection

    def _conn(self):
        import http.client
        import socket as _socket
        if self._c is None:
            c = http.client.HTTPConnection(self.host, self.port,
                                           timeout=self.timeout)
            # TCP_NODELAY on the client side too: http.client sends the
            # request line, headers and body separately.  self._c is set
            # only after connect and setsockopt succeed: a half-connected
            # object would reconnect on the next request without it.
            try:
                c.connect()
                c.sock.setsockopt(_socket.IPPROTO_TCP,
                                  _socket.TCP_NODELAY, 1)
            except Exception:
                c.close()
                raise
            self._c = c
        return self._c

    def _drop_conn(self):
        if self._c is not None:
            try:
                self._c.close()
            except Exception:
                pass
            self._c = None

    def _request(self, method: str, path: str, body: bytes = b"",
                 retry: bool = True):
        """One HTTP round trip over a persistent connection, dropped and
        rebuilt on any transport error."""
        attempts = (self.retries + 1) if retry else 1
        last: Optional[Exception] = None
        for _ in range(attempts):
            try:
                # Connect inside the retried block: a transient error
                # during the handshake gets the same retry policy.
                c = self._conn()
                c.request(method, path, body=body)
                r = c.getresponse()
                data = r.read()
                return r.status, r.getheader("Content-Type", ""), data
            except TimeoutError as exc:
                self._drop_conn()
                last = TimeoutError(
                    f"server {self.host}:{self.port} did not answer "
                    f"{method} {path} within {self.timeout}s")
                last.__cause__ = exc
                if not retry:
                    break
            except (ConnectionError, OSError) as exc:
                self._drop_conn()
                last = exc
        raise last

    def health(self) -> dict:
        status, _, data = self._request("GET", "/healthz")
        if status != 200:
            raise RuntimeError(f"/healthz answered {status}: {data!r}")
        return json.loads(data)

    def open(self) -> dict:
        status, _, data = self._request("POST", "/v1/sessions")
        out = json.loads(data)
        if status != 200:
            raise RuntimeError(out.get("error", data))
        self.session = out["session"]
        return out

    def infer(self, video_u8: np.ndarray) -> np.ndarray:
        if not self.session:
            raise RuntimeError("open() a session first")
        status, ctype, data = self._request(
            "POST", f"/v1/sessions/{self.session}/infer",
            _np_bytes(np.ascontiguousarray(video_u8)), retry=False)
        if status != 200:
            raise RuntimeError(json.loads(data).get("error", data))
        return _np_from_bytes(data)

    def close(self) -> None:
        if self.session:
            self._request("DELETE", f"/v1/sessions/{self.session}")
            self.session = None
        self._drop_conn()
