"""Packed cine-clip (PCK) dataset: decode once, then read raw bytes.

Copy of gdkvm_tpu/data/packed.py.  ``write_pck`` converts any clip dataset
(CAMUS, EchoNet, synthetic) into a fixed-record binary file; the training
path then reads it through mmap, a whole batch in one call of the C++
thread-pool gather (``native/pck.cpp`` through ctypes, without the GIL), or
through a numpy gather over the same mmap when the shared library is
absent.  ``PackedDataset.native_gather`` says which of the two it took.

Build the native library with ``make -C native`` (attempted once at first
use when it is missing).
"""

from __future__ import annotations

import ctypes
import os
import struct
import subprocess
from typing import Optional, Tuple

import numpy as np

_MAGIC = 0x564B4447  # 'GDKV'
_HEADER = struct.Struct("<8I")

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libpck.so")

_lib: Optional[ctypes.CDLL] = None
_lib_tried = False


def _load_native() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native gather library; None if absent."""
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    if not os.path.exists(_LIB_PATH):
        try:
            subprocess.run(["make", "-C", _NATIVE_DIR, "-s"], check=True,
                           capture_output=True, timeout=120)
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.pck_open.restype = ctypes.c_void_p
    lib.pck_open.argtypes = [ctypes.c_char_p]
    lib.pck_close.argtypes = [ctypes.c_void_p]
    for fn in ("pck_num_clips", "pck_clip_len", "pck_height", "pck_width"):
        getattr(lib, fn).restype = ctypes.c_uint32
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.pck_gather.restype = ctypes.c_int32
    lib.pck_gather.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int32,
    ]
    _lib = lib
    return _lib


def write_pck(path: str, dataset, *, show_progress: bool = False) -> None:
    """Convert a clip dataset (indexable → (frames, masks, valid)) to PCK."""
    n = len(dataset)
    f0, m0, v0 = dataset[0]
    t, hh, ww = f0.shape[0], f0.shape[1], f0.shape[2]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as fh:
        fh.write(_HEADER.pack(_MAGIC, 1, n, t, hh, ww, 0, 0))
        for i in range(n):
            frames, masks, valid = dataset[i] if i else (f0, m0, v0)
            assert frames.shape[:3] == (t, hh, ww), "ragged clip shapes"
            fh.write(np.ascontiguousarray(
                frames[..., 0] if frames.ndim == 4 else frames,
                np.uint8).tobytes())
            fh.write(np.ascontiguousarray(masks, np.uint8).tobytes())
            fh.write(np.ascontiguousarray(valid, np.float32).tobytes())


class PackedDataset:
    """Random-access clip dataset over a PCK file.

    Single-clip __getitem__ matches the other datasets' contract; the fast
    path is :meth:`gather` — one native call per batch.
    """

    def __init__(self, path: str, num_workers: int = 0):
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"{path} not found (create with "
                f"gdkvm_tpu_torch.data.packed.write_pck)")
        self.path = path
        self.num_workers = num_workers
        self._native = _load_native()
        self._handle = None
        if self._native is not None:
            self._handle = self._native.pck_open(path.encode())
            if not self._handle:
                self._native = None
        if self._native is not None:
            self.num_clips = self._native.pck_num_clips(self._handle)
            self.clip_len = self._native.pck_clip_len(self._handle)
            self.height = self._native.pck_height(self._handle)
            self.width = self._native.pck_width(self._handle)
        else:
            with open(path, "rb") as fh:
                magic, ver, n, t, hh, ww, _, _ = _HEADER.unpack(
                    fh.read(_HEADER.size))
            if magic != _MAGIC or ver != 1:
                raise ValueError(f"{path} is not a v1 PCK file")
            self.num_clips, self.clip_len = n, t
            self.height, self.width = hh, ww
        # Which gather this dataset takes: the native library's or numpy's.
        self.native_gather = self._native is not None
        thw = self.clip_len * self.height * self.width
        self._rec = thw * 2 + self.clip_len * 4
        self._mm = np.memmap(path, np.uint8, "r")

    def __len__(self) -> int:
        return int(self.num_clips)

    def close(self) -> None:
        if self._native is not None and self._handle:
            self._native.pck_close(self._handle)
            self._handle = None

    def gather(self, indices: np.ndarray,
               flips: Optional[np.ndarray] = None
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Batch gather: (B,T,H,W,1) u8 frames, (B,T,H,W) u8 masks,
        (B,T) f32 valid.  Native thread-pool when available."""
        b = len(indices)
        t, hh, ww = self.clip_len, self.height, self.width
        frames = np.empty((b, t, hh, ww), np.uint8)
        masks = np.empty((b, t, hh, ww), np.uint8)
        valid = np.empty((b, t), np.float32)
        idx32 = np.ascontiguousarray(indices, np.int32)
        if self._native is not None:
            fl = None
            if flips is not None:
                fl = np.ascontiguousarray(flips, np.uint8)
            rc = self._native.pck_gather(
                self._handle,
                idx32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                fl.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
                if fl is not None else None,
                b,
                frames.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                masks.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                valid.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                self.num_workers,
            )
            if rc != 0:
                raise IndexError(f"pck_gather failed (rc={rc}) for indices "
                                 f"{indices}")
        else:
            thw = t * hh * ww
            for j, i in enumerate(idx32):
                if not 0 <= i < self.num_clips:
                    raise IndexError(f"clip index {i} out of range")
                off = _HEADER.size + int(i) * self._rec
                frames[j] = self._mm[off:off + thw].reshape(t, hh, ww)
                masks[j] = self._mm[off + thw:off + 2 * thw].reshape(
                    t, hh, ww)
                valid[j] = self._mm[off + 2 * thw:off + self._rec].view(
                    np.float32).reshape(t)
                if flips is not None and flips[j]:
                    frames[j] = frames[j, :, :, ::-1]
                    masks[j] = masks[j, :, :, ::-1]
        return frames[..., None], masks, valid

    def __getitem__(self, idx: int
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        f, m, v = self.gather(np.array([idx], np.int32))
        return f[0], m[0], v[0]
