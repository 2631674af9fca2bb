"""The GDR forward scan as a hand-written CUDA kernel, and its dispatch.

:func:`gdr_fwd_cuda` launches ``csrc/gdr_fwd.cu`` (the port of the Pallas
TPU kernel ``_gdr_kernel`` in gdkvm_tpu/ops/gdr_pallas.py, forward only, no
residual outputs).  :func:`gdr_fwd` is the ``gdr_impl="auto"`` entry point:
it launches the kernel for CUDA tensors and runs the plain version,
``core.gdr.gdr_chunked``, for CPU tensors.  A CUDA tensor never takes the
plain version: the kernel launches or the call raises.

Shapes as in ``core/gdr.py``: q, k (B, H, T, N, d_k); v (B, H, T, N, d_v);
beta, eta (B, H, T, N); alpha (B, H, T); s0 (B, H, d_k, d_v) →
o (B, H, T, N, d_v) fp32, s_T (B, H, d_k, d_v) fp32.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from gdkvm_tpu_torch.core import gdr
from gdkvm_tpu_torch.ops import _build

Tensor = torch.Tensor

# Launches of the CUDA kernel (counted where it launches, and nowhere else).
LAUNCHES = gdr.CallCount()

# Dynamic shared memory one block may use on Hopper (227 KB).
SMEM_LIMIT_BYTES = 232_448


def smem_bytes(n: int, dk: int, dv: int) -> int:
    """Shared memory of one block at (N, d_k, d_v): S, Q, K with rows padded
    to d_k+1, [U | W] and A, in fp32 (mirrors ``smem_floats`` in the
    source)."""
    return 4 * (dk * dv + n * dk + n * (dk + 1) + n * (dv + dk) + n * n)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build.build("gdr_fwd")))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gdr_fwd.argtypes = [p] * 9 + [i] * 7 + [p]
    lib.gdr_fwd.restype = ctypes.c_int
    lib.gdr_error_string.argtypes = [ctypes.c_int]
    lib.gdr_error_string.restype = ctypes.c_char_p
    lib.gdr_fwd_smem_bytes.argtypes = [i, i, i]
    lib.gdr_fwd_smem_bytes.restype = ctypes.c_size_t
    return lib


def _check(name: str, x: Tensor, shape: tuple, dtypes: tuple,
           device: torch.device) -> None:
    if tuple(x.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {shape}")
    if x.dtype not in dtypes:
        raise ValueError(f"{name}: dtype {x.dtype}, expected one of {dtypes}")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous (call .contiguous())")


def gdr_fwd_cuda(q: Tensor, k: Tensor, v: Tensor, beta: Tensor, alpha: Tensor,
                 s0: Tensor, eta: Optional[Tensor] = None
                 ) -> Tuple[Tensor, Tensor]:
    """Launch the CUDA GDR forward kernel.  Raises on a CPU tensor, on a
    shape, dtype or layout it does not take, and on a failed launch."""
    if not q.is_cuda:
        raise ValueError(f"gdr_fwd_cuda takes CUDA tensors, got q on {q.device}")
    eta = beta if eta is None else eta
    if q.dim() != 5 or v.dim() != 5:
        raise ValueError("q, k, v must be (B, H, T, N, d)")
    b, h, t, n, dk = q.shape
    dv = v.shape[-1]
    dev = q.device
    io_types = (torch.float32, torch.bfloat16)
    _check("q", q, (b, h, t, n, dk), io_types, dev)
    _check("k", k, (b, h, t, n, dk), (q.dtype,), dev)
    _check("v", v, (b, h, t, n, dv), (q.dtype,), dev)
    _check("beta", beta, (b, h, t, n), (torch.float32,), dev)
    _check("eta", eta, (b, h, t, n), (torch.float32,), dev)
    _check("alpha", alpha, (b, h, t), (torch.float32,), dev)
    _check("s0", s0, (b, h, dk, dv), (torch.float32,), dev)
    if min(b, h, t, n, dk, dv) < 1:
        raise ValueError(f"empty GDR input: q {tuple(q.shape)}, v {tuple(v.shape)}")
    need = smem_bytes(n, dk, dv)
    if need > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"GDR kernel tiles at N={n}, d_k={dk}, d_v={dv} need {need} B of "
            f"shared memory, over the {SMEM_LIMIT_BYTES} B a block may use")

    lib = _lib()
    o = torch.empty((b, h, t, n, dv), dtype=torch.float32, device=dev)
    s_t = torch.empty((b, h, dk, dv), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.gdr_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          beta.data_ptr(), eta.data_ptr(), alpha.data_ptr(),
                          s0.data_ptr(), o.data_ptr(), s_t.data_ptr(),
                          b, h, t, n, dk, dv, int(q.dtype == torch.bfloat16),
                          stream)
    if err != 0:
        raise RuntimeError(f"gdr_fwd launch failed: CUDA error {err} "
                           f"({lib.gdr_error_string(err).decode()})")
    LAUNCHES.n += 1
    return o, s_t


def gdr_fwd(q: Tensor, k: Tensor, v: Tensor, beta: Tensor, alpha: Tensor,
            s0: Tensor, eta: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """``gdr_impl="auto"``: the kernel for CUDA tensors, the plain chunked
    form for CPU tensors."""
    if q.is_cuda:
        return gdr_fwd_cuda(q, k, v, beta, alpha, s0, eta)
    return gdr.gdr_chunked(q, k, v, beta, alpha, s0, eta)
