"""The GDR scan's CUDA kernels, their autograd, and the dispatch.

- :func:`gdr_fwd_cuda` / :func:`gdr_fwd_cuda_residuals` launch
  ``csrc/gdr_fwd.cu``, the port of the Pallas TPU kernel ``_gdr_kernel``
  (gdkvm_tpu/ops/gdr_pallas.py), without or with its residual outputs
  (S_{t-1} per frame; the frame's WY solve U, W).
- :func:`gdr_chain_cuda` launches ``csrc/gdr_chain.cu``, the port of
  ``_gdr_chain_kernel``: the per-frame chain alone, given every frame's WY
  solve U, W from one batched solve (``core.gdr.wy_transform``), with
  S_{t-1} per frame on request.
- :func:`gdr_bwd_cuda` launches ``csrc/gdr_bwd.cu``, the port of
  ``_gdr_bwd_kernel``: the reverse scan with dS on chip.
- ``GDKVM_GDR_FWD`` picks the forward split, as in the JAX package:
  ``monolith`` (default; ``gdr_fwd.cu`` solves inside the scan) or
  ``chain`` (the batched solve, then ``gdr_chain.cu``).  It is read each
  time a forward runs; the JAX package reads it once, at import.
- :class:`GDRFunction` makes the kernel route differentiable, with the
  three backward modes of the JAX package's ``gdr_pallas_bh`` custom VJP,
  chosen by ``GDKVM_GDR_BWD`` when the forward runs:

  - ``stored`` (default): forward with S_{t-1}, U, W →
    ``core.gdr.gdr_bwd_stored``, plain torch ops batched over all frames
    (the JAX package runs this adjoint in XLA, not in a kernel);
  - ``fused``: forward with S_{t-1} → the backward kernel;
  - ``recompute``: residual-free forward → autograd through
    ``core.gdr.gdr_chunked``.

  In chain mode U and W come from the batched solve and the chain kernel
  writes S_{t-1}.

- :func:`gdr_kernel` is ``gdr_impl="pallas"``: the kernels, or raise.
  :func:`gdr_fwd` is ``gdr_impl="auto"``: the kernels for CUDA tensors, the
  plain ``core.gdr.gdr_chunked`` for CPU tensors.  When no input needs a
  gradient (``torch.no_grad``, ``inference_mode``) both launch one
  residual-free forward kernel.  A CUDA tensor never takes a plain
  version of a kernel: the kernel launches or the call raises.

Shapes as in ``core/gdr.py``: q, k (B, H, T, N, d_k); v (B, H, T, N, d_v);
beta, eta (B, H, T, N); alpha (B, H, T); s0 (B, H, d_k, d_v) →
o (B, H, T, N, d_v) fp32, s_T (B, H, d_k, d_v) fp32.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional, Tuple

import torch

from gdkvm_tpu_torch.core import gdr
from gdkvm_tpu_torch.ops import _build

Tensor = torch.Tensor

# Launches of each CUDA kernel (counted where it launches, and nowhere else).
LAUNCHES = gdr.CallCount()        # gdr_fwd.cu, with or without residuals
CHAIN_LAUNCHES = gdr.CallCount()  # gdr_chain.cu, with or without S_{t-1}
BWD_LAUNCHES = gdr.CallCount()    # gdr_bwd.cu
# Of the forward launches above (either kernel), those that wrote the
# backward's residuals: an inference path shows 0 here.
RESIDUAL_LAUNCHES = gdr.CallCount()

# Dynamic shared memory one block may use on Hopper (227 KB).
SMEM_LIMIT_BYTES = 232_448
PANEL = 32    # rows per panel of the blocked solves (csrc/gdr_panel.cuh)
# The largest d_k the chain kernel's registers hold (kMaxDk in
# csrc/gdr_chain.cu); its shared memory (~31 KB at d_k=64) does not grow
# with N.
CHAIN_MAX_DK = 128


def _panel_floats(dk: int, m: int) -> int:
    """The panel workspace: a d_k × m accumulator (rows padded to m+1), the
    panel's K rows (padded to d_k+1), its A block, its rows of X and its
    η."""
    return dk * (m + 1) + PANEL * (dk + 1) + PANEL * PANEL + PANEL * m + PANEL


def _fwd_small_floats(n: int, dk: int, dv: int) -> int:
    """S, Q, K with rows padded to d_k+1, [U | W] and A."""
    return dk * dv + n * dk + n * (dk + 1) + n * (dv + dk) + n * n


def fwd_uses_panels(n: int, dk: int, dv: int) -> bool:
    """True when the forward kernel's small layout does not fit in shared
    memory, so it solves by panels and reads Q and K from global memory."""
    return 4 * _fwd_small_floats(n, dk, dv) > SMEM_LIMIT_BYTES


def smem_bytes(n: int, dk: int, dv: int) -> int:
    """Shared memory of one forward block at (N, d_k, d_v), fp32 (mirrors
    ``smem_floats`` in ``csrc/gdr_fwd.cu``): S, [U | W] and the panel
    workspace when solving by panels."""
    if fwd_uses_panels(n, dk, dv):
        return 4 * (dk * dv + n * (dv + dk) + _panel_floats(dk, dv + dk))
    return 4 * _fwd_small_floats(n, dk, dv)


def bwd_smem_bytes(n: int, dk: int, dv: int) -> int:
    """Shared memory of one backward block: S̃, dS, dS̃ (rows padded to
    d_v+1), padded K, β, η, 8 warp partials, the panel workspace, and a
    panel's X rows (padded) and d(ηK) rows (mirrors ``smem_floats`` in
    ``csrc/gdr_bwd.cu``)."""
    m = dv + dk
    return 4 * (3 * dk * (dv + 1) + n * (dk + 1) + 2 * n + 8
                + _panel_floats(dk, m) + PANEL * (m + 1) + PANEL * dk)


def bwd_scratch_floats(n: int, dk: int, dv: int) -> int:
    """Scratch of one backward block: X, Y, M, K g, dAᵀ(ηK)."""
    return 2 * n * (dv + dk) + 2 * n * dv + n * dk


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build.build("gdr_fwd")))
    p, i, size = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
    lib.gdr_fwd.argtypes = [p] * 12 + [i] * 7 + [p]
    lib.gdr_fwd.restype = i
    lib.gdr_error_string.argtypes = [i]
    lib.gdr_error_string.restype = ctypes.c_char_p
    lib.gdr_fwd_smem_bytes.argtypes = [i, i, i]
    lib.gdr_fwd_smem_bytes.restype = size
    lib.gdr_fwd_uses_panels.argtypes = [i, i, i]
    lib.gdr_fwd_uses_panels.restype = i
    return lib


@functools.cache
def _chain_lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build.build("gdr_chain")))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gdr_chain.argtypes = [p] * 9 + [i] * 7 + [p]
    lib.gdr_chain.restype = i
    lib.gdr_chain_error_string.argtypes = [i]
    lib.gdr_chain_error_string.restype = ctypes.c_char_p
    lib.gdr_chain_max_dk.argtypes = []
    lib.gdr_chain_max_dk.restype = i
    return lib


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build.build("gdr_bwd")))
    p, i, size = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
    lib.gdr_bwd.argtypes = [p] * 17 + [i] * 7 + [p]
    lib.gdr_bwd.restype = i
    lib.gdr_bwd_error_string.argtypes = [i]
    lib.gdr_bwd_error_string.restype = ctypes.c_char_p
    for fn in (lib.gdr_bwd_smem_bytes, lib.gdr_bwd_scratch_floats):
        fn.argtypes = [i, i, i]
        fn.restype = size
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


def _check_inputs(fn: str, q: Tensor, k: Tensor, v: Tensor, beta: Tensor,
                  eta: Tensor, alpha: Tensor) -> Tuple[int, ...]:
    """Check the operands both kernels share; return (B, H, T, N, d_k, d_v)."""
    if not q.is_cuda:
        raise ValueError(f"{fn} takes CUDA tensors, got q on {q.device}")
    if q.dim() != 5 or v.dim() != 5:
        raise ValueError("q, k, v must be (B, H, T, N, d)")
    b, h, t, n, dk = q.shape
    dv = v.shape[-1]
    dev = q.device
    _check("q", q, (b, h, t, n, dk), (torch.float32, torch.bfloat16), dev)
    _check("k", k, (b, h, t, n, dk), (q.dtype,), dev)
    _check("v", v, (b, h, t, n, dv), (q.dtype,), dev)
    _check("beta", beta, (b, h, t, n), (torch.float32,), dev)
    _check("eta", eta, (b, h, t, n), (torch.float32,), dev)
    _check("alpha", alpha, (b, h, t), (torch.float32,), dev)
    if min(b, h, t, n, dk, dv) < 1:
        raise ValueError(f"empty GDR input: q {tuple(q.shape)}, v {tuple(v.shape)}")
    return b, h, t, n, dk, dv


def _launch_fwd(q: Tensor, k: Tensor, v: Tensor, beta: Tensor, alpha: Tensor,
                s0: Tensor, eta: Optional[Tensor], save_states: bool,
                save_uw: bool) -> Tuple[Optional[Tensor], ...]:
    eta = beta if eta is None else eta
    b, h, t, n, dk, dv = _check_inputs("gdr_fwd_cuda", q, k, v, beta, eta, alpha)
    dev = q.device
    _check("s0", s0, (b, h, dk, dv), (torch.float32,), dev)
    need = smem_bytes(n, dk, dv)
    if need > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"GDR kernel tiles at N={n}, d_k={dk}, d_v={dv} need {need} B of "
            f"shared memory, over the {SMEM_LIMIT_BYTES} B a block may use")

    lib = _lib()
    f32 = dict(dtype=torch.float32, device=dev)
    o = torch.empty((b, h, t, n, dv), **f32)
    s_t = torch.empty((b, h, dk, dv), **f32)
    states = torch.empty((b, h, t, dk, dv), **f32) if save_states else None
    u = torch.empty((b, h, t, n, dv), **f32) if save_uw else None
    w = torch.empty((b, h, t, n, dk), **f32) if save_uw else None
    ptr = lambda x: None if x is None else x.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.gdr_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          beta.data_ptr(), eta.data_ptr(), alpha.data_ptr(),
                          s0.data_ptr(), o.data_ptr(), s_t.data_ptr(),
                          ptr(states), ptr(u), ptr(w), b, h, t, n, dk, dv, int(q.dtype == torch.bfloat16),
                          stream)
    if err != 0:
        raise RuntimeError(f"gdr_fwd launch failed: CUDA error {err} "
                           f"({lib.gdr_error_string(err).decode()})")
    LAUNCHES.n += 1
    RESIDUAL_LAUNCHES.n += save_states or save_uw
    return o, s_t, states, u, w


def gdr_fwd_cuda(q: Tensor, k: Tensor, v: Tensor, beta: Tensor, alpha: Tensor,
                 s0: Tensor, eta: Optional[Tensor] = None
                 ) -> Tuple[Tensor, Tensor]:
    """Launch the CUDA GDR forward kernel without residual outputs → (o,
    s_T).  Raises on a CPU tensor, on a shape, dtype or layout it does not
    take, and on a failed launch.  Not differentiable."""
    o, s_t, _, _, _ = _launch_fwd(q, k, v, beta, alpha, s0, eta, False, False)
    return o, s_t


def gdr_fwd_cuda_residuals(q: Tensor, k: Tensor, v: Tensor, beta: Tensor,
                           alpha: Tensor, s0: Tensor,
                           eta: Optional[Tensor] = None, *,
                           save_uw: bool = True
                           ) -> Tuple[Optional[Tensor], ...]:
    """The forward kernel with its residual outputs → (o, s_T, states, u,
    w): states (B, H, T, d_k, d_v) = S_{t-1} per frame before its decay;
    u, w the frame's WY solve, or None without ``save_uw``.  All fp32.
    Its plain version is ``core.gdr.gdr_chunked_residuals``."""
    return _launch_fwd(q, k, v, beta, alpha, s0, eta, True, save_uw)


def gdr_chain_cuda(q: Tensor, k: Tensor, u: Tensor, w: Tensor, alpha: Tensor,
                   s0: Tensor, *, save_states: bool
                   ) -> Tuple[Tensor, Tensor, Optional[Tensor]]:
    """Launch the CUDA chain kernel → (o, s_T, states): ``states`` (B, H,
    T, d_k, d_v) = S_{t-1} per frame before its decay, or None without
    ``save_states``.  q, k (B, H, T, N, d_k) bf16 or fp32; u (…, N, d_v)
    and w (…, N, d_k) fp32 from ``core.gdr.wy_transform``.  Raises on a
    CPU tensor, on a shape, dtype or layout it does not take, and on a
    failed launch.  Its plain version is ``core.gdr.gdr_chain``."""
    if not q.is_cuda:
        raise ValueError(f"gdr_chain_cuda takes CUDA tensors, got q on {q.device}")
    if q.dim() != 5 or u.dim() != 5:
        raise ValueError("q, k, u, w must be (B, H, T, N, d)")
    b, h, t, n, dk = q.shape
    dv = u.shape[-1]
    dev = q.device
    _check("q", q, (b, h, t, n, dk), (torch.float32, torch.bfloat16), dev)
    _check("k", k, (b, h, t, n, dk), (q.dtype,), dev)
    _check("u", u, (b, h, t, n, dv), (torch.float32,), dev)
    _check("w", w, (b, h, t, n, dk), (torch.float32,), dev)
    _check("alpha", alpha, (b, h, t), (torch.float32,), dev)
    _check("s0", s0, (b, h, dk, dv), (torch.float32,), dev)
    if min(b, h, t, n, dk, dv) < 1:
        raise ValueError(f"empty GDR input: q {tuple(q.shape)}, u {tuple(u.shape)}")
    if dk > CHAIN_MAX_DK:
        raise ValueError(f"the chain kernel takes d_k <= {CHAIN_MAX_DK}, got {dk}")

    lib = _chain_lib()
    f32 = dict(dtype=torch.float32, device=dev)
    o = torch.empty((b, h, t, n, dv), **f32)
    s_t = torch.empty((b, h, dk, dv), **f32)
    states = torch.empty((b, h, t, dk, dv), **f32) if save_states else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.gdr_chain(q.data_ptr(), k.data_ptr(), u.data_ptr(),
                            w.data_ptr(), alpha.data_ptr(), s0.data_ptr(),
                            o.data_ptr(), s_t.data_ptr(),
                            None if states is None else states.data_ptr(),
                            b, h, t, n, dk, dv, int(q.dtype == torch.bfloat16),
                            stream)
    if err != 0:
        raise RuntimeError(f"gdr_chain launch failed: CUDA error {err} "
                           f"({lib.gdr_chain_error_string(err).decode()})")
    CHAIN_LAUNCHES.n += 1
    RESIDUAL_LAUNCHES.n += save_states
    return o, s_t, states


def gdr_bwd_cuda(q: Tensor, k: Tensor, v: Tensor, beta: Tensor, eta: Tensor,
                 alpha: Tensor, states: Tensor, do: Tensor, ds_t: Tensor
                 ) -> Tuple[Tensor, ...]:
    """Launch the CUDA GDR backward kernel → (dq, dk, dv, dbeta, deta,
    dalpha (B, H, T), ds0), all fp32.  Its plain version is
    ``core.gdr.gdr_bwd_ref``, with the same arguments."""
    b, h, t, n, dk, dv = _check_inputs("gdr_bwd_cuda", q, k, v, beta, eta, alpha)
    dev = q.device
    _check("states", states, (b, h, t, dk, dv), (torch.float32,), dev)
    _check("do", do, (b, h, t, n, dv), (torch.float32,), dev)
    _check("ds_t", ds_t, (b, h, dk, dv), (torch.float32,), dev)
    need = bwd_smem_bytes(n, dk, dv)
    if need > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"GDR backward kernel at N={n}, d_k={dk}, d_v={dv} needs {need} B "
            f"of shared memory, over the {SMEM_LIMIT_BYTES} B a block may use")

    lib = _bwd_lib()
    f32 = dict(dtype=torch.float32, device=dev)
    dq = torch.empty((b, h, t, n, dk), **f32)
    dk_ = torch.empty((b, h, t, n, dk), **f32)
    dv_ = torch.empty((b, h, t, n, dv), **f32)
    dbeta = torch.empty((b, h, t, n), **f32)
    deta = torch.empty((b, h, t, n), **f32)
    dalpha = torch.empty((b, h, t), **f32)
    ds0 = torch.empty((b, h, dk, dv), **f32)
    scratch = torch.empty((b * h * bwd_scratch_floats(n, dk, dv),), **f32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.gdr_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          beta.data_ptr(), eta.data_ptr(), alpha.data_ptr(),
                          states.data_ptr(), do.data_ptr(), ds_t.data_ptr(),
                          dq.data_ptr(), dk_.data_ptr(), dv_.data_ptr(),
                          dbeta.data_ptr(), deta.data_ptr(), dalpha.data_ptr(),
                          ds0.data_ptr(), scratch.data_ptr(),
                          b, h, t, n, dk, dv, int(q.dtype == torch.bfloat16),
                          stream)
    if err != 0:
        raise RuntimeError(f"gdr_bwd launch failed: CUDA error {err} "
                           f"({lib.gdr_bwd_error_string(err).decode()})")
    BWD_LAUNCHES.n += 1
    return dq, dk_, dv_, dbeta, deta, dalpha, ds0


def _bwd_mode() -> str:
    """``GDKVM_GDR_BWD``: stored (default) | recompute | fused, read when the
    forward runs (as the JAX package reads it when it traces)."""
    mode = os.environ.get("GDKVM_GDR_BWD", "stored")
    if mode not in ("stored", "recompute", "fused"):
        raise ValueError(f"GDKVM_GDR_BWD must be stored|recompute|fused, "
                         f"got {mode!r}")
    return mode


def _fwd_mode() -> str:
    """``GDKVM_GDR_FWD``: monolith (default) | chain, read each time a
    forward runs."""
    mode = os.environ.get("GDKVM_GDR_FWD", "monolith")
    if mode not in ("chain", "monolith"):
        raise ValueError(f"GDKVM_GDR_FWD must be chain|monolith, got {mode!r}")
    return mode


def _wy(k: Tensor, v: Tensor, beta: Tensor, eta: Optional[Tensor]
        ) -> Tuple[Tensor, Tensor]:
    """All frames' WY solves in one batched call (the chain split's first
    step; the JAX package's ``_wy_uw_bh``), contiguous for the kernel."""
    u, w = gdr.wy_transform(k, v, beta, eta)
    return u.contiguous(), w.contiguous()


def _fwd_no_residuals(q: Tensor, k: Tensor, v: Tensor, beta: Tensor,
                      alpha: Tensor, s0: Tensor, eta: Optional[Tensor]
                      ) -> Tuple[Tensor, Tensor]:
    """One residual-free forward launch in the ``GDKVM_GDR_FWD`` split."""
    if _fwd_mode() == "chain":
        o, s_t, _ = gdr_chain_cuda(q, k, *_wy(k, v, beta, eta), alpha, s0,
                                   save_states=False)
        return o, s_t
    return gdr_fwd_cuda(q, k, v, beta, alpha, s0, eta)


class GDRFunction(torch.autograd.Function):
    """The kernel route with a gradient.  ``apply(q, k, v, beta, alpha, s0,
    eta)``; ``eta=None`` is the coupled rule (η = β), whose β gradient is
    the sum of the write and erase cotangents.  Gradients come back in
    their inputs' dtypes."""

    @staticmethod
    def forward(ctx, q, k, v, beta, alpha, s0, eta):
        mode = _bwd_mode()
        ctx.mode, ctx.coupled = mode, eta is None
        eta_ = beta if eta is None else eta
        ins = (q, k, v, beta, alpha, s0, eta_)
        if mode == "recompute":
            o, s_t = _fwd_no_residuals(*ins)
            ctx.save_for_backward(*ins)
        else:
            if _fwd_mode() == "chain":
                # The stored backward takes U, W from the batched solve, as
                # the JAX package's does (its inverses are None there).
                u, w = _wy(k, v, beta, eta_)
                o, s_t, states = gdr_chain_cuda(q, k, u, w, alpha, s0,
                                                save_states=True)
            else:
                o, s_t, states, u, w = gdr_fwd_cuda_residuals(
                    *ins, save_uw=mode == "stored")
            res = (states, u, w) if mode == "stored" else (states,)
            ctx.save_for_backward(q, k, v, beta, alpha, eta_, *res)
        return o, s_t

    @staticmethod
    def backward(ctx, do, ds_t):
        do, ds_t = do.contiguous(), ds_t.contiguous()
        if ctx.mode == "recompute":
            with torch.enable_grad():
                ins = [x.detach().requires_grad_(True) for x in ctx.saved_tensors]
                out = gdr.gdr_chunked(*ins)
                dq, dk, dv, dbeta, dalpha, ds0, deta = torch.autograd.grad(
                    out, ins, (do, ds_t))
        else:
            q, k, v, beta, alpha, eta, states, *uw = ctx.saved_tensors
            if ctx.mode == "stored":
                grads = gdr.gdr_bwd_stored(q, k, v, beta, eta, alpha, states,
                                           *uw, do, ds_t)
            else:
                grads = gdr_bwd_cuda(q, k, v, beta, eta, alpha, states, do, ds_t)
            dq, dk, dv, dbeta, deta, dalpha, ds0 = grads
        if ctx.coupled:
            dbeta, deta = dbeta + deta, None
        q, k, v, beta, alpha = ctx.saved_tensors[:5]
        cast = lambda g, x: g.to(x.dtype)
        return (cast(dq, q), cast(dk, k), cast(dv, v), cast(dbeta, beta),
                cast(dalpha, alpha), ds0, deta)


def _needs_grad(*xs: Optional[Tensor]) -> bool:
    return torch.is_grad_enabled() and any(
        x is not None and x.requires_grad for x in xs)


def gdr_kernel(q: Tensor, k: Tensor, v: Tensor, beta: Tensor, alpha: Tensor,
               s0: Tensor, eta: Optional[Tensor] = None
               ) -> Tuple[Tensor, Tensor]:
    """``gdr_impl="pallas"``: the kernels, differentiable; the launchers
    raise on CPU tensors.  Without a gradient to take, one residual-free
    launch of the ``GDKVM_GDR_FWD`` split's kernel."""
    args = tuple(x.contiguous() for x in (q, k, v, beta, alpha, s0))
    eta = None if eta is None else eta.contiguous()
    if _needs_grad(*args, eta):
        return GDRFunction.apply(*args, eta)
    return _fwd_no_residuals(*args, eta)


def gdr_fwd(q: Tensor, k: Tensor, v: Tensor, beta: Tensor, alpha: Tensor,
            s0: Tensor, eta: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """``gdr_impl="auto"``: the kernels for CUDA tensors, the plain chunked
    form (differentiated by autograd) for CPU tensors."""
    if q.is_cuda:
        return gdr_kernel(q, k, v, beta, alpha, s0, eta)
    return gdr.gdr_chunked(q, k, v, beta, alpha, s0, eta)
