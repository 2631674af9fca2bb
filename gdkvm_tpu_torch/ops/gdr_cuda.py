"""The GDR scan's CUDA kernels, their autograd, and the dispatch.

- :func:`gdr_fwd_cuda` / :func:`gdr_fwd_cuda_residuals` launch
  ``csrc/gdr_fwd.cu``, the port of the Pallas TPU kernel ``_gdr_kernel``
  (gdkvm_tpu/ops/gdr_pallas.py), without or with its residual outputs
  (S_{t-1} per frame; the frame's WY solve U, W).  One C call launches two
  kernels on the current stream: the WY solve of every frame at once (one
  block a frame) into U, W (the residuals, or scratch that the wrapper
  allocates), then the state chain of ``csrc/gdr_chain.cuh``.
- :func:`gdr_chain_cuda` launches that chain alone (``csrc/gdr_chain.cuh``,
  built into the same library), the port of ``_gdr_chain_kernel``, given
  every frame's WY solve U, W from one batched solve
  (``core.gdr.wy_transform``), with S_{t-1} per frame on request.
- :func:`gdr_bwd_cuda` launches ``csrc/gdr_bwd.cu``, the port of
  ``_gdr_bwd_kernel``: one C call, three kernels on the current stream —
  the WY solve of every frame (``csrc/gdr_wy.cuh``, the forward's), the
  reverse dS chain (the only serial part, 128 blocks at the training
  shape), and the per-frame adjoint (one block a frame).  ``_bwd_launch``
  also returns the phases' scratch (U, W, g, dS̃), so that each phase can
  be held against its plain version in ``core.gdr``.
- ``GDKVM_GDR_FWD`` picks the forward split, as in the JAX package:
  ``monolith`` (default; ``gdr_fwd.cu``'s own solve kernel) or ``chain``
  (the batched solve, then the chain alone).  It is read each
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
  writes S_{t-1}.  ``GDKVM_GDR_SAVE_DTYPE=bf16`` (default ``f32``) makes
  the monolith forward under ``stored`` write S_{t-1}, U and W in bf16,
  as the JAX package's does; the chain split keeps them fp32.

- :func:`gdr_fwd_op` registers that residual-free forward as the custom op
  ``torch.ops.gdkvm_tpu_torch.gdr_fwd`` (``torch.library``), which
  ``torch.export`` keeps as one node (io/export.py): the kernels of the
  ``GDKVM_GDR_FWD`` split on CUDA tensors, the plain
  ``core.gdr.gdr_chunked`` on CPU tensors, and a fake implementation for
  tracing.
- :func:`gdr_kernel` is ``gdr_impl="pallas"``: the kernels, or raise.
  :func:`gdr_fwd` is ``gdr_impl="auto"``: the kernels for CUDA tensors, the
  plain ``core.gdr.gdr_chunked`` for CPU tensors.  When no input needs a
  gradient (``torch.no_grad``, ``inference_mode``) both call the custom op
  (on the card: one residual-free forward launch).  A CUDA tensor never
  takes a plain version of a kernel: the kernel launches or the call
  raises.

Shapes as in ``core/gdr.py``: q, k (B, H, T, N, d_k); v (B, H, T, N, d_v);
beta, eta (B, H, T, N); alpha (B, H, T); s0 (B, H, d_k, d_v) →
o (B, H, T, N, d_v) fp32, s_T (B, H, d_k, d_v) fp32.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import os
from typing import Iterator, Optional, Tuple

import torch

from gdkvm_tpu_torch.core import gdr
from gdkvm_tpu_torch.ops import _build

Tensor = torch.Tensor

# Launches of each CUDA kernel (counted where it launches, and nowhere else).
LAUNCHES = gdr.CallCount()        # gdr_fwd (solve + chain in one call)
CHAIN_LAUNCHES = gdr.CallCount()  # gdr_chain, with or without S_{t-1}
BWD_LAUNCHES = gdr.CallCount()    # gdr_bwd.cu: the backward (three kernels in one call)
# Of the forward launches above (either kernel), those that wrote the
# backward's residuals: an inference path shows 0 here.
RESIDUAL_LAUNCHES = gdr.CallCount()

# Dynamic shared memory one block may use on Hopper (227 KB).
SMEM_LIMIT_BYTES = 232_448
THREADS = 256  # threads of every block of the forward kernels
PANEL = 32     # rows per panel of the blocked solves (csrc/gdr_panel.cuh)
WY_BLOCK = 16  # rows per diagonal block of the small-layout solve (gdr_fwd.cu)
# The chain (csrc/gdr_chain.cuh): state columns per block, tokens per tile,
# and the largest d_k its registers hold.
CHAIN_COLS = 16
CHAIN_ROWS = 64
CHAIN_MAX_DK = 128


def _panel_floats(dk: int, m: int) -> int:
    """The panel workspace: a d_k × m accumulator (rows padded to m+1), the
    panel's K rows (padded to d_k+1), its A block, its rows of X and its
    η."""
    return dk * (m + 1) + PANEL * (dk + 1) + PANEL * PANEL + PANEL * m + PANEL


def _wy_small_floats(n: int, dk: int, dv: int) -> int:
    """K, which the inverses of A's 16 × 16 diagonal blocks (rows of 20)
    and one block's right-hand side replace once A is formed; X = [U | W];
    A; β and η.  Rows are padded for the tensor cores' fragment reads: K's
    and A's to 4 mod 8 floats, X's to 8 mod 32 (``Strides`` in
    ``csrc/gdr_fwd.cu``)."""
    up8 = lambda x: -(-x // 8) * 8
    ld_k, ld_a, ld_x = up8(dk) + 4, up8(n) + 4, up8(dv + dk) + 8
    region = max(n * ld_k, -(-n // WY_BLOCK) * WY_BLOCK * (WY_BLOCK + 4)
                 + WY_BLOCK * ld_x)
    return region + n * (ld_x + ld_a) + 2 * n


def wy_uses_panels(n: int, dk: int, dv: int) -> bool:
    """True when the solve's small layout (A in shared memory, 16-row block
    substitution) does not fit, so it solves by 32-row panels."""
    return 4 * _wy_small_floats(n, dk, dv) > SMEM_LIMIT_BYTES


def wy_smem_bytes(n: int, dk: int, dv: int) -> int:
    """Shared memory of one solve block at (N, d_k, d_v) (mirrors
    ``smem_floats`` in ``csrc/gdr_fwd.cu``): by panels, X = [U | W], the
    panel workspace, β and η."""
    if wy_uses_panels(n, dk, dv):
        return 4 * (n * (dv + dk) + _panel_floats(dk, dv + dk) + 2 * n)
    return 4 * _wy_small_floats(n, dk, dv)


def chain_smem_bytes(dk: int, bf16: bool) -> int:
    """Shared memory of one chain block (mirrors ``smem_bytes`` and
    ``ring_stages`` in ``csrc/gdr_chain.cuh``): three ring stages (two where
    three do not fit) of Q, K tiles (input type), W and U-column tiles
    (fp32), each tile row d_k rounded up to 16 elements plus 16 bytes; then
    S̃ transposed and the M tile (rows of 16 + 8 floats).  It does not grow
    with N."""
    d16 = -(-dk // 16) * 16
    elem = 2 if bf16 else 4
    stage = CHAIN_ROWS * (2 * (d16 + 16 // elem) * elem + 4 * (d16 + 4 + CHAIN_COLS))
    fixed = 4 * (CHAIN_COLS * (d16 + 4) + CHAIN_ROWS * (CHAIN_COLS + 8))
    stages = 3 if 3 * stage + fixed <= SMEM_LIMIT_BYTES else 2   # ring_stages
    return stages * stage + fixed


def fwd_launch_plan(b: int, h: int, t: int, n: int, dk: int, dv: int,
                    bf16: bool) -> dict:
    """The forward's two launches (grid, threads and shared memory of each)
    and the bytes of its U, W scratch; ``fits`` is False where a block
    would need more shared memory than Hopper gives it, or d_k is past the
    chain's largest."""
    plan = {
        "solve": {"grid": (b * h * t,), "threads": THREADS,
                  "smem": wy_smem_bytes(n, dk, dv),
                  "panels": wy_uses_panels(n, dk, dv)},
        "chain": {"grid": (b * h, -(-dv // CHAIN_COLS)), "threads": THREADS,
                  "smem": chain_smem_bytes(dk, bf16)},
        "scratch_bytes": 4 * b * h * t * n * (dv + dk),
    }
    plan["fits"] = (dk <= CHAIN_MAX_DK and max(
        plan["solve"]["smem"], plan["chain"]["smem"]) <= SMEM_LIMIT_BYTES)
    return plan


KLDM = CHAIN_COLS + 8  # row stride (floats) of the chains' column tiles


def bwd_chain_smem_bytes(dk: int, bf16: bool) -> int:
    """Shared memory of one block of the backward's reverse dS chain
    (mirrors ``rc_smem_bytes`` and ``rc_stages`` in ``csrc/gdr_bwd.cu``):
    three ring stages (two where three do not fit) of Q, K tiles (input
    type) and W tiles (fp32), rows of d_k rounded up to 16 plus 16 bytes,
    and dO-column tiles (rows of 16 + 8 floats); then g transposed and the
    −KG tile.  It does not grow with N."""
    d16 = -(-dk // 16) * 16
    elem = 2 if bf16 else 4
    stage = CHAIN_ROWS * (2 * (d16 + 16 // elem) * elem + 4 * (d16 + 4 + KLDM))
    fixed = 4 * (CHAIN_COLS * (d16 + 4) + CHAIN_ROWS * KLDM)
    stages = 3 if 3 * stage + fixed <= SMEM_LIMIT_BYTES else 2
    return stages * stage + fixed


def bwd_frames_smem_bytes(n: int, dk: int, dv: int, bf16: bool) -> int:
    """Shared memory of one block of the backward's per-frame adjoint
    (mirrors ``adj_smem_floats`` in ``csrc/gdr_bwd.cu``): one region that
    holds first S̃, g (rows of d_v padded), S̃ gᵀ and a 32-row panel of K
    (input type), dO, U, W and KG, then the panel workspace (the d_k × m
    accumulator, the panel's K, A block, right-hand side, solution and X
    rows, two 16 × 16 inverses and the panel's η); then β, η and 8 warp
    partials.  Only β and η grow with N."""
    up8 = lambda x: -(-x // 8) * 8
    tile = lambda d, elem: -(-d // 16) * 16 + 16 // elem   # chain's tile_ld
    m, elem = dv + dk, (2 if bf16 else 4)
    ld_v, ld_p, ld_x, ld_k = up8(dv) + 4, up8(dk) + 4, up8(m) + 8, up8(dk) + 4
    before = (2 * dk * ld_v + dk * ld_p + PANEL * tile(dk, elem) * elem // 4
              + PANEL * (2 * tile(dv, 4) + tile(dk, 4) + ld_v))
    after = (dk * ld_x + PANEL * ld_k + PANEL * (PANEL + 4) + 3 * PANEL * ld_x
             + 2 * WY_BLOCK * (WY_BLOCK + 4) + PANEL)
    return 4 * (max(before, after) + 2 * n + 8)


def bwd_launch_plan(b: int, h: int, t: int, n: int, dk: int, dv: int,
                    bf16: bool) -> dict:
    """The backward's three launches (grid, threads and shared memory of
    each) and the bytes of its scratch (U, W; g and dS̃ per frame; Y);
    ``fits`` is False where a block would need more shared memory than
    Hopper gives it, or d_k is past the chain's largest."""
    frames = b * h * t
    plan = {
        "solve": {"grid": (frames,), "threads": THREADS,
                  "smem": wy_smem_bytes(n, dk, dv),
                  "panels": wy_uses_panels(n, dk, dv)},
        "chain": {"grid": (b * h, -(-dv // CHAIN_COLS)), "threads": THREADS,
                  "smem": bwd_chain_smem_bytes(dk, bf16)},
        "frames": {"grid": (frames,), "threads": THREADS,
                   "smem": bwd_frames_smem_bytes(n, dk, dv, bf16)},
        "scratch_bytes": 4 * frames * (2 * n * (dv + dk) + 2 * dk * dv),
    }
    plan["fits"] = (dk <= CHAIN_MAX_DK and max(
        plan[p]["smem"] for p in ("solve", "chain", "frames")) <= SMEM_LIMIT_BYTES)
    return plan


@functools.cache
def _lib() -> ctypes.CDLL:
    """``csrc/gdr_fwd.cu``'s library: the forward and the chain alone."""
    lib = ctypes.CDLL(str(_build.build("gdr_fwd")))
    p, i, size = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
    lib.gdr_fwd.argtypes = [p] * 14 + [i] * 8 + [p]
    lib.gdr_fwd.restype = i
    lib.gdr_chain.argtypes = [p] * 9 + [i] * 7 + [p]
    lib.gdr_chain.restype = i
    lib.gdr_error_string.argtypes = [i]
    lib.gdr_error_string.restype = ctypes.c_char_p
    lib.gdr_wy_smem_bytes.argtypes = [i, i, i]
    lib.gdr_wy_smem_bytes.restype = size
    lib.gdr_wy_uses_panels.argtypes = [i, i, i]
    lib.gdr_wy_uses_panels.restype = i
    for fn in (lib.gdr_chain_max_dk, lib.gdr_chain_cols):
        fn.argtypes = []
        fn.restype = i
    lib.gdr_chain_smem_bytes.argtypes = [i, i]
    lib.gdr_chain_smem_bytes.restype = size
    return lib


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    """``csrc/gdr_bwd.cu``'s library: the backward."""
    lib = ctypes.CDLL(str(_build.build("gdr_bwd")))
    p, i, size = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
    lib.gdr_bwd.argtypes = [p] * 21 + [i] * 7 + [p]
    lib.gdr_bwd.restype = i
    lib.gdr_bwd_error_string.argtypes = [i]
    lib.gdr_bwd_error_string.restype = ctypes.c_char_p
    lib.gdr_bwd_solve_smem_bytes.argtypes = [i, i, i]
    lib.gdr_bwd_frames_smem_bytes.argtypes = [i, i, i, i]
    for fn in (lib.gdr_bwd_solve_smem_bytes, lib.gdr_bwd_frames_smem_bytes):
        fn.restype = size
    lib.gdr_bwd_chain_smem_bytes.argtypes = [i, i]
    lib.gdr_bwd_chain_smem_bytes.restype = size
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


def _require_cuda(fn: str, x: Tensor) -> None:
    if not x.is_cuda:
        raise ValueError(f"{fn} takes CUDA tensors, got q on {x.device}")


@contextlib.contextmanager
def _launching(dev: torch.device) -> Iterator[int]:
    """Make ``dev`` the current device and yield its current stream, as
    the int that the C entry points take."""
    with torch.cuda.device(dev):
        yield torch.cuda.current_stream(dev).cuda_stream


def _check_inputs(fn: str, q: Tensor, k: Tensor, v: Tensor, beta: Tensor,
                  eta: Tensor, alpha: Tensor) -> Tuple[int, ...]:
    """Check the operands both kernels share; return (B, H, T, N, d_k, d_v)."""
    _require_cuda(fn, q)
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
                save_uw: bool, save_bf16: bool = False
                ) -> Tuple[Optional[Tensor], ...]:
    eta = beta if eta is None else eta
    b, h, t, n, dk, dv = _check_inputs("gdr_fwd_cuda", q, k, v, beta, eta, alpha)
    dev = q.device
    _check("s0", s0, (b, h, dk, dv), (torch.float32,), dev)
    _check_plan(b, h, t, n, dk, dv, q.dtype == torch.bfloat16)

    lib = _lib()
    f32 = dict(dtype=torch.float32, device=dev)
    o = torch.empty((b, h, t, n, dv), **f32)
    s_t = torch.empty((b, h, dk, dv), **f32)
    # Residuals in bf16 (GDKVM_GDR_SAVE_DTYPE=bf16): S_{t-1} and extra bf16
    # copies of U, W; the chain still reads the fp32 U, W.
    save_bf16 = save_bf16 and save_states and save_uw
    bf = dict(dtype=torch.bfloat16, device=dev)
    states = (torch.empty((b, h, t, dk, dv), **(bf if save_bf16 else f32))
              if save_states else None)
    # The solve's U, W: the residuals, or scratch that dies with this call.
    u = torch.empty((b, h, t, n, dv), **f32)
    w = torch.empty((b, h, t, n, dk), **f32)
    u16 = torch.empty((b, h, t, n, dv), **bf) if save_bf16 else None
    w16 = torch.empty((b, h, t, n, dk), **bf) if save_bf16 else None
    ptr = lambda x: None if x is None else x.data_ptr()
    with _launching(dev) as stream:
        err = lib.gdr_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          beta.data_ptr(), eta.data_ptr(), alpha.data_ptr(),
                          s0.data_ptr(), o.data_ptr(), s_t.data_ptr(),
                          ptr(states), u.data_ptr(), w.data_ptr(), ptr(u16),
                          ptr(w16), b, h, t, n, dk, dv,
                          int(q.dtype == torch.bfloat16), int(save_bf16), stream)
    if err != 0:
        raise RuntimeError(f"gdr_fwd launch failed: CUDA error {err} "
                           f"({lib.gdr_error_string(err).decode()})")
    LAUNCHES.n += 1
    RESIDUAL_LAUNCHES.n += save_states or save_uw
    if save_bf16:
        u, w = u16, w16
    return o, s_t, states, *((u, w) if save_uw else (None, None))


def _check_plan(b: int, h: int, t: int, n: int, dk: int, dv: int,
                bf16: bool) -> None:
    plan = fwd_launch_plan(b, h, t, n, dk, dv, bf16)
    if not plan["fits"]:
        raise ValueError(
            f"GDR forward at N={n}, d_k={dk}, d_v={dv}: the solve needs "
            f"{plan['solve']['smem']} B and the chain {plan['chain']['smem']} B "
            f"of shared memory (a block may use {SMEM_LIMIT_BYTES} B), and "
            f"the chain takes d_k <= {CHAIN_MAX_DK}")


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
                           save_uw: bool = True, save_bf16: bool = False
                           ) -> Tuple[Optional[Tensor], ...]:
    """The forward kernel with its residual outputs → (o, s_T, states, u,
    w): states (B, H, T, d_k, d_v) = S_{t-1} per frame before its decay;
    u, w the frame's WY solve, or None without ``save_uw``.  All fp32; with
    ``save_bf16`` and ``save_uw`` (``GDKVM_GDR_SAVE_DTYPE=bf16``) states, u
    and w are bf16.  Its plain version is
    ``core.gdr.gdr_chunked_residuals``."""
    return _launch_fwd(q, k, v, beta, alpha, s0, eta, True, save_uw, save_bf16)


def gdr_chain_cuda(q: Tensor, k: Tensor, u: Tensor, w: Tensor, alpha: Tensor,
                   s0: Tensor, *, save_states: bool
                   ) -> Tuple[Tensor, Tensor, Optional[Tensor]]:
    """Launch the CUDA chain kernel → (o, s_T, states): ``states`` (B, H,
    T, d_k, d_v) = S_{t-1} per frame before its decay, or None without
    ``save_states``.  q, k (B, H, T, N, d_k) bf16 or fp32; u (…, N, d_v)
    and w (…, N, d_k) fp32 from ``core.gdr.wy_transform``.  Raises on a
    CPU tensor, on a shape, dtype or layout it does not take, and on a
    failed launch.  Its plain version is ``core.gdr.gdr_chain``."""
    _require_cuda("gdr_chain_cuda", q)
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

    lib = _lib()
    f32 = dict(dtype=torch.float32, device=dev)
    o = torch.empty((b, h, t, n, dv), **f32)
    s_t = torch.empty((b, h, dk, dv), **f32)
    states = torch.empty((b, h, t, dk, dv), **f32) if save_states else None
    with _launching(dev) as stream:
        err = lib.gdr_chain(q.data_ptr(), k.data_ptr(), u.data_ptr(),
                            w.data_ptr(), alpha.data_ptr(), s0.data_ptr(),
                            o.data_ptr(), s_t.data_ptr(),
                            None if states is None else states.data_ptr(),
                            b, h, t, n, dk, dv, int(q.dtype == torch.bfloat16),
                            stream)
    if err != 0:
        raise RuntimeError(f"gdr_chain launch failed: CUDA error {err} "
                           f"({lib.gdr_error_string(err).decode()})")
    CHAIN_LAUNCHES.n += 1
    RESIDUAL_LAUNCHES.n += save_states
    return o, s_t, states


def _check_bwd_plan(b: int, h: int, t: int, n: int, dk: int, dv: int,
                    bf16: bool) -> dict:
    plan = bwd_launch_plan(b, h, t, n, dk, dv, bf16)
    if not plan["fits"]:
        raise ValueError(
            f"GDR backward at N={n}, d_k={dk}, d_v={dv}: its phases need "
            + ", ".join(f"{p} {plan[p]['smem']} B" for p in ("solve", "chain", "frames"))
            + f" of shared memory (a block may use {SMEM_LIMIT_BYTES} B), and "
            f"the chain takes d_k <= {CHAIN_MAX_DK}")
    return plan


def gdr_bwd_cuda(q: Tensor, k: Tensor, v: Tensor, beta: Tensor, eta: Tensor,
                 alpha: Tensor, states: Tensor, do: Tensor, ds_t: Tensor
                 ) -> Tuple[Tensor, ...]:
    """Launch the CUDA GDR backward → (dq, dk, dv, dbeta, deta, dalpha (B,
    H, T), ds0), all fp32: one C call, three kernels (the WY solve of every
    frame, the reverse dS chain, the per-frame adjoint), with scratch that
    the wrapper allocates.  Its plain version is ``core.gdr.gdr_bwd_ref``,
    with the same arguments."""
    return _bwd_launch(q, k, v, beta, eta, alpha, states, do, ds_t)[0]


def _bwd_launch(q: Tensor, k: Tensor, v: Tensor, beta: Tensor, eta: Tensor,
                alpha: Tensor, states: Tensor, do: Tensor, ds_t: Tensor
                ) -> Tuple[Tuple[Tensor, ...], Tuple[Tensor, ...]]:
    """:func:`gdr_bwd_cuda` → (its gradients, (u, w, g, ds_dec)): the
    scratch its phases wrote, the solve's U, W and the reverse chain's dS_t,
    dS̃_t per frame (B, H, T, d_k, d_v), for checks of each phase."""
    b, h, t, n, dk, dv = _check_inputs("gdr_bwd_cuda", q, k, v, beta, eta, alpha)
    dev = q.device
    _check("states", states, (b, h, t, dk, dv), (torch.float32,), dev)
    _check("do", do, (b, h, t, n, dv), (torch.float32,), dev)
    _check("ds_t", ds_t, (b, h, dk, dv), (torch.float32,), dev)
    _check_bwd_plan(b, h, t, n, dk, dv, q.dtype == torch.bfloat16)

    lib = _bwd_lib()
    f32 = dict(dtype=torch.float32, device=dev)
    dq = torch.empty((b, h, t, n, dk), **f32)
    dk_ = torch.empty((b, h, t, n, dk), **f32)
    dv_ = torch.empty((b, h, t, n, dv), **f32)
    dbeta = torch.empty((b, h, t, n), **f32)
    deta = torch.empty((b, h, t, n), **f32)
    dalpha = torch.empty((b, h, t), **f32)
    ds0 = torch.empty((b, h, dk, dv), **f32)
    # Scratch: the recomputed U, W; dS_t and dS̃_t per frame; Y.
    u = torch.empty((b, h, t, n, dv), **f32)
    w = torch.empty((b, h, t, n, dk), **f32)
    g = torch.empty((b, h, t, dk, dv), **f32)
    dsd = torch.empty((b, h, t, dk, dv), **f32)
    y = torch.empty((b, h, t, n, dv + dk), **f32)
    with _launching(dev) as stream:
        err = lib.gdr_bwd(*(x.data_ptr() for x in (
            q, k, v, beta, eta, alpha, states, do, ds_t, dq, dk_, dv_, dbeta,
            deta, dalpha, ds0, u, w, g, dsd, y)),
            b, h, t, n, dk, dv, int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"gdr_bwd launch failed: CUDA error {err} "
                           f"({lib.gdr_bwd_error_string(err).decode()})")
    BWD_LAUNCHES.n += 1
    return (dq, dk_, dv_, dbeta, deta, dalpha, ds0), (u, w, g, dsd)


def _bwd_mode() -> str:
    """``GDKVM_GDR_BWD``: stored (default) | recompute | fused, read when the
    forward runs (as the JAX package reads it when it traces)."""
    mode = os.environ.get("GDKVM_GDR_BWD", "stored")
    if mode not in ("stored", "recompute", "fused"):
        raise ValueError(f"GDKVM_GDR_BWD must be stored|recompute|fused, "
                         f"got {mode!r}")
    return mode


def _save_dtype() -> str:
    """``GDKVM_GDR_SAVE_DTYPE``: f32 (default) | bf16, the type of the
    stored backward's residuals (S_{t-1}, U, W), read when a forward runs
    (the JAX package's ``_save_dtype``, read when it traces).  It applies
    to the monolith forward under ``GDKVM_GDR_BWD=stored`` only."""
    val = os.environ.get("GDKVM_GDR_SAVE_DTYPE", "f32")
    if val not in ("f32", "bf16"):
        raise ValueError(f"GDKVM_GDR_SAVE_DTYPE must be f32|bf16, got {val!r}")
    return val


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


@torch.library.custom_op("gdkvm_tpu_torch::gdr_fwd", mutates_args=(),
                         device_types="cuda")
def gdr_fwd_op(q: Tensor, k: Tensor, v: Tensor, beta: Tensor, alpha: Tensor,
               s0: Tensor, eta: Optional[Tensor]) -> Tuple[Tensor, Tensor]:
    """``torch.ops.gdkvm_tpu_torch.gdr_fwd``: the residual-free forward as
    a custom op, so that ``torch.export`` keeps it as one node of the
    exported program.  On CUDA tensors it launches the ``GDKVM_GDR_FWD``
    split's kernel (read when it runs, in an exported program too); on CPU
    tensors it runs the plain ``core.gdr.gdr_chunked``.  Not
    differentiable: the gradient route is :class:`GDRFunction`."""
    # An exported program hands over its tensors as it made them: the
    # kernels take them contiguous.
    return _fwd_no_residuals(*(x.contiguous() for x in (q, k, v, beta, alpha, s0)),
                             None if eta is None else eta.contiguous())


@gdr_fwd_op.register_kernel("cpu")
def _gdr_fwd_op_cpu(q: Tensor, k: Tensor, v: Tensor, beta: Tensor,
                    alpha: Tensor, s0: Tensor, eta: Optional[Tensor]
                    ) -> Tuple[Tensor, Tensor]:
    return gdr.gdr_chunked(q, k, v, beta, alpha, s0, eta)


@gdr_fwd_op.register_fake
def _gdr_fwd_op_fake(q: Tensor, k: Tensor, v: Tensor, beta: Tensor,
                     alpha: Tensor, s0: Tensor, eta: Optional[Tensor]
                     ) -> Tuple[Tensor, Tensor]:
    """o (B, H, T, N, d_v) and s_T (B, H, d_k, d_v), both fp32, as the
    kernels and the plain scan write them."""
    f32 = torch.float32
    return (q.new_empty((*q.shape[:-1], v.shape[-1]), dtype=f32),
            s0.new_empty(s0.shape, dtype=f32))


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
                stored = mode == "stored"
                o, s_t, states, u, w = gdr_fwd_cuda_residuals(
                    *ins, save_uw=stored,
                    save_bf16=stored and _save_dtype() == "bf16")
            res = (states, u, w) if mode == "stored" else (states,)
            ctx.save_for_backward(q, k, v, beta, alpha, eta_, *res)
        return o, s_t

    @staticmethod
    def backward(ctx, do, ds_t):
        do, ds_t = do.contiguous(), ds_t.contiguous()
        # Read once: under torch.utils.checkpoint (train.remat) a second
        # read of saved_tensors would ask for a second recomputation, which
        # it refuses.
        saved = ctx.saved_tensors
        if ctx.mode == "recompute":
            with torch.enable_grad():
                ins = [x.detach().requires_grad_(True) for x in saved]
                out = gdr.gdr_chunked(*ins)
                dq, dk, dv, dbeta, dalpha, ds0, deta = torch.autograd.grad(
                    out, ins, (do, ds_t))
        else:
            q, k, v, beta, alpha, eta, states, *uw = saved
            if ctx.mode == "stored":
                grads = gdr.gdr_bwd_stored(q, k, v, beta, eta, alpha, states,
                                           *uw, do, ds_t)
            else:
                grads = gdr_bwd_cuda(q, k, v, beta, eta, alpha, states, do, ds_t)
            dq, dk, dv, dbeta, deta, dalpha, ds0 = grads
        if ctx.coupled:
            dbeta, deta = dbeta + deta, None
        q, k, v, beta, alpha = saved[:5]
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
    if q.is_cuda:
        return gdr_fwd_op(*args, eta)
    # The op's CPU implementation is the plain scan, which this route never
    # runs: CPU tensors go to the launchers, which raise.
    return _fwd_no_residuals(*args, eta)


def gdr_fwd(q: Tensor, k: Tensor, v: Tensor, beta: Tensor, alpha: Tensor,
            s0: Tensor, eta: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """``gdr_impl="auto"``: the kernels for CUDA tensors; for CPU tensors
    the plain chunked form, through the custom op without a gradient to
    take (so that a CPU export holds the op's node too), differentiated by
    autograd with one."""
    if q.is_cuda:
        return gdr_kernel(q, k, v, beta, alpha, s0, eta)
    if _needs_grad(q, k, v, beta, alpha, s0, eta):
        return gdr.gdr_chunked(q, k, v, beta, alpha, s0, eta)
    return gdr_fwd_op(q, k, v, beta, alpha, s0, eta)
