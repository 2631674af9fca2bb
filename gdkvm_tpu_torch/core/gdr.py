"""Gated Delta Rule (GDR) memory recurrence in PyTorch: the plain versions.

Port of gdkvm_tpu/core/gdr.py.  Per (batch, head) the state
``S ∈ R^{d_k × d_v}`` is advanced one frame (N spatial tokens) at a time:

    S̃_t   = α_t · S_{t-1}                  (per-frame forget gate)
    o_t,i = S̃_tᵀ q_t,i                     (read the decayed pre-write state)
    S_t   = S̃_t after N delta-rule writes  S ← (I − η_i k_i k_iᵀ) S + β_i k_i v_iᵀ

η is the erase gate; ``eta=None`` couples η = β (the classic rule).

- :func:`gdr_ref` — token-level loop, the executable definition.
- :func:`gdr_chunked` — the chunk (WY) closed form: all frames' triangular
  solves in one batched call, then a loop of three products per frame.  It
  is the plain version of the CUDA kernel in ``ops/gdr_cuda.py``.

(B, H) are written out as leading batch dims.  All math is fp32 whatever
the input dtype, and the state is fp32.

    q, k : (B, H, T, N, d_k)   v : (B, H, T, N, d_v)   beta, eta : (B, H, T, N)
    alpha : (B, H, T)   s0 : (B, H, d_k, d_v)
    →  o : (B, H, T, N, d_v),  s_T : (B, H, d_k, d_v)
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

Tensor = torch.Tensor


class CallCount:
    """Calls of a plain version, so a run can show which path it took."""

    def __init__(self) -> None:
        self.n = 0

    def reset(self) -> None:
        self.n = 0


# Counts gdr_chunked calls; the kernel's launches are counted in gdr_cuda.
CHUNKED_CALLS = CallCount()


def _f32(x: Tensor) -> Tensor:
    return x.to(torch.float32)


def gdr_ref(q: Tensor, k: Tensor, v: Tensor, beta: Tensor, alpha: Tensor,
            s0: Tensor, eta: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Token-level sequential scan.  Ground truth; returns (o, s_T) fp32."""
    eta = beta if eta is None else eta
    q, k, v, beta, eta, alpha = map(_f32, (q, k, v, beta, eta, alpha))
    s = _f32(s0)
    outs = []
    for t in range(q.shape[2]):
        s = alpha[:, :, t, None, None] * s
        outs.append(q[:, :, t] @ s)
        for i in range(q.shape[3]):
            k_i = k[:, :, t, i]                                  # (B, H, dk)
            sk = (s.transpose(-1, -2) @ k_i[..., None])[..., 0]  # Sᵀk (B,H,dv)
            r = beta[:, :, t, i, None] * v[:, :, t, i] - eta[:, :, t, i, None] * sk
            s = s + k_i[..., :, None] * r[..., None, :]
    return torch.stack(outs, dim=2), s


def wy_transform(k: Tensor, v: Tensor, beta: Tensor,
                 eta: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """U, W with ``S ← S + Kᵀ(U − W S)`` equal to the frame's N writes.

    ``(I + A)[U | W] = [diag(β) V | diag(η) K]`` with
    ``A = strict_tril(diag(η) K Kᵀ)``.  Batched over all leading dims:
    k (..., N, d_k), v (..., N, d_v), beta/eta (..., N).  The unit-lower
    solve is exact forward substitution in fp32.
    """
    eta = beta if eta is None else eta
    k, v, beta, eta = map(_f32, (k, v, beta, eta))
    ke = k * eta[..., None]
    a = torch.tril(ke @ k.transpose(-1, -2), diagonal=-1)
    rhs = torch.cat([v * beta[..., None], ke], dim=-1)
    uw = torch.linalg.solve_triangular(a, rhs, upper=False, unitriangular=True)
    dv = v.shape[-1]
    return uw[..., :dv], uw[..., dv:]


def gdr_chunked(q: Tensor, k: Tensor, v: Tensor, beta: Tensor, alpha: Tensor,
                s0: Tensor, eta: Optional[Tensor] = None
                ) -> Tuple[Tensor, Tensor]:
    """Chunk-form scan: batched WY solves, then three products per frame."""
    CHUNKED_CALLS.n += 1
    u, w = wy_transform(k, v, beta, eta)            # (B,H,T,N,dv), (…,dk)
    q, k, alpha = _f32(q), _f32(k), _f32(alpha)
    s = _f32(s0)
    outs = []
    for t in range(q.shape[2]):
        s = alpha[:, :, t, None, None] * s
        outs.append(q[:, :, t] @ s)
        s = s + k[:, :, t].transpose(-1, -2) @ (u[:, :, t] - w[:, :, t] @ s)
    return torch.stack(outs, dim=2), s


def gdr_write_chunk(s: Tensor, k: Tensor, v: Tensor, beta: Tensor) -> Tensor:
    """Write-only update (no decay, no read): ``S ← S + Kᵀ(U − W S)``.

    s (B, H, d_k, d_v); k (B, H, N, d_k); v (B, H, N, d_v); beta (B, H, N).
    Used for mask-prompt writes into the initial memory state.
    """
    s = _f32(s)
    u, w = wy_transform(k, v, beta)
    return s + _f32(k).transpose(-1, -2) @ (u - w @ s)


def init_state(batch: int, heads: int, d_k: int, d_v: int,
               device: torch.device | str) -> Tensor:
    """Zero memory state (B, H, d_k, d_v) fp32 on ``device``."""
    return torch.zeros((batch, heads, d_k, d_v), dtype=torch.float32,
                       device=device)
