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
  is the plain version of the CUDA forward kernel in ``ops/gdr_cuda.py``;
  :func:`gdr_chunked_residuals` also returns the backward's residuals
  (S_{t-1} per frame, each frame's WY solve U, W), the plain version of the
  kernel's residual outputs.
- :func:`gdr_chain` — the per-frame chain alone, given the batched solves'
  U and W: the plain version of the CUDA chain kernel
  (``GDKVM_GDR_FWD=chain``).
- :func:`gdr_assoc` — the frame recurrence as a log-depth scan of affine
  maps (``gdr_impl="assoc"``).
- :func:`gdr_bwd_ref` — the backward as a reverse scan applying
  :func:`frame_adjoint` frame by frame: the plain version of the CUDA
  backward kernel.  :func:`gdr_bwd_stored` — the same adjoint from the
  stored residuals, batched over all frames: the default backward, built
  from :func:`gdr_bwd_chain` (the reverse dS chain) and
  :func:`gdr_bwd_frames` (the per-frame adjoint), the plain versions of
  the backward kernel's second and third phases.

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


# Calls of the plain chunked forward (gdr_chunked, gdr_chunked_residuals)
# and of the plain chain (gdr_chain); the kernels' launches are counted in
# ops/gdr_cuda.py.
CHUNKED_CALLS = CallCount()
CHAIN_CALLS = CallCount()


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


def solve_unit_lower_t(a: Tensor, rhs: Tensor) -> Tensor:
    """Y = (I + A)⁻ᵀ RHS for strictly-lower A (..., N, N): the transposed
    (unit-upper) system, exact backward substitution in fp32."""
    return torch.linalg.solve_triangular(_f32(a).transpose(-1, -2), _f32(rhs),
                                         upper=True, unitriangular=True)


def _chain_loop(q: Tensor, k: Tensor, u: Tensor, w: Tensor, alpha: Tensor,
                s0: Tensor, save_states: bool
                ) -> Tuple[Tensor, Tensor, Optional[Tensor]]:
    q, k, u, w, alpha = map(_f32, (q, k, u, w, alpha))
    s = _f32(s0)
    outs, states = [], []
    for t in range(q.shape[2]):
        states.append(s)
        s = alpha[:, :, t, None, None] * s
        outs.append(q[:, :, t] @ s)
        s = s + k[:, :, t].transpose(-1, -2) @ (u[:, :, t] - w[:, :, t] @ s)
    return (torch.stack(outs, dim=2), s,
            torch.stack(states, dim=2) if save_states else None)


def gdr_chain(q: Tensor, k: Tensor, u: Tensor, w: Tensor, alpha: Tensor,
              s0: Tensor, save_states: bool = False
              ) -> Tuple[Tensor, Tensor, Optional[Tensor]]:
    """The state chain alone, given each frame's WY solve: per frame
    ``S̃ = α_t S;  O_t = Q_t S̃;  S ← S̃ + K_tᵀ (U_t − W_t S̃)``.

    u (B, H, T, N, d_v) and w (…, N, d_k) come from :func:`wy_transform`.
    → (o, s_T, states): ``states`` (B, H, T, d_k, d_v) holds S_{t-1} of
    every frame, before its decay, or None without ``save_states``.  All
    fp32.  It is the plain version of the CUDA chain kernel
    (``csrc/gdr_chain.cuh``, the port of the Pallas ``_gdr_chain_kernel``).
    """
    CHAIN_CALLS.n += 1
    return _chain_loop(q, k, u, w, alpha, s0, save_states)


def gdr_chunked_residuals(q: Tensor, k: Tensor, v: Tensor, beta: Tensor,
                          alpha: Tensor, s0: Tensor,
                          eta: Optional[Tensor] = None, *,
                          save_bf16: bool = False
                          ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Chunk-form scan that also returns the backward's residuals.

    → (o, s_T, states, u, w): ``states`` (B, H, T, d_k, d_v) holds S_{t-1}
    for every frame, before its decay; ``u`` (…, N, d_v) and ``w``
    (…, N, d_k) are each frame's WY solve.  fp32, or with ``save_bf16``
    (``GDKVM_GDR_SAVE_DTYPE=bf16``) the three residuals rounded to bf16
    after an fp32 scan.  It is the plain version of the CUDA forward kernel
    with its residual outputs: the batched solves, then the chain of
    :func:`gdr_chain`.
    """
    CHUNKED_CALLS.n += 1
    u, w = wy_transform(k, v, beta, eta)            # (B,H,T,N,dv), (…,dk)
    o, s_t, states = _chain_loop(q, k, u, w, alpha, s0, True)
    if save_bf16:
        states, u, w = (x.to(torch.bfloat16) for x in (states, u, w))
    return o, s_t, states, u, w


def gdr_chunked(q: Tensor, k: Tensor, v: Tensor, beta: Tensor, alpha: Tensor,
                s0: Tensor, eta: Optional[Tensor] = None
                ) -> Tuple[Tensor, Tensor]:
    """Chunk-form scan: batched WY solves, then three products per frame."""
    o, s_t, _, _, _ = gdr_chunked_residuals(q, k, v, beta, alpha, s0, eta)
    return o, s_t


def gdr_assoc(q: Tensor, k: Tensor, v: Tensor, beta: Tensor, alpha: Tensor,
              s0: Tensor, eta: Optional[Tensor] = None
              ) -> Tuple[Tensor, Tensor]:
    """Parallel-scan GDR: the frame recurrence as a scan of affine maps.

    With each frame's WY solve (U_t, W_t) in hand the state transition is
    affine, ``S_t = M_t S_{t-1} + b_t`` with ``M_t = α_t (I − K_tᵀ W_t)``
    (d_k × d_k) and ``b_t = K_tᵀ U_t``.  Affine maps compose associatively
    (g after f: ``(M_g M_f, M_g b_f + b_g)``), so every prefix comes out of
    log₂(T) levels of batched products (a Hillis–Steele scan over T,
    written in plain torch: torch has no stable ``associative_scan``).
    Autograd carries the gradient.  Port of ``gdr_assoc``
    (gdkvm_tpu/core/gdr.py); returns (o, s_T) fp32.
    """
    u, w = wy_transform(k, v, beta, eta)               # (B,H,T,N,dv), (…,dk)
    k32, a32 = _f32(k), _f32(alpha)
    eye = torch.eye(k.shape[-1], dtype=torch.float32, device=k.device)
    m = a32[..., None, None] * (eye - k32.transpose(-1, -2) @ w)  # (B,H,T,dk,dk)
    bv = k32.transpose(-1, -2) @ u                                # (B,H,T,dk,dv)
    n_t, step = q.shape[2], 1
    while step < n_t:
        # Prefix t composes with the prefix ending at t − step.
        m_prev, b_prev = m[:, :, :-step], bv[:, :, :-step]
        m_cur, b_cur = m[:, :, step:], bv[:, :, step:]
        m = torch.cat([m[:, :, :step], m_cur @ m_prev], dim=2)
        bv = torch.cat([bv[:, :, :step], m_cur @ b_prev + b_cur], dim=2)
        step *= 2
    s0 = _f32(s0)
    s_all = m @ s0[:, :, None] + bv                               # S_t, all t
    s_prev = torch.cat([s0[:, :, None], s_all[:, :, :-1]], dim=2)
    o = _f32(q) @ (a32[..., None, None] * s_prev)
    return o, s_all[:, :, -1]


# ---------------------------------------------------------------------------
# Backward.  Per frame (g = dS_t, the cotangent of the frame's output state;
# S̃ = α_t S_{t-1}; X = [U | W]; M = U − W S̃):
#
#   dQ = dO S̃ᵀ;   dS̃ = g + Qᵀ dO − Wᵀ (K g)
#   dX = [K g | −(K g) S̃ᵀ];   Y = (I + A)⁻ᵀ dX;   dA = −stril(Y Xᵀ)
#   d(ηK) = dA K + Y_k;   dK = M gᵀ + dAᵀ (ηK) + η ⊙ d(ηK);   dV = β ⊙ Y_v
#   dβ = Σ_dv Y_v ⊙ V;   dη = Σ_dk d(ηK) ⊙ K;   dα_t = ⟨dS̃, S_{t-1}⟩
#   carry dS_{t-1} = α_t dS̃
#
# (derivation in gdkvm_tpu/ops/gdr_pallas.py's module docstring).  For the
# coupled rule (η = β) the caller sums dβ and dη.
# ---------------------------------------------------------------------------

# Calls of the plain backward versions, so a run can show which path it took.
BWD_REF_CALLS = CallCount()      # gdr_bwd_ref: the backward kernel's plain version
BWD_STORED_CALLS = CallCount()   # gdr_bwd_stored: the stored-mode backward


def frame_adjoint(s_dec: Tensor, q: Tensor, k: Tensor, v: Tensor,
                  beta: Tensor, eta: Tensor, g: Tensor, do: Tensor
                  ) -> Tuple[Tensor, ...]:
    """Adjoint of one frame, recomputing its WY solve.

    s_dec (..., d_k, d_v) = S̃; q, k (..., N, d_k); v (..., N, d_v);
    beta, eta (..., N); g = dS_t (..., d_k, d_v); do (..., N, d_v); all
    fp32.  → (ds_dec, dq, dk, dv, dbeta, deta).
    """
    dv_dim = v.shape[-1]
    b2, e2 = beta[..., None], eta[..., None]
    ke = k * e2
    a = torch.tril(ke @ k.transpose(-1, -2), diagonal=-1)
    x = torch.linalg.solve_triangular(a, torch.cat([v * b2, ke], dim=-1),
                                      upper=False, unitriangular=True)
    u, w = x[..., :dv_dim], x[..., dv_dim:]
    m = u - w @ s_dec
    kg = k @ g
    dq = do @ s_dec.transpose(-1, -2)
    ds_dec = g + q.transpose(-1, -2) @ do - w.transpose(-1, -2) @ kg
    dx = torch.cat([kg, -kg @ s_dec.transpose(-1, -2)], dim=-1)
    y = solve_unit_lower_t(a, dx)
    da = -torch.tril(y @ x.transpose(-1, -2), diagonal=-1)
    y_v, y_k = y[..., :dv_dim], y[..., dv_dim:]
    dke = da @ k + y_k
    dk = m @ g.transpose(-1, -2) + da.transpose(-1, -2) @ ke + e2 * dke
    return (ds_dec, dq, dk, b2 * y_v, (y_v * v).sum(-1), (dke * k).sum(-1))


def gdr_bwd_ref(q: Tensor, k: Tensor, v: Tensor, beta: Tensor, eta: Tensor,
                alpha: Tensor, states: Tensor, do: Tensor, ds_t: Tensor
                ) -> Tuple[Tensor, ...]:
    """Reverse scan over frames from the S_{t-1} checkpoints, applying
    :func:`frame_adjoint` frame by frame.  The plain version of the CUDA
    backward kernel.

    states (B, H, T, d_k, d_v); do (B, H, T, N, d_v); ds_t (B, H, d_k, d_v).
    → (dq, dk, dv, dbeta, deta, dalpha (B, H, T), ds0), all fp32.
    """
    BWD_REF_CALLS.n += 1
    q, k, v, beta, eta, alpha, states, do = map(
        _f32, (q, k, v, beta, eta, alpha, states, do))
    g = _f32(ds_t)
    n_t = q.shape[2]
    grads = [None] * n_t
    dalpha = [None] * n_t
    for t in reversed(range(n_t)):
        a_t = alpha[:, :, t, None, None]
        s_prev = states[:, :, t]
        ds_dec, *grads[t] = frame_adjoint(
            a_t * s_prev, q[:, :, t], k[:, :, t], v[:, :, t], beta[:, :, t],
            eta[:, :, t], g, do[:, :, t])
        dalpha[t] = (ds_dec * s_prev).sum((-2, -1))
        g = a_t * ds_dec
    dq, dk, dv, dbeta, deta = (torch.stack(z, dim=2) for z in zip(*grads))
    return dq, dk, dv, dbeta, deta, torch.stack(dalpha, dim=2), g


def gdr_bwd_stored(q: Tensor, k: Tensor, v: Tensor, beta: Tensor, eta: Tensor,
                   alpha: Tensor, states: Tensor, u: Tensor, w: Tensor,
                   do: Tensor, ds_t: Tensor) -> Tuple[Tensor, ...]:
    """The stored-solve backward: the same adjoint from the forward's
    residuals (S_{t-1}, U, W), batched over all (B, H, T) frames.  Only the
    dS chain is a loop over frames; no forward solve is recomputed, and the
    one new solve, Y = (I + A)⁻ᵀ dX, runs batched.  Port of
    ``_bwd_stored`` (gdkvm_tpu/ops/gdr_pallas.py); the default backward.

    Arguments as :func:`gdr_bwd_ref`, plus u (B, H, T, N, d_v) and
    w (B, H, T, N, d_k).  → the same seven gradients, fp32.
    """
    BWD_STORED_CALLS.n += 1
    # Residuals stored in bf16 (GDKVM_GDR_SAVE_DTYPE=bf16) upcast once here.
    q, k, v, beta, eta, alpha, states, u, w, do = map(
        _f32, (q, k, v, beta, eta, alpha, states, u, w, do))
    g, ds_dec, ds0 = gdr_bwd_chain(k, w, q.transpose(-1, -2) @ do, alpha, ds_t)
    return (*gdr_bwd_frames(k, v, beta, eta, alpha, states, u, w, do, g,
                            ds_dec), ds0)


def gdr_bwd_chain(k: Tensor, w: Tensor, qdo: Tensor, alpha: Tensor,
                  ds_t: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """The reverse dS chain, the backward's only sequential piece: from
    g = dS_T down, per frame ``dS̃_t = g_t + Q_tᵀ dO_t − W_tᵀ (K_t g_t)`` and
    ``g_{t-1} = α_t dS̃_t``.

    k (B, H, T, N, d_k); w (…, N, d_k); qdo (B, H, T, d_k, d_v) = Qᵀ dO per
    frame; alpha (B, H, T); ds_t (B, H, d_k, d_v).  → (g, ds_dec, ds0): g
    and ds_dec (B, H, T, d_k, d_v) hold dS_t and dS̃_t of every frame, ds0
    the cotangent of S_0.  All fp32.  The plain version of the CUDA
    backward's second phase.
    """
    k, w, qdo, alpha = map(_f32, (k, w, qdo, alpha))
    g = _f32(ds_t)
    gs, ds_decs = [None] * k.shape[2], [None] * k.shape[2]
    for t in reversed(range(k.shape[2])):
        kg_t = k[:, :, t] @ g
        ds_decs[t] = g + qdo[:, :, t] - w[:, :, t].transpose(-1, -2) @ kg_t
        gs[t] = g
        g = alpha[:, :, t, None, None] * ds_decs[t]
    return torch.stack(gs, dim=2), torch.stack(ds_decs, dim=2), g


def gdr_bwd_frames(k: Tensor, v: Tensor, beta: Tensor, eta: Tensor,
                   alpha: Tensor, states: Tensor, u: Tensor, w: Tensor,
                   do: Tensor, g: Tensor, ds_dec: Tensor
                   ) -> Tuple[Tensor, ...]:
    """The per-frame adjoint, batched over all (B, H, T) frames, given each
    frame's WY solve X = [U | W], its dS_t = g and its dS̃_t (from
    :func:`gdr_bwd_chain`): KG, dQ, M, dX, Y = (I + A)⁻ᵀ dX, dA and the
    gradients.  No carry, so every frame is independent.

    Arguments as :func:`gdr_bwd_stored` without q (dQ = dO S̃ᵀ needs
    none), plus g and ds_dec (B, H, T, d_k, d_v).  → (dq, dk, dv, dbeta, deta, dalpha), fp32.  The plain version
    of the CUDA backward's third phase.
    """
    k, v, beta, eta, alpha, states, u, w, do, g, ds_dec = map(
        _f32, (k, v, beta, eta, alpha, states, u, w, do, g, ds_dec))
    dv_dim = v.shape[-1]
    e2 = eta[..., None]
    sdec = alpha[..., None, None] * states                # S̃_t (B,H,T,dk,dv)
    kg = k @ g
    ke = k * e2
    a = torch.tril(ke @ k.transpose(-1, -2), diagonal=-1)
    x = torch.cat([u, w], dim=-1)
    y = solve_unit_lower_t(a, torch.cat([kg, -kg @ sdec.transpose(-1, -2)],
                                        dim=-1))
    da = -torch.tril(y @ x.transpose(-1, -2), diagonal=-1)
    y_v, y_k = y[..., :dv_dim], y[..., dv_dim:]
    m = u - w @ sdec
    dke = da @ k + y_k
    dk = m @ g.transpose(-1, -2) + da.transpose(-1, -2) @ ke + e2 * dke
    dq = do @ sdec.transpose(-1, -2)
    dbeta = (y_v * v).sum(-1)
    deta = (dke * k).sum(-1)
    dalpha = (ds_dec * states).sum((-2, -1))
    return dq, dk, beta[..., None] * y_v, dbeta, deta, dalpha


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
