"""LKVA — linear key-value association memory over the GDR state.

Port of gdkvm_tpu/models/lkva.py: the projections and gates around the GDR
scan, and the readout (per-head RMSNorm → SiLU gate → output projection).
q, k and v enter the scan in the compute dtype; β, η and α stay fp32.
``gdr_variant="gdn2"`` adds the erase gate's projection ``eta_proj`` and
passes η = sigmoid(eta_proj(x)) to the scan; "gdn" couples η = β.

A head shard (``heads=(M, m)``, the JAX package's ``model`` mesh axis)
holds heads [m·H/M, (m+1)·H/M): its rows of the q/k/v/mask/gate
projections' weights and its columns of ``out_proj``'s (the head-major
features), and the replicated rest whole (the biases, the β/α/η
projections, ``o_norm``), of which it reads its heads' rows.  The scan,
the per-head norm and the gate are then local to the shard, whose
``out_proj`` output is a partial sum over its heads: the caller sums it
over the shards.  ``M`` must divide H.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from gdkvm_tpu_torch.core import gdr
from gdkvm_tpu_torch.models.layers import Dense, RMSNorm
from gdkvm_tpu_torch.ops import gdr_cuda

Tensor = torch.Tensor

# gdr_impl → scan with the (B, H, T, N, d) signature of core/gdr.py.
GDR_IMPLS = {
    "auto": gdr_cuda.gdr_fwd,        # kernel for CUDA tensors, chunked on CPU
    "pallas": gdr_cuda.gdr_kernel,    # the kernels, or raise
    "chunked": gdr.gdr_chunked,
    "assoc": gdr.gdr_assoc,
    "ref": gdr.gdr_ref,
}


def _l2norm(x: Tensor, eps: float = 1e-6) -> Tensor:
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + eps)


class LKVAMemory(nn.Module):
    """Multi-head linear key-value association over the GDR state."""

    def __init__(self, in_channels: int, num_classes: int, num_heads: int = 4,
                 head_dim_k: int = 64, head_dim_v: int = 64,
                 out_channels: int = 128, dtype: torch.dtype = torch.bfloat16,
                 gdr_impl: str = "auto", gdr_variant: str = "gdn",
                 device: torch.device | str | None = None,
                 heads: Tuple[int, int] = (1, 0)) -> None:
        super().__init__()
        shards, shard = heads
        if num_heads % shards or not 0 <= shard < shards:
            raise ValueError(f"head shard {shard} of {shards}: the model axis must "
                             f"divide num_heads={num_heads} (a model position runs "
                             f"whole heads)")
        if gdr_variant not in ("gdn", "gdn2"):
            raise ValueError(f"gdr_variant must be gdn|gdn2, got {gdr_variant!r}")
        if gdr_impl not in GDR_IMPLS:
            raise ValueError(f"gdr_impl must be one of {sorted(GDR_IMPLS)}, "
                             f"got {gdr_impl!r}")
        h = num_heads // shards                 # the shard's heads
        self.heads, self.head_lo = heads, shard * h
        self.num_heads, self.head_dim_k, self.head_dim_v = (
            h, head_dim_k, head_dim_v)
        self.out_channels, self.dtype, self.gdr_impl, self.gdr_variant = (
            out_channels, dtype, gdr_impl, gdr_variant)
        dk, dv, c = head_dim_k, head_dim_v, in_channels
        kw = dict(dtype=dtype, device=device)
        self.q_proj = Dense(c, h * dk, bias=False, **kw)
        self.k_proj = Dense(c, h * dk, bias=False, **kw)
        self.v_proj = Dense(c, h * dv, bias=False, **kw)
        self.mask_proj = Dense(num_classes, h * dv, bias=False, **kw)
        self.beta_proj = Dense(c, num_heads, **kw)      # bias −1 at init
        if gdr_variant == "gdn2":
            # The decoupled erase gate η: bias −1 at init, as β's, so
            # training starts at the coupled rule's behaviour.
            self.eta_proj = Dense(c, num_heads, **kw)
        self.alpha_proj = Dense(c, num_heads, **kw)     # kernel 0, bias 4 at init
        self.gate_proj = Dense(c, h * dv, bias=False, **kw)
        # Its bias is whole: the JAX package shards the kernels alone.
        self.gate_proj.bias = nn.Parameter(torch.zeros(num_heads * dv, device=device))
        self.out_proj = Dense(h * dv, out_channels, bias=False, **kw)
        self.o_norm = RMSNorm(dv, device=device)

    def _own(self, proj: Dense, x: Tensor, per_head: int = 1) -> Tensor:
        """``proj(x)`` for the shard's heads: the rows [lo, hi) of the
        replicated projection's output (each head ``per_head`` of them)
        when only the bias is replicated, or weight and bias."""
        lo, n = self.head_lo * per_head, self.num_heads * per_head
        w = proj.weight if proj.weight.shape[0] == n else proj.weight[lo:lo + n]
        b = proj.bias if proj.bias.shape[0] == n else proj.bias[lo:lo + n]
        return F.linear(x.to(proj.dtype), w.to(proj.dtype), b.to(proj.dtype))

    def _heads_l2(self, proj: Dense, x: Tensor) -> Tensor:
        """x (..., N, C) → SiLU(proj(x)) as (..., N, H, dk), unit L2, fp32."""
        y = F.silu(proj(x))
        return _l2norm(y.reshape(*y.shape[:-1], self.num_heads,
                                 self.head_dim_k).to(torch.float32))

    def prompt_write(self, x_map: Tensor, mask_onehot: Tensor,
                     state: Tensor) -> Tensor:
        """Write a prompted frame (features + mask) into the memory state.

        x_map (B, h, w, C) stride-16 features; mask_onehot (B, h, w, K);
        state (B, H, dk, dv) → updated state fp32.  The write is coupled
        (η = β) in both variants, as in the JAX package.
        """
        b, hh, ww, c = x_map.shape
        x_tok = x_map.reshape(b, hh * ww, c)
        m_tok = mask_onehot.reshape(b, hh * ww, -1)
        k = self._heads_l2(self.k_proj, x_tok)                  # (B,N,H,dk)
        v = self.v_proj(x_tok) + self.mask_proj(m_tok.to(self.dtype))
        v = v.reshape(b, hh * ww, self.num_heads, self.head_dim_v).to(torch.float32)
        beta = torch.sigmoid(self._own(self.beta_proj, x_tok).to(torch.float32))
        return gdr.gdr_write_chunk(state, k.transpose(1, 2), v.transpose(1, 2),
                                   beta.transpose(1, 2))

    def forward(self, x_seq: Tensor, state: Tensor) -> Tuple[Tensor, Tensor]:
        """x_seq (B, T, h, w, C) stride-16 features; state (B, H, dk, dv)
        fp32 → (readout (B, T, h, w, out_channels) in compute dtype, new
        state fp32).  A head shard's H is its own, and its readout is its
        heads' share of the sum."""
        b, t, hh, ww, c = x_seq.shape
        n = hh * ww
        h, dv = self.num_heads, self.head_dim_v
        x_tok = x_seq.reshape(b, t, n, c)

        q = self._heads_l2(self.q_proj, x_tok).to(self.dtype)   # (B,T,N,H,dk)
        k = self._heads_l2(self.k_proj, x_tok).to(self.dtype)
        v = self.v_proj(x_tok).reshape(b, t, n, h, dv).to(self.dtype)
        beta = torch.sigmoid(self._own(self.beta_proj, x_tok).to(torch.float32))
        eta = (torch.sigmoid(self._own(self.eta_proj, x_tok).to(torch.float32))
               .permute(0, 3, 1, 2).contiguous()
               if self.gdr_variant == "gdn2" else None)
        pooled = x_tok.to(torch.float32).mean(2)                  # (B,T,C)
        alpha = torch.sigmoid(
            self._own(self.alpha_proj, pooled.to(self.dtype)).to(torch.float32))

        # (B, H, T, N, d) for the scan; the kernel takes contiguous tensors.
        o, new_state = GDR_IMPLS[self.gdr_impl](
            q.permute(0, 3, 1, 2, 4).contiguous(),
            k.permute(0, 3, 1, 2, 4).contiguous(),
            v.permute(0, 3, 1, 2, 4).contiguous(),
            beta.permute(0, 3, 1, 2).contiguous(),
            alpha.permute(0, 2, 1).contiguous(), state, eta)

        o = self.o_norm(o.permute(0, 2, 3, 1, 4))                 # (B,T,N,H,dv)
        o = o.reshape(b, t, n, h * dv).to(self.dtype)
        o = o * F.silu(self._own(self.gate_proj, x_tok, dv))
        o = self.out_proj(o)
        return o.reshape(b, t, hh, ww, self.out_channels), new_state
