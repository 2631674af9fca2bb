"""LKVA — linear key-value association memory over the GDR state.

Port of gdkvm_tpu/models/lkva.py: the projections and gates around the GDR
scan, and the readout (per-head RMSNorm → SiLU gate → output projection).
q, k and v enter the scan in the compute dtype; β and α stay fp32.
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
    "ref": gdr.gdr_ref,
}


def _l2norm(x: Tensor, eps: float = 1e-6) -> Tensor:
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + eps)


class LKVAMemory(nn.Module):
    """Multi-head linear key-value association over the GDR state."""

    def __init__(self, in_channels: int, num_classes: int, num_heads: int = 4,
                 head_dim_k: int = 64, head_dim_v: int = 64,
                 out_channels: int = 128, dtype: torch.dtype = torch.bfloat16,
                 gdr_impl: str = "auto",
                 device: torch.device | str | None = None) -> None:
        super().__init__()
        if gdr_impl == "assoc":
            raise NotImplementedError(
                "gdr_impl='assoc' is not ported (ROADMAP Queue 1, item 2: "
                "gdr_assoc comes last)")
        if gdr_impl not in GDR_IMPLS:
            raise ValueError(f"gdr_impl must be one of {sorted(GDR_IMPLS)}, "
                             f"got {gdr_impl!r}")
        self.num_heads, self.head_dim_k, self.head_dim_v = (
            num_heads, head_dim_k, head_dim_v)
        self.out_channels, self.dtype, self.gdr_impl = (
            out_channels, dtype, gdr_impl)
        h, dk, dv, c = num_heads, head_dim_k, head_dim_v, in_channels
        kw = dict(dtype=dtype, device=device)
        self.q_proj = Dense(c, h * dk, bias=False, **kw)
        self.k_proj = Dense(c, h * dk, bias=False, **kw)
        self.v_proj = Dense(c, h * dv, bias=False, **kw)
        self.mask_proj = Dense(num_classes, h * dv, bias=False, **kw)
        self.beta_proj = Dense(c, h, **kw)      # bias −1 at init
        self.alpha_proj = Dense(c, h, **kw)     # kernel 0, bias 4 at init
        self.gate_proj = Dense(c, h * dv, **kw)
        self.out_proj = Dense(h * dv, out_channels, bias=False, **kw)
        self.o_norm = RMSNorm(dv, device=device)

    def _heads_l2(self, proj: Dense, x: Tensor) -> Tensor:
        """x (..., N, C) → SiLU(proj(x)) as (..., N, H, dk), unit L2, fp32."""
        y = F.silu(proj(x))
        return _l2norm(y.reshape(*y.shape[:-1], self.num_heads,
                                 self.head_dim_k).to(torch.float32))

    def prompt_write(self, x_map: Tensor, mask_onehot: Tensor,
                     state: Tensor) -> Tensor:
        """Write a prompted frame (features + mask) into the memory state.

        x_map (B, h, w, C) stride-16 features; mask_onehot (B, h, w, K);
        state (B, H, dk, dv) → updated state fp32.
        """
        b, hh, ww, c = x_map.shape
        x_tok = x_map.reshape(b, hh * ww, c)
        m_tok = mask_onehot.reshape(b, hh * ww, -1)
        k = self._heads_l2(self.k_proj, x_tok)                  # (B,N,H,dk)
        v = self.v_proj(x_tok) + self.mask_proj(m_tok.to(self.dtype))
        v = v.reshape(b, hh * ww, self.num_heads, self.head_dim_v).to(torch.float32)
        beta = torch.sigmoid(self.beta_proj(x_tok).to(torch.float32))
        return gdr.gdr_write_chunk(state, k.transpose(1, 2), v.transpose(1, 2),
                                   beta.transpose(1, 2))

    def forward(self, x_seq: Tensor, state: Tensor) -> Tuple[Tensor, Tensor]:
        """x_seq (B, T, h, w, C) stride-16 features; state (B, H, dk, dv)
        fp32 → (readout (B, T, h, w, out_channels) in compute dtype, new
        state fp32)."""
        b, t, hh, ww, c = x_seq.shape
        n = hh * ww
        h, dv = self.num_heads, self.head_dim_v
        x_tok = x_seq.reshape(b, t, n, c)

        q = self._heads_l2(self.q_proj, x_tok).to(self.dtype)   # (B,T,N,H,dk)
        k = self._heads_l2(self.k_proj, x_tok).to(self.dtype)
        v = self.v_proj(x_tok).reshape(b, t, n, h, dv).to(self.dtype)
        beta = torch.sigmoid(self.beta_proj(x_tok).to(torch.float32))
        pooled = x_tok.to(torch.float32).mean(2)                  # (B,T,C)
        alpha = torch.sigmoid(
            self.alpha_proj(pooled.to(self.dtype)).to(torch.float32))

        # (B, H, T, N, d) for the scan; the kernel takes contiguous tensors.
        o, new_state = GDR_IMPLS[self.gdr_impl](
            q.permute(0, 3, 1, 2, 4).contiguous(),
            k.permute(0, 3, 1, 2, 4).contiguous(),
            v.permute(0, 3, 1, 2, 4).contiguous(),
            beta.permute(0, 3, 1, 2).contiguous(),
            alpha.permute(0, 2, 1).contiguous(), state)

        o = self.o_norm(o.permute(0, 2, 3, 1, 4))                 # (B,T,N,H,dv)
        o = o.reshape(b, t, n, h * dv).to(self.dtype)
        o = o * F.silu(self.gate_proj(x_tok))
        o = self.out_proj(o)
        return o.reshape(b, t, hh, ww, self.out_channels), new_state
