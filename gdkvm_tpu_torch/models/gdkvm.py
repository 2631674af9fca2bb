"""GDKVM: encoder → LKVA/GDR memory → KPFF decoder (port of
gdkvm_tpu/models/gdkvm.py).

``GDKVM.forward(frames (B, T, H, W, C), state, prompt_mask, prompt_weight)``
returns ``(logits (B, T, H, W, K) fp32, StreamState)``.  Streaming is
successive calls with the returned state; an optional prompt mask is written
into the memory before the chunk's first frame.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from gdkvm_tpu_torch.config.schema import ModelConfig
from gdkvm_tpu_torch.core import gdr
from gdkvm_tpu_torch.models.decoder import Decoder, resize_bilinear
from gdkvm_tpu_torch.models.encoder import Encoder
from gdkvm_tpu_torch.models.layers import BareKernel, Conv, Dense, RMSNorm
from gdkvm_tpu_torch.models.lkva import LKVAMemory
from gdkvm_tpu_torch.ops.norms import GroupNorm

Tensor = torch.Tensor

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass
class StreamState:
    """Memory carried across chunks: mem (B, H, d_k, d_v) fp32, and
    frames_seen (B,) int32 for bookkeeping."""
    mem: Tensor
    frames_seen: Tensor


class GDKVM(nn.Module):
    """Echocardiography video segmentation with gated delta-rule KV memory."""

    def __init__(self, cfg: ModelConfig,
                 device: torch.device | str | None = None) -> None:
        super().__init__()
        if cfg.mem_stride != 16:
            raise ValueError(
                f"model.mem_stride={cfg.mem_stride} is not supported: the "
                f"memory reads the encoder's deepest scale, stride 16")
        if cfg.gdr_variant != "gdn":
            raise NotImplementedError(
                f"gdr_variant={cfg.gdr_variant!r} is not ported (ROADMAP "
                f"Queue 1, item 2: the decoupled-η variants)")
        if cfg.quant != "none":
            raise NotImplementedError(
                f"quant={cfg.quant!r} is not ported (ROADMAP Queue 1, item 9: "
                f"ops/quant.py)")
        if cfg.param_dtype != "float32":
            raise ValueError(f"param_dtype must be float32, got {cfg.param_dtype!r}")
        self.cfg = cfg
        dt = _DTYPES[cfg.compute_dtype]
        c16 = cfg.enc_channels[-1]
        self.encoder = Encoder(cfg.in_channels, tuple(cfg.enc_channels),
                               tuple(cfg.enc_blocks), dtype=dt,
                               stem=cfg.enc_stem, device=device)
        self.lkva = LKVAMemory(c16, cfg.num_classes, cfg.num_heads,
                               cfg.head_dim_k, cfg.head_dim_v, out_channels=c16,
                               dtype=dt, gdr_impl=cfg.gdr_impl, device=device)
        self.decoder = Decoder(tuple(cfg.kpff_channels), tuple(cfg.enc_channels),
                               c16, cfg.num_classes, dtype=dt, device=device)

    def init_state(self, batch: int, device: torch.device | str) -> StreamState:
        c = self.cfg
        return StreamState(
            mem=gdr.init_state(batch, c.num_heads, c.head_dim_k, c.head_dim_v,
                               device),
            frames_seen=torch.zeros((batch,), dtype=torch.int32, device=device))

    def forward(self, frames: Tensor, state: Optional[StreamState] = None,
                prompt_mask: Optional[Tensor] = None,
                prompt_weight: Optional[Tensor] = None
                ) -> Tuple[Tensor, StreamState]:
        """frames (B, T, H, W, C_in); state None ⇒ a zero state on the
        frames' device; prompt_mask (B, H, W) int class ids written into the
        memory before frame 0; prompt_weight (B,) in [0, 1] blends the
        prompted state with the unprompted one."""
        b, t, hh, ww, ci = frames.shape
        if state is None:
            state = self.init_state(b, frames.device)

        f4, f8, f16 = self.encoder(frames.reshape(b * t, hh, ww, ci))
        h16, w16 = f16.shape[-2:]
        f16_seq = f16.permute(0, 2, 3, 1).reshape(b, t, h16, w16, f16.shape[1])

        mem = state.mem
        if prompt_mask is not None:
            onehot = F.one_hot(prompt_mask.long(), self.cfg.num_classes)
            m16 = resize_bilinear(onehot.to(torch.float32).permute(0, 3, 1, 2),
                                  (h16, w16)).permute(0, 2, 3, 1)
            prompted = self.lkva.prompt_write(f16_seq[:, 0], m16, mem)
            if prompt_weight is None:
                mem = prompted
            else:
                w = prompt_weight.to(torch.float32).reshape(b, 1, 1, 1)
                mem = w * prompted + (1.0 - w) * mem

        readout, mem = self.lkva(f16_seq, mem)            # (B,T,h16,w16,C)
        ro = readout.reshape(b * t, h16, w16, -1).permute(0, 3, 1, 2)
        logits = self.decoder(f4, f8, f16, ro, (hh, ww))
        logits = logits.reshape(b, t, hh, ww, self.cfg.num_classes)
        return logits, StreamState(mem=mem, frames_seen=state.frames_seen + t)


def train_model_config(cfg: ModelConfig,
                       image_size: int | None = None) -> ModelConfig:
    """Resolve ``gdr_impl="auto"`` for training, by memory-token count.

    As in the JAX package: keep "auto" (the kernels with the stored
    backward on the card, the plain chunked form on the CPU) when the
    stride-16 token count reaches 128 (256² frames: N=256), else resolve
    "chunked", whose autograd is the training path at EchoNet scale (112²:
    N=49).  Other values pass through.
    """
    if cfg.gdr_impl == "auto":
        n_tokens = None if image_size is None else (image_size // 16) ** 2
        if n_tokens is not None and n_tokens >= 128:
            return cfg
        return dataclasses.replace(cfg, gdr_impl="chunked")
    return cfg


def _lecun_normal_(p: Tensor, fan_in: int, gen: torch.Generator) -> None:
    """flax ``lecun_normal``: a normal truncated at ±2σ, scaled so that the
    variance is 1/fan_in.  Drawn on the CPU, so a seed gives the same
    weights on every device."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    vals = torch.empty(p.shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(vals, 0.0, std, -2.0 * std, 2.0 * std,
                                generator=gen)
    p.copy_(vals)


@torch.no_grad()
def init_params(model: GDKVM, gen: torch.Generator) -> GDKVM:
    """Initialize as the JAX package does: lecun_normal kernels, zero
    biases, norm scales 1; the α projection's kernel 0 with bias 4 (α ≈ 0.98,
    remember long) and the β bias −1.  ``gen`` is a CPU generator."""
    for mod in model.modules():
        if isinstance(mod, Conv):
            _, cin_g, kh, kw = mod.weight.shape
            _lecun_normal_(mod.weight, cin_g * kh * kw, gen)
        elif isinstance(mod, Dense):
            _lecun_normal_(mod.weight, mod.weight.shape[1], gen)
        elif isinstance(mod, BareKernel):
            _lecun_normal_(mod.kernel, mod.kernel.shape[0], gen)
        elif isinstance(mod, (GroupNorm, RMSNorm)):
            mod.scale.fill_(1.0)
        if getattr(mod, "bias", None) is not None:
            mod.bias.zero_()
    lkva = model.lkva
    lkva.alpha_proj.weight.zero_()
    lkva.alpha_proj.bias.fill_(4.0)
    lkva.beta_proj.bias.fill_(-1.0)
    return model
