"""GDKVM: encoder → LKVA/GDR memory → KPFF decoder (port of
gdkvm_tpu/models/gdkvm.py).

``GDKVM.forward(frames (B, T, H, W, C), state, prompt_mask, prompt_weight)``
returns ``(logits (B, T, H, W, K) fp32, StreamState)``.  Streaming is
successive calls with the returned state; an optional prompt mask is written
into the memory before the chunk's first frame.

A W8A8 model (``cfg.quant = "w8a8-<digest>"``) carries its scale table and
runs its calibrated convs int8 (ops/quant.py); ``ops.quant.w8a8_model``
builds one from a float model.

Head parallelism (the JAX package's ``model`` mesh axis > 1) splits the
LKVA heads over M model positions (models/lkva.py), each summing its
heads' share of the readout with the others'.  In a process group a rank
builds ``GDKVM(cfg, heads=(M, m), model_group=...)``, whose forward enters
the heads' region through ``parallel.distributed.model_copy`` and leaves
it through ``model_sum``; in one process :class:`HeadParallel` holds the
M shards on M devices and sums on the first.  ``StreamState.mem`` of a
shard holds its H/M heads.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Any, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from gdkvm_tpu_torch.config.schema import ModelConfig
from gdkvm_tpu_torch.core import gdr
from gdkvm_tpu_torch.models.decoder import Decoder, resize_bilinear
from gdkvm_tpu_torch.models.encoder import Encoder
from gdkvm_tpu_torch.models.layers import BareKernel, Conv, Dense, RMSNorm
from gdkvm_tpu_torch.models.lkva import LKVAMemory
from gdkvm_tpu_torch.ops import quant
from gdkvm_tpu_torch.ops.norms import GroupNorm
from gdkvm_tpu_torch.parallel import distributed
from gdkvm_tpu_torch.parallel.mesh import shard_state_dict

Tensor = torch.Tensor

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass
class StreamState:
    """Memory carried across chunks: mem (B, H, d_k, d_v) fp32 (a head
    shard's H; :class:`HeadParallel`'s: a tuple of its shards'), and
    frames_seen (B,) int32 for bookkeeping."""
    mem: Tensor
    frames_seen: Tensor


def make_lkva(cfg: ModelConfig, device: torch.device | str | None = None,
              heads: Tuple[int, int] = (1, 0)) -> LKVAMemory:
    """The LKVA of ``GDKVM(cfg)``, or its head shard ``heads`` = (M, m)."""
    return LKVAMemory(cfg.enc_channels[-1], cfg.num_classes, cfg.num_heads,
                      cfg.head_dim_k, cfg.head_dim_v,
                      out_channels=cfg.enc_channels[-1],
                      dtype=_DTYPES[cfg.compute_dtype], gdr_impl=cfg.gdr_impl,
                      gdr_variant=cfg.gdr_variant, device=device, heads=heads)


def _remember(lkva: LKVAMemory, x_seq: Tensor, mem: Tensor,
              m16: Optional[Tensor], prompt_weight: Optional[Tensor]
              ) -> Tuple[Tensor, Tensor]:
    """The memory's part of a forward: write the prompt (``m16``, the mask
    at stride 16) into ``mem`` before frame 0, blended by
    ``prompt_weight``, then read and write over the frames → (readout, new
    mem) of ``lkva``'s heads."""
    if m16 is not None:
        prompted = lkva.prompt_write(x_seq[:, 0], m16, mem)
        if prompt_weight is None:
            mem = prompted
        else:
            w = prompt_weight.to(torch.float32).reshape(-1, 1, 1, 1)
            mem = w * prompted + (1.0 - w) * mem
    return lkva(x_seq, mem)


class GDKVM(nn.Module):
    """Echocardiography video segmentation with gated delta-rule KV memory."""

    def __init__(self, cfg: ModelConfig,
                 device: torch.device | str | None = None,
                 quant_scales: Optional[Mapping[str, float]] = None,
                 heads: Tuple[int, int] = (1, 0), model_group: Any = None) -> None:
        """``quant_scales``: the W8A8 scale table {flax conv path: input
        scale}, with ``cfg.quant`` its ``quant.quant_tag``; a ``w8a8-`` tag
        without its table raises.  ``heads`` = (M, m): hold head shard m of
        M (M must divide ``cfg.num_heads``), its readout summed over
        ``model_group``, the process group of the M positions."""
        super().__init__()
        if cfg.mem_stride != 16:
            raise ValueError(
                f"model.mem_stride={cfg.mem_stride} is not supported: the "
                f"memory reads the encoder's deepest scale, stride 16")
        want = "none" if quant_scales is None else quant.quant_tag(quant_scales)
        if cfg.quant != want:
            raise ValueError(
                f"quant={cfg.quant!r} does not match the scale table given "
                f"({want!r}): build a W8A8 model with ops.quant.w8a8_model("
                f"model, load_scales(path)), which sets the tag")
        if cfg.param_dtype != "float32":
            raise ValueError(f"param_dtype must be float32, got {cfg.param_dtype!r}")
        self.cfg = cfg
        self.model_group = model_group
        dt = _DTYPES[cfg.compute_dtype]
        c16 = cfg.enc_channels[-1]
        self.encoder = Encoder(cfg.in_channels, tuple(cfg.enc_channels),
                               tuple(cfg.enc_blocks), dtype=dt,
                               stem=cfg.enc_stem, device=device)
        self.lkva = make_lkva(cfg, device, heads)
        self.decoder = Decoder(tuple(cfg.kpff_channels), tuple(cfg.enc_channels),
                               c16, cfg.num_classes, dtype=dt, device=device)
        if quant_scales is not None:
            convs = quant.eligible_convs(self)
            unknown = sorted(set(quant_scales) - set(convs))
            if unknown:
                raise ValueError(f"scales name no eligible conv of this model: "
                                 f"{unknown}")
            for path, s in quant_scales.items():
                convs[path].set_act_scale(s)

    def init_state(self, batch: int, device: torch.device | str) -> StreamState:
        c = self.cfg
        return StreamState(
            mem=gdr.init_state(batch, self.lkva.num_heads, c.head_dim_k,
                               c.head_dim_v, device),
            frames_seen=torch.zeros((batch,), dtype=torch.int32, device=device))

    def encode(self, frames: Tensor) -> Tuple[Tensor, ...]:
        """frames (B, T, H, W, C_in) → the encoder's (f4, f8, f16) of the
        B·T frames and f16 as (B, T, h16, w16, C), the memory's input."""
        b, t, hh, ww, ci = frames.shape
        f4, f8, f16 = self.encoder(frames.reshape(b * t, hh, ww, ci))
        h16, w16 = f16.shape[-2:]
        return f4, f8, f16, f16.permute(0, 2, 3, 1).reshape(b, t, h16, w16, f16.shape[1])

    def prompt_map(self, prompt_mask: Tensor, size: Tuple[int, int]) -> Tensor:
        """(B, H, W) class ids → their one-hot at stride 16 (B, h16, w16, K)."""
        onehot = F.one_hot(prompt_mask.long(), self.cfg.num_classes)
        return resize_bilinear(onehot.to(torch.float32).permute(0, 3, 1, 2),
                               size).permute(0, 2, 3, 1)

    def decode(self, feats: Tuple[Tensor, ...], readout: Tensor,
               size: Tuple[int, int]) -> Tensor:
        """The decoder over ``encode``'s features and the memory's readout
        (B, T, h16, w16, C) → logits (B, T, H, W, K) fp32."""
        f4, f8, f16, _ = feats
        b, t = readout.shape[:2]
        ro = readout.reshape(b * t, *readout.shape[2:]).permute(0, 3, 1, 2)
        logits = self.decoder(f4, f8, f16, ro, size)
        return logits.reshape(b, t, *size, self.cfg.num_classes)

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
        group = self.model_group
        if self.lkva.heads[0] > 1 and group is None:
            raise RuntimeError("a head shard's forward sums over its model group: "
                               "build it with model_group=, or run the shards "
                               "in one process through HeadParallel")
        feats = self.encode(frames)
        x = feats[3]
        m16 = None if prompt_mask is None else self.prompt_map(prompt_mask, x.shape[2:4])
        if group is not None:
            x = distributed.model_copy(x, group)
        readout, mem = _remember(self.lkva, x, state.mem, m16, prompt_weight)
        if group is not None:
            readout = distributed.model_sum(readout, group)
        logits = self.decode(feats, readout, (hh, ww))
        return logits, StreamState(mem=mem, frames_seen=state.frames_seen + t)


class HeadParallel(nn.Module):
    """One model's LKVA heads split over the ``M`` devices of one process
    (the serving engine's model over a row of a mesh): head shard m on
    ``devices[m]``, the encoder and the decoder (a copy of the model's) on
    ``devices[0]``, which sums the shards' partial readouts in fp32.  The
    state's ``mem`` is the tuple of the shards' (B, H/M, d_k, d_v), each on
    its device.  The forward equals the model's up to the order of that
    sum."""

    def __init__(self, model: GDKVM, devices: Sequence[torch.device | str]) -> None:
        super().__init__()
        self.devices = tuple(torch.device(d) for d in devices)
        m_axis = len(self.devices)
        self.cfg = model.cfg
        full = model.state_dict()
        self.base = copy.deepcopy(model).to(self.devices[0])
        shards = []
        for m, dev in enumerate(self.devices):
            lkva = make_lkva(model.cfg, dev, (m_axis, m))
            part = shard_state_dict(full, m_axis, m)
            lkva.load_state_dict({k[len("lkva."):]: v for k, v in part.items()
                                  if k.startswith("lkva.")})
            shards.append(lkva)
        self.base.lkva = shards[0]
        self.lkvas = nn.ModuleList(shards)
        self.train(model.training)

    def init_state(self, batch: int, device: torch.device | str | None = None
                   ) -> StreamState:
        c = self.cfg
        return StreamState(
            mem=tuple(gdr.init_state(batch, lkva.num_heads, c.head_dim_k, c.head_dim_v, dev)
                      for lkva, dev in zip(self.lkvas, self.devices)),
            frames_seen=torch.zeros((batch,), dtype=torch.int32, device=self.devices[0]))

    def forward(self, frames: Tensor, state: Optional[StreamState] = None,
                prompt_mask: Optional[Tensor] = None,
                prompt_weight: Optional[Tensor] = None
                ) -> Tuple[Tensor, StreamState]:
        """As :meth:`GDKVM.forward`, on ``devices[0]``'s frames."""
        b, t, hh, ww, _ = frames.shape
        if state is None:
            state = self.init_state(b)
        feats = self.base.encode(frames)
        x = feats[3]
        m16 = None if prompt_mask is None else self.base.prompt_map(prompt_mask, x.shape[2:4])
        readout, mems = None, []
        for lkva, mem, dev in zip(self.lkvas, state.mem, self.devices):
            part, mem = _remember(lkva, x.to(dev), mem, None if m16 is None else m16.to(dev),
                                  None if prompt_weight is None else prompt_weight.to(dev))
            part = part.to(self.devices[0], torch.float32)
            readout = part if readout is None else readout + part
            mems.append(mem)
        logits = self.base.decode(feats, readout.to(x.dtype), (hh, ww))
        return logits, StreamState(mem=tuple(mems), frames_seen=state.frames_seen + t)


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
    remember long) and the β bias −1 (and the η bias −1 of a ``gdn2`` model).
    ``gen`` is a CPU generator."""
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
    if lkva.gdr_variant == "gdn2":
        lkva.eta_proj.bias.fill_(-1.0)
    return model
