"""Export of the streaming step for deployment: a ``torch.export`` program
(port of gdkvm_tpu/io/export.py).

The artifact is the streaming step — uint8 frames in, mask logits and the
carried memory state out — as an ``ExportedProgram`` with the trained
parameters in it (a W8A8 model's int8 weights and scales as buffers, its
products as ``aten._int_mm`` nodes).  A consumer needs torch and this package's
``ops.gdr_cuda`` (which registers the GDR forward as the custom op
``gdkvm_tpu_torch::gdr_fwd``), but none of the model code: the recurrence
is frozen into the program's graph, where the GDR is one node.

Artifact layout (one directory):
    model.pt2       ``torch.export.save`` of the step
    meta.json       shapes of the step signature, the platform, the model
                    config

The exported step signature (positional, static shapes):
    (frames_u8 (B,T,H,W,C) uint8, mem (B,heads,dk,dv) f32,
     frames_seen (B,) i32)
      -> (logits (B,T,H,W,K) f32, mem', frames_seen')

An artifact belongs to the device type it was exported on (``cuda`` or
``cpu``): the JAX package's multi-platform export has no counterpart, and a
list of more than one platform raises.  On the card the GDR node launches
the kernel of the ``GDKVM_GDR_FWD`` split read when it runs; on the CPU it
runs the plain chunked scan.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from gdkvm_tpu_torch.eval.streaming import model_device
from gdkvm_tpu_torch.models.gdkvm import GDKVM, StreamState
# Registers torch.ops.gdkvm_tpu_torch.gdr_fwd, which the program calls:
# torch.export.load cannot read a program whose ops are not registered.
from gdkvm_tpu_torch.ops import gdr_cuda  # noqa: F401
from gdkvm_tpu_torch.ops import quant

Tensor = torch.Tensor

_BLOB = "model.pt2"
_META = "meta.json"
FORMAT = "gdkvm-torch-export-v1"


class StreamingStep(nn.Module):
    """The serving step around a model: frames divided by 255, the state
    passed as two tensors."""

    def __init__(self, model: GDKVM) -> None:
        super().__init__()
        self.model = model

    def forward(self, frames_u8: Tensor, mem: Tensor, frames_seen: Tensor
                ) -> Tuple[Tensor, Tensor, Tensor]:
        frames = frames_u8.to(torch.float32) / 255.0
        logits, state = self.model(frames, StreamState(mem=mem,
                                                       frames_seen=frames_seen))
        return logits, state.mem, state.frames_seen


def _platform(model: GDKVM, platforms: Optional[Sequence[str]]) -> str:
    """The one device type of the export: the model's.  ``platforms``, when
    given, must name just that one."""
    kind = model_device(model).type
    if platforms is not None:
        platforms = tuple(platforms)
        if len(platforms) != 1:
            raise ValueError(
                f"platforms={platforms}: a torch.export artifact belongs to the "
                f"one device type it was exported on; export once per platform")
        if platforms[0] != kind:
            raise ValueError(f"platforms={platforms}: the model is on {kind}; "
                             f"move it there (export --device) to export for it")
    return kind


def export_streaming(model: GDKVM, *, image_size: int, chunk: int = 16,
                     batch: int = 1,
                     platforms: Optional[Sequence[str]] = None
                     ) -> torch.export.ExportedProgram:
    """``torch.export`` of the streaming step at static shapes, on the
    model's device, under ``torch.no_grad`` (so that the GDR is the
    residual-free custom op, not the autograd route)."""
    _platform(model, platforms)
    c = model.cfg
    device = model_device(model)
    args = (
        torch.zeros((batch, chunk, image_size, image_size, c.in_channels),
                    dtype=torch.uint8, device=device),
        torch.zeros((batch, c.num_heads, c.head_dim_k, c.head_dim_v),
                    dtype=torch.float32, device=device),
        torch.zeros((batch,), dtype=torch.int32, device=device),
    )
    quant.refresh_w8a8(model)         # a W8A8 model's int8 weights, current
    with torch.no_grad():
        return torch.export.export(StreamingStep(model.eval()), args)


def save_artifact(out_dir: str, model: GDKVM, *, image_size: int,
                  chunk: int = 16, batch: int = 1,
                  platforms: Optional[Sequence[str]] = None) -> dict:
    """Export and write the artifact directory; returns the metadata."""
    kind = _platform(model, platforms)
    ep = export_streaming(model, image_size=image_size, chunk=chunk,
                          batch=batch)
    os.makedirs(out_dir, exist_ok=True)
    blob = os.path.join(out_dir, _BLOB)
    torch.export.save(ep, blob)
    c = model.cfg
    meta = {
        "format": FORMAT,
        "signature": {
            "frames_u8": [batch, chunk, image_size, image_size,
                          c.in_channels],
            "mem": [batch, c.num_heads, c.head_dim_k, c.head_dim_v],
            "frames_seen": [batch],
            "outputs": ["logits (B,T,H,W,K) f32", "mem f32",
                        "frames_seen i32"],
        },
        "num_classes": c.num_classes,
        "platforms": [kind],
        "model_config": dataclasses.asdict(c),
        "blob_bytes": os.path.getsize(blob),
    }
    with open(os.path.join(out_dir, _META), "w") as f:
        json.dump(meta, f, indent=1, default=str)
    return meta


def read_meta(art_dir: str) -> dict:
    with open(os.path.join(art_dir, _META)) as f:
        meta = json.load(f)
    if meta.get("format") != FORMAT:
        raise ValueError(f"{art_dir}: format {meta.get('format')!r}, expected "
                         f"{FORMAT!r} (an artifact of this package's export)")
    return meta


class ServingModel:
    """A loaded serving artifact: feed uint8 chunks, thread the state."""

    def __init__(self, art_dir: str,
                 device: Optional[torch.device | str] = None) -> None:
        self.meta = read_meta(art_dir)
        kind = self.meta["platforms"][0]
        if device is not None and torch.device(device).type != kind:
            raise ValueError(f"{art_dir} was exported for {kind} and runs only "
                             f"there, not on {device}: export it again there")
        if kind == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"{art_dir} was exported for cuda: no CUDA device")
        self.program = torch.export.load(os.path.join(art_dir, _BLOB))
        self._step = self.program.module()
        self.device = next(iter(self.program.state_dict.values())).device
        if device is not None and torch.device(device).index not in (
                None, self.device.index):
            raise ValueError(f"{art_dir} holds its weights on {self.device}, "
                             f"not on {device}")
        sig = self.meta["signature"]
        self.batch, self.chunk = sig["frames_u8"][0], sig["frames_u8"][1]

    def init_state(self) -> Tuple[Tensor, Tensor]:
        sig = self.meta["signature"]
        return (torch.zeros(sig["mem"], dtype=torch.float32, device=self.device),
                torch.zeros(sig["frames_seen"], dtype=torch.int32,
                            device=self.device))

    @torch.inference_mode()
    def step(self, frames_u8: Tensor, mem: Tensor, frames_seen: Tensor
             ) -> Tuple[Tensor, Tensor, Tensor]:
        """One chunk: returns (logits, mem', frames_seen')."""
        return self._step(frames_u8, mem, frames_seen)


def load_artifact(art_dir: str,
                  device: Optional[torch.device | str] = None) -> ServingModel:
    """Load an artifact; ``device`` (default: where it was exported) must
    be of the device type it was exported for."""
    return ServingModel(art_dir, device)
