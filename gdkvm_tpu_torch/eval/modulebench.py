"""Per-module FLOP and time breakdown of the GDKVM forward and of the train
step (port of gdkvm_tpu/eval/modulebench.py: the same rows and keys).

Answers "where do the FLOPs and the milliseconds go" per module: encoder,
LKVA/GDR memory, decoder, loss.

Method:
  - Time: on a CUDA device, two CUDA events around ``reps`` calls of the
    module after a warm-up, divided by ``reps``: the device's timeline,
    launch gaps of a host-bound module included.  On the CPU, the host
    clock around the same loop.  Nothing is subtracted:
    ``floor_ms_per_rep`` reads 0.0 and ``_meta["clock"]`` names the clock.
  - FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over one call
    (matrix products and convolutions, 2 a multiply-add), plus the GDR
    kernels' own counts (``ops/gdr_counts.py``, every product once) for
    each launch the call made: the counter cannot see a kernel launched
    through ctypes.

The modules run as the model runs them: their compute-dtype casts are the
model's own.
"""

from __future__ import annotations

import time
from typing import Callable, Dict

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from gdkvm_tpu_torch.eval.streaming import model_device
from gdkvm_tpu_torch.models.gdkvm import GDKVM
from gdkvm_tpu_torch.ops import gdr_counts, gdr_cuda
from gdkvm_tpu_torch.train import losses

Tensor = torch.Tensor


def _flops_of(fn: Callable[[], object], gdr_shape: tuple) -> float:
    """FLOPs of one call of ``fn()``: the counter's total plus the GDR
    kernels' counts at ``gdr_shape`` (B, H, T, N, d_k, d_v) for each launch
    the call made."""
    before = (gdr_cuda.LAUNCHES.n, gdr_cuda.CHAIN_LAUNCHES.n, gdr_cuda.BWD_LAUNCHES.n)
    with FlopCounterMode(display=False) as counter:
        fn()
    fwd, chain, bwd = (c.n - b for c, b in zip(
        (gdr_cuda.LAUNCHES, gdr_cuda.CHAIN_LAUNCHES, gdr_cuda.BWD_LAUNCHES), before))
    return float(counter.get_total_flops()
                 + fwd * gdr_counts.fwd_ops(*gdr_shape, None)
                 + chain * gdr_counts.chain_ops(*gdr_shape, None)
                 + bwd * gdr_counts.bwd_ops(*gdr_shape, None))


def _timed(fn: Callable[[], object], reps: int, device: torch.device,
           warmup: int = 3) -> float:
    """ms a call of ``fn()`` over ``reps`` calls after ``warmup``."""
    for _ in range(warmup):
        fn()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def _rows(mods: Dict[str, Callable[[], object]], reps: int, device: torch.device,
          gdr_shape: tuple) -> Dict[str, Dict[str, float]]:
    out: Dict[str, Dict[str, float]] = {}
    for name, fn in mods.items():
        flops = _flops_of(getattr(fn, "for_flops", fn), gdr_shape)
        ms = _timed(fn, reps, device)
        out[name] = {
            "flops_per_call": flops,
            "ms_per_call": round(ms, 4),
            "tflops_per_sec": round(flops / (ms * 1e-3) / 1e12, 2)
            if ms > 0 else float("nan"),
        }
    return out


def _meta(device: torch.device, **kw) -> Dict[str, object]:
    return dict(
        kw, floor_ms_per_rep=0.0,
        clock="cuda_events" if device.type == "cuda" else "host_perf_counter",
        device=(torch.cuda.get_device_name(device) if device.type == "cuda"
                else "cpu"),
        method="mean over reps calls after a warm-up, no floor subtracted; "
               "FLOPs from FlopCounterMode plus the GDR kernels' own counts")


def _inputs(model: GDKVM, image_size: int, chunk: int, batch: int, seed: int):
    c = model.cfg
    device = model_device(model)
    rng = np.random.default_rng(seed)
    frames = torch.from_numpy(rng.integers(
        0, 255, (batch, chunk, image_size, image_size, c.in_channels),
        np.uint8)).to(device).to(torch.float32) / 255.0
    masks = torch.from_numpy(rng.integers(
        0, c.num_classes, (batch, chunk, image_size, image_size),
        np.int32)).to(device).long()
    valid = torch.ones((batch, chunk), dtype=torch.float32, device=device)
    gdr_shape = (batch, c.num_heads, chunk, (image_size // 16) ** 2,
                 c.head_dim_k, c.head_dim_v)
    return device, frames, masks, valid, gdr_shape


def _split(model: GDKVM, frames: Tensor):
    """The model's stages on ``frames``: (f4, f8, f16), the stride-16
    sequence, the zero state, and the decoder's readout input."""
    b, t, hh, ww, ci = frames.shape
    f4, f8, f16 = model.encoder(frames.reshape(b * t, hh, ww, ci))
    h16, w16 = f16.shape[-2:]
    f16_seq = f16.permute(0, 2, 3, 1).reshape(b, t, h16, w16, f16.shape[1])
    state0 = model.init_state(b, frames.device).mem
    readout, _ = model.lkva(f16_seq, state0)
    ro = readout.reshape(b * t, h16, w16, -1).permute(0, 3, 1, 2)
    return (f4, f8, f16), f16_seq, state0, ro


@torch.inference_mode()
def module_breakdown(model: GDKVM, *, image_size: int = 112, chunk: int = 16,
                     batch: int = 1, reps: int = 100, include_loss: bool = True,
                     seed: int = 0) -> Dict[str, Dict[str, float]]:
    """FLOPs and ms per module of the forward, on the model's device, under
    ``torch.inference_mode()``: rows ``encoder``, ``lkva_gdr``, ``decoder``,
    ``full_model``, ``loss`` and ``_meta``."""
    device, frames, masks, valid, gdr_shape = _inputs(model, image_size, chunk,
                                                      batch, seed)
    b, t, hh, ww, ci = frames.shape
    (f4, f8, f16), f16_seq, state0, ro = _split(model, frames)
    logits = model.decoder(f4, f8, f16, ro, (hh, ww))
    mods = {
        "encoder": lambda: model.encoder(frames.reshape(b * t, hh, ww, ci)),
        "lkva_gdr": lambda: model.lkva(f16_seq, state0),
        "decoder": lambda: model.decoder(f4, f8, f16, ro, (hh, ww)),
        "full_model": lambda: model(frames),
    }
    if include_loss:
        lg5 = logits.reshape(b, t, hh, ww, -1)
        mods["loss"] = lambda: losses.segmentation_loss(lg5, masks, valid)[0]

    out = _rows(mods, reps, device, gdr_shape)
    full_ms = out["full_model"]["ms_per_call"]
    for row in out.values():
        row["pct_of_full_time"] = round(100 * row["ms_per_call"]
                                        / max(full_ms, 1e-9), 1)
    parts = [n for n in ("encoder", "lkva_gdr", "decoder") if n in out]
    sum_parts = sum(out[n]["ms_per_call"] for n in parts)
    out["_meta"] = _meta(device, image_size=image_size, chunk=chunk, batch=batch,
                         reps=reps, sum_parts_ms=round(sum_parts, 4),
                         fusion_gain_ms=round(sum_parts - full_ms, 4))
    return out


def _tree_sum(tree) -> Tensor:
    leaves = tree if isinstance(tree, (tuple, list)) else (tree,)
    return sum(x.to(torch.float32).sum() for x in leaves)


def grad_breakdown(model: GDKVM, *, image_size: int = 256, chunk: int = 10,
                   batch: int = 8, reps: int = 100, opt=None,
                   seed: int = 0) -> Dict[str, Dict[str, float]]:
    """Per-module forward+backward (train-step) breakdown, on the model's
    device.  Each row times the gradient of the module's subgraph:

      - encoder: grad wrt its params (first layer: no input cotangent).
      - lkva_gdr: grad wrt (params, f16 sequence): the input cotangent is
        the flow back into the encoder, a real cost in the step.
      - decoder: grad wrt (params, f4, f8, f16, readout).
      - loss: grad wrt logits.
      - full_fwd_bwd: the gradient of the complete training loss wrt the
        params (prompting branch included at weight 0.5, as in the recipe).
      - optimizer: ``opt.step(grads)`` (a ``train.loop.Optimizer``) on a
        full set of gradients; it moves the model's parameters.
      - train_step_total: full_fwd_bwd then the optimizer.

    Rows overlap the full step rather than summing to it; use them to rank
    line items.  FLOPs cover the forward and the backward.
    """
    device, frames, masks, valid, gdr_shape = _inputs(model, image_size, chunk,
                                                      batch, seed)
    b, t, hh, ww, ci = frames.shape
    prompt_mask = masks[:, 0]
    prompt_w = torch.full((b,), 0.5, dtype=torch.float32, device=device)
    params = list(model.parameters())
    with torch.no_grad():
        (f4, f8, f16), f16_seq, state0, ro = _split(model, frames)
        logits = model.decoder(f4, f8, f16, ro, (hh, ww)).reshape(b, t, hh, ww, -1)
    leaf = lambda x: x.detach().clone().requires_grad_(True)
    f4, f8, f16, f16_seq, ro, logits = (leaf(x) for x in (f4, f8, f16, f16_seq,
                                                          ro, logits))

    def grad_of(fn, wrt):
        run = lambda: torch.autograd.grad(fn(), wrt, allow_unused=True)

        def for_flops():
            # The counter's module hooks do not take autograd.grad on leaf
            # tensors: the same backward through .backward(), grads dropped.
            fn().backward(inputs=wrt)
            for x in wrt:
                x.grad = None
        run.for_flops = for_flops
        return run

    def full_loss():
        lg, _ = model(frames, None, prompt_mask, prompt_w)
        return losses.segmentation_loss(lg, masks, valid)[0]

    full_grads = grad_of(full_loss, params)
    mods = {
        "encoder": grad_of(
            lambda: _tree_sum(model.encoder(frames.reshape(b * t, hh, ww, ci))),
            list(model.encoder.parameters())),
        "lkva_gdr": grad_of(lambda: _tree_sum(model.lkva(f16_seq, state0)),
                            list(model.lkva.parameters()) + [f16_seq]),
        "decoder": grad_of(
            lambda: _tree_sum(model.decoder(f4, f8, f16, ro, (hh, ww))),
            list(model.decoder.parameters()) + [f4, f8, f16, ro]),
        "loss": grad_of(lambda: losses.segmentation_loss(logits, masks, valid)[0],
                        [logits]),
        "full_fwd_bwd": full_grads,
    }
    if opt is not None:
        grads = list(full_grads())
        mods["optimizer"] = lambda: opt.step(grads)
        total = lambda: opt.step(list(full_grads()))
        total.for_flops = lambda: (full_grads.for_flops(), opt.step(grads))
        mods["train_step_total"] = total

    out = _rows(mods, reps, device, gdr_shape)
    ref = out.get("train_step_total", out["full_fwd_bwd"])["ms_per_call"]
    for row in out.values():
        row["pct_of_step_time"] = round(
            100 * row["ms_per_call"] / max(ref, 1e-9), 1)
    out["_meta"] = _meta(device, image_size=image_size, chunk=chunk, batch=batch,
                         reps=reps, mode="grad")
    return out
