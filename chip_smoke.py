"""Smoke run of the PyTorch port (``gdkvm_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (nonzero exit) when it fails:

1. device and versions (torch, CUDA, nvcc, the card's name and power limit);
2. build the GDR forward kernel (``gdkvm_tpu_torch/csrc/gdr_fwd.cu``) with
   nvcc from the checkout's sources;
3. the kernel against its plain PyTorch version on identical inputs;
4. the ts8 model at full width, streaming 8 × 32-frame chunks at 112² with
   the state carried, through the kernel; the kernel's launches are counted
   and the result is held against the plain GDR path;
5. times on the card: frames/s of both paths, the kernel against the plain
   GDR at the bench shape.

The line before the last is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``.  Without a CUDA device the script
exits nonzero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time


def _sh(cmd: list[str]) -> str:
    res = subprocess.run(cmd, capture_output=True, text=True, check=True)
    return res.stdout.strip()


def _times_ms(fn, iters: int = 20, warmup: int = 3) -> list[float]:
    """Device times of ``iters`` calls of ``fn()`` (CUDA events), in ms."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def _gdr_inputs(gen, b, h, t, n, dk, dv, dtype, device):
    """Random GDR operands shaped like the model's: unit-norm keys, gates in
    (0, 1), α near 1."""
    import torch
    f32 = dict(device=device, dtype=torch.float32, generator=gen)
    q = torch.randn((b, h, t, n, dk), **f32)
    k = torch.randn((b, h, t, n, dk), **f32)
    q = q * torch.rsqrt((q * q).sum(-1, keepdim=True) + 1e-6)
    k = k * torch.rsqrt((k * k).sum(-1, keepdim=True) + 1e-6)
    v = torch.randn((b, h, t, n, dv), **f32)
    beta = torch.sigmoid(torch.randn((b, h, t, n), **f32))
    alpha = torch.sigmoid(torch.randn((b, h, t), **f32) + 2.0)
    s0 = 0.1 * torch.randn((b, h, dk, dv), **f32)
    return (q.to(dtype), k.to(dtype), v.to(dtype), beta, alpha, s0)


# Kernel against plain version: both see identical inputs and both run fp32
# math, so they differ only in summation order.
RTOL, ATOL = 1e-4, 1e-5


def phase_device() -> dict:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this run needs a CUDA device")
    from gdkvm_tpu_torch.ops import _build
    nvcc = _build.nvcc_path()
    smi = _sh(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"])
    print(f"torch {torch.__version__}  cuda {torch.version.cuda}  "
          f"python {sys.version.split()[0]}")
    print(f"nvcc {nvcc}: {_sh([nvcc, '--version']).splitlines()[-1]}")
    print(f"device {torch.cuda.get_device_name(0)}  "
          f"count {torch.cuda.device_count()}")
    print(f"nvidia-smi: {smi.splitlines()[0]}")
    return {"smi": smi.splitlines()[0]}


def phase_build() -> None:
    from gdkvm_tpu_torch.ops import _build, gdr_cuda
    t0 = time.perf_counter()
    path = _build.build("gdr_fwd")
    print(f"build: {path.name} in {time.perf_counter() - t0:.1f} s")
    print(path.with_suffix(".log").read_text().strip())
    lib = gdr_cuda._lib()
    for n, dk, dv in ((49, 64, 64), (7, 8, 8), (64, 64, 64)):
        c_bytes = lib.gdr_fwd_smem_bytes(n, dk, dv)
        if c_bytes != gdr_cuda.smem_bytes(n, dk, dv):
            raise AssertionError(f"smem_bytes disagrees with the source at "
                                 f"{(n, dk, dv)}: {gdr_cuda.smem_bytes(n, dk, dv)}"
                                 f" vs {c_bytes}")


def phase_kernel_vs_plain(device) -> float:
    import torch
    from gdkvm_tpu_torch.core import gdr
    from gdkvm_tpu_torch.ops import gdr_cuda

    gen = torch.Generator(device=device).manual_seed(0)
    bench = (8, 4, 32, 49, 64, 64)
    cases = [
        ("bench bf16", bench, torch.bfloat16),
        ("bench fp32", bench, torch.float32),
        ("T=1", (8, 4, 1, 49, 64, 64), torch.bfloat16),
        ("N=16", (8, 4, 32, 16, 64, 64), torch.bfloat16),
        ("N=7", (8, 4, 32, 7, 64, 64), torch.bfloat16),
        ("N=64", (2, 4, 8, 64, 64, 64), torch.float32),
        ("dk=32 dv=64", (2, 3, 5, 49, 32, 64), torch.float32),
    ]
    worst = 0.0
    for name, shape, dtype in cases:
        args = _gdr_inputs(gen, *shape, dtype, device)
        o_k, s_k = gdr_cuda.gdr_fwd_cuda(*args)
        o_p, s_p = gdr.gdr_chunked(*args)
        torch.cuda.synchronize()
        err = max((o_k - o_p).abs().max().item(), (s_k - s_p).abs().max().item())
        print(f"kernel vs plain [{name}] shape {shape} {dtype}: "
              f"max|Δo|={(o_k - o_p).abs().max().item():.3e} "
              f"max|Δs_T|={(s_k - s_p).abs().max().item():.3e}")
        torch.testing.assert_close(o_k, o_p, rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(s_k, s_p, rtol=RTOL, atol=ATOL)
        worst = max(worst, err)

    # Two chained calls with the state carried equal one call.
    q, k, v, beta, alpha, s0 = _gdr_inputs(gen, *bench, torch.bfloat16, device)
    o_full, s_full = gdr_cuda.gdr_fwd_cuda(q, k, v, beta, alpha, s0)
    half = lambda x, lo, hi: x[:, :, lo:hi].contiguous()
    o_a, s_a = gdr_cuda.gdr_fwd_cuda(*(half(x, 0, 16) for x in (q, k, v, beta, alpha)), s0)
    o_b, s_b = gdr_cuda.gdr_fwd_cuda(*(half(x, 16, 32) for x in (q, k, v, beta, alpha)), s_a)
    torch.cuda.synchronize()
    torch.testing.assert_close(torch.cat([o_a, o_b], 2), o_full, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(s_b, s_full, rtol=RTOL, atol=ATOL)
    print(f"kernel chained 16+16 vs 32: max|Δs_T|="
          f"{(s_b - s_full).abs().max().item():.3e}")
    return worst


def phase_gdr_times(device) -> tuple[float, float]:
    """Median ms of the kernel and of the plain GDR at the bench shape, timed
    in turns (plain, kernel, kernel, plain)."""
    import statistics
    import torch
    from gdkvm_tpu_torch.core import gdr
    from gdkvm_tpu_torch.ops import gdr_cuda
    gen = torch.Generator(device=device).manual_seed(1)
    args = _gdr_inputs(gen, 8, 4, 32, 49, 64, 64, torch.bfloat16, device)
    plain = _times_ms(lambda: gdr.gdr_chunked(*args))
    kern = _times_ms(lambda: gdr_cuda.gdr_fwd_cuda(*args))
    kern += _times_ms(lambda: gdr_cuda.gdr_fwd_cuda(*args))
    plain += _times_ms(lambda: gdr.gdr_chunked(*args))
    kern_ms, plain_ms = statistics.median(kern), statistics.median(plain)
    print(f"GDR at B=8 H=4 T=32 N=49 d=64 bf16 q/k/v, median of {len(kern)} "
          f"calls: kernel {kern_ms:.4f} ms, plain {plain_ms:.4f} ms "
          f"(kernel min {min(kern):.4f} max {max(kern):.4f}; "
          f"plain min {min(plain):.4f} max {max(plain):.4f})")
    return kern_ms, plain_ms


def phase_model(device) -> dict:
    """The ts8 model at full width, streaming through the kernel; then the
    same weights through the plain GDR."""
    import dataclasses
    import torch
    from gdkvm_tpu_torch.config.schema import ModelConfig
    from gdkvm_tpu_torch.core import gdr
    from gdkvm_tpu_torch.eval.metrics import mask_from_logits
    from gdkvm_tpu_torch.eval.throughput import measure_streaming_fps
    from gdkvm_tpu_torch.models.gdkvm import GDKVM, init_params
    from gdkvm_tpu_torch.ops import gdr_cuda

    cfg = ModelConfig(num_classes=2, in_channels=1,
                      enc_channels=(64, 64, 128, 192), enc_blocks=(1, 1, 2, 2),
                      num_heads=4, head_dim_k=64, head_dim_v=64,
                      kpff_channels=(128, 96))
    model = init_params(GDKVM(cfg, device=device),
                        torch.Generator().manual_seed(0)).eval()
    plain = GDKVM(dataclasses.replace(cfg, gdr_impl="chunked"), device=device)
    plain.load_state_dict(model.state_dict())
    plain.eval()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"ts8: {n_params} parameters, bf16 compute, fp32 params")
    stream = dict(image_size=112, chunk=32, batch=8, warmup_chunks=3,
                  timed_chunks=20)
    n_chunks = 1 + stream["warmup_chunks"] + stream["timed_chunks"]

    # The main path: every count is 0 just before, and read just after.
    gdr_cuda.LAUNCHES.reset()
    gdr.CHUNKED_CALLS.reset()
    fps_kernel = measure_streaming_fps(model, device, **stream)
    launches, plain_calls = gdr_cuda.LAUNCHES.n, gdr.CHUNKED_CALLS.n
    print(f"main path: {n_chunks} chunks of 8 x 32 frames at 112^2, "
          f"kernel launches {launches}, plain GDR calls {plain_calls}")
    if launches != n_chunks:
        raise AssertionError(f"kernel launched {launches} times for {n_chunks} chunks")
    if plain_calls != 0:
        raise AssertionError(f"the plain GDR ran {plain_calls} times on the main path")

    # The same weights and input through the kernel and the plain GDR.
    rng = torch.Generator().manual_seed(1)
    frames = torch.randint(0, 255, (8, 32, 112, 112, 1), generator=rng,
                           dtype=torch.uint8).to(device)
    x = frames.to(torch.float32) / 255.0
    with torch.inference_mode():
        logits_k, state_k = model(x)
        logits_p, state_p = plain(x)
    torch.cuda.synchronize()
    if logits_k.shape != (8, 32, 112, 112, 2) or logits_k.dtype != torch.float32:
        raise AssertionError(f"logits {tuple(logits_k.shape)} {logits_k.dtype}")
    if not bool(torch.isfinite(logits_k).all()):
        raise AssertionError("non-finite logits on the kernel path")
    agree = (mask_from_logits(logits_k) == mask_from_logits(logits_p)
             ).to(torch.float32).mean().item()
    s_rel = ((state_k.mem - state_p.mem).abs().max()
             / state_p.mem.abs().max()).item()
    print(f"kernel path vs plain path, one 8 x 32 chunk: mask agreement "
          f"{agree:.6f}, max|Δs_T|/max|s_T| {s_rel:.3e}, "
          f"max|Δlogit| {(logits_k - logits_p).abs().max().item():.3e}")
    if agree < 0.999:
        raise AssertionError(f"mask agreement {agree} < 0.999")
    if s_rel > 1e-4:
        raise AssertionError(f"state relative error {s_rel} > 1e-4")

    # Frames/s in turns: kernel (above), plain, kernel, plain.
    fps_plain = measure_streaming_fps(plain, device, **stream)
    fps_kernel2 = measure_streaming_fps(model, device, **stream)
    fps_plain2 = measure_streaming_fps(plain, device, **stream)
    runs = [fps_kernel, fps_plain, fps_kernel2, fps_plain2]
    print("frames/s (kernel, plain, kernel, plain): "
          + " ".join(f"{r['frames_per_sec']:.1f}" for r in runs))
    print(f"peak device memory {torch.cuda.max_memory_allocated(device) / 2**20:.1f} MiB")
    return {"launches": launches}


def main() -> int:
    info = phase_device()
    import torch
    # fp32 products in full fp32 everywhere: the plain GDR drifts under TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda:0")
    phase_build()
    err = phase_kernel_vs_plain(device)
    main_path = phase_model(device)
    kern_ms, plain_ms = phase_gdr_times(device)
    print(json.dumps({"kernels": [{
        "name": "gdr_fwd", "route": "cuda",
        "source": "gdkvm_tpu_torch/csrc/gdr_fwd.cu",
        "replaces": "gdkvm_tpu/ops/gdr_pallas.py:513",
        "launches": main_path["launches"], "max_abs_err": err,
        "ms": kern_ms, "plain_ms": plain_ms}]}))
    print(f"card: {info['smi']}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
