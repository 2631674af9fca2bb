"""Smoke run of the PyTorch port (``gdkvm_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (nonzero exit) when it fails:

1. device and versions (torch, CUDA, nvcc, the card's name and power limit);
2. build the GDR kernels (``gdkvm_tpu_torch/csrc/gdr_fwd.cu`` and
   ``gdr_bwd.cu``) with nvcc from the checkout's sources, in parallel;
3. each kernel against its plain PyTorch version on identical inputs: the
   forward without residuals at the streaming shapes, the forward with its
   residuals (S_{t-1}, U, W) and the backward at the training shape (B=8
   H=4 T=10 N=256 d=64, bf16 q/k/v) and at small shapes; fused against
   stored gradients through the autograd Function;
4. streaming (the first main path): the ts8 model at full width streams
   8 × 32-frame chunks at 112² with the state carried, through the forward
   kernel; launches are counted and the result held against the plain GDR;
5. training (the second main path): ``train(cfg, max_steps)`` on the
   ``ts8_256`` recipe (256², batch 8 × 10 frames, 4 classes, bootstrapped
   CE) on synthetic clips, in the stored and the fused backward mode, with
   every kernel's and plain version's calls counted; then one step's
   gradients (finite everywhere, nonzero in the LKVA projections) and the
   kernel path against the plain chunked path from the same weights;
6. times on the card: frames/s of streaming and steps/s of training on both
   paths, and each kernel against its plain version at its main path's
   shape, timed in turns.

The line before the last is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``.  Without a CUDA device the script
exits nonzero and prints no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor


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


def _in_turns(plain, kernel, iters: int = 20) -> tuple[float, float, str]:
    """Median ms of ``kernel`` and ``plain`` timed in turns (plain, kernel,
    kernel, plain), with the spread as text."""
    p = _times_ms(plain, iters)
    k = _times_ms(kernel, iters)
    k += _times_ms(kernel, iters)
    p += _times_ms(plain, iters)
    spread = (f"median of {len(k)} calls; kernel min {min(k):.4f} max "
              f"{max(k):.4f}, plain min {min(p):.4f} max {max(p):.4f}")
    return statistics.median(k), statistics.median(p), spread


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


def _rel(got, want) -> float:
    """max |got − want| / max |want|."""
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


def _abs(got, want) -> float:
    return (got - want).abs().max().item()


# Streaming forward kernel against its plain version: both see identical
# inputs and both run fp32 math, so they differ only in summation order.
RTOL, ATOL = 1e-4, 1e-5
# Residual forward and backward against their plain versions, as max|Δ| over
# max|plain| per output: fp32 on both sides, so they differ in summation
# order only (the kernels solve by panels, the plain versions with cuBLAS);
# measured ≤ 1.6e-6 at every shape, N=301 included.
FWD_REL = BWD_REL = 1e-5
# Shapes of the residual-forward and backward comparisons.
TRAIN_SHAPE = (8, 4, 10, 256, 64, 64)
GRAD_CASES = [
    ("train bf16", TRAIN_SHAPE, "bfloat16"),
    ("train fp32", (2, 4, 10, 256, 64, 64), "float32"),
    ("N=7", (8, 4, 10, 7, 64, 64), "bfloat16"),
    ("N=49", (8, 4, 10, 49, 64, 64), "bfloat16"),
    ("N=138 (panels)", (2, 2, 3, 138, 64, 64), "float32"),
    ("N=301 (largest)", (1, 2, 2, 301, 64, 64), "float32"),
    ("T=1", (8, 4, 1, 256, 64, 64), "bfloat16"),
    ("dk=32 dv=64", (2, 3, 5, 256, 32, 64), "float32"),
]


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
    """Build both kernels at once (one nvcc each), then check that the
    wrappers' shared-memory and scratch sizes agree with the sources'."""
    from gdkvm_tpu_torch.ops import _build, gdr_cuda
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        paths = list(pool.map(_build.build, ["gdr_fwd", "gdr_bwd"]))
    print(f"build: {', '.join(p.name for p in paths)} in "
          f"{time.perf_counter() - t0:.1f} s")
    for path in paths:
        print(path.with_suffix(".log").read_text().strip())
    fwd, bwd = gdr_cuda._lib(), gdr_cuda._bwd_lib()
    for n, dk, dv in ((49, 64, 64), (7, 8, 8), (64, 64, 64), (137, 64, 64),
                      (138, 64, 64), (256, 64, 64), (256, 32, 64),
                      (301, 64, 64)):
        pairs = [
            ("fwd smem", fwd.gdr_fwd_smem_bytes(n, dk, dv),
             gdr_cuda.smem_bytes(n, dk, dv)),
            ("fwd panels", fwd.gdr_fwd_uses_panels(n, dk, dv),
             int(gdr_cuda.fwd_uses_panels(n, dk, dv))),
            ("bwd smem", bwd.gdr_bwd_smem_bytes(n, dk, dv),
             gdr_cuda.bwd_smem_bytes(n, dk, dv)),
            ("bwd scratch", bwd.gdr_bwd_scratch_floats(n, dk, dv),
             gdr_cuda.bwd_scratch_floats(n, dk, dv)),
        ]
        for what, c_val, py_val in pairs:
            if c_val != py_val:
                raise AssertionError(f"{what} at {(n, dk, dv)}: source {c_val}, "
                                     f"wrapper {py_val}")


def phase_kernel_vs_plain(device) -> float:
    """The forward kernel without residuals (the streaming path's) against
    the plain chunked GDR."""
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
        err = max(_abs(o_k, o_p), _abs(s_k, s_p))
        print(f"fwd kernel vs plain [{name}] shape {shape} {dtype}: "
              f"max|Δo|={_abs(o_k, o_p):.3e} max|Δs_T|={_abs(s_k, s_p):.3e}")
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
    print(f"fwd kernel chained 16+16 vs 32: max|Δs_T|={_abs(s_b, s_full):.3e}")
    return worst


def _check_rel(label: str, names, got, want, bar: float) -> float:
    """Print and check max|Δ|/max|plain| per output; return the worst
    absolute error."""
    rels = {n: _rel(g, w) for n, g, w in zip(names, got, want)}
    print(f"{label}: " + " ".join(f"{n} {r:.2e}" for n, r in rels.items())
          + f" (max|Δ|/max|plain|, bar {bar:g})")
    bad = {n: r for n, r in rels.items() if not r <= bar}
    if bad:
        raise AssertionError(f"{label}: over the bar {bar}: {bad}")
    return max(_abs(g, w) for g, w in zip(got, want))


def phase_residuals_and_bwd(device) -> tuple[float, float]:
    """The forward kernel with residuals against ``gdr_chunked_residuals``,
    and the backward kernel against ``gdr_bwd_ref`` on the plain forward's
    checkpoints and random cotangents; then the backward kernel against the
    stored backward.  Returns the worst absolute errors (fwd, bwd)."""
    import torch
    from gdkvm_tpu_torch.core import gdr
    from gdkvm_tpu_torch.ops import gdr_cuda

    gen = torch.Generator(device=device).manual_seed(2)
    fwd_names = ("o", "s_T", "states", "U", "W")
    bwd_names = ("dq", "dk", "dv", "dbeta", "deta", "dalpha", "ds0")
    worst_f = worst_b = 0.0
    for name, shape, dt in GRAD_CASES:
        dtype = getattr(torch, dt)
        q, k, v, beta, alpha, s0 = _gdr_inputs(gen, *shape, dtype, device)
        eta = torch.sigmoid(torch.randn(beta.shape, device=device, generator=gen))
        got = gdr_cuda.gdr_fwd_cuda_residuals(q, k, v, beta, alpha, s0, eta)
        want = gdr.gdr_chunked_residuals(q, k, v, beta, alpha, s0, eta)
        torch.cuda.synchronize()
        worst_f = max(worst_f, _check_rel(
            f"fwd+residuals vs plain [{name}] {shape} {dt}", fwd_names, got,
            want, FWD_REL))

        states = want[2]
        do = torch.randn(want[0].shape, device=device, generator=gen)
        ds_t = torch.randn(s0.shape, device=device, generator=gen)
        bwd_args = (q, k, v, beta, eta, alpha, states, do, ds_t)
        got_b = gdr_cuda.gdr_bwd_cuda(*bwd_args)
        want_b = gdr.gdr_bwd_ref(*bwd_args)
        torch.cuda.synchronize()
        worst_b = max(worst_b, _check_rel(
            f"bwd kernel vs plain [{name}] {shape} {dt}", bwd_names, got_b,
            want_b, BWD_REL))
        if shape == TRAIN_SHAPE:
            stored = gdr.gdr_bwd_stored(q, k, v, beta, eta, alpha, states,
                                        want[3], want[4], do, ds_t)
            _check_rel(f"bwd kernel vs stored backward [{name}]", bwd_names,
                       got_b, stored, BWD_REL)
    return worst_f, worst_b


def phase_fused_vs_stored(device) -> None:
    """Gradients of every input through the autograd Function (the kernel
    route) under GDKVM_GDR_BWD=fused against =stored, at the training
    shape, coupled gates."""
    import torch
    from gdkvm_tpu_torch.ops import gdr_cuda
    gen = torch.Generator(device=device).manual_seed(3)
    args = _gdr_inputs(gen, *TRAIN_SHAPE, torch.bfloat16, device)
    w_o = torch.randn(TRAIN_SHAPE[:4] + (TRAIN_SHAPE[5],), device=device,
                      generator=gen)
    grads = {}
    for mode in ("fused", "stored"):
        os.environ["GDKVM_GDR_BWD"] = mode
        ins = [x.clone().requires_grad_(True) for x in args]
        o, s = gdr_cuda.gdr_kernel(*ins)
        grads[mode] = torch.autograd.grad((o * w_o).sum() + (s * s).sum(), ins)
    os.environ.pop("GDKVM_GDR_BWD")
    torch.cuda.synchronize()
    for g, x in zip(grads["fused"], args):
        assert g.dtype == x.dtype, (g.dtype, x.dtype)
    # dq, dk, dv come back in bf16, like q, k, v: the two modes may round
    # an element to neighbouring bf16 values, one ulp, which is at most 2^-7
    # of the largest element.
    _check_rel("autograd fused vs stored [train bf16], bf16 gradients",
               ("dq", "dk", "dv"), [g.float() for g in grads["fused"][:3]],
               [g.float() for g in grads["stored"][:3]], 2.0 ** -7)
    _check_rel("autograd fused vs stored [train bf16], fp32 gradients",
               ("dbeta", "dalpha", "ds0"), grads["fused"][3:],
               grads["stored"][3:], BWD_REL)


def phase_gdr_times(device) -> tuple[float, float]:
    """Median ms of the forward kernel and of the plain GDR at the streaming
    bench shape, timed in turns (plain, kernel, kernel, plain)."""
    import torch
    from gdkvm_tpu_torch.core import gdr
    from gdkvm_tpu_torch.ops import gdr_cuda
    gen = torch.Generator(device=device).manual_seed(1)
    args = _gdr_inputs(gen, 8, 4, 32, 49, 64, 64, torch.bfloat16, device)
    kern_ms, plain_ms, spread = _in_turns(lambda: gdr.gdr_chunked(*args),
                                          lambda: gdr_cuda.gdr_fwd_cuda(*args))
    print(f"GDR fwd at B=8 H=4 T=32 N=49 d=64 bf16 q/k/v: kernel "
          f"{kern_ms:.4f} ms, plain {plain_ms:.4f} ms ({spread})")
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

    # The streaming main path: every count is 0 just before, read just after.
    _reset_counts()
    fps_kernel = measure_streaming_fps(model, device, **stream)
    counts = _read_counts()
    print(f"streaming main path: {n_chunks} chunks of 8 x 32 frames at 112^2, "
          f"counts {counts}")
    if counts != dict(_ZERO, fwd_kernel=n_chunks):
        raise AssertionError(f"streaming counts {counts}: expected "
                             f"{n_chunks} forward launches and nothing else")

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
    s_rel = _rel(state_k.mem, state_p.mem)
    print(f"kernel path vs plain path, one 8 x 32 chunk: mask agreement "
          f"{agree:.6f}, max|Δs_T|/max|s_T| {s_rel:.3e}, "
          f"max|Δlogit| {_abs(logits_k, logits_p):.3e}")
    if agree < 0.999:
        raise AssertionError(f"mask agreement {agree} < 0.999")
    if s_rel > 1e-4:
        raise AssertionError(f"state relative error {s_rel} > 1e-4")

    # Frames/s in turns: kernel (above), plain, kernel, plain.
    fps_plain = measure_streaming_fps(plain, device, **stream)
    fps_kernel2 = measure_streaming_fps(model, device, **stream)
    fps_plain2 = measure_streaming_fps(plain, device, **stream)
    runs = [fps_kernel, fps_plain, fps_kernel2, fps_plain2]
    print("streaming frames/s (kernel, plain, kernel, plain): "
          + " ".join(f"{r['frames_per_sec']:.1f}" for r in runs))
    print(f"peak device memory {torch.cuda.max_memory_allocated(device) / 2**20:.1f} MiB")
    return {"launches": counts["fwd_kernel"]}


_ZERO = {"fwd_kernel": 0, "bwd_kernel": 0, "plain_fwd": 0, "plain_bwd": 0,
         "stored_bwd": 0}


def _reset_counts() -> None:
    from gdkvm_tpu_torch.core import gdr
    from gdkvm_tpu_torch.ops import gdr_cuda
    for c in (gdr_cuda.LAUNCHES, gdr_cuda.BWD_LAUNCHES, gdr.CHUNKED_CALLS,
              gdr.BWD_REF_CALLS, gdr.BWD_STORED_CALLS):
        c.reset()


def _read_counts() -> dict:
    """Launches of each kernel, and calls of each plain version: the plain
    forward (gdr_chunked, with or without residuals), the backward kernel's
    plain version (gdr_bwd_ref), and the stored backward (plain torch ops by
    design, as the JAX package runs it in XLA)."""
    from gdkvm_tpu_torch.core import gdr
    from gdkvm_tpu_torch.ops import gdr_cuda
    return {"fwd_kernel": gdr_cuda.LAUNCHES.n, "bwd_kernel": gdr_cuda.BWD_LAUNCHES.n,
            "plain_fwd": gdr.CHUNKED_CALLS.n, "plain_bwd": gdr.BWD_REF_CALLS.n,
            "stored_bwd": gdr.BWD_STORED_CALLS.n}


def _train_cfg():
    """The ts8_256 recipe on synthetic clips (the card host has no CAMUS)."""
    from gdkvm_tpu_torch.config.schema import ts8_256
    cfg = ts8_256()
    cfg.data.dataset = "synthetic"
    return cfg


TRAIN_STEPS = 3


def phase_train(device) -> dict:
    """The training main path, once per backward mode: ``train(cfg,
    max_steps)`` with the counts 0 just before and read just after."""
    import math
    from gdkvm_tpu_torch.train.loop import train
    cfg = _train_cfg()
    print(f"train: ts8_256 recipe, {cfg.train.batch_size} x "
          f"{cfg.data.clip_len} frames at {cfg.data.image_size}^2, "
          f"{cfg.model.num_classes} classes, bootstrap_ratio "
          f"{cfg.train.bootstrap_ratio}, synthetic clips, {TRAIN_STEPS} steps")
    launches = {}
    for mode in ("stored", "fused"):
        os.environ["GDKVM_GDR_BWD"] = mode
        _reset_counts()
        t0 = time.perf_counter()
        metrics = train(cfg, max_steps=TRAIN_STEPS, device=device)
        dt = time.perf_counter() - t0
        counts = _read_counts()
        print(f"training main path [{mode}]: counts {counts}; last metrics "
              + " ".join(f"{k} {v:.6f}" for k, v in metrics.items())
              + f"; {dt:.1f} s with model init and host data")
        want = dict(_ZERO, fwd_kernel=TRAIN_STEPS,
                    bwd_kernel=TRAIN_STEPS if mode == "fused" else 0,
                    stored_bwd=TRAIN_STEPS if mode == "stored" else 0)
        if counts != want:
            raise AssertionError(f"training counts [{mode}] {counts}, expected {want}")
        if not all(math.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"non-finite training metrics {metrics}")
        launches[mode] = counts
    os.environ.pop("GDKVM_GDR_BWD")
    return {"fwd": sum(c["fwd_kernel"] for c in launches.values()),
            "bwd": sum(c["bwd_kernel"] for c in launches.values())}


def _batch(cfg, seed: int = 0):
    from gdkvm_tpu_torch.data.pipeline import batch_iterator, make_dataset
    ds = make_dataset(cfg.data, cfg.data.train_split, cfg.model.num_classes)
    return next(batch_iterator(ds, cfg.train.batch_size, augment=True,
                               seed=seed))


def _state(cfg, model_cfg, device, weights=None):
    import torch
    from gdkvm_tpu_torch.models.gdkvm import GDKVM, init_params
    from gdkvm_tpu_torch.train.loop import state_for
    model = GDKVM(model_cfg, device=device)
    if weights is None:
        init_params(model, torch.Generator().manual_seed(cfg.train.seed))
    else:
        model.load_state_dict(weights)
    return state_for(cfg, model)


# One train step, kernel path against the plain chunked path from the same
# weights, batch and prompt bits, as relative differences of the loss and
# the gradient norm: in fp32 compute the two differ only in the GDR's
# summation order; in bf16 those differences also flip roundings of bf16
# activations and gradients downstream (measured ≤ 6.3e-5 on the card at
# full width, 3.8e-4 on a narrow model on the CPU).
STEP_REL = {"float32": 1e-5, "bfloat16": 2e-3}


def phase_train_grads(device) -> None:
    """One step's gradients on the kernel path: finite for every parameter,
    nonzero for the LKVA projections; stored against fused; and against
    the plain chunked path, in fp32 and in bf16 compute."""
    import dataclasses
    import torch
    from gdkvm_tpu_torch.models.gdkvm import train_model_config
    from gdkvm_tpu_torch.train.loop import global_norm, loss_and_grads
    cfg = _train_cfg()
    batch = _batch(cfg)
    lkva = ("q_proj", "k_proj", "v_proj", "beta_proj", "alpha_proj")
    for dtype in ("bfloat16", "float32"):
        mcfg = dataclasses.replace(train_model_config(cfg.model, 256),
                                   compute_dtype=dtype)
        runs = {}
        for mode in ("stored", "fused", "chunked"):
            os.environ["GDKVM_GDR_BWD"] = "stored" if mode == "chunked" else mode
            model_cfg = (dataclasses.replace(mcfg, gdr_impl="chunked")
                         if mode == "chunked" else mcfg)
            state = _state(cfg, model_cfg, device, runs.get("weights"))
            runs.setdefault("weights", state.model.state_dict())
            _reset_counts()
            metrics, grads = loss_and_grads(state, batch, cfg)
            counts = _read_counts()
            want = dict(_ZERO, **{"chunked": {"plain_fwd": 1},
                                  "stored": {"fwd_kernel": 1, "stored_bwd": 1},
                                  "fused": {"fwd_kernel": 1, "bwd_kernel": 1}}[mode])
            if counts != want:
                raise AssertionError(f"[{dtype} {mode}] counts {counts}, expected {want}")
            names = [n for n, _ in state.model.named_parameters()]
            bad = [n for n, g in zip(names, grads) if not bool(torch.isfinite(g).all())]
            if bad:
                raise AssertionError(f"[{dtype} {mode}] non-finite gradients: {bad}")
            g = dict(zip(names, grads))
            zero = [p for p in lkva if not g[f"lkva.{p}.weight"].abs().max().item() > 0]
            if zero:
                raise AssertionError(f"[{dtype} {mode}] zero LKVA gradients: {zero}")
            runs[mode] = (metrics["loss"].item(), global_norm(grads).item(), grads)
            print(f"one step [{dtype} compute, {mode}]: loss {runs[mode][0]:.6f} "
                  f"grad_norm {runs[mode][1]:.6f}; counts {counts}; "
                  f"{len(names)} gradients finite; "
                  "LKVA projection gradients max|g| "
                  + " ".join(f"{p} {g[f'lkva.{p}.weight'].abs().max().item():.3e}"
                             for p in lkva))
        os.environ.pop("GDKVM_GDR_BWD")
        bar = STEP_REL[dtype]
        for mode in ("stored", "fused"):
            d_loss = abs(runs[mode][0] - runs["chunked"][0]) / abs(runs["chunked"][0])
            d_norm = abs(runs[mode][1] - runs["chunked"][1]) / abs(runs["chunked"][1])
            print(f"[{dtype}] {mode} vs chunked: |Δloss|/loss {d_loss:.3e}, "
                  f"|Δgrad_norm|/grad_norm {d_norm:.3e} (bar {bar:g})")
            if not (d_loss <= bar and d_norm <= bar):
                raise AssertionError(f"[{dtype}] {mode} path disagrees with chunked")
        worst = max(_rel(a, b) for a, b in zip(runs["fused"][2], runs["stored"][2]))
        print(f"[{dtype}] fused vs stored: worst per-parameter max|Δg|/max|g| {worst:.3e}")


def phase_train_times(device) -> dict:
    """Steps/s and frames/s of training on one fixed batch, stored, fused
    and chunked, timed in turns; peak device memory of each."""
    import dataclasses
    import torch
    from gdkvm_tpu_torch.models.gdkvm import train_model_config
    from gdkvm_tpu_torch.train.loop import train_step
    cfg = _train_cfg()
    batch = _batch(cfg)
    mcfg = train_model_config(cfg.model, cfg.data.image_size)
    states = {"kernel": _state(cfg, mcfg, device)}
    states["chunked"] = _state(cfg, dataclasses.replace(mcfg, gdr_impl="chunked"),
                               device, states["kernel"].model.state_dict())
    frames = cfg.train.batch_size * cfg.data.clip_len
    order = ("stored", "fused", "chunked", "chunked", "fused", "stored")
    rates = {m: [] for m in order}
    peak = {}
    for mode in order:
        os.environ["GDKVM_GDR_BWD"] = "stored" if mode == "chunked" else mode
        state = states["chunked" if mode == "chunked" else "kernel"]
        for _ in range(2):
            train_step(state, batch, cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        n = 8
        t0 = time.perf_counter()
        for _ in range(n):
            metrics = train_step(state, batch, cfg)
        metrics["loss"].item()
        torch.cuda.synchronize()
        rates[mode].append(n / (time.perf_counter() - t0))
        peak[mode] = torch.cuda.max_memory_allocated(device) / 2**20
    os.environ.pop("GDKVM_GDR_BWD")
    print(f"train steps/s in turns ({', '.join(order)}), 8 steps each after 2: "
          + " ".join(f"{rates[m][i]:.3f}" for m, i in
                     zip(order, (0, 0, 0, 1, 1, 1))))
    for mode in ("stored", "fused", "chunked"):
        sps = statistics.mean(rates[mode])
        print(f"train [{mode}]: {sps:.3f} steps/s, {sps * frames:.1f} frames/s "
              f"(mean of 2), peak device memory {peak[mode]:.1f} MiB")
    return rates


def phase_train_kernel_times(device) -> dict:
    """The training path's kernels against their plain versions at the
    training shape, timed in turns; the stored backward beside them."""
    import torch
    from gdkvm_tpu_torch.core import gdr
    from gdkvm_tpu_torch.ops import gdr_cuda
    gen = torch.Generator(device=device).manual_seed(4)
    q, k, v, beta, alpha, s0 = _gdr_inputs(gen, *TRAIN_SHAPE, torch.bfloat16,
                                           device)
    f_ms, f_plain, f_spread = _in_turns(
        lambda: gdr.gdr_chunked_residuals(q, k, v, beta, alpha, s0),
        lambda: gdr_cuda.gdr_fwd_cuda_residuals(q, k, v, beta, alpha, s0),
        iters=10)
    _, _, states, u, w = gdr.gdr_chunked_residuals(q, k, v, beta, alpha, s0)
    do = torch.randn(TRAIN_SHAPE[:4] + (TRAIN_SHAPE[5],), device=device,
                     generator=gen)
    ds_t = torch.randn(s0.shape, device=device, generator=gen)
    args = (q, k, v, beta, beta, alpha, states, do, ds_t)
    b_ms, b_plain, b_spread = _in_turns(lambda: gdr.gdr_bwd_ref(*args),
                                        lambda: gdr_cuda.gdr_bwd_cuda(*args),
                                        iters=10)
    stored_ms = statistics.median(_times_ms(
        lambda: gdr.gdr_bwd_stored(q, k, v, beta, beta, alpha, states, u, w,
                                   do, ds_t), iters=10))
    shape = "B=8 H=4 T=10 N=256 d=64 bf16 q/k/v"
    print(f"GDR fwd+residuals at {shape}: kernel {f_ms:.4f} ms, plain "
          f"(gdr_chunked_residuals) {f_plain:.4f} ms ({f_spread})")
    print(f"GDR bwd at {shape}: kernel {b_ms:.4f} ms, plain (gdr_bwd_ref) "
          f"{b_plain:.4f} ms ({b_spread}); stored backward (plain torch ops) "
          f"{stored_ms:.4f} ms")
    return {"fwd": (f_ms, f_plain), "bwd": (b_ms, b_plain)}


def main() -> int:
    info = phase_device()
    import torch
    # fp32 products in full fp32 everywhere: the plain GDR drifts under TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda:0")
    os.environ.pop("GDKVM_GDR_BWD", None)
    phase_build()
    err_fwd = phase_kernel_vs_plain(device)
    err_res, err_bwd = phase_residuals_and_bwd(device)
    phase_fused_vs_stored(device)
    stream = phase_model(device)
    train_launches = phase_train(device)
    phase_train_grads(device)
    phase_train_times(device)
    fwd_ms, fwd_plain_ms = phase_gdr_times(device)
    times = phase_train_kernel_times(device)
    src = "gdkvm_tpu_torch/csrc/"
    print(json.dumps({"kernels": [
        {"name": "gdr_fwd", "route": "cuda", "source": src + "gdr_fwd.cu",
         "replaces": "gdkvm_tpu/ops/gdr_pallas.py:513",
         "launches": stream["launches"], "max_abs_err": err_fwd,
         "ms": fwd_ms, "plain_ms": fwd_plain_ms},
        {"name": "gdr_fwd_residuals", "route": "cuda", "source": src + "gdr_fwd.cu",
         "replaces": "gdkvm_tpu/ops/gdr_pallas.py:513",
         "launches": train_launches["fwd"], "max_abs_err": err_res,
         "ms": times["fwd"][0], "plain_ms": times["fwd"][1]},
        {"name": "gdr_bwd", "route": "cuda", "source": src + "gdr_bwd.cu",
         "replaces": "gdkvm_tpu/ops/gdr_pallas.py:724",
         "launches": train_launches["bwd"], "max_abs_err": err_bwd,
         "ms": times["bwd"][0], "plain_ms": times["bwd"][1]},
    ]}))
    print(f"card: {info['smi']}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
