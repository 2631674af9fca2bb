"""Smoke run of the PyTorch port (``gdkvm_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (nonzero exit) when it fails:

1. device and versions (torch, CUDA, nvcc, the card's name and power limit);
2. build the GDR kernels (``gdkvm_tpu_torch/csrc/gdr_fwd.cu``, which
   holds the forward's solve (``gdr_wy.cuh``) and the chain of
   ``gdr_chain.cuh``, and ``gdr_bwd.cu``: the same solve, the reverse dS
   chain and the per-frame adjoint) with nvcc from the checkout's
   sources, in parallel, print nvcc's ptxas report of each (registers,
   spills, shared memory) and hold the wrappers' launch plans to the
   sources';
3. each kernel against its plain PyTorch version on identical inputs: the
   forward without residuals at the streaming shapes, the forward with its
   residuals (S_{t-1}, U, W) and the backward at the training shape (B=8
   H=4 T=10 N=256 d=64, bf16 q/k/v) and at small shapes; each of the
   backward's phases against its plain version (``wy_transform``,
   ``gdr_bwd_chain``, ``gdr_bwd_frames``) fed the kernel's own output of
   the phase before; fused against stored gradients through the
   autograd Function; the bf16 residuals (``GDKVM_GDR_SAVE_DTYPE=bf16``)
   against the plain rounding; the chain kernel
   against ``gdr_chain`` at the serving shapes (B=8 H=4 T=16 and 32 N=49),
   the training shape, N=7, d_k≠d_v, T=1, d=48 (H=2) and H=6 (N=256),
   chained calls, and the chain
   split (batched solve + kernel) against the monolith kernel; the
   forward's WY solve kernel, through the U, W the forward returns,
   against the batched solve;
4. streaming (the first main path): the ts8 model at full width streams
   8 × 32-frame chunks at 112² with the state carried, through the forward
   kernel; launches are counted and the result held against the plain GDR;
   then ``bench_torch.py``, the port's headline entry, as a subprocess at
   its defaults (one JSON line, a plausible apparent TFLOP/s) and its
   single-stream, flagship and W8A8 arms in this process with every launch
   counted; one chunk's FLOP count on the kernel route equal to the chunked
   route's;
5. serving (the third main path): the ts8_112 model at full width in a
   ``BatchingEngine`` (8 slots, 16-frame chunks) behind ``make_server``; 8
   ``ServeClient`` sessions stream at once (one ragged, one resized on the
   device), under ``GDKVM_GDR_FWD=monolith`` and ``=chain``; launches are
   counted (one residual-free launch a tick) and every session's masks are
   held against ``stream_video``, and chain against monolith;
6. the exported artifact (the sixth main path): the bf16 ts8_112 model of
   phase 5 through ``io.export.save_artifact`` at batch 8, chunk 16, and
   ``load_artifact``: an eager call after the export returns real tensors,
   the loaded graph holds the ``gdkvm_tpu_torch::gdr_fwd`` custom op, two
   carried chunks match the eager model (logits and state within 1e-5 of
   their largest) under either forward split, one residual-free launch a
   step; ``BatchingEngine(artifact=...)`` serves phase 5's 8 sessions
   under both splits (one launch a tick, masks against the model engine's
   on ≥ 99.9% of pixels), and its frames/s and latency are timed against
   the model engine's, in turns;
7. training (the second main path): ``train(cfg, max_steps)`` on the
   ``ts8_256`` recipe (256², batch 8 × 10 frames, 4 classes, bootstrapped
   CE) on synthetic clips, in the stored and the fused backward mode, with
   every kernel's and plain version's calls counted (the run ends with the
   eval stage over 8 val clips: residual-free launches), then the stored
   mode with the chain forward; one step's gradients (finite everywhere, nonzero in
   the LKVA projections) and the kernel path against the plain chunked
   path from the same weights, and chain against monolith;
8. the training run (the fourth main path): ``train(cfg)`` on the
   ``ts8_256`` recipe with data from disk, written here from a seed: a
   packed train/val split (32 + 8 clips of 10 frames at 256²) from the
   device cache, and the CAMUS PNG layout through the thread pool and the
   pinned prefetch (the packed file, where PIL does not import); 12 steps
   with the eval stage and a checkpoint every 6, EMA on; the JSONL, checkpoints and overlays are
   checked, every launch is counted (one forward with residuals a step,
   none during eval, no plain GDR call), steps/s with the data path
   inside is printed; a run resumed from checkpoint 6 is held against the
   unbroken run (parameters, EMA, AdamW moments, batch checksums);
9. the ``gdn2`` model (η ≠ β from the model): a streamed chunk and two
   training steps under the stored and the fused backward against the same
   weights through the plain chunked GDR;
10. streaming eval: ``stream_evaluate`` on 8 synthetic videos of 64 frames
   at 112², one stream against 8 in flight;
11. the command line (the fifth main path): ``python -m gdkvm_tpu_torch
   <command> --config configs/<file>.yaml key=value`` at the full width of
   the ts8 model, through ``cli.main`` in this process with every launch
   counted (``info``, ``serve`` and ``serve-check`` as subprocesses): ``pack`` of the
   PNG layout and ``validate-data``; ``train`` 12 steps of
   ``configs/gdkvm_ts8_256.yaml`` on the packed split (``config.yaml`` read
   back by ``load_config``); ``eval``, ``stream-eval --streams 8``,
   ``parity`` (CAMUS official scoring, biplane EF, the memory ablation) and
   ``infer`` (a PNG directory at another size, resized on the device and
   on the host) from the run's checkpoint, residual-free launches only;
   ``export`` of the checkpoint at batch 1, ``serve-check`` of it as a
   subprocess (a cold load; ``ok`` must be true) and ``infer --artifact``
   on the same file at the artifact's size, its masks against ``infer``'s;
   ``serve`` of ``configs/gdkvm_ts8_112.yaml`` on port 0 with
   ``serve-bench`` against it, ended by SIGINT; ``bench`` in every mode
   (and once each through the backward kernel and the chain split);
   ``sweep``; ``scale``; and ``stream-eval`` of the two other documented
   models, ``gdkvm_rt_112`` (H=2, d=48) and ``gdkvm_base_256`` (H=6,
   N=256), against the same call under ``gdr_impl=chunked``;
12. the mount-day chain (the eighth main path; docs/REPRODUCE.md, "Mount
   day"): raw CAMUS ``.mhd``/``.raw`` half-sequences at 320 x 288 with
   anisotropic spacing, written from a seed, through ``convert-camus
   --split-mode official``, ``validate-data``, ``train`` of
   ``configs/config_gdkvm_01.yaml`` at its model widths, ``parity`` (HD95
   in mm over 2 folds, biplane EF in mL, the ablation), ``export --chunk 16
   --batch 8`` and ``serve --artifact`` (a subprocess) with ``serve-bench
   --sessions 8``; the card's fp32 parity of the checkpoint against the
   CPU's; EchoNet MJPG AVIs at 30 and 50 fps through ``validate-data``,
   ``train`` of ``configs/echonet_stream.yaml`` (occlusion on) and the
   FPS-aware ``echonet-ef``; every command with ``--device cuda``, every
   launch counted;
13. W8A8 quantized serving (the seventh main path): the ts8 model at full
   width on seeded weights at 112² (2 classes) and 256² (4 classes),
   calibrated with absmax and percentile; every eligible conv's W8A8 call on
   the card bit-equal to the same call on the CPU; W8A8 masks against bf16;
   the bf16 and the W8A8 forward timed in turns at ``quant_ab``'s shapes,
   with peak memory and a device-time breakdown; then the commands on the
   run of phase 11: ``quant --check``, ``stream-eval``, ``parity --ablate``,
   ``export`` + ``infer --artifact`` (the artifact's steps equal to the eager
   W8A8 model's) and ``serve`` (a subprocess), each with ``--quant-scales``;
   ``gdr_assoc`` against ``gdr_chunked`` (values and gradients, fp32) at the
   serving, streaming and training shapes;
14. ``bench --mode all --device cuda`` (the regression artifact of
   ``eval/regression.py``): no errored section, the artifact valid, each
   section's headline number and the artifact printed;
15. times on the card: frames/s of streaming and steps/s of training on both
   paths; serving frames/s, request latency p50/p95/p99 (16- and 256-frame
   requests), queue wait and service time and peak memory per forward
   split, in turns; each kernel against its plain version at its main
   path's shape and the chain split against the monolith kernel at the
   serving and the training shape, timed in turns on the device alone
   (CUDA events); the WY solve kernel inside the forward against the
   batched solve, and the backward's three phases, by torch.profiler's
   device time; a training step's device time; each beside its bound
   (the function's products in 3xTF32 passes at 495 TFLOP/s, or bytes at
   3.35 TB/s, whichever is longer) and its share of it.

The line before the last is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``.  Without a CUDA device the script
exits nonzero and prints no result.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import io
import json
import os
import signal
import statistics
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor


def _sh(cmd: list[str]) -> str:
    res = subprocess.run(cmd, capture_output=True, text=True, check=True)
    return res.stdout.strip()


# Cycles the stream spins (torch.cuda._sleep, ~5 ms) before each timed call,
# so that the host enqueues the start event, the call's launches and the
# end event while the card is still busy: the events then time the device,
# not the wrapper's host path (tens of µs, as long as the new kernels).
CUSHION_CYCLES = 10_000_000


def _times_ms(fn, iters: int = 20, warmup: int = 3) -> list[float]:
    """Device times of ``iters`` calls of ``fn()`` (CUDA events), in ms."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(CUSHION_CYCLES)
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


# Published dense peaks of one H100 SXM at its 700 W limit (NVIDIA's data
# sheet): TF32 on the tensor cores, and HBM3.
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES_PER_S = 3.35e12

# Operations of a kernel are the function's products, counted in TF32
# passes at the card's fp32-accurate rate whatever unit a design runs them
# on (gdkvm_tpu_torch/ops/gdr_counts.py, which the package's module
# breakdown shares): a product of fp32 operands is three passes, one fewer
# for each operand exact in TF32 (a bf16 q or k).  The 3xTF32 rate is above
# fp32 FMAs' 67 TFLOP/s, so this is the least time for the function on this
# card.


def _nbytes(*xs) -> int:
    """Bytes of the distinct tensors among ``xs``: each input read once and
    each output written once."""
    return sum({x.data_ptr(): x.numel() * x.element_size()
                for x in xs if x is not None}.values())


def _bound(label: str, ms: float, flops: int, nbytes: int) -> dict:
    """The least time the card could take for the work (ms): the larger of
    the operations (TF32 passes at 495 TFLOP/s) and the bytes over the
    memory rate.  Prints it beside the measured time, with what bounds it
    and the share."""
    t_ops = 1e3 * flops / PEAK_TF32_FLOPS
    t_bytes = 1e3 * nbytes / PEAK_BYTES_PER_S
    bound, by = max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")
    print(f"bound [{label}]: {ms:.4f} ms against {bound:.4f} ms ({flops / 1e9:.3f} "
          f"GFLOP of TF32 passes -> {t_ops:.4f} ms; {nbytes / 1e6:.2f} MB -> "
          f"{t_bytes:.4f} ms; bound by {by}), share {bound / ms:.3f}")
    return {"ms": ms, "bound_ms": bound, "bound_by": by}


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
RT_SHAPE = (8, 2, 16, 49, 48, 48)
BASE_SHAPE = (2, 6, 10, 256, 64, 64)
GRAD_CASES = [
    ("train bf16", TRAIN_SHAPE, "bfloat16"),
    ("train fp32", (2, 4, 10, 256, 64, 64), "float32"),
    ("N=7", (8, 4, 10, 7, 64, 64), "bfloat16"),
    ("N=49", (8, 4, 10, 49, 64, 64), "bfloat16"),
    ("N=138", (2, 2, 3, 138, 64, 64), "float32"),
    ("N=301 (largest)", (1, 2, 2, 301, 64, 64), "float32"),
    ("T=1", (8, 4, 1, 256, 64, 64), "bfloat16"),
    ("dk=32 dv=64", (2, 3, 5, 256, 32, 64), "float32"),
    # The other documented models' shapes: configs/gdkvm_rt_112.yaml (H=2,
    # d_k=d_v=48: 3 column blocks a chain) and gdkvm_base_256.yaml (H=6).
    ("rt d=48", RT_SHAPE, "bfloat16"),
    ("base H=6", BASE_SHAPE, "bfloat16"),
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
    import importlib.util
    have = {m: importlib.util.find_spec(m) is not None for m in ("PIL", "cv2", "matplotlib")}
    print("optional host libraries: " + ", ".join(
        f"{m} {'present' if ok else 'absent'}" for m, ok in have.items()))
    return {"smi": smi.splitlines()[0], "pil": have["PIL"]}


# The libraries: gdr_fwd.cu holds the forward (solve + chain) and the chain
# alone (csrc/gdr_chain.cuh); gdr_bwd.cu the backward.
KERNELS = ("gdr_fwd", "gdr_bwd")


def phase_build() -> None:
    """Build the kernels' libraries at once (one nvcc each) and print nvcc's
    ptxas report of each (registers, spills, shared memory); then check
    that the wrappers' launch plans (shared memory, scratch, the chain's
    columns per block and largest d_k) agree with the sources'."""
    from gdkvm_tpu_torch.ops import _build, gdr_cuda
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(KERNELS)) as pool:
        paths = list(pool.map(_build.build, KERNELS))
    print(f"build: {', '.join(p.name for p in paths)} in "
          f"{time.perf_counter() - t0:.1f} s")
    for path in paths:
        print(path.with_suffix(".log").read_text().strip())
    fwd, bwd = gdr_cuda._lib(), gdr_cuda._bwd_lib()
    for what, c_val, py_val in (
            ("chain max d_k", fwd.gdr_chain_max_dk(), gdr_cuda.CHAIN_MAX_DK),
            ("chain columns", fwd.gdr_chain_cols(), gdr_cuda.CHAIN_COLS)):
        if c_val != py_val:
            raise AssertionError(f"{what}: source {c_val}, wrapper {py_val}")
    for dk in (8, 32, 40, 48, 64, 128):
        for bf16 in (0, 1):
            for what, c_val, py_val in (
                    ("chain", fwd.gdr_chain_smem_bytes(dk, bf16),
                     gdr_cuda.chain_smem_bytes(dk, bool(bf16))),
                    ("bwd chain", bwd.gdr_bwd_chain_smem_bytes(dk, bf16),
                     gdr_cuda.bwd_chain_smem_bytes(dk, bool(bf16)))):
                if c_val != py_val:
                    raise AssertionError(f"{what} smem at d_k={dk} bf16={bf16}: "
                                         f"source {c_val}, wrapper {py_val}")
    for n, dk, dv in ((49, 64, 64), (49, 48, 48), (7, 8, 8), (64, 64, 64), (137, 64, 64),
                      (157, 64, 64), (158, 64, 64), (256, 64, 64),
                      (256, 32, 64), (301, 64, 64), (71, 128, 128)):
        pairs = [
            ("solve smem", fwd.gdr_wy_smem_bytes(n, dk, dv),
             gdr_cuda.wy_smem_bytes(n, dk, dv)),
            ("solve panels", fwd.gdr_wy_uses_panels(n, dk, dv),
             int(gdr_cuda.wy_uses_panels(n, dk, dv))),
            ("bwd solve smem", bwd.gdr_bwd_solve_smem_bytes(n, dk, dv),
             gdr_cuda.wy_smem_bytes(n, dk, dv)),
        ] + [(f"bwd frames smem bf16={bf16}",
              bwd.gdr_bwd_frames_smem_bytes(n, dk, dv, bf16),
              gdr_cuda.bwd_frames_smem_bytes(n, dk, dv, bool(bf16))) for bf16 in (0, 1)]
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
        ("dk=40 dv=10", (2, 3, 5, 49, 40, 10), torch.float32),
        # The eval stage's batch at 256²: N=256, the panel solve, one clip.
        ("eval N=256", (1, 4, 10, 256, 64, 64), torch.bfloat16),
        ("eval N=256 fp32", (2, 4, 10, 256, 64, 64), torch.float32),
        ("N=256 eta", (1, 4, 10, 256, 64, 64), torch.bfloat16),
        ("bench eta", bench, torch.bfloat16),
        ("rt d=48", RT_SHAPE, torch.bfloat16),
        ("rt d=48 fp32", RT_SHAPE, torch.float32),
        ("base H=6", BASE_SHAPE, torch.bfloat16),
        ("base H=6 eta", BASE_SHAPE, torch.bfloat16),
        # The shapes the command line gives this kernel (phase_cli): the
        # memory ablation's single frames, stream-eval of 8 streams and
        # infer at 256², bench's latency and modules modes, and the rt_112
        # and base_256 models' streams in fp32 compute.
        ("cli ablate, one frame", (1, 4, 1, 256, 64, 64), torch.bfloat16),
        ("cli stream-eval, 8 streams at 256²", (8, 4, 16, 256, 64, 64), torch.bfloat16),
        ("cli infer", (1, 4, 16, 256, 64, 64), torch.bfloat16),
        ("cli bench latency, modules", (1, 4, 16, 49, 64, 64), torch.bfloat16),
        ("cli rt_112 stream", (1, 2, 16, 49, 48, 48), torch.float32),
        ("cli base_256 stream", (1, 6, 16, 256, 64, 64), torch.float32),
    ]
    worst = 0.0
    for name, shape, dtype in cases:
        args = _gdr_inputs(gen, *shape, dtype, device)
        if name.endswith("eta"):          # the decoupled erase gate (gdn2)
            args += (torch.sigmoid(torch.randn(args[3].shape, device=device,
                                               generator=gen)),)
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


def phase_bwd_phases_vs_plain(device) -> float:
    """Each of the backward's three phases against its plain version at
    every GRAD_CASES shape, from one launch that keeps its scratch
    (``gdr_cuda._bwd_launch``): the solve's U, W against ``wy_transform``;
    the reverse dS chain's g, dS̃ and dS₀ against ``gdr_bwd_chain`` fed the
    kernel's W; the per-frame adjoint's gradients against
    ``gdr_bwd_frames`` fed the kernel's U, W, g and dS̃.  fp32 math on both
    sides, summation order only.  Returns the worst absolute error."""
    import torch
    from gdkvm_tpu_torch.core import gdr
    from gdkvm_tpu_torch.ops import gdr_cuda
    gen = torch.Generator(device=device).manual_seed(8)
    worst = 0.0
    for name, shape, dt in GRAD_CASES:
        q, k, v, beta, alpha, s0 = _gdr_inputs(gen, *shape, getattr(torch, dt), device)
        eta = torch.sigmoid(torch.randn(beta.shape, device=device, generator=gen))
        states = gdr.gdr_chunked_residuals(q, k, v, beta, alpha, s0, eta)[2]
        do = torch.randn(q.shape[:4] + (shape[5],), device=device, generator=gen)
        ds_t = torch.randn(s0.shape, device=device, generator=gen)
        grads, (u, w, g, dsd) = gdr_cuda._bwd_launch(q, k, v, beta, eta, alpha,
                                                    states, do, ds_t)
        label = f"[{name}] {shape} {dt}"
        worst = max(worst, _check_rel(f"bwd solve vs plain {label}", ("U", "W"),
                                      (u, w), gdr.wy_transform(k, v, beta, eta),
                                      BWD_REL))
        g_ds0 = (g, dsd, grads[6])
        want = gdr.gdr_bwd_chain(k, w, q.float().transpose(-1, -2) @ do, alpha, ds_t)
        worst = max(worst, _check_rel(f"bwd reverse chain vs plain {label}",
                                      ("g", "ds_dec", "ds0"), g_ds0, want, BWD_REL))
        want = gdr.gdr_bwd_frames(k, v, beta, eta, alpha, states, u, w, do, g, dsd)
        worst = max(worst, _check_rel(
            f"bwd per-frame adjoint vs plain {label}",
            ("dq", "dk", "dv", "dbeta", "deta", "dalpha"), grads[:6], want, BWD_REL))
    return worst


# bf16 residuals (GDKVM_GDR_SAVE_DTYPE=bf16) against the plain forward's
# rounding of its fp32 residuals: the two fp32 values differ in summation
# order, so a value near a rounding boundary may round to the neighbouring
# bf16 value, one ulp, at most 2^-8 of the largest element.
SAVE_BF16_REL = 2.0 ** -8


def phase_bf16_residuals(device) -> None:
    """The forward kernel's bf16 residuals (S_{t-1}, U, W) against
    ``gdr_chunked_residuals(save_bf16=True)`` at the training shape, and
    the stored backward through the autograd Function under
    GDKVM_GDR_SAVE_DTYPE=bf16 against =f32."""
    import torch
    from gdkvm_tpu_torch.core import gdr
    from gdkvm_tpu_torch.ops import gdr_cuda
    gen = torch.Generator(device=device).manual_seed(9)
    args = _gdr_inputs(gen, *TRAIN_SHAPE, torch.bfloat16, device)
    got = gdr_cuda.gdr_fwd_cuda_residuals(*args, save_bf16=True)
    want = gdr.gdr_chunked_residuals(*args, save_bf16=True)
    torch.cuda.synchronize()
    if [x.dtype for x in got[2:]] != [torch.bfloat16] * 3:
        raise AssertionError(f"bf16 residual dtypes {[x.dtype for x in got[2:]]}")
    _check_rel("fwd bf16 residuals vs plain rounding [train bf16]", ("o", "s_T"),
               got[:2], want[:2], FWD_REL)
    _check_rel("fwd bf16 residuals vs plain rounding [train bf16]",
               ("states", "U", "W"), [x.float() for x in got[2:]],
               [x.float() for x in want[2:]], SAVE_BF16_REL)
    w_o = torch.randn(TRAIN_SHAPE[:4] + (TRAIN_SHAPE[5],), device=device, generator=gen)
    grads = {}
    os.environ["GDKVM_GDR_BWD"] = "stored"
    for save in ("bf16", "f32"):
        os.environ["GDKVM_GDR_SAVE_DTYPE"] = save
        ins = [x.clone().requires_grad_(True) for x in args]
        o, s = gdr_cuda.gdr_kernel(*ins)
        grads[save] = torch.autograd.grad((o * w_o).sum() + (s * s).sum(), ins)
    os.environ.pop("GDKVM_GDR_BWD")
    os.environ.pop("GDKVM_GDR_SAVE_DTYPE")
    torch.cuda.synchronize()
    rels = {n: _rel(a.float(), b.float()) for n, a, b in zip(
        ("dq", "dk", "dv", "dbeta", "dalpha", "ds0"), grads["bf16"], grads["f32"])}
    print("stored backward, bf16 against fp32 residuals [train bf16]: "
          + " ".join(f"{n} {r:.2e}" for n, r in rels.items()) + " (max|Δ|/max|f32|)")
    if not all(r < 3e-2 for r in rels.values()):
        raise AssertionError(f"bf16 residuals move the gradients by {rels}")


# The chain kernel against its plain version, and the chain split against
# the monolith kernel: fp32 math on both sides, summation order only.
CHAIN_REL = 1e-5
SERVE_SHAPE = (8, 4, 16, 49, 64, 64)      # B H T N d_k d_v: 8 slots × 16 frames at 112²
CHAIN_CASES = [
    ("serve T=16 bf16", SERVE_SHAPE, "bfloat16", False),
    ("serve T=16 bf16", SERVE_SHAPE, "bfloat16", True),
    ("serve T=32 bf16", (8, 4, 32, 49, 64, 64), "bfloat16", False),
    ("serve T=32 bf16", (8, 4, 32, 49, 64, 64), "bfloat16", True),
    ("serve T=16 fp32", SERVE_SHAPE, "float32", False),
    ("train bf16", TRAIN_SHAPE, "bfloat16", True),
    ("N=7", (8, 4, 10, 7, 64, 64), "bfloat16", True),
    ("dk=32 dv=64", (2, 3, 5, 49, 32, 64), "float32", True),
    ("dk=64 dv=40", (2, 3, 5, 49, 64, 40), "float32", True),
    ("T=1", (8, 4, 1, 49, 64, 64), "bfloat16", True),
    # Rows the tiles' cp.async path does not take (d_k not a multiple of 16,
    # d_v not of 4): plain loads with zero padding.
    ("dk=40 dv=10", (2, 3, 5, 49, 40, 10), "bfloat16", True),
    ("rt d=48", RT_SHAPE, "bfloat16", False),
    ("rt d=48", RT_SHAPE, "bfloat16", True),
    ("base H=6", BASE_SHAPE, "bfloat16", True),
]


def phase_chain_vs_plain(device) -> float:
    """The chain kernel against ``gdr_chain`` on identical inputs (U, W from
    one batched solve), with and without S_{t-1}; two chained 8-frame calls
    against one 16-frame call; then the whole chain split (batched solve +
    kernel) against the monolith kernel.  Returns the worst absolute error
    against the plain version."""
    import torch
    from gdkvm_tpu_torch.core import gdr
    from gdkvm_tpu_torch.ops import gdr_cuda
    gen = torch.Generator(device=device).manual_seed(5)
    worst = 0.0
    for name, shape, dt, save in CHAIN_CASES:
        q, k, v, beta, alpha, s0 = _gdr_inputs(gen, *shape, getattr(torch, dt), device)
        u, w = gdr_cuda._wy(k, v, beta, None)
        got = gdr_cuda.gdr_chain_cuda(q, k, u, w, alpha, s0, save_states=save)
        want = gdr.gdr_chain(q, k, u, w, alpha, s0, save_states=save)
        torch.cuda.synchronize()
        names = ("o", "s_T", "states")[:3 if save else 2]
        worst = max(worst, _check_rel(
            f"chain kernel vs plain [{name}{', states' if save else ''}] {shape} {dt}",
            names, got[:len(names)], want[:len(names)], CHAIN_REL))

    # Operands that start one element past a 16-byte boundary (contiguous
    # views into a larger buffer): the tiles' plain-load path.
    def misaligned(x):
        return torch.empty(x.numel() + 1, dtype=x.dtype, device=device)[1:].view_as(x).copy_(x)
    q, k, v, beta, alpha, s0 = _gdr_inputs(gen, 2, 3, 5, 49, 64, 64, torch.bfloat16, device)
    u, w = gdr_cuda._wy(k, v, beta, None)
    got = gdr_cuda.gdr_chain_cuda(*(misaligned(x) for x in (q, k, u, w)), alpha, s0,
                                  save_states=True)
    want = gdr.gdr_chain(q, k, u, w, alpha, s0, save_states=True)
    torch.cuda.synchronize()
    worst = max(worst, _check_rel("chain kernel vs plain [misaligned q, k, u, w]",
                                  ("o", "s_T", "states"), got, want, CHAIN_REL))

    # Two chained 8-frame calls with the state carried equal one 16-frame call.
    q, k, v, beta, alpha, s0 = _gdr_inputs(gen, *SERVE_SHAPE, torch.bfloat16, device)
    u, w = gdr_cuda._wy(k, v, beta, None)
    o_full, s_full, _ = gdr_cuda.gdr_chain_cuda(q, k, u, w, alpha, s0, save_states=False)
    half = lambda x, lo, hi: x[:, :, lo:hi].contiguous()
    o_a, s_a, _ = gdr_cuda.gdr_chain_cuda(
        *(half(x, 0, 8) for x in (q, k, u, w, alpha)), s0, save_states=False)
    o_b, s_b, _ = gdr_cuda.gdr_chain_cuda(
        *(half(x, 8, 16) for x in (q, k, u, w, alpha)), s_a, save_states=False)
    torch.cuda.synchronize()
    _check_rel("chain kernel chained 8+8 vs 16", ("o", "s_T"),
               (torch.cat([o_a, o_b], 2), s_b), (o_full, s_full), CHAIN_REL)

    # The chain split against the monolith kernel: residual-free at the
    # serving shape; with S_{t-1}, U, W (the stored backward's residuals) at
    # the training shape.
    os.environ["GDKVM_GDR_FWD"] = "chain"
    got = gdr_cuda._fwd_no_residuals(q, k, v, beta, alpha, s0, None)
    os.environ.pop("GDKVM_GDR_FWD")
    want = gdr_cuda.gdr_fwd_cuda(q, k, v, beta, alpha, s0)
    torch.cuda.synchronize()
    _check_rel(f"chain split vs monolith kernel [serve] {SERVE_SHAPE} bf16",
               ("o", "s_T"), got, want, CHAIN_REL)
    q, k, v, beta, alpha, s0 = _gdr_inputs(gen, *TRAIN_SHAPE, torch.bfloat16, device)
    u, w = gdr_cuda._wy(k, v, beta, None)
    o, s_t, states = gdr_cuda.gdr_chain_cuda(q, k, u, w, alpha, s0, save_states=True)
    want = gdr_cuda.gdr_fwd_cuda_residuals(q, k, v, beta, alpha, s0)
    torch.cuda.synchronize()
    _check_rel(f"chain split vs monolith kernel [train, residuals] {TRAIN_SHAPE} bf16",
               ("o", "s_T", "states", "U", "W"), (o, s_t, states, u, w), want,
               CHAIN_REL)
    return worst


# The forward's hand-written WY solve against the chain split's batched
# solve (_wy, cuBLAS): fp32 both, summation order only.  Each layout and its
# edge: 16-row blocks to N=157 at d=64, 32-row panels from N=158.
SOLVE_CASES = [
    ("serve", SERVE_SHAPE, "bfloat16"),
    ("stream", (8, 4, 32, 49, 64, 64), "bfloat16"),
    ("train", TRAIN_SHAPE, "bfloat16"),
    ("N=7", (2, 2, 3, 7, 64, 64), "float32"),
    ("N=157 (blocks)", (1, 2, 2, 157, 64, 64), "float32"),
    ("N=158 (panels)", (1, 2, 2, 158, 64, 64), "float32"),
    ("N=301", (1, 2, 2, 301, 64, 64), "float32"),
    ("dk=64 dv=40", (2, 3, 5, 49, 64, 40), "float32"),
    ("d=128 N=71", (1, 2, 2, 71, 128, 128), "float32"),
    ("dk=40 dv=10", (2, 3, 5, 49, 40, 10), "bfloat16"),
    ("rt d=48", RT_SHAPE, "bfloat16"),
    ("base H=6", BASE_SHAPE, "bfloat16"),
]


def phase_solve_vs_plain(device) -> float:
    """The forward's WY solve kernel, through the U, W that the forward
    returns as residuals, against the batched solve, with decoupled gates;
    returns the worst absolute error."""
    import torch
    from gdkvm_tpu_torch.ops import gdr_cuda
    gen = torch.Generator(device=device).manual_seed(7)
    worst = 0.0
    for name, shape, dt in SOLVE_CASES:
        q, k, v, beta, alpha, s0 = _gdr_inputs(gen, *shape, getattr(torch, dt), device)
        eta = torch.sigmoid(torch.randn(beta.shape, device=device, generator=gen))
        got = gdr_cuda.gdr_fwd_cuda_residuals(q, k, v, beta, alpha, s0, eta)[3:]
        want = gdr_cuda._wy(k, v, beta, eta)
        torch.cuda.synchronize()
        worst = max(worst, _check_rel(f"WY solve kernel vs _wy [{name}] {shape} {dt}",
                                      ("U", "W"), got, want, FWD_REL))
    return worst


def phase_gdr_times(device) -> dict:
    """Median ms of the forward kernel and of the plain GDR at the streaming
    bench shape, timed in turns (plain, kernel, kernel, plain), beside the
    kernel's bound."""
    import torch
    from gdkvm_tpu_torch.core import gdr
    from gdkvm_tpu_torch.ops import gdr_counts, gdr_cuda
    gen = torch.Generator(device=device).manual_seed(1)
    shape = (8, 4, 32, 49, 64, 64)
    args = _gdr_inputs(gen, *shape, torch.bfloat16, device)
    kern_ms, plain_ms, spread = _in_turns(lambda: gdr.gdr_chunked(*args),
                                          lambda: gdr_cuda.gdr_fwd_cuda(*args))
    print(f"GDR fwd at B=8 H=4 T=32 N=49 d=64 bf16 q/k/v: kernel "
          f"{kern_ms:.4f} ms, plain {plain_ms:.4f} ms ({spread})")
    out = gdr_cuda.gdr_fwd_cuda(*args)
    return dict(_bound("fwd, streaming", kern_ms, gdr_counts.fwd_ops(*shape, exact=True),
                       _nbytes(*args, *out)), plain_ms=plain_ms)


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
    _stream_profile(model, device)
    return {"launches": counts["fwd_kernel"],
            "fps": max(fps_kernel["frames_per_sec"], fps_kernel2["frames_per_sec"])}


# bench_torch.py's other arms, in this process: one rep of 10 timed chunks
# each (after a chunk from the initial state and the 3 warm-up chunks).
BENCH_ARMS = (("single-stream", {"GDKVM_BENCH_BATCH": "1", "GDKVM_BENCH_CHUNK": "16"}),
              ("flagship", {"GDKVM_BENCH_MODEL": "flagship"}),
              ("w8a8", {"GDKVM_BENCH_QUANT": "w8a8"}))
BENCH_ARM_RUN = {"GDKVM_BENCH_REPS": "1", "GDKVM_BENCH_TIMED_CHUNKS": "10"}
BENCH_KEYS = {"metric", "value", "unit", "device", "apparent_tflops", "plausible"}


def _check_bench_line(what: str, rec: dict, name: str) -> None:
    import math
    import bench_torch
    if set(rec) != BENCH_KEYS or rec["metric"] != bench_torch.METRIC \
            or rec["unit"] != "frames/sec" or not rec["value"] > 0 \
            or not (math.isfinite(rec["apparent_tflops"]) and rec["apparent_tflops"] > 0) \
            or rec["plausible"] is not True or not rec["device"].startswith(name + ", "):
        raise AssertionError(f"bench_torch.py {what}: {rec}")


def phase_bench_entry(device, info: dict, model_fps: float) -> dict:
    """``bench_torch.py``, the port's headline entry: (a) ``python3
    bench_torch.py`` at its defaults (ts8, 8 x 32 at 112^2, best of 3 reps
    of 30 timed chunks) as a subprocess, its one line checked; (b) the
    single-stream, flagship and W8A8 arms through ``bench_torch.run`` in
    this process with the launches counted (every chunk one forward launch,
    W8A8's two calibration batches one each; nothing else); (c) one chunk's
    FLOP count (``eval/flops.py``) on the kernel route equal to the
    chunked route's on the card; (d) the default arm's frames/s beside
    ``phase_model``'s, its apparent TFLOP/s and share of the card's peak.
    Returns the forward launches of (b)."""
    import bench_torch
    import torch
    from gdkvm_tpu_torch.eval import throughput
    from gdkvm_tpu_torch.eval.flops import count_flops
    name = torch.cuda.get_device_name(0)

    # (a) The contract, as the command line runs it.
    env = {k: v for k, v in _module_env().items() if not k.startswith("GDKVM_BENCH_")}
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, os.path.join(REPO, "bench_torch.py")], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=600)
    dt = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"bench_torch.py: rc {res.returncode}: {res.stderr[-2000:]}")
    lines = res.stdout.strip().splitlines()
    if len(lines) != 1:
        raise AssertionError(f"bench_torch.py printed {len(lines)} lines: {lines}")
    print(f"bench_torch.py (subprocess, {dt:.1f} s): {lines[0]}")
    default = json.loads(lines[0])
    _check_bench_line("default", default, name)

    # (b) The other arms, every launch counted.
    launches = 0
    for label, arm in BENCH_ARMS:
        arm = dict(BENCH_ARM_RUN, **arm)
        _reset_counts()
        t0 = time.perf_counter()
        rec = bench_torch.run(arm, "cuda")
        dt = time.perf_counter() - t0
        counts = _read_counts()
        _reset_counts()
        want = int(arm["GDKVM_BENCH_REPS"]) * (
            1 + bench_torch.WARMUP_CHUNKS + int(arm["GDKVM_BENCH_TIMED_CHUNKS"]))
        want += len(bench_torch.calibration_batches()) if "GDKVM_BENCH_QUANT" in arm else 0
        print(f"bench_torch [{label}] ({dt:.1f} s): {json.dumps(rec)}; counts {counts}")
        if counts != dict(_ZERO, fwd_kernel=want):
            raise AssertionError(f"bench_torch [{label}]: counts {counts}, expected "
                                 f"{want} forward launches and nothing else")
        _check_bench_line(label, rec, name)
        launches += want

    # (c) One 8 x 32 chunk's count: the kernel route against the chunked one.
    frames = torch.randint(0, 255, (8, 32, 112, 112, 1), generator=torch.Generator()
                           .manual_seed(4), dtype=torch.uint8).to(device)
    flops = {}
    for impl in ("auto", "chunked"):
        model = bench_torch.bench_model({"GDKVM_BENCH_IMPL": impl}, device)
        with torch.inference_mode():
            flops[impl] = count_flops(lambda: throughput.streaming_step(model, frames, None))
    counts = _read_counts()
    _reset_counts()
    print(f"FLOPs of one 8 x 32 chunk at 112^2: kernel route {flops['auto']}, chunked "
          f"{flops['chunked']}; counts {counts}")
    if flops["auto"] != flops["chunked"] or counts != dict(_ZERO, fwd_kernel=1, plain_fwd=1):
        raise AssertionError(f"route-dependent count {flops}, counts {counts}")

    # (d) Against phase_model's streaming run of the same model and shape.
    peak = throughput.peak_tflops(device)
    share = "not known" if peak is None else f"{default['apparent_tflops'] / peak:.4f}"
    print(f"bench_torch default on {info['smi']}: {default['value']} frames/s (phase_model "
          f"{model_fps:.1f}); apparent {default['apparent_tflops']:.4f} TFLOP/s, "
          f"{flops['auto'] / 1e9:.4f} GFLOP a chunk, share of the {peak} TFLOP/s "
          f"bf16 peak {share}")
    return {"fwd": launches}


def _stream_profile(model, device, warmup: int = 3, chunks: int = 3) -> None:
    """Where a streamed chunk's device time goes: torch.profiler over
    ``chunks`` chunks of 8 × 32 frames at 112² after ``warmup``, the state
    carried.  Prints the device kernel time and the kernels a chunk, the
    device's busy share of the profiled wall time, and the kernels that
    take the most time."""
    import collections
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    frames = torch.randint(0, 255, (8, 32 * (warmup + chunks), 112, 112, 1),
                           generator=torch.Generator().manual_seed(3),
                           dtype=torch.uint8).to(device)
    state = None

    def chunk(i):
        nonlocal state
        x = frames[:, 32 * i:32 * (i + 1)].to(torch.float32) / 255.0
        with torch.inference_mode():
            _, state = model(x, state)

    for i in range(warmup):
        chunk(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()     # the profiler's own start-up excluded
        for i in range(warmup, warmup + chunks):
            chunk(i)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        print("streaming profile: no device events traced (not measured)")
        return
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, (lo, hi) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > hi:
            busy, lo = busy + hi - lo, s
        hi = max(hi, e)
    busy += hi - lo
    by_name = collections.Counter()
    for e in kernels:
        by_name[e.name] += e.time_range.elapsed_us()
    total = sum(by_name.values())
    gdr_us = sum(t for n, t in by_name.items() if "wy_kernel" in n or "chain_kernel" in n)
    print(f"streaming profile, {chunks} chunks after {warmup}: device kernel time "
          f"{total / chunks / 1e3:.3f} ms a chunk in {len(kernels) / chunks:.0f} kernels; "
          f"GDR kernels {gdr_us / chunks / 1e3:.3f} ms a chunk ({gdr_us / total:.2%}); "
          f"device busy {busy / wall_us:.3f} of the profiled wall "
          f"({wall_us / chunks / 1e3:.3f} ms a chunk)")
    for name, us in by_name.most_common(8):
        print(f"  {us / total:7.2%} {us / chunks / 1e3:8.3f} ms/chunk  {name[:110]}")


_ZERO = {"fwd_kernel": 0, "chain_kernel": 0, "bwd_kernel": 0, "residual_fwd": 0, "plain_fwd": 0, "plain_chain": 0, "plain_bwd": 0,
         "stored_bwd": 0}


def _counters():
    from gdkvm_tpu_torch.core import gdr
    from gdkvm_tpu_torch.ops import gdr_cuda
    return {"fwd_kernel": gdr_cuda.LAUNCHES,
            "chain_kernel": gdr_cuda.CHAIN_LAUNCHES,
            "bwd_kernel": gdr_cuda.BWD_LAUNCHES,
            "residual_fwd": gdr_cuda.RESIDUAL_LAUNCHES,
            "plain_fwd": gdr.CHUNKED_CALLS, "plain_chain": gdr.CHAIN_CALLS,
            "plain_bwd": gdr.BWD_REF_CALLS, "stored_bwd": gdr.BWD_STORED_CALLS}


def _reset_counts() -> None:
    for c in _counters().values():
        c.reset()


def _read_counts() -> dict:
    """Launches of each kernel (residual_fwd: the forward launches, of
    either forward kernel, that wrote the backward's residuals), and calls of each
    plain version: the plain forward (gdr_chunked, with or without
    residuals), the plain chain (gdr_chain), the backward kernel's plain
    version (gdr_bwd_ref), and the stored backward (plain torch ops by
    design, as the JAX package runs it in XLA)."""
    return {name: c.n for name, c in _counters().items()}


_SCRATCH: list = []       # the run's TemporaryDirectory, made at first use


def _scratch_dir(name: str) -> str:
    """A fresh directory under one temporary directory that is removed when
    the script ends: nothing is written around the checkout."""
    import tempfile
    if not _SCRATCH:
        _SCRATCH.append(tempfile.TemporaryDirectory(prefix="gdkvm_smoke_"))
    return tempfile.mkdtemp(prefix=name + "_", dir=_SCRATCH[0].name)


def _train_cfg():
    """The ts8_256 recipe on synthetic clips (64 train, 8 val), its run dir
    a scratch directory, the wandb mirror off."""
    from gdkvm_tpu_torch.config.schema import ts8_256
    cfg = ts8_256()
    cfg.data.dataset = "synthetic"
    cfg.eval_stage.wandb_mode = "disabled"
    cfg.runtime.run_dir = _scratch_dir("train")
    return cfg


TRAIN_STEPS = 3
# train() ends with the eval stage: the 8 synthetic val clips, one a batch,
# each a residual-free forward launch.
FINAL_EVAL = 8


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
        print(f"training main path [{mode}]: counts {counts} ({TRAIN_STEPS} steps, "
              f"then the eval stage's {FINAL_EVAL} clips); last metrics "
              + " ".join(f"{k} {v:.6f}" for k, v in metrics.items())
              + f"; {dt:.1f} s with model init, data, eval and checkpoint")
        want = dict(_ZERO, fwd_kernel=TRAIN_STEPS + FINAL_EVAL,
                    residual_fwd=TRAIN_STEPS,
                    bwd_kernel=TRAIN_STEPS if mode == "fused" else 0,
                    stored_bwd=TRAIN_STEPS if mode == "stored" else 0)
        if counts != want:
            raise AssertionError(f"training counts [{mode}] {counts}, expected {want}")
        if not all(math.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"non-finite training metrics {metrics}")
        launches[mode] = counts
    os.environ.pop("GDKVM_GDR_BWD")
    return {"fwd": sum(c["fwd_kernel"] - c["residual_fwd"] for c in launches.values()),
            "residual": sum(c["residual_fwd"] for c in launches.values()),
            "bwd": sum(c["bwd_kernel"] for c in launches.values())}


def _batch(cfg, seed: int = 0):
    from gdkvm_tpu_torch.data.pipeline import batch_iterator, make_dataset
    ds = make_dataset(cfg.data, cfg.data.train_split, cfg.model.num_classes)
    return next(batch_iterator(ds, cfg.train.batch_size, augment=True,
                               seed=seed))


def _state(cfg, model_cfg, device, weights=None, mesh=None):
    """A train state of ``model_cfg`` on ``device`` from ``weights`` (whole;
    default the seeded init); on a process group's ``mesh``, its rank's head
    shard of them."""
    import torch
    from gdkvm_tpu_torch.models.gdkvm import GDKVM, init_params
    from gdkvm_tpu_torch.parallel.mesh import shard_state_dict
    from gdkvm_tpu_torch.train.loop import state_for
    heads = {} if mesh is None else dict(heads=mesh.heads, model_group=mesh.model_group)
    model = GDKVM(model_cfg, device=device, **heads)
    if weights is None:
        init_params(model, torch.Generator().manual_seed(cfg.train.seed))
    else:
        model.load_state_dict(shard_state_dict(weights, *model.lkva.heads))
    return state_for(cfg, model, mesh)


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
                                  "stored": {"fwd_kernel": 1, "residual_fwd": 1,
                                             "stored_bwd": 1},
                                  "fused": {"fwd_kernel": 1, "residual_fwd": 1,
                                            "bwd_kernel": 1}}[mode])
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
    and chunked, timed in turns; peak device memory of each, and the
    device kernel time of a step (torch.profiler)."""
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
    peak, device_ms = {}, {}
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
        if mode not in device_ms:
            device_ms[mode] = _profiled_ms(lambda: train_step(state, batch, cfg), iters=3)
    os.environ.pop("GDKVM_GDR_BWD")
    print("train device kernel time a step (torch.profiler, 3 steps): "
          + ", ".join(f"{m} {'not measured' if t is None else f'{t:.3f} ms'}"
                      for m, t in device_ms.items()))
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
    from gdkvm_tpu_torch.ops import gdr_counts, gdr_cuda
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
    # Each phase's device time inside the backward, by torch.profiler.
    bwd = lambda: gdr_cuda.gdr_bwd_cuda(*args)
    phases = {p: _profiled_ms(bwd, match=m) for p, m in (
        ("solve", "wy_kernel"), ("chain", "rev_chain_kernel"),
        ("frames", "frame_adjoint_kernel"))}
    if None in phases.values():
        print("GDR bwd phases: no device time traced (not measured)")
    else:
        print(f"GDR bwd at {shape} by phase (profiled device time a call, mean of "
              f"20): solve {phases['solve']:.4f} + reverse chain {phases['chain']:.4f} "
              f"+ per-frame adjoint {phases['frames']:.4f} = "
              f"{sum(phases.values()):.4f} ms")
    fwd_out = gdr_cuda.gdr_fwd_cuda_residuals(q, k, v, beta, alpha, s0)
    bwd_out = gdr_cuda.gdr_bwd_cuda(*args)
    return {"fwd": dict(_bound("fwd+residuals, training", f_ms,
                               gdr_counts.fwd_ops(*TRAIN_SHAPE, exact=True),
                               _nbytes(q, k, v, beta, alpha, s0, *fwd_out)),
                        plain_ms=f_plain),
            "bwd": dict(_bound("bwd, training", b_ms, gdr_counts.bwd_ops(*TRAIN_SHAPE, exact=True),
                               _nbytes(*args, *bwd_out)),
                        plain_ms=b_plain, stored_ms=stored_ms)}


# The serving main path: the engine's pool and chunk, at the model's size.
SERVE = dict(streams=8, chunk=16, image_size=112)
# Served masks against stream_video (batch 1) on the same weights.  In fp32
# compute, other cuDNN algorithms at batch 8 move logits by ~1e-6 and flip a
# handful of near-tied pixels of a random init (measured ≥ 0.999996), so
# served masks must agree on SERVE_AGREE of the pixels, and chain- with
# monolith-mode masks too.  In bf16 those differences become bf16
# roundings: the model's own chunked stream of the 8 videos as one batch
# agrees with stream_video on only ~99.4% of the pixels (measured), so there
# serving may lose at most BF16_SLACK of agreement beyond what batching
# itself loses; chain- and monolith-mode masks, whose GDR outputs differ by
# ~5e-7 relative, agree on ~99.89% (measured) and are held to the same bar.
SERVE_AGREE = 0.999
BF16_SLACK = 1e-3


def _serve_model(device, compute_dtype: str = "bfloat16"):
    """configs/gdkvm_ts8_112.yaml's ts8 model (4 classes) at full width,
    seeded random weights (the same for either compute dtype)."""
    import dataclasses
    import torch
    from gdkvm_tpu_torch.config.schema import ts8_112
    from gdkvm_tpu_torch.models.gdkvm import GDKVM, init_params
    cfg = dataclasses.replace(ts8_112().model, compute_dtype=compute_dtype)
    return init_params(GDKVM(cfg, device=device), torch.Generator().manual_seed(0))


def _serve_videos():
    """Seeded uint8 videos of 8 sessions: 64 frames at 112²; session 6 a
    ragged 70 frames; session 7 at 160×200, resized on the device."""
    import numpy as np
    videos = []
    for i in range(8):
        rng = np.random.default_rng(100 + i)
        hw = (160, 200) if i == 7 else (112, 112)
        videos.append(rng.integers(0, 256, (70 if i == 6 else 64, *hw, 1), np.uint8))
    return videos


def _batched_stream(model, videos, chunk: int):
    """The model's own chunked stream of ``videos`` as one batch, the state
    carried, each padded as stream_video pads it → per-video uint8 masks."""
    import numpy as np
    import torch
    from gdkvm_tpu_torch.eval.metrics import mask_from_logits
    device = next(model.parameters()).device
    n_chunks = max(-(-len(v) // chunk) for v in videos)
    padded = [np.concatenate([v, np.repeat(v[-1:], n_chunks * chunk - len(v), axis=0)])
              for v in videos]
    x = torch.from_numpy(np.stack(padded)).to(device)
    state, outs = None, []
    with torch.inference_mode():
        for lo in range(0, n_chunks * chunk, chunk):
            logits, state = model(x[:, lo:lo + chunk].to(torch.float32) / 255.0, state)
            outs.append(mask_from_logits(logits))
    masks = torch.cat(outs, 1).cpu().numpy()
    return [m[:len(v)] for m, v in zip(masks, videos)]


@contextlib.contextmanager
def _served(model=None, artifact=None, mesh=None):
    """A BatchingEngine around ``model`` (over ``mesh`` when given) or a
    loaded ``artifact`` behind make_server on 127.0.0.1 (port 0), the
    server on its own thread → (engine, (host, port)); all closed on exit."""
    from gdkvm_tpu_torch.serve import BatchingEngine, make_server
    engine = BatchingEngine(model=model, artifact=artifact, mesh=mesh, **SERVE)
    server = make_server(engine, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield engine, server.server_address
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        engine.close()


def _one_session(addr, video):
    from gdkvm_tpu_torch.serve import ServeClient
    client = ServeClient(*addr)
    client.open()
    try:
        return client.infer(video)
    finally:
        client.close()


def phase_serve(device) -> dict:
    """The serving main path, once per compute dtype and forward split: 8
    ServeClient sessions stream their videos at once through the engine
    behind the HTTP server, with every count 0 just before and read just
    after.  Each session's masks are held against a reference on the same
    weights (SERVE_AGREE), and in fp32 the chain run's against the monolith
    run's.  Returns the launches of each kernel, the bf16 model and its
    served masks by split."""
    import numpy as np
    import torch
    from gdkvm_tpu_torch.eval.streaming import stream_video
    from gdkvm_tpu_torch.ops.preproc import resize_u8
    from gdkvm_tpu_torch.serve import ServeClient
    videos = _serve_videos()
    size = SERVE["image_size"]
    refs = [v if v.shape[1:3] == (size, size) else
            resize_u8(torch.from_numpy(v).to(device), (size, size)).cpu().numpy()
            for v in videos]
    launches, models, by_dtype = {"fwd_kernel": 0, "chain_kernel": 0}, {}, {}
    for dtype in ("float32", "bfloat16"):
        os.environ.pop("GDKVM_GDR_FWD", None)     # references: the default split
        model = models[dtype] = _serve_model(device, dtype)
        cfg = model.cfg
        print(f"serve: ts8_112 model ({sum(p.numel() for p in model.parameters())} "
              f"parameters, {cfg.num_classes} classes, {dtype} compute), engine "
              f"{SERVE}; 8 sessions of {[v.shape[:3] for v in videos]} frames")
        single = [stream_video(model, r, chunk=SERVE["chunk"]) for r in refs]
        bar = SERVE_AGREE
        if dtype == "bfloat16":
            batched = [float((b == w).mean()) for b, w in
                       zip(_batched_stream(model, refs, SERVE["chunk"]), single)]
            print(f"[{dtype}] the model's batch-8 stream vs stream_video, per "
                  "session: " + " ".join(f"{x:.6f}" for x in batched))
            bar = min(batched) - BF16_SLACK
        masks = by_dtype[dtype] = {}
        for mode in ("monolith", "chain"):
            os.environ["GDKVM_GDR_FWD"] = mode
            with _served(model) as (engine, addr):
                _reset_counts()
                ticks0 = engine.ticks
                with ThreadPoolExecutor(max_workers=len(videos)) as pool:
                    masks[mode] = list(pool.map(lambda v: _one_session(addr, v), videos))
                ticks = engine.ticks - ticks0
                counts = _read_counts()
                health = ServeClient(*addr).health()
            key = "chain_kernel" if mode == "chain" else "fwd_kernel"
            print(f"serving main path [{dtype}, {mode}]: {ticks} ticks, counts {counts}")
            print(f"/healthz [{dtype}, {mode}]: {json.dumps(health)}")
            if ticks < 1 or counts != dict(_ZERO, **{key: ticks}):
                raise AssertionError(f"serving counts [{dtype}, {mode}] {counts}: "
                                     f"expected {ticks} residual-free {key} launches, "
                                     f"one a tick, and nothing else")
            launches[key] += counts[key]
            for got, want in zip(masks[mode], single):
                if got.shape != want.shape or got.dtype != np.uint8 \
                        or int(got.max()) >= cfg.num_classes:
                    raise AssertionError(f"[{dtype}, {mode}] masks {got.shape} "
                                         f"{got.dtype} max {got.max()}, want {want.shape}")
            agree = [float((g == w).mean()) for g, w in zip(masks[mode], single)]
            print(f"[{dtype}, {mode}] served vs stream_video, per session: "
                  + " ".join(f"{x:.6f}" for x in agree) + f"; bar {bar:.6f}")
            if min(agree) < bar:
                raise AssertionError(f"[{dtype}, {mode}] agreement with stream_video "
                                     f"{min(agree)} < {bar}")
        agree = [float((a == b).mean()) for a, b in zip(masks["chain"], masks["monolith"])]
        print(f"[{dtype}] chain vs monolith served masks, per session: "
              + " ".join(f"{a:.6f}" for a in agree) + f"; bar {bar:.6f}")
        if min(agree) < bar:
            raise AssertionError(f"[{dtype}] chain vs monolith agreement {min(agree)} < {bar}")
    os.environ.pop("GDKVM_GDR_FWD")
    return {"fwd_launches": launches["fwd_kernel"],
            "chain_launches": launches["chain_kernel"], "model": models["bfloat16"],
            "masks": masks, "bf16_bar": bar, "model_fp32": models["float32"],
            "masks_fp32": by_dtype["float32"]}


def _bench_sessions(addr, sessions: int, frames: int, per_request: int) -> dict:
    """``gdkvm serve-bench``'s probe (gdkvm_tpu/cli.py): ``sessions``
    clients at once, each streaming ``frames`` frames in requests of
    ``per_request`` frames (videos made before the clock starts); the host
    time of every request, submit to masks, and frames/s over the wall
    time."""
    import numpy as np
    from gdkvm_tpu_torch.serve import ServeClient
    size = SERVE["image_size"]
    n_req = frames // per_request

    def run(i):
        rng = np.random.default_rng(200 + i)
        vids = [rng.integers(0, 256, (per_request, size, size, 1), np.uint8)
                for _ in range(min(n_req, 4))]
        client = ServeClient(*addr)
        client.open()
        lat = []
        try:
            for j in range(n_req):
                t0 = time.perf_counter()
                masks = client.infer(vids[j % len(vids)])
                lat.append(time.perf_counter() - t0)
                if masks.shape != (per_request, size, size):
                    raise AssertionError(f"masks {masks.shape}")
        finally:
            client.close()
        return lat

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=sessions) as pool:
        lats = [x for lat in pool.map(run, range(sessions)) for x in lat]
    wall = time.perf_counter() - t0
    ms = np.array(lats) * 1e3
    return {"frames_per_sec": sessions * frames / wall, "requests": len(lats),
            **{f"p{q}_ms": float(np.percentile(ms, q)) for q in (50, 95, 99)}}


# (name, frames per request, frames per session): one chunk per request, the
# live-scanner pattern; 256-frame requests, the cine-upload pattern.
SERVE_PATTERNS = (("live 16-frame requests", 16, 256),
                  ("cine 256-frame requests", 256, 512))


def phase_serve_times(device, model) -> dict:
    """Serving frames/s and request latency per forward split, in turns
    (monolith, chain, chain, monolith), 8 sessions at once, for each
    request pattern; the engine's queue wait and service time per piece,
    and the peak device memory."""
    import numpy as np
    import torch
    runs = {"monolith": [], "chain": []}
    with _served(model) as (engine, addr):
        for mode in ("monolith", "chain", "chain", "monolith"):
            os.environ["GDKVM_GDR_FWD"] = mode
            _bench_sessions(addr, 8, 64, 16)               # warm, untimed
            engine.drain_stats()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            for name, per_request, frames in SERVE_PATTERNS:
                r = _bench_sessions(addr, 8, frames, per_request)
                wait, service, _ = np.array(engine.drain_stats()).T
                r.update({f"{what}_ms_p{q}": float(np.percentile(x, q))
                          for what, x in (("wait", wait), ("service", service))
                          for q in (50, 99)})
                runs[mode].append((name, r))
                print(f"serve [{mode}] {name}: {r['frames_per_sec']:.1f} frames/s, "
                      f"{r['requests']} requests, latency p50 {r['p50_ms']:.3f} "
                      f"p95 {r['p95_ms']:.3f} p99 {r['p99_ms']:.3f} ms; per piece "
                      f"queue wait p50 {r['wait_ms_p50']:.3f} p99 {r['wait_ms_p99']:.3f}, "
                      f"service p50 {r['service_ms_p50']:.3f} p99 "
                      f"{r['service_ms_p99']:.3f} ms")
            print(f"serve [{mode}] peak device memory "
                  f"{torch.cuda.max_memory_allocated(device) / 2**20:.1f} MiB; "
                  f"stats dropped {engine.stats_dropped}")
    os.environ.pop("GDKVM_GDR_FWD")
    for mode, rs in runs.items():
        for name, _, _ in SERVE_PATTERNS:
            fps = [r["frames_per_sec"] for n, r in rs if n == name]
            print(f"serve [{mode}] {name}: mean of {len(fps)} turns "
                  f"{statistics.mean(fps):.1f} frames/s")
    return runs


# The exported artifact against the eager model on the same frames: max|Δ|
# over max|eager| of the logits and of the carried state.
EXPORT_REL = 1e-5
EXPORT_OP = "gdkvm_tpu_torch.gdr_fwd.default"


def phase_export(device, served: dict) -> dict:
    """The exported artifact (the sixth main path): the bf16 ts8_112 model
    of ``phase_serve`` saved by ``io.export.save_artifact`` at the engine's
    batch 8 and chunk 16, and loaded back.  An eager call after the export
    returns real tensors; the loaded graph holds the GDR's custom op; two
    carried chunks through the artifact are held against the eager model
    (EXPORT_REL), in each forward split, one residual-free launch a step;
    then ``BatchingEngine(artifact=...)`` behind the HTTP server serves the
    8 sessions of ``phase_serve``, counts 0 just before and read just
    after, every session's masks held against the model engine's
    (SERVE_AGREE); last, served frames/s and latency of the artifact engine
    against the model engine, in turns.  The custom op alone passes
    ``torch.library.opcheck`` on the card and matches the plain scan.
    Returns the launches by kernel."""
    import numpy as np
    import torch
    from torch._subclasses.fake_tensor import FakeTensor
    from gdkvm_tpu_torch.core import gdr
    from gdkvm_tpu_torch.io.export import load_artifact, save_artifact
    from gdkvm_tpu_torch.models import decoder
    model, size, chunk = served["model"], SERVE["image_size"], SERVE["chunk"]
    art = os.path.join(_scratch_dir("export"), "ts8_112")
    os.environ.pop("GDKVM_GDR_FWD", None)
    # The export is the first call to reach the decoder's resize sizes: a
    # traced (fake) matrix must not reach the cache that eager calls read.
    decoder._resize_tensor.cache_clear()
    t0 = time.perf_counter()
    meta = save_artifact(art, model, image_size=size, chunk=chunk, batch=SERVE["streams"])
    t_export = time.perf_counter() - t0
    frames = torch.from_numpy(np.random.default_rng(300).integers(
        0, 256, (SERVE["streams"], 2 * chunk, size, size, 1), np.uint8)).to(device)
    with torch.inference_mode():
        logits, state = model(frames[:, :chunk].to(torch.float32) / 255.0)
    if isinstance(logits, FakeTensor) or isinstance(state.mem, FakeTensor) \
            or not torch.isfinite(logits).all():
        raise AssertionError(f"an eager call after the export returned {type(logits)}")
    t0 = time.perf_counter()
    sm = load_artifact(art)
    t_load = time.perf_counter() - t0
    ops = [str(n.target) for n in sm.program.graph.nodes if n.op == "call_function"]
    print(f"export: ts8_112 [bfloat16] at batch {sm.batch}, chunk {sm.chunk}, {size}²: "
          f"model.pt2 {meta['blob_bytes']} bytes on {meta['platforms']}; export "
          f"{t_export:.1f} s, load {t_load:.1f} s; {len(ops)} graph calls, "
          f"{ops.count(EXPORT_OP)} of {EXPORT_OP}")
    if ops.count(EXPORT_OP) != 1 or sm.device != device:
        raise AssertionError(f"the loaded program: {ops.count(EXPORT_OP)} GDR op nodes "
                             f"on {sm.device}")
    # The op alone at the serving shape, in either split: torch.library's
    # opcheck (schema; the fake implementation against the kernel's
    # outputs) and its result against the plain scan.
    op = torch.ops.gdkvm_tpu_torch.gdr_fwd
    ins = _gdr_inputs(torch.Generator(device=device).manual_seed(8), *SERVE_SHAPE,
                      torch.bfloat16, device)
    plain = gdr.gdr_chunked(*ins)
    for mode in ("monolith", "chain"):
        os.environ["GDKVM_GDR_FWD"] = mode
        torch.library.opcheck(op, (*ins, None))
        err = max(_rel(x, p) for x, p in zip(op(*ins, None), plain))
        print(f"export: {EXPORT_OP} [{mode}] at {SERVE_SHAPE} bf16: opcheck passed; "
              f"against gdr_chunked {err:.3e} of the largest (bar {FWD_REL:g})")
        if err > FWD_REL:
            raise AssertionError(f"the custom op [{mode}] differs from gdr_chunked: {err}")
    os.environ.pop("GDKVM_GDR_FWD")
    print("export: the graph's most frequent calls: " + ", ".join(
        f"{op.split('.')[-2] if '.' in op else op} {n}"
        for op, n in collections.Counter(ops).most_common(8)))
    # Host time of one step, eager model against the artifact, in turns,
    # each call ended by a synchronize (the engine's ticks are host-bound).
    step_ms = {"eager": [], "artifact": []}
    x_u8 = frames[:, :chunk].contiguous()
    mem0, seen0 = sm.init_state()

    def eager_step():
        with torch.inference_mode():
            return model(x_u8.to(torch.float32) / 255.0)
    for which in ("eager", "artifact", "artifact", "eager"):
        call = eager_step if which == "eager" else (lambda: sm.step(x_u8, mem0, seen0))
        for i in range(23):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            if i >= 3:
                step_ms[which].append(1e3 * (time.perf_counter() - t0))
    print("export: host ms a step (8 x 16 frames, synchronized), median of 40 in turns: "
          + ", ".join(f"{w} {statistics.median(v):.3f} (min {min(v):.3f})"
                      for w, v in step_ms.items()))
    launches = {"fwd_kernel": 0, "chain_kernel": 0}
    for mode in ("monolith", "chain"):
        os.environ["GDKVM_GDR_FWD"] = mode
        key = "chain_kernel" if mode == "chain" else "fwd_kernel"
        mem, seen = sm.init_state()
        got = []
        _reset_counts()
        for lo in (0, chunk):
            out, mem, seen = sm.step(frames[:, lo:lo + chunk], mem, seen)
            got.append(out)
        counts = _read_counts()
        launches[key] += counts[key]
        state, want = None, []
        with torch.inference_mode():
            for lo in (0, chunk):
                out, state = model(frames[:, lo:lo + chunk].to(torch.float32) / 255.0, state)
                want.append(out)
        _reset_counts()
        err = max(_rel(g, w) for g, w in zip(got, want))
        err_mem = _rel(mem, state.mem)
        print(f"export [{mode}]: 2 carried chunks, artifact vs eager: logits "
              f"{err:.3e}, mem {err_mem:.3e} of their largest (bar {EXPORT_REL:g}); "
              f"frames_seen {seen.tolist()}; counts {counts}")
        if counts != dict(_ZERO, **{key: 2}):
            raise AssertionError(f"artifact [{mode}] counts {counts}: expected one "
                                 f"residual-free {key} launch a step")
        if err > EXPORT_REL or err_mem > EXPORT_REL \
                or seen.tolist() != state.frames_seen.tolist():
            raise AssertionError(f"artifact [{mode}] differs from the eager model")

    videos = _serve_videos()
    for mode in ("monolith", "chain"):
        os.environ["GDKVM_GDR_FWD"] = mode
        key = "chain_kernel" if mode == "chain" else "fwd_kernel"
        with _served(artifact=sm) as (engine, addr):
            _reset_counts()
            ticks0 = engine.ticks
            with ThreadPoolExecutor(max_workers=len(videos)) as pool:
                masks = list(pool.map(lambda v: _one_session(addr, v), videos))
            ticks = engine.ticks - ticks0
            counts = _read_counts()
        launches[key] += counts[key]
        agree = [float((g == w).mean()) for g, w in zip(masks, served["masks"][mode])]
        print(f"export [{mode}]: artifact engine, {ticks} ticks, counts {counts}; masks vs "
              "the model engine's, per session: " + " ".join(f"{x:.6f}" for x in agree)
              + f"; bar {SERVE_AGREE}")
        if ticks < 1 or counts != dict(_ZERO, **{key: ticks}):
            raise AssertionError(f"artifact serving counts [{mode}] {counts}: expected "
                                 f"{ticks} residual-free {key} launches, one a tick")
        if min(agree) < SERVE_AGREE:
            raise AssertionError(f"artifact-served masks [{mode}] agree {min(agree)} "
                                 f"< {SERVE_AGREE}")
    os.environ.pop("GDKVM_GDR_FWD")

    # Served rate and latency: the model engine and the artifact engine in
    # turns, live 16-frame requests, 8 sessions at once.
    rates = {"model": [], "artifact": []}
    for which in ("model", "artifact", "artifact", "model"):
        source = {"model": model} if which == "model" else {"artifact": sm}
        with _served(**source) as (_, addr):
            _bench_sessions(addr, 8, 32, 16)                # warm, untimed
            rates[which].append(_bench_sessions(addr, 8, 256, 16))
    for which, rs in rates.items():
        print(f"export: {which} engine, live 16-frame requests: " + "; ".join(
            f"{r['frames_per_sec']:.1f} frames/s, p50 {r['p50_ms']:.3f} p99 "
            f"{r['p99_ms']:.3f} ms" for r in rs))
    _reset_counts()
    return {"fwd": launches["fwd_kernel"], "chain": launches["chain_kernel"]}


def phase_chain_train(device) -> int:
    """Training with GDKVM_GDR_FWD=chain: ``train(cfg, max_steps)`` on the
    ts8_256 recipe under the stored backward, counts 0 just before and read
    just after; then one step in fp32 compute under either backward, chain
    against monolith, from the same weights and batch: its launches, loss
    and gradient norm.  Returns the chain launches of the training run."""
    import dataclasses
    import math
    from gdkvm_tpu_torch.models.gdkvm import train_model_config
    from gdkvm_tpu_torch.train.loop import global_norm, loss_and_grads, train
    cfg = _train_cfg()
    os.environ["GDKVM_GDR_FWD"], os.environ["GDKVM_GDR_BWD"] = "chain", "stored"
    _reset_counts()
    metrics = train(cfg, max_steps=TRAIN_STEPS, device=device)
    counts = _read_counts()
    print(f"training [chain, stored]: counts {counts}; last metrics "
          + " ".join(f"{k} {v:.6f}" for k, v in metrics.items()))
    want = dict(_ZERO, chain_kernel=TRAIN_STEPS + FINAL_EVAL,
                residual_fwd=TRAIN_STEPS, stored_bwd=TRAIN_STEPS)
    if counts != want:
        raise AssertionError(f"training counts [chain, stored] {counts}, expected {want}")
    if not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"non-finite training metrics {metrics}")
    launches = counts["chain_kernel"]

    batch = _batch(cfg)
    mcfg = dataclasses.replace(train_model_config(cfg.model, 256),
                               compute_dtype="float32")
    weights, runs = None, {}
    for fwd in ("monolith", "chain"):
        for mode in ("stored", "fused"):
            os.environ["GDKVM_GDR_FWD"], os.environ["GDKVM_GDR_BWD"] = fwd, mode
            state = _state(cfg, mcfg, device, weights)
            weights = weights or state.model.state_dict()
            _reset_counts()
            metrics, grads = loss_and_grads(state, batch, cfg)
            counts = _read_counts()
            want = dict(_ZERO, residual_fwd=1,
                        **{"chain_kernel" if fwd == "chain" else "fwd_kernel": 1,
                           "bwd_kernel" if mode == "fused" else "stored_bwd": 1})
            if counts != want:
                raise AssertionError(f"one step [{fwd}, {mode}] counts {counts}, "
                                     f"expected {want}")
            runs[fwd, mode] = (metrics["loss"].item(), global_norm(grads).item())
    os.environ.pop("GDKVM_GDR_FWD")
    os.environ.pop("GDKVM_GDR_BWD")
    bar = STEP_REL["float32"]
    for mode in ("stored", "fused"):
        (l_c, g_c), (l_m, g_m) = runs["chain", mode], runs["monolith", mode]
        d_loss, d_norm = abs(l_c - l_m) / abs(l_m), abs(g_c - g_m) / abs(g_m)
        print(f"[float32, {mode}] chain vs monolith one step: loss {l_c:.6f} vs "
              f"{l_m:.6f}, grad_norm {g_c:.6f} vs {g_m:.6f}; |Δloss|/loss "
              f"{d_loss:.3e}, |Δgrad_norm|/grad_norm {d_norm:.3e} (bar {bar:g})")
        if not (d_loss <= bar and d_norm <= bar):
            raise AssertionError(f"[{mode}] chain step disagrees with monolith")
    return launches


def phase_chain_times(device) -> dict:
    """The chain kernel against gdr_chain, and the chain split (batched
    solve + kernel) against the monolith kernel, at the serving shape
    (residual-free) and at the training shape (with the stored backward's
    residuals), timed in turns; the forward's solve and chain kernels by
    their profiled device time, the solve against the batched solve."""
    import torch
    from gdkvm_tpu_torch.core import gdr
    from gdkvm_tpu_torch.ops import gdr_counts, gdr_cuda
    gen = torch.Generator(device=device).manual_seed(6)
    out = {}
    for name, shape, save in (("serve", SERVE_SHAPE, False), ("train", TRAIN_SHAPE, True)):
        q, k, v, beta, alpha, s0 = _gdr_inputs(gen, *shape, torch.bfloat16, device)
        u, w = gdr_cuda._wy(k, v, beta, None)
        k_ms, p_ms, spread = _in_turns(
            lambda: gdr.gdr_chain(q, k, u, w, alpha, s0, save_states=save),
            lambda: gdr_cuda.gdr_chain_cuda(q, k, u, w, alpha, s0, save_states=save))
        solve_ms = statistics.median(_times_ms(lambda: gdr_cuda._wy(k, v, beta, None)))
        split = lambda: gdr_cuda.gdr_chain_cuda(q, k, *gdr_cuda._wy(k, v, beta, None),
                                                alpha, s0, save_states=save)
        mono = ((lambda: gdr_cuda.gdr_fwd_cuda_residuals(q, k, v, beta, alpha, s0))
                if save else (lambda: gdr_cuda.gdr_fwd_cuda(q, k, v, beta, alpha, s0)))
        s_ms, m_ms, s_spread = _in_turns(mono, split)
        # The forward's own solve kernel (its wy_kernel launches inside the
        # forward) against the batched solve (every kernel of _wy), device
        # time by torch.profiler, in turns.
        wy_plain = lambda: gdr_cuda._wy(k, v, beta, None)
        turns = [_profiled_ms(wy_plain), _profiled_ms(mono, match="wy_kernel"),
                 _profiled_ms(mono, match="wy_kernel"), _profiled_ms(wy_plain)]
        chain_in_fwd = _profiled_ms(mono, match="chain_kernel")
        if None in turns or chain_in_fwd is None:
            wy_ms = lib_ms = None
            print(f"GDR WY solve [{name}]: no device time traced (not measured)")
        else:
            lib_ms, wy_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
            print(f"GDR WY solve [{name}]: kernel (wy_kernel inside the forward) "
                  f"{wy_ms:.4f} ms, batched solve (_wy) {lib_ms:.4f} ms (profiled "
                  f"device time a call, mean of 20 calls in turns: "
                  + " ".join(f"{x:.4f}" for x in turns) + ")")
            # What a one-launch design (solve overlapped with the chain, U
            # and W kept on chip) could at best remove: the solve's time, or
            # the events' time beyond the two kernels' own.
            print(f"GDR forward [{name}] by kernel: solve {wy_ms:.4f} + chain "
                  f"{chain_in_fwd:.4f} = {wy_ms + chain_in_fwd:.4f} ms of kernel time "
                  f"(profiled), against {m_ms:.4f} ms between CUDA events")
        b, h, t, n, dk, dv = shape
        what = "with S_{t-1}, U, W" if save else "residual-free"
        print(f"GDR chain kernel [{name}] B={b} H={h} T={t} N={n} d={dk} bf16 q/k, "
              f"{what}: kernel {k_ms:.4f} ms, plain (gdr_chain) {p_ms:.4f} ms ({spread})")
        print(f"GDR forward split [{name}], {what}: chain split {s_ms:.4f} ms "
              f"(batched solve alone {solve_ms:.4f} ms), monolith kernel "
              f"{m_ms:.4f} ms ({s_spread})")
        o, s_t, states = gdr_cuda.gdr_chain_cuda(q, k, u, w, alpha, s0, save_states=save)
        mono_out = mono()
        out[name] = {
            "kernel": dict(_bound(f"chain, {name}", k_ms, gdr_counts.chain_ops(*shape, exact=True),
                                  _nbytes(q, k, u, w, alpha, s0, o, s_t, states)),
                           plain_ms=p_ms),
            "fwd": _bound(f"fwd, {name}", m_ms, gdr_counts.fwd_ops(*shape, exact=True),
                          _nbytes(q, k, v, beta, alpha, s0, *mono_out)),
            "split": (s_ms, m_ms), "solve": solve_ms}
        if wy_ms is not None:
            _bound(f"WY solve, {name}", wy_ms, gdr_counts.solve_ops(*shape, exact=True),
                   _nbytes(k, v, beta, u, w))
    return out


# The training run: the ts8_256 recipe, cut to 12 steps with the eval stage
# and a checkpoint every 6, EMA on.
RUN = dict(num_iterations=12, log_every=2, eval_every=6, checkpoint_every=6,
           ema_decay=0.99)
RUN_CLIPS = {"packed": (32, 8), "camus": (16, 4)}      # train, val clips of 10 frames
# A resumed run against the unbroken one, max|Δ|/max|·| over each group of
# tensors: cuDNN's and the atomics of the stored backward's batched products
# may order sums differently from run to run.
RESUME_REL = 1e-5


def _write_run_sets(root: str, pil: bool) -> dict:
    """The run's datasets, written from a seed: a packed train/val split at
    256² (data/packed.py ``write_pck``), and the CAMUS PNG layout where PIL
    is there.  → {kind: data_path}."""
    from gdkvm_tpu_torch.data.packed import PackedDataset, write_pck
    from gdkvm_tpu_torch.data.synthetic import SyntheticDataset
    t0 = time.perf_counter()
    roots = {"packed": os.path.join(root, "pck")}
    for split, n, seed in (("train", RUN_CLIPS["packed"][0], 0),
                           ("val", RUN_CLIPS["packed"][1], 1)):
        clips = SyntheticDataset(n, 10, 256, num_classes=4, seed=seed)
        with ThreadPoolExecutor(max_workers=8) as pool:
            items = list(pool.map(clips.__getitem__, range(n)))
        write_pck(os.path.join(roots["packed"], f"{split}.pck"), items)
    ds = PackedDataset(os.path.join(roots["packed"], "train.pck"))
    mb = os.path.getsize(ds.path) / 2**20
    print(f"train run data: packed split written in {time.perf_counter() - t0:.1f} s, "
          f"train.pck {mb:.1f} MiB ({len(ds)} clips of {ds.clip_len} x {ds.height} x "
          f"{ds.width}); gather through the "
          f"{'native library (native/libpck.so)' if ds.native_gather else 'numpy mmap path'}")
    ds.close()
    if pil:
        from gdkvm_tpu_torch.data.camus import materialize_synthetic_camus
        t0 = time.perf_counter()
        roots["camus"] = os.path.join(root, "camus")
        materialize_synthetic_camus(roots["camus"], *RUN_CLIPS["camus"], image_size=256,
                                    clip_len=10, num_classes=4)
        print(f"train run data: CAMUS PNG layout ({RUN_CLIPS['camus'][0]} + "
              f"{RUN_CLIPS['camus'][1]} clips) written in {time.perf_counter() - t0:.1f} s")
    else:
        print("train run data: PIL is absent: no CAMUS PNG layout is written and no "
              "overlay PNG will be; the card and the kernels are used all the same")
    return roots


def _run_cfg(kind: str, data_path: str, run_dir: str, cache: str, **over):
    """ts8_256 on the set at ``data_path``, cut to RUN."""
    from gdkvm_tpu_torch.config.schema import ts8_256
    cfg = ts8_256(data_path=data_path)
    cfg.data.dataset, cfg.data.device_cache = kind, cache
    for key, val in {**RUN, **over}.items():
        setattr(cfg.runtime if key == "resume" else cfg.train, key, val)
    cfg.eval_stage.wandb_mode = "disabled"
    cfg.runtime.run_dir = run_dir
    return cfg


def _jsonl(run_dir: str) -> list:
    with open(os.path.join(run_dir, "metrics.jsonl")) as fh:
        return [json.loads(line) for line in fh]


def phase_train_run(device, pil: bool) -> dict:
    """The training-run main path: ``train(cfg)`` with data from disk, the
    eval stage, checkpoints and the log, once per data path, counts 0 just
    before and read just after; then the resume check.  Returns the
    launches."""
    import math
    from gdkvm_tpu_torch.config.schema import load_config
    from gdkvm_tpu_torch.train.loop import train
    launches = {"fwd": 0, "residual": 0}
    rates = {}
    tmp = _scratch_dir("run")
    roots = _write_run_sets(tmp, pil)
    # The device cache, and the host pipeline (thread pool, pinned
    # prefetch): on the PNG layout where PIL imports, else on the packed file.
    runs = [("packed", "on"), ("camus", "off") if pil else ("packed", "off")]
    for kind, cache in runs:
        run_dir = os.path.join(tmp, f"run_{kind}_{cache}")
        cfg = _run_cfg(kind, roots[kind], run_dir, cache)
        n_val = RUN_CLIPS[kind][1]
        _reset_counts()
        t0 = time.perf_counter()
        final = train(cfg, device=device)
        dt = time.perf_counter() - t0
        counts = _read_counts()
        steps = RUN["num_iterations"]
        evals = 2 * n_val // cfg.eval_stage.batch_size     # two passes
        want = dict(_ZERO, fwd_kernel=steps + evals, residual_fwd=steps,
                    stored_bwd=steps)
        print(f"training run [{kind}, device_cache={cache}]: counts {counts} "
              f"({steps} steps, 2 eval passes of {n_val} clips); {dt:.1f} s in all")
        if counts != want:
            raise AssertionError(
                f"training run [{kind}, {cache}] counts {counts}, expected {want}: "
                f"one forward with residuals a step, {evals} residual-free "
                f"launches in eval, no plain GDR call")
        rows = _jsonl(run_dir)
        logged = [r for r in rows if "loss" in r]
        eval_rows = [r for r in rows if "eval/dice_fg_mean" in r]
        if [r["step"] for r in logged] != [1, 2, 4, 6, 8, 10, 12] \
                or [r["step"] for r in eval_rows] != [6, 12]:
            raise AssertionError(f"logged steps {[r['step'] for r in rows]}")
        for r in logged[1:]:
            if not all(math.isfinite(r[k]) and r[k] > 0 for k in
                       ("loss", "steps_per_sec", "frames_per_sec")):
                raise AssertionError(f"log row {r}")
        for r in eval_rows:
            dice = {k: v for k, v in r.items() if k.startswith("eval/dice")}
            if len(dice) != 5 or not all(0 <= v <= 1 for v in dice.values()) \
                    or r["eval/frames"] != n_val * 10:
                raise AssertionError(f"eval row {r}")
        ckpts = sorted(os.listdir(os.path.join(run_dir, "checkpoints")))
        if ckpts != ["step_00000006.pt", "step_00000012.pt"]:
            raise AssertionError(f"checkpoints {ckpts}")
        n_vis = (len(os.listdir(os.path.join(run_dir, "vis")))
                 if os.path.isdir(os.path.join(run_dir, "vis")) else 0)
        if n_vis != (2 * min(cfg.eval_stage.num_vis, n_val) if pil else 0):
            raise AssertionError(f"{n_vis} overlay PNGs")
        if load_config(os.path.join(run_dir, "config.yaml")) != cfg:
            raise AssertionError("config.yaml does not read back to the run's config")
        if final["eval/dice_fg_mean"] != eval_rows[-1]["eval/dice_fg_mean"]:
            raise AssertionError(f"returned {final}")
        # The second eval pass, between its step's log row and its own
        # (the first also pays cuDNN's search at the eval batch).
        eval_s = eval_rows[-1]["time"] - logged[-1]["time"]
        print(f"training run [{kind}, device_cache={cache}]: eval stage at step 12: "
              f"{n_val * 10} frames in {eval_s:.3f} s, {n_val * 10 / eval_s:.1f} "
              f"frames/s (batch {cfg.eval_stage.batch_size}, overlays and val "
              f"loading inside)")
        window = [r["steps_per_sec"] for r in logged if r["step"] >= 4]
        rates[kind, cache] = statistics.median(window)
        print(f"training run [{kind}, device_cache={cache}]: steps/s by log window "
              + " ".join(f"{r['step']}:{r['steps_per_sec']:.3f}" for r in logged[1:])
              + f"; median from step 4 {rates[kind, cache]:.3f} steps/s "
              f"({rates[kind, cache] * 80:.1f} frames/s), data path inside; "
              f"loss {logged[0]['loss']:.4f} -> {logged[-1]['loss']:.4f}; eval Dice fg "
              + " ".join(f"{r['eval/dice_fg_mean']:.4f}" for r in eval_rows)
              + f"; {n_vis} overlays, checkpoints {ckpts}")
        launches["fwd"] += counts["fwd_kernel"] - counts["residual_fwd"]
        launches["residual"] += counts["residual_fwd"]
    _resume_check(device, roots["packed"], tmp, "on")
    return {"launches": launches, "rates": rates, "roots": roots}


def _resume_check(device, data_path: str, tmp: str, cache: str) -> None:
    """An unbroken 12-step run against one resumed from its checkpoint 6
    in another run dir: parameters, EMA and AdamW moments at step 12 within
    RESUME_REL, the logged batch checksums of steps 7-12 identical."""
    import shutil
    import torch
    from gdkvm_tpu_torch.train.loop import train
    dirs = {n: os.path.join(tmp, f"resume_{cache}_{n}") for n in ("unbroken", "resumed")}
    train(_run_cfg("packed", data_path, dirs["unbroken"], cache, log_every=1), device=device)
    os.makedirs(os.path.join(dirs["resumed"], "checkpoints"))
    shutil.copy(os.path.join(dirs["unbroken"], "checkpoints", "step_00000006.pt"),
                os.path.join(dirs["resumed"], "checkpoints"))
    train(_run_cfg("packed", data_path, dirs["resumed"], cache, log_every=1, resume=True),
          device=device)
    rows = {n: {r["step"]: r for r in _jsonl(d) if "loss" in r} for n, d in dirs.items()}
    if sorted(rows["resumed"]) != list(range(7, 13)):
        raise AssertionError(f"resumed run logged steps {sorted(rows['resumed'])}")
    sums = {n: [rows[n][s]["batch_checksum"] for s in range(7, 13)] for n in rows}
    d_loss = max(abs(rows["resumed"][s]["loss"] - rows["unbroken"][s]["loss"])
                 for s in range(7, 13))
    if sums["resumed"] != sums["unbroken"]:
        raise AssertionError(f"[{cache}] batch checksums differ: {sums}")
    trees = {n: torch.load(os.path.join(d, "checkpoints", "step_00000012.pt"),
                           weights_only=True) for n, d in dirs.items()}
    groups = {"params": lambda t: list(t["model"].values()), "ema": lambda t: t["ema"],
              "exp_avg": lambda t: t["opt"]["exp_avg"],
              "exp_avg_sq": lambda t: t["opt"]["exp_avg_sq"]}
    rels = {}
    for name, pick in groups.items():
        a, b = pick(trees["resumed"]), pick(trees["unbroken"])
        rels[name] = max(_rel(x, y) for x, y in zip(a, b))
    same = all(trees["resumed"][k] == trees["unbroken"][k] for k in ("step",)) and \
        trees["resumed"]["opt"]["count"] == trees["unbroken"]["opt"]["count"] and \
        torch.equal(trees["resumed"]["gen"], trees["unbroken"]["gen"])
    print(f"resume [device_cache={cache}]: steps 7-12 batch checksums identical "
          f"({[int(x) for x in sums['resumed']]}); max|Δloss| {d_loss:.3e}; at step 12, "
          "per-tensor worst max|Δ|/max|·|: "
          + " ".join(f"{n} {r:.3e}" for n, r in rels.items())
          + f" (bar {RESUME_REL:g}); step, update count and prompt generator equal: {same}")
    if not same or not all(r <= RESUME_REL for r in rels.values()):
        raise AssertionError(f"[{cache}] resumed run differs from the unbroken one")


def phase_gdn2(device) -> dict:
    """The decoupled-η model: the ts8 model with ``gdr_variant="gdn2"``, its
    η projection drawn apart from β's.  One streamed 8 x 32 chunk at 112²
    and two training steps at the ts8_256 shape under the stored and the
    fused backward, each against the same weights through the plain chunked
    GDR; the kernels' counts show they ran."""
    import dataclasses
    import torch
    from gdkvm_tpu_torch.eval.metrics import mask_from_logits
    from gdkvm_tpu_torch.models.gdkvm import GDKVM, init_params, train_model_config
    from gdkvm_tpu_torch.train.loop import state_for, train_step
    cfg = _train_cfg()
    cfg.model.gdr_variant = "gdn2"
    batch = _batch(cfg)
    launches = {"fwd": 0, "residual": 0, "bwd": 0}
    frames = torch.randint(0, 255, (8, 32, 112, 112, 1), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(5)).to(device)
    for dtype in ("float32", "bfloat16"):
        mcfg = dataclasses.replace(train_model_config(cfg.model, 256), compute_dtype=dtype)
        ref = init_params(GDKVM(dataclasses.replace(mcfg, gdr_impl="chunked"), device=device),
                          torch.Generator().manual_seed(0))
        with torch.no_grad():      # η's projection: its own weights, not β's start
            ref.lkva.eta_proj.weight.copy_(torch.randn(
                ref.lkva.eta_proj.weight.shape, generator=torch.Generator().manual_seed(1))
                * ref.lkva.beta_proj.weight.std().cpu())
        weights = {k: v.clone() for k, v in ref.state_dict().items()}
        kern = GDKVM(mcfg, device=device)
        kern.load_state_dict(weights)

        # One streamed chunk, state carried from a first one.
        x = frames.to(torch.float32) / 255.0
        _reset_counts()
        with torch.inference_mode():
            _, st_k = kern(x[:, :16])
            logits_k, st_k = kern(x[:, 16:], st_k)
            counts = _read_counts()
            _, st_p = ref(x[:, :16])
            logits_p, st_p = ref(x[:, 16:], st_p)
        if counts != dict(_ZERO, fwd_kernel=2):
            raise AssertionError(f"gdn2 stream counts {counts}")
        launches["fwd"] += 2
        agree = (mask_from_logits(logits_k) == mask_from_logits(logits_p)).float().mean().item()
        s_rel, l_rel = _rel(st_k.mem, st_p.mem), _rel(logits_k, logits_p)
        print(f"gdn2 [{dtype}] streamed chunk, kernel vs chunked: state max|Δ|/max "
              f"{s_rel:.3e}, logits max|Δ|/max {l_rel:.3e}, mask agreement {agree:.6f}")
        # In bf16 a GDR difference of ~5e-7 flips roundings downstream: the
        # masks of two forward splits agree on ~99.89% there (phase_serve),
        # these on 99.80% (measured on an H100).
        if not bool(torch.isfinite(logits_k).all()) or s_rel > 1e-4 \
                or agree < (0.9999 if dtype == "float32" else 0.995) \
                or (dtype == "float32" and l_rel > 1e-5):
            raise AssertionError(f"gdn2 [{dtype}] streamed chunk disagrees")

        # Two training steps per mode from the same weights and batch.
        runs = {}
        for mode in ("stored", "fused", "chunked"):
            os.environ["GDKVM_GDR_BWD"] = "stored" if mode == "chunked" else mode
            model = GDKVM(dataclasses.replace(mcfg, gdr_impl="chunked")
                          if mode == "chunked" else mcfg, device=device)
            model.load_state_dict(weights)
            state = state_for(cfg, model)
            _reset_counts()
            steps = [train_step(state, batch, cfg) for _ in range(2)]
            counts = _read_counts()
            want = dict(_ZERO, **{"chunked": {"plain_fwd": 2},
                                  "stored": {"fwd_kernel": 2, "residual_fwd": 2,
                                             "stored_bwd": 2},
                                  "fused": {"fwd_kernel": 2, "residual_fwd": 2,
                                            "bwd_kernel": 2}}[mode])
            if counts != want:
                raise AssertionError(f"gdn2 [{dtype} {mode}] counts {counts}, expected {want}")
            launches["residual"] += counts["residual_fwd"]
            launches["bwd"] += counts["bwd_kernel"]
            runs[mode] = [(m["loss"].item(), m["grad_norm"].item()) for m in steps]
            eta_g = state.opt.adamw.state[model.lkva.eta_proj.weight]["exp_avg"].abs().max().item()
            if not eta_g > 0:
                raise AssertionError(f"gdn2 [{dtype} {mode}] η projection got no gradient")
        os.environ.pop("GDKVM_GDR_BWD")
        bar = STEP_REL[dtype]
        for mode in ("stored", "fused"):
            worst = max(abs(a - b) / abs(b) for got, ref_ in zip(runs[mode], runs["chunked"])
                        for a, b in zip(got, ref_))
            print(f"gdn2 [{dtype}] 2 steps {mode} vs chunked: losses "
                  + " ".join(f"{l:.6f}" for l, _ in runs[mode]) + " grad norms "
                  + " ".join(f"{g:.6f}" for _, g in runs[mode])
                  + f"; worst relative difference {worst:.3e} (bar {bar:g})")
            if not worst <= bar:
                raise AssertionError(f"gdn2 [{dtype}] {mode} steps disagree with chunked")
    return launches


# Streaming eval, 8 streams in flight against one: other batch sizes take
# other cuDNN algorithms, which moves logits in their last bits and flips
# near-tied pixels of a random init (see SERVE_AGREE), so the Dice values
# agree to a bar and not bit for bit (the CPU tests hold them exactly).
STREAM_EVAL_DICE = {"float32": 1e-4, "bfloat16": 2e-2}


def phase_stream_eval(device) -> int:
    """``stream_evaluate`` on 8 synthetic videos of 64 frames at 112² in
    16-frame chunks, the ts8_112 model: one stream and 8 in flight.
    Returns the forward launches."""
    import dataclasses
    from gdkvm_tpu_torch.config.schema import ts8_112
    from gdkvm_tpu_torch.eval.streaming import stream_evaluate
    launches = 0
    for dtype in ("float32", "bfloat16"):
        model = _serve_model(device, dtype)
        cfg = ts8_112()
        cfg.model = dataclasses.replace(cfg.model, compute_dtype=dtype)
        out = {}
        for streams in (1, 8):
            _reset_counts()
            out[streams] = stream_evaluate(cfg, model, num_videos=8, video_len=64,
                                           streams=streams)
            counts = _read_counts()
            calls = (8 // streams) * 4 + 4          # the timed pass + the untimed one
            if counts != dict(_ZERO, fwd_kernel=calls):
                raise AssertionError(f"stream eval [{dtype}, {streams}] counts {counts}, "
                                     f"expected {calls} residual-free launches")
            launches += calls
            print(f"stream eval [{dtype}, streams={streams}]: "
                  f"{out[streams]['stream_frames_per_sec']:.1f} frames/s end to end, "
                  f"frames {out[streams]['frames']:.0f}, Dice "
                  + " ".join(f"{out[streams][f'dice_class{i}']:.6f}" for i in range(4))
                  + f" fg mean {out[streams]['dice_fg_mean']:.6f}")
        keys = [k for k in out[1] if k.startswith("dice")]
        worst = max(abs(out[1][k] - out[8][k]) for k in keys)
        bar = STREAM_EVAL_DICE[dtype]
        print(f"stream eval [{dtype}]: 8 streams vs 1, worst |ΔDice| {worst:.3e} (bar {bar:g})")
        if out[1]["frames"] != out[8]["frames"] or out[1]["frames"] != 8 * 64 \
                or not worst <= bar:
            raise AssertionError(f"stream eval [{dtype}]: 8 streams disagree with 1")
    return launches


# ---------------------------------------------------------------- the CLI

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIGS = os.path.join(REPO, "configs")
TS8_256 = os.path.join(CONFIGS, "gdkvm_ts8_256.yaml")
TS8_112 = os.path.join(CONFIGS, "gdkvm_ts8_112.yaml")
# Two forward routes of one model through the command line, by their Dice
# values; their masks, compared in-process, must agree on MASK_AGREE.
CLI_DICE = 2e-3
MASK_AGREE = 0.999
# Calls a row of `bench --mode modules --grad` (the command's default: 100).
GRAD_REPS = 25


def _cli(argv: list, rc: int = 0) -> list:
    """``gdkvm_tpu_torch.cli.main(argv)`` in this process, so that the
    kernels' launch counters can be read, with stdout captured → the JSON
    object of each line it printed.  A nonzero exit code, like any
    exception of the command, ends the run."""
    from gdkvm_tpu_torch.cli import main
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        got = main(list(argv))
    dt = time.perf_counter() - t0
    text = buf.getvalue().strip()
    if got != rc:
        raise AssertionError(f"cli {argv}: exit code {got}, expected {rc}; stdout {text!r}")
    lines = [json.loads(line) for line in text.splitlines()]
    print(f"cli [{' '.join(str(a) for a in argv if not os.path.isabs(str(a).split('=')[-1]))}]"
          f" -> {len(lines)} line(s) in {dt:.1f} s")
    return lines


def _module_env() -> dict:
    return dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))


def _expect_counts(what: str, want: dict) -> dict:
    counts = _read_counts()
    if counts != dict(_ZERO, **want):
        raise AssertionError(f"cli {what}: counts {counts}, expected {dict(_ZERO, **want)}")
    _reset_counts()
    return counts


def _cli_info_subprocess(name: str) -> None:
    """``python3 -m gdkvm_tpu_torch info --probe`` in a process of its own:
    the module entry and a cold import."""
    import torch
    res = subprocess.run([sys.executable, "-m", "gdkvm_tpu_torch", "info", "--config",
                          TS8_256, "--probe"], cwd=REPO, env=_module_env(),
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        raise AssertionError(f"python -m gdkvm_tpu_torch info: rc {res.returncode}: "
                             f"{res.stderr[-2000:]}")
    out = json.loads(res.stdout.strip().splitlines()[-1])
    print(f"cli info (subprocess): {json.dumps({k: v for k, v in out.items() if k != 'config'})}")
    if out["platform"] != "gpu" or out["devices"][0] != name \
            or out["cuda"] != torch.version.cuda or "device_roundtrip_ms" not in out \
            or out["config"]["model"]["enc_channels"] != [64, 64, 128, 192] \
            or out["config"]["train"]["batch_size"] != 8:
        raise AssertionError(f"info: {out}")



@contextlib.contextmanager
def _serve_subprocess(argv: list, err_path: str):
    """``python -m gdkvm_tpu_torch serve`` with ``argv`` (port 0) in a
    process of its own → its first stdout line (host, port, ...); on leaving
    the block, SIGINT, which must end it with exit code 0.  Its stderr goes
    to ``err_path``."""
    with open(err_path, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "gdkvm_tpu_torch", "serve", "--port", "0"] + argv,
            cwd=REPO, env=_module_env(), stdout=subprocess.PIPE, stderr=err, text=True)
    watchdog = threading.Timer(300, proc.kill)     # a server that never answers
    watchdog.start()
    try:
        line = proc.stdout.readline()
        if not line:
            raise AssertionError(f"serve printed nothing (rc {proc.wait()}): "
                                 f"{open(err_path).read()[-2000:]}")
        yield json.loads(line)
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=120)
        if rc != 0:
            raise AssertionError(f"serve ended with rc {rc}: {open(err_path).read()[-2000:]}")
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()


def _cli_serve_subprocess(tmp: str, smi: str) -> None:
    """``serve`` as a subprocess on port 0 (its first stdout line gives the
    port), ``serve-bench`` against it in this process, then SIGINT, which
    must end it with exit code 0."""
    from gdkvm_tpu_torch.serve import ServeClient
    err_path = os.path.join(tmp, "serve.err")
    with _serve_subprocess(["--config", TS8_112, "--streams", "8",
                            f"runtime.run_dir={os.path.join(tmp, 'none')}"],
                           err_path) as first:
        client = ServeClient(first["host"], first["port"])
        before = client.health()
        if before["device"] != "cuda:0" or first["streams"] != 8 or first["chunk"] != 16 \
                or first["image_size"] != 112:
            raise AssertionError(f"serve: {first}, /healthz {before}")
        bench = _cli(["serve-bench", "--port", str(first["port"]), "--sessions", "8",
                      "--frames", "256"])[-1]
        after = client.health()
        print(f"cli serve (subprocess, {before['device']}) + serve-bench on {smi}: "
              f"{json.dumps(bench)}; ticks {before['ticks']} -> {after['ticks']}")
        if bench["ok"] is not True or bench["frames_total"] != 8 * 256 \
                or not after["ticks"] > before["ticks"]:
            raise AssertionError(f"serve-bench: {bench}")
    if "UNTRAINED init" not in open(err_path).read():
        raise AssertionError("serve without a checkpoint gave no warning")



def _cli_serve_check_subprocess(art: str, smi: str) -> None:
    """``serve-check`` of an artifact in a process of its own, which loads
    it cold: its ``ok`` must be true."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "gdkvm_tpu_torch", "serve-check",
                          "--artifact", art], cwd=REPO, env=_module_env(),
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        raise AssertionError(f"serve-check: rc {res.returncode}: {res.stderr[-2000:]}")
    out = json.loads(res.stdout.strip().splitlines()[-1])
    print(f"cli serve-check (subprocess, {time.perf_counter() - t0:.1f} s with the "
          f"process's start) on {smi}: {json.dumps(out)}")
    if out["ok"] is not True or out["logits_shape"] != [1, 16, 256, 256, 4] \
            or out["frames_seen"] != [4 * 16]:
        raise AssertionError(f"serve-check: {out}")


def phase_cli(device, info: dict, roots: dict) -> dict:
    """The command-line main path: ``python -m gdkvm_tpu_torch <command>
    --config configs/<file>.yaml key=value``, through ``cli.main`` in this
    process (``info``, ``serve`` and ``serve-check`` as subprocesses), at the full
    width of the ts8 model, on the data ``phase_train_run`` wrote.  Every
    command's launches are counted; nothing here catches a failure.
    Returns the launches by kernel."""
    import numpy as np
    import torch
    from gdkvm_tpu_torch import cli
    from gdkvm_tpu_torch.config.schema import load_config
    from gdkvm_tpu_torch.eval.infer import load_frames
    from gdkvm_tpu_torch.eval.streaming import stream_video
    from gdkvm_tpu_torch.ops.preproc import resize_normalize, resize_u8
    t_phase = time.perf_counter()
    total = dict(_ZERO)

    def tally(what: str, want: dict) -> None:
        for key, n in _expect_counts(what, want).items():
            total[key] += n

    tmp = _scratch_dir("cli")
    name, smi = torch.cuda.get_device_name(0), info["smi"]

    _cli_info_subprocess(name)

    # pack the PNG layout (the run's packed split where PIL is absent).
    _reset_counts()
    if info["pil"]:
        pck = os.path.join(tmp, "pck")
        packed = _cli(["pack", "--config", TS8_256, "--out", pck,
                       f"data_path={roots['camus']}"])[-1]
        n_train, n_val = RUN_CLIPS["camus"]
        if packed["train"]["clips"] != n_train or packed["val"]["clips"] != n_val:
            raise AssertionError(f"pack: {packed}")
    else:
        pck, (n_train, n_val) = roots["packed"], RUN_CLIPS["packed"]
    run_dir = os.path.join(tmp, "run")
    base = ["--config", TS8_256, "data.dataset=packed", f"data_path={pck}",
            "eval_stage.wandb_mode=disabled", f"runtime.run_dir={run_dir}"]
    report = _cli(["validate-data"] + base)[-1]
    if not report["ok"] or report["splits"]["train"]["clips"] != n_train \
            or report["splits"]["val"]["frame_geometry"] != ["(256, 256, 1)"]:
        raise AssertionError(f"validate-data: {report}")
    tally("pack, validate-data", {})

    # train: one forward with residuals a step, the stored backward, two
    # eval passes of residual-free launches, no plain GDR call.
    steps = 12
    final = _cli(["train", "num_iterations=12", "train.eval_every=6",
                  "train.checkpoint_every=6", "train.log_every=2"] + base)[-1]["final"]
    tally("train", {"fwd_kernel": steps + 2 * n_val, "residual_fwd": steps,
                    "stored_bwd": steps})
    rows = _jsonl(run_dir)
    sps = [r["steps_per_sec"] for r in rows if "loss" in r and r["step"] >= 4]
    print(f"cli train on {smi}: {steps} steps of ts8_256 on {n_train} packed clips, steps/s by "
          f"log window from step 4 " + " ".join(f"{x:.3f}" for x in sps)
          + f" (median {statistics.median(sps):.3f}); loss {final['loss']:.4f}, eval Dice fg "
          f"{final['eval/dice_fg_mean']:.4f}")
    cfg = load_config(os.path.join(run_dir, "config.yaml"))
    if cfg != load_config(TS8_256, base[2:] + ["num_iterations=12", "train.eval_every=6",
                                               "train.checkpoint_every=6", "train.log_every=2"]) \
            or cfg.train.num_iterations != 12 or cfg.data.data_path != pck:
        raise AssertionError("config.yaml does not read back to the run's config")
    if sorted(os.listdir(os.path.join(run_dir, "checkpoints"))) != \
            ["step_00000006.pt", "step_00000012.pt"]:
        raise AssertionError("train: checkpoints")

    # The inference commands, each from the run's checkpoint: residual-free
    # launches only.
    scored = _cli(["eval"] + base)[-1]
    tally("eval", {"fwd_kernel": n_val})
    worst = max(abs(scored[k] - final["eval/" + k]) for k in scored)
    print(f"cli eval: {json.dumps(scored)}; worst |Δ| to the run's last eval {worst:.2e}")
    if scored["frames"] != n_val * 10 or worst > 1e-3:
        raise AssertionError(f"eval {scored} against the run's {final}")

    streamed = _cli(["stream-eval", "--streams", "8", "--video-len", "64"] + base)[-1]
    tally("stream-eval", {"fwd_kernel": 2 * 4})       # 4 chunks, two passes
    print(f"cli stream-eval --streams 8 on {smi}: {json.dumps(streamed)}")
    if streamed["frames"] != 8 * 64 or streamed["streams"] != 8.0:
        raise AssertionError(f"stream-eval: {streamed}")

    if info["pil"]:
        png = base + ["data.dataset=camus", f"data_path={roots['camus']}"]
        for protocol, key in (("camus", "dice_mean_overall"), ("camus-ef", "ef_mae")):
            res = _cli(["parity", "--protocol", protocol] + png)[-1]
            tally(f"parity {protocol}", {"fwd_kernel": 1})     # 4 clips: one padded batch
            print(f"cli parity --protocol {protocol}: {res['n_patients']} patients, "
                  f"{key} {res[key]:.4f}" + (f", HD95 in {res['hd95_units']}"
                                             if protocol == "camus" else ""))
            if res["n_patients"] != RUN_CLIPS["camus"][1] // 2 or not np.isfinite(res[key]):
                raise AssertionError(f"parity {protocol}: {res}")
    abl = _cli(["parity", "--ablate", "--ablate-videos", "1", "--ablate-video-len", "8"]
               + base)[-1]
    tally("parity --ablate", {"fwd_kernel": 8 * (8 + 8)})   # per frame, + untimed passes
    print("cli parity --ablate: memory deltas " + " ".join(
        f"{k[13:]} {v:+.4f}" for k, v in abl.items() if k.startswith("memory_delta")))
    if len(abl["conditions"]) != 8:
        raise AssertionError(f"ablation: {abl}")

    # infer: 40 frames at 300 x 280, resized on the device, chunks of 16.
    rng = np.random.default_rng(11)
    clip = rng.integers(0, 256, (40, 300, 280), np.uint8)
    if info["pil"]:
        from PIL import Image
        source = os.path.join(tmp, "frames")
        os.makedirs(source)
        for i, frame in enumerate(clip):
            Image.fromarray(frame).save(os.path.join(source, f"frame_{i:03d}.png"))
    else:
        from gdkvm_tpu_torch.data.camus_raw import write_mhd
        source = os.path.join(tmp, "frames.mhd")
        write_mhd(source, clip)
    out_dir = os.path.join(tmp, "infer")
    summary = _cli(["infer", "--input", source, "--out", out_dir, "--device-resize"]
                   + (["--overlay-every", "8"] if info["pil"] else []) + base)[-1]
    tally("infer", {"fwd_kernel": 3})
    masks = np.load(os.path.join(out_dir, "masks.npz"))["masks"]
    n_png = len(os.listdir(os.path.join(out_dir, "overlays"))) if info["pil"] else 0
    if masks.shape != (40, 256, 256) or masks.dtype != np.uint8 or summary["frames"] != 40 \
            or summary["overlays"] != n_png or (info["pil"] and n_png != 5):
        raise AssertionError(f"infer: {summary}, masks {masks.shape}")
    model, step = cli._load_model(load_config(TS8_256, base[2:]), None, device, "checking")
    frames = torch.from_numpy(clip[..., None]).to(device)
    with torch.inference_mode():
        state, want = None, []
        for lo in range(0, 48, 16):
            part = frames[lo:lo + 16]
            part = torch.cat([part, part.new_zeros((16 - len(part),) + part.shape[1:])])
            logits, state = model(resize_normalize(part[None], (256, 256)), state)
            want.append(logits[0].argmax(-1))
        want = torch.cat(want)[:40].cpu().numpy()
        rounded = stream_video(model, resize_u8(frames, (256, 256)).cpu().numpy(), chunk=16)
    agree, agree_u8 = float((masks == want).mean()), float((masks == rounded).mean())
    # The same file resized on the host: stream_video's own input.
    _reset_counts()
    _cli(["infer", "--input", source, "--out", out_dir + "_host"] + base)
    tally("infer, host resize", {"fwd_kernel": 3})
    host = np.load(os.path.join(out_dir + "_host", "masks.npz"))["masks"]
    agree_host = float((host == stream_video(model, load_frames(source, 256), chunk=16)).mean())
    print(f"cli infer (checkpoint step {step}): device-resized masks against the restored "
          f"model in this process {agree:.6f} (bar {MASK_AGREE}; against stream_video on "
          f"frames rounded to uint8 after the resize {agree_u8:.6f}, no bar: another "
          f"input); host-resized masks against stream_video {agree_host:.6f} (bar {MASK_AGREE})")
    if agree < MASK_AGREE or agree_host < MASK_AGREE:
        raise AssertionError("infer's masks differ from the restored model's")
    _reset_counts()

    # export of the checkpoint at batch 1 (tracing launches nothing);
    # serve-check in a process of its own; infer --artifact on the same
    # file, decoded at the artifact's size, against infer's masks.
    art = os.path.join(tmp, "artifact")
    exported = _cli(["export", "--out", art, "--batch", "1"] + base)[-1]
    tally("export", {})
    print(f"cli export: {json.dumps(exported)}")
    if exported["platforms"] != ["cuda"] or exported["signature"]["frames_u8"] != \
            [1, 16, 256, 256, 1]:
        raise AssertionError(f"export: {exported}")
    _cli_serve_check_subprocess(art, smi)
    _cli(["infer", "--input", source, "--out", out_dir + "_artifact", "--artifact", art]
         + base)
    tally("infer --artifact", {"fwd_kernel": 3})
    via_art = np.load(os.path.join(out_dir + "_artifact", "masks.npz"))["masks"]
    agree_art = float((via_art == host).mean()) if via_art.shape == host.shape else 0.0
    print(f"cli infer --artifact: masks {via_art.shape} against infer's from the "
          f"checkpoint {agree_art:.6f} (bar {MASK_AGREE})")
    if agree_art < MASK_AGREE:
        raise AssertionError("infer --artifact's masks differ from infer's")

    _cli_serve_subprocess(tmp, smi)
    tally("serve-bench (the server is another process)", {})

    # bench, at ts8 width.
    shapes = {"stream": ["--chunk", "32", "--batch", "8"], "latency": [],
              "train": ["--image-size", "256"], "modules": []}
    for mode, extra in shapes.items():
        res = _cli(["bench", "--mode", mode, "--config", TS8_256] + extra)[-1]
        print(f"cli bench --mode {mode} {' '.join(extra)} on {smi}: {json.dumps(res)}")
    # Depth cut that makes room for the artifact's steps (PERF.md): the train-step
    # breakdown over GRAD_REPS calls a row, not the command's 100.
    from gdkvm_tpu_torch.eval import modulebench
    full_breakdown = modulebench.grad_breakdown
    modulebench.grad_breakdown = functools.partial(full_breakdown, reps=GRAD_REPS)
    try:
        grad = _cli(["bench", "--mode", "modules", "--grad", "--config", TS8_256,
                     "--image-size", "256", "--chunk", "10", "--batch", "8"])[-1]
    finally:
        modulebench.grad_breakdown = full_breakdown
    print(f"cli bench --mode modules --grad on {smi}: {json.dumps(grad)}")
    if grad["_meta"]["clock"] != "cuda_events" or grad["_meta"]["device"] != name \
            or grad["_meta"]["reps"] != GRAD_REPS or not grad["lkva_gdr"]["flops_per_call"] > 0:
        raise AssertionError(f"modules --grad: {grad}")
    counts = _read_counts()
    if counts["plain_fwd"] or counts["plain_chain"] or counts["plain_bwd"] \
            or not (counts["fwd_kernel"] > counts["residual_fwd"] > 0) \
            or counts["stored_bwd"] != counts["residual_fwd"]:
        raise AssertionError(f"bench counts {counts}")
    for key, n in counts.items():
        total[key] += n
    # The same step through the backward kernel, and a stream through the
    # chain split: the two opt-in kernels from the command line.
    _reset_counts()
    os.environ["GDKVM_GDR_BWD"] = "fused"
    res = _cli(["bench", "--mode", "train", "--config", TS8_256, "--image-size", "256"])[-1]
    os.environ.pop("GDKVM_GDR_BWD")
    print(f"cli bench --mode train [GDKVM_GDR_BWD=fused] on {smi}: {json.dumps(res)}")
    tally("bench train, fused", {"fwd_kernel": 12, "residual_fwd": 12, "bwd_kernel": 12})
    os.environ["GDKVM_GDR_FWD"] = "chain"
    res = _cli(["bench", "--mode", "stream", "--config", TS8_256, "--chunk", "32",
                "--batch", "8"])[-1]
    os.environ.pop("GDKVM_GDR_FWD")
    print(f"cli bench --mode stream [GDKVM_GDR_FWD=chain] on {smi}: {json.dumps(res)}")
    tally("bench stream, chain", {"chain_kernel": 24})

    # sweep: two learning rates x 3 steps; no combo may carry an error.
    lines = _cli(["sweep", "learning_rate=1e-4,3e-4", "num_iterations=3", "train.eval_every=3",
                  "train.log_every=1", "train.checkpoint_every=100"] + base[:-1]
                 + [f"runtime.run_dir={os.path.join(tmp, 'sweep')}"])
    tally("sweep", {"fwd_kernel": 2 * (3 + n_val), "residual_fwd": 6, "stored_bwd": 6})
    if len(lines) != 3 or any("error" in r for r in lines[:2]) or lines[2]["runs"] != 2 \
            or lines[2]["sweep_best"] is None:
        raise AssertionError(f"sweep: {lines}")
    print(f"cli sweep: best {lines[2]['sweep_best']['overrides']} by {lines[2]['metric']}")
    law = _cli(["scale", "-N", "3e6", "-D", "2e9"])[-1]
    if not (0 < law["learning_rate"] < 1 and law["batch_size_tokens"] > 1):
        raise AssertionError(f"scale: {law}")

    # The two other documented models, their kernels' first run through a
    # model: H=2, d=48 at N=49, and H=6 at N=256; seeded init, fp32 compute,
    # the kernel route held to the plain chunked route.
    for label, path, image in (("rt_112 (H=2, d=48)", "gdkvm_rt_112.yaml", 112),
                               ("base_256 (H=6, N=256)", "gdkvm_base_256.yaml", 256)):
        argv = ["stream-eval", "--config", os.path.join(CONFIGS, path),
                "data.dataset=synthetic", "--num-videos", "2", "--video-len", "32",
                "model.compute_dtype=float32",
                f"runtime.run_dir={os.path.join(tmp, 'none')}"]
        kern = _cli(argv)[-1]
        tally(f"stream-eval {label}", {"fwd_kernel": 2 * 2 + 2})   # 2 videos + the untimed one
        plain = _cli(argv + ["model.gdr_impl=chunked"])[-1]
        _expect_counts(f"stream-eval {label}, chunked", {"plain_fwd": 6})
        worst = max(abs(kern[k] - plain[k]) for k in kern if k.startswith("dice"))
        mcfg = load_config(argv[2], argv[3:4] + argv[8:]).model
        video = torch.randint(0, 256, (32, image, image, 1), dtype=torch.uint8,
                              generator=torch.Generator().manual_seed(7)).numpy()
        masks = {}
        for impl in ("auto", "chunked"):
            m, _ = cli._load_model(load_config(argv[2], argv[3:4] + argv[8:]
                                               + [f"model.gdr_impl={impl}"]),
                                   None, device, "checking")
            masks[impl] = stream_video(m, video, chunk=16)
        agree = float((masks["auto"] == masks["chunked"]).mean())
        _reset_counts()
        print(f"cli stream-eval {label} on {smi}: kernel {json.dumps(kern)}; against "
              f"gdr_impl=chunked worst |ΔDice| {worst:.2e} (bar {CLI_DICE:g}), masks of a "
              f"32-frame video agree on {agree:.6f} (bar {MASK_AGREE}); heads "
              f"{mcfg.num_heads}, d_k {mcfg.head_dim_k}")
        if worst > CLI_DICE or agree < MASK_AGREE or kern["frames"] != 64:
            raise AssertionError(f"{label}: the kernel route disagrees with the chunked one")

    print(f"cli main path: counts {total}; {time.perf_counter() - t_phase:.1f} s in all")
    if not (total["fwd_kernel"] > total["residual_fwd"] > 0 and total["bwd_kernel"] > 0
            and total["chain_kernel"] > 0) or total["plain_fwd"] or total["plain_bwd"]:
        raise AssertionError(f"cli path counts {total}")
    return {"fwd": total["fwd_kernel"] - total["residual_fwd"],
            "residual": total["residual_fwd"], "bwd": total["bwd_kernel"],
            "chain": total["chain_kernel"], "base": base, "source": source}


# ------------------------------------------------------------- mount day

GDKVM_01 = os.path.join(CONFIGS, "config_gdkvm_01.yaml")
ECHONET_STREAM = os.path.join(CONFIGS, "echonet_stream.yaml")
# Raw CAMUS as it ships: half-sequences of 20 frames at 320 x 288 (rows x
# columns; the converter resamples both axes to 256), anisotropic
# ElementSpacing (x, y, z) in mm, official patient numbers (1-400 train,
# 401-450 val): 8 train clips, one batch of 8, and 2 val patients, one per
# fold of --folds 2.
MOUNT_RAW = (20, 320, 288)
MOUNT_SPACING = (0.308, 0.154, 1.0)
MOUNT_PATIENTS = {"train": (1, 2, 3, 4), "val": (401, 402)}
MOUNT_STEPS = {"camus": 24, "echonet": 6}
# EchoNet: MJPG AVIs of 64 frames at 112², 30 and 50 fps in turn.
MOUNT_ECHONET = dict(num_train=8, num_val=2, num_frames=64, image_size=112,
                     fps_cycle=(30.0, 50.0), seed=3)
# The card against the CPU on one checkpoint, both in fp32: each Dice cell
# (mean over the fold's patients) within MOUNT_DICE, each biplane volume
# (mL) within MOUNT_VOLUME_REL of the CPU's.  HD95 is held only as finite:
# one flipped boundary pixel moves it.
MOUNT_DICE = 1e-3
MOUNT_VOLUME_REL = 1e-3


def _write_raw_camus(raw: str) -> int:
    """Both views of each MOUNT_PATIENTS patient, image and ``_gt``, as
    MetaImage .mhd/.raw half-sequences at MOUNT_SPACING, frames from
    ``generate_clip`` → the number of clips."""
    from gdkvm_tpu_torch.data.camus_raw import write_mhd
    from gdkvm_tpu_torch.data.synthetic import generate_clip
    t, h, w = MOUNT_RAW
    numbers = MOUNT_PATIENTS["train"] + MOUNT_PATIENTS["val"]

    def one(seed_num):
        seed, num = seed_num
        pat = f"patient{num:04d}"
        os.makedirs(os.path.join(raw, pat))
        for v, view in enumerate(("2CH", "4CH")):
            frames, masks = generate_clip(2 * seed + v, t, h, w, num_classes=4)
            stem = os.path.join(raw, pat, f"{pat}_{view}_half_sequence")
            write_mhd(stem + ".mhd", frames[..., 0], spacing=MOUNT_SPACING)
            write_mhd(stem + "_gt.mhd", masks, spacing=MOUNT_SPACING)
    with ThreadPoolExecutor(max_workers=len(numbers)) as pool:
        list(pool.map(one, enumerate(numbers)))
    return 2 * len(numbers)


def _fold_cells(folds: dict) -> dict:
    """{(fold, view, structure, phase): cell} of a ``parity --folds``
    result."""
    return {(r["fold"], view, name, phase): cell
            for r in folds["per_fold"] for view, names in r["per_structure"].items()
            for name, phases in names.items() for phase, cell in phases.items()}


def phase_mount_day(device, info: dict) -> dict:
    """The raw-data chain of the mount-day runbook (docs/REPRODUCE.md,
    "Mount day") on the card, through ``cli.main`` in this process with
    ``--device cuda`` and every launch counted (``serve`` a subprocess),
    from raw files written here from a seed:

    CAMUS: .mhd/.raw half-sequences → ``convert-camus --split-mode
    official`` at its defaults (256², 10 frames) → ``validate-data`` →
    ``train`` with ``configs/config_gdkvm_01.yaml`` at its model widths
    (enc 32-64-96-128, H=4, d=64, bf16, batch 8) → ``parity --protocol
    camus --folds 2`` (HD95 in mm), ``--protocol camus-ef`` (volumes in
    mL), ``--ablate`` → ``export --chunk 16 --batch 8`` → ``serve
    --artifact`` (8 streams, chunk 16) with ``serve-bench --sessions 8``;
    then ``parity --protocol camus --folds 2`` and ``camus-ef`` of the same
    checkpoint in fp32 with ``--device cuda`` and ``--device cpu``, the
    Dice cells and volumes held within MOUNT_DICE and MOUNT_VOLUME_REL.

    EchoNet: MJPG AVIs at 112², FileList.csv at 30 and 50 fps,
    VolumeTracings.csv → ``validate-data`` → ``train`` with
    ``configs/echonet_stream.yaml`` (2 classes, clip 16, occlude_prob 0.5;
    at 112² training takes the plain chunked GDR, as the JAX package's
    does: the one plain route of the phase, counted) → ``parity --protocol
    echonet-ef --split VAL``, each video scored at its own frame rate.

    Cuts, none of a width: 6 CAMUS patients (4 train, 2 val) of 20 frames
    at 320 x 288; 24 training steps (one eval stage and one checkpoint, at
    step 24); ``--folds 2``, not 10; the ablation on 1 video of 8 frames;
    ``serve-bench`` at its default 256 frames a session; 10 EchoNet videos
    (8 train, 2 val) of 64 frames and 6 training steps; the wandb mirror
    off (``eval_stage.wandb_mode=disabled``) in both runs.  Returns the
    forward kernel's launches."""
    import math
    import numpy as np
    from gdkvm_tpu_torch.config.schema import load_config
    from gdkvm_tpu_torch.data.echonet import materialize_synthetic_echonet
    from gdkvm_tpu_torch.serve import ServeClient
    t_phase = time.perf_counter()
    total = dict(_ZERO)

    def tally(what: str, want: dict) -> None:
        for key, n in _expect_counts(what, want).items():
            total[key] += n

    tmp = _scratch_dir("mount")
    smi, on = info["smi"], ["--device", "cuda"]
    _reset_counts()

    # 1. raw CAMUS → the processed layout, official split.
    raw = os.path.join(tmp, "camus_raw")
    t0 = time.perf_counter()
    n_clips = _write_raw_camus(raw)
    print(f"mount day: raw CAMUS written, {n_clips} .mhd half-sequences + _gt of "
          f"{MOUNT_RAW[0]} x {MOUNT_RAW[1]} x {MOUNT_RAW[2]} at {MOUNT_SPACING} mm in "
          f"{time.perf_counter() - t0:.1f} s")
    processed = os.path.join(tmp, "camus_png256x256_10f")
    conv = _cli(["convert-camus", "--raw", raw, "--out", processed,
                 "--split-mode", "official"])[-1]
    n_train, n_val = (2 * len(MOUNT_PATIENTS[s]) for s in ("train", "val"))
    with open(os.path.join(processed, "val", "patient0401_2CH", "meta.json")) as fh:
        meta = json.load(fh)
    _, h, w = MOUNT_RAW
    want_mm = [MOUNT_SPACING[1] * h / 256, MOUNT_SPACING[0] * w / 256]
    print(f"mount day: convert-camus rc 0: {conv['clips_written']} clips; sidecar "
          f"spacing_mm {meta['spacing_mm']} (from {meta['orig_spacing_mm']} at "
          f"{meta['orig_size']})")
    if conv["clips_written"] != n_clips or meta["size"] != [256, 256] \
            or meta["orig_size"] != [h, w] \
            or not np.allclose(meta["spacing_mm"], want_mm, rtol=1e-12) \
            or sorted(os.listdir(os.path.join(processed, "train"))) != sorted(
                f"patient{p:04d}_{v}" for p in MOUNT_PATIENTS["train"] for v in ("2CH", "4CH")):
        raise AssertionError(f"convert-camus: {conv}, meta {meta}")

    run_dir = os.path.join(tmp, "camus_run")
    base = ["--config", GDKVM_01, f"data_path={processed}", f"runtime.run_dir={run_dir}",
            "eval_stage.wandb_mode=disabled"]
    report = _cli(["validate-data"] + base)[-1]
    print(f"mount day: validate-data rc 0: ok {report['ok']}, clips "
          f"{report['splits']['train']['clips']} train / {report['splits']['val']['clips']} "
          f"val, geometry {report['splits']['val']['frame_geometry']}")
    if not report["ok"] or report["splits"]["train"]["clips"] != n_train \
            or report["splits"]["val"]["clips"] != n_val \
            or report["splits"]["train"]["frame_geometry"] != ["(256, 256, 1)"]:
        raise AssertionError(f"validate-data: {report}")
    tally("convert-camus, validate-data", {})

    # 2. train the recipe: one forward with residuals a step, the stored
    # backward, one eval pass of residual-free launches (eval batch 1).
    steps = MOUNT_STEPS["camus"]
    cadence = [f"num_iterations={steps}", f"train.log_every={steps // 6}",
               f"train.eval_every={steps}", f"train.checkpoint_every={steps}"]
    t0 = time.perf_counter()
    final = _cli(["train"] + on + cadence + base)[-1]["final"]
    train_s = time.perf_counter() - t0
    tally("mount-day train", {"fwd_kernel": steps + n_val, "residual_fwd": steps,
                              "stored_bwd": steps})
    cfg = load_config(os.path.join(run_dir, "config.yaml"))
    rows = _jsonl(run_dir)
    sps = [r["steps_per_sec"] for r in rows if "loss" in r and r["step"] > steps // 6]
    ckpts = sorted(os.listdir(os.path.join(run_dir, "checkpoints")))
    print(f"mount day: train rc 0 on {smi}: {steps} steps of config_gdkvm_01 (enc "
          f"{list(cfg.model.enc_channels)}, H {cfg.model.num_heads}, d "
          f"{cfg.model.head_dim_k}, {cfg.model.compute_dtype}, batch "
          f"{cfg.train.batch_size}, device_cache {cfg.data.device_cache}) in "
          f"{train_s:.1f} s; steps/s by log window " + " ".join(f"{x:.3f}" for x in sps)
          + f" (median {statistics.median(sps):.3f}); loss {final['loss']:.4f}, eval Dice "
          f"fg {final['eval/dice_fg_mean']:.4f}; checkpoints {ckpts}")
    recipe = load_config(GDKVM_01)
    if not math.isfinite(final["loss"]) or ckpts != [f"step_{steps:08d}.pt"] \
            or [r["step"] for r in rows if "eval/dice_fg_mean" in r] != [steps] \
            or cfg.model != recipe.model or cfg.train.batch_size != recipe.train.batch_size \
            or cfg.data.image_size != 256:
        raise AssertionError(f"mount-day train: {final}, {ckpts}")

    # 3. parity of the checkpoint: HD95 in mm over 2 folds, EF in mL, the
    # ablation.  Each fold holds one patient: its 2 clips, one padded batch.
    t0 = time.perf_counter()
    folds = _cli(["parity"] + on + ["--protocol", "camus", "--folds", "2"] + base)[-1]
    folds_s = time.perf_counter() - t0
    tally("parity camus --folds 2", {"fwd_kernel": 2})
    print(f"mount day: parity --protocol camus --folds 2 rc 0 in {folds_s:.1f} s: Dice "
          f"{folds['dice_mean_overall']:.4f}, HD95 {folds['hd95_mean_overall']:.2f} "
          f"{folds['hd95_units']}, {folds['n_folds_scored']} folds")
    if folds["hd95_units"] != "mm" or folds["folds"] != 2 or len(folds["per_fold"]) != 2 \
            or not math.isfinite(folds["dice_mean_overall"]) \
            or not math.isfinite(folds["hd95_mean_overall"]):
        raise AssertionError(f"parity camus --folds 2: {folds}")
    t0 = time.perf_counter()
    ef = _cli(["parity"] + on + ["--protocol", "camus-ef"] + base)[-1]
    ef_s = time.perf_counter() - t0
    tally("parity camus-ef", {"fwd_kernel": 1})
    print(f"mount day: parity --protocol camus-ef rc 0 in {ef_s:.1f} s: volumes in "
          f"{ef['volume_units']}, " + "; ".join(
              f"{r['patient']} EF {r['ef_pred']:.2f} (ref {r['ef_ref']:.2f}) V_ED "
              f"{r.get('v_ed_ml', float('nan')):.3f} mL" for r in ef["per_patient"]))
    if ef["n_patients"] != len(MOUNT_PATIENTS["val"]) or ef["volume_units"] != "mL" \
            or not all("v_ed_ml" in r and "v_es_ml" in r for r in ef["per_patient"]):
        raise AssertionError(f"parity camus-ef: {ef}")
    abl = _cli(["parity"] + on + ["--ablate", "--ablate-videos", "1",
                                  "--ablate-video-len", "8"] + base)[-1]
    tally("parity --ablate", {"fwd_kernel": 8 * (8 + 8)})   # per frame, + untimed passes
    print("mount day: parity --ablate rc 0: memory deltas " + " ".join(
        f"{k[13:]} {v:+.4f}" for k, v in abl.items() if k.startswith("memory_delta")))
    if len(abl["conditions"]) != 8:
        raise AssertionError(f"ablation: {abl}")

    # 4. the card against the CPU on the same checkpoint, fp32 on both.
    fp32 = base + ["model.compute_dtype=float32"]
    got = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        got[dev] = (_cli(["parity", "--device", dev, "--protocol", "camus", "--folds", "2"]
                         + fp32)[-1],
                    _cli(["parity", "--device", dev, "--protocol", "camus-ef"] + fp32)[-1])
        print(f"mount day: parity camus --folds 2 + camus-ef in fp32, --device {dev}: "
              f"{time.perf_counter() - t0:.1f} s")
        if dev == "cuda":
            tally("parity in fp32 on the card", {"fwd_kernel": 3})
        else:   # the CPU's scan is the plain one: not a launch on the card
            counts = _read_counts()
            if counts != dict(_ZERO, plain_fwd=3):
                raise AssertionError(f"parity on the CPU: counts {counts}")
            _reset_counts()
    cells = {dev: _fold_cells(g[0]) for dev, g in got.items()}
    if set(cells["cuda"]) != set(cells["cpu"]) or not cells["cpu"]:
        raise AssertionError(f"Dice cells: {sorted(cells['cuda'])} vs {sorted(cells['cpu'])}")
    worst_dice = max(abs(cells["cuda"][k]["dice_mean"] - cells["cpu"][k]["dice_mean"])
                     for k in cells["cpu"])
    same_n = all(cells["cuda"][k]["n"] == cells["cpu"][k]["n"] for k in cells["cpu"])
    hd95 = {dev: {k: c.get("hd95_mean", float("nan")) for k, c in cells[dev].items()}
            for dev in cells}
    vols = [(a[key], b[key]) for a, b in zip(got["cuda"][1]["per_patient"],
                                              got["cpu"][1]["per_patient"])
            for key in ("v_ed_ml", "v_es_ml")]
    worst_vol = max(abs(a - b) / abs(b) for a, b in vols)
    print(f"mount day: card against CPU on {smi}, checkpoint step {steps}, fp32: "
          f"{len(cells['cpu'])} Dice cells, worst |ΔDice| {worst_dice:.2e} (bar "
          f"{MOUNT_DICE:g}); {len(vols)} volumes, worst relative Δ {worst_vol:.2e} (bar "
          f"{MOUNT_VOLUME_REL:g}); EF card " + " ".join(
              f"{r['ef_pred']:.3f}" for r in got["cuda"][1]["per_patient"]) + " CPU "
          + " ".join(f"{r['ef_pred']:.3f}" for r in got["cpu"][1]["per_patient"]))
    print("mount day: HD95 (mm), card | CPU: " + "; ".join(
        f"{'/'.join(str(x) for x in k)} {hd95['cuda'][k]:.3f} | {hd95['cpu'][k]:.3f}"
        for k in sorted(hd95["cpu"])))
    if worst_dice > MOUNT_DICE or not same_n or worst_vol > MOUNT_VOLUME_REL \
            or any(g[0]["hd95_units"] != "mm" or g[1]["volume_units"] != "mL"
                   for g in got.values()) \
            or not all(math.isfinite(v) for d in hd95.values() for v in d.values()):
        raise AssertionError("the card's parity disagrees with the CPU's")

    # 5. export at batch 8 x chunk 16 (tracing launches nothing), serve the
    # artifact in a process of its own, serve-bench with 8 sessions.
    art = os.path.join(tmp, "artifact")
    t0 = time.perf_counter()
    exported = _cli(["export"] + on + ["--out", art, "--chunk", "16", "--batch", "8"]
                    + base)[-1]
    tally("export", {})
    print(f"mount day: export rc 0 in {time.perf_counter() - t0:.1f} s: "
          f"{json.dumps(exported['signature'])}, {exported['blob_bytes']} bytes")
    if exported["platforms"] != [device.type] \
            or exported["signature"]["frames_u8"] != [8, 16, 256, 256, 1]:
        raise AssertionError(f"export: {exported}")
    err_path = os.path.join(tmp, "serve.err")
    t0 = time.perf_counter()
    with _serve_subprocess(on + ["--artifact", art, "--streams", "8", "--chunk", "16"]
                           + base, err_path) as first:
        client = ServeClient(first["host"], first["port"])
        before = client.health()
        if before["num_classes"] != 4 or not before["device"].startswith(device.type) \
                or (first["streams"], first["chunk"], first["image_size"]) != (8, 16, 256):
            raise AssertionError(f"serve --artifact: {first}, /healthz {before}")
        bench = _cli(["serve-bench", "--port", str(first["port"]), "--sessions", "8"])[-1]
        after = client.health()
        print(f"mount day: serve --artifact (subprocess, {before['device']}) + serve-bench "
              f"--sessions 8 rc 0 on {smi}: {json.dumps(bench)}; ticks {before['ticks']} -> "
              f"{after['ticks']}")
        if bench["ok"] is not True or bench["frames_total"] != 8 * 256 \
                or not after["ticks"] > before["ticks"]:
            raise AssertionError(f"serve-bench: {bench}")
    print(f"mount day: serve --artifact subprocess, start to exit: "
          f"{time.perf_counter() - t0:.1f} s")
    tally("serve-bench (the server is another process)", {})

    # 6. EchoNet: AVIs at two frame rates → validate → train → echonet-ef.
    echo = os.path.join(tmp, "echonet")
    t0 = time.perf_counter()
    materialize_synthetic_echonet(echo, **MOUNT_ECHONET)
    print(f"mount day: EchoNet layout written in {time.perf_counter() - t0:.1f} s: "
          f"{MOUNT_ECHONET['num_train']} + {MOUNT_ECHONET['num_val']} MJPG AVIs of "
          f"{MOUNT_ECHONET['num_frames']} frames at {MOUNT_ECHONET['image_size']}², fps "
          f"{MOUNT_ECHONET['fps_cycle']}")
    erun = os.path.join(tmp, "echonet_run")
    ebase = ["--config", ECHONET_STREAM, f"data_path={echo}", f"runtime.run_dir={erun}",
             "eval_stage.wandb_mode=disabled"]
    report = _cli(["validate-data"] + ebase)[-1]
    n_videos = MOUNT_ECHONET["num_train"] + MOUNT_ECHONET["num_val"]
    print(f"mount day: validate-data (EchoNet) rc 0: ok {report['ok']}, clips "
          f"{report['splits']['train']['clips']} train, EF labels "
          f"{report['splits']['val']['ef_labels']}, geometry "
          f"{report['splits']['train']['frame_geometry']}")
    if not report["ok"] or report["splits"]["train"]["clips"] != MOUNT_ECHONET["num_train"] \
            or report["splits"]["val"]["ef_labels"] != n_videos \
            or report["splits"]["train"]["frame_geometry"] != ["(112, 112, 1)"]:
        raise AssertionError(f"validate-data (EchoNet): {report}")
    tally("validate-data (EchoNet)", {})
    steps = MOUNT_STEPS["echonet"]
    t0 = time.perf_counter()
    final = _cli(["train"] + on + [f"num_iterations={steps}", "train.log_every=2",
                                   f"train.eval_every={steps}",
                                   f"train.checkpoint_every={steps}"] + ebase)[-1]["final"]
    echo_train_s = time.perf_counter() - t0
    ecfg = load_config(os.path.join(erun, "config.yaml"))
    # 112²: the chunked GDR under autograd a step, and in the eval pass
    # (one val video a batch), as the JAX package trains at this size.
    tally("EchoNet train", {"plain_fwd": steps + MOUNT_ECHONET["num_val"]})
    print(f"mount day: train (EchoNet) rc 0 on {smi}: {steps} steps of echonet_stream "
          f"(clip {ecfg.data.clip_len}, occlude_prob {ecfg.data.occlude_prob}, "
          f"{ecfg.model.num_classes} classes) in {echo_train_s:.1f} s; loss "
          f"{final['loss']:.4f}, eval Dice fg {final['eval/dice_fg_mean']:.4f}")
    if not math.isfinite(final["loss"]) or ecfg.data.occlude_prob != 0.5 \
            or ecfg.data.clip_len != 16 or ecfg.model.num_classes != 2 \
            or sorted(os.listdir(os.path.join(erun, "checkpoints"))) != [f"step_{steps:08d}.pt"]:
        raise AssertionError(f"EchoNet train: {final}")
    t0 = time.perf_counter()
    res = _cli(["parity"] + on + ["--protocol", "echonet-ef", "--split", "VAL"] + ebase)[-1]
    per_chunk = math.ceil(MOUNT_ECHONET["num_frames"] / ecfg.eval_stage.stream_chunk)
    tally("parity echonet-ef", {"fwd_kernel": MOUNT_ECHONET["num_val"] * per_chunk})
    fps = MOUNT_ECHONET["fps_cycle"]
    want_fps = [fps[(MOUNT_ECHONET["num_train"] + i) % len(fps)]
                for i in range(MOUNT_ECHONET["num_val"])]
    print(f"mount day: parity --protocol echonet-ef rc 0 in {time.perf_counter() - t0:.1f} s: "
          + "; ".join(f"{r['video']} {r.get('fps')} fps, {r['beats']} beats, ED/ES frames "
                      f"{r['frame_ed']}/{r['frame_es']}, EF {r['ef_pred']:.2f} (label "
                      f"{r.get('ef_true', float('nan')):.2f})" for r in res["per_video"])
          + f"; EF MAE {res.get('ef_mae', float('nan')):.3f}")
    if res["n_videos"] != MOUNT_ECHONET["num_val"] or res["n_scored"] != res["n_videos"] \
            or [r.get("fps") for r in res["per_video"]] != want_fps \
            or not all(math.isfinite(r["ef_pred"]) for r in res["per_video"]) \
            or not math.isfinite(res["ef_mae"]):
        raise AssertionError(f"parity echonet-ef: {res}")

    print(f"mount day: counts {total}; {time.perf_counter() - t_phase:.1f} s in all")
    if not total["fwd_kernel"] > total["residual_fwd"] > 0 \
            or total["plain_fwd"] != steps + MOUNT_ECHONET["num_val"] \
            or total["plain_chain"] or total["plain_bwd"] or total["chain_kernel"] \
            or total["bwd_kernel"]:
        raise AssertionError(f"mount-day counts {total}")
    return {"fwd": total["fwd_kernel"] - total["residual_fwd"],
            "residual": total["residual_fwd"]}


# ------------------------------------------------------ W8A8 and gdr_assoc

# gdr_assoc against gdr_chunked on the card, fp32 (TF32 off): o, s_T and
# every gradient as max|Δ| over max| |.  The two sum in other orders (the
# scan composes T maps by log-depth products); measured on the CPU ≤ 1e-6.
ASSOC_REL = 1e-4


def _only_forward_launches(what: str) -> int:
    """The forward kernel's residual-free launches since the last reset (then
    reset), and a raise where anything else ran or nothing did."""
    counts = _read_counts()
    if counts["fwd_kernel"] < 1 or counts != dict(_ZERO, fwd_kernel=counts["fwd_kernel"]):
        raise AssertionError(f"{what}: counts {counts}, expected forward launches only")
    _reset_counts()
    return counts["fwd_kernel"]


def _device_kernels(fn, iters: int = 3, top: int = 10) -> str:
    """Where a call of ``fn()`` spends device time, by torch.profiler over
    ``iters`` calls after one: the device ms and kernels a call, and the
    ``top`` kernels by time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    agg = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            agg[e.name][0] += e.time_range.elapsed_us() / iters / 1e3
            agg[e.name][1] += 1
    rows = sorted(agg.items(), key=lambda kv: -kv[1][0])
    total = sum(ms for ms, _ in agg.values())
    return (f"{total:.4f} ms of device time a call in {sum(c for _, c in agg.values()) // iters}"
            f" kernels; top: " + "; ".join(f"{name[:70]} {ms:.4f} ms x{c // iters}"
                                           for name, (ms, c) in rows[:top]))


def _check_convs_bit_equal(qm, clip, label: str) -> None:
    """Every eligible conv of the W8A8 model ``qm``, on the inputs it gets
    in a forward of ``clip`` on the card, against the same W8A8 conv on the
    CPU: bit for bit."""
    import torch
    from gdkvm_tpu_torch.ops import quant
    convs = quant.eligible_convs(qm)
    seen = []
    hooks = [conv.register_forward_hook(
        lambda mod, args, out, p=path: seen.append((p, mod, args[0], out)))
        for path, conv in convs.items()]
    try:
        with torch.inference_mode():
            qm(clip)
    finally:
        for h in hooks:
            h.remove()
    for path, mod, x, out in seen:
        want = quant.int8_conv(
            x.cpu(), mod.qweight.cpu(), mod.qdeq.cpu(), mod.act_scale,
            ksize=mod.ksize, stride=mod.stride,
            bias=None if mod.bias is None else mod.bias.detach().cpu(),
            out_dtype=mod.dtype)
        if out.dtype != want.dtype or not torch.equal(out.cpu(), want):
            raise AssertionError(f"W8A8 conv {path} [{label}]: the card differs from the "
                                 f"CPU by {_abs(out.cpu().float(), want.float()):.3e}")
    paths = {p for p, *_ in seen}
    if paths != set(convs):
        raise AssertionError(f"{label}: convs that did not run W8A8: {set(convs) - paths}")
    rows = sorted({(x.shape[0] * out.shape[2] * out.shape[3], x.shape[1] * m.ksize ** 2,
                    out.shape[1]) for _, m, x, out in seen})
    print(f"quant [{label}]: {len(seen)} W8A8 conv calls ({len(paths)} convs) on the card "
          f"bit-equal to the CPU; int8 products (M, K, N) from {rows[0]} to {rows[-1]}")


def phase_quant_model(device, info: dict) -> dict:
    """W8A8 on the ts8 model at full width, seeded weights, bf16, at
    quant_ab's shapes (eval/regression.py: 112², 2 classes; 256², 4
    classes): calibration with absmax and percentile on seeded clips (scope
    "all": every eligible conv); every eligible conv of each W8A8 model on
    the card against the CPU, bit for bit; the W8A8 masks against the bf16
    model's; where each forward spends device time (torch.profiler).  The
    times and peak memory of both forwards are quant_ab's, in
    ``phase_bench_all``.  Returns the forward launches of the calibration
    and W8A8 forwards (the profiled calls are not counted)."""
    import torch
    from gdkvm_tpu_torch.eval.metrics import mask_from_logits
    from gdkvm_tpu_torch.eval.regression import QUANT_SHAPES, arm_config
    from gdkvm_tpu_torch.models.gdkvm import GDKVM, init_params
    from gdkvm_tpu_torch.ops import quant

    launches = 0
    for name, ncls, size, chunk, batch in QUANT_SHAPES:
        model = init_params(GDKVM(arm_config("ts8", ncls), device=device),
                            torch.Generator().manual_seed(0)).eval()
        gen = torch.Generator().manual_seed(1)
        calib = [torch.rand((1, 4, size, size, 1), generator=gen) for _ in range(2)]
        _reset_counts()
        tables = {}
        for method in ("absmax", "percentile"):
            t0 = time.perf_counter()
            with torch.inference_mode():
                tables[method] = quant.calibrate_act_scales(model, calib, scope="all",
                                                            method=method)
            print(f"quant [{name}] calibrate {method}: {len(tables[method])} convs in "
                  f"{time.perf_counter() - t0:.2f} s; stem scale "
                  f"{tables[method]['encoder/Conv_0']:.4f}")
            if sorted(tables[method]) != sorted(quant.eligible_convs(model)):
                raise AssertionError(f"calibration {method} misses an eligible conv")
        qmodels = {m: quant.w8a8_model(model, t) for m, t in tables.items()}
        clip = torch.rand((1, 8, size, size, 1), generator=gen).to(device)
        for method, qm in qmodels.items():
            _check_convs_bit_equal(qm, clip, f"{name}, {method}")
        frames = torch.rand((batch, chunk, size, size, 1), generator=gen).to(device)
        with torch.inference_mode():
            lf, _ = model(frames)
            agree = {}
            for method, qm in qmodels.items():
                lq, state = qm(frames)
                if not (bool(torch.isfinite(lq).all()) and bool(torch.isfinite(state.mem).all())):
                    raise AssertionError(f"W8A8 {name} {method}: non-finite output")
                agree[method] = (mask_from_logits(lq) == mask_from_logits(lf)
                                 ).to(torch.float32).mean().item()
        launches += _only_forward_launches(f"quant model {name}")
        print(f"quant [{name}]: W8A8 masks against the bf16 model's (seeded random "
              f"weights, {batch} x {chunk} frames): " + ", ".join(
                  f"{m} {a:.6f}" for m, a in agree.items()))
        qm = qmodels["percentile"]
        with torch.inference_mode():
            profiles = {"bf16": _device_kernels(lambda: model(frames)),
                        "W8A8": _device_kernels(lambda: qm(frames))}
        _reset_counts()
        for label, text in profiles.items():
            print(f"quant [{name}] {label} forward of {batch} x {chunk} frames on "
                  f"{info['smi']}, torch.profiler: {text}")
    return {"fwd": launches}


def phase_assoc(device, info: dict) -> dict:
    """``gdr_assoc`` (the log-depth scan, plain torch) against
    ``gdr_chunked`` on the card, fp32: o, s_T and every input's gradient
    within ASSOC_REL of their largest at the serving, streaming and
    training shapes; both forwards timed in turns without a gradient."""
    import torch
    from gdkvm_tpu_torch.core import gdr
    gen = torch.Generator(device=device).manual_seed(3)
    out = {}
    for label, shape in (("serving T=16", SERVE_SHAPE), ("streaming T=32", (8, 4, 32, 49, 64, 64)),
                         ("training", TRAIN_SHAPE)):
        args = _gdr_inputs(gen, *shape, torch.float32, device)
        res = {}
        for fn in (gdr.gdr_assoc, gdr.gdr_chunked):
            xs = [a.clone().requires_grad_(True) for a in args]
            o, s = fn(*xs)
            cot = torch.Generator(device=device).manual_seed(4)
            wo = torch.randn(o.shape, device=device, generator=cot)
            ws = torch.randn(s.shape, device=device, generator=cot)
            grads = torch.autograd.grad((o * wo).sum() + (s * ws).sum(), xs)
            res[fn.__name__] = (o.detach(), s.detach()) + tuple(grads)
        worst = max(_rel(a, b) for a, b in zip(res["gdr_assoc"], res["gdr_chunked"]))
        with torch.inference_mode():
            assoc_ms, chunked_ms, spread = _in_turns(lambda: gdr.gdr_chunked(*args),
                                                     lambda: gdr.gdr_assoc(*args), iters=10)
        out[label] = {"assoc_ms": assoc_ms, "chunked_ms": chunked_ms, "worst_rel": worst}
        spread = spread.replace("kernel", "assoc").replace("plain", "chunked")
        print(f"gdr_assoc [{label} {shape}] against gdr_chunked, fp32: worst max|Δ|/max| | "
              f"over o, s_T and 6 gradients {worst:.3e} (bar {ASSOC_REL:g}); forward "
              f"{assoc_ms:.4f} ms against {chunked_ms:.4f} on {info['smi']} ({spread})")
        if not worst <= ASSOC_REL:
            raise AssertionError(f"gdr_assoc {label}: {worst} > {ASSOC_REL}")
    return out


def _serve_w8a8_session(base: list, scales: str, video, smi: str):
    """``serve --quant-scales`` of the run's checkpoint in a process of its
    own (one slot), one session of ``video`` → the session's masks."""
    with _serve_subprocess(["--streams", "1", "--chunk", "16", "--quant-scales", scales]
                           + base, scales + ".serve.err") as first:
        t0 = time.perf_counter()
        masks = _one_session((first["host"], first["port"]), video)
        print(f"cli serve --quant-scales (subprocess) on {smi}: one session of "
              f"{len(video)} frames in {time.perf_counter() - t0:.2f} s; {json.dumps(first)}")
    return masks


def phase_quant_cli(device, info: dict, ctx: dict) -> dict:
    """W8A8 through the command line on ``phase_cli``'s run (ts8_256, its
    checkpoint): ``quant --check --device cuda``, then ``stream-eval``,
    ``parity --ablate``, ``export`` + ``infer --artifact`` and ``serve`` (a
    subprocess, one session), each with ``--quant-scales``.  The W8A8
    artifact's step equals the eager W8A8 model's; the artifact's and the
    server's masks agree with ``stream_video`` of the eager W8A8 model.
    Returns the forward launches counted in this process."""
    import numpy as np
    import torch
    from gdkvm_tpu_torch import cli
    from gdkvm_tpu_torch.config.schema import load_config
    from gdkvm_tpu_torch.eval.infer import load_frames
    from gdkvm_tpu_torch.eval.streaming import stream_video
    from gdkvm_tpu_torch.io.export import load_artifact
    from gdkvm_tpu_torch.models.gdkvm import StreamState
    from gdkvm_tpu_torch.ops import quant

    smi, base = info["smi"], ctx["base"]
    size = load_config(base[1], base[2:]).data.image_size
    tmp = _scratch_dir("quant")
    scales = os.path.join(tmp, "scales.json")
    launches = 0
    _reset_counts()
    res = _cli(["quant", "--check", "--device", "cuda", "--out", scales] + base)[-1]
    launches += _only_forward_launches("quant --check")
    print(f"cli quant --check on {smi}: {json.dumps(res)}")
    table = quant.load_scales(scales)
    if res["n_convs"] != len(table) or not all(k.startswith("encoder/") for k in table) \
            or res["check"]["fps_w8a8"] is None:
        raise AssertionError(f"quant: {res}")

    streamed = _cli(["stream-eval", "--quant-scales", scales, "--streams", "8",
                     "--video-len", "64"] + base)[-1]
    launches += _only_forward_launches("stream-eval --quant-scales")
    print(f"cli stream-eval --quant-scales --streams 8 on {smi}: {json.dumps(streamed)}")
    abl = _cli(["parity", "--ablate", "--ablate-videos", "1", "--ablate-video-len", "8",
                "--quant-scales", scales] + base)[-1]
    launches += _only_forward_launches("parity --ablate --quant-scales")
    print("cli parity --ablate --quant-scales: memory deltas " + " ".join(
        f"{k[13:]} {v:+.4f}" for k, v in abl.items() if k.startswith("memory_delta")))

    art = os.path.join(tmp, "artifact")
    exported = _cli(["export", "--out", art, "--batch", "1", "--quant-scales", scales]
                    + base)[-1]
    print(f"cli export --quant-scales: {json.dumps(exported)}")
    sm = load_artifact(art)
    n_mm = sum("_int_mm" in str(n.target) for n in sm.program.graph.nodes)
    if exported["platforms"] != [device.type] or n_mm != len(table):
        raise AssertionError(f"W8A8 export: {exported}, {n_mm} int8 products in the graph")
    model, _ = cli._load_model(load_config(base[1], base[2:]), None, device, "checking")
    qmodel = quant.w8a8_model(model, table)
    gen = torch.Generator().manual_seed(13)
    mem, seen = sm.init_state()
    state = StreamState(mem=mem, frames_seen=seen)
    worst = 0.0
    with torch.inference_mode():
        for _ in range(2):
            u8 = torch.randint(0, 256, (1, 16, size, size, 1), generator=gen,
                               dtype=torch.uint8).to(device)
            logits, mem, seen = sm.step(u8, mem, seen)
            want, state = qmodel(u8.to(torch.float32) / 255.0, state)
            worst = max(worst, _rel(logits, want), _rel(mem, state.mem))
    print(f"W8A8 artifact: {n_mm} aten._int_mm nodes; two carried chunks against the eager "
          f"W8A8 model, worst max|Δ|/max| | {worst:.3e} (bar {EXPORT_REL:g})")
    if not worst <= EXPORT_REL:
        raise AssertionError(f"W8A8 artifact against the eager W8A8 model: {worst}")
    out_dir = os.path.join(tmp, "infer_artifact")
    _cli(["infer", "--input", ctx["source"], "--out", out_dir, "--artifact", art] + base)
    launches += _only_forward_launches("export, the artifact's steps, infer --artifact")
    video = load_frames(ctx["source"], size)
    with torch.inference_mode():
        want = stream_video(qmodel, video, chunk=16)
    got = np.load(os.path.join(out_dir, "masks.npz"))["masks"]
    agree_art = float((got == want).mean()) if got.shape == want.shape else 0.0
    served = _serve_w8a8_session(base, scales, video, smi)
    agree_srv = float((served == want).mean()) if served.shape == want.shape else 0.0
    _reset_counts()
    print(f"W8A8 masks against stream_video of the eager W8A8 model: infer --artifact "
          f"{agree_art:.6f}, serve --quant-scales {agree_srv:.6f} (bar {MASK_AGREE})")
    if agree_art < MASK_AGREE or agree_srv < MASK_AGREE:
        raise AssertionError("W8A8 masks of the artifact or the server differ")
    return {"fwd": launches}


def phase_bench_all(device, info: dict) -> dict:
    """``python -m gdkvm_tpu_torch bench --mode all --device cuda`` through
    ``cli.main``: exit 0 (no errored section), an artifact that passes
    ``validate_artifact``, each section's headline number (quant_ab's are
    the W8A8 and bf16 forward times and peaks of this script).  Returns the
    launches, less the kernel's in gdr_kernel_ab (an A/B of the kernel
    against its plain version)."""
    from gdkvm_tpu_torch.eval import regression
    out = os.path.join(_scratch_dir("bench_all"), "bench_all.json")
    _reset_counts()
    t0 = time.perf_counter()
    art = _cli(["bench", "--mode", "all", "--device", device.type, "--out", out])[-1]
    dt = time.perf_counter() - t0
    counts = _read_counts()
    _reset_counts()
    regression.validate_artifact(art)
    if regression.failed_sections(art) or art["platform"] != "cuda":
        raise AssertionError(f"bench --mode all: errored {regression.failed_sections(art)}")
    secs = art["sections"]
    for arm in art["arms"]:
        rows = {k: r for k, r in secs["quant_ab"][arm].items() if isinstance(r, dict)}
        print(f"bench all [{arm}] on {info['smi']}: serve_112 "
              f"{secs['serve_112'][arm]['frames_per_sec']:.1f} f/s, serve_256 "
              f"{secs['serve_256'][arm]['frames_per_sec']:.1f} f/s, train_step "
              f"{secs['train_step'][arm]['steps_per_sec']:.3f} steps/s, quant_ab " + ", ".join(
                  f"{k} bf16 {r['fwd_ms_bf16']:.3f} / W8A8 {r['fwd_ms_w8a8']:.3f} ms "
                  f"(peak {r['peak_mb_bf16']:.0f} / {r['peak_mb_w8a8']:.0f} MB)"
                  for k, r in rows.items())
              + f", serve_bench {secs['serve_bench'][arm]['frames_per_sec']:.1f} f/s "
              f"(p50 {secs['serve_bench'][arm]['request_latency_ms_p50']:.2f} ms)")
    for shape, row in secs["gdr_kernel_ab"].items():
        print(f"bench all gdr_kernel_ab [{shape}]: kernel {row['kernel_ms']:.4f} ms, chunked "
              f"{row['chunked_ms']:.4f} ms ({row['speedup']:.2f}x)")
    print(f"bench all: reps {art['reps']}, elapsed {art['elapsed_sec']} s in the artifact, "
          f"{dt:.1f} s with its write; counts {counts}")
    print("bench all artifact: " + json.dumps(art, sort_keys=True))
    # gdr_kernel_ab times each side reps calls after 3 warm-up calls, twice
    # a shape; its chunked side is the only plain GDR of the run, so the
    # kernel's A/B launches equal the plain calls counted.
    ab = counts["plain_fwd"]
    if ab != 2 * (art["reps"] + 3) * len(secs["gdr_kernel_ab"]) \
            or not (counts["fwd_kernel"] - ab > counts["residual_fwd"] > 0) \
            or counts["stored_bwd"] != counts["residual_fwd"] or counts["bwd_kernel"] \
            or counts["plain_chain"] or counts["plain_bwd"]:
        raise AssertionError(f"bench all counts {counts}")
    return {"fwd": counts["fwd_kernel"] - ab - counts["residual_fwd"],
            "residual": counts["residual_fwd"]}


# ------------------------------------------------------ distribution

# Two ranks on one card against one process: parameters after DIST_STEPS
# steps within the JAX package's data-parallel tolerances
# (tests/test_sharding.py), the losses within DIST_LOSS_REL, the gradient
# norms within DIST_NORM_REL (only the order of the sums over the batch
# differs); evaluate's scores within DIST_DICE.
DIST_STEPS = 2
DIST_TIMED = 5
DIST_RTOL, DIST_ATOL = 2e-4, 2e-5
DIST_LOSS_REL, DIST_NORM_REL = 1e-5, 1e-4
DIST_DICE = 1e-4
DIST_TIMEOUT = 300


def _dist_cfg(data_path: str, run_dir: str):
    """The ts8_256 recipe for the two-rank checks: full width, fp32
    compute, the peak rate from the second step on; the packed split with
    HD95 for evaluate."""
    import dataclasses
    from gdkvm_tpu_torch.models.gdkvm import train_model_config
    cfg = _run_cfg("packed", data_path, run_dir, "off", warmup_iterations=1)
    cfg.eval_stage.hd95 = True
    return cfg, dataclasses.replace(train_model_config(cfg.model, 256),
                                    compute_dtype="float32")


def _timed_steps(state, batch, cfg, n: int) -> float:
    """Mean ms of ``n`` train steps on the host clock, each ended by a
    synchronize (after one untimed)."""
    import torch
    from gdkvm_tpu_torch.train.loop import train_step
    train_step(state, batch, cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        train_step(state, batch, cfg)
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def _layout(mesh) -> str:
    return f"{mesh.data}x{mesh.model}"


def _dist_steps(root: str, device, batch, cfg, model_cfg, mesh) -> dict:
    """DIST_STEPS train steps per backward mode from root/weights.pt on
    ``batch`` (this process's rows) with this process's place on ``mesh``,
    the counts 0 just before and read just after; the parameters (the
    rank's shard) go to root; then DIST_TIMED timed steps; in a process
    group, the time of the step's collectives alone."""
    import torch
    from gdkvm_tpu_torch.parallel import distributed
    from gdkvm_tpu_torch.train.loop import train_step
    weights = torch.load(os.path.join(root, "weights.pt"), weights_only=True)
    out = {}
    for mode in ("stored", "fused"):
        os.environ["GDKVM_GDR_BWD"] = mode
        state = _state(cfg, model_cfg, device, weights, mesh)
        _reset_counts()
        metrics = [{k: float(v) for k, v in train_step(state, batch, cfg).items()}
                   for _ in range(DIST_STEPS)]
        torch.cuda.synchronize()
        counts = _read_counts()
        torch.save({k: v.cpu() for k, v in state.model.state_dict().items()},
                   os.path.join(root, f"params_{mode}_rank{distributed.rank()}"
                                      f"_of{_layout(mesh)}.pt"))
        out[mode] = {"metrics": metrics, "counts": counts,
                     "step_ms": _timed_steps(state, batch, cfg, DIST_TIMED)}
    os.environ.pop("GDKVM_GDR_BWD")

    def timed(fn) -> float:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DIST_TIMED):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / DIST_TIMED * 1e3
    if mesh.data_group is not None:
        # The step's gradient all-reduce alone: one flat fp32 buffer of
        # every parameter's gradient.
        flat = torch.zeros(sum(p.numel() for p in state.opt.params), device=device)
        out["all_reduce_ms"] = timed(lambda: distributed.all_reduce_sum([flat],
                                                                        mesh.data_group))
        out["all_reduce_mb"] = flat.numel() * 4 / 2**20
    if mesh.model_group is not None:
        # The model group's collectives of a step alone: the heads' sum of
        # the readout, the sum of its input's gradient (both fp32 of the
        # stride-16 features' shape), the replicated LKVA parameters'
        # partial gradients and the norm's sum of squares.
        b, t = batch.frames.shape[:2]
        side = cfg.data.image_size // 16
        feats = torch.zeros((b, t, side, side, model_cfg.enc_channels[-1]), device=device)
        part = torch.zeros(sum(p.numel() for p, f in zip(state.opt.params, state.partial)
                               if f), device=device)
        one = torch.zeros((), device=device)
        group = mesh.model_group
        out["model_sum_ms"] = timed(lambda: [distributed.all_reduce_sum([x], group)
                                             for x in (feats, feats, part, one)])
        out["model_sum_mb"] = (2 * feats.numel() + part.numel() + 1) * 4 / 2**20
    return out


def _dist_evaluate(root: str, device, cfg, model_cfg, mesh) -> dict:
    """evaluate from root/weights.pt (the rank's head shard of them) with
    this process's place on ``mesh``, counts 0 just before, read after."""
    import torch
    from gdkvm_tpu_torch.eval.evaluator import evaluate
    weights = torch.load(os.path.join(root, "weights.pt"), weights_only=True)
    model = _state(cfg, model_cfg, device, weights, mesh).model
    _reset_counts()
    with torch.inference_mode():
        scores = evaluate(cfg, model.eval(), device, mesh=mesh)
    torch.cuda.synchronize()
    return {"scores": scores, "counts": _read_counts()}


def _rank_dist(root: str, data_path: str, *layouts: str) -> int:
    """One rank of phase_distributed's ranks on cuda:0 over gloo (run as
    ``chip_smoke.py --rank-dist ROOT DATA DxM...`` under RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT), once for each ``DxM`` mesh layout of the
    group: its data position's rows of the global batch through
    _dist_steps with its head shard, then evaluate; writes
    root/rank{r}_of{D}x{M}.json."""
    import numpy as np
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from gdkvm_tpu_torch.data.pipeline import Batch
    from gdkvm_tpu_torch.parallel import distributed
    from gdkvm_tpu_torch.parallel.mesh import batch_slice, make_mesh
    device = torch.device("cuda:0")
    if not distributed.maybe_initialize_distributed(backend="gloo", device=device):
        raise RuntimeError("--rank-dist: no process group in the environment")
    rank = distributed.rank()
    z = np.load(os.path.join(root, "batch.npz"))
    for layout in layouts:
        mesh = make_mesh(*(int(x) for x in layout.split("x")))
        cfg, model_cfg = _dist_cfg(data_path, os.path.join(root, f"eval_ranks_{layout}"))
        rows = batch_slice(mesh, z["frames"].shape[0])
        batch = Batch(*(torch.from_numpy(z[k][rows]).to(device)
                        for k in ("frames", "masks", "valid")))
        out = {"backend": torch.distributed.get_backend(), "info": distributed.process_info(),
               "rows": [rows.start, rows.stop], "place": [mesh.index, mesh.model_index],
               **_dist_steps(root, device, batch, cfg, model_cfg, mesh),
               "eval": _dist_evaluate(root, device, cfg, model_cfg, mesh)}
        with open(os.path.join(root, f"rank{rank}_of{layout}.json"), "w") as fh:
            json.dump(out, fh)
    distributed.shutdown()
    return 0


# (vi): the 2x2 run's steps, its checkpoints, and where one process resumes.
HEAD_RUN_STEPS, HEAD_RESUME_AT = 4, 2


def _head_run_cfg(data_path: str, run_dir: str, **over):
    """The ts8_256 recipe in fp32 on the packed split for (vi): HEAD_RUN_STEPS
    steps, a checkpoint every HEAD_RESUME_AT, the eval stage at the end."""
    cfg, model_cfg = _dist_cfg(data_path, run_dir)
    cfg.model = model_cfg
    cfg.eval_stage.hd95 = False
    t = cfg.train
    t.num_iterations, t.log_every, t.eval_every = HEAD_RUN_STEPS, 1, HEAD_RUN_STEPS
    t.checkpoint_every = HEAD_RESUME_AT
    for k, v in over.items():
        section, key = k.split(".")
        setattr(getattr(cfg, section), key, v)
    return cfg


def _rank_train(run_dir: str, data_path: str) -> int:
    """One rank of (vi): ``train(cfg)`` at data 2 × model 2 on cuda:0 over
    gloo (``chip_smoke.py --rank-train RUN_DIR DATA``), the counts 0 just
    before and read just after; writes RUN_DIR/rank{r}.json."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from gdkvm_tpu_torch.parallel import distributed
    from gdkvm_tpu_torch.train.loop import train
    device = torch.device("cuda:0")
    if not distributed.maybe_initialize_distributed(backend="gloo", device=device):
        raise RuntimeError("--rank-train: no process group in the environment")
    rank = distributed.rank()
    cfg = _head_run_cfg(data_path, run_dir, **{"parallel.data_axis": 2,
                                               "parallel.model_axis": 2})
    _reset_counts()
    final = train(cfg, device=device)
    torch.cuda.synchronize()
    out = {"final": final, "counts": _read_counts()}
    distributed.barrier("rank-train done")
    with open(os.path.join(run_dir, f"rank{rank}.json"), "w") as fh:
        json.dump(out, fh)
    distributed.shutdown()
    return 0


def _rank_cli(argv: list) -> int:
    """``cli.main(argv)`` as one rank under torchrun (``chip_smoke.py
    --rank-cli train ...``), so that its launches can be counted: around
    the ``train`` it calls, the counts are set to 0 and read, and the
    group's backend and place recorded; printed as a JSON line last."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from gdkvm_tpu_torch import cli
    from gdkvm_tpu_torch.parallel import distributed
    from gdkvm_tpu_torch.train import loop
    real, seen = loop.train, {}

    def counted_train(cfg, **kw):
        seen.update(backend=torch.distributed.get_backend(), info=distributed.process_info(),
                    device=str(kw.get("device")))
        _reset_counts()
        out = real(cfg, **kw)
        torch.cuda.synchronize()
        seen["counts"] = _read_counts()
        return out
    loop.train = counted_train
    rc = cli.main(argv)
    print(json.dumps({"rank_cli": seen}), flush=True)
    return rc


def _run_ranks(cmd: list, n: int, what: str) -> list:
    """``cmd`` as ``n`` ranks of a group on localhost (RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT; n = 0: one process that sets them itself, a
    launcher), waited for at most DIST_TIMEOUT s; any that fails ends the
    run.  → each process's stdout."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(_module_env(), GDKVM_DIST_TIMEOUT=str(DIST_TIMEOUT))
    envs = [dict(env, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(n),
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)) for r in range(n)] or [env]
    procs = [subprocess.Popen(cmd, cwd=REPO, env=e, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for e in envs]
    try:
        outs = [p.communicate(timeout=DIST_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"{what}: rank {r} exit code {p.returncode}: {err[-3000:]}")
    return [o for o, _ in outs]


def phase_distributed(device, info: dict, roots: dict, served: dict) -> dict:
    """Training, eval and serving over a data × model mesh of devices (the
    distribution main path), on the one card:

    (i) ``python -m torch.distributed.run --standalone --nproc_per_node=1``
        of ``python -m gdkvm_tpu_torch train --config
        configs/gdkvm_ts8_256.yaml`` on the packed split: NCCL, one rank,
        its JSON, log and checkpoint, its launches counted in the rank;
    (ii) two ranks on cuda:0 over gloo: DIST_STEPS ts8_256 steps at full
        width, fp32, batch 8 split 4 + 4, in the stored and the fused
        backward mode, held to one process on the global batch, with each
        rank's launches counted; the step's time and the gradient
        all-reduce's;
    (iii) the same ranks' evaluate against one process;
    (iv) phase_serve's 8 sessions through a data=2 mesh of [cuda:0, cuda:0]
        in both forward splits, against the model engine's masks;
    (v) the ranks of (ii) as data 1 × model 2 (ts8's 4 LKVA
        heads, 2 a rank), the steps of (ii) on the whole batch a rank, held
        to one process (losses, gathered parameters, gradient norms; the
        replicated parameters bitwise equal on both ranks), with evaluate;
        each rank's step against one process's and the model group's
        collectives alone;
    (vi) four ranks as data 2 × model 2: ``train(cfg)`` HEAD_RUN_STEPS
        steps with a checkpoint every HEAD_RESUME_AT; one process restores
        its step-HEAD_RESUME_AT checkpoint and continues to the same step,
        held to the 2x2 run;
    (vii) phase_serve's 8 sessions through 1x2 and 2x2 meshes of cuda:0 in
        one process (the heads of each slot group over the row), in both
        forward splits, fp32 and bf16, against the one-device engine's
        masks, and frames/s beside the one-device engine's in the same call;
    (viii) the kernels at a head shard's shape (H=2) against their plain
        versions, timed beside their bounds.

    Returns the launches by kernel and (viii)'s results."""
    import numpy as np
    import torch
    from gdkvm_tpu_torch.parallel.mesh import make_mesh
    t_phase = time.perf_counter()
    smi = info["smi"]
    launches = {"fwd": 0, "residual": 0, "bwd": 0, "chain": 0}
    tmp = _scratch_dir("dist")

    # (i) torchrun, NCCL, world 1, through the command line.
    run_dir = os.path.join(tmp, "torchrun")
    steps, n_val = 4, RUN_CLIPS["packed"][1]
    t0 = time.perf_counter()
    out = _run_ranks([sys.executable, "-m", "torch.distributed.run", "--standalone",
                      "--nproc_per_node=1", os.path.abspath(__file__), "--rank-cli", "train",
                      "--config", TS8_256, "data.dataset=packed",
                      f"data_path={roots['packed']}", f"num_iterations={steps}",
                      "train.log_every=1", f"train.eval_every={steps}",
                      f"train.checkpoint_every={steps}", "eval_stage.wandb_mode=disabled",
                      f"runtime.run_dir={run_dir}"], 0, "torchrun train")[0]
    lines = [json.loads(line) for line in out.strip().splitlines() if line.startswith("{")]
    final = next(x["final"] for x in lines if "final" in x)
    seen = next(x["rank_cli"] for x in lines if "rank_cli" in x)
    want = dict(_ZERO, fwd_kernel=steps + n_val, residual_fwd=steps, stored_bwd=steps)
    print(f"distributed (i) torchrun train, 1 rank: backend {seen['backend']}, "
          f"{seen['info']}, device {seen['device']}; counts {seen['counts']}; loss "
          f"{final['loss']:.4f}, eval Dice fg {final['eval/dice_fg_mean']:.4f}; "
          f"{time.perf_counter() - t0:.1f} s with the process's start")
    rows = _jsonl(run_dir)
    if seen["backend"] != "nccl" or seen["info"]["process_count"] != 1 \
            or seen["device"] != "cuda:0" or seen["counts"] != want \
            or [r["step"] for r in rows if "loss" in r] != list(range(1, steps + 1)) \
            or os.listdir(os.path.join(run_dir, "checkpoints")) != [f"step_{steps:08d}.pt"] \
            or not all(np.isfinite(v) for v in final.values()):
        raise AssertionError(f"torchrun train: {seen}, final {final}, expected counts {want}")
    launches["fwd"] += n_val
    launches["residual"] += steps

    # (ii), (iii): one process on the global batch, then two ranks.
    from gdkvm_tpu_torch.models.gdkvm import GDKVM, init_params
    cfg, model_cfg = _dist_cfg(roots["packed"], os.path.join(tmp, "eval_one"))
    torch.save(init_params(GDKVM(model_cfg, device=device),
                           torch.Generator().manual_seed(cfg.train.seed)).state_dict(),
               os.path.join(tmp, "weights.pt"))
    batch = _batch(_train_cfg())
    np.savez(os.path.join(tmp, "batch.npz"), frames=batch.frames, masks=batch.masks,
             valid=batch.valid)
    from gdkvm_tpu_torch.data.pipeline import Batch
    alone = make_mesh(1, 1, devices=[device])
    one = _dist_steps(tmp, device, Batch(*(torch.from_numpy(np.asarray(x)).to(device)
                                           for x in (batch.frames, batch.masks, batch.valid))),
                      cfg, model_cfg, alone)
    one_eval = _dist_evaluate(tmp, device, cfg, model_cfg, alone)
    t0 = time.perf_counter()
    # The same two processes run (ii)-(iii) as data 2 x model 1, then (v) as
    # data 1 x model 2.
    _run_ranks([sys.executable, os.path.abspath(__file__), "--rank-dist", tmp,
                roots["packed"], "2x1", "1x2"], 2, "two ranks on cuda:0")
    ranks_s = time.perf_counter() - t0
    ranks = [json.load(open(os.path.join(tmp, f"rank{r}_of2x1.json"))) for r in range(2)]
    for mode in ("stored", "fused"):
        want = dict(_ZERO, fwd_kernel=DIST_STEPS, residual_fwd=DIST_STEPS,
                    **{"stored_bwd" if mode == "stored" else "bwd_kernel": DIST_STEPS})
        ref = torch.load(os.path.join(tmp, f"params_{mode}_rank0_of1x1.pt"), weights_only=True)
        worst = {}
        for r, rk in enumerate(ranks):
            if rk["backend"] != "gloo" or rk["info"]["process_count"] != 2 \
                    or rk["rows"] != [4 * r, 4 * r + 4] or rk[mode]["counts"] != want:
                raise AssertionError(f"rank {r} [{mode}]: {rk['backend']} {rk['info']} rows "
                                     f"{rk['rows']} counts {rk[mode]['counts']}, expected {want}")
            got = torch.load(os.path.join(tmp, f"params_{mode}_rank{r}_of2x1.pt"),
                             weights_only=True)
            for name, w in ref.items():
                excess = ((got[name] - w).abs() - DIST_RTOL * w.abs()).max()
                worst[name] = max(worst.get(name, -1.0), float(excess))
            for s, (m1, m2) in enumerate(zip(one[mode]["metrics"], rk[mode]["metrics"])):
                d_loss = abs(m2["loss"] - m1["loss"]) / abs(m1["loss"])
                d_norm = abs(m2["grad_norm"] - m1["grad_norm"]) / abs(m1["grad_norm"])
                if d_loss > DIST_LOSS_REL or d_norm > DIST_NORM_REL \
                        or m2["batch_checksum"] != m1["batch_checksum"]:
                    raise AssertionError(f"rank {r} [{mode}] step {s + 1}: {m2} against {m1}")
        name = max(worst, key=worst.get)
        print(f"distributed (ii) [{mode}]: 2 ranks x rows 4 of batch 8 on cuda:0 over gloo; "
              f"counts per rank {ranks[0][mode]['counts']}; losses "
              + " ".join(f"{m['loss']:.7f}" for m in ranks[0][mode]["metrics"])
              + " (one process " + " ".join(f"{m['loss']:.7f}" for m in one[mode]["metrics"])
              + f"); worst max(|Δ| - {DIST_RTOL:g}|p|) over the parameters {worst[name]:.3e} "
              f"({name}; bar {DIST_ATOL:g})")
        if worst[name] > DIST_ATOL:
            raise AssertionError(f"[{mode}] two ranks differ from one process at {name}")
        launches["residual"] += 2 * DIST_STEPS
        launches["bwd"] += 2 * DIST_STEPS if mode == "fused" else 0
    share = [rk["all_reduce_ms"] / rk["stored"]["step_ms"] for rk in ranks]
    print(f"distributed (ii) times on {smi}: step ms per rank, two ranks at once on the "
          "card: " + ", ".join(f"{m} " + "/".join(f"{rk[m]['step_ms']:.2f}" for rk in ranks)
                               for m in ("stored", "fused"))
          + "; one process on batch 8: " + ", ".join(f"{m} {one[m]['step_ms']:.2f}"
                                                     for m in ("stored", "fused"))
          + f"; gloo all-reduce of the {ranks[0]['all_reduce_mb']:.1f} MiB gradient "
          + "/".join(f"{rk['all_reduce_ms']:.2f}" for rk in ranks)
          + " ms, " + "/".join(f"{x:.3f}" for x in share) + " of a stored step; "
          f"ranks' processes {ranks_s:.1f} s")
    want_eval = dict(_ZERO, fwd_kernel=n_val // 2)
    for r, rk in enumerate(ranks):
        scores = rk["eval"]["scores"]
        diff = max(abs(scores[k] - v) for k, v in one_eval["scores"].items())
        if rk["eval"]["counts"] != want_eval or set(scores) != set(one_eval["scores"]) \
                or scores["frames"] != one_eval["scores"]["frames"] or diff > DIST_DICE:
            raise AssertionError(f"rank {r} evaluate {rk['eval']} against one process "
                                 f"{one_eval}")
    print(f"distributed (iii) evaluate, 2 ranks: {json.dumps(ranks[0]['eval']['scores'])}; "
          f"counts per rank {ranks[0]['eval']['counts']}; one process "
          f"{one_eval['counts']}; worst |Δ| {diff:.2e}")
    launches["fwd"] += n_val

    # (iv) mesh serving: two groups of 4 slots on the one card.  A group's
    # call is a batch of 4: its masks must equal, on every pixel, those of a
    # one-device engine of 4 slots (the same sessions in two rounds of 4).
    # Against phase_serve's 8-slot engine, a batch of 8 a call, bf16 kernels
    # chosen by batch size round differently: held to phase_serve's bar for
    # what batching loses.
    from gdkvm_tpu_torch.serve import ServeClient
    mesh = make_mesh(data=2, devices=[device, device])
    videos = _serve_videos()
    per_group = dict(SERVE, streams=SERVE["streams"] // 2)
    for mode in ("monolith", "chain"):
        os.environ["GDKVM_GDR_FWD"] = mode
        with _served(served["model"], mesh=mesh) as (engine, addr):
            _reset_counts()
            ticks0 = engine.ticks
            with ThreadPoolExecutor(max_workers=len(videos)) as pool:
                masks = list(pool.map(lambda v: _one_session(addr, v), videos))
            ticks = engine.ticks - ticks0
            counts = _read_counts()
            health = ServeClient(*addr).health()
        key = "chain_kernel" if mode == "chain" else "fwd_kernel"
        from gdkvm_tpu_torch.serve import BatchingEngine
        engine4 = BatchingEngine(model=served["model"], **per_group)
        try:
            same_batch = []
            for lo in (0, per_group["streams"]):
                group = videos[lo:lo + per_group["streams"]]
                sids = [engine4.open_session()["session"] for _ in group]
                with ThreadPoolExecutor(max_workers=len(group)) as pool:
                    same_batch += list(pool.map(engine4.infer, sids, group))
                for sid in sids:
                    engine4.close_session(sid)
        finally:
            engine4.close()
        exact = [float((a == b).mean()) for a, b in zip(masks, same_batch)]
        agree = [float((a == b).mean()) for a, b in zip(masks, served["masks"][mode])]
        print(f"distributed (iv) mesh serving [{mode}]: mesh {health['mesh']}, {ticks} ticks, "
              f"counts {counts}; masks per session against a one-device engine of 4 slots: "
              + " ".join(f"{x:.6f}" for x in exact) + "; against phase_serve's 8-slot engine: "
              + " ".join(f"{x:.6f}" for x in agree) + f" (bar {served['bf16_bar']:.6f})")
        if health["mesh"] != {"data": 2, "model": 1} or ticks < 1 \
                or counts != dict(_ZERO, **{key: 2 * ticks}) or min(exact) < 1.0 \
                or min(agree) < served["bf16_bar"]:
            raise AssertionError(f"mesh serving [{mode}]: counts {counts} for {ticks} ticks, "
                                 f"agreement {exact}, {agree}")
        launches["chain" if mode == "chain" else "fwd"] += counts[key]
    os.environ.pop("GDKVM_GDR_FWD")

    _heads_train(tmp, one, one_eval, launches, smi)
    _heads_run(tmp, roots, device, launches)
    _heads_serve(device, served, launches, smi)
    shard = _shard_kernels(device, smi)
    print(f"phase_distributed: {time.perf_counter() - t_phase:.1f} s")
    return dict(launches, shard=shard)


def _heads_train(tmp: str, one: dict, one_eval: dict, launches: dict, smi: str) -> None:
    """(v): the two ranks of (ii) as data 1 × model 2, against one
    process's (ii)."""
    import torch
    from gdkvm_tpu_torch.parallel.mesh import gather_state_dicts, head_dim
    ranks = [json.load(open(os.path.join(tmp, f"rank{r}_of1x2.json"))) for r in range(2)]
    for mode in ("stored", "fused"):
        want = dict(_ZERO, fwd_kernel=DIST_STEPS, residual_fwd=DIST_STEPS,
                    **{"stored_bwd" if mode == "stored" else "bwd_kernel": DIST_STEPS})
        ref = torch.load(os.path.join(tmp, f"params_{mode}_rank0_of1x1.pt"), weights_only=True)
        shards = [torch.load(os.path.join(tmp, f"params_{mode}_rank{r}_of1x2.pt"),
                             weights_only=True) for r in range(2)]
        for r, rk in enumerate(ranks):
            if rk["place"] != [0, r] or rk["rows"] != [0, 8] or rk[mode]["counts"] != want:
                raise AssertionError(f"1x2 rank {r} [{mode}]: place {rk['place']} rows "
                                     f"{rk['rows']} counts {rk[mode]['counts']}, expected {want}")
            for s_, (m1, m2) in enumerate(zip(one[mode]["metrics"], rk[mode]["metrics"])):
                d_loss = abs(m2["loss"] - m1["loss"]) / abs(m1["loss"])
                d_norm = abs(m2["grad_norm"] - m1["grad_norm"]) / abs(m1["grad_norm"])
                if d_loss > DIST_LOSS_REL or d_norm > DIST_NORM_REL \
                        or m2["batch_checksum"] != m1["batch_checksum"]:
                    raise AssertionError(f"1x2 rank {r} [{mode}] step {s_ + 1}: {m2} "
                                         f"against {m1}")
        unequal = [n for n, t in shards[0].items()
                   if head_dim(n) is None and not torch.equal(t, shards[1][n])]
        if unequal:
            raise AssertionError(f"1x2 [{mode}]: replicated parameters differ across the "
                                 f"ranks: {unequal[:5]}")
        got = gather_state_dicts(shards)
        worst = {n: float(((got[n] - w).abs() - DIST_RTOL * w.abs()).max())
                 for n, w in ref.items()}
        name = max(worst, key=worst.get)
        print(f"distributed (v) [{mode}]: data 1 x model 2 on cuda:0 over gloo, 2 heads a "
              f"rank, batch 8 each; counts per rank {ranks[0][mode]['counts']}; losses "
              + " ".join(f"{m['loss']:.7f}" for m in ranks[0][mode]["metrics"])
              + ", grad norms " + " ".join(f"{m['grad_norm']:.7f}"
                                           for m in ranks[0][mode]["metrics"])
              + " (one process " + " ".join(f"{m['loss']:.7f}/{m['grad_norm']:.7f}"
                                            for m in one[mode]["metrics"])
              + f"); replicated parameters bitwise equal on both ranks; worst max(|Δ| - "
              f"{DIST_RTOL:g}|p|) over the gathered parameters {worst[name]:.3e} ({name}; "
              f"bar {DIST_ATOL:g})")
        if worst[name] > DIST_ATOL:
            raise AssertionError(f"[{mode}] 1x2 differs from one process at {name}")
        launches["residual"] += 2 * DIST_STEPS
        launches["bwd"] += 2 * DIST_STEPS if mode == "fused" else 0
    share = [rk["model_sum_ms"] / rk["stored"]["step_ms"] for rk in ranks]
    print(f"distributed (v) times on {smi}: step ms per rank, two ranks at once on the "
          "card: " + ", ".join(f"{m} " + "/".join(f"{rk[m]['step_ms']:.2f}" for rk in ranks)
                               for m in ("stored", "fused"))
          + "; one process on batch 8: " + ", ".join(f"{m} {one[m]['step_ms']:.2f}"
                                                     for m in ("stored", "fused"))
          + f"; the model group's collectives of a step ({ranks[0]['model_sum_mb']:.2f} MiB "
          "of all-reduces) " + "/".join(f"{rk['model_sum_ms']:.2f}" for rk in ranks)
          + " ms, " + "/".join(f"{x:.3f}" for x in share) + " of a stored step")
    n_val = RUN_CLIPS["packed"][1]
    want_eval = dict(_ZERO, fwd_kernel=n_val)
    for r, rk in enumerate(ranks):
        scores = rk["eval"]["scores"]
        diff = max(abs(scores[k] - v) for k, v in one_eval["scores"].items())
        if rk["eval"]["counts"] != want_eval or set(scores) != set(one_eval["scores"]) \
                or scores["frames"] != one_eval["scores"]["frames"] or diff > DIST_DICE:
            raise AssertionError(f"1x2 rank {r} evaluate {rk['eval']} against one process "
                                 f"{one_eval}")
    print(f"distributed (v) evaluate, 1x2: counts per rank {ranks[0]['eval']['counts']}; "
          f"worst |Δ| against one process {diff:.2e}")
    launches["fwd"] += 2 * n_val


def _heads_run(tmp: str, roots: dict, device, launches: dict) -> None:
    """(vi): ``train(cfg)`` on four ranks as data 2 × model 2, then one
    process from its checkpoint."""
    import shutil
    import numpy as np
    import torch
    from gdkvm_tpu_torch.train.loop import train
    run_dir = os.path.join(tmp, "run2x2")
    os.makedirs(run_dir)
    t0 = time.perf_counter()
    _run_ranks([sys.executable, os.path.abspath(__file__), "--rank-train", run_dir,
                roots["packed"]], 4, "2x2 train on cuda:0")
    ranks_s = time.perf_counter() - t0
    ranks = [json.load(open(os.path.join(run_dir, f"rank{r}.json"))) for r in range(4)]
    n_val = RUN_CLIPS["packed"][1]
    want = dict(_ZERO, fwd_kernel=HEAD_RUN_STEPS + n_val // 2, residual_fwd=HEAD_RUN_STEPS,
                stored_bwd=HEAD_RUN_STEPS)
    untimed = lambda m: {k: v for k, v in m.items()
                         if k not in ("steps_per_sec", "sec_per_step", "frames_per_sec")}
    if any(rk["counts"] != want or untimed(rk["final"]) != untimed(ranks[0]["final"])
           for rk in ranks):
        raise AssertionError(f"2x2 train: counts {[rk['counts'] for rk in ranks]}, expected "
                             f"{want}; finals {[rk['final'] for rk in ranks]}")
    launches["fwd"] += 4 * (n_val // 2)
    launches["residual"] += 4 * HEAD_RUN_STEPS
    resumed = os.path.join(tmp, "run1_from2x2")
    os.makedirs(os.path.join(resumed, "checkpoints"))
    shutil.copy(os.path.join(run_dir, "checkpoints", f"step_{HEAD_RESUME_AT:08d}.pt"),
                os.path.join(resumed, "checkpoints"))
    _reset_counts()
    final = train(_head_run_cfg(roots["packed"], resumed, **{"runtime.resume": True}),
                  device=device)
    torch.cuda.synchronize()
    counts = _read_counts()
    steps = HEAD_RUN_STEPS - HEAD_RESUME_AT
    want1 = dict(_ZERO, fwd_kernel=steps + n_val, residual_fwd=steps, stored_bwd=steps)
    rows2 = {r["step"]: r for r in _jsonl(run_dir) if "loss" in r}
    rows1 = [r for r in _jsonl(resumed) if "loss" in r]
    ck2, ck1 = (torch.load(os.path.join(d, "checkpoints", f"step_{HEAD_RUN_STEPS:08d}.pt"),
                           weights_only=True) for d in (run_dir, resumed))
    worst = {n: float(((ck1["model"][n] - w).abs() - DIST_RTOL * w.abs()).max())
             for n, w in ck2["model"].items()}
    name = max(worst, key=worst.get)
    d_loss = max(abs(r["loss"] - rows2[r["step"]]["loss"]) / abs(rows2[r["step"]]["loss"])
                 for r in rows1)
    print(f"distributed (vi) train at data 2 x model 2 on cuda:0 over gloo, 4 ranks: "
          f"{HEAD_RUN_STEPS} steps, counts per rank {ranks[0]['counts']}, loss "
          f"{ranks[0]['final']['loss']:.6f}, eval Dice fg "
          f"{ranks[0]['final']['eval/dice_fg_mean']:.6f}, ranks' processes {ranks_s:.1f} s; "
          f"one process from its step-{HEAD_RESUME_AT} checkpoint: counts {counts}, steps "
          f"{[r['step'] for r in rows1]}, worst loss rel {d_loss:.2e}, worst max(|Δ| - "
          f"{DIST_RTOL:g}|p|) over the step-{HEAD_RUN_STEPS} parameters {worst[name]:.3e} "
          f"({name}), eval Dice fg {final['eval/dice_fg_mean']:.6f}")
    if counts != want1 or [r["step"] for r in rows1] != list(range(HEAD_RESUME_AT + 1,
                                                                    HEAD_RUN_STEPS + 1)) \
            or any(r["batch_checksum"] != rows2[r["step"]]["batch_checksum"] for r in rows1) \
            or d_loss > DIST_LOSS_REL or worst[name] > DIST_ATOL \
            or not torch.equal(ck1["gen"], ck2["gen"]) \
            or abs(final["eval/dice_fg_mean"] - ranks[0]["final"]["eval/dice_fg_mean"]) \
            > DIST_DICE or not np.isfinite(final["loss"]):
        raise AssertionError(f"one process from the 2x2 checkpoint: counts {counts} "
                             f"(expected {want1}), rows {rows1}, worst {worst[name]} at {name}")
    launches["fwd"] += n_val
    launches["residual"] += steps


def _heads_serve(device, served: dict, launches: dict, smi: str) -> None:
    """(vii): phase_serve's sessions through 1x2 and 2x2 meshes of the card
    in one process, against the one-device engine's masks; the one-device
    engine timed beside them in the same call."""
    from gdkvm_tpu_torch.parallel.mesh import make_mesh
    from gdkvm_tpu_torch.serve import ServeClient
    videos = _serve_videos()
    frames = sum(len(v) for v in videos)
    for dtype, model, refs, bar in (
            ("float32", served["model_fp32"], served["masks_fp32"], SERVE_AGREE),
            ("bfloat16", served["model"], served["masks"], served["bf16_bar"])):
        for mode in ("monolith", "chain"):
            os.environ["GDKVM_GDR_FWD"] = mode
            key = "chain_kernel" if mode == "chain" else "fwd_kernel"
            for d, m in ((1, 1), (1, 2), (2, 2)):
                mesh = None if m == 1 else make_mesh(d, m, devices=[device] * (d * m))
                with _served(model, mesh=mesh) as (engine, addr):
                    _reset_counts()
                    ticks0 = engine.ticks
                    t0 = time.perf_counter()
                    with ThreadPoolExecutor(max_workers=len(videos)) as pool:
                        masks = list(pool.map(lambda v: _one_session(addr, v), videos))
                    wall = time.perf_counter() - t0
                    ticks = engine.ticks - ticks0
                    counts = _read_counts()
                    health = ServeClient(*addr).health()
                launches["chain" if mode == "chain" else "fwd"] += counts[key]
                if mesh is None:           # the one-device engine, timed in the same call
                    print(f"distributed (vii) one-device engine [{dtype}, {mode}] on {smi}: "
                          f"{ticks} ticks, {counts[key] / max(ticks, 1):.1f} launches a tick, "
                          f"{frames / wall:.1f} frames/s over {wall:.2f} s")
                    if counts != dict(_ZERO, **{key: ticks}):
                        raise AssertionError(f"one-device engine [{dtype}, {mode}]: {counts}")
                    continue
                agree = [float((a == b).mean()) for a, b in zip(masks, refs[mode])]
                print(f"distributed (vii) mesh serving {d}x{m} [{dtype}, {mode}] on {smi}: "
                      f"mesh {health['mesh']}, {ticks} ticks, counts {counts} "
                      f"({counts[key] / max(ticks, 1):.1f} launches a tick), "
                      f"{frames / wall:.1f} frames/s over {wall:.2f} s; masks per session "
                      "against the one-device engine: "
                      + " ".join(f"{x:.6f}" for x in agree) + f" (bar {bar:.6f})")
                if health["mesh"] != {"data": d, "model": m} or ticks < 1 \
                        or counts != dict(_ZERO, **{key: d * m * ticks}) or min(agree) < bar:
                    raise AssertionError(f"mesh serving {d}x{m} [{dtype}, {mode}]: counts "
                                         f"{counts} for {ticks} ticks, agreement {agree}")
    os.environ.pop("GDKVM_GDR_FWD")


# (viii): ts8's 4 heads over a model axis of 2.
SHARD_SERVE, SHARD_STREAM = (8, 2, 16, 49, 64, 64), (8, 2, 32, 49, 64, 64)
SHARD_TRAIN = (8, 2, 10, 256, 64, 64)


def _shard_kernels(device, smi: str) -> dict:
    """(viii): each kernel at a head shard's shape against its plain
    version at the existing bars, then timed in turns beside its bound →
    {kernel: {ms, plain_ms, bound_ms, bound_by, err}}."""
    import torch
    from gdkvm_tpu_torch.core import gdr
    from gdkvm_tpu_torch.ops import gdr_counts, gdr_cuda
    gen = torch.Generator(device=device).manual_seed(8)
    out = {}
    for name, shape in (("serve", SHARD_SERVE), ("stream", SHARD_STREAM)):
        args = _gdr_inputs(gen, *shape, torch.bfloat16, device)
        o_k, s_k = gdr_cuda.gdr_fwd_cuda(*args)
        o_p, s_p = gdr.gdr_chunked(*args)
        torch.testing.assert_close(o_k, o_p, rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(s_k, s_p, rtol=RTOL, atol=ATOL)
        k_ms, p_ms, spread = _in_turns(lambda: gdr.gdr_chunked(*args),
                                       lambda: gdr_cuda.gdr_fwd_cuda(*args))
        print(f"distributed (viii) fwd at {shape} bf16 on {smi}: kernel {k_ms:.4f} ms, "
              f"plain {p_ms:.4f} ms ({spread}); max|Δo| {_abs(o_k, o_p):.3e}")
        out[f"fwd_{name}"] = dict(_bound(f"fwd at H=2, {name}", k_ms,
                                         gdr_counts.fwd_ops(*shape, exact=True),
                                         _nbytes(*args, o_k, s_k)),
                                  plain_ms=p_ms, err=max(_abs(o_k, o_p), _abs(s_k, s_p)))
    q, k, v, beta, alpha, s0 = _gdr_inputs(gen, *SHARD_TRAIN, torch.bfloat16, device)
    got = gdr_cuda.gdr_fwd_cuda_residuals(q, k, v, beta, alpha, s0)
    want = gdr.gdr_chunked_residuals(q, k, v, beta, alpha, s0)
    err_f = _check_rel(f"distributed (viii) fwd+residuals vs plain {SHARD_TRAIN}",
                       ("o", "s_T", "states", "U", "W"), got, want, FWD_REL)
    do = torch.randn(want[0].shape, device=device, generator=gen)
    ds_t = torch.randn(s0.shape, device=device, generator=gen)
    bargs = (q, k, v, beta, beta, alpha, want[2], do, ds_t)
    got_b = gdr_cuda.gdr_bwd_cuda(*bargs)
    err_b = _check_rel(f"distributed (viii) fused bwd vs plain {SHARD_TRAIN}",
                       ("dq", "dk", "dv", "dbeta", "deta", "dalpha", "ds0"), got_b,
                       gdr.gdr_bwd_ref(*bargs), BWD_REL)
    f_ms, f_plain, f_spread = _in_turns(
        lambda: gdr.gdr_chunked_residuals(q, k, v, beta, alpha, s0),
        lambda: gdr_cuda.gdr_fwd_cuda_residuals(q, k, v, beta, alpha, s0), iters=10)
    b_ms, b_plain, b_spread = _in_turns(lambda: gdr.gdr_bwd_ref(*bargs),
                                        lambda: gdr_cuda.gdr_bwd_cuda(*bargs), iters=10)
    print(f"distributed (viii) at {SHARD_TRAIN} bf16 q/k/v on {smi}: fwd+residuals kernel "
          f"{f_ms:.4f} ms, plain {f_plain:.4f} ms ({f_spread}); bwd kernel {b_ms:.4f} ms, "
          f"plain {b_plain:.4f} ms ({b_spread})")
    out["fwd_residuals"] = dict(_bound("fwd+residuals at H=2", f_ms,
                                       gdr_counts.fwd_ops(*SHARD_TRAIN, exact=True),
                                       _nbytes(q, k, v, beta, alpha, s0, *got)),
                                plain_ms=f_plain, err=err_f)
    out["bwd"] = dict(_bound("bwd at H=2", b_ms, gdr_counts.bwd_ops(*SHARD_TRAIN, exact=True),
                             _nbytes(*bargs, *got_b)), plain_ms=b_plain, err=err_b)
    q, k, v, beta, alpha, s0 = _gdr_inputs(gen, *SHARD_SERVE, torch.bfloat16, device)
    u, w = gdr_cuda._wy(k, v, beta, None)
    got_c = gdr_cuda.gdr_chain_cuda(q, k, u, w, alpha, s0, save_states=False)
    err_c = _check_rel(f"distributed (viii) chain vs plain {SHARD_SERVE}", ("o", "s_T"),
                       got_c[:2], gdr.gdr_chain(q, k, u, w, alpha, s0)[:2], CHAIN_REL)
    c_ms, c_plain, c_spread = _in_turns(
        lambda: gdr.gdr_chain(q, k, u, w, alpha, s0),
        lambda: gdr_cuda.gdr_chain_cuda(q, k, u, w, alpha, s0, save_states=False))
    print(f"distributed (viii) chain at {SHARD_SERVE} on {smi}: kernel {c_ms:.4f} ms, plain "
          f"{c_plain:.4f} ms ({c_spread})")
    out["chain"] = dict(_bound("chain at H=2, serve", c_ms,
                               gdr_counts.chain_ops(*SHARD_SERVE, exact=True),
                               _nbytes(q, k, u, w, alpha, s0, *got_c[:2])),
                        plain_ms=c_plain, err=err_c)
    return out


def _profiled_ms(fn, iters: int = 20, match: str | None = None) -> float | None:
    """Mean device time of a call of ``fn()`` (ms) as torch.profiler traces
    it over ``iters`` calls after 3: the kernels whose name holds ``match``
    (every kernel without one), summed and divided by ``iters``; None where
    it traces no device time.  The device's activity alone is traced: with
    the host's traced too, a ``record_function`` range (the optimizer's
    step) comes back as a device span over kernels already counted.  The
    sum holds the copies to and from the device beside the kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA and (match is None or match in e.name))
    return us / iters / 1e3 if us > 0 else None


def main() -> int:
    info = phase_device()
    import torch
    # fp32 products in full fp32 everywhere: the plain GDR drifts under TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda:0")
    os.environ.pop("GDKVM_GDR_BWD", None)
    os.environ.pop("GDKVM_GDR_FWD", None)
    t_start = time.perf_counter()

    def timed(phase, *args):
        """Run a phase and print the seconds it took and the run's so far."""
        t0 = time.perf_counter()
        out = phase(*args)
        now = time.perf_counter()
        print(f"{phase.__name__}: {now - t0:.1f} s ({now - t_start:.1f} s so far)")
        return out

    timed(phase_build)
    err_fwd = timed(phase_kernel_vs_plain, device)
    err_res, err_bwd = timed(phase_residuals_and_bwd, device)
    timed(phase_fused_vs_stored, device)
    err_bwd = max(err_bwd, timed(phase_bwd_phases_vs_plain, device))
    timed(phase_bf16_residuals, device)
    err_chain = timed(phase_chain_vs_plain, device)
    err_fwd = max(err_fwd, timed(phase_solve_vs_plain, device))
    stream = timed(phase_model, device)
    bench_entry = timed(phase_bench_entry, device, info, stream["fps"])
    serve = timed(phase_serve, device)
    export = timed(phase_export, device, serve)
    train_launches = timed(phase_train, device)
    chain_train_launches = timed(phase_chain_train, device)
    timed(phase_train_grads, device)
    run = timed(phase_train_run, device, info["pil"])
    gdn2 = timed(phase_gdn2, device)
    stream_eval_launches = timed(phase_stream_eval, device)
    cli_launches = timed(phase_cli, device, info, run["roots"])
    mount = timed(phase_mount_day, device, info)
    quant_model = timed(phase_quant_model, device, info)
    quant_cli = timed(phase_quant_cli, device, info, cli_launches)
    timed(phase_assoc, device, info)
    dist = timed(phase_distributed, device, info, run["roots"], serve)
    fixed = timed(phase_train_times, device)
    print("training steps/s: " + ", ".join(
        f"{kind} device_cache={cache} {r:.3f}" for (kind, cache), r in run["rates"].items())
        + " (train(cfg), data path inside); fixed batch "
        + ", ".join(f"{m} {statistics.mean(fixed[m]):.3f}" for m in ("stored", "fused")))
    timed(phase_serve_times, device, serve["model"])
    fwd_times = timed(phase_gdr_times, device)
    times = timed(phase_train_kernel_times, device)
    chain_times = timed(phase_chain_times, device)
    bench = timed(phase_bench_all, device, info)
    src = "gdkvm_tpu_torch/csrc/"
    # No one PyTorch call computes a GDR scan: no library yardstick.
    print(json.dumps({"kernels": [
        {"name": "gdr_fwd", "route": "cuda", "source": src + "gdr_fwd.cu",
         "replaces": "gdkvm_tpu/ops/gdr_pallas.py:513",
         "launches": stream["launches"] + serve["fwd_launches"] + export["fwd"]
         + train_launches["fwd"] + run["launches"]["fwd"] + gdn2["fwd"]
         + stream_eval_launches + cli_launches["fwd"] + mount["fwd"] + quant_model["fwd"]
         + quant_cli["fwd"] + dist["fwd"] + bench["fwd"] + bench_entry["fwd"],
         "max_abs_err": max(err_fwd, dist["shard"]["fwd_serve"]["err"],
                            dist["shard"]["fwd_stream"]["err"]),
         **fwd_times, "library_ms": None},
        {"name": "gdr_fwd_residuals", "route": "cuda", "source": src + "gdr_fwd.cu",
         "replaces": "gdkvm_tpu/ops/gdr_pallas.py:513",
         "launches": train_launches["residual"] + run["launches"]["residual"]
         + gdn2["residual"] + cli_launches["residual"] + mount["residual"] + dist["residual"]
         + bench["residual"],
         "max_abs_err": max(err_res, dist["shard"]["fwd_residuals"]["err"]),
         **times["fwd"], "library_ms": None},
        {"name": "gdr_bwd", "route": "cuda", "source": src + "gdr_bwd.cu",
         "replaces": "gdkvm_tpu/ops/gdr_pallas.py:724",
         "launches": train_launches["bwd"] + gdn2["bwd"] + cli_launches["bwd"]
         + dist["bwd"],
         "max_abs_err": max(err_bwd, dist["shard"]["bwd"]["err"]),
         **{k: v for k, v in times["bwd"].items() if k != "stored_ms"},
         "library_ms": None},
        {"name": "gdr_chain", "route": "cuda", "source": src + "gdr_chain.cuh",
         "replaces": "gdkvm_tpu/ops/gdr_pallas.py:585",
         "launches": serve["chain_launches"] + export["chain"]
         + chain_train_launches + cli_launches["chain"] + dist["chain"],
         "max_abs_err": max(err_chain, dist["shard"]["chain"]["err"]),
         **chain_times["serve"]["kernel"],
         "library_ms": None},
    ]}))
    print(f"card: {info['smi']}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-cli"]:          # a rank of phase_distributed
        sys.exit(_rank_cli(sys.argv[2:]))
    if sys.argv[1:2] == ["--rank-dist"]:
        sys.exit(_rank_dist(*sys.argv[2:]))
    if sys.argv[1:2] == ["--rank-train"]:
        sys.exit(_rank_train(*sys.argv[2:]))
    sys.exit(main())
