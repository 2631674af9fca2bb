"""Headline benchmark of the PyTorch port: EchoNet-shaped streaming LV
segmentation throughput on one NVIDIA GPU.

    python3 bench_torch.py [--device cpu]

Prints ONE JSON line: {"metric", "value", "unit", "device",
"apparent_tflops", "plausible"}.  ``device`` is the card's name and power
limit as ``nvidia-smi --query-gpu=name,power.limit`` reads them ("cpu" on
the CPU); ``apparent_tflops`` is the best rep's model FLOPs a second
(``eval/flops.py``'s count of a chunk, the same whichever GDR route runs)
and ``plausible`` says whether it is at most the card's dense bf16 peak
(None where the peak is not known, as on the CPU).  There is no baseline
ratio: the port's own numbers are its baseline.

The counterpart of ``bench.py`` (the JAX package's entry), with its knobs:

- ``GDKVM_BENCH_MODEL``: ``ts8`` (default; enc 64/64/128/192, blocks
  1/1/2/2, 4 heads × 64×64, KPFF 128/96, bf16 compute) or ``flagship``
  (the default ``ModelConfig``); 2 classes, 1 channel, weights from
  ``init_params`` with a generator seeded 0;
- ``GDKVM_BENCH_IMPL``: the model's ``gdr_impl`` (``auto``, default: the
  CUDA kernel on the card; ``chunked``, ``pallas``, ...);
- ``GDKVM_BENCH_QUANT=w8a8``: calibrate W8A8 scales (``ops/quant.py``,
  absmax, encoder scope) on two seeded batches of 8 frames and measure the
  quantized model;
- ``GDKVM_BENCH_CHUNK`` (32), ``GDKVM_BENCH_BATCH`` (8),
  ``GDKVM_BENCH_REPS`` (3), ``GDKVM_BENCH_TIMED_CHUNKS`` (30): frames a
  chunk, streams in flight, runs (the best kept) and timed chunks a run,
  each run after 3 warm-up chunks at 112².  Single-stream:
  ``GDKVM_BENCH_BATCH=1 GDKVM_BENCH_CHUNK=16``;
- ``GDKVM_BENCH_WATCHDOG_SEC`` (1500): a run that has not printed by then
  prints an error line and exits 3.

It runs on ``cuda:0`` unless ``--device`` says otherwise, and raises where
there is no card: nothing falls back to the CPU.  :func:`run` is the
measurement without the printing, for callers in the same process.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
from typing import List, Mapping

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

METRIC = "echonet_streaming_frames_per_sec_per_gpu"
IMAGE_SIZE = 112
WARMUP_CHUNKS = 3


def _arm_watchdog(seconds: float) -> threading.Timer:
    """Print an error line and exit 3 if no result came within ``seconds``
    (a stalled device path would otherwise print nothing at all)."""

    def fire():
        print(json.dumps({
            "metric": METRIC, "value": 0.0, "unit": "frames/sec",
            "error": f"watchdog: the device path stalled >{int(seconds)}s "
                     f"(no measurement possible)",
        }), flush=True)
        os._exit(3)

    timer = threading.Timer(seconds, fire)
    timer.daemon = True
    timer.start()
    return timer


def device_label(device) -> str:
    """``name, power.limit`` of the card that ``device`` is, as nvidia-smi
    prints them (the first card of its name), or "cpu"."""
    import torch
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    name = torch.cuda.get_device_name(device)
    for line in out.strip().splitlines():
        if line.startswith(name + ", "):
            return line
    raise RuntimeError(f"nvidia-smi lists no {name}: {out!r}")


def calibration_batches() -> List:
    """``bench.py``'s two W8A8 calibration batches: (1, 8, 112, 112, 1)
    float32 frames in [0, 1] from a numpy generator seeded 0."""
    import numpy as np
    rng = np.random.default_rng(0)
    return [rng.integers(0, 255, (1, 8, IMAGE_SIZE, IMAGE_SIZE, 1))
            .astype(np.float32) / 255.0 for _ in range(2)]


def w8a8_scales(model) -> dict:
    """The W8A8 arm's scales of ``model``: ``calibrate_act_scales`` (absmax,
    encoder scope) on :func:`calibration_batches`."""
    from gdkvm_tpu_torch.ops import quant
    return quant.calibrate_act_scales(model, calibration_batches())


def bench_model(env: Mapping[str, str], device):
    """The model that ``env`` names on ``device``, in eval mode."""
    import torch
    from gdkvm_tpu_torch.config.schema import ModelConfig
    from gdkvm_tpu_torch.models.gdkvm import GDKVM, init_params
    from gdkvm_tpu_torch.ops import quant

    impl = env.get("GDKVM_BENCH_IMPL", "auto")
    if env.get("GDKVM_BENCH_MODEL", "ts8") == "flagship":
        cfg = ModelConfig(num_classes=2, in_channels=1, gdr_impl=impl)
    else:
        cfg = ModelConfig(num_classes=2, in_channels=1, gdr_impl=impl,
                          enc_channels=(64, 64, 128, 192),
                          enc_blocks=(1, 1, 2, 2), num_heads=4,
                          head_dim_k=64, head_dim_v=64,
                          kpff_channels=(128, 96))
    model = init_params(GDKVM(cfg, device=device),
                        torch.Generator().manual_seed(0)).eval()
    if env.get("GDKVM_BENCH_QUANT") == "w8a8":
        with torch.inference_mode():
            model = quant.w8a8_model(model, w8a8_scales(model))
    return model


def run(env: Mapping[str, str] = os.environ, device: str = "cuda") -> dict:
    """Measure as ``env`` says (the ``GDKVM_BENCH_*`` knobs) on ``device``
    and return the JSON line's object."""
    import torch
    from gdkvm_tpu_torch.eval.throughput import measure_streaming_fps

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench_torch: no CUDA device (torch.cuda.is_available() "
                           "is False); pass --device cpu for a CPU run")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    model = bench_model(env, dev)
    runs = [measure_streaming_fps(
        model, dev, image_size=IMAGE_SIZE,
        chunk=int(env.get("GDKVM_BENCH_CHUNK", "32")),
        batch=int(env.get("GDKVM_BENCH_BATCH", "8")),
        warmup_chunks=WARMUP_CHUNKS,
        timed_chunks=int(env.get("GDKVM_BENCH_TIMED_CHUNKS", "30")))
        for _ in range(int(env.get("GDKVM_BENCH_REPS", "3")))]
    best = max(runs, key=lambda r: r["frames_per_sec"])
    return {"metric": METRIC, "value": round(best["frames_per_sec"], 1),
            "unit": "frames/sec", "device": device_label(dev),
            "apparent_tflops": best["apparent_tflops"],
            "plausible": best["plausible"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="bench_torch.py", description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda, which raises without a card)")
    args = p.parse_args(argv)
    watchdog = _arm_watchdog(float(os.environ.get("GDKVM_BENCH_WATCHDOG_SEC", "1500")))
    try:
        result = run(os.environ, args.device)
    finally:
        watchdog.cancel()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
