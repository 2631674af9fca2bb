"""Command-line interface of the port: ``python -m gdkvm_tpu_torch <command>
--config cfg.yaml key=value ...`` (port of gdkvm_tpu/cli.py: the same
commands, flags, defaults, JSON keys on stdout and exit codes).

Every command that runs the model takes ``--device`` (default ``cuda``) and
raises where that device is not there: nothing falls back to the CPU.  Pass
``--device cpu`` to run on the CPU.  ``train``, ``sweep``, ``bench --mode
train`` and ``bench --mode modules --grad`` run in grad mode; every other
command runs the model under ``torch.inference_mode()``, so the GDR takes
its residual-free forward.

``export`` writes a ``torch.export`` artifact of the streaming step
(io/export.py) for the one device type it runs on; ``serve-check``, ``serve
--artifact`` and ``infer --artifact`` load it on ``--device``, which must be
of that type.

``quant`` calibrates the W8A8 scales of ops/quant.py (``--check``: Dice and
frames/s in full precision and in W8A8); ``--quant-scales`` runs
``stream-eval``, ``export``, ``serve`` (checkpoint path) and ``parity`` on
the W8A8 model.  ``bench --mode all`` writes the regression artifact of
eval/regression.py.

``train`` and ``eval`` join the process group that ``torchrun`` (or the
JAX package's ``GDKVM_*`` variables) describes, one process per card
(parallel/distributed.py): ``torchrun --nproc_per_node=N -m gdkvm_tpu_torch
train --config ... parallel.model_axis=M`` trains on N cards laid out as a
N/M × M mesh, the LKVA heads split over each row of M, each rank on
``cuda:{LOCAL_RANK}`` (``--device cpu``: N CPU processes over gloo).  Only
rank 0 prints and writes.  ``serve --mesh auto|DxM`` splits the slot pool
over D rows of M devices in one process, the heads over each row: every
visible card for ``--device cuda``, D × M places on the one device
otherwise.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

def _split_args(argv):
    """Separate flag args from key=value overrides."""
    flags, overrides = [], []
    for a in argv:
        (overrides if ("=" in a and not a.startswith("-")) else flags).append(a)
    return flags, overrides


def _add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="device to run on (default cuda; raises without a "
                        "card; pass cpu to run on the CPU)")


def _device(name: str):
    import torch
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device; pass --device cpu "
                           f"to run on the CPU")
    return device


@contextlib.contextmanager
def _process_group(device):
    """Join the process group the environment describes (a no-op without
    one) → this rank's device (``device``, or ``cuda:{LOCAL_RANK}`` for an
    index-less card); the group is left on exit."""
    from gdkvm_tpu_torch.parallel import distributed
    joined = distributed.maybe_initialize_distributed(device=device)
    try:
        yield distributed.device() if joined else device
    finally:
        if joined:
            distributed.shutdown()


def _print_main(line: str) -> None:
    """Print on rank 0 alone (every rank holds the same result)."""
    from gdkvm_tpu_torch.parallel import distributed
    if distributed.is_main_process():
        print(line, flush=True)


def _load_model(cfg, checkpoint, device, action: str, require: bool = False,
                mesh=None):
    """The model to run, on ``device`` in eval mode, and its step: restored
    from ``checkpoint`` (default ``<run_dir>/checkpoints``) with the
    parameters to score in place (the EMA shadow when tracked and
    ``eval_stage.use_ema``), else a seeded init with a warning on stderr
    (an error under ``require``).  ``mesh``: a process group's mesh, whose
    model position's head shard this process holds."""
    import torch
    from gdkvm_tpu_torch.io.checkpoint import CheckpointManager
    from gdkvm_tpu_torch.models.gdkvm import GDKVM, init_params
    from gdkvm_tpu_torch.train.loop import eval_params, state_for

    heads = dict(heads=mesh.heads, model_group=mesh.model_group) if mesh else {}
    model = GDKVM(cfg.model, device=device, **heads)
    ckpt_dir = checkpoint or os.path.join(cfg.runtime.run_dir, "checkpoints")
    step = 0
    if os.path.isdir(ckpt_dir) and os.listdir(ckpt_dir):
        state = CheckpointManager(ckpt_dir).restore(state_for(cfg, model, mesh))
        with torch.no_grad():
            for p, v in zip(model.parameters(), eval_params(state, cfg)):
                if p is not v:
                    p.copy_(v)
        step = int(state.step)
    elif require:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    else:
        print(f"warning: no checkpoint under {ckpt_dir} — {action} an "
              f"UNTRAINED init", file=sys.stderr)
        init_params(model, torch.Generator().manual_seed(0))
    return model.eval(), step


def _w8a8(model, scales_path):
    """``model`` as it is, or its W8A8 copy with the scales of
    ``scales_path`` (``--quant-scales``)."""
    if not scales_path:
        return model
    from gdkvm_tpu_torch.ops import quant
    return quant.w8a8_model(model, quant.load_scales(scales_path))


def cmd_train(argv) -> int:
    from gdkvm_tpu_torch.config.schema import load_config
    from gdkvm_tpu_torch.train.loop import train
    flags, overrides = _split_args(argv)
    p = argparse.ArgumentParser(prog="gdkvm train")
    p.add_argument("--config", default=None, help="YAML config path")
    _add_device(p)
    args = p.parse_args(flags)
    cfg = load_config(args.config, overrides)
    with _process_group(_device(args.device)) as device:
        metrics = train(cfg, device=device)
        _print_main(json.dumps({"final": metrics}))
    return 0


def cmd_eval(argv) -> int:
    import torch
    from gdkvm_tpu_torch.config.schema import load_config
    from gdkvm_tpu_torch.eval.evaluator import evaluate
    from gdkvm_tpu_torch.parallel.mesh import run_mesh

    flags, overrides = _split_args(argv)
    p = argparse.ArgumentParser(prog="gdkvm eval")
    p.add_argument("--config", default=None)
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint dir (defaults to <run_dir>/checkpoints)")
    _add_device(p)
    args = p.parse_args(flags)
    cfg = load_config(args.config, overrides)
    with _process_group(_device(args.device)) as device:
        mesh = run_mesh(cfg, device)
        model, step = _load_model(cfg, args.checkpoint, device, "scoring",
                                  require=True, mesh=mesh)
        with torch.inference_mode():
            metrics = evaluate(cfg, model, device, step=step, mesh=mesh)
        _print_main(json.dumps(metrics))
    return 0


def cmd_bench(argv) -> int:
    import numpy as np
    import torch
    from gdkvm_tpu_torch.config.schema import load_config
    from gdkvm_tpu_torch.eval.throughput import (measure_streaming_fps,
                                                 measure_streaming_latency,
                                                 measure_train_step_time)
    from gdkvm_tpu_torch.models.gdkvm import (GDKVM, init_params,
                                              train_model_config)

    flags, overrides = _split_args(argv)
    p = argparse.ArgumentParser(prog="gdkvm bench")
    p.add_argument("--config", default=None)
    p.add_argument("--mode", choices=("stream", "train", "latency",
                                      "modules", "all"),
                   default="stream")
    p.add_argument("--chunk", type=int, default=16)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--image-size", type=int, default=112)
    p.add_argument("--grad", action="store_true",
                   help="modules mode: fwd+bwd (train-step) breakdown "
                        "using the training model config")
    p.add_argument("--out", default="bench_all.json",
                   help="all mode: consolidated artifact path")
    p.add_argument("--smoke", action="store_true",
                   help="all mode: tiny shapes/model (a CPU contract run)")
    _add_device(p)
    args = p.parse_args(flags)

    if args.mode == "all":
        # The artifact measures fixed shapes (that is the point of a
        # regression artifact): a shape or config flag would be ignored,
        # so it is refused.
        unused = [flag for flag, passed in (
            ("--config", args.config is not None),
            ("--chunk", args.chunk != 16), ("--batch", args.batch != 1),
            ("--image-size", args.image_size != 112),
            ("--grad", args.grad)) if passed]
        if overrides:
            unused.append("dotted config overrides")
        if unused:
            p.error(f"--mode all ignores {', '.join(unused)}: the "
                    f"artifact's shapes are fixed by the schema "
                    f"(eval/regression.py)")
        from gdkvm_tpu_torch.eval.regression import (bench_all, failed_sections,
                                                     validate_artifact,
                                                     write_artifact)
        artifact = bench_all(_device(args.device), smoke=args.smoke)
        validate_artifact(artifact)
        write_artifact(artifact, args.out)
        print(json.dumps(artifact))
        failed = failed_sections(artifact)
        if failed and not args.smoke:
            # Fault isolation keeps one broken section from killing the
            # artifact, but a run with errored sections must not exit 0.
            print(f"bench --mode all: {len(failed)} section(s) errored: "
                  f"{', '.join(failed)}", file=sys.stderr)
            return 1
        return 0

    cfg = load_config(args.config, overrides)
    device = _device(args.device)
    shape = dict(image_size=args.image_size, chunk=args.chunk, batch=args.batch)

    def seeded(model_cfg):
        return init_params(GDKVM(model_cfg, device=device),
                           torch.Generator().manual_seed(0))

    if args.mode == "modules" and args.grad:
        from gdkvm_tpu_torch.eval.modulebench import grad_breakdown
        from gdkvm_tpu_torch.train.loop import Optimizer
        model = seeded(train_model_config(cfg.model, args.image_size))
        result = grad_breakdown(model, **shape,
                                opt=Optimizer(list(model.parameters()), cfg))
    elif args.mode == "modules":
        from gdkvm_tpu_torch.eval.modulebench import module_breakdown
        result = module_breakdown(seeded(cfg.model).eval(), **shape)
    elif args.mode == "latency":
        result = measure_streaming_latency(seeded(cfg.model).eval(), device,
                                           **shape)
    elif args.mode == "train":
        from gdkvm_tpu_torch.data.pipeline import Batch
        from gdkvm_tpu_torch.train.loop import state_for, train_step
        cfg.data.image_size = args.image_size
        state = state_for(cfg, seeded(train_model_config(cfg.model,
                                                         args.image_size)))
        b, t = cfg.train.batch_size, cfg.data.clip_len
        rng = np.random.default_rng(0)
        to_dev = lambda a: torch.from_numpy(a).to(device)
        batch = Batch(
            frames=to_dev(rng.integers(0, 255, (b, t, args.image_size,
                                                args.image_size, 1), np.uint8)),
            masks=to_dev(rng.integers(0, cfg.model.num_classes,
                                      (b, t, args.image_size, args.image_size)
                                      ).astype(np.uint8)),
            valid=to_dev(np.ones((b, t), np.float32)))
        result = measure_train_step_time(
            lambda: train_step(state, batch, cfg), device)
        result["train_frames_per_sec"] = result["steps_per_sec"] * b * t
        result["batch_size"] = b
        result["clip_len"] = t
        result["image_size"] = args.image_size
    else:
        result = measure_streaming_fps(seeded(cfg.model).eval(), device,
                                       **shape)
    print(json.dumps(result))
    return 0


def cmd_stream_eval(argv) -> int:
    """Full-sequence streaming eval (Dice + fps) with chunked recurrence."""
    import torch
    from gdkvm_tpu_torch.config.schema import load_config
    from gdkvm_tpu_torch.eval.streaming import stream_evaluate

    flags, overrides = _split_args(argv)
    p = argparse.ArgumentParser(prog="gdkvm stream-eval")
    p.add_argument("--config", default=None)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--num-videos", type=int, default=8)
    p.add_argument("--video-len", type=int, default=128)
    p.add_argument("--reset-state", action="store_true",
                   help="ablation: zero the memory between chunks")
    p.add_argument("--occlude", action="store_true",
                   help="robustness probe: blank an LV-covering region "
                        "around the last traced frame")
    p.add_argument("--streams", type=int, default=None,
                   help="videos in flight as one batched recurrence "
                        "(serving mode; default eval_stage.streams)")
    p.add_argument("--consistency", action="store_true",
                   help="also report temporal prediction stability "
                        "(fg IoU between consecutive frames, flicker "
                        "rate; single-stream mode only)")
    p.add_argument("--quant-scales", default=None,
                   help="W8A8 scales JSON from `quant`: evaluate the "
                        "quantized serving path")
    _add_device(p)
    args = p.parse_args(flags)
    cfg = load_config(args.config, overrides)
    model, _ = _load_model(cfg, args.checkpoint, _device(args.device), "scoring")
    model = _w8a8(model, args.quant_scales)
    with torch.inference_mode():
        out = stream_evaluate(cfg, model, num_videos=args.num_videos,
                              video_len=args.video_len,
                              reset_state=args.reset_state,
                              occlude=args.occlude,
                              streams=args.streams if args.streams is not None
                              else cfg.eval_stage.streams,
                              consistency=args.consistency)
    print(json.dumps(out))
    return 0


def cmd_quant(argv) -> int:
    """Calibrate W8A8 activation scales for quantized serving
    (ops/quant.py), optionally with a measured quality check.

    W8A8 adds launches around each int8 product, so whether it pays is a
    measurement per card and shape, and its quality one per checkpoint:
    calibrate, then ``--check``, never enable blind.
    """
    import numpy as np
    import torch
    from gdkvm_tpu_torch.config.schema import load_config
    from gdkvm_tpu_torch.ops import quant

    flags, overrides = _split_args(argv)
    p = argparse.ArgumentParser(prog="gdkvm quant")
    p.add_argument("--config", default=None)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--out", default=None,
                   help="scales JSON (default <run_dir>/quant_scales.json)")
    p.add_argument("--scope", default="encoder", choices=list(quant.SCOPES),
                   help="which convs to calibrate")
    p.add_argument("--calib-clips", type=int, default=4)
    p.add_argument("--method", default="absmax", choices=list(quant.METHODS),
                   help="activation-range statistic: absmax (exact) or "
                        "percentile (robust to speckle outliers)")
    p.add_argument("--percentile", type=float, default=99.9,
                   help="percentile of |x| when --method percentile")
    p.add_argument("--check", action="store_true",
                   help="run streaming eval full-precision vs w8a8 and "
                        "report the Dice delta + throughput both ways")
    p.add_argument("--num-videos", type=int, default=4)
    p.add_argument("--video-len", type=int, default=64)
    _add_device(p)
    args = p.parse_args(flags)
    cfg = load_config(args.config, overrides)
    model, _ = _load_model(cfg, args.checkpoint, _device(args.device),
                           "calibrating")

    # Calibration clips: the configured dataset's val clips where it is
    # mounted, else the synthetic generator (stream_evaluate's fallback).
    s, k = cfg.data.image_size, cfg.model.num_classes
    batches = []
    if cfg.data.dataset != "synthetic":
        try:
            from gdkvm_tpu_torch.data.pipeline import make_dataset
            ds = make_dataset(cfg.data, cfg.data.val_split, k)
            for i in range(min(args.calib_clips, len(ds))):
                frames = ds[i][0]                      # (T,H,W,1) uint8
                batches.append(frames[None].astype(np.float32) / 255.0)
        except (OSError, ValueError, KeyError, RuntimeError) as exc:
            print(f"warning: {cfg.data.dataset} calibration clips "
                  f"unavailable ({exc}); falling back to synthetic",
                  file=sys.stderr)
    if not batches:
        from gdkvm_tpu_torch.data import synthetic
        for i in range(args.calib_clips):
            f, _ = synthetic.generate_video(7000 + i, cfg.data.clip_len, s, s,
                                            k, cfg.data.synth_difficulty)
            batches.append(f[None].astype(np.float32) / 255.0)

    with torch.inference_mode():
        scales = quant.calibrate_act_scales(model, batches, scope=args.scope,
                                            method=args.method,
                                            percentile=args.percentile)
    out_path = args.out or os.path.join(cfg.runtime.run_dir,
                                        "quant_scales.json")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    quant.save_scales(out_path, scales)
    result = {"scales": out_path, "n_convs": len(scales),
              "scope": args.scope, "method": args.method}

    if args.check:
        from gdkvm_tpu_torch.eval.streaming import stream_evaluate
        qmodel = quant.w8a8_model(model, scales)
        kw = dict(num_videos=args.num_videos, video_len=args.video_len,
                  streams=cfg.eval_stage.streams)
        with torch.inference_mode():
            fp = stream_evaluate(cfg, model, **kw)
            q8 = stream_evaluate(cfg, qmodel, **kw)
        result["check"] = {
            "dice_fg_fp": fp.get("dice_fg_mean"),
            "dice_fg_w8a8": q8.get("dice_fg_mean"),
            "dice_fg_delta": (None if "dice_fg_mean" not in fp else
                              q8["dice_fg_mean"] - fp["dice_fg_mean"]),
            "fps_fp": fp.get("stream_frames_per_sec"),
            "fps_w8a8": q8.get("stream_frames_per_sec"),
        }
    print(json.dumps(result))
    return 0


def cmd_scale(argv) -> int:
    """Predictable-Scale calculator: optimal batch size and learning rate."""
    from gdkvm_tpu_torch.utils.scaling import optimal_bs_lr
    p = argparse.ArgumentParser(prog="gdkvm scale")
    p.add_argument("-N", "--model-params", required=True,
                   help="model size, e.g. 1e8 or 3.5x10^6")
    p.add_argument("-D", "--tokens", required=True,
                   help="training tokens, e.g. 2e10")
    args = p.parse_args(argv)
    try:
        out = optimal_bs_lr(args.model_params, args.tokens)
    except ValueError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    print(json.dumps(out))
    return 0


def cmd_pack(argv) -> int:
    """Convert a clip dataset into the packed (PCK) decode-once format."""
    from gdkvm_tpu_torch.config.schema import load_config
    from gdkvm_tpu_torch.data.packed import write_pck
    from gdkvm_tpu_torch.data.pipeline import make_dataset

    flags, overrides = _split_args(argv)
    p = argparse.ArgumentParser(prog="gdkvm pack")
    p.add_argument("--config", default=None)
    p.add_argument("--out", required=True, help="output directory for "
                   "<split>.pck files")
    p.add_argument("--splits", default="train,val")
    args = p.parse_args(flags)
    cfg = load_config(args.config, overrides)
    os.makedirs(args.out, exist_ok=True)
    written = {}
    for split in args.splits.split(","):
        ds = make_dataset(cfg.data, split, cfg.model.num_classes)
        path = os.path.join(args.out, f"{split}.pck")
        write_pck(path, ds)
        written[split] = {"path": path, "clips": len(ds),
                          "bytes": os.path.getsize(path)}
    print(json.dumps(written))
    return 0


def cmd_info(argv) -> int:
    """Environment and config diagnostics: versions, devices, and the
    fully resolved config for a given YAML + overrides."""
    import importlib

    flags, overrides = _split_args(argv)
    p = argparse.ArgumentParser(prog="gdkvm info")
    p.add_argument("--config", default=None)
    p.add_argument("--probe", action="store_true",
                   help="also run a tiny round trip to the card (latency ms; "
                        "null without one)")
    args = p.parse_args(flags)

    import gdkvm_tpu_torch
    out = {"gdkvm_tpu_torch": gdkvm_tpu_torch.__version__}
    for mod in ("torch", "numpy"):
        try:
            out[mod] = importlib.import_module(mod).__version__
        except Exception:
            out[mod] = None
    import torch
    out["cuda"] = torch.version.cuda
    have_card = torch.cuda.is_available()
    out["platform"] = "gpu" if have_card else "cpu"
    out["devices"] = ([torch.cuda.get_device_name(i)
                       for i in range(torch.cuda.device_count())]
                      if have_card else [])
    from gdkvm_tpu_torch.data.packed import _load_native
    out["pck_native_loader"] = _load_native() is not None
    if args.probe and have_card:
        import time
        x = torch.arange(8, dtype=torch.float32).to("cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x.cpu()
        out["device_roundtrip_ms"] = round(
            (time.perf_counter() - t0) * 1e3, 2)
    elif args.probe:
        out["device_roundtrip_ms"] = None
        print("warning: --probe found no CUDA device; nothing was timed",
              file=sys.stderr)
    if args.config or overrides:
        from gdkvm_tpu_torch.config.schema import load_config, to_dict
        out["config"] = to_dict(load_config(args.config, overrides))
    print(json.dumps(out, default=str))
    return 0


def cmd_sweep(argv) -> int:
    """Run the cartesian product of swept overrides one after another, one
    run dir per combination, and summarize.

    Swept values are a comma list in the override value: ``sweep --config
    c.yaml learning_rate=1e-4,3e-4 batch_size=4,8`` runs 4 trainings under
    <run_dir>/sweep/<combo>/ and prints a ranked summary (by
    eval/dice_fg_mean, then loss).

    Bracketed values are never swept: pass tuple-typed config fields as
    ``model.enc_channels=[16,32,48,64]`` to pin them while sweeping other
    keys.  A combo that raises is recorded with an ``error`` field and the
    sweep continues.
    """
    import itertools
    import math
    from gdkvm_tpu_torch.config.schema import load_config
    from gdkvm_tpu_torch.train.loop import train

    flags, overrides = _split_args(argv)
    p = argparse.ArgumentParser(prog="gdkvm sweep")
    p.add_argument("--config", default=None)
    p.add_argument("--metric", default="eval/dice_fg_mean",
                   help="ranking metric from the final metrics "
                        "(higher better unless it contains 'loss')")
    _add_device(p)
    args = p.parse_args(flags)

    fixed, swept = [], []
    for ov in overrides:
        key, _, val = ov.partition("=")
        if "," in val and not val.startswith("["):
            swept.append((key, val.split(",")))
        else:
            fixed.append(ov)
    if not swept:
        print("error: no swept overrides (use key=v1,v2,...)",
              file=sys.stderr)
        return 2

    device = _device(args.device)
    base_cfg = load_config(args.config, fixed)
    base_dir = os.path.join(base_cfg.runtime.run_dir, "sweep")
    results = []
    combos = list(itertools.product(*(vals for _, vals in swept)))
    for ci, combo in enumerate(combos):
        combo_ovs = [f"{key}={val}"
                     for (key, _), val in zip(swept, combo)]
        # The index keeps run dirs apart even when joined values collide.
        tag = f"{ci:02d}_" + "_".join(
            f"{key.rsplit('.', 1)[-1]}-{v.replace('/', '-')}"
            for (key, _), v in zip(swept, combo))
        run_dir = os.path.join(base_dir, tag)
        cfg = load_config(args.config,
                          fixed + combo_ovs + [f"runtime.run_dir={run_dir}"])
        try:
            metrics = train(cfg, device=device)
        except Exception as exc:     # a failing combo must not end the grid
            row = {"overrides": combo_ovs, "run_dir": run_dir,
                   "error": f"{type(exc).__name__}: {exc}"}
            results.append(row)
            print(json.dumps(row), flush=True)
            continue
        row = {"overrides": combo_ovs, "run_dir": run_dir, **{
            k: v for k, v in metrics.items()
            if isinstance(v, (int, float))}}
        results.append(row)
        print(json.dumps(row), flush=True)

    m = args.metric
    lower_better = "loss" in m
    scored = [r for r in results
              if m in r and not math.isnan(r[m])]
    scored.sort(key=lambda r: r[m], reverse=not lower_better)
    print(json.dumps({"sweep_best": scored[0] if scored else None,
                      "metric": m, "runs": len(results)}))
    return 0


def cmd_infer(argv) -> int:
    """Run a trained model (or exported artifact) on a cine file: AVI/MP4,
    raw CAMUS .mhd, or a directory of PNG frames → masks.npz + overlays."""
    from gdkvm_tpu_torch.config.schema import load_config
    from gdkvm_tpu_torch.eval.infer import (artifact_image_size, load_frames,
                                            run_inference)
    from gdkvm_tpu_torch.io.export import load_artifact

    flags, overrides = _split_args(argv)
    p = argparse.ArgumentParser(prog="gdkvm infer")
    p.add_argument("--config", default=None)
    p.add_argument("--input", required=True,
                   help=".avi/.mp4, .mhd, or a directory of PNG frames")
    p.add_argument("--out", required=True, help="output directory")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint dir (defaults to <run_dir>/checkpoints)")
    p.add_argument("--artifact", default=None,
                   help="exported artifact dir (replaces checkpoint+model; "
                        "exported for --device's type)")
    p.add_argument("--chunk", type=int, default=16)
    p.add_argument("--overlay-every", type=int, default=0,
                   help="write an overlay PNG every N frames (0 = none)")
    p.add_argument("--device-resize", action="store_true",
                   help="decode at the file's resolution and resize on the "
                        "device inside the model step: the host only "
                        "decodes")
    _add_device(p)
    args = p.parse_args(flags)
    cfg = load_config(args.config, overrides)
    device = _device(args.device)
    if args.artifact:
        # Decode at the size the artifact was exported for, not the
        # config's: the exported program has a fixed input signature.
        sm = load_artifact(args.artifact, device)
        frames = load_frames(args.input, artifact_image_size(args.artifact))
        summary = run_inference(frames, args.out, artifact=sm,
                                overlay_every=args.overlay_every)
    else:
        frames = load_frames(args.input, cfg.data.image_size,
                             host_resize=not args.device_resize)
        model, _ = _load_model(cfg, args.checkpoint, device, "running")
        summary = run_inference(frames, args.out, model=model, chunk=args.chunk,
                                overlay_every=args.overlay_every,
                                model_size=(cfg.data.image_size
                                            if args.device_resize else None))
    print(json.dumps(summary))
    return 0


def cmd_export(argv) -> int:
    """Export a trained model as a ``torch.export`` serving artifact
    (frames in → logits and state out, parameters in the program), for the
    device type of ``--device``."""
    from gdkvm_tpu_torch.config.schema import load_config
    from gdkvm_tpu_torch.io.export import save_artifact

    flags, overrides = _split_args(argv)
    p = argparse.ArgumentParser(prog="gdkvm export")
    p.add_argument("--config", default=None)
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint dir (defaults to <run_dir>/checkpoints; "
                        "untrained init if absent)")
    p.add_argument("--out", required=True, help="artifact directory")
    p.add_argument("--chunk", type=int, default=16)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--image-size", type=int, default=None,
                   help="default: data.image_size")
    p.add_argument("--platforms", default=None,
                   help="the one device type to export for (cuda or cpu, "
                        "--device's); a list of more than one raises")
    p.add_argument("--quant-scales", default=None,
                   help="W8A8 scales JSON from `quant`: bake the quantized "
                        "conv path into the artifact")
    _add_device(p)
    args = p.parse_args(flags)
    cfg = load_config(args.config, overrides)
    model, _ = _load_model(cfg, args.checkpoint, _device(args.device),
                           "exporting")
    model = _w8a8(model, args.quant_scales)
    platforms = args.platforms.split(",") if args.platforms else None
    meta = save_artifact(args.out, model,
                         image_size=args.image_size or cfg.data.image_size,
                         chunk=args.chunk, batch=args.batch,
                         platforms=platforms)
    print(json.dumps({"out": args.out, "blob_bytes": meta["blob_bytes"],
                      "platforms": meta["platforms"],
                      "signature": meta["signature"]}))
    return 0


def cmd_serve_check(argv) -> int:
    """Load an exported artifact and run a random chunk through it."""
    import time
    import numpy as np
    import torch
    from gdkvm_tpu_torch.io.export import load_artifact

    p = argparse.ArgumentParser(prog="gdkvm serve-check")
    p.add_argument("--artifact", required=True)
    p.add_argument("--chunks", type=int, default=4)
    _add_device(p)
    args = p.parse_args(argv)
    sm = load_artifact(args.artifact, _device(args.device))
    sig = sm.meta["signature"]
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(
        rng.integers(0, 255, sig["frames_u8"], np.uint8)).to(sm.device)
    mem, seen = sm.init_state()
    logits = None
    t0 = time.perf_counter()
    for _ in range(args.chunks):
        logits, mem, seen = sm.step(frames, mem, seen)
    seen = seen.cpu()
    dt = time.perf_counter() - t0
    n_frames = args.chunks * sig["frames_u8"][0] * sig["frames_u8"][1]
    print(json.dumps({
        "ok": bool(torch.isfinite(logits).all()),
        "logits_shape": list(logits.shape),
        "frames_seen": seen.tolist(),
        "frames_per_sec_incl_compile": round(n_frames / dt, 1),
    }))
    return 0


def _serving_mesh(device, data: int, model: int):
    """The mesh of ``serve --mesh``: over every visible card for an
    index-less CUDA device, else ``data × model`` places on ``device``
    (data = -1: one row)."""
    import torch
    from gdkvm_tpu_torch.parallel.mesh import make_mesh
    if device.type == "cuda" and device.index is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devices = [device] * (max(data, 1) * model)
    return make_mesh(data, model, devices)


def cmd_serve(argv) -> int:
    """Run the multi-stream streaming-segmentation HTTP server (serve.py: a
    session per stream, the GDR state held server-side, one multi-stream
    model call a tick).  The first line on stdout is a JSON object with the
    bound host and port; SIGINT ends the server with exit code 0."""
    from gdkvm_tpu_torch.config.schema import load_config
    from gdkvm_tpu_torch.serve import BatchingEngine, make_server

    flags, overrides = _split_args(argv)
    p = argparse.ArgumentParser(prog="gdkvm serve")
    p.add_argument("--config", default=None)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--artifact", default=None,
                   help="exported artifact dir (must match --streams/--chunk; "
                        "exported for --device's type)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8477)
    p.add_argument("--streams", type=int, default=None,
                   help="stream slots (default eval_stage.streams)")
    p.add_argument("--chunk", type=int, default=None,
                   help="frames per device call (default "
                        "eval_stage.stream_chunk)")
    p.add_argument("--max-inflight-mb", type=float, default=256.0,
                   help="in-flight request byte budget; beyond it infer "
                        "returns HTTP 429 instead of queueing")
    p.add_argument("--session-ttl", type=float, default=300.0,
                   help="idle-session GC: reclaim a slot whose client "
                        "has been silent this many seconds (0 disables)")
    p.add_argument("--no-warmup", action="store_true",
                   help="skip the constructor's warm-up tick")
    p.add_argument("--no-pack", action="store_true",
                   help="disable bit-packed mask fetch (debugging)")
    p.add_argument("--quant-scales", default=None,
                   help="W8A8 scales JSON from `quant`: serve the quantized "
                        "conv path (checkpoint path only)")
    p.add_argument("--mesh", default=None,
                   help="split the slot pool over devices: 'auto' (config "
                        "parallel.{data_axis,model_axis}) or 'DxM', e.g. 2x2: "
                        "D slot groups, the heads of each over M devices; "
                        "streams must divide by D (checkpoint path only)")
    _add_device(p)
    args = p.parse_args(flags)
    cfg = load_config(args.config, overrides)
    mesh_shape = None
    for flag, value in (("--mesh", args.mesh), ("--quant-scales", args.quant_scales)):
        if args.artifact and value:
            print(f"error: {flag} applies to the checkpoint path; an artifact "
                  f"is an already-lowered program for one device", file=sys.stderr)
            return 2
    if args.mesh:
        if args.mesh == "auto":
            mesh_shape = (cfg.parallel.data_axis, cfg.parallel.model_axis)
        else:
            try:
                d, m = (int(x) for x in args.mesh.lower().split("x"))
            except ValueError:
                print(f"error: --mesh must be 'auto' or 'DxM', got "
                      f"{args.mesh!r}", file=sys.stderr)
                return 2
            mesh_shape = (d, m)
    streams = args.streams or max(cfg.eval_stage.streams, 1)
    chunk = args.chunk or cfg.eval_stage.stream_chunk
    device = _device(args.device)
    ekw = dict(streams=streams, chunk=chunk,
               max_inflight_mb=args.max_inflight_mb, warmup=not args.no_warmup,
               pack_masks=not args.no_pack, session_ttl=args.session_ttl or None)
    if mesh_shape is not None:
        ekw["mesh"] = _serving_mesh(device, *mesh_shape)
    if args.artifact:
        from gdkvm_tpu_torch.io.export import load_artifact
        engine = BatchingEngine(artifact=load_artifact(args.artifact, device),
                                **ekw)
    else:
        model, _ = _load_model(cfg, args.checkpoint, device, "serving")
        engine = BatchingEngine(model=_w8a8(model, args.quant_scales),
                                image_size=cfg.data.image_size,
                                **ekw)
    srv = make_server(engine, args.host, args.port)
    print(json.dumps({"serving": True,
                      "host": srv.server_address[0],
                      "port": srv.server_address[1],
                      "streams": engine.streams, "chunk": engine.chunk,
                      "image_size": engine.image_size}), flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
        engine.close()
    return 0


def cmd_serve_bench(argv) -> int:
    """Client-side latency/throughput probe against a running ``serve``:
    opens N concurrent sessions, streams synthetic videos, reports
    submit→mask latency percentiles per request and aggregate frames/s."""
    import threading
    import time
    import numpy as np
    from gdkvm_tpu_torch.serve import ServeClient

    p = argparse.ArgumentParser(prog="gdkvm serve-bench")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8477)
    p.add_argument("--sessions", type=int, default=4)
    p.add_argument("--frames", type=int, default=256,
                   help="frames streamed per session")
    p.add_argument("--frames-per-request", type=int, default=None,
                   help="frames per HTTP request (default: one chunk, the "
                        "live-scanner pattern; larger requests are split "
                        "server-side and pipeline across ticks, the "
                        "cine-upload pattern)")
    args = p.parse_args(argv)

    probe = ServeClient(args.host, args.port)
    info = probe.health()
    chunk, size = info["chunk"], info["image_size"]
    req_frames = args.frames_per_request or chunk
    lat_lock = threading.Lock()
    lats, errors = [], []

    def run_session(i):
        rng = np.random.default_rng(i)
        # The test chunks are made before the timed loop: making them is
        # the probe's cost, not the server's.
        n_reqs = (args.frames + req_frames - 1) // req_frames
        videos = [rng.integers(0, 255, (req_frames, size, size, 1),
                               np.uint8) for _ in range(min(n_reqs, 8))]
        try:
            c = ServeClient(args.host, args.port)
            c.open()
            done = 0
            j = 0
            while done < args.frames:
                t0 = time.perf_counter()
                masks = c.infer(videos[j % len(videos)])
                dt = time.perf_counter() - t0
                assert masks.shape == (req_frames, size, size)
                with lat_lock:
                    lats.append(dt)
                done += req_frames
                j += 1
            c.close()
        except Exception as exc:
            with lat_lock:
                errors.append(f"{type(exc).__name__}: {exc}")

    threads = [threading.Thread(target=run_session, args=(i,))
               for i in range(args.sessions)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        print(json.dumps({"ok": False, "errors": errors[:3]}))
        return 1
    ms = np.array(lats) * 1e3
    total_frames = args.sessions * args.frames
    print(json.dumps({
        "ok": True,
        "sessions": args.sessions,
        "chunk": chunk,
        "frames_per_request": req_frames,
        "frames_total": total_frames,
        "frames_per_sec": round(total_frames / wall, 1),
        "request_latency_ms_p50": round(float(np.percentile(ms, 50)), 2),
        "request_latency_ms_p95": round(float(np.percentile(ms, 95)), 2),
        "request_latency_ms_p99": round(float(np.percentile(ms, 99)), 2),
        "latency_ms_per_frame_p50": round(
            float(np.percentile(ms, 50)) / req_frames, 3),
    }))
    return 0


def cmd_parity(argv) -> int:
    """Clinical parity protocols: CAMUS official ED/ES per-patient scoring
    (Dice + HD95 per structure and view), CAMUS biplane EF, EchoNet EF from
    predicted masks, or the memory ablation (eval/parity.py has the
    protocols' definitions).  The table goes to stderr, the JSON to stdout."""
    import torch
    from gdkvm_tpu_torch.config.schema import load_config
    from gdkvm_tpu_torch.eval import parity

    flags, overrides = _split_args(argv)
    p = argparse.ArgumentParser(prog="gdkvm parity")
    p.add_argument("--config", default=None)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--protocol",
                   choices=("camus", "camus-ef", "echonet-ef", "auto"),
                   default="auto", help="auto = by data.dataset")
    p.add_argument("--split", default=None,
                   help="default: data.val_split (camus) / VAL (echonet)")
    p.add_argument("--num-videos", type=int, default=None,
                   help="echonet-ef: cap videos scored")
    p.add_argument("--max-patients", type=int, default=None,
                   help="camus: cap patients scored")
    p.add_argument("--folds", type=int, default=None,
                   help="camus: k-fold CV aggregation (the CAMUS "
                        "challenge protocol is 10-fold) instead of the "
                        "fixed split: mean ± std of per-fold mean Dice")
    p.add_argument("--no-hd95", action="store_true")
    p.add_argument("--ablate", action="store_true",
                   help="memory-contribution 2x2 study ({clean,occluded} x "
                        "{carry,reset}) on the configured benchmark instead "
                        "of a clinical protocol (parity.memory_ablation)")
    p.add_argument("--ablate-videos", type=int, default=8)
    p.add_argument("--ablate-video-len", type=int, default=64)
    p.add_argument("--quant-scales", default=None,
                   help="W8A8 scales JSON from `quant`: score the quantized "
                        "serving path (e.g. --ablate to check the memory's "
                        "robustness survives quantization)")
    _add_device(p)
    args = p.parse_args(flags)
    cfg = load_config(args.config, overrides)
    model, _ = _load_model(cfg, args.checkpoint, _device(args.device), "scoring")
    model = _w8a8(model, args.quant_scales)

    protocol = args.protocol
    if protocol == "auto":
        protocol = "echonet-ef" if cfg.data.dataset == "echonet" else "camus"
    with torch.inference_mode():
        if args.ablate:
            out = parity.memory_ablation(cfg, model,
                                         num_videos=args.ablate_videos,
                                         video_len=args.ablate_video_len)
        elif protocol == "camus" and args.folds:
            out = parity.camus_official_folds(
                cfg, model, folds=args.folds,
                split=args.split or cfg.data.val_split,
                with_hd95=not args.no_hd95)
        elif protocol == "camus":
            out = parity.camus_official(
                cfg, model, split=args.split or cfg.data.val_split,
                with_hd95=not args.no_hd95, max_patients=args.max_patients)
        elif protocol == "camus-ef":
            out = parity.camus_ef(
                cfg, model, split=args.split or cfg.data.val_split,
                max_patients=args.max_patients)
        else:
            out = parity.echonet_ef(cfg, model, split=args.split or "VAL",
                                    num_videos=args.num_videos)
    table = out.pop("table", None)
    if table:
        print(table, file=sys.stderr)
    print(json.dumps(out))
    return 0


def cmd_validate_data(argv) -> int:
    """Dataset layout health check: counts, geometry, class histogram,
    annotation coverage.  Run it before pointing a training run at a
    freshly mounted CAMUS or EchoNet layout."""
    import numpy as np
    from gdkvm_tpu_torch.config.schema import load_config
    from gdkvm_tpu_torch.data.pipeline import make_dataset

    flags, overrides = _split_args(argv)
    p = argparse.ArgumentParser(prog="gdkvm validate-data")
    p.add_argument("--config", default=None)
    p.add_argument("--splits", default=None,
                   help="comma list (default: train_split,val_split)")
    p.add_argument("--sample", type=int, default=4,
                   help="clips to decode per split for the histogram")
    args = p.parse_args(flags)
    cfg = load_config(args.config, overrides)
    splits = (args.splits.split(",") if args.splits
              else [cfg.data.train_split, cfg.data.val_split])

    out = {"dataset": cfg.data.dataset, "data_path": cfg.data.data_path,
           "splits": {}, "warnings": []}
    for split in splits:
        try:
            ds = make_dataset(cfg.data, split, cfg.model.num_classes)
        except Exception as exc:
            out["splits"][split] = {"error": f"{type(exc).__name__}: {exc}"}
            out["warnings"].append(f"split {split!r} failed to open")
            continue
        info = {"clips": len(ds)}
        if len(ds) == 0:
            out["warnings"].append(f"split {split!r} is empty")
        hist = np.zeros(cfg.model.num_classes, np.int64)
        ann_frames = tot_frames = 0
        geoms = set()
        for i in range(min(args.sample, len(ds))):
            frames, masks, valid = ds[i]
            geoms.add(tuple(frames.shape[1:]))
            vals, counts = np.unique(masks[valid > 0], return_counts=True)
            for v, c in zip(vals, counts):
                if v < hist.size:
                    hist[v] += int(c)
                else:
                    out["warnings"].append(
                        f"split {split!r}: mask class {int(v)} ≥ "
                        f"model.num_classes={cfg.model.num_classes}")
            ann_frames += int((valid > 0).sum())
            tot_frames += int(valid.shape[0])
        info["frame_geometry"] = sorted(str(g) for g in geoms)
        info["annotated_frame_fraction"] = (
            round(ann_frames / tot_frames, 3) if tot_frames else None)
        total_px = int(hist.sum())
        info["class_pixel_fractions"] = (
            [round(float(c) / total_px, 4) for c in hist] if total_px
            else None)
        missing = [k for k in range(1, cfg.model.num_classes)
                   if total_px and hist[k] == 0]
        if missing:
            out["warnings"].append(
                f"split {split!r}: foreground classes {missing} absent "
                f"in the sampled clips")
        if cfg.data.dataset == "echonet":
            from gdkvm_tpu_torch.eval.parity import read_ef_labels
            efs = read_ef_labels(cfg.data.data_path)
            info["ef_labels"] = len(efs)
            if not efs:
                out["warnings"].append(
                    "FileList.csv has no EF column — the echonet-ef "
                    "parity protocol will have nothing to score against")
        out["splits"][split] = info
    out["ok"] = not out["warnings"]
    print(json.dumps(out))
    return 0 if out["ok"] else 1


def cmd_convert_camus(argv) -> int:
    """Convert raw CAMUS (MetaImage .mhd) into the processed PNG layout."""
    from gdkvm_tpu_torch.data.camus_raw import convert_raw_camus
    p = argparse.ArgumentParser(prog="gdkvm convert-camus")
    p.add_argument("--raw", required=True, help="raw CAMUS root "
                   "(patientNNNN dirs of .mhd half-sequences)")
    p.add_argument("--out", required=True,
                   help="output root (camus_png256x256_10f layout)")
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--clip-len", type=int, default=10)
    p.add_argument("--val-fraction", type=float, default=0.1)
    p.add_argument("--split-mode", choices=("random", "official"),
                   default="random",
                   help="official = fixed CAMUS patient-number split "
                        "(1-400 train / 401-450 val / 451-500 test)")
    args = p.parse_args(argv)
    n = convert_raw_camus(args.raw, args.out, image_size=args.image_size,
                          clip_len=args.clip_len,
                          val_fraction=args.val_fraction,
                          split_mode=args.split_mode)
    print(json.dumps({"clips_written": n, "out": args.out}))
    return 0


_COMMANDS = {
    "train": cmd_train,
    "eval": cmd_eval,
    "bench": cmd_bench,
    "stream-eval": cmd_stream_eval,
    "scale": cmd_scale,
    "quant": cmd_quant,
    "pack": cmd_pack,
    "convert-camus": cmd_convert_camus,
    "validate-data": cmd_validate_data,
    "parity": cmd_parity,
    "serve": cmd_serve,
    "serve-bench": cmd_serve_bench,
    "export": cmd_export,
    "serve-check": cmd_serve_check,
    "infer": cmd_infer,
    "sweep": cmd_sweep,
    "info": cmd_info,
}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m gdkvm_tpu_torch "
              f"{{{'|'.join(_COMMANDS)}}} [--config cfg.yaml] "
              "[key=value ...]")
        return 0 if argv else 2
    cmd, rest = argv[0], argv[1:]
    if cmd in _COMMANDS:
        return _COMMANDS[cmd](rest)
    print(f"unknown command {cmd!r}; expected {'|'.join(_COMMANDS)}",
          file=sys.stderr)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
