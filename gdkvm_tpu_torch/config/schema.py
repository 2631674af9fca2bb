"""Configuration of the port: model, data and training settings.

``ModelConfig`` has the same fields and defaults as
``gdkvm_tpu.config.schema.ModelConfig`` (a test holds the two equal); this
copy exists because the port must import without JAX or yaml.
``DataConfig``, ``TrainConfig``, ``EvalStageConfig`` and ``RuntimeConfig``
carry the fields of the JAX package's that the port's training run reads,
with the same names and defaults (a test holds every shared default);
``Config`` holds the five.  The card host has no yaml, so the documented
configs the port runs are functions, :func:`ts8_256` (training) and
:func:`ts8_112` (serving), each held to its YAML file by a test, and a run
writes its config as JSON (:func:`save_config_json`).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Tuple


@dataclass
class ModelConfig:
    """GDKVM model hyperparameters (see gdkvm_tpu_torch/models/gdkvm.py)."""
    in_channels: int = 1
    num_classes: int = 2
    # Encoder: stem + stages at strides 4/8/16.
    enc_channels: Tuple[int, ...] = (32, 64, 96, 128)
    enc_blocks: Tuple[int, ...] = (1, 2, 2, 2)
    enc_stem: str = "s2d"              # "s2d" (4×4 space-to-depth) | "conv"
    # LKVA / GDR memory.
    num_heads: int = 4
    head_dim_k: int = 64
    head_dim_v: int = 64
    mem_stride: int = 16               # must be 16, the encoder's deepest stride
    # KPFF decoder widths from stride 16 downward (2 entries: sub-pixel head
    # at stride 8; 3 entries: head at stride 4).
    kpff_channels: Tuple[int, ...] = (96, 64, 48)
    # Numerics: params stay fp32, ops run in compute_dtype.
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # GDR scan: "auto" (CUDA kernel for CUDA tensors, chunked for CPU
    # tensors) | "pallas" (force the kernel) | "chunked" | "ref".
    gdr_impl: str = "auto"
    # "gdn": the coupled rule (η = β); "gdn2": a separate learned erase gate
    # η per token and head.
    gdr_variant: str = "gdn"
    quant: str = "none"                # quantized serving is not ported


@dataclass
class DataConfig:
    """Training data (see gdkvm_tpu_torch/data/pipeline.py)."""
    dataset: str = "synthetic"         # synthetic | camus | echonet | packed
    data_path: str = ""
    image_size: int = 112
    clip_len: int = 10
    num_workers: int = 4               # loader threads of the host path
    prefetch: int = 2                  # batches in flight to the device
    train_split: str = "train"
    val_split: str = "val"
    augment: bool = True
    # Probability that a clip gets 1-4 consecutive frames with a blanked
    # region (never frame 0).
    occlude_prob: float = 0.0
    seed: int = 0
    synth_difficulty: float = 0.0      # synthetic clip artifacts, in [0, 1]
    # Device-resident dataset cache (data/device_cache.py): the whole
    # training split is uploaded once and batches are sampled and augmented
    # on the device.  auto = on when the split fits device_cache_max_mb.
    device_cache: str = "auto"         # auto | on | off
    device_cache_max_mb: int = 2048


@dataclass
class TrainConfig:
    """Optimizer and loss settings (see gdkvm_tpu_torch/train/loop.py)."""
    batch_size: int = 8
    learning_rate: float = 1.0e-4
    num_iterations: int = 3000
    warmup_iterations: int = 100
    weight_decay: float = 1.0e-4
    grad_clip: float = 1.0
    ce_weight: float = 1.0
    dice_weight: float = 1.0
    # Bootstrapped CE: ratio < 1 keeps only the hardest ratio·H·W pixels of
    # each frame, blended in from start·N to end·N iterations.
    bootstrap_ratio: float = 1.0
    bootstrap_start: float = 0.2       # fraction of num_iterations
    bootstrap_end: float = 0.6
    seed: int = 0
    log_every: int = 50
    eval_every: int = 500
    checkpoint_every: int = 500
    prompt_prob: float = 0.5           # first-frame mask prompting
    ema_decay: float = 0.0             # Polyak/EMA of params; 0 disables
    accum_steps: int = 1               # micro-steps averaged per update


@dataclass
class EvalStageConfig:
    """The eval stage of a training run (eval/evaluator.py) and streaming
    eval (eval/streaming.py)."""
    num_vis: int = 4                   # overlay PNGs written per eval
    wandb_mode: str = "offline"        # "disabled" turns the wandb mirror off
    batch_size: int = 1
    stream_chunk: int = 16             # frames per model call when streaming
    streams: int = 1                   # videos in flight (serving mode)
    use_ema: bool = True               # score the EMA weights when tracked
    hd95: bool = False                 # also the 95th-percentile Hausdorff (host)


@dataclass
class RuntimeConfig:
    run_dir: str = "outputs/run"       # metrics, checkpoints, vis, trace
    resume: bool = False               # continue from the latest checkpoint
    profile: bool = False              # write a torch.profiler trace to run_dir/trace
    # Raise at the first backward op that produces a NaN
    # (torch.autograd.set_detect_anomaly); slower, for debugging.
    debug_nans: bool = False


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    eval_stage: EvalStageConfig = field(default_factory=EvalStageConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)


def save_config_json(cfg: Config, path: str) -> None:
    """Write ``cfg`` as JSON (``dataclasses.asdict``; tuples become lists)."""
    with open(path, "w") as fh:
        json.dump(dataclasses.asdict(cfg), fh, indent=2, sort_keys=True)
        fh.write("\n")


def _ts8_model() -> ModelConfig:
    """The ts8 model of both ts8 configs, 4 classes."""
    return ModelConfig(num_classes=4, in_channels=1,
                       enc_channels=(64, 64, 128, 192), enc_blocks=(1, 1, 2, 2),
                       kpff_channels=(128, 96), num_heads=4, head_dim_k=64,
                       head_dim_v=64)


def ts8_112() -> Config:
    """configs/gdkvm_ts8_112.yaml: the ts8 model, 4 classes (masks pack at
    2 bits), at 112² on synthetic clips of difficulty 0.7, batch 8, lr
    1e-4, 3000 iterations, clip 10, bootstrapped CE at 0.15.  The serving
    model of ``chip_smoke.py``."""
    return Config(
        model=_ts8_model(),
        data=DataConfig(dataset="synthetic", image_size=112, clip_len=10,
                        augment=True, synth_difficulty=0.7),
        train=TrainConfig(batch_size=8, learning_rate=1.0e-4,
                          num_iterations=3000, bootstrap_ratio=0.15,
                          eval_every=500, checkpoint_every=1000),
        eval_stage=EvalStageConfig(num_vis=4, wandb_mode="disabled"),
        runtime=RuntimeConfig(run_dir="outputs/ts8_hard"))


def ts8_256(data_path: str = "/data/camus_png256x256_10f_20250709") -> Config:
    """configs/gdkvm_ts8_256.yaml, the documented CAMUS recipe (256², batch
    8, lr 1e-4, 3000 iterations, clip 10) on the ts8 model, 4 classes, with
    bootstrapped CE at 0.15.  ``data_path`` is the root of the processed
    CAMUS layout (data/camus.py); the default is the YAML file's."""
    return Config(
        model=_ts8_model(),
        data=DataConfig(dataset="camus", data_path=data_path, image_size=256,
                        clip_len=10),
        train=TrainConfig(batch_size=8, learning_rate=1.0e-4,
                          num_iterations=3000, bootstrap_ratio=0.15),
        eval_stage=EvalStageConfig(num_vis=4, wandb_mode="offline"),
        runtime=RuntimeConfig(run_dir="outputs/gdkvm_ts8_256"))
