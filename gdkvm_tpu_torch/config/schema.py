"""Configuration of the port: model, data and training settings.

``ModelConfig`` has the same fields and defaults as
``gdkvm_tpu.config.schema.ModelConfig`` (a test holds the two equal); this
copy exists because the port must import without JAX or yaml.
``DataConfig`` and ``TrainConfig`` carry the fields of the JAX package's
that the port's training step reads, with the same defaults; ``Config``
holds the three.  The card host has no yaml, so the documented configs the
port runs are functions, :func:`ts8_256` (training) and :func:`ts8_112`
(serving), each held to its YAML file by a test.
"""

from __future__ import annotations

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
    gdr_variant: str = "gdn"           # only the coupled rule is ported
    quant: str = "none"                # quantized serving is not ported


@dataclass
class DataConfig:
    """Training data (see gdkvm_tpu_torch/data/pipeline.py)."""
    dataset: str = "synthetic"         # only "synthetic" is ported
    image_size: int = 112
    clip_len: int = 10
    train_split: str = "train"
    augment: bool = True
    # Probability that a clip gets 1-4 consecutive frames with a blanked
    # region (never frame 0).
    occlude_prob: float = 0.0
    seed: int = 0
    synth_difficulty: float = 0.0      # synthetic clip artifacts, in [0, 1]


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
    prompt_prob: float = 0.5           # first-frame mask prompting
    ema_decay: float = 0.0             # Polyak/EMA of params; 0 disables
    accum_steps: int = 1               # micro-steps averaged per update


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)


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
                          num_iterations=3000, bootstrap_ratio=0.15))


def ts8_256() -> Config:
    """configs/gdkvm_ts8_256.yaml, the documented CAMUS recipe (256², batch
    8, lr 1e-4, 3000 iterations, clip 10) on the ts8 model, 4 classes, with
    bootstrapped CE at 0.15.  The data location is left out: the port reads
    synthetic clips only."""
    return Config(
        model=_ts8_model(),
        data=DataConfig(dataset="camus", image_size=256, clip_len=10),
        train=TrainConfig(batch_size=8, learning_rate=1.0e-4,
                          num_iterations=3000, bootstrap_ratio=0.15))
