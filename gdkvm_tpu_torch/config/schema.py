"""Configuration of the port: model, data and training settings.

``ModelConfig`` has the same fields and defaults as
``gdkvm_tpu.config.schema.ModelConfig`` (a test holds the two equal); this
copy exists because the port must import without JAX or yaml.
``DataConfig``, ``TrainConfig``, ``EvalStageConfig``, ``ParallelConfig`` and
``RuntimeConfig`` carry the JAX package's fields with the same names and
defaults (a test holds every shared default); ``Config`` holds the six and
the documented top-level aliases ``data_path``, ``batch_size``,
``learning_rate`` and ``num_iterations``.

:func:`load_config` reads a YAML file (through ``config/yaml_subset.py``:
PyYAML is not required) and applies ``a.b.c=value`` overrides;
:func:`save_config` writes one back.  :func:`ts8_256` (training) and
:func:`ts8_112` (serving) build the two documented ts8 configs without a
file, each held to its YAML file by a test.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple

from gdkvm_tpu_torch.config import yaml_subset


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
    # tensors) | "pallas" (force the kernel) | "chunked" | "assoc" (the
    # log-depth scan of affine maps) | "ref".
    gdr_impl: str = "auto"
    # "gdn": the coupled rule (η = β); "gdn2": a separate learned erase gate
    # η per token and head.
    gdr_variant: str = "gdn"
    # "none", or "w8a8-<digest>" for a W8A8 model, which carries its scale
    # table (ops/quant.py::w8a8_model sets the tag).
    quant: str = "none"


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
    # Recompute the model's forward in the backward instead of keeping its
    # activations (torch.utils.checkpoint around the forward).
    remat: bool = False
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
class ParallelConfig:
    """Device layout: a ``data_axis`` × ``model_axis`` mesh.  ``data_axis``
    is the data-parallel width, ``model_axis`` the number of shards the
    LKVA heads are split into (it must divide ``model.num_heads``).  In
    training and eval the mesh spans the ranks of the process group
    (parallel/distributed.py, one process per device): the world must
    equal data × model, a ``data_axis`` of -1 is world / model, and the
    global ``train.batch_size`` must split evenly over the data axis
    (:func:`data_parallel_size`).  Under ``serve --mesh auto`` the mesh is
    laid over the process's devices."""
    data_axis: int = -1                # -1 = all remaining devices
    model_axis: int = 1
    donate_state: bool = True          # unused here: no buffer donation in PyTorch


@dataclass
class RuntimeConfig:
    run_dir: str = "outputs/run"       # metrics, checkpoints, vis, trace
    resume: bool = False               # continue from the latest checkpoint
    # Unused: kept so that a config.yaml written by a JAX run loads.
    jit_cache_dir: str = ""
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
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)

    # The documented top-level keys of the reference recipes.  When set (in
    # YAML or by an override) they replace the nested fields in
    # __post_init__, which apply_overrides runs again: an alias that is set
    # wins over a nested override of the same field.
    data_path: Optional[str] = None
    batch_size: Optional[int] = None
    learning_rate: Optional[float] = None
    num_iterations: Optional[int] = None

    def __post_init__(self):
        if self.data_path is not None:
            self.data.data_path = self.data_path
        if self.batch_size is not None:
            self.train.batch_size = self.batch_size
        if self.learning_rate is not None:
            self.train.learning_rate = self.learning_rate
        if self.num_iterations is not None:
            self.train.num_iterations = self.num_iterations


def data_parallel_size(cfg: Config, world: int) -> int:
    """The data axis of a run over ``world`` ranks, checked as the JAX
    package's ``make_mesh`` checks its devices: ``model_axis`` must divide
    the world when ``data_axis`` is -1, ``data_axis × model_axis`` must
    span it, and the global batch must split evenly over the data axis."""
    p = cfg.parallel
    model = p.model_axis
    if model < 1:
        raise ValueError(f"parallel.model_axis={model} must be at least 1")
    if p.data_axis == -1:
        if world % model:
            raise ValueError(f"parallel.model_axis={model}: {world} devices not "
                             f"divisible by model={model}")
        data = world // model
    else:
        data = p.data_axis
        if data * model != world:
            raise ValueError(
                f"parallel.data_axis={data}: a run of {world} process(es) at "
                f"model_axis={model} has a data axis of {world // model} (or -1)"
                + (f"; mesh {data}x{model} exceeds {world} devices"
                   if data * model > world else ""))
    if cfg.train.batch_size % data:
        raise ValueError(f"train.batch_size={cfg.train.batch_size} (global) does "
                         f"not split over {data} data positions")
    return data


def _from_dict(cls, d: Dict[str, Any]):
    """Build a dataclass from a (possibly nested) dict; an unknown key raises
    KeyError naming the valid ones, lists become tuples."""
    if d is None:
        return cls()
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for key, value in d.items():
        if key not in fields:
            raise KeyError(f"Unknown config key {key!r} for {cls.__name__}; "
                           f"valid keys: {sorted(fields)}")
        f = fields[key]
        if dataclasses.is_dataclass(f.type):
            kwargs[key] = _from_dict(f.type, value)
        elif isinstance(value, dict):
            # a nested dataclass, declared by a string annotation
            kwargs[key] = _from_dict(_resolve_dataclass(f), value)
        elif isinstance(value, list):
            kwargs[key] = tuple(value)
        else:
            kwargs[key] = value
    return cls(**kwargs)


def _resolve_dataclass(f: dataclasses.Field):
    t = f.type
    if isinstance(t, str):
        t = globals().get(t, None)
    if t is None or not dataclasses.is_dataclass(t):
        raise TypeError(f"Field {f.name} is not a dataclass")
    return t


def _coerce(value: str, current: Any) -> Any:
    """Coerce an override's string to the type of the current value."""
    if isinstance(current, bool) or value in ("true", "false", "True", "False"):
        return value in ("true", "True", "1")
    if isinstance(current, int) and not isinstance(current, bool):
        try:
            return int(value)
        except ValueError:
            return float(value)
    if isinstance(current, float):
        return float(value)
    if isinstance(current, (tuple, list)):
        items = [x for x in value.strip("[]()").split(",") if x]
        elem = current[0] if len(current) else 0
        return tuple(_coerce(x.strip(), elem) for x in items)
    if current is None:
        # best-effort literal parse
        for cast in (int, float):
            try:
                return cast(value)
            except ValueError:
                pass
        return value
    return value


def apply_overrides(cfg: Config, overrides: Sequence[str]) -> Config:
    """Apply ``a.b.c=value`` dotted-path overrides in place, then run the
    alias propagation again."""
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"Override {item!r} must be key=value")
        path, value = item.split("=", 1)
        parts = path.split(".")
        obj = cfg
        for p in parts[:-1]:
            if not hasattr(obj, p):
                raise KeyError(f"Unknown config path {path!r} (at {p!r})")
            obj = getattr(obj, p)
        leaf = parts[-1]
        if not hasattr(obj, leaf):
            raise KeyError(f"Unknown config path {path!r} (at {leaf!r})")
        setattr(obj, leaf, _coerce(value, getattr(obj, leaf)))
    if isinstance(cfg, Config):
        cfg.__post_init__()
    return cfg


def load_config(path: Optional[str] = None,
                overrides: Sequence[str] = ()) -> Config:
    """Load a YAML config file (or the defaults) and apply overrides."""
    if path:
        with open(path) as fh:
            raw = yaml_subset.load(fh.read()) or {}
        cfg = _from_dict(Config, raw)
    else:
        cfg = Config()
    return apply_overrides(cfg, overrides)


def to_dict(cfg) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)


def save_config(cfg: Config, path: str) -> None:
    """Write ``cfg`` as YAML that :func:`load_config` (and PyYAML) reads."""
    with open(path, "w") as fh:
        fh.write(yaml_subset.dump(to_dict(cfg)))


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
