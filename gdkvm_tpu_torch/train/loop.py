"""Training: optimizer, train step, train state and the loop.

Port of gdkvm_tpu/train/loop.py on one device.  The optimizer is the JAX
package's optax chain written out: global-norm clip → AdamW on a
warmup-cosine schedule from 0 to the peak and down to 5%, inside
``optax.MultiSteps`` gradient accumulation.  The step samples first-frame
prompts, weights bootstrapped CE by its schedule, takes the gradient of CE +
soft Dice, applies the update and keeps an EMA of the params on applied
updates.  Eval, checkpoints and the metrics logger are not ported yet.

Under ``gdr_impl="auto"`` (kept at 256² by ``train_model_config``) the GDR
scan of a CUDA model runs the forward kernel with residuals and the backward
chosen by ``GDKVM_GDR_BWD`` (ops/gdr_cuda.py).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch

from gdkvm_tpu_torch.config.schema import Config
from gdkvm_tpu_torch.data.pipeline import Batch, batch_iterator, make_dataset
from gdkvm_tpu_torch.models.gdkvm import GDKVM, init_params, train_model_config
from gdkvm_tpu_torch.train import losses

Tensor = torch.Tensor


def normalize_frames(frames_u8: Tensor) -> Tensor:
    """uint8 → float32 in [0, 1], on the frames' device."""
    return frames_u8.to(torch.float32) * (1.0 / 255.0)


def lr_schedule(cfg: Config) -> Callable[[int], float]:
    """Learning rate by applied-update count: ``optax.warmup_cosine_decay_
    schedule(0, peak, warmup, decay, 0.05·peak)``, its horizons counted in
    applied updates (micro-steps / accum_steps)."""
    t = cfg.train
    k = max(t.accum_steps, 1)
    total = max(t.num_iterations // k, 1)
    warmup = max(min(t.warmup_iterations // k, total // 2), 1)
    decay = max(total, warmup + 1) - warmup
    peak = t.learning_rate
    alpha = 0.0 if peak == 0.0 else 0.05

    def schedule(count: int) -> float:
        if count < warmup:
            return peak * count / warmup
        c = min(count - warmup, decay)
        return peak * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / decay))
                       + alpha)
    return schedule


def global_norm(tensors: List[Tensor]) -> Tensor:
    """√(Σ x²) over all tensors, fp32 (``optax.global_norm``)."""
    return torch.sqrt(sum((x.to(torch.float32) ** 2).sum() for x in tensors))


class Optimizer:
    """Clip by global norm → AdamW(schedule, weight_decay) on every param,
    under ``optax.MultiSteps``-style accumulation when ``accum_steps`` > 1:
    micro-step grads are averaged (a running mean) and one update applied
    every k micro-steps; between updates the params do not move and the
    schedule does not advance.

    Written out rather than ``clip_grad_norm_``, which adds 1e-6 to the
    norm; the first applied update uses lr = schedule(0) = 0, as optax's.
    """

    def __init__(self, params: List[Tensor], cfg: Config) -> None:
        t = cfg.train
        self.params = list(params)
        self.schedule = lr_schedule(cfg)
        self.grad_clip = t.grad_clip
        self.k = max(t.accum_steps, 1)
        self.adamw = torch.optim.AdamW(self.params, lr=0.0, betas=(0.9, 0.999),
                                       eps=1e-8, weight_decay=t.weight_decay)
        self.count = 0        # applied updates
        self.mini_step = 0    # micro-steps accumulated toward the next one
        self.acc = ([torch.zeros_like(p) for p in self.params]
                    if self.k > 1 else None)

    def step(self, grads: List[Tensor]) -> bool:
        """Take one micro-step's grads; return whether params were updated."""
        if self.acc is not None:
            for a, g in zip(self.acc, grads):
                a.add_((g - a) / (self.mini_step + 1))
            if self.mini_step < self.k - 1:
                self.mini_step += 1
                return False
            grads = self.acc
        norm = global_norm(grads)
        for p, g in zip(self.params, grads):
            p.grad = torch.where(norm < self.grad_clip, g,
                                 (g / norm) * self.grad_clip)
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(self.count)
        self.adamw.step()
        self.count += 1
        self.mini_step = 0
        if self.acc is not None:
            for a in self.acc:
                a.zero_()
        return True


@dataclass
class TrainState:
    """The model (its params are the state's params), the optimizer, the
    micro-step count, the generator of prompt bits and the EMA shadow of
    the params (None when ``ema_decay`` is 0)."""
    step: int
    model: GDKVM
    opt: Optimizer
    gen: torch.Generator
    ema: Optional[List[Tensor]] = None


def create_train_state(cfg: Config, model: GDKVM) -> TrainState:
    """Initialize ``model`` from ``cfg.train.seed`` (the reference
    initializers) and build its optimizer and EMA."""
    init_params(model, torch.Generator().manual_seed(cfg.train.seed))
    return state_for(cfg, model)


def state_for(cfg: Config, model: GDKVM) -> TrainState:
    """A train state around ``model`` as it is (e.g. converted weights)."""
    params = list(model.parameters())
    ema = ([p.detach().clone() for p in params]
           if cfg.train.ema_decay > 0 else None)
    return TrainState(step=0, model=model, opt=Optimizer(params, cfg),
                      gen=torch.Generator().manual_seed(cfg.train.seed), ema=ema)


def loss_and_grads(state: TrainState, batch: Batch, cfg: Config
                   ) -> Tuple[Dict[str, Tensor], List[Tensor]]:
    """The step's forward and backward, without the update: → (metrics
    {loss, ce, dice_loss} as 0-dim device tensors, a gradient per param).
    Draws the step's prompt bits from ``state.gen``."""
    t = cfg.train
    params = state.opt.params
    dev = params[0].device
    frames = normalize_frames(torch.as_tensor(batch.frames, device=dev))
    masks = torch.as_tensor(batch.masks, device=dev).long()
    valid = torch.as_tensor(batch.valid, device=dev).to(torch.float32)
    b = frames.shape[0]
    # Stochastic first-frame prompting, only where frame 0 has ground truth.
    use_prompt = torch.bernoulli(torch.full((b,), t.prompt_prob),
                                 generator=state.gen).to(dev)
    prompt_w = use_prompt * valid[:, 0]
    bweight = 1.0 if t.bootstrap_ratio >= 1.0 else losses.bootstrap_schedule(
        state.step, t.num_iterations, t.bootstrap_start, t.bootstrap_end)

    logits, _ = state.model(frames, None, masks[:, 0], prompt_w)
    loss, aux = losses.segmentation_loss(
        logits, masks, valid, ce_weight=t.ce_weight, dice_weight=t.dice_weight,
        bootstrap_ratio=t.bootstrap_ratio, bootstrap_weight=bweight)
    grads = torch.autograd.grad(loss, params)
    return {k: v.detach() for k, v in aux.items()}, list(grads)


def train_step(state: TrainState, batch: Batch, cfg: Config
               ) -> Dict[str, Tensor]:
    """One micro-step: loss → grads → update → EMA.  Updates ``state`` in
    place and returns the step's metrics (0-dim tensors on the device):
    loss, ce, dice_loss, and grad_norm (micro_grad_norm under
    accumulation: the norm of this micro-step's grads)."""
    t = cfg.train
    metrics, grads = loss_and_grads(state, batch, cfg)
    norm_key = "micro_grad_norm" if t.accum_steps > 1 else "grad_norm"
    metrics[norm_key] = global_norm(grads)
    applied = state.opt.step(grads)
    if state.ema is not None and applied:
        with torch.no_grad():
            for e, p in zip(state.ema, state.opt.params):
                e.add_((1.0 - t.ema_decay) * (p - e))
    state.step += 1
    return metrics


def train(cfg: Config, max_steps: Optional[int] = None,
          device: torch.device | str = "cuda") -> Dict[str, float]:
    """Train from scratch on ``cfg`` for ``max_steps`` micro-steps (default
    ``num_iterations``) on ``device``, the CUDA device unless the caller
    asks for the CPU; return the last step's metrics as floats.  Raises
    when ``device`` is CUDA and there is no card: it never falls back."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train: no CUDA device; pass device='cpu' to train "
                           "on the CPU")
    model = GDKVM(train_model_config(cfg.model, cfg.data.image_size),
                  device=device)
    state = create_train_state(cfg, model)
    dataset = make_dataset(cfg.data, cfg.data.train_split, cfg.model.num_classes)
    it = batch_iterator(dataset, cfg.train.batch_size, shuffle=True,
                        augment=cfg.data.augment,
                        occlude_prob=cfg.data.occlude_prob, seed=cfg.data.seed)
    total = cfg.train.num_iterations if max_steps is None else max_steps
    metrics: Dict[str, Tensor] = {}
    for _ in range(total):
        metrics = train_step(state, next(it), cfg)
    return {k: float(v) for k, v in metrics.items()}
