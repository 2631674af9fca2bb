"""Training: optimizer, train step, train state and the whole run.

Port of gdkvm_tpu/train/loop.py.  The optimizer is the JAX
package's optax chain written out: global-norm clip → AdamW on a
warmup-cosine schedule from 0 to the peak and down to 5%, inside
``optax.MultiSteps`` gradient accumulation.  The step samples first-frame
prompts, weights bootstrapped CE by its schedule, takes the gradient of CE +
soft Dice, applies the update and keeps an EMA of the params on applied
updates.  :func:`train` is the run: data from the device cache or the
prefetched host pipeline, the metrics log, the periodic eval stage,
checkpoints and resume.

Distribution runs one process per device in a ``torch.distributed`` group
(parallel/distributed.py) laid out as the JAX package's ``data`` ×
``model`` mesh (``parallel.data_axis`` × ``parallel.model_axis``,
parallel/mesh.py).  A step there is the one-device step on the global
batch: every rank draws the same global batch and prompt bits, keeps its
data position's rows (``parallel.batch_slice``), takes the loss over the
valid frames of the whole batch (their count is summed over its data group
first) and averages its gradients and metrics over its data group before
the update.  With ``model_axis`` > 1 a rank holds its model position's
shard of the LKVA heads (models/gdkvm.py): the gradients of the replicated
LKVA parameters, of which each position uses its heads' rows, are summed
over its model group, those of the encoder and the decoder averaged over
the whole mesh, and the global norm of the clip counts each shard's
squares once over its model group.  Every rank's replicated parameters
then take the same update, bit for bit; the AdamW moments, the
accumulation buffer and the EMA are per shard.  Only rank 0 writes the
run's files.

Under ``gdr_impl="auto"`` (kept at 256² by ``train_model_config``) the GDR
scan of a CUDA model runs the forward kernel with residuals and the backward
chosen by ``GDKVM_GDR_BWD`` (ops/gdr_cuda.py).
"""

from __future__ import annotations

import contextlib
import math
import os
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Tuple, Union

import torch
import torch.utils.checkpoint

from gdkvm_tpu_torch.config.schema import Config, save_config
from gdkvm_tpu_torch.data import device_cache as dc
from gdkvm_tpu_torch.data.pipeline import (Batch, batch_iterator, make_dataset,
                                           prefetch_to_device)
from gdkvm_tpu_torch.eval.evaluator import evaluate
from gdkvm_tpu_torch.io.checkpoint import CheckpointManager
from gdkvm_tpu_torch.io.metrics_log import MetricsLogger
from gdkvm_tpu_torch.models.gdkvm import GDKVM, init_params, train_model_config
from gdkvm_tpu_torch.parallel import distributed
from gdkvm_tpu_torch.parallel.mesh import (Mesh, batch_slice, head_dim, process_mesh,
                                           run_mesh, shard_state_dict)
from gdkvm_tpu_torch.train import losses
from gdkvm_tpu_torch.utils.profiling import (StepTimer, maybe_profile,
                                             trace_annotation)

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


def global_norm(tensors: List[Tensor], sharded: Optional[List[bool]] = None,
                model_group=None) -> Tensor:
    """√(Σ x²) over all tensors, fp32 (``optax.global_norm``).  Over a
    model group (``model_group``), the tensors flagged in ``sharded`` are
    head shards: their squares are summed over the group, the others' (the
    same on every position) counted once."""
    if model_group is None:
        return torch.sqrt(sum((x.to(torch.float32) ** 2).sum() for x in tensors))
    sq = [(x.to(torch.float32) ** 2).sum() for x in tensors]
    own = sum(q for q, s in zip(sq, sharded) if s)
    whole = distributed.all_reduce_sum([own], model_group)[0]
    return torch.sqrt(whole + sum(q for q, s in zip(sq, sharded) if not s))


class Optimizer:
    """Clip by global norm → AdamW(schedule, weight_decay) on every param,
    under ``optax.MultiSteps``-style accumulation when ``accum_steps`` > 1:
    micro-step grads are averaged (a running mean) and one update applied
    every k micro-steps; between updates the params do not move and the
    schedule does not advance.

    Written out rather than ``clip_grad_norm_``, which adds 1e-6 to the
    norm; the first applied update uses lr = schedule(0) = 0, as optax's.
    ``norm``: the global norm of a gradient list (a head shard's counts
    the other shards', see :func:`global_norm`).
    """

    def __init__(self, params: List[Tensor], cfg: Config,
                 norm: Callable[[List[Tensor]], Tensor] = global_norm) -> None:
        t = cfg.train
        self.params = list(params)
        self.norm = norm
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
        norm = self.norm(grads)
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

    def state_dict(self) -> Dict[str, object]:
        """Everything a resumed run needs: the counts, the accumulation
        buffer (None without accumulation) and AdamW's moments and step per
        parameter (zeros before the first applied update)."""
        st = self.adamw.state
        get = lambda p, key: (st[p][key] if p in st and key in st[p]
                              else torch.zeros_like(p))
        return {"count": self.count, "mini_step": self.mini_step,
                "acc": None if self.acc is None else list(self.acc),
                "exp_avg": [get(p, "exp_avg") for p in self.params],
                "exp_avg_sq": [get(p, "exp_avg_sq") for p in self.params],
                "adam_step": [float(st[p]["step"]) if p in st else 0.0
                              for p in self.params]}

    @torch.no_grad()
    def load_state_dict(self, sd: Dict[str, object]) -> None:
        self.count, self.mini_step = int(sd["count"]), int(sd["mini_step"])
        if self.acc is not None:
            for a, saved in zip(self.acc, sd["acc"]):
                a.copy_(saved)
        self.adamw.state.clear()
        for p, m, v, n in zip(self.params, sd["exp_avg"], sd["exp_avg_sq"],
                              sd["adam_step"]):
            if n > 0:
                self.adamw.state[p] = {
                    "step": torch.tensor(float(n), dtype=torch.float32),
                    "exp_avg": m.to(p.device, copy=True),
                    "exp_avg_sq": v.to(p.device, copy=True)}


@dataclass
class TrainState:
    """The model (its params are the state's params), the optimizer, the
    micro-step count, the generator of prompt bits, the EMA shadow of the
    params (None when ``ema_decay`` is 0), the mesh the state lies on and,
    per param, whether it is a head shard (``sharded``) or a replicated
    LKVA param of which a head shard uses its heads' rows (``partial``: its
    gradient is summed over the model group)."""
    step: int
    model: GDKVM
    opt: Optimizer
    gen: torch.Generator
    ema: Optional[List[Tensor]] = None
    mesh: Optional[Mesh] = None
    sharded: Tuple[bool, ...] = ()
    partial: Tuple[bool, ...] = ()


def create_train_state(cfg: Config, model: GDKVM,
                       mesh: Optional[Mesh] = None) -> TrainState:
    """Initialize ``model`` from ``cfg.train.seed`` (the reference
    initializers; a head shard gets its share of the whole model's) and
    build its optimizer and EMA."""
    gen = torch.Generator().manual_seed(cfg.train.seed)
    m_axis, m = model.lkva.heads
    if m_axis == 1:
        init_params(model, gen)
    else:
        whole = init_params(GDKVM(model.cfg, device="cpu"), gen).state_dict()
        model.load_state_dict(shard_state_dict(whole, m_axis, m))
    return state_for(cfg, model, mesh)


def state_for(cfg: Config, model: GDKVM, mesh: Optional[Mesh] = None) -> TrainState:
    """A train state around ``model`` as it is (e.g. converted weights) on
    ``mesh`` (default: the data-only mesh of the process group, or of this
    process alone); a head shard's mesh has its model axis."""
    names, params = zip(*model.named_parameters())
    if mesh is None:
        mesh = process_mesh(params[0].device)
    if model.lkva.heads[0] != mesh.model:
        raise ValueError(f"a model of head shards {model.lkva.heads} on a mesh of "
                         f"model axis {mesh.model}")
    sharded = tuple(mesh.model > 1 and head_dim(n) is not None for n in names)
    partial = tuple(mesh.model > 1 and n.startswith("lkva.") and not s
                    for n, s in zip(names, sharded))
    norm = global_norm
    if mesh.model_group is not None:
        norm = lambda grads: global_norm(grads, list(sharded), mesh.model_group)
    ema = ([p.detach().clone() for p in params]
           if cfg.train.ema_decay > 0 else None)
    return TrainState(step=0, model=model, opt=Optimizer(list(params), cfg, norm),
                      gen=torch.Generator().manual_seed(cfg.train.seed), ema=ema,
                      mesh=mesh, sharded=sharded, partial=partial)


def eval_params(state: TrainState, cfg: Config) -> List[Tensor]:
    """Parameters to score: the EMA shadow when tracked and requested."""
    if state.ema is not None and cfg.eval_stage.use_ema:
        return state.ema
    return state.opt.params


@contextlib.contextmanager
def use_params(model: GDKVM, values: List[Tensor]) -> Iterator[None]:
    """Run the block with ``values`` (one tensor per parameter, in
    ``model.parameters()`` order) in place of the model's parameters, by
    swapping storage; nothing is copied and the swap is undone on exit."""
    params = list(model.parameters())
    swap = [(p, v) for p, v in zip(params, values) if p is not v]
    for p, v in swap:
        p.data, v.data = v.data, p.data
    try:
        yield
    finally:
        for p, v in swap:
            p.data, v.data = v.data, p.data


@dataclass
class CacheSampler:
    """The device cache as a batch source: ``sample(step)`` reseeds the
    cache's generator from ``(train.seed, 17, data.seed, step)`` and draws
    the step's global batch on the device, so the batch is a pure function
    of the step (the JAX package folds its key the same way); it returns
    the rows of this process's data position on ``mesh`` (all of them on
    a data axis of one)."""
    cache: Union[dc.DeviceDataset, dc.VideoDeviceCache]
    cfg: Config
    gen: torch.Generator
    mesh: Mesh

    def sample(self, step: int) -> Batch:
        cfg = self.cfg
        self.gen.manual_seed(dc.step_seed(
            (cfg.train.seed, 17, cfg.data.seed, step)))
        kw = dict(augment=cfg.data.augment, occlude_prob=cfg.data.occlude_prob)
        if isinstance(self.cache, dc.VideoDeviceCache):
            batch = dc.sample_video_batch(self.cache, self.gen, cfg.train.batch_size,
                                          cfg.data.clip_len, **kw)
        else:
            batch = dc.sample_batch(self.cache, self.gen, cfg.train.batch_size, **kw)
        if self.mesh.data == 1:
            return batch
        rows = batch_slice(self.mesh, cfg.train.batch_size)
        return Batch(batch.frames[rows], batch.masks[rows], batch.valid[rows])


def loss_and_grads(state: TrainState, batch: Union[Batch, CacheSampler],
                   cfg: Config) -> Tuple[Dict[str, Tensor], List[Tensor]]:
    """The step's forward and backward, without the update: → (metrics
    {loss, ce, dice_loss, batch_checksum} as 0-dim device tensors, a
    gradient per param).  ``batch`` is a Batch, or a :class:`CacheSampler`
    that draws this step's batch on the device.  Draws the step's prompt
    bits from ``state.gen``.

    On a mesh of D data positions (``state.mesh``) ``batch`` holds this
    process's data position's rows of a global batch of D times as many (a
    CacheSampler returns them); the prompt bits are drawn for the global
    batch and sliced the same way, and the metrics and gradients returned
    are those of the global batch, averaged (summed, for the checksum) over
    the data group; over a model axis the gradients of the parameters that
    are not head shards are averaged over the whole mesh, the replicated
    LKVA parameters' partial ones summed over the model group.

    Under ``train.remat`` the model's forward runs a second time inside the
    backward, through the GDR's autograd Function too: the forward's
    counters (``LAUNCHES`` and ``RESIDUAL_LAUNCHES`` or ``CHAIN_LAUNCHES``
    on the card, ``CHUNKED_CALLS`` on the CPU) then read two a step, the
    backward's one; the loss and the gradients are those of the plain
    step."""
    t = cfg.train
    params = state.opt.params
    dev = params[0].device
    if isinstance(batch, CacheSampler):
        batch = batch.sample(state.step)
    frames_u8 = torch.as_tensor(batch.frames, device=dev)
    frames = normalize_frames(frames_u8)
    masks = torch.as_tensor(batch.masks, device=dev).long()
    valid = torch.as_tensor(batch.valid, device=dev).to(torch.float32)
    mesh = state.mesh
    data_group = mesh.data_group
    b = frames.shape[0] * mesh.data
    # Stochastic first-frame prompting, only where frame 0 has ground truth.
    use_prompt = torch.bernoulli(torch.full((b,), t.prompt_prob),
                                 generator=state.gen)
    use_prompt = use_prompt[batch_slice(mesh, b)].to(dev)
    prompt_w = use_prompt * valid[:, 0]
    bweight = 1.0 if t.bootstrap_ratio >= 1.0 else losses.bootstrap_schedule(
        state.step, t.num_iterations, t.bootstrap_start, t.bootstrap_end)

    if t.remat:
        # Keep no activation of the model: the backward runs the forward
        # again (JAX: jax.checkpoint around the forward).
        logits, _ = torch.utils.checkpoint.checkpoint(
            state.model, frames, None, masks[:, 0], prompt_w, use_reentrant=False)
    else:
        logits, _ = state.model(frames, None, masks[:, 0], prompt_w)
    # The valid frames of the global batch: the loss's denominator.  In a
    # process group (of one too) the loss is taken as a data position's share.
    grouped = distributed.in_group()
    valid_total = (distributed.all_reduce_sum([valid.sum()], data_group)[0]
                   if data_group is not None else valid.sum()) if grouped else None
    loss, aux = losses.segmentation_loss(
        logits, masks, valid, ce_weight=t.ce_weight, dice_weight=t.dice_weight,
        bootstrap_ratio=t.bootstrap_ratio, bootstrap_weight=bweight,
        valid_total=valid_total, world=mesh.data)
    grads = list(torch.autograd.grad(loss, params))
    if mesh.model_group is None:
        if data_group is not None:
            grads = distributed.all_reduce_mean(grads, data_group)
    else:
        # Over a model axis: a head shard's gradient is averaged over its
        # data group; every other one is summed over the whole mesh, which
        # completes a replicated LKVA parameter's partial gradient (÷ D) and
        # gives the encoder's and decoder's, which every model position
        # computes alike, the same bits on every rank (÷ D·M): a card's
        # convolution backward need not repeat its own bits.
        whole = [i for i, s in enumerate(state.sharded) if not s]
        for i, g in zip(whole, distributed.all_reduce_sum([grads[i] for i in whole])):
            grads[i] = g / (mesh.data * (1 if state.partial[i] else mesh.model))
        own = [i for i, s in enumerate(state.sharded) if s]
        if data_group is not None:
            for i, g in zip(own, distributed.all_reduce_mean([grads[i] for i in own],
                                                             data_group)):
                grads[i] = g
    metrics = {k: v.detach() for k, v in aux.items()}
    # Sum of the batch's bytes: two runs that log the same value at a step
    # saw the same batch there (exact below 2^53).
    metrics["batch_checksum"] = (frames_u8.sum(dtype=torch.int64)
                                 + masks.sum()).to(torch.float64)
    if data_group is not None:
        keys = list(metrics)
        packed = torch.stack([metrics[k].to(torch.float64)
                              / (1 if k == "batch_checksum" else mesh.data) for k in keys])
        packed = distributed.all_reduce_sum([packed], data_group)[0]
        metrics = {k: v.to(metrics[k].dtype) for k, v in zip(keys, packed)}
    return metrics, grads


def train_step(state: TrainState, batch: Union[Batch, CacheSampler], cfg: Config
               ) -> Dict[str, Tensor]:
    """One micro-step: loss → grads → update → EMA.  Updates ``state`` in
    place and returns the step's metrics (0-dim tensors on the device):
    loss, ce, dice_loss, batch_checksum, and grad_norm (micro_grad_norm
    under accumulation: the norm of this micro-step's grads)."""
    t = cfg.train
    metrics, grads = loss_and_grads(state, batch, cfg)
    norm_key = "micro_grad_norm" if t.accum_steps > 1 else "grad_norm"
    metrics[norm_key] = state.opt.norm(grads)
    applied = state.opt.step(grads)
    if state.ema is not None and applied:
        with torch.no_grad():
            for e, p in zip(state.ema, state.opt.params):
                e.add_((1.0 - t.ema_decay) * (p - e))
    state.step += 1
    return metrics


def train(cfg: Config, max_steps: Optional[int] = None,
          device: torch.device | str = "cuda") -> Dict[str, float]:
    """The whole training run on ``device``, the CUDA device unless the
    caller asks for the CPU; raises when ``device`` is CUDA and there is no
    card: it never falls back.

    Under ``cfg.runtime.run_dir`` it writes ``config.yaml``, the metrics
    log ``metrics.jsonl`` (every ``log_every`` steps, with steps/s and
    frames/s of the window), ``checkpoints/`` (every ``checkpoint_every``
    steps and at the end), the eval stage's overlays ``vis/`` (every
    ``eval_every`` steps and at the end, scoring the EMA weights when
    tracked) and, under ``runtime.profile``, ``trace/``.  With
    ``runtime.resume`` it continues from the latest checkpoint and sees the
    batches an unbroken run would have seen.  Data comes from the device
    cache when the split fits (``data.device_cache``), else from the
    threaded host pipeline through the prefetcher.  Runs ``max_steps``
    micro-steps in all (default ``num_iterations``) and returns the last
    logged metrics and the last eval's, as floats.

    Under an initialized process group (parallel/distributed.py) the ranks
    form the ``parallel.data_axis`` × ``parallel.model_axis`` mesh
    (``config.schema.data_parallel_size`` checks it): this process trains
    its data position's share of every global batch on ``device`` (the
    rank's own) with its model position's head shard.  Every rank builds
    the same parameters from the seed (its shard of them), restores the
    same checkpoint on resume and returns the same metrics; rank 0 alone
    writes the run dir, its checkpoints whole (gathered over its model
    group).  In one process the mesh is one device: ``model_axis`` > 1
    raises, as the JAX package's ``make_mesh`` does on one device."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train: no CUDA device; pass device='cpu' to train "
                           "on the CPU")
    rank = distributed.rank()
    mesh = run_mesh(cfg, device)
    model = GDKVM(train_model_config(cfg.model, cfg.data.image_size),
                  device=device, heads=mesh.heads, model_group=mesh.model_group)
    run_dir = cfg.runtime.run_dir
    if rank == 0:
        os.makedirs(run_dir, exist_ok=True)
        save_config(cfg, os.path.join(run_dir, "config.yaml"))
    logger = MetricsLogger(run_dir, wandb_mode=cfg.eval_stage.wandb_mode)
    state = create_train_state(cfg, model, mesh)

    ckpt = CheckpointManager(os.path.join(run_dir, "checkpoints"))
    start_step = 0
    if cfg.runtime.resume and ckpt.latest_step() is not None:
        state = ckpt.restore(state)
        start_step = state.step

    dataset = make_dataset(cfg.data, cfg.data.train_split, cfg.model.num_classes)
    cache_mode = dc.resolve_cache_mode(cfg.data, dataset)
    cache = None
    if cache_mode == "video":
        # One bulk upload; batches are sampled and augmented in the step.
        cache = dc.build_video_cache(
            dataset, cfg.data.clip_len, device,
            max_bytes=cfg.data.device_cache_max_mb * 2**20)
    elif cache_mode == "clip":
        cache = dc.build_device_cache(dataset, device)
    if cache is not None:
        source, it = CacheSampler(cache, cfg, torch.Generator(device=device), mesh), None
    else:
        it = prefetch_to_device(
            batch_iterator(dataset, cfg.train.batch_size, shuffle=True,
                           augment=cfg.data.augment,
                           occlude_prob=cfg.data.occlude_prob,
                           seed=cfg.data.seed,
                           num_workers=cfg.data.num_workers,
                           start_step=start_step, shard=(mesh.index, mesh.data)),
            size=cfg.data.prefetch, device=device)

    total = cfg.train.num_iterations if max_steps is None else max_steps
    last_eval: Dict[str, float] = {}
    final_metrics: Dict[str, float] = {}
    timer = StepTimer(skip=1)           # the first step builds and warms up
    trace_dir = (os.path.join(run_dir, "trace")
                 if cfg.runtime.profile and rank == 0 else None)

    with contextlib.ExitStack() as stack:
        stack.enter_context(maybe_profile(trace_dir))
        if cfg.runtime.debug_nans:
            stack.enter_context(torch.autograd.set_detect_anomaly(True))
        if it is not None:
            stack.callback(it.close)    # stops the prefetcher's thread
        for step_idx in range(start_step, total):
            batch = source if it is None else next(it)
            with trace_annotation("train_step"):
                metrics = train_step(state, batch, cfg)
            timer.lap(metrics["loss"])

            if (step_idx + 1) % cfg.train.log_every == 0 or step_idx == 0:
                logged = {k: float(v) for k, v in metrics.items()}   # the fetch
                logged.update(timer.stats())
                if "steps_per_sec" in logged:
                    logged["frames_per_sec"] = (
                        logged["steps_per_sec"] * cfg.train.batch_size
                        * cfg.data.clip_len)
                logger.log(step_idx + 1, logged)
                final_metrics = logged
                timer.reset_window()

            if (step_idx + 1) % cfg.train.eval_every == 0 or step_idx + 1 == total:
                with trace_annotation("eval_stage"), \
                        use_params(model, eval_params(state, cfg)):
                    last_eval = evaluate(cfg, model, device, step=step_idx + 1,
                                         mesh=mesh)
                logger.log(step_idx + 1, {f"eval/{k}": v
                                          for k, v in last_eval.items()})
                timer.reset_window()

            if (step_idx + 1) % cfg.train.checkpoint_every == 0 or \
                    step_idx + 1 == total:
                ckpt.save(step_idx + 1, state)
                timer.reset_window()

    ckpt.wait()
    ckpt.close()
    logger.close()
    final_metrics.update({f"eval/{k}": v for k, v in last_eval.items()})
    return final_metrics
