"""The port's train step against the JAX package's, on the CPU (slow tier).

Each test compiles a JAX train step (several seconds on one CPU), so the
file is marked slow.  The port runs on the JAX weights carried over by
io/convert.py, on the same synthetic clips.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdkvm_tpu.config.schema import apply_overrides, load_config
from gdkvm_tpu.data.pipeline import Batch as JBatch
from gdkvm_tpu.eval import metrics as jmetrics
from gdkvm_tpu.models.gdkvm import GDKVM as JGDKVM
from gdkvm_tpu.train.loop import TrainState, make_optimizer, make_train_step
from gdkvm_tpu_torch.data.pipeline import Batch, make_dataset
from gdkvm_tpu_torch.io.convert import state_dict_from_flax
from gdkvm_tpu_torch.models.gdkvm import GDKVM
from gdkvm_tpu_torch.train.loop import create_train_state, state_for, train_step
from test_torch_train import port_config

pytestmark = pytest.mark.slow

torch.set_num_threads(1)


def smoke_cfg(**overrides):
    """configs/smoke_synthetic.yaml (narrow fp32 model, 2 classes) at 32²,
    clip 2, a 1-update warmup, and bootstrapped CE whose weight is 0 at
    step 0 and 1 from step 1."""
    cfg = load_config("configs/smoke_synthetic.yaml")
    base = {"data.image_size": 32, "data.clip_len": 2,
            "train.warmup_iterations": 1, "train.bootstrap_ratio": 0.25,
            "train.bootstrap_start": 0.0, "train.bootstrap_end": 0.01}
    apply_overrides(cfg, [f"{k}={v}" for k, v in {**base, **overrides}.items()])
    return cfg


class _Pair:
    """The JAX train state and step for a config, and the port's train
    state on the same weights."""

    def __init__(self, jcfg):
        self.jcfg, self.cfg = jcfg, port_config(jcfg)
        jmodel = JGDKVM(cfg=jcfg.model)
        tx = make_optimizer(jcfg)
        size = jcfg.data.image_size
        params = jax.jit(jmodel.init)(
            jax.random.PRNGKey(0), jnp.zeros((1, 2, size, size, 1)), None,
            jnp.zeros((1, size, size), jnp.int32))
        ema = params if jcfg.train.ema_decay > 0 else None
        self.jstate = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                 opt_state=tx.init(params),
                                 rng=jax.random.PRNGKey(0), ema_params=ema)
        self.jstep = jax.jit(make_train_step(jmodel, tx, jcfg))
        model = GDKVM(self.cfg.model, device="cpu")
        model.load_state_dict(self.to_torch(params))
        self.state = state_for(self.cfg, model)

    def to_torch(self, tree):
        return state_dict_from_flax(jax.tree.map(np.asarray, tree), self.cfg.model)

    def step(self, batch: Batch):
        jbatch = JBatch(frames=jnp.asarray(batch.frames),
                        masks=jnp.asarray(batch.masks),
                        valid=jnp.asarray(batch.valid))
        self.jstate, jm = self.jstep(self.jstate, jbatch)
        m = train_step(self.state, batch, self.cfg)
        return m, jm


def _batch(cfg, idx=(0, 1)):
    ds = make_dataset(cfg.data, "train", cfg.model.num_classes)
    items = [ds[i] for i in idx]
    return Batch(*(np.stack([it[j] for it in items]) for j in range(3)))


def _assert_params_close(got: dict, want: dict, atol: float):
    for name, w in want.items():
        np.testing.assert_allclose(got[name].detach().numpy(), w.numpy(),
                                   rtol=0, atol=atol, err_msg=name)


@pytest.mark.parametrize("prompt_prob", [0.0, 1.0])
def test_train_step_matches_jax(prompt_prob):
    """Two steps (the first at lr 0 with bootstrap weight 0, the second at
    the peak lr with weight 1): loss, its terms and grad_norm at each step,
    and every parameter after the second, equal make_train_step's.
    prompt_prob 0 and 1 draw no random bits that would differ."""
    pair = _Pair(smoke_cfg(**{"train.prompt_prob": prompt_prob}))
    batch = _batch(pair.cfg)
    for _ in range(2):
        m, jm = pair.step(batch)
        for key in ("loss", "ce", "dice_loss", "grad_norm"):
            np.testing.assert_allclose(m[key].item(), float(jm[key]),
                                       rtol=1e-4, err_msg=key)
    # lr 3e-4: an Adam step moves each weight by up to ~3e-4.  1e-6 is
    # what fp32 summation order leaves of it.
    _assert_params_close(dict(pair.state.model.named_parameters()),
                         pair.to_torch(pair.jstate.params), atol=1e-6)


def test_accumulation_with_ema_matches_jax():
    """accum_steps=2 with EMA 0.9 over four micro-steps: params and the EMA
    shadow stay put on the withheld micro-steps and equal JAX's after each
    one; the metric is micro_grad_norm."""
    pair = _Pair(smoke_cfg(**{"train.accum_steps": 2, "train.ema_decay": 0.9,
                              "train.prompt_prob": 0.0}))
    batches = [_batch(pair.cfg, (0, 1)), _batch(pair.cfg, (2, 3))]
    names = [n for n, _ in pair.state.model.named_parameters()]
    for i in range(4):
        before = [e.clone() for e in pair.state.ema]
        m, jm = pair.step(batches[i % 2])
        assert "grad_norm" not in m
        np.testing.assert_allclose(m["micro_grad_norm"].item(),
                                   float(jm["micro_grad_norm"]), rtol=1e-4)
        if i % 2 == 0:
            for a, b in zip(before, pair.state.ema):
                assert torch.equal(a, b)
        _assert_params_close(dict(pair.state.model.named_parameters()),
                             pair.to_torch(pair.jstate.params), atol=1e-6)
        _assert_params_close(dict(zip(names, pair.state.ema)),
                             pair.to_torch(pair.jstate.ema_params), atol=1e-6)
    assert pair.state.opt.count == 2


def test_overfit_single_clip():
    """Port of tests/test_train.py::test_overfit_single_clip: 120 steps on
    one synthetic clip cut the loss below 45% of its first value, and the
    hard foreground Dice (the JAX package's metric on the port's logits)
    passes 0.9."""
    jcfg = load_config("configs/smoke_synthetic.yaml")
    apply_overrides(jcfg, ["train.prompt_prob=0.0", "data.image_size=48",
                           "data.clip_len=3", "num_iterations=500",
                           "learning_rate=2e-3"])
    cfg = port_config(jcfg)
    state = create_train_state(cfg, GDKVM(cfg.model, device="cpu"))
    batch = _batch(cfg, (0,))
    first = None
    for _ in range(120):
        metrics = train_step(state, batch, cfg)
        first = metrics["loss"].item() if first is None else first
    last = metrics["loss"].item()
    assert last < first * 0.45, f"no learning: {first:.3f} → {last:.3f}"
    with torch.no_grad():
        logits, _ = state.model(torch.from_numpy(batch.frames).float() / 255.0)
    acc = jmetrics.dice_accumulate(jnp.asarray(logits.numpy()),
                                   jnp.asarray(batch.masks, jnp.int32),
                                   jnp.asarray(batch.valid),
                                   cfg.model.num_classes)
    d = jmetrics.dice_finalize(jax.device_get(acc))
    assert d["dice_fg_mean"] > 0.9, d
