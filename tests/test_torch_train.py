"""The port's training pieces (gdkvm_tpu_torch.train, .data, .config) against
the JAX package's, on the CPU.

Inputs are made with numpy from a seed and go to both frameworks.  The
whole train step, accumulation with EMA and the overfit run, which need a
compiled JAX train step, are in tests/test_torch_train_slow.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gdkvm_tpu.config import schema as jschema
from gdkvm_tpu.data import pipeline as jpipeline
from gdkvm_tpu.data import synthetic as jsynthetic
from gdkvm_tpu.models.gdkvm import train_model_config as j_train_model_config
from gdkvm_tpu.train import losses as jlosses
from gdkvm_tpu.train.loop import make_optimizer
from gdkvm_tpu_torch.config.schema import (Config, DataConfig, EvalStageConfig,
                                           ModelConfig, RuntimeConfig,
                                           TrainConfig, ts8_256)
from gdkvm_tpu_torch.data import pipeline, synthetic
from gdkvm_tpu_torch.models.gdkvm import train_model_config
from gdkvm_tpu_torch.train import losses
from gdkvm_tpu_torch.train.loop import Optimizer, lr_schedule, train

torch.set_num_threads(1)


def port_config(jcfg: jschema.Config) -> Config:
    """The port's Config with every field it has taken from a JAX Config."""
    pick = lambda cls, src: cls(**{f.name: getattr(src, f.name)
                                   for f in dataclasses.fields(cls)})
    return Config(model=pick(ModelConfig, jcfg.model),
                  data=pick(DataConfig, jcfg.data),
                  train=pick(TrainConfig, jcfg.train),
                  eval_stage=pick(EvalStageConfig, jcfg.eval_stage),
                  runtime=pick(RuntimeConfig, jcfg.runtime))


def _jax_config(**train) -> jschema.Config:
    cfg = jschema.Config()
    for key, val in train.items():
        setattr(cfg.train, key, val)
    return cfg


# ---------------------------------------------------------------- config


def test_ts8_256_preset_matches_yaml():
    """ts8_256() equals configs/gdkvm_ts8_256.yaml field for field (every
    field the port has)."""
    want = port_config(jschema.load_config("configs/gdkvm_ts8_256.yaml"))
    got = ts8_256()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.data.image_size == 256 and got.model.num_classes == 4
    assert got.train.bootstrap_ratio == 0.15
    assert got.data.dataset == "camus" and got.data.data_path.startswith("/data/camus")
    assert ts8_256("/x").data.data_path == "/x"


@pytest.mark.parametrize("cls,ref", [(DataConfig, jschema.DataConfig),
                                     (TrainConfig, jschema.TrainConfig),
                                     (EvalStageConfig, jschema.EvalStageConfig),
                                     (RuntimeConfig, jschema.RuntimeConfig),
                                     (Config, jschema.Config)])
def test_config_fields_match_jax(cls, ref):
    """The port's data, train, eval-stage and runtime fields are JAX fields
    with JAX defaults; Config has JAX's sections and top-level aliases."""
    if cls is Config:
        sections = [f.name for f in dataclasses.fields(cls)]
        assert sections == [f.name for f in dataclasses.fields(ref)]
        assert sections[:6] == ["model", "data", "train", "eval_stage", "parallel", "runtime"]
        return
    ref_defaults = {f.name: f.default for f in dataclasses.fields(ref)}
    for f in dataclasses.fields(cls):
        assert f.name in ref_defaults, f.name
        assert f.default == ref_defaults[f.name], f.name


@pytest.mark.parametrize("gdr_impl", ["auto", "chunked", "pallas"])
@pytest.mark.parametrize("image_size", [112, 176, 192, 256, None])
def test_train_model_config_matches_jax(gdr_impl, image_size):
    """"auto" stays at N ≥ 128 memory tokens (256²: N=256) and resolves
    to "chunked" below (112²: N=49)."""
    got = train_model_config(ModelConfig(gdr_impl=gdr_impl), image_size)
    want = j_train_model_config(jschema.ModelConfig(gdr_impl=gdr_impl),
                                image_size)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


# ---------------------------------------------------------------- losses


def _loss_inputs(seed, b=2, t=2, hw=128, k=4):
    rng = np.random.default_rng(seed)
    logits = (2 * rng.standard_normal((b, t, hw, hw, k))).astype(np.float32)
    labels = rng.integers(0, k, (b, t, hw, hw)).astype(np.int32)
    valid = np.array([[1.0, 0.0], [1.0, 1.0]], np.float32)[:b, :t]
    return logits, labels, valid


@pytest.mark.parametrize("ratio,weight", [(1.0, 1.0), (0.25, 0.7), (0.15, 1.0)])
def test_segmentation_loss_matches_jax(ratio, weight):
    """CE + soft Dice, plain and bootstrapped, and the gradient with respect
    to the logits.  128² frames make the threshold's subsample strided
    (stride 2).  fp32 on both sides; tolerances cover summation order."""
    logits, labels, valid = _loss_inputs(0)

    def jloss(lg):
        return jlosses.segmentation_loss(lg, jnp.asarray(labels), jnp.asarray(valid),
                                         bootstrap_ratio=ratio,
                                         bootstrap_weight=weight)
    (l_j, aux_j), g_j = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(logits))
    lg = torch.from_numpy(logits).requires_grad_(True)
    loss, aux = losses.segmentation_loss(lg, torch.from_numpy(labels),
                                         torch.from_numpy(valid),
                                         bootstrap_ratio=ratio,
                                         bootstrap_weight=weight)
    (g,) = torch.autograd.grad(loss, [lg])
    for key in ("loss", "ce", "dice_loss"):
        np.testing.assert_allclose(aux[key].item(), float(aux_j[key]),
                                   rtol=1e-5, err_msg=key)
    g_j = np.asarray(g_j)
    np.testing.assert_allclose(g.numpy(), g_j, rtol=1e-4,
                               atol=1e-5 * np.abs(g_j).max())


def test_bootstrapped_threshold_subsample():
    """At 256² the threshold comes from every 8th pixel and keeps the
    hardest round(0.15 · 8192) = 1229 of them; the mask keeps at least as
    many pixels of the full frame as the subsample's share implies."""
    logits, labels, valid = _loss_inputs(1, b=1, t=2, hw=256)
    lg = torch.from_numpy(logits)
    loss, aux = losses.segmentation_loss(lg, torch.from_numpy(labels),
                                         torch.from_numpy(valid),
                                         bootstrap_ratio=0.15)
    l_j, aux_j = jlosses.segmentation_loss(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(valid),
        bootstrap_ratio=0.15)
    np.testing.assert_allclose(aux["ce"].item(), float(aux_j["ce"]), rtol=1e-5)
    plain, _ = losses.segmentation_loss(lg, torch.from_numpy(labels),
                                        torch.from_numpy(valid))
    assert loss.item() > plain.item()          # hard pixels cost more


def test_bootstrap_schedule_matches_jax():
    for n, start, end in ((1000, 0.2, 0.6), (3000, 0.2, 0.6), (10, 0.0, 0.01)):
        for step in (0, 1, 5, 199, 200, 201, 400, 599, 600, 601, 2999, 5000):
            got = losses.bootstrap_schedule(step, n, start, end)
            assert got.dtype == torch.float32
            assert got.item() == float(jlosses.bootstrap_schedule(step, n, start, end))


# ------------------------------------------------------------- optimizer


@pytest.mark.parametrize("accum", [1, 2])
def test_lr_sequence_matches_optax(accum):
    """With a constant unit gradient, no weight decay and no clipping,
    AdamW's step is −lr/(1 + ε): every micro-step's parameter change reads
    the learning rate the optimizer applied.  The JAX package's optax chain
    and the port's Optimizer give the same sequence: 0 first, the warmup,
    the cosine down to 5%, and (k=2) nothing on the withheld micro-steps."""
    kw = dict(num_iterations=12, warmup_iterations=4, learning_rate=1e-3,
              weight_decay=0.0, grad_clip=1e9, accum_steps=accum)
    jcfg = _jax_config(**kw)
    tx = make_optimizer(jcfg)
    update = jax.jit(tx.update)
    jparams = {"w": jnp.zeros((3,), jnp.float32)}
    jstate = tx.init(jparams)
    p = torch.zeros(3)
    opt = Optimizer([p], port_config(jcfg))
    sched = lr_schedule(port_config(jcfg))
    got, want, applied = [], [], []
    for _ in range(2 * 12 + 2):
        updates, jstate = update({"w": jnp.ones((3,))}, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        want.append(float(updates["w"][0]))
        before = p.clone()
        applied.append(opt.step([torch.ones(3)]))
        got.append((p - before)[0].item())
    # optax takes Adam's bias corrections in fp32 (1 − 0.999ᵗ loses ~5
    # digits at t=1); the port in float64.
    np.testing.assert_allclose(got, want, rtol=5e-5, atol=1e-12)
    assert want[accum - 1] == 0.0 and applied[accum - 1]      # lr(0) = 0
    assert applied == [(i + 1) % accum == 0 for i in range(len(applied))]
    # The changes are read off fp32 params near 1e-3: ~1e-6 relative.
    lrs = [-d * (1 + 1e-8) for d, a in zip(got, applied) if a]
    np.testing.assert_allclose(lrs, [sched(c) for c in range(len(lrs))],
                               rtol=1e-5, atol=1e-12)
    assert abs(sched(12 // accum) - 0.05e-3) < 1e-12           # ends at 5%


def test_clip_adamw_update_matches_optax():
    """Clip by global norm (triggered: the grads' norm is ~10× the clip)
    then AdamW with weight decay on every leaf, three updates."""
    rng = np.random.default_rng(3)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 2)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    jcfg = _jax_config(num_iterations=10, warmup_iterations=1,
                       learning_rate=1e-2, weight_decay=1e-2, grad_clip=1.0)
    tx = make_optimizer(jcfg)
    update = jax.jit(tx.update)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jparams)
    tparams = [torch.from_numpy(params[k].copy()) for k in shapes]
    opt = Optimizer(tparams, port_config(jcfg))
    for _ in range(3):
        grads = {k: (3 * rng.standard_normal(s)).astype(np.float32)
                 for k, s in shapes.items()}
        updates, jstate = update({k: jnp.asarray(g) for k, g in grads.items()},
                                 jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        assert opt.step([torch.from_numpy(grads[k]) for k in shapes])
        for k, p in zip(shapes, tparams):
            np.testing.assert_allclose(p.numpy(), np.asarray(jparams[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
    moved = max(np.abs(p.numpy() - params[k]).max() for k, p in zip(shapes, tparams))
    assert moved > 1e-3


# ------------------------------------------------------------------ data


@pytest.mark.parametrize("difficulty", [0.0, 0.5])
def test_synthetic_clips_identical(difficulty):
    """generate_clip and SyntheticDataset give the JAX package's arrays,
    at 256² with 4 classes."""
    for seed in (0, 1, 7):
        f, m = synthetic.generate_clip(seed, 10, 256, 256, 4, difficulty)
        f_j, m_j = jsynthetic.generate_clip(seed, 10, 256, 256, 4, difficulty)
        np.testing.assert_array_equal(f, f_j)
        np.testing.assert_array_equal(m, m_j)
        assert f.dtype == np.uint8 and f.shape == (10, 256, 256, 1)
        assert set(np.unique(m)) <= {0, 1, 2, 3}
    ds = synthetic.SyntheticDataset(3, 10, 256, 4, seed=2, difficulty=difficulty)
    ds_j = jsynthetic.SyntheticDataset(3, 10, 256, 4, seed=2, difficulty=difficulty)
    for i in range(len(ds)):
        for a, b in zip(ds[i], ds_j[i]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("occlude_prob", [0.0, 0.5, 1.0])
def test_augment_and_occlude_identical(occlude_prob):
    """The same np.random.Generator gives the same augmented clip, and
    leaves the generator in the same state."""
    frames, masks = synthetic.generate_clip(5, 6, 48, 48, 4)
    for seed in range(8):
        rng, rng_j = np.random.default_rng(seed), np.random.default_rng(seed)
        f, m = pipeline._augment(rng, frames.copy(), masks.copy(), occlude_prob)
        f_j, m_j = jpipeline._augment(rng_j, frames.copy(), masks.copy(),
                                      occlude_prob)
        np.testing.assert_array_equal(f, f_j)
        np.testing.assert_array_equal(m, m_j)
        assert rng.random() == rng_j.random()
        o = pipeline._occlude(rng, frames.copy(), occlude_prob)
        o_j = jpipeline._occlude(rng_j, frames.copy(), occlude_prob)
        np.testing.assert_array_equal(o, o_j)


def test_batch_iterator_matches_jax_host_path():
    """Shuffled, augmented, occluded batches across an epoch boundary equal
    the JAX package's host batch_iterator for the same seed."""
    data = DataConfig(image_size=32, clip_len=3, seed=4)
    ds = pipeline.make_dataset(data, "train", 2)
    ds.num_clips = 5                               # 2 batches an epoch
    ds_j = jsynthetic.SyntheticDataset(5, 3, 32, 2, seed=4)
    kw = dict(shuffle=True, augment=True, occlude_prob=0.5, seed=9)
    it = pipeline.batch_iterator(ds, 2, **kw)
    it_j = jpipeline.batch_iterator(ds_j, 2, num_workers=1, **kw)
    for _ in range(5):
        b, b_j = next(it), next(it_j)
        for name in ("frames", "masks", "valid"):
            np.testing.assert_array_equal(getattr(b, name), getattr(b_j, name))
    with pytest.raises(FileNotFoundError, match="CAMUS split directory"):
        pipeline.make_dataset(dataclasses.replace(data, dataset="camus"), "train", 4)


# ------------------------------------------------------------------ loop


def test_train_runs_on_cpu(tmp_path):
    """train(cfg, max_steps) on a tiny synthetic config returns the last
    logged step's finite metrics and the final eval's; under accumulation
    the norm is the micro-step's."""
    model = ModelConfig(enc_channels=(8, 8, 16, 16), enc_blocks=(1, 1, 1, 1),
                        num_heads=1, head_dim_k=8, head_dim_v=8,
                        kpff_channels=(8, 8), compute_dtype="float32")
    cfg = Config(model=model,
                 data=DataConfig(image_size=32, clip_len=2, occlude_prob=0.5),
                 train=TrainConfig(batch_size=2, num_iterations=4,
                                   warmup_iterations=1, bootstrap_ratio=0.25,
                                   ema_decay=0.9, accum_steps=2),
                 eval_stage=EvalStageConfig(wandb_mode="disabled", num_vis=0),
                 runtime=RuntimeConfig(run_dir=str(tmp_path)))
    metrics = train(cfg, max_steps=3, device="cpu")
    assert {"loss", "ce", "dice_loss", "micro_grad_norm", "batch_checksum",
            "eval/dice_fg_mean", "eval/frames"} <= set(metrics)
    assert "grad_norm" not in metrics
    assert all(np.isfinite(v) for v in metrics.values())
    assert (tmp_path / "checkpoints" / "step_00000003.pt").exists()


def test_train_defaults_to_cuda_and_never_falls_back(monkeypatch):
    """train(cfg, max_steps) with no device runs on the card; where there is
    none it raises instead of training on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config(model=ModelConfig(enc_channels=(8, 8, 16, 16),
                                   enc_blocks=(1, 1, 1, 1), num_heads=1,
                                   head_dim_k=8, head_dim_v=8,
                                   kpff_channels=(8, 8)),
                 data=DataConfig(image_size=32, clip_len=2),
                 train=TrainConfig(batch_size=2, num_iterations=1))
    for device in ((), ("cuda",)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train(cfg, 1, *device)
