"""The port's evaluation (gdkvm_tpu_torch.eval) against the JAX package's,
on the CPU in fp32: Dice partial sums, HD95 and temporal consistency on the
same arrays; the eval stage and streaming eval on converted weights.
"""

import dataclasses
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdkvm_tpu.config import schema as jschema
from gdkvm_tpu.eval import evaluator as jevaluator
from gdkvm_tpu.eval import metrics as JM
from gdkvm_tpu.eval import streaming as jstreaming
from gdkvm_tpu.models.gdkvm import GDKVM as JGDKVM
from gdkvm_tpu.parallel import make_mesh
from gdkvm_tpu_torch.config.schema import (Config, DataConfig, EvalStageConfig,
                                           ModelConfig, RuntimeConfig)
from gdkvm_tpu_torch.data import camus
from gdkvm_tpu_torch.eval import metrics as M
from gdkvm_tpu_torch.eval import vis
from gdkvm_tpu_torch.eval.evaluator import evaluate
from gdkvm_tpu_torch.eval.streaming import stream_evaluate
from gdkvm_tpu_torch.eval.throughput import (measure_streaming_latency,
                                             measure_train_step_time)
from gdkvm_tpu_torch.io.convert import state_dict_from_flax
from gdkvm_tpu_torch.models.gdkvm import GDKVM

torch.set_num_threads(1)

NARROW = dict(enc_channels=(16, 16, 32, 32), enc_blocks=(1, 1, 1, 1),
              num_heads=2, head_dim_k=16, head_dim_v=16, kpff_channels=(16, 16),
              compute_dtype="float32", num_classes=4)
IMAGE = 32


# ---------------------------------------------------------------- metrics


def _dice_case(seed, b=3, t=4, k=4):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b, t, 16, 16, k)).astype(np.float32)
    labels = rng.integers(0, k, (b, t, 16, 16)).astype(np.uint8)
    valid = (rng.random((b, t)) < 0.7).astype(np.float32)
    return logits, labels, valid


def test_dice_sums_match_jax_exactly():
    """dice_accumulate's partial sums are JAX's, bit for bit; merged and
    finalized they give JAX's Dice within 1e-6."""
    accs, accs_j = [], []
    for seed in range(3):
        logits, labels, valid = _dice_case(seed)
        acc = M.dice_accumulate(torch.from_numpy(logits), torch.from_numpy(labels),
                                torch.from_numpy(valid), 4)
        acc_j = JM.dice_accumulate(jnp.asarray(logits), jnp.asarray(labels),
                                   jnp.asarray(valid), 4)
        assert set(acc) == set(acc_j) == {"inter", "psum", "lsum", "frames"}
        for key in acc:
            assert acc[key].dtype == torch.float32
            np.testing.assert_array_equal(acc[key].numpy(), np.asarray(acc_j[key]))
        accs.append(acc)
        accs_j.append(acc_j)
    out = M.dice_finalize(M.dice_merge(M.dice_merge(accs[0], accs[1]), accs[2]))
    out_j = JM.dice_finalize(JM.dice_merge(JM.dice_merge(accs_j[0], accs_j[1]), accs_j[2]))
    assert set(out) == set(out_j)
    for key in out:
        assert out[key] == pytest.approx(out_j[key], abs=1e-6), key
    assert out["frames"] == sum(float(a["frames"]) for a in accs)


def test_dice_edge_cases_match_jax():
    """No valid frame, a perfect prediction, and two classes only."""
    logits, labels, valid = _dice_case(5, k=2)
    for v in (np.zeros_like(valid), valid):
        perfect = np.eye(2, dtype=np.float32)[labels]
        for lg in (logits, perfect):
            out = M.dice_finalize(M.dice_accumulate(
                torch.from_numpy(lg), torch.from_numpy(labels), torch.from_numpy(v), 2))
            out_j = JM.dice_finalize(JM.dice_accumulate(
                jnp.asarray(lg), jnp.asarray(labels), jnp.asarray(v), 2))
            for key in out_j:
                assert out[key] == pytest.approx(out_j[key], abs=1e-6), key
    assert out["dice_fg_mean"] == pytest.approx(1.0, abs=1e-6)
    one = M.dice_finalize({k_: torch.ones(1) for k_ in ("inter", "psum", "lsum")}
                          | {"frames": torch.tensor(1.0)})
    assert np.isnan(one["dice_fg_mean"])


def _blob(rng, k=4, size=48):
    yy, xx = np.mgrid[:size, :size]
    out = np.zeros((size, size), np.int64)
    for c in range(1, k):
        cy, cx, r = rng.uniform(12, 36), rng.uniform(12, 36), rng.uniform(5, 11)
        out[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = c
    return out


def test_hd95_and_temporal_consistency_match_jax():
    rng = np.random.default_rng(0)
    for trial in range(4):
        pred, label = _blob(rng), _blob(rng)
        if trial == 3:
            pred[pred == 2] = 0                    # a class absent on one side
        for spacing in (1.0, (0.6, 0.4)):
            got, want = M.hd95(pred, label, 4, spacing), JM.hd95(pred, label, 4, spacing)
            assert got == want and got
    assert M.hd95(np.zeros((8, 8), int), np.zeros((8, 8), int), 4) == {}
    masks = np.stack([_blob(rng) for _ in range(6)])
    assert M.temporal_consistency(masks) == JM.temporal_consistency(masks)
    assert np.isnan(M.temporal_consistency(masks[:1])["flicker_rate"])


def test_overlay_matches_jax(tmp_path):
    from gdkvm_tpu.eval import vis as jvis
    rng = np.random.default_rng(1)
    frame = rng.integers(0, 255, (48, 48, 1), np.uint8)
    pred, gt = _blob(rng), _blob(rng)
    np.testing.assert_array_equal(vis.overlay(frame, pred), jvis.overlay(frame, pred))
    a = vis.save_vis(str(tmp_path / "a"), 7, 1, frame, pred, gt)
    b = jvis.save_vis(str(tmp_path / "b"), 7, 1, frame, pred, gt)
    assert os.path.basename(a) == os.path.basename(b) == "vis_step000007_01.png"
    assert open(a, "rb").read() == open(b, "rb").read()


# ---------------------------------------------------- the model on both sides


def _seeded_params(jmodel):
    """The JAX model's param tree, shaped by jax.eval_shape (no compile),
    filled from a numpy seed: kernels N(0, 1/fan_in), biases N(0, 0.1²),
    norm scales 1 + N(0, 0.1²)."""
    shapes = jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0),
        jnp.zeros((1, 2, IMAGE, IMAGE, 1)), None, jnp.zeros((1, IMAGE, IMAGE), jnp.int32))
    rng = np.random.default_rng(3)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path[-1:])
        x = rng.standard_normal(leaf.shape).astype(np.float32)
        if "kernel" in name:
            return x / np.sqrt(np.prod(leaf.shape[:-1]))
        return 1.0 + 0.1 * x if "scale" in name else 0.1 * x
    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def pair():
    jmodel = JGDKVM(cfg=jschema.ModelConfig(**NARROW))
    params = _seeded_params(jmodel)
    cfg = ModelConfig(**NARROW)
    model = GDKVM(cfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray, params), cfg))
    return jmodel, params, model.eval()


@pytest.fixture(scope="module")
def camus_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("camus"))
    camus.materialize_synthetic_camus(root, num_train=2, num_val=5, image_size=IMAGE,
                                      clip_len=4, difficulty=0.3, seed=1)
    return root


def _cfgs(root, run_dir, **stage):
    """The same settings as the port's Config and the JAX package's."""
    data = dict(dataset="camus", data_path=root, image_size=IMAGE, clip_len=4)
    stage = dict(num_vis=3, batch_size=2, wandb_mode="disabled", **stage)
    cfg = Config(model=ModelConfig(**NARROW), data=DataConfig(**data),
                 eval_stage=EvalStageConfig(**stage), runtime=RuntimeConfig(run_dir=run_dir))
    jcfg = jschema.Config(model=jschema.ModelConfig(**NARROW),
                          data=jschema.DataConfig(**data),
                          eval_stage=jschema.EvalStageConfig(**stage),
                          runtime=jschema.RuntimeConfig(run_dir=run_dir + "_j"))
    return cfg, jcfg


def _mesh1():
    return make_mesh(data=1, model=1, devices=jax.devices()[:1])


def test_evaluate_matches_jax(pair, camus_root, tmp_path):
    """The val split (5 clips in batches of 2: a ragged tail) through both
    eval stages: the same frame count, Dice within 1e-5, the same overlays."""
    jmodel, params, model = pair
    cfg, jcfg = _cfgs(camus_root, str(tmp_path / "run"))
    want = jevaluator.evaluate(jcfg, jmodel, params, _mesh1(), step=12)
    got = evaluate(cfg, model, "cpu", step=12)
    assert set(got) == set(want) and got["frames"] == want["frames"] == 20.0
    for key in want:
        assert got[key] == pytest.approx(want[key], abs=1e-5), key
    files = sorted(os.listdir(tmp_path / "run" / "vis"))
    assert files == sorted(os.listdir(tmp_path / "run_j" / "vis"))
    assert files == [f"vis_step000012_{i:02d}.png" for i in range(3)]
    # evaluate leaves the caller's grad mode as it found it.
    assert torch.is_grad_enabled() and not torch.is_inference_mode_enabled()


def test_evaluate_hd95_matches_jax(pair, camus_root, tmp_path):
    jmodel, params, model = pair
    cfg, jcfg = _cfgs(camus_root, str(tmp_path / "run"), hd95=True)
    cfg.eval_stage.num_vis = jcfg.eval_stage.num_vis = 0
    want = jevaluator.evaluate(jcfg, jmodel, params, _mesh1())
    got = evaluate(cfg, model, "cpu")
    assert set(got) == set(want) and "hd95_miss_frac" in got
    for key in want:
        assert got[key] == pytest.approx(want[key], abs=1e-5, rel=1e-5), key
    assert not os.path.exists(tmp_path / "run" / "vis")


def test_evaluate_missing_val_split_is_loud(pair, camus_root, tmp_path):
    cfg, _ = _cfgs(camus_root, str(tmp_path / "run"))
    cfg.data.val_split = "validation"
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert evaluate(cfg, pair[2], "cpu") == {}
    assert any("SKIPPING evaluation" in str(x.message) for x in w)


STREAM_CASES = {
    "single": dict(),
    "streams8": dict(streams=8),
    "streams2-tail": dict(streams=2),
    "reset": dict(reset_state=True),
    "occlude": dict(occlude=True),
    "occlude-window-reset-streams": dict(occlude=True, probe_window_only=True,
                                         reset_state=True, streams=2),
    "consistency": dict(consistency=True),
}


@pytest.mark.parametrize("case", sorted(STREAM_CASES))
def test_stream_evaluate_matches_jax(pair, case):
    """3 synthetic videos of 20 frames in chunks of 8 (a padded tail chunk;
    with 2 streams a padded tail group): equal frame counts, Dice within
    1e-5 of the JAX package's."""
    jmodel, params, model = pair
    kw = STREAM_CASES[case]
    data = dict(dataset="synthetic", image_size=IMAGE, synth_difficulty=0.4)
    cfg = Config(model=ModelConfig(**NARROW), data=DataConfig(**data),
                 eval_stage=EvalStageConfig(stream_chunk=8))
    jcfg = jschema.Config(model=jschema.ModelConfig(**NARROW),
                          data=jschema.DataConfig(**data),
                          eval_stage=jschema.EvalStageConfig(stream_chunk=8))
    want = jstreaming.stream_evaluate(jcfg, jmodel, params, num_videos=3, video_len=20, **kw)
    got = stream_evaluate(cfg, model, num_videos=3, video_len=20, **kw)
    assert set(got) == set(want)
    assert got["frames"] == want["frames"] == (12.0 if "window" in case else 60.0)
    for key in want:
        if key != "stream_frames_per_sec":
            assert got[key] == pytest.approx(want[key], abs=1e-5), key
    assert got["stream_frames_per_sec"] > 0


def test_stream_evaluate_streams_equal_single(pair):
    """8 streams in flight give the single-stream Dice sums exactly; the
    memory matters (reset changes them); occlusion lowers the window's Dice
    inputs."""
    model = pair[2]
    cfg = Config(model=ModelConfig(**NARROW),
                 data=DataConfig(image_size=IMAGE, synth_difficulty=0.4),
                 eval_stage=EvalStageConfig(stream_chunk=8))
    single = stream_evaluate(cfg, model, num_videos=3, video_len=20)
    multi = stream_evaluate(cfg, model, num_videos=3, video_len=20, streams=8)
    reset = stream_evaluate(cfg, model, num_videos=3, video_len=20, reset_state=True)
    assert multi["streams"] == 8.0 and multi["videos"] == 3.0
    dice = [k for k in single if k.startswith("dice")]
    assert all(single[k] == pytest.approx(multi[k], abs=1e-6) for k in dice)
    assert any(abs(single[k] - reset[k]) > 1e-6 for k in dice)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        stream_evaluate(cfg, model, num_videos=2, video_len=8, streams=2, consistency=True)
    assert any("single-stream" in str(x.message) for x in w)


def test_measuring_functions_refuse_the_cpu(pair):
    """Latency and step time have no default device, so none falls back to
    the CPU; given the CPU by name they time it and say so."""
    with pytest.raises(TypeError):
        measure_streaming_latency(pair[2])
    with pytest.raises(TypeError):
        measure_train_step_time(lambda: {"loss": torch.zeros(())})
    cpu = torch.device("cpu")
    lat = measure_streaming_latency(pair[2], cpu, image_size=IMAGE, warmup=0, timed=1)
    assert lat["device"] == "cpu" and lat["calls"] == 1
    calls = []
    step = measure_train_step_time(lambda: calls.append(0) or {"loss": torch.zeros(())}, cpu,
                                   warmup=1, timed=2)
    assert len(calls) == 3 and step["steps_per_sec"] > 0
