"""Checkpoints, the metrics log, step timing and the whole training run of
the port (gdkvm_tpu_torch.io, .utils.profiling, .train.loop.train) on the
CPU: a restored state continues bit for bit, a tree that does not match is
a named error, and a resumed run equals an unbroken one.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from gdkvm_tpu.io import metrics_log as jmetrics_log
from gdkvm_tpu_torch.config.schema import (Config, DataConfig, EvalStageConfig,
                                           ModelConfig, RuntimeConfig, TrainConfig,
                                           load_config)
from gdkvm_tpu_torch.data import camus, packed, pipeline
from gdkvm_tpu_torch.data.synthetic import SyntheticDataset
from gdkvm_tpu_torch.io.checkpoint import CheckpointManager, state_tree
from gdkvm_tpu_torch.io.metrics_log import MetricsLogger
from gdkvm_tpu_torch.models.gdkvm import GDKVM
from gdkvm_tpu_torch.train.loop import (create_train_state, eval_params, train,
                                        train_step, use_params)
from gdkvm_tpu_torch.utils.profiling import StepTimer, maybe_profile, trace_annotation

torch.set_num_threads(1)

TINY = dict(enc_channels=(8, 8, 16, 16), enc_blocks=(1, 1, 1, 1), num_heads=1,
            head_dim_k=8, head_dim_v=8, kpff_channels=(8, 8),
            compute_dtype="float32", num_classes=4)


def _cfg(run_dir="", **train_kw):
    kw = dict(batch_size=2, num_iterations=8, warmup_iterations=2, bootstrap_ratio=0.25,
              ema_decay=0.9, accum_steps=2, log_every=1, eval_every=4, checkpoint_every=4)
    kw.update(train_kw)
    return Config(model=ModelConfig(**TINY),
                  data=DataConfig(image_size=32, clip_len=2, occlude_prob=0.5),
                  train=TrainConfig(**kw),
                  eval_stage=EvalStageConfig(wandb_mode="disabled", num_vis=2),
                  runtime=RuntimeConfig(run_dir=run_dir))


def _state(cfg):
    return create_train_state(cfg, GDKVM(cfg.model, device="cpu"))


def _batches(cfg, n):
    ds = pipeline.make_dataset(cfg.data, "train", cfg.model.num_classes)
    it = pipeline.batch_iterator(ds, cfg.train.batch_size, augment=True, seed=1)
    return [next(it) for _ in range(n)]


def _assert_same_state(a, b):
    _assert_same_tree(state_tree(a), state_tree(b))


def _assert_same_tree(ta, tb):
    assert ta["step"] == tb["step"] and torch.equal(ta["gen"], tb["gen"])
    for key in ta["model"]:
        assert torch.equal(ta["model"][key], tb["model"][key]), key
    for key in ("count", "mini_step", "adam_step"):
        assert ta["opt"][key] == tb["opt"][key], key
    for key in ("acc", "exp_avg", "exp_avg_sq"):
        assert (ta["opt"][key] is None) == (tb["opt"][key] is None)
        for x, y in zip(ta["opt"][key] or [], tb["opt"][key] or []):
            assert torch.equal(x, y), key
    assert (ta["ema"] is None) == (tb["ema"] is None)
    for x, y in zip(ta["ema"] or [], tb["ema"] or []):
        assert torch.equal(x, y)


@pytest.mark.parametrize("saved_at", [3, 4])
def test_save_restore_one_more_step_is_bitwise(tmp_path, saved_at):
    """Save after ``saved_at`` micro-steps (3: mid-accumulation, with a
    half-filled buffer; 4: right after an applied update), restore into a
    fresh state, take two more steps: parameters, EMA, AdamW moments,
    counts and the prompt generator equal the unbroken run's bit for bit."""
    cfg = _cfg()
    batches = _batches(cfg, saved_at + 2)
    straight = _state(cfg)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    for i, b in enumerate(batches):
        train_step(straight, b, cfg)
        if i + 1 == saved_at:
            mgr.save(saved_at, straight)
    mgr.wait()
    assert mgr.latest_step() == saved_at

    resumed = mgr.restore(_state(dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, seed=5))))     # other init
    assert resumed.step == saved_at and resumed.opt.mini_step == saved_at % 2
    metrics = [train_step(resumed, b, cfg) for b in batches[saved_at:]]
    _assert_same_state(resumed, straight)
    assert all(np.isfinite(float(v)) for m in metrics for v in m.values())
    mgr.close()


def test_restore_before_the_first_update(tmp_path):
    """A checkpoint taken before AdamW has any moment restores to one."""
    cfg = _cfg(accum_steps=1)
    state = _state(cfg)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, state)
    other = mgr.restore(_state(cfg))
    _assert_same_state(other, state)
    b = _batches(cfg, 1)[0]
    train_step(other, b, cfg)
    train_step(state, b, cfg)
    _assert_same_state(other, state)


@pytest.mark.parametrize("change,names", [
    (dict(train=dict(ema_decay=0.0)), "ema"),
    (dict(train=dict(accum_steps=1)), "opt/acc"),
    (dict(model=dict(head_dim_v=16)), "model/lkva.v_proj.weight"),
    (dict(model=dict(gdr_variant="gdn2")), "lkva.eta_proj"),
])
def test_tree_mismatch_is_a_named_error(tmp_path, change, names):
    """Restoring into a template of another shape (no EMA, no accumulation
    buffer, other widths, another variant) raises the JAX manager's
    ValueError, naming what differs; the template is left untouched."""
    cfg = _cfg()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, _state(cfg))
    other = dataclasses.replace(cfg, **{
        part: dataclasses.replace(getattr(cfg, part), **kw) for part, kw in change.items()})
    template = _state(other)
    before = state_tree(template)
    with pytest.raises(ValueError, match="state tree mismatch") as err:
        mgr.restore(template)
    assert "ema_decay" in str(err.value) and names in str(err.value)
    _assert_same_tree(state_tree(template), before)
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        CheckpointManager(str(tmp_path / "empty")).restore(template)
    with pytest.raises(FileNotFoundError):
        mgr.restore(_state(cfg), step=3)


def test_manager_keeps_the_newest_and_writes_whole_files(tmp_path):
    """max_to_keep prunes the oldest; files appear under their final name
    only (written to a temporary name, then renamed); an existing step is
    rewritten only with force; the file loads with weights_only=True."""
    cfg = _cfg()
    state = _state(cfg)
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    assert mgr.latest_step() is None
    for step in (2, 4, 6):
        state.step = step
        mgr.save(step, state)
    mgr.wait()
    assert sorted(os.listdir(tmp_path)) == ["step_00000004.pt", "step_00000006.pt"]
    assert mgr.all_steps() == [4, 6] and mgr.latest_step() == 6
    mtime = os.path.getmtime(tmp_path / "step_00000006.pt")
    mgr.save(6, state)
    mgr.wait()
    assert os.path.getmtime(tmp_path / "step_00000006.pt") == mtime
    tree = torch.load(tmp_path / "step_00000006.pt", weights_only=True)
    assert tree["step"] == 6 and set(tree) == {"step", "model", "opt", "ema", "gen"}
    assert mgr.restore(_state(cfg), step=4).step == 4
    mgr.close()


def test_eval_params_and_use_params():
    """eval_params picks the EMA shadow when tracked and asked for;
    use_params scores it through the model without a copy and puts the
    parameters back."""
    cfg = _cfg(accum_steps=1)
    state = _state(cfg)
    for b in _batches(cfg, 3):
        train_step(state, b, cfg)
    assert eval_params(state, cfg) is state.ema
    cfg.eval_stage.use_ema = False
    assert eval_params(state, cfg) is state.opt.params
    params = [p.detach().clone() for p in state.model.parameters()]
    ema = [e.clone() for e in state.ema]
    assert any(not torch.equal(p, e) for p, e in zip(params, ema))
    x = torch.rand(1, 2, 32, 32, 1)
    with torch.no_grad():
        plain, _ = state.model(x)
        with use_params(state.model, state.ema):
            for p, e in zip(state.model.parameters(), ema):
                assert torch.equal(p, e)
            scored, _ = state.model(x)
        again, _ = state.model(x)
    assert torch.equal(plain, again) and not torch.equal(plain, scored)
    for p, q, e, f in zip(state.model.parameters(), params, state.ema, ema):
        assert torch.equal(p, q) and torch.equal(e, f)
    no_ema = _state(_cfg(ema_decay=0.0))
    assert no_ema.ema is None and eval_params(no_ema, _cfg()) is no_ema.opt.params


def test_metrics_logger_matches_jax(tmp_path):
    """The JSONL lines are the JAX package's logger's, field for field."""
    rows = [(1, {"loss": torch.tensor(1.5), "n": 3, "tag": "x"}),
            (2, {"eval/dice_fg_mean": np.float32(0.25)})]
    a = MetricsLogger(str(tmp_path / "a"), wandb_mode="disabled")
    b = jmetrics_log.MetricsLogger(str(tmp_path / "b"), wandb_mode="disabled")
    for step, metrics in rows:
        a.log(step, metrics)
        b.log(step, {k: (float(v) if isinstance(v, torch.Tensor) else v)
                     for k, v in metrics.items()})
    a.close()
    b.close()
    strip = lambda p: [{k: v for k, v in json.loads(l).items() if k != "time"}
                       for l in open(p)]
    got = strip(tmp_path / "a" / "metrics.jsonl")
    assert got == strip(tmp_path / "b" / "metrics.jsonl")
    assert got[0] == {"step": 1, "loss": 1.5, "n": 3.0, "tag": "x"}
    MetricsLogger(str(tmp_path / "a"), wandb_mode="disabled").close()   # appends
    assert len(strip(tmp_path / "a" / "metrics.jsonl")) == 2


def test_step_timer_and_profile(tmp_path):
    """The timer leaves its first ``skip`` laps out and reports nothing
    for an empty window; maybe_profile writes a trace only when asked."""
    timer = StepTimer(skip=1)
    timer.lap(torch.tensor(1.0))
    assert timer.stats() == {}
    timer.lap()
    timer.lap()
    stats = timer.stats()
    assert stats["steps_per_sec"] > 0
    assert stats["sec_per_step"] == pytest.approx(1 / stats["steps_per_sec"])
    timer.reset_window()
    assert timer.stats() == {}
    with maybe_profile(None), trace_annotation("nothing"):
        pass
    with maybe_profile(str(tmp_path / "trace")):
        with trace_annotation("train_step"):
            torch.ones(4).sum()
    trace = (tmp_path / "trace" / "trace.json").read_text()
    assert "train_step" in trace


# ------------------------------------------------------------ the whole run


def _rows(run_dir):
    return [json.loads(l) for l in open(os.path.join(run_dir, "metrics.jsonl"))]


@pytest.fixture(scope="module")
def data_roots(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    camus.materialize_synthetic_camus(str(root / "camus"), num_train=6, num_val=3,
                                      image_size=32, clip_len=2, seed=3)
    for split, n, seed in (("train", 6, 0), ("val", 3, 1)):
        packed.write_pck(str(root / "pck" / f"{split}.pck"),
                         SyntheticDataset(n, 2, 32, num_classes=4, seed=seed))
    return {"camus": str(root / "camus"), "packed": str(root / "pck")}


@pytest.mark.parametrize("dataset,cache", [("camus", "off"), ("packed", "on"),
                                           ("packed", "off")])
def test_run_writes_its_records_and_resumes_bitwise(tmp_path, data_roots, dataset, cache):
    """train(cfg, device="cpu") on a materialized CAMUS layout (thread pool
    and prefetch) and on a packed set (device cache, and the gather path):
    the JSONL has every logged step with finite loss, rates and the eval
    stage's Dice; checkpoints, overlays and config.yaml exist; and a run
    stopped at 4 and resumed to 8 logs the unbroken run's losses and batch
    checksums and ends in its state, bit for bit."""
    def cfg_for(name, **runtime):
        cfg = _cfg(str(tmp_path / name))
        cfg.data = dataclasses.replace(cfg.data, dataset=dataset, device_cache=cache,
                                       data_path=data_roots[dataset], num_workers=2)
        cfg.runtime = dataclasses.replace(cfg.runtime, **runtime)
        return cfg

    final = train(cfg_for("a"), device="cpu")
    assert {"loss", "ce", "dice_loss", "micro_grad_norm", "steps_per_sec",
            "frames_per_sec", "eval/dice_fg_mean", "eval/frames"} <= set(final)
    run = str(tmp_path / "a")
    rows = _rows(run)
    steps = [r for r in rows if "loss" in r]
    evals = [r for r in rows if "eval/dice_fg_mean" in r]
    assert [r["step"] for r in steps] == list(range(1, 9))
    assert [r["step"] for r in evals] == [4, 8] and evals[-1]["eval/frames"] == 6.0
    assert all(np.isfinite(r["loss"]) for r in steps)
    assert all(r["steps_per_sec"] > 0 and r["frames_per_sec"] ==
               pytest.approx(4 * r["steps_per_sec"]) for r in steps[1:])
    assert final["eval/dice_fg_mean"] == evals[-1]["eval/dice_fg_mean"]
    assert sorted(os.listdir(os.path.join(run, "checkpoints"))) == \
        ["step_00000004.pt", "step_00000008.pt"]
    assert len(os.listdir(os.path.join(run, "vis"))) == 4          # 2 a pass
    saved = load_config(os.path.join(run, "config.yaml"))
    assert saved.data.dataset == dataset and saved.model.enc_channels == (8, 8, 16, 16)

    train(cfg_for("b"), max_steps=4, device="cpu")
    assert train(cfg_for("b", resume=True), device="cpu").keys() == final.keys()
    rows_b = [r for r in _rows(str(tmp_path / "b")) if "loss" in r]
    assert [r["step"] for r in rows_b] == list(range(1, 9))
    for r, r_b in zip(steps, rows_b):
        assert r["loss"] == r_b["loss"] and r["batch_checksum"] == r_b["batch_checksum"]
    tpl = lambda: _state(cfg_for("tpl"))
    a = CheckpointManager(os.path.join(run, "checkpoints")).restore(tpl())
    b = CheckpointManager(str(tmp_path / "b" / "checkpoints")).restore(tpl())
    assert a.step == b.step == 8
    _assert_same_state(a, b)


def test_run_profile_and_final_eval_uses_ema(tmp_path, data_roots):
    """runtime.profile writes run_dir/trace; with use_ema off the final
    eval scores the raw parameters and differs from the EMA's."""
    cfg = _cfg(str(tmp_path / "p"), num_iterations=5, eval_every=100, checkpoint_every=100,
               accum_steps=1, warmup_iterations=1, learning_rate=5e-2)
    cfg.data = dataclasses.replace(cfg.data, dataset="packed", data_path=data_roots["packed"])
    cfg.runtime.profile = True
    ema = train(cfg, device="cpu")
    assert os.path.exists(tmp_path / "p" / "trace" / "trace.json")
    cfg.runtime = RuntimeConfig(run_dir=str(tmp_path / "q"))
    cfg.eval_stage.use_ema = False
    raw = train(cfg, device="cpu")
    assert raw["loss"] == ema["loss"]
    assert raw["eval/dice_class0"] != ema["eval/dice_class0"]
