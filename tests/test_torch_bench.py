"""The port's headline entry, ``bench_torch.py``, and the FLOP count behind
its plausibility check (``gdkvm_tpu_torch/eval/flops.py``), on the CPU:
the one-line contract, the refusal without a card, a count that is the
same on every GDR route and close to XLA's cost analysis of ``bench.py``'s
step, ``measure_streaming_fps``'s keys against the JAX package's, and the
W8A8 arm's calibration against JAX's.
"""

import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import runpy
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdkvm_tpu.config import schema as jschema
from gdkvm_tpu.eval import throughput as jthroughput
from gdkvm_tpu.eval.metrics import mask_from_logits as jmask_from_logits
from gdkvm_tpu.models.gdkvm import GDKVM as JGDKVM
from gdkvm_tpu.ops import quant as jquant
from gdkvm_tpu_torch.config.schema import ModelConfig
from gdkvm_tpu_torch.eval import throughput
from gdkvm_tpu_torch.eval.flops import count_flops
from gdkvm_tpu_torch.models.gdkvm import GDKVM, init_params
from torch_port_util import model_pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENTRY = os.path.join(REPO, "bench_torch.py")
KEYS = {"metric", "value", "unit", "device", "apparent_tflops", "plausible"}
SMALL = {"GDKVM_BENCH_REPS": "1", "GDKVM_BENCH_TIMED_CHUNKS": "1",
         "GDKVM_BENCH_CHUNK": "2", "GDKVM_BENCH_BATCH": "1"}
# bench.py's ts8 model (bench.py:70-74), 2 classes on one channel.
TS8 = dict(num_classes=2, in_channels=1, enc_channels=(64, 64, 128, 192),
           enc_blocks=(1, 1, 2, 2), num_heads=4, head_dim_k=64, head_dim_v=64,
           kpff_channels=(128, 96))
CHUNK_SHAPE = (1, 4, 112, 112, 1)        # one ts8 chunk: batch 1 x 4 frames

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def entry():
    spec = importlib.util.spec_from_file_location("bench_torch", ENTRY)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _frames():
    return np.random.default_rng(0).integers(0, 255, CHUNK_SHAPE, np.uint8)


def _chunk_flops(model) -> int:
    frames = torch.from_numpy(_frames())
    with torch.inference_mode():
        return count_flops(lambda: throughput.streaming_step(model, frames, None))


@pytest.fixture(scope="module")
def ts8():
    return init_params(GDKVM(ModelConfig(**TS8), device="cpu"),
                       torch.Generator().manual_seed(0)).eval()


def test_entry_prints_one_line_on_the_cpu(entry, monkeypatch):
    """``python bench_torch.py --device cpu`` (run as __main__ in this
    process) prints one JSON line with exactly the contract's keys."""
    for key, value in SMALL.items():
        monkeypatch.setenv(key, value)
    monkeypatch.setattr(sys, "argv", [ENTRY, "--device", "cpu"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.raises(SystemExit) as exc:
        runpy.run_path(ENTRY, run_name="__main__")
    assert exc.value.code == 0
    lines = buf.getvalue().strip().splitlines()
    assert len(lines) == 1, lines
    rec = json.loads(lines[0])
    assert set(rec) == KEYS
    assert rec["metric"] == "echonet_streaming_frames_per_sec_per_gpu" == entry.METRIC
    assert rec["unit"] == "frames/sec" and rec["value"] > 0
    assert rec["device"] == "cpu" and rec["plausible"] is None
    assert rec["apparent_tflops"] > 0


def test_entry_refuses_without_a_card():
    """No card and no ``--device cpu``: a nonzero exit and no value line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **SMALL)
    res = subprocess.run([sys.executable, ENTRY], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=120)
    assert res.returncode != 0
    assert '"value"' not in res.stdout and res.stdout.strip() == ""
    assert "no CUDA device" in res.stderr


def test_chunk_count_is_the_same_on_every_route(ts8):
    """One ts8 chunk counts the same FLOPs whichever GDR route runs: the
    scan is counted from its shape, not from the route's own products."""
    counts = {}
    for impl in ("chunked", "ref", "assoc", "auto"):
        model = GDKVM(dataclasses.replace(ts8.cfg, gdr_impl=impl), device="cpu")
        model.load_state_dict(ts8.state_dict())
        counts[impl] = _chunk_flops(model.eval())
    assert len(set(counts.values())) == 1, counts
    assert counts["chunked"] > 2e9


def test_chunk_count_is_close_to_xla_cost_analysis(ts8):
    """The port's count of one ts8 chunk against XLA's cost analysis of
    bench.py's jitted step (gdkvm_tpu/eval/throughput.py), same config and
    shape: within 10% (XLA also counts the elementwise work)."""
    jmodel = JGDKVM(cfg=jschema.ModelConfig(**TS8))
    params = jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, 1, 16, 16, 1)), None,
        jnp.zeros((1, 16, 16), jnp.int32))

    def step_fn(params, frames_u8, state):
        logits, new_state = jmodel.apply(params, frames_u8.astype(jnp.float32) / 255.0,
                                         state)
        masks = jmask_from_logits(logits)
        return masks, jnp.sum(masks.astype(jnp.int32)), new_state

    frames = jax.ShapeDtypeStruct(CHUNK_SHAPE, jnp.uint8)
    ca = jax.jit(step_fn).lower(params, frames, None).compile().cost_analysis()
    xla = float((ca[0] if isinstance(ca, list) else ca)["flops"])
    ratio = _chunk_flops(ts8) / xla
    assert 0.9 <= ratio <= 1.1, ratio


def test_streaming_fps_has_every_jax_key():
    """The port's measure_streaming_fps returns every key of JAX's (and the
    device), with the apparent TFLOP/s and plausible None on the CPU."""
    kw = dict(image_size=32, chunk=2, batch=1, warmup_chunks=1, timed_chunks=1)
    jmodel, params, model = model_pair(32)
    want = jthroughput.measure_streaming_fps(jmodel, params, **kw)
    got = throughput.measure_streaming_fps(model, torch.device("cpu"), **kw)
    assert set(want) <= set(got) and set(got) - set(want) == {"device"}
    assert got["apparent_tflops"] > 0 and got["plausible"] is None
    assert throughput.peak_tflops(torch.device("cpu")) is None
    assert throughput.BF16_PEAK_TFLOPS == {"NVIDIA H100 80GB HBM3": 989.4,
                                           "NVIDIA H100 PCIe": 756.5}


def test_w8a8_arm_scales_match_jax(entry):
    """The W8A8 arm calibrates on bench.py's two batches as JAX does
    (absmax, encoder scope): the same scales on the same converted weights
    (the narrow model), at rtol 1e-5."""
    batches = entry.calibration_batches()
    rng = np.random.default_rng(0)
    want_batches = [rng.integers(0, 255, (1, 8, 112, 112, 1)).astype(np.float32) / 255.0
                    for _ in range(2)]
    for got_b, want_b in zip(batches, want_batches, strict=True):
        np.testing.assert_array_equal(got_b, want_b)
    jmodel, params, model = model_pair(112, num_classes=2)
    want = jquant.calibrate_act_scales(jmodel, params, want_batches)
    with torch.inference_mode():
        got = entry.w8a8_scales(model)
    assert sorted(got) == sorted(want) and got
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=1e-5), key


def test_w8a8_keeps_the_convs_in_the_count(ts8, entry):
    """Under W8A8 the int8 products (aten._int_mm) count as the products
    they are: the quantized ts8 chunk counts no less than the bf16 one and
    at most 1% more (the int8 product's padding)."""
    from gdkvm_tpu_torch.ops import quant
    with torch.inference_mode():
        qmodel = quant.w8a8_model(ts8, entry.w8a8_scales(ts8))
    plain, w8a8 = _chunk_flops(ts8), _chunk_flops(qmodel)
    assert plain <= w8a8 <= 1.01 * plain, (plain, w8a8)


def test_grad_count_is_the_same_on_every_route(ts8):
    """Under a gradient the scan's backward is counted from its shape too:
    forward and backward of a chunk count the same on every route."""
    x = torch.from_numpy(_frames()).to(torch.float32) / 255.0
    counts = {}
    for impl in ("chunked", "ref", "assoc"):
        model = GDKVM(dataclasses.replace(ts8.cfg, gdr_impl=impl), device="cpu")
        model.load_state_dict(ts8.state_dict())
        counts[impl] = count_flops(lambda: model(x)[0].float().sum().backward())
    assert len(set(counts.values())) == 1, counts
    assert counts["chunked"] > 2 * _chunk_flops(ts8)
