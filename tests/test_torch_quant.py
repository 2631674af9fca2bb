"""W8A8 quantized serving in the port (gdkvm_tpu_torch/ops/quant.py) against
the JAX package's ops/quant.py, on the CPU.

The int8 conv is bit-equal to JAX's in fp32 (and after the cast in bf16);
calibration finds the same convs and scales; the W8A8 model matches JAX's
``QuantGDKVM`` on converted weights and the same scales; the tag and the
scales JSON are shared by both packages; the W8A8 artifact equals the eager
W8A8 model.  Inputs are made with numpy from a seed.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdkvm_tpu.ops import quant as jquant
from gdkvm_tpu_torch.cli import main
from gdkvm_tpu_torch.models.gdkvm import StreamState
from gdkvm_tpu_torch.ops import quant
from torch_port_util import NARROW_OVERRIDES, model_pair

torch.set_num_threads(1)
IMAGE = 32
ARMS = {"ts8": (16, 16), "flagship": (16, 16, 16)}     # narrow kpff_channels

# (batch, H, W, C_in, C_out, kernel, stride, bias): strides 1 and 2, 1×1
# and 3×3, odd sizes, K = C_in·k² off a multiple of 8, M ≤ 16 rows.
CONV_CASES = [
    (2, 8, 8, 6, 10, 3, 1, False),
    (1, 9, 7, 4, 8, 3, 2, True),
    (2, 5, 5, 5, 3, 1, 1, True),
    (1, 3, 3, 3, 5, 3, 1, False),
    (2, 16, 16, 16, 24, 3, 2, False),
    (1, 12, 12, 32, 16, 1, 1, False),
]


@pytest.mark.parametrize("case", CONV_CASES, ids=lambda c: "b{}_{}x{}_c{}_o{}_k{}_s{}_{}".format(
    *c[:7], "bias" if c[7] else "nobias"))
def test_w8a8_conv_bit_equal_to_jax(case):
    b, h, w, c, o, k, s, with_bias = case
    rng = np.random.default_rng(sum(case[:7]))
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    kern = (rng.standard_normal((k, k, c, o)) * 0.2).astype(np.float32)
    bias = rng.standard_normal(o).astype(np.float32) if with_bias else None
    act_scale = float(np.abs(x).max()) * 0.8          # some inputs clip
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = jquant.quantized_conv(
            jnp.asarray(x), jnp.asarray(kern), act_scale, strides=(s, s),
            padding="SAME", bias=None if bias is None else jnp.asarray(bias),
            out_dtype=jdt)
        got = quant.quantized_conv(
            torch.from_numpy(x).permute(0, 3, 1, 2),
            torch.from_numpy(kern).permute(3, 2, 0, 1), act_scale, stride=s,
            bias=None if bias is None else torch.from_numpy(bias), out_dtype=tdt)
        assert got.dtype == tdt
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))


def test_int8_product_is_exact_through_its_padding():
    """The packed weight's zero rows and columns and the padded rows of a
    small im2col matrix change nothing: the int32 product equals the exact
    integer conv of the quantized operands."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((1, 3, 3, 3)).astype(np.float32))
    wt = torch.from_numpy((rng.standard_normal((5, 3, 3, 3)) * 0.2).astype(np.float32))
    mat, deq = quant.pack_weight(wt, 1.5)
    assert mat.shape == (8, 8 * 9) and mat.dtype == torch.int8
    w8, _ = quant.quantize_weight(wt)
    x8 = quant.quantize_act(x, 1.5)
    ref = torch.nn.functional.conv2d(x8.double(), w8.double(), padding=1)
    got = quant.int8_conv(x, mat, deq, 1.5, ksize=3, stride=1, bias=None,
                          out_dtype=torch.float32)
    want = (ref.float() * deq[None, :, None, None])
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert torch.equal(mat[5:], torch.zeros_like(mat[5:]))


@pytest.fixture(scope="module")
def pairs():
    return {arm: model_pair(IMAGE, kpff_channels=kpff) for arm, kpff in ARMS.items()}


def _clips(seed, n=2, t=3):
    rng = np.random.default_rng(seed)
    return [rng.random((1, t, IMAGE, IMAGE, 1)).astype(np.float32) for _ in range(n)]


# Both packages' fp32 activations differ by up to ~3e-6 relative at the
# decoder's convs (their float convs round differently), which bounds the
# agreement of the statistics taken from them.
CALIB_RTOL = {"absmax": 1e-5, "percentile": 1e-5}


@pytest.mark.parametrize("method", ["absmax", "percentile"])
@pytest.mark.parametrize("scope", ["encoder", "decoder", "all"])
@pytest.mark.parametrize("arm", ["ts8", "flagship"])
def test_calibration_matches_jax(pairs, arm, scope, method):
    jmodel, params, model = pairs[arm]
    clips = _clips(1)
    want = jquant.calibrate_act_scales(jmodel, params, clips, scope=scope,
                                       method=method)
    with torch.inference_mode():
        got = quant.calibrate_act_scales(model, clips, scope=scope, method=method)
    assert sorted(got) == sorted(want) and got
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=CALIB_RTOL[method]), key


def test_linear_percentile_beyond_the_quantile_limit():
    """More than 2²⁴ elements (torch.quantile refuses them): the two order
    statistics and their interpolation agree with numpy's default
    percentile.  The position is fp32 arithmetic, as in ``jnp.percentile``:
    past 2²⁴ it moves by up to one order statistic, ~3e-6 relative here."""
    a = np.random.default_rng(0).standard_normal(2 ** 24 + 5).astype(np.float32)
    t = torch.from_numpy(np.abs(a))
    for q in (99.9, 50.0, 100.0):
        want = np.percentile(np.abs(a).astype(np.float64), q)
        assert quant.linear_percentile(t, q).item() == pytest.approx(want, rel=1e-5)


def test_linear_percentile_rounds_as_jax():
    """On a wide gap between the neighbours (the top of a small map) the
    fp32 position matters: the result equals ``jnp.percentile``'s."""
    a = np.abs(np.random.default_rng(1).standard_normal(767)).astype(np.float32)
    a[-1] = 40.0
    for q in (99.9, 97.3, 50.0):
        want = float(jnp.percentile(jnp.asarray(a), q))
        got = quant.linear_percentile(torch.from_numpy(a), q).item()
        assert got == pytest.approx(want, rel=1e-6), q


# fp32 compute: the logits of the two W8A8 models agree to fp32 rounding,
# unless an activation rounds to another int8 step in the two packages.
W8A8_LOGIT_ATOL = 1e-4
# bf16 compute: the two packages' bf16 activations differ by a bf16 step
# here and there, and a W8A8 conv can round such an input to the next int8
# step, so the masks of these random narrow models (near-tied logits) agree
# less than the float models' do: measured 0.940 / 0.945 (ts8 / flagship).
W8A8_BF16_AGREE = 0.90


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arm", ["ts8", "flagship"])
def test_w8a8_model_matches_jax(arm, dtype):
    jmodel, params, model = model_pair(IMAGE, kpff_channels=ARMS[arm],
                                       compute_dtype=dtype)
    scales = jquant.calibrate_act_scales(jmodel, params, _clips(2), scope="all")
    jq, q = jquant.w8a8_model(jmodel, scales), quant.w8a8_model(model, scales)
    assert q.cfg.quant == jq.cfg.quant
    frames = np.random.default_rng(3).random((2, 3, IMAGE, IMAGE, 1)).astype(np.float32)
    # Un-jitted: under jit XLA fuses JAX's float ops differently and an
    # activation at an int8 rounding boundary can land on the other step.
    want, jstate = jq.apply(params, jnp.asarray(frames))
    with torch.inference_mode():
        got, state = q(torch.from_numpy(frames))
        floats, _ = model(torch.from_numpy(frames))
    want = np.asarray(want)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=W8A8_LOGIT_ATOL)
        np.testing.assert_allclose(state.mem.numpy(), np.asarray(jstate.mem),
                                   rtol=0, atol=W8A8_LOGIT_ATOL)
    agree = (got.argmax(-1).numpy() == want.argmax(-1)).mean()
    assert agree >= W8A8_BF16_AGREE, agree
    # And W8A8 is a different model from the float one.
    assert not torch.equal(got, floats)


def test_tag_and_scales_json_are_shared_with_jax(pairs, tmp_path):
    jmodel, params, model = pairs["ts8"]
    scales = jquant.calibrate_act_scales(jmodel, params, _clips(4))
    with torch.inference_mode():
        mine = quant.calibrate_act_scales(model, _clips(4))
    assert quant.quant_tag(scales) == jquant.w8a8_model(jmodel, scales).cfg.quant
    assert quant.w8a8_model(model, mine).cfg.quant == jquant.w8a8_model(
        jmodel, mine).cfg.quant
    jquant.save_scales(str(tmp_path / "j.json"), scales)
    quant.save_scales(str(tmp_path / "t.json"), mine)
    assert quant.load_scales(str(tmp_path / "j.json")) == scales
    assert jquant.load_scales(str(tmp_path / "t.json")) == mine
    assert (tmp_path / "j.json").read_text() == json.dumps(scales, indent=2,
                                                             sort_keys=True)


def test_uncalibrated_and_depthwise_convs_stay_float(pairs):
    _, _, model = pairs["ts8"]
    with torch.inference_mode():
        enc = quant.calibrate_act_scales(model, _clips(5), scope="encoder")
        every = quant.calibrate_act_scales(model, _clips(5), scope="all")
    q_enc, q_all = quant.w8a8_model(model, enc), quant.w8a8_model(model, every)
    convs = quant.eligible_convs(q_enc)
    assert all((c.act_scale is not None) == p.startswith("encoder")
               for p, c in convs.items())
    assert "decoder/head" in convs and "encoder/ConvBlock_0/Conv_0" in convs
    assert not any("local_dw" in p for p in convs)
    assert q_all.decoder.kpff16.local_dw.act_scale is None
    with pytest.raises(ValueError, match="depthwise"):
        q_all.decoder.kpff16.local_dw.set_act_scale(1.0)
    frames = torch.from_numpy(_clips(6)[0])
    with torch.inference_mode():
        assert not torch.allclose(q_enc(frames)[0], q_all(frames)[0])


def test_percentile_calibration_is_robust_to_one_hot_pixel(pairs):
    """One speckle spike inflates the abs-max scale of the stem, which sees
    the raw input, and wrecks the masks; the 99.9th percentile ignores it
    (tests/test_quant.py::test_percentile_calibration_robust)."""
    _, _, model = pairs["ts8"]
    clean = _clips(7, n=1)[0]
    outlier = clean.copy()
    outlier[0, 0, 3, 3, 0] = 100.0
    with torch.inference_mode():
        s_clean = quant.calibrate_act_scales(model, [clean])
        s_abs = quant.calibrate_act_scales(model, [outlier])
        s_pct = quant.calibrate_act_scales(model, [outlier], method="percentile")
    assert max(s_abs[k] / s_clean[k] for k in s_clean) > 10.0
    assert max(s_pct[k] / s_clean[k] for k in s_clean) < 3.0
    frames = torch.from_numpy(_clips(8, n=1)[0])
    with torch.inference_mode():
        ref = model(frames)[0].argmax(-1)
        agree = {name: (quant.w8a8_model(model, s)(frames)[0].argmax(-1) == ref)
                 .float().mean().item() for name, s in (("abs", s_abs), ("pct", s_pct))}
    assert agree["pct"] > 0.95 and agree["pct"] > agree["abs"], agree


def test_bad_method_scope_and_scale_keys_are_refused(pairs):
    _, _, model = pairs["ts8"]
    with pytest.raises(ValueError, match="calibration method"):
        quant.calibrate_act_scales(model, [], method="minmax")
    with pytest.raises(ValueError, match="scope"):
        quant.calibrate_act_scales(model, [], scope="lkva")
    with pytest.raises(ValueError, match="no eligible conv"):
        quant.w8a8_model(model, {"decoder/kpff16/local_dw": 1.0})


def test_w8a8_route_is_inference_only_and_follows_weight_changes(pairs):
    _, _, model = pairs["ts8"]
    with torch.inference_mode():
        scales = quant.calibrate_act_scales(model, _clips(9))
    q = quant.w8a8_model(model, scales)
    frames = torch.from_numpy(_clips(10, n=1)[0])
    with pytest.raises(RuntimeError, match="inference-only"):
        q(frames)
    conv = q.encoder.ConvBlock_0.Conv_0
    # A change GroupNorm does not undo (a scale of the weight it would).
    delta = 0.1 * torch.randn(conv.weight.shape, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        before = q(frames)[0]
        conv.weight.add_(delta)            # in place: the int8 weight follows
        after = q(frames)[0]
        model.encoder.ConvBlock_0.Conv_0.weight.add_(delta)
        fresh = quant.w8a8_model(model, scales)(frames)[0]
        model.encoder.ConvBlock_0.Conv_0.weight.sub_(delta)
    assert not torch.equal(before, after)
    torch.testing.assert_close(after, fresh, rtol=0, atol=0)


def test_w8a8_artifact_equals_the_eager_model(pairs, tmp_path):
    """The exported program of a W8A8 model holds the int8 products and
    equals the eager W8A8 model over two carried chunks; saved and loaded,
    it runs unchanged in the serving engine (``serve --artifact``) and in
    ``infer --artifact``'s ``run_inference``, with ``stream_video``'s masks."""
    from gdkvm_tpu_torch.eval.infer import run_inference
    from gdkvm_tpu_torch.eval.streaming import stream_video
    from gdkvm_tpu_torch.io.export import load_artifact, save_artifact
    from gdkvm_tpu_torch.serve import BatchingEngine
    _, _, model = pairs["ts8"]
    with torch.inference_mode():
        scales = quant.calibrate_act_scales(model, _clips(11), scope="all")
    q = quant.w8a8_model(model, scales)
    art = str(tmp_path / "art")
    meta = save_artifact(art, q, image_size=IMAGE, chunk=2, batch=1)
    assert meta["model_config"]["quant"] == q.cfg.quant
    sm = load_artifact(art)
    assert sum("_int_mm" in str(n.target) for n in sm.program.graph.nodes) == len(scales)
    rng = np.random.default_rng(12)
    mem, seen = sm.init_state()
    state = StreamState(mem=mem, frames_seen=seen)
    with torch.inference_mode():
        for _ in range(2):
            u8 = torch.from_numpy(rng.integers(0, 255, (1, 2, IMAGE, IMAGE, 1), np.uint8))
            logits, mem, seen = sm.step(u8, mem, seen)
            want, state = q(u8.to(torch.float32) / 255.0, state)
            torch.testing.assert_close(logits, want, rtol=0, atol=0)
            torch.testing.assert_close(mem, state.mem, rtol=0, atol=0)
        video = rng.integers(0, 255, (5, IMAGE, IMAGE, 1), np.uint8)
        want = stream_video(q, video, chunk=2)
    eng = BatchingEngine(artifact=sm, streams=1, chunk=2)
    try:
        served = eng.infer(eng.open_session()["session"], video)
    finally:
        eng.close()
    np.testing.assert_array_equal(served, want)
    run_inference(video, str(tmp_path / "out"), artifact=sm)
    np.testing.assert_array_equal(np.load(tmp_path / "out" / "masks.npz")["masks"], want)


def test_quant_check_on_synthetic_clips(tmp_path, capsys):
    """``quant --check --device cpu`` calibrates on synthetic clips 7000+i,
    writes the scales JSON and reports Dice and frames/s both ways."""
    out_path = tmp_path / "s.json"
    rc = main(["quant", "--device", "cpu", "--check", "--calib-clips", "1",
               "--num-videos", "1", "--video-len", "4", "--method", "percentile",
               "--out", str(out_path), f"data.image_size={IMAGE}",
               f"runtime.run_dir={tmp_path}"] + NARROW_OVERRIDES)
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    scales = quant.load_scales(str(out_path))
    assert out["n_convs"] == len(scales) > 0 and out["method"] == "percentile"
    assert all(k.startswith("encoder/") for k in scales)
    check = out["check"]
    assert check["dice_fg_delta"] == pytest.approx(
        check["dice_fg_w8a8"] - check["dice_fg_fp"])
    assert check["fps_fp"] > 0 and check["fps_w8a8"] > 0
