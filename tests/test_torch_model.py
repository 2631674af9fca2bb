"""The port's model (gdkvm_tpu_torch.models) against the JAX package's, on
the CPU, with the JAX weights carried over by io/convert.py.

A narrow model (enc 16/16/32/32, 2 heads of 16×16, 32² frames, B=2, T=3)
keeps each JAX init and forward near a second.
"""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gdkvm_tpu.config import schema as jschema
from gdkvm_tpu.eval.metrics import mask_from_logits as j_mask_from_logits
from gdkvm_tpu.models import decoder as jdecoder
from gdkvm_tpu.models.gdkvm import GDKVM as JGDKVM
from gdkvm_tpu.models.gdkvm import init_params as j_init_params
from gdkvm_tpu.ops import norms as jnorms
from gdkvm_tpu.ops import preproc as jpreproc
from gdkvm_tpu_torch.config.schema import ModelConfig
from gdkvm_tpu_torch.eval.metrics import mask_from_logits
from gdkvm_tpu_torch.eval.throughput import measure_streaming_fps, streaming_step
from gdkvm_tpu_torch.io.convert import state_dict_from_flax
from gdkvm_tpu_torch.models.decoder import resize_bilinear, subpixel_to_nhwc
from gdkvm_tpu_torch.models.gdkvm import GDKVM, init_params
from gdkvm_tpu_torch.models.layers import Conv
from gdkvm_tpu_torch.ops.norms import group_norm
from gdkvm_tpu_torch.ops.preproc import resize_matrix

torch.set_num_threads(1)

NARROW = dict(enc_channels=(16, 16, 32, 32), enc_blocks=(1, 1, 1, 1),
              num_heads=2, head_dim_k=16, head_dim_v=16)
VARIANTS = {
    "s2d-2scale": dict(kpff_channels=(16, 16)),
    "s2d-3scale": dict(kpff_channels=(16, 16, 16)),
    "conv-2scale": dict(kpff_channels=(16, 16), enc_stem="conv"),
}
IMAGE, B, T = 32, 2, 3

# fp32 on both sides: summation order is the only difference.
RTOL, ATOL = 1e-4, 1e-4


class _Pair:
    """The JAX model and params for one config, and the port on the same
    weights."""

    def __init__(self, seed: int, **kw):
        self.kw = {**NARROW, **kw}
        self.jmodel = JGDKVM(cfg=jschema.ModelConfig(**self.kw))
        self.params = j_init_params(self.jmodel, jax.random.PRNGKey(seed), IMAGE)
        self.cfg = ModelConfig(**self.kw)
        self.model = self.port(self.cfg)

    def port(self, cfg: ModelConfig) -> GDKVM:
        model = GDKVM(cfg, device="cpu")
        model.load_state_dict(state_dict_from_flax(
            jax.tree.map(np.asarray, self.params), cfg))
        return model.eval()


@pytest.fixture(scope="module")
def pairs():
    cache = {}

    def get(name: str, compute_dtype: str = "float32", seed: int = 0) -> _Pair:
        key = (name, compute_dtype, seed)
        if key not in cache:
            cache[key] = _Pair(seed, compute_dtype=compute_dtype, **VARIANTS[name])
        return cache[key]
    return get


def _frames(seed=0, b=B, t=T):
    return np.random.default_rng(seed).random((b, t, IMAGE, IMAGE, 1),
                                              dtype=np.float32)


def _run_port(model, frames, **kw):
    with torch.no_grad():
        logits, state = model(torch.from_numpy(frames), **kw)
    return logits.numpy(), state.mem.numpy()


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_model_fp32_matches_jax(pairs, variant):
    p = pairs(variant)
    x = _frames()
    logits_j, state_j = jax.jit(p.jmodel.apply)(p.params, jnp.asarray(x))
    logits, mem = _run_port(p.model, x)
    assert logits.shape == (B, T, IMAGE, IMAGE, 2) and logits.dtype == np.float32
    np.testing.assert_allclose(logits, np.asarray(logits_j), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(mem, np.asarray(state_j.mem), rtol=RTOL, atol=ATOL)


def test_model_bf16_matches_jax(pairs):
    """bf16 compute on both sides.  Both frameworks round each op's output
    to bf16 when run op by op, so JAX runs un-jitted here (under jit XLA
    rounds only at fusion boundaries).  The two still round convs and
    matmuls differently by about one bf16 ulp per layer; at this narrow
    random init JAX's own bf16 run agrees with its fp32 run on ~99.2% of
    pixels, the same noise floor as the bounds below."""
    p = pairs("s2d-2scale", "bfloat16")
    x = _frames()
    logits_j, _ = p.jmodel.apply(p.params, jnp.asarray(x))
    logits_j = np.asarray(logits_j)
    logits, _ = _run_port(p.model, x)
    agree = (logits.argmax(-1) == logits_j.argmax(-1)).mean()
    assert agree >= 0.99, agree
    assert np.abs(logits - logits_j).max() <= 5e-2 * np.abs(logits_j).max()


def test_prompted_forward_matches_jax(pairs):
    """Mask prompt written into the memory, blended by prompt_weight, from
    a carried (nonzero) state."""
    p = pairs("s2d-2scale")
    x = _frames(1)
    rng = np.random.default_rng(2)
    mask = rng.integers(0, 2, (B, IMAGE, IMAGE)).astype(np.int32)
    weight = np.array([1.0, 0.3], np.float32)
    apply = jax.jit(p.jmodel.apply)
    _, state0_j = apply(p.params, jnp.asarray(_frames(3)))
    logits_j, state_j = apply(p.params, jnp.asarray(x), state0_j,
                              jnp.asarray(mask), jnp.asarray(weight))
    with torch.no_grad():
        _, state0 = p.model(torch.from_numpy(_frames(3)))
        logits, state = p.model(torch.from_numpy(x), state0,
                                torch.from_numpy(mask), torch.from_numpy(weight))
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(state.mem.numpy(), np.asarray(state_j.mem),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(state.frames_seen.numpy(),
                                  np.asarray(state_j.frames_seen))


def test_streaming_equals_batched(pairs):
    """Chunks of 1 + 2 frames with the state carried equal one 3-frame call."""
    model = pairs("s2d-2scale").model
    x = torch.from_numpy(_frames(4))
    with torch.no_grad():
        full, s_full = model(x)
        a, s_a = model(x[:, :1])
        b, s_b = model(x[:, 1:], s_a)
    torch.testing.assert_close(torch.cat([a, b], 1), full, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(s_b.mem, s_full.mem, rtol=1e-5, atol=1e-5)
    assert s_b.frames_seen.tolist() == [T, T]


def test_mask_from_logits_matches_jax():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((2, 3, 8, 8, 4)).astype(np.float32)
    logits[0, 0, 0, 0] = [1.0, 1.0, 0.0, 1.0]           # ties go to class 0
    got = mask_from_logits(torch.from_numpy(logits))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(j_mask_from_logits(jnp.asarray(logits))))


@pytest.mark.parametrize("size", [8, 7])
def test_stride2_same_padding(size):
    """A stride-2 3×3 "SAME" conv pads (0, 1) on an even input as flax does;
    torch's padding=1 pads (1, 1) and samples another grid."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((1, size, size, 3)).astype(np.float32)
    conv = nn.Conv(4, (3, 3), strides=(2, 2), padding="SAME", use_bias=False,
                   dtype=jnp.float32)
    params = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(conv.apply(params, jnp.asarray(x)))
    w = torch.from_numpy(np.asarray(params["params"]["kernel"]).transpose(3, 2, 0, 1).copy())
    port = Conv(3, 4, 3, stride=2, dtype=torch.float32)
    with torch.no_grad():
        port.weight.copy_(w)
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        got = port(xt).permute(0, 2, 3, 1).numpy()
        naive = F.conv2d(xt, w, stride=2, padding=1).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert got.shape == naive.shape
    if size % 2 == 0:
        assert np.abs(naive - want).max() > 1e-2


def test_subpixel_channel_order():
    """The sub-pixel head reads channel (py·2 + px)·K + k, as the JAX
    reshape does; F.pixel_shuffle's order (k·4 + py·2 + px) differs."""
    k = 3
    hs = np.arange(2 * 5 * 6 * 4 * k, dtype=np.float32).reshape(2, 5, 6, 4 * k)
    b, hh, ww, _ = hs.shape
    want = hs.reshape(b, hh, ww, 2, 2, k).transpose(0, 1, 3, 2, 4, 5).reshape(
        b, hh * 2, ww * 2, k)
    hs_t = torch.from_numpy(hs).permute(0, 3, 1, 2)
    np.testing.assert_array_equal(subpixel_to_nhwc(hs_t, k).numpy(), want)
    shuffled = F.pixel_shuffle(hs_t, 2).permute(0, 2, 3, 1).numpy()
    assert not np.array_equal(shuffled, want)


def test_model_config_matches_jax():
    port = {f.name: f.default for f in dataclasses.fields(ModelConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(jschema.ModelConfig)}
    assert port == ref


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-6), ("bfloat16", 8e-3)])
def test_group_norm_matches_jax(dtype, tol):
    """fp32 stats and affine on both sides; bf16 differs by the output's
    rounding only."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 5, 6, 32)).astype(np.float32) * 3 + 1
    scale = rng.standard_normal(32).astype(np.float32)
    bias = rng.standard_normal(32).astype(np.float32)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    want = np.asarray(jnorms.group_norm(jnp.asarray(x).astype(jdt), jnp.asarray(scale),
                                        jnp.asarray(bias), 8).astype(jnp.float32))
    got = group_norm(torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2),
                     torch.from_numpy(scale), torch.from_numpy(bias), 8)
    got = got.to(torch.float32).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.abs(want).max())


@pytest.mark.parametrize("src,dst", [(7, 28), (112, 7), (28, 112), (5, 5)])
def test_resize_matches_jax(src, dst):
    """The matrices are the JAX package's; the resize (antialiased when
    downscaling, the mask-prompt case) matches resize_bilinear in fp32."""
    np.testing.assert_array_equal(resize_matrix(src, dst),
                                  jpreproc._resize_matrix(src, dst))
    x = np.random.default_rng(8).standard_normal((2, src, src, 3)).astype(np.float32)
    want = np.asarray(jdecoder.resize_bilinear(jnp.asarray(x), (dst, dst)))
    got = resize_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2), (dst, dst))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-5, atol=1e-5)


def test_init_params_follows_reference_initializers():
    """α kernel 0 and bias 4, β bias −1, norm scales 1 and biases 0, and
    lecun_normal kernels (std √(1/fan_in), truncated at 2σ/0.8796)."""
    cfg = ModelConfig(**NARROW, kpff_channels=(16, 16))
    a = init_params(GDKVM(cfg, device="cpu"), torch.Generator().manual_seed(0))
    b = init_params(GDKVM(cfg, device="cpu"), torch.Generator().manual_seed(0))
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa, pb), name
    lk = a.lkva
    assert torch.all(lk.alpha_proj.weight == 0) and torch.all(lk.alpha_proj.bias == 4)
    assert torch.all(lk.beta_proj.bias == -1)
    assert torch.all(a.encoder.GroupNorm_0.scale == 1)
    assert torch.all(a.encoder.GroupNorm_0.bias == 0)
    assert torch.all(lk.o_norm.scale == 1)
    w = a.encoder.ConvBlock_0.Conv_0.weight                # fan_in 16·9
    std = (1 / 144) ** 0.5
    assert abs(w.std().item() - std) < 0.1 * std
    assert w.abs().max().item() <= 2 * std / 0.87962566103423978 + 1e-6


@pytest.mark.parametrize("field,value", [
    ("gdr_variant", "gdn3"), ("gdr_impl", "assoc"), ("quant", "w8a8-x")])
def test_unported_options_raise(field, value):
    """A variant neither package has is a ValueError, as in the JAX package
    (gdn2 is ported: tests/test_torch_gdn2.py); a W8A8 tag without its
    scale table is refused (ops.quant.w8a8_model makes both).
    ``gdr_impl="assoc"`` is ported and runs (tests/test_torch_assoc.py)."""
    cfg = dataclasses.replace(ModelConfig(**NARROW), **{field: value})
    if field == "gdr_variant":
        with pytest.raises(ValueError, match="gdn2"):
            GDKVM(cfg, device="cpu")
    elif field == "quant":
        with pytest.raises(ValueError, match="w8a8_model"):
            GDKVM(cfg, device="cpu")
    else:
        model = init_params(GDKVM(cfg, device="cpu"), torch.Generator().manual_seed(0))
        frames = torch.rand((1, 2, 32, 32, 1), generator=torch.Generator().manual_seed(1))
        with torch.no_grad():
            logits, state = model(frames)
        assert logits.shape == (1, 2, 32, 32, 2) and torch.isfinite(logits).all()
        assert torch.isfinite(state.mem).all()


def test_streaming_step_and_fps_device(pairs):
    """streaming_step runs a uint8 chunk to masks and a checksum; frames/s
    is taken on the device it is given and says which: "cpu" for a host
    number, never a card's name."""
    model = pairs("s2d-2scale").model
    frames = torch.from_numpy(np.random.default_rng(9).integers(
        0, 255, (B, T, IMAGE, IMAGE, 1), np.uint8))
    with torch.no_grad():
        masks, checksum, state = streaming_step(model, frames, None)
        logits, _ = model(frames.to(torch.float32) / 255.0)
    assert masks.dtype == torch.uint8 and masks.shape == (B, T, IMAGE, IMAGE)
    assert torch.equal(masks, mask_from_logits(logits))
    assert checksum.item() == int(masks.sum())
    assert state.frames_seen.tolist() == [T, T]
    fps = measure_streaming_fps(model, torch.device("cpu"), image_size=IMAGE, chunk=2,
                                warmup_chunks=0, timed_chunks=1)
    assert fps["device"] == "cpu" and fps["timed_frames"] == 2 and fps["frames_per_sec"] > 0
