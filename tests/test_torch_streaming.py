"""The port's device resize (ops/preproc.py), its ts8_112 preset and its
in-process streaming (eval/streaming.py) against the JAX package's, on the
CPU, on converted weights.

Inputs are made with numpy from a seed and go to both frameworks.  A narrow
fp32 model (enc 16/16/32/32, 2 heads of 16×16, 32² frames) keeps each JAX
compile near a second.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdkvm_tpu.config import schema as jschema
from gdkvm_tpu.eval import streaming as jstreaming
from gdkvm_tpu.models.gdkvm import GDKVM as JGDKVM
from gdkvm_tpu.ops import preproc as jpreproc
from gdkvm_tpu_torch.config.schema import (Config, DataConfig, EvalStageConfig,
                                           ModelConfig, RuntimeConfig,
                                           TrainConfig, ts8_112)
from gdkvm_tpu_torch.eval.metrics import mask_from_logits
from gdkvm_tpu_torch.eval.streaming import StreamingSegmenter, stream_video
from gdkvm_tpu_torch.io.convert import state_dict_from_flax
from gdkvm_tpu_torch.models.gdkvm import GDKVM
from gdkvm_tpu_torch.ops.preproc import resize_matrices, resize_normalize, resize_u8

torch.set_num_threads(1)

NARROW = dict(enc_channels=(16, 16, 32, 32), enc_blocks=(1, 1, 1, 1),
              num_heads=2, head_dim_k=16, head_dim_v=16, kpff_channels=(16, 16),
              num_classes=3, compute_dtype="float32")
IMAGE, CHUNK = 32, 4
# Logits: fp32 on both sides, summation order only (tests/test_torch_model.py).
RTOL, ATOL = 1e-4, 1e-4


# ---------------------------------------------------------------- resize


@pytest.mark.parametrize("shape,out", [
    ((3, 100, 140, 1), (48, 48)),        # downscale, antialiased
    ((2, 3, 23, 29, 1), (48, 44)),       # upscale, two leading dims
    ((4, 48, 48, 1), (48, 48)),          # identity: no products
], ids=["down", "up", "identity"])
def test_resize_matches_jax(shape, out):
    """resize_normalize within 1e-6 of the JAX package's (fp32 products on
    both sides, summation order only); resize_u8 equal to the last bit
    (rounded half to even, clipped).  Equal on these inputs.  Not on every
    input: an upscale puts many pixels near k + 0.5 before the rounding
    (42 of 12,672 within 1e-3 here), and where one lies within an ulp of it
    the two frameworks' FMA orders can round it to neighbouring values (1
    pixel of 12,672 at 2×3×21×27 → 48×44, 9 of 11,520 at 2×3×20×30 →
    48×40)."""
    video = np.random.default_rng(0).integers(0, 256, shape, np.uint8)
    want = np.asarray(jpreproc.resize_normalize(jnp.asarray(video), out))
    got = resize_normalize(torch.from_numpy(video), out)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    want_u8 = np.asarray(jpreproc.resize_u8(jnp.asarray(video), out))
    got_u8 = resize_u8(torch.from_numpy(video), out)
    assert got_u8.dtype == torch.uint8
    np.testing.assert_array_equal(got_u8.numpy(), want_u8)
    if shape[-3:-1] == out:
        np.testing.assert_array_equal(got_u8.numpy(), video)


def test_resize_with_kept_matrices():
    """Matrices made once (as the serving engine keeps them) give the same
    resize as matrices made per call."""
    video = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (2, 50, 60, 1), np.uint8))
    mats = resize_matrices((50, 60), (32, 32), "cpu")
    assert [tuple(m.shape) for m in mats] == [(32, 50), (32, 60)]
    assert torch.equal(resize_u8(video, (32, 32), matrices=mats),
                       resize_u8(video, (32, 32)))


# ---------------------------------------------------------------- config


def test_ts8_112_preset_matches_yaml():
    """ts8_112() equals configs/gdkvm_ts8_112.yaml field for field (every
    field the port has); 4 classes, so masks pack at 2 bits."""
    jcfg = jschema.load_config("configs/gdkvm_ts8_112.yaml")
    pick = lambda cls, src: cls(**{f.name: getattr(src, f.name)
                                   for f in dataclasses.fields(cls)})
    want = Config(model=pick(ModelConfig, jcfg.model),
                  data=pick(DataConfig, jcfg.data),
                  train=pick(TrainConfig, jcfg.train),
                  eval_stage=pick(EvalStageConfig, jcfg.eval_stage),
                  runtime=pick(RuntimeConfig, jcfg.runtime))
    got = ts8_112()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.data.image_size == 112 and got.model.num_classes == 4
    assert got.model.enc_channels == (64, 64, 128, 192)


# ---------------------------------------------------------------- streaming


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
    """The JAX model and params, and the port on the same weights."""
    jmodel = JGDKVM(cfg=jschema.ModelConfig(**NARROW))
    params = _seeded_params(jmodel)
    cfg = ModelConfig(**NARROW)
    model = GDKVM(cfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray, params), cfg))
    return jmodel, params, model.eval()


def _video(seed, t):
    return np.random.default_rng(seed).integers(0, 255, (t, IMAGE, IMAGE, 1), np.uint8)


def test_segmenter_feed_matches_jax(pair):
    """StreamingSegmenter.feed, chunk by chunk with a short (zero-padded)
    last chunk and the state carried, gives the JAX segmenter's logits;
    reset() starts a fresh recurrence."""
    jmodel, params, model = pair
    video = _video(4, 10)                       # chunks of 4, 4, 2
    jseg = jstreaming.StreamingSegmenter(jmodel, params, chunk=CHUNK)
    seg = StreamingSegmenter(model, chunk=CHUNK)
    first = None
    for lo in range(0, 10, CHUNK):
        piece = video[lo:lo + CHUNK]
        want = np.asarray(jseg.feed(jnp.asarray(piece)))
        got = seg.feed(piece)
        assert got.shape == (piece.shape[0], IMAGE, IMAGE, 3)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
        first = got if first is None else first
    assert seg.state.frames_seen.tolist() == [12]
    seg.reset()
    torch.testing.assert_close(seg.feed(video[:CHUNK]), first, rtol=0, atol=0)


@pytest.mark.parametrize("prompted", [False, True], ids=["plain", "prompt"])
def test_stream_video_matches_jax(pair, prompted):
    """stream_video masks (ragged tail padded by repeating the last frame;
    optionally a frame-0 mask prompt) equal the JAX package's."""
    jmodel, params, model = pair
    video = _video(5, 10)
    prompt = (np.random.default_rng(6).integers(0, 3, (IMAGE, IMAGE)).astype(np.int32)
              if prompted else None)
    want = jstreaming.stream_video(jmodel, params, video, chunk=CHUNK,
                                   prompt_mask=prompt)
    got = stream_video(model, video, chunk=CHUNK, prompt_mask=prompt)
    assert got.dtype == np.uint8 and got.shape == (10, IMAGE, IMAGE)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_streaming_equals_batched(pair):
    """Chunked streaming (chunk 4, state carried) gives the masks and
    logits of one call over the whole 8-frame video."""
    _, _, model = pair
    video = _video(7, 8)
    with torch.no_grad():
        logits, _ = model(torch.from_numpy(video)[None].to(torch.float32) / 255.0)
    seg = StreamingSegmenter(model, chunk=CHUNK)
    streamed = torch.cat([seg.feed(video[:4]), seg.feed(video[4:])])
    torch.testing.assert_close(streamed, logits[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(stream_video(model, video, chunk=CHUNK),
                                  mask_from_logits(logits[0]).numpy())
