"""File-to-masks inference of the port (gdkvm_tpu_torch.eval.infer) against
the JAX package's, and a long stream through both models, on the CPU in
fp32 on converted weights.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from gdkvm_tpu.eval import infer as jinfer
from gdkvm_tpu.eval import streaming as jstreaming
from gdkvm_tpu_torch.data import camus_raw, echonet
from gdkvm_tpu_torch.eval import infer
from gdkvm_tpu_torch.eval.streaming import StreamingSegmenter, stream_video
from torch_port_util import model_pair

torch.set_num_threads(1)
IMAGE = 32


@pytest.fixture(scope="module")
def pair():
    return model_pair(IMAGE)


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """A PNG directory (48 x 40 frames, plus a file that is no frame), a
    raw .mhd half sequence, and an .avi."""
    from PIL import Image
    root = tmp_path_factory.mktemp("sources")
    rng = np.random.default_rng(0)
    pngs = root / "pngs"
    pngs.mkdir()
    for i in range(7):
        Image.fromarray(rng.integers(0, 255, (48, 40), np.uint8)).save(pngs / f"f{i:03d}.png")
    (pngs / "notes.txt").write_text("not a frame")
    mhd = str(root / "seq.mhd")
    camus_raw.write_mhd(mhd, rng.integers(0, 255, (5, 60, 44), np.uint8), spacing=(0.3, 0.15, 1.0))
    echonet.materialize_synthetic_echonet(str(root / "echo"), num_train=1, num_val=0,
                                          num_frames=9, image_size=40)
    vids = os.listdir(root / "echo" / "Videos")
    return {"pngs": str(pngs), "mhd": mhd, "avi": str(root / "echo" / "Videos" / vids[0])}


@pytest.mark.parametrize("kind", ["pngs", "mhd", "avi"])
@pytest.mark.parametrize("host_resize", [True, False])
def test_load_frames_bitwise_jax(sources, kind, host_resize):
    got = infer.load_frames(sources[kind], IMAGE, host_resize=host_resize)
    want = jinfer.load_frames(sources[kind], IMAGE, host_resize=host_resize)
    assert got.dtype == np.uint8 and got.shape == want.shape and got.shape[-1] == 1
    np.testing.assert_array_equal(got, want)
    assert (got.shape[1:3] == (IMAGE, IMAGE)) == host_resize


def test_load_frames_errors(tmp_path):
    with pytest.raises(ValueError, match="unsupported input"):
        infer.load_frames(str(tmp_path / "x.bin"), IMAGE)
    with pytest.raises(FileNotFoundError, match="no image frames"):
        infer.load_frames(str(tmp_path), IMAGE)


@pytest.mark.parametrize("device_resize", [False, True])
def test_infer_masks_match_jax(pair, sources, tmp_path, device_resize):
    """7 frames in chunks of 4 (a ragged tail), resized on the host or, at
    their own 48 x 40, on the device: masks agree with JAX's on >= 99.9% of
    the pixels; the summary has JAX's keys and values."""
    jmodel, params, model = pair
    frames = infer.load_frames(sources["pngs"], IMAGE, host_resize=not device_resize)
    size = IMAGE if device_resize else None
    got = infer.run_inference(frames, str(tmp_path / "out"), model=model, chunk=4,
                              overlay_every=3, model_size=size)
    want = jinfer.run_inference(frames, str(tmp_path / "out_j"), model=jmodel, params=params,
                                chunk=4, overlay_every=3, model_size=size)
    masks = np.load(tmp_path / "out" / "masks.npz")["masks"]
    jmasks = np.load(tmp_path / "out_j" / "masks.npz")["masks"]
    assert masks.shape == jmasks.shape == (7, IMAGE, IMAGE) and masks.dtype == np.uint8
    assert (masks == jmasks).mean() >= 0.999
    assert set(got) == set(want) and got["frames"] == 7 and got["overlays"] == 3
    assert got["classes_present"] == want["classes_present"]
    assert got["foreground_fraction"] == pytest.approx(want["foreground_fraction"], abs=2e-3)
    assert json.load(open(tmp_path / "out" / "infer.json")) == got
    assert sorted(os.listdir(tmp_path / "out" / "overlays")) == \
        sorted(os.listdir(tmp_path / "out_j" / "overlays"))
    if not device_resize:
        # At the model's size the chunked run is stream_video's.
        np.testing.assert_array_equal(masks, stream_video(model, frames, chunk=4))
    assert torch.is_grad_enabled() and not torch.is_inference_mode_enabled()


# tests/test_infer.py's model, as key=value overrides of the command line.
SMALL = ["model.enc_channels=[8,16,24,32]", "model.enc_blocks=[1,1,1,1]",
         "model.num_heads=2", "model.head_dim_k=16", "model.head_dim_v=16",
         "model.kpff_channels=[24,16,8]", "model.compute_dtype=float32"]


def _cli(argv):
    from gdkvm_tpu_torch.cli import main
    assert main(argv[:1] + ["--device", "cpu"] + argv[1:]) == 0


def test_infer_cli_model_and_artifact(sources, tmp_path):
    """infer end to end on the CPU: the checkpoint-free model path and an
    artifact exported from the same (untrained, seeded) weights give the
    same masks; the artifact path writes the same summary and overlays."""
    small = SMALL + [f"data.image_size={IMAGE}", f"runtime.run_dir={tmp_path}/none"]
    out_a, out_b, art = (str(tmp_path / d) for d in ("out_model", "out_art", "art"))
    _cli(["infer", "--input", sources["avi"], "--out", out_a, "--chunk", "4",
          "--overlay-every", "3"] + small)
    summary = json.load(open(os.path.join(out_a, "infer.json")))
    assert summary["frames"] == 9 and summary["overlays"] == 3
    masks_a = np.load(os.path.join(out_a, "masks.npz"))["masks"]
    assert masks_a.shape == (9, IMAGE, IMAGE) and masks_a.dtype == np.uint8
    _cli(["export", "--out", art, "--chunk", "4", "--image-size", str(IMAGE)] + small)
    assert infer.artifact_image_size(art) == IMAGE
    _cli(["infer", "--input", sources["avi"], "--out", out_b, "--artifact", art,
          "--overlay-every", "3"] + small)
    np.testing.assert_array_equal(masks_a, np.load(os.path.join(out_b, "masks.npz"))["masks"])
    assert {k: v for k, v in json.load(open(os.path.join(out_b, "infer.json"))).items()
            if k != "out"} == {k: v for k, v in summary.items() if k != "out"}
    assert os.listdir(os.path.join(out_b, "overlays")) == os.listdir(
        os.path.join(out_a, "overlays"))


def test_infer_artifact_decodes_at_the_exported_size(sources, tmp_path):
    """--artifact decodes at the size the artifact was exported for, not the
    config's; infer_video_artifact refuses frames of another size."""
    small = SMALL + [f"runtime.run_dir={tmp_path}/none"]
    art = str(tmp_path / "art48")
    _cli(["export", "--out", art, "--chunk", "4", "--image-size", "48"] + small)
    out = str(tmp_path / "out48")
    # The config says 32; the artifact was exported at 48 and wins.
    _cli(["infer", "--input", sources["pngs"], "--out", out, "--artifact", art,
          f"data.image_size={IMAGE}"] + small)
    assert np.load(os.path.join(out, "masks.npz"))["masks"].shape == (7, 48, 48)
    with pytest.raises(ValueError, match="exported for \\(48, 48\\)"):
        infer.infer_video_artifact(art, np.zeros((2, IMAGE, IMAGE, 1), np.uint8))


def test_long_stream_matches_jax():
    """T=512 frames in 16-frame chunks through the JAX model and the port
    (narrow, 32², fp32, converted weights, α ≈ 0.98 so that the memory
    reaches back over many chunks): after 32 carried chunks the state
    agrees within 1e-4 of its largest entry, the last chunk's logits within
    1e-4 absolute, and the masks of all 512 frames on >= 99.9% of the
    pixels."""
    jmodel, params, model = model_pair(IMAGE)
    bias = params["params"]["lkva"]["alpha_proj"]["bias"]
    params["params"]["lkva"]["alpha_proj"]["bias"] = bias + 4.0
    with torch.no_grad():
        model.lkva.alpha_proj.bias.add_(4.0)
    video = np.random.default_rng(5).integers(0, 255, (512, IMAGE, IMAGE, 1), np.uint8)
    seg = StreamingSegmenter(model, chunk=16)
    jseg = jstreaming.StreamingSegmenter(jmodel, params, chunk=16)
    agree = []
    for lo in range(0, 512, 16):
        logits = seg.feed(video[lo:lo + 16]).numpy()
        jlogits = np.asarray(jseg.feed(jax.device_put(video[lo:lo + 16])))
        agree.append((logits.argmax(-1) == jlogits.argmax(-1)).mean())
    mem, jmem = seg.state.mem.numpy(), np.asarray(jseg.state.mem)
    assert np.isfinite(mem).all() and int(seg.state.frames_seen[0]) == 512
    assert np.abs(jmem).max() > 1e-3
    assert np.abs(mem - jmem).max() <= 1e-4 * np.abs(jmem).max()
    assert np.abs(logits - jlogits).max() <= 1e-4
    assert np.mean(agree) >= 0.999 and min(agree) >= 0.995
