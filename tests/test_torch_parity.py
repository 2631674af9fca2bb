"""The scoring protocols of the port (gdkvm_tpu_torch.eval.parity) against
the JAX package's, on layouts the tests write from a seed, on the CPU in
fp32: fed the same predictions they must give the same numbers, and on
converted weights the same scores.
"""

import numpy as np
import pytest
import torch

from gdkvm_tpu.eval import parity as jparity
from gdkvm_tpu_torch.data import camus, echonet, synthetic
from gdkvm_tpu_torch.eval import parity
from torch_port_util import config_pair, model_pair

torch.set_num_threads(1)
IMAGE = 32


@pytest.fixture(scope="module")
def pair():
    return model_pair(IMAGE)


@pytest.fixture(scope="module")
def camus_root(tmp_path_factory):
    """5 patients × 2 views: batches of 4 leave a ragged tail of 2."""
    root = str(tmp_path_factory.mktemp("camus"))
    camus.materialize_synthetic_camus(root, num_train=1, num_val=10, image_size=IMAGE,
                                      clip_len=4, difficulty=0.3, seed=1)
    return root


def _cfgs(root, tmp_path, dataset="camus", **stage):
    return config_pair(dict(dataset=dataset, data_path=root, image_size=IMAGE, clip_len=4),
                       str(tmp_path / "run"), stage)


def _dataset(root):
    return camus.CamusDataset(root, "val", image_size=IMAGE, clip_len=4, num_classes=4)


def _oracle(ds, shift=0):
    """predict_fn: each clip's ground truth, looked up by its frames,
    rolled ``shift`` pixels along x."""
    items = [ds[i] for i in range(len(ds))]

    def predict(frames):
        out = []
        for f in frames:
            gt = next(m for fr, m, _ in items if np.array_equal(fr, f))
            out.append(np.roll(gt, shift, axis=-1))
        return np.stack(out)
    return predict


def _assert_cells_equal(got, want, tol):
    assert set(got) == set(want)
    for view in want:
        assert set(got[view]) == set(want[view])
        for name in want[view]:
            for phase, cell in want[view][name].items():
                mine = got[view][name][phase]
                assert set(mine) == set(cell)
                for key, val in cell.items():
                    assert mine[key] == pytest.approx(val, abs=tol), (view, name, phase, key)


def test_small_functions_match_jax():
    rng = np.random.default_rng(0)
    a, b = rng.random((16, 16)) < 0.4, rng.random((16, 16)) < 0.4
    assert parity.dice_bin(a, b) == jparity.dice_bin(a, b)
    assert parity.dice_bin(a & ~a, a & ~a) == 1.0
    assert parity.biplane_volume(100.0, 90.0, 20.0, 25.0) == \
        jparity.biplane_volume(100.0, 90.0, 20.0, 25.0)
    assert parity.biplane_volume(10, 10, 0.0, 5.0) == 0.0
    assert [n for n, _ in parity.CAMUS_STRUCTURES] == [n for n, _ in jparity.CAMUS_STRUCTURES]
    m = rng.integers(0, 4, (8, 8))
    for (_, sel), (_, jsel) in zip(parity.CAMUS_STRUCTURES, jparity.CAMUS_STRUCTURES):
        np.testing.assert_array_equal(sel(m), jsel(m))


@pytest.mark.parametrize("shift", [0, 2])
def test_camus_official_matches_jax_on_fed_predictions(camus_root, tmp_path, shift):
    """Ground truth → Dice 1.0 and HD95 0.0 in mm; a mask shifted by 2
    pixels → every cell equal to JAX's within 1e-6, the table too."""
    cfg, jcfg = _cfgs(camus_root, tmp_path)
    fn = _oracle(_dataset(camus_root), shift)
    got = parity.camus_official(cfg, None, split="val", batch_size=4, predict_fn=fn)
    want = jparity.camus_official(jcfg, None, None, split="val", batch_size=4, predict_fn=fn)
    assert set(got) == set(want)
    _assert_cells_equal(got["per_structure"], want["per_structure"], 1e-6)
    for key in ("protocol", "split", "n_patients", "hd95_units", "table"):
        assert got[key] == want[key]
    assert got["dice_mean_overall"] == pytest.approx(want["dice_mean_overall"], abs=1e-6)
    assert got["n_patients"] == 5 and got["hd95_units"] == "mm"
    cells = [c for v in got["per_structure"].values() for s in v.values() for c in s.values()]
    if shift == 0:
        assert all(c["dice_mean"] == pytest.approx(1.0, abs=1e-6) for c in cells)
        assert all(c["hd95_mean"] == pytest.approx(0.0) for c in cells if "hd95_mean" in c)
    else:
        assert all(c["dice_mean"] < 0.999 for c in cells)


def test_camus_official_filters_and_pads(camus_root, tmp_path):
    """max_patients and patient_filter keep what JAX keeps; the last batch
    is padded with repeats of its last clip, which are not scored."""
    cfg, jcfg = _cfgs(camus_root, tmp_path)
    ds = _dataset(camus_root)
    fn = _oracle(ds)
    batches = []

    def spy(frames):
        batches.append(frames.copy())
        return fn(frames)
    got = parity.camus_official(cfg, None, batch_size=4, with_hd95=False, predict_fn=spy)
    assert [b.shape[0] for b in batches] == [4, 4, 4]          # 10 clips: a tail of 2
    np.testing.assert_array_equal(batches[-1][2], batches[-1][1])
    np.testing.assert_array_equal(batches[-1][3], batches[-1][1])
    assert got["n_patients"] == 5 and "hd95_mean" not in str(got["per_structure"])
    keep = lambda pid: pid.endswith(("1", "3"))
    for kw in (dict(max_patients=2), dict(patient_filter=keep),
               dict(max_patients=1, patient_filter=keep)):
        a = parity.camus_official(cfg, None, batch_size=4, with_hd95=False,
                                  predict_fn=_oracle(ds, 1), **kw)
        b = jparity.camus_official(jcfg, None, None, batch_size=4, with_hd95=False,
                                   predict_fn=_oracle(ds, 1), **kw)
        assert a["n_patients"] == b["n_patients"] < 5
        _assert_cells_equal(a["per_structure"], b["per_structure"], 1e-6)


def test_camus_official_folds_matches_jax(camus_root, tmp_path):
    cfg, jcfg = _cfgs(camus_root, tmp_path)
    fn = _oracle(_dataset(camus_root), 2)
    got = parity.camus_official_folds(cfg, None, folds=3, batch_size=4, predict_fn=fn)
    want = jparity.camus_official_folds(jcfg, None, None, folds=3, batch_size=4,
                                        predict_fn=fn)
    assert set(got) == set(want) and got["table"] == want["table"]
    assert got["n_folds_scored"] == want["n_folds_scored"] == 3 and got["n_patients"] == 5
    for key in ("dice_mean_overall", "dice_std_over_folds", "hd95_mean_overall"):
        assert got[key] == pytest.approx(want[key], abs=1e-6)
    for a, b in zip(got["per_fold"], want["per_fold"]):
        assert a["fold"] == b["fold"] and a["n_patients"] == b["n_patients"]
        _assert_cells_equal(a["per_structure"], b["per_structure"], 1e-6)
    exact = parity.camus_official_folds(cfg, None, folds=2, batch_size=4,
                                        predict_fn=_oracle(_dataset(camus_root)))
    assert exact["dice_mean_overall"] == pytest.approx(1.0, abs=1e-6)
    assert exact["dice_std_over_folds"] == pytest.approx(0.0, abs=1e-6)


@pytest.mark.parametrize("shift", [0, 2])
def test_camus_ef_matches_jax_on_fed_predictions(camus_root, tmp_path, shift):
    cfg, jcfg = _cfgs(camus_root, tmp_path)
    ds = _dataset(camus_root)
    # A shifted and eroded prediction, so the EF differs from the reference's.
    def fn(frames):
        out = _oracle(ds, shift)(frames)
        if shift:
            out[:, -1, ::3] = 0
        return out
    got = parity.camus_ef(cfg, None, batch_size=4, predict_fn=fn)
    want = jparity.camus_ef(jcfg, None, None, batch_size=4, predict_fn=fn)
    assert set(got) == set(want) and got["table"] == want["table"]
    assert got["n_patients"] == want["n_patients"] == 5 and got["volume_units"] == "mL"
    for key in ("ef_mae", "ef_rmse", "ef_bias"):
        assert got[key] == pytest.approx(want[key], abs=1e-6)
    for a, b in zip(got["per_patient"], want["per_patient"]):
        assert a["patient"] == b["patient"]
        for key in ("ef_pred", "ef_ref", "v_ed_ml", "v_es_ml"):
            assert a[key] == pytest.approx(b[key], abs=1e-6)
    if shift == 0:
        assert got["ef_mae"] == pytest.approx(0.0, abs=1e-9)
    else:
        assert got["ef_mae"] > 0.01
    assert parity.camus_ef(cfg, None, batch_size=4, predict_fn=fn,
                           max_patients=2)["n_patients"] == 2


def test_camus_protocols_match_jax_on_converted_weights(pair, camus_root, tmp_path):
    """The model's own predictions (fp32, narrow, converted weights): every
    cell's Dice within 1e-4 of JAX's (HD95 is scored on both sides and not
    compared: one flipped boundary pixel moves it), the biplane EF within
    1e-3 points."""
    jmodel, params, model = pair
    cfg, jcfg = _cfgs(camus_root, tmp_path)
    got = parity.camus_official(cfg, model, batch_size=4)
    want = jparity.camus_official(jcfg, jmodel, params, batch_size=4)
    assert got["n_patients"] == want["n_patients"] == 5
    for view in want["per_structure"]:
        for name in want["per_structure"][view]:
            for phase, cell in want["per_structure"][view][name].items():
                mine = got["per_structure"][view][name][phase]
                assert mine["n"] == cell["n"]
                assert mine["dice_mean"] == pytest.approx(cell["dice_mean"], abs=1e-4)
    assert got["dice_mean_overall"] == pytest.approx(want["dice_mean_overall"], abs=1e-4)
    ef, jef = parity.camus_ef(cfg, model, batch_size=4), \
        jparity.camus_ef(jcfg, jmodel, params, batch_size=4)
    assert ef["n_patients"] == jef["n_patients"]
    for a, b in zip(ef["per_patient"], jef["per_patient"]):
        assert a["ef_pred"] == pytest.approx(b["ef_pred"], abs=1e-3)
        assert a["ef_ref"] == pytest.approx(b["ef_ref"], abs=1e-9)
    # The predictor leaves the caller's grad mode alone.
    assert torch.is_grad_enabled() and not torch.is_inference_mode_enabled()


@pytest.fixture(scope="module")
def echonet_root(tmp_path_factory):
    pytest.importorskip("cv2")
    root = str(tmp_path_factory.mktemp("echonet"))
    echonet.materialize_synthetic_echonet(root, num_train=1, num_val=3, num_frames=24,
                                          image_size=IMAGE, seed=5)
    return root


def test_echonet_ef_matches_jax(pair, echonet_root, tmp_path):
    """FileList metadata equal to JAX's; ground truth through segment_fn
    reproduces the labels (MAE ≈ 0) and equals JAX's result; the streamed
    model's per-video EF within 1e-3 points of JAX's on converted weights
    (2 classes: the LV is class 1)."""
    assert parity.read_filelist_meta(echonet_root) == jparity.read_filelist_meta(echonet_root)
    labels = parity.read_ef_labels(echonet_root)
    assert labels == jparity.read_ef_labels(echonet_root) and len(labels) == 4
    assert parity.read_filelist_meta(str(tmp_path)) == {}
    cfg, jcfg = _cfgs(echonet_root, tmp_path, dataset="echonet", stream_chunk=8)

    def segment_fn(video, name):
        i = int(name.replace("synth", "").replace(".avi", ""))
        return synthetic.generate_video(5 * 104729 + i, video.shape[0], IMAGE, IMAGE, 2)[1]
    got = parity.echonet_ef(cfg, None, split="VAL", segment_fn=segment_fn)
    want = jparity.echonet_ef(jcfg, None, None, split="VAL", segment_fn=segment_fn)
    assert got == want
    assert got["n_scored"] == 3 and got["ef_mae"] == pytest.approx(0.0, abs=1e-3)
    assert "| Metric | Value |" in got["table"]

    jmodel, params, model = pair
    got = parity.echonet_ef(cfg, model, split="VAL", num_videos=2)
    want = jparity.echonet_ef(jcfg, jmodel, params, split="VAL", num_videos=2)
    assert got["n_videos"] == want["n_videos"] == 2
    for a, b in zip(got["per_video"], want["per_video"]):
        assert a["video"] == b["video"] and a["frames"] == b["frames"]
        assert a["ef_pred"] == pytest.approx(b["ef_pred"], abs=1e-3)


@pytest.fixture(scope="module")
def echonet_mixed_root(tmp_path_factory):
    """Four val videos of 64 frames at 30 and 50 fps in turn: long enough
    for the beat-wise protocol to cut beats at either rate."""
    pytest.importorskip("cv2")
    root = str(tmp_path_factory.mktemp("echonet_mixed"))
    echonet.materialize_synthetic_echonet(root, num_train=0, num_val=4, num_frames=64,
                                          image_size=IMAGE, seed=6, fps_cycle=(30.0, 50.0))
    return root


def test_echonet_ef_mixed_fps_matches_jax(pair, echonet_mixed_root, tmp_path):
    """Per-video FPS read from FileList.csv as JAX reads it, and the
    beat-wise EF of each video cut at its own rate as JAX cuts it: through
    the ground truth (segment_fn) the results are equal; through the
    streamed model on converted weights each video's fps, ED/ES frames and
    beats are equal and its EF within 1e-3 points of JAX's."""
    root = echonet_mixed_root
    meta = parity.read_filelist_meta(root)
    assert meta == jparity.read_filelist_meta(root)
    assert [meta[f"synth{i:04d}.avi"]["FPS"] for i in range(4)] == [30.0, 50.0, 30.0, 50.0]
    cfg, jcfg = _cfgs(root, tmp_path, dataset="echonet", stream_chunk=16)

    def segment_fn(video, name):
        i = int(name.replace("synth", "").replace(".avi", ""))
        return synthetic.generate_video(6 * 104729 + i, video.shape[0], IMAGE, IMAGE, 2)[1]
    got = parity.echonet_ef(cfg, None, split="VAL", segment_fn=segment_fn)
    want = jparity.echonet_ef(jcfg, None, None, split="VAL", segment_fn=segment_fn)
    assert got == want
    assert [r["fps"] for r in got["per_video"]] == [30.0, 50.0, 30.0, 50.0]
    assert all(r["beats"] > 1 for r in got["per_video"])
    assert got["n_scored"] == 4 and got["ef_mae"] == pytest.approx(0.0, abs=1e-3)

    jmodel, params, model = pair
    got = parity.echonet_ef(cfg, model, split="VAL")
    want = jparity.echonet_ef(jcfg, jmodel, params, split="VAL")
    assert got["n_videos"] == want["n_videos"] == 4
    for a, b in zip(got["per_video"], want["per_video"]):
        for key in ("video", "frames", "fps", "ef_true", "frame_ed", "frame_es", "beats"):
            assert a[key] == b[key], key
        assert a["ef_pred"] == pytest.approx(b["ef_pred"], abs=1e-3)
    assert got["ef_mae"] == pytest.approx(want["ef_mae"], abs=1e-3)


def test_memory_ablation_matches_jax(pair, tmp_path):
    """The 2 x 2 (x window) study on synthetic videos: the same conditions
    and keys, every Dice within 1e-4 of JAX's, the deltas and the table
    built the same way."""
    jmodel, params, model = pair
    cfg, jcfg = config_pair(dict(image_size=IMAGE, synth_difficulty=0.5),
                            str(tmp_path / "run"))
    got = parity.memory_ablation(cfg, model, num_videos=2, video_len=6)
    want = jparity.memory_ablation(jcfg, jmodel, params, num_videos=2, video_len=6)
    assert set(got) == set(want) and set(got["conditions"]) == set(want["conditions"])
    assert len(got["conditions"]) == 8 and cfg.eval_stage.stream_chunk == 16
    for name, cond in want["conditions"].items():
        assert set(got["conditions"][name]) == set(cond)
        for key, val in cond.items():
            assert got["conditions"][name][key] == pytest.approx(val, abs=1e-4, nan_ok=True)
    for key in want:
        if key.startswith("memory_delta"):
            assert got[key] == pytest.approx(want[key], abs=2e-4)
    assert got["table"].splitlines()[:2] == want["table"].splitlines()[:2]
    assert parity.format_ablation_table(want) == want["table"]
    assert parity.format_ef_table({"ef_mae": 1.0, "n_scored": 2}) == \
        jparity.format_ef_table({"ef_mae": 1.0, "n_scored": 2})
