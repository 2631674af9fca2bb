"""The mount-day chain of the port: the raw-data path of the runbook
(docs/REPRODUCE.md, "Mount day") through ``gdkvm_tpu_torch.cli.main`` with
``--device cpu``, one test per dataset, on fixtures written here from a
seed in the formats the datasets ship in:

  CAMUS: MetaImage .mhd/.raw half-sequences with anisotropic
  ElementSpacing and official patient numbers → convert-camus → validate-data
  → train → parity (HD95 in mm, 2 folds; biplane EF in mL; the ablation)
  → export → the artifact served over HTTP;

  EchoNet: MJPG AVI cine loops, FileList.csv with two frame rates and
  VolumeTracings.csv → validate-data → train → the FPS-aware echonet-ef.

The two chains hold tests/test_dress_rehearsal.py's assertions, and one
more: every command after ``train`` scored the trained checkpoint, not the
seeded init that ``_load_model`` falls back to with only a warning on
stderr.  They take about a minute on the CPU and are marked slow, as the
JAX package's are.  The quick test compares the chain's data commands with
the JAX package's: the same JSON and byte-equal converted trees.
"""

import contextlib
import csv
import io
import json
import os
import threading

import numpy as np
import pytest
import torch

from gdkvm_tpu import cli as jcli
from gdkvm_tpu_torch.cli import main
from gdkvm_tpu_torch.data.camus_raw import write_mhd
from gdkvm_tpu_torch.data.synthetic import generate_clip

torch.set_num_threads(1)
SPACING = (0.308, 0.154, 1.0)     # anisotropic mm, CAMUS-like (x, y, z)
# Official CAMUS numbering: 1-400 train, 401-450 val.
PATIENTS = ("patient0001", "patient0002", "patient0401", "patient0402")
UNTRAINED = "UNTRAINED init"


def _run_cli(args, entry=main):
    """``entry(args)`` with stdout and stderr captured → (exit code, the
    JSON of the last stdout line, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = entry(args)
    lines = [line for line in out.getvalue().strip().splitlines() if line.strip()]
    return rc, (json.loads(lines[-1]) if lines else {}), err.getvalue()


def _write_raw(raw, t=12, hw=96):
    """Both views of each patient, with their ground truth, as .mhd/.raw
    half-sequences at SPACING."""
    for seed, pat in enumerate(PATIENTS):
        frames, masks = generate_clip(seed, t, hw, hw, num_classes=4)
        os.makedirs(os.path.join(raw, pat), exist_ok=True)
        for view in ("2CH", "4CH"):
            stem = os.path.join(raw, pat, f"{pat}_{view}_half_sequence")
            write_mhd(stem + ".mhd", frames[..., 0], spacing=SPACING)
            write_mhd(stem + "_gt.mhd", masks, spacing=SPACING)


_MODEL = """
model:
  num_classes: {classes}
  in_channels: 1
  enc_channels: [8, 16, 24, 32]
  enc_blocks: [1, 1, 1, 1]
  num_heads: 2
  head_dim_k: 16
  head_dim_v: 16
  kpff_channels: [24, 16, 8]
  compute_dtype: float32
"""


def _camus_cfg(tmp_path, data_root):
    cfg = tmp_path / "camus.yaml"
    cfg.write_text(f"""
data_path: {data_root}
batch_size: 2
learning_rate: 1.0e-3
num_iterations: 30
data:
  dataset: camus
  image_size: 64
  clip_len: 6
  augment: false
{_MODEL.format(classes=4)}
train:
  warmup_iterations: 5
  log_every: 10
  eval_every: 30
  checkpoint_every: 30
eval_stage:
  num_vis: 1
  streams: 1
  stream_chunk: 4
  wandb_mode: disabled
runtime:
  run_dir: {tmp_path}/camus_run
""")
    return str(cfg)


def _echonet_cfg(tmp_path, root):
    cfg = tmp_path / "echonet.yaml"
    cfg.write_text(f"""
data_path: {root}
batch_size: 2
learning_rate: 1.0e-3
num_iterations: 20
data:
  dataset: echonet
  image_size: 64
  clip_len: 6
  augment: false
{_MODEL.format(classes=2)}
train:
  warmup_iterations: 5
  log_every: 10
  eval_every: 20
  checkpoint_every: 20
eval_stage:
  num_vis: 0
  streams: 1
  stream_chunk: 4
  wandb_mode: disabled
runtime:
  run_dir: {tmp_path}/echonet_run
""")
    return str(cfg)


def _echonet_root(tmp_path):
    """Four train and two val AVIs of 24 frames at 64², at 30 and 50 fps
    in turn: the beat-wise EF must read each video's own rate."""
    pytest.importorskip("cv2")
    from gdkvm_tpu_torch.data.echonet import materialize_synthetic_echonet
    root = str(tmp_path / "echonet")
    materialize_synthetic_echonet(root, num_train=4, num_val=2, num_frames=24,
                                  image_size=64, fps_cycle=(30.0, 50.0))
    with open(os.path.join(root, "FileList.csv")) as f:
        rows = list(csv.DictReader(f))
    assert {r["FPS"] for r in rows} == {"30", "50"}
    return root


def _tree(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def test_mount_day_data_commands_match_jax(tmp_path):
    """convert-camus --split-mode official and validate-data on the chain's
    raw .mhd fixtures, and validate-data on the mixed-FPS EchoNet layout:
    the port prints the JAX package's JSON, and the two converters write
    byte-equal trees, the spacing sidecars included."""
    raw = str(tmp_path / "raw")
    _write_raw(raw)
    trees = {}
    for label, entry in (("port", main), ("jax", jcli.main)):
        out_dir = str(tmp_path / f"processed_{label}")
        rc, out, _ = _run_cli(["convert-camus", "--raw", raw, "--out", out_dir,
                               "--image-size", "64", "--clip-len", "6",
                               "--split-mode", "official"], entry)
        assert rc == 0 and out == {"clips_written": 8, "out": out_dir}
        trees[label] = _tree(out_dir)
    assert trees["port"] == trees["jax"]
    metas = [name for name in trees["port"] if name.endswith("meta.json")]
    assert len(metas) == 8
    for name in metas:
        meta = json.loads(trees["port"][name])
        assert meta["orig_spacing_mm"] == [SPACING[1], SPACING[0]]
    assert {name.split(os.sep)[0] for name in trees["port"]} == {"train", "val"}

    data_root = str(tmp_path / "processed_port")
    cfg = _camus_cfg(tmp_path, data_root)
    port = _run_cli(["validate-data", "--config", cfg])
    assert port == _run_cli(["validate-data", "--config", cfg], jcli.main)
    rc, out, _ = port
    assert rc == 0 and out["ok"]
    assert out["splits"]["train"]["clips"] == out["splits"]["val"]["clips"] == 4

    cfg = _echonet_cfg(tmp_path, _echonet_root(tmp_path))
    port = _run_cli(["validate-data", "--config", cfg])
    assert port == _run_cli(["validate-data", "--config", cfg], jcli.main)
    rc, out, _ = port
    assert rc == 0 and out["splits"]["train"]["clips"] == 4
    assert out["splits"]["val"]["ef_labels"] == 6


@pytest.mark.slow
def test_camus_mount_day_chain(tmp_path):
    """Raw mhd fixtures → convert → validate → train → parity (mm, mL,
    folds, ablate) → export → serve, every command on the trained
    checkpoint."""
    from gdkvm_tpu_torch.serve import BatchingEngine, ServeClient, make_server

    raw = str(tmp_path / "raw")
    _write_raw(raw)
    data_root = str(tmp_path / "processed")
    rc, out, _ = _run_cli(["convert-camus", "--raw", raw, "--out", data_root,
                           "--image-size", "64", "--clip-len", "6",
                           "--split-mode", "official"])
    assert rc == 0 and out["clips_written"] == 8     # 4 patients × 2 views

    cfg = _camus_cfg(tmp_path, data_root)
    rc, out, _ = _run_cli(["validate-data", "--config", cfg])
    assert rc == 0, out
    assert out["ok"] and out["splits"]["train"]["clips"] == 4
    assert out["splits"]["val"]["clips"] == 4

    rc, out, _ = _run_cli(["train", "--device", "cpu", "--config", cfg])
    assert rc == 0
    assert np.isfinite(out["final"]["loss"])
    ckpt = os.path.join(str(tmp_path), "camus_run", "checkpoints")
    assert os.listdir(ckpt) == ["step_00000030.pt"], "no checkpoint saved"

    # Clinical parity in physical units: HD95 in mm (the spacing sidecars
    # survived the converter), 2-fold CV aggregation.
    rc, out, err = _run_cli(["parity", "--device", "cpu", "--config", cfg,
                             "--protocol", "camus", "--folds", "2"])
    assert rc == 0, out
    assert UNTRAINED not in err, err
    assert out["hd95_units"] == "mm", out
    assert out["folds"] == 2 and len(out["per_fold"]) == 2
    assert np.isfinite(out["dice_mean_overall"])
    assert np.isfinite(out["hd95_mean_overall"])

    # Biplane-Simpson EF in mL (the volumes need the mm spacing).
    rc, out, err = _run_cli(["parity", "--device", "cpu", "--config", cfg,
                             "--protocol", "camus-ef"])
    assert rc == 0, out
    assert UNTRAINED not in err, err
    assert out["per_patient"], out
    assert all("v_ed_ml" in r for r in out["per_patient"]), \
        "EF volumes not in mL: spacing lost between converter and parity"

    rc, out, err = _run_cli(["parity", "--device", "cpu", "--config", cfg, "--ablate",
                             "--ablate-videos", "2", "--ablate-video-len", "8"])
    assert rc == 0, out
    assert UNTRAINED not in err, err

    # Export the trained checkpoint and serve it over HTTP.
    art = str(tmp_path / "artifact")
    rc, out, err = _run_cli(["export", "--device", "cpu", "--config", cfg, "--out", art,
                             "--chunk", "4", "--batch", "1"])
    assert rc == 0 and out["signature"]["frames_u8"][0] == 1
    assert UNTRAINED not in err, err

    engine = BatchingEngine(artifact=art, streams=1, chunk=4)
    srv = make_server(engine, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        client = ServeClient("127.0.0.1", srv.server_address[1])
        health = client.health()
        assert health["num_classes"] == 4
        client.open()
        video = np.random.default_rng(0).integers(0, 255, (8, 64, 64, 1), np.uint8)
        masks = client.infer(video)
        client.close()
        assert masks.shape == (8, 64, 64)
        assert masks.max() <= 3
    finally:
        srv.shutdown()
        srv.server_close()
        engine.close()


@pytest.mark.slow
def test_echonet_mount_day_chain(tmp_path):
    """Raw AVI + FileList (two frame rates) + VolumeTracings → validate →
    train → FPS-aware EF parity on the trained checkpoint."""
    root = _echonet_root(tmp_path)
    cfg = _echonet_cfg(tmp_path, root)
    rc, out, _ = _run_cli(["validate-data", "--config", cfg])
    assert rc == 0, out
    assert out["splits"]["train"]["clips"] == 4
    assert out["splits"]["val"]["ef_labels"] == 6

    rc, out, _ = _run_cli(["train", "--device", "cpu", "--config", cfg])
    assert rc == 0 and np.isfinite(out["final"]["loss"])
    ckpt = os.path.join(str(tmp_path), "echonet_run", "checkpoints")
    assert os.listdir(ckpt) == ["step_00000020.pt"]

    rc, out, err = _run_cli(["parity", "--device", "cpu", "--config", cfg,
                             "--protocol", "echonet-ef", "--split", "VAL"])
    assert rc == 0, out
    assert UNTRAINED not in err, err
    assert out["n_videos"] == 2
    # A 20-step model's EF error is large; what is held is that the
    # protocol scored both videos against their own labels, each at its
    # own frame rate.
    assert all("ef_true" in r and np.isfinite(r["ef_pred"]) for r in out["per_video"])
    assert {r["fps"] for r in out["per_video"]} == {30.0, 50.0}
    assert np.isfinite(out["ef_mae"])
