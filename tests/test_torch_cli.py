"""The command line of the port (``python -m gdkvm_tpu_torch``,
gdkvm_tpu_torch.cli) on the CPU at a narrow size: every ported command
runs under ``--device cpu`` and prints JSON with the JAX package's keys;
without it each raises where there is no card; remat gives the plain step.
"""

import contextlib
import io
import json
import os
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from gdkvm_tpu import cli as jcli
from gdkvm_tpu_torch import cli
from gdkvm_tpu_torch.cli import main
from gdkvm_tpu_torch.config import schema
from gdkvm_tpu_torch.core import gdr
from gdkvm_tpu_torch.data import camus
from gdkvm_tpu_torch.eval.streaming import stream_video
from gdkvm_tpu_torch.models import decoder
from gdkvm_tpu_torch.models.gdkvm import GDKVM, init_params
from gdkvm_tpu_torch.train.loop import loss_and_grads, state_for, train
from gdkvm_tpu_torch.utils import scaling
from torch_port_util import NARROW, NARROW_OVERRIDES

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMAGE = 32
SMALL = NARROW_OVERRIDES + [f"data.image_size={IMAGE}", "data.clip_len=4",
                            "eval_stage.wandb_mode=disabled", "data.num_workers=1"]


def run(argv, rc=0):
    """main(argv) with stdout captured → (the JSON of each stdout line)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        got = main(argv)
    assert got == rc, buf.getvalue()
    return [json.loads(line) for line in buf.getvalue().strip().splitlines()]


@pytest.fixture(scope="module")
def camus_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("camus"))
    camus.materialize_synthetic_camus(root, num_train=4, num_val=4, image_size=IMAGE,
                                      clip_len=4, difficulty=0.3, seed=2)
    return root


@pytest.fixture(scope="module")
def trained(tmp_path_factory, camus_root):
    """pack the PNG layout, then train 4 steps on the packed split with an
    EMA, through the command line → (run dir, its overrides, train's JSON)."""
    tmp = tmp_path_factory.mktemp("run")
    pck = str(tmp / "pck")
    packed = run(["pack", "--out", pck, "data.dataset=camus",
                  f"data_path={camus_root}"] + SMALL)[-1]
    run_dir = str(tmp / "run")
    over = SMALL + ["data.dataset=packed", f"data_path={pck}",
                    f"runtime.run_dir={run_dir}", "train.ema_decay=0.9"]
    final = run(["train", "--device", "cpu", "num_iterations=4", "batch_size=2",
                 "train.log_every=2", "train.eval_every=4",
                 "train.checkpoint_every=4"] + over)[-1]
    return run_dir, over, final, packed


# ------------------------------------------------------------ the surface


def test_usage_line_and_exit_codes(capsys):
    assert main([]) == 2
    usage = capsys.readouterr().out.strip()
    assert jcli.main([]) == 2
    assert usage == capsys.readouterr().out.strip().replace("gdkvm_tpu", "gdkvm_tpu_torch")
    assert list(cli._COMMANDS) == list(jcli._COMMANDS) and len(cli._COMMANDS) == 17
    assert main(["--help"]) == 0 and "usage:" in capsys.readouterr().out
    assert main(["nope"]) == 2 and "unknown command 'nope'" in capsys.readouterr().err
    argv = ["--config", "c.yaml", "a.b=1", "--x=3", "k=v=w", "-N", "3e6"]
    assert cli._split_args(argv) == jcli._split_args(argv)


def test_module_entry_prints_usage_and_exits_2():
    res = subprocess.run([sys.executable, "-m", "gdkvm_tpu_torch"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 2 and res.stdout.startswith("usage: python -m gdkvm_tpu_torch {train|")


NEEDS_DEVICE = [
    ["train"], ["eval"], ["bench"], ["bench", "--mode", "train"],
    ["bench", "--mode", "modules"], ["stream-eval"], ["parity"], ["serve", "--port", "0"],
    ["infer", "--input", "x.avi", "--out", "o"], ["sweep", "learning_rate=1e-4,1e-3"],
    ["export", "--out", "a"], ["serve", "--artifact", "a", "--port", "0"],
    ["infer", "--artifact", "a", "--input", "x.avi", "--out", "o"], ["quant"]]


@pytest.mark.parametrize("argv", NEEDS_DEVICE, ids=lambda a: "-".join(a[:3]))
def test_commands_default_to_cuda_and_never_fall_back(argv, tmp_path, monkeypatch):
    """Without --device each command that runs the model wants the card
    and raises where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device; pass --device cpu"):
        main(argv + [f"runtime.run_dir={tmp_path}"])
    assert not os.path.exists(tmp_path / "config.yaml")


def test_serve_check_defaults_to_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device; pass --device cpu"):
        main(["serve-check", "--artifact", str(tmp_path)])


NOT_PORTED = [
    (["quant"], 9), (["export", "--out", "a", "--quant-scales", "s.json"], 9),
    (["stream-eval", "--quant-scales", "s.json"], 9), (["parity", "--quant-scales", "s.json"], 9),
    (["serve", "--quant-scales", "s.json"], 9), (["serve", "--mesh", "2x2"], 7),
    (["bench", "--mode", "all", "--smoke"], 4), (["bench", "--mode", "all"], 9),
    (["train", "--device", "cpu", "parallel.model_axis=2"], 7)]


@pytest.fixture(scope="module")
def w8a8_scales(trained, tmp_path_factory):
    """The run's W8A8 scales, calibrated by ``quant`` on the CPU."""
    path = str(tmp_path_factory.mktemp("quant") / "scales.json")
    out = run(["quant", "--device", "cpu", "--calib-clips", "1", "--out", path]
              + trained[1])[-1]
    assert out["n_convs"] > 0 and os.path.exists(path)
    return path


def _serve_one_session(monkeypatch, seen, video):
    """Make ``serve``'s server answer one session, then stop as on SIGINT."""
    from gdkvm_tpu_torch import serve
    real = serve.make_server

    def make_server(engine, host, port):
        srv = real(engine, host, 0)

        def serve_forever():
            thread = threading.Thread(target=type(srv).serve_forever, args=(srv,))
            thread.start()
            client = serve.ServeClient(*srv.server_address)
            seen["health"] = client.health()
            client.open()
            seen["masks"] = client.infer(video)
            client.close()
            srv.shutdown()
            thread.join(timeout=30)
            raise KeyboardInterrupt
        srv.serve_forever = serve_forever
        return srv
    monkeypatch.setattr(serve, "make_server", make_server)


@pytest.mark.parametrize("argv,item", NOT_PORTED, ids=lambda a: "-".join(map(str, a[:3]))
                         if isinstance(a, list) else str(a))
def test_unported_commands_and_flags_raise_their_item(argv, item, tmp_path, monkeypatch,
                                                      request):
    """Every command and flag that cited an item of ROADMAP Queue 1 is
    ported: each case now runs on the CPU on the run's model and is held to
    the library call it stands for.  Head parallelism (item 7): ``serve
    --mesh 2x2`` serves a session over two slot groups with the heads of
    each over two places, on ≥ 99.9% of the pixels of ``stream_video``;
    ``train parallel.model_axis=2`` as two gloo ranks of one model group
    gives one process's run (losses, norms and eval within rtol 1e-5, the
    same batches).  ``quant`` writes its scales; each ``--quant-scales``
    command equals the same computation on the eager W8A8 model (export:
    the artifact's tag and int8 products; serve: the session's masks
    against ``stream_video``; stream-eval: Dice; parity: the memory
    deltas of ``memory_ablation``); ``bench --mode all --smoke`` writes a
    valid artifact; ``bench --mode all`` wants the card and raises without
    one."""
    monkeypatch.chdir(tmp_path)
    if argv[0] == "train":
        _train_over_a_model_group(argv, tmp_path)
        return
    if argv == ["bench", "--mode", "all"]:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv)
        return
    if argv[0] == "bench":
        from gdkvm_tpu_torch.eval.regression import failed_sections, validate_artifact
        art = run(argv + ["--device", "cpu", "--out", "b.json"])[-1]
        validate_artifact(art)
        assert not failed_sections(art) and art["platform"] == "cpu"
        assert json.load(open("b.json")) == art
        return
    trained = request.getfixturevalue("trained")
    over = ["--device", "cpu"] + trained[1]
    if argv[0] == "quant":
        out = run(argv + ["--calib-clips", "1", "--out", "s.json"] + over)[-1]
        assert out["n_convs"] > 0 and out["scope"] == "encoder"
        assert set(json.load(open("s.json"))) and os.path.exists("s.json")
        return
    model, _ = cli._load_model(schema.load_config(None, trained[1]), None,
                               torch.device("cpu"), "testing")
    if item == 9:
        scales = request.getfixturevalue("w8a8_scales")
        with open(scales) as src, open("s.json", "w") as dst:
            dst.write(src.read())
        from gdkvm_tpu_torch.ops import quant
        qmodel = quant.w8a8_model(model, quant.load_scales("s.json"))
    if argv[0] == "export":
        from gdkvm_tpu_torch.io.export import load_artifact
        out = run(argv + ["--chunk", "2"] + over)[-1]
        sm = load_artifact(out["out"])
        assert sm.meta["model_config"]["quant"] == qmodel.cfg.quant
        assert any("_int_mm" in str(n.target) for n in sm.program.graph.nodes)
    elif argv[:2] == ["serve", "--mesh"]:
        seen = {}
        video = np.random.default_rng(5).integers(0, 255, (6, IMAGE, IMAGE, 1), np.uint8)
        _serve_one_session(monkeypatch, seen, video)
        out = run(argv + ["--port", "0", "--streams", "2", "--chunk", "4"] + over)[-1]
        assert out["serving"] and seen["health"]["mesh"] == {"data": 2, "model": 2}
        assert (seen["masks"] == stream_video(model, video, chunk=4)).mean() >= 0.999
    elif argv[0] == "serve":
        seen = {}
        video = np.random.default_rng(5).integers(0, 255, (4, IMAGE, IMAGE, 1), np.uint8)
        _serve_one_session(monkeypatch, seen, video)
        out = run(argv + ["--port", "0", "--streams", "1", "--chunk", "4"] + over)[-1]
        assert out["serving"] and seen["health"]["streams"] == 1
        np.testing.assert_array_equal(seen["masks"], stream_video(qmodel, video, chunk=4))
    elif argv[0] == "stream-eval":
        out = run(argv + ["--num-videos", "1", "--video-len", "4"] + over)[-1]
        from gdkvm_tpu_torch.eval.streaming import stream_evaluate
        with torch.inference_mode():
            want = stream_evaluate(schema.load_config(None, trained[1]), qmodel,
                                       num_videos=1, video_len=4, streams=1)
        assert out["dice_fg_mean"] == pytest.approx(want["dice_fg_mean"], abs=1e-6)
    else:                                 # parity
        out = run(argv + ["--ablate", "--ablate-videos", "1", "--ablate-video-len", "4"]
                  + over)[-1]
        from gdkvm_tpu_torch.eval import parity
        with torch.inference_mode():
            want = parity.memory_ablation(schema.load_config(None, trained[1]), qmodel,
                                          num_videos=1, video_len=4)
        deltas = [k for k in want if k.startswith("memory_delta")]
        assert deltas and set(deltas) == {k for k in out if k.startswith("memory_delta")}
        for k in deltas:
            assert out[k] == pytest.approx(want[k], abs=1e-6), k


def _train_over_a_model_group(argv, tmp_path):
    """``argv`` (train at model_axis=2) as two ranks of a gloo group on the
    CPU, against the same run in one process at model_axis=1."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    common = ["num_iterations=2", "batch_size=2", "train.log_every=1",
              "train.eval_every=2", "train.checkpoint_every=2"] + SMALL
    env = dict(os.environ, WORLD_SIZE="2", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               GDKVM_DIST_TIMEOUT="60", OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    for k in ("GDKVM_COORDINATOR", "GDKVM_NUM_PROCESSES", "GDKVM_PROCESS_ID"):
        env.pop(k, None)
    cmd = [sys.executable, "-m", "gdkvm_tpu_torch"] + argv + common + [
        f"runtime.run_dir={tmp_path / 'ranks'}"]
    procs = [subprocess.Popen(cmd, cwd=REPO, env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        one = run(["train", "--device", "cpu", f"runtime.run_dir={tmp_path / 'one'}"]
                  + common)[-1]["final"]
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    assert outs[1][0].strip() == ""                  # rank 0 alone prints
    got = json.loads(outs[0][0].strip().splitlines()[-1])["final"]
    assert set(got) == set(one)
    for k, v in one.items():
        if k not in ("steps_per_sec", "sec_per_step", "frames_per_sec"):
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-7, err_msg=k)
    assert got["batch_checksum"] == one["batch_checksum"]
    assert sorted(os.listdir(tmp_path / "ranks" / "checkpoints")) == ["step_00000002.pt"]


def _clear_launcher_env(monkeypatch):
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
                 "GDKVM_COORDINATOR", "GDKVM_NUM_PROCESSES", "GDKVM_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)


def test_train_refuses_a_torchrun_world(monkeypatch, tmp_path):
    """A torchrun environment with variables missing (WORLD_SIZE alone) is
    refused, naming them, before anything is written: no process trains a
    copy of its own."""
    _clear_launcher_env(monkeypatch)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="RANK, MASTER_ADDR, MASTER_PORT unset"):
        main(["train", "--device", "cpu", f"runtime.run_dir={tmp_path}"])
    assert not os.listdir(tmp_path)


def test_train_in_a_one_rank_process_group(monkeypatch, tmp_path):
    """train under torchrun's variables for one rank joins a gloo group of
    one on the CPU, trains, prints its JSON and leaves the group."""
    import socket
    from gdkvm_tpu_torch.parallel import distributed
    from gdkvm_tpu_torch.train import loop
    _clear_launcher_env(monkeypatch)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(port), GDKVM_DIST_TIMEOUT="30").items():
        monkeypatch.setenv(k, v)
    groups = []

    def recording_train(cfg, **kw):
        groups.append((torch.distributed.get_backend(), distributed.process_info()))
        return train(cfg, **kw)
    monkeypatch.setattr(loop, "train", recording_train)
    out = run(["train", "--device", "cpu", "num_iterations=2", "batch_size=2",
               "train.log_every=1", f"runtime.run_dir={tmp_path}"] + SMALL)[-1]
    assert groups == [("gloo", {"process_index": 0, "process_count": 1,
                                "local_devices": 1, "global_devices": 1})]
    assert np.isfinite(out["final"]["loss"]) and not torch.distributed.is_initialized()
    assert len(open(tmp_path / "metrics.jsonl").readlines()) == 3


@pytest.mark.parametrize("argv,err", [
    (["serve", "--artifact", "a", "--mesh", "auto"], "applies to the checkpoint path"),
    (["serve", "--mesh", "3"], "must be 'auto' or 'DxM'"),
    (["serve", "--artifact", "a", "--quant-scales", "s.json"],
     "--quant-scales applies to the checkpoint path"),
], ids=["artifact", "malformed", "artifact-quant"])
def test_serve_mesh_flag_errors(argv, err, capsys, tmp_path):
    """As in the JAX package: exit code 2 and the reason on stderr."""
    assert main(argv + [f"runtime.run_dir={tmp_path}"]) == 2
    assert err in capsys.readouterr().err


def test_train_data_axis_must_be_the_world(tmp_path):
    with pytest.raises(ValueError, match="parallel.data_axis=4: a run of 1 process"):
        main(["train", "--device", "cpu", "parallel.data_axis=4",
              f"runtime.run_dir={tmp_path}"])
    assert not os.listdir(tmp_path)


# ------------------------------------------------------------ pure commands


@pytest.mark.parametrize("n,d", [("1e8", "2e10"), ("3.5×10^6", "2*10^9"), ("1_000_000", "3e6")])
def test_scale_matches_jax(n, d, capsys):
    from gdkvm_tpu.utils import scaling as jscaling
    got = run(["scale", "-N", n, "-D", d])[-1]
    assert jcli.main(["scale", "-N", n, "-D", d]) == 0
    assert got == json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got == jscaling.optimal_bs_lr(n, d) == scaling.optimal_bs_lr(n, d)
    for text in ("3.5×10^6", "1e8", "1_000_000", "2x10^7", "(2*3)**2/4"):
        assert scaling.parse_count(text) == jscaling.parse_count(text)
    for bad in ("-5", "import os", "9**9**9", "1/0"):
        with pytest.raises(ValueError):
            scaling.parse_count(bad)
    assert main(["scale", "-N", "import os", "-D", "1"]) == 2
    assert "error:" in capsys.readouterr().err


def test_info_prints_versions_and_the_resolved_config(capsys):
    out = run(["info", "--config", os.path.join(REPO, "configs/smoke_synthetic.yaml"),
               "--probe", "train.remat=true"])[-1]
    assert out["torch"] == torch.__version__ and out["numpy"] == np.__version__
    assert out["gdkvm_tpu_torch"] and "cuda" in out and out["platform"] in ("cpu", "gpu")
    assert isinstance(out["pck_native_loader"], bool)
    if out["platform"] == "cpu":          # no card: nothing is timed, and it says so
        assert out["device_roundtrip_ms"] is None
        assert "no CUDA device" in capsys.readouterr().err
    else:
        assert out["device_roundtrip_ms"] >= 0
    assert out["config"]["model"]["gdr_impl"] == "auto" and out["config"]["train"]["remat"]
    assert jcli.main(["info", "--config", os.path.join(REPO, "configs/smoke_synthetic.yaml"),
                      "train.remat=true"]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["config"] == want["config"]
    assert set(want) - set(out) == {"gdkvm_tpu", "jax", "flax", "optax", "jit_cache_dir"}
    assert "config" not in run(["info"])[-1]


def test_pack_and_validate_data_match_jax(trained, camus_root, capsys):
    """pack's record and validate-data's report equal the JAX package's on
    the same layout; a bad path warns with exit code 1."""
    packed = trained[3]
    assert set(packed) == {"train", "val"}
    for rec in packed.values():
        assert rec["clips"] == 4 and rec["bytes"] == os.path.getsize(rec["path"])
    argv = ["validate-data", "data.dataset=camus", f"data_path={camus_root}",
            f"data.image_size={IMAGE}", "data.clip_len=4", "model.num_classes=4"]
    got = run(argv)[-1]
    assert jcli.main(argv) == 0
    assert got == json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["ok"] and got["splits"]["train"]["clips"] == 4
    bad = run(["validate-data", "data.dataset=camus", "data_path=/nope_nope"], rc=1)[-1]
    assert not bad["ok"] and "error" in bad["splits"]["train"]
    got = run(["validate-data", "--splits", "val", "--sample", "2"] + trained[1])[-1]
    assert got["dataset"] == "packed" and list(got["splits"]) == ["val"]


def test_convert_camus(tmp_path):
    from gdkvm_tpu_torch.data.camus_raw import write_mhd
    rng = np.random.default_rng(0)
    for pid in (1, 2):
        d = tmp_path / "raw" / f"patient{pid:04d}"
        d.mkdir(parents=True)
        for view in ("2CH", "4CH"):
            write_mhd(str(d / f"patient{pid:04d}_{view}_half_sequence.mhd"),
                      rng.integers(0, 255, (5, 40, 36), np.uint8), spacing=(0.3, 0.15, 1.0))
            write_mhd(str(d / f"patient{pid:04d}_{view}_half_sequence_gt.mhd"),
                      rng.integers(0, 4, (5, 40, 36), np.uint8), spacing=(0.3, 0.15, 1.0))
    out = run(["convert-camus", "--raw", str(tmp_path / "raw"), "--out", str(tmp_path / "png"),
               "--image-size", "32", "--clip-len", "4", "--val-fraction", "0.5"])[-1]
    assert out == {"clips_written": 4, "out": str(tmp_path / "png")}
    assert sorted(os.listdir(tmp_path / "png")) == ["train", "val"]


# ------------------------------------------------------------ the run


def test_train_writes_its_records(trained):
    """train prints {"final": metrics}; the run dir holds config.yaml (read
    back by load_config to the run's config), the log and the checkpoint."""
    run_dir, over, final, _ = trained
    assert set(final) == {"final"}
    m = final["final"]
    assert {"loss", "ce", "dice_loss", "grad_norm", "steps_per_sec", "eval/dice_fg_mean",
            "eval/frames"} <= set(m) and m["eval/frames"] == 16.0
    assert {"config.yaml", "metrics.jsonl", "checkpoints"} <= set(os.listdir(run_dir))
    cfg = schema.load_config(os.path.join(run_dir, "config.yaml"))
    assert cfg == schema.load_config(None, over + ["num_iterations=4", "batch_size=2",
                                                   "train.log_every=2", "train.eval_every=4",
                                                   "train.checkpoint_every=4"])
    assert cfg.train.num_iterations == 4 and cfg.num_iterations == 4
    from gdkvm_tpu.config import schema as jschema
    assert jschema.load_config(os.path.join(run_dir, "config.yaml")).train.ema_decay == 0.9
    assert os.listdir(os.path.join(run_dir, "checkpoints")) == ["step_00000004.pt"]


def test_eval_scores_the_checkpoint(trained, tmp_path):
    """eval restores the run's checkpoint (the EMA weights) and reproduces
    the run's last eval; without a checkpoint it is an error."""
    run_dir, over, final, _ = trained
    out = run(["eval", "--device", "cpu"] + over)[-1]
    assert out == {k[5:]: v for k, v in final["final"].items() if k.startswith("eval/")}
    assert run(["eval", "--device", "cpu", "--checkpoint",
                os.path.join(run_dir, "checkpoints")] + over)[-1] == out
    raw = run(["eval", "--device", "cpu", "eval_stage.use_ema=false"] + over)[-1]
    assert raw != out
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        main(["eval", "--device", "cpu", f"runtime.run_dir={tmp_path}"] + SMALL)


def test_stream_eval_and_parity_from_the_checkpoint(trained, camus_root, capsys):
    """stream-eval, parity (camus, folds, camus-ef, ablate) on the restored
    model, with the JAX package's keys; the residual-free forward only."""
    over = trained[1]
    gdr.CHUNKED_CALLS.reset()
    out = run(["stream-eval", "--device", "cpu", "--num-videos", "2", "--video-len", "12",
               "--streams", "2", "eval_stage.stream_chunk=4"] + over)[-1]
    assert {"dice_class0", "dice_class3", "dice_fg_mean", "frames", "stream_frames_per_sec",
            "videos", "streams"} == set(out) - {"dice_class1", "dice_class2"}
    assert out["frames"] == 24.0 and gdr.CHUNKED_CALLS.n == 6     # 3 chunks, two passes
    single = run(["stream-eval", "--device", "cpu", "--num-videos", "2", "--video-len", "12",
                  "--consistency", "--occlude", "eval_stage.stream_chunk=4"] + over)[-1]
    assert {"temporal_fg_iou", "flicker_rate"} <= set(single) and "streams" not in single

    png = over + ["data.dataset=camus", f"data_path={camus_root}"]
    res = run(["parity", "--device", "cpu", "--protocol", "camus", "--max-patients", "1"] + png)[-1]
    assert res["protocol"] == "camus_official_ed_es_per_patient" and res["n_patients"] == 1
    assert "table" not in res and "| View | Structure |" in capsys.readouterr().err
    assert {"split", "per_structure", "hd95_units", "dice_mean_overall"} <= set(res)
    folds = run(["parity", "--device", "cpu", "--folds", "2", "--no-hd95"] + png)[-1]
    assert folds["protocol"] == "camus_official_kfold" and folds["n_patients"] == 2
    ef = run(["parity", "--device", "cpu", "--protocol", "camus-ef"] + png)[-1]
    assert ef["protocol"] == "camus_ef_biplane_simpson" and ef["n_patients"] == 2
    abl = run(["parity", "--device", "cpu", "--ablate", "--ablate-videos", "1",
               "--ablate-video-len", "6"] + over)[-1]
    assert abl["protocol"] == "memory_ablation_2x2" and len(abl["conditions"]) == 8
    assert "memory_delta_occluded_window" in abl
    assert not capsys.readouterr().err.startswith("warning")
    assert torch.is_grad_enabled() and not torch.is_inference_mode_enabled()


def test_parity_echonet_auto_protocol(tmp_path, capsys):
    """--protocol auto picks echonet-ef by data.dataset; without a
    checkpoint the init is seeded and a warning goes to stderr."""
    pytest.importorskip("cv2")
    from gdkvm_tpu_torch.data.echonet import materialize_synthetic_echonet
    root = str(tmp_path / "echo")
    materialize_synthetic_echonet(root, num_train=1, num_val=2, num_frames=12,
                                  image_size=IMAGE, seed=5)
    argv = ["parity", "--device", "cpu", "--num-videos", "1", "data.dataset=echonet",
            f"data_path={root}", f"runtime.run_dir={tmp_path}/none"] + SMALL
    out = run(argv)[-1]
    assert out["protocol"] == "echonet_ef_area_length" and out["n_videos"] == 1
    assert "UNTRAINED init" in capsys.readouterr().err
    assert run(argv)[-1]["per_video"] == out["per_video"]       # the init is seeded


def test_infer_from_the_checkpoint(trained, camus_root, tmp_path):
    """infer on a PNG clip of the layout, resized on the host and on the
    device: masks.npz, overlays and infer.json; the host-resized masks are
    stream_video's on the restored model."""
    run_dir, over, _, _ = trained
    clip = os.path.join(camus_root, "val", sorted(os.listdir(os.path.join(camus_root, "val")))[0])
    out = run(["infer", "--device", "cpu", "--input", clip, "--out", str(tmp_path / "a"),
               "--chunk", "3", "--overlay-every", "2"] + over)[-1]
    assert out["frames"] == 8 and out["overlays"] == 4        # 4 frames + 4 masks are PNGs
    masks = np.load(tmp_path / "a" / "masks.npz")["masks"]
    cfg = schema.load_config(None, over)
    model, step = cli._load_model(cfg, None, torch.device("cpu"), "testing")
    assert step == 4
    from gdkvm_tpu_torch.eval.infer import load_frames
    np.testing.assert_array_equal(masks, stream_video(model, load_frames(clip, IMAGE), chunk=3))
    big = run(["infer", "--device", "cpu", "--input", clip, "--out", str(tmp_path / "b"),
               "--device-resize", "data.image_size=48"] + [o for o in over
                                                           if "image_size" not in o])[-1]
    assert np.load(tmp_path / "b" / "masks.npz")["masks"].shape == (8, 48, 48)
    assert big["overlays"] == 0 and json.load(open(tmp_path / "b" / "infer.json")) == big


def test_serve_subprocess_and_serve_bench(trained):
    """serve as a subprocess: the first stdout line gives the port;
    serve-bench against it prints ok; /healthz names the device and its
    ticks grow; SIGINT ends it with exit code 0."""
    from gdkvm_tpu_torch.serve import ServeClient
    over = trained[1]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "gdkvm_tpu_torch", "serve", "--device", "cpu", "--port", "0",
         "--streams", "2", "--chunk", "4"] + over,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=REPO)
    try:
        first = json.loads(proc.stdout.readline())
        assert first["serving"] and first["streams"] == 2 and first["chunk"] == 4
        assert first["image_size"] == IMAGE and first["port"] > 0
        client = ServeClient(first["host"], first["port"])
        before = client.health()
        assert before["device"] == "cpu" and before["ok"]
        out = run(["serve-bench", "--port", str(first["port"]), "--sessions", "2",
                   "--frames", "8"])[-1]
        assert out["ok"] and out["frames_total"] == 16 and out["frames_per_request"] == 4
        assert set(out) == {"ok", "sessions", "chunk", "frames_per_request", "frames_total",
                            "frames_per_sec", "request_latency_ms_p50",
                            "request_latency_ms_p95", "request_latency_ms_p99",
                            "latency_ms_per_frame_p50"}
        assert client.health()["ticks"] > before["ticks"]
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0, proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.stdout.close()
        proc.stderr.close()


@pytest.mark.parametrize("mesh", [["2x1"], ["auto", "parallel.data_axis=2"]],
                         ids=["2x1", "auto"])
def test_serve_mesh_splits_the_pool(trained, mesh, monkeypatch):
    """serve --mesh on the CPU: two replicas of the run's model, one slot
    each; /healthz reports the mesh and a session's masks are
    stream_video's."""
    from gdkvm_tpu_torch import serve
    real, seen = serve.make_server, {}
    video = np.random.default_rng(5).integers(0, 255, (6, IMAGE, IMAGE, 1), np.uint8)

    def make_server(engine, host, port):
        srv = real(engine, host, 0)

        def serve_forever():              # one session, then as if SIGINT
            thread = threading.Thread(target=type(srv).serve_forever, args=(srv,))
            thread.start()
            client = serve.ServeClient(*srv.server_address)
            seen["health"] = client.health()
            client.open()
            seen["masks"] = client.infer(video)
            client.close()
            srv.shutdown()
            thread.join(timeout=30)
            raise KeyboardInterrupt
        srv.serve_forever = serve_forever
        return srv
    monkeypatch.setattr(serve, "make_server", make_server)
    out = run(["serve", "--device", "cpu", "--port", "0", "--streams", "2", "--chunk", "4",
               "--mesh", mesh[0]] + trained[1] + mesh[1:])[-1]
    assert out["serving"] and out["streams"] == 2
    assert seen["health"]["mesh"] == {"data": 2, "model": 1}
    model, _ = cli._load_model(schema.load_config(None, trained[1]), None,
                               torch.device("cpu"), "testing")
    np.testing.assert_array_equal(seen["masks"], stream_video(model, video, chunk=4))


@pytest.fixture(scope="module")
def artifact(trained, tmp_path_factory):
    """export of the run's checkpoint (the EMA weights), batch 1, chunk 4,
    on the CPU → (its directory, export's JSON)."""
    art = str(tmp_path_factory.mktemp("export") / "art")
    out = run(["export", "--device", "cpu", "--out", art, "--chunk", "4"] + trained[1])[-1]
    return art, out


def test_export_and_serve_check_from_the_checkpoint(trained, artifact):
    """export prints the JAX package's keys for a cpu artifact of the
    run's checkpoint, whose program gives the restored model's logits;
    serve-check loads it and prints ok with JAX's keys; a list of two
    platforms raises."""
    from gdkvm_tpu_torch.io.export import load_artifact
    art, out = artifact
    assert set(out) == {"out", "blob_bytes", "platforms", "signature"}
    assert out["platforms"] == ["cpu"] and out["out"] == art
    assert out["signature"]["frames_u8"] == [1, 4, IMAGE, IMAGE, 1]
    assert out["blob_bytes"] == os.path.getsize(os.path.join(art, "model.pt2"))
    model, step = cli._load_model(schema.load_config(None, trained[1]), None,
                                  torch.device("cpu"), "testing")
    frames = torch.randint(0, 256, (1, 4, IMAGE, IMAGE, 1), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(1))
    sm = load_artifact(art, "cpu")
    logits, _, _ = sm.step(frames, *sm.init_state())
    with torch.no_grad():
        want, _ = model(frames.to(torch.float32) / 255.0)
    assert step == 4 and (logits - want).abs().max().item() <= 1e-6
    check = run(["serve-check", "--device", "cpu", "--artifact", art, "--chunks", "2"])[-1]
    assert set(check) == {"ok", "logits_shape", "frames_seen", "frames_per_sec_incl_compile"}
    assert check["ok"] is True and check["logits_shape"] == [1, 4, IMAGE, IMAGE, 4]
    assert check["frames_seen"] == [8] and check["frames_per_sec_incl_compile"] > 0
    with pytest.raises(ValueError, match="one device type"):
        main(["export", "--device", "cpu", "--out", art + "2", "--platforms", "cpu,cuda"]
             + trained[1])


def test_infer_artifact_equals_infer(trained, camus_root, artifact, tmp_path):
    """infer --artifact on a PNG clip gives infer's masks from the same
    checkpoint."""
    over = trained[1]
    clip = os.path.join(camus_root, "val", sorted(os.listdir(os.path.join(camus_root, "val")))[0])
    run(["infer", "--device", "cpu", "--input", clip, "--out", str(tmp_path / "m"),
         "--chunk", "4"] + over)
    got = run(["infer", "--device", "cpu", "--input", clip, "--out", str(tmp_path / "a"),
               "--artifact", artifact[0]] + over)[-1]
    assert got["frames"] == 8
    np.testing.assert_array_equal(np.load(tmp_path / "a" / "masks.npz")["masks"],
                                  np.load(tmp_path / "m" / "masks.npz")["masks"])


def test_serve_artifact_subprocess(trained, artifact):
    """serve --artifact as a subprocess: the artifact's size, one slot of
    its chunk; a session's masks are infer_video_artifact's; SIGINT ends it
    with exit code 0."""
    from gdkvm_tpu_torch.eval.infer import infer_video_artifact
    from gdkvm_tpu_torch.serve import ServeClient
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "gdkvm_tpu_torch", "serve", "--device", "cpu", "--port", "0",
         "--streams", "1", "--chunk", "4", "--artifact", artifact[0]] + trained[1],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=REPO)
    try:
        first = json.loads(proc.stdout.readline())
        assert (first["streams"], first["chunk"], first["image_size"]) == (1, 4, IMAGE)
        client = ServeClient(first["host"], first["port"])
        client.open()
        video = np.random.default_rng(3).integers(0, 255, (6, IMAGE, IMAGE, 1), np.uint8)
        np.testing.assert_array_equal(client.infer(video),
                                      infer_video_artifact(artifact[0], video))
        client.close()
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0, proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.stdout.close()
        proc.stderr.close()


BENCH = ["--chunk", "2", "--batch", "2", "--image-size", str(IMAGE)] + NARROW_OVERRIDES


@pytest.mark.parametrize("mode,keys", [
    ("stream", {"frames_per_sec", "ms_per_frame", "chunk", "batch", "image_size",
                "timed_frames", "elapsed_sec", "apparent_tflops", "plausible", "device"}),
    ("latency", {"chunk", "batch", "image_size", "calls", "latency_ms_p50", "latency_ms_p95",
                 "latency_ms_p99", "latency_ms_mean", "latency_ms_per_frame_p50", "device"}),
])
def test_bench_stream_and_latency_print_jax_keys(mode, keys):
    """JAX's keys (gdkvm_tpu/eval/throughput.py) plus the device the number
    was taken on: "cpu" here, never a card's name."""
    out = run(["bench", "--device", "cpu", "--mode", mode] + BENCH)[-1]
    assert set(out) == keys and out["device"] == "cpu"
    assert out["chunk"] == 2 and out["batch"] == 2 and out["image_size"] == IMAGE
    if mode == "stream":           # no peak is known for the CPU
        assert out["apparent_tflops"] > 0 and out["plausible"] is None


def test_bench_train_prints_jax_keys():
    out = run(["bench", "--device", "cpu", "--mode", "train", "--image-size", str(IMAGE),
               "batch_size=1", "data.clip_len=2"] + NARROW_OVERRIDES)[-1]
    assert set(out) == {"sec_per_step", "steps_per_sec", "train_frames_per_sec", "batch_size",
                        "clip_len", "image_size"}
    assert out["train_frames_per_sec"] == out["steps_per_sec"] * 1 * 2 and out["image_size"] == IMAGE


ROW_KEYS = {"flops_per_call", "ms_per_call", "tflops_per_sec"}


def test_bench_modules_rows_and_keys():
    """The forward breakdown: JAX's rows and keys; the parts' FLOPs add up
    to the full model's; no floor is subtracted and _meta says so."""
    out = run(["bench", "--device", "cpu", "--mode", "modules"] + BENCH)[-1]
    assert list(out) == ["encoder", "lkva_gdr", "decoder", "full_model", "loss", "_meta"]
    for name in list(out)[:-1]:
        assert set(out[name]) == ROW_KEYS | {"pct_of_full_time"} and out[name]["ms_per_call"] > 0
    parts = sum(out[n]["flops_per_call"] for n in ("encoder", "lkva_gdr", "decoder"))
    assert parts == out["full_model"]["flops_per_call"] > 0
    meta = out["_meta"]
    assert {"image_size", "chunk", "batch", "reps", "floor_ms_per_rep", "sum_parts_ms",
            "fusion_gain_ms"} <= set(meta)
    assert meta["floor_ms_per_rep"] == 0.0 and meta["clock"] == "host_perf_counter"
    assert meta["device"] == "cpu" and meta["reps"] == 100


def test_grad_breakdown_rows_keys_and_flops():
    """The train-step breakdown (called with few reps; the command line's
    --grad passes 100): JAX's rows and keys, backward FLOPs above the
    forward's, with and without an optimizer."""
    from gdkvm_tpu_torch.eval.modulebench import grad_breakdown, module_breakdown
    from gdkvm_tpu_torch.train.loop import Optimizer
    model = init_params(GDKVM(schema.ModelConfig(**NARROW)), torch.Generator().manual_seed(0))
    kw = dict(image_size=IMAGE, chunk=2, batch=2, reps=2)
    out = grad_breakdown(model, **kw, opt=Optimizer(list(model.parameters()), schema.Config()))
    assert list(out) == ["encoder", "lkva_gdr", "decoder", "loss", "full_fwd_bwd", "optimizer",
                         "train_step_total", "_meta"]
    for name in list(out)[:-1]:
        assert set(out[name]) == ROW_KEYS | {"pct_of_step_time"}
    assert out["train_step_total"]["pct_of_step_time"] == 100.0
    assert out["_meta"]["mode"] == "grad" and out["_meta"]["floor_ms_per_rep"] == 0.0
    fwd = module_breakdown(model.eval(), **kw)
    assert out["full_fwd_bwd"]["flops_per_call"] > 2 * fwd["full_model"]["flops_per_call"]
    bare = grad_breakdown(model, **kw)
    assert "optimizer" not in bare and bare["full_fwd_bwd"]["pct_of_step_time"] == 100.0


def test_sweep_ranks_and_contains_an_erroring_combo(tmp_path):
    """Two learning rates x (a valid and an invalid cache mode): bracketed
    values stay fixed, the failing combos are recorded with an error field,
    the summary ranks the rest; no swept value is exit code 2."""
    base = ["--device", "cpu", "num_iterations=2", "train.log_every=1", "train.eval_every=2",
            "train.checkpoint_every=100", "batch_size=1", f"runtime.run_dir={tmp_path}/base"] \
        + [o for o in SMALL if "clip_len" not in o] + ["data.clip_len=2"]
    lines = run(["sweep", "--metric", "loss", "learning_rate=1e-4,1e-2",
                 "data.device_cache=on,bogus"] + base)
    runs, summary = lines[:-1], lines[-1]
    assert len(runs) == 4 and summary == {"sweep_best": summary["sweep_best"],
                                          "metric": "loss", "runs": 4}
    oks = [r for r in runs if "error" not in r]
    errs = [r for r in runs if "error" in r]
    assert len(oks) == 2 and len(errs) == 2 and all("bogus" in r["overrides"][1] for r in errs)
    assert [os.path.basename(r["run_dir"]) for r in runs] == [
        "00_learning_rate-1e-4_device_cache-on", "01_learning_rate-1e-4_device_cache-bogus",
        "02_learning_rate-1e-2_device_cache-on", "03_learning_rate-1e-2_device_cache-bogus"]
    assert summary["sweep_best"] == min(oks, key=lambda r: r["loss"])
    assert all(os.path.exists(os.path.join(r["run_dir"], "metrics.jsonl")) for r in oks)
    assert main(["sweep", "--device", "cpu", "model.enc_channels=[8,16,24,32]"]) == 2


# ------------------------------------------------------------ remat, caches


def _step_cfg(**train_kw):
    return schema.Config(model=schema.ModelConfig(**NARROW),
                         data=schema.DataConfig(image_size=IMAGE, clip_len=3),
                         train=schema.TrainConfig(batch_size=2, bootstrap_ratio=0.5, **train_kw))


@pytest.mark.parametrize("impl", ["chunked", "pallas"])
def test_remat_gives_the_plain_step(impl, monkeypatch):
    """train.remat (torch.utils.checkpoint around the forward): the loss
    and every gradient equal the plain step's within 1e-6, through the
    plain GDR and through the GDR's autograd Function (its launchers
    swapped for their plain versions, which bump the kernels' counters);
    the forward's counters read 2 a step, the backward's 1."""
    from gdkvm_tpu_torch.data.pipeline import batch_iterator, make_dataset
    from gdkvm_tpu_torch.ops import gdr_cuda
    if impl == "pallas":
        def fwd(q, k, v, beta, alpha, s0, eta=None, *, save_uw=True, save_bf16=False):
            gdr_cuda.LAUNCHES.n += 1
            gdr_cuda.RESIDUAL_LAUNCHES.n += 1
            return gdr.gdr_chunked_residuals(q, k, v, beta, alpha, s0, eta)
        monkeypatch.setattr(gdr_cuda, "gdr_fwd_cuda_residuals", fwd)
        monkeypatch.setattr(gdr_cuda, "_require_cuda", lambda *a: None)
        monkeypatch.setenv("GDKVM_GDR_BWD", "stored")
    out = {}
    for remat in (False, True):
        cfg = _step_cfg(remat=remat)
        cfg.model.gdr_impl = impl
        model = init_params(GDKVM(cfg.model), torch.Generator().manual_seed(0))
        state = state_for(cfg, model)
        ds = make_dataset(cfg.data, "train", 4)
        batch = next(batch_iterator(ds, 2, augment=False, seed=0))
        for c in (gdr.CHUNKED_CALLS, gdr.BWD_STORED_CALLS, gdr_cuda.LAUNCHES,
                  gdr_cuda.RESIDUAL_LAUNCHES):
            c.reset()
        metrics, grads = loss_and_grads(state, batch, cfg)
        fwd_count = gdr_cuda.LAUNCHES.n if impl == "pallas" else gdr.CHUNKED_CALLS.n
        assert fwd_count == (2 if remat else 1)
        if impl == "pallas":
            assert gdr_cuda.RESIDUAL_LAUNCHES.n == fwd_count and gdr.BWD_STORED_CALLS.n == 1
        out[remat] = (metrics["loss"].item(), grads)
    assert out[True][0] == pytest.approx(out[False][0], abs=1e-6)
    for a, b in zip(out[True][1], out[False][1]):
        assert (a - b).abs().max().item() <= 1e-6


def test_resize_cache_made_under_inference_mode_serves_training():
    """A decoder resize matrix first asked for under inference_mode (an
    eval command) is a plain tensor: a training step at that size runs."""
    decoder._resize_tensor.cache_clear()
    cfg = _step_cfg()
    model = init_params(GDKVM(cfg.model), torch.Generator().manual_seed(0))
    x = torch.rand(1, 2, IMAGE, IMAGE, 1)
    with torch.inference_mode():
        model(x)
    logits, _ = model(x)
    torch.autograd.grad(logits.sum(), list(model.parameters()), allow_unused=True)


def test_train_writes_config_yaml_without_the_command_line(tmp_path):
    cfg = _step_cfg(num_iterations=1, log_every=1, eval_every=100, checkpoint_every=100)
    cfg.runtime.run_dir = str(tmp_path)
    cfg.eval_stage.wandb_mode = "disabled"
    cfg.data.num_workers = 1
    train(cfg, device="cpu")
    assert schema.load_config(str(tmp_path / "config.yaml")) == cfg
    assert "config.json" not in os.listdir(tmp_path)
