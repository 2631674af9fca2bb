"""Data-parallel distribution of the port (gdkvm_tpu_torch/parallel/) on the
CPU: two gloo ranks against the JAX package's two-device ``data`` mesh and
against one process.

One module fixture starts the two ranks once (tests/torch_dist_ranks.py:
train steps, whole runs with a resume, evaluate) and, while they run,
computes the references in this process: JAX's jitted ``make_train_step``
and ``evaluate`` over ``make_mesh(data=2)`` on two of its virtual CPU
devices, and the port in one process.  The tests then read what each rank
wrote.  The group's timeout is 60 s and the ranks are killed after
``RANK_TIMEOUT``, so no test can hang the suite.
"""

import json
import os
import shutil
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from gdkvm_tpu_torch.config.schema import Config, data_parallel_size, load_config
from gdkvm_tpu_torch.data import pipeline
from gdkvm_tpu_torch.data.packed import PackedDataset, write_pck
from gdkvm_tpu_torch.data.synthetic import SyntheticDataset
from gdkvm_tpu_torch.parallel import distributed
from gdkvm_tpu_torch.parallel.mesh import Mesh, batch_slice, make_mesh
from gdkvm_tpu_torch.train import losses
from gdkvm_tpu_torch.train.loop import train

import torch_dist_ranks as R

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT = 240
VAL_CLIPS = 5          # odd: a two-rank eval drops the last batch


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _write_inputs(root: str):
    """The tiny model's JAX parameters (converted to weights.pt), the two
    global batches and the packed split → (JAX model, params, configs)."""
    import jax
    from gdkvm_tpu.config.schema import load_config as jload_config
    from gdkvm_tpu.models.gdkvm import GDKVM as JGDKVM
    from gdkvm_tpu_torch.io.convert import state_dict_from_flax
    from torch_port_util import seeded_params

    jcfg = jload_config(None, R.STEP)
    cfg = R.step_cfg()
    jmodel = JGDKVM(cfg=jcfg.model)
    params = seeded_params(jmodel, 16)
    torch.save(state_dict_from_flax(jax.tree.map(np.asarray, params), cfg.model),
               os.path.join(root, "weights.pt"))
    rng = np.random.default_rng(0)
    b = cfg.train.batch_size
    batch = dict(frames=rng.integers(0, 255, (b, 2, 16, 16, 1), np.uint8),
                 masks=rng.integers(0, 2, (b, 2, 16, 16)).astype(np.uint8),
                 valid=np.ones((b, 2), np.float32))
    np.savez(os.path.join(root, "batch_a.npz"), **batch)
    # Uneven validity: rank 0's rows one valid frame each, rank 1's two.
    batch["valid"] = np.array([[1, 0], [0, 1], [1, 1], [1, 1]], np.float32)
    np.savez(os.path.join(root, "batch_b.npz"), **batch)
    k = cfg.model.num_classes
    for split, n, seed in (("train", 8, 0), ("val", VAL_CLIPS, 1)):
        write_pck(os.path.join(root, "data", f"{split}.pck"),
                  SyntheticDataset(n, 2, 32, num_classes=k, seed=seed))
    return jmodel, params, jcfg


def _jax_steps(jmodel, params, jcfg, root):
    """JAX's train step jitted over make_mesh(data=2): losses, params."""
    import jax
    import jax.numpy as jnp
    from gdkvm_tpu.data.pipeline import Batch as JBatch
    from gdkvm_tpu.parallel import batch_sharding, replicated
    from gdkvm_tpu.parallel import make_mesh as jmake_mesh
    from gdkvm_tpu.train.loop import TrainState, make_optimizer, make_train_step
    from gdkvm_tpu_torch.io.convert import state_dict_from_flax

    mesh = jmake_mesh(data=2, model=1, devices=jax.devices()[:2])
    tx = make_optimizer(jcfg)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       opt_state=tx.init(params), rng=jax.random.PRNGKey(0))
    state = jax.device_put(state, replicated(mesh))
    z = np.load(os.path.join(root, "batch_a.npz"))
    batch = jax.device_put(JBatch(frames=z["frames"], masks=z["masks"], valid=z["valid"]),
                           batch_sharding(mesh))
    step = jax.jit(make_train_step(jmodel, tx, jcfg))
    out = []
    with mesh:
        for _ in range(R.STEPS):
            state, m = step(state, batch)
            out.append(float(m["loss"]))
    return out, state_dict_from_flax(jax.tree.map(np.asarray, jax.device_get(state.params)),
                                     R.step_cfg().model)


def _jax_evaluate(jmodel, params, root):
    import jax
    from gdkvm_tpu.config.schema import load_config as jload_config
    from gdkvm_tpu.eval.evaluator import evaluate as jevaluate
    from gdkvm_tpu.parallel import make_mesh as jmake_mesh
    jcfg = jload_config(None, R.TINY + R.EVAL + [f"data.data_path={root}/data",
                                                 f"runtime.run_dir={root}/eval_jax"])
    return jevaluate(jcfg, jmodel, params, jmake_mesh(data=2, devices=jax.devices()[:2]))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Start the two ranks, compute the references meanwhile, wait."""
    root = str(tmp_path_factory.mktemp("dist"))
    jmodel, params, jcfg = _write_inputs(root)
    env = dict(os.environ, RANK="0", WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), GDKVM_DIST_TIMEOUT="60",
               PYTHONPATH=os.pathsep.join([REPO, os.path.join(REPO, "tests")]),
               OMP_NUM_THREADS="1")
    script = os.path.join(REPO, "tests", "torch_dist_ranks.py")
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, script, root], cwd=REPO,
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        refs = {"jax_steps": _jax_steps(jmodel, params, jcfg, root),
                "one_b": R.steps(root, "b"),
                "jax_eval": _jax_evaluate(jmodel, params, root)}
        for kind in ("cache", "host"):
            refs[f"run_{kind}"] = train(R.run_cfg(root, kind, os.path.join(root, f"run1_{kind}")),
                                        device="cpu")
        t1 = time.perf_counter()
        logs = [p.communicate(timeout=RANK_TIMEOUT)[0] for p in procs]
        print(f"references {t1 - t0:.1f} s, ranks {time.perf_counter() - t0:.1f} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    out = [json.load(open(os.path.join(root, f"rank{r}.json"))) for r in range(2)]
    return root, out, refs


def _params(root, case, rank):
    return torch.load(os.path.join(root, f"params_{case}_rank{rank}.pt"), weights_only=True)


def _ckpt(run_dir, step=R.RUN_STEPS):
    return torch.load(os.path.join(run_dir, "checkpoints", f"step_{step:08d}.pt"),
                      weights_only=True)


def _rows(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as fh:
        return [json.loads(line) for line in fh]


def _untimed(metrics):
    """A run's returned metrics without each rank's own clock."""
    return {k: v for k, v in metrics.items()
            if k not in ("steps_per_sec", "sec_per_step", "frames_per_sec")}


def _files(run_dir):
    return sorted(os.path.relpath(os.path.join(d, f), run_dir)
                  for d, _, fs in os.walk(run_dir) for f in fs)


# ------------------------------------------------------------ two ranks


def test_ranks_form_a_gloo_group(ranks):
    _, out, _ = ranks
    for r, o in enumerate(out):
        assert o["backend"] == "gloo"
        assert o["info"] == {"process_index": r, "process_count": 2,
                             "local_devices": 1, "global_devices": 2}


def test_two_rank_step_matches_jax_data_parallel(ranks):
    """Two steps on the global batch split 2 + 2 over the ranks equal JAX's
    step jitted over a two-device data mesh (tests/test_sharding.py's
    tolerances); the replicas stay equal."""
    root, out, refs = ranks
    jlosses, jparams = refs["jax_steps"]
    p0, p1 = _params(root, "a", 0), _params(root, "a", 1)
    for r in range(2):
        np.testing.assert_allclose(out[r]["a"], jlosses, rtol=1e-5)
    for name, want in jparams.items():
        assert torch.equal(p0[name], p1[name]), name
        np.testing.assert_allclose(p0[name].numpy(), want.numpy(), rtol=2e-4, atol=2e-5,
                                   err_msg=name)


def test_uneven_valid_step_matches_one_process(ranks):
    """Rank 0's rows hold one valid frame each, rank 1's two: the loss is
    averaged over the global batch's valid frames, so two ranks equal one
    process on the whole batch (a mean of per-rank means would not)."""
    root, out, refs = ranks
    losses_1, params_1 = refs["one_b"]
    assert out[0]["b"] == out[1]["b"]
    np.testing.assert_allclose(out[0]["b"], losses_1, rtol=1e-6)
    got = _params(root, "b", 0)
    for name, want in params_1.items():
        np.testing.assert_allclose(got[name].numpy(), want.numpy(), rtol=2e-4, atol=2e-5,
                                   err_msg=name)


@pytest.mark.parametrize("kind", ["cache", "host"])
def test_two_rank_train_matches_one_process(ranks, kind):
    """train() on two ranks equals one process: parameters, EMA and AdamW
    moments at the end within rtol 1e-5, the batch checksum identical at
    every step, the same files, all written once (by rank 0), and every
    rank returns the same metrics."""
    root, out, refs = ranks
    d1, d2 = (os.path.join(root, f"run{n}_{kind}") for n in (1, 2))
    assert _files(d2) == _files(d1)
    rows1, rows2 = _rows(d1), _rows(d2)
    assert len(rows2) == len(rows1)
    sums = [[r["batch_checksum"] for r in rows if "loss" in r] for rows in (rows1, rows2)]
    assert len(sums[0]) == R.RUN_STEPS and sums[1] == sums[0]
    for a, b in zip(rows1, rows2):
        for k in ("loss", "ce", "dice_loss", "grad_norm", "micro_grad_norm"):
            if k in a:
                np.testing.assert_allclose(b[k], a[k], rtol=1e-5, err_msg=k)
    t1, t2 = _ckpt(d1), _ckpt(d2)
    for name, want in t1["model"].items():
        np.testing.assert_allclose(t2["model"][name].numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=name)
    # AdamW's moments: their largest entries within 1e-4 (an entry near 0
    # keeps only the summation order's noise).
    for group in ("exp_avg", "exp_avg_sq"):
        for a, b in zip(t2["opt"][group], t1["opt"][group]):
            assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max()), group
    for a, b in zip(t2["ema"], t1["ema"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-7)
    assert _untimed(out[0][f"run_{kind}"]) == _untimed(out[1][f"run_{kind}"])
    if kind == "cache":      # 8 val clips: the same clips on either side
        for k, v in refs["run_cache"].items():
            if k.startswith("eval/"):
                np.testing.assert_allclose(out[0]["run_cache"][k], v, rtol=1e-6, err_msg=k)


def test_two_rank_resume_equals_unbroken(ranks):
    """Two ranks resumed from step 2 of a two-rank run reach the unbroken
    run's step 4: the same batches and state."""
    root, out, _ = ranks
    unbroken, resumed = (os.path.join(root, f"run2_{n}") for n in ("cache", "resumed"))
    got = {r["step"]: r["batch_checksum"] for r in _rows(resumed) if "loss" in r}
    want = {r["step"]: r["batch_checksum"] for r in _rows(unbroken) if "loss" in r}
    assert sorted(got) == [3, 4] and all(got[s] == want[s] for s in got)
    t_res, t_unb = _ckpt(resumed), _ckpt(unbroken)
    assert t_res["step"] == t_unb["step"] == R.RUN_STEPS
    assert torch.equal(t_res["gen"], t_unb["gen"])
    for name, want in t_unb["model"].items():
        np.testing.assert_allclose(t_res["model"][name].numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=name)
    assert _untimed(out[0]["run_resumed"]) == _untimed(out[1]["run_resumed"])


def test_two_rank_evaluate_matches_jax_mesh(ranks):
    """evaluate on two ranks equals JAX's on make_mesh(data=2): the eval
    batch is 2, the odd last clip is dropped, the Dice sums are summed and
    the HD95 values gathered; rank 0 writes the overlays of the first clips
    in the global order, as JAX writes them."""
    root, out, refs = ranks
    want = refs["jax_eval"]
    assert out[0]["eval"] == out[1]["eval"]
    got = out[0]["eval"]
    val = PackedDataset(os.path.join(root, "data", "val.pck"))
    assert got["frames"] == want["frames"] == sum(val[i][2].sum() for i in range(VAL_CLIPS - 1))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-6, atol=1e-9, err_msg=k)
    from PIL import Image
    names = sorted(os.listdir(os.path.join(root, "eval_jax", "vis")))
    assert names == sorted(os.listdir(os.path.join(root, "eval2", "vis"))) and len(names) == 3
    for name in names:
        a, b = (np.asarray(Image.open(os.path.join(root, d, "vis", name)))
                for d in ("eval_jax", "eval2"))
        w = a.shape[1] // 3          # [frame | prediction | ground truth]
        np.testing.assert_array_equal(a[:, :w], b[:, :w])
        np.testing.assert_array_equal(a[:, 2 * w:], b[:, 2 * w:])


# ------------------------------------------------------------ one process


def test_make_mesh_shapes_and_errors():
    """JAX's shapes and errors; a process group's mesh needs every rank."""
    cpu = torch.device("cpu")
    m = make_mesh(data=2, devices=[cpu] * 3)
    assert isinstance(m, Mesh) and m.shape == {"data": 2, "model": 1}
    assert m.devices == (cpu, cpu) and not m.distributed
    assert make_mesh(devices=[cpu] * 4).shape == {"data": 4, "model": 1}
    with pytest.raises(ValueError, match="exceeds 2 devices"):
        make_mesh(data=3, devices=[cpu] * 2)
    with pytest.raises(ValueError, match="not divisible by model=2"):
        make_mesh(model=2, devices=[cpu] * 3)
    assert batch_slice(m, 8) == slice(0, 4)
    assert batch_slice(Mesh(data=2, devices=(cpu,), index=1), 8) == slice(4, 8)
    assert batch_slice(0, 5) == slice(0, 5)
    with pytest.raises(ValueError, match="does not split"):
        batch_slice(m, 5)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()


def test_head_parallelism_raises_item_7(tmp_path):
    """model > 1, the LKVA heads over a 'model' axis: make_mesh gives JAX's
    shapes and errors (tests/test_sharding.py::test_make_mesh_shapes) with
    the devices row-major, as JAX's reshape(data, model); a one-process
    train at model_axis=2 raises as JAX's make_mesh does on one device,
    before it writes anything."""
    devs = [torch.device("cpu", i) for i in range(8)]
    assert make_mesh(devices=devs).shape == {"data": 8, "model": 1}
    m = make_mesh(data=4, model=2, devices=devs)
    assert m.shape == {"data": 4, "model": 2} and not m.distributed
    assert m.devices == tuple(devs) and m.row(1) == (devs[2], devs[3])
    assert make_mesh(data=2, model=2, devices=devs[:4]).row(1) == (devs[2], devs[3])
    assert make_mesh(model=2, devices=devs[:4]).shape == {"data": 2, "model": 2}
    with pytest.raises(ValueError, match="mesh 5x2 exceeds 8 devices"):
        make_mesh(data=5, model=2, devices=devs)
    assert batch_slice(m, 8) == slice(0, 2)
    assert batch_slice(Mesh(data=2, devices=(devs[0],), index=1, model=2, model_index=1),
                       8) == slice(4, 8)
    assert Mesh(data=1, devices=(devs[0],), model=2).distributed
    cfg = load_config(None, R.TINY + ["parallel.model_axis=2", f"runtime.run_dir={tmp_path}"])
    with pytest.raises(ValueError, match="1 devices not divisible by model=2"):
        train(cfg, max_steps=1, device="cpu")
    assert not os.listdir(tmp_path)


def test_parallel_config_checks():
    cfg = Config()
    cfg.train.batch_size = 6
    assert data_parallel_size(cfg, 1) == 1 and data_parallel_size(cfg, 2) == 2
    cfg.parallel.data_axis = 4
    with pytest.raises(ValueError, match="data_axis=4"):
        data_parallel_size(cfg, 2)
    cfg.parallel.data_axis = -1
    with pytest.raises(ValueError, match="batch_size=6"):
        data_parallel_size(cfg, 4)


@pytest.mark.parametrize("env,want", [
    ({}, None),
    ({"RANK": "1", "WORLD_SIZE": "2", "LOCAL_RANK": "1", "MASTER_ADDR": "h",
      "MASTER_PORT": "29500"}, ("env://", 2, 1, 1)),
    ({"GDKVM_COORDINATOR": "h:1234", "GDKVM_NUM_PROCESSES": "2",
      "GDKVM_PROCESS_ID": "1"}, ("tcp://h:1234", 2, 1, 1)),
    ({"WORLD_SIZE": "2"}, "RANK"),
    ({"GDKVM_COORDINATOR": "h:1234"}, "GDKVM_NUM_PROCESSES"),
])
def test_launcher_environments(env, want, monkeypatch):
    """torchrun's and the JAX package's variables; a launcher's set with a
    variable missing raises, naming it; none set is a one-process run."""
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
                 "GDKVM_COORDINATOR", "GDKVM_NUM_PROCESSES", "GDKVM_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if isinstance(want, str):
        with pytest.raises(RuntimeError, match=f"{want}.* unset"):
            distributed._env_spec()
    else:
        assert distributed._env_spec() == want
    if not env:
        assert distributed.maybe_initialize_distributed(device="cpu") is False
        assert distributed.process_info()["process_count"] == 1


def test_no_fallback(monkeypatch):
    """A failed NCCL init raises and leaves no group (never gloo instead);
    a rank whose card is not there raises."""
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    monkeypatch.setenv("GDKVM_DIST_TIMEOUT", "20")
    with pytest.raises(RuntimeError, match="initialization failed .*backend nccl"):
        distributed.maybe_initialize_distributed(backend="nccl", device="cpu")
    assert not torch.distributed.is_initialized()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.maybe_initialize_distributed()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_RANK", "3")
    with pytest.raises(RuntimeError, match="this host has 1 CUDA device"):
        distributed.maybe_initialize_distributed()
    assert not torch.distributed.is_initialized()


def test_global_denominator_splits_the_loss():
    """The mean of the ranks' scaled losses, and of their gradients, is the
    loss of the whole batch, with validity uneven across the halves."""
    g = torch.Generator().manual_seed(0)
    logits = torch.randn(4, 2, 8, 8, 3, generator=g, requires_grad=True)
    labels = torch.randint(0, 3, (4, 2, 8, 8), generator=g)
    valid = torch.tensor([[1.0, 0.0], [0.0, 1.0], [1.0, 1.0], [1.0, 1.0]])
    kw = dict(bootstrap_ratio=0.25, bootstrap_weight=0.5)
    whole, aux = losses.segmentation_loss(logits, labels, valid, **kw)
    whole_value = float(whole.detach())
    (g_whole,) = torch.autograd.grad(whole, logits)
    parts = [losses.segmentation_loss(logits[s], labels[s], valid[s], valid_total=valid.sum(),
                                      world=2, **kw) for s in (slice(0, 2), slice(2, 4))]
    mean = sum(p[0] for p in parts) / 2
    (g_mean,) = torch.autograd.grad(mean, logits)
    torch.testing.assert_close(mean, whole, rtol=1e-6, atol=0)
    for k in ("ce", "dice_loss"):
        torch.testing.assert_close(sum(p[1][k] for p in parts) / 2, aux[k], rtol=1e-6, atol=0)
    torch.testing.assert_close(g_mean, g_whole, rtol=1e-5, atol=1e-9)
    local = sum(losses.segmentation_loss(logits[s], labels[s], valid[s], **kw)[0]
                for s in (slice(0, 2), slice(2, 4))) / 2
    assert abs(float(local.detach()) - whole_value) > 1e-3 * whole_value  # not a mean of local means


@pytest.mark.parametrize("packed", [False, True], ids=["pool", "gather"])
def test_batch_iterator_shards_make_the_batch(packed, tmp_path):
    """A rank's shard loads only its rows, with every draw made as for the
    whole batch: the shards put together are the unsharded batch (thread
    pool path and packed gather path, augmentation and occlusion on)."""
    ds = SyntheticDataset(7, 3, 16, num_classes=2, seed=4)
    if packed:
        write_pck(str(tmp_path / "train.pck"), ds)
        ds = PackedDataset(str(tmp_path / "train.pck"))
    kw = dict(shuffle=True, augment=True, occlude_prob=0.5, seed=3, num_workers=2,
              drop_last=False, loop=False)
    whole = list(pipeline.batch_iterator(ds, 4, **kw))
    shards = [list(pipeline.batch_iterator(ds, 4, shard=(r, 2), **kw)) for r in range(2)]
    assert [b.frames.shape[0] for b in shards[0]] == [2, 1]
    for i, b in enumerate(whole):
        for key in ("frames", "masks", "valid"):
            joined = np.concatenate([getattr(s[i], key) for s in shards])
            np.testing.assert_array_equal(joined, getattr(b, key))
