"""Head parallelism of the port over a process group on the CPU: four gloo
ranks laid out as a data 2 × model 2 mesh (the tiny model's two LKVA heads,
one a rank of each pair) against the JAX package's 2x2 mesh and against
one process.

One module fixture writes the inputs and runs the one-process reference
run (the ranks resume from its step-2 checkpoint), starts the four ranks
(tests/torch_head_ranks.py: two train steps, a whole run with a clip that
bites, a resume from the one-process checkpoint, evaluate) and, while they
run, computes JAX's jitted ``make_train_step`` and ``evaluate`` over
``make_mesh(data=2, model=2)``.  After the ranks, one process resumes from
the 2x2 run's step-2 checkpoint.  The group's timeout is 60 s and the ranks
are killed after ``RANK_TIMEOUT``.
"""

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from gdkvm_tpu_torch.parallel.mesh import gather_state_dicts, param_shardings
from gdkvm_tpu_torch.train.loop import train

import torch_dist_ranks as R
import torch_head_ranks as H
from test_torch_distributed import (REPO, RANK_TIMEOUT, VAL_CLIPS, _ckpt, _files,
                                    _free_port, _rows, _untimed, _write_inputs)

torch.set_num_threads(1)
WORLD = 4


def _jax_mesh():
    import jax
    from gdkvm_tpu.parallel import make_mesh as jmake_mesh
    return jmake_mesh(data=2, model=2, devices=jax.devices()[:WORLD])


def _write_batch(root):
    """The two-step check's global batch, at 32²."""
    rng = np.random.default_rng(1)
    b = R.step_cfg().train.batch_size
    np.savez(os.path.join(root, "batch_32.npz"),
             frames=rng.integers(0, 255, (b, 2, 32, 32, 1), np.uint8),
             masks=rng.integers(0, 2, (b, 2, 32, 32)).astype(np.uint8),
             valid=np.ones((b, 2), np.float32))


def _jax_steps(jmodel, params, root):
    """JAX's train step jitted over make_mesh(data=2, model=2), the params
    laid out by its param_shardings: (loss, grad norm) a step, params."""
    import jax
    import jax.numpy as jnp
    from gdkvm_tpu.config.schema import load_config as jload_config
    from gdkvm_tpu.data.pipeline import Batch as JBatch
    from gdkvm_tpu.parallel import batch_sharding, param_shardings as jshardings, replicated
    from gdkvm_tpu.train.loop import TrainState, make_optimizer, make_train_step
    from gdkvm_tpu_torch.io.convert import state_dict_from_flax

    mesh = _jax_mesh()
    jcfg = jload_config(None, H.STEP)
    tx = make_optimizer(jcfg)
    state = TrainState(step=jnp.zeros((), jnp.int32),
                       params=jax.device_put(params, jshardings(mesh, params)),
                       opt_state=jax.device_put(tx.init(params), replicated(mesh)),
                       rng=jax.device_put(jax.random.PRNGKey(0), replicated(mesh)))
    z = np.load(os.path.join(root, "batch_32.npz"))
    batch = jax.device_put(JBatch(frames=z["frames"], masks=z["masks"], valid=z["valid"]),
                           batch_sharding(mesh))
    step = jax.jit(make_train_step(jmodel, tx, jcfg))
    out = []
    with mesh:
        for _ in range(R.STEPS):
            state, m = step(state, batch)
            out.append((float(m["loss"]), float(m["grad_norm"])))
    return out, state_dict_from_flax(jax.tree.map(np.asarray, jax.device_get(state.params)),
                                     R.step_cfg().model)


def _one_steps(root):
    """The same two steps in one process on the whole batch: (loss, grad
    norm) a step."""
    from gdkvm_tpu_torch.config.schema import load_config
    from gdkvm_tpu_torch.data.pipeline import Batch
    from gdkvm_tpu_torch.train.loop import state_for, train_step
    cfg = load_config(None, H.STEP)
    state = state_for(cfg, R.tiny_model(root))
    z = np.load(os.path.join(root, "batch_32.npz"))
    batch = Batch(*(torch.from_numpy(z[k]) for k in ("frames", "masks", "valid")))
    return [(float(m["loss"]), float(m["grad_norm"]))
            for m in (train_step(state, batch, cfg) for _ in range(R.STEPS))]


def _jax_evaluate(jmodel, params, root):
    from gdkvm_tpu.config.schema import load_config as jload_config
    from gdkvm_tpu.eval.evaluator import evaluate as jevaluate
    jcfg = jload_config(None, R.TINY + R.EVAL + [f"data.data_path={root}/data",
                                                 f"runtime.run_dir={root}/eval_jax"])
    return jevaluate(jcfg, jmodel, params, _jax_mesh())


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The one-process run, the four ranks, the references meanwhile."""
    root = str(tmp_path_factory.mktemp("heads"))
    jmodel, params, _ = _write_inputs(root)
    _write_batch(root)
    refs = {"run1": train(H.run_cfg(root, os.path.join(root, "run1"), mesh=False),
                          device="cpu")}
    env = dict(os.environ, WORLD_SIZE=str(WORLD), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), GDKVM_DIST_TIMEOUT="60",
               PYTHONPATH=os.pathsep.join([REPO, os.path.join(REPO, "tests")]),
               OMP_NUM_THREADS="1")
    script = os.path.join(REPO, "tests", "torch_head_ranks.py")
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, script, root], cwd=REPO,
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    try:
        refs["jax_steps"] = _jax_steps(jmodel, params, root)
        refs["one_steps"] = _one_steps(root)
        refs["jax_eval"] = _jax_evaluate(jmodel, params, root)
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
    out = [json.load(open(os.path.join(root, f"rank{r}.json"))) for r in range(WORLD)]
    # One process resumed from the 2x2 run's step 2.
    resumed = os.path.join(root, "run1_from2")
    os.makedirs(os.path.join(resumed, "checkpoints"))
    shutil.copy(os.path.join(root, "run2", "checkpoints", "step_00000002.pt"),
                os.path.join(resumed, "checkpoints"))
    refs["run1_from2"] = train(H.run_cfg(root, resumed, mesh=False,
                                         **{"runtime.resume": "true"}), device="cpu")
    return root, out, refs


def _shards(root, rank):
    return torch.load(os.path.join(root, f"params_a_rank{rank}.pt"), weights_only=True)


def test_head_ranks_sit_row_major(ranks):
    """Rank r sits at data position r // 2 and model position r % 2."""
    _, out, _ = ranks
    assert [o["place"] for o in out] == [[0, 0], [0, 1], [1, 0], [1, 1]]


def test_head_parallel_steps_match_jax_2x2(ranks):
    """Two steps at data 2 × model 2 equal JAX's step jitted over its 2x2
    mesh: the losses at rtol 1e-5, the gathered parameters at rtol 2e-4 /
    atol 2e-5 (tests/test_sharding.py's bar); every rank logs the same
    norm, one process's at rtol 1e-5 (the tiny model's norm is ~1e-3 off
    JAX's in one process too: its narrow decoder branches carry fp32 noise
    in their gradients); the replicated parameters are bitwise equal on all
    four ranks, and each shard on the two data positions."""
    root, out, refs = ranks
    want_steps, want = refs["jax_steps"]
    for o in out:
        np.testing.assert_allclose(o["a"], [w[0] for w in want_steps], rtol=1e-5)
        np.testing.assert_allclose(o["a_norm"], [w[1] for w in refs["one_steps"]], rtol=1e-5)
        assert o["a_norm"] == out[0]["a_norm"]
    shards = [_shards(root, r) for r in range(WORLD)]
    dims = param_shardings(2, want)
    for name in want:
        for r in range(1, WORLD):
            ref = 0 if dims[name] is None else r % 2
            assert torch.equal(shards[r][name], shards[ref][name]), (name, r)
    got = gather_state_dicts(shards[:2])
    assert any(d is not None for d in dims.values())
    for name, w in want.items():
        assert got[name].shape == w.shape, name
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=2e-4, atol=2e-5,
                                   err_msg=name)


def _same_run(d1, d2, metrics1, metrics2):
    """Two runs of the same steps agree: logged losses and norms at rtol
    1e-5, identical batch checksums, the step-4 parameters, EMA and AdamW
    moments, the returned metrics."""
    rows1, rows2 = _rows(d1), _rows(d2)
    steps = [r["step"] for r in rows2 if "loss" in r]
    want = {r["step"]: r for r in rows1 if "loss" in r}
    assert steps and all(s in want for s in steps)
    for r in (r for r in rows2 if "loss" in r):
        a = want[r["step"]]
        assert r["batch_checksum"] == a["batch_checksum"]
        for k in ("loss", "ce", "dice_loss", "grad_norm"):
            np.testing.assert_allclose(r[k], a[k], rtol=1e-5, err_msg=k)
        assert a["grad_norm"] > H.CLIP["train.grad_clip"]          # the clip bit
    t1, t2 = _ckpt(d1), _ckpt(d2)
    assert t1["step"] == t2["step"] == R.RUN_STEPS and torch.equal(t1["gen"], t2["gen"])
    for name, w in t1["model"].items():
        np.testing.assert_allclose(t2["model"][name].numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=name)
    for group in ("exp_avg", "exp_avg_sq"):
        for a, b in zip(t2["opt"][group], t1["opt"][group]):
            assert a.shape == b.shape
            assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max()), group
    for a, b in zip(t2["ema"], t1["ema"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-7)
    for k, v in _untimed(metrics1).items():
        np.testing.assert_allclose(metrics2[k], v, rtol=1e-5, atol=1e-7, err_msg=k)


def test_head_parallel_train_matches_one_process(ranks):
    """train() at 2x2 equals one process: the logged grad norm, with a
    clip that bites, at rtol 1e-5, the same batches, whole checkpoints
    equal to the one process's, the same files written once (by rank 0),
    and every rank returns the same metrics."""
    root, out, refs = ranks
    d1, d2 = os.path.join(root, "run1"), os.path.join(root, "run2")
    assert _files(d2) == _files(d1)
    _same_run(d1, d2, refs["run1"], out[0]["run"])
    assert all(_untimed(o["run"]) == _untimed(out[0]["run"]) for o in out)


@pytest.mark.parametrize("case", ["2x2-from-1x1", "1x1-from-2x2"])
def test_head_parallel_resume_across_layouts(ranks, case):
    """A checkpoint holds whole tensors: the 2x2 ranks resume from the one
    process's step 2 and one process resumes from the 2x2 run's, and each
    reaches the unbroken run's step 4."""
    root, out, refs = ranks
    if case == "2x2-from-1x1":
        _same_run(os.path.join(root, "run1"), os.path.join(root, "run2_from1"),
                  refs["run1"], out[0]["run_from1"])
    else:
        _same_run(os.path.join(root, "run2"), os.path.join(root, "run1_from2"),
                  out[0]["run"], refs["run1_from2"])


def test_head_parallel_evaluate_matches_jax_mesh(ranks):
    """evaluate at 2x2 equals JAX's on make_mesh(data=2, model=2): the odd
    last clip dropped, each data position's frames counted once."""
    root, out, refs = ranks
    want = refs["jax_eval"]
    assert all(o["eval"] == out[0]["eval"] for o in out)
    got = out[0]["eval"]
    from gdkvm_tpu_torch.data.packed import PackedDataset
    val = PackedDataset(os.path.join(root, "data", "val.pck"))
    assert got["frames"] == want["frames"] == sum(val[i][2].sum() for i in range(VAL_CLIPS - 1))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-6, atol=1e-9, err_msg=k)
    assert sorted(os.listdir(os.path.join(root, "eval2", "vis"))) == \
        sorted(os.listdir(os.path.join(root, "eval_jax", "vis")))
