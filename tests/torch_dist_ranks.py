"""The rank side of tests/test_torch_distributed.py: what each process of a
two-rank gloo group runs, and the settings the test's one-process
references share with it.  Imports torch and the port only, so that a rank
starts in a few seconds.

    RANK=r WORLD_SIZE=2 MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/torch_dist_ranks.py ROOT

ROOT holds the inputs the test wrote (``weights.pt``, ``batch_a.npz``,
``batch_b.npz``, the packed split ``data/``); each rank writes
``rank{r}.json`` and its tensors there, and rank 0 the run dirs.
"""

import json
import os
import shutil
import sys

import numpy as np
import torch

from gdkvm_tpu_torch.config.schema import load_config
from gdkvm_tpu_torch.data.pipeline import Batch
from gdkvm_tpu_torch.eval.evaluator import evaluate
from gdkvm_tpu_torch.models.gdkvm import GDKVM
from gdkvm_tpu_torch.parallel import distributed
from gdkvm_tpu_torch.parallel.mesh import batch_slice
from gdkvm_tpu_torch.train.loop import state_for, train, train_step

# The tiny fp32 model and batch of tests/test_multihost.py.
TINY = ["data.image_size=16", "data.clip_len=2", "train.batch_size=4",
        "model.enc_channels=[4,8,12,16]", "model.enc_blocks=[1,1,1,1]",
        "model.num_heads=2", "model.head_dim_k=8", "model.head_dim_v=8",
        "model.kpff_channels=[12,8,4]", "model.compute_dtype=float32"]
# Two steps, the second at the peak rate; every prompt bit 1 where frame 0
# has ground truth, so the JAX package's draws and the port's agree.
STEP = TINY + ["train.warmup_iterations=1", "train.prompt_prob=1.0"]
STEPS = 2
EVAL = ["data.dataset=packed", "data.image_size=32", "data.num_workers=2",
        "eval_stage.hd95=true", "eval_stage.num_vis=3", "eval_stage.wandb_mode=disabled"]
RUN_STEPS = 4


def step_cfg():
    return load_config(None, STEP)


def run_cfg(root: str, kind: str, run_dir: str, **over):
    """A 4-step run of the tiny model at 32² with the eval stage and a
    checkpoint every 2 steps, EMA on: ``cache`` from the device cache of the
    synthetic split, ``host`` through the host iterator over the packed
    split with two micro-steps an update.  (At 16² the decoder's 1/16
    branch is one pixel, its GroupNorm's output 0 and its gradient fp32
    noise, which Adam turns into steps that differ from run to run.)"""
    data = (["data.dataset=synthetic", "data.device_cache=on"] if kind == "cache" else
            ["data.dataset=packed", f"data.data_path={root}/data",
             "data.device_cache=off", "data.num_workers=2", "train.accum_steps=2"])
    cfg = load_config(None, TINY + data + [
        "data.image_size=32", "train.num_iterations=4", "train.warmup_iterations=1",
        "train.log_every=1", "train.eval_every=2", "train.checkpoint_every=2", "train.ema_decay=0.9",
        "eval_stage.num_vis=2", "eval_stage.wandb_mode=disabled",
        f"runtime.run_dir={run_dir}"] + [f"{k}={v}" for k, v in over.items()])
    return cfg


def eval_cfg(root: str, run_dir: str):
    """The packed val split (odd-sized, 32²) with HD95 and 3 overlays."""
    return load_config(None, TINY + EVAL + [f"data.data_path={root}/data",
                                            f"runtime.run_dir={run_dir}"])


def tiny_model(root: str) -> GDKVM:
    cfg = step_cfg()
    model = GDKVM(cfg.model, device="cpu")
    model.load_state_dict(torch.load(os.path.join(root, "weights.pt"), weights_only=True))
    return model


def steps(root: str, case: str):
    """STEPS train steps of the tiny model on batch ``case``, this rank's
    rows of it → (the losses, the parameters after them)."""
    cfg = step_cfg()
    state = state_for(cfg, tiny_model(root))
    z = np.load(os.path.join(root, f"batch_{case}.npz"))
    rows = batch_slice(distributed.rank(), z["frames"].shape[0])
    batch = Batch(*(torch.from_numpy(z[k][rows]) for k in ("frames", "masks", "valid")))
    losses = [float(train_step(state, batch, cfg)["loss"]) for _ in range(STEPS)]
    return losses, {k: v.detach().clone() for k, v in state.model.state_dict().items()}


def main(root: str) -> None:
    torch.set_num_threads(1)
    assert distributed.maybe_initialize_distributed(device="cpu")
    rank = distributed.rank()
    out = {"info": distributed.process_info(),
           "backend": torch.distributed.get_backend()}
    for case in ("a", "b"):
        out[case], params = steps(root, case)
        torch.save(params, os.path.join(root, f"params_{case}_rank{rank}.pt"))
    for kind in ("cache", "host"):
        out[f"run_{kind}"] = train(run_cfg(root, kind, os.path.join(root, f"run2_{kind}")),
                                   device="cpu")
    resumed = os.path.join(root, "run2_resumed")
    if rank == 0:
        os.makedirs(os.path.join(resumed, "checkpoints"))
        shutil.copy(os.path.join(root, "run2_cache", "checkpoints", "step_00000002.pt"),
                    os.path.join(resumed, "checkpoints"))
    distributed.barrier("resume copy")
    out["run_resumed"] = train(run_cfg(root, "cache", resumed, **{"runtime.resume": "true"}),
                               device="cpu")
    with torch.inference_mode():
        out["eval"] = evaluate(eval_cfg(root, os.path.join(root, "eval2")), tiny_model(root),
                               "cpu")
    with open(os.path.join(root, f"rank{rank}.json"), "w") as fh:
        json.dump(out, fh)
    distributed.shutdown()


if __name__ == "__main__":
    main(sys.argv[1])
