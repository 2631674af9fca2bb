"""The rank side of tests/test_torch_head_parallel_dist.py: what each process
of a four-rank gloo group laid out as a data 2 × model 2 mesh runs (the
LKVA heads of the tiny model split over each pair of ranks), and the
settings the test's one-process references share with it.  Imports torch
and the port only.

    RANK=r WORLD_SIZE=4 MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/torch_head_ranks.py ROOT

ROOT holds the inputs the test wrote (``weights.pt``, ``batch_32.npz``,
the packed split ``data/``, the one-process run ``run1/`` whose step-2
checkpoint the ranks resume from); each rank writes ``rank{r}.json`` and
its shard's tensors there, and rank 0 the run dirs.
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
from gdkvm_tpu_torch.parallel.mesh import batch_slice, make_mesh, shard_state_dict
from gdkvm_tpu_torch.train.loop import state_for, train, train_step

import torch_dist_ranks as R

MESH = {"parallel.data_axis": 2, "parallel.model_axis": 2}
# A clip that bites at every step of the tiny model (its norms are ~0.1-1).
CLIP = {"train.grad_clip": 0.01}
# The two-step check at 32², as PR 9's whole runs: at 16² the decoder's
# 1/16 branch is one pixel, and its gradient fp32 noise that Adam turns
# into steps of its own on every summation order.
STEP = R.STEP + ["data.image_size=32"]


def run_cfg(root: str, run_dir: str, mesh: bool = True, **over):
    """PR 9's 4-step run of the tiny model from the device cache, with the
    clip above; on the 2x2 mesh unless ``mesh`` is False."""
    return R.run_cfg(root, "cache", run_dir, **CLIP, **(MESH if mesh else {}), **over)


def shard_model(root: str, mesh) -> GDKVM:
    """The tiny model's head shard of this rank, from root/weights.pt."""
    model = GDKVM(R.step_cfg().model, device="cpu", heads=mesh.heads,
                  model_group=mesh.model_group)
    whole = torch.load(os.path.join(root, "weights.pt"), weights_only=True)
    model.load_state_dict(shard_state_dict(whole, *mesh.heads))
    return model


def steps(root: str, mesh):
    """R.STEPS train steps of the shard on this data position's rows of
    the 32² batch → (the losses, the grad norms, the shard's parameters)."""
    cfg = load_config(None, STEP)
    state = state_for(cfg, shard_model(root, mesh), mesh)
    z = np.load(os.path.join(root, "batch_32.npz"))
    rows = batch_slice(mesh, z["frames"].shape[0])
    batch = Batch(*(torch.from_numpy(z[k][rows]) for k in ("frames", "masks", "valid")))
    metrics = [train_step(state, batch, cfg) for _ in range(R.STEPS)]
    return ([float(m["loss"]) for m in metrics], [float(m["grad_norm"]) for m in metrics],
            {k: v.detach().clone() for k, v in state.model.state_dict().items()})


def main(root: str) -> None:
    torch.set_num_threads(1)
    assert distributed.maybe_initialize_distributed(device="cpu")
    rank = distributed.rank()
    mesh = make_mesh(2, 2)
    out = {"place": [mesh.index, mesh.model_index]}
    out["a"], out["a_norm"], params = steps(root, mesh)
    torch.save(params, os.path.join(root, f"params_a_rank{rank}.pt"))
    out["run"] = train(run_cfg(root, os.path.join(root, "run2")), device="cpu")
    resumed = os.path.join(root, "run2_from1")
    if rank == 0:
        os.makedirs(os.path.join(resumed, "checkpoints"))
        shutil.copy(os.path.join(root, "run1", "checkpoints", "step_00000002.pt"),
                    os.path.join(resumed, "checkpoints"))
    distributed.barrier("resume copy")
    out["run_from1"] = train(run_cfg(root, resumed, **{"runtime.resume": "true"}),
                             device="cpu")
    with torch.inference_mode():
        out["eval"] = evaluate(R.eval_cfg(root, os.path.join(root, "eval2")),
                               shard_model(root, mesh), "cpu", mesh=mesh)
    with open(os.path.join(root, f"rank{rank}.json"), "w") as fh:
        json.dump(out, fh)
    distributed.shutdown()


if __name__ == "__main__":
    main(sys.argv[1])
