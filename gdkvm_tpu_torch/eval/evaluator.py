"""Eval stage of a training run: the val split's Dice, overlay PNGs and,
on request, HD95 (port of gdkvm_tpu/eval/evaluator.py).

The val split goes once through ``batch_iterator(loop=False,
drop_last=False)`` and the prefetcher; each batch runs forward under
``torch.inference_mode()`` (entered here, so a caller in grad mode, like
the training loop, gets its graph back afterwards), Dice partial sums are
added on the device and fetched once at the end of the pass.

In a process group (parallel/distributed.py) the clips are split over the
data positions of the mesh as the JAX package splits them over its
``data`` axis: each eval batch holds a multiple of the data axis, each
rank runs its data position's rows (with its model group, through its head
shard, where the model axis is > 1), the Dice sums are summed over its
data group and the HD95 values and the overlays' frames are gathered over
it (``all_gather_object``), so each data position counts once; rank 0
writes the overlays.  Every rank returns the same scores.
"""

from __future__ import annotations

import logging
import os
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch

from gdkvm_tpu_torch.config.schema import Config
from gdkvm_tpu_torch.data.pipeline import (batch_iterator, make_dataset,
                                           prefetch_to_device)
from gdkvm_tpu_torch.eval import metrics as M
from gdkvm_tpu_torch.eval.vis import save_vis
from gdkvm_tpu_torch.models.gdkvm import GDKVM
from gdkvm_tpu_torch.parallel import distributed
from gdkvm_tpu_torch.parallel.mesh import Mesh, process_mesh
from gdkvm_tpu_torch.utils.optional import has_pil


def evaluate(cfg: Config, model: GDKVM, device: torch.device | str,
             step: int = 0, mesh: Optional[Mesh] = None) -> Dict[str, float]:
    """Run the val split through ``model`` (whose parameters are the ones to
    score) on ``device``; returns per-class Dice, their foreground mean and
    the frame count, plus HD95 under ``eval_stage.hd95``.  Writes up to
    ``eval_stage.num_vis`` overlays into ``run_dir/vis`` when PIL is there.
    A missing val split is a warning and an empty result, not an error.
    ``mesh``: the process group's mesh (default: data-only over every
    rank); ``model`` is its model position's head shard."""
    device = torch.device(device)
    mesh = process_mesh(device) if mesh is None else mesh
    k = cfg.model.num_classes
    try:
        dataset = make_dataset(cfg.data, cfg.data.val_split, k)
    except FileNotFoundError as exc:
        # Loud, not silent: a mistyped data_path would otherwise train the
        # whole run with no eval and no signal.
        msg = (f"eval: val split {cfg.data.val_split!r} not found under "
               f"{cfg.data.data_path!r} ({exc}); SKIPPING evaluation — "
               f"check data_path / val_split")
        logging.getLogger("gdkvm").warning(msg)
        warnings.warn(msg, stacklevel=2)
        return {}

    # The eval batch tiles the data axis, and a ragged last batch that does
    # not split over it is dropped, as the JAX package drops it.
    world, rank, group = mesh.data, distributed.rank(), mesh.data_group
    bs = max(cfg.eval_stage.batch_size, world) // world * world
    drop_tail = (len(dataset) % bs) % world != 0
    hd_on = cfg.eval_stage.hd95
    vis_budget = cfg.eval_stage.num_vis if has_pil() else 0
    vis_dir = os.path.join(cfg.runtime.run_dir, "vis")

    it = batch_iterator(dataset, bs, shuffle=False, augment=False,
                        drop_last=drop_tail, loop=False,
                        num_workers=cfg.data.num_workers, shard=(mesh.index, world))
    acc = None
    vis_jobs: List[tuple] = []     # mid frames, their masks and preds, on the device
    hd_jobs: List[tuple] = []      # (preds, masks, valid) on the host
    with torch.inference_mode():
        for batch in prefetch_to_device(it, size=2, device=device):
            logits, _ = model(batch.frames.to(torch.float32) / 255.0)
            pred = logits.argmax(dim=-1)
            part = M.dice_sums(pred, batch.masks, batch.valid, k)
            acc = part if acc is None else M.dice_merge(acc, part)
            t_mid = pred.shape[1] // 2
            if len(vis_jobs) * bs < vis_budget:
                vis_jobs.append((batch.frames[:, t_mid], batch.masks[:, t_mid],
                                 pred[:, t_mid]))
            if hd_on:
                # Fetched per batch, so the predictions of a large val
                # split do not pile up on the device.
                hd_jobs.append(tuple(x.cpu().numpy() for x in
                                     (pred.to(torch.uint8), batch.masks, batch.valid)))
    if acc is None:
        return {}
    if group is not None:
        acc = dict(zip(acc, distributed.all_reduce_sum(list(acc.values()), group)))
    out = M.dice_finalize(acc)

    # Overlays of the first clips of the global order, written by rank 0.
    vis_jobs = [tuple(x.cpu().numpy() for x in job) for job in vis_jobs]
    if group is not None:
        shards = [None] * world
        torch.distributed.all_gather_object(shards, vis_jobs, group=group)
        vis_jobs = [tuple(np.concatenate(parts) for parts in zip(*jobs))
                    for jobs in zip(*shards)]
    vis_saved = 0
    for frames_h, masks_h, preds_h in (vis_jobs if rank == 0 else ()):
        for i in range(min(frames_h.shape[0], vis_budget - vis_saved)):
            save_vis(vis_dir, step, vis_saved, frames_h[i], preds_h[i], masks_h[i])
            vis_saved += 1
        if vis_saved >= vis_budget:
            break

    if hd_on and hd_jobs:
        # HD95 on the host over all valid frames, every rank's.
        if group is not None:
            shards = [None] * world
            torch.distributed.all_gather_object(shards, hd_jobs, group=group)
            hd_jobs = [job for jobs in shards for job in jobs]
        per_class: Dict[str, list] = {}
        n_inf = 0
        n_pairs = 0          # (frame, class) pairs where the class exists
        for pred_h, masks_h, valid_h in hd_jobs:
            b, t = valid_h.shape
            for i in range(b):
                for tt in range(t):
                    if valid_h[i, tt] <= 0:
                        continue
                    d = M.hd95(pred_h[i, tt], masks_h[i, tt].astype(np.int64), k)
                    for key, val in d.items():
                        n_pairs += 1
                        if np.isinf(val):
                            n_inf += 1
                        else:
                            per_class.setdefault(key, []).append(val)
        for key, vals in per_class.items():
            out[key] = float(np.mean(vals))
        if per_class:
            out["hd95_fg_mean"] = float(np.mean(
                [np.mean(v) for v in per_class.values()]))
        # Fraction of evaluated (frame, class) pairs where one side was
        # empty, so the distance is undefined.
        out["hd95_miss_frac"] = float(n_inf / max(n_pairs, 1))
    return out
