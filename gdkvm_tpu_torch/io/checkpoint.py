"""Checkpoints of a training run, keyed by step (port of
gdkvm_tpu/io/checkpoint.py on ``torch.save``).

A checkpoint holds what an exact resume needs: the model's ``state_dict``,
the optimizer's moments and counts (``Optimizer.state_dict``: AdamW's
``exp_avg``/``exp_avg_sq``/``step`` per parameter, the applied-update
count, the accumulation buffer and ``mini_step``), the EMA shadow, the
micro-step count and the state of the prompt-bit generator.  The data
stream needs nothing: it is a pure function of the seeds and the step
(data/pipeline.py, data/device_cache.py).

``save`` snapshots the state to the CPU on the calling thread and writes
the file on a background thread (``wait`` joins it), to a temporary name
that ``os.replace`` then moves into place, so a killed run leaves no
half-written checkpoint.  Files load with ``torch.load(weights_only=True)``:
they hold tensors, numbers, lists and dicts only.

A checkpoint is layout-free: it holds whole tensors whatever mesh wrote it.
In a process group every data position holds the same state, so rank 0
alone writes; a head shard's parameters, AdamW moments, accumulation buffer
and EMA are first gathered whole over its model group (data position 0's
ranks).  Rank 0 waits for the file, and every rank then meets the others at
a barrier, so no rank runs ahead of a checkpoint that is not yet on disk.
Every rank restores, each slicing out its model position's shard, so a run
at any ``data × model`` mesh resumes one written at any other.
"""

from __future__ import annotations

import os
import re
import threading
from typing import Any, Callable, Dict, List, Optional

import torch

from gdkvm_tpu_torch.parallel import distributed
from gdkvm_tpu_torch.parallel.mesh import gather_shard, head_dim

_NAME = re.compile(r"^step_(\d+)\.pt$")


def _heads(state) -> int:
    return 1 if state.mesh is None else state.mesh.model


def _tree(state, place: Callable[[Any, Optional[int]], Any]) -> Dict[str, Any]:
    """The checkpoint tree of a ``TrainState`` (train/loop.py), each tensor
    of a parameter's shape passed through ``place(t, dim)``, ``dim`` the
    dim its head shard splits (None where the tensor is whole)."""
    m_axis = _heads(state)
    dim = lambda name: head_dim(name) if m_axis > 1 else None
    dims = [dim(n) for n, _ in state.model.named_parameters()]
    per_param = lambda v: [place(t, d) for t, d in zip(v, dims)]
    return {
        "step": int(state.step),
        "model": {k: place(v, dim(k)) for k, v in state.model.state_dict().items()},
        "opt": {k: (per_param(v) if isinstance(v, list) and k != "adam_step" else v)
                for k, v in state.opt.state_dict().items()},
        "ema": None if state.ema is None else per_param(state.ema),
        "gen": state.gen.get_state().clone(),
    }


def state_tree(state) -> Dict[str, Any]:
    """The checkpoint tree of a ``TrainState``, its tensors detached, whole
    and copied to the CPU: a head shard's are gathered over its model group
    (a collective call of the group)."""
    def place(t, d):
        if d is not None:
            t = gather_shard(t.detach(), d, state.mesh)
        return t.detach().to("cpu", copy=True)
    return _tree(state, place)


def _describe(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """Flat {path: (shape, dtype) | type name} of a checkpoint tree."""
    if isinstance(tree, dict):
        out: Dict[str, Any] = {}
        for k, v in tree.items():
            out.update(_describe(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {f"{prefix}/#": len(tree)}
        for i, v in enumerate(tree):
            out.update(_describe(v, f"{prefix}/{i}"))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix: (tuple(tree.shape), str(tree.dtype))}
    return {prefix: "none" if tree is None else "scalar"}


class CheckpointManager:
    """Saves ``TrainState`` trees by step under ``directory``, keeps the
    newest ``max_to_keep``, restores into a template state."""

    def __init__(self, directory: str, max_to_keep: int = 3) -> None:
        self._dir = os.path.abspath(directory)
        if distributed.is_main_process():
            os.makedirs(self._dir, exist_ok=True)
        self._max_to_keep = max_to_keep
        self._pending: List[threading.Thread] = []
        self._error: Optional[BaseException] = None

    def _path(self, step: int) -> str:
        return os.path.join(self._dir, f"step_{step:08d}.pt")

    def all_steps(self) -> List[int]:
        if not os.path.isdir(self._dir):       # another rank makes it
            return []
        return sorted(int(m.group(1)) for m in
                      (_NAME.match(f) for f in os.listdir(self._dir)) if m)

    def save(self, step: int, state, force: bool = False) -> None:
        """Write ``state`` as step ``step``; an existing checkpoint of that
        step is kept unless ``force``.  In a process group: rank 0 writes
        and waits for the file, then every rank meets at a barrier."""
        self.wait()
        if distributed.world_size() > 1:
            # Data position 0's ranks gather the head shards for rank 0.
            tree = (state_tree(state) if _heads(state) > 1 and state.mesh.index == 0
                    else None)
            if distributed.is_main_process():
                self._save(step, tree or state_tree(state), force)
                self.wait()
            distributed.barrier(f"checkpoint step {step}")
            return
        self._save(step, state_tree(state), force)

    def _save(self, step: int, tree: Dict[str, Any], force: bool) -> None:
        if os.path.exists(self._path(step)) and not force:
            return

        def write() -> None:
            try:
                tmp = self._path(step) + f".tmp{os.getpid()}"
                torch.save(tree, tmp)
                os.replace(tmp, self._path(step))
                if self._max_to_keep > 0:
                    for old in self.all_steps()[:-self._max_to_keep]:
                        os.remove(self._path(old))
            except BaseException as exc:     # re-raised by wait()
                self._error = exc

        thread = threading.Thread(target=write, daemon=True)
        thread.start()
        self._pending.append(thread)

    def wait(self) -> None:
        """Block until every started write is on disk; re-raise its error."""
        for thread in self._pending:
            thread.join()
        self._pending.clear()
        if self._error is not None:
            exc, self._error = self._error, None
            raise exc

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, state_template, step: Optional[int] = None):
        """Load step ``step`` (default: the latest) into ``state_template``
        (a ``TrainState`` built from the run's config) in place, on the
        template's device, and return it; a head shard's template takes its
        slice of each whole tensor.  A tree that does not match the
        template's (other widths, EMA on one side only) raises ValueError."""
        self.wait()
        step = self.latest_step() if step is None else step
        if step is None or not os.path.exists(self._path(step)):
            raise FileNotFoundError(f"no checkpoint under {self._dir}")
        tree = torch.load(self._path(step), map_location="cpu", weights_only=True)
        m_axis = _heads(state_template)

        def whole(t, d):
            shape = list(t.shape)
            if d is not None:
                shape[d] *= m_axis
            return torch.empty(shape, dtype=t.dtype, device="meta")
        want, got = _describe(_tree(state_template, whole)), _describe(tree)
        if want != got:
            # The model's own leaves first: the optimizer's and the EMA's
            # repeat them.
            keys = sorted((k for k in set(want) | set(got) if want.get(k) != got.get(k)),
                          key=lambda k: (not k.startswith("model/"), k))
            detail = "; ".join(f"{k}: checkpoint {got.get(k, 'absent')}, template "
                               f"{want.get(k, 'absent')}" for k in keys[:8])
            raise ValueError(
                f"checkpoint at {self._dir} step {step} does not match the "
                f"restore template (state tree mismatch). Common causes: "
                f"(a) the run used another model config (e.g. "
                f"model.enc_stem, widths, gdr_variant) — pass the original "
                f"values; (b) train.ema_decay or train.accum_steps differs "
                f"from the training run — the EMA shadow and the "
                f"accumulation buffer are part of the checkpoint tree, so "
                f"scoring/resume must use the same values (0 ↔ >0 changes "
                f"the tree). Differences ({len(keys)}): {detail}")
        if m_axis > 1:
            # The template's layout (each tensor's split dim) picks the
            # slice of each saved tensor.
            m = state_template.mesh.model_index
            dims = _tree(state_template, lambda t, d: d)

            def own(t, d):
                return t if d is None else t.chunk(m_axis, d)[m].contiguous()
            tree = dict(tree,
                        model={k: own(v, dims["model"][k]) for k, v in tree["model"].items()},
                        opt={k: ([own(t, d) for t, d in zip(v, dims["opt"][k])]
                                 if isinstance(v, list) and k != "adam_step" else v)
                             for k, v in tree["opt"].items()},
                        ema=None if tree["ema"] is None else
                        [own(t, d) for t, d in zip(tree["ema"], dims["ema"])])
        state_template.model.load_state_dict(tree["model"], strict=True)
        state_template.opt.load_state_dict(tree["opt"])
        if tree["ema"] is not None:
            with torch.no_grad():
                for e, saved in zip(state_template.ema, tree["ema"]):
                    e.copy_(saved)
        state_template.gen.set_state(tree["gen"])
        state_template.step = int(tree["step"])
        return state_template

    def close(self) -> None:
        self.wait()
