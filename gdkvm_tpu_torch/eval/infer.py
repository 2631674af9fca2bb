"""File-to-masks inference: run a trained model on a cine file (port of
gdkvm_tpu/eval/infer.py).

Inputs: an EchoNet-style ``.avi`` / ``.mp4`` (OpenCV), a directory of frame
PNGs (a clip of the processed CAMUS layout; PIL), or a raw CAMUS MetaImage
``.mhd`` half sequence.  Inference is chunked streaming with the memory
state carried, on the model's device, or through an exported artifact
(io/export.py) on the device it was exported for; each chunk goes up in one
copy (through pinned memory and without blocking on a card).  Outputs are
``masks.npz``, optional overlay PNGs (eval/vis.py) and ``infer.json``.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from gdkvm_tpu_torch.eval.metrics import mask_from_logits
from gdkvm_tpu_torch.eval.streaming import _stage, model_device
from gdkvm_tpu_torch.io.export import ServingModel, load_artifact, read_meta
from gdkvm_tpu_torch.models.gdkvm import GDKVM
from gdkvm_tpu_torch.ops.preproc import resize_matrices, resize_normalize
from gdkvm_tpu_torch.utils.optional import require_cv2, require_pil


def load_frames(path: str, image_size: int,
                host_resize: bool = True) -> np.ndarray:
    """Decode any supported cine source → (F, H, W, 1) uint8.

    ``host_resize=False`` keeps the decoded resolution (the host only
    decodes); the model step then resizes on the device
    (:func:`infer_video_model` with ``model_size``).
    """
    if os.path.isdir(path):
        Image = require_pil("load_frames of a directory of frames")
        names = sorted(n for n in os.listdir(path)
                       if n.lower().endswith((".png", ".jpg", ".jpeg")))
        if not names:
            raise FileNotFoundError(f"no image frames in {path}")
        frames = []
        for n in names:
            img = Image.open(os.path.join(path, n)).convert("L")
            if host_resize and img.size != (image_size, image_size):
                img = img.resize((image_size, image_size))
            frames.append(np.asarray(img, np.uint8))
        return np.stack(frames)[..., None]
    if path.lower().endswith((".avi", ".mp4")):
        cv2 = require_cv2("load_frames of a video file")
        cap = cv2.VideoCapture(path)
        frames = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            if frame.ndim == 3:
                frame = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
            if host_resize and frame.shape[:2] != (image_size, image_size):
                frame = cv2.resize(frame, (image_size, image_size),
                                   interpolation=cv2.INTER_AREA)
            frames.append(frame)
        cap.release()
        if not frames:
            raise IOError(f"failed to decode {path}")
        return np.stack(frames)[..., None]
    if path.lower().endswith(".mhd"):
        from gdkvm_tpu_torch.data.camus_raw import _resize_stack, read_mhd
        vol, _ = read_mhd(path)                       # (F, H, W)
        if host_resize:
            vol = _resize_stack(vol, image_size, is_mask=False)
        return vol.astype(np.uint8)[..., None]
    raise ValueError(f"unsupported input {path!r} (want .avi/.mp4, .mhd, "
                     f"or a directory of PNG frames)")


@torch.inference_mode()
def infer_video_model(model: GDKVM, frames: np.ndarray, chunk: int = 16,
                      model_size: Optional[int] = None) -> np.ndarray:
    """Chunked streaming inference with the in-process model, on its device.

    frames: (F, H, W, 1) uint8 → (F, h, w) uint8 argmax masks, the state
    carried from chunk to chunk; a ragged last chunk is padded with zero
    frames and cut.  When the frames are not at ``model_size`` (decoded at
    their own resolution), they are resized and normalized on the device
    (ops/preproc.py) and the masks come back at the model's resolution.
    """
    device = model_device(model)
    src_hw = tuple(frames.shape[1:3])
    mats = None
    if model_size is not None and src_hw != (model_size, model_size):
        mats = resize_matrices(src_hw, (model_size, model_size), device)
    masks = []
    state = None
    for lo in range(0, frames.shape[0], chunk):
        part = frames[lo:lo + chunk]
        t = part.shape[0]
        if t < chunk:
            part = np.pad(part, ((0, chunk - t), (0, 0), (0, 0), (0, 0)))
        (dev,) = _stage(device, part)
        if mats is not None:
            x = resize_normalize(dev[None], (model_size, model_size), matrices=mats)
        else:
            x = dev[None].to(torch.float32) / 255.0
        logits, state = model(x, state)
        masks.append(mask_from_logits(logits[0])[:t])
    return torch.cat(masks).cpu().numpy()         # the one fetch


def infer_video_artifact(artifact: str | ServingModel,
                         frames: np.ndarray) -> np.ndarray:
    """Chunked streaming inference through an exported artifact (its
    directory, loaded where it was exported, or a loaded ServingModel) of
    batch 1, at the size it was exported for: (F, H, W, 1) uint8 → (F, H,
    W) uint8 argmax masks; a ragged last chunk is padded with zero frames
    and cut."""
    sm = load_artifact(artifact) if isinstance(artifact, str) else artifact
    if sm.batch != 1:
        raise ValueError(f"infer needs a batch-1 artifact, got {sm.batch}")
    sig_hw = tuple(sm.meta["signature"]["frames_u8"][2:4])
    if frames.shape[1:3] != sig_hw:
        raise ValueError(
            f"frames are {frames.shape[1:3]} but the artifact was exported "
            f"for {sig_hw} — decode with the artifact's image size "
            f"(gdkvm infer does this automatically)")
    chunk = sm.chunk
    mem, seen = sm.init_state()
    masks = []
    for lo in range(0, frames.shape[0], chunk):
        part = frames[lo:lo + chunk]
        t = part.shape[0]
        if t < chunk:
            part = np.pad(part, ((0, chunk - t), (0, 0), (0, 0), (0, 0)))
        (dev,) = _stage(sm.device, part)
        logits, mem, seen = sm.step(dev[None], mem, seen)
        masks.append(mask_from_logits(logits[0])[:t])
    return torch.cat(masks).cpu().numpy()         # the one fetch


def artifact_image_size(art_dir: str) -> int:
    """Input H (= W) the artifact was exported for (from meta.json)."""
    return int(read_meta(art_dir)["signature"]["frames_u8"][2])


def run_inference(frames: np.ndarray, out_dir: str, *, model: Optional[GDKVM] = None,
                  artifact: Optional[str | ServingModel] = None, chunk: int = 16,
                  overlay_every: int = 0,
                  model_size: Optional[int] = None) -> dict:
    """Infer masks and write ``masks.npz`` (and overlay PNGs every
    ``overlay_every`` frames, and ``infer.json``); returns the summary.
    ``model``'s parameters are the ones to run, or ``artifact``'s program
    (:func:`infer_video_artifact`).  ``model_size``: set when the frames
    are at their decoded resolution, to resize on the device."""
    from gdkvm_tpu_torch.eval.vis import overlay as make_overlay

    if artifact is not None:
        masks = infer_video_artifact(artifact, frames)
    else:
        masks = infer_video_model(model, frames, chunk=chunk,
                                  model_size=model_size)
    os.makedirs(out_dir, exist_ok=True)
    np.savez_compressed(os.path.join(out_dir, "masks.npz"), masks=masks)
    n_overlays = 0
    if overlay_every > 0:
        Image = require_pil("run_inference with overlay_every > 0")
        ov_dir = os.path.join(out_dir, "overlays")
        os.makedirs(ov_dir, exist_ok=True)
        mh, mw = masks.shape[1:3]
        for t in range(0, frames.shape[0], overlay_every):
            fr = frames[t]
            if fr.shape[:2] != (mh, mw):      # frames at their own size: match the mask
                fr = np.asarray(Image.fromarray(fr[..., 0]).resize(
                    (mw, mh)), np.uint8)[..., None]
            img = make_overlay(fr, masks[t])
            Image.fromarray(img).save(
                os.path.join(ov_dir, f"frame_{t:05d}.png"))
            n_overlays += 1
    summary = {
        "frames": int(frames.shape[0]),
        "classes_present": sorted(int(c) for c in np.unique(masks)),
        "foreground_fraction": float((masks > 0).mean()),
        "out": out_dir,
        "overlays": n_overlays,
    }
    with open(os.path.join(out_dir, "infer.json"), "w") as fp:
        json.dump(summary, fp, indent=1)
    return summary
