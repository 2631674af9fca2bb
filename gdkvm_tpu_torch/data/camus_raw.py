"""Raw CAMUS dataset support: MetaImage .mhd/.raw volumes (copy of
gdkvm_tpu/data/camus_raw.py).

Raw CAMUS ships one directory per patient with per-view half-cycle
sequences as MetaImage volumes:

    patient0001/
      patient0001_2CH_half_sequence.mhd/.raw        frames (T,H,W) uint8
      patient0001_2CH_half_sequence_gt.mhd/.raw     masks  (T,H,W) uint8
      (same for 4CH; plus single-frame ED/ES files)

This module holds a dependency-free MetaImage reader (a small ASCII header
and a raw blob) and a converter into the processed ``camus_png256x256_10f``
layout that data/camus.py reads: resize to 256×256, 10 frames sampled
uniformly across the half cycle.  PIL is imported when a frame is resized
or written.

CAMUS class ids: 0 background, 1 LV endocardium, 2 myocardium, 3 LA, the
loader's own convention.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np

from gdkvm_tpu_torch.utils.optional import require_pil

_MET_DTYPES = {
    "MET_UCHAR": np.uint8,
    "MET_CHAR": np.int8,
    "MET_USHORT": np.uint16,
    "MET_SHORT": np.int16,
    "MET_UINT": np.uint32,
    "MET_INT": np.int32,
    "MET_FLOAT": np.float32,
    "MET_DOUBLE": np.float64,
}


def read_mhd(path: str) -> Tuple[np.ndarray, Dict[str, str]]:
    """Read a MetaImage volume → (array in [T]HW order, header dict)."""
    header: Dict[str, str] = {}
    with open(path, "r", errors="ignore") as f:
        for line in f:
            if "=" not in line:
                continue
            key, val = line.split("=", 1)
            header[key.strip()] = val.strip()
    ndims = int(header.get("NDims", "3"))
    dims = [int(x) for x in header["DimSize"].split()]   # X Y [Z/T]
    dtype = _MET_DTYPES[header.get("ElementType", "MET_UCHAR")]
    if header.get("CompressedData", "False").lower() == "true":
        import zlib
        raw_name = header["ElementDataFile"]
        raw_path = os.path.join(os.path.dirname(path), raw_name)
        with open(raw_path, "rb") as rf:
            blob = zlib.decompress(rf.read())
        arr = np.frombuffer(blob, dtype=dtype)
    else:
        raw_name = header["ElementDataFile"]
        raw_path = os.path.join(os.path.dirname(path), raw_name)
        arr = np.fromfile(raw_path, dtype=dtype)
    # MetaImage is x-fastest: reshape as (dimN,...,dim1) = (T/Z, H, W).
    shape = tuple(reversed(dims[:ndims]))
    return arr.reshape(shape), header


def element_spacing(header: Dict[str, str]) -> Optional[Tuple[float, ...]]:
    """Physical voxel spacing from a MetaImage header, in the header's own
    x-fastest order (sx, sy[, sz/st]), millimetres.

    MetaImage spells it ``ElementSpacing`` (mm per voxel); some writers use
    ``ElementSize`` instead — same semantics for medical volumes.  Returns
    None when the header declares neither (the caller decides whether to
    fall back to pixel units)."""
    for key in ("ElementSpacing", "ElementSize"):
        if key in header:
            return tuple(float(x) for x in header[key].split())
    return None


def write_mhd(path: str, volume: np.ndarray,
              spacing: Optional[Tuple[float, ...]] = None) -> None:
    """Write a (T,H,W) uint8 MetaImage pair (testing / materialization).

    ``spacing``: optional physical voxel spacing (sx, sy[, st]) in mm —
    written as ElementSpacing exactly as raw CAMUS declares it."""
    base = os.path.splitext(os.path.basename(path))[0]
    raw_name = base + ".raw"
    t, h, w = volume.shape
    sp_line = ""
    if spacing is not None:
        vals = " ".join(f"{s:g}" for s in spacing)
        sp_line = f"ElementSpacing = {vals}\n"
    with open(path, "w") as f:
        f.write("ObjectType = Image\nNDims = 3\nBinaryData = True\n"
                "BinaryDataByteOrderMSB = False\nCompressedData = False\n"
                f"DimSize = {w} {h} {t}\n{sp_line}"
                "ElementType = MET_UCHAR\n"
                f"ElementDataFile = {raw_name}\n")
    volume.astype(np.uint8).tofile(os.path.join(os.path.dirname(path),
                                                raw_name))


def _resize_stack(vol: np.ndarray, size: int, is_mask: bool) -> np.ndarray:
    Image = require_pil("convert_raw_camus")
    out = np.empty((vol.shape[0], size, size), np.uint8)
    method = Image.NEAREST if is_mask else Image.BILINEAR
    for t in range(vol.shape[0]):
        img = Image.fromarray(vol[t].astype(np.uint8))
        out[t] = np.asarray(img.resize((size, size), method), np.uint8)
    return out


def official_camus_split(patient: str) -> str:
    """Fixed patient-number split of the 500-patient CAMUS release:
    0001-0400 train, 0401-0450 val, 0451-0500 test — the common
    literature protocol (per-patient, never per-view, so both views of a
    patient land in one split).  The paper's exact fold should be
    confirmed against its text when obtainable; this fixed split is the
    reproducible default for parity runs."""
    num = int("".join(ch for ch in patient if ch.isdigit()) or 0)
    if num <= 400:
        return "train"
    if num <= 450:
        return "val"
    return "test"


def camus_fold(patient: str, folds: int) -> int:
    """Deterministic patient-number fold id in [0, folds): (num-1) % folds.

    The CAMUS challenge protocol is 10-fold cross-validation over the 500
    patients; the official fold assignment isn't re-derivable here, so this
    balanced patient-number rule is the reproducible default — whichever
    fold scheme the paper used is then an argument, not a code change."""
    num = int("".join(ch for ch in patient if ch.isdigit()) or 0)
    return (num - 1) % folds


def convert_raw_camus(raw_root: str, out_root: str, *,
                      image_size: int = 256, clip_len: int = 10,
                      val_fraction: float = 0.1, seed: int = 0,
                      split_mode: str = "random") -> int:
    """Convert raw CAMUS (patientNNNN dirs of .mhd half-sequences) into the
    processed camus_png256x256_10f layout.  Returns #clips written.

    split_mode: "random" (seeded per-patient val_fraction holdout) or
    "official" (fixed patient-number split — see official_camus_split).
    """
    Image = require_pil("convert_raw_camus")
    patients = sorted(d for d in os.listdir(raw_root)
                      if d.startswith("patient")
                      and os.path.isdir(os.path.join(raw_root, d)))
    if not patients:
        raise FileNotFoundError(f"no patientNNNN directories in {raw_root}")
    if split_mode not in ("random", "official"):
        raise ValueError(f"split_mode must be random|official, "
                         f"got {split_mode!r}")
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(patients))
    n_val = max(int(len(patients) * val_fraction), 1) \
        if len(patients) > 1 else 0
    val_set = {patients[i] for i in order[:n_val]}

    written = 0
    for pat in patients:
        pdir = os.path.join(raw_root, pat)
        for view in ("2CH", "4CH"):
            seq = os.path.join(pdir, f"{pat}_{view}_half_sequence.mhd")
            gt = os.path.join(pdir, f"{pat}_{view}_half_sequence_gt.mhd")
            if not os.path.exists(seq):
                continue
            frames, header = read_mhd(seq)
            masks = read_mhd(gt)[0] if os.path.exists(gt) else None
            t_total = frames.shape[0]
            idx = np.linspace(0, t_total - 1, clip_len).round().astype(int)
            frames_r = _resize_stack(frames[idx], image_size, False)
            split = (official_camus_split(pat) if split_mode == "official"
                     else ("val" if pat in val_set else "train"))
            clip_dir = os.path.join(out_root, split, f"{pat}_{view}")
            os.makedirs(clip_dir, exist_ok=True)
            for j in range(clip_len):
                Image.fromarray(frames_r[j]).save(
                    os.path.join(clip_dir, f"frame_{j:02d}.png"))
            if masks is not None:
                masks_r = _resize_stack(masks[idx], image_size, True)
                for j in range(clip_len):
                    Image.fromarray(masks_r[j]).save(
                        os.path.join(clip_dir, f"mask_{j:02d}.png"))
            # Physical-units sidecar: raw CAMUS is anisotropic (~0.31 mm
            # lateral × ~0.15 mm axial at native resolution); the resize to
            # image_size scales each axis's mm-per-pixel independently.
            # HD95 in mm and volumes in mL read this back.
            sp = element_spacing(header)            # (sx, sy[, st]) mm
            if sp is not None and len(sp) >= 2:
                h0, w0 = frames.shape[1], frames.shape[2]
                meta = {
                    "spacing_mm": [sp[1] * h0 / image_size,
                                   sp[0] * w0 / image_size],  # [sy, sx]
                    "size": [image_size, image_size],
                    "orig_size": [h0, w0],
                    "orig_spacing_mm": [sp[1], sp[0]],
                    "source": os.path.basename(seq),
                }
                with open(os.path.join(clip_dir, "meta.json"), "w") as f:
                    json.dump(meta, f)
            written += 1
    return written
