"""Clinical parity protocols: CAMUS official scoring, CAMUS biplane EF,
EchoNet-Dynamic EF and the memory ablation (port of
gdkvm_tpu/eval/parity.py).  Host numpy and scipy; the model's forward runs
on the model's device, whose parameters are the ones scored.

CAMUS official protocol (per the CAMUS challenge definition):
  - scored per patient, per view (2CH / 4CH), at the ED and ES frames only;
  - structures: LV endocardium (class 1), LV epicardium (classes 1∪2: the
    epicardial contour encloses the cavity and the myocardium), left atrium
    (class 3);
  - metrics: Dice and HD95 per (structure, phase), mean ± std across
    patients, never pooled over pixels.  HD95 is in millimetres whenever
    the clips carry the spacing sidecar the raw converter writes
    (data/camus_raw.py), pixel units otherwise; the table header says which.
  The processed clips are ED→ES half sequences, so ED is the first
  annotated frame of a clip and ES the last.

EchoNet-Dynamic EF protocol:
  - stream-segment the full video, one LV mask per frame;
  - per-frame LV volume by the single-plane area–length rule
    V = 8·A² / (3π·L);
  - beat-aware EF from the volume trace, frame-rate-aware through
    FileList.csv's FPS column;
  - EF against FileList.csv's EF column: MAE / RMSE / bias / Pearson r / R².

CAMUS biplane EF also reports volumes in mL where spacing sidecars exist.
"""

from __future__ import annotations

import os
import re
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

MM3_PER_ML = 1000.0


def lv_long_axis_px(mask: np.ndarray, spacing=None) -> float:
    """Long-axis length of a binary mask: extent along the first principal
    axis of the foreground pixel cloud.

    ``spacing``: optional (sy, sx) physical pixel size in mm — the cloud
    is scaled to physical coordinates BEFORE the PCA, so both the axis
    direction and its extent are anisotropic-correct (raw CAMUS pixels
    are ~2× taller than wide; a pixel-space axis is wrong there).
    Returns pixels when spacing is None, mm otherwise."""
    ys, xs = np.nonzero(mask)
    if ys.size < 2:
        return 0.0
    pts = np.stack([ys, xs], axis=1).astype(np.float64)
    if spacing is not None:
        pts *= np.asarray(spacing, np.float64)[None, :]
    pts -= pts.mean(axis=0)
    # Principal axis via the 2×2 covariance eigenvector.
    cov = pts.T @ pts / pts.shape[0]
    w, v = np.linalg.eigh(cov)
    axis = v[:, int(np.argmax(w))]
    proj = pts @ axis
    return float(proj.max() - proj.min())


def lv_area(mask: np.ndarray, spacing=None) -> float:
    """Foreground area: pixel count, or mm² when (sy, sx) spacing given."""
    n = float(np.asarray(mask, bool).sum())
    if spacing is None:
        return n
    return n * float(spacing[0]) * float(spacing[1])


def lv_volume_area_length(mask: np.ndarray, spacing=None) -> float:
    """Monoplane area–length LV volume estimate V = 8·A²/(3π·L).

    Voxel units when ``spacing`` is None; with (sy, sx) in mm the area is
    mm², the length mm, and the volume mm³ (divide by MM3_PER_ML for mL).
    Anisotropic spacing does NOT cancel in EF — A² grows with sy²·sx²
    while L grows with the spacing along the long axis only — so physical
    units matter even for the ratio.  Returns 0 for an empty mask."""
    area = lv_area(mask, spacing)
    if area <= 0:
        return 0.0
    length = lv_long_axis_px(mask, spacing)
    if length <= 0:
        return 0.0
    return 8.0 * area * area / (3.0 * np.pi * length)


def detect_ed_es(volumes: np.ndarray, smooth: int = 3
                 ) -> Tuple[int, int]:
    """Pick (ED, ES) frame indices from a per-frame volume trace.

    ED = global max, ES = global min of the lightly-smoothed trace — the
    simple robust rule; with multiple beats the global extremes still land
    on a genuine ED/ES pair of some beat, which is what EF needs.
    """
    v = _smooth_trace(volumes, smooth)
    if v.size == 0:
        return 0, 0
    return int(np.argmax(v)), int(np.argmin(v))


def _smooth_trace(volumes: np.ndarray, smooth: int) -> np.ndarray:
    v = np.asarray(volumes, np.float64)
    if smooth > 1 and v.size > smooth:
        v = np.convolve(v, np.ones(smooth) / smooth, mode="same")
    return v


def beatwise_ef(volumes: np.ndarray, smooth: int = 3,
                min_beat_frames: int = 8,
                fps: Optional[float] = None,
                min_beat_s: float = 0.3) -> Tuple[float, int]:
    """Beat-aware EF: segment the volume trace into beats at the ES minima
    (the EchoNet-protocol shape: EF is estimated per beat and averaged —
    robust to arrhythmia and to a lucky/unlucky global extreme).

    Beats = intervals between successive local minima separated by at
    least ``min_beat_frames``; per beat, EF from the max/min volume inside
    it.  Falls back to the global-extreme EF when the trace is too short
    to segment.  Returns (ef_percent, n_beats_used).

    ``fps`` (EchoNet FileList.csv carries per-video FPS; ~50 typical but
    it varies) makes the separation frame-rate-aware: min separation =
    ``min_beat_s``·fps frames (0.3 s ≈ a 200 bpm ceiling — filters noise
    wiggles without dropping real beats).  A fixed frame count misreads
    slow-frame-rate videos: 8 frames is 0.16 s at 50 fps but 0.27 s at
    30 fps.  Without fps the legacy fixed ``min_beat_frames`` applies.
    """
    if fps is not None and fps > 0:
        min_beat_frames = max(3, int(round(min_beat_s * fps)))
    v = _smooth_trace(volumes, smooth)
    if v.size < 2 * min_beat_frames:
        i_ed, i_es = detect_ed_es(volumes, smooth)
        return ef_from_volumes(volumes[i_ed], volumes[i_es]), 1
    # Local minima with a minimum separation (greedy by depth).
    cand = [i for i in range(1, v.size - 1)
            if v[i] <= v[i - 1] and v[i] <= v[i + 1]]
    cand.sort(key=lambda i: v[i])
    minima: list = []
    for i in cand:
        if all(abs(i - j) >= min_beat_frames for j in minima):
            minima.append(i)
    minima.sort()
    if len(minima) < 2:
        i_ed, i_es = detect_ed_es(volumes, smooth)
        return ef_from_volumes(volumes[i_ed], volumes[i_es]), 1
    efs = []
    for lo, hi in zip(minima[:-1], minima[1:]):
        seg = v[lo:hi + 1]
        if seg.size < 3:
            continue
        v_ed, v_es = float(seg.max()), float(seg.min())
        if v_ed > 0:
            efs.append(ef_from_volumes(v_ed, v_es))
    if not efs:
        i_ed, i_es = detect_ed_es(volumes, smooth)
        return ef_from_volumes(volumes[i_ed], volumes[i_es]), 1
    return float(np.mean(efs)), len(efs)


def ef_from_volumes(v_ed: float, v_es: float) -> float:
    """Ejection fraction (%) from ED/ES volumes; 0 when V_ED is empty."""
    if v_ed <= 0:
        return 0.0
    return 100.0 * (v_ed - v_es) / v_ed


def dice_bin(pred: np.ndarray, label: np.ndarray, eps: float = 1e-7
             ) -> float:
    """Hard binary Dice of two boolean masks."""
    p = pred.astype(bool)
    l = label.astype(bool)
    denom = p.sum() + l.sum()
    if denom == 0:
        return 1.0
    return float((2.0 * np.logical_and(p, l).sum() + eps) / (denom + eps))


# ---------------------------------------------------------------------------
# CAMUS official protocol.
# ---------------------------------------------------------------------------

# (display name, predicate over the integer class map)
CAMUS_STRUCTURES = (
    ("LV_endo", lambda m: m == 1),
    ("LV_epi", lambda m: (m == 1) | (m == 2)),
    ("LA", lambda m: m == 3),
)

_CLIP_RE = re.compile(r"(patient\w+?)_(2CH|4CH)", re.IGNORECASE)


def _predict_masks_fn(model):
    """Clip forward on the model's device: uint8 frames (B, T, H, W, 1)
    (numpy) → uint8 argmax masks (B, T, H, W) (numpy).  One upload and one
    fetch a batch; normalize, forward and argmax run under
    ``torch.inference_mode()``."""
    import torch
    from gdkvm_tpu_torch.eval.metrics import mask_from_logits
    from gdkvm_tpu_torch.eval.streaming import _stage, model_device

    device = model_device(model)

    @torch.inference_mode()
    def predict(frames_u8: np.ndarray) -> np.ndarray:
        (x,) = _stage(device, frames_u8)
        logits, _ = model(x.to(torch.float32) / 255.0)
        return mask_from_logits(logits).cpu().numpy()
    return predict


def camus_official(cfg, model, split: str = "val",
                   batch_size: int = 8, with_hd95: bool = True,
                   max_patients: Optional[int] = None,
                   predict_fn=None, patient_filter=None) -> Dict:
    """Run the CAMUS official per-patient ED/ES protocol on a split.

    Returns {"per_structure": {view: {structure: {phase: {dice_mean, ...,
    hd95_mean, ...}}}}, "n_patients": ..., "table": markdown str}.

    ``predict_fn(frames_u8 (B,T,H,W,1)) -> (B,T,H,W) class maps`` replaces
    the model forward (protocol-exactness tests feed ground truth through
    it and must read Dice 1.0 / HD95 0.0).  ``patient_filter(pid) -> bool``
    restricts scoring to a patient subset (the fold machinery uses it).
    """
    from gdkvm_tpu_torch.data.camus import CamusDataset
    from gdkvm_tpu_torch.eval import metrics as M

    k = cfg.model.num_classes
    ds = CamusDataset(cfg.data.data_path, split,
                      image_size=cfg.data.image_size,
                      clip_len=cfg.data.clip_len, num_classes=k)
    structures = [s for s in CAMUS_STRUCTURES
                  if k >= 4 or s[0] == "LV_endo"]

    if predict_fn is None:
        predict_fn = _predict_masks_fn(model)

    # Score records: (view, structure, phase) → list of per-patient values.
    dice_rec: Dict[Tuple[str, str, str], List[float]] = defaultdict(list)
    hd_rec: Dict[Tuple[str, str, str], List[float]] = defaultdict(list)
    patients = set()
    # Physical units: HD95 in mm when every scored clip declares spacing
    # (meta.json sidecar, written by the raw converter); px otherwise.
    # CAMUS-literature tables report mm.
    n_spaced = 0
    n_clips = 0

    # Batched prediction over clips (fixed batch: the tail is padded with
    # repeats of its last clip, which are not scored).
    n = len(ds)
    if max_patients is not None or patient_filter is not None:
        keep = []
        seen_p = set()
        for i in range(n):
            m = _CLIP_RE.match(ds.clips[i])
            pid = m.group(1) if m else ds.clips[i]
            if patient_filter is not None and not patient_filter(pid):
                continue
            if pid not in seen_p and max_patients is not None \
                    and len(seen_p) >= max_patients:
                continue
            seen_p.add(pid)
            keep.append(i)
        idxs = keep
    else:
        idxs = list(range(n))

    for lo in range(0, len(idxs), batch_size):
        chunk_ids = idxs[lo:lo + batch_size]
        items = [ds[i] for i in chunk_ids]
        pad = batch_size - len(items)
        frames = np.stack([it[0] for it in items] + [items[-1][0]] * pad)
        preds = predict_fn(frames)
        for j, i in enumerate(chunk_ids):
            _, gt, valid = items[j]
            ann = np.nonzero(valid > 0)[0]
            if ann.size == 0:
                continue
            # ED→ES half sequence: first/last annotated frame.
            phase_frames = {"ED": int(ann[0]), "ES": int(ann[-1])}
            m = _CLIP_RE.match(ds.clips[i])
            pid = m.group(1) if m else ds.clips[i]
            view = m.group(2).upper() if m else "NA"
            patients.add(pid)
            sp = ds.spacing(i) if hasattr(ds, "spacing") else None
            n_clips += 1
            n_spaced += sp is not None
            for phase, t in phase_frames.items():
                for name, sel in structures:
                    p = sel(preds[j, t])
                    l = sel(gt[t])
                    if not l.any() and not p.any():
                        continue
                    dice_rec[(view, name, phase)].append(dice_bin(p, l))
                    if with_hd95:
                        hd = M.hd95(p.astype(np.uint8),
                                    l.astype(np.int64), 2,
                                    spacing=sp if sp is not None else 1.0)
                        val = hd.get("hd95_class1", float("inf"))
                        if np.isfinite(val):
                            hd_rec[(view, name, phase)].append(val)

    per_structure: Dict = {}
    for (view, name, phase), vals in dice_rec.items():
        cell = per_structure.setdefault(view, {}).setdefault(name, {}) \
            .setdefault(phase, {})
        cell["dice_mean"] = float(np.mean(vals))
        cell["dice_std"] = float(np.std(vals))
        cell["n"] = len(vals)
        hvals = hd_rec.get((view, name, phase))
        if hvals:
            cell["hd95_mean"] = float(np.mean(hvals))
            cell["hd95_std"] = float(np.std(hvals))

    if 0 < n_spaced < n_clips:
        import warnings
        warnings.warn(
            f"camus_official: {n_spaced}/{n_clips} clips declare physical "
            f"spacing — HD95 units are MIXED (mm for spaced clips, px "
            f"otherwise). Re-run the converter so every clip has meta.json.")
    out = {
        "protocol": "camus_official_ed_es_per_patient",
        "split": split,
        "n_patients": len(patients),
        "per_structure": per_structure,
        "hd95_units": ("mm" if n_clips and n_spaced == n_clips
                       else "px" if n_spaced == 0 else "mixed"),
    }
    out["table"] = format_camus_table(out)
    # Headline scalar: mean Dice over every (view, structure, phase) cell —
    # the number the paper-style tables summarize.
    cells = [c["dice_mean"] for v in per_structure.values()
             for s in v.values() for c in s.values()]
    out["dice_mean_overall"] = float(np.mean(cells)) if cells else float("nan")
    return out


def format_camus_table(result: Dict) -> str:
    """Markdown table in the paper's layout: rows = view × structure,
    columns = ED/ES × Dice/HD95 (mean ± std); HD95 units from the run
    (mm when every clip declared physical spacing, px otherwise)."""
    u = result.get("hd95_units", "px")
    lines = [
        f"| View | Structure | Dice ED | Dice ES | HD95 ED ({u}) "
        f"| HD95 ES ({u}) |",
        "|---|---|---|---|---|---|",
    ]

    def fmt(cell, key):
        if cell is None or f"{key}_mean" not in cell:
            return "—"
        return f"{cell[f'{key}_mean']:.4f} ± {cell[f'{key}_std']:.4f}" \
            if key == "dice" else \
            f"{cell[f'{key}_mean']:.2f} ± {cell[f'{key}_std']:.2f}"

    for view in sorted(result["per_structure"]):
        for name, phases in result["per_structure"][view].items():
            ed = phases.get("ED")
            es = phases.get("ES")
            lines.append(
                f"| {view} | {name} | {fmt(ed, 'dice')} | {fmt(es, 'dice')}"
                f" | {fmt(ed, 'hd95')} | {fmt(es, 'hd95')} |")
    return "\n".join(lines)


def camus_official_folds(cfg, model, folds: int = 10,
                         split: str = "val", batch_size: int = 8,
                         with_hd95: bool = True,
                         predict_fn=None) -> Dict:
    """CAMUS official protocol under k-fold cross-validation aggregation.

    The CAMUS challenge's own protocol is 10-fold CV over the 500 patients
    (fixed-split literature results also exist — data/camus_raw.py
    ``official_camus_split``); which one the paper used is unconfirmable
    from the reference, so BOTH are flags at parity time: the ``parity``
    command's default = fixed split, ``--folds 10`` = this path.  Patients are
    assigned by the deterministic ``camus_fold`` rule; each fold is scored
    independently by the per-patient ED/ES protocol and the headline is
    mean ± std of the per-fold mean Dice — matching how CV tables report.

    For the full-CV protocol point the run at a layout containing all
    patients (e.g. convert with val_fraction=0 and score ``--split
    train``); running it on a sub-split still aggregates correctly over
    whatever patients that split holds (empty folds are skipped).
    """
    from gdkvm_tpu_torch.data.camus_raw import camus_fold

    per_fold: List[Dict] = []
    for f in range(folds):
        res = camus_official(
            cfg, model, split=split, batch_size=batch_size,
            with_hd95=with_hd95, predict_fn=predict_fn,
            patient_filter=lambda pid, f=f: camus_fold(pid, folds) == f)
        if res["n_patients"] == 0:
            continue
        res.pop("table", None)
        res["fold"] = f
        per_fold.append(res)

    out: Dict = {"protocol": "camus_official_kfold", "split": split,
                 "folds": folds, "n_folds_scored": len(per_fold),
                 "per_fold": per_fold}
    if per_fold:
        vals = np.array([r["dice_mean_overall"] for r in per_fold])
        out["dice_mean_overall"] = float(vals.mean())
        out["dice_std_over_folds"] = float(vals.std())
        out["n_patients"] = int(sum(r["n_patients"] for r in per_fold))
        out["hd95_units"] = per_fold[0]["hd95_units"]
        hds = [c["hd95_mean"]
               for r in per_fold for v in r["per_structure"].values()
               for s in v.values() for c in s.values() if "hd95_mean" in c]
        if hds:
            out["hd95_mean_overall"] = float(np.mean(hds))
        lines = [f"| Fold | Patients | Mean Dice |", "|---|---|---|"]
        for r in per_fold:
            lines.append(f"| {r['fold']} | {r['n_patients']} "
                         f"| {r['dice_mean_overall']:.4f} |")
        lines.append(f"| **mean ± std** | {out['n_patients']} "
                     f"| {out['dice_mean_overall']:.4f} ± "
                     f"{out['dice_std_over_folds']:.4f} |")
        out["table"] = "\n".join(lines)
    return out


def biplane_volume(area_2ch: float, area_4ch: float,
                   length_2ch: float, length_4ch: float) -> float:
    """Biplane area–length (modified Simpson) LV volume:
    V = (8/3π) · A_2CH · A_4CH / L, with L the shorter long axis of the
    two views — the standard CAMUS/clinical biplane estimate."""
    length = min(length_2ch, length_4ch)
    if length <= 0:
        return 0.0
    return 8.0 * area_2ch * area_4ch / (3.0 * np.pi * length)


def camus_ef(cfg, model, split: str = "val",
             batch_size: int = 8,
             max_patients: Optional[int] = None,
             predict_fn=None) -> Dict:
    """CAMUS EF protocol: biplane Simpson from paired 2CH+4CH predictions.

    Per patient: LV-endo areas and long axes at the ED/ES frames of BOTH
    views → biplane volumes → EF.  The reference EF is computed from the
    ground-truth masks by the identical rule (on real CAMUS the clinical
    EF label lives in Info_*CH.cfg, outside the processed-artifact layout;
    GT-mask-derived EF is the self-consistent stand-in and the mask-error
    isolator either way).  Reports MAE/RMSE/bias/r against it.

    With per-clip physical spacing (meta.json sidecars) areas/lengths are
    computed in mm²/mm and volumes reported in mL — anisotropic-safe: the
    area–length rule does NOT cancel anisotropic spacing, so EF itself
    changes when pixels aren't square.  Without spacing, voxel units.
    """
    from gdkvm_tpu_torch.data.camus import CamusDataset

    k = cfg.model.num_classes
    ds = CamusDataset(cfg.data.data_path, split,
                      image_size=cfg.data.image_size,
                      clip_len=cfg.data.clip_len, num_classes=k)
    if predict_fn is None:
        predict_fn = _predict_masks_fn(model)

    # patient → view → (pred masks, gt masks, valid, spacing)
    per_patient: Dict[str, Dict[str, tuple]] = defaultdict(dict)
    idxs = list(range(len(ds)))
    for lo in range(0, len(idxs), batch_size):
        chunk_ids = idxs[lo:lo + batch_size]
        items = [ds[i] for i in chunk_ids]
        pad = batch_size - len(items)
        frames = np.stack([it[0] for it in items] + [items[-1][0]] * pad)
        preds = predict_fn(frames)
        for j, i in enumerate(chunk_ids):
            m = _CLIP_RE.match(ds.clips[i])
            if not m:
                continue
            sp = ds.spacing(i) if hasattr(ds, "spacing") else None
            per_patient[m.group(1)][m.group(2).upper()] = (
                preds[j], items[j][1], items[j][2], sp)

    def _ef_from(masks_by_view, use_pred: bool
                 ) -> Optional[Tuple[float, float, float, bool]]:
        """(EF%, V_ED, V_ES, physical): volumes in mm³ when both views
        declare spacing (physical=True), voxel units otherwise."""
        stats = {}
        physical = True
        for view in ("2CH", "4CH"):
            if view not in masks_by_view:
                return None
            pred, gt, valid, sp = masks_by_view[view]
            physical = physical and sp is not None
            ann = np.nonzero(valid > 0)[0]
            if ann.size == 0:
                return None
            maps = pred if use_pred else gt
            per_phase = {}
            for phase, t in (("ED", int(ann[0])), ("ES", int(ann[-1]))):
                lv = maps[t] == 1
                per_phase[phase] = (lv, sp)
            stats[view] = per_phase
        vols = {}
        for phase in ("ED", "ES"):
            m2, sp2 = stats["2CH"][phase]
            m4, sp4 = stats["4CH"][phase]
            use2 = sp2 if physical else None
            use4 = sp4 if physical else None
            vols[phase] = biplane_volume(
                lv_area(m2, use2), lv_area(m4, use4),
                lv_long_axis_px(m2, use2), lv_long_axis_px(m4, use4))
        return (ef_from_volumes(vols["ED"], vols["ES"]),
                vols["ED"], vols["ES"], physical)

    per_pat = []
    n_physical = 0
    for pid in sorted(per_patient):
        if max_patients is not None and len(per_pat) >= max_patients:
            break
        res_p = _ef_from(per_patient[pid], use_pred=True)
        res_r = _ef_from(per_patient[pid], use_pred=False)
        if res_p is None or res_r is None:
            continue
        ef_p, v_ed, v_es, physical = res_p
        rec = {"patient": pid, "ef_pred": ef_p, "ef_ref": res_r[0]}
        if physical:
            rec["v_ed_ml"] = v_ed / MM3_PER_ML
            rec["v_es_ml"] = v_es / MM3_PER_ML
            n_physical += 1
        per_pat.append(rec)

    out: Dict = {"protocol": "camus_ef_biplane_simpson", "split": split,
                 "n_patients": len(per_pat), "per_patient": per_pat,
                 "volume_units": ("mL" if per_pat
                                  and n_physical == len(per_pat)
                                  else "voxel")}
    if per_pat:
        pred = np.array([r["ef_pred"] for r in per_pat])
        ref = np.array([r["ef_ref"] for r in per_pat])
        err = pred - ref
        out["ef_mae"] = float(np.mean(np.abs(err)))
        out["ef_rmse"] = float(np.sqrt(np.mean(err ** 2)))
        out["ef_bias"] = float(np.mean(err))
        if len(per_pat) > 1 and pred.std() > 0 and ref.std() > 0:
            out["ef_pearson_r"] = float(np.corrcoef(pred, ref)[0, 1])
        out["n_scored"] = len(per_pat)
        out["table"] = format_ef_table(out)
    return out


# ---------------------------------------------------------------------------
# EchoNet-Dynamic EF protocol.
# ---------------------------------------------------------------------------


def read_ef_labels(root: str) -> Dict[str, float]:
    """EF column from FileList.csv (absent in minimal synthetic layouts)."""
    return {name: rec["EF"] for name, rec in read_filelist_meta(root).items()
            if "EF" in rec}


def read_filelist_meta(root: str) -> Dict[str, Dict[str, float]]:
    """Per-video numeric metadata from FileList.csv: EF and FPS (the real
    EchoNet FileList carries FPS per video — ~50 typical but variable —
    which the beat-aware EF segmentation needs to be frame-rate-correct).
    Returns {video.avi: {"EF": ..., "FPS": ...}} with keys present only
    when the column exists and parses."""
    import csv

    out: Dict[str, Dict[str, float]] = {}
    path = os.path.join(root, "FileList.csv")
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for row in csv.DictReader(f):
            name = row.get("FileName")
            if not name:
                continue
            if not name.endswith(".avi"):
                name += ".avi"
            rec: Dict[str, float] = {}
            for col in ("EF", "FPS"):
                val = row.get(col)
                if val not in ("", None):
                    try:
                        rec[col] = float(val)
                    except ValueError:
                        pass
            if rec:
                out[name] = rec
    return out


def echonet_ef(cfg, model, split: str = "VAL",
               num_videos: Optional[int] = None,
               chunk: Optional[int] = None,
               segment_fn=None) -> Dict:
    """EF estimation from predicted masks over full streamed videos.

    Returns per-video EF predictions plus MAE/RMSE/bias/r/R² against the
    FileList EF labels (videos without a label are reported but unscored).

    ``segment_fn(video_u8 (T,H,W,1), name) -> (T,H,W) class maps``
    replaces the streamed model forward (protocol-exactness tests feed the
    generator's ground-truth masks and must read EF MAE ≈ 0).
    """
    from gdkvm_tpu_torch.data.echonet import EchoNetDataset
    from gdkvm_tpu_torch.eval.streaming import stream_video

    k = cfg.model.num_classes
    ds = EchoNetDataset(cfg.data.data_path, split,
                        image_size=cfg.data.image_size,
                        clip_len=cfg.data.clip_len, num_classes=k)
    meta = read_filelist_meta(cfg.data.data_path)
    chunk = chunk or cfg.eval_stage.stream_chunk

    names = ds.videos[:num_videos] if num_videos else ds.videos
    per_video = []
    for name in names:
        vid = ds.decode_video(name)
        masks = (segment_fn(vid, name) if segment_fn is not None
                 else stream_video(model, vid, chunk=chunk))
        lv = masks == 1
        # EchoNet pixels are square (isotropic resize), so pixel-unit
        # volumes are fine HERE: EF is a ratio and isotropic scaling
        # cancels exactly (unlike anisotropic raw CAMUS — see camus_ef).
        vols = np.array([lv_volume_area_length(lv[t])
                         for t in range(lv.shape[0])])
        # Beat-aware EF (per-beat estimates averaged — the EchoNet
        # protocol shape), frame-rate-aware via the video's FPS column;
        # falls back to global extremes on short traces.
        fps = meta.get(name, {}).get("FPS")
        ef_pred, n_beats = beatwise_ef(vols, fps=fps)
        i_ed, i_es = detect_ed_es(vols)
        rec = {"video": name, "ef_pred": ef_pred, "beats": n_beats,
               "frame_ed": i_ed, "frame_es": i_es,
               "frames": int(vid.shape[0])}
        if fps is not None:
            rec["fps"] = fps
        if "EF" in meta.get(name, {}):
            rec["ef_true"] = meta[name]["EF"]
        per_video.append(rec)

    scored = [(r["ef_pred"], r["ef_true"])
              for r in per_video if "ef_true" in r]
    out: Dict = {"protocol": "echonet_ef_area_length",
                 "split": split, "per_video": per_video,
                 "n_videos": len(per_video), "n_scored": len(scored)}
    if scored:
        pred = np.array([s[0] for s in scored])
        true = np.array([s[1] for s in scored])
        err = pred - true
        out["ef_mae"] = float(np.mean(np.abs(err)))
        out["ef_rmse"] = float(np.sqrt(np.mean(err ** 2)))
        out["ef_bias"] = float(np.mean(err))
        ss_res = float(np.sum(err ** 2))
        ss_tot = float(np.sum((true - true.mean()) ** 2))
        out["ef_r2"] = 1.0 - ss_res / ss_tot if ss_tot > 0 else float("nan")
        if len(scored) > 1 and pred.std() > 0 and true.std() > 0:
            out["ef_pearson_r"] = float(np.corrcoef(pred, true)[0, 1])
        out["table"] = format_ef_table(out)
    return out


def format_ef_table(result: Dict) -> str:
    lines = ["| Metric | Value |", "|---|---|"]
    for key, label in (("ef_mae", "EF MAE (pts)"),
                       ("ef_rmse", "EF RMSE (pts)"),
                       ("ef_bias", "EF bias (pts)"),
                       ("ef_pearson_r", "Pearson r"),
                       ("ef_r2", "R²")):
        if key in result:
            lines.append(f"| {label} | {result[key]:.3f} |")
    lines.append(f"| videos scored | {result['n_scored']} |")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Memory-contribution ablation (the GDKVM mechanism study).
# ---------------------------------------------------------------------------


def memory_ablation(cfg, model, num_videos: int = 8,
                    video_len: int = 64) -> Dict:
    """2x2 memory-contribution study: {clean, occluded} x {carried, reset}.

    The reference's headline claim is robustness of the carried memory
    under acoustic dropout, so the mechanism evidence must live on the
    benchmark that can rank models: run this with a checkpoint trained on
    configs/camus_hard_synth.yaml (+ data.occlude_prob) and the same
    config here, so eval videos carry the difficulty-0.7 artifact bank.

    Protocol: per-frame streaming
    (stream_chunk=1) so ``reset`` removes ALL temporal context; the
    occlusion probe blanks an LV-covering region on the 4 frames up to
    the last traced frame (eval/streaming.py::stream_evaluate).

    Returns per-condition Dice plus the two memory deltas; the occluded
    delta is the robustness-mechanism number.
    """
    import copy

    from gdkvm_tpu_torch.eval.streaming import stream_evaluate

    cfg = copy.deepcopy(cfg)
    cfg.eval_stage.stream_chunk = 1      # per-frame: reset = truly no memory
    conditions = {}
    for window in (False, True):
        for occl in (False, True):
            for reset in (False, True):
                name = (("occluded" if occl else "clean") + "_"
                        + ("reset" if reset else "carry")
                        + ("_window" if window else ""))
                r = stream_evaluate(cfg, model,
                                    num_videos=num_videos,
                                    video_len=video_len, reset_state=reset,
                                    occlude=occl, streams=1,
                                    probe_window_only=window)
                conditions[name] = {
                    k: v for k, v in r.items()
                    if k.startswith("dice") or k == "frames"}
    out: Dict = {"protocol": "memory_ablation_2x2",
                 "dataset": cfg.data.dataset,
                 "synth_difficulty": getattr(cfg.data, "synth_difficulty",
                                             None),
                 "num_videos": num_videos, "video_len": video_len,
                 "conditions": conditions}
    for cond in ("clean", "occluded", "clean_window", "occluded_window"):
        base, _, suffix = cond.partition("_")
        carry = conditions[f"{base}_carry" + (f"_{suffix}" if suffix
                                              else "")].get("dice_fg_mean")
        reset = conditions[f"{base}_reset" + (f"_{suffix}" if suffix
                                              else "")].get("dice_fg_mean")
        if carry is not None and reset is not None:
            out[f"memory_delta_{cond}"] = carry - reset
    out["table"] = format_ablation_table(out)
    return out


def format_ablation_table(result: Dict) -> str:
    """All-frame rows dilute the probe (4 occluded frames of video_len);
    the `window` rows score ONLY the probe window — the robustness-
    mechanism number."""
    lines = ["| Condition | fg Dice (carry) | fg Dice (reset) | memory Δ |",
             "|---|---|---|---|"]
    c = result["conditions"]
    for cond, suffix in (("clean", ""), ("occluded", ""),
                         ("clean", "_window"), ("occluded", "_window")):
        carry = c[cond + "_carry" + suffix].get("dice_fg_mean", float("nan"))
        reset = c[cond + "_reset" + suffix].get("dice_fg_mean", float("nan"))
        delta = result.get("memory_delta_" + cond + suffix, float("nan"))
        lines.append(f"| {cond}{suffix} | {carry:.4f} | {reset:.4f} "
                     f"| {delta:+.4f} |")
    return "\n".join(lines)
