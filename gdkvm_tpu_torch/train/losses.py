"""Segmentation losses: cross-entropy + soft Dice, with frame validity.

Port of gdkvm_tpu/train/losses.py.  Logits stay (B, T, H, W, K) with the
classes last: the JAX package's class-major transposes are TPU lane tuning.
Bootstrapped CE keeps its form: a threshold from a strided subsample of
each frame's pixel CE, and a stop-gradient mask ``pix_ce ≥ thr`` in place of
the selected values (the same gradient almost everywhere, an elementwise
backward).  The threshold is the exact k-th largest value (``torch.topk``);
the JAX package's ``approx_max_k`` is exact on the CPU, where the two are
compared.

In a data-parallel run each rank holds a share of the global batch.  The
averages are over the valid frames of the whole batch: ``valid_total`` is
that count (summed over the ranks beforehand), and each term comes out
scaled by the ``world`` size, so that the mean of the ranks' losses, and of
their gradients, is the loss of the global batch.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def _ce_dice_terms(logits: Tensor, labels: Tensor, valid: Tensor, eps: float,
                   bootstrap_ratio: float = 1.0,
                   bootstrap_weight: float | Tensor = 1.0,
                   valid_total: Optional[Tensor] = None, world: int = 1
                   ) -> Tuple[Tensor, Tensor]:
    """(CE, 1 − foreground soft Dice), both averaged over valid frames: of
    this batch, or of the global batch of ``valid_total`` valid frames over
    ``world`` ranks (each term then scaled by ``world``).

    ``bootstrap_ratio`` < 1 blends mean CE with the CE of each frame's
    hardest ratio·H·W pixels by ``bootstrap_weight`` λ ∈ [0, 1].
    """
    k = logits.shape[-1]
    logp = F.log_softmax(logits, dim=-1)
    onehot = F.one_hot(labels.long(), k).to(logp.dtype)
    valid = valid.to(logp.dtype)
    total = valid.sum() if valid_total is None else valid_total.to(logp.dtype)
    denom = total.clamp_min(1.0) / world

    ll = (logp * onehot).sum(-1)                       # (B,T,H,W)
    per_frame = -ll.mean((2, 3))                        # (B,T)
    ce = (per_frame * valid).sum() / denom
    if bootstrap_ratio < 1.0:
        b, t, h, w = ll.shape
        pix_ce = (-ll).reshape(b, t, h * w)
        # The k-th largest value is a quantile: estimate it from a strided
        # subsample of at least 8192 pixels (the full field below 16k).
        stride = max(1, (h * w) // 8192)
        sub = pix_ce.detach()[..., ::stride]
        ksub = max(1, int(round(bootstrap_ratio * sub.shape[-1])))
        thr = torch.topk(sub, ksub, dim=-1).values[..., -1:]
        mask = (pix_ce.detach() >= thr).to(pix_ce.dtype)
        cnt = mask.sum(-1).clamp_min(1.0)               # ties ⇒ cnt ≥ k
        per_frame_hard = (pix_ce * mask).sum(-1) / cnt
        ce_hard = (per_frame_hard * valid).sum() / denom
        ce = (1.0 - bootstrap_weight) * ce + bootstrap_weight * ce_hard

    probs = logp.exp()
    inter = (probs * onehot).sum((2, 3))                # (B,T,K)
    psum = probs.sum((2, 3))
    lsum = onehot.sum((2, 3))
    dice = (2 * inter + eps) / (psum + lsum + eps)
    fg = dice[..., 1:].mean(-1)                         # (B,T)
    return ce, 1.0 - (fg * valid).sum() / denom


def bootstrap_schedule(step: int, num_iterations: int, start_frac: float,
                       end_frac: float) -> Tensor:
    """λ(step): 0 before start_frac·N iterations, a linear ramp to 1 by
    end_frac·N.  A 0-dim fp32 tensor."""
    s = float(num_iterations) * start_frac
    e = float(num_iterations) * end_frac
    span = max(e - s, 1.0)
    return torch.clamp((torch.tensor(step, dtype=torch.float32) - s) / span,
                       0.0, 1.0)


def segmentation_loss(logits: Tensor, labels: Tensor, valid: Tensor,
                      ce_weight: float = 1.0, dice_weight: float = 1.0,
                      bootstrap_ratio: float = 1.0,
                      bootstrap_weight: float | Tensor = 1.0,
                      valid_total: Optional[Tensor] = None, world: int = 1
                      ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """CE (bootstrapped when ``bootstrap_ratio`` < 1) + soft Dice.

    logits (B, T, H, W, K) fp32; labels (B, T, H, W) int; valid (B, T).
    ``valid_total``, ``world``: this rank's share of a global batch (see the
    module docstring).  → (loss, {"loss", "ce", "dice_loss"}).
    """
    ce, dl = _ce_dice_terms(logits, labels, valid, eps=1.0,
                            bootstrap_ratio=bootstrap_ratio,
                            bootstrap_weight=bootstrap_weight,
                            valid_total=valid_total, world=world)
    loss = ce_weight * ce + dice_weight * dl
    return loss, {"loss": loss, "ce": ce, "dice_loss": dl}
