"""Segmentation, depth and BEV losses (port of ``ddp_tpu/nn/losses.py:19-206``).

  - ``cross_entropy_seg``: pixel CE with ignore_index and mmseg's historical
    averaging (the NLL summed over valid pixels / all pixels).
  - ``seg_accuracy``: top-1 over valid pixels (argmax, first index wins).
  - ``cross_entropy_seg_upsampled``: CE of the x``scale`` bilinear upsample
    without materialising it: the plain version of the fused upsample+CE
    kernel (``ops/upsample_ce.py``), computed phase by phase.
  - ``sig_loss``: the depther's scale-invariant log loss (SigLoss).
  - ``sigmoid_focal_loss``: the BEV map head's per-class loss (mmcv's,
    element-wise, no reduction).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..ops.upsample_ce import upsample_ce_fwd_plain


def cross_entropy_seg(logits: torch.Tensor, labels: torch.Tensor,
                      ignore_index: int = 255) -> torch.Tensor:
    """logits [B, H, W, K], labels [B, H, W] int; mean over ALL pixels."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, safe[..., None].long())[..., 0]
    return torch.where(valid, nll, torch.zeros_like(nll)).sum() / labels.numel()


def seg_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                 ignore_index: int = 255) -> torch.Tensor:
    valid = labels != ignore_index
    correct = valid & (torch.argmax(logits, dim=-1) == labels)
    return correct.sum() / torch.clamp(valid.sum(), min=1)


def cross_entropy_seg_upsampled(logits: torch.Tensor, labels: torch.Tensor, scale: int,
                                ignore_index: int = 255, align_corners: bool = False,
                                with_acc: bool = False):
    """CE of the x``scale`` bilinear upsample (align_corners=False) of logits
    [B, h, w, K] against labels [B, s·h, s·w]; loss, or (loss, accuracy).
    Differentiable through autograd."""
    if align_corners:
        raise ValueError("the phase decomposition covers align_corners=False only")
    sums, _ = upsample_ce_fwd_plain(logits, labels, scale, ignore_index)
    loss = sums[0] / labels.numel()
    if with_acc:
        return loss, sums[2] / torch.clamp(sums[1], min=1.0)
    return loss


def sig_loss(pred: torch.Tensor, gt: torch.Tensor, valid: Optional[torch.Tensor] = None,
             lam: float = 0.85, eps: float = 1e-3) -> torch.Tensor:
    """sqrt(E[g²] − λ·E[g]²) over the valid pixels, g = log(pred + eps) −
    log(gt + eps) (depth/depth/models/losses/sigloss.py:41-53). pred and gt
    [B, H, W] metric depth; ``valid`` defaults to gt > 0. Masked, not
    indexed, and with no host read, so that a CUDA graph can hold it: with no
    valid pixel it is sqrt(1e-12)."""
    if valid is None:
        valid = gt > 0
    n = torch.clamp(valid.sum(), min=1)
    g = torch.log(pred + eps) - torch.log(torch.where(valid, gt, 1.0) + eps)
    g = torch.where(valid, g, 0.0)
    dg = (g * g).sum() / n - lam * (g.sum() / n) ** 2
    return torch.sqrt(torch.clamp(dg, min=1e-12))


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-element sigmoid focal loss (mmcv semantics, alpha 0.25, gamma 2),
    no reduction; ``targets`` in {0, 1}, the logits' shape."""
    alpha = 0.25
    p = torch.sigmoid(logits)
    ce = -(targets * F.logsigmoid(logits) + (1.0 - targets) * F.logsigmoid(-logits))
    p_t = p * targets + (1.0 - p) * (1.0 - targets)
    alpha_t = alpha * targets + (1.0 - alpha) * (1.0 - targets)
    return alpha_t * ((1.0 - p_t) ** 2) * ce
