"""Segmentation losses (port of ``ddp_tpu/nn/losses.py:19-163``).

  - ``cross_entropy_seg``: pixel CE with ignore_index and mmseg's historical
    averaging (the NLL summed over valid pixels / all pixels).
  - ``seg_accuracy``: top-1 over valid pixels (argmax, first index wins).
  - ``cross_entropy_seg_upsampled``: CE of the x``scale`` bilinear upsample
    without materialising it: the plain version of the fused upsample+CE
    kernel (``ops/upsample_ce.py``), computed phase by phase.
"""
from __future__ import annotations

import torch

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
