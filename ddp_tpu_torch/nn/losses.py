"""Segmentation, depth and BEV losses (port of ``ddp_tpu/nn/losses.py``).

  - ``cross_entropy_seg``: pixel CE with ignore_index and mmseg's historical
    averaging (the NLL summed over valid pixels / all pixels).
  - ``seg_accuracy``: top-1 over valid pixels (argmax, first index wins).
  - ``cross_entropy_seg_upsampled``: CE of the x``scale`` bilinear upsample
    without materialising it: the plain version of the fused upsample+CE
    kernel (``ops/upsample_ce.py``), computed phase by phase.
  - ``sig_loss``: the depther's scale-invariant log loss (SigLoss).
  - ``sigmoid_focal_loss``: the BEV map head's per-class loss (mmcv's,
    element-wise, no reduction).
  - The compat zoo's region and depth losses (``losses.py:200-397``):
    ``dice_loss``, ``tversky_loss``, ``lovasz_softmax``, ``lovasz_hinge``,
    ``focal_seg_loss`` (mmseg's), ``bins_chamfer_loss`` (AdaBins),
    ``mse_depth_loss`` and ``ce_bins_loss`` (the depth toolbox's). Ignored
    pixels are masked, never indexed away, as in JAX: the shapes do not
    depend on the labels. The Lovász losses sort with
    ``torch.sort(stable=True)``, as JAX's ``sort_key_val`` is stable, so ties
    keep the same order (the loss does not depend on it; its gradient
    does).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..ops.upsample_ce import global_accuracy, upsample_ce_fwd_plain
from ..parallel.global_batch import active_world, all_reduce_sum, sum_over_ranks


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
    """Correct over valid pixels; in a data-parallel step, of the global
    batch."""
    valid = labels != ignore_index
    correct = valid & (torch.argmax(logits, dim=-1) == labels)
    counts = sum_over_ranks(torch.stack([correct.sum(), valid.sum()]))
    return counts[0] / torch.clamp(counts[1], min=1)


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
        return loss, global_accuracy(sums[2], sums[1])
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
    g = torch.log(pred + eps) - torch.log(torch.where(valid, gt, 1.0) + eps)
    g = torch.where(valid, g, 0.0)
    if active_world()[1] > 1:
        # over the global batch (as JAX's over a mesh-sharded one): one
        # all-reduce of (Σg², Σg, n)
        sums = all_reduce_sum(torch.stack([(g * g).sum(), g.sum(),
                                           valid.sum().to(g.dtype)]))
        n = torch.clamp(sums[2], min=1)
        dg = sums[0] / n - lam * (sums[1] / n) ** 2
    else:
        n = torch.clamp(valid.sum(), min=1)
        dg = (g * g).sum() / n - lam * (g.sum() / n) ** 2
    return torch.sqrt(torch.clamp(dg, min=1e-12))


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor, alpha: float = 0.25,
                       gamma: float = 2.0) -> torch.Tensor:
    """Per-element sigmoid focal loss (mmcv semantics), no reduction;
    ``targets`` in {0, 1}, the logits' shape."""
    p = torch.sigmoid(logits)
    ce = -(targets * F.logsigmoid(logits) + (1.0 - targets) * F.logsigmoid(-logits))
    p_t = p * targets + (1.0 - p) * (1.0 - targets)
    alpha_t = alpha * targets + (1.0 - alpha) * (1.0 - targets)
    return alpha_t * ((1.0 - p_t) ** gamma) * ce


# ---------------------------------------------------------------------------
# the compat zoo's region losses (mmseg dice / tversky / lovasz / focal)
# ---------------------------------------------------------------------------


def _one_hot_valid(labels: torch.Tensor, num_classes: int, ignore_index: int):
    """(one-hot [..., K] float32 with ignored pixels all 0, valid [...])."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    oh = F.one_hot(safe.long(), num_classes).to(torch.float32)
    return oh * valid[..., None], valid


def _flat_probs_targets(logits: torch.Tensor, labels: torch.Tensor, ignore_index: int):
    """softmax probs, one-hot targets [B, N, K] and the valid mask [B, N, 1]."""
    k = logits.shape[-1]
    probs = torch.softmax(logits, dim=-1)
    oh, valid = _one_hot_valid(labels, k, ignore_index)
    b = logits.shape[0]
    return (probs.reshape(b, -1, k), oh.reshape(b, -1, k),
            valid.reshape(b, -1, 1).to(probs.dtype))


def dice_loss(logits: torch.Tensor, labels: torch.Tensor, smooth: float = 1.0,
              exponent: float = 2.0, class_weight: Optional[torch.Tensor] = None,
              ignore_index: int = 255) -> torch.Tensor:
    """Multi-class dice (mmseg dice_loss.py:13-47): softmax probs, a binary
    dice per class and image over its pixels (the numerator masked, the
    denominator not, as in JAX), the mean over classes and images."""
    p, t, m = _flat_probs_targets(logits, labels, ignore_index)
    num = 2.0 * (p * t * m).sum(dim=1) + smooth
    den = (p ** exponent + t ** exponent).sum(dim=1) + smooth
    per_class = 1.0 - num / den
    if class_weight is not None:
        per_class = per_class * class_weight[None, :]
    return per_class.mean()


def tversky_loss(logits: torch.Tensor, labels: torch.Tensor, alpha: float = 0.3,
                 beta: float = 0.7, smooth: float = 1.0,
                 class_weight: Optional[torch.Tensor] = None,
                 ignore_index: int = 255) -> torch.Tensor:
    """Tversky loss (mmseg tversky_loss.py:14-58): dice with separate FP
    (``alpha``) and FN (``beta``) weights."""
    p, t, m = _flat_probs_targets(logits, labels, ignore_index)
    tp = (p * t * m).sum(dim=1)
    fp = (p * (1.0 - t) * m).sum(dim=1)
    fn = ((1.0 - p) * t * m).sum(dim=1)
    per_class = 1.0 - (tp + smooth) / (tp + alpha * fp + beta * fn + smooth)
    if class_weight is not None:
        per_class = per_class * class_weight[None, :]
    return per_class.mean()


def _lovasz_grad(gt_sorted: torch.Tensor) -> torch.Tensor:
    """Gradient of the Lovász extension with respect to the sorted errors
    (lovasz_loss.py:15-27), along dim 0 (each further index is its own
    problem)."""
    gts = gt_sorted.sum(dim=0)
    intersection = gts - torch.cumsum(gt_sorted, dim=0)
    union = gts + torch.cumsum(1.0 - gt_sorted, dim=0)
    jaccard = 1.0 - intersection / torch.clamp_min(union, 1e-12)
    return torch.cat([jaccard[:1], jaccard[1:] - jaccard[:-1]], dim=0)


def _sorted_desc(err: torch.Tensor, values: torch.Tensor):
    """``err`` sorted descending along dim 0 (stably: ``sort_key_val`` of
    −err) and ``values`` in the same order."""
    keys, idx = torch.sort(-err, dim=0, stable=True)
    return -keys, values.gather(0, idx)


def lovasz_softmax(logits: torch.Tensor, labels: torch.Tensor, classes: str = "present",
                   ignore_index: int = 255) -> torch.Tensor:
    """Multi-class Lovász-Softmax over the whole batch (mmseg
    lovasz_loss.py:129-224, per_image=False): an ignored pixel's error is 0,
    so it sorts behind the valid ones and adds 0. ``classes``: 'present'
    (the mean over the classes present in the labels) or 'all'."""
    k = logits.shape[-1]
    probs = torch.softmax(logits, dim=-1).reshape(-1, k)
    flat = labels.reshape(-1)
    valid = flat != ignore_index
    classes_ = torch.arange(k, device=logits.device)
    fg = ((flat[:, None] == classes_[None]) & valid[:, None]).to(probs.dtype)  # [N, K]
    err = torch.where(valid[:, None], (fg - probs).abs(), torch.zeros((), dtype=probs.dtype,
                                                                        device=probs.device))
    err_sorted, fg_sorted = _sorted_desc(err, fg)
    losses = (err_sorted * _lovasz_grad(fg_sorted)).sum(dim=0)
    if classes == "present":
        w = (fg.sum(dim=0) > 0).to(losses.dtype)
        return (losses * w).sum() / torch.clamp_min(w.sum(), 1.0)
    return losses.mean()


def lovasz_hinge(logits: torch.Tensor, labels: torch.Tensor, ignore_index: int = 255,
                 per_image: bool = True) -> torch.Tensor:
    """Binary Lovász hinge (lovasz_loss.py:60-126): logits and labels in
    {0, 1} [B, H, W]; per image and averaged (``per_image``), or over the
    whole batch at once. An ignored pixel's error is −1e9 (last, and 0
    after the ReLU)."""
    b = logits.shape[0] if per_image else 1
    flat = logits.reshape(b, -1).t()  # [N, images]
    lab = labels.reshape(b, -1).t()
    valid = lab != ignore_index
    lab_f = lab.to(flat.dtype)
    err = torch.where(valid, 1.0 - flat * (2.0 * lab_f - 1.0),
                      torch.full((), -1e9, dtype=flat.dtype, device=flat.device))
    err_sorted, lab_sorted = _sorted_desc(err, lab_f)
    lab_sorted = torch.where(err_sorted > -1e8, lab_sorted, torch.zeros_like(lab_sorted))
    return (F.relu(err_sorted) * _lovasz_grad(lab_sorted)).sum(dim=0).mean()


def focal_seg_loss(logits: torch.Tensor, labels: torch.Tensor, gamma: float = 2.0,
                   alpha: float = 0.5, ignore_index: int = 255) -> torch.Tensor:
    """mmseg FocalLoss (sigmoid, one-hot targets over the K classes): the sum
    over valid pixels and classes / the valid pixels."""
    oh, valid = _one_hot_valid(labels, logits.shape[-1], ignore_index)
    per_el = sigmoid_focal_loss(logits, oh, alpha=alpha, gamma=gamma) * valid[..., None]
    return per_el.sum() / torch.clamp_min(valid.sum() * 1.0, 1.0)


# ---------------------------------------------------------------------------
# depth losses beyond SigLoss (depth/depth/models/losses/)
# ---------------------------------------------------------------------------


def bins_chamfer_loss(bin_edges: torch.Tensor, gt_depth: torch.Tensor,
                      min_valid: float = 1e-3) -> torch.Tensor:
    """Bidirectional chamfer between the bin centres [B, N] and the valid
    ground-truth depths (chamferloss.py:27-39, AdaBins): invalid pixels
    (depth ≤ ``min_valid``) are masked out of both directions; an image
    without one adds 0 to the batch mean."""
    centers = 0.5 * (bin_edges[:, 1:] + bin_edges[:, :-1])
    target = gt_depth.reshape(gt_depth.shape[0], -1)
    mask = target > min_valid
    d2 = (centers[:, :, None] - target[:, None, :]) ** 2  # [B, N, M]
    big = torch.full((), 1e12, dtype=d2.dtype, device=d2.device)
    loss_x = torch.where(mask[:, None, :], d2, big).amin(dim=2).mean(dim=1)
    denom = torch.clamp_min(mask.sum(dim=1), 1)
    loss_y = torch.where(mask, d2.amin(dim=1), torch.zeros_like(big)).sum(dim=1) / denom
    has_valid = (mask.sum(dim=1) > 0).to(loss_x.dtype)
    return ((loss_x + loss_y) * has_valid).mean()


def mse_depth_loss(pred: torch.Tensor, gt: torch.Tensor,
                   valid_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked MSE (mseloss.py): ``valid_mask`` defaults to gt > 0."""
    if valid_mask is None:
        valid_mask = gt > 0
    se = torch.where(valid_mask, (pred - gt) ** 2, torch.zeros((), dtype=pred.dtype,
                                                                device=pred.device))
    return se.sum() / torch.clamp_min(valid_mask.sum(), 1)


def ce_bins_loss(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Plain CE over bin classes (celoss.py:38-46, BinsFormer's auxiliary)."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, target[..., None].long())[..., 0].mean()
