"""Segmentation, depth and BEV metrics (port of ``ddp_tpu/evaluation/
metrics.py:22-110``), numpy on the host.

mmseg ``intersect_and_union`` / mIoU, aAcc, mAcc as numpy histograms, the
depth toolbox's nine metrics in float64, and the nuScenes BEV map IoU.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


def intersect_and_union(
    pred: np.ndarray, label: np.ndarray, num_classes: int, ignore_index: int = 255
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Per-class (intersection, union, pred-area, label-area) histograms."""
    mask = label != ignore_index
    pred = pred[mask]
    label = label[mask]
    inter = pred[pred == label]
    area_inter = np.bincount(inter, minlength=num_classes)[:num_classes]
    area_pred = np.bincount(pred, minlength=num_classes)[:num_classes]
    area_label = np.bincount(label, minlength=num_classes)[:num_classes]
    area_union = area_pred + area_label - area_inter
    return area_inter, area_union, area_pred, area_label


class SegMetricAccumulator:
    """Streaming mIoU/aAcc/mAcc accumulator (reference pre_eval pattern)."""

    def __init__(self, num_classes: int, ignore_index: int = 255):
        self.num_classes = num_classes
        self.ignore_index = ignore_index
        self.inter = np.zeros(num_classes, np.int64)
        self.union = np.zeros(num_classes, np.int64)
        self.pred = np.zeros(num_classes, np.int64)
        self.label = np.zeros(num_classes, np.int64)

    def update(self, pred: np.ndarray, label: np.ndarray):
        i, u, p, l = intersect_and_union(
            np.asarray(pred), np.asarray(label), self.num_classes, self.ignore_index)
        self.inter += i
        self.union += u
        self.pred += p
        self.label += l

    def compute(self) -> Dict[str, float]:
        iou = self.inter / np.maximum(self.union, 1)
        acc = self.inter / np.maximum(self.label, 1)
        present = self.label > 0
        return {
            "aAcc": float(self.inter.sum() / max(self.label.sum(), 1)),
            "mIoU": float(iou[present].mean()) if present.any() else 0.0,
            "mAcc": float(acc[present].mean()) if present.any() else 0.0,
            "IoU_per_class": iou,
        }


def depth_metrics(pred: np.ndarray, gt: np.ndarray, mask: Optional[np.ndarray] = None
                  ) -> Dict[str, float]:
    """a1-a3, abs_rel, sq_rel, rmse, rmse_log, log10 and silog over the pixels
    with gt > 0 (and ``mask``), in float64."""
    valid = gt > 0
    if mask is not None:
        valid &= mask
    p = pred[valid].astype(np.float64)
    g = gt[valid].astype(np.float64)
    thresh = np.maximum(g / p, p / g)
    err = p - g
    log_err = np.log(p) - np.log(g)
    return {
        "a1": float((thresh < 1.25).mean()),
        "a2": float((thresh < 1.25 ** 2).mean()),
        "a3": float((thresh < 1.25 ** 3).mean()),
        "abs_rel": float((np.abs(err) / g).mean()),
        "sq_rel": float((err ** 2 / g).mean()),
        "rmse": float(np.sqrt((err ** 2).mean())),
        "rmse_log": float(np.sqrt((log_err ** 2).mean())),
        "log10": float(np.abs(np.log10(p) - np.log10(g)).mean()),
        "silog": float(np.sqrt((log_err ** 2).mean() - log_err.mean() ** 2) * 100.0),
    }


def bev_map_iou(pred_scores: np.ndarray, gt_masks: np.ndarray,
                thresholds=(0.35, 0.4, 0.45, 0.5, 0.55, 0.6, 0.65)) -> Dict[str, float]:
    """nuScenes BEV map IoU of sigmoid scores [N, K, H, W] against binary
    masks [N, K, H, W]: per class the best IoU over the score thresholds
    (``iou_class{k}``), and their mean (``mIoU``)."""
    k = pred_scores.shape[1]
    per_class = np.zeros((len(thresholds), k))
    gt = gt_masks > 0.5
    for ti, t in enumerate(thresholds):
        p = pred_scores >= t
        inter = (p & gt).sum(axis=(0, 2, 3))
        union = (p | gt).sum(axis=(0, 2, 3))
        per_class[ti] = inter / np.maximum(union, 1)
    best = per_class.max(axis=0)
    out = {f"iou_class{i}": float(best[i]) for i in range(k)}
    out["mIoU"] = float(best.mean())
    return out
