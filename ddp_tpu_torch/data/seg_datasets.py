"""Procedural segmentation data (copy of ``SyntheticSegDataset`` from
``ddp_tpu/data/seg_datasets.py:84-112``; numpy only)."""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


class SyntheticSegDataset:
    """Procedural dataset for tests/benchmarks: images with geometric regions
    whose class is a deterministic function of position + per-sample seed, so
    a model CAN learn it (non-trivial but closed-form)."""

    def __init__(self, num_classes: int = 7, size: Tuple[int, int] = (64, 64),
                 length: int = 256):
        self.num_classes = num_classes
        self.size = size
        self.length = length

    def __len__(self):
        return self.length

    def load(self, idx: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(idx)
        h, w = self.size
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        k = self.num_classes
        cx, cy = rng.uniform(0.3, 0.7, 2)
        ang = np.arctan2(yy / h - cy, xx / w - cx)
        label = ((ang + np.pi) / (2 * np.pi) * k).astype(np.int32) % k
        img = np.stack([
            np.cos(2 * np.pi * label / k),
            np.sin(2 * np.pi * label / k),
            rng.normal(0, 0.1, (h, w)),
        ], axis=-1).astype(np.float32) * 64.0 + 128.0
        img += rng.normal(0, 4.0, img.shape)
        return {"image": img.astype(np.float32), "label": label}
