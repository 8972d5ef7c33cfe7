"""Depth data (port of ``ddp_tpu/data/depth_datasets.py:25-193``; numpy only):
NYUv2, KITTI (Eigen split), SUNRGBD and Cityscapes-depth file lists, the
procedural ``SyntheticDepthDataset``, and ``depth_batch_iterator``.

The layouts (the reference toolbox's depth/depth/datasets/*.py):
  - nyu: depth PNGs in millimetres (scale 1000); evaluated on the Eigen
    crop [45:471, 41:601];
  - kitti: depth PNGs at scale 256, the KB crop (352 x 1216, bottom,
    centred) on loading; evaluated on the Garg crop;
  - sunrgbd: uint16 millimetres stored rotated left by 3 bits, clipped at
    8 m; the Eigen crop;
  - cityscapes: disparity PNGs, (raw − 1) / 256 where raw > 0, turned into
    depth by the per-image camera JSON (baseline · fx / disparity); the
    Garg crop.

Files are read by ``data/image_io.py: read_image`` (Pillow where it is
installed, else a PNG by ``read_png``, whose 16-bit grey path gives Pillow's
uint16 depth maps), so every sample is the JAX package's.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from .image_io import read_image
from .pipelines import normalize, pad_to, random_flip
from .seg_datasets import prefetched


def nyu_eval_mask(shape: Tuple[int, int]) -> np.ndarray:
    """The Eigen crop of NYU (and SUNRGBD) evaluation."""
    m = np.zeros(shape, bool)
    m[45:471, 41:601] = True
    return m


def garg_crop_mask(shape: Tuple[int, int]) -> np.ndarray:
    """The Garg crop (Adabins' convention) of KITTI evaluation."""
    h, w = shape
    m = np.zeros(shape, bool)
    m[int(0.40810811 * h):int(0.99189189 * h),
      int(0.03594771 * w):int(0.96405229 * w)] = True
    return m


def kb_crop(img: np.ndarray, depth: Optional[np.ndarray] = None):
    """The KITTI benchmark crop: 352 x 1216 from the bottom, centred."""
    h, w = img.shape[:2]
    top, left = h - 352, (w - 1216) // 2
    img = img[top:top + 352, left:left + 1216]
    if depth is not None:
        depth = depth[top:top + 352, left:left + 1216]
    return img, depth


def sunrgbd_decode_depth(raw: np.ndarray) -> np.ndarray:
    """SUNRGBD's uint16 depth: millimetres rotated left by 3 bits; rotate
    back, convert to metres and clip at 8 m (sunrgbd.py:225-229)."""
    v = raw.astype(np.uint16)
    mm = np.bitwise_or(np.right_shift(v, 3), np.left_shift(v, 13))
    return np.minimum(mm.astype(np.float32) / 1000.0, 8.0)


def cityscapes_disparity_to_depth(raw: np.ndarray, baseline: float,
                                  fx: float) -> np.ndarray:
    """Cityscapes disparity PNGs: disparity = (raw − 1) / 256 where raw > 0,
    depth = baseline · fx / disparity; 0 where raw is 0 (cityscapes.py:
    242-250)."""
    disp = (raw.astype(np.float32) - 1.0) / 256.0
    valid = raw > 0
    disp = np.where(valid & (disp > 0), disp, 1.0)
    return np.where(valid, baseline * fx / disp, 0.0).astype(np.float32)


class DepthDataset:
    """The toolbox's split files, ``<root>/<dataset>_<split>.txt``: one sample
    per line, ``image depth`` (nyu, kitti, sunrgbd; a depth of "None" skips
    the line) or ``image disparity camera`` (cityscapes), paths relative to
    the root."""

    def __init__(self, data_root: str, split: str = "train", dataset: str = "nyu"):
        if dataset not in ("nyu", "kitti", "sunrgbd", "cityscapes"):
            raise ValueError(f"unknown depth dataset {dataset!r}")
        self.dataset = dataset
        self.data_root = data_root
        self.split = split
        self.depth_scale = 1000.0 if dataset in ("nyu", "sunrgbd") else 256.0
        self.items = self._index()

    def _index(self) -> List[Tuple[str, ...]]:
        path = os.path.join(self.data_root, f"{self.dataset}_{self.split}.txt")
        items = []
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    parts = line.split()
                    if len(parts) >= 2 and parts[1] != "None":
                        items.append(tuple(os.path.join(self.data_root, p.lstrip("/\\"))
                                           for p in parts))
        return items

    def __len__(self):
        return len(self.items)

    def load(self, idx: int) -> Dict[str, np.ndarray]:
        item = self.items[idx]
        img = read_image(item[0], rgb=True).astype(np.float32)
        raw = read_image(item[1])
        if self.dataset == "sunrgbd":
            depth = sunrgbd_decode_depth(raw)
        elif self.dataset == "cityscapes":
            with open(item[2]) as f:
                cam = json.load(f)
            depth = cityscapes_disparity_to_depth(raw, cam["extrinsic"]["baseline"],
                                                  cam["intrinsic"]["fx"])
        else:
            depth = raw.astype(np.float32) / self.depth_scale
        if self.dataset == "kitti":
            img, depth = kb_crop(img, depth)
        return {"image": img, "label": depth.astype(np.float32)}


def eval_mask(dataset: str, shape: Tuple[int, int]) -> np.ndarray:
    """The evaluation crop of ``dataset``: Eigen for nyu and sunrgbd, Garg
    for kitti and cityscapes, every pixel otherwise (``tools/test.py``)."""
    if dataset in ("nyu", "sunrgbd"):
        return nyu_eval_mask(shape)
    if dataset in ("kitti", "cityscapes"):
        return garg_crop_mask(shape)
    return np.ones(shape, bool)


class SyntheticDepthDataset:
    """Procedural depth: a smooth closed-form field of the image content, so
    that a model can learn it."""

    def __init__(self, size: Tuple[int, int] = (64, 64), length: int = 256,
                 max_depth: float = 10.0):
        self.size = size
        self.length = length
        self.max_depth = max_depth

    def __len__(self):
        return self.length

    def load(self, idx: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(idx)
        h, w = self.size
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        fx, fy = rng.uniform(0.5, 2.0, 2)
        phase = rng.uniform(0, 2 * np.pi)
        field = 0.5 + 0.4 * np.sin(2 * np.pi * fx * xx / w + phase) \
            * np.cos(2 * np.pi * fy * yy / h)
        depth = (0.1 + field * 0.9) * self.max_depth * 0.9
        img = np.stack([field, np.roll(field, 3, 0), np.roll(field, 3, 1)],
                       axis=-1).astype(np.float32) * 200.0 + 20.0
        img += rng.normal(0, 2.0, img.shape)
        return {"image": img.astype(np.float32), "label": depth.astype(np.float32)}


def depth_batch_iterator(ds, batch_size: int, crop: Tuple[int, int], seed: int = 0,
                         mean=(123.675, 116.28, 103.53), std=(58.395, 57.12, 57.375),
                         rank: int = 0, world: int = 1) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite depth train batches: a random crop and a flip, then
    normalise and pad to ``crop`` (depth padded with 0, invalid). The
    toolbox's NYU pipeline also rotates at random; the JAX package leaves
    that out, and so does the port (ROADMAP.md queue 3). ``batch_size`` is
    global; with world > 1 each process yields its rank's slice, seeded as
    ``seg_batch_iterator``; a background thread keeps two batches ready."""
    if batch_size % world:
        raise ValueError(f"global batch {batch_size} does not split over {world} processes")
    local = batch_size // world

    def make_batch(epoch: int, start: int) -> Dict[str, np.ndarray]:
        order = np.random.default_rng(seed + epoch).permutation(len(ds))
        imgs, deps = [], []
        for i in range(rank * local, (rank + 1) * local):
            idx = int(order[(start + i) % len(ds)])
            s = ds.load(idx)
            rng = np.random.default_rng((seed, epoch, idx))
            h, w = s["image"].shape[:2]
            ch, cw = min(crop[0], h), min(crop[1], w)
            y = rng.integers(0, h - ch + 1)
            x = rng.integers(0, w - cw + 1)
            s = {"image": s["image"][y:y + ch, x:x + cw],
                 "label": s["label"][y:y + ch, x:x + cw]}
            s = random_flip(s, rng)
            s = pad_to(normalize(s, mean, std), crop, seg_pad_val=0)
            imgs.append(s["image"][: crop[0], : crop[1]])
            deps.append(s["label"][: crop[0], : crop[1]])
        return {"image": np.stack(imgs), "label": np.stack(deps)}

    return prefetched(make_batch, len(ds), batch_size)
