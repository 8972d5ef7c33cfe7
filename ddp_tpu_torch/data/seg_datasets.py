"""Segmentation data (port of ``ddp_tpu/data/seg_datasets.py``; numpy only).

  - ``SegDataset``: ADE20K (150 classes, ``reduce_zero_label``: 0 -> 255, the
    rest shift by -1) and Cityscapes (labelIds -> the 19 trainIds) file lists
    (mmseg's ``ADE20KDataset`` and ``CityscapesDataset``);
  - ``SyntheticSegDataset``, the procedural dataset;
  - ``seg_batch_iterator``, the train batch iterator.

Files are read by ``data/image_io.py: read_image`` (Pillow where it is
installed; without it a PNG by the port's own decoder and no JPEG), which
gives exactly Pillow's pixels, so every sample is the JAX package's.

The iterator is deterministic and seeded: the epoch's order is a
permutation seeded by ``seed + epoch`` and each sample's augmentation draws
from ``default_rng((seed, epoch, index))``, so any batch is reproducible
from (seed, step) alone, on every process of a multi-process run.
"""
from __future__ import annotations

import os
import queue as queue_mod
import threading
from typing import Callable, Dict, Iterator, List, Tuple

import numpy as np

from .image_io import read_image
from .pipelines import seg_train_pipeline

# Cityscapes labelId -> trainId (34 entries; 255 = ignore)
CITYSCAPES_LABEL2TRAIN = np.full(256, 255, np.int32)
for _lid, _tid in [(7, 0), (8, 1), (11, 2), (12, 3), (13, 4), (17, 5), (19, 6),
                   (20, 7), (21, 8), (22, 9), (23, 10), (24, 11), (25, 12),
                   (26, 13), (27, 14), (28, 15), (31, 16), (32, 17), (33, 18)]:
    CITYSCAPES_LABEL2TRAIN[_lid] = _tid


class SegDataset:
    """File-list dataset with task-specific label decoding."""

    def __init__(self, data_root: str, split: str = "train", dataset: str = "ade20k"):
        self.dataset = dataset
        self.data_root = data_root
        self.split = split
        self.items = self._index()

    def _index(self) -> List[Tuple[str, str]]:
        r = self.data_root
        pairs = []
        if self.dataset == "ade20k":
            sub = "training" if self.split == "train" else "validation"
            img_dir = os.path.join(r, "images", sub)
            ann_dir = os.path.join(r, "annotations", sub)
            if os.path.isdir(img_dir):
                for f in sorted(os.listdir(img_dir)):
                    if f.endswith(".jpg"):
                        pairs.append((os.path.join(img_dir, f),
                                      os.path.join(ann_dir, f[:-4] + ".png")))
        elif self.dataset == "cityscapes":
            img_dir = os.path.join(r, "leftImg8bit", self.split)
            ann_dir = os.path.join(r, "gtFine", self.split)
            if os.path.isdir(img_dir):
                for city in sorted(os.listdir(img_dir)):
                    for f in sorted(os.listdir(os.path.join(img_dir, city))):
                        if f.endswith("_leftImg8bit.png"):
                            ann = f.replace("_leftImg8bit.png", "_gtFine_labelIds.png")
                            pairs.append((os.path.join(img_dir, city, f),
                                          os.path.join(ann_dir, city, ann)))
        else:
            raise ValueError(f"unknown dataset {self.dataset!r}")
        return pairs

    def __len__(self):
        return len(self.items)

    def load(self, idx: int) -> Dict[str, np.ndarray]:
        img_path, ann_path = self.items[idx]
        img = read_image(img_path, rgb=True).astype(np.float32)
        label = read_image(ann_path).astype(np.int32)
        if self.dataset == "ade20k":
            # reduce_zero_label: 0 (background) -> 255, shift others by -1
            label = np.where(label == 0, 255, label - 1).astype(np.int32)
        elif self.dataset == "cityscapes":
            label = CITYSCAPES_LABEL2TRAIN[np.clip(label, 0, 255)]
        return {"image": img, "label": label}


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


def seg_batch_iterator(
    ds, batch_size: int, crop: Tuple[int, int], seed: int = 0,
    mean=(123.675, 116.28, 103.53), std=(58.395, 57.12, 57.375),
    ratio_range=(0.5, 2.0), cat_max_ratio=0.75, flip_prob=0.5,
    rank: int = 0, world: int = 1,
) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite train batch iterator (the seg train pipeline at img_scale
    (2048, crop[0])) with a background thread that keeps two batches ready.

    ``batch_size`` is global. With world > 1 each process yields only its
    rank's contiguous slice of every global batch (the same seed-folded order
    and per-sample augmentation streams on every process, so the global batch
    is consistent, as a DistributedSampler's)."""
    img_scale = (2048, crop[0])
    if batch_size % world:
        raise ValueError(f"global batch {batch_size} does not split over {world} processes")
    local = batch_size // world

    def make_batch(epoch: int, start: int) -> Dict[str, np.ndarray]:
        order = np.random.default_rng(seed + epoch).permutation(len(ds))
        imgs, labels = [], []
        for i in range(rank * local, (rank + 1) * local):
            idx = int(order[(start + i) % len(ds)])
            rng = np.random.default_rng((seed, epoch, idx))
            sample = seg_train_pipeline(
                ds.load(idx), rng, crop, img_scale, ratio_range, cat_max_ratio,
                flip_prob, mean, std)
            imgs.append(sample["image"][: crop[0], : crop[1]])
            labels.append(sample["label"][: crop[0], : crop[1]])
        return {"image": np.stack(imgs), "label": np.stack(labels)}

    return prefetched(make_batch, len(ds), batch_size)


def prefetched(make_batch: Callable[[int, int], Dict[str, np.ndarray]], length: int,
               batch_size: int) -> Iterator[Dict[str, np.ndarray]]:
    """The infinite sequence make_batch(epoch, start), start stepping by
    ``batch_size`` through an epoch of ``length`` samples, made by a
    background thread that keeps two batches ready."""
    def gen():
        epoch, cursor = 0, 0
        while True:
            yield make_batch(epoch, cursor)
            cursor += batch_size
            if cursor >= length:
                cursor = 0
                epoch += 1

    q: queue_mod.Queue = queue_mod.Queue(maxsize=2)
    stop = threading.Event()

    def worker():
        for b in gen():
            if stop.is_set():
                return
            q.put(b)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            yield q.get()
    finally:
        stop.set()
