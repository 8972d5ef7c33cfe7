"""Segmentation data (port of ``ddp_tpu/data/seg_datasets.py``; numpy only).

  - ``SegDataset``: ADE20K (150 classes, ``reduce_zero_label``: 0 -> 255, the
    rest shift by -1) and Cityscapes (labelIds -> the 19 trainIds) file lists
    (mmseg's ``ADE20KDataset`` and ``CityscapesDataset``);
  - ``SyntheticSegDataset``, the procedural dataset;
  - ``seg_batch_iterator``, the batch iterator (the train pipeline, or
    normalise and pad);
  - the metadata the tools render with (``PALETTES``, ``NUM_CLASSES``),
    ``normalize_image``, the generic folder dataset ``CustomSegDataset``,
    the ``RepeatDataset`` and ``ConcatDataset`` wrappers, and
    ``build_eval_dataset`` (``ddp_tpu/data/seg_datasets.py:186-330``).

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
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from .image_io import read_image
from .pipelines import normalize, pad_to, seg_train_pipeline

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
    img_scale: Optional[Tuple[int, int]] = None, train: bool = True,
    mean=(123.675, 116.28, 103.53), std=(58.395, 57.12, 57.375),
    ratio_range=(0.5, 2.0), cat_max_ratio=0.75, flip_prob=0.5,
    prefetch: int = 2, rank: int = 0, world: int = 1,
) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite batch iterator: with ``train`` the seg train pipeline at
    ``img_scale`` (default (2048, crop[0])), else each sample normalised and
    padded to ``crop``, then cut to ``crop``; a background thread keeps
    ``prefetch`` batches ready (0: no thread, each batch made when asked).

    ``batch_size`` is global. With world > 1 each process yields only its
    rank's contiguous slice of every global batch (the same seed-folded order
    and per-sample augmentation streams on every process, so the global batch
    is consistent, as a DistributedSampler's)."""
    img_scale = img_scale or (2048, crop[0])
    if batch_size % world:
        raise ValueError(f"global batch {batch_size} does not split over {world} processes")
    local = batch_size // world

    def make_batch(epoch: int, start: int) -> Dict[str, np.ndarray]:
        order = np.random.default_rng(seed + epoch).permutation(len(ds))
        imgs, labels = [], []
        for i in range(rank * local, (rank + 1) * local):
            idx = int(order[(start + i) % len(ds)])
            sample = ds.load(idx)
            if train:
                rng = np.random.default_rng((seed, epoch, idx))
                sample = seg_train_pipeline(sample, rng, crop, img_scale, ratio_range,
                                            cat_max_ratio, flip_prob, mean, std)
            else:
                sample = pad_to(normalize(sample, mean, std), crop)
            imgs.append(sample["image"][: crop[0], : crop[1]])
            labels.append(sample["label"][: crop[0], : crop[1]])
        return {"image": np.stack(imgs), "label": np.stack(labels)}

    return prefetched(make_batch, len(ds), batch_size, prefetch)


def prefetched(make_batch: Callable[[int, int], Dict[str, np.ndarray]], length: int,
               batch_size: int, depth: int = 2) -> Iterator[Dict[str, np.ndarray]]:
    """The infinite sequence make_batch(epoch, start), start stepping by
    ``batch_size`` through an epoch of ``length`` samples, made by a
    background thread that keeps ``depth`` batches ready (0: made in the
    caller's thread when asked)."""
    def gen():
        epoch, cursor = 0, 0
        while True:
            yield make_batch(epoch, cursor)
            cursor += batch_size
            if cursor >= length:
                cursor = 0
                epoch += 1

    if depth <= 0:
        yield from gen()
        return
    q: queue_mod.Queue = queue_mod.Queue(maxsize=depth)
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


# ---------------------------------------------------------------------------
# metadata, the generic folder dataset and the wrappers (mmseg custom.py and
# dataset_wrappers.py)
# ---------------------------------------------------------------------------

CITYSCAPES_CLASSES = (
    "road", "sidewalk", "building", "wall", "fence", "pole", "traffic light",
    "traffic sign", "vegetation", "terrain", "sky", "person", "rider", "car",
    "truck", "bus", "train", "motorcycle", "bicycle")

CITYSCAPES_PALETTE = [
    [128, 64, 128], [244, 35, 232], [70, 70, 70], [102, 102, 156],
    [190, 153, 153], [153, 153, 153], [250, 170, 30], [220, 220, 0],
    [107, 142, 35], [152, 251, 152], [70, 130, 180], [220, 20, 60],
    [255, 0, 0], [0, 0, 142], [0, 0, 70], [0, 60, 100], [0, 80, 100],
    [0, 0, 230], [119, 11, 32]]


def voc_palette(n: int = 21) -> List[List[int]]:
    """The PASCAL-VOC palette (its bit-interleave formula)."""
    pal = np.zeros((n, 3), np.uint8)
    for i in range(n):
        c, j = i, 0
        while c:
            for ch in range(3):
                pal[i, ch] |= ((c >> ch) & 1) << (7 - j)
            c >>= 3
            j += 1
    return pal.tolist()


def _procedural_palette(n: int) -> List[List[int]]:
    return np.random.default_rng(42).integers(0, 255, (n, 3)).tolist()


PALETTES = {
    "cityscapes": CITYSCAPES_PALETTE,
    "voc": voc_palette(21),
    "ade20k": _procedural_palette(150),
    "coco_stuff": _procedural_palette(171),
    "loveda": _procedural_palette(7),
    "potsdam": _procedural_palette(6),
    "vaihingen": _procedural_palette(6),
    "isaid": _procedural_palette(16),
}

NUM_CLASSES = {
    "ade20k": 150, "cityscapes": 19, "voc": 21, "coco_stuff": 171,
    "loveda": 7, "potsdam": 6, "vaihingen": 6, "isaid": 16,
}

IMAGENET_MEAN = (123.675, 116.28, 103.53)
IMAGENET_STD = (58.395, 57.12, 57.375)


def normalize_image(img: np.ndarray, mean=IMAGENET_MEAN, std=IMAGENET_STD) -> np.ndarray:
    return ((img - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)
            ).astype(np.float32)


class CustomSegDataset:
    """A generic (img_dir, ann_dir, suffixes) folder dataset, mmseg's
    ``CustomDataset`` pattern (VOC, COCO-Stuff, LoveDA, Potsdam, iSAID
    layouts through the arguments), read by ``read_image``."""

    def __init__(self, img_dir: str, ann_dir: str, img_suffix: str = ".jpg",
                 seg_map_suffix: str = ".png", reduce_zero_label: bool = False,
                 label_map: Optional[np.ndarray] = None):
        self.img_dir, self.ann_dir = img_dir, ann_dir
        self.reduce_zero_label = reduce_zero_label
        self.label_map = label_map
        self.items = []
        if os.path.isdir(img_dir):
            for f in sorted(os.listdir(img_dir)):
                if f.endswith(img_suffix):
                    self.items.append((os.path.join(img_dir, f), os.path.join(
                        ann_dir, f[:-len(img_suffix)] + seg_map_suffix)))

    def __len__(self):
        return len(self.items)

    def load(self, idx: int) -> Dict[str, np.ndarray]:
        img_path, ann_path = self.items[idx]
        img = read_image(img_path, rgb=True).astype(np.float32)
        label = read_image(ann_path).astype(np.int32)
        if self.reduce_zero_label:
            label = np.where(label == 0, 255, label - 1).astype(np.int32)
        if self.label_map is not None:
            label = self.label_map[np.clip(label, 0, 255)]
        return {"image": img, "label": label}


class RepeatDataset:
    """A dataset repeated ``times`` per epoch."""

    def __init__(self, ds, times: int):
        self.ds, self.times = ds, times

    def __len__(self):
        return len(self.ds) * self.times

    def load(self, idx: int):
        return self.ds.load(idx % len(self.ds))


class ConcatDataset:
    """Datasets one after another."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        self._cum = np.cumsum([len(d) for d in self.datasets])

    def __len__(self):
        return int(self._cum[-1])

    def load(self, idx: int):
        di = int(np.searchsorted(self._cum, idx, side="right"))
        prev = 0 if di == 0 else int(self._cum[di - 1])
        return self.datasets[di].load(idx - prev)


def build_eval_dataset(data_cfg) -> Iterator[Dict[str, np.ndarray]]:
    """The val samples of a DataConfig, each image ``normalize_image``d
    (ImageNet statistics): 64 synthetic ones, or the ``val`` split of an
    ADE20K or Cityscapes tree."""
    if data_cfg.dataset == "synthetic":
        ds = SyntheticSegDataset(length=64)
    else:
        ds = SegDataset(data_cfg.data_root, split="val", dataset=data_cfg.dataset)
    for i in range(len(ds)):
        s = ds.load(i)
        yield {"image": normalize_image(s["image"]), "label": s["label"]}
