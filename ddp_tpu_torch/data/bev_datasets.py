"""BEV map-segmentation data (port of ``ddp_tpu/data/bev_datasets.py:24-110,
361-421``).

  - ``SyntheticBEVDataset``: a procedural camera rig (N outward-looking
    cameras 1.5 m above the ground) with coloured discs on the ground plane,
    painted both into the camera images (projected) and into the BEV class
    masks, so that the camera -> BEV pipeline is learnable without real data.
  - ``apply_bev_aug``: the train-time 3D aug of one sample (ImageAug3D,
    GridMask, GlobalRotScaleTrans with the masks resampled), through
    ``data/transforms_3d.py``.
  - ``bev_batch_iterator``: normalised, augmented batches of
    ``BEV_BATCH_KEYS``, bitwise the JAX iterator's.

A sample is a dict of float32 arrays: ``image`` [N, H, W, 3] (0-255),
``cam2lidar_rots`` [N, 3, 3], ``cam2lidar_trans`` [N, 3], ``intrins``
[N, 3, 3], ``post_rots`` [N, 3, 3], ``post_trans`` [N, 3] and ``label``
[G, G, K] (binary masks, row = x index). The nuScenes reader
(``NuScenesBEVDataset``) comes with the fusion slice (ROADMAP.md queue 1).
"""
from __future__ import annotations

from typing import Dict

import numpy as np

BEV_BATCH_KEYS = ("image", "cam2lidar_rots", "cam2lidar_trans", "intrins", "post_rots",
                  "post_trans", "label")


def _look_at_ground() -> np.ndarray:
    """Camera-frame axes (x right, y down, z forward) -> the ego frame."""
    return np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], np.float32).T


class SyntheticBEVDataset:
    """``num_cams`` outward-facing cameras around the ego; coloured discs on
    the ground plane appear both in the images and in the BEV class masks.
    Sample ``idx`` is drawn from ``np.random.default_rng(idx)``."""

    def __init__(self, num_cams: int = 2, image_size=(32, 64), out_grid: int = 20,
                 num_classes: int = 3, scope: float = 8.0, length: int = 128):
        self.n = num_cams
        self.image_size = image_size
        self.out_grid = out_grid
        self.k = num_classes
        self.scope = scope
        self.length = length

    def __len__(self):
        return self.length

    def rig(self):
        """(cam2lidar rots, trans, intrins, post rots, post trans) of the rig."""
        h, w = self.image_size
        intr = np.zeros((self.n, 3, 3), np.float32)
        intr[:, 0, 0] = intr[:, 1, 1] = w * 0.6
        intr[:, 0, 2] = (w - 1) / 2.0
        intr[:, 1, 2] = (h - 1) / 2.0
        intr[:, 2, 2] = 1.0
        rots = np.zeros((self.n, 3, 3), np.float32)
        look = _look_at_ground()
        for i in range(self.n):
            ang = 2 * np.pi * i / self.n
            c, s = np.cos(ang), np.sin(ang)
            rz = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
            rots[i] = rz @ look
        trans = np.zeros((self.n, 3), np.float32)
        trans[:, 2] = 1.5  # camera height
        eye = np.tile(np.eye(3, dtype=np.float32), (self.n, 1, 1))
        zero = np.zeros((self.n, 3), np.float32)
        return rots, trans, intr, eye, zero

    def load(self, idx: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(idx)
        h, w = self.image_size
        rots, trans, intr, post_rots, post_trans = self.rig()
        img = np.full((self.n, h, w, 3), 60.0, np.float32)
        masks = np.zeros((self.out_grid, self.out_grid, self.k), np.float32)
        cell = 2 * self.scope / self.out_grid
        for _ in range(6):
            cls = int(rng.integers(0, self.k))
            px, py = rng.uniform(-self.scope * 0.8, self.scope * 0.8, 2)
            rad = rng.uniform(0.5, 1.5)
            # BEV mask: the cells within rad of (px, py); grid row = x index
            xs = (np.arange(self.out_grid) + 0.5) * cell - self.scope
            dx = xs[:, None] - px
            dy = xs[None, :] - py
            masks[..., cls] = np.maximum(masks[..., cls], (dx ** 2 + dy ** 2 < rad ** 2))
            # painted into each camera that sees it
            color = np.zeros(3)
            color[cls % 3] = 255.0
            for ci in range(self.n):
                pt_cam = rots[ci].T @ (np.array([px, py, 0.0]) - trans[ci])
                if pt_cam[2] < 0.5:
                    continue
                uvw = intr[ci] @ pt_cam
                u, v = uvw[0] / uvw[2], uvw[1] / uvw[2]
                if 0 <= u < w and 0 <= v < h:
                    ui, vi = int(u), int(v)
                    r = max(1, int(rad * intr[ci, 0, 0] / pt_cam[2]))
                    img[ci, max(0, vi - r):vi + r, max(0, ui - r):ui + r] = color
        img += rng.normal(0, 2.0, img.shape)
        return {"image": img.astype(np.float32), "cam2lidar_rots": rots,
                "cam2lidar_trans": trans, "intrins": intr, "post_rots": post_rots,
                "post_trans": post_trans, "label": masks.astype(np.float32)}


def apply_bev_aug(s: Dict[str, np.ndarray], rng: np.random.Generator,
                  scope: float) -> Dict[str, np.ndarray]:
    """The train-time 3D aug of one sample, in place: ImageAug3D (the
    images' own size, resize 0.95-1.1, bottom crop 0-5 %, ±5.4°, no flip),
    GridMask (p 0.3), and GlobalRotScaleTrans (scale 0.95-1.05, ±0.3 rad,
    translation σ 0.2) composed into cam2lidar with the masks resampled
    under it."""
    from .transforms_3d import (ImageAug3DConfig, global_rot_scale_trans, grid_mask,
                                image_aug_3d, rotate_bev_masks)

    h, w = s["image"].shape[1:3]
    cfg = ImageAug3DConfig(final_dim=(h, w), resize_lim=(0.95, 1.1), bot_pct_lim=(0.0, 0.05),
                           rot_lim=(-5.4, 5.4), rand_flip=False)
    s["image"], s["post_rots"], s["post_trans"] = image_aug_3d(
        s["image"], s["post_rots"], s["post_trans"], rng, cfg, is_train=True)
    s["image"] = grid_mask(s["image"], rng, prob=0.3)
    _, m = global_rot_scale_trans(rng, None, resize_lim=(0.95, 1.05), rot_lim=(-0.3, 0.3),
                                  trans_lim=0.2)
    # cam -> lidar composed into the augmented lidar frame
    s["cam2lidar_rots"] = np.einsum("ij,njk->nik", m[:3, :3], s["cam2lidar_rots"])
    s["cam2lidar_trans"] = s["cam2lidar_trans"] @ m[:3, :3].T + m[:3, 3]
    s["label"] = rotate_bev_masks(s["label"], m, scope)
    return s


def bev_batch_iterator(ds, batch_size: int, seed: int = 0, mean=(123.675, 116.28, 103.53),
                       std=(58.395, 57.12, 57.375), rank: int = 0, world: int = 1):
    """Endless train batches of ``BEV_BATCH_KEYS`` (images normalised), each
    epoch in the order of ``default_rng(seed + epoch).permutation``, each
    sample through ``apply_bev_aug`` drawn from ``default_rng((seed, epoch,
    idx))`` (the JAX iterator with ``aug=True``, as its ``make_train_iter``
    calls it). ``batch_size`` is global: with ``world`` > 1 each process
    yields its rank's slice."""
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    if batch_size % world:
        raise ValueError(f"batch {batch_size} does not split over {world} processes")
    local = batch_size // world
    epoch, cursor = 0, 0
    while True:
        order = np.random.default_rng(seed + epoch).permutation(len(ds))
        batch = {k: [] for k in BEV_BATCH_KEYS}
        for i in range(rank * local, (rank + 1) * local):
            idx = int(order[(cursor + i) % len(ds)])
            s = apply_bev_aug(ds.load(idx), np.random.default_rng((seed, epoch, idx)),
                              scope=ds.scope)
            s["image"] = (s["image"] - mean) / std
            for k in BEV_BATCH_KEYS:
                batch[k].append(s[k])
        yield {k: np.stack(v) for k, v in batch.items()}
        cursor += batch_size
        if cursor >= len(ds):
            cursor, epoch = 0, epoch + 1
