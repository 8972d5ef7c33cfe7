"""BEV map-segmentation data (port of ``ddp_tpu/data/bev_datasets.py:24-358,
361-421``).

  - ``SyntheticBEVDataset``: a procedural camera rig (N outward-looking
    cameras 1.5 m above the ground) with coloured discs on the ground plane,
    painted both into the camera images (projected) and into the BEV class
    masks, so that the camera -> BEV pipeline is learnable without real data.
  - ``NuScenesBEVDataset``: BEVFusion-preprocessed nuScenes
    (``nuscenes_infos_{split}.pkl``: camera paths and calibration; the
    rasterised map masks in ``maps_bev/{token}.npz``), JPEGs read through
    Pillow, scaled to cover and cropped bottom-centre.
  - ``apply_bev_aug``: the train-time 3D aug of one sample (ImageAug3D,
    GridMask, GlobalRotScaleTrans with the masks resampled), through
    ``data/transforms_3d.py``.
  - ``bev_batch_iterator``: normalised, augmented batches of
    ``BEV_BATCH_KEYS``, bitwise the JAX iterator's.
  - Fusion (camera + lidar): ``SyntheticFusionDataset`` (the synthetic rig
    plus a point cloud on its objects) and ``NuScenesFusionDataset`` (the
    key frame's ``.bin`` points plus up to 10 sweeps, with a time-lag
    channel), each hard-voxelized and given its rulebooks on the host
    (``ddp_tpu_torch/native``); ``fusion_batch_iterator`` batches
    ``FUSION_BATCH_KEYS``, the rulebooks stacked key by key.

A sample is a dict of float32 arrays: ``image`` [N, H, W, 3] (0-255),
``cam2lidar_rots`` [N, 3, 3], ``cam2lidar_trans`` [N, 3], ``intrins``
[N, 3, 3], ``post_rots`` [N, 3, 3], ``post_trans`` [N, 3] and ``label``
[G, G, K] (binary masks, row = x index); a fusion sample adds
``voxel_feats`` [cap0, 5] (mean point features) and ``rulebooks`` (a dict of
int32 arrays, see ``nn/sparse_conv.py: build_sparse_encoder_rulebooks``).
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, List

import numpy as np

BEV_BATCH_KEYS = ("image", "cam2lidar_rots", "cam2lidar_trans", "intrins", "post_rots",
                  "post_trans", "label")
FUSION_BATCH_KEYS = BEV_BATCH_KEYS[:-1] + ("voxel_feats", "rulebooks", "label")


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
    calls it), the masks resampled over the dataset's ``scope`` (50 m for
    nuScenes, which has none, as in JAX). ``batch_size`` is global: with ``world`` > 1 each process
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
                              scope=getattr(ds, "scope", 50.0))
            s["image"] = (s["image"] - mean) / std
            for k in BEV_BATCH_KEYS:
                batch[k].append(s[k])
        yield {k: np.stack(v) for k, v in batch.items()}
        cursor += batch_size
        if cursor >= len(ds):
            cursor, epoch = 0, epoch + 1


def _pil_image():
    try:
        from PIL import Image
    except ImportError:
        raise ImportError("NuScenesBEVDataset reads the camera JPEGs through Pillow (as the "
                          "JAX package does), which is not installed here") from None
    return Image


class NuScenesBEVDataset:
    """BEVFusion-preprocessed nuScenes: ``nuscenes_infos_{split}.pkl`` (a dict
    with ``infos`` or a list: per sample its ``token``, ``cams`` with each
    camera's ``data_path``, ``sensor2lidar_rotation``,
    ``sensor2lidar_translation`` and ``camera_intrinsics``), and the
    rasterised map masks ``maps_bev/{token}.npz`` (key 'masks', [K, 200,
    200]; all zeros where missing), nearest-resized to ``out_grid``. Each
    camera image is scaled to cover ``image_size`` (Pillow BILINEAR) and
    cropped bottom-centre, the reference's eval aug, with the matching
    post-transform. A missing infos file gives an empty dataset."""

    def __init__(self, data_root: str, split: str = "train", image_size=(256, 704),
                 out_grid: int = 200):
        self.data_root = data_root
        self.image_size = image_size
        self.out_grid = out_grid
        path = os.path.join(data_root, f"nuscenes_infos_{split}.pkl")
        self.infos: List[dict] = []
        if os.path.exists(path):
            with open(path, "rb") as f:
                data = pickle.load(f)
            self.infos = data["infos"] if isinstance(data, dict) else data

    def __len__(self):
        return len(self.infos)

    def load(self, idx: int) -> Dict[str, np.ndarray]:
        image = _pil_image()
        info = self.infos[idx]
        h, w = self.image_size
        imgs, rots, trans, intrs, prots, ptrans = [], [], [], [], [], []
        for cam in info["cams"].values():
            im = image.open(os.path.join(self.data_root, cam["data_path"]))
            w0, h0 = im.size
            scale = max(w / w0, h / h0)
            im = im.resize((int(w0 * scale), int(h0 * scale)), image.BILINEAR)
            left = (im.size[0] - w) // 2
            top = im.size[1] - h
            im = im.crop((left, top, left + w, top + h))
            imgs.append(np.asarray(im, np.float32))
            post_rot = np.eye(3, dtype=np.float32)
            post_rot[0, 0] = post_rot[1, 1] = scale
            prots.append(post_rot)
            ptrans.append(np.array([-left, -top, 0], np.float32))
            rots.append(np.asarray(cam["sensor2lidar_rotation"], np.float32))
            trans.append(np.asarray(cam["sensor2lidar_translation"], np.float32))
            intrs.append(np.asarray(cam["camera_intrinsics"], np.float32))
        mask_path = os.path.join(self.data_root, "maps_bev", f"{info['token']}.npz")
        if os.path.exists(mask_path):
            masks = np.moveaxis(np.load(mask_path)["masks"].astype(np.float32), 0, -1)
        else:
            masks = np.zeros((200, 200, 6), np.float32)
        if masks.shape[0] != self.out_grid:
            ii = np.arange(self.out_grid) * masks.shape[0] // self.out_grid
            masks = masks[ii][:, ii]
        return {"image": np.stack(imgs), "cam2lidar_rots": np.stack(rots),
                "cam2lidar_trans": np.stack(trans), "intrins": np.stack(intrs),
                "post_rots": np.stack(prots), "post_trans": np.stack(ptrans), "label": masks}


def lidar_inputs(s: Dict[str, np.ndarray], points: np.ndarray, pc_range, voxel_size,
                 max_points: int, sparse_shape, caps) -> Dict[str, np.ndarray]:
    """``s`` with the cloud's mean voxel features and rulebooks added."""
    from .. import native
    from ..nn.sparse_conv import build_sparse_encoder_rulebooks, mean_voxel_features

    voxels, coords, counts, nv = native.hard_voxelize(points, pc_range, voxel_size,
                                                      max_points=max_points,
                                                      max_voxels=caps[0])
    s["voxel_feats"] = mean_voxel_features(voxels, counts)
    s["rulebooks"] = build_sparse_encoder_rulebooks(coords, nv, sparse_shape, caps)
    return s


class NuScenesFusionDataset(NuScenesBEVDataset):
    """``NuScenesBEVDataset`` plus the lidar branch's inputs (the reference's
    LoadPointsFromFile and LoadPointsFromMultiSweeps): the key frame's
    float32 ``.bin`` points (x, y, z, intensity, ring; the ring channel
    becomes the time lag, 0) and up to ``sweeps_num`` sweeps, each rotated
    and shifted into the key frame by its ``sensor2lidar_*`` and given the
    lag ``key_ts − sweep_ts`` in seconds; the cloud is hard-voxelized (at
    most ``max_points_per_voxel`` points a voxel) and its rulebooks built."""

    def __init__(self, data_root: str, split: str = "train", image_size=(256, 704),
                 out_grid: int = 200, sparse_shape=(1024, 1024, 41),
                 caps=(120_000, 60_000, 30_000, 15_000, 15_000), voxel_size=(0.1, 0.1, 0.2),
                 z_range=(-5.0, 3.2), scope: float = 51.2, sweeps_num: int = 10,
                 max_points_per_voxel: int = 10):
        super().__init__(data_root, split, image_size, out_grid)
        self.sparse_shape = tuple(sparse_shape)
        self.caps = tuple(caps)
        self.voxel_size = tuple(voxel_size)
        self.pc_range = (-scope, -scope, z_range[0], scope, scope, z_range[1])
        self.sweeps_num = sweeps_num
        self.max_points = max_points_per_voxel

    def _points(self, rel_path: str) -> np.ndarray:
        return np.fromfile(os.path.join(self.data_root, rel_path), dtype=np.float32
                           ).reshape(-1, 5)

    def load(self, idx: int, noise_seed=None) -> Dict[str, np.ndarray]:
        """``noise_seed`` is taken and unused (the synthetic dataset draws a
        new lidar pattern with it; real sweeps are what they are)."""
        s = super().load(idx)
        info = self.infos[idx]
        pts = self._points(info["lidar_path"])
        pts[:, 4] = 0.0
        clouds = [pts]
        ts = float(info.get("timestamp", 0)) / 1e6
        for sweep in info.get("sweeps", [])[:self.sweeps_num]:
            p = self._points(sweep["data_path"])
            p[:, :3] = p[:, :3] @ np.asarray(sweep["sensor2lidar_rotation"], np.float32).T
            p[:, :3] += np.asarray(sweep["sensor2lidar_translation"], np.float32)
            p[:, 4] = ts - float(sweep.get("timestamp", 0)) / 1e6
            clouds.append(p)
        return lidar_inputs(s, np.concatenate(clouds, axis=0), self.pc_range,
                            self.voxel_size, self.max_points, self.sparse_shape, self.caps)


class SyntheticFusionDataset(SyntheticBEVDataset):
    """``SyntheticBEVDataset`` plus a lidar cloud of 800 points: ground
    clutter, and up to 60 % of the points on the scene's object cells,
    standing above the ground at a class-coded height; intensity (class +
    1) / K on objects, 0.05 elsewhere. The pattern is drawn from
    ``default_rng((idx + 10_000, noise_seed or 0))``: the train iterator
    passes the epoch, so that the pattern changes every epoch (a fixed one
    per scene is memorised), the end check none. Hard-voxelized at 4 points
    a voxel."""

    def __init__(self, sparse_shape=(128, 128, 41), caps=(512, 256, 128, 96, 96),
                 voxel_size=(0.125, 0.125, 0.2), z_range=(-5.0, 3.2), **kw):
        super().__init__(**kw)
        self.sparse_shape = sparse_shape
        self.caps = tuple(caps)
        self.voxel_size = voxel_size
        self.pc_range = (-self.scope, -self.scope, z_range[0], self.scope, self.scope,
                         z_range[1])

    def load(self, idx: int, noise_seed=None) -> Dict[str, np.ndarray]:
        s = super().load(idx)
        rng = np.random.default_rng((idx + 10_000, noise_seed or 0))
        n_pts = 800
        cell = 2 * self.scope / self.out_grid
        obj_cells = np.argwhere(s["label"].max(-1) > 0)  # [M, 2] grid coords
        n_obj = min(int(n_pts * 0.6), max(len(obj_cells), 0) * 4)
        pts = np.zeros((n_pts, 5), np.float32)
        # background returns: uniform ground clutter
        pts[:, 0] = rng.uniform(-self.scope, self.scope, n_pts)
        pts[:, 1] = rng.uniform(-self.scope, self.scope, n_pts)
        pts[:, 2] = rng.uniform(self.pc_range[2], self.pc_range[2] + 0.5, n_pts)
        if n_obj > 0:
            pick = obj_cells[rng.integers(0, len(obj_cells), n_obj)]
            jitter = rng.uniform(0.0, 1.0, (n_obj, 2))
            pts[:n_obj, 0] = (pick[:, 0] + jitter[:, 0]) * cell - self.scope
            pts[:n_obj, 1] = (pick[:, 1] + jitter[:, 1]) * cell - self.scope
            ocls = s["label"][pick[:, 0], pick[:, 1]].argmax(-1)
            pts[:n_obj, 2] = self.pc_range[2] + 1.0 + ocls + rng.uniform(0, 0.5, n_obj)
        gx = np.clip(((pts[:, 0] + self.scope) / cell).astype(int), 0, self.out_grid - 1)
        gy = np.clip(((pts[:, 1] + self.scope) / cell).astype(int), 0, self.out_grid - 1)
        cls = s["label"][gx, gy].argmax(-1)
        hit = s["label"][gx, gy].max(-1) > 0
        pts[:, 3] = np.where(hit, (cls + 1) / self.k, 0.05)
        return lidar_inputs(s, pts, self.pc_range, self.voxel_size, 4, self.sparse_shape,
                            self.caps)


def fusion_batch_iterator(ds, batch_size: int, seed: int = 0, mean=(123.675, 116.28, 103.53),
                          std=(58.395, 57.12, 57.375), rank: int = 0, world: int = 1):
    """Endless train batches of ``FUSION_BATCH_KEYS`` (images normalised;
    ``rulebooks`` a dict of arrays stacked key by key), each epoch in the
    order of ``default_rng(seed + epoch).permutation``, each sample loaded
    with ``noise_seed = seed + epoch + 1`` (a new lidar pattern every epoch);
    no aug, as the JAX package's ``make_train_iter`` calls its iterator.
    ``batch_size`` is global: with ``world`` > 1 each process yields its
    rank's slice."""
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    if batch_size % world:
        raise ValueError(f"batch {batch_size} does not split over {world} processes")
    local = batch_size // world
    epoch, cursor = 0, 0
    while True:
        order = np.random.default_rng(seed + epoch).permutation(len(ds))
        samples = []
        for i in range(rank * local, (rank + 1) * local):
            s = ds.load(int(order[(cursor + i) % len(ds)]), noise_seed=seed + epoch + 1)
            s["image"] = (s["image"] - mean) / std
            samples.append(s)
        out = {k: np.stack([s[k] for s in samples]) for k in FUSION_BATCH_KEYS
               if k != "rulebooks"}
        out["rulebooks"] = {k: np.stack([s["rulebooks"][k] for s in samples])
                            for k in samples[0]["rulebooks"]}
        yield out
        cursor += batch_size
        if cursor >= len(ds):
            cursor, epoch = 0, epoch + 1
