"""BEV 3D train-time augmentations, host-side numpy (port of
``ddp_tpu/data/transforms_3d.py``; the reference's
bev/mmdet3d/datasets/pipelines/transforms_3d.py).

  - ``image_aug_3d`` (ImageAug3D): per-camera resize / crop / flip / rotate,
    the pixel homography folded into (post_rot, post_tran) so that the LSS
    frustum unprojection undoes it.
  - ``global_rot_scale_trans`` (GlobalRotScaleTrans): a scene-level
    rotation, scale and translation of the lidar frame, returned as the 4x4
    ``lidar_aug_matrix``; ``rotate_bev_masks`` resamples the BEV masks under it.
  - ``grid_mask`` (GridMask): structured grid dropout on the camera images.

Every draw comes from the ``np.random.Generator`` passed in. Images are
float32 [H, W, 3]; the sub-pixel resize and rotate go through Pillow's 'F'
mode one channel at a time, as the JAX package's do (bitwise the same
output); without Pillow they raise a named ImportError.

  - ``multi_sweep_points`` (LoadPointsFromMultiSweeps, loading.py:84-230;
    JAX ``transforms_3d.py:233-279``): past sweeps moved into the key
    frame's lidar frame, the 5th channel made the time lag, points within
    ``close_radius`` of the sensor in x and y dropped (``_remove_close``).
    No JAX path calls it; the nuScenes fusion reader loads its sweeps itself
    (``data/bev_datasets.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def _pil_image():
    try:
        from PIL import Image
    except ImportError:
        raise ImportError("the BEV image augmentation resizes and rotates through Pillow "
                          "(as the JAX package does), which is not installed here") from None
    return Image


def _pil_resize(img: np.ndarray, size_wh: Tuple[int, int]) -> np.ndarray:
    """[H, W, C] float32 resized to (w, h) by Pillow's BILINEAR, per channel."""
    image = _pil_image()
    chans = [np.asarray(image.fromarray(img[..., c], mode="F").resize(size_wh, image.BILINEAR))
             for c in range(img.shape[-1])]
    return np.stack(chans, axis=-1)


def _pil_rotate(img: np.ndarray, deg: float) -> np.ndarray:
    """[H, W, C] float32 rotated by ``deg`` degrees (Pillow, nearest, zero fill)."""
    if deg == 0:
        return img
    image = _pil_image()
    chans = [np.asarray(image.fromarray(img[..., c], mode="F").rotate(deg))
             for c in range(img.shape[-1])]
    return np.stack(chans, axis=-1)


@dataclasses.dataclass(frozen=True)
class ImageAug3DConfig:
    """nuScenes seg defaults (bev/configs/nuscenes/default.yaml image aug)."""

    final_dim: Tuple[int, int] = (256, 704)
    resize_lim: Tuple[float, float] = (0.38, 0.55)
    bot_pct_lim: Tuple[float, float] = (0.0, 0.0)
    rot_lim: Tuple[float, float] = (-5.4, 5.4)
    rand_flip: bool = True


def sample_image_aug(rng: np.random.Generator, ori_wh: Tuple[int, int],
                     cfg: ImageAug3DConfig, is_train: bool):
    """(resize, resize_dims, crop, flip, rotate) of one camera
    (ImageAug3D.sample_augmentation)."""
    w, h = ori_wh
    fh, fw = cfg.final_dim
    if is_train:
        resize = float(rng.uniform(*cfg.resize_lim))
        neww, newh = int(w * resize), int(h * resize)
        crop_h = int((1 - rng.uniform(*cfg.bot_pct_lim)) * newh) - fh
        crop_w = int(rng.uniform(0, max(0, neww - fw)))
        flip = bool(cfg.rand_flip and rng.integers(0, 2))
        rotate = float(rng.uniform(*cfg.rot_lim))
    else:
        resize = float(np.mean(cfg.resize_lim))
        neww, newh = int(w * resize), int(h * resize)
        crop_h = int((1 - np.mean(cfg.bot_pct_lim)) * newh) - fh
        crop_w = int(max(0, neww - fw) / 2)
        flip, rotate = False, 0.0
    crop = (crop_w, crop_h, crop_w + fw, crop_h + fh)
    return resize, (neww, newh), crop, flip, rotate


def image_aug_3d(imgs: np.ndarray, post_rots: np.ndarray, post_trans: np.ndarray,
                 rng: np.random.Generator, cfg: ImageAug3DConfig,
                 is_train: bool = True) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Resize, crop (zero outside the image, as PIL's crop), flip and rotate
    each camera of [N, H, W, 3], composing the pixel homography into
    (post_rots [N, 3, 3], post_trans [N, 3]) as ImageAug3D.img_transform does.
    Returns (images [N, fh, fw, 3], post_rots, post_trans)."""
    n, h, w, _ = imgs.shape
    fh, fw = cfg.final_dim
    out = np.zeros((n, fh, fw, imgs.shape[-1]), np.float32)
    new_rots = post_rots.copy()
    new_trans = post_trans.copy()
    for i in range(n):
        resize, resize_dims, crop, flip, rotate = sample_image_aug(rng, (w, h), cfg, is_train)
        img = _pil_resize(imgs[i], resize_dims)
        x0, y0, x1, y1 = crop
        canvas = np.zeros((y1 - y0, x1 - x0, img.shape[-1]), np.float32)
        sy0, sy1 = max(y0, 0), min(y1, img.shape[0])
        sx0, sx1 = max(x0, 0), min(x1, img.shape[1])
        if sy1 > sy0 and sx1 > sx0:
            canvas[sy0 - y0:sy1 - y0, sx0 - x0:sx1 - x0] = img[sy0:sy1, sx0:sx1]
        img = canvas
        if flip:
            img = img[:, ::-1]
        out[i] = _pil_rotate(img, rotate)

        rot = (np.eye(2, dtype=np.float32) * resize) @ post_rots[i, :2, :2]
        tran = resize * post_trans[i, :2] - np.asarray(crop[:2], np.float32)
        if flip:
            a = np.asarray([[-1, 0], [0, 1]], np.float32)
            b = np.asarray([crop[2] - crop[0], 0], np.float32)
            rot = a @ rot
            tran = a @ tran + b
        theta = rotate / 180.0 * np.pi
        a = np.asarray([[np.cos(theta), np.sin(theta)],
                        [-np.sin(theta), np.cos(theta)]], np.float32)
        b = np.asarray([crop[2] - crop[0], crop[3] - crop[1]], np.float32) / 2
        b = a @ (-b) + b
        rot = a @ rot
        tran = a @ tran + b
        new_rots[i] = np.eye(3, dtype=np.float32)
        new_rots[i][:2, :2] = rot
        new_trans[i] = np.asarray([tran[0], tran[1], 0.0], np.float32)
    return out, new_rots, new_trans


def global_rot_scale_trans(rng: np.random.Generator, points: Optional[np.ndarray] = None,
                           resize_lim: Tuple[float, float] = (0.9, 1.1),
                           rot_lim: Tuple[float, float] = (-0.78539816, 0.78539816),
                           trans_lim: float = 0.5, is_train: bool = True
                           ) -> Tuple[Optional[np.ndarray], np.ndarray]:
    """A scene-level rotation by −θ, translation and scale
    (p' = s·(R(−θ)·p + t)) of ``points`` [P, D] (xyz first; None: none) and
    the 4x4 ``lidar_aug_matrix`` M with p' = M[:3, :3]·p + M[:3, 3]."""
    transform = np.eye(4, dtype=np.float32)
    if not is_train:
        return points, transform
    scale = float(rng.uniform(*resize_lim))
    theta = float(rng.uniform(*rot_lim))
    translation = rng.normal(0, trans_lim, 3).astype(np.float32)
    c, s = np.cos(-theta), np.sin(-theta)
    rot = np.asarray([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    if points is not None:
        points = points.copy()
        points[:, :3] = points[:, :3] @ rot.T
        points[:, :3] += translation
        points[:, :3] *= scale
    transform[:3, :3] = rot * scale
    transform[:3, 3] = translation * scale
    return points, transform


def rotate_bev_masks(masks: np.ndarray, transform: np.ndarray, scope: float) -> np.ndarray:
    """BEV masks [G, G, K] (row = x index, column = y index, over ±scope)
    resampled (nearest) under the 4x4 scene transform: each output cell takes
    the mask at the pre-transform location of its centre, 0 outside."""
    g = masks.shape[0]
    cell = 2 * scope / g
    centers = (np.arange(g) + 0.5) * cell - scope
    xx, yy = np.meshgrid(centers, centers, indexing="ij")
    pts = np.stack([xx, yy, np.zeros_like(xx), np.ones_like(xx)], -1)  # [G, G, 4]
    src = pts.reshape(-1, 4) @ np.linalg.inv(transform).T
    si = np.clip(((src[:, 0] + scope) / cell).astype(np.int64), 0, g - 1)
    sj = np.clip(((src[:, 1] + scope) / cell).astype(np.int64), 0, g - 1)
    inb = (np.abs(src[:, 0]) < scope) & (np.abs(src[:, 1]) < scope)
    out = masks[si, sj] * inb[:, None]
    return out.reshape(g, g, masks.shape[-1]).astype(masks.dtype)


def grid_mask(imgs: np.ndarray, rng: np.random.Generator, prob: float = 0.7,
              ratio: float = 0.5, rotate: int = 1, use_h: bool = True, use_w: bool = True,
              mode: int = 1) -> np.ndarray:
    """Structured grid dropout of [N, H, W, 3] with probability ``prob``
    (GridMask); ``mode=1`` keeps the grid cells and drops the bars (the
    BEVFusion config's setting)."""
    if rng.random() > prob:
        return imgs
    n, h, w, _ = imgs.shape
    d = int(rng.integers(2, min(h, w)))
    length = (min(max(int(d * ratio + 0.5), 1), d - 1) if ratio != 1
              else int(rng.integers(1, d)))
    hh, ww = int(1.5 * h), int(1.5 * w)
    mask = np.ones((hh, ww), np.float32)
    st_h = int(rng.integers(d))
    st_w = int(rng.integers(d))
    if use_h:
        for i in range(hh // d):
            s = d * i + st_h
            mask[s:min(s + length, hh), :] = 0
    if use_w:
        for i in range(ww // d):
            s = d * i + st_w
            mask[:, s:min(s + length, ww)] = 0
    r = int(rng.integers(rotate)) if rotate > 1 else 0
    if r:
        mask = _pil_rotate(mask[..., None], r)[..., 0]
    mask = mask[(hh - h) // 2:(hh - h) // 2 + h, (ww - w) // 2:(ww - w) // 2 + w]
    if mode == 1:
        mask = 1.0 - mask
    return imgs * mask[None, :, :, None]


def multi_sweep_points(key_points: np.ndarray, sweeps: Sequence[Dict[str, np.ndarray]],
                       rng: np.random.Generator, sweeps_num: int = 10, timestamp: float = 0.0,
                       remove_close: bool = True, close_radius: float = 1.0,
                       test_mode: bool = False) -> np.ndarray:
    """The key frame's points [P, 5] (x y z intensity time) with
    ``sweeps_num`` past sweeps in its lidar frame: [sum P, 5], the key
    frame's time channel 0, each sweep's the lag ``timestamp`` − its own.
    A sweep is {'points': [P, 5], 'sensor2lidar_rotation': [3, 3],
    'sensor2lidar_translation': [3], 'timestamp': seconds}. With more
    sweeps than ``sweeps_num`` a train draw picks them without replacement
    from ``rng`` (``test_mode``: the first ones); with none, the key frame's
    points are repeated."""
    key = key_points.copy()
    key[:, 4] = 0.0
    out: List[np.ndarray] = [key]
    if len(sweeps) == 0:
        for _ in range(sweeps_num):
            out.append(_remove_close(key, close_radius) if remove_close else key)
    else:
        if len(sweeps) <= sweeps_num:
            choices = np.arange(len(sweeps))
        elif test_mode:
            choices = np.arange(sweeps_num)
        else:
            choices = rng.choice(len(sweeps), sweeps_num, replace=False)
        for idx in choices:
            sw = sweeps[int(idx)]
            pts = sw["points"].copy()
            if remove_close:
                pts = _remove_close(pts, close_radius)
            pts[:, :3] = pts[:, :3] @ np.asarray(sw["sensor2lidar_rotation"], np.float32).T
            pts[:, :3] += np.asarray(sw["sensor2lidar_translation"], np.float32)
            pts[:, 4] = timestamp - float(sw["timestamp"])
            out.append(pts)
    return np.concatenate(out, axis=0)


def _remove_close(points: np.ndarray, radius: float = 1.0) -> np.ndarray:
    """The points outside the square |x| < radius, |y| < radius."""
    x = np.abs(points[:, 0]) < radius
    y = np.abs(points[:, 1]) < radius
    return points[~(x & y)]
