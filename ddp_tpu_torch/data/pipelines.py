"""Train data pipeline transforms (copy of ``ddp_tpu/data/pipelines.py``),
numpy on the host, mmseg semantics:

  - Resize with img_scale + ratio_range (keep_ratio): scale sampled per image
  - RandomCrop with cat_max_ratio (re-crop up to 10x to avoid one class
    dominating), ignore label excluded from the count
  - RandomFlip (horizontal, prob 0.5)
  - PhotoMetricDistortion (brightness/contrast/saturation/hue jitter)
  - Normalize (mean/std, RGB), Pad to crop size with pad_val 0 / seg 255

All transforms take and return a dict sample {'image': HxWx3 float32,
'label': HxW int32} and use an explicit np.random.Generator, so that a
sample is a function of its generator's seed alone.
The JAX package resizes with Pillow, which the port does not require.
The JAX package resizes with Pillow, which the card's installation lacks.
``pil_resize_bilinear`` and ``pil_resize_nearest`` are numpy versions of the
two Pillow resamples the pipeline uses, equal to Pillow's output bit for bit
(``tests/test_torch_port_pipelines.py``): its BILINEAR on uint8 RGB
(``libImaging/Resample.c``: a separable triangle filter whose support
widens by the downscale factor, coefficients in 22-bit fixed point, each
pass rounded and clipped to uint8, horizontal then vertical) and its NEAREST
on int32 labels (``libImaging/Geometry.c``: the affine scale, source index
the truncated running sum of ``in / out`` from half a step).
"""
from __future__ import annotations

import functools
from typing import Dict, Sequence, Tuple

import numpy as np

Sample = Dict[str, np.ndarray]

_PRECISION_BITS = 32 - 8 - 2  # Pillow's fixed-point coefficient bits


@functools.lru_cache(maxsize=256)
def _bilinear_coeffs(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pillow's ``precompute_coeffs`` for its bilinear filter (support 1) and
    ``normalize_coeffs_8bpc``: the first source index of each output pixel
    [out] and its fixed-point taps [out, ksize] (0 past the window)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    taps = np.zeros((out_size, ksize), np.int64)
    ss = 1.0 / filterscale
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [max(0.0, 1.0 - abs((x + xmin - center + 0.5) * ss)) for x in range(xmax)]
        ww = sum(w)
        k = [v / ww if ww != 0.0 else v for v in w]
        first[xx] = xmin
        taps[xx, :xmax] = [int(-0.5 + v * (1 << _PRECISION_BITS)) if v < 0
                           else int(0.5 + v * (1 << _PRECISION_BITS)) for v in k]
    return first, taps


def _resample_axis(arr: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass of Pillow's 8-bit resample along ``axis`` of a uint8 array."""
    in_size = arr.shape[axis]
    first, taps = _bilinear_coeffs(in_size, out_size)
    x = np.moveaxis(arr, axis, 0).astype(np.int64)
    acc = np.full((out_size,) + x.shape[1:], 1 << (_PRECISION_BITS - 1), np.int64)
    tail = (1,) * (x.ndim - 1)
    for t in range(taps.shape[1]):
        src = np.minimum(first + t, in_size - 1)  # taps past the window are 0
        acc += x[src] * taps[:, t].reshape((-1,) + tail)
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def pil_resize_bilinear(img: np.ndarray, size_wh: Tuple[int, int]) -> np.ndarray:
    """``PIL.Image.fromarray(img).resize(size_wh, BILINEAR)`` of an [H, W, C]
    uint8 image, as a uint8 array: horizontal pass, then vertical, each
    skipped where that side keeps its size."""
    out_w, out_h = size_wh
    if img.shape[1] != out_w:
        img = _resample_axis(img, out_w, 1)
    if img.shape[0] != out_h:
        img = _resample_axis(img, out_h, 0)
    return np.ascontiguousarray(img)


def _nearest_source(in_size: int, out_size: int) -> np.ndarray:
    """Source index of each output pixel as Pillow's affine scale finds it:
    a position that starts at half a step and adds the step once per pixel
    (a running float64 sum, which can fall an ulp short of an integer that
    ``(x + 0.5) · step`` would reach), truncated."""
    step = in_size / out_size
    pos = np.add.accumulate(np.r_[0.0 + step * 0.5, np.full(out_size - 1, step)])
    return pos.astype(np.int64)


def pil_resize_nearest(arr: np.ndarray, size_wh: Tuple[int, int]) -> np.ndarray:
    """``PIL.Image.fromarray(arr, "I").resize(size_wh, NEAREST)`` of an [H, W]
    int32 map, as an int32 array."""
    out_w, out_h = size_wh
    if arr.shape == (out_h, out_w):
        return arr.copy()
    rows = _nearest_source(arr.shape[0], out_h)
    cols = _nearest_source(arr.shape[1], out_w)
    return arr[rows][:, cols]


def random_resize(
    sample: Sample, rng: np.random.Generator,
    img_scale: Tuple[int, int], ratio_range: Tuple[float, float] = (0.5, 2.0),
) -> Sample:
    """mmseg Resize(keep_ratio=True, ratio_range): sample ratio, scale the
    long-side target, then fit within (keeping aspect)."""
    ratio = rng.uniform(*ratio_range)
    scale = (int(img_scale[0] * ratio), int(img_scale[1] * ratio))
    h, w = sample["image"].shape[:2]
    max_long, max_short = max(scale), min(scale)
    scale_factor = min(max_long / max(h, w), max_short / min(h, w))
    new_w, new_h = int(w * scale_factor + 0.5), int(h * scale_factor + 0.5)
    out = dict(sample)
    # the image truncated to uint8 first, as the JAX copy hands it to Pillow
    out["image"] = pil_resize_bilinear(sample["image"].astype(np.uint8),
                                       (new_w, new_h)).astype(np.float32)
    if "label" in sample:
        out["label"] = pil_resize_nearest(sample["label"].astype(np.int32), (new_w, new_h))
    return out


def random_crop(
    sample: Sample, rng: np.random.Generator, crop: Tuple[int, int],
    cat_max_ratio: float = 0.75, ignore_index: int = 255, max_attempts: int = 10,
) -> Sample:
    img, label = sample["image"], sample.get("label")
    h, w = img.shape[:2]
    ch, cw = min(crop[0], h), min(crop[1], w)

    def rand_box():
        y = rng.integers(0, h - ch + 1)
        x = rng.integers(0, w - cw + 1)
        return y, x

    y, x = rand_box()
    if label is not None and cat_max_ratio < 1.0:
        for _ in range(max_attempts):
            patch = label[y:y + ch, x:x + cw]
            counts = np.bincount(patch.reshape(-1))
            counts = counts[:ignore_index] if len(counts) > ignore_index else counts
            total = counts.sum()
            if total > 0 and counts.max() / total < cat_max_ratio:
                break
            y, x = rand_box()
    out = dict(sample)
    out["image"] = img[y:y + ch, x:x + cw]
    if label is not None:
        out["label"] = label[y:y + ch, x:x + cw]
    return out


def random_flip(sample: Sample, rng: np.random.Generator, prob: float = 0.5) -> Sample:
    if rng.random() >= prob:
        return sample
    out = dict(sample)
    out["image"] = sample["image"][:, ::-1].copy()
    if "label" in sample:
        out["label"] = sample["label"][:, ::-1].copy()
    return out


def photo_metric_distortion(
    sample: Sample, rng: np.random.Generator,
    brightness_delta: float = 32, contrast_range=(0.5, 1.5),
    saturation_range=(0.5, 1.5), hue_delta: float = 18,
) -> Sample:
    """mmseg PhotoMetricDistortion: random brightness, contrast (random
    order), saturation, hue — in float32, clipped to [0, 255]."""
    img = sample["image"].astype(np.float32)

    def clip(x):
        return np.clip(x, 0, 255)

    if rng.integers(2):
        img = clip(img + rng.uniform(-brightness_delta, brightness_delta))
    contrast_first = rng.integers(2)
    if contrast_first and rng.integers(2):
        img = clip(img * rng.uniform(*contrast_range))
    # saturation / hue via HSV
    if rng.integers(2) or rng.integers(2):
        hsv = _rgb_to_hsv(img)
        if rng.integers(2):
            hsv[..., 1] = np.clip(hsv[..., 1] * rng.uniform(*saturation_range), 0, 1)
        if rng.integers(2):
            hsv[..., 0] = (hsv[..., 0] + rng.uniform(-hue_delta, hue_delta) / 360.0) % 1.0
        img = clip(_hsv_to_rgb(hsv))
    if not contrast_first and rng.integers(2):
        img = clip(img * rng.uniform(*contrast_range))
    out = dict(sample)
    out["image"] = img
    return out


def _rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    x = img / 255.0
    mx = x.max(-1)
    mn = x.min(-1)
    diff = mx - mn + 1e-12
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    h = np.zeros_like(mx)
    m = mx == r
    h[m] = ((g - b)[m] / diff[m]) % 6
    m = mx == g
    h[m] = (b - r)[m] / diff[m] + 2
    m = mx == b
    h[m] = (r - g)[m] / diff[m] + 4
    h = h / 6.0
    s = np.where(mx > 0, diff / (mx + 1e-12), 0.0)
    return np.stack([h, s, mx], axis=-1)


def _hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    h, s, v = hsv[..., 0] * 6.0, hsv[..., 1], hsv[..., 2]
    i = np.floor(h).astype(np.int32) % 6
    f = h - np.floor(h)
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    lut = np.stack([
        np.stack([v, t, p], -1), np.stack([q, v, p], -1), np.stack([p, v, t], -1),
        np.stack([p, q, v], -1), np.stack([t, p, v], -1), np.stack([v, p, q], -1),
    ], axis=-2)
    rgb = np.take_along_axis(lut, i[..., None, None].repeat(3, -1), axis=-2)[..., 0, :]
    return rgb * 255.0


def normalize(sample: Sample, mean: Sequence[float], std: Sequence[float]) -> Sample:
    out = dict(sample)
    out["image"] = (sample["image"].astype(np.float32) - np.asarray(mean, np.float32)) \
        / np.asarray(std, np.float32)
    return out


def pad_to(sample: Sample, size: Tuple[int, int], seg_pad_val: int = 255) -> Sample:
    h, w = sample["image"].shape[:2]
    ph, pw = max(size[0] - h, 0), max(size[1] - w, 0)
    if ph == 0 and pw == 0:
        return sample
    out = dict(sample)
    out["image"] = np.pad(sample["image"], ((0, ph), (0, pw), (0, 0)))
    if "label" in sample:
        out["label"] = np.pad(sample["label"], ((0, ph), (0, pw)),
                              constant_values=seg_pad_val)
    return out


def seg_train_pipeline(
    sample: Sample, rng: np.random.Generator, crop: Tuple[int, int],
    img_scale: Tuple[int, int], ratio_range=(0.5, 2.0), cat_max_ratio=0.75,
    flip_prob=0.5, mean=(123.675, 116.28, 103.53), std=(58.395, 57.12, 57.375),
) -> Sample:
    """The full DDP seg train pipeline (configs/_base_/datasets/ade20k.py:7-21):
    Resize(ratio_range) → RandomCrop(cat_max_ratio) → Flip → PhotoMetric →
    Normalize → Pad."""
    s = random_resize(sample, rng, img_scale, ratio_range)
    s = random_crop(s, rng, crop, cat_max_ratio)
    s = random_flip(s, rng, flip_prob)
    s = photo_metric_distortion(s, rng)
    s = normalize(s, mean, std)
    s = pad_to(s, crop)
    return s
