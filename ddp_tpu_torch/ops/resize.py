"""NHWC resize with PyTorch ``F.interpolate`` sampling conventions.

Port of ``ddp_tpu/ops/resize.py``. The source indices and lerp weights are
computed in numpy exactly as the JAX package computes them (float64, then
weights cast to float32), so both packages gather the same pixels with the
same weights:

  - nearest: src = floor(dst * in/out), the torch 'asymmetric' convention;
  - bilinear, align_corners=False: half-pixel centres, src clipped to
    [0, in-1]; align_corners=True: corner-aligned grid.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from ..device import device_constant


@functools.lru_cache(maxsize=64)
def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    idx = np.floor(np.arange(out_size) * (in_size / out_size)).astype(np.int64)
    return np.clip(idx, 0, in_size - 1)


@functools.lru_cache(maxsize=64)
def _linear_weights(in_size: int, out_size: int, align_corners: bool):
    """Source indices (lo, hi) and lerp weight for 1-D linear resize."""
    if align_corners and out_size > 1:
        src = np.arange(out_size) * ((in_size - 1) / (out_size - 1))
    else:
        src = (np.arange(out_size) + 0.5) * (in_size / out_size) - 0.5
    src = np.clip(src, 0.0, in_size - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    w = (src - lo).astype(np.float32)
    return lo, hi, w


# the index and weight tensors on the device, copied there once per shape: a
# copy from the host cannot be captured into a CUDA graph, and the train step
# (train/step.py) is one
@device_constant(maxsize=128)
def _nearest_index_on(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_nearest_index(in_size, out_size), device=device)


@device_constant(maxsize=128)
def _linear_weights_on(in_size: int, out_size: int, align_corners: bool,
                       device: torch.device) -> Tuple[torch.Tensor, ...]:
    return tuple(torch.as_tensor(a, device=device)
                 for a in _linear_weights(in_size, out_size, align_corners))


def resize_nearest(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """[..., H, W, C] -> [..., size[0], size[1], C], torch floor convention."""
    h, w = x.shape[-3], x.shape[-2]
    ih = _nearest_index_on(h, size[0], x.device)
    iw = _nearest_index_on(w, size[1], x.device)
    return x.index_select(-3, ih).index_select(-2, iw)


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int],
                    align_corners: bool = False) -> torch.Tensor:
    """[..., H, W, C] -> [..., size[0], size[1], C]; lerps in float32
    (float64 for float64 inputs)."""
    h, w = x.shape[-3], x.shape[-2]
    oh, ow = size
    if (h, w) == (oh, ow):
        return x
    dev = x.device
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    lo_h, hi_h, wh = _linear_weights_on(h, oh, align_corners, dev)
    lo_w, hi_w, ww = _linear_weights_on(w, ow, align_corners, dev)
    wh_ = wh[:, None, None]
    xf = xf.index_select(-3, lo_h) * (1.0 - wh_) + xf.index_select(-3, hi_h) * wh_
    ww_ = ww[:, None]
    xf = xf.index_select(-2, lo_w) * (1.0 - ww_) + xf.index_select(-2, hi_w) * ww_
    return xf.to(x.dtype)


def resize(x: torch.Tensor, size: Tuple[int, int], mode: str = "bilinear",
           align_corners: bool = False) -> torch.Tensor:
    """Dispatching resize mirroring mmseg.ops.resize semantics (NHWC)."""
    if mode == "nearest":
        return resize_nearest(x, size)
    if mode == "bilinear":
        return resize_bilinear(x, size, align_corners)
    raise ValueError(f"unsupported resize mode {mode!r}")
