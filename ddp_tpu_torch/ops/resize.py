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


def resize_nearest(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """[..., H, W, C] -> [..., size[0], size[1], C], torch floor convention."""
    h, w = x.shape[-3], x.shape[-2]
    ih = torch.as_tensor(_nearest_index(h, size[0]), device=x.device)
    iw = torch.as_tensor(_nearest_index(w, size[1]), device=x.device)
    return x.index_select(-3, ih).index_select(-2, iw)


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int],
                    align_corners: bool = False) -> torch.Tensor:
    """[..., H, W, C] -> [..., size[0], size[1], C]; lerps in float32."""
    h, w = x.shape[-3], x.shape[-2]
    oh, ow = size
    if (h, w) == (oh, ow):
        return x
    dev = x.device
    xf = x.float()
    lo_h, hi_h, wh = _linear_weights(h, oh, align_corners)
    lo_w, hi_w, ww = _linear_weights(w, ow, align_corners)
    wh_ = torch.as_tensor(wh, device=dev)[:, None, None]
    top = xf.index_select(-3, torch.as_tensor(lo_h, device=dev))
    bot = xf.index_select(-3, torch.as_tensor(hi_h, device=dev))
    xf = top * (1.0 - wh_) + bot * wh_
    ww_ = torch.as_tensor(ww, device=dev)[:, None]
    left = xf.index_select(-2, torch.as_tensor(lo_w, device=dev))
    right = xf.index_select(-2, torch.as_tensor(hi_w, device=dev))
    xf = left * (1.0 - ww_) + right * ww_
    return xf.to(x.dtype)


def resize(x: torch.Tensor, size: Tuple[int, int], mode: str = "bilinear",
           align_corners: bool = False) -> torch.Tensor:
    """Dispatching resize mirroring mmseg.ops.resize semantics (NHWC)."""
    if mode == "nearest":
        return resize_nearest(x, size)
    if mode == "bilinear":
        return resize_bilinear(x, size, align_corners)
    raise ValueError(f"unsupported resize mode {mode!r}")
