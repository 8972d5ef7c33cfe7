"""Slide (sliding-window) inference (port of ``slide_grid`` and
``slide_inference`` from ``ddp_tpu/evaluation/slide.py``).

mmseg ``EncoderDecoder.slide_inference`` (encoder_decoder.py:181-227): a
grid of crops with stride < crop, each crop's prediction added into a
[B, H, W, K] sum and a count map, then divided. Both sums are device
tensors filled by slice adds, so nothing goes to the host between crops.
Images and predictions are NHWC.
"""
from __future__ import annotations

from typing import Callable, List, Tuple

import torch


def slide_grid(h: int, w: int, crop: Tuple[int, int],
               stride: Tuple[int, int]) -> List[Tuple[int, int]]:
    """Crop origins, mmseg convention: the last window is clamped flush to
    the border, so every pixel is covered."""
    ch, cw = crop
    sh, sw = stride
    h_grids = max((h - ch + sh - 1) // sh, 0) + 1
    w_grids = max((w - cw + sw - 1) // sw, 0) + 1
    return [(min(i * sh, max(h - ch, 0)), min(j * sw, max(w - cw, 0)))
            for i in range(h_grids) for j in range(w_grids)]


def slide_inference(predict_fn: Callable[[torch.Tensor], torch.Tensor], img: torch.Tensor,
                    num_classes: int, crop: Tuple[int, int],
                    stride: Tuple[int, int]) -> torch.Tensor:
    """Accumulated sliding-window inference. ``predict_fn`` maps a [B, ch,
    cw, 3] crop to [B, ch, cw, K] logits or probabilities; returns their
    float32 mean over the crops covering each pixel, [B, H, W, K]."""
    b, h, w, _ = img.shape
    ch, cw = min(crop[0], h), min(crop[1], w)
    preds = torch.zeros((b, h, w, num_classes), dtype=torch.float32, device=img.device)
    count = torch.zeros((1, h, w, 1), dtype=torch.float32, device=img.device)
    for y1, x1 in slide_grid(h, w, (ch, cw), stride):
        preds[:, y1:y1 + ch, x1:x1 + cw] += predict_fn(img[:, y1:y1 + ch, x1:x1 + cw]).float()
        count[:, y1:y1 + ch, x1:x1 + cw] += 1.0
    return preds / count
