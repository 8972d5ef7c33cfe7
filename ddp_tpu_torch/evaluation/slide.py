"""Slide (sliding-window) inference and test-time augmentation (port of
``ddp_tpu/evaluation/slide.py``).

mmseg ``EncoderDecoder.slide_inference`` (encoder_decoder.py:181-227): a
grid of crops with stride < crop, each crop's prediction added into a
[B, H, W, K] sum and a count map, then divided. Both sums are device
tensors filled by slice adds, so nothing goes to the host between crops.
``flip_tta`` and ``multi_scale_flip_tta``: mmseg's aug_test (flip, and
MultiScaleFlipAug's scales), the predictions averaged. Images and
predictions are NHWC.
"""
from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch

from ..ops.resize import resize


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


def flip_tta(predict_fn: Callable[[torch.Tensor], torch.Tensor],
             img: torch.Tensor) -> torch.Tensor:
    """Horizontal-flip TTA: the mean of the predictions of ``img`` and of its
    mirror image (mirrored back), as mmseg's aug_test
    (encoder_decoder.py:210-226)."""
    out = predict_fn(img)
    out_f = predict_fn(torch.flip(img, dims=(2,)))
    return 0.5 * (out + torch.flip(out_f, dims=(2,)))


def multi_scale_flip_tta(predict_fn: Callable[[torch.Tensor], torch.Tensor],
                         img: torch.Tensor,
                         scales: Sequence[float] = (0.5, 0.75, 1.0, 1.25, 1.5, 1.75),
                         flip: bool = True) -> torch.Tensor:
    """mmseg's MultiScaleFlipAug + aug_test (the reference's 'MS' protocol):
    the image bilinearly resized to round(H·s) × round(W·s) for each scale,
    its prediction (flip-averaged when ``flip``) resized back to H × W, and
    the mean over the scales."""
    b, h, w, _ = img.shape
    acc = None
    for s in scales:
        hs, ws = int(round(h * s)), int(round(w * s))
        x = img if (hs, ws) == (h, w) else resize(img, (hs, ws), mode="bilinear")
        p = flip_tta(predict_fn, x) if flip else predict_fn(x)
        p = p if (hs, ws) == (h, w) else resize(p, (h, w), mode="bilinear")
        acc = p if acc is None else acc + p
    return acc / len(scales)
