"""2-D sine positional encoding (port of ``ddp_tpu/nn/pos_embed.py:18-39``).

mmcv ``SinePositionalEncoding`` with normalize=True, offset=-0.5,
temperature=10000, always called with an all-zeros mask, so the table is a
static function of (h, w) computed once in numpy.
"""
from __future__ import annotations

import functools
import math

import numpy as np


@functools.lru_cache(maxsize=64)
def sine_pos_embed(h: int, w: int, num_feats: int = 128, temperature: float = 10000.0,
                   offset: float = -0.5, eps: float = 1e-6) -> np.ndarray:
    """Returns [h*w, 2*num_feats] float32 (y-features first, then x)."""
    y_embed = np.arange(1, h + 1, dtype=np.float32)[:, None] * np.ones((1, w), np.float32)
    x_embed = np.ones((h, 1), np.float32) * np.arange(1, w + 1, dtype=np.float32)[None, :]
    scale = 2.0 * math.pi
    y_embed = (y_embed + offset) / (y_embed[-1:, :] + eps) * scale
    x_embed = (x_embed + offset) / (x_embed[:, -1:] + eps) * scale

    dim_t = np.arange(num_feats, dtype=np.float32)
    dim_t = temperature ** (2 * (dim_t // 2) / num_feats)

    pos_x = x_embed[:, :, None] / dim_t
    pos_y = y_embed[:, :, None] / dim_t
    # interleave sin on even indices, cos on odd indices
    pos_x = np.stack([np.sin(pos_x[:, :, 0::2]), np.cos(pos_x[:, :, 1::2])], axis=3
                     ).reshape(h, w, num_feats)
    pos_y = np.stack([np.sin(pos_y[:, :, 0::2]), np.cos(pos_y[:, :, 1::2])], axis=3
                     ).reshape(h, w, num_feats)
    pos = np.concatenate([pos_y, pos_x], axis=2)  # [h, w, 2*num_feats]
    return pos.reshape(h * w, 2 * num_feats)
