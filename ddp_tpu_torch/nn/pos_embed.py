"""2-D positional encodings (port of ``ddp_tpu/nn/pos_embed.py``).

  - ``sine_pos_embed``: mmcv ``SinePositionalEncoding`` with normalize=True,
    offset=-0.5, temperature=10000, always called with an all-zeros mask,
    so the table is a static function of (h, w) computed once in numpy.
  - ``LearnedPositionalEncoding``: mmseg's learned row/col tables.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
from torch import nn


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


class LearnedPositionalEncoding(nn.Module):
    """Learned row/col position tables (mmseg LearnedPositionalEncoding):
    position (y, x) gets concat(col_embed[x], row_embed[y]), x first. The
    caller sizes the tables (the decode head: max(50, h) × max(50, w) for the
    grid the model is built for, as the JAX package's init does); a grid
    beyond them raises. Returns [h·w, 2·num_feats]."""

    def __init__(self, num_feats: int = 128, row_num_embed: int = 50,
                 col_num_embed: int = 50):
        super().__init__()
        self.row_embed = nn.Embedding(row_num_embed, num_feats)
        self.col_embed = nn.Embedding(col_num_embed, num_feats)

    def forward(self, h: int, w: int) -> torch.Tensor:
        rows, cols = self.row_embed.weight, self.col_embed.weight
        if h > rows.shape[0] or w > cols.shape[0]:
            raise ValueError(f"a {h}x{w} grid needs more than the {rows.shape[0]} rows and "
                             f"{cols.shape[0]} columns of the position tables")
        c = rows.shape[1]
        return torch.cat([cols[None, :w].expand(h, w, c), rows[:h, None].expand(h, w, c)],
                         dim=-1).reshape(h * w, 2 * c)
