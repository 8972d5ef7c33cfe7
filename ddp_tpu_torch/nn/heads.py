"""Decode heads (port of ``ddp_tpu/nn/heads.py:23-67,150-166``).

  - DeformableHeadWithTime: flatten HW -> sine or learned pos-enc ->
    time-FiLM encoder (msda over the one level, or window attention; FiLM
    v1/v2/v3) -> reshape -> 1x1 conv_seg (deformable_head_with_time.py:21-189).
  - FCNHead: the training-time auxiliary head (3x3 conv+BN+ReLU, dropout
    0.1 in training, 1x1 conv_seg) on the clean encoder features.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
from torch import nn

from .common import ConvModule, dropout
from .pos_embed import LearnedPositionalEncoding, sine_pos_embed
from .transformer import TimeFiLMEncoder, reference_points


@functools.lru_cache(maxsize=64)
def _sine_pos(h: int, w: int, num_feats: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(sine_pos_embed(h, w, num_feats=num_feats), device=device)


@functools.lru_cache(maxsize=64)
def _reference_points(h: int, w: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(reference_points(((h, w),)), device=device)


class DeformableHeadWithTime(nn.Module):
    """The learned position tables (``pos_type="learned"``) have max(50, h)
    rows and max(50, w) columns for ``pos_grid`` = (h, w), the latent grid
    the model is built for (the JAX package sizes them from the grid it is
    initialised on, ``ddp_tpu/nn/heads.py:40-44``); a larger grid raises."""

    def __init__(self, num_classes: int, embed_dims: int = 256, num_layers: int = 6,
                 num_heads: int = 8, ffn_dim: int = 1024, attn_type: str = "window",
                 film: str = "v1", pos_type: str = "sine", window: int = 8,
                 pos_grid: Tuple[int, int] = (50, 50)):
        super().__init__()
        if pos_type not in ("sine", "learned"):
            raise ValueError(f"pos_type must be 'sine' or 'learned', got {pos_type!r}")
        self.embed_dims = embed_dims
        self.attn_type = attn_type
        self.pos_type = pos_type
        if pos_type == "learned":
            self.pos_enc = LearnedPositionalEncoding(
                embed_dims // 2, max(50, pos_grid[0]), max(50, pos_grid[1]))
        self.encoder = TimeFiLMEncoder(num_layers, embed_dims, num_heads, ffn_dim=ffn_dim,
                                       use_time=True, attn_type=attn_type, window=window,
                                       film=film)
        self.conv_seg = nn.Conv2d(embed_dims, num_classes, 1)

    def forward(self, x: torch.Tensor, time: Optional[torch.Tensor]) -> torch.Tensor:
        """x: [B, H, W, C]; time: [B, 4C]. Returns logits [B, H, W, K]."""
        b, h, w, c = x.shape
        if self.pos_type == "learned":
            pos = self.pos_enc(h, w).to(x.dtype)
        else:
            pos = _sine_pos(h, w, self.embed_dims // 2, x.device).to(x.dtype)
        refs = (_reference_points(h, w, x.device).to(x.dtype)
                if self.attn_type == "msda" else None)
        q = self.encoder(x.reshape(b, h * w, c), time, pos, refs, ((h, w),))
        q = q.reshape(b, h, w, c).permute(0, 3, 1, 2)
        return self.conv_seg(q).permute(0, 2, 3, 1)


class FCNHead(nn.Module):
    """Auxiliary FCN head; dropout draws from the generator the caller passes."""

    def __init__(self, num_classes: int, in_channels: int, channels: int = 256,
                 num_convs: int = 1, dropout: float = 0.1, norm: str = "SyncBN"):
        super().__init__()
        self.num_convs = num_convs
        self.dropout = dropout
        for i in range(num_convs):
            self.add_module(f"conv{i}", ConvModule(
                in_channels if i == 0 else channels, channels, (3, 3), norm=norm,
                act="relu"))
        self.conv_seg = nn.Conv2d(channels, num_classes, 1)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for i in range(self.num_convs):
            x = getattr(self, f"conv{i}")(x)
        x = dropout(x, self.dropout, self.training, generator)
        return self.conv_seg(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
