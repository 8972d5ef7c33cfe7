"""Decode heads (port of ``ddp_tpu/nn/heads.py:23-67,150-166``).

  - DeformableHeadWithTime: flatten HW -> sine pos-enc -> time-FiLM encoder
    -> reshape -> 1x1 conv_seg (deformable_head_with_time.py:21-189). Only
    the window-attention decoder with sine positions is ported so far.
  - FCNHead: the training-time auxiliary head (3x3 conv+BN+ReLU, 1x1
    conv_seg). Serving never runs it; it is here so that every parameter of
    the JAX segmentor has a home in the port.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
from torch import nn

from .common import ConvModule
from .pos_embed import sine_pos_embed
from .transformer import TimeFiLMEncoder


@functools.lru_cache(maxsize=64)
def _sine_pos(h: int, w: int, num_feats: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(sine_pos_embed(h, w, num_feats=num_feats), device=device)


class DeformableHeadWithTime(nn.Module):
    def __init__(self, num_classes: int, embed_dims: int = 256, num_layers: int = 6,
                 num_heads: int = 8, ffn_dim: int = 1024, attn_type: str = "window",
                 film: str = "v1", pos_type: str = "sine", window: int = 8):
        super().__init__()
        if pos_type != "sine":
            raise NotImplementedError(f"decoder pos_type={pos_type!r} is not ported yet")
        self.embed_dims = embed_dims
        self.encoder = TimeFiLMEncoder(num_layers, embed_dims, num_heads, ffn_dim,
                                       use_time=True, attn_type=attn_type,
                                       window=window, film=film)
        self.conv_seg = nn.Conv2d(embed_dims, num_classes, 1)

    def forward(self, x: torch.Tensor, time: Optional[torch.Tensor]) -> torch.Tensor:
        """x: [B, H, W, C]; time: [B, 4C]. Returns logits [B, H, W, K]."""
        b, h, w, c = x.shape
        pos = _sine_pos(h, w, self.embed_dims // 2, x.device).to(x.dtype)
        q = self.encoder(x.reshape(b, h * w, c), time, pos, (h, w))
        q = q.reshape(b, h, w, c).permute(0, 3, 1, 2)
        return self.conv_seg(q).permute(0, 2, 3, 1)


class FCNHead(nn.Module):
    """Auxiliary FCN head (dropout is the identity at eval and is not ported)."""

    def __init__(self, num_classes: int, in_channels: int, channels: int = 256,
                 num_convs: int = 1, norm: str = "SyncBN"):
        super().__init__()
        self.num_convs = num_convs
        for i in range(num_convs):
            self.add_module(f"conv{i}", ConvModule(
                in_channels if i == 0 else channels, channels, (3, 3), norm=norm,
                act="relu"))
        self.conv_seg = nn.Conv2d(channels, num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_convs):
            x = getattr(self, f"conv{i}")(x)
        return self.conv_seg(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
