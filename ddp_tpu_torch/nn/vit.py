"""Vision Transformer backbone with NHWC grid taps (port of
``ddp_tpu/nn/vit.py:24-110``).

mmseg's ViT (vit.py): a VALID patch embed, a learned position embedding on
the pretrain grid resized to the input's grid, pre-norm blocks (LayerNorm
eps 1e-6, flax's tanh GELU), the taps ``out_indices`` reshaped to
[B, H/p, W/p, C], an optional LayerNorm per tap. The position embedding is
resized as ``jax.image.resize(..., "bilinear")`` does it: half-pixel
centres, and where the grid shrinks a triangle filter widened by the
shrink factor (antialiasing): ``F.interpolate(..., antialias=True)``; where
it grows, plain bilinear (the two agree there). Drop path draws from the
generator the caller passes. The modules carry the flax names
(``pos_embed``, ``cls_token`` keep theirs).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .common import Conv, Mlp, drop_path
from .mit import attention


def resize_pos_grid(grid: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """[1, g, g, C] -> [1, size[0], size[1], C] as ``jax.image.resize``'s
    bilinear method: antialiased where a side shrinks."""
    shrink = size[0] < grid.shape[1] or size[1] < grid.shape[2]
    out = F.interpolate(grid.permute(0, 3, 1, 2), size=tuple(size), mode="bilinear",
                        align_corners=False, antialias=shrink)
    return out.permute(0, 2, 3, 1)


class ViTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 drop_path: float = 0.0, qkv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.drop_path = drop_path
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, n, c = x.shape
        qkv = self.qkv(self.norm1(x)).reshape(b, n, 3, self.num_heads, c // self.num_heads)
        y = self.proj(attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]))
        x = x + drop_path(y, self.drop_path, self.training, generator)
        y = self.mlp(self.norm2(x))
        return x + drop_path(y, self.drop_path, self.training, generator)


class VisionTransformer(nn.Module):
    def __init__(self, embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 patch_size: int = 16, mlp_ratio: float = 4.0, drop_path_rate: float = 0.0,
                 out_indices: Sequence[int] = (2, 5, 8, 11), with_cls_token: bool = True,
                 final_norm: bool = False, pretrain_grid: int = 14, in_channels: int = 3):
        super().__init__()
        self.depth = depth
        self.patch_size = patch_size
        self.pretrain_grid = pretrain_grid
        self.out_indices = tuple(out_indices)
        self.out_channels = (embed_dim,) * len(self.out_indices)
        self.with_cls_token = with_cls_token
        self.final_norm = final_norm
        self.patch_embed = Conv(in_channels, embed_dim, patch_size, patch_size,
                                padding="VALID")
        n_extra = 1 if with_cls_token else 0
        self.pos_embed = nn.Parameter(torch.zeros(1, pretrain_grid ** 2 + n_extra, embed_dim))
        if with_cls_token:
            self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        dpr = np.linspace(0.0, drop_path_rate, depth)
        for i in range(depth):
            self.add_module(f"layers_{i}", ViTBlock(embed_dim, num_heads, mlp_ratio,
                                                    float(dpr[i])))
            if final_norm and i in self.out_indices:
                self.add_module(f"out_norm{i}", nn.LayerNorm(embed_dim, eps=1e-6))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, ...]:
        """x: [B, H, W, C] -> the taps, [B, H/p, W/p, C] each."""
        b, hh, ww, _ = x.shape
        gh, gw = hh // self.patch_size, ww // self.patch_size
        x = self.patch_embed(x)
        c = x.shape[-1]
        x = x.reshape(b, gh * gw, c)
        n_extra = 1 if self.with_cls_token else 0
        g = self.pretrain_grid
        grid_pos = resize_pos_grid(self.pos_embed[:, n_extra:].reshape(1, g, g, c), (gh, gw))
        grid_pos = grid_pos.reshape(1, gh * gw, c)
        if self.with_cls_token:
            x = torch.cat([self.cls_token.expand(b, 1, c), x], dim=1)
            x = x + torch.cat([self.pos_embed[:, :1], grid_pos], dim=1)
        else:
            x = x + grid_pos
        outs = []
        for i in range(self.depth):
            x = getattr(self, f"layers_{i}")(x, generator)
            if i in self.out_indices:
                y = x[:, n_extra:]
                if self.final_norm:
                    y = getattr(self, f"out_norm{i}")(y)
                outs.append(y.reshape(b, gh, gw, c))
        return tuple(outs)


def vit_variant(name: str) -> dict:
    variants = {
        "nano": dict(embed_dim=32, depth=2, num_heads=2, out_indices=(0, 1)),
        "base": dict(embed_dim=768, depth=12, num_heads=12,
                     out_indices=(2, 5, 8, 11)),
        "large": dict(embed_dim=1024, depth=24, num_heads=16,
                      out_indices=(5, 11, 17, 23)),
    }
    return dict(variants[name])
