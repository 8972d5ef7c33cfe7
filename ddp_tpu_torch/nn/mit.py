"""Mix Vision Transformer, the SegFormer backbone (port of
``ddp_tpu/nn/mit.py:21-130``).

mmseg's MixVisionTransformer (mit.py): overlapping patch embeds (7/4, then
3/2) with flax's ``SAME`` padding (the extra row after: torch's symmetric
padding 3 gives the same size but other pixels), efficient self-attention
whose keys and values come from a ``sr_ratio``-strided conv, Mix-FFN with a
3x3 depthwise conv and flax's tanh GELU, LayerNorm eps 1e-6. Tokens are
[B, N, C] with N in row-major (h, w) order, as the JAX package's NHWC
reshape gives them; maps are NHWC. Drop path draws from the generator the
caller passes. The modules carry the flax names.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .common import Conv, drop_path, gelu


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q·kᵀ/√d)·v over [B, N, heads, d] -> [B, N, heads·d]."""
    b, n = q.shape[:2]
    out = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                         v.transpose(1, 2))
    return out.transpose(1, 2).reshape(b, n, -1)


class EfficientAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, sr_ratio: int = 1):
        super().__init__()
        self.num_heads = num_heads
        self.q = nn.Linear(dim, dim)
        if sr_ratio > 1:
            self.sr = Conv(dim, dim, sr_ratio, sr_ratio, padding="VALID")
            self.sr_norm = nn.LayerNorm(dim, eps=1e-6)
        self.kv = nn.Linear(dim, 2 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
        b, n, c = x.shape
        nh = self.num_heads
        q = self.q(x).reshape(b, n, nh, c // nh)
        kv_in = x
        if hasattr(self, "sr"):
            kv_in = self.sr_norm(self.sr(x.reshape(b, *hw, c)).reshape(b, -1, c))
        kv = self.kv(kv_in).reshape(b, -1, 2, nh, c // nh)
        return self.proj(attention(q, kv[:, :, 0], kv[:, :, 1]))


class MixFFN(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.dwconv = Conv(hidden, hidden, 3, groups=hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
        b, n, _ = x.shape
        y = self.fc1(x)
        y = self.dwconv(y.reshape(b, *hw, -1)).reshape(b, n, -1)
        return self.fc2(gelu(y))


class MiTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, sr_ratio: int, mlp_ratio: float = 4.0,
                 drop_path: float = 0.0):
        super().__init__()
        self.drop_path = drop_path
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = EfficientAttention(dim, num_heads, sr_ratio)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.ffn = MixFFN(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor, hw: Tuple[int, int],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        y = self.attn(self.norm1(x), hw)
        x = x + drop_path(y, self.drop_path, self.training, generator)
        y = self.ffn(self.norm2(x), hw)
        return x + drop_path(y, self.drop_path, self.training, generator)


class MixVisionTransformer(nn.Module):
    def __init__(self, embed_dims: Sequence[int] = (64, 128, 320, 512),
                 depths: Sequence[int] = (3, 4, 6, 3), num_heads: Sequence[int] = (1, 2, 5, 8),
                 sr_ratios: Sequence[int] = (8, 4, 2, 1), drop_path_rate: float = 0.1,
                 out_indices: Sequence[int] = (0, 1, 2, 3), in_channels: int = 3):
        super().__init__()
        self.depths = tuple(depths)
        self.out_indices = tuple(out_indices)
        self.out_channels = tuple(d for i, d in enumerate(embed_dims) if i in self.out_indices)
        dpr = np.linspace(0.0, drop_path_rate, sum(depths))
        ch, blk_i = in_channels, 0
        for stage, depth in enumerate(depths):
            patch, stride = (7, 4) if stage == 0 else (3, 2)
            dim = embed_dims[stage]
            self.add_module(f"patch_embed{stage}", Conv(ch, dim, patch, stride))
            self.add_module(f"embed_norm{stage}", nn.LayerNorm(dim, eps=1e-6))
            for blk in range(depth):
                self.add_module(f"stage{stage}_block{blk}", MiTBlock(
                    dim, num_heads[stage], sr_ratios[stage], 4.0, float(dpr[blk_i])))
                blk_i += 1
            self.add_module(f"out_norm{stage}", nn.LayerNorm(dim, eps=1e-6))
            ch = dim

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, ...]:
        """x: [B, H, W, C] -> the stages' maps, NHWC."""
        m_ = self._modules
        b = x.shape[0]
        outs = []
        for stage, depth in enumerate(self.depths):
            x = m_[f"patch_embed{stage}"](x)
            h, w, c = x.shape[1:]
            x = m_[f"embed_norm{stage}"](x.reshape(b, h * w, c))
            for blk in range(depth):
                x = m_[f"stage{stage}_block{blk}"](x, (h, w), generator)
            x = m_[f"out_norm{stage}"](x).reshape(b, h, w, c)
            if stage in self.out_indices:
                outs.append(x)
        return tuple(outs)


def mit_variant(name: str) -> dict:
    depths = {
        "nano": (1, 1, 1, 1), "b0": (2, 2, 2, 2), "b1": (2, 2, 2, 2),
        "b2": (3, 4, 6, 3), "b3": (3, 4, 18, 3), "b4": (3, 8, 27, 3),
        "b5": (3, 6, 40, 3),
    }
    dims = {
        "nano": (16, 32, 64, 128), "b0": (32, 64, 160, 256),
    }
    d = dict(depths=depths[name])
    d["embed_dims"] = dims.get(name, (64, 128, 320, 512))
    if name == "nano":
        d["num_heads"] = (1, 2, 4, 8)
    return d
