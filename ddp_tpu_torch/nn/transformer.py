"""Time-FiLM transformer encoder of the DDP denoising decoder
(port of ``ddp_tpu/nn/transformer.py:122-237,240-296``).

Ported: the v1 layer (post-norm attn -> norm -> ffn -> norm, one trailing
FiLM: time -> SiLU -> Linear(4C -> 2C), query·(scale+1)+shift) over the
dense shifted-window self-attention that the presets ship. Not yet ported:
FiLM v2/v3 and the msda path (``DeformableAttention``/``ms_deform_attn``).

Layout is batch-first [B, S, C], as in the JAX package.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .common import Mlp
from .swin import shift_attn_mask, window_attention, window_partition, window_reverse


class WindowSelfAttention(nn.Module):
    """Dense shifted-window self-attention over the token grid, Swin-style
    partition/shift/mask, no relative bias (position comes from the sine
    embedding added to the query). The residual is added inside."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8, window: int = 8,
                 shift: int = 0, residual: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.window = window
        self.shift = shift
        self.residual = residual
        self.qkv = nn.Linear(embed_dims, 3 * embed_dims)
        self.proj = nn.Linear(embed_dims, embed_dims)

    def forward(self, query: torch.Tensor, query_pos: Optional[torch.Tensor],
                hw: Tuple[int, int]) -> torch.Tensor:
        b, s, c = query.shape
        h, w = hw
        identity = query
        if query_pos is not None:
            query = query + query_pos
        x = query.reshape(b, h, w, c)
        win = self.window
        pad_h, pad_w = (-h) % win, (-w) % win
        hp, wp = h + pad_h, w + pad_w
        shift = self.shift if min(hp, wp) > win else 0
        if pad_h or pad_w:
            x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
        if shift:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
        mask = shift_attn_mask(hp, wp, win, shift, query.device)
        y = self.proj(window_attention(self.qkv(window_partition(x, win)),
                                       self.num_heads, None, mask))
        y = window_reverse(y, win, hp, wp)
        if shift:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        if pad_h or pad_w:
            y = y[:, :h, :w]
        y = y.reshape(b, s, c)
        return identity + y if self.residual else y


class TimeFiLMEncoderLayer(nn.Module):
    """DETR encoder layer, v1: attn -> norm1 -> (+ffn) -> norm2 -> FiLM(time)."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8, ffn_dim: int = 1024,
                 use_time: bool = True, attn_type: str = "window", window: int = 8,
                 shift: int = 0, film: str = "v1"):
        super().__init__()
        if attn_type != "window":
            raise NotImplementedError(
                f"decoder attn_type={attn_type!r} is not ported yet (only 'window')")
        if film != "v1":
            raise NotImplementedError(f"FiLM variant {film!r} is not ported yet (only 'v1')")
        self.use_time = use_time
        self.attn = WindowSelfAttention(embed_dims, num_heads, window, shift)
        self.norm1 = nn.LayerNorm(embed_dims, eps=1e-5)
        self.ffn = Mlp(embed_dims, ffn_dim, embed_dims)
        self.norm2 = nn.LayerNorm(embed_dims, eps=1e-5)
        if use_time:
            self.time_mlp = nn.Linear(embed_dims * 4, embed_dims * 2)

    def forward(self, query: torch.Tensor, time: Optional[torch.Tensor],
                query_pos: Optional[torch.Tensor], hw: Tuple[int, int]) -> torch.Tensor:
        query = self.norm1(self.attn(query, query_pos, hw))
        query = self.norm2(query + self.ffn(query))
        if self.use_time and time is not None:
            scale, shift = self.time_mlp(F.silu(time))[:, None, :].chunk(2, dim=-1)
            query = query * (scale + 1.0) + shift
        return query


class TimeFiLMEncoder(nn.Module):
    """Stack of ``num_layers`` TimeFiLMEncoderLayer; odd layers shift by window//2."""

    def __init__(self, num_layers: int = 6, embed_dims: int = 256, num_heads: int = 8,
                 ffn_dim: int = 1024, use_time: bool = True, attn_type: str = "window",
                 window: int = 8, film: str = "v1"):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer{i}", TimeFiLMEncoderLayer(
                embed_dims, num_heads, ffn_dim, use_time, attn_type, window,
                shift=0 if i % 2 == 0 else window // 2, film=film))

    def forward(self, query: torch.Tensor, time: Optional[torch.Tensor],
                query_pos: Optional[torch.Tensor], hw: Tuple[int, int]) -> torch.Tensor:
        for i in range(self.num_layers):
            query = getattr(self, f"layer{i}")(query, time, query_pos, hw)
        return query
