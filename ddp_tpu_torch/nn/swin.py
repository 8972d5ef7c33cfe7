"""Swin Transformer backbone (port of ``ddp_tpu/nn/swin.py``), NHWC.

Parity traps carried over from the JAX package:
  - the shifted-window mask is -100 (not -inf) between pre-shift regions;
  - the shift is disabled when the padded grid is no larger than one window
    (``min(hp, wp) <= window``);
  - blocks zero-pad the grid up to a window multiple AFTER ``norm1``
    (stage 0 of a 512² image is 128×128, padded to 133×133 for window 7);
  - ``PatchMerging`` concatenates its 2×2 neighbours in (ky, kx, C) order,
    the JAX package's layout (mmseg's unfold is (C, ky, kx); the torch
    checkpoint importer permutes between them), so weights bridge from the
    JAX package with a plain transpose;
  - the FFN GELU is the tanh approximation (flax default);
  - drop path grows linearly over all blocks, ``linspace(0, rate, sum(depths))``
    (12 blocks for Swin-T), and draws from the generator the caller passes.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import device_constant
from .common import Mlp, drop_path


@functools.lru_cache(maxsize=128)
def _relative_position_index(window: int) -> np.ndarray:
    """[win², win²] indices into the (2w-1)² relative-position-bias table."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window), indexing="ij"))
    coords = coords.reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1)


@functools.lru_cache(maxsize=128)
def _shift_attn_mask(hp: int, wp: int, window: int, shift: int) -> Optional[np.ndarray]:
    """[num_windows, win², win²]: 0 for allowed pairs, -100 for pairs from
    different pre-shift regions; None without a shift."""
    if shift == 0:
        return None
    img_mask = np.zeros((hp, wp), np.int32)
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img_mask[hs, ws] = cnt
            cnt += 1
    m = img_mask.reshape(hp // window, window, wp // window, window)
    m = m.transpose(0, 2, 1, 3).reshape(-1, window * window)
    diff = m[:, None, :] != m[:, :, None]
    return np.where(diff, -100.0, 0.0).astype(np.float32)


@device_constant(maxsize=128)
def shift_attn_mask(hp: int, wp: int, window: int, shift: int,
                    device: torch.device) -> Optional[torch.Tensor]:
    """``_shift_attn_mask`` as a tensor on ``device``, built once per shape."""
    m = _shift_attn_mask(hp, wp, window, shift)
    return None if m is None else torch.as_tensor(m, device=device)


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """[B, H, W, C] -> [B*nW, win², C] (H, W divisible by window)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, c)


def window_reverse(x: torch.Tensor, window: int, h: int, w: int) -> torch.Tensor:
    """Inverse of window_partition."""
    c = x.shape[-1]
    b = x.shape[0] // ((h // window) * (w // window))
    x = x.reshape(b, h // window, w // window, window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


def window_attention(qkv: torch.Tensor, num_heads: int, bias: Optional[torch.Tensor],
                     mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Softmax attention inside each window.

    qkv: [B*nW, n, 3C] packed (3, heads, d) as flax's Dense output; bias:
    [heads, n, n] or None; mask: [nW, n, n] or None. Returns [B*nW, n, C].
    """
    bnw, n, c3 = qkv.shape
    c = c3 // 3
    d = c // num_heads
    q, k, v = qkv.reshape(bnw, n, 3, num_heads, d).permute(2, 0, 3, 1, 4)  # [bnw,h,n,d]
    attn = (q * d ** -0.5) @ k.transpose(-2, -1)  # [bnw, h, n, n]
    if bias is not None:
        attn = attn + bias[None]
    if mask is not None:
        nw = mask.shape[0]
        attn = (attn.reshape(bnw // nw, nw, num_heads, n, n)
                + mask.to(attn.dtype)[None, :, None])
        attn = attn.reshape(bnw, num_heads, n, n)
    attn = torch.softmax(attn, dim=-1)
    return (attn @ v).transpose(1, 2).reshape(bnw, n, c)


class WindowAttention(nn.Module):
    """Window MHSA with a learned relative-position bias."""

    def __init__(self, dim: int, num_heads: int, window: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.empty((2 * window - 1) ** 2, num_heads))
        self.register_buffer(
            "relative_position_index",
            torch.as_tensor(_relative_position_index(window).reshape(-1)),
            persistent=False)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        n = x.shape[1]
        bias = self.relative_position_bias_table[self.relative_position_index]
        bias = bias.reshape(n, n, self.num_heads).permute(2, 0, 1)
        return self.proj(window_attention(self.qkv(x), self.num_heads, bias, mask))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: int, shift: int,
                 mlp_ratio: float = 4.0, drop_path: float = 0.0):
        super().__init__()
        self.window = window
        self.shift = shift
        self.drop_path = drop_path
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, num_heads, window)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.ffn = Mlp(dim, int(dim * mlp_ratio), dim)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, h, w, c = x.shape
        win = self.window
        pad_h, pad_w = (-h) % win, (-w) % win
        hp, wp = h + pad_h, w + pad_w
        shift = self.shift if min(hp, wp) > win else 0

        y = self.norm1(x)
        if pad_h or pad_w:
            y = F.pad(y, (0, 0, 0, pad_w, 0, pad_h))
        if shift:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
        mask = shift_attn_mask(hp, wp, win, shift, x.device)
        y = window_reverse(self.attn(window_partition(y, win), mask), win, hp, wp)
        if shift:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        if pad_h or pad_w:
            y = y[:, :h, :w]
        x = x + drop_path(y, self.drop_path, self.training, generator)
        return x + drop_path(self.ffn(self.norm2(x)), self.drop_path, self.training, generator)


class PatchMerging(nn.Module):
    """2×2 space-to-depth in (ky, kx, C) order -> LN -> Linear(4C -> out)."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * in_dim, eps=1e-5)
        self.reduction = nn.Linear(4 * in_dim, out_dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        pad_h, pad_w = h % 2, w % 2
        if pad_h or pad_w:
            x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
            h, w = h + pad_h, w + pad_w
        x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, h // 2, w // 2, 4 * c)
        return self.reduction(self.norm(x))


class SwinTransformer(nn.Module):
    """Swin backbone; returns the out-normed features of ``out_indices``, NHWC."""

    def __init__(self, embed_dims: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window: int = 7,
                 patch_size: int = 4, mlp_ratio: float = 4.0,
                 out_indices: Sequence[int] = (0, 1, 2, 3), in_chans: int = 3,
                 drop_path_rate: float = 0.0):
        super().__init__()
        self.patch_size = patch_size
        self.depths = tuple(depths)
        self.out_indices = tuple(out_indices)
        self.patch_embed = nn.Conv2d(in_chans, embed_dims, patch_size, stride=patch_size)
        self.patch_norm = nn.LayerNorm(embed_dims, eps=1e-5)
        dpr = np.linspace(0.0, drop_path_rate, sum(self.depths))
        block_idx = 0
        for stage, depth in enumerate(self.depths):
            dim = embed_dims * 2 ** stage
            for blk in range(depth):
                self.add_module(f"stage{stage}_block{blk}", SwinBlock(
                    dim, num_heads[stage], window,
                    shift=0 if blk % 2 == 0 else window // 2, mlp_ratio=mlp_ratio,
                    drop_path=float(dpr[block_idx])))
                block_idx += 1
            if stage in self.out_indices:
                self.add_module(f"out_norm{stage}", nn.LayerNorm(dim, eps=1e-5))
            if stage < len(self.depths) - 1:
                self.add_module(f"downsample{stage}", PatchMerging(dim, dim * 2))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, ...]:
        p = self.patch_size
        pad_h, pad_w = (-x.shape[1]) % p, (-x.shape[2]) % p
        if pad_h or pad_w:
            x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
        x = self.patch_embed(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        x = self.patch_norm(x)
        outs = []
        for stage, depth in enumerate(self.depths):
            for blk in range(depth):
                x = getattr(self, f"stage{stage}_block{blk}")(x, generator)
            if stage in self.out_indices:
                outs.append(getattr(self, f"out_norm{stage}")(x))
            if stage < len(self.depths) - 1:
                x = getattr(self, f"downsample{stage}")(x)
        return tuple(outs)


def swin_variant(name: str) -> dict:
    """Constructor kwargs for the published Swin variants used by DDP configs."""
    variants = {
        # 'nano' is a test-only scale (not in the reference) for fast CPU CI
        "nano": dict(embed_dims=16, depths=(1, 1, 1, 1), num_heads=(1, 2, 2, 2),
                     window=4),
        "tiny": dict(embed_dims=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24)),
        "small": dict(embed_dims=96, depths=(2, 2, 18, 2), num_heads=(3, 6, 12, 24)),
        "base": dict(embed_dims=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32)),
        "large": dict(embed_dims=192, depths=(2, 2, 18, 2), num_heads=(6, 12, 24, 48),
                      window=12),
    }
    return dict(variants[name])
