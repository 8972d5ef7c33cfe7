"""Compat backbones III: Twins (PCPVT/SVT), BEiT, EfficientNet (port of
``ddp_tpu/nn/transformer_backbones.py``).

mmseg's twins and beit and the depth toolbox's efficientnet as the JAX
package re-designs them: each takes NHWC images and returns a tuple of NHWC
maps whose channels it names in ``out_channels``. Tokens are [B, N, C] in
row-major (h, w) order. Flax semantics kept:

  - Twins: patch embeds and the GSA ``sr`` conv are flax ``SAME`` convs with
    kernel = stride; LayerNorm eps 1e-6; the PEG (3x3 depthwise) after each
    stage's first block; SVT alternates LSA (even blocks) and GSA and norms
    every stage's output, which the next stage embeds. LSA pads the grid to
    a window multiple and adds −1000 to the padded keys: at 512², stage 0 is
    128², which 7 does not divide.
  - BEiT: the relative-position table is sized by the token grid of one
    input size (JAX's table is shaped at init by the grid it sees), so the
    port builds it for ``grid`` and raises on another grid; no [CLS] token;
    LayerScale ``gamma1``/``gamma2`` start at ``init_values``.
  - EfficientNet: flax BatchNorm (momentum 0.9, eps 1e-3, the biased batch
    variance), ``SAME`` strided convs padded as flax pads them (the extra
    row after), SE on ``inp // 4`` channels, swish.

GELU is flax's tanh form. Attention is one softmax(q·kᵀ/√d)·v through
``F.scaled_dot_product_attention`` (biases as its additive mask). Drop path
draws from the generator the caller passes. The modules carry the flax
names, so ``convert.py`` maps JAX weights; ``flax_init`` gives the bare
parameters JAX's initialisers.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import device_constant
from .common import BatchNorm2d, Conv, Conv2dSame, Mlp, drop_path, trunc_normal


def _attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
          bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dense multi-head attention over tokens: q [B, N, C], k, v [B, M, C];
    ``bias`` added to the logits (broadcast against [B, heads, N, M])."""
    b, n, c = q.shape
    d = c // num_heads

    def heads(t):
        return t.reshape(b, t.shape[1], num_heads, d).transpose(1, 2)

    out = F.scaled_dot_product_attention(heads(q), heads(k), heads(v),
                                         attn_mask=None if bias is None else bias.to(q.dtype))
    return out.transpose(1, 2).reshape(b, n, c)


class GlobalSubsampledAttention(nn.Module):
    """Twins GSA: keys and values from an ``sr_ratio``-strided conv of the map."""

    def __init__(self, dim: int, num_heads: int, sr_ratio: int = 1):
        super().__init__()
        self.num_heads = num_heads
        self.q = nn.Linear(dim, dim)
        if sr_ratio > 1:
            self.sr = Conv(dim, dim, sr_ratio, sr_ratio)
            self.sr_norm = nn.LayerNorm(dim, eps=1e-6)
        self.k = nn.Linear(dim, dim)
        self.v = nn.Linear(dim, dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
        b, n, c = x.shape
        kv_in = x
        if hasattr(self, "sr"):
            kv_in = self.sr_norm(self.sr(x.reshape(b, *hw, c))).reshape(b, -1, c)
        return self.proj(_attn(self.q(x), self.k(kv_in), self.v(kv_in), self.num_heads))


@device_constant(maxsize=64)
def _pad_key_bias(h: int, w: int, ws: int, device: torch.device) -> torch.Tensor:
    """[nW, ws²]: −1000 at the keys that padding added, 0 elsewhere (windows
    in row-major order)."""
    hh, ww = h + (-h) % ws, w + (-w) % ws
    valid = np.zeros((hh, ww), np.float32)
    valid[:h, :w] = 1.0
    valid = valid.reshape(hh // ws, ws, ww // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    return torch.as_tensor((1.0 - valid) * -1000.0, device=device)


class LocallyGroupedAttention(nn.Module):
    """Twins-SVT LSA: full attention inside non-overlapping windows of
    ``min(window_size, h, w)``; a grid the window does not divide is padded
    after, and the padded keys get −1000 (twins.py:118-125)."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 7):
        super().__init__()
        self.num_heads = num_heads
        self.window_size = window_size
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
        b, n, c = x.shape
        h, w = hw
        ws = min(self.window_size, h, w)
        pad_h, pad_w = (-h) % ws, (-w) % ws
        y = x.reshape(b, h, w, c)
        if pad_h or pad_w:
            y = F.pad(y, (0, 0, 0, pad_w, 0, pad_h))
        hh, ww = h + pad_h, w + pad_w
        y = y.reshape(b, hh // ws, ws, ww // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
        q, k, v = self.qkv(y.reshape(-1, ws * ws, c)).chunk(3, dim=-1)
        bias = None
        if pad_h or pad_w:
            bias = _pad_key_bias(h, w, ws, x.device).repeat(b, 1)[:, None, None, :]
        out = self.proj(_attn(q, k, v, self.num_heads, bias))
        out = out.reshape(b, hh // ws, ww // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
        return out.reshape(b, hh, ww, c)[:, :h, :w].reshape(b, n, c)


class _TwinsBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, attn: str, sr_ratio: int = 1,
                 window_size: int = 7, mlp_ratio: float = 4.0, drop_path: float = 0.0):
        super().__init__()
        self.drop_path = drop_path
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = (GlobalSubsampledAttention(dim, num_heads, sr_ratio) if attn == "gsa"
                     else LocallyGroupedAttention(dim, num_heads, window_size))
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim)

    def forward(self, x: torch.Tensor, hw: Tuple[int, int],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x + drop_path(self.attn(self.norm1(x), hw), self.drop_path, self.training, generator)
        return x + drop_path(self.mlp(self.norm2(x)), self.drop_path, self.training, generator)


class Twins(nn.Module):
    """Twins-PCPVT (GSA in every block) or Twins-SVT (``svt``: LSA/GSA
    alternating, norm after every stage)."""

    def __init__(self, dims: Sequence[int] = (64, 128, 320, 512),
                 depths: Sequence[int] = (3, 4, 6, 3), num_heads: Sequence[int] = (1, 2, 5, 8),
                 sr_ratios: Sequence[int] = (8, 4, 2, 1), svt: bool = False,
                 window_size: int = 7, drop_path_rate: float = 0.0,
                 out_indices: Sequence[int] = (0, 1, 2, 3), in_channels: int = 3):
        super().__init__()
        self.depths = tuple(depths)
        self.svt = svt
        self.out_indices = tuple(out_indices)
        self.out_channels = tuple(dims[s] for s in range(len(dims)) if s in self.out_indices)
        dpr = np.linspace(0, drop_path_rate, sum(self.depths))
        bi, cin = 0, in_channels
        for s, (dim, depth, heads, sr) in enumerate(zip(dims, depths, num_heads, sr_ratios)):
            ps = 4 if s == 0 else 2
            self.add_module(f"patch_embed{s}", Conv(cin, dim, ps, ps))
            self.add_module(f"pe_norm{s}", nn.LayerNorm(dim, eps=1e-6))
            for i in range(depth):
                attn = "lsa" if (svt and i % 2 == 0) else "gsa"
                self.add_module(f"s{s}_block{i}", _TwinsBlock(
                    dim, heads, attn, sr_ratio=sr, window_size=window_size,
                    drop_path=float(dpr[bi])))
                bi += 1
            self.add_module(f"peg{s}", Conv(dim, dim, 3, groups=dim))
            if svt or s in self.out_indices:
                self.add_module(f"out_norm{s}", nn.LayerNorm(dim, eps=1e-6))
            cin = dim

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, ...]:
        outs = []
        for s, depth in enumerate(self.depths):
            x = getattr(self, f"pe_norm{s}")(getattr(self, f"patch_embed{s}")(x))
            b, h, w, c = x.shape
            t = x.reshape(b, h * w, c)
            for i in range(depth):
                t = getattr(self, f"s{s}_block{i}")(t, (h, w), generator)
                if i == 0:  # PEG conditional position encoding
                    t = getattr(self, f"peg{s}")(t.reshape(b, h, w, c)).reshape(b, h * w, c) + t
            x = t.reshape(b, h, w, c)
            if self.svt:
                x = getattr(self, f"out_norm{s}")(x)
                if s in self.out_indices:
                    outs.append(x)
            elif s in self.out_indices:
                outs.append(getattr(self, f"out_norm{s}")(x))
        return tuple(outs)


@functools.lru_cache(maxsize=16)
def _rel_pos_index(h: int, w: int) -> np.ndarray:
    """[h·w · h·w] indices into the (2h−1)(2w−1) relative-position table."""
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    coords = np.stack([ys.reshape(-1), xs.reshape(-1)])
    rel = coords[:, :, None] - coords[:, None, :]
    return ((rel[0] + h - 1) * (2 * w - 1) + (rel[1] + w - 1)).reshape(-1)


class _BEiTBlock(nn.Module):
    """BEiT block: a relative-position bias over the token grid ``grid`` and
    LayerScale (mmseg beit.py BEiTTransformerEncoderLayer)."""

    def __init__(self, dim: int, num_heads: int, grid: Tuple[int, int],
                 mlp_ratio: float = 4.0, init_values: float = 0.1, drop_path: float = 0.0):
        super().__init__()
        h, w = grid
        self.num_heads = num_heads
        self.init_values = init_values
        self.drop_path = drop_path
        self.rel_pos_table = nn.Parameter(torch.empty((2 * h - 1) * (2 * w - 1), num_heads))
        self.register_buffer("rel_pos_index", torch.as_tensor(_rel_pos_index(h, w)),
                             persistent=False)
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.gamma1 = nn.Parameter(torch.empty(dim))
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim)
        self.gamma2 = nn.Parameter(torch.empty(dim))

    def flax_init(self, leaf: str, shape, gen: torch.Generator) -> Optional[torch.Tensor]:
        if leaf == "rel_pos_table":
            return trunc_normal(shape, gen)
        if leaf in ("gamma1", "gamma2"):
            return torch.full(shape, self.init_values)
        return None

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        n = x.shape[1]
        bias = self.rel_pos_table[self.rel_pos_index].reshape(n, n, self.num_heads)
        q, k, v = self.qkv(self.norm1(x)).chunk(3, dim=-1)
        y = self.proj(_attn(q, k, v, self.num_heads, bias.permute(2, 0, 1)))
        x = x + drop_path(self.gamma1 * y, self.drop_path, self.training, generator)
        y = self.mlp(self.norm2(x))
        return x + drop_path(self.gamma2 * y, self.drop_path, self.training, generator)


class BEiT(nn.Module):
    """BEiT/MAE-style ViT backbone: a VALID patch embed, blocks with a
    relative-position bias and LayerScale, the taps ``out_indices`` as
    [B, H/p, W/p, C] maps (upsampled by the caller's neck). Built for the
    token grid ``grid`` (H/p, W/p) of one image size; another raises."""

    def __init__(self, embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 patch_size: int = 16, init_values: float = 0.1, drop_path_rate: float = 0.0,
                 out_indices: Sequence[int] = (3, 5, 7, 11), *, grid: Tuple[int, int],
                 in_channels: int = 3):
        super().__init__()
        self.depth = depth
        self.patch_size = patch_size
        self.grid = tuple(grid)
        self.out_indices = tuple(out_indices)
        self.out_channels = (embed_dim,) * len(self.out_indices)
        self.patch_embed = Conv(in_channels, embed_dim, patch_size, patch_size)
        dpr = np.linspace(0, drop_path_rate, depth)
        for i in range(depth):
            self.add_module(f"block{i}", _BEiTBlock(embed_dim, num_heads, self.grid,
                                                    init_values=init_values,
                                                    drop_path=float(dpr[i])))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, ...]:
        x = self.patch_embed(x)
        b, h, w, c = x.shape
        if (h, w) != self.grid:
            raise ValueError(f"BEiT is built for a {self.grid} token grid, got {(h, w)}")
        t = x.reshape(b, h * w, c)
        outs = []
        for i in range(self.depth):
            t = getattr(self, f"block{i}")(t, generator)
            if i in self.out_indices:
                outs.append(t.reshape(b, h, w, c))
        return tuple(outs)


# EfficientNet-B0 stage settings: (expand, kernel, stride, out, repeats)
_EFFNET_B0 = [
    (1, 3, 1, 16, 1),
    (6, 3, 2, 24, 2),
    (6, 5, 2, 40, 2),
    (6, 3, 2, 80, 3),
    (6, 5, 1, 112, 3),
    (6, 5, 2, 192, 4),
    (6, 3, 1, 320, 1),
]


class EfficientNet(nn.Module):
    """EfficientNet backbone (depth/depth/models/backbones/efficientnet.py):
    MBConv stages (inverted residual, SE ratio 0.25, swish); ``width_mult``
    and ``depth_mult`` give B0..B7. Taps after ``out_stages``."""

    def __init__(self, width_mult: float = 1.0, depth_mult: float = 1.0,
                 out_stages: Sequence[int] = (1, 2, 4, 6), in_channels: int = 3):
        super().__init__()
        self.out_stages = tuple(out_stages)

        def rnd_w(w):
            w = w * width_mult
            nw = max(8, int(w + 4) // 8 * 8)
            return int(nw + 8) if nw < 0.9 * w else int(nw)

        def cbn(name, cin, cout, k=1, s=1, groups=1):
            self.add_module(name, Conv2dSame(cin, cout, k, s, groups=groups))
            self.add_module(f"{name}_bn", BatchNorm2d(cout, eps=1e-3))

        cbn("stem", in_channels, rnd_w(32), 3, 2)
        self.blocks = []  # (prefix, expand, stride, residual) per block
        inp, outs = rnd_w(32), []
        for si, (e, k, s, o, r) in enumerate(_EFFNET_B0):
            o = rnd_w(o)
            for i in range(int(np.ceil(r * depth_mult))):
                stride, exp, pre = s if i == 0 else 1, inp * e, f"s{si}b{i}"
                if e != 1:
                    cbn(f"{pre}_exp", inp, exp)
                cbn(f"{pre}_dw", exp, exp, k, stride, groups=exp)
                self.add_module(f"{pre}_se1", Conv2dSame(exp, max(1, inp // 4), 1, bias=True))
                self.add_module(f"{pre}_se2", Conv2dSame(max(1, inp // 4), exp, 1, bias=True))
                cbn(f"{pre}_pw", exp, o)
                self.blocks.append((si, pre, e != 1, stride == 1 and inp == o))
                inp = o
            if si in self.out_stages:
                outs.append(o)
        self.out_channels = tuple(outs)

    def _cbn(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return getattr(self, f"{name}_bn")(getattr(self, name)(x))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, ...]:
        x = F.silu(self._cbn("stem", x.permute(0, 3, 1, 2).contiguous()))
        outs = []
        for j, (si, pre, expand, residual) in enumerate(self.blocks):
            y = F.silu(self._cbn(f"{pre}_exp", x)) if expand else x
            y = F.silu(self._cbn(f"{pre}_dw", y))
            se = F.silu(getattr(self, f"{pre}_se1")(y.mean(dim=(2, 3), keepdim=True)))
            y = y * torch.sigmoid(getattr(self, f"{pre}_se2")(se))
            y = self._cbn(f"{pre}_pw", y)
            x = x + y if residual else y
            last = j + 1 == len(self.blocks) or self.blocks[j + 1][0] != si
            if last and si in self.out_stages:
                outs.append(x.permute(0, 2, 3, 1))
        return tuple(outs)
