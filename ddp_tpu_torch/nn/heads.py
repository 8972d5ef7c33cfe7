"""Decode heads (port of ``ddp_tpu/nn/heads.py:23-290``).

  - DeformableHeadWithTime: flatten HW -> sine or learned pos-enc ->
    time-FiLM encoder (msda over the one level, or window attention; FiLM
    v1/v2/v3) -> reshape -> 1x1 conv_seg (deformable_head_with_time.py:21-189).
  - DeformableDepthHead: the same encoder (msda, sine positions) with a
    one-channel ``conv_depth`` output, relu or softplus plus ``min_depth``;
    its 'upconv' variant ends in two pixel shuffles (x4 the encoder's grid).
  - FCNHead: the training-time auxiliary head (3x3 conv+BN+ReLU, dropout
    0.1 in training, 1x1 conv_seg) on the clean encoder features.
  - The heads that only the head registry (``head_registry.py``) builds:
    ``ConvWithTime`` / ``FCNHeadWithTime`` (fcn_head_with_time.py: conv,
    norm, FiLM(time) before the ReLU), ``NNHead`` (an FCN stack without a
    classifier), ``IdentityHead``, and ``DeformableHead`` (the deformable
    encoder without time conditioning, deformable_head.py).

NHWC in and out; every forward takes the generator its dropout draws from
(unused where nothing is random), so the registry's heads share one
interface.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .common import Conv, ConvModule, dropout, make_norm
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
                 num_heads: int = 8, ffn_dim: int = 1024, attn_type: str = "msda",
                 film: str = "v1", pos_type: str = "sine", window: int = 8,
                 pos_grid: Tuple[int, int] = (50, 50), remat: bool = False):
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
                                       film=film, remat=remat)
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


def pixel_shuffle(x: torch.Tensor, scale: int) -> torch.Tensor:
    """NHWC depth-to-space as the JAX package lays it out: [B, H, W, C] ->
    [B, H·s, W·s, C/s²], input channels ordered (sy, sx, c'). Not
    ``F.pixel_shuffle``, whose input channels are ordered (c', sy, sx): JAX
    weights of the 'upconv' head would give other outputs through it."""
    b, h, w, c = x.shape
    x = x.reshape(b, h, w, scale, scale, c // (scale * scale))
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h * scale, w * scale, c // (scale * scale))


class DeformableDepthHead(nn.Module):
    """The time-FiLM decoder with a depth output (``ddp_tpu/nn/heads.py:
    83-147``; the reference's decode_head.py:258-270, scale_up off, eps on).

    ``variant``: 'deform' - a 1x1 ``conv_depth`` on the encoder's grid;
    'upconv' - pixel shuffle x2, a 3x3 ConvModule + ReLU (``up_conv``), pixel
    shuffle x2, a 3x3 ``conv_depth``: the output is 4x the encoder's grid;
    'spade' - the 'deform' compute, with a ``condition`` argument accepted and
    unused, as in the reference. ``act``: 'relu' (the reference's; a head
    whose conv_depth goes all negative stops learning) or 'softplus'; the
    output is act(conv_depth) + min_depth. ``init_params_`` starts
    ``conv_depth``'s bias at 0.5, as the JAX package's init does."""

    def __init__(self, embed_dims: int = 256, num_layers: int = 6, num_heads: int = 8,
                 ffn_dim: int = 1024, min_depth: float = 1e-3, variant: str = "deform",
                 act: str = "relu", film: str = "v1", remat: bool = False):
        super().__init__()
        if variant not in ("deform", "upconv", "spade"):
            raise ValueError(f"variant must be 'deform', 'upconv' or 'spade', got {variant!r}")
        if act not in ("relu", "softplus"):
            raise ValueError(f"act must be 'relu' or 'softplus', got {act!r}")
        self.embed_dims = embed_dims
        self.min_depth = min_depth
        self.variant = variant
        self.act = act
        self.encoder = TimeFiLMEncoder(num_layers, embed_dims, num_heads, ffn_dim=ffn_dim,
                                       use_time=True, attn_type="msda", film=film,
                                       remat=remat)
        if variant == "upconv":
            self.up_conv = ConvModule(embed_dims // 4, embed_dims // 4, (3, 3), act="relu")
            self.conv_depth = nn.Conv2d(embed_dims // 16, 1, 3, padding=1)
        else:
            self.conv_depth = nn.Conv2d(embed_dims, 1, 1)

    def forward(self, x: torch.Tensor, time: Optional[torch.Tensor],
                condition: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: [B, H, W, C]; time: [B, 4C]. Returns metric depth [B, H, W, 1]
        ([B, 4H, 4W, 1] for 'upconv')."""
        del condition  # accepted and unused, as in the reference
        b, h, w, c = x.shape
        pos = _sine_pos(h, w, self.embed_dims // 2, x.device).to(x.dtype)
        refs = _reference_points(h, w, x.device).to(x.dtype)
        q = self.encoder(x.reshape(b, h * w, c), time, pos, refs, ((h, w),))
        q = q.reshape(b, h, w, c)
        if self.variant == "upconv":
            q = pixel_shuffle(self.up_conv(pixel_shuffle(q, 2)), 2)
        depth = self.conv_depth(q.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        depth = F.softplus(depth) if self.act == "softplus" else F.relu(depth)
        return depth + self.min_depth


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


class ConvWithTime(nn.Module):
    """conv -> norm -> FiLM(time) -> ReLU (the reference's ConvWithTimeModule):
    with a time vector, SiLU -> Linear(T -> 2C) gives (scale, shift), applied
    as x·(scale + 1) + shift before the activation. ``time_in`` None: no
    time MLP (the flax module has one only where it was called with a time
    vector)."""

    def __init__(self, in_channels: int, features: int, kernel_size=(3, 3), dilation: int = 1,
                 norm: Optional[str] = "SyncBN", time_in: Optional[int] = 1024):
        super().__init__()
        self.conv = Conv(in_channels, features, kernel_size, dilation=dilation,
                         bias=norm is None)
        self.norm = make_norm(norm, features)
        if time_in is not None:
            self.time_mlp = nn.Linear(time_in, features * 2)

    def forward(self, x: torch.Tensor, time: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.conv(x)
        if isinstance(self.norm, nn.LayerNorm):
            x = self.norm(x)
        elif self.norm is not None:
            x = self.norm(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        if time is not None:
            scale, shift = self.time_mlp(F.silu(time))[:, None, None, :].chunk(2, dim=-1)
            x = x * (scale + 1.0) + shift
        return F.relu(x)


class FCNHeadWithTime(nn.Module):
    """FCN denoising head with FiLM time conditioning in every conv
    (fcn_head_with_time.py: ``num_convs`` ConvWithTime, the optional
    ``concat_input`` conv_cat, dropout, 1x1 conv_seg)."""

    def __init__(self, num_classes: int, in_channels: int, channels: int = 256,
                 num_convs: int = 2, kernel_size: int = 3, dilation: int = 1,
                 concat_input: bool = True, dropout: float = 0.1,
                 norm: Optional[str] = "SyncBN", time_in: Optional[int] = 1024):
        super().__init__()
        self.num_convs, self.concat_input, self.dropout = num_convs, concat_input, dropout
        k = (kernel_size, kernel_size)
        for i in range(num_convs):
            self.add_module(f"conv{i}", ConvWithTime(in_channels if i == 0 else channels,
                                                     channels, k, dilation, norm, time_in))
        if concat_input:
            self.conv_cat = ConvModule(in_channels + channels, channels, k, norm=norm,
                                       act="relu")
        self.conv_seg = Conv(channels, num_classes, 1)

    def forward(self, x: torch.Tensor, time: Optional[torch.Tensor],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        inputs = x
        for i in range(self.num_convs):
            x = getattr(self, f"conv{i}")(x, time)
        if self.concat_input:
            x = self.conv_cat(torch.cat([inputs, x], dim=-1))
        return self.conv_seg(dropout(x, self.dropout, self.training, generator))


class NNHead(nn.Module):
    """An FCN stack without a classifier (the reference's NNHead, a feature
    refiner): ``channels`` out."""

    def __init__(self, in_channels: int, channels: int = 256, num_convs: int = 2,
                 kernel_size: int = 3, dilation: int = 1, concat_input: bool = True,
                 norm: Optional[str] = "SyncBN"):
        super().__init__()
        self.num_convs, self.concat_input = num_convs, concat_input
        k = (kernel_size, kernel_size)
        for i in range(num_convs):
            self.add_module(f"conv{i}", ConvModule(in_channels if i == 0 else channels,
                                                   channels, k, norm=norm, act="relu"))
        if concat_input:
            self.conv_cat = ConvModule(in_channels + channels, channels, k, norm=norm,
                                       act="relu")

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        inputs = x
        for i in range(self.num_convs):
            x = getattr(self, f"conv{i}")(x)
        if self.concat_input:
            x = self.conv_cat(torch.cat([inputs, x], dim=-1))
        return x


class IdentityHead(nn.Module):
    """Pass-through head (identity_head.py)."""

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return x


class DeformableHead(nn.Module):
    """The deformable-attention head without time conditioning
    (deformable_head.py): the msda encoder on one level, sine positions,
    1x1 conv_seg."""

    def __init__(self, num_classes: int, embed_dims: int = 256, num_layers: int = 6,
                 num_heads: int = 8, num_points: int = 4, ffn_dim: int = 1024):
        super().__init__()
        self.embed_dims = embed_dims
        self.encoder = TimeFiLMEncoder(num_layers, embed_dims, num_heads, 1, num_points,
                                       ffn_dim, use_time=False, attn_type="msda")
        self.conv_seg = Conv(embed_dims, num_classes, 1)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, h, w, c = x.shape
        pos = _sine_pos(h, w, self.embed_dims // 2, x.device).to(x.dtype)
        refs = _reference_points(h, w, x.device).to(x.dtype)
        q = self.encoder(x.reshape(b, h * w, c), None, pos, refs, ((h, w),))
        return self.conv_seg(q.reshape(b, h, w, c))
