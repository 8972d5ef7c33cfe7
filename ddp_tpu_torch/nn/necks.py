"""The neck zoo beyond FPN and MultiStageMerging (port of
``ddp_tpu/nn/necks.py``).

  - ``PPM``/``PSPNeck`` (depth toolbox necks/psp.py): pyramid pooling on the
    last level, its fused map appended as an extra level. This PPM is the
    neck's own: each pooled grid averages the map cut to a multiple of the
    scale (``h // s · s`` rows, as the JAX package does; mmseg's adaptive
    pool covers every row), and the scale-1 branch takes GroupNorm.
  - ``MultiLevelNeck`` (mmseg necks/multilevel_neck.py): per-level 1x1
    lateral, a rescale, a 3x3 conv.
  - ``Feature2Pyramid`` (mmseg necks/featurepyramid.py): transposed convs
    (x4: conv, BatchNorm, tanh GELU, conv; x2: one conv), identity, or
    flax's ``VALID`` max pool (x0.5, x0.25); another rescale raises
    KeyError.
  - ``SkipNeck``: per-level bilinear rescale (align_corners).
  - ``HAHINeck`` (DepthFormer hahi.py): multi-level deformable
    self-attention over the transformer levels (level embeddings + sine
    positions) and deformable cross-attention from the first (conv) level
    into them at learned reference points, through the port's
    ``DeformableAttention`` and ``ops/deform_attn.py``.
  - ``JPU`` (FastFCN): per-level 3x3 convs upsampled to the finest,
    concatenated, and four dilated depthwise-separable convs.

Every neck takes the input maps' channels at construction and names its
outputs' in ``out_channels`` (``SkipNeck``, which has no weights, takes
none). Maps are NHWC; resizes are ``ops/resize.py``'s. The modules carry
the flax names (``Feature2Pyramid``'s x4 BatchNorm, flax's auto-named
``BatchNorm_0``, is ``norm``), so ``convert.py`` maps JAX weights.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..device import device_constant
from ..ops.resize import resize
from .common import ConvModule, gelu, make_norm, trunc_normal
from .compat_heads import DepthwiseSeparableConv
from .pos_embed import sine_pos_embed
from .transformer import DeformableAttention, reference_points


class PPM(nn.Module):
    """Average pools to ``pool_scales`` grids (over the map cut to a
    multiple of each scale), 1x1 ConvModule + ReLU (GroupNorm at scale 1),
    bilinear back to the map's size. Returns the list of branches."""

    def __init__(self, in_channels: int, channels: int, pool_scales: Sequence[int] = (1, 2, 3, 6),
                 norm: str = "BN", align_corners: bool = False):
        super().__init__()
        self.pool_scales = tuple(pool_scales)
        self.align_corners = align_corners
        for s in self.pool_scales:
            self.add_module(f"pool{s}", ConvModule(in_channels, channels, (1, 1),
                                                   norm="GN" if s == 1 else norm, act="relu"))

    def forward(self, x: torch.Tensor):
        b, h, w, c = x.shape
        outs = []
        for s in self.pool_scales:
            pooled = x[:, :h // s * s, :w // s * s].reshape(b, s, h // s, s, w // s, c).mean(
                dim=(2, 4))
            y = getattr(self, f"pool{s}")(pooled)
            outs.append(resize(y, (h, w), mode="bilinear", align_corners=self.align_corners))
        return outs


class PSPNeck(nn.Module):
    """PPM on the last level; the fused map is appended as an extra level."""

    def __init__(self, in_channels: Sequence[int], channels: int,
                 pool_scales: Sequence[int] = (1, 2, 3, 6), norm: str = "BN",
                 align_corners: bool = False):
        super().__init__()
        self.out_channels = tuple(in_channels) + (channels,)
        self.ppm = PPM(in_channels[-1], channels, pool_scales, norm, align_corners)
        self.bottleneck = ConvModule(in_channels[-1] + len(pool_scales) * channels, channels,
                                     (3, 3), norm=norm, act="relu")

    def forward(self, inputs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        x = inputs[-1]
        fused = self.bottleneck(torch.cat([x] + self.ppm(x), dim=-1))
        return tuple(inputs) + (fused,)


class MultiLevelNeck(nn.Module):
    """A 1x1 lateral per level (one level is shared by every scale), a
    bilinear rescale by ``scales``, a 3x3 conv."""

    def __init__(self, in_channels: Sequence[int], out_channels: int,
                 scales: Sequence[float] = (0.5, 1.0, 2.0, 4.0)):
        super().__init__()
        self.scales = tuple(scales)
        self.out_channels = (out_channels,) * len(self.scales)
        for i, c in enumerate(in_channels):
            self.add_module(f"lateral{i}", ConvModule(c, out_channels, (1, 1)))
        for i in range(len(self.scales)):
            self.add_module(f"conv{i}", ConvModule(out_channels, out_channels, (3, 3)))

    def forward(self, inputs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        laterals = [getattr(self, f"lateral{i}")(x) for i, x in enumerate(inputs)]
        if len(laterals) == 1:
            laterals = laterals * len(self.scales)
        outs = []
        for i, s in enumerate(self.scales):
            x = laterals[i]
            if s != 1.0:
                x = resize(x, (int(x.shape[1] * s), int(x.shape[2] * s)), mode="bilinear")
            outs.append(getattr(self, f"conv{i}")(x))
        return tuple(outs)


class Feature2Pyramid(nn.Module):
    """Rescale single-stride ViT maps into a pyramid: x4 two transposed convs
    (``norm``, BatchNorm by default, and tanh GELU between), x2 one, x1
    identity, x0.5 and x0.25 flax's ``VALID`` max pool. Any other rescale
    raises KeyError; a second x4 rescale (a second flax ``BatchNorm_1``,
    which ``convert.py`` does not map) raises ValueError."""

    def __init__(self, embed_dim: int, rescales: Sequence[float] = (4.0, 2.0, 1.0, 0.5),
                 norm: str = "SyncBN"):
        super().__init__()
        self.rescales = tuple(rescales)
        self.out_channels = (embed_dim,) * len(self.rescales)
        for i, k in enumerate(self.rescales):
            if k == 4:
                self.add_module(f"up4_a{i}", nn.ConvTranspose2d(embed_dim, embed_dim, 2, 2))
                self.norm = make_norm(norm, embed_dim)
                self.add_module(f"up4_b{i}", nn.ConvTranspose2d(embed_dim, embed_dim, 2, 2))
            elif k == 2:
                self.add_module(f"up2_{i}", nn.ConvTranspose2d(embed_dim, embed_dim, 2, 2))
            elif k not in (1, 0.5, 0.25):
                raise KeyError(f"invalid rescale {k}")
        if sum(k == 4 for k in self.rescales) > 1:
            raise ValueError("one x4 rescale at most: its norm is the neck's one norm")

    def forward(self, inputs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        outs = []
        for i, (k, x) in enumerate(zip(self.rescales, inputs)):
            x = x.permute(0, 3, 1, 2)
            if k == 4:
                x = getattr(self, f"up4_a{i}")(x)
                if isinstance(self.norm, nn.LayerNorm):
                    x = self.norm(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
                else:
                    x = self.norm(x)
                x = gelu(x)
                x = getattr(self, f"up4_b{i}")(x)
            elif k == 2:
                x = getattr(self, f"up2_{i}")(x)
            elif k in (0.5, 0.25):
                x = F.max_pool2d(x, int(1 / k), int(1 / k))
            outs.append(x.permute(0, 2, 3, 1))
        return tuple(outs)


class SkipNeck(nn.Module):
    """Per-level bilinear rescale (align_corners), no weights."""

    def __init__(self, scales: Sequence[float] = (0.5, 1.0, 2.0, 4.0)):
        super().__init__()
        self.scales = tuple(scales)

    def forward(self, inputs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        outs = []
        for x, s in zip(inputs, self.scales):
            if s != 1.0:
                x = resize(x, (int(x.shape[1] * s), int(x.shape[2] * s)), mode="bilinear",
                           align_corners=True)
            outs.append(x)
        return tuple(outs)


@device_constant(maxsize=32)
def _sine_pos(h: int, w: int, num_feats: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(sine_pos_embed(h, w, num_feats=num_feats), device=device)


@device_constant(maxsize=32)
def _refs(spatial_shapes: Tuple[Tuple[int, int], ...], device: torch.device) -> torch.Tensor:
    return torch.as_tensor(reference_points(spatial_shapes), device=device)


class HAHINeck(nn.Module):
    """Heterogeneous interaction neck: ``inputs[0]`` is the conv level, the
    rest the transformer levels. HI: deformable self-attention over the
    transformer levels' 1x1 projections, flattened and concatenated, with a
    sine position plus a learned level embedding. HA: the conv level's
    projection cross-attends into that source at reference points from a
    Linear -> sigmoid of its sine position. 3x3 fusion convs bring each
    level back to ``out_channels``."""

    def __init__(self, in_channels: Sequence[int], out_channels: Sequence[int],
                 embedding_dim: int = 256, num_points: int = 8, num_heads: int = 8,
                 norm: str = "BN", self_att: bool = True, cross_att: bool = True):
        super().__init__()
        e = embedding_dim
        self.embedding_dim = e
        self.out_channels = tuple(out_channels)
        n_trans = len(in_channels) - 1
        for i, (c, oc) in enumerate(zip(in_channels, out_channels)):
            self.add_module(f"lateral{i}", ConvModule(c, oc, (1, 1), norm=norm, act="relu"))
        self.level_embed = nn.Parameter(torch.empty(n_trans, e))
        for i in range(n_trans):
            self.add_module(f"trans_proj{i}", ConvModule(out_channels[i + 1], e, (1, 1), norm=norm,
                                                         act="relu"))
        if self_att:
            self.self_attn = DeformableAttention(e, num_heads, n_trans, num_points)
        self.conv_proj = ConvModule(out_channels[0], e, (1, 1), norm=norm, act="relu")
        self.reference_points = nn.Linear(e, 2)
        if cross_att:
            self.cross_attn = DeformableAttention(e, num_heads, n_trans, num_points)
        self.conv_fusion = ConvModule(e + out_channels[0], out_channels[0], (3, 3), norm=norm,
                                      act="relu")
        for i in range(n_trans):
            self.add_module(f"trans_fusion{i}", ConvModule(
                out_channels[i + 1] + e, out_channels[i + 1], (3, 3), norm=norm, act="relu"))

    def flax_init(self, leaf: str, shape, gen: torch.Generator) -> Optional[torch.Tensor]:
        return trunc_normal(shape, gen) if leaf == "level_embed" else None

    def forward(self, inputs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        laterals = [getattr(self, f"lateral{i}")(x) for i, x in enumerate(inputs)]
        feat_conv, feats_trans = laterals[0], laterals[1:]
        b, e, dev = feat_conv.shape[0], self.embedding_dim, feat_conv.device
        shapes = tuple((f.shape[1], f.shape[2]) for f in feats_trans)
        srcs, poss = [], []
        for i, f in enumerate(feats_trans):
            h, w = f.shape[1:3]
            srcs.append(getattr(self, f"trans_proj{i}")(f).reshape(b, h * w, e))
            poss.append(_sine_pos(h, w, e // 2, dev).to(f.dtype) + self.level_embed[i][None])
        src, pos = torch.cat(srcs, dim=1), torch.cat(poss, dim=0)
        if hasattr(self, "self_attn"):
            src = self.self_attn(src, src, pos, _refs(shapes, dev).to(src.dtype), shapes)

        h0, w0 = feat_conv.shape[1:3]
        query = self.conv_proj(feat_conv).reshape(b, h0 * w0, e)
        q_pos = _sine_pos(h0, w0, e // 2, dev).to(query.dtype)
        if hasattr(self, "cross_attn"):
            ref_q = torch.sigmoid(self.reference_points(q_pos))
            ref_q = ref_q[None, :, None, :].expand(b, h0 * w0, len(shapes), 2)
            query = self.cross_attn(query, src, q_pos, ref_q, shapes)
        outs = [self.conv_fusion(torch.cat([query.reshape(b, h0, w0, e), feat_conv], dim=-1))]
        start = 0
        for i, f in enumerate(feats_trans):
            h, w = f.shape[1:3]
            piece = src[:, start:start + h * w].reshape(b, h, w, e)
            start += h * w
            outs.append(getattr(self, f"trans_fusion{i}")(torch.cat([f, piece], dim=-1)))
        return tuple(outs)


class JPU(nn.Module):
    """Joint Pyramid Upsampling: 3x3 ConvModule + BN + ReLU per level from
    ``start_level``, all bilinear to the first's size, concatenated, then
    depthwise-separable convs at ``dilations`` concatenated. Returns the
    levels before ``start_level`` and the fused map."""

    def __init__(self, in_channels: Sequence[int], mid_channels: int = 512,
                 dilations: Sequence[int] = (1, 2, 4, 8), start_level: int = 0):
        super().__init__()
        self.start_level = start_level
        self.dilations = tuple(dilations)
        n = len(in_channels) - start_level
        self.out_channels = tuple(in_channels[:start_level]) + (len(self.dilations) * mid_channels,)
        for i in range(start_level, len(in_channels)):
            self.add_module(f"conv{i}", ConvModule(in_channels[i], mid_channels, (3, 3),
                                                   norm="BN", act="relu"))
        for d in self.dilations:
            self.add_module(f"dil{d}", DepthwiseSeparableConv(n * mid_channels, mid_channels,
                                                              dilation=d))

    def forward(self, inputs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        feats = [getattr(self, f"conv{i}")(inputs[i])
                 for i in range(self.start_level, len(inputs))]
        target = feats[0].shape[1:3]
        feat = torch.cat([feats[0]] + [resize(f, target, mode="bilinear") for f in feats[1:]],
                         dim=-1)
        fused = torch.cat([getattr(self, f"dil{d}")(feat) for d in self.dilations], dim=-1)
        return tuple(inputs[:self.start_level]) + (fused,)
