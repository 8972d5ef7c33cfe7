"""The compat decode-head zoo, part I (port of ``ddp_tpu/nn/compat_heads.py:
39-657``): the inherited mmseg heads the reference ships beside its DDP
heads.

  UPerHead        (uper_head.py)        PSP + FPN fuse
  PSPHead         (psp_head.py)         pyramid pooling
  ASPPHead        (aspp_head.py)        DeepLabV3 atrous pyramid
  DepthwiseSeparableASPPHead (sep_aspp_head.py)  DeepLabV3+ with the c1 skip
  SegformerHead   (segformer_head.py)   all-MLP fuse
  OCRHead         (ocr_head.py)         object-contextual representations
  DAHead          (da_head.py)          position + channel attention
  NLHead          (nl_head.py)          non-local block
  LRASPPHead      (lraspp_head.py)      MobileNetV3's lite R-ASPP
  FPNHead         (fpn_head.py)         Panoptic-FPN scale heads
  SETRUPHead / SETRMLAHead (setr_up_head.py / setr_mla_head.py)
  DPTHead         (dpt_head.py)         ViT reassemble + fusion, seg or depth
  PointHead       (point_head.py)       PointRend refinement, static K

Every head takes a list of NHWC maps whose channels it is built for
(``in_channels``) and returns logits at its working level; the cascade heads
(OCR, Point) also take the previous stage's logits. Convs pad as flax's
``SAME`` does; BatchNorm has flax's training semantics; dropout draws from
the generator the caller passes. The modules carry the flax names, so
``convert.py`` maps JAX weights.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import device_constant
from ..ops.resize import resize
from .common import BatchNorm2d, Conv, Conv2dSame, ConvModule, dropout


@functools.lru_cache(maxsize=64)
def _adaptive_pool_matrix(in_size: int, out_size: int) -> np.ndarray:
    """[out, in] averaging matrix with torch adaptive_avg_pool2d's bin edges
    (bin i spans [floor(i·n/s), ceil((i+1)·n/s)))."""
    m = np.zeros((out_size, in_size), np.float32)
    for i in range(out_size):
        lo = (i * in_size) // out_size
        hi = -((-(i + 1) * in_size) // out_size)  # ceil
        m[i, lo:hi] = 1.0 / (hi - lo)
    return m


@device_constant(maxsize=128)
def _pool_matrix_on(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_adaptive_pool_matrix(in_size, out_size), device=device)


def _adaptive_avg_pool(x: torch.Tensor, scale: int) -> torch.Tensor:
    """NHWC -> (scale, scale) adaptive average pool, torch's bins, for any
    input size (a map smaller than ``scale`` included)."""
    h, w = x.shape[1:3]
    mh = _pool_matrix_on(h, scale, x.device).to(x.dtype)
    mw = _pool_matrix_on(w, scale, x.device).to(x.dtype)
    x = torch.einsum("ph,bhwc->bpwc", mh, x)
    return torch.einsum("qw,bpwc->bpqc", mw, x)


class _PPM(nn.Module):
    """mmseg-style pyramid pooling (psp_head.py:PPM)."""

    def __init__(self, in_channels: int, channels: int,
                 pool_scales: Sequence[int] = (1, 2, 3, 6), norm: str = "BN",
                 align_corners: bool = False):
        super().__init__()
        self.pool_scales = tuple(pool_scales)
        self.align_corners = align_corners
        for scale in self.pool_scales:
            self.add_module(f"pool{scale}", ConvModule(in_channels, channels, (1, 1),
                                                       norm=norm, act="relu"))

    def forward(self, x: torch.Tensor):
        h, w = x.shape[1:3]
        return [resize(getattr(self, f"pool{s}")(_adaptive_avg_pool(x, s)), (h, w),
                       mode="bilinear", align_corners=self.align_corners)
                for s in self.pool_scales]


class SegHeadOut(nn.Module):
    """dropout -> 1x1 conv_seg: every mmseg BaseDecodeHead's classifier."""

    def __init__(self, in_channels: int, num_classes: int, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.conv_seg = Conv(in_channels, num_classes, 1)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.conv_seg(dropout(x, self.dropout, self.training, generator))


class PSPHead(nn.Module):
    """PSPNet head: PPM on the last level, concat, 3x3 bottleneck, classifier."""

    def __init__(self, num_classes: int, in_channels: Sequence[int], channels: int = 512,
                 pool_scales: Sequence[int] = (1, 2, 3, 6), norm: str = "BN",
                 dropout: float = 0.1, align_corners: bool = False):
        super().__init__()
        c = in_channels[-1]
        self.psp = _PPM(c, channels, pool_scales, norm, align_corners)
        self.bottleneck = ConvModule(c + len(pool_scales) * channels, channels, (3, 3),
                                     norm=norm, act="relu")
        self.out = SegHeadOut(channels, num_classes, dropout)

    def forward(self, feats, generator: Optional[torch.Generator] = None):
        x = feats[-1]
        y = self.bottleneck(torch.cat([x] + self.psp(x), dim=-1))
        return self.out(y, generator)


class UPerHead(nn.Module):
    """UPerNet head: PSP on the top level, FPN top-down over 1x1 laterals,
    upsample-concat all levels, fuse."""

    def __init__(self, num_classes: int, in_channels: Sequence[int], channels: int = 512,
                 pool_scales: Sequence[int] = (1, 2, 3, 6), norm: str = "BN",
                 dropout: float = 0.1, align_corners: bool = False):
        super().__init__()
        n = len(in_channels)
        self.n = n
        self.align_corners = align_corners
        self.psp = _PPM(in_channels[-1], channels, pool_scales, norm, align_corners)
        self.psp_bottleneck = ConvModule(in_channels[-1] + len(pool_scales) * channels,
                                         channels, (3, 3), norm=norm, act="relu")
        for i in range(n - 1):
            self.add_module(f"lateral{i}", ConvModule(in_channels[i], channels, (1, 1),
                                                      norm=norm, act="relu"))
            self.add_module(f"fpn_conv{i}", ConvModule(channels, channels, (3, 3),
                                                       norm=norm, act="relu"))
        self.fpn_bottleneck = ConvModule(n * channels, channels, (3, 3), norm=norm, act="relu")
        self.out = SegHeadOut(channels, num_classes, dropout)

    def forward(self, feats, generator: Optional[torch.Generator] = None):
        n, ac = self.n, self.align_corners
        top = self.psp_bottleneck(torch.cat([feats[-1]] + self.psp(feats[-1]), dim=-1))
        laterals = [getattr(self, f"lateral{i}")(feats[i]) for i in range(n - 1)] + [top]
        for i in range(n - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + resize(
                laterals[i], laterals[i - 1].shape[1:3], mode="bilinear", align_corners=ac)
        outs = [getattr(self, f"fpn_conv{i}")(laterals[i]) for i in range(n - 1)]
        outs.append(laterals[-1])
        size = outs[0].shape[1:3]
        outs = [outs[0]] + [resize(o, size, mode="bilinear", align_corners=ac)
                            for o in outs[1:]]
        return self.out(self.fpn_bottleneck(torch.cat(outs, dim=-1)), generator)


class DepthwiseSeparableConv(nn.Module):
    """depthwise kxk (+BN+ReLU) -> pointwise 1x1 (+BN+ReLU): mmcv's
    DepthwiseSeparableConvModule. NHWC in and out. ``norm`` is accepted as
    the JAX package accepts it: both norms are BatchNorm."""

    def __init__(self, in_channels: int, features: int, kernel_size=(3, 3), strides=(1, 1),
                 dilation: int = 1, norm: Optional[str] = "BN"):
        super().__init__()
        self.depthwise = Conv2dSame(in_channels, in_channels, kernel_size, strides, dilation,
                                    groups=in_channels)
        self.dw_bn = BatchNorm2d(in_channels, eps=1e-5)
        self.pointwise = Conv2dSame(in_channels, features, 1)
        self.pw_bn = BatchNorm2d(features, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.dw_bn(self.depthwise(x.permute(0, 3, 1, 2))))
        return F.relu(self.pw_bn(self.pointwise(x))).permute(0, 2, 3, 1)


class _ASPP(nn.Module):
    """Atrous pyramid: the global image pool, then a 1x1 or a dilated 3x3
    (separable or plain conv + BN) per dilation (aspp_head.py:ASPPModule)."""

    def __init__(self, in_channels: int, channels: int,
                 dilations: Sequence[int] = (1, 12, 24, 36), norm: str = "BN",
                 separable: bool = False, align_corners: bool = False):
        super().__init__()
        self.dilations = tuple(dilations)
        self.separable = separable
        self.align_corners = align_corners
        self.image_pool = ConvModule(in_channels, channels, (1, 1), norm=norm, act="relu")
        for i, d in enumerate(self.dilations):
            if d == 1:
                self.add_module(f"aspp{i}", ConvModule(in_channels, channels, (1, 1),
                                                       norm=norm, act="relu"))
            elif separable:
                self.add_module(f"aspp{i}", DepthwiseSeparableConv(
                    in_channels, channels, (3, 3), dilation=d, norm=norm))
            else:
                self.add_module(f"aspp{i}_conv", Conv2dSame(in_channels, channels, 3,
                                                            dilation=d))
                self.add_module(f"aspp{i}_bn", BatchNorm2d(channels, eps=1e-5))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1:3]
        pooled = self.image_pool(x.mean(dim=(1, 2), keepdim=True))
        outs = [resize(pooled, (h, w), mode="bilinear", align_corners=self.align_corners)]
        for i, d in enumerate(self.dilations):
            if d == 1 or self.separable:
                outs.append(getattr(self, f"aspp{i}")(x))
            else:
                y = getattr(self, f"aspp{i}_conv")(x.permute(0, 3, 1, 2))
                outs.append(F.relu(getattr(self, f"aspp{i}_bn")(y)).permute(0, 2, 3, 1))
        return torch.cat(outs, dim=-1)


class ASPPHead(nn.Module):
    """DeepLabV3 head."""

    def __init__(self, num_classes: int, in_channels: Sequence[int], channels: int = 512,
                 dilations: Sequence[int] = (1, 12, 24, 36), norm: str = "BN",
                 dropout: float = 0.1, align_corners: bool = False):
        super().__init__()
        self.aspp = _ASPP(in_channels[-1], channels, dilations, norm,
                          align_corners=align_corners)
        self.bottleneck = ConvModule((1 + len(dilations)) * channels, channels, (3, 3),
                                     norm=norm, act="relu")
        self.out = SegHeadOut(channels, num_classes, dropout)

    def forward(self, feats, generator: Optional[torch.Generator] = None):
        return self.out(self.bottleneck(self.aspp(feats[-1])), generator)


class DepthwiseSeparableASPPHead(nn.Module):
    """DeepLabV3+ head: separable ASPP on the top level, the ``c1_channels``
    skip from the first level, two separable 3x3 fuse convs."""

    def __init__(self, num_classes: int, in_channels: Sequence[int], channels: int = 512,
                 c1_channels: int = 48, dilations: Sequence[int] = (1, 12, 24, 36),
                 norm: str = "BN", dropout: float = 0.1, align_corners: bool = False):
        super().__init__()
        self.align_corners = align_corners
        self.aspp = _ASPP(in_channels[-1], channels, dilations, norm, separable=True,
                          align_corners=align_corners)
        self.bottleneck = ConvModule((1 + len(dilations)) * channels, channels, (3, 3),
                                     norm=norm, act="relu")
        self.c1_bottleneck = ConvModule(in_channels[0], c1_channels, (1, 1), norm=norm,
                                        act="relu")
        self.sep1 = DepthwiseSeparableConv(channels + c1_channels, channels, norm=norm)
        self.sep2 = DepthwiseSeparableConv(channels, channels, norm=norm)
        self.out = SegHeadOut(channels, num_classes, dropout)

    def forward(self, feats, generator: Optional[torch.Generator] = None):
        y = self.bottleneck(self.aspp(feats[-1]))
        c1 = self.c1_bottleneck(feats[0])
        y = resize(y, c1.shape[1:3], mode="bilinear", align_corners=self.align_corners)
        y = self.sep2(self.sep1(torch.cat([y, c1], dim=-1)))
        return self.out(y, generator)


class SegformerHead(nn.Module):
    """SegFormer all-MLP head: per-level 1x1, upsample to the first level,
    concat, 1x1 fuse."""

    def __init__(self, num_classes: int, in_channels: Sequence[int], channels: int = 256,
                 norm: str = "BN", dropout: float = 0.1, align_corners: bool = False):
        super().__init__()
        self.n = len(in_channels)
        self.align_corners = align_corners
        for i, c in enumerate(in_channels):
            self.add_module(f"proj{i}", Conv(c, channels, 1))
        self.fuse = ConvModule(self.n * channels, channels, (1, 1), norm=norm, act="relu")
        self.out = SegHeadOut(channels, num_classes, dropout)

    def forward(self, feats, generator: Optional[torch.Generator] = None):
        size = feats[0].shape[1:3]
        outs = [resize(getattr(self, f"proj{i}")(f), size, mode="bilinear",
                       align_corners=self.align_corners) for i, f in enumerate(feats)]
        return self.out(self.fuse(torch.cat(outs, dim=-1)), generator)


class OCRHead(nn.Module):
    """Object-contextual representations (cascade head): soft object regions
    from the previous logits gather per-class context, pixel-to-object
    attention redistributes it."""

    def __init__(self, num_classes: int, in_channels: Sequence[int], channels: int = 512,
                 ocr_channels: int = 256, norm: str = "BN", dropout: float = 0.1):
        super().__init__()
        self.ocr_channels = ocr_channels
        self.bottleneck = ConvModule(in_channels[-1], channels, (3, 3), norm=norm, act="relu")
        self.query = nn.Linear(channels, ocr_channels, bias=False)
        self.key = nn.Linear(channels, ocr_channels, bias=False)
        self.value = nn.Linear(channels, ocr_channels, bias=False)
        self.up_proj = nn.Linear(ocr_channels, channels, bias=False)
        self.fuse = ConvModule(2 * channels, channels, (1, 1), norm=norm, act="relu")
        self.out = SegHeadOut(channels, num_classes, dropout)

    def forward(self, feats, prev_logits: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        x = self.bottleneck(feats[-1])
        b, h, w, c = x.shape
        k = prev_logits.shape[-1]
        probs = torch.softmax(prev_logits.reshape(b, -1, k), dim=1)
        flat = x.reshape(b, -1, c)
        ctx = torch.einsum("bsk,bsc->bkc", probs, flat)
        q, key, val = self.query(flat), self.key(ctx), self.value(ctx)
        attn = torch.softmax(torch.einsum("bsd,bkd->bsk", q, key) / self.ocr_channels ** 0.5,
                             dim=-1)
        y = self.up_proj(torch.einsum("bsk,bkd->bsd", attn, val)).reshape(b, h, w, c)
        return self.out(self.fuse(torch.cat([y, x], dim=-1)), generator)


class DAHead(nn.Module):
    """Dual attention (DANet: position + channel attention); ``return_aux``
    adds the branches' own classifiers, as the reference supervises them."""

    def __init__(self, num_classes: int, in_channels: Sequence[int], channels: int = 512,
                 norm: str = "BN", dropout: float = 0.1, return_aux: bool = False):
        super().__init__()
        ch = channels
        self.return_aux = return_aux
        self.pam_in = ConvModule(in_channels[-1], ch, (3, 3), norm=norm, act="relu")
        self.pam_q = Conv(ch, ch // 8, 1)
        self.pam_k = Conv(ch, ch // 8, 1)
        self.pam_v = Conv(ch, ch, 1)
        self.pam_gamma = nn.Parameter(torch.zeros(()))
        self.pam_out = ConvModule(ch, ch, (3, 3), norm=norm, act="relu")
        self.cam_in = ConvModule(in_channels[-1], ch, (3, 3), norm=norm, act="relu")
        self.cam_gamma = nn.Parameter(torch.zeros(()))
        self.cam_out = ConvModule(ch, ch, (3, 3), norm=norm, act="relu")
        self.out = SegHeadOut(ch, num_classes, dropout)
        if return_aux:
            self.pam_cls = SegHeadOut(ch, num_classes, dropout)
            self.cam_cls = SegHeadOut(ch, num_classes, dropout)

    def forward(self, feats, generator: Optional[torch.Generator] = None):
        x = feats[-1]
        b, h, w, _ = x.shape
        pam_in = self.pam_in(x)
        ch = pam_in.shape[-1]
        q = self.pam_q(pam_in).reshape(b, h * w, -1)
        k = self.pam_k(pam_in).reshape(b, h * w, -1)
        v = self.pam_v(pam_in).reshape(b, h * w, ch)
        attn = torch.softmax(torch.einsum("bqd,bkd->bqk", q, k), dim=-1)
        pam = torch.einsum("bqk,bkc->bqc", attn, v).reshape(b, h, w, ch)
        pam = self.pam_out(pam_in + self.pam_gamma * pam)

        cam_in = self.cam_in(x)
        f = cam_in.reshape(b, h * w, ch)
        energy = torch.einsum("bsc,bsd->bcd", f, f)
        energy = energy.amax(dim=-1, keepdim=True) - energy
        cam = torch.einsum("bcd,bsd->bsc", torch.softmax(energy, dim=-1), f)
        cam = self.cam_out(cam_in + self.cam_gamma * cam.reshape(b, h, w, ch))

        out = self.out(pam + cam, generator)
        if self.return_aux:
            return out, self.pam_cls(pam, generator), self.cam_cls(cam, generator)
        return out


class NLHead(nn.Module):
    """Non-local head: embedded-gaussian NonLocal2d on the bottlenecked top
    level (``conv_out`` starts at 0), concat-fused with the input."""

    def __init__(self, num_classes: int, in_channels: Sequence[int], channels: int = 512,
                 reduction: int = 2, norm: str = "BN", dropout: float = 0.1):
        super().__init__()
        d = max(channels // reduction, 1)
        self.bottleneck = ConvModule(in_channels[-1], channels, (3, 3), norm=norm, act="relu")
        self.theta = Conv(channels, d, 1)
        self.phi = Conv(channels, d, 1)
        self.g = Conv(channels, d, 1)
        self.conv_out = Conv(d, channels, 1)
        self.conv_out.zero_init = True
        self.fuse = ConvModule(in_channels[-1] + channels, channels, (3, 3), norm=norm,
                               act="relu")
        self.out = SegHeadOut(channels, num_classes, dropout)

    def forward(self, feats, generator: Optional[torch.Generator] = None):
        x = self.bottleneck(feats[-1])
        b, h, w, _ = x.shape
        theta = self.theta(x).reshape(b, h * w, -1)
        phi = self.phi(x).reshape(b, h * w, -1)
        g = self.g(x).reshape(b, h * w, -1)
        attn = torch.softmax(torch.einsum("bqd,bkd->bqk", theta, phi), dim=-1)
        y = torch.einsum("bqk,bkd->bqd", attn, g).reshape(b, h, w, -1)
        y = x + self.conv_out(y)
        return self.out(self.fuse(torch.cat([feats[-1], y], dim=-1)), generator)


class LRASPPHead(nn.Module):
    """Lite R-ASPP (MobileNetV3's head): a sigmoid gate from the global mean
    of the deepest level over its 1x1 branch, then 1x1 skips from the
    shallower levels. The global mean stands in for the reference's 49x49/16
    average pool (the JAX package's choice)."""

    def __init__(self, num_classes: int, in_channels: Sequence[int], channels: int = 128,
                 norm: str = "BN"):
        super().__init__()
        self.n = len(in_channels)
        self.aspp_conv = ConvModule(in_channels[-1], channels, (1, 1), norm=norm, act="relu")
        self.image_pool = Conv(in_channels[-1], channels, 1)
        for i in range(self.n - 2, -1, -1):
            self.add_module(f"skip{i}", Conv(in_channels[i], channels, 1))
            self.add_module(f"fuse{i}", ConvModule(channels, channels, (1, 1), norm=norm,
                                                   act="relu"))
        self.conv_seg = Conv(channels, num_classes, 1)

    def forward(self, feats, generator: Optional[torch.Generator] = None):
        x = feats[-1]
        y = self.aspp_conv(x) * torch.sigmoid(self.image_pool(x.mean(dim=(1, 2), keepdim=True)))
        for i in range(self.n - 2, -1, -1):
            y = resize(y, feats[i].shape[1:3], mode="bilinear")
            y = getattr(self, f"fuse{i}")(y + getattr(self, f"skip{i}")(feats[i]))
        return self.conv_seg(y)


class FPNHead(nn.Module):
    """Panoptic-FPN style head: per-level scale heads (3x3 conv, then x2 up,
    repeated), summed at the first level's scale."""

    def __init__(self, num_classes: int, in_channels: Sequence[int], channels: int = 128,
                 feature_strides: Sequence[int] = (4, 8, 16, 32), norm: str = "BN",
                 dropout: float = 0.1):
        super().__init__()
        self.feature_strides = tuple(feature_strides)
        self.reps = []
        for i, (c, s) in enumerate(zip(in_channels, feature_strides)):
            reps = max(1, (s // feature_strides[0]).bit_length() - 1)
            self.reps.append(reps)
            for r in range(reps):
                self.add_module(f"scale{i}_conv{r}", ConvModule(
                    c if r == 0 else channels, channels, (3, 3), norm=norm, act="relu"))
        self.out = SegHeadOut(channels, num_classes, dropout)

    def forward(self, feats, generator: Optional[torch.Generator] = None):
        size = tuple(feats[0].shape[1:3])
        out = None
        for i, (f, s) in enumerate(zip(feats, self.feature_strides)):
            y = f
            for r in range(self.reps[i]):
                y = getattr(self, f"scale{i}_conv{r}")(y)
                if s > self.feature_strides[0]:
                    y = resize(y, (y.shape[1] * 2, y.shape[2] * 2), mode="bilinear")
            if tuple(y.shape[1:3]) != size:
                y = resize(y, size, mode="bilinear")
            out = y if out is None else out + y
        return self.out(out, generator)


class SETRUPHead(nn.Module):
    """SETR naive/progressive upsampling head: LayerNorm on the last map,
    then (3x3 conv -> bilinear x``up_scale``) x ``num_convs``."""

    def __init__(self, num_classes: int, in_channels: Sequence[int], channels: int = 256,
                 num_convs: int = 1, up_scale: int = 4, norm: str = "BN",
                 dropout: float = 0.1):
        super().__init__()
        self.num_convs, self.up_scale = num_convs, up_scale
        self.ln = nn.LayerNorm(in_channels[-1], eps=1e-6)
        for i in range(num_convs):
            self.add_module(f"up_conv{i}", ConvModule(in_channels[-1] if i == 0 else channels,
                                                      channels, (3, 3), norm=norm, act="relu"))
        self.out = SegHeadOut(channels, num_classes, dropout)

    def forward(self, feats, generator: Optional[torch.Generator] = None):
        x = self.ln(feats[-1])
        for i in range(self.num_convs):
            x = getattr(self, f"up_conv{i}")(x)
            x = resize(x, (x.shape[1] * self.up_scale, x.shape[2] * self.up_scale),
                       mode="bilinear")
        return self.out(x, generator)


class SETRMLAHead(nn.Module):
    """SETR multi-level aggregation head: per-level conv-conv-x``up_scale``,
    concat, classifier (the levels must share one grid, as ViT's taps do)."""

    def __init__(self, num_classes: int, in_channels: Sequence[int], channels: int = 128,
                 up_scale: int = 4, norm: str = "BN", dropout: float = 0.1):
        super().__init__()
        self.n, self.up_scale = len(in_channels), up_scale
        for i, c in enumerate(in_channels):
            self.add_module(f"mla{i}_conv1", ConvModule(c, channels, (3, 3), norm=norm,
                                                        act="relu"))
            self.add_module(f"mla{i}_conv2", ConvModule(channels, channels, (3, 3), norm=norm,
                                                        act="relu"))
        self.out = SegHeadOut(self.n * channels, num_classes, dropout)

    def forward(self, feats, generator: Optional[torch.Generator] = None):
        outs = []
        for i, f in enumerate(feats):
            y = getattr(self, f"mla{i}_conv2")(getattr(self, f"mla{i}_conv1")(f))
            outs.append(resize(y, (y.shape[1] * self.up_scale, y.shape[2] * self.up_scale),
                               mode="bilinear"))
        return self.out(torch.cat(outs, dim=-1), generator)


class _ResidualConvUnit(nn.Module):
    """DPT residual conv unit: relu -> conv -> relu -> conv, plus the input."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = Conv(features, features, 3)
        self.conv2 = Conv(features, features, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class DPTHead(nn.Module):
    """DPT head (Ranftl et al.; the reference's dpt_head.py): each of the 4
    maps projected and resampled x(4, 2, 1, 0.5) to a pyramid, top-down
    fusion through residual conv units, then a seg classifier (``mode="seg"``)
    or a depth regressor (relu + ``min_depth``). ``out_channels``: the
    classes, or 1 for depth."""

    SCALES = (4.0, 2.0, 1.0, 0.5)

    def __init__(self, out_channels: int, in_channels: Sequence[int], channels: int = 256,
                 post_channels: Sequence[int] = (96, 192, 384, 768), mode: str = "depth",
                 min_depth: float = 1e-3, dropout: float = 0.0):
        super().__init__()
        if len(in_channels) != len(post_channels):
            raise ValueError(f"DPTHead takes {len(post_channels)} maps, got {len(in_channels)}")
        self.n = len(post_channels)
        self.mode, self.min_depth = mode, min_depth
        for i, (c, pc) in enumerate(zip(in_channels, post_channels)):
            self.add_module(f"reassemble{i}", Conv(c, pc, 1))
            self.add_module(f"project{i}", Conv(pc, channels, 3, bias=False))
        self.rcu_top = _ResidualConvUnit(channels)
        for i in range(self.n - 2, -1, -1):
            self.add_module(f"rcu_skip{i}", _ResidualConvUnit(channels))
            self.add_module(f"rcu_fuse{i}", _ResidualConvUnit(channels))
        self.head_conv1 = Conv(channels, channels // 2, 3)
        self.head_conv2 = Conv(channels // 2, 32, 3)
        self.head_out = Conv(32, out_channels, 1)

    def forward(self, feats, generator: Optional[torch.Generator] = None):
        if len(feats) != self.n:
            raise ValueError(f"DPTHead takes {self.n} maps, got {len(feats)}")
        pyr = []
        for i, f in enumerate(feats):
            y = getattr(self, f"reassemble{i}")(f)
            h, w = y.shape[1:3]
            nh, nw = max(int(h * self.SCALES[i]), 1), max(int(w * self.SCALES[i]), 1)
            if (nh, nw) != (h, w):
                y = resize(y, (nh, nw), mode="bilinear", align_corners=True)
            pyr.append(getattr(self, f"project{i}")(y))
        x = self.rcu_top(pyr[-1])
        for i in range(self.n - 2, -1, -1):
            x = resize(x, pyr[i].shape[1:3], mode="bilinear", align_corners=True)
            x = getattr(self, f"rcu_fuse{i}")(x + getattr(self, f"rcu_skip{i}")(pyr[i]))
        x = self.head_conv1(x)
        x = resize(x, (x.shape[1] * 2, x.shape[2] * 2), mode="bilinear", align_corners=True)
        out = self.head_out(F.relu(self.head_conv2(x)))
        if self.mode == "depth":
            return F.relu(out) + self.min_depth
        return out


def point_uncertainty(logits: torch.Tensor) -> torch.Tensor:
    """PointRend uncertainty: −(top1 − top2) of the class logits."""
    top2 = torch.topk(logits, 2, dim=-1).values
    return top2[..., 1] - top2[..., 0]


class PointHead(nn.Module):
    """PointRend refinement (cascade head), static K: the previous logits
    upsampled to the first level's grid, the K most uncertain pixels refined
    by a shared MLP over [fine feature ; coarse logits] and written back.
    Which of equally uncertain pixels ``topk`` picks is the implementation's
    own (torch's and XLA's may differ)."""

    def __init__(self, num_classes: int, in_channels: Sequence[int], fc_channels: int = 256,
                 num_fcs: int = 3, point_fraction: float = 1.0 / 16.0):
        super().__init__()
        self.num_classes, self.num_fcs = num_classes, num_fcs
        self.point_fraction = point_fraction
        for i in range(num_fcs):
            self.add_module(f"fc{i}", nn.Linear(
                (in_channels[0] if i == 0 else fc_channels) + num_classes, fc_channels))
        self.fc_seg = nn.Linear(fc_channels, num_classes)

    def forward(self, feats, prev_logits: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        fine = feats[0]
        b, h, w, c = fine.shape
        coarse = resize(prev_logits, (h, w), mode="bilinear")
        k = max(1, int(h * w * self.point_fraction))
        _, idx = torch.topk(point_uncertainty(coarse).reshape(b, h * w), k, dim=-1)
        coarse_flat = coarse.reshape(b, h * w, self.num_classes)

        def take(t):
            return torch.gather(t, 1, idx[..., None].expand(-1, -1, t.shape[-1]))

        x, cpts = take(fine.reshape(b, h * w, c)), take(coarse_flat)
        for i in range(self.num_fcs):
            x = F.relu(getattr(self, f"fc{i}")(torch.cat([x, cpts], dim=-1)))
        refined = self.fc_seg(x)
        out = coarse_flat.scatter(1, idx[..., None].expand(-1, -1, self.num_classes),
                                  refined)
        return out.reshape(b, h, w, self.num_classes)
