"""Compat backbones II: the real-time segmentation family (port of
``ddp_tpu/nn/lightweight.py:21-407``).

mmseg's stdc, bisenetv1, bisenetv2, fast_scnn, cgnet, erfnet and icnet
(neck) as the JAX package re-designs them: STDCNet, BiSeNetV1 (its STDC
context net built in), BiSeNetV2, FastSCNN, CGNet and ERFNet each take NHWC
images and return a tuple of NHWC maps, whose channels they name in
``out_channels``; ICNeck fuses three such maps. Inside they run contiguous
NCHW, as ``resnet.py`` does. Convs pad as flax's ``SAME`` does (a strided
conv's extra row after; rectangular kernels and one-axis dilations per
axis), flax's ``SAME`` average pool divides by the whole window and its max
pool pads with −inf (``avg_pool_same``, ``max_pool_same``); BatchNorm has
flax's training semantics, with ERFNet's eps 1e-3. The modules carry the
flax names (``_cbr``'s ``{name}_conv`` and ``{name}_bn``), so
``convert.py`` maps JAX weights.

One flax computation the port keeps in training although nothing reads it:
BiSeNetV2's ``bga_s2`` conv and BN (JAX computes them and drops the
result), whose BatchNorm statistics move. It runs under ``torch.no_grad``:
the loss does not reach its parameters (JAX gives them a gradient of 0).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .common import BatchNorm2d, Conv2dSame, avg_pool_same, max_pool_same
from .mobile_hrnet import _InvertedResidual, _resize_nchw


def _gap(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=(2, 3), keepdim=True)


def _add_cbr(owner: nn.Module, name: str, cin: int, w: int, k: int, s: int = 1,
             groups: int = 1, dilation: int = 1, eps: float = 1e-5) -> None:
    """Register ``{name}_conv`` (bias-free, flax SAME) and ``{name}_bn``."""
    owner.add_module(f"{name}_conv", Conv2dSame(cin, w, k, s, dilation, groups))
    owner.add_module(f"{name}_bn", BatchNorm2d(w, eps=eps))


def _cbr(owner: nn.Module, name: str, x: torch.Tensor, act: Optional[str] = "relu"
         ) -> torch.Tensor:
    """conv -> BN -> (ReLU) through ``owner``'s ``{name}_conv``/``{name}_bn``
    (NCHW)."""
    x = getattr(owner, f"{name}_bn")(getattr(owner, f"{name}_conv")(x))
    return F.relu(x) if act == "relu" else x


class STDCModule(nn.Module):
    """Short-term dense concatenate block: a channel-halving conv chain whose
    taps are concatenated; the stride-2 block average-pools its first tap."""

    def __init__(self, in_channels: int, features: int, stride: int = 1, num_convs: int = 4):
        super().__init__()
        self.stride, self.num_convs = stride, num_convs
        _add_cbr(self, "c0", in_channels, features // 2, 1)
        cin = features // 2
        for i in range(1, num_convs):
            w = features // (2 ** i) if i == num_convs - 1 else features // (2 ** (i + 1))
            _add_cbr(self, f"c{i}", cin, w, 3, stride if i == 1 else 1)
            cin = w

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW."""
        outs = []
        y = _cbr(self, "c0", x)
        for i in range(1, self.num_convs):
            outs.append(avg_pool_same(y, 3, 2) if i == 1 and self.stride == 2 else y)
            y = _cbr(self, f"c{i}", y)
        outs.append(y)
        return torch.cat(outs, dim=1)


class STDCNet(nn.Module):
    """STDC1/2: two stem convs, then STDC stages at strides 8, 16, 32
    (``blocks`` (2, 2, 2): STDC1; (4, 5, 3): STDC2)."""

    def __init__(self, base: int = 64, blocks: Sequence[int] = (2, 2, 2),
                 out_indices: Sequence[int] = (0, 1, 2), in_channels: int = 3):
        super().__init__()
        self.blocks, self.out_indices = tuple(blocks), tuple(out_indices)
        _add_cbr(self, "stem0", in_channels, base // 2, 3, 2)
        _add_cbr(self, "stem1", base // 2, base, 3, 2)
        cin, widths = base, []
        for s, n in enumerate(self.blocks):
            w = min(base * (2 ** (s + 2)), base * 16)
            for i in range(n):
                self.add_module(f"stage{s}_m{i}", STDCModule(cin, w, stride=2 if i == 0 else 1))
                cin = w
            widths.append(w)
        self.out_channels = tuple(w for s, w in enumerate(widths) if s in self.out_indices)

    def forward_nchw(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = _cbr(self, "stem1", _cbr(self, "stem0", x))
        outs = []
        for s, n in enumerate(self.blocks):
            for i in range(n):
                x = getattr(self, f"stage{s}_m{i}")(x)
            if s in self.out_indices:
                outs.append(x)
        return tuple(outs)

    def forward(self, x: torch.Tensor, generator=None) -> Tuple[torch.Tensor, ...]:
        outs = self.forward_nchw(x.permute(0, 3, 1, 2).contiguous())
        return tuple(o.permute(0, 2, 3, 1) for o in outs)


class _ARM(nn.Module):
    """BiSeNetV1's attention-refinement module."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        _add_cbr(self, "conv", in_channels, features, 3)
        _add_cbr(self, "att", features, features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _cbr(self, "conv", x)
        return x * torch.sigmoid(_cbr(self, "att", _gap(x), act=None))


class _FFM(nn.Module):
    """BiSeNetV1's feature-fusion module: concat -> 1x1 -> an SE-style gate."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        _add_cbr(self, "fuse", in_channels, features, 1)
        self.att1 = Conv2dSame(features, features, 1, bias=True)
        self.att2 = Conv2dSame(features, features, 1, bias=True)

    def forward(self, sp: torch.Tensor, cx: torch.Tensor) -> torch.Tensor:
        x = _cbr(self, "fuse", torch.cat([sp, cx], dim=1))
        a = torch.sigmoid(self.att2(F.relu(self.att1(_gap(x)))))
        return x + x * a


class BiSeNetV1(nn.Module):
    """BiSeNetV1: a spatial path (three stride-2 convs) and a context path
    over the built-in STDC net's 1/16 and 1/32 maps (ARMs, global context,
    nearest upsampling), fused by the FFM. Returns (fused, a16, a32)."""

    def __init__(self, channels: int = 128, spatial_channels: Sequence[int] = (64, 64, 64, 128),
                 in_channels: int = 3):
        super().__init__()
        cin = in_channels
        for i, w in enumerate(spatial_channels[:3]):
            _add_cbr(self, f"sp{i}", cin, w, 7 if i == 0 else 3, 2)
            cin = w
        _add_cbr(self, "sp3", cin, spatial_channels[3], 1)
        self.context = STDCNet(base=64, in_channels=in_channels)
        _, c16, c32 = self.context.out_channels
        _add_cbr(self, "gap", c32, channels, 1)
        self.arm32 = _ARM(c32, channels)
        _add_cbr(self, "refine32", channels, channels, 3)
        self.arm16 = _ARM(c16, channels)
        _add_cbr(self, "refine16", channels, channels, 3)
        self.ffm = _FFM(spatial_channels[3] + channels, 2 * channels)
        self.out_channels = (2 * channels, channels, channels)

    def forward(self, x: torch.Tensor, generator=None) -> Tuple[torch.Tensor, ...]:
        x = x.permute(0, 3, 1, 2).contiguous()
        sp = x
        for i in range(3):
            sp = _cbr(self, f"sp{i}", sp)
        sp = _cbr(self, "sp3", sp)
        _, c16, c32 = self.context.forward_nchw(x)
        gap = _cbr(self, "gap", _gap(c32))
        a32 = _resize_nchw(self.arm32(c32) + gap, c16.shape[2:], "nearest")
        a32 = _cbr(self, "refine32", a32)
        a16 = _resize_nchw(self.arm16(c16) + a32, sp.shape[2:], "nearest")
        a16 = _cbr(self, "refine16", a16)
        fused = self.ffm(sp, a16)
        return tuple(o.permute(0, 2, 3, 1) for o in (fused, a16, a32))


class _GatherExpansion(nn.Module):
    """BiSeNetV2's gather-and-expansion block: 3x3, a depthwise conv with a
    channel multiplier of ``expand`` (stride 2: a second depthwise conv and
    a depthwise + pointwise shortcut), 1x1; residual where shapes agree."""

    def __init__(self, in_channels: int, features: int, stride: int = 1, expand: int = 6):
        super().__init__()
        inp, e = in_channels, in_channels * expand
        self.stride = stride
        _add_cbr(self, "conv1", inp, inp, 3)
        _add_cbr(self, "dw1", inp, e, 3, stride, groups=inp)
        if stride == 2:
            _add_cbr(self, "dw2", e, e, 3, groups=e)
            _add_cbr(self, "short_dw", inp, inp, 3, 2, groups=inp)
            _add_cbr(self, "short_pw", inp, features, 1)
        _add_cbr(self, "pw", e, features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _cbr(self, "dw1", _cbr(self, "conv1", x), act=None)
        if self.stride == 2:
            y = _cbr(self, "dw2", y, act=None)
            x = _cbr(self, "short_pw", _cbr(self, "short_dw", x, act=None), act=None)
        y = _cbr(self, "pw", y, act=None)
        if x.shape == y.shape:
            y = x + y
        return F.relu(y)


class BiSeNetV2(nn.Module):
    """BiSeNetV2: a detail branch (three conv stages, 1/8), a semantic branch
    (stem, gather-expansion blocks, context embedding) and the bilateral
    guided aggregation. Returns (aggregated, the semantic taps...)."""

    def __init__(self, detail_channels: Sequence[int] = (64, 64, 128),
                 semantic_channels: Sequence[int] = (16, 32, 64, 128), in_channels: int = 3):
        super().__init__()
        self.detail_channels = tuple(detail_channels)
        self.semantic_channels = tuple(semantic_channels)
        cin = in_channels
        for i, w in enumerate(self.detail_channels):
            _add_cbr(self, f"detail{i}_down", cin, w, 3, 2)
            _add_cbr(self, f"detail{i}_conv", w, w, 3)
            cin = w
        s0 = self.semantic_channels[0]
        _add_cbr(self, "stem", in_channels, s0, 3, 2)
        _add_cbr(self, "stem_l1", s0, s0 // 2, 1)
        _add_cbr(self, "stem_l2", s0 // 2, s0, 3, 2)
        _add_cbr(self, "stem_fuse", 2 * s0, s0, 3)
        cin = s0
        for i, w in enumerate(self.semantic_channels[1:], start=1):
            self.add_module(f"ge{i}_down", _GatherExpansion(cin, w, stride=2))
            self.add_module(f"ge{i}_conv", _GatherExpansion(w, w, stride=1))
            cin = w
        self.ce_bn = BatchNorm2d(cin, eps=1e-5)
        _add_cbr(self, "ce_conv", cin, cin, 1)
        _add_cbr(self, "ce_fuse", cin, cin, 3)
        dc = self.detail_channels[-1]
        _add_cbr(self, "bga_d_dw", dc, dc, 3, groups=dc)
        self.bga_d_pw = Conv2dSame(dc, dc, 1, bias=True)
        for name in ("bga_s", "bga_s2", "bga_s3"):
            _add_cbr(self, name, cin, dc, 3)
        _add_cbr(self, "bga_d2", dc, dc, 3, 2)
        _add_cbr(self, "bga_out", dc, dc, 3)
        self.out_channels = (dc,) + self.semantic_channels

    def forward(self, x: torch.Tensor, generator=None) -> Tuple[torch.Tensor, ...]:
        x = x.permute(0, 3, 1, 2).contiguous()
        d = x
        for i in range(len(self.detail_channels)):
            d = _cbr(self, f"detail{i}_conv", _cbr(self, f"detail{i}_down", d))
        s = _cbr(self, "stem", x)
        left = _cbr(self, "stem_l2", _cbr(self, "stem_l1", s))
        right = max_pool_same(s, 3, 2)
        s = _cbr(self, "stem_fuse", torch.cat([left, right], dim=1))
        taps = [s]
        for i in range(1, len(self.semantic_channels)):
            s = getattr(self, f"ge{i}_conv")(getattr(self, f"ge{i}_down")(s))
            taps.append(s)
        gap = _cbr(self, "ce_conv", self.ce_bn(_gap(s)))
        s = _cbr(self, "ce_fuse", s + gap)
        size = d.shape[2:]
        dg = self.bga_d_pw(_cbr(self, "bga_d_dw", d, act=None))
        out = dg * torch.sigmoid(_resize_nchw(_cbr(self, "bga_s", s, act=None), size))
        d_dn = avg_pool_same(_cbr(self, "bga_d2", d, act=None), 3, 2)
        out2 = _resize_nchw(d_dn * torch.sigmoid(_cbr(self, "bga_s3", s, act=None)), size)
        agg = _cbr(self, "bga_out", out + out2)
        if self.training:  # JAX's unused branch: only its BatchNorm statistics move
            with torch.no_grad():
                _cbr(self, "bga_s2", s, act=None)
        return tuple(o.permute(0, 2, 3, 1) for o in [agg] + taps)


class FastSCNN(nn.Module):
    """Fast-SCNN: learning to downsample (depthwise-separable convs, 1/8),
    the global feature extractor (inverted residuals, 1/32, a global-pool
    context added back) and the feature fusion at 1/8. Returns (fused,
    higher, lower), JAX's order."""

    def __init__(self, channels: Sequence[int] = (32, 48, 64),
                 global_channels: Sequence[int] = (64, 96, 128), in_channels: int = 3):
        super().__init__()
        c0, c1, c2 = channels
        self.global_channels = tuple(global_channels)
        _add_cbr(self, "ld0", in_channels, c0, 3, 2)
        _add_cbr(self, "ld1_dw", c0, c0, 3, 2, groups=c0)
        _add_cbr(self, "ld1_pw", c0, c1, 1)
        _add_cbr(self, "ld2_dw", c1, c1, 3, 2, groups=c1)
        _add_cbr(self, "ld2_pw", c1, c2, 1)
        cin = c2
        for i, w in enumerate(self.global_channels):
            for b in range(3):
                self.add_module(f"gfe{i}_{b}", _InvertedResidual(
                    cin, w, cin * 6, stride=2 if (b == 0 and i < 2) else 1))
                cin = w
        _add_cbr(self, "ppm", cin, self.global_channels[-1], 3)
        cl = self.global_channels[-1]
        _add_cbr(self, "ffm_dw", cl, cl, 3, groups=cl)
        _add_cbr(self, "ffm_up", cl, 2 * c2, 1)
        _add_cbr(self, "ffm_hi", c2, 2 * c2, 1)
        self.out_channels = (2 * c2, c2, cl)

    def forward(self, x: torch.Tensor, generator=None) -> Tuple[torch.Tensor, ...]:
        x = _cbr(self, "ld0", x.permute(0, 3, 1, 2).contiguous())
        x = _cbr(self, "ld1_pw", _cbr(self, "ld1_dw", x))
        higher = _cbr(self, "ld2_pw", _cbr(self, "ld2_dw", x))
        y = higher
        for i in range(len(self.global_channels)):
            for b in range(3):
                y = getattr(self, f"gfe{i}_{b}")(y)
        lower = _cbr(self, "ppm", y + _gap(y))
        up = _cbr(self, "ffm_dw", _resize_nchw(lower, higher.shape[2:]), act=None)
        up = _cbr(self, "ffm_up", up, act=None)
        fused = F.relu(up + _cbr(self, "ffm_hi", higher, act=None))
        return tuple(o.permute(0, 2, 3, 1) for o in (fused, higher, lower))


class _CGBlock(nn.Module):
    """CGNet's context-guided block: a local 3x3 and a dilated surrounding
    3x3 depthwise conv, joint BN + PReLU (slopes start at 0.25), a
    global-context gate; residual where stride 1 keeps the width."""

    def __init__(self, in_channels: int, features: int, dilation: int = 2, stride: int = 1,
                 reduction: int = 16):
        super().__init__()
        half = features // 2
        self.residual = stride == 1 and in_channels == features
        _add_cbr(self, "reduce", in_channels, half, 3 if stride == 2 else 1, stride)
        self.f_loc = Conv2dSame(half, half, 3, groups=half)
        self.f_sur = Conv2dSame(half, half, 3, dilation=dilation, groups=half)
        self.bn = BatchNorm2d(2 * half, eps=1e-5)
        self.prelu = nn.Parameter(torch.full((2 * half,), 0.25))
        self.fc1 = nn.Linear(2 * half, features // reduction)
        self.fc2 = nn.Linear(features // reduction, features)

    def flax_init(self, leaf: str, shape, gen: torch.Generator) -> Optional[torch.Tensor]:
        return torch.full(shape, 0.25) if leaf == "prelu" else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _cbr(self, "reduce", x)
        j = self.bn(torch.cat([self.f_loc(y), self.f_sur(y)], dim=1))
        j = torch.where(j >= 0, j, self.prelu[:, None, None] * j)
        g = torch.sigmoid(self.fc2(F.relu(self.fc1(j.mean(dim=(2, 3))))))
        j = j * g[:, :, None, None]
        return x + j if self.residual else j


class CGNet(nn.Module):
    """CGNet: a three-conv stem and two CG stages, the image injected
    (bilinear) after the stem and after stage 1. Returns (stem, stage1,
    stage2)."""

    def __init__(self, channels: Sequence[int] = (32, 64, 128), blocks: Sequence[int] = (3, 6),
                 dilations: Sequence[int] = (2, 4), in_channels: int = 3):
        super().__init__()
        self.blocks = tuple(blocks)
        cin = in_channels
        for i in range(3):
            _add_cbr(self, f"stem{i}", cin, channels[0], 3, 2 if i == 0 else 1)
            cin = channels[0]
        cin = channels[0] + in_channels
        outs = [cin]
        for s in range(2):
            w, d = channels[s + 1], dilations[s]
            self.add_module(f"s{s}_down", _CGBlock(cin, w, dilation=d, stride=2))
            for i in range(self.blocks[s]):
                self.add_module(f"s{s}_b{i}", _CGBlock(w, w, dilation=d))
            cin = w + in_channels if s == 0 else w
            outs.append(cin)
        self.out_channels = tuple(outs)

    def forward(self, x: torch.Tensor, generator=None) -> Tuple[torch.Tensor, ...]:
        img = x.permute(0, 3, 1, 2).contiguous()
        y = img
        for i in range(3):
            y = _cbr(self, f"stem{i}", y)
        y = torch.cat([y, _resize_nchw(img, y.shape[2:])], dim=1)
        outs = [y]
        for s in range(2):
            y = getattr(self, f"s{s}_down")(y)
            for i in range(self.blocks[s]):
                y = getattr(self, f"s{s}_b{i}")(y)
            if s == 0:
                y = torch.cat([y, _resize_nchw(img, y.shape[2:])], dim=1)
            outs.append(y)
        return tuple(o.permute(0, 2, 3, 1) for o in outs)


class _NonBottleneck1D(nn.Module):
    """ERFNet's factorised residual block: (3x1, 1x3) twice, the second pair
    dilated along its own axis; BN eps 1e-3."""

    def __init__(self, features: int, dilation: int = 1):
        super().__init__()
        w, d = features, dilation
        self.c31a = Conv2dSame(w, w, (3, 1), bias=True)
        self.c13a = Conv2dSame(w, w, (1, 3))
        self.bn1 = BatchNorm2d(w, eps=1e-3)
        self.c31b = Conv2dSame(w, w, (3, 1), dilation=(d, 1), bias=True)
        self.c13b = Conv2dSame(w, w, (1, 3), dilation=(1, d))
        self.bn2 = BatchNorm2d(w, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.c13a(F.relu(self.c31a(x)))))
        y = self.bn2(self.c13b(F.relu(self.c31b(y))))
        return F.relu(x + y)


class ERFNet(nn.Module):
    """ERFNet's encoder: downsamplers (a SAME stride-2 conv beside a VALID
    2x2 max pool, concatenated; BN eps 1e-3) and non-bottleneck-1D stacks
    with growing dilation. Returns the three stages (strides 2, 4, 8); the
    input's sides must be multiples of 8, as in JAX."""

    def __init__(self, channels: Sequence[int] = (16, 64, 128), in_channels: int = 3):
        super().__init__()
        cin, outs = in_channels, []
        for i, w in enumerate(channels, start=1):
            conv = max(w - cin, 1)
            self.add_module(f"down{i}_conv", Conv2dSame(cin, conv, 3, 2, bias=True))
            self.add_module(f"down{i}_bn", BatchNorm2d(conv + cin, eps=1e-3))
            cin = conv + cin
            outs.append(cin)
            if i == 2:
                for b in range(5):
                    self.add_module(f"nb1_{b}", _NonBottleneck1D(cin))
            elif i == 3:
                for r in range(2):
                    for b, d in enumerate((2, 4, 8, 16)):
                        self.add_module(f"nb2_{r}_{b}", _NonBottleneck1D(cin, dilation=d))
        self.out_channels = tuple(outs)

    def _down(self, x: torch.Tensor, name: str) -> torch.Tensor:
        y = torch.cat([getattr(self, f"{name}_conv")(x), F.max_pool2d(x, 2, 2)], dim=1)
        return F.relu(getattr(self, f"{name}_bn")(y))

    def forward(self, x: torch.Tensor, generator=None) -> Tuple[torch.Tensor, ...]:
        x = self._down(x.permute(0, 3, 1, 2).contiguous(), "down1")
        outs = [x]
        x = self._down(x, "down2")
        for b in range(5):
            x = getattr(self, f"nb1_{b}")(x)
        outs.append(x)
        x = self._down(x, "down3")
        for r in range(2):
            for b in range(4):
                x = getattr(self, f"nb2_{r}_{b}")(x)
        outs.append(x)
        return tuple(o.permute(0, 2, 3, 1) for o in outs)


class ICNeck(nn.Module):
    """ICNet's cascade feature fusion: the inputs (c_sub1, c_sub2, c_sub4),
    fine to coarse, fused pairwise (the coarser resized, a dilated 3x3; the
    finer through a 1x1). Returns (low24, low12, fused12)."""

    def __init__(self, in_channels: Sequence[int], channels: int = 128):
        super().__init__()
        c1, c2, c3 = in_channels
        _add_cbr(self, "cff24_low", c3, channels, 3, dilation=2)
        _add_cbr(self, "cff24_high", c2, channels, 1)
        _add_cbr(self, "cff12_low", channels, channels, 3, dilation=2)
        _add_cbr(self, "cff12_high", c1, channels, 1)
        self.out_channels = (channels,) * 3

    def _cff(self, low: torch.Tensor, high: torch.Tensor, name: str):
        low = _cbr(self, f"{name}_low", _resize_nchw(low, high.shape[2:]), act=None)
        high = _cbr(self, f"{name}_high", high, act=None)
        return F.relu(low + high), low

    def forward(self, inputs: Sequence[torch.Tensor], generator=None
                ) -> Tuple[torch.Tensor, ...]:
        c1, c2, c3 = (t.permute(0, 3, 1, 2) for t in inputs)
        fused24, low24 = self._cff(c3, c2, "cff24")
        fused12, low12 = self._cff(fused24, c1, "cff12")
        return tuple(o.permute(0, 2, 3, 1) for o in (low24, low12, fused12))
