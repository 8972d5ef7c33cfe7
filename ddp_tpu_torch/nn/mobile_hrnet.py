"""Compat backbones I: MobileNetV2/V3, HRNet, UNet, ResNeSt (port of
``ddp_tpu/nn/mobile_hrnet.py:28-433``).

mmseg's mobilenet_v2, mobilenet_v3, hrnet, unet and resnest backbones as the
JAX package re-designs them (its HRNet stage 1 is two basic blocks at 64
channels where mmseg's has bottlenecks; its ResNeSt downsamples by average
pooling, radix 2, groups 1). Each returns a tuple of NHWC maps, whose
channels it names in ``out_channels``; inside they run contiguous NCHW, for
the reason ``resnet.py`` gives (UNet: NHWC through ``ConvModule``). Convs
and pools pad as flax's ``SAME`` does; flax's ``avg_pool`` divides by the
whole window, padding included (``avg_pool_same``). BatchNorm has flax's training semantics. The
modules carry the flax names, so ``convert.py`` maps JAX weights.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import resize
from .common import BatchNorm2d, Conv2dSame, ConvModule, avg_pool_same, max_pool_same


def _hswish(x: torch.Tensor) -> torch.Tensor:
    return x * F.relu6(x + 3.0) / 6.0


def _hsigmoid(x: torch.Tensor) -> torch.Tensor:
    return F.relu6(x + 3.0) / 6.0


def _bn(channels: int) -> BatchNorm2d:
    return BatchNorm2d(channels, eps=1e-5)


def _resize_nchw(x: torch.Tensor, size, mode: str = "bilinear") -> torch.Tensor:
    """NCHW through the NHWC ``resize`` (bilinear: align_corners=False)."""
    return resize(x.permute(0, 2, 3, 1), tuple(size), mode=mode).permute(0, 3, 1, 2)


class _SE(nn.Module):
    """Squeeze-excitation; MobileNetV3's gate is the hard sigmoid."""

    def __init__(self, channels: int, ratio: int = 4, gate: str = "hsigmoid"):
        super().__init__()
        self.fc1 = Conv2dSame(channels, channels // ratio, 1, bias=True)
        self.fc2 = Conv2dSame(channels // ratio, channels, 1, bias=True)
        self.gate = gate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW."""
        s = self.fc2(F.relu(self.fc1(x.mean(dim=(2, 3), keepdim=True))))
        return x * (_hsigmoid(s) if self.gate == "hsigmoid" else torch.sigmoid(s))


class _InvertedResidual(nn.Module):
    """MobileNet inverted residual: 1x1 expand -> depthwise kxk -> (SE) -> 1x1
    project, residual where stride 1 keeps the width."""

    def __init__(self, in_channels: int, out: int, expand: int, kernel: int = 3,
                 stride: int = 1, dilation: int = 1, se: bool = False, act: str = "relu"):
        super().__init__()
        self.act = _hswish if act == "hswish" else F.relu6
        self.residual = stride == 1 and in_channels == out
        if expand != in_channels:
            self.expand = Conv2dSame(in_channels, expand, 1)
            self.expand_bn = _bn(expand)
        self.dw = Conv2dSame(expand, expand, kernel, stride, dilation, groups=expand)
        self.dw_bn = _bn(expand)
        if se:
            self.se = _SE(expand)
        self.project = Conv2dSame(expand, out, 1)
        self.project_bn = _bn(out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW."""
        y = self.act(self.expand_bn(self.expand(x))) if hasattr(self, "expand") else x
        y = self.act(self.dw_bn(self.dw(y)))
        if hasattr(self, "se"):
            y = self.se(y)
        y = self.project_bn(self.project(y))
        return x + y if self.residual else y


class MobileNetV2(nn.Module):
    """MobileNetV2 seg backbone (mmseg mobilenet_v2.py): 7 stages, the last
    two dilated, out_indices (1,2,4,6)."""

    def __init__(self, widths: Sequence[int] = (16, 24, 32, 64, 96, 160, 320),
                 repeats: Sequence[int] = (1, 2, 3, 4, 3, 3, 1),
                 strides: Sequence[int] = (1, 2, 2, 2, 1, 1, 1),
                 dilations: Sequence[int] = (1, 1, 1, 1, 1, 2, 4),
                 out_indices: Sequence[int] = (1, 2, 4, 6), width_mult: float = 1.0,
                 in_channels: int = 3):
        super().__init__()
        self.repeats = tuple(repeats)
        self.out_indices = tuple(out_indices)
        ch = int(32 * width_mult)
        self.out_channels = tuple(int(w * width_mult) for i, w in enumerate(widths)
                                  if i in self.out_indices)
        self.stem = Conv2dSame(in_channels, ch, 3, 2)
        self.stem_bn = _bn(ch)
        for si, (w, r, s, d) in enumerate(zip(widths, repeats, strides, dilations)):
            w = int(w * width_mult)
            for bi in range(r):
                expand = ch * (1 if si == 0 and bi == 0 else 6)
                self.add_module(f"stage{si}_block{bi}", _InvertedResidual(
                    ch, w, expand, stride=s if bi == 0 else 1, dilation=d))
                ch = w

    def forward(self, x: torch.Tensor, generator=None) -> Tuple[torch.Tensor, ...]:
        x = F.relu6(self.stem_bn(self.stem(x.permute(0, 3, 1, 2).contiguous())))
        outs = []
        for si, r in enumerate(self.repeats):
            for bi in range(r):
                x = getattr(self, f"stage{si}_block{bi}")(x)
            if si in self.out_indices:
                outs.append(x.permute(0, 2, 3, 1))
        return tuple(outs)


# (kernel, expand, out, se, act, stride) per block: MobileNetV3-Large and
# -Small (mmseg mobilenet_v3.py arch_settings)
_V3_LARGE = [
    (3, 16, 16, False, "relu", 1),
    (3, 64, 24, False, "relu", 2),
    (3, 72, 24, False, "relu", 1),
    (5, 72, 40, True, "relu", 2),
    (5, 120, 40, True, "relu", 1),
    (5, 120, 40, True, "relu", 1),
    (3, 240, 80, False, "hswish", 2),
    (3, 200, 80, False, "hswish", 1),
    (3, 184, 80, False, "hswish", 1),
    (3, 184, 80, False, "hswish", 1),
    (3, 480, 112, True, "hswish", 1),
    (3, 672, 112, True, "hswish", 1),
    (5, 672, 160, True, "hswish", 2),
    (5, 960, 160, True, "hswish", 1),
    (5, 960, 160, True, "hswish", 1),
]
_V3_SMALL = [
    (3, 16, 16, True, "relu", 2),
    (3, 72, 24, False, "relu", 2),
    (3, 88, 24, False, "relu", 1),
    (5, 96, 40, True, "hswish", 2),
    (5, 240, 40, True, "hswish", 1),
    (5, 240, 40, True, "hswish", 1),
    (5, 120, 48, True, "hswish", 1),
    (5, 144, 48, True, "hswish", 1),
    (5, 288, 96, True, "hswish", 2),
    (5, 576, 96, True, "hswish", 1),
    (5, 576, 96, True, "hswish", 1),
]


class MobileNetV3(nn.Module):
    """MobileNetV3 (mmseg mobilenet_v3.py): the taps ``out_indices`` (default
    (1, 3) large, (0, 1) small) and the final 1x1 conv. ``dilated`` (mmseg's
    seg conversion): the last two downsampling blocks run at stride 1 and the
    tail dilated 2 then 4, so the last tap is at output stride 8."""

    def __init__(self, arch: str = "large", out_indices: Sequence[int] = (),
                 dilated: bool = True, in_channels: int = 3):
        super().__init__()
        cfg = _V3_LARGE if arch == "large" else _V3_SMALL
        self.taps = tuple(out_indices) or ((1, 3) if arch == "large" else (0, 1))
        if dilated:
            destride = (6, 12) if arch == "large" else (3, 8)
            dil2 = range(7, 13) if arch == "large" else range(4, 9)
        self.n_blocks = len(cfg)
        self.stem = Conv2dSame(in_channels, 16, 3, 2)
        self.stem_bn = _bn(16)
        ch = 16
        for i, (k, e, o, se, act, s) in enumerate(cfg):
            d = 1
            if dilated:
                if i in destride:
                    s = 1
                d = 2 if i in dil2 else (4 if i > max(destride) else 1)
            self.add_module(f"block{i}", _InvertedResidual(ch, o, e, k, s, d, se, act))
            ch = o
        self.out_channels = tuple(cfg[i][2] for i in range(len(cfg)) if i in self.taps) \
            + (ch * 6,)
        self.last_conv = Conv2dSame(ch, ch * 6, 1)
        self.last_bn = _bn(ch * 6)

    def forward(self, x: torch.Tensor, generator=None) -> Tuple[torch.Tensor, ...]:
        x = _hswish(self.stem_bn(self.stem(x.permute(0, 3, 1, 2).contiguous())))
        outs = []
        for i in range(self.n_blocks):
            x = getattr(self, f"block{i}")(x)
            if i in self.taps:
                outs.append(x.permute(0, 2, 3, 1))
        x = _hswish(self.last_bn(self.last_conv(x)))
        outs.append(x.permute(0, 2, 3, 1))
        return tuple(outs)


class _HRBasicBlock(nn.Module):
    def __init__(self, in_channels: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2dSame(in_channels, features, 3, stride)
        self.bn1 = _bn(features)
        self.conv2 = Conv2dSame(features, features, 3)
        self.bn2 = _bn(features)
        if in_channels != features or stride != 1:
            self.down_conv = Conv2dSame(in_channels, features, 1, stride)
            self.down_bn = _bn(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW."""
        y = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        identity = self.down_bn(self.down_conv(x)) if hasattr(self, "down_conv") else x
        return F.relu(identity + y)


class HRNet(nn.Module):
    """HRNet (mmseg hrnet.py): parallel streams of ``widths`` channels (W18 =
    (18, 36, 72, 144)) fused across resolutions after every stage module
    (``stage_modules``: modules in stages 2..4; ``blocks_per_stage`` basic
    blocks per branch). Returns every branch's map (strides 4/8/16/32)."""

    def __init__(self, widths: Sequence[int] = (18, 36, 72, 144), blocks_per_stage: int = 2,
                 stage_modules: Sequence[int] = (1, 1, 2), in_channels: int = 3):
        super().__init__()
        self.widths = tuple(widths)
        self.out_channels = self.widths[:1 + len(stage_modules)]
        self.blocks_per_stage = blocks_per_stage
        self.stage_modules = tuple(stage_modules)
        self.stem1 = Conv2dSame(in_channels, 64, 3, 2)
        self.stem_bn1 = _bn(64)
        self.stem2 = Conv2dSame(64, 64, 3, 2)
        self.stem_bn2 = _bn(64)
        for i in range(blocks_per_stage):
            self.add_module(f"layer1_{i}", _HRBasicBlock(64, 64))
        chans = [64]
        for stage, n_modules in enumerate(self.stage_modules, start=2):
            for b in range(stage):
                w = widths[b]
                if b >= len(chans) or chans[b] != w:
                    src = chans[b] if b < len(chans) else chans[-1]
                    self.add_module(f"t{stage}_{b}", Conv2dSame(
                        src, w, 3, 1 if b < len(chans) else 2))
                    self.add_module(f"t{stage}_{b}_bn", _bn(w))
            chans = list(widths[:stage])
            for m in range(n_modules):
                for b in range(stage):
                    for i in range(blocks_per_stage):
                        self.add_module(f"s{stage}m{m}b{b}_{i}",
                                        _HRBasicBlock(widths[b], widths[b]))
                for i in range(stage):
                    for j in range(stage):
                        name = f"f{stage}m{m}_{j}to{i}"
                        if j > i:
                            self.add_module(name, Conv2dSame(widths[j], widths[i], 1))
                            self.add_module(f"{name}_bn", _bn(widths[i]))
                        elif j < i:
                            for d in range(i - j):
                                cw = widths[i] if d == i - j - 1 else widths[j]
                                self.add_module(f"{name}_d{d}", Conv2dSame(widths[j], cw, 3, 2))
                                self.add_module(f"{name}_d{d}_bn", _bn(cw))

    def forward(self, x: torch.Tensor, generator=None) -> Tuple[torch.Tensor, ...]:
        m_ = self._modules
        x = F.relu(self.stem_bn1(self.stem1(x.permute(0, 3, 1, 2).contiguous())))
        x = F.relu(self.stem_bn2(self.stem2(x)))
        for i in range(self.blocks_per_stage):
            x = m_[f"layer1_{i}"](x)
        branches = [x]
        for stage, n_modules in enumerate(self.stage_modules, start=2):
            new = []
            for b in range(stage):
                name = f"t{stage}_{b}"
                y = branches[b] if b < len(branches) else branches[-1]
                if name in m_:
                    y = F.relu(m_[f"{name}_bn"](m_[name](y)))
                new.append(y)
            branches = new
            for m in range(n_modules):
                for b in range(stage):
                    for i in range(self.blocks_per_stage):
                        branches[b] = m_[f"s{stage}m{m}b{b}_{i}"](branches[b])
                fused = []
                for i in range(stage):
                    acc = branches[i]
                    for j in range(stage):
                        name = f"f{stage}m{m}_{j}to{i}"
                        y = branches[j]
                        if j > i:  # upsample the lower-resolution branch
                            y = _resize_nchw(m_[f"{name}_bn"](m_[name](y)), acc.shape[2:])
                        elif j < i:  # a chain of strided 3x3 convs
                            for d in range(i - j):
                                y = m_[f"{name}_d{d}_bn"](m_[f"{name}_d{d}"](y))
                                if d < i - j - 1:
                                    y = F.relu(y)
                        else:
                            continue
                        acc = acc + y
                    fused.append(F.relu(acc))
                branches = fused
        return tuple(b.permute(0, 2, 3, 1) for b in branches)


class UNetBackbone(nn.Module):
    """UNet (mmseg unet.py): conv-conv stages with 2x2 max-pool downs, then
    bilinear up + skip concat. Returns the decoder maps coarsest first."""

    def __init__(self, base_channels: int = 64, num_stages: int = 5, in_channels: int = 3):
        super().__init__()
        self.num_stages = num_stages
        ch, w = in_channels, base_channels
        skips = []
        for s in range(num_stages):
            if s > 0:
                w *= 2
            self._block(f"enc{s}", ch, w)
            ch = w
            skips.append(w)
        self.out_channels = (w,) + tuple(w >> k for k in range(1, num_stages))
        for s in range(num_stages - 2, -1, -1):
            w //= 2
            self._block(f"dec{s}", ch + skips[s], w)
            ch = w

    def _block(self, name: str, in_channels: int, w: int) -> None:
        for i in range(2):
            self.add_module(f"{name}_c{i}", ConvModule(in_channels if i == 0 else w, w, (3, 3),
                                                       norm="BN", act="relu"))

    def _run(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return getattr(self, f"{name}_c1")(getattr(self, f"{name}_c0")(x))

    def forward(self, x: torch.Tensor, generator=None) -> Tuple[torch.Tensor, ...]:
        """NHWC."""
        skips = []
        for s in range(self.num_stages):
            if s > 0:
                x = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
            x = self._run(f"enc{s}", x)
            skips.append(x)
        outs = [skips[-1]]
        for s in range(self.num_stages - 2, -1, -1):
            x = resize(x, skips[s].shape[1:3], mode="bilinear")
            x = self._run(f"dec{s}", torch.cat([x, skips[s]], dim=-1))
            outs.append(x)
        return tuple(outs)


class SplitAttentionConv(nn.Module):
    """ResNeSt split-attention conv: a grouped 3x3 to ``radix`` splits, their
    sum pooled, two linear layers, a softmax over the splits (radix-major)."""

    def __init__(self, in_channels: int, features: int, radix: int = 2, groups: int = 1,
                 stride: int = 1):
        super().__init__()
        self.radix, self.features = radix, features
        self.conv = Conv2dSame(in_channels, features * radix, 3, stride, groups=groups * radix)
        self.bn = _bn(features * radix)
        inter = max(features * radix // 4, 32)
        self.fc1 = nn.Linear(features, inter)
        self.fc2 = nn.Linear(inter, features * radix)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW."""
        r, f = self.radix, self.features
        y = F.relu(self.bn(self.conv(x)))
        b, _, h, w = y.shape
        splits = y.reshape(b, r, f, h, w)
        gap = splits.sum(dim=1).mean(dim=(2, 3))  # [B, F]
        a = self.fc2(F.relu(self.fc1(gap))).reshape(b, r, f)
        a = torch.softmax(a, dim=1) if r > 1 else torch.sigmoid(a)
        return torch.einsum("brfhw,brf->bfhw", splits, a)


class ResNeSt(nn.Module):
    """ResNeSt-style backbone (mmseg resnest.py semantics as the JAX package
    simplifies them): the deep stem, a SAME max pool, bottlenecks whose 3x3 is
    a radix split-attention conv, average-pool downsampling (before the 3x3
    and on the shortcut)."""

    def __init__(self, depth: int = 50, base_channels: int = 64,
                 out_indices: Sequence[int] = (0, 1, 2, 3), radix: int = 2,
                 in_channels: int = 3):
        super().__init__()
        self.stage_blocks = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}[depth]
        self.out_indices = tuple(out_indices)
        self.out_channels = tuple(base_channels * 2 ** s * 4 for s in range(4)
                                  if s in self.out_indices)
        ch = in_channels
        for i, w in enumerate((32, 32, 64)):
            self.add_module(f"stem{i}", Conv2dSame(ch, w, 3, 2 if i == 0 else 1))
            self.add_module(f"stem_bn{i}", _bn(w))
            ch = w
        w = base_channels
        for s, n_blocks in enumerate(self.stage_blocks):
            for i in range(n_blocks):
                p = f"s{s}b{i}"
                self.add_module(f"{p}_conv1", Conv2dSame(ch, w, 1))
                self.add_module(f"{p}_bn1", _bn(w))
                self.add_module(f"{p}_splat", SplitAttentionConv(w, w, radix))
                self.add_module(f"{p}_conv3", Conv2dSame(w, w * 4, 1))
                self.add_module(f"{p}_bn3", _bn(w * 4))
                if i == 0 and (s > 0 or ch != w * 4):  # JAX: the shapes differ
                    self.add_module(f"{p}_down", Conv2dSame(ch, w * 4, 1))
                    self.add_module(f"{p}_down_bn", _bn(w * 4))
                ch = w * 4
            w *= 2

    def forward(self, x: torch.Tensor, generator=None) -> Tuple[torch.Tensor, ...]:
        m_ = self._modules
        x = x.permute(0, 3, 1, 2).contiguous()
        for i in range(3):
            x = F.relu(m_[f"stem_bn{i}"](m_[f"stem{i}"](x)))
        x = max_pool_same(x, 3, 2)
        outs = []
        for s, n_blocks in enumerate(self.stage_blocks):
            for i in range(n_blocks):
                p = f"s{s}b{i}"
                stride = 2 if (s > 0 and i == 0) else 1
                y = F.relu(m_[f"{p}_bn1"](m_[f"{p}_conv1"](x)))
                if stride > 1:
                    y = avg_pool_same(y, 3, 2)
                y = m_[f"{p}_bn3"](m_[f"{p}_conv3"](m_[f"{p}_splat"](y)))
                identity = x
                if f"{p}_down" in m_:
                    if stride > 1:
                        identity = avg_pool_same(identity, 2, 2)
                    identity = m_[f"{p}_down_bn"](m_[f"{p}_down"](identity))
                x = F.relu(identity + y)
            if s in self.out_indices:
                outs.append(x.permute(0, 2, 3, 1))
        return tuple(outs)
