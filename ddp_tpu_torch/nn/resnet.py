"""ResNet / ResNeXt backbones (port of ``ddp_tpu/nn/resnet.py:23-149``).

mmseg's ResNet zoo (resnet.py: ResNetV1c deep stem, dilations for output
stride 8; resnext.py grouped bottlenecks), strides in each block's 3x3 conv.
NHWC in and out; contiguous NCHW inside (a channels-last conv stack's
backward crashed torch 2.13's CPU build with several threads). Every conv
pads as flax's ``SAME`` does (``Conv2dSame``: a strided conv's extra row
goes after), and a dilated one pads d·(k−1)/2 on each side. BatchNorm has flax's training semantics
(``BatchNorm2d``); train and eval follow ``module.training``. The modules
carry the flax names, so ``convert.py`` maps JAX weights.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .common import BatchNorm2d, Conv2dSame


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_channels: int, features: int, stride: int = 1, dilation: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = Conv2dSame(in_channels, features, 3, stride, dilation)
        self.bn1 = BatchNorm2d(features, eps=1e-5)
        self.conv2 = Conv2dSame(features, features, 3, 1, dilation)
        self.bn2 = BatchNorm2d(features, eps=1e-5)
        if downsample:
            self.down_conv = Conv2dSame(in_channels, features, 1, stride)
            self.down_bn = BatchNorm2d(features, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW."""
        y = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        identity = self.down_bn(self.down_conv(x)) if hasattr(self, "down_conv") else x
        return F.relu(y + identity)


class Bottleneck(nn.Module):
    """``features`` is the bottleneck width; the output has 4x."""

    expansion = 4

    def __init__(self, in_channels: int, features: int, stride: int = 1, dilation: int = 1,
                 downsample: bool = False, groups: int = 1, width_per_group: int = 64):
        super().__init__()
        width = (int(features * (width_per_group / 64.0)) * groups if groups > 1
                 else features)
        self.conv1 = Conv2dSame(in_channels, width, 1)
        self.bn1 = BatchNorm2d(width, eps=1e-5)
        self.conv2 = Conv2dSame(width, width, 3, stride, dilation, groups)
        self.bn2 = BatchNorm2d(width, eps=1e-5)
        self.conv3 = Conv2dSame(width, features * 4, 1)
        self.bn3 = BatchNorm2d(features * 4, eps=1e-5)
        if downsample:
            self.down_conv = Conv2dSame(in_channels, features * 4, 1, stride)
            self.down_bn = BatchNorm2d(features * 4, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW."""
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = self.down_bn(self.down_conv(x)) if hasattr(self, "down_conv") else x
        return F.relu(y + identity)


_DEPTH_CFG = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}


class ResNet(nn.Module):
    """ResNet with mmseg's segmentation defaults: the deep 3x3x3 stem (V1c),
    strides (1,2,2,2), or dilations (1,1,2,4) for output stride 8. Returns the
    maps of ``out_indices``, NHWC (``out_channels``: their channels)."""

    def __init__(self, depth: int = 50, deep_stem: bool = True, stem_channels: int = 64,
                 base_channels: int = 64, strides: Sequence[int] = (1, 2, 2, 2),
                 dilations: Sequence[int] = (1, 1, 1, 1),
                 out_indices: Sequence[int] = (0, 1, 2, 3), groups: int = 1,
                 width_per_group: int = 64, in_channels: int = 3):
        super().__init__()
        block_type, self.depths = _DEPTH_CFG[depth]
        self.out_indices = tuple(out_indices)
        if deep_stem:
            stem = [(stem_channels // 2, 2), (stem_channels // 2, 1), (stem_channels, 1)]
            kernel = 3
        else:
            stem, kernel = [(stem_channels, 2)], 7
        ch = in_channels
        for i, (f, s) in enumerate(stem):
            self.add_module(f"stem_conv{i}", Conv2dSame(ch, f, kernel, s))
            self.add_module(f"stem_bn{i}", BatchNorm2d(f, eps=1e-5))
            ch = f
        self.n_stem = len(stem)
        cls = Bottleneck if block_type == "bottleneck" else BasicBlock
        self.out_channels = tuple(base_channels * 2 ** s * cls.expansion for s in range(4)
                                  if s in self.out_indices)
        for stage, num_blocks in enumerate(self.depths):
            feats = base_channels * (2 ** stage)
            for blk in range(num_blocks):
                s = strides[stage] if blk == 0 else 1
                need_down = blk == 0 and (s != 1 or ch != feats * cls.expansion)
                kw = dict(groups=groups, width_per_group=width_per_group) \
                    if cls is Bottleneck else {}
                self.add_module(f"stage{stage}_block{blk}", cls(
                    ch, feats, s, dilations[stage], need_down, **kw))
                ch = feats * cls.expansion

    def forward(self, x: torch.Tensor, generator=None) -> Tuple[torch.Tensor, ...]:
        """x: [B, H, W, C]. ``generator`` is accepted for the backbone
        interface (nothing here is random)."""
        x = x.permute(0, 3, 1, 2).contiguous()
        for i in range(self.n_stem):
            x = F.relu(getattr(self, f"stem_bn{i}")(getattr(self, f"stem_conv{i}")(x)))
        x = F.max_pool2d(x, 3, 2, padding=1)
        outs = []
        for stage, num_blocks in enumerate(self.depths):
            for blk in range(num_blocks):
                x = getattr(self, f"stage{stage}_block{blk}")(x)
            if stage in self.out_indices:
                outs.append(x.permute(0, 2, 3, 1))
        return tuple(outs)


def resnext(depth: int = 101, groups: int = 32, width_per_group: int = 4, **kw) -> ResNet:
    """ResNeXt factory (mmseg resnext.py semantics)."""
    return ResNet(depth=depth, groups=groups, width_per_group=width_per_group, **kw)
