"""DLA and VoVNet camera backbones (port of ``ddp_tpu/nn/dla_vovnet.py:
93-178``; BEVFusion's mmdet3d ``backbones/dla.py``, ``vovnet.py``).

  - ``DLA``: deep layer aggregation, binary aggregation trees per stage
    with root fusion nodes; DLA-34 by default. Returns the stride 4-32 maps.
  - ``VoVNet``: one-shot-aggregation stages (K sequential 3x3 convs whose
    outputs and input are concatenated once into a 1x1 projection) with
    effective-SE gating by the hard sigmoid ``clip((s + 3) / 6, 0, 1)``;
    V2-19 slim by default. Between stages a 3x3/2 max pool with padding 1
    (padded cells are −inf, as flax pads).

BatchNorm is flax's (momentum 0.9, eps 1e-5). Maps are NHWC at the
boundaries, as in JAX; inside, the convs run on contiguous NCHW. Every
module carries the flax names.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .common import BatchNorm2d


def _conv(cin: int, cout: int, k: int, stride: int = 1, bias: bool = False) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=bias)


def _bn(channels: int) -> BatchNorm2d:
    return BatchNorm2d(channels, eps=1e-5)


class _DLABasic(nn.Module):
    def __init__(self, in_channels: int, channels: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(in_channels, channels, 3, stride)
        self.bn1 = _bn(channels)
        self.conv2 = _conv(channels, channels, 3)
        self.bn2 = _bn(channels)

    def forward(self, x: torch.Tensor, residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        residual = x if residual is None else residual
        y = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(y)) + residual)


class _Root(nn.Module):
    def __init__(self, in_channels: int, channels: int, shortcut: bool = False):
        super().__init__()
        self.conv = _conv(in_channels, channels, 1)
        self.bn = _bn(channels)
        self.shortcut = shortcut

    def forward(self, xs: List[torch.Tensor]) -> torch.Tensor:
        y = self.bn(self.conv(torch.cat(xs, dim=1)))
        return F.relu(y + xs[0] if self.shortcut else y)


class _Tree(nn.Module):
    """Binary aggregation tree (dla.py:156-242). ``children_channels``: the
    channels of the maps a parent passes down to the root."""

    def __init__(self, levels: int, in_channels: int, channels: int, stride: int = 1,
                 level_root: bool = False, root_shortcut: bool = False,
                 children_channels: int = 0):
        super().__init__()
        self.levels, self.stride, self.level_root = levels, stride, level_root
        if in_channels != channels:
            self.project = _conv(in_channels, channels, 1)
            self.project_bn = _bn(channels)
        kids = children_channels + (in_channels if level_root else 0)
        if levels == 1:
            self.tree1 = _DLABasic(in_channels, channels, stride)
            self.tree2 = _DLABasic(channels, channels)
            self.root = _Root(2 * channels + kids, channels, root_shortcut)
        else:
            self.tree1 = _Tree(levels - 1, in_channels, channels, stride,
                               root_shortcut=root_shortcut)
            self.tree2 = _Tree(levels - 1, channels, channels, root_shortcut=root_shortcut,
                               children_channels=kids + channels)

    def forward(self, x: torch.Tensor, children: Sequence[torch.Tensor] = ()) -> torch.Tensor:
        children = list(children)
        bottom = F.max_pool2d(x, self.stride, self.stride) if self.stride > 1 else x
        residual = bottom
        if hasattr(self, "project"):
            if self.levels == 1:
                residual = self.project_bn(self.project(bottom))
            elif self.training:
                # JAX computes the projection here and drops it: only its
                # BatchNorm statistics move (its parameters' gradient is 0)
                with torch.no_grad():
                    self.project_bn(self.project(bottom))
        if self.level_root:
            children.append(bottom)
        if self.levels == 1:
            x1 = self.tree1(x, residual)
            x2 = self.tree2(x1)
            return self.root([x2, x1] + children)
        x1 = self.tree1(x)
        return self.tree2(x1, children + [x1])


class DLA(nn.Module):
    """DLA-34 by default: levels (1, 1, 1, 2, 2, 1), channels (16, 32, 64,
    128, 256, 512). Images [B, H, W, 3] -> the four stride 4-32 maps."""

    def __init__(self, in_channels: int = 3, levels: Sequence[int] = (1, 1, 1, 2, 2, 1),
                 channels: Sequence[int] = (16, 32, 64, 128, 256, 512)):
        super().__init__()
        ch = tuple(channels)
        self.out_channels = ch[2:6]
        self.base = _conv(in_channels, ch[0], 7)
        self.base_bn = _bn(ch[0])
        self.l0 = _conv(ch[0], ch[0], 3)
        self.l0_bn = _bn(ch[0])
        self.l1 = _conv(ch[0], ch[1], 3, 2)
        self.l1_bn = _bn(ch[1])
        for i in range(2, 6):
            self.add_module(f"level{i}", _Tree(levels[i], ch[i - 1], ch[i], stride=2,
                                               level_root=i > 2))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = x.permute(0, 3, 1, 2).contiguous()
        x = F.relu(self.base_bn(self.base(x)))
        x = F.relu(self.l0_bn(self.l0(x)))
        x = F.relu(self.l1_bn(self.l1(x)))
        outs = []
        for i in range(2, 6):
            x = getattr(self, f"level{i}")(x)
            outs.append(x.permute(0, 2, 3, 1))
        return tuple(outs)


class _eSE(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.fc = nn.Conv2d(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.fc(x.mean(dim=(2, 3), keepdim=True))
        return x * torch.clamp((s + 3.0) / 6.0, 0.0, 1.0)


class _OSA(nn.Module):
    def __init__(self, in_channels: int, stage_ch: int, concat_ch: int, layers: int = 5,
                 identity: bool = False):
        super().__init__()
        self.layers, self.identity = layers, identity
        for i in range(layers):
            self.add_module(f"conv{i}", _conv(in_channels if i == 0 else stage_ch, stage_ch, 3))
            self.add_module(f"bn{i}", _bn(stage_ch))
        self.concat = _conv(in_channels + layers * stage_ch, concat_ch, 1)
        self.concat_bn = _bn(concat_ch)
        self.ese = _eSE(concat_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = [x]
        y = x
        for i in range(self.layers):
            y = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(y)))
            feats.append(y)
        y = self.ese(F.relu(self.concat_bn(self.concat(torch.cat(feats, dim=1)))))
        return y + x if self.identity else y


class VoVNet(nn.Module):
    """VoVNetV2-19 slim by default: a 64/64/128 stem (strides 2, 1, 1) and
    OSA stages of (stage_ch, concat_ch, blocks). Images [B, H, W, 3] -> the
    four stage maps (strides 2, 4, 8, 16)."""

    def __init__(self, in_channels: int = 3, stage_ch: Sequence[int] = (64, 80, 96, 112),
                 concat_ch: Sequence[int] = (112, 256, 384, 512),
                 blocks: Sequence[int] = (1, 1, 1, 1), osa_layers: int = 3):
        super().__init__()
        self.blocks = tuple(blocks)
        self.out_channels = tuple(concat_ch)
        cin = in_channels
        for i, (c, s) in enumerate(((64, 2), (64, 1), (128, 1))):
            self.add_module(f"stem{i}", _conv(cin, c, 3, s))
            self.add_module(f"stem{i}_bn", _bn(c))
            cin = c
        for si, (sc, cc, nb) in enumerate(zip(stage_ch, concat_ch, self.blocks)):
            for bi in range(nb):
                self.add_module(f"s{si}_osa{bi}", _OSA(cin, sc, cc, osa_layers,
                                                       identity=bi > 0))
                cin = cc

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = x.permute(0, 3, 1, 2).contiguous()
        for i in range(3):
            x = F.relu(getattr(self, f"stem{i}_bn")(getattr(self, f"stem{i}")(x)))
        outs = []
        for si, nb in enumerate(self.blocks):
            if si > 0:
                x = F.max_pool2d(x, 3, 2, padding=1)
            for bi in range(nb):
                x = getattr(self, f"s{si}_osa{bi}")(x)
            outs.append(x.permute(0, 2, 3, 1))
        return tuple(outs)
