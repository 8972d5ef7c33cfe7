"""FPN neck + MultiStageMerging (port of ``ddp_tpu/nn/fpn.py``), NHWC.

  - FPN: lateral 1x1 convs, top-down nearest upsample, 3x3 output convs,
    GN-32, no activation (configs/ade/ddp_swin_t...py:40-46).
  - MultiStageMerging: bilinear-resize every level to level 0, concat,
    1x1 conv + GN (multi_stage_merging.py:11-52).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from ..ops.resize import resize
from .common import ConvModule


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 num_outs: int = 4, norm: str = "GN"):
        super().__init__()
        self.num_levels = len(in_channels)
        self.num_outs = num_outs
        for i, c in enumerate(in_channels):
            self.add_module(f"lateral{i}", ConvModule(c, out_channels, (1, 1), norm=norm))
        for i in range(self.num_levels):
            self.add_module(f"fpn{i}", ConvModule(out_channels, out_channels, (3, 3),
                                                  norm=norm))

    def forward(self, inputs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        laterals = [getattr(self, f"lateral{i}")(x) for i, x in enumerate(inputs)]
        for i in range(len(laterals) - 1, 0, -1):
            h, w = laterals[i - 1].shape[1:3]
            laterals[i - 1] = laterals[i - 1] + resize(laterals[i], (h, w), mode="nearest")
        outs = [getattr(self, f"fpn{i}")(x) for i, x in enumerate(laterals)]
        return tuple(outs[: self.num_outs])


class MultiStageMerging(nn.Module):
    def __init__(self, in_channels: int, out_channels: int = 256, norm: str = "GN",
                 align_corners: bool = False):
        super().__init__()
        self.align_corners = align_corners
        self.down = ConvModule(in_channels, out_channels, (1, 1), norm=norm)

    def forward(self, inputs: Sequence[torch.Tensor]) -> torch.Tensor:
        h, w = inputs[0].shape[1:3]
        ups = [resize(x, (h, w), mode="bilinear", align_corners=self.align_corners)
               for x in inputs]
        return self.down(torch.cat(ups, dim=-1))
