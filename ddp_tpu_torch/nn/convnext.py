"""ConvNeXt backbone (port of ``ddp_tpu/nn/convnext.py``), NHWC.

mmcls ConvNeXt as the Cityscapes DDP configs use it: a 4×4/4 stem conv +
LN, 2×2/2 LN-conv downsamplers, blocks of 7×7 depthwise conv → LN →
Linear(4C) → GELU → Linear(C) → layer scale → drop path, and an LN on each
output stage. Parity traps carried over from the JAX package:

  - every LayerNorm has eps 1e-6 (Swin's have 1e-5);
  - the GELU is the tanh approximation (flax's default; mmcls uses the exact
    erf form: ROADMAP.md queue 3);
  - the layer scale ``gamma`` starts at 1e-6;
  - drop path grows linearly over all blocks, ``linspace(0, rate,
    sum(depths))``, and draws from the generator the caller passes;
  - module names are the flax names (``stem_conv``, ``stem_norm``,
    ``down_norm{s}``, ``down_conv{s}``, ``stage{s}_block{b}``,
    ``out_norm{s}``), so ``convert.py`` maps the JAX weights by its general
    rules: a flax depthwise kernel [7, 7, 1, C] becomes [C, 1, 7, 7].
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .common import drop_path, gelu

_EPS = 1e-6


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, drop_path: float = 0.0, layer_scale_init: float = 1e-6):
        super().__init__()
        self.drop_path = drop_path
        self.layer_scale_init = layer_scale_init
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=_EPS)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)
        self.gamma = (nn.Parameter(torch.full((dim,), layer_scale_init))
                      if layer_scale_init > 0 else None)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        y = self.dwconv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        y = self.pwconv2(gelu(self.pwconv1(self.norm(y))))
        if self.gamma is not None:
            y = y * self.gamma
        return x + drop_path(y, self.drop_path, self.training, generator)


class ConvNeXt(nn.Module):
    """Returns the LN'd features of ``out_indices`` stages, NHWC."""

    def __init__(self, depths: Sequence[int] = (3, 3, 9, 3),
                 dims: Sequence[int] = (96, 192, 384, 768), drop_path_rate: float = 0.4,
                 out_indices: Sequence[int] = (0, 1, 2, 3), in_chans: int = 3):
        super().__init__()
        self.depths = tuple(depths)
        self.out_indices = tuple(out_indices)
        dpr = np.linspace(0.0, drop_path_rate, sum(self.depths))
        block_idx = 0
        for stage, depth in enumerate(self.depths):
            if stage == 0:
                self.stem_conv = nn.Conv2d(in_chans, dims[0], 4, stride=4)
                self.stem_norm = nn.LayerNorm(dims[0], eps=_EPS)
            else:
                self.add_module(f"down_norm{stage}", nn.LayerNorm(dims[stage - 1], eps=_EPS))
                self.add_module(f"down_conv{stage}",
                                nn.Conv2d(dims[stage - 1], dims[stage], 2, stride=2))
            for blk in range(depth):
                self.add_module(f"stage{stage}_block{blk}",
                                ConvNeXtBlock(dims[stage], drop_path=float(dpr[block_idx])))
                block_idx += 1
            if stage in self.out_indices:
                self.add_module(f"out_norm{stage}", nn.LayerNorm(dims[stage], eps=_EPS))

    @staticmethod
    def _conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, ...]:
        outs = []
        for stage, depth in enumerate(self.depths):
            if stage == 0:
                x = self.stem_norm(self._conv(self.stem_conv, x))
            else:
                x = self._conv(getattr(self, f"down_conv{stage}"),
                               getattr(self, f"down_norm{stage}")(x))
            for blk in range(depth):
                x = getattr(self, f"stage{stage}_block{blk}")(x, generator)
            if stage in self.out_indices:
                outs.append(getattr(self, f"out_norm{stage}")(x))
        return tuple(outs)


def convnext_variant(name: str) -> dict:
    """Constructor kwargs for the published ConvNeXt variants used by DDP configs."""
    variants = {
        # 'nano' is a test-only scale (not in the reference) for fast CPU CI
        "nano": dict(depths=(1, 1, 1, 1), dims=(16, 32, 64, 128)),
        "tiny": dict(depths=(3, 3, 9, 3), dims=(96, 192, 384, 768)),
        "small": dict(depths=(3, 3, 27, 3), dims=(96, 192, 384, 768)),
        "base": dict(depths=(3, 3, 27, 3), dims=(128, 256, 512, 1024)),
        "large": dict(depths=(3, 3, 27, 3), dims=(192, 384, 768, 1536)),
    }
    return dict(variants[name])
