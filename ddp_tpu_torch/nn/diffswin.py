"""DiffSwin: a Swin backbone with per-stage FiLM time conditioning (port of
``ddp_tpu/nn/diffswin.py``).

The reference's experimental DiffSwinTransformer (mmseg backbones/
diffswin.py:485, 427-471, 775-783): the model-level time MLP
(``TimeMLP``: LearnedSinusoidalPosEmb(16) -> Linear -> GELU -> Linear) of
the diffusion time t; each stage's SiLU -> Linear(time_dim -> 2C) gives one
(scale, shift) pair, applied after every block of the stage as
x·(scale + 1) + shift. The blocks and merges are the port's ``SwinBlock``
and ``PatchMerging``; the modules carry the flax names.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .common import Conv
from .swin import PatchMerging, SwinBlock
from .time_embed import TimeMLP


class DiffSwinTransformer(nn.Module):
    def __init__(self, embed_dims: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window: int = 7,
                 patch_size: int = 4, mlp_ratio: float = 4.0, drop_path_rate: float = 0.3,
                 out_indices: Sequence[int] = (0, 1, 2, 3), patch_norm: bool = True,
                 time_dim: int = 1024, in_channels: int = 3):
        super().__init__()
        self.patch_size = patch_size
        self.depths = tuple(depths)
        self.out_indices = tuple(out_indices)
        self.out_channels = tuple(embed_dims * 2 ** s for s in self.out_indices)
        self.patch_embed = Conv(in_channels, embed_dims, patch_size, patch_size, padding="VALID")
        if patch_norm:
            self.patch_norm = nn.LayerNorm(embed_dims, eps=1e-5)
        self.time_mlp = TimeMLP(time_dim)
        dpr = np.linspace(0.0, drop_path_rate, sum(self.depths))
        block_idx = 0
        for stage, depth in enumerate(self.depths):
            dim = embed_dims * 2 ** stage
            self.add_module(f"stage{stage}_time", nn.Linear(time_dim, 2 * dim))
            for blk in range(depth):
                self.add_module(f"stage{stage}_block{blk}", SwinBlock(
                    dim, num_heads[stage], window, shift=0 if blk % 2 == 0 else window // 2,
                    mlp_ratio=mlp_ratio, drop_path=float(dpr[block_idx])))
                block_idx += 1
            if stage in self.out_indices:
                self.add_module(f"out_norm{stage}", nn.LayerNorm(dim, eps=1e-5))
            if stage < len(self.depths) - 1:
                self.add_module(f"downsample{stage}", PatchMerging(dim, dim * 2))

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, ...]:
        """x [B, H, W, 3] image; t [B] diffusion time (continuous)."""
        p = self.patch_size
        pad_h, pad_w = (-x.shape[1]) % p, (-x.shape[2]) % p
        if pad_h or pad_w:
            x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
        x = self.patch_embed(x)
        if hasattr(self, "patch_norm"):
            x = self.patch_norm(x)
        time = F.silu(self.time_mlp(t))
        outs = []
        for stage, depth in enumerate(self.depths):
            scale, shift = getattr(self, f"stage{stage}_time")(time)[:, None, None].chunk(2, -1)
            for blk in range(depth):
                x = getattr(self, f"stage{stage}_block{blk}")(x, generator)
                x = x * (scale + 1.0) + shift
            if stage in self.out_indices:
                outs.append(getattr(self, f"out_norm{stage}")(x))
            if stage < len(self.depths) - 1:
                x = getattr(self, f"downsample{stage}")(x)
        return tuple(outs)
