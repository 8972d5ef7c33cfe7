"""SECOND and PointPillars pieces of the lidar branch (port of
``ddp_tpu/nn/second.py:25-147``; the reference's mmdet3d
``backbones/second.py``, ``necks/second.py`` and
``backbones/pillar_encoder.py``).

  - ``SECOND``: per stage a strided 3x3 conv and ``layer_nums`` 3x3 convs,
    each with BatchNorm and ReLU; returns every stage's map.
  - ``SECONDFPN``: each stage brought to one grid by a transposed conv
    (stride > 1, flax ``ConvTranspose``: ``convert.py`` reverses its taps)
    or a strided conv (stride ≤ 1), BatchNorm, ReLU, then concatenated.
  - ``PillarFeatureNet``: each pillar's points decorated with their offsets
    from the pillar's mean and cell centre, then Linear -> BatchNorm -> ReLU
    -> a max over the real points (padded points masked to −inf first; an
    empty pillar gives 0).
  - ``point_pillars_scatter``: pillar features onto the dense BEV canvas.

BatchNorm is flax's with momentum 0.99 (torch ``momentum`` 0.01) and eps
1e-3. Maps are NHWC at the boundaries, as in JAX; the convs run on a
contiguous NCHW copy. Every module carries the flax names.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .common import BatchNorm2d, Conv2dSame, TokenBatchNorm

BN_EPS = 1e-3
BN_MOMENTUM = 0.01  # flax's 0.99


def _bn(channels: int) -> BatchNorm2d:
    return BatchNorm2d(channels, eps=BN_EPS, momentum=BN_MOMENTUM)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


class SECOND(nn.Module):
    """Multi-stage 2-D conv backbone over BEV features [B, H, W, C]."""

    def __init__(self, in_channels: int, out_channels: Sequence[int] = (128, 128, 256),
                 layer_nums: Sequence[int] = (3, 5, 5), layer_strides: Sequence[int] = (2, 2, 2)):
        super().__init__()
        self.stages = tuple(zip(out_channels, layer_nums, layer_strides))
        cin = in_channels
        for i, (ch, n, s) in enumerate(self.stages):
            for j in range(n + 1):
                self.add_module(f"s{i}_conv{j}", nn.Conv2d(cin if j == 0 else ch, ch, 3,
                                                           stride=s if j == 0 else 1,
                                                           padding=1, bias=False))
                self.add_module(f"s{i}_bn{j}", _bn(ch))
            cin = ch

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = _nchw(x)
        outs = []
        for i, (_, n, _) in enumerate(self.stages):
            for j in range(n + 1):
                x = F.relu(getattr(self, f"s{i}_bn{j}")(getattr(self, f"s{i}_conv{j}")(x)))
            outs.append(x.permute(0, 2, 3, 1))
        return tuple(outs)


class SECONDFPN(nn.Module):
    """Each level to a common grid (transposed conv k = s for a stride > 1,
    else a conv with kernel and stride round(1/s)), BatchNorm, ReLU; the
    levels concatenated on channels. NHWC in and out."""

    def __init__(self, in_channels: Sequence[int], out_channels: Sequence[int] = (256, 256, 256),
                 upsample_strides: Sequence[float] = (1, 2, 4)):
        super().__init__()
        if not len(in_channels) == len(out_channels) == len(upsample_strides):
            raise ValueError("in_channels, out_channels and upsample_strides differ in length")
        self.strides = tuple(upsample_strides)
        for i, (cin, ch, s) in enumerate(zip(in_channels, out_channels, self.strides)):
            if s > 1:
                self.add_module(f"deconv{i}", nn.ConvTranspose2d(cin, ch, int(s), int(s),
                                                                 bias=False))
            else:
                k = int(round(1.0 / s)) if s < 1 else 1
                self.add_module(f"conv{i}", Conv2dSame(cin, ch, k, k))
            self.add_module(f"bn{i}", _bn(ch))

    def forward(self, feats: Sequence[torch.Tensor]) -> torch.Tensor:
        if len(feats) != len(self.strides):
            raise ValueError(f"{len(feats)} levels for {len(self.strides)} strides")
        outs = []
        for i, (x, s) in enumerate(zip(feats, self.strides)):
            up = getattr(self, f"deconv{i}" if s > 1 else f"conv{i}")
            outs.append(F.relu(getattr(self, f"bn{i}")(up(_nchw(x)))))
        return torch.cat(outs, dim=1).permute(0, 2, 3, 1)


class PillarFeatureNet(nn.Module):
    """Pillar points -> pillar features. ``feats`` [B, P, N, D] (xyz and
    extras, zero-padded), ``counts`` [B, P] real points per pillar, ``coords``
    [B, P, 2] int (ix, iy) -> [B, P, C]. The decoration is the points, their
    xyz minus the pillar's mean, and their xy minus the cell's centre (and
    their range with ``with_distance``); padded points are zeroed. Every
    layer but the last concatenates its max back onto each point. The
    BatchNorm counts every point slot, the padded ones too, as JAX's."""

    def __init__(self, in_channels: int, feat_channels: Sequence[int] = (64,),
                 voxel_size: Tuple[float, float] = (0.2, 0.2),
                 pc_range: Tuple[float, float] = (0.0, -40.0), with_distance: bool = False):
        super().__init__()
        if not feat_channels:
            raise ValueError("PillarFeatureNet needs at least one layer")
        self.voxel_size = tuple(voxel_size)
        self.pc_range = tuple(pc_range)
        self.with_distance = with_distance
        self.layers = len(feat_channels)
        cin = in_channels + 5 + int(with_distance)
        for i, ch in enumerate(feat_channels):
            units = ch if i == self.layers - 1 else ch // 2
            self.add_module(f"pfn{i}_linear", nn.Linear(cin, units, bias=False))
            self.add_module(f"pfn{i}_bn", TokenBatchNorm(units, eps=BN_EPS,
                                                         momentum=BN_MOMENTUM))
            cin = 2 * units

    def forward(self, feats: torch.Tensor, counts: torch.Tensor,
                coords: torch.Tensor) -> torch.Tensor:
        n = feats.shape[2]
        dtype = feats.dtype
        cnt = torch.clamp(counts, min=1).to(dtype)[..., None, None]
        xyz = feats[..., :3]
        f_cluster = xyz - xyz.sum(dim=2, keepdim=True) / cnt
        vx, vy = self.voxel_size
        cx = coords[..., 0:1].to(dtype) * vx + (vx / 2 + self.pc_range[0])
        cy = coords[..., 1:2].to(dtype) * vy + (vy / 2 + self.pc_range[1])
        f_center = torch.stack([feats[..., 0] - cx, feats[..., 1] - cy], dim=-1)
        parts = [feats, f_cluster, f_center]
        if self.with_distance:
            parts.append(torch.linalg.vector_norm(xyz, dim=-1, keepdim=True))
        mask = torch.arange(n, device=feats.device)[None, None, :] < counts[..., None]
        x = torch.cat(parts, dim=-1) * mask[..., None].to(dtype)
        for i in range(self.layers):
            x = F.relu(getattr(self, f"pfn{i}_bn")(getattr(self, f"pfn{i}_linear")(x)))
            xmax = torch.where(mask[..., None], x, float("-inf")).amax(dim=2)
            xmax = torch.where(torch.isfinite(xmax), xmax, 0.0)
            if i == self.layers - 1:
                return xmax
            x = torch.cat([x, xmax[:, :, None, :].expand_as(x)], dim=-1)


def point_pillars_scatter(pillar_feats: torch.Tensor, coords: torch.Tensor, valid: torch.Tensor,
                          nx: int, ny: int) -> torch.Tensor:
    """Pillar features [B, P, C] at ``coords`` [B, P, 2] (ix, iy) -> the
    dense canvas [B, ny, nx, C] (0 where no pillar lies). Each valid pillar
    has a cell of its own (JAX's segment sum adds one value per cell), so
    the valid rows are written with ``index_copy`` and every invalid row
    goes to a dump slot of its own: no float atomics, and the backward is
    a gather."""
    b, p, c = pillar_feats.shape
    cells = nx * ny
    row = torch.arange(b * p, device=pillar_feats.device)
    cell = (coords[..., 1].long() * nx + coords[..., 0].long()).reshape(-1) + (row // p) * cells
    flat = torch.where(valid.reshape(-1), cell, b * cells + row)
    canvas = pillar_feats.new_zeros(b * cells + b * p, c).index_copy(
        0, flat, pillar_feats.reshape(b * p, c))
    return canvas[:b * cells].reshape(b, ny, nx, c)
