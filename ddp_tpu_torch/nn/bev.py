"""BEV (bird's-eye-view) modules (port of ``ddp_tpu/nn/bev.py``).

  - ``frustum_grid`` / ``lss_geometry``: the image frustum's (x_px, y_px,
    depth) points unprojected into the lidar frame through the rig
    (vtransforms/base.py:53-122), in float32 whatever the policy.
  - ``LSSTransform``: depthnet 1x1 conv -> depth softmax ⊗ features (optionally
    only the top-k depth bins, renormalised) -> voxel indices -> ``bev_pool``
    -> three 3x3 convs (strides 1, 2, 1) with BatchNorm and ReLU (the
    reference's downsample 2, the only one its configs use).
  - ``DepthLSSTransform``: the same lift and splat after a depth net that
    also reads the lidar depth canvas (``ddp_tpu/nn/bev.py:286-373``).
  - ``GeneralizedLSSFPN``: the camera neck, top-down concat-then-conv FPN
    (bilinear, align_corners=False).
  - ``BasicBlock`` / ``GeneralizedResNet``: BasicBlock stages over the BEV.
  - ``LSSFPN``: fuse the last and first stages, then x2 (align_corners=True).
  - ``bev_grid_transform``: the axis-aligned resample between metric scopes
    as two 1-D bilinear interpolations with zero padding (the JAX package's
    form of the reference's ``grid_sample``; ``F.grid_sample``'s CUDA backward
    has no deterministic algorithm).

Tensors are NHWC at module boundaries (convs permute inside). Flax's
``SAME`` padding of a strided conv is asymmetric (the extra row and column
go after), so the stride-2 3x3 convs pad explicitly (``Conv2dSame``).
Every module carries the flax names, so ``convert.py`` maps JAX weights.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import device_constant
from ..ops.bev_pool import bev_pool, quantize_geometry
from ..ops.resize import resize
from .common import BatchNorm2d, Conv2dSame, ConvModule


def frustum_grid(image_size, feature_size, dbound) -> np.ndarray:
    """[D, fH, fW, 3] (x_px, y_px, depth) frustum (vtransforms/base.py:53-76)."""
    ih, iw = image_size
    fh, fw = feature_size
    ds = np.arange(dbound[0], dbound[1], dbound[2], dtype=np.float32)
    f = np.zeros((len(ds), fh, fw, 3), np.float32)
    f[..., 0] = np.linspace(0, iw - 1, fw, dtype=np.float32)[None, None, :]
    f[..., 1] = np.linspace(0, ih - 1, fh, dtype=np.float32)[None, :, None]
    f[..., 2] = ds[:, None, None]
    return f


# constant tensors on the device, copied there once per shape: a copy from
# the host cannot be captured into a CUDA graph (train/step.py)
@device_constant(maxsize=16)
def _frustum_on(image_size, feature_size, dbound, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(frustum_grid(image_size, feature_size, dbound), device=device)


def _inv(m: torch.Tensor) -> torch.Tensor:
    """The inverse of each 3x3 matrix by LU, as ``jnp.linalg.inv``.
    ``torch.linalg.inv`` checks its LU's info on the host (a read that
    breaks a CUDA-graph capture); ``inv_ex`` is the same factorisation
    without that check (a singular rig gives inf/nan, as in JAX)."""
    return torch.linalg.inv_ex(m).inverse


def lss_geometry(frustum: torch.Tensor, camera2lidar_rots: torch.Tensor,
                 camera2lidar_trans: torch.Tensor, intrins: torch.Tensor,
                 post_rots: torch.Tensor, post_trans: torch.Tensor) -> torch.Tensor:
    """Unproject the frustum [D, fH, fW, 3] into the lidar frame
    (vtransforms/base.py:79-122): rig [B, N, 3, 3] / [B, N, 3] -> points
    [B, N, D, fH, fW, 3] in the frustum's type. The geometry is float32
    whatever the rig's type (a bf16 rig is cast back, as in JAX)."""
    f32 = torch.float32
    pts = frustum.to(f32)[None, None] - post_trans.to(f32)[:, :, None, None, None, :]
    pts = torch.einsum("bnij,bndhwj->bndhwi", _inv(post_rots.to(f32)), pts)
    # (u·d, v·d, d) before unprojection through the intrinsics
    pts = torch.cat([pts[..., :2] * pts[..., 2:3], pts[..., 2:3]], dim=-1)
    combine = torch.einsum("bnij,bnjk->bnik", camera2lidar_rots.to(f32), _inv(intrins.to(f32)))
    pts = torch.einsum("bnij,bndhwj->bndhwi", combine, pts)
    out = pts + camera2lidar_trans.to(f32)[:, :, None, None, None, :]
    return out.to(frustum.dtype)


def _grid(bounds):
    """(cells per axis, cell size, first cell's centre) of x/y/z bounds."""
    nx = [int(round((b[1] - b[0]) / b[2])) for b in bounds]
    dx = [b[2] for b in bounds]
    bx = [b[0] + b[2] / 2.0 for b in bounds]
    return nx, dx, bx


class _LiftSplat(nn.Module):
    """What both LSS view transforms share: the voxel grid, the softmax depth
    ⊗ features lift (optionally only the top-k depth bins, renormalised),
    ``bev_pool`` and the three 3x3 convs (strides 1, 2, 1) with BatchNorm
    and ReLU (the reference's downsample 2, the only one its configs use).
    A subclass registers its depth net, then calls ``_add_down``."""

    def __init__(self, out_channels, image_size, feature_size, xbound, ybound, zbound, dbound,
                 depth_topk: int = 0):
        super().__init__()
        self.out_channels = out_channels
        self.image_size = tuple(image_size)
        self.feature_size = tuple(feature_size)
        self.dbound = tuple(dbound)
        self.depth_topk = depth_topk
        self.depth_bins = int(round((dbound[1] - dbound[0]) / dbound[2]))
        self.nx, self.dx, self.bx = _grid((xbound, ybound, zbound))

    def _add_down(self) -> None:
        ch = self.out_channels
        for i, stride in enumerate((1, 2, 1)):
            self.add_module(f"down{i}", Conv2dSame(ch * (self.nx[2] if i == 0 else 1), ch, 3,
                                                   stride))
            self.add_module(f"down_bn{i}", BatchNorm2d(ch, eps=1e-5))

    def splat(self, x: torch.Tensor, camera2lidar_rots, camera2lidar_trans, intrins,
              post_rots, post_trans) -> torch.Tensor:
        """The depth net's output [B, N, fH, fW, D + C] -> BEV features
        [B, X/2, Y/2, C]."""
        b, n, fh, fw, _ = x.shape
        d, ch = self.depth_bins, self.out_channels
        depth = torch.softmax(x[..., :d], dim=-1)  # [B, N, fH, fW, D]
        feat = x[..., d:]
        frustum = _frustum_on(self.image_size, self.feature_size, self.dbound, x.device)
        geom = lss_geometry(frustum, camera2lidar_rots, camera2lidar_trans, intrins,
                            post_rots, post_trans)  # [B, N, D, fH, fW, 3]
        k = self.depth_topk
        if k and k < d:
            # the k most likely bins per pixel, renormalised so that the
            # pooled feature magnitude is kept
            topv, topi = torch.topk(depth, k, dim=-1)
            topv = topv / torch.clamp(topv.sum(dim=-1, keepdim=True), min=1e-6)
            cam = topv.permute(0, 1, 4, 2, 3)[..., None] * feat[:, :, None]
            idx = topi.permute(0, 1, 4, 2, 3)[..., None].expand(b, n, k, fh, fw, 3)
            geom = torch.gather(geom, 2, idx)
            d_eff = k
        else:
            # the outer product, laid out [B, N, D, fH, fW, C]
            cam = depth.permute(0, 1, 4, 2, 3)[..., None] * feat[:, :, None]
            d_eff = d
        coords, valid = quantize_geometry(geom, self.bx, self.dx, self.nx)
        p = n * d_eff * fh * fw
        y = bev_pool(cam.reshape(b, p, ch), coords.reshape(b, p, 3), valid.reshape(b, p),
                     *self.nx).permute(0, 3, 1, 2)  # [B, nz·C, nx, ny]
        for i in range(3):
            y = F.relu(getattr(self, f"down_bn{i}")(getattr(self, f"down{i}")(y)))
        return y.permute(0, 2, 3, 1)


class LSSTransform(_LiftSplat):
    """Lift-Splat-Shoot camera -> BEV view transform: a 1x1 depth net, then
    ``splat``. ``depth_topk`` > 0 keeps the k most likely depth bins of each
    pixel, renormalised (0: all bins, the reference's behaviour)."""

    def __init__(self, in_channels: int, out_channels: int = 80,
                 image_size: Tuple[int, int] = (256, 704),
                 feature_size: Tuple[int, int] = (32, 88),
                 xbound=(-51.2, 51.2, 0.4), ybound=(-51.2, 51.2, 0.4),
                 zbound=(-10.0, 10.0, 20.0), dbound=(1.0, 60.0, 0.5),
                 depth_topk: int = 0):
        super().__init__(out_channels, image_size, feature_size, xbound, ybound, zbound, dbound,
                         depth_topk)
        self.depthnet = nn.Conv2d(in_channels, self.depth_bins + out_channels, 1)
        self._add_down()

    def forward(self, feats: torch.Tensor, camera2lidar_rots, camera2lidar_trans, intrins,
                post_rots, post_trans) -> torch.Tensor:
        """feats [B, N, fH, fW, C] -> BEV features [B, X/2, Y/2, C']."""
        b, n, fh, fw, c = feats.shape
        x = self.depthnet(feats.reshape(b * n, fh, fw, c).permute(0, 3, 1, 2))
        x = x.permute(0, 2, 3, 1).reshape(b, n, fh, fw, -1)
        return self.splat(x, camera2lidar_rots, camera2lidar_trans, intrins, post_rots,
                          post_trans)


class DepthLSSTransform(_LiftSplat):
    """Lidar-guided LSS (the reference's vtransforms/depth_lss.py:15-124; JAX
    ``ddp_tpu/nn/bev.py:286-373``): a sparse per-pixel lidar depth canvas at
    image resolution (``data/bev_datasets.py: rasterize_lidar_depth``) is
    encoded by ``dtransform`` (1->8 1x1, 8->32 5x5/4, 32->64 5x5/2, each
    with BatchNorm and ReLU: /8 to the feature grid), concatenated before
    the camera features, and a depth net of two 3x3 convs with BatchNorm and
    ReLU and a 1x1 conv gives D + C channels; then ``splat``. Defaults:
    BEVFusion's ``depth_lss`` (256x704 images, 32x88 features, 118 bins over
    ``dbound`` (1, 60, 0.5), 80 channels, a 256² grid over ±51.2 m)."""

    def __init__(self, in_channels: int, out_channels: int = 80,
                 image_size: Tuple[int, int] = (256, 704),
                 feature_size: Tuple[int, int] = (32, 88),
                 xbound=(-51.2, 51.2, 0.4), ybound=(-51.2, 51.2, 0.4),
                 zbound=(-10.0, 10.0, 20.0), dbound=(1.0, 60.0, 0.5)):
        super().__init__(out_channels, image_size, feature_size, xbound, ybound, zbound, dbound)
        cin = 1
        for i, (f, k, s) in enumerate(((8, 1, 1), (32, 5, 4), (64, 5, 2))):
            self.add_module(f"dtransform{i}", Conv2dSame(cin, f, k, s, bias=True))
            self.add_module(f"dtransform_bn{i}", BatchNorm2d(f, eps=1e-5))
            cin = f
        c = in_channels
        for i in range(2):
            self.add_module(f"depthnet{i}", Conv2dSame(cin + c if i == 0 else c, c, 3,
                                                       bias=True))
            self.add_module(f"depthnet_bn{i}", BatchNorm2d(c, eps=1e-5))
        self.depthnet_out = nn.Conv2d(c, self.depth_bins + out_channels, 1)
        self._add_down()

    def forward(self, feats: torch.Tensor, depth_canvas: torch.Tensor, camera2lidar_rots,
                camera2lidar_trans, intrins, post_rots, post_trans) -> torch.Tensor:
        """feats [B, N, fH, fW, C], depth_canvas [B, N, H, W, 1] -> BEV
        features [B, X/2, Y/2, C']."""
        b, n, fh, fw, c = feats.shape
        dc = depth_canvas.reshape((b * n,) + depth_canvas.shape[2:]).permute(0, 3, 1, 2)
        for i in range(3):
            dc = F.relu(getattr(self, f"dtransform_bn{i}")(getattr(self, f"dtransform{i}")(dc)))
        x = torch.cat([dc, feats.reshape(b * n, fh, fw, c).permute(0, 3, 1, 2)], dim=1)
        for i in range(2):
            x = F.relu(getattr(self, f"depthnet_bn{i}")(getattr(self, f"depthnet{i}")(x)))
        x = self.depthnet_out(x).permute(0, 2, 3, 1).reshape(b, n, fh, fw, -1)
        return self.splat(x, camera2lidar_rots, camera2lidar_trans, intrins, post_rots,
                          post_trans)


class GeneralizedLSSFPN(nn.Module):
    """Concat-then-conv top-down FPN (the camera neck; bilinear upsampling,
    align_corners=False, as DDP's config sets it). ``in_channels``: the
    channels of each input level; returns len(inputs) − 1 levels."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256):
        super().__init__()
        n = len(in_channels) - 1
        for i in range(n):
            above = in_channels[i + 1] if i == n - 1 else out_channels
            self.add_module(f"lateral{i}", ConvModule(in_channels[i] + above, out_channels,
                                                      (1, 1), norm="BN", act="relu"))
            self.add_module(f"fpn{i}", ConvModule(out_channels, out_channels, (3, 3),
                                                  norm="BN", act="relu"))
        self.levels = n

    def forward(self, inputs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        laterals = list(inputs)
        outs: List[torch.Tensor] = [None] * self.levels
        for i in range(self.levels - 1, -1, -1):
            h, w = laterals[i].shape[1:3]
            up = resize(laterals[i + 1], (h, w), mode="bilinear")
            y = getattr(self, f"lateral{i}")(torch.cat([laterals[i], up], dim=-1))
            y = getattr(self, f"fpn{i}")(y)
            laterals[i] = outs[i] = y
        return tuple(outs)


class BasicBlock(nn.Module):
    """3x3 conv-BN-ReLU, 3x3 conv-BN, plus the (1x1 conv-BN projected)
    identity, ReLU. NHWC in and out."""

    def __init__(self, in_channels: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2dSame(in_channels, features, 3, stride)
        self.bn1 = BatchNorm2d(features, eps=1e-5)
        self.conv2 = Conv2dSame(features, features, 3)
        self.bn2 = BatchNorm2d(features, eps=1e-5)
        self.project = stride != 1 or in_channels != features
        if self.project:
            self.down_conv = Conv2dSame(in_channels, features, 1, stride)
            self.down_bn = BatchNorm2d(features, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        identity = self.down_bn(self.down_conv(x)) if self.project else x
        return F.relu(y + identity).permute(0, 2, 3, 1)


class GeneralizedResNet(nn.Module):
    """BasicBlock stages (blocks, channels, stride) over the BEV grid; returns
    every stage's output."""

    def __init__(self, in_channels: int,
                 blocks: Sequence[Tuple[int, int, int]] = ((2, 160, 2), (2, 320, 2),
                                                           (2, 640, 1))):
        super().__init__()
        self.blocks = tuple(tuple(b) for b in blocks)
        ch = in_channels
        for si, (num, out, stride) in enumerate(self.blocks):
            for bi in range(num):
                self.add_module(f"stage{si}_block{bi}",
                                BasicBlock(ch, out, stride if bi == 0 else 1))
                ch = out

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        outs = []
        for si, (num, _, _) in enumerate(self.blocks):
            for bi in range(num):
                x = getattr(self, f"stage{si}_block{bi}")(x)
            outs.append(x)
        return outs


class LSSFPN(nn.Module):
    """Fuse the last BEV level, resized to the first (align_corners=True),
    with the first by 1x1 and 3x3 ConvModules, then x2 and a 3x3
    ConvModule. ``in_channels``: the last and the first level's channels."""

    def __init__(self, in_channels: Tuple[int, int], out_channels: int = 256):
        super().__init__()
        self.fuse1 = ConvModule(sum(in_channels), out_channels, (1, 1), norm="BN", act="relu")
        self.fuse2 = ConvModule(out_channels, out_channels, (3, 3), norm="BN", act="relu")
        self.up = ConvModule(out_channels, out_channels, (3, 3), norm="BN", act="relu")

    def forward(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        h, w = xs[0].shape[1:3]
        x1 = resize(xs[-1], (h, w), mode="bilinear", align_corners=True)
        x = self.fuse2(self.fuse1(torch.cat([x1, xs[0]], dim=-1)))
        return self.up(resize(x, (2 * h, 2 * w), mode="bilinear", align_corners=True))


def _axis_weights(iscope, oscope, size_in: int):
    """One axis of ``bev_grid_transform``: source indices (lo, hi, clipped),
    lerp weight t and the zero-padding masks of lo and hi, in numpy as the
    JAX package computes them (float64, then float32)."""
    omin, omax, ostep = oscope
    imin, imax, _ = iscope
    v = np.arange(omin + ostep / 2.0, omax, ostep, dtype=np.float64)
    g = (v - imin) / (imax - imin) * 2.0 - 1.0  # normalised [-1, 1]
    src = ((g + 1.0) * size_in - 1.0) / 2.0  # align_corners=False
    lo = np.floor(src).astype(np.int64)
    t = (src - lo).astype(np.float32)
    lo_ok = ((lo >= 0) & (lo < size_in)).astype(np.float32)
    hi_ok = ((lo + 1 >= 0) & (lo + 1 < size_in)).astype(np.float32)
    return (np.clip(lo, 0, size_in - 1), np.clip(lo + 1, 0, size_in - 1), t, lo_ok, hi_ok)


@device_constant(maxsize=32)
def _axis_weights_on(iscope, oscope, size_in: int, device: torch.device):
    lo, hi, t, lo_ok, hi_ok = (torch.as_tensor(a, device=device)
                               for a in _axis_weights(iscope, oscope, size_in))
    return lo, hi, t, 1.0 - t, lo_ok, hi_ok


def _as_scope(scope):
    return tuple(tuple(float(v) for v in axis) for axis in scope)


def bev_grid_transform(x: torch.Tensor, input_scope, output_scope) -> torch.Tensor:
    """Resample [B, H, W, C] between metric BEV scopes (rows: scope[0],
    columns: scope[1]): ``grid_sample(align_corners=False)`` with zero
    padding on an axis-aligned grid, as two 1-D bilinear interpolations.
    The result is float32 for a bf16 input (the weights are float32, as in
    JAX)."""
    h, w = x.shape[1:3]
    iscope, oscope = _as_scope(input_scope), _as_scope(output_scope)
    rlo, rhi, rt, r1t, rlo_ok, rhi_ok = _axis_weights_on(iscope[0], oscope[0], h, x.device)
    clo, chi, ct, c1t, clo_ok, chi_ok = _axis_weights_on(iscope[1], oscope[1], w, x.device)
    top = x.index_select(1, rlo) * rlo_ok[None, :, None, None]
    bot = x.index_select(1, rhi) * rhi_ok[None, :, None, None]
    x = top * r1t[None, :, None, None] + bot * rt[None, :, None, None]
    left = x.index_select(2, clo) * clo_ok[None, None, :, None]
    right = x.index_select(2, chi) * chi_ok[None, None, :, None]
    return left * c1t[None, None, :, None] + right * ct[None, None, :, None]
