"""Sparse 3-D convolution of the lidar branch (port of
``ddp_tpu/nn/sparse_conv.py:28-106,159-203``): gather-GEMM over host-built
rulebooks.

The host (``ddp_tpu_torch/native``) builds, per sample and with static
capacities, one rulebook per resolution level: ``gather[k, o]`` is the one
input voxel that feeds output ``o`` through kernel offset ``k``, or -1. On the
device a layer is one padded gather and one ``[V_out, K·Cin] x [K·Cin, Cout]``
product (``sparse_conv_gather_gemm``), a BatchNorm over the active rows only
(``MaskedBatchNorm``) and a ReLU; ``densify`` scatters the last level's rows
into the dense BEV grid.

``sparse_conv_gather_gemm`` is a ``torch.autograd.Function`` in the form the
card needs:
  - memory: it saves only the features, the rulebook and the weight, not the
    gathered ``[V_out, K·Cin]`` matrix (about 1.6 GB a scene over the 12
    layers at nuScenes capacities); the backward gathers again for the
    weight's gradient;
  - determinism: the features' gradient is a gather-GEMM over the
    transposed rulebook ``inv[k, i] = o`` (where ``gather[k, o] = i``), not
    the atomic scatter-add of a gather's backward. ``o`` is unique for each
    ``(k, i)`` under every subm, strided and ``down`` rulebook (an input cell
    reaches at most one output cell through one offset), so ``inv`` is built
    on the device by one scatter of unique indices (``transpose_rulebook``).
No float atomics in either pass, and no host read, so a CUDA graph captures
it. ``sparse_conv_gather_gemm_plain`` (``padded[idx]`` and an ``einsum``
under autograd) is the plain version the tests hold it to.

As in the JAX package this is plain tensor code, not a Pallas kernel: the
JAX function is XLA's gather and ``einsum``.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def _gather_rows(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """x [V, C] and a rulebook [K, V'] (-1 = none) -> [V', K·C]: row o holds
    x[index[k, o]] for k = 0..K-1 (zeros where -1)."""
    v, c = x.shape
    padded = torch.cat([x, x.new_zeros(1, c)])
    idx = torch.where(index < 0, v, index).t().reshape(-1)
    return padded.index_select(0, idx).reshape(index.shape[1], index.shape[0] * c)


def transpose_rulebook(gather: torch.Tensor, v_in: int) -> torch.Tensor:
    """gather [K, V_out] (input rows, -1 = none) -> inv [K, v_in] int32 with
    inv[k, i] = o where gather[k, o] = i, else -1. One scatter of unique
    positions: entry (k, o) goes to k·v_in + gather[k, o], or, where it is
    -1, to a dump slot of its own past the K·v_in that are kept."""
    k, v_out = gather.shape
    dev = gather.device
    o = torch.arange(v_out, device=dev, dtype=torch.int32).expand(k, v_out)
    row = torch.arange(k, device=dev, dtype=torch.int64)[:, None]
    pos = torch.where(gather >= 0, row * v_in + gather,
                      k * v_in + row * v_out + o.to(torch.int64))
    inv = torch.full((k * (v_in + v_out),), -1, dtype=torch.int32, device=dev)
    inv.scatter_(0, pos.reshape(-1), o.reshape(-1))
    return inv[:k * v_in].reshape(k, v_in)


class _GatherGemm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feats, gather, weight):
        ctx.save_for_backward(feats, gather, weight)
        k, cin, cout = weight.shape
        return _gather_rows(feats, gather) @ weight.reshape(k * cin, cout)

    @staticmethod
    def backward(ctx, grad):
        feats, gather, weight = ctx.saved_tensors
        k, cin, cout = weight.shape
        dfeats = dweight = None
        if ctx.needs_input_grad[2]:
            dweight = (_gather_rows(feats, gather).t() @ grad).reshape(k, cin, cout)
        if ctx.needs_input_grad[0]:
            inv = transpose_rulebook(gather, feats.shape[0])
            dfeats = _gather_rows(grad, inv) @ weight.transpose(1, 2).reshape(k * cout, cin)
        return dfeats, None, dweight


def sparse_conv_gather_gemm(feats: torch.Tensor, gather: torch.Tensor,
                            weight: torch.Tensor) -> torch.Tensor:
    """out[o] = sum_k feats[gather[k, o]] @ weight[k] (a missing -1 adds 0):
    feats [V_in, Cin], gather [K, V_out] int, weight [K, Cin, Cout] -> [V_out,
    Cout] in the features' type (a bf16 product accumulates in float32)."""
    return _GatherGemm.apply(feats, gather, weight)


def sparse_conv_gather_gemm_plain(feats: torch.Tensor, gather: torch.Tensor,
                                  weight: torch.Tensor) -> torch.Tensor:
    """The plain version: the padded gather [K, V_out, Cin] and an einsum in
    float32 under autograd (JAX's form); tests only."""
    v_in = feats.shape[0]
    padded = torch.cat([feats, feats.new_zeros(1, feats.shape[1])])
    g = padded[torch.where(gather < 0, v_in, gather).long()]
    return torch.einsum("kvc,kcd->vd", g.float(), weight.float()).to(feats.dtype)


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d over the active rows of a padded [V, C] voxel tensor, as
    the reference's spconv tensors hold only active voxels. flax's names and
    update: parameters ``scale`` and ``bias``, buffers ``mean`` and ``var``;
    in training the statistics are the float32 mean and the biased variance
    over the rows where ``mask`` is set, and the running update is ``0.99 ·
    old + 0.01 · new`` (biased variance too); eps 1e-3. ``(x − mean) ·
    rsqrt(var + eps)`` is computed in x's type (bf16 under the mixed-precision
    policy), after float32 statistics."""

    MOMENTUM = 0.99
    EPS = 1e-3

    def __init__(self, channels: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if self.training:
            w = mask.float()[:, None]
            n = torch.clamp(w.sum(), min=1.0)
            xf = x.float()
            mean = (xf * w).sum(dim=0) / n
            var = ((xf - mean) ** 2 * w).sum(dim=0) / n
            with torch.no_grad():
                m = self.MOMENTUM
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        y = (x - mean.to(x.dtype)) * torch.rsqrt(var + self.EPS).to(x.dtype)
        return y * self.scale + self.bias


class SparseConvLayer(nn.Module):
    """Sparse conv -> BN1d over the active rows -> ReLU; rows that no offset
    feeds (padding) stay exactly 0. ``kernel`` [K, Cin, Cout] and ``bn`` carry
    the flax names."""

    def __init__(self, in_channels: int, out_channels: int, num_offsets: int = 27,
                 use_act: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(num_offsets, in_channels, out_channels))
        self.bn = MaskedBatchNorm(out_channels)
        self.use_act = use_act

    def forward(self, feats: torch.Tensor, gather: torch.Tensor) -> torch.Tensor:
        y = sparse_conv_gather_gemm(feats, gather, self.kernel)
        # a row is an active output site iff an offset feeds it (a subm
        # rulebook always holds the centre offset of an active site)
        active = (gather >= 0).any(dim=0)
        y = self.bn(y, active)
        if self.use_act:
            y = F.relu(y)
        # BN's bias would leak into the padding rows, which strided levels
        # may gather
        return y * active[:, None].to(y.dtype)


def densify(rows: torch.Tensor, coords: torch.Tensor, valid: torch.Tensor, batch: int,
            hw: int, z: int) -> torch.Tensor:
    """Rows [B·cap, C] at coords [B·cap, 3] (x, y, z cells) of their sample
    (row r in sample r // cap) -> the dense BEV [B, hw, hw, z·C]: cell (x, y)
    of sample b holds channels zc·C + c, as JAX's flat index ((b·hw + x)·hw +
    y)·z + zc lays them out. Valid rows go to unique cells, every other row to
    a dump slot of its own, so the scatter (``index_copy``) and its backward
    (a gather) are deterministic."""
    n, c = rows.shape
    cap = n // batch
    total = batch * hw * hw * z
    coords = coords.long()
    row = torch.arange(n, device=rows.device)
    flat = (((row // cap) * hw + coords[:, 0]) * hw + coords[:, 1]) * z + coords[:, 2]
    flat = torch.where(valid, flat, total + row)
    dense = rows.new_zeros(total + n, c).index_copy(0, flat, rows)
    return dense[:total].reshape(batch, hw, hw, z * c)


def build_sparse_encoder_rulebooks(
    coords: np.ndarray, n_voxels: int, sparse_shape=(1024, 1024, 41),
    caps: Sequence[int] = (120_000, 60_000, 30_000, 15_000, 15_000),
) -> Dict[str, np.ndarray]:
    """Host side: every rulebook of one sample's encoder pass. coords
    [cap0, 3] int32 (x, y, z), rows from ``n_voxels`` on ignored; ``caps``:
    the static capacities of the levels (full, /2, /4, /8, down). Returns
    subm1, spconv2, subm2, spconv3, subm3, spconv4, subm4 and down (gather
    arrays [K, cap]), down_coords [cap4, 3] and down_valid [cap4] bool."""
    from .. import native

    shape = np.asarray(sparse_shape, np.int64)
    out = {}
    cur_coords, cur_n = coords, n_voxels
    out["subm1"] = native.build_subm_rulebook(cur_coords, cur_n, caps[0])
    for si in range(1, 4):
        oc, g, n_out = native.build_sparse_rulebook(
            cur_coords, cur_n, tuple(shape), kernel=(3, 3, 3) if si == 3 else 3,
            stride=(2, 2, 2) if si == 3 else 2, pad=(1, 1, 0) if si == 3 else 1,
            cap=caps[si])
        out[f"spconv{si + 1}"] = g
        out[f"subm{si + 1}"] = native.build_subm_rulebook(oc, n_out, caps[si])
        cur_coords, cur_n = oc, n_out
        if si == 3:
            shape = (shape + 2 * np.asarray((1, 1, 0)) - 3) // 2 + 1
        else:
            shape = (shape + 2 - 3) // 2 + 1
    # conv_out: kernel (1, 1, 3), stride (1, 1, 2), no padding
    oc, g, n_out = native.build_sparse_rulebook(
        cur_coords, cur_n, tuple(shape), kernel=(1, 1, 3), stride=(1, 1, 2), pad=(0, 0, 0),
        cap=caps[4])
    out["down"] = g
    out["down_coords"] = oc
    valid = np.zeros(caps[4], bool)
    valid[:n_out] = True
    out["down_valid"] = valid
    return out


def mean_voxel_features(voxels: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """The hard voxelizer's mean reduce: [V, P, F] and counts [V] -> [V, F]
    float32 (the reference's bevfusion.py 'mean' mode)."""
    s = voxels.sum(axis=1)
    return (s / np.maximum(counts[:, None], 1)).astype(np.float32)
