"""Time-FiLM transformer encoder of the DDP denoising decoder
(port of ``ddp_tpu/nn/transformer.py:32-296``).

Two attention types: the mmcv ``MultiScaleDeformableAttention`` (``msda``,
the reference's own, with its ring offset-bias init) and the dense
shifted-window self-attention (``window``, the JAX package's presets). Three
layer variants (the reference's BaseTransformerLayer / V2 / V3):

  v1 - post-norm attn -> norm -> ffn -> norm, one trailing FiLM
       (time -> SiLU -> Linear(4C -> 2C); query·(scale+1)+shift).
  v2 - pre-norm: q += FiLM1(attn(norm1(q))); q += FiLM2(ffn(norm2(q))),
       with a Linear(4C -> 4C) time MLP chunked (s1, s2, sh1, sh2).
  v3 - post-norm like v1, with a FiLM after each norm.

Layout is batch-first [B, S, C], as in the JAX package.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.deform_attn import ms_deform_attn
from .common import Mlp
from .swin import shift_attn_mask, window_attention, window_partition, window_reverse

SpatialShapes = Sequence[Tuple[int, int]]


def offset_bias_init(num_heads: int, num_levels: int, num_points: int) -> np.ndarray:
    """mmcv's sampling-offset bias init: per head a unit vector on a ring at
    angle 2π·h/H, L∞-normalised, tiled over levels and scaled by
    (point index + 1). Flat [H·L·P·2] float32."""
    thetas = np.arange(num_heads, dtype=np.float64) * (2.0 * math.pi / num_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], axis=-1)  # [H, 2]
    grid = grid / np.abs(grid).max(axis=-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, num_levels, num_points, 1))
    for p in range(num_points):
        grid[:, :, p, :] *= p + 1
    return grid.reshape(-1).astype(np.float32)


def reference_points(spatial_shapes: SpatialShapes) -> np.ndarray:
    """Each token's normalised cell centre, (x, y), concatenated over the
    levels: [S, L, 2], the level axis broadcast (every token gets the same
    point on all levels, as in the reference's get_reference_points)."""
    pts = []
    for h, w in spatial_shapes:
        ys = (np.arange(h, dtype=np.float32) + 0.5) / h
        xs = (np.arange(w, dtype=np.float32) + 0.5) / w
        ref_y, ref_x = np.meshgrid(ys, xs, indexing="ij")
        pts.append(np.stack([ref_x.reshape(-1), ref_y.reshape(-1)], axis=-1))
    ref = np.concatenate(pts, axis=0)
    return np.tile(ref[:, None, :], (1, len(spatial_shapes), 1))


@functools.lru_cache(maxsize=64)
def _normalizer(spatial_shapes: Tuple[Tuple[int, int], ...], device: torch.device
                ) -> torch.Tensor:
    """Each level's (W, H) [L, 2], cached on the device (a copy from the host
    cannot be captured in a CUDA graph)."""
    return torch.tensor([[w, h] for h, w in spatial_shapes], dtype=torch.float32,
                        device=device)


class DeformableAttention(nn.Module):
    """Multi-scale deformable attention (1 level in every DDP config). The
    sampling offsets and weights come from ``query + query_pos``, the value
    from ``value`` (the layer passes the query without its position)."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8, num_levels: int = 1,
                 num_points: int = 4, residual: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.num_levels = num_levels
        self.num_points = num_points
        self.residual = residual
        n = num_heads * num_levels * num_points
        self.sampling_offsets = nn.Linear(embed_dims, 2 * n)
        self.attention_weights = nn.Linear(embed_dims, n)
        self.value_proj = nn.Linear(embed_dims, embed_dims)
        self.output_proj = nn.Linear(embed_dims, embed_dims)

    def offset_bias(self) -> torch.Tensor:
        """The ring init of ``sampling_offsets.bias`` (init_params_)."""
        return torch.from_numpy(offset_bias_init(self.num_heads, self.num_levels,
                                                 self.num_points))

    def forward(self, query: torch.Tensor, value: torch.Tensor,
                query_pos: Optional[torch.Tensor], ref_points: torch.Tensor,
                spatial_shapes: SpatialShapes) -> torch.Tensor:
        """query [B, Q, C]; value [B, S, C]; query_pos [Q, C] or [B, Q, C];
        ref_points [Q, L, 2] (static) or [B, Q, L, 2] (per batch), in the
        query's dtype. The offsets are in pixels of each level and divided by
        its (W, H) in the query's dtype, as in the JAX package."""
        b, nq, c = query.shape
        h, l, p = self.num_heads, self.num_levels, self.num_points
        identity = query
        if query_pos is not None:
            query = query + query_pos
        offsets = self.sampling_offsets(query).reshape(b, nq, h, l, p, 2)
        weights = self.attention_weights(query).reshape(b, nq, h, l * p)
        weights = torch.softmax(weights, dim=-1).reshape(b, nq, h, l, p)
        v = self.value_proj(value).reshape(b, value.shape[1], h, c // h)
        if ref_points.dim() == 3:
            refs = ref_points[None, :, None, :, None, :]
        else:
            refs = ref_points[:, :, None, :, None, :]
        normalizer = _normalizer(tuple(map(tuple, spatial_shapes)), query.device)
        loc = refs + offsets / normalizer.to(query.dtype)[None, None, None, :, None, :]
        out = self.output_proj(ms_deform_attn(v, spatial_shapes, loc, weights))
        return identity + out if self.residual else out


class WindowSelfAttention(nn.Module):
    """Dense shifted-window self-attention over the token grid, Swin-style
    partition/shift/mask, no relative bias (position comes from the sine
    embedding added to the query). The residual is added inside unless
    ``residual`` is False (v2 layers)."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8, window: int = 8,
                 shift: int = 0, residual: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.window = window
        self.shift = shift
        self.residual = residual
        self.qkv = nn.Linear(embed_dims, 3 * embed_dims)
        self.proj = nn.Linear(embed_dims, embed_dims)

    def forward(self, query: torch.Tensor, query_pos: Optional[torch.Tensor],
                hw: Tuple[int, int]) -> torch.Tensor:
        b, s, c = query.shape
        h, w = hw
        identity = query
        if query_pos is not None:
            query = query + query_pos
        x = query.reshape(b, h, w, c)
        win = self.window
        pad_h, pad_w = (-h) % win, (-w) % win
        hp, wp = h + pad_h, w + pad_w
        shift = self.shift if min(hp, wp) > win else 0
        if pad_h or pad_w:
            x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
        if shift:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
        mask = shift_attn_mask(hp, wp, win, shift, query.device)
        y = self.proj(window_attention(self.qkv(window_partition(x, win)),
                                       self.num_heads, None, mask))
        y = window_reverse(y, win, hp, wp)
        if shift:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        if pad_h or pad_w:
            y = y[:, :h, :w]
        y = y.reshape(b, s, c)
        return identity + y if self.residual else y


class TimeFiLMEncoderLayer(nn.Module):
    """DETR encoder layer with FiLM time modulation, v1, v2 or v3 (module
    docstring)."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8, num_levels: int = 1,
                 num_points: int = 4, ffn_dim: int = 1024, use_time: bool = True,
                 attn_type: str = "window", window: int = 8, shift: int = 0,
                 film: str = "v1"):
        super().__init__()
        if attn_type not in ("msda", "window"):
            raise ValueError(f"attn_type must be 'msda' or 'window', got {attn_type!r}")
        if film not in ("v1", "v2", "v3"):
            raise ValueError(f"film must be 'v1', 'v2' or 'v3', got {film!r}")
        self.use_time = use_time
        self.attn_type = attn_type
        self.film = film
        residual = film != "v2"  # v2 adds its FiLMed attention output itself
        if attn_type == "window":
            self.attn = WindowSelfAttention(embed_dims, num_heads, window, shift, residual)
        else:
            self.attn = DeformableAttention(embed_dims, num_heads, num_levels, num_points,
                                            residual)
        self.norm1 = nn.LayerNorm(embed_dims, eps=1e-5)
        self.ffn = Mlp(embed_dims, ffn_dim, embed_dims)
        self.norm2 = nn.LayerNorm(embed_dims, eps=1e-5)
        if use_time:
            self.time_mlp = nn.Linear(embed_dims * 4, embed_dims * (2 if film == "v1" else 4))

    def _attn(self, query, query_pos, ref_points, spatial_shapes):
        if self.attn_type == "window":
            return self.attn(query, query_pos, spatial_shapes[0])
        return self.attn(query, query, query_pos, ref_points, spatial_shapes)

    def forward(self, query: torch.Tensor, time: Optional[torch.Tensor],
                query_pos: Optional[torch.Tensor], ref_points: Optional[torch.Tensor],
                spatial_shapes: SpatialShapes) -> torch.Tensor:
        timed = self.use_time and time is not None
        if self.film == "v1":
            query = self.norm1(self._attn(query, query_pos, ref_points, spatial_shapes))
            query = self.norm2(query + self.ffn(query))
            if timed:
                scale, shift = self.time_mlp(F.silu(time))[:, None, :].chunk(2, dim=-1)
                query = query * (scale + 1.0) + shift
            return query
        s1 = s2 = sh1 = sh2 = None
        if timed:
            s1, s2, sh1, sh2 = self.time_mlp(F.silu(time))[:, None, :].chunk(4, dim=-1)

        def film(x, s, sh):
            return x if s is None else x * (s + 1.0) + sh

        if self.film == "v2":
            y = self._attn(self.norm1(query), query_pos, ref_points, spatial_shapes)
            query = query + film(y, s1, sh1)
            return query + film(self.ffn(self.norm2(query)), s2, sh2)
        query = self._attn(query, query_pos, ref_points, spatial_shapes)
        query = film(self.norm1(query), s1, sh1)
        query = query + self.ffn(query)
        return film(self.norm2(query), s2, sh2)


class TimeFiLMEncoder(nn.Module):
    """Stack of ``num_layers`` TimeFiLMEncoderLayer; odd layers shift by window//2
    (window attention only). ``remat``: while gradients are taken, each layer
    keeps only its input and recomputes its activations in the backward pass
    (``torch.utils.checkpoint``, non-reentrant; the JAX package's
    ``nn.remat``). The layers draw no random numbers, so the recomputation
    needs no saved RNG state (``preserve_rng_state=False``: it reads none,
    which a CUDA-graph capture forbids)."""

    def __init__(self, num_layers: int = 6, embed_dims: int = 256, num_heads: int = 8,
                 num_levels: int = 1, num_points: int = 4, ffn_dim: int = 1024,
                 use_time: bool = True, attn_type: str = "window", window: int = 8,
                 film: str = "v1", remat: bool = False):
        super().__init__()
        self.num_layers = num_layers
        self.remat = remat
        for i in range(num_layers):
            self.add_module(f"layer{i}", TimeFiLMEncoderLayer(
                embed_dims, num_heads, num_levels, num_points, ffn_dim, use_time, attn_type,
                window, shift=0 if i % 2 == 0 else window // 2, film=film))

    def forward(self, query: torch.Tensor, time: Optional[torch.Tensor],
                query_pos: Optional[torch.Tensor], ref_points: Optional[torch.Tensor],
                spatial_shapes: SpatialShapes) -> torch.Tensor:
        remat = self.remat and torch.is_grad_enabled()
        for i in range(self.num_layers):
            layer = getattr(self, f"layer{i}")
            if remat:
                query = checkpoint(layer, query, time, query_pos, ref_points, spatial_shapes,
                                   use_reentrant=False, preserve_rng_state=False)
            else:
                query = layer(query, time, query_pos, ref_points, spatial_shapes)
        return query
