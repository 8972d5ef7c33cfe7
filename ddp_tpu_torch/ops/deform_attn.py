"""Multi-scale deformable attention sampling (port of ``ms_deform_attn_xla``
and ``_bilinear_sample_level``, ``ddp_tpu/ops/deform_attn.py:31-99``).

The reference's mmcv ``MultiScaleDeformableAttention`` core: per level,
bilinear sampling of the value map at learned locations with
``grid_sample(align_corners=False, padding_mode='zeros')`` semantics, then a
sum over (levels × points) weighted by the softmaxed attention weights.

Layouts (batch-first, as in the JAX package):
  value:              [B, S, H, D]   (S = Σ_l H_l·W_l tokens, H heads)
  sampling_locations: [B, Q, H, L, P, 2]  in [0, 1] per level, as (x, y)
  attention_weights:  [B, Q, H, L, P]     softmaxed over L·P
  output:             [B, Q, H·D]

Sampling follows the reference exactly: half-pixel centres
(``x = loc_x·W − 0.5``), four corners from ``floor``, each masked to zero
outside its level and read at a clamped index, levels walked in order over
the flattened S, the locations' arithmetic in their own dtype. The corners
are read and summed with their bilinear × attention weights by one
``F.embedding_bag`` (mode "sum", per-sample weights) on a flat
``(b·H + h)·S + start + y·W + x`` index: an index select fused with the
weighted sum, so the [B·H·Q, L·P·4, D] corner tensor of an ``index_select``
followed by a matmul is never formed (at the decoder's shape on an NVIDIA
H100 80GB HBM3 at 700 W, ``chip_smoke.py``'s msda_main timed that form's
forward at 4.05 ms and this one's at 2.62 ms; PERF.md §6). The bag runs in
float32 (its per-sample-weights backward has no bfloat16 CUDA kernel), and
the output is cast back to the value's dtype. No ``F.grid_sample``: its CUDA
backward has no deterministic implementation; the bag's has. The JAX
package's window-gather and hybrid forms (``ms_deform_attn_window``,
``ms_deform_attn_hybrid``) work around a libtpu crash and are not ported. No
Pallas kernel backs MSDA (``ddp_tpu/ops/deform_attn.py:10-14``).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


def _level_corners(loc: torch.Tensor, hw: Tuple[int, int], start: int, seq: int):
    """Flat indices [B, Q, H, P, 4] of the four corners of ``loc`` [B, Q, H,
    P, 2] in one level of ``hw`` that starts at token ``start``, and their
    bilinear weights (zero outside the level), corners ordered (x0, y0),
    (x0+1, y0), (x0, y0+1), (x0+1, y0+1)."""
    h, w = hw
    x = loc[..., 0] * w - 0.5
    y = loc[..., 1] * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    tx = x - x0
    ty = y - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    b, _, nh = loc.shape[:3]
    # the (batch, head) row of value [B·H·S, D] each sample reads from
    base = (torch.arange(b * nh, device=loc.device) * seq).reshape(b, 1, nh, 1)
    idx, wts = [], []
    for xi, yi, wt in ((x0i, y0i, (1 - tx) * (1 - ty)), (x0i + 1, y0i, tx * (1 - ty)),
                       (x0i, y0i + 1, (1 - tx) * ty), (x0i + 1, y0i + 1, tx * ty)):
        inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        flat = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        idx.append(base + start + flat)
        wts.append(wt * inside.to(wt.dtype))
    return torch.stack(idx, dim=-1), torch.stack(wts, dim=-1)


def ms_deform_attn(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                   sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor) -> torch.Tensor:
    """Multi-scale deformable attention core. See the module docstring."""
    # a named range: a profile of eager calls sums the op's kernels from it
    # (the forward) and from the backward nodes made inside it
    with torch.profiler.record_function("ms_deform_attn"):
        return _ms_deform_attn(value, spatial_shapes, sampling_locations, attention_weights)


def _ms_deform_attn(value, spatial_shapes, sampling_locations, attention_weights):
    b, s, nh, d = value.shape
    q = sampling_locations.shape[1]
    idx, wts = [], []
    start = 0
    for lvl, hw in enumerate(spatial_shapes):
        i, w = _level_corners(sampling_locations[:, :, :, lvl], hw, start, s)
        idx.append(i)
        wts.append(w * attention_weights[:, :, :, lvl, :, None])
        start += hw[0] * hw[1]
    if start != s:
        raise ValueError(f"spatial_shapes {tuple(spatial_shapes)} cover {start} tokens, "
                         f"value has {s}")
    # [B, Q, H, L·P·4] -> [B·H·Q, L·P·4]: one bag per (batch, head, query)
    idx = torch.cat(idx, dim=-2).flatten(-2).transpose(1, 2).reshape(b * nh * q, -1)
    wts = torch.cat(wts, dim=-2).flatten(-2).transpose(1, 2).reshape(b * nh * q, -1)
    flat_v = value.transpose(1, 2).reshape(b * nh * s, d)
    out = F.embedding_bag(idx, flat_v.float(), per_sample_weights=wts.float(), mode="sum")
    return out.to(value.dtype).reshape(b, nh, q, d).transpose(1, 2).reshape(b, q, nh * d)
