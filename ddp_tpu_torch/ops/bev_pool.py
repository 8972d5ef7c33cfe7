"""BEV pooling: scatter-sum camera frustum features into the BEV grid (port
of ``ddp_tpu/ops/bev_pool.py:24-66``; the reference's CUDA ``bev_pool`` op as
``BaseTransform.bev_pool`` calls it).

The JAX package's static design is kept: every point gets a cell id, a point
outside the grid goes to a dump slot (``n_cells``) of its batch, and one
``index_add_`` sums the rows into [B·(n_cells + 1), C]; the dump slots are
dropped and Z is collapsed into channels. The point count is fixed by the
shapes, and nothing reads a value on the host (no boolean indexing, no
``nonzero``), so the train step that runs it can be captured in a CUDA graph.

JAX sums with XLA's ``segment_sum``, outside any Pallas kernel; so does this
(``index_add_``: atomics on the card, a sorted sum under PyTorch's
deterministic algorithms). Its backward is a gather of the output's gradient.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def quantize_geometry(geom: torch.Tensor, bx: Sequence[float], dx: Sequence[float],
                      nx: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Voxel indices of float32 points [..., 3]: ``floor((p − (bx − dx/2)) /
    dx)``, as int32 [..., 3], and the in-range mask [...]. ``bx − dx/2`` is
    rounded as JAX computes it (float32); the bounds enter as Python scalars,
    not tensors copied from the host, which a CUDA graph cannot capture."""
    dx32 = np.asarray(dx, np.float32)
    lo = np.asarray(bx, np.float32) - dx32 / np.float32(2.0)
    idx = torch.stack([torch.floor((geom[..., i] - float(lo[i])) / float(dx32[i]))
                       for i in range(3)], dim=-1).to(torch.int32)
    ok = (idx >= 0).all(dim=-1)
    for axis, n in enumerate(nx):
        ok = ok & (idx[..., axis] < n)
    return idx, ok


def bev_pool(feats: torch.Tensor, coords: torch.Tensor, valid: torch.Tensor,
             nx: int, ny: int, nz: int) -> torch.Tensor:
    """feats [B, P, C], coords [B, P, 3] int (x, y, z), valid [B, P] bool ->
    the per-cell sums [B, nx, ny, nz·C] (Z collapsed into channels, as the
    reference's ``cat(unbind(dim=Z))``), in the features' type. A profile
    of eager calls finds its kernels (and its backward nodes') under the
    ``bev_pool`` range."""
    with torch.profiler.record_function("bev_pool"):
        return _bev_pool(feats, coords, valid, nx, ny, nz)


def _bev_pool(feats: torch.Tensor, coords: torch.Tensor, valid: torch.Tensor,
              nx: int, ny: int, nz: int) -> torch.Tensor:
    b, p, c = feats.shape
    x, y, z = (coords[..., i].long() for i in range(3))
    n_cells = nz * nx * ny
    cell = (z * nx + x) * ny + y
    cell = torch.where(valid, cell, torch.full_like(cell, n_cells))  # the dump slot
    offset = torch.arange(b, device=feats.device)[:, None] * (n_cells + 1)
    pooled = torch.zeros(b * (n_cells + 1), c, dtype=feats.dtype, device=feats.device)
    pooled = pooled.index_add(0, (cell + offset).reshape(-1), feats.reshape(b * p, c))
    pooled = pooled.reshape(b, n_cells + 1, c)[:, :n_cells]
    pooled = pooled.reshape(b, nz, nx, ny, c)
    return pooled.permute(0, 2, 3, 1, 4).reshape(b, nx, ny, nz * c)
