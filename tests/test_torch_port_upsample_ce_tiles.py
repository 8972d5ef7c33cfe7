"""The tile geometry of the upsample+CE backward CUDA kernel, on the CPU.

``ops/upsample_ce.py:bwd_geometry`` picks the kernel's tile, class chunk,
grid and shared bytes; the kernel itself runs only on the card
(``chip_smoke.py``). Here the geometry is checked against the card's limit,
and a torch model of the kernel's decomposition (per tile: the clamped
(TH+2) x (TW+2) halo, the (S·TH+S) x (S·TW+S) region of output pixels from
S·i0 − ceil(S/2), dz once per region pixel, the transposed column then row
lerp restricted to the tile) is held to ``upsample_ce_grad_plain`` in
float64 at ragged shapes, with ignored and out-of-range labels.
"""
import numpy as np
import pytest
import torch

from ddp_tpu_torch.ops import upsample_ce as U
from torch_port_threads import _one_torch_thread  # noqa: F401


@pytest.mark.parametrize("k", [150, 19])
@pytest.mark.parametrize("scale", range(2, U.MAX_SCALE + 1))
def test_bwd_geometry_fits_the_card(scale, k):
    geo = U.bwd_geometry(2, 128, 128, k, scale)
    assert geo.smem_bytes <= U.MAX_SMEM
    assert geo.smem_bytes == U.bwd_smem_bytes(scale, geo.tile_h, geo.tile_w)
    assert 1 <= geo.tile_h <= 8 and geo.tile_w >= 1  # the kernel takes tile_h <= 8
    assert geo.chunk == 32
    tiles = -(-128 // geo.tile_h) * -(-128 // geo.tile_w)
    assert geo.grid == (tiles, -(-k // 32), 2)


def _tiled_grad(logits, labels, lse, g, scale, ignore_index=255):
    """The backward computed tile by tile as the CUDA kernel decomposes it."""
    b, h, w, k = logits.shape
    geo = U.bwd_geometry(b, h, w, k, scale)
    th, tw = geo.tile_h, geo.tile_w
    before = scale - scale // 2  # phases of the previous cell that tap the tile
    taps = U.phase_taps(scale)
    minus = torch.tensor([t[0] for t in taps])
    wlo = torch.tensor([t[1] for t in taps], dtype=logits.dtype)
    whi = torch.tensor([t[2] for t in taps], dtype=logits.dtype)
    out = torch.full_like(logits, float("nan"))
    for i0 in range(0, h, th):
        for j0 in range(0, w, tw):
            rows = (i0 - 1 + torch.arange(th + 2)).clamp(0, h - 1)
            cols = (j0 - 1 + torch.arange(tw + 2)).clamp(0, w - 1)
            halo = logits[:, rows][:, :, cols]  # [b, th+2, tw+2, k]
            ys = scale * i0 - before + torch.arange(scale * (th + 1))
            xs = scale * j0 - before + torch.arange(scale * (tw + 1))
            p, ci = ys % scale, torch.div(ys, scale, rounding_mode="floor")
            q, cj = xs % scale, torch.div(xs, scale, rounding_mode="floor")
            # z from the halo alone: the unclamped low tap's halo row / column
            lo_r = (torch.where(minus[p], ci - 1, ci) - (i0 - 1)).clamp(0, th)
            zy = (halo[:, lo_r] * wlo[p][:, None, None]
                  + halo[:, lo_r + 1] * whi[p][:, None, None])
            lo_c = (torch.where(minus[q], cj - 1, cj) - (j0 - 1)).clamp(0, tw)
            z = zy[:, :, lo_c] * wlo[q][:, None] + zy[:, :, lo_c + 1] * whi[q][:, None]
            # the region's labels and lse; pixels outside the image count nothing
            yin, xin = (ys >= 0) & (ys < scale * h), (xs >= 0) & (xs < scale * w)
            yc, xc = ys.clamp(0, scale * h - 1), xs.clamp(0, scale * w - 1)
            lab, l = labels[:, yc][:, :, xc], lse[:, yc][:, :, xc]
            valid = (lab != ignore_index) & yin[:, None] & xin[None, :]
            in_range = (lab >= 0) & (lab < k)
            onehot = torch.nn.functional.one_hot(lab.clamp(0, k - 1), k) * in_range[..., None]
            dz = (torch.exp(z - l[..., None]) - onehot) * valid[..., None]
            # transposed column lerp into the tile's columns (the edge clamp
            # sends both taps to one column), then the row lerp
            dlo = torch.where(minus[q], cj - 1, cj).clamp(0, w - 1) - j0 + 1
            dhi = torch.where(minus[q], cj, cj + 1).clamp(0, w - 1) - j0 + 1
            dzy = torch.zeros(b, len(ys), tw + 2, k, dtype=logits.dtype)
            dzy.index_add_(2, dlo, dz * wlo[q][:, None])
            dzy.index_add_(2, dhi, dz * whi[q][:, None])
            dzy = dzy[:, :, 1:tw + 1]
            rlo = torch.where(minus[p], ci - 1, ci).clamp(0, h - 1) - i0 + 1
            rhi = torch.where(minus[p], ci, ci + 1).clamp(0, h - 1) - i0 + 1
            dx = torch.zeros(b, th + 2, tw, k, dtype=logits.dtype)
            dx.index_add_(1, rlo, dzy * wlo[p][:, None, None])
            dx.index_add_(1, rhi, dzy * whi[p][:, None, None])
            nh, nw = min(th, h - i0), min(tw, w - j0)
            out[:, i0:i0 + nh, j0:j0 + nw] = g * dx[:, 1:nh + 1, :nw]
    return out


@pytest.mark.parametrize("k", [7, 33])
@pytest.mark.parametrize("w", [1, 5, 13])
@pytest.mark.parametrize("h", [1, 5, 13])
@pytest.mark.parametrize("scale", [2, 3, 4, 8])
def test_tiled_backward_matches_plain(scale, h, w, k):
    rng = np.random.RandomState(scale * 1000 + h * 100 + w * 10 + k)
    logits = torch.from_numpy(rng.randn(2, h, w, k))
    labels = torch.from_numpy(rng.randint(0, k, (2, scale * h, scale * w)).astype(np.int64))
    labels[0, :scale + 1, :2 * scale] = 255  # ignored
    labels[1, -1, :] = k + 3  # valid, outside [0, K): softmax only
    _, lse = U.upsample_ce_fwd_plain(logits, labels, scale)
    g = torch.tensor(0.5, dtype=torch.float64)
    want = U.upsample_ce_grad_plain(logits, labels, lse, g, scale)
    got = _tiled_grad(logits, labels, lse, g, scale)
    assert not torch.isnan(got).any()  # every latent pixel belongs to one tile
    # float64: only the summation order differs
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-10, atol=1e-14)
