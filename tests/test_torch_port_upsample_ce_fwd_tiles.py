"""The tile geometry of the upsample+CE forward CUDA kernel, on the CPU.

``ops/upsample_ce.py:fwd_geometry`` picks the kernel's tile, grid, threads
and shared bytes; the kernel itself runs only on the card
(``chip_smoke.py``). Here the geometry is checked against the card's limits,
and a torch model of the kernel's decomposition is held to
``upsample_ce_fwd_plain`` in float64 at ragged shapes, with ignored and
out-of-range labels: per tile, the clamped (TH+2) x (TW+2) halo and the z of
the tile's S·TH x S·TW output pixels from it; per chunk of 32 classes
(classes >= K staged as -1e30) and group of 4, the group's maximum, one
rescale of the running sum, then the group's exponentials; the label's z
from the chunk that holds it; per block, the three sums.
"""
import numpy as np
import pytest
import torch

from ddp_tpu_torch.ops import upsample_ce as U
from torch_port_threads import _one_torch_thread  # noqa: F401


PAD = -1e30  # the kernel's logit for a class >= K


@pytest.mark.parametrize("k", [150, 19])
@pytest.mark.parametrize("scale", range(2, U.MAX_SCALE + 1))
def test_fwd_geometry_fits_the_card(scale, k):
    geo = U.fwd_geometry(2, 128, 128, k, scale)
    assert geo.smem_bytes <= U.FWD_MAX_SMEM <= U.MAX_SMEM
    assert geo.smem_bytes == U.fwd_smem_bytes(scale, geo.tile_h, geo.tile_w)
    # the tile the kernel is compiled for (fwd_tile): 8 wide, the highest
    # of 16, 8, 4 with at most 32 output rows
    assert geo.tile_w == U.FWD_TILE_W == 8
    assert geo.tile_h == max(t for t in (16, 8, 4) if scale * t <= 32)
    assert geo.threads == scale * geo.tile_h * geo.tile_w
    assert geo.threads % 32 == 0 and geo.threads <= 256  # whole warps, 64 registers
    assert geo.chunk == U.CHUNK == 32
    assert geo.grid == (-(-128 // geo.tile_h) * (128 // 8), 2)


def _tiled_fwd(logits, labels, scale, ignore_index=255):
    """The forward computed tile by tile as the CUDA kernel decomposes it."""
    b, h, w, k = logits.shape
    geo = U.fwd_geometry(b, h, w, k, scale)
    th, tw, chunk = geo.tile_h, geo.tile_w, geo.chunk
    taps = U.phase_taps(scale)
    minus = torch.tensor([t[0] for t in taps])
    wlo = torch.tensor([t[1] for t in taps], dtype=logits.dtype)
    whi = torch.tensor([t[2] for t in taps], dtype=logits.dtype)
    kp = -(-k // chunk) * chunk
    x = torch.cat([logits, torch.full((b, h, w, kp - k), PAD, dtype=logits.dtype)], -1)
    sums = torch.zeros(3, dtype=logits.dtype)
    lse = torch.full((b, scale * h, scale * w), float("nan"), dtype=logits.dtype)
    ys, xs = torch.arange(scale * th), torch.arange(scale * tw)
    p, q = ys % scale, xs % scale
    for i0 in range(0, h, th):
        for j0 in range(0, w, tw):
            rows = (i0 - 1 + torch.arange(th + 2)).clamp(0, h - 1)
            cols = (j0 - 1 + torch.arange(tw + 2)).clamp(0, w - 1)
            halo = x[:, rows][:, :, cols]  # [b, th+2, tw+2, kp]
            # the halo row / column of the low tap; the high tap is the next
            lo_r = torch.div(ys, scale, rounding_mode="floor") + (~minus[p]).long()
            zy = (halo[:, lo_r] * wlo[p][:, None, None]
                  + halo[:, lo_r + 1] * whi[p][:, None, None])
            lo_c = torch.div(xs, scale, rounding_mode="floor") + (~minus[q]).long()
            z = zy[:, :, lo_c] * wlo[q][:, None] + zy[:, :, lo_c + 1] * whi[q][:, None]
            y, xx = scale * i0 + ys, scale * j0 + xs
            inside = (y < scale * h)[:, None] & (xx < scale * w)[None, :]
            lab = labels[:, y.clamp(max=scale * h - 1)][:, :, xx.clamp(max=scale * w - 1)]
            valid = (lab != ignore_index) & inside
            in_range = (lab >= 0) & (lab < k)
            z_lab = z.gather(-1, lab.clamp(0, kp - 1)[..., None])[..., 0]
            m = torch.full(lab.shape, float("-inf"), dtype=logits.dtype)
            s = torch.zeros(lab.shape, dtype=logits.dtype)
            zl = torch.zeros(lab.shape, dtype=logits.dtype)
            for c0 in range(0, k, chunk):
                nc = min(chunk, k - c0)
                for g in range(c0, c0 + nc, 4):
                    zg = z[..., g:g + 4]
                    mn = torch.maximum(m, zg.max(-1).values)
                    s = s * torch.exp(m - mn) + torch.exp(zg - mn[..., None]).sum(-1)
                    m = mn
                zl = torch.where(in_range & (lab >= c0) & (lab < c0 + nc), z_lab, zl)
            l = m + torch.log(s)
            sums += torch.stack([torch.where(valid, l - zl, 0.0).sum(),
                                 valid.sum().to(sums.dtype),
                                 (valid & (zl >= m)).sum().to(sums.dtype)])
            nh, nw = min(scale * th, scale * (h - i0)), min(scale * tw, scale * (w - j0))
            lse[:, scale * i0:scale * i0 + nh, scale * j0:scale * j0 + nw] = l[:, :nh, :nw]
    return sums, lse


@pytest.mark.parametrize("k", [7, 33])
@pytest.mark.parametrize("w", [1, 5, 13])
@pytest.mark.parametrize("h", [1, 5, 13])
@pytest.mark.parametrize("scale", [2, 3, 4, 8])
def test_tiled_forward_matches_plain(scale, h, w, k):
    rng = np.random.RandomState(scale * 1000 + h * 100 + w * 10 + k)
    # +3: every pixel's max z is positive, so that a label outside [0, K)
    # counts as correct under neither rule (the kernel's 0 >= max z, the
    # plain version's argmax == label)
    logits = torch.from_numpy(rng.randn(2, h, w, k) + 3.0)
    labels = torch.from_numpy(rng.randint(0, k, (2, scale * h, scale * w)).astype(np.int64))
    labels[0, :scale + 1, :2 * scale] = 255  # ignored
    labels[1, -1, :] = k + 3  # valid, outside [0, K)
    labels[1, :, 0] = -4
    want, want_lse = U.upsample_ce_fwd_plain(logits, labels, scale)
    got, got_lse = _tiled_fwd(logits, labels, scale)
    assert not torch.isnan(got_lse).any()  # every output pixel belongs to one tile
    # float64: only the summation order differs; the counts are exact
    np.testing.assert_allclose(got[0].item(), want[0].item(), rtol=1e-10)
    assert got[1:].tolist() == want[1:].tolist()
    np.testing.assert_allclose(got_lse.numpy(), want_lse.numpy(), rtol=1e-10, atol=1e-12)
