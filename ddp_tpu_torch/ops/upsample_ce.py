"""Fused bilinear-upsample + cross-entropy, forward and backward.

Port of ``ddp_tpu/ops/pallas/upsample_ce.py`` (the ``_fwd_kernel`` and
``_bwd_kernel`` Pallas kernels behind ``fused_upsample_ce``) and of its XLA
oracle ``ddp_tpu/nn/losses.py:cross_entropy_seg_upsampled``.

The cross-entropy of the x``scale`` bilinear upsample (align_corners=False,
edge clamped) of logits [B, h, w, K] against labels [B, s·h, s·w], without
materialising the upsampled logits. An integer-scale upsample is, per output
phase (p, q), a fixed lerp of edge-clamped neighbours of the latent grid, so
every output pixel's logits are a function of four latent pixels.

  - ``upsample_ce_fwd_*``: (sums, lse) where sums = [NLL sum, valid count,
    correct count] over labels != ignore_index, and lse [B, s·h, s·w] the
    log-sum-exp of every output pixel (the backward reads it).
  - ``upsample_ce_bwd_*``: dlogits [B, h, w, K] float32 = g · d(NLL sum)/d logits.

The CUDA kernels (``ddp_tpu_torch/csrc/upsample_ce.cu``) run for CUDA tensors
and raise on anything they do not take; the plain versions run for CPU
tensors. ``upsample_ce`` is the differentiable entry with the semantics of
``fused_upsample_ce``: loss = NLL sum / labels.numel() (ignored pixels stay in
the denominator), accuracy = correct / max(count, 1).

Both versions compute in float32 whatever the logits' type (the Pallas
kernels do; the XLA oracle lerps in the input type). Accuracy: the CUDA
kernel counts a pixel as correct when the label's logit is >= the maximum
(ties count, as in the Pallas kernel); the plain version takes the argmax
(the first index wins, as in the oracle). The two differ only on exact ties.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import torch

from ..parallel.global_batch import sum_over_ranks
from .q_sample import _acc

# launches of each CUDA kernel since the last reset (chip_smoke.py reads them)
launches: Dict[str, int] = {"upsample_ce_fwd": 0, "upsample_ce_bwd": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_SCALE = 8  # the CUDA kernels are instantiated for scales 2..8
CHUNK = 32  # classes staged at a time by both kernels (the backward: one per lane)
MAX_SMEM = 232_448  # opt-in shared memory of one block on an H100
FWD_MAX_SMEM = 48 * 1024  # the forward's, which does not opt in
FWD_TILE_W = 8  # latent columns of a forward tile (the 8 lanes of a quarter warp)


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


def phase_taps(scale: int) -> List[Tuple[bool, float, float]]:
    """(minus, w_lo, w_hi) per phase: taps (i-1, i) when minus else (i, i+1)
    (``ddp_tpu/ops/pallas/upsample_ce.py:_taps``)."""
    taps = []
    for p in range(scale):
        phi = (p + 0.5) / scale - 0.5
        taps.append((True, -phi, 1.0 + phi) if phi < 0 else (False, 1.0 - phi, phi))
    return taps


def _tap_index(n: int, minus: bool, device) -> Tuple[torch.Tensor, torch.Tensor]:
    i = torch.arange(n, device=device)
    if minus:
        return (i - 1).clamp(min=0), i
    return i, (i + 1).clamp(max=n - 1)


def _lerp(x: torch.Tensor, dim: int, tap, device) -> torch.Tensor:
    minus, wlo, whi = tap
    lo, hi = _tap_index(x.shape[dim], minus, device)
    return x.index_select(dim, lo) * wlo + x.index_select(dim, hi) * whi


def _lerp_T(g: torch.Tensor, dim: int, tap, device) -> torch.Tensor:
    """Transpose of ``_lerp`` along ``dim`` (the edge clamp's scatter-add)."""
    minus, wlo, whi = tap
    lo, hi = _tap_index(g.shape[dim], minus, device)
    out = torch.zeros_like(g)
    out.index_add_(dim, lo, g * wlo)
    return out.index_add_(dim, hi, g * whi)


def _phases(logits: torch.Tensor, labels: torch.Tensor, scale: int):
    """Yield (p, q, z [B, h, w, K], labels [B, h, w]) for every output phase."""
    x = _acc(logits)
    taps = phase_taps(scale)
    for p in range(scale):
        zy = _lerp(x, 1, taps[p], x.device)
        for q in range(scale):
            yield p, q, zy, _lerp(zy, 2, taps[q], x.device), labels[:, p::scale, q::scale]


def _check_shapes(logits: torch.Tensor, labels: torch.Tensor, scale: int) -> None:
    if logits.ndim != 4 or labels.ndim != 3:
        raise ValueError(f"logits must be [B, h, w, K] and labels [B, H, W], got "
                         f"{tuple(logits.shape)} and {tuple(labels.shape)}")
    b, h, w, _ = logits.shape
    if tuple(labels.shape) != (b, scale * h, scale * w):
        raise ValueError(f"labels {tuple(labels.shape)} are not the x{scale} grid of "
                         f"logits {tuple(logits.shape)}")


def _label_terms(z: torch.Tensor, lab: torch.Tensor, ignore_index: int):
    """(valid, in_range, safe labels, label logit or 0 outside [0, K))."""
    k = z.shape[-1]
    valid = lab != ignore_index
    in_range = (lab >= 0) & (lab < k)
    safe = torch.where(in_range, lab, torch.zeros_like(lab))
    z_lab = torch.where(in_range, z.gather(-1, safe[..., None])[..., 0],
                        torch.zeros((), dtype=z.dtype, device=z.device))
    return valid, in_range, safe, z_lab


def upsample_ce_fwd_plain(logits: torch.Tensor, labels: torch.Tensor, scale: int,
                          ignore_index: int = 255):
    """Plain PyTorch version: (sums [3], lse [B, s·h, s·w]), phase by phase as
    the XLA oracle computes it (in float32)."""
    _check_shapes(logits, labels, scale)
    b, h, w, _ = logits.shape
    dt = _acc(logits).dtype
    sums = torch.zeros(3, dtype=dt, device=logits.device)
    lse_full = torch.empty((b, scale * h, scale * w), dtype=dt, device=logits.device)
    for p, q, _, z, lab in _phases(logits, labels, scale):
        lse = torch.logsumexp(z, dim=-1)
        valid, _, _, z_lab = _label_terms(z, lab, ignore_index)
        correct = valid & (torch.argmax(z, dim=-1) == lab)
        sums = sums + torch.stack([torch.where(valid, lse - z_lab, 0.0).sum(),
                                   valid.sum().to(dt), correct.sum().to(dt)])
        lse_full[:, p::scale, q::scale] = lse
    return sums, lse_full


def upsample_ce_grad_plain(logits: torch.Tensor, labels: torch.Tensor, lse: torch.Tensor,
                           g: torch.Tensor, scale: int, ignore_index: int = 255):
    """Plain PyTorch version of the backward: g · d(NLL sum)/d logits
    [B, h, w, K] in float32, the phase backward written out (the transposed
    lerps of (softmax − onehot)·valid)."""
    _check_shapes(logits, labels, scale)
    taps = phase_taps(scale)
    dx = torch.zeros_like(_acc(logits))
    dzy = None
    for p, q, zy, z, lab in _phases(logits, labels, scale):
        if q == 0:
            dzy = torch.zeros_like(zy)
        valid, in_range, safe, _ = _label_terms(z, lab, ignore_index)
        soft = torch.exp(z - lse[:, p::scale, q::scale, None].to(z.dtype))
        onehot = torch.zeros_like(z).scatter_(-1, safe[..., None], 1.0)
        dz = (soft - onehot * in_range[..., None]) * valid[..., None]
        dzy = dzy + _lerp_T(dz, 2, taps[q], dz.device)
        if q == scale - 1:
            dx = dx + _lerp_T(dzy, 1, taps[p], dzy.device)
    return g.to(dx.dtype) * dx


class BwdGeometry(NamedTuple):
    """Launch of the tiled backward kernel: a block of ``tile_h + 1`` warps
    owns ``tile_h x tile_w`` latent pixels of one image and ``chunk`` classes;
    ``grid`` = (tiles, class chunks, batch)."""
    tile_h: int
    tile_w: int
    chunk: int
    grid: Tuple[int, int, int]
    smem_bytes: int


def bwd_smem_bytes(scale: int, tile_h: int, tile_w: int) -> int:
    """Shared bytes of one backward block: the (TH+2) x (TW+2) halo of logits
    and the (S·TH+S) x TW x chunk column-lerped gradient, f32 per class; the
    (S·TH+S) x (S·TW+S) region's lse and label, 8 bytes per output pixel."""
    return (4 * CHUNK * ((tile_h + 2) * (tile_w + 2) + scale * (tile_h + 1) * tile_w)
            + 8 * scale * scale * (tile_h + 1) * (tile_w + 1))


def bwd_geometry(b: int, h: int, w: int, k: int, scale: int) -> BwdGeometry:
    """The backward's launch at logits [b, h, w, k] and ``scale``: 8 x 8
    tiles where three blocks fit on an SM's shared memory (scales 2..5),
    else 4 x 4. The kernel is compiled for that tile (``bwd_tile`` in
    ``csrc/upsample_ce.cu``) and refuses another."""
    tile = next(t for t in (8, 4) if bwd_smem_bytes(scale, t, t) <= MAX_SMEM // 3)
    tiles = -(-h // tile) * -(-w // tile)
    return BwdGeometry(tile, tile, CHUNK, (tiles, -(-k // CHUNK), b),
                       bwd_smem_bytes(scale, tile, tile))


class FwdGeometry(NamedTuple):
    """Launch of the tiled forward kernel: a block of ``threads`` (one per
    output row and latent column) owns ``tile_h x tile_w`` latent pixels of
    one image and stages ``chunk`` classes at a time; ``grid`` = (tiles,
    batch)."""
    tile_h: int
    tile_w: int
    chunk: int
    grid: Tuple[int, int]
    threads: int
    smem_bytes: int


def fwd_smem_bytes(scale: int, tile_h: int, tile_w: int) -> int:
    """Shared bytes of one forward block: the (TH+2) x (TW+2) halo of logits,
    chunk + 4 floats per pixel (the 4 keep a quarter warp's float4 reads on
    distinct banks); the S·TH x S·TW tile's labels, then its lse, 4 bytes per
    output pixel."""
    return 4 * ((tile_h + 2) * (tile_w + 2) * (CHUNK + 4) + scale * scale * tile_h * tile_w)


def fwd_geometry(b: int, h: int, w: int, k: int, scale: int) -> FwdGeometry:
    """The forward's launch at logits [b, h, w, k] and ``scale``: tiles 8
    latent columns wide and 16, 8 or 4 rows high, the most with at most 32
    output rows, so that a block has at most 256 threads (at 64 registers,
    four blocks share an SM: 528 places for the 512 blocks of [2, 128, 128]
    at scale 4, one wave). The kernel is compiled for that tile
    (``fwd_tile`` in ``csrc/upsample_ce.cu``) and refuses another."""
    tile_h = next(t for t in (16, 8, 4) if scale * t <= 32)
    tiles = -(-h // tile_h) * -(-w // FWD_TILE_W)
    return FwdGeometry(tile_h, FWD_TILE_W, CHUNK, (tiles, b), scale * tile_h * FWD_TILE_W,
                       fwd_smem_bytes(scale, tile_h, FWD_TILE_W))


def kernel_attrs(kernel: str, scale: int, dtype: torch.dtype) -> Dict[str, int]:
    """Registers, spilled (local) bytes and static shared bytes per thread
    or block of the ``"fwd"`` or ``"bwd"`` kernel's instantiation, as the
    card reports them (``cudaFuncGetAttributes``); builds the kernels if
    needed."""
    import ctypes

    from ._build import load_library

    out = (ctypes.c_int * 4)()
    entry = f"ddp_upsample_ce_{kernel}_attrs"
    err = getattr(load_library(), entry)(scale, _DTYPE_CODES[dtype], ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"{entry}: cudaError {err}")
    return dict(zip(("registers", "local_bytes", "static_shared_bytes", "max_threads"), out))


def _check_cuda(logits: torch.Tensor, labels: torch.Tensor, scale: int,
                *more: torch.Tensor) -> None:
    tensors = (logits, labels) + more
    if logits.device.type != "cuda" or any(t.device != logits.device for t in tensors):
        raise ValueError(f"upsample_ce CUDA kernels need all tensors on one CUDA device, "
                         f"got {[str(t.device) for t in tensors]}")
    if logits.dtype not in _DTYPE_CODES or labels.dtype != torch.int64:
        raise ValueError(f"logits must be float32/bfloat16 and labels int64, got "
                         f"{logits.dtype} and {labels.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("upsample_ce CUDA kernels need contiguous tensors")
    if not 2 <= scale <= MAX_SCALE:
        raise ValueError(f"the upsample_ce CUDA kernels take scales 2..{MAX_SCALE}, got {scale}")
    _check_shapes(logits, labels, scale)


def _launch(name: str, entry: str, device, *args) -> None:
    from ._build import launch

    launch(entry, device, *args)
    launches[name] += 1


def upsample_ce_fwd_cuda(logits: torch.Tensor, labels: torch.Tensor, scale: int,
                         ignore_index: int = 255):
    """Launch the forward kernel: logits [B, h, w, K] f32/bf16, labels
    [B, s·h, s·w] int64, contiguous on one CUDA device. Returns (sums [3]
    float32, lse [B, s·h, s·w] float32)."""
    _check_cuda(logits, labels, scale)
    b, h, w, k = logits.shape
    sums = torch.zeros(3, dtype=torch.float32, device=logits.device)
    lse = torch.empty((b, scale * h, scale * w), dtype=torch.float32, device=logits.device)
    if logits.numel():
        geo = fwd_geometry(b, h, w, k, scale)
        _launch("upsample_ce_fwd", "ddp_upsample_ce_fwd", logits.device, logits.data_ptr(),
                labels.data_ptr(), sums.data_ptr(), lse.data_ptr(), b, h, w, k, scale,
                int(ignore_index), _DTYPE_CODES[logits.dtype], geo.tile_h, geo.tile_w,
                *geo.grid, geo.threads, geo.smem_bytes)
    return sums, lse


def upsample_ce_bwd_cuda(logits: torch.Tensor, labels: torch.Tensor, lse: torch.Tensor,
                         g: torch.Tensor, scale: int, ignore_index: int = 255):
    """Launch the backward kernel: lse from the forward, g a one-element
    float32 tensor on the device. Returns dlogits [B, h, w, K] float32."""
    _check_cuda(logits, labels, scale, lse, g)
    b, h, w, k = logits.shape
    if lse.dtype != torch.float32 or tuple(lse.shape) != tuple(labels.shape):
        raise ValueError(f"lse must be float32 {tuple(labels.shape)}, got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    if g.dtype != torch.float32 or g.numel() != 1:
        raise ValueError(f"g must be one float32 value, got {g.dtype} {tuple(g.shape)}")
    dlogits = torch.empty((b, h, w, k), dtype=torch.float32, device=logits.device)
    if logits.numel():
        geo = bwd_geometry(b, h, w, k, scale)
        _launch("upsample_ce_bwd", "ddp_upsample_ce_bwd", logits.device, logits.data_ptr(),
                labels.data_ptr(), lse.data_ptr(), g.data_ptr(), dlogits.data_ptr(), b, h,
                w, k, scale, int(ignore_index), _DTYPE_CODES[logits.dtype], geo.tile_h,
                geo.tile_w, *geo.grid, geo.smem_bytes)
    return dlogits


class _UpsampleCE(torch.autograd.Function):
    """(logits, labels) -> sums [NLL sum, count, correct]; only the NLL sum
    carries a gradient."""

    @staticmethod
    def forward(ctx, logits, labels, scale, ignore_index):
        if logits.device.type == "cuda":
            sums, lse = upsample_ce_fwd_cuda(logits, labels, scale, ignore_index)
        elif logits.device.type == "cpu":
            sums, lse = upsample_ce_fwd_plain(logits, labels, scale, ignore_index)
        else:
            raise ValueError(f"upsample_ce: unsupported device {logits.device}")
        ctx.save_for_backward(logits, labels, lse)
        ctx.scale, ctx.ignore_index = scale, ignore_index
        return sums

    @staticmethod
    def backward(ctx, g_sums):
        logits, labels, lse = ctx.saved_tensors
        if logits.device.type == "cuda":
            g = g_sums[:1].to(torch.float32).contiguous()
            d = upsample_ce_bwd_cuda(logits, labels, lse, g, ctx.scale, ctx.ignore_index)
        else:
            d = upsample_ce_grad_plain(logits, labels, lse, g_sums[0], ctx.scale,
                                       ctx.ignore_index)
        return d.to(logits.dtype), None, None, None


def upsample_ce(logits: torch.Tensor, labels: torch.Tensor, scale: int,
                ignore_index: int = 255, with_acc: bool = False):
    """CE of the x``scale`` bilinear upsample of ``logits`` against ``labels``
    (semantics of ``fused_upsample_ce``). Returns loss, or (loss, accuracy)."""
    sums = _UpsampleCE.apply(logits.contiguous(), labels.to(torch.int64).contiguous(),
                             scale, ignore_index)
    loss = sums[0] / labels.numel()
    if with_acc:
        return loss, global_accuracy(sums[2].detach(), sums[1].detach())
    return loss


def global_accuracy(correct: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """correct / max(count, 1); in a data-parallel step, of the global batch
    (the sums of every rank, as JAX's over the mesh-sharded batch)."""
    sums = sum_over_ranks(torch.stack([correct, count]))
    return sums[0] / torch.clamp(sums[1], min=1.0)
