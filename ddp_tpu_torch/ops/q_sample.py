"""Encode-map, q_sample and the table gradient: the analog-bits latent of a
class-index map, its corruption, and their VJPs.

Port of ``ddp_tpu/ops/pallas/q_sample.py`` (the ``_encode_kernel``,
``_qsample_kernel`` and ``_dtable_kernel`` Pallas kernels, their XLA oracles
and the closed-form VJPs ``_encode_bwd`` and ``_qs_bwd``)::

    encode_map:    x0[n, :]  = (sigmoid(table[labels[n], :]) * 2 - 1) * bit_scale
    q_sample:      out[n, :] = alpha[n] * x0[n, :] + sigma[n] * noise[n, :]
    dtable:        dtable[k, :] = sum over n with labels[n] == k of demb[n, :]
    squash_dtable: dtable of demb = g · alpha · 2·bit_scale·σ(1−σ),
                   σ = sigmoid(table[labels[n], :])

Each kernel has a wrapper that launches the hand-written CUDA kernel
(``ddp_tpu_torch/csrc/encode_map.cu``, ``csrc/q_sample.cu``) for CUDA tensors
and raises on anything it does not take, and a plain PyTorch version that
runs for CPU tensors. There is no fallback from one to the other.
``encode_map``'s forward is the registered op ``ddp_tpu_torch::encode_map``
(the kernel on CUDA tensors, the plain version on CPU tensors), which a
``torch.export`` program of ``sample`` holds and calls.
``encode_map`` and ``q_sample`` are differentiable (``torch.autograd.Function``)
with the JAX package's closed-form backward. Their table gradient is one
``squash_dtable`` launch, which reads the cotangent in its own type and takes
the squash's derivative from the table (``2·bit_scale·σ(1−σ)``) rather than
from the saved output; ``dtable`` is the same kernel without the derivative,
the counterpart of ``_dtable_kernel`` alone.

Out-of-range labels: the JAX oracle (``jnp.take``) fills NaN, the Pallas
kernel's one-hot gives 0. The plain versions here raise on them (they can
check, the tensor is on the host); the CUDA kernels give a zero row (and no
table gradient), like the Pallas kernel, and never read outside the table.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

# launches of each CUDA kernel since the last reset (chip_smoke.py reads them)
launches: Dict[str, int] = {"encode_map": 0, "q_sample": 0, "dtable": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# resident blocks of 256 threads per SM: the encode_map grid's size
ENCODE_BLOCKS_PER_SM = 8
# columns a (squash_)dtable block owns (kChunk of csrc/q_sample.cu), its
# threads (kThreads), the blocks per SM its grid is sized for, and the fewest
# and most rows a block takes (it sorts them in shared memory, 8 bytes each,
# beside 4 bytes per label, within the 48 KB a block has without opting in)
DTABLE_CHUNK = 64
DTABLE_THREADS = 512
DTABLE_BLOCKS_PER_SM = 2
DTABLE_MIN_ROWS = 256
DTABLE_MAX_ROWS = 4096
DTABLE_SMEM = 48 * 1024


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


def _acc(t: torch.Tensor) -> torch.Tensor:
    """``t`` in its accumulation type: float32, or float64 when it is float64
    (the plain versions then run in float64, for gradcheck)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _check_range(labels: torch.Tensor, k: int) -> None:
    if labels.device.type == "cpu" and labels.numel() and (
            int(labels.min()) < 0 or int(labels.max()) >= k):
        raise ValueError(f"labels outside [0, {k})")


def _check_cuda(name: str, labels: torch.Tensor, *tensors: torch.Tensor) -> None:
    if labels.device.type != "cuda" or any(t.device != labels.device for t in tensors):
        raise ValueError(f"{name}_cuda needs all tensors on one CUDA device, got "
                         f"{[str(t.device) for t in (labels,) + tensors]}")
    if labels.dtype != torch.int64 or labels.ndim != 1:
        raise ValueError(f"labels must be 1-D int64, got {labels.dtype} {tuple(labels.shape)}")
    if not all(t.is_contiguous() for t in (labels,) + tensors):
        raise ValueError(f"{name}_cuda needs contiguous tensors")


def _check_table(table: torch.Tensor) -> None:
    if table.dtype not in _DTYPE_CODES or table.ndim != 2:
        raise ValueError(f"table must be 2-D float32 or bfloat16, got "
                         f"{table.dtype} {tuple(table.shape)}")


def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch(name: str, entry: str, device: torch.device, *args) -> None:
    from ._build import launch

    launch(entry, device, *args)
    launches[name] += 1


def _dispatch(name: str, cuda_fn: Callable, plain_fn: Callable, device: torch.device,
              *args):
    if device.type == "cuda":
        return cuda_fn(*args)
    if device.type == "cpu":
        return plain_fn(*args)
    raise ValueError(f"{name}: unsupported device {device}")


# --- encode_map -----------------------------------------------------------

def encode_map_plain(labels: torch.Tensor, table: torch.Tensor,
                     bit_scale: float) -> torch.Tensor:
    """Plain PyTorch version: labels [N] int, table [K, C] -> [N, C] in
    table.dtype, squash computed in float32 (as the Pallas kernel does)."""
    _check_range(labels, table.shape[0])
    emb = _acc(F.embedding(labels, table))
    return ((torch.sigmoid(emb) * 2.0 - 1.0) * bit_scale).to(table.dtype)


def encode_map_cuda(labels: torch.Tensor, table: torch.Tensor,
                    bit_scale: float) -> torch.Tensor:
    """Launch the CUDA kernel: labels [N] int64, table [K, C] f32/bf16, both
    contiguous on one CUDA device. Returns [N, C] in table.dtype."""
    _check_cuda("encode_map", labels, table)
    _check_table(table)
    n, (k, c) = labels.shape[0], table.shape
    out = torch.empty((n, c), dtype=table.dtype, device=table.device)
    if n:
        _launch("encode_map", "ddp_encode_map", table.device, labels.data_ptr(),
                table.data_ptr(), out.data_ptr(), n, c, k, float(bit_scale),
                _DTYPE_CODES[table.dtype], _sm_count(table.device) * ENCODE_BLOCKS_PER_SM)
    return out


# --- q_sample -------------------------------------------------------------

def q_sample_plain(labels: torch.Tensor, table: torch.Tensor, bit_scale: float,
                   alpha: torch.Tensor, sigma: torch.Tensor,
                   noise: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: alpha·x0 + sigma·noise in float32 (x0 not rounded
    to the table's type), returned in noise.dtype."""
    _check_range(labels, table.shape[0])
    x0 = (torch.sigmoid(_acc(F.embedding(labels, table))) * 2.0 - 1.0) * bit_scale
    out = _acc(alpha)[:, None] * x0 + _acc(sigma)[:, None] * _acc(noise)
    return out.to(noise.dtype)


def q_sample_cuda(labels: torch.Tensor, table: torch.Tensor, bit_scale: float,
                  alpha: torch.Tensor, sigma: torch.Tensor,
                  noise: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel: labels [N] int64; table [K, C] and noise [N, C]
    of one type (f32/bf16); alpha, sigma [N] float32; all contiguous on one
    CUDA device. Returns [N, C] in noise.dtype."""
    _check_cuda("q_sample", labels, table, alpha, sigma, noise)
    _check_table(table)
    n, (k, c) = labels.shape[0], table.shape
    if noise.dtype != table.dtype or tuple(noise.shape) != (n, c):
        raise ValueError(f"noise must be {table.dtype} {(n, c)}, got "
                         f"{noise.dtype} {tuple(noise.shape)}")
    for name, t in (("alpha", alpha), ("sigma", sigma)):
        if t.dtype != torch.float32 or tuple(t.shape) != (n,):
            raise ValueError(f"{name} must be float32 ({n},), got {t.dtype} {tuple(t.shape)}")
    out = torch.empty_like(noise)
    if n:
        _launch("q_sample", "ddp_q_sample", table.device, labels.data_ptr(),
                table.data_ptr(), alpha.data_ptr(), sigma.data_ptr(), noise.data_ptr(),
                out.data_ptr(), n, c, k, float(bit_scale), _DTYPE_CODES[table.dtype])
    return out


# --- dtable and squash_dtable ----------------------------------------------

class DtableGeometry(NamedTuple):
    row_blocks: int      # grid x: blocks over the rows
    rows_per_block: int
    col_chunks: int      # grid y: blocks over the columns, DTABLE_CHUNK each
    smem_bytes: int      # the label counts and the block's rows sorted by label


def dtable_geometry(n: int, c: int, k: int, sms: int) -> DtableGeometry:
    """The (squash_)dtable launch: ``sms · DTABLE_BLOCKS_PER_SM`` blocks split
    over the column chunks, each over DTABLE_MIN_ROWS to DTABLE_MAX_ROWS
    rows, fewer where K leaves less of DTABLE_SMEM."""
    col_chunks = -(-c // DTABLE_CHUNK)
    row_blocks = -(-sms * DTABLE_BLOCKS_PER_SM // col_chunks)
    counts = (k + 2) // 2 * 2 * 4
    most = min(DTABLE_MAX_ROWS, (DTABLE_SMEM - counts) // 8)
    if most < 1:
        raise ValueError(f"dtable: K = {k} labels leave no shared memory for rows")
    rows = min(most, max(DTABLE_MIN_ROWS, -(-n // row_blocks)))
    return DtableGeometry(-(-n // rows), rows, col_chunks, counts + rows * 8)


def dtable_plain(labels: torch.Tensor, demb: torch.Tensor, k: int) -> torch.Tensor:
    """Plain PyTorch version: [K, C] row sums of demb by label, in float32
    (float64 for float64 demb)."""
    _check_range(labels, k)
    demb = _acc(demb)
    out = torch.zeros((k, demb.shape[1]), dtype=demb.dtype, device=demb.device)
    return out.index_add_(0, labels, demb)


def _squash_grad(labels: torch.Tensor, table: torch.Tensor, bit_scale: float,
                 g: torch.Tensor) -> torch.Tensor:
    """g · d x0 / d emb = g · 2·bit_scale·σ(1−σ), σ of the rows' table entries
    (f32). Labels are clamped for the lookup only: an out-of-range row gets no
    table gradient from the kernel, and the plain version refuses it."""
    sig = F.embedding(labels.clamp(0, table.shape[0] - 1), torch.sigmoid(_acc(table)))
    return g * (2.0 * bit_scale) * sig * (1.0 - sig)


def squash_dtable_plain(labels: torch.Tensor, g: torch.Tensor, alpha: Optional[torch.Tensor],
                        table: torch.Tensor, bit_scale: float) -> torch.Tensor:
    """Plain PyTorch version of the fused table gradient: ``dtable_plain`` of
    ``g · alpha · 2·bit_scale·σ(1−σ)`` (alpha None: 1), [K, C] float32
    (float64 for float64 inputs)."""
    g = _acc(g) if alpha is None else _acc(g) * _acc(alpha)[:, None]
    return dtable_plain(labels, _squash_grad(labels, table, bit_scale, g), table.shape[0])


def dtable_cuda(labels: torch.Tensor, demb: torch.Tensor, k: int) -> torch.Tensor:
    """Launch the CUDA kernel without the squash's derivative: labels [N]
    int64, demb [N, C] float32, both contiguous on one CUDA device. Returns
    [K, C] float32."""
    _check_cuda("dtable", labels, demb)
    n = labels.shape[0]
    if demb.dtype != torch.float32 or demb.ndim != 2 or demb.shape[0] != n:
        raise ValueError(f"demb must be float32 ({n}, C), got {demb.dtype} "
                         f"{tuple(demb.shape)}")
    c = demb.shape[1]
    out = torch.zeros((k, c), dtype=torch.float32, device=demb.device)
    if n:
        geo = dtable_geometry(n, c, k, _sm_count(demb.device))
        _launch("dtable", "ddp_dtable", demb.device, labels.data_ptr(), demb.data_ptr(),
                out.data_ptr(), n, c, k, geo.row_blocks, geo.rows_per_block)
    return out


def squash_dtable_cuda(labels: torch.Tensor, g: torch.Tensor, alpha: Optional[torch.Tensor],
                       table: torch.Tensor, bit_scale: float) -> torch.Tensor:
    """Launch the fused CUDA kernel: labels [N] int64; g [N, C] (columns
    contiguous, rows at a stride of at least C) and table [K, C], each
    float32 or bfloat16; alpha [N] float32 or None (1); the rest contiguous;
    all on one CUDA device. Returns [K, C] float32."""
    rest = (table,) if alpha is None else (table, alpha)
    _check_cuda("squash_dtable", labels, *rest)
    _check_table(table)
    n, (k, c) = labels.shape[0], table.shape
    if (g.device != labels.device or g.dtype not in _DTYPE_CODES or tuple(g.shape) != (n, c)
            or (n and (g.stride(1) != 1 or g.stride(0) < c))):
        raise ValueError(f"g must be float32 or bfloat16 {(n, c)} with contiguous columns "
                         f"on {labels.device}, got {g.dtype} {tuple(g.shape)} "
                         f"stride {g.stride()} on {g.device}")
    if alpha is not None and (alpha.dtype != torch.float32 or tuple(alpha.shape) != (n,)):
        raise ValueError(f"alpha must be float32 ({n},), got {alpha.dtype} "
                         f"{tuple(alpha.shape)}")
    out = torch.zeros((k, c), dtype=torch.float32, device=g.device)
    if n:
        geo = dtable_geometry(n, c, k, _sm_count(g.device))
        _launch("dtable", "ddp_squash_dtable", g.device, labels.data_ptr(), g.data_ptr(),
                g.stride(0), None if alpha is None else alpha.data_ptr(),
                table.data_ptr(), out.data_ptr(), n, c, k, float(bit_scale), _DTYPE_CODES[g.dtype],
                _DTYPE_CODES[table.dtype], geo.row_blocks, geo.rows_per_block)
    return out


# --- differentiable API ---------------------------------------------------

def _squash_dtable(labels: torch.Tensor, g: torch.Tensor, alpha: Optional[torch.Tensor],
                   table: torch.Tensor, bit_scale: float) -> torch.Tensor:
    """The table's gradient, in the table's type."""
    if g.stride(-1) != 1 or g.stride(0) < g.shape[-1]:  # e.g. an expanded cotangent
        g = g.contiguous()
    dtable = _dispatch("squash_dtable", squash_dtable_cuda, squash_dtable_plain, g.device,
                       labels, g, alpha, table, bit_scale)
    return dtable.to(table.dtype)


# ``torch.ops.ddp_tpu_torch.encode_map``: the forward of ``encode_map`` as a
# registered op, so that torch.export traces it (the fake implementation gives
# its shape) and a saved program calls it once this module is imported. The
# CUDA implementation is the hand-written kernel, the CPU one the plain
# version; any other device raises. Registering builds and loads nothing.
@torch.library.custom_op("ddp_tpu_torch::encode_map", mutates_args=(), device_types="cpu")
def _encode_map_op(labels: torch.Tensor, table: torch.Tensor,
                   bit_scale: float) -> torch.Tensor:
    return encode_map_plain(labels, table, bit_scale)


@_encode_map_op.register_kernel("cuda")
def _encode_map_op_cuda(labels: torch.Tensor, table: torch.Tensor,
                        bit_scale: float) -> torch.Tensor:
    return encode_map_cuda(labels, table, bit_scale)


@_encode_map_op.register_fake
def _encode_map_op_fake(labels: torch.Tensor, table: torch.Tensor,
                        bit_scale: float) -> torch.Tensor:
    return table.new_empty((labels.shape[0], table.shape[1]))


class _EncodeMap(torch.autograd.Function):
    @staticmethod
    def forward(ctx, labels, table, bit_scale):
        ctx.save_for_backward(labels, table)
        ctx.bit_scale = bit_scale
        return _encode_map_op(labels, table, float(bit_scale))

    @staticmethod
    def backward(ctx, g):
        labels, table = ctx.saved_tensors
        return None, _squash_dtable(labels, g, None, table, ctx.bit_scale), None


class _QSample(torch.autograd.Function):
    @staticmethod
    def forward(ctx, labels, table, bit_scale, alpha, sigma, noise):
        ctx.save_for_backward(labels, table, alpha, sigma, noise)
        ctx.bit_scale = bit_scale
        return _dispatch("q_sample", q_sample_cuda, q_sample_plain, labels.device,
                         labels, table, bit_scale, alpha, sigma, noise)

    @staticmethod
    def backward(ctx, g):
        labels, table, alpha, sigma, noise = ctx.saved_tensors
        _, need_table, _, need_alpha, need_sigma, need_noise = ctx.needs_input_grad
        dtable = dalpha = dsigma = dnoise = None
        if need_table:
            dtable = _squash_dtable(labels, g, alpha, table, ctx.bit_scale)
        gf = _acc(g) if need_alpha or need_sigma or need_noise else None
        if need_alpha:
            x0 = _acc(encode_map(labels, table, ctx.bit_scale))
            dalpha = (gf * x0).sum(-1).to(alpha.dtype)
        if need_sigma:
            dsigma = (gf * _acc(noise)).sum(-1).to(sigma.dtype)
        if need_noise:
            dnoise = (gf * _acc(sigma)[:, None]).to(noise.dtype)
        return None, dtable, None, dalpha, dsigma, dnoise


def encode_map(labels: torch.Tensor, table: torch.Tensor,
               bit_scale: float) -> torch.Tensor:
    """Squashed analog-bits latent [N, C] of labels [N]; differentiable in
    ``table``."""
    return _EncodeMap.apply(labels, table, bit_scale)


def q_sample(labels: torch.Tensor, table: torch.Tensor, bit_scale: float,
             alpha: torch.Tensor, sigma: torch.Tensor,
             noise: torch.Tensor) -> torch.Tensor:
    """x_t = alpha·encode(labels) + sigma·noise [N, C] in one pass;
    differentiable in table, alpha, sigma and noise. labels [N] int; table
    [K, C]; alpha, sigma [N] float32; noise [N, C] of the table's type."""
    return _QSample.apply(labels, table, bit_scale, alpha, sigma, noise)
