"""Encode-map: class-index map -> squashed analog-bits latent.

Port of the forward of ``ddp_tpu/ops/pallas/q_sample.py:fused_encode_map``
(the ``_encode_kernel`` Pallas kernel and its XLA oracle ``encode_map_xla``):

    out[n, :] = (sigmoid(table[labels[n], :]) * 2 - 1) * bit_scale

On a CUDA tensor ``encode_map`` launches the hand-written kernel in
``ddp_tpu_torch/csrc/encode_map.cu`` or raises; on a CPU tensor it runs
``encode_map_plain``. There is no fallback from one to the other.

Out-of-range labels: the JAX oracle (``jnp.take``) fills NaN, the Pallas
kernel's one-hot gives 0. The plain version here raises on them (it can
check, the tensor is on the host); the CUDA kernel writes 0, like the Pallas
kernel, and never reads outside the table.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

# launches of the CUDA kernel since the last reset (chip_smoke.py reads it)
launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    global launches
    launches = 0


def encode_map_plain(labels: torch.Tensor, table: torch.Tensor,
                     bit_scale: float) -> torch.Tensor:
    """Plain PyTorch version: labels [N] int, table [K, C] -> [N, C] in
    table.dtype, squash computed in float32 (as the Pallas kernel does)."""
    if labels.device.type == "cpu" and labels.numel() and (
            int(labels.min()) < 0 or int(labels.max()) >= table.shape[0]):
        raise ValueError(f"labels outside [0, {table.shape[0]})")
    emb = F.embedding(labels, table).float()
    return ((torch.sigmoid(emb) * 2.0 - 1.0) * bit_scale).to(table.dtype)


def encode_map_cuda(labels: torch.Tensor, table: torch.Tensor,
                    bit_scale: float) -> torch.Tensor:
    """Launch the CUDA kernel: labels [N] int64, table [K, C] f32/bf16, both
    contiguous on one CUDA device. Returns [N, C] in table.dtype."""
    if labels.device.type != "cuda" or table.device != labels.device:
        raise ValueError(f"encode_map_cuda needs labels and table on one CUDA "
                         f"device, got {labels.device} and {table.device}")
    if labels.dtype != torch.int64 or labels.ndim != 1:
        raise ValueError(f"labels must be 1-D int64, got {labels.dtype} {tuple(labels.shape)}")
    if table.dtype not in _DTYPE_CODES or table.ndim != 2:
        raise ValueError(f"table must be 2-D float32 or bfloat16, got "
                         f"{table.dtype} {tuple(table.shape)}")
    if not (labels.is_contiguous() and table.is_contiguous()):
        raise ValueError("labels and table must be contiguous")
    n = labels.shape[0]
    k, c = table.shape
    out = torch.empty((n, c), dtype=table.dtype, device=table.device)
    if n == 0:
        return out
    from ._build import load_library

    lib = load_library()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ddp_encode_map(labels.data_ptr(), table.data_ptr(), out.data_ptr(),
                                 n, c, k, float(bit_scale), _DTYPE_CODES[table.dtype],
                                 stream)
    if err != 0:
        raise RuntimeError(f"encode_map CUDA kernel launch failed: cudaError {err}")
    global launches
    launches += 1
    return out


def encode_map(labels: torch.Tensor, table: torch.Tensor,
               bit_scale: float) -> torch.Tensor:
    """Squashed analog-bits latent [N, C]: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if labels.device.type == "cuda":
        return encode_map_cuda(labels, table, bit_scale)
    if labels.device.type == "cpu":
        return encode_map_plain(labels, table, bit_scale)
    raise ValueError(f"encode_map: unsupported device {labels.device}")
