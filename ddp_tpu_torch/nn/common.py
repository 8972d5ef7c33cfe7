"""Common building blocks (port of ``ddp_tpu/nn/common.py:45-142``).

Tensors are NHWC at every module boundary, as in the JAX package; a conv
permutes to NCHW inside. ``DropPath`` is not ported: it is the identity at
eval, and the port serves only so far.

GELU parity trap: flax ``nn.gelu`` defaults to the tanh approximation, so
every GELU here is ``F.gelu(x, approximate="tanh")``; exact GELU differs by
about 1e-3 per activation.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.gelu`` (tanh approximation)."""
    return F.gelu(x, approximate="tanh")


_ACTS = {"relu": F.relu, "gelu": gelu, "silu": F.silu, None: None}


def make_norm(norm: Optional[str], channels: int) -> Optional[nn.Module]:
    """'GN' (32 groups), 'BN'/'SyncBN' (running stats at eval), or None."""
    if norm is None:
        return None
    if norm == "GN":
        return nn.GroupNorm(32, channels, eps=1e-5)
    if norm in ("BN", "SyncBN"):
        return nn.BatchNorm2d(channels, eps=1e-5)
    raise ValueError(f"unknown norm {norm!r}")


class ConvModule(nn.Module):
    """conv -> norm -> act (mmcv ConvModule; bias only without a norm).
    'SAME' padding for odd kernels, stride 1. NHWC in and out."""

    def __init__(self, in_channels: int, features: int,
                 kernel_size: Tuple[int, int] = (1, 1), norm: Optional[str] = None,
                 act: Optional[str] = None):
        super().__init__()
        if kernel_size[0] % 2 == 0 or kernel_size[1] % 2 == 0:
            raise ValueError(f"SAME padding needs odd kernels, got {kernel_size}")
        pad = (kernel_size[0] // 2, kernel_size[1] // 2)
        self.conv = nn.Conv2d(in_channels, features, kernel_size, padding=pad,
                              bias=norm is None)
        self.norm = make_norm(norm, features)
        self.act = _ACTS[act]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x.permute(0, 3, 1, 2))
        if self.norm is not None:
            x = self.norm(x)
        if self.act is not None:
            x = self.act(x)
        return x.permute(0, 2, 3, 1)


class Mlp(nn.Module):
    """Linear -> act -> Linear (transformer FFN core / time MLPs)."""

    def __init__(self, in_dim: int, hidden: int, out: int,
                 act: Callable[[torch.Tensor], torch.Tensor] = gelu):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, hidden)
        self.fc2 = nn.Linear(hidden, out)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


def init_params_(module: nn.Module, seed: int) -> None:
    """Fill every parameter from ``torch.Generator().manual_seed(seed)``, drawn
    on the CPU so that the weights do not depend on the device:
    matrices and conv kernels N(0, 1/fan_in), norm scales 1, biases 0,
    Swin relative-position biases N(0, 0.02^2), sinusoid frequencies N(0, 1)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "relative_position_bias_table":
                val = torch.randn(p.shape, generator=gen) * 0.02
            elif leaf == "weights":
                val = torch.randn(p.shape, generator=gen)
            elif leaf == "bias":
                val = torch.zeros(p.shape)
            elif p.ndim == 1:
                val = torch.ones(p.shape)
            else:
                fan_in = p[0].numel()
                val = torch.randn(p.shape, generator=gen) / fan_in ** 0.5
            p.copy_(val)
