"""Time (noise-level) embeddings (port of ``ddp_tpu/nn/time_embed.py``).

``LearnedSinusoidalPosEmb`` + the 17 -> dim -> dim GELU MLP of the reference
(ddp.py:31-46,102-112); its input is the log-SNR, not t.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .common import gelu


class LearnedSinusoidalPosEmb(nn.Module):
    """x -> [x, sin(2π·x·w), cos(2π·x·w)] with learned frequencies w (dim/2)."""

    def __init__(self, dim: int = 16):
        super().__init__()
        if dim % 2:
            raise ValueError(f"dim must be even, got {dim}")
        self.weights = nn.Parameter(torch.empty(dim // 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        freqs = x[:, None] * self.weights[None, :] * 2.0 * math.pi
        return torch.cat([x[:, None], torch.sin(freqs), torch.cos(freqs)], dim=-1)


class TimeMLP(nn.Module):
    """LearnedSinusoidalPosEmb(16) -> Linear(17, dim) -> GELU(tanh) -> Linear(dim, dim)."""

    def __init__(self, dim: int = 1024, sinusoidal_dim: int = 16):
        super().__init__()
        self.pos_emb = LearnedSinusoidalPosEmb(sinusoidal_dim)
        self.fc1 = nn.Linear(sinusoidal_dim + 1, dim)
        self.fc2 = nn.Linear(dim, dim)

    def forward(self, log_snr: torch.Tensor) -> torch.Tensor:
        # the embedding is computed in the log-SNR's type (float32 in
        # training) and enters the MLP in the weights' type (bf16 under the
        # mixed-precision policy)
        emb = self.pos_emb(log_snr).to(self.fc1.weight.dtype)
        return self.fc2(gelu(self.fc1(emb)))
