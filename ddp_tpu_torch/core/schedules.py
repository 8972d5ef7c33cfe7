"""Continuous-time log-SNR noise schedules (port of ``ddp_tpu/core/schedules.py``).

Reference: segmentation/mmseg/models/segmentors/ddp.py:14-28 (schedules,
``log_snr_to_alpha_sigma``) and :204-213 (the sampling timestep grid);
depth/depth/models/depther/ddp.py:207-208 (``cosine_gamma``).
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch


def safe_log(t: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """log with the input clamped from below (reference ddp.py:14-15)."""
    return torch.log(torch.clamp(t, min=eps))


def beta_linear_log_snr(t: torch.Tensor) -> torch.Tensor:
    """Linear-beta schedule expressed as log SNR (reference ddp.py:18-19)."""
    return -torch.log(torch.expm1(1e-4 + 10.0 * (t ** 2)))


def alpha_cosine_log_snr(t: torch.Tensor, ns: float = 0.0002,
                         ds: float = 0.00025) -> torch.Tensor:
    """Cosine schedule expressed as log SNR (reference ddp.py:22-24)."""
    cos = torch.cos((t + ns) / (1.0 + ds) * math.pi * 0.5)
    return -safe_log(cos ** -2 - 1.0, eps=1e-5)


_SCHEDULES = {
    "linear": beta_linear_log_snr,
    "cosine": alpha_cosine_log_snr,
}


def get_log_snr_fn(name: str):
    """Look up a log-SNR schedule by name ('linear' | 'cosine')."""
    try:
        return _SCHEDULES[name]
    except KeyError:
        raise ValueError(
            f"invalid noise schedule {name!r}; choose from {sorted(_SCHEDULES)}")


def log_snr_to_alpha_sigma(log_snr: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """alpha = sqrt(sigmoid(log_snr)), sigma = sqrt(sigmoid(-log_snr))."""
    return torch.sqrt(torch.sigmoid(log_snr)), torch.sqrt(torch.sigmoid(-log_snr))


def cosine_gamma(t: torch.Tensor, ns: float = 0.0002, ds: float = 0.00025) -> torch.Tensor:
    """gamma(t) = cos²(((t + ns) / (1 + ds))·π/2), the depther's corruption
    coefficient: x_t = sqrt(gamma)·x0 + sqrt(1 − gamma)·noise."""
    return torch.cos((t + ns) / (1.0 + ds) * math.pi * 0.5) ** 2


def right_pad_dims_to(x_ndim: int, t: torch.Tensor) -> torch.Tensor:
    """Append singleton dims to ``t`` until it has ``x_ndim`` dims."""
    padding = x_ndim - t.ndim
    if padding <= 0:
        return t
    return t.reshape(t.shape + (1,) * padding)


def sampling_time_pairs(
    timesteps: int,
    sample_range: Tuple[float, float] = (0.0, 0.999),
    time_difference: float = 1.0,
) -> np.ndarray:
    """The (t_now, t_next) grid for the reverse rollout, [T, 2] float32.

      t_now  = 1 - (step / T) * (1 - s0)
      t_next = max(1 - (step + 1 + td) / T * (1 - s0), s0)
    """
    s0 = sample_range[0]
    pairs = []
    for step in range(timesteps):
        t_now = 1.0 - (step / timesteps) * (1.0 - s0)
        t_next = max(1.0 - (step + 1 + time_difference) / timesteps * (1.0 - s0), s0)
        pairs.append((t_now, t_next))
    return np.asarray(pairs, dtype=np.float32)
