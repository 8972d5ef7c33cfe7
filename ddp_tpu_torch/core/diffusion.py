"""The DDP diffusion engine: the multi-step reverse rollout (DDIM / DDPM).

Port of ``ddp_tpu/core/diffusion.py:37-196`` (reference ddp.py:156-165,215-290).
JAX draws the rollout's noise from PRNG keys inside ``rollout``; torch cannot
reproduce those bits, so here the caller hands in the initial latent noise
(and, for DDPM, the per-step noise). The model-side ``denoise_fn`` maps
(noisy map latent, log_snr [N]) -> (task logits, re-encoded x0 latent);
layouts are NHWC with randsteps·batch folded into the leading axis.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import torch

from ..parallel.global_batch import global_draw
from .schedules import (
    get_log_snr_fn,
    log_snr_to_alpha_sigma,
    right_pad_dims_to,
    safe_log,
    sampling_time_pairs,
)

DenoiseFn = Callable[[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    """Static hyper-parameters of the DDP diffusion process (ddp.py:56-66)."""

    timesteps: int = 3
    randsteps: int = 1
    time_difference: float = 1.0
    sample_range: Tuple[float, float] = (0.0, 0.999)
    schedule: str = "cosine"
    method: str = "ddim"  # 'ddim' | 'ddpm'
    accumulation: bool = True

    @property
    def log_snr_fn(self):
        return get_log_snr_fn(self.schedule)

    def time_pairs(self):
        return sampling_time_pairs(self.timesteps, self.sample_range, self.time_difference)


def sample_times(batch: int, sample_range: Tuple[float, float],
                 generator: Optional[torch.Generator] = None,
                 device=None) -> torch.Tensor:
    """t ~ U(sample_range) per sample, float32 [batch] (reference ddp.py:156-158)."""
    lo, hi = sample_range
    u = global_draw(lambda s: torch.rand(s, generator=generator, dtype=torch.float32,
                                         device=device), (batch,))
    return lo + (hi - lo) * u


def q_sample(x0: torch.Tensor, log_snr: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """alpha(log_snr) * x0 + sigma(log_snr) * noise; ``log_snr`` is [B]."""
    alpha, sigma = log_snr_to_alpha_sigma(right_pad_dims_to(x0.ndim, log_snr))
    return alpha * x0 + sigma * noise


def ddim_update(mask_t: torch.Tensor, x0_pred: torch.Tensor, log_snr: torch.Tensor,
                log_snr_next: torch.Tensor) -> torch.Tensor:
    """One DDIM reverse step (reference ddp.py:233-239)."""
    alpha, sigma = log_snr_to_alpha_sigma(right_pad_dims_to(mask_t.ndim, log_snr))
    alpha_next, sigma_next = log_snr_to_alpha_sigma(
        right_pad_dims_to(mask_t.ndim, log_snr_next))
    pred_noise = (mask_t - alpha * x0_pred) / torch.clamp(sigma, min=1e-8)
    return x0_pred * alpha_next + pred_noise * sigma_next


def ddpm_update(mask_t: torch.Tensor, x0_pred: torch.Tensor, log_snr: torch.Tensor,
                log_snr_next: torch.Tensor, t_next: torch.Tensor,
                noise: torch.Tensor) -> torch.Tensor:
    """One DDPM posterior step (reference ddp.py:266-280)."""
    p = right_pad_dims_to(mask_t.ndim, log_snr)
    pn = right_pad_dims_to(mask_t.ndim, log_snr_next)
    alpha, _ = log_snr_to_alpha_sigma(p)
    alpha_next, sigma_next = log_snr_to_alpha_sigma(pn)
    c = -torch.expm1(p - pn)
    mean = alpha_next * (mask_t * (1.0 - c) / alpha + c * x0_pred)
    log_variance = safe_log((sigma_next ** 2) * c)
    gate = right_pad_dims_to(mask_t.ndim, (t_next > 0).to(mask_t.dtype))
    return mean + torch.exp(0.5 * log_variance) * gate * noise


def rollout(
    cfg: DiffusionConfig,
    denoise_fn: DenoiseFn,
    init_noise: torch.Tensor,
    step_noise: Optional[Sequence[torch.Tensor]] = None,
) -> torch.Tensor:
    """Run the reverse process from ``init_noise`` ([N, ..., C]).

    ``step_noise`` holds one tensor shaped like ``init_noise`` per step and is
    read only by DDPM. Returns the mean softmax over steps ([N, ..., K]) when
    ``cfg.accumulation``, else the final step's logits.
    """
    if cfg.method not in ("ddim", "ddpm"):
        raise ValueError(f"unknown diffusion method {cfg.method!r}")
    if cfg.method == "ddpm" and (step_noise is None or len(step_noise) != cfg.timesteps):
        raise ValueError("DDPM needs one step_noise tensor per timestep")
    mask_t = init_noise
    n = mask_t.shape[0]
    outs = []
    for i, (t_now, t_next) in enumerate(cfg.time_pairs().tolist()):
        t_now_b = torch.full((n,), t_now, dtype=mask_t.dtype, device=mask_t.device)
        t_next_b = torch.full((n,), t_next, dtype=mask_t.dtype, device=mask_t.device)
        log_snr = cfg.log_snr_fn(t_now_b)
        log_snr_next = cfg.log_snr_fn(t_next_b)
        logits, x0_pred = denoise_fn(mask_t, log_snr)
        if cfg.method == "ddim":
            mask_t = ddim_update(mask_t, x0_pred, log_snr, log_snr_next)
        else:
            mask_t = ddpm_update(mask_t, x0_pred, log_snr, log_snr_next, t_next_b,
                                 step_noise[i])
        outs.append(torch.softmax(logits, dim=-1) if cfg.accumulation else logits)
    if cfg.accumulation:
        return torch.stack(outs, dim=0).mean(dim=0)
    return outs[-1]
