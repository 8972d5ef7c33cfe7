"""ControlLDM: mask-conditioned Stable-Diffusion generation (port of
``ddp_tpu/models/controlnet.py``; reference: controlnet/cldm/cldm.py:308-435,
ldm/models/diffusion/ddpm.py:356-360,885-919, cldm/ddim_hacked.py).

A frozen SD stack (UNet ``diffusion_model``, VAE ``first_stage_model``, CLIP
text ``cond_stage_model``) and a trainable ``control_model``. The methods
take and give NHWC images and latents, as JAX's; inside, the UNet, the
ControlNet and the VAE run NCHW.

Training (``p_losses``, ``ControlNetTrainer.forward``): the image is encoded
to a sampled posterior latent times ``scale_factor``, t ~ U{0..999}, the
latent is corrupted with SD's linear-sqrt schedule, and the UNet fed the
ControlNet's residuals predicts the noise (MSE). The three draws (posterior
noise, t, noise; JAX splits one key three ways) come from the
``torch.Generator`` the caller passes, or are given; they are the only draws
of the training path (the UNet, the ControlNet, the VAE and CLIP have no
dropout). Each runs over the batch and goes through ``global_draw``, so a
rank of a data-parallel step draws the global batch's numbers and keeps its
rows, as JAX's one key over the sharded batch gives them.

Serving (``sample``): DDIM with classifier-free guidance, the batch doubled
to [uncond, cond] for one UNet pass a step, ``guess_mode``'s control scales
``0.825**(12 - i)`` cut by ``zip`` to the number of residuals (5 at the tiny
scale, as JAX's); the initial latent and each step's noise may be given.

Mixed precision: under the bf16 policy (bf16 weights, image and hint) the
schedule constants stay float32, so the corrupted latent is float32 and JAX's
type promotion runs the UNet and the ControlNet in float32 on the
bf16-rounded weights; the VAE encoder and CLIP run in bf16. The port's layers
promote likewise (``nn/common.py: PConv2d``).

The frozen parts are frozen by the optimizer (lr_mult 0, ``controlnet_sd15``'s
``custom_keys``), not in autograd: their gradients are taken and enter the
global-norm clip, as JAX's.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..nn.autoencoder import AutoencoderKL
from ..nn.clip_text import CLIPTextEncoder
from ..nn.unet import ControlNet, UNetConfig, UNetModel
from ..parallel.global_batch import global_draw


def make_beta_schedule(n_timestep: int = 1000, linear_start: float = 0.00085,
                       linear_end: float = 0.012) -> np.ndarray:
    """ddpm.py's 'linear' schedule: a float64 linspace in sqrt space, squared."""
    return np.linspace(linear_start ** 0.5, linear_end ** 0.5, n_timestep,
                       dtype=np.float64) ** 2


def make_ddim_timesteps(num_ddim: int, num_ddpm: int = 1000) -> np.ndarray:
    """The 'uniform' grid range(0, num_ddpm, num_ddpm // num_ddim) + 1, clipped
    in range (the reference fails where num_ddim does not divide num_ddpm)."""
    c = num_ddpm // num_ddim
    return np.minimum(np.arange(num_ddim) * c + 1, num_ddpm - 1)


class DDPMSchedule:
    """The diffusion constants, float64 on the host, kept as float32."""

    def __init__(self, n_timestep: int = 1000, linear_start: float = 0.00085,
                 linear_end: float = 0.012):
        betas = make_beta_schedule(n_timestep, linear_start, linear_end)
        self.num_timesteps = n_timestep
        self.alphas_cumprod = np.cumprod(1.0 - betas).astype(np.float32)
        self.sqrt_alphas_cumprod = np.sqrt(self.alphas_cumprod)
        self.sqrt_one_minus_alphas_cumprod = np.sqrt(1.0 - self.alphas_cumprod)

    def ddim_constants(self, steps: int, eta: float = 0.0):
        """(timesteps int32, alphas, previous alphas, sigmas float32) over the
        DDIM grid (ddim_hacked.py:30-53)."""
        ts = make_ddim_timesteps(steps, self.num_timesteps)
        a = self.alphas_cumprod[ts]
        a_prev = np.concatenate([[self.alphas_cumprod[0]], a[:-1]])
        sigmas = eta * np.sqrt((1 - a_prev) / (1 - a) * (1 - a / a_prev))
        return (ts.astype(np.int32), a.astype(np.float32), a_prev.astype(np.float32),
                sigmas.astype(np.float32))


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _f32(x) -> float:
    """A float32 value as a Python float (JAX computes the DDIM scalars in
    float32)."""
    return float(np.float32(x))


class ControlLDM(nn.Module):
    def __init__(self, unet: Optional[UNetConfig] = None, hint_channels: int = 3,
                 scale_factor: float = 0.18215, clip_width: int = 768, clip_layers: int = 12,
                 clip_vocab: int = 49408, vae_ch: int = 128,
                 vae_ch_mult: Sequence[int] = (1, 2, 4, 4), vae_nrb: int = 2,
                 only_mid_control: bool = False, device=None):
        super().__init__()
        cfg = unet or UNetConfig()
        self.unet_cfg = cfg
        self.scale_factor = scale_factor
        self.only_mid_control = only_mid_control
        self.vae_ch, self.vae_ch_mult, self.vae_nrb = vae_ch, tuple(vae_ch_mult), vae_nrb
        self.schedule = DDPMSchedule()
        with torch.device(resolve_device(device)):
            # the context's width is the text encoder's (flax infers it)
            self.diffusion_model = UNetModel(cfg, context_dim=clip_width)
            self.control_model = ControlNet(cfg, hint_channels,
                                            hint_downsample=self.latent_downsample,
                                            context_dim=clip_width)
            self.first_stage_model = AutoencoderKL(embed_dim=cfg.in_channels, ch=vae_ch,
                                                   ch_mult=vae_ch_mult, num_res_blocks=vae_nrb)
            self.cond_stage_model = CLIPTextEncoder(vocab_size=clip_vocab, width=clip_width,
                                                    layers=clip_layers,
                                                    heads=max(1, clip_width // 64))
            s = self.schedule
            # torch.tensor, unlike from_numpy, is made on the context's device
            self.register_buffer("sqrt_alphas_cumprod", torch.tensor(s.sqrt_alphas_cumprod),
                                 persistent=False)
            self.register_buffer("sqrt_one_minus_alphas_cumprod",
                                 torch.tensor(s.sqrt_one_minus_alphas_cumprod), persistent=False)

    @property
    def latent_downsample(self) -> int:
        """The first stage's spatial reduction (SD's VAE: 8)."""
        return 2 ** (len(self.vae_ch_mult) - 1)

    # --- the reference's surface (NHWC) ------------------------------------
    def encode_first_stage(self, img: torch.Tensor,
                           posterior_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """scale_factor · z, z the posterior mean, or the posterior sample of
        ``posterior_noise``."""
        return _nhwc(self._encode(_nchw(img), posterior_noise, None, False))

    def decode_first_stage(self, z: torch.Tensor) -> torch.Tensor:
        return _nhwc(self.first_stage_model.decode(_nchw(z) / self.scale_factor))

    def get_learned_conditioning(self, ids: torch.Tensor) -> torch.Tensor:
        return self.cond_stage_model(ids)

    def apply_model(self, x_noisy: torch.Tensor, t: torch.Tensor, context: torch.Tensor,
                    hint: torch.Tensor) -> torch.Tensor:
        """The ControlNet's residuals into the UNet (cldm.py:328-341)."""
        return _nhwc(self._apply_model(_nchw(x_noisy), t, context, _nchw(hint)))

    # --- NCHW internals ----------------------------------------------------
    def _encode(self, img, posterior_noise, generator, sample_posterior):
        mean, logvar = self.first_stage_model.encode(img)
        if posterior_noise is not None:
            eps = _nchw(posterior_noise).to(mean.dtype)
        elif sample_posterior:
            eps = global_draw(lambda s: torch.randn(s, generator=generator, dtype=mean.dtype,
                                                    device=mean.device), mean.shape)
        else:
            return self.scale_factor * mean
        return self.scale_factor * (mean + torch.exp(0.5 * logvar) * eps)

    def _apply_model(self, x, t, context, hint, scales=None):
        """``scales``: one per residual (``zip`` cuts them to the residuals)."""
        control = self.control_model(x, hint, t, context)
        if scales is not None:
            control = [c * s for c, s in zip(control, scales)]
        return self.diffusion_model(x, t, context, control=control,
                                    only_mid_control=self.only_mid_control)

    def p_losses(self, img: torch.Tensor, hint: torch.Tensor, ids: torch.Tensor,
                 t: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
                 posterior_noise: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """The eps-prediction MSE (ddpm.py:885-919). img [B, H, W, 3] in [-1, 1],
        hint [B, H, W, 3] in [0, 1], ids [B, T]; t [B] int, noise and
        posterior_noise [B, h, w, C] may be given."""
        z = self._encode(_nchw(img), posterior_noise, generator, True)
        context = self.get_learned_conditioning(ids)
        b = z.shape[0]
        if t is None:
            t = global_draw(lambda s: torch.randint(0, self.schedule.num_timesteps, s,
                                                    generator=generator, device=z.device),
                            (b,))
        t = t.long()
        if noise is None:
            noise = global_draw(lambda s: torch.randn(s, generator=generator, dtype=z.dtype,
                                                      device=z.device), z.shape)
        else:
            noise = _nchw(noise).to(z.dtype)
        z_noisy = (self.sqrt_alphas_cumprod[t][:, None, None, None] * z
                   + self.sqrt_one_minus_alphas_cumprod[t][:, None, None, None] * noise)
        eps = self._apply_model(z_noisy, t, context, _nchw(hint))
        return {"loss": torch.mean((eps - noise) ** 2)}

    @torch.no_grad()
    def sample(self, hint: torch.Tensor, ids: torch.Tensor, uncond_ids: torch.Tensor,
               steps: int = 20, guidance_scale: float = 9.0, eta: float = 0.0,
               guess_mode: bool = False, generator: Optional[torch.Generator] = None,
               x_T: Optional[torch.Tensor] = None,
               noise: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """DDIM with classifier-free guidance (ddim_hacked.py:123-238): decoded
        images [B, H, W, 3] in about [-1, 1]. hint [B, H, W, 3] in [0, 1].
        ``x_T`` [B, h, w, C] the initial latent; ``noise[i]`` the noise of the
        i-th step taken (scaled by its sigma; with eta 0 no noise enters)."""
        b, hh, ww = hint.shape[:3]
        ds = self.latent_downsample
        cin = self.unet_cfg.in_channels
        ts, a, a_prev, sigmas = self.schedule.ddim_constants(steps, eta)
        context = self.get_learned_conditioning(ids)
        ucontext = self.get_learned_conditioning(uncond_ids)
        # JAX multiplies by 1.0 outside guess mode, which changes no bit
        scales = [_f32(0.825 ** (12 - i)) for i in range(13)] if guess_mode else None
        if x_T is None:
            x = torch.randn((b, cin, hh // ds, ww // ds), generator=generator,
                            dtype=torch.float32, device=hint.device)
        else:
            x = _nchw(x_T).float()
        ctx2 = torch.cat([ucontext, context])
        hint2 = _nchw(torch.cat([hint, hint]))
        for i, k in enumerate(reversed(range(steps))):
            a_i, a_prev_i, sigma_i = a[k], a_prev[k], sigmas[k]
            tb = torch.full((2 * b,), int(ts[k]), dtype=torch.long, device=x.device)
            eps2 = self._apply_model(torch.cat([x, x]), tb, ctx2, hint2, scales)
            e_u, e_c = eps2.chunk(2)
            e_t = e_u + guidance_scale * (e_c - e_u)
            pred_x0 = (x - _f32(np.sqrt(np.float32(1.0) - a_i)) * e_t) / _f32(np.sqrt(a_i))
            dir_xt = _f32(np.sqrt(np.maximum(np.float32(1.0) - a_prev_i - sigma_i ** 2,
                                             np.float32(0.0)))) * e_t
            x = _f32(np.sqrt(a_prev_i)) * pred_x0 + dir_xt
            if noise is not None:
                x = x + _f32(sigma_i) * _nchw(noise[i]).float()
            elif sigma_i != 0:
                x = x + _f32(sigma_i) * torch.randn(x.shape, generator=generator,
                                                    dtype=x.dtype, device=x.device)
        return self.decode_first_stage(_nhwc(x))


class ControlNetTrainer(ControlLDM):
    """The train-loop adapter (tutorial_train.py): ``forward(img, hint, ids)``
    -> (loss, {"loss": loss}), with ``t=``, ``noise=``, ``posterior_noise=``
    and ``generator=`` as ``p_losses`` takes them. The reference freezes the
    SD UNet, VAE and CLIP (``sd_locked``); here, as in JAX, the optimizer
    does (``controlnet_sd15``'s lr_mult 0 rules); the end check's preset
    trains all but the VAE from scratch."""

    def forward(self, img, hint, ids, t=None, noise=None, posterior_noise=None,
                generator=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        loss = self.p_losses(img, hint, ids, t, noise, posterior_noise, generator)["loss"]
        return loss, {"loss": loss}


CONTROL_FROM_SD = ("encoder.", "middle.", "time_embed_0.", "time_embed_2.")


def add_control_from_sd(sd_unet: Mapping[str, torch.Tensor],
                        control_init: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Weight surgery (tool_add_control.py): a ControlNet state_dict whose time
    embedding, encoder and middle are copies of the SD UNet's (``sd_unet``,
    a ``UNetModel`` state_dict); the hint encoder and zero convs keep
    ``control_init``'s values."""
    return {k: (sd_unet[k].clone() if k.startswith(CONTROL_FROM_SD) and k in sd_unet
                else v.clone()) for k, v in control_init.items()}


def part_sizes(model: ControlLDM) -> List[Tuple[str, int]]:
    """(part, parameter count) of each of the four parts."""
    return [(name, sum(p.numel() for p in getattr(model, name).parameters()))
            for name in ("diffusion_model", "control_model", "first_stage_model",
                         "cond_stage_model")]
