"""Stable-Diffusion UNet and its ControlNet copy (port of
``ddp_tpu/nn/unet.py``; reference: controlnet/ldm/modules/diffusionmodules/
openaimodel.py:412-797, controlnet/cldm/cldm.py:22-305).

Maps are NCHW here (JAX: NHWC), so the decoder's skip concat is on dim 1 and
a flax Conv kernel [kh, kw, in, out] loads as [out, in, kh, kw]
(``convert.py``). Module names are the flax ones (``encoder/res_{level}_{i}``,
``attn_{level}_{i}``, ``down_{level}``, ``middle/mid_res1``, ``up_res_{level}_{i}``,
``hint/conv_{i}``, ``zero_conv_{i}``, ...).

A flax Dense infers its input width; here the cross-attention's key and value
projections are sized by ``context_dim``, which ``models/controlnet.py`` sets
to the text encoder's width (the tiny preset's ``UNetConfig.context_dim`` of
16 is not the width of the context JAX feeds it, 64).

``ResBlock``'s up/down resampling is not ported: no UNet block of either
package sets it.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .attention import GN_EPS, SpatialTransformer
from .common import PConv2d, PGroupNorm, PLinear


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding [B, dim] of [B] timesteps, [cos, sin] order,
    float32 (ldm diffusionmodules/util.py:222-240)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half)
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb


def upsample_nearest(x: torch.Tensor) -> torch.Tensor:
    """x2 nearest (``jax.image.resize`` 'nearest' at an exact factor of 2)."""
    return F.interpolate(x, scale_factor=2.0, mode="nearest")


class ResBlock(nn.Module):
    """GN, SiLU, 3x3 conv, + the time embedding (added, or scale-shift), GN,
    SiLU, zero-initialised 3x3 conv, 1x1 skip where the width changes."""

    def __init__(self, channels: int, out_channels: int, emb_dim: int,
                 use_scale_shift_norm: bool = False):
        super().__init__()
        self.use_scale_shift_norm = use_scale_shift_norm
        self.in_norm = PGroupNorm(32, channels, eps=GN_EPS)
        self.in_conv = PConv2d(channels, out_channels, 3, padding=1)
        self.emb_proj = PLinear(emb_dim, out_channels * (2 if use_scale_shift_norm else 1))
        self.out_norm = PGroupNorm(32, out_channels, eps=GN_EPS)
        self.out_conv = PConv2d(out_channels, out_channels, 3, padding=1, zero_init=True)
        self.skip = PConv2d(channels, out_channels, 1) if out_channels != channels else None

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = self.in_conv(F.silu(self.in_norm(x)))
        e = self.emb_proj(F.silu(emb))[:, :, None, None]
        if self.use_scale_shift_norm:
            scale, shift = e.chunk(2, dim=1)
            h = self.out_norm(h) * (1 + scale) + shift
        else:
            h = self.out_norm(h + e)
        h = self.out_conv(F.silu(h))
        if self.skip is not None:
            x = self.skip(x)
        return x + h


class Upsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = PConv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(upsample_nearest(x))


class Downsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = PConv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class UNetConfig:
    """SD 1.5 defaults (controlnet/models/cldm_v15.yaml unet_config)."""

    def __init__(self, in_channels=4, model_channels=320, out_channels=4,
                 num_res_blocks=2, attention_resolutions=(4, 2, 1),
                 channel_mult=(1, 2, 4, 4), num_heads=8, context_dim=768,
                 transformer_depth=1, use_linear_in_transformer=False,
                 use_scale_shift_norm=False):
        self.in_channels = in_channels
        self.model_channels = model_channels
        self.out_channels = out_channels
        self.num_res_blocks = num_res_blocks
        self.attention_resolutions = tuple(attention_resolutions)
        self.channel_mult = tuple(channel_mult)
        self.num_heads = num_heads
        self.context_dim = context_dim
        self.transformer_depth = transformer_depth
        self.use_linear_in_transformer = use_linear_in_transformer
        self.use_scale_shift_norm = use_scale_shift_norm

    def tiny(self) -> "UNetConfig":
        """The test scale: 32 channels, one res block a level, one 2x level
        with cross-attention."""
        return UNetConfig(in_channels=4, model_channels=32, out_channels=4,
                          num_res_blocks=1, attention_resolutions=(2,),
                          channel_mult=(1, 2), num_heads=2, context_dim=16)

    def small(self) -> "UNetConfig":
        """The end check's scale (``converge_controlnet``): SD's topology at
        64 channels, three levels."""
        return UNetConfig(in_channels=4, model_channels=64, out_channels=4,
                          num_res_blocks=2, attention_resolutions=(1, 2),
                          channel_mult=(1, 2, 4), num_heads=4, context_dim=64)


def _level_plan(cfg: UNetConfig):
    """(level, channels, has cross-attention, downsampling so far) of each
    encoder level."""
    plan, ds = [], 1
    for level, mult in enumerate(cfg.channel_mult):
        plan.append((level, cfg.model_channels * mult, ds in cfg.attention_resolutions, ds))
        ds *= 2
    return plan


def _transformer(cfg: UNetConfig, ch: int, context_dim: int) -> SpatialTransformer:
    return SpatialTransformer(ch, cfg.num_heads, ch // cfg.num_heads, cfg.transformer_depth,
                              context_dim)


def skip_channels(cfg: UNetConfig) -> List[int]:
    """The width of each encoder activation the decoder pops (and of each
    ControlNet residual but the middle's), in push order."""
    out = [cfg.model_channels]
    for level, ch, _, _ in _level_plan(cfg):
        out += [ch] * cfg.num_res_blocks
        if level != len(cfg.channel_mult) - 1:
            out.append(ch)
    return out


class UNetEncoder(nn.Module):
    """The input blocks: (h, every skip activation). Shared by the UNet and
    the ControlNet, which adds the guided hint after ``conv_in``."""

    def __init__(self, cfg: UNetConfig, emb_dim: int, context_dim: int):
        super().__init__()
        self.cfg = cfg
        self.conv_in = PConv2d(cfg.in_channels, cfg.model_channels, 3, padding=1)
        ch_in = cfg.model_channels
        for level, ch, attn, _ in _level_plan(cfg):
            for i in range(cfg.num_res_blocks):
                self.add_module(f"res_{level}_{i}", ResBlock(ch_in, ch, emb_dim,
                                                             cfg.use_scale_shift_norm))
                if attn:
                    self.add_module(f"attn_{level}_{i}", _transformer(cfg, ch, context_dim))
                ch_in = ch
            if level != len(cfg.channel_mult) - 1:
                self.add_module(f"down_{level}", Downsample(ch))
        self.out_channels = ch_in

    def forward(self, x, emb, context, hint=None):
        cfg = self.cfg
        h = self.conv_in(x)
        if hint is not None:
            h = h + hint
        hs = [h]
        for level, _, attn, _ in _level_plan(cfg):
            for i in range(cfg.num_res_blocks):
                h = getattr(self, f"res_{level}_{i}")(h, emb)
                if attn:
                    h = getattr(self, f"attn_{level}_{i}")(h, context)
                hs.append(h)
            if level != len(cfg.channel_mult) - 1:
                h = getattr(self, f"down_{level}")(h)
                hs.append(h)
        return h, hs


class UNetMiddle(nn.Module):
    def __init__(self, cfg: UNetConfig, ch: int, emb_dim: int, context_dim: int):
        super().__init__()
        self.mid_res1 = ResBlock(ch, ch, emb_dim, cfg.use_scale_shift_norm)
        self.mid_attn = _transformer(cfg, ch, context_dim)
        self.mid_res2 = ResBlock(ch, ch, emb_dim, cfg.use_scale_shift_norm)

    def forward(self, h, emb, context):
        h = self.mid_res1(h, emb)
        h = self.mid_attn(h, context)
        return self.mid_res2(h, emb)


class _TimeEmbed(nn.Module):
    """time_embed_0 / time_embed_2 of the sinusoidal embedding, SiLU between."""

    def _init_time(self, cfg: UNetConfig) -> int:
        emb_dim = cfg.model_channels * 4
        self.time_embed_0 = PLinear(cfg.model_channels, emb_dim)
        self.time_embed_2 = PLinear(emb_dim, emb_dim)
        return emb_dim

    def time_embed(self, timesteps: torch.Tensor) -> torch.Tensor:
        emb = self.time_embed_0(timestep_embedding(timesteps, self.cfg.model_channels))
        return self.time_embed_2(F.silu(emb))


class UNetModel(_TimeEmbed):
    """The SD UNet. ``control``: the ControlNet's residuals (one per skip, then
    the middle's), as ControlledUnetModel adds them (cldm.py:23-45): the last
    onto the middle's output, the others onto the popped skips (none with
    ``only_mid_control``)."""

    def __init__(self, cfg: UNetConfig, context_dim: Optional[int] = None):
        super().__init__()
        self.cfg = cfg
        context_dim = cfg.context_dim if context_dim is None else context_dim
        emb_dim = self._init_time(cfg)
        self.encoder = UNetEncoder(cfg, emb_dim, context_dim)
        h_ch = self.encoder.out_channels
        self.middle = UNetMiddle(cfg, h_ch, emb_dim, context_dim)
        skips = skip_channels(cfg)
        ds = 2 ** (len(cfg.channel_mult) - 1)
        for level in reversed(range(len(cfg.channel_mult))):
            ch = cfg.model_channels * cfg.channel_mult[level]
            for i in range(cfg.num_res_blocks + 1):
                self.add_module(f"up_res_{level}_{i}",
                                ResBlock(h_ch + skips.pop(), ch, emb_dim,
                                         cfg.use_scale_shift_norm))
                if ds in cfg.attention_resolutions:
                    self.add_module(f"up_attn_{level}_{i}", _transformer(cfg, ch, context_dim))
                h_ch = ch
            if level != 0:
                self.add_module(f"up_{level}", Upsample(ch))
                ds //= 2
        self.out_norm = PGroupNorm(32, h_ch, eps=GN_EPS)
        self.out_conv = PConv2d(h_ch, cfg.out_channels, 3, padding=1, zero_init=True)

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor, context: torch.Tensor,
                control: Optional[Sequence[torch.Tensor]] = None,
                only_mid_control: bool = False) -> torch.Tensor:
        cfg = self.cfg
        emb = self.time_embed(timesteps)
        h, hs = self.encoder(x, emb, context)
        h = self.middle(h, emb, context)
        if control is not None:
            h = h + control[-1]
            control = list(control[:-1])
        ds = 2 ** (len(cfg.channel_mult) - 1)
        for level in reversed(range(len(cfg.channel_mult))):
            for i in range(cfg.num_res_blocks + 1):
                skip = hs.pop()
                if control is not None and not only_mid_control:
                    skip = skip + control.pop()
                h = getattr(self, f"up_res_{level}_{i}")(torch.cat([h, skip], dim=1), emb)
                if ds in cfg.attention_resolutions:
                    h = getattr(self, f"up_attn_{level}_{i}")(h, context)
            if level != 0:
                h = getattr(self, f"up_{level}")(h)
                ds //= 2
        return self.out_conv(F.silu(self.out_norm(h)))


# input_hint_block (cldm.py:109-120): (channels, stride) of its 3x3 convs
HINT_PLAN = ((16, 1), (16, 1), (32, 2), (32, 1), (96, 2), (96, 1), (256, 2))


class HintEncoder(nn.Module):
    """The hint image (NCHW, [0, 1]) to ``model_channels`` on the latent grid:
    7 SiLU'd 3x3 convs (three of stride 2) and a zero-initialised conv. For a
    first stage that reduces by less than 8, the last stride-2 convs run at
    stride 1, as JAX's does. ``downsample`` must be 1, 2, 4 or 8: JAX's flip
    logic takes 16 silently and lands the hint at 1/8 (ROADMAP.md queue 3)."""

    def __init__(self, model_channels: int, downsample: int = 8, hint_channels: int = 3):
        super().__init__()
        if downsample not in (1, 2, 4, 8):
            raise ValueError(f"HintEncoder: downsample must be 1, 2, 4 or 8 (the 8x hint "
                             f"block with stride-2 convs turned to stride 1), got {downsample}")
        plan = [list(e) for e in HINT_PLAN]
        n_flip = 3 - int(math.log2(downsample))
        for entry in reversed(plan):
            if n_flip <= 0:
                break
            if entry[1] == 2:
                entry[1] = 1
                n_flip -= 1
        self.plan = tuple(tuple(e) for e in plan)
        ch_in = hint_channels
        for i, (ch, s) in enumerate(self.plan):
            self.add_module(f"conv_{i}", PConv2d(ch_in, ch, 3, stride=s, padding=1))
            ch_in = ch
        self.zero_conv = PConv2d(ch_in, model_channels, 3, padding=1, zero_init=True)

    def forward(self, hint: torch.Tensor) -> torch.Tensor:
        h = hint
        for i in range(len(self.plan)):
            h = F.silu(getattr(self, f"conv_{i}")(h))
        return self.zero_conv(h)


class ControlNet(_TimeEmbed):
    """The encoder copy, the hint encoder, and a zero-initialised 1x1 conv on
    each skip activation and on the middle: the residuals [13 at SD 1.5]
    (cldm.py:284-305). NCHW."""

    def __init__(self, cfg: UNetConfig, hint_channels: int = 3, hint_downsample: int = 8,
                 context_dim: Optional[int] = None):
        super().__init__()
        self.cfg = cfg
        context_dim = cfg.context_dim if context_dim is None else context_dim
        emb_dim = self._init_time(cfg)
        self.hint = HintEncoder(cfg.model_channels, hint_downsample, hint_channels)
        self.encoder = UNetEncoder(cfg, emb_dim, context_dim)
        h_ch = self.encoder.out_channels
        self.middle = UNetMiddle(cfg, h_ch, emb_dim, context_dim)
        self.n_skips = len(skip_channels(cfg))
        for i, ch in enumerate(skip_channels(cfg)):
            self.add_module(f"zero_conv_{i}", PConv2d(ch, ch, 1, zero_init=True))
        self.middle_out = PConv2d(h_ch, h_ch, 1, zero_init=True)

    def forward(self, x: torch.Tensor, hint: torch.Tensor, timesteps: torch.Tensor,
                context: torch.Tensor) -> List[torch.Tensor]:
        emb = self.time_embed(timesteps)
        h, hs = self.encoder(x, emb, context, hint=self.hint(hint))
        h = self.middle(h, emb, context)
        outs = [getattr(self, f"zero_conv_{i}")(s) for i, s in enumerate(hs)]
        outs.append(self.middle_out(h))
        return outs
