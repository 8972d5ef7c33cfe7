"""AutoencoderKL, SD's first-stage VAE (port of ``ddp_tpu/nn/autoencoder.py``;
reference: controlnet/ldm/models/autoencoder.py:13-115 and
ldm/modules/diffusionmodules/model.py). NCHW; flax module names
(``encoder/down_{level}_block_{i}``, ``down_{level}_downsample``,
``mid_block_1``, ``mid_attn``, ``decoder/up_{level}_block_{i}``,
``up_{level}_upsample``, ``quant_conv``, ``post_quant_conv``).

Geometry as JAX: a downsample pads right and bottom by 1, then runs a VALID
stride-2 conv; the decoder upsamples x2 nearest; a resnet block's GroupNorms
take gcd(32, channels) groups (the tiny widths), eps 1e-6 (flax's default).
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .attention import GN_EPS, VAEAttnBlock
from .common import PConv2d, GroupNorm
from .unet import upsample_nearest


def _gn(c: int) -> int:
    return math.gcd(32, c)


def _norm(c: int) -> GroupNorm:
    return GroupNorm(_gn(c), c, eps=GN_EPS)


class VAEResnetBlock(nn.Module):
    def __init__(self, channels: int, out_channels: int):
        super().__init__()
        self.norm1 = _norm(channels)
        self.conv1 = PConv2d(channels, out_channels, 3, padding=1)
        self.norm2 = _norm(out_channels)
        self.conv2 = PConv2d(out_channels, out_channels, 3, padding=1)
        self.nin_shortcut = (PConv2d(channels, out_channels, 1) if channels != out_channels
                             else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class VAEEncoder(nn.Module):
    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, z_channels: int = 4, double_z: bool = True,
                 in_channels: int = 3):
        super().__init__()
        self.ch_mult, self.num_res_blocks = tuple(ch_mult), num_res_blocks
        self.conv_in = PConv2d(in_channels, ch, 3, padding=1)
        c_in = ch
        for level, mult in enumerate(self.ch_mult):
            for i in range(num_res_blocks):
                self.add_module(f"down_{level}_block_{i}", VAEResnetBlock(c_in, ch * mult))
                c_in = ch * mult
            if level != len(self.ch_mult) - 1:
                self.add_module(f"down_{level}_downsample", PConv2d(c_in, c_in, 3, stride=2))
        self.mid_block_1 = VAEResnetBlock(c_in, c_in)
        self.mid_attn = VAEAttnBlock(c_in)
        self.mid_block_2 = VAEResnetBlock(c_in, c_in)
        self.norm_out = _norm(c_in)
        self.conv_out = PConv2d(c_in, 2 * z_channels if double_z else z_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for level in range(len(self.ch_mult)):
            for i in range(self.num_res_blocks):
                h = getattr(self, f"down_{level}_block_{i}")(h)
            if level != len(self.ch_mult) - 1:
                h = getattr(self, f"down_{level}_downsample")(F.pad(h, (0, 1, 0, 1)))
        h = self.mid_block_2(self.mid_attn(self.mid_block_1(h)))
        return self.conv_out(F.silu(self.norm_out(h)))


class VAEDecoder(nn.Module):
    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, out_channels: int = 3, z_channels: int = 4):
        super().__init__()
        self.ch_mult, self.num_res_blocks = tuple(ch_mult), num_res_blocks
        c_in = ch * self.ch_mult[-1]
        self.conv_in = PConv2d(z_channels, c_in, 3, padding=1)
        self.mid_block_1 = VAEResnetBlock(c_in, c_in)
        self.mid_attn = VAEAttnBlock(c_in)
        self.mid_block_2 = VAEResnetBlock(c_in, c_in)
        for level in reversed(range(len(self.ch_mult))):
            for i in range(num_res_blocks + 1):
                self.add_module(f"up_{level}_block_{i}",
                                VAEResnetBlock(c_in, ch * self.ch_mult[level]))
                c_in = ch * self.ch_mult[level]
            if level != 0:
                self.add_module(f"up_{level}_upsample", PConv2d(c_in, c_in, 3, padding=1))
        self.norm_out = _norm(c_in)
        self.conv_out = PConv2d(c_in, out_channels, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(z)
        h = self.mid_block_2(self.mid_attn(self.mid_block_1(h)))
        for level in reversed(range(len(self.ch_mult))):
            for i in range(self.num_res_blocks + 1):
                h = getattr(self, f"up_{level}_block_{i}")(h)
            if level != 0:
                h = getattr(self, f"up_{level}_upsample")(upsample_nearest(h))
        return self.conv_out(F.silu(self.norm_out(h)))


class AutoencoderKL(nn.Module):
    """``encode`` -> (mean, logvar clipped to [-30, 20]); ``decode`` maps
    latents back to images; 1x1 quant / post-quant convs (autoencoder.py:
    63-80). NCHW."""

    def __init__(self, embed_dim: int = 4, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, out_channels: int = 3):
        super().__init__()
        self.encoder = VAEEncoder(ch, ch_mult, num_res_blocks, z_channels=embed_dim)
        self.decoder = VAEDecoder(ch, ch_mult, num_res_blocks, out_channels=out_channels,
                                  z_channels=embed_dim)
        self.quant_conv = PConv2d(2 * embed_dim, 2 * embed_dim, 1)
        self.post_quant_conv = PConv2d(embed_dim, embed_dim, 1)

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        mean, logvar = self.quant_conv(self.encoder(x)).chunk(2, dim=1)
        return mean, torch.clamp(logvar, -30.0, 20.0)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z))
