"""Spatial transformer and cross-attention blocks of the latent-diffusion
UNet, and the VAE's attention block (port of ``ddp_tpu/nn/attention.py``;
reference: controlnet/ldm/modules/attention.py and
ldm/modules/diffusionmodules/model.py:119-160).

Token tensors are [B, N, C]; ``SpatialTransformer`` and ``VAEAttnBlock`` take
NCHW maps (the UNet's layout, ``nn/unet.py``) and flatten them in (h, w)
order, as JAX's NHWC reshape does.

Attention is ``F.scaled_dot_product_attention`` (JAX: XLA's
``jax.nn.dot_product_attention``, no Pallas kernel): no attention map is
materialised. On the card the backends are chosen, not left to PyTorch's
fallback: ``CUDA_BACKENDS`` (flash, else memory-efficient), and a shape
neither takes raises instead of dropping to the math backend, whose
[B, H, N, N] map at the 64² latent is 2.15 GB per self-attention at batch 4
x 8 heads. On the CPU PyTorch picks.

Parity traps: flax's ``LayerNorm`` and ``GroupNorm`` default to eps 1e-6
(torch's and the reference's: 1e-5), so every norm here passes 1e-6; JAX's
GEGLU gate is ``jax.nn.gelu``, the tanh form (the reference's is the exact
erf GELU; ROADMAP.md queue 3). Layers promote bf16 weights against float32
activations as flax does (``nn/common.py: PLinear``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .common import PGroupNorm, PLayerNorm, PLinear, gelu

LN_EPS = 1e-6  # flax's LayerNorm / GroupNorm default
GN_EPS = 1e-6


def cuda_backends():
    """The SDPA backends the card may take, in PyTorch's order of preference:
    flash (16-bit, head dim <= 256), then memory-efficient (any float type)."""
    from torch.nn.attention import SDPBackend

    return [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         is_causal: bool = False) -> torch.Tensor:
    """``F.scaled_dot_product_attention`` on [B, H, N, D]; on the card only
    through ``cuda_backends()``."""
    if q.device.type != "cuda":
        return F.scaled_dot_product_attention(q, k, v, is_causal=is_causal)
    from torch.nn.attention import sdpa_kernel

    with sdpa_kernel(cuda_backends()):
        return F.scaled_dot_product_attention(q, k, v, is_causal=is_causal)


def multihead_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        num_heads: int, is_causal: bool = False) -> torch.Tensor:
    """[B, Nq, H·D] queries against [B, Nk, H·D] keys and values. k and v are
    cast to q's type, as JAX does (``ddp_tpu/nn/attention.py:36-38``): under
    the bf16 policy a float32 query meets bf16 context keys."""
    b, nq, hd = q.shape
    d = hd // num_heads
    q = q.reshape(b, nq, num_heads, d).transpose(1, 2)
    k = k.reshape(b, k.shape[1], num_heads, d).transpose(1, 2).to(q.dtype)
    v = v.reshape(b, v.shape[1], num_heads, d).transpose(1, 2).to(q.dtype)
    out = sdpa(q, k, v, is_causal)
    return out.transpose(1, 2).reshape(b, nq, hd)


class CrossAttention(nn.Module):
    """q from x, k and v from the context (self-attention without one);
    to_q/to_k/to_v without bias, to_out with."""

    def __init__(self, query_dim: int, context_dim: Optional[int] = None, heads: int = 8,
                 dim_head: int = 64):
        super().__init__()
        inner = heads * dim_head
        context_dim = query_dim if context_dim is None else context_dim
        self.heads = heads
        self.to_q = PLinear(query_dim, inner, bias=False)
        self.to_k = PLinear(context_dim, inner, bias=False)
        self.to_v = PLinear(context_dim, inner, bias=False)
        self.to_out = PLinear(inner, query_dim)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        context = x if context is None else context
        out = multihead_attention(self.to_q(x), self.to_k(context), self.to_v(context),
                                  self.heads)
        return self.to_out(out)


class GEGLUFeedForward(nn.Module):
    """Linear to 2·4·dim, h · gelu(gate) (tanh GELU, as JAX), Linear back."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.proj_in = PLinear(dim, dim * mult * 2)
        self.proj_out = PLinear(dim * mult, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj_in(x).chunk(2, dim=-1)
        return self.proj_out(h * gelu(gate))


class BasicTransformerBlock(nn.Module):
    """Self-attention, cross-attention, GEGLU FFN, each pre-LN and residual."""

    def __init__(self, dim: int, context_dim: Optional[int] = None, heads: int = 8,
                 dim_head: int = 64):
        super().__init__()
        self.norm1 = PLayerNorm(dim, eps=LN_EPS)
        self.attn1 = CrossAttention(dim, None, heads, dim_head)
        self.norm2 = PLayerNorm(dim, eps=LN_EPS)
        self.attn2 = CrossAttention(dim, context_dim, heads, dim_head)
        self.norm3 = PLayerNorm(dim, eps=LN_EPS)
        self.ff = GEGLUFeedForward(dim)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    """GroupNorm, proj_in, ``depth`` transformer blocks over the h·w tokens,
    zero-initialised proj_out, residual. NCHW in and out. The projections
    are Linears (SD 1.5's 1x1 convs compute the same)."""

    def __init__(self, channels: int, heads: int, dim_head: int, depth: int = 1,
                 context_dim: Optional[int] = None):
        super().__init__()
        inner = heads * dim_head
        self.depth = depth
        self.norm = PGroupNorm(32, channels, eps=GN_EPS)
        self.proj_in = PLinear(channels, inner)
        for i in range(depth):
            self.add_module(f"block_{i}", BasicTransformerBlock(inner, context_dim, heads,
                                                                dim_head))
        self.proj_out = PLinear(inner, channels, zero_init=True)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, c, h, w = x.shape
        t = self.norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        t = self.proj_in(t)
        for i in range(self.depth):
            t = getattr(self, f"block_{i}")(t, context)
        t = self.proj_out(t)
        return t.reshape(b, h, w, c).permute(0, 3, 1, 2) + x


class VAEAttnBlock(nn.Module):
    """Single-head self-attention over the h·w tokens of the VAE's middle
    (GroupNorm of 32, q/k/v/proj_out Linears), residual. NCHW."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = PGroupNorm(32, channels, eps=GN_EPS)
        self.q = PLinear(channels, channels)
        self.k = PLinear(channels, channels)
        self.v = PLinear(channels, channels)
        self.proj_out = PLinear(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        t = self.norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        out = self.proj_out(multihead_attention(self.q(t), self.k(t), self.v(t), 1))
        return x + out.reshape(b, h, w, c).permute(0, 3, 1, 2)
