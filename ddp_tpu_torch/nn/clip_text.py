"""The CLIP ViT-L/14 text encoder, SD's frozen conditioning model (port of
``ddp_tpu/nn/clip_text.py``; reference: FrozenCLIPEmbedder, controlnet/ldm/
modules/encoders/modules.py:88-115, which wraps HF ``CLIPTextModel``).

Token ids in, the last hidden state [B, T, width] out: token embedding plus a
learned ``position_embedding`` parameter, blocks of causal self-attention
through one fused qkv projection and a quick-GELU MLP, pre-LN (eps 1e-6,
flax's default; HF's ``layer_norm_eps`` is 1e-5: ROADMAP.md queue 3), a final
LayerNorm.

``tokenize`` needs the HF CLIP BPE tokenizer's assets on disk, as JAX's
does; without them it raises, and callers pass ids (``dummy_ids``, or the
toy vocabulary of ``data/controlnet_data.py``).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from .attention import LN_EPS, sdpa
from .common import PLayerNorm, PLinear

BOS, EOS = 49406, 49407


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class CLIPTextBlock(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.ln_1 = PLayerNorm(width, eps=LN_EPS)
        self.qkv = PLinear(width, 3 * width)
        self.out_proj = PLinear(width, width)
        self.ln_2 = PLayerNorm(width, eps=LN_EPS)
        self.fc1 = PLinear(width, 4 * width)
        self.fc2 = PLinear(4 * width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, w = x.shape
        d = w // self.heads
        q, k, v = (t.reshape(b, n, self.heads, d).transpose(1, 2)
                   for t in self.qkv(self.ln_1(x)).chunk(3, dim=-1))
        attn = sdpa(q, k, v, is_causal=True).transpose(1, 2).reshape(b, n, w)
        x = x + self.out_proj(attn)
        return x + self.fc2(quick_gelu(self.fc1(self.ln_2(x))))


class CLIPTextEncoder(nn.Module):
    def __init__(self, vocab_size: int = 49408, width: int = 768, layers: int = 12,
                 heads: int = 12, max_len: int = 77):
        super().__init__()
        self.layers = layers
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.position_embedding = nn.Parameter(torch.empty(max_len, width))
        for i in range(layers):
            self.add_module(f"block_{i}", CLIPTextBlock(width, heads))
        self.ln_final = PLayerNorm(width, eps=LN_EPS)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        x = self.token_embedding(ids.long()) + self.position_embedding[None, :ids.shape[1]]
        for i in range(self.layers):
            x = getattr(self, f"block_{i}")(x)
        return self.ln_final(x)


def tokenize(texts: Sequence[str], max_len: int = 77) -> np.ndarray:
    """Ids [len(texts), max_len] int32 from the HF CLIP tokenizer's local
    assets; without them (no network here) a RuntimeError, as JAX's."""
    try:
        from transformers import CLIPTokenizerFast

        tok = CLIPTokenizerFast.from_pretrained("openai/clip-vit-large-patch14",
                                                local_files_only=True)
    except Exception as e:
        raise RuntimeError("CLIP tokenizer assets not available locally; pass precomputed "
                           "token ids to CLIPTextEncoder instead") from e
    out = tok(list(texts), padding="max_length", truncation=True, max_length=max_len,
              return_tensors="np")
    return out["input_ids"].astype(np.int32)


def dummy_ids(batch: int, max_len: int = 77) -> np.ndarray:
    """BOS then EOS padding: the empty prompt's ids, the unconditional rows of
    classifier-free guidance (cldm.py:344-346)."""
    ids = np.full((batch, max_len), EOS, np.int32)
    ids[:, 0] = BOS
    return ids
