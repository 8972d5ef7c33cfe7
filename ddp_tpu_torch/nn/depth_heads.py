"""The depth toolbox's decode heads beyond the DDP deformable head (port of
``ddp_tpu/nn/depth_heads.py``).

  - ``DenseDepthHead`` (densedepth_head.py): a top-down decoder (``conv0``,
    then ``UpSampleFuse``: align_corners upsample to the skip, concat,
    convA, convB) and a 3x3 ``conv_depth``; sigmoid·max_depth (``scale_up``)
    or relu + min_depth.
  - ``AdabinsHead`` (adabins_head.py): the same decoder, then the mViT
    (``PatchTransformerEncoder``: a VALID patch embed, a learned 500-row
    position table, four post-norm layers of flax's
    ``MultiHeadDotProductAttention``): token 0 regresses the bin widths,
    tokens 1..Q are queries against a 3x3 conv of the decoder map, and
    ``conv_out`` turns the Q range-attention maps into bin logits. JAX takes
    ``tgt[:, 1:n_query_channels + 1]``, so below n_query_channels + 1
    tokens there are fewer queries, and ``conv_out``'s input width depends
    on the map's size: the port builds the head for one finest-map size
    ``feat_size`` and raises on another. Above 500 tokens the position
    table raises, as JAX fails.
  - ``BTSHead`` (bts_head.py, compact): a decoder with skip fusion, plane
    coefficients (``_PlaneCoeffs``) at 1/8 and 1/4 expanded by
    ``local_planar_guidance`` to depth maps at the image's scale, resized
    to the finest level and concatenated for the final prediction.
  - ``NeWCRFHead`` (newcrfs.py, compact): a global-pool PPM on the coarsest
    level, then a window cross-attention CRF block per level, coarse to
    fine (queries and keys from the image feature, values from the
    upsampled prediction embedding; padded windows are not masked, as in
    JAX).
  - ``BinsFormerHead`` (binsformer_head.py, compact): learned bin queries
    cross-attend the projected finest map through pre-norm decoder layers;
    softplus bin widths, depth = Σ centres · softmax(pixel · query
    embedding). It reads only the first map.

Flax's LayerNorm default eps 1e-6 and tanh GELU are kept. Maps are NHWC;
each head takes its input maps' channels at construction. The modules
carry the flax names; ``FlaxMultiHeadAttention`` holds flax MHA's
``query``/``key``/``value``/``out`` as Linears, which ``convert.py`` maps
from its [E, H, D] and [H, D, E] kernels.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import resize
from .common import Conv, ConvModule, gelu


class UpSampleFuse(nn.Module):
    """Upsample to the skip (align_corners), concat, convA -> convB."""

    def __init__(self, in_channels: int, features: int, norm: Optional[str] = None,
                 act: str = "relu"):
        super().__init__()
        self.convA = ConvModule(in_channels, features, (3, 3), norm=norm, act=act)
        self.convB = ConvModule(features, features, (3, 3), norm=norm, act=act)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        up = resize(x, skip.shape[1:3], mode="bilinear", align_corners=True)
        return self.convB(self.convA(torch.cat([up, skip], dim=-1)))


def _add_decoder(owner: nn.Module, in_channels: Sequence[int], up_sample_channels: Sequence[int],
                 norm: Optional[str]) -> int:
    """Register the top-down decoder's ``conv0`` and ``up{i}``; returns its
    output channels."""
    chans, ins = list(up_sample_channels)[::-1], list(in_channels)[::-1]
    owner.conv0 = ConvModule(ins[0], chans[0], (1, 1))
    for i in range(1, len(ins)):
        owner.add_module(f"up{i}", UpSampleFuse(chans[i - 1] + ins[i], chans[i], norm=norm))
    return chans[len(ins) - 1]


def _decode(owner: nn.Module, feats: Sequence[torch.Tensor]) -> torch.Tensor:
    x = None
    for i, feat in enumerate(reversed(list(feats))):
        x = owner.conv0(feat) if i == 0 else getattr(owner, f"up{i}")(x, feat)
    return x


class DenseDepthHead(nn.Module):
    """Top-down fusion decoder over a pyramid -> 1-channel depth."""

    def __init__(self, in_channels: Sequence[int],
                 up_sample_channels: Sequence[int] = (128, 256, 512, 1024),
                 max_depth: float = 10.0, min_depth: float = 1e-3, scale_up: bool = True,
                 norm: Optional[str] = None):
        super().__init__()
        self.max_depth, self.min_depth, self.scale_up = max_depth, min_depth, scale_up
        self.conv_depth = Conv(_add_decoder(self, in_channels, up_sample_channels, norm), 1, 3)

    def forward(self, feats: Sequence[torch.Tensor]) -> torch.Tensor:
        d = self.conv_depth(_decode(self, feats))
        if self.scale_up:
            return torch.sigmoid(d) * self.max_depth
        return F.relu(d) + self.min_depth


class FlaxMultiHeadAttention(nn.Module):
    """flax ``nn.MultiHeadDotProductAttention`` (no dropout, no mask):
    ``query``/``key``/``value`` Linears to heads·d, softmax(q·kᵀ/√d)·v,
    ``out`` back to ``dim``."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, q: torch.Tensor, kv: torch.Tensor) -> torch.Tensor:
        b, n, c = q.shape
        nh = self.num_heads

        def heads(t):
            return t.reshape(b, t.shape[1], nh, c // nh).transpose(1, 2)

        y = F.scaled_dot_product_attention(heads(self.query(q)), heads(self.key(kv)),
                                           heads(self.value(kv)))
        return self.out(y.transpose(1, 2).reshape(b, n, c))


class PatchTransformerEncoder(nn.Module):
    """Patch embed + learned positions + post-norm transformer layers (the
    adabins mViT core). Returns [B, S, E]."""

    def __init__(self, in_channels: int, embedding_dim: int = 128, patch_size: int = 16,
                 num_heads: int = 4, num_layers: int = 4):
        super().__init__()
        self.num_layers = num_layers
        self.embed = Conv(in_channels, embedding_dim, patch_size, patch_size, padding="VALID")
        self.pos = nn.Parameter(torch.empty(500, embedding_dim))
        for i in range(num_layers):
            self.add_module(f"attn{i}", FlaxMultiHeadAttention(embedding_dim, num_heads))
            self.add_module(f"norm1_{i}", nn.LayerNorm(embedding_dim, eps=1e-6))
            self.add_module(f"fc1_{i}", nn.Linear(embedding_dim, 1024))
            self.add_module(f"fc2_{i}", nn.Linear(1024, embedding_dim))
            self.add_module(f"norm2_{i}", nn.LayerNorm(embedding_dim, eps=1e-6))

    def flax_init(self, leaf: str, shape, gen: torch.Generator) -> Optional[torch.Tensor]:
        return torch.rand(shape, generator=gen) if leaf == "pos" else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        e = self.embed(x)
        b, s = e.shape[0], e.shape[1] * e.shape[2]
        if s > self.pos.shape[0]:
            raise ValueError(f"{s} tokens exceed the {self.pos.shape[0]}-row position table")
        e = e.reshape(b, s, -1) + self.pos[None, :s]
        for i in range(self.num_layers):
            e = getattr(self, f"norm1_{i}")(e + getattr(self, f"attn{i}")(e, e))
            y = getattr(self, f"fc2_{i}")(F.relu(getattr(self, f"fc1_{i}")(e)))
            e = getattr(self, f"norm2_{i}")(e + y)
        return e


class AdabinsHead(nn.Module):
    """Adaptive-bins depth head: the DenseDepth decoder + mViT bins. Built
    for the finest map size ``feat_size`` (h, w): the query count is
    min(n_query_channels, tokens − 1), tokens = (h // p)·(w // p)."""

    def __init__(self, in_channels: Sequence[int], feat_size: Tuple[int, int],
                 up_sample_channels: Sequence[int] = (128, 256, 512, 1024), n_bins: int = 256,
                 n_query_channels: int = 128, embedding_dim: int = 128, patch_size: int = 16,
                 max_depth: float = 10.0, min_depth: float = 1e-3, norm: Optional[str] = None):
        super().__init__()
        self.feat_size = tuple(feat_size)
        self.max_depth, self.min_depth = max_depth, min_depth
        tokens = (self.feat_size[0] // patch_size) * (self.feat_size[1] // patch_size)
        self.n_queries = max(0, min(n_query_channels, tokens - 1))
        c = _add_decoder(self, in_channels, up_sample_channels, norm)
        self.mvit = PatchTransformerEncoder(c, embedding_dim, patch_size)
        self.conv3x3 = Conv(c, embedding_dim, 3)
        self.reg1 = nn.Linear(embedding_dim, 256)
        self.reg2 = nn.Linear(256, 256)
        self.reg3 = nn.Linear(256, n_bins)
        self.conv_out = Conv(self.n_queries, n_bins, 1)

    def forward(self, feats: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (depth [B, h, w, 1], bin edges [B, n_bins + 1])."""
        x = _decode(self, feats)
        if tuple(x.shape[1:3]) != self.feat_size:
            raise ValueError(f"AdabinsHead is built for {self.feat_size} maps, "
                             f"got {tuple(x.shape[1:3])}")
        tgt = self.mvit(x)
        queries = tgt[:, 1:self.n_queries + 1]
        range_attn = torch.einsum("bhwe,bqe->bhwq", self.conv3x3(x), queries)
        y = self.reg3(F.leaky_relu(self.reg2(F.leaky_relu(self.reg1(tgt[:, 0])))))
        widths = F.relu(y) + 0.1
        widths = widths / widths.sum(dim=1, keepdim=True) * (self.max_depth - self.min_depth)
        edges = torch.cumsum(torch.cat([torch.full_like(widths[:, :1], self.min_depth), widths],
                                       dim=1), dim=1)
        centers = 0.5 * (edges[:, :-1] + edges[:, 1:])
        probs = torch.softmax(self.conv_out(range_attn), dim=-1)
        return torch.einsum("bhwk,bk->bhw", probs, centers)[..., None], edges


def local_planar_guidance(plane_eq: torch.Tensor, ratio: int) -> torch.Tensor:
    """BTS local planar guidance (bts_head.py:97-120): each cell's plane
    [B, h, w, 4] repeated ``ratio``x per axis, evaluated at the sub-pixel
    offsets (i − (ratio − 1)/2)/ratio: depth = n4 / (n1·v + n2·u + n3), v
    along the width, u along the height. Returns [B, h·ratio, w·ratio]."""
    b, h, w, _ = plane_eq.shape
    pe = plane_eq.repeat_interleave(ratio, dim=1).repeat_interleave(ratio, dim=2)
    n1, n2, n3, n4 = pe.unbind(-1)
    grid = (torch.arange(ratio, dtype=pe.dtype, device=pe.device) - (ratio - 1) * 0.5) / ratio
    u = grid.repeat(h).reshape(1, h * ratio, 1)
    v = grid.repeat(w).reshape(1, 1, w * ratio)
    return n4 / (n1 * v + n2 * u + n3)


class _PlaneCoeffs(nn.Module):
    """reduction_1x1 (bts_head.py:53-95): 1x1 conv + ReLU stack halving from
    ``channels`` down to 4, then (theta, phi, dist) -> unit plane normal
    and distance [B, h, w, 4]."""

    def __init__(self, in_channels: int, max_depth: float, channels: int = 32):
        super().__init__()
        self.max_depth = max_depth
        self.widths = []
        c, cin = channels, in_channels
        while c >= 4:
            self.add_module(f"reduc_{c}", Conv(cin, c, 1))
            self.widths.append(c)
            c, cin = c // 2, c
        self.plane_params = Conv(cin, 3, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c in self.widths:
            x = F.relu(getattr(self, f"reduc_{c}")(x))
        xyz = self.plane_params(x)
        theta = torch.sigmoid(xyz[..., 0]) * (math.pi / 3)
        phi = torch.sigmoid(xyz[..., 1]) * (math.pi * 2)
        dist = torch.sigmoid(xyz[..., 2]) * self.max_depth
        return torch.stack([torch.sin(theta) * torch.cos(phi), torch.sin(theta) * torch.sin(phi),
                            torch.cos(theta), dist], dim=-1)


class BTSHead(nn.Module):
    """BTS multi-scale local planar guidance head (compact): a 4-level
    pyramid (strides 4/8/16/32) -> depth at the finest level's size."""

    _STAGES = (("16", 0, 4), ("8", 8, 2), ("4", 4, 1))  # (name, LPG ratio, width / channels)

    def __init__(self, in_channels: Sequence[int], max_depth: float = 10.0, channels: int = 64,
                 min_depth: float = 1e-3):
        super().__init__()
        self.max_depth, self.min_depth = max_depth, min_depth
        c4, c8, c16, c32 = in_channels
        self.dense_32 = Conv(c32, channels * 4, 3)
        cin = channels * 4
        for (name, ratio, mult), skip in zip(self._STAGES, (c16, c8, c4)):
            self.add_module(f"up_{name}", Conv(cin + skip, channels * mult, 3))
            cin = channels * mult
            if ratio:
                self.add_module(f"plane_{name}", _PlaneCoeffs(cin, max_depth))
        self.final = Conv(cin + 2, channels, 3)
        self.depth_pred = Conv(channels, 1, 3)

    def forward(self, feats: Sequence[torch.Tensor]) -> torch.Tensor:
        f4, f8, f16, f32 = feats
        x = F.relu(self.dense_32(f32))
        lpgs = []
        for (name, ratio, _), skip in zip(self._STAGES, (f16, f8, f4)):
            x = torch.cat([resize(x, skip.shape[1:3], mode="bilinear"), skip], dim=-1)
            x = F.relu(getattr(self, f"up_{name}")(x))
            if ratio:
                lpg = local_planar_guidance(getattr(self, f"plane_{name}")(x), ratio)
                lpgs.append(resize(lpg[..., None] / self.max_depth, f4.shape[1:3],
                                   mode="bilinear"))
        x = F.relu(self.final(torch.cat([x] + lpgs, dim=-1)))
        depth = torch.sigmoid(self.depth_pred(x)) * self.max_depth
        return torch.clamp_min(depth, self.min_depth)


class _CRFBlock(nn.Module):
    """Neural window FC-CRF block (newcrfs.py:160-230, compact): window
    cross-attention, queries and keys from the image feature ``x``, values
    from the prediction embedding ``v``; then a pre-norm MLP."""

    def __init__(self, dim: int, num_heads: int = 4, window: int = 4):
        super().__init__()
        self.num_heads, self.window = num_heads, window
        self.q = nn.Linear(dim, dim)
        self.k = nn.Linear(dim, dim)
        self.v = nn.Linear(dim, dim)
        self.ln = nn.LayerNorm(dim, eps=1e-6)
        self.mlp1 = nn.Linear(dim, 2 * dim)
        self.mlp2 = nn.Linear(2 * dim, dim)

    def forward(self, x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        win = min(self.window, h, w)
        ph, pw = (-h) % win, (-w) % win
        hh, ww = h + ph, w + pw

        def part(t):
            t = F.pad(t, (0, 0, 0, pw, 0, ph))
            t = t.reshape(b, hh // win, win, ww // win, win, t.shape[-1]).permute(0, 1, 3, 2, 4, 5)
            return t.reshape(-1, win * win, t.shape[-1])

        xp, nh = part(x), self.num_heads

        def heads(t):
            return t.reshape(t.shape[0], win * win, nh, c // nh).transpose(1, 2)

        y = F.scaled_dot_product_attention(heads(self.q(xp)), heads(self.k(xp)),
                                           heads(self.v(part(v))))
        y = y.transpose(1, 2).reshape(b, hh // win, ww // win, win, win, c)
        y = y.permute(0, 1, 3, 2, 4, 5).reshape(b, hh, ww, c)[:, :h, :w]
        x = x + y
        return x + self.mlp2(gelu(self.mlp1(self.ln(x))))


class NeWCRFHead(nn.Module):
    """NeWCRFs depth head (compact): a global-pool PPM on the coarsest level,
    then a CRF block per finer level, coarse to fine; sigmoid depth at the
    finest level's size."""

    def __init__(self, in_channels: Sequence[int], max_depth: float = 10.0, channels: int = 64,
                 min_depth: float = 1e-3):
        super().__init__()
        self.max_depth, self.min_depth = max_depth, min_depth
        self.n_levels = len(in_channels)
        self.ppm = Conv(2 * in_channels[-1], channels, 3)
        for i in reversed(range(self.n_levels - 1)):
            self.add_module(f"proj_{i}", Conv(in_channels[i], channels, 1))
            self.add_module(f"crf_{i}", _CRFBlock(channels))
        self.depth_pred = Conv(channels, 1, 3)

    def forward(self, feats: Sequence[torch.Tensor]) -> torch.Tensor:
        x = feats[-1]
        pooled = x.mean(dim=(1, 2), keepdim=True).expand_as(x)
        v = F.relu(self.ppm(torch.cat([x, pooled], dim=-1)))
        for i in reversed(range(self.n_levels - 1)):
            skip = feats[i]
            v = resize(v, skip.shape[1:3], mode="bilinear")
            q = F.relu(getattr(self, f"proj_{i}")(skip))
            v = getattr(self, f"crf_{i}")(q, v)
        depth = torch.sigmoid(self.depth_pred(v)) * self.max_depth
        return torch.clamp_min(depth, self.min_depth)


class BinsFormerHead(nn.Module):
    """BinsFormer depth head (compact): ``n_bins`` learned queries through
    ``dec_layers`` pre-norm cross-attention layers over the projected first
    map; softplus widths -> centres; depth = Σ centres · softmax(pixel ·
    query embedding)."""

    def __init__(self, in_channels: Sequence[int], max_depth: float = 10.0, n_bins: int = 16,
                 channels: int = 64, dec_layers: int = 2, num_heads: int = 4,
                 min_depth: float = 1e-3):
        super().__init__()
        c = channels
        self.max_depth, self.min_depth = max_depth, min_depth
        self.dec_layers, self.num_heads = dec_layers, num_heads
        self.pixel_proj = Conv(in_channels[0], c, 3)
        self.query_feat = nn.Parameter(torch.empty(n_bins, c))
        for li in range(dec_layers):
            self.add_module(f"l{li}_ln1", nn.LayerNorm(c, eps=1e-6))
            for name in ("q", "k", "v", "proj"):
                self.add_module(f"l{li}_{name}", nn.Linear(c, c))
            self.add_module(f"l{li}_ln2", nn.LayerNorm(c, eps=1e-6))
            self.add_module(f"l{li}_mlp1", nn.Linear(c, 2 * c))
            self.add_module(f"l{li}_mlp2", nn.Linear(2 * c, c))
        self.bin_mlp = nn.Linear(c, 1)
        self.query_emb = nn.Linear(c, c)

    def flax_init(self, leaf: str, shape, gen: torch.Generator) -> Optional[torch.Tensor]:
        return torch.randn(shape, generator=gen) * 0.02 if leaf == "query_feat" else None

    def forward(self, feats: Sequence[torch.Tensor]) -> torch.Tensor:
        x = F.relu(self.pixel_proj(feats[0]))
        b, h, w, c = x.shape
        mem = x.reshape(b, h * w, c)
        q = self.query_feat[None].expand(b, -1, -1)
        nh = self.num_heads

        def heads(t):
            return t.reshape(b, t.shape[1], nh, c // nh).transpose(1, 2)

        for li in range(self.dec_layers):
            def layer(name, li=li):
                return getattr(self, f"l{li}_{name}")

            y = F.scaled_dot_product_attention(heads(layer("q")(layer("ln1")(q))),
                                               heads(layer("k")(mem)), heads(layer("v")(mem)))
            q = q + layer("proj")(y.transpose(1, 2).reshape(b, -1, c))
            q = q + layer("mlp2")(gelu(layer("mlp1")(layer("ln2")(q))))
        widths = F.softplus(self.bin_mlp(q))[..., 0] + 0.1
        widths = widths / widths.sum(-1, keepdim=True)
        edges = torch.cumsum(widths, dim=-1)
        centers = self.min_depth + (edges - widths / 2) * (self.max_depth - self.min_depth)
        logits = torch.einsum("bsc,bnc->bsn", mem, self.query_emb(q)).reshape(b, h, w, -1)
        depth = torch.einsum("bhwn,bn->bhw", torch.softmax(logits, dim=-1), centers)[..., None]
        return torch.clamp_min(depth, self.min_depth)
