"""The compat decode-head zoo, part II (port of ``ddp_tpu/nn/compat_heads2.py:
53-983``): the rest of the inherited mmseg heads.

  ANNHead        (ann_head.py)        asymmetric non-local (AFNB + APNB)
  APCHead        (apc_head.py)        adaptive pyramid context (ACM)
  CCHead         (cc_head.py)         criss-cross attention, as dense axial
                                      einsums
  DMHead         (dm_head.py)         dynamic multi-scale filters (DCM)
  DNLHead        (dnl_head.py)        disentangled non-local
  EMAHead        (ema_head.py)        expectation-maximization attention
  EncHead        (enc_head.py)        context encoding + SE-loss logits
  GCHead         (gc_head.py)         global context block
  ISAHead        (isa_head.py)        interlaced sparse self-attention
  KNetHead       (knet_head.py)       iterative kernel update (K-Net)
  PSAHead        (psa_head.py)        point-wise spatial attention, compact
  SegmenterMaskHead (segmenter_mask_head.py)  class-token mask transformer
  SepFCNHead     (sep_fcn_head.py)    Fast-SCNN depthwise-separable FCN
  STDCHead       (stdc_head.py)       one-channel FCN over boundary targets

Every head takes a list of NHWC maps whose channels it is built for
(``in_channels``) and a generator for its dropout, and returns logits at its
working level (EncHead with ``use_se_loss``: ``(logits, se_logits)``;
KNetHead with ``all_stages``: every stage's). Convs pad as flax's ``SAME``
does; BatchNorm has flax's training semantics (``TokenBatchNorm`` over
token tensors [b, N, C]); the LayerNorms keep flax's eps (1e-6 by default,
1e-5 where JAX sets it). The modules carry the flax names, so
``convert.py`` maps JAX weights, and ``flax_init`` gives the bare
parameters JAX's initialisers for ``init_params_``.

Two flax semantics that torch does not give by itself: EMANet's frozen
``ema_mid`` conv and its EM loop run under ``torch.no_grad`` (JAX's
``lax.stop_gradient``), so the loss does not reach ``ema_mid``'s parameters
(JAX gives them a gradient of 0; the port's train step fills 0 for a
parameter the loss does not reach); the EMA bases are a buffer, moved only
in training (momentum 0.1 towards the L2-normalised batch mean of the
refined bases).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import resize
from .common import Conv, ConvModule, TokenBatchNorm, dropout
from .compat_heads import DepthwiseSeparableConv, SegHeadOut, _adaptive_avg_pool
from .vit import ViTBlock


def _normal_02(shape, gen: torch.Generator) -> torch.Tensor:
    """flax ``initializers.normal(0.02)``."""
    return torch.randn(shape, generator=gen) * 0.02


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------


class _TokenConvModule(nn.Module):
    """A 1x1-conv ConvModule on a token tensor [b, N, C]: a Dense (bias only
    without a norm), BN over (b, N) or LN, ReLU."""

    def __init__(self, in_features: int, features: int, norm: Optional[str] = "BN",
                 act: Optional[str] = "relu"):
        super().__init__()
        self.fc1 = nn.Linear(in_features, features, bias=norm is None)
        if norm in ("BN", "SyncBN"):
            self.norm = TokenBatchNorm(features, eps=1e-5)
        elif norm == "LN":
            self.norm = nn.LayerNorm(features, eps=1e-5)
        else:  # as JAX's: any other norm is none
            self.norm = None
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.fc1(x)
        if self.norm is not None:
            x = self.norm(x)
        return F.relu(x) if self.act == "relu" else x


class _SABlock(nn.Module):
    """mmseg SelfAttentionBlock on token tensors: projected queries and keys
    (``num_qk_convs`` token convs each), scaled softmax over the keys, value
    aggregation, an optional output Dense. ``share_key_query``: the key
    stack is the query stack, one set of weights applied to both."""

    def __init__(self, query_channels: int, key_channels: int, channels: int,
                 out_channels: int, num_qk_convs: int = 1, share_key_query: bool = False,
                 with_out: bool = True):
        super().__init__()
        self.channels, self.num_qk_convs = channels, num_qk_convs
        self.share_key_query, self.with_out = share_key_query, with_out
        for i in range(num_qk_convs):
            self.add_module(f"query{i}", _TokenConvModule(query_channels if i == 0 else channels,
                                                          channels))
            if not share_key_query:
                self.add_module(f"key{i}", _TokenConvModule(key_channels if i == 0 else channels,
                                                            channels))
        self.value = nn.Linear(key_channels, channels if with_out else out_channels)
        if with_out:
            self.out = nn.Linear(channels, out_channels)

    def _stack(self, name: str, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_qk_convs):
            x = getattr(self, f"{name}{i}")(x)
        return x

    def forward(self, query: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
        q = self._stack("query", query)
        k = self._stack("query" if self.share_key_query else "key", key)
        v = self.value(key)
        attn = torch.softmax(torch.einsum("bqc,bkc->bqk", q, k) * self.channels ** -0.5, dim=-1)
        ctx = torch.einsum("bqk,bkc->bqc", attn, v)
        return self.out(ctx) if self.with_out else ctx


def _ppm_concat(x: torch.Tensor, pool_scales: Sequence[int] = (1, 3, 6, 8)) -> torch.Tensor:
    """ann_head.py PPMConcat: an adaptive pool at each scale, flattened and
    concatenated along the samples -> [b, sum(s²), C]."""
    b, _, _, c = x.shape
    return torch.cat([_adaptive_avg_pool(x, s).reshape(b, s * s, c) for s in pool_scales],
                     dim=1)


# ---------------------------------------------------------------------------
# ANNHead
# ---------------------------------------------------------------------------


class ANNHead(nn.Module):
    """Asymmetric non-local head: AFNB fuses the last two levels (queries
    from the high level, pyramid-pooled keys and values from the low one),
    then a 3x3 bottleneck and APNB self-attention with pyramid-pooled keys
    (its key and query projections shared)."""

    def __init__(self, num_classes: int, in_channels: Sequence[int], channels: int = 512,
                 project_channels: int = 256, key_pool_scales: Sequence[int] = (1, 3, 6, 8),
                 norm: str = "BN", dropout: float = 0.1):
        super().__init__()
        c_low, c_high = in_channels[-2], in_channels[-1]
        self.key_pool_scales = tuple(key_pool_scales)
        self.dropout = dropout
        self.afnb = _SABlock(c_high, c_low, project_channels, c_high)
        self.afnb_bottleneck = _TokenConvModule(2 * c_high, c_high, norm=norm, act=None)
        self.bottleneck = ConvModule(c_high, channels, (3, 3), norm=norm, act="relu")
        self.apnb = _SABlock(channels, channels, project_channels, channels,
                             share_key_query=True)
        self.apnb_bottleneck = _TokenConvModule(2 * channels, channels, norm=norm, act="relu")
        self.out = SegHeadOut(channels, num_classes, dropout)

    def forward(self, feats, generator: Optional[torch.Generator] = None):
        low, high = feats[-2], feats[-1]
        b, h, w, c_high = high.shape
        q = high.reshape(b, h * w, c_high)
        ctx = self.afnb(q, _ppm_concat(low, self.key_pool_scales))
        y = self.afnb_bottleneck(torch.cat([ctx, q], dim=-1)).reshape(b, h, w, c_high)
        y = self.bottleneck(dropout(y, self.dropout, self.training, generator))
        q2 = y.reshape(b, h * w, y.shape[-1])
        ctx2 = self.apnb(q2, _ppm_concat(y, self.key_pool_scales))
        y2 = self.apnb_bottleneck(torch.cat([ctx2, q2], dim=-1)).reshape(b, h, w, -1)
        return self.out(y2, generator)


# ---------------------------------------------------------------------------
# APCHead
# ---------------------------------------------------------------------------


class _ACM(nn.Module):
    """Adaptive context module: a sigmoid affinity between every pixel and
    an s x s pooled context, guided by the global vector."""

    def __init__(self, in_channels: int, pool_scale: int, channels: int, fusion: bool = True,
                 norm: str = "BN"):
        super().__init__()
        s = self.pool_scale = pool_scale
        self.fusion_on = fusion
        self.pooled_redu = ConvModule(in_channels, channels, (1, 1), norm=norm, act="relu")
        self.input_redu = ConvModule(in_channels, channels, (1, 1), norm=norm, act="relu")
        self.global_info = ConvModule(channels, channels, (1, 1), norm=norm, act="relu")
        self.gla = Conv(channels, s * s, 1)
        self.residual = ConvModule(channels, channels, (1, 1), norm=norm, act="relu")
        if fusion:
            self.fusion = ConvModule(channels, channels, (1, 1), norm=norm, act="relu")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        s = self.pool_scale
        pooled = self.pooled_redu(_adaptive_avg_pool(x, s))
        xr = self.input_redu(x)
        gi = self.global_info(xr.mean(dim=(1, 2), keepdim=True))
        affinity = torch.sigmoid(self.gla(xr + gi).reshape(b, h * w, s * s))
        c = pooled.shape[-1]
        z = torch.einsum("bqs,bsc->bqc", affinity, pooled.reshape(b, s * s, c))
        z = F.relu(self.residual(z.reshape(b, h, w, c)) + xr)
        return self.fusion(z) if self.fusion_on else z


class APCHead(nn.Module):
    """Adaptive pyramid context head: an ACM at each pool scale, concatenated
    with the input, a 3x3 bottleneck."""

    def __init__(self, num_classes: int, in_channels: Sequence[int], channels: int = 512,
                 pool_scales: Sequence[int] = (1, 2, 3, 6), fusion: bool = True,
                 norm: str = "BN", dropout: float = 0.1):
        super().__init__()
        c = in_channels[-1]
        self.pool_scales = tuple(pool_scales)
        for s in self.pool_scales:
            self.add_module(f"acm{s}", _ACM(c, s, channels, fusion, norm))
        self.bottleneck = ConvModule(c + len(self.pool_scales) * channels, channels, (3, 3),
                                     norm=norm, act="relu")
        self.out = SegHeadOut(channels, num_classes, dropout)

    def forward(self, feats, generator: Optional[torch.Generator] = None):
        x = feats[-1]
        outs = [x] + [getattr(self, f"acm{s}")(x) for s in self.pool_scales]
        return self.out(self.bottleneck(torch.cat(outs, dim=-1)), generator)


# ---------------------------------------------------------------------------
# DMHead
# ---------------------------------------------------------------------------


class _DCM(nn.Module):
    """Dynamic convolutional module: a per-sample depthwise filter made from
    the fs x fs pooled feature. The batch folds into the channels for one
    grouped conv of b·c groups; an even filter pads (fs/2, fs/2 − 1)."""

    def __init__(self, in_channels: int, filter_size: int, channels: int, fusion: bool = False,
                 norm: str = "BN"):
        super().__init__()
        self.filter_size, self.fusion_on = filter_size, fusion
        self.filter_gen = Conv(in_channels, channels, 1)
        self.input_redu = ConvModule(in_channels, channels, (1, 1), norm=norm, act="relu")
        self.norm_out = TokenBatchNorm(channels, eps=1e-5)
        if fusion:
            self.fusion = ConvModule(channels, channels, (1, 1), norm=norm, act="relu")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fs = self.filter_size
        filt = self.filter_gen(_adaptive_avg_pool(x, fs))  # [b, fs, fs, C]
        xr = self.input_redu(x)
        b, h, w, c = xr.shape
        merged = xr.permute(0, 3, 1, 2).reshape(1, b * c, h, w)
        kernel = filt.permute(0, 3, 1, 2).reshape(b * c, 1, fs, fs)
        pad = (fs - 1) // 2
        lo = pad if fs % 2 else pad + 1
        out = F.conv2d(F.pad(merged, [lo, pad, lo, pad]), kernel, groups=b * c)
        out = F.relu(self.norm_out(out.reshape(b, c, h, w).permute(0, 2, 3, 1)))
        return self.fusion(out) if self.fusion_on else out


class DMHead(nn.Module):
    """Dynamic multi-scale filter head: a DCM per filter size, concatenated
    with the input, a 3x3 bottleneck."""

    def __init__(self, num_classes: int, in_channels: Sequence[int], channels: int = 512,
                 filter_sizes: Sequence[int] = (1, 3, 5, 7), fusion: bool = False,
                 norm: str = "BN", dropout: float = 0.1):
        super().__init__()
        c = in_channels[-1]
        self.filter_sizes = tuple(filter_sizes)
        for fsz in self.filter_sizes:
            self.add_module(f"dcm{fsz}", _DCM(c, fsz, channels, fusion, norm))
        self.bottleneck = ConvModule(c + len(self.filter_sizes) * channels, channels, (3, 3),
                                     norm=norm, act="relu")
        self.out = SegHeadOut(channels, num_classes, dropout)

    def forward(self, feats, generator: Optional[torch.Generator] = None):
        x = feats[-1]
        outs = [x] + [getattr(self, f"dcm{fsz}")(x) for fsz in self.filter_sizes]
        return self.out(self.bottleneck(torch.cat(outs, dim=-1)), generator)


# ---------------------------------------------------------------------------
# CCHead
# ---------------------------------------------------------------------------


class _CrissCrossAttention(nn.Module):
    """Criss-cross attention (mmcv's CUDA op as dense einsums): the keys of
    query (i, j) are its column and its row, softmaxed together, with the
    column branch's (i, j) masked to −inf so that it counts once. The gate
    ``gamma`` starts at 0."""

    def __init__(self, channels: int, reduction: int = 8):
        super().__init__()
        cq = max(channels // reduction, 1)
        self.query = Conv(channels, cq, 1)
        self.key = Conv(channels, cq, 1)
        self.value = Conv(channels, channels, 1)
        self.gamma = nn.Parameter(torch.zeros(()))

    def flax_init(self, leaf: str, shape, gen: torch.Generator) -> Optional[torch.Tensor]:
        return torch.zeros(shape) if leaf == "gamma" else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.shape[1]
        q, k, v = self.query(x), self.key(x), self.value(x)
        eye = torch.eye(h, dtype=torch.bool, device=x.device)
        e_col = torch.einsum("bijc,bujc->biju", q, k).masked_fill(eye[None, :, None, :],
                                                                    float("-inf"))
        e_row = torch.einsum("bijc,biuc->biju", q, k)
        attn = torch.softmax(torch.cat([e_col, e_row], dim=-1), dim=-1)
        a_col, a_row = attn[..., :h], attn[..., h:]
        out = (torch.einsum("biju,bujc->bijc", a_col, v)
               + torch.einsum("biju,biuc->bijc", a_row, v))
        return x + self.gamma * out


class CCHead(nn.Module):
    """CCNet head: FCN convs around ``recurrence`` passes of one criss-cross
    attention module."""

    def __init__(self, num_classes: int, in_channels: Sequence[int], channels: int = 512,
                 recurrence: int = 2, concat_input: bool = True, norm: str = "BN",
                 dropout: float = 0.1):
        super().__init__()
        c = in_channels[-1]
        self.recurrence, self.concat_input = recurrence, concat_input
        self.conv0 = ConvModule(c, channels, (3, 3), norm=norm, act="relu")
        self.cca = _CrissCrossAttention(channels)
        self.conv1 = ConvModule(channels, channels, (3, 3), norm=norm, act="relu")
        if concat_input:
            self.conv_cat = ConvModule(c + channels, channels, (3, 3), norm=norm, act="relu")
        self.out = SegHeadOut(channels, num_classes, dropout)

    def forward(self, feats, generator: Optional[torch.Generator] = None):
        x = feats[-1]
        y = self.conv0(x)
        for _ in range(self.recurrence):
            y = self.cca(y)
        y = self.conv1(y)
        if self.concat_input:
            y = self.conv_cat(torch.cat([x, y], dim=-1))
        return self.out(y, generator)


# ---------------------------------------------------------------------------
# DNLHead
# ---------------------------------------------------------------------------


class _DisentangledNonLocal(nn.Module):
    """Disentangled non-local block: a whitened (mean-subtracted) embedded
    gaussian pairwise term and a softmax unary term over one shared value."""

    def __init__(self, channels: int, reduction: int = 2, temperature: float = 0.05):
        super().__init__()
        ci = self.ci = max(channels // reduction, 1)
        self.temperature = temperature
        self.g = Conv(channels, ci, 1)
        self.theta = Conv(channels, ci, 1)
        self.phi = Conv(channels, ci, 1)
        self.conv_mask = Conv(channels, 1, 1)
        self.conv_out = Conv(ci, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        n, ci = h * w, self.ci
        g = self.g(x).reshape(b, n, ci)
        theta = self.theta(x).reshape(b, n, ci)
        phi = self.phi(x).reshape(b, n, ci)
        theta = theta - theta.mean(dim=1, keepdim=True)
        phi = phi - phi.mean(dim=1, keepdim=True)
        logits = torch.einsum("bqc,bkc->bqk", theta, phi) * ci ** -0.5 / self.temperature
        y = torch.einsum("bqk,bkc->bqc", torch.softmax(logits, dim=-1), g)
        unary = torch.softmax(self.conv_mask(x).reshape(b, n), dim=-1)
        uy = torch.einsum("bk,bkc->bc", unary, g)[:, None, :]
        return x + self.conv_out((y + uy).reshape(b, h, w, ci))


class DNLHead(nn.Module):
    """Disentangled non-local head: FCN (two convs) with the DNL block
    between them."""

    def __init__(self, num_classes: int, in_channels: Sequence[int], channels: int = 512,
                 reduction: int = 2, temperature: float = 0.05, concat_input: bool = True,
                 norm: str = "BN", dropout: float = 0.1):
        super().__init__()
        c = in_channels[-1]
        self.concat_input = concat_input
        self.conv0 = ConvModule(c, channels, (3, 3), norm=norm, act="relu")
        self.dnl = _DisentangledNonLocal(channels, reduction, temperature)
        self.conv1 = ConvModule(channels, channels, (3, 3), norm=norm, act="relu")
        if concat_input:
            self.conv_cat = ConvModule(c + channels, channels, (3, 3), norm=norm, act="relu")
        self.out = SegHeadOut(channels, num_classes, dropout)

    def forward(self, feats, generator: Optional[torch.Generator] = None):
        x = feats[-1]
        y = self.conv1(self.dnl(self.conv0(x)))
        if self.concat_input:
            y = self.conv_cat(torch.cat([x, y], dim=-1))
        return self.out(y, generator)


# ---------------------------------------------------------------------------
# GCHead
# ---------------------------------------------------------------------------


class _ContextBlock(nn.Module):
    """mmcv ContextBlock: softmax-attention global pooling, then 1x1 -> LN
    (eps 1e-5) -> ReLU -> 1x1, added back to every pixel."""

    def __init__(self, channels: int, ratio: float = 0.25):
        super().__init__()
        planes = max(int(channels * ratio), 1)
        self.conv_mask = Conv(channels, 1, 1)
        self.down = nn.Linear(channels, planes)
        self.ln = nn.LayerNorm(planes, eps=1e-5)
        self.up = nn.Linear(planes, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        attn = torch.softmax(self.conv_mask(x).reshape(b, h * w), dim=-1)
        ctx = torch.einsum("bn,bnc->bc", attn, x.reshape(b, h * w, c))
        t = self.up(F.relu(self.ln(self.down(ctx))))
        return x + t[:, None, None, :]


class GCHead(nn.Module):
    """GCNet head: FCN (two convs) with a global context block between."""

    def __init__(self, num_classes: int, in_channels: Sequence[int], channels: int = 512,
                 ratio: float = 0.25, concat_input: bool = True, norm: str = "BN",
                 dropout: float = 0.1):
        super().__init__()
        c = in_channels[-1]
        self.concat_input = concat_input
        self.conv0 = ConvModule(c, channels, (3, 3), norm=norm, act="relu")
        self.gc = _ContextBlock(channels, ratio)
        self.conv1 = ConvModule(channels, channels, (3, 3), norm=norm, act="relu")
        if concat_input:
            self.conv_cat = ConvModule(c + channels, channels, (3, 3), norm=norm, act="relu")
        self.out = SegHeadOut(channels, num_classes, dropout)

    def forward(self, feats, generator: Optional[torch.Generator] = None):
        x = feats[-1]
        y = self.conv1(self.gc(self.conv0(x)))
        if self.concat_input:
            y = self.conv_cat(torch.cat([x, y], dim=-1))
        return self.out(y, generator)


# ---------------------------------------------------------------------------
# EMAHead
# ---------------------------------------------------------------------------


class _EMAModule(nn.Module):
    """EM attention: ``num_stages`` EM iterations refine the bases against
    the map under ``torch.no_grad``; the reconstruction takes the last
    in-loop responsibilities with the refined bases. The buffer ``bases``
    [num_bases, C] (JAX: a ``batch_stats`` variable) moves only in
    training: ``(1 − m)·bases + m·normalise(mean over the batch)``."""

    def __init__(self, channels: int, num_bases: int = 64, num_stages: int = 3,
                 momentum: float = 0.1, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_bases, self.num_stages, self.momentum = num_bases, num_stages, momentum
        self.register_buffer("bases", torch.empty(num_bases, channels))
        self.init_buffers_(generator)

    def init_buffers_(self, generator: Optional[torch.Generator] = None) -> None:
        """JAX's draw: N(0, 2/num_bases), each basis L2-normalised."""
        with torch.no_grad():
            v = torch.randn(self.bases.shape, generator=generator) * (2.0 / self.num_bases) ** 0.5
            self.bases.copy_(v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1e-12))

    @torch.no_grad()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        feats = x.reshape(b, h * w, c)
        bases = self.bases.to(feats.dtype)[None].expand(b, -1, -1)
        attn = feats.new_zeros(b, h * w, self.num_bases)
        for _ in range(self.num_stages):
            attn = torch.softmax(torch.einsum("bnc,bkc->bnk", feats, bases), dim=-1)
            attn_n = attn / (attn.sum(dim=1, keepdim=True) + 1e-12)
            new = torch.einsum("bnc,bnk->bkc", feats, attn_n)
            bases = new / (torch.linalg.vector_norm(new, dim=-1, keepdim=True) + 1e-12)
        recon = torch.einsum("bnk,bkc->bnc", attn, bases).reshape(b, h, w, c)
        if self.training:
            mean_b = bases.mean(dim=0)
            mean_b = mean_b / (torch.linalg.vector_norm(mean_b, dim=-1, keepdim=True) + 1e-12)
            self.bases.copy_((1 - self.momentum) * self.bases + self.momentum * mean_b)
        return recon


class EMAHead(nn.Module):
    """EMANet head. ``ema_mid`` is frozen as the reference's: it and the EM
    reconstruction run without a graph (JAX's ``stop_gradient``), so the
    loss does not reach its parameters."""

    def __init__(self, num_classes: int, in_channels: Sequence[int], channels: int = 256,
                 ema_channels: int = 256, num_bases: int = 64, num_stages: int = 3,
                 momentum: float = 0.1, concat_input: bool = True, norm: str = "BN",
                 dropout: float = 0.1):
        super().__init__()
        c = in_channels[-1]
        self.concat_input = concat_input
        self.ema_in = ConvModule(c, ema_channels, (3, 3), norm=norm, act="relu")
        self.ema_mid = Conv(ema_channels, ema_channels, 1)
        self.ema = _EMAModule(ema_channels, num_bases, num_stages, momentum)
        self.ema_out = ConvModule(ema_channels, ema_channels, (1, 1), norm=norm, act=None)
        self.bottleneck = ConvModule(ema_channels, channels, (3, 3), norm=norm, act="relu")
        if concat_input:
            self.conv_cat = ConvModule(c + channels, channels, (3, 3), norm=norm, act="relu")
        self.out = SegHeadOut(channels, num_classes, dropout)

    def forward(self, feats, generator: Optional[torch.Generator] = None):
        x = feats[-1]
        identity = self.ema_in(x)
        with torch.no_grad():
            recon = self.ema(self.ema_mid(identity))
        y = F.relu(identity + self.ema_out(F.relu(recon)))
        y = self.bottleneck(y)
        if self.concat_input:
            y = self.conv_cat(torch.cat([x, y], dim=-1))
        return self.out(y, generator)


# ---------------------------------------------------------------------------
# EncHead
# ---------------------------------------------------------------------------


class _Encoding(nn.Module):
    """mmseg's Encoding: residuals to ``num_codes`` codewords, soft-assigned
    with a smoothing factor per code -> [b, num_codes, C]. The stored values
    are the effective ones (JAX: codewords U(−std, std), std =
    (num_codes·C)^−½; factors U(−1, 0)); the factors are ``weight`` (flax:
    ``scale``)."""

    def __init__(self, channels: int, num_codes: int = 32):
        super().__init__()
        self.num_codes = num_codes
        self.codewords = nn.Parameter(torch.zeros(num_codes, channels))
        self.weight = nn.Parameter(torch.zeros(num_codes))

    def flax_init(self, leaf: str, shape, gen: torch.Generator) -> Optional[torch.Tensor]:
        if leaf == "codewords":
            std = (shape[0] * shape[1]) ** -0.5
            return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * std
        if leaf == "weight":
            return -torch.rand(shape, generator=gen)
        return None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        resid = x[:, :, None, :] - self.codewords[None, None]  # [b, n, k, c]
        dist = (resid * resid).sum(dim=-1)
        assign = torch.softmax(self.weight[None, None] * dist, dim=-1)
        return torch.einsum("bnk,bnkc->bkc", assign, resid)


class EncHead(nn.Module):
    """EncNet head: context-encoding channel gating, plus SE logits for the
    semantic-encoding loss. Returns ``(seg_logits, se_logits)`` with
    ``use_se_loss``, else the logits."""

    def __init__(self, num_classes: int, in_channels: Sequence[int], channels: int = 512,
                 num_codes: int = 32, use_se_loss: bool = True, add_lateral: bool = False,
                 norm: str = "BN", dropout: float = 0.1, align_corners: bool = False):
        super().__init__()
        self.use_se_loss, self.add_lateral = use_se_loss, add_lateral
        self.align_corners = align_corners
        self.n_lateral = len(in_channels) - 1
        self.bottleneck = ConvModule(in_channels[-1], channels, (3, 3), norm=norm, act="relu")
        if add_lateral:
            for i, c in enumerate(in_channels[:-1]):
                self.add_module(f"lateral{i}", ConvModule(c, channels, (1, 1), norm=norm,
                                                          act="relu"))
            self.fusion = ConvModule(len(in_channels) * channels, channels, (3, 3), norm=norm,
                                     act="relu")
        self.enc_proj = ConvModule(channels, channels, (1, 1), norm=norm, act="relu")
        self.encoding = _Encoding(channels, num_codes)
        self.enc_bn = TokenBatchNorm(channels, eps=1e-5)
        self.fc = nn.Linear(channels, channels)
        self.out = SegHeadOut(channels, num_classes, dropout)
        if use_se_loss:
            self.se_layer = nn.Linear(channels, num_classes)

    def forward(self, feats, generator: Optional[torch.Generator] = None):
        y = self.bottleneck(feats[-1])
        if self.add_lateral:
            size = y.shape[1:3]
            lat = [resize(getattr(self, f"lateral{i}")(f), size, mode="bilinear",
                          align_corners=self.align_corners)
                   for i, f in enumerate(feats[:self.n_lateral])]
            y = self.fusion(torch.cat([y] + lat, dim=-1))
        b, h, w, c = y.shape
        enc = self.encoding(self.enc_proj(y).reshape(b, h * w, c))
        enc_feat = F.relu(self.enc_bn(enc)).mean(dim=1)  # [b, C]
        gamma = torch.sigmoid(self.fc(enc_feat))
        y = F.relu(y + y * gamma[:, None, None, :])
        logits = self.out(y, generator)
        if self.use_se_loss:
            return logits, self.se_layer(enc_feat)
        return logits


def enc_onehot_labels(labels: torch.Tensor, num_classes: int,
                      ignore_index: int = 255) -> torch.Tensor:
    """Per-image class presence for the SE loss -> [b, K] float32 in {0, 1}
    (a label outside [0, K) marks no class, as ``jax.nn.one_hot``)."""
    valid = labels != ignore_index
    classes = torch.arange(num_classes, device=labels.device)
    hit = (labels[..., None] == classes) & valid[..., None]
    return hit.flatten(1, -2).any(dim=1).to(torch.float32)


# ---------------------------------------------------------------------------
# ISAHead
# ---------------------------------------------------------------------------


class ISAHead(nn.Module):
    """Interlaced sparse self-attention: attention among the pixels of each
    local offset across the global grid, then within each local window. The
    map is zero-padded to a multiple of ``down_factor`` (the extra row or
    column after) and cropped back."""

    def __init__(self, num_classes: int, in_channels: Sequence[int], channels: int = 512,
                 isa_channels: int = 256, down_factor: Tuple[int, int] = (8, 8),
                 norm: str = "BN", dropout: float = 0.1):
        super().__init__()
        self.down_factor = tuple(down_factor)
        self.in_conv = ConvModule(in_channels[-1], channels, (3, 3), norm=norm, act="relu")
        for name in ("global_relation", "local_relation"):
            self.add_module(name, _SABlock(channels, channels, isa_channels, channels,
                                           num_qk_convs=2, with_out=False))
            self.add_module(f"{name}_out", _TokenConvModule(channels, channels, norm=norm))
        self.out_conv = ConvModule(2 * channels, channels, (1, 1), norm=norm, act="relu")
        self.out = SegHeadOut(channels, num_classes, dropout)

    def _attend(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return getattr(self, f"{name}_out")(getattr(self, name)(x, x))

    def forward(self, feats, generator: Optional[torch.Generator] = None):
        y = residual = self.in_conv(feats[-1])
        b, h, w, c = y.shape
        lh, lw = self.down_factor
        gh, gw = -(-h // lh), -(-w // lw)
        ph, pw = gh * lh - h, gw * lw - w
        if ph or pw:
            y = F.pad(y, [0, 0, pw // 2, pw - pw // 2, ph // 2, ph - ph // 2])
        y = y.reshape(b, gh, lh, gw, lw, c)
        yg = y.permute(0, 2, 4, 1, 3, 5).reshape(b * lh * lw, gh * gw, c)
        yg = self._attend(yg, "global_relation")
        yl = yg.reshape(b, lh, lw, gh, gw, c).permute(0, 3, 4, 1, 2, 5)
        yl = self._attend(yl.reshape(b * gh * gw, lh * lw, c), "local_relation")
        y = yl.reshape(b, gh, gw, lh, lw, c).permute(0, 1, 3, 2, 4, 5).reshape(
            b, gh * lh, gw * lw, c)
        if ph or pw:
            y = y[:, ph // 2:ph // 2 + h, pw // 2:pw // 2 + w]
        return self.out(self.out_conv(torch.cat([y, residual], dim=-1)), generator)


# ---------------------------------------------------------------------------
# PSAHead
# ---------------------------------------------------------------------------


class PSAHead(nn.Module):
    """Point-wise spatial attention, compact bi-direction form: collect and
    distribute branches each predict a full [HW, HW] attention with a 1x1
    conv of hs·ws outputs (hs, ws = ⌈h/shrink⌉, ⌈w/shrink⌉), so the weights
    fit the one map size ``feat_size`` (h, w) they are built for (JAX sizes
    them from the map it is initialised on); another size raises."""

    def __init__(self, num_classes: int, in_channels: Sequence[int],
                 feat_size: Tuple[int, int], channels: int = 512, shrink_factor: int = 2,
                 psa_softmax: bool = True, normalization_factor: float = 1.0,
                 norm: str = "BN", dropout: float = 0.1, align_corners: bool = False):
        super().__init__()
        c = in_channels[-1]
        self.feat_size = tuple(feat_size)
        self.hs, self.ws = (-(-n // shrink_factor) for n in self.feat_size)
        self.channels, self.shrink_factor = channels, shrink_factor
        self.psa_softmax, self.normalization_factor = psa_softmax, normalization_factor
        self.align_corners = align_corners
        for name in ("collect", "distribute"):
            self.add_module(f"{name}_reduce", ConvModule(c, channels, (1, 1), norm=norm,
                                                         act="relu"))
            self.add_module(f"{name}_attn0", ConvModule(channels, channels, (1, 1), norm=norm,
                                                        act="relu"))
            self.add_module(f"{name}_attn1", Conv(channels, self.hs * self.ws, 1, bias=False))
        self.proj = ConvModule(2 * channels, c, (1, 1), norm=norm, act="relu")
        self.bottleneck = ConvModule(2 * c, channels, (3, 3), norm=norm, act="relu")
        self.out = SegHeadOut(channels, num_classes, dropout)

    def _branch(self, x: torch.Tensor, name: str):
        y = getattr(self, f"{name}_reduce")(x)
        if self.shrink_factor != 1:
            y = resize(y, (self.hs, self.ws), mode="bilinear", align_corners=self.align_corners)
        return y, getattr(self, f"{name}_attn1")(getattr(self, f"{name}_attn0")(y))

    def forward(self, feats, generator: Optional[torch.Generator] = None):
        x = feats[-1]
        b, h, w, _ = x.shape
        if (h, w) != self.feat_size:
            raise ValueError(f"PSAHead is built for {self.feat_size} maps, got {(h, w)}")
        n, ch = self.hs * self.ws, self.channels
        xc, ac = self._branch(x, "collect")
        xd, ad = self._branch(x, "distribute")
        ac = ac.reshape(b, n, n).transpose(1, 2)
        ad = ad.reshape(b, n, n)
        if self.psa_softmax:
            ac, ad = torch.softmax(ac, dim=-1), torch.softmax(ad, dim=-1)
        scale = 1.0 / self.normalization_factor
        yc = torch.einsum("bqk,bkc->bqc", ac, xc.reshape(b, n, ch)) * scale
        yd = torch.einsum("bqk,bkc->bqc", ad, xd.reshape(b, n, ch)) * scale
        y = self.proj(torch.cat([yc, yd], dim=-1).reshape(b, self.hs, self.ws, 2 * ch))
        y = resize(y, (h, w), mode="bilinear", align_corners=self.align_corners)
        return self.out(self.bottleneck(torch.cat([x, y], dim=-1)), generator)


# ---------------------------------------------------------------------------
# KNetHead
# ---------------------------------------------------------------------------


class _KernelUpdator(nn.Module):
    """K-Net's adaptive kernel update: K~ = G_f ⊙ phi_f(F) + G_k ⊙ phi_k(K),
    the gates from the mask-pooled group feature and the old kernel. Its
    LayerNorms have flax's default eps, 1e-6."""

    def __init__(self, channels: int):
        super().__init__()
        c = self.channels = channels
        self.feat_in = nn.Linear(c, 2 * c)
        self.kernel_in = nn.Linear(c, 2 * c)
        for name in ("fg_norm", "kg_norm", "f_norm", "k_norm", "out_norm"):
            self.add_module(name, nn.LayerNorm(c, eps=1e-6))
        self.fc_out = nn.Linear(c, c)

    def forward(self, kernels: torch.Tensor, group_feat: torch.Tensor) -> torch.Tensor:
        c = self.channels
        f, k = self.feat_in(group_feat), self.kernel_in(kernels)
        f_param, f_gate_in = f[..., :c], f[..., c:]
        k_param, k_gate_in = k[..., :c], k[..., c:]
        gate_f = torch.sigmoid(self.fg_norm(f_gate_in + k_gate_in))
        gate_k = torch.sigmoid(self.kg_norm(f_gate_in + k_gate_in))
        new = gate_f * self.f_norm(f_param) + gate_k * self.k_norm(k_param)
        return F.relu(self.out_norm(self.fc_out(new)))


class KNetHead(nn.Module):
    """K-Net semantic head: ``num_classes`` dynamic kernels refined over
    ``num_stages`` rounds (mask pooling -> adaptive update -> kernel
    self-attention -> mask re-prediction). The last stage's logits, or with
    ``all_stages`` every stage's (a list)."""

    def __init__(self, num_classes: int, in_channels: Sequence[int], channels: int = 256,
                 num_stages: int = 3, num_heads: int = 8, all_stages: bool = False,
                 norm: str = "BN", dropout: float = 0.1):
        super().__init__()
        self.num_classes, self.num_stages, self.all_stages = num_classes, num_stages, all_stages
        self.feat_conv = ConvModule(in_channels[-1], channels, (3, 3), norm=norm, act="relu")
        self.kernels = nn.Parameter(torch.zeros(num_classes, channels))
        for s in range(num_stages):
            self.add_module(f"updator{s}", _KernelUpdator(channels))
            self.add_module(f"interact{s}", ViTBlock(channels, num_heads))

    def flax_init(self, leaf: str, shape, gen: torch.Generator) -> Optional[torch.Tensor]:
        return _normal_02(shape, gen) if leaf == "kernels" else None

    def forward(self, feats, generator: Optional[torch.Generator] = None):
        x = self.feat_conv(feats[-1])
        b, h, w, c = x.shape
        tokens = x.reshape(b, h * w, c)
        kernels = self.kernels[None].expand(b, -1, -1)
        logits = torch.einsum("bnc,bkc->bnk", tokens, kernels)
        outs: List[torch.Tensor] = [logits]
        for s in range(self.num_stages):
            m = torch.sigmoid(logits)
            group = torch.einsum("bnk,bnc->bkc", m, tokens) / (m.sum(dim=1)[..., None] + 1e-6)
            kernels = getattr(self, f"updator{s}")(kernels, group)
            kernels = getattr(self, f"interact{s}")(kernels, generator)
            logits = torch.einsum("bnc,bkc->bnk", tokens, kernels)
            outs.append(logits)
        outs = [o.reshape(b, h, w, self.num_classes) for o in outs]
        return outs if self.all_stages else outs[-1]


# ---------------------------------------------------------------------------
# SegmenterMaskHead
# ---------------------------------------------------------------------------


class SegmenterMaskHead(nn.Module):
    """Segmenter's mask transformer: patch tokens and learned class tokens
    through ``num_layers`` ViT blocks; logits are the patch·class
    similarities (classes L2-normalised), LayerNormed over the classes."""

    def __init__(self, num_classes: int, in_channels: Sequence[int], embed_dims: int = 256,
                 num_layers: int = 2, num_heads: int = 8, mlp_ratio: float = 4.0):
        super().__init__()
        d = embed_dims
        self.num_classes, self.num_layers = num_classes, num_layers
        self.dec_proj = nn.Linear(in_channels[-1], d)
        self.cls_emb = nn.Parameter(torch.zeros(1, num_classes, d))
        for i in range(num_layers):
            self.add_module(f"layer{i}", ViTBlock(d, num_heads, mlp_ratio))
        self.decoder_norm = nn.LayerNorm(d, eps=1e-6)
        self.patch_proj = nn.Linear(d, d, bias=False)
        self.classes_proj = nn.Linear(d, d, bias=False)
        self.mask_norm = nn.LayerNorm(num_classes, eps=1e-6)

    def flax_init(self, leaf: str, shape, gen: torch.Generator) -> Optional[torch.Tensor]:
        return _normal_02(shape, gen) if leaf == "cls_emb" else None

    def forward(self, feats, generator: Optional[torch.Generator] = None):
        x = feats[-1]
        b, h, w, _ = x.shape
        k = self.num_classes
        tok = self.dec_proj(x.reshape(b, h * w, -1))
        y = torch.cat([tok, self.cls_emb.expand(b, -1, -1)], dim=1)
        for i in range(self.num_layers):
            y = getattr(self, f"layer{i}")(y, generator)
        y = self.decoder_norm(y)
        patches = self.patch_proj(y[:, :-k])
        classes = self.classes_proj(y[:, -k:])
        classes = classes / (torch.linalg.vector_norm(classes, dim=-1, keepdim=True) + 1e-12)
        masks = self.mask_norm(torch.einsum("bnd,bkd->bnk", patches, classes))
        return masks.reshape(b, h, w, k)


# ---------------------------------------------------------------------------
# SepFCNHead + STDCHead
# ---------------------------------------------------------------------------


class SepFCNHead(nn.Module):
    """Fast-SCNN's depthwise-separable FCN head."""

    def __init__(self, num_classes: int, in_channels: Sequence[int], channels: int = 128,
                 num_convs: int = 2, concat_input: bool = False, dropout: float = 0.1):
        super().__init__()
        c = in_channels[-1]
        self.num_convs, self.concat_input = num_convs, concat_input
        for i in range(num_convs):
            self.add_module(f"conv{i}", DepthwiseSeparableConv(c if i == 0 else channels,
                                                               channels))
        if concat_input:
            self.conv_cat = DepthwiseSeparableConv(c + (channels if num_convs else c), channels)
        self.out = SegHeadOut(channels if num_convs or concat_input else c, num_classes, dropout)

    def forward(self, feats, generator: Optional[torch.Generator] = None):
        x = y = feats[-1]
        for i in range(self.num_convs):
            y = getattr(self, f"conv{i}")(y)
        if self.concat_input:
            y = self.conv_cat(torch.cat([x, y], dim=-1))
        return self.out(y, generator)


class STDCHead(nn.Module):
    """STDC's detail head: a one-channel FCN, trained on the laplacian
    boundary targets of ``stdc_boundary_targets``."""

    def __init__(self, in_channels: Sequence[int], channels: int = 64, norm: str = "BN",
                 dropout: float = 0.1):
        super().__init__()
        self.conv0 = ConvModule(in_channels[-1], channels, (3, 3), norm=norm, act="relu")
        self.out = SegHeadOut(channels, 1, dropout)

    def forward(self, feats, generator: Optional[torch.Generator] = None):
        return self.out(self.conv0(feats[-1]), generator)


def stdc_boundary_targets(labels: torch.Tensor, threshold: float = 0.1) -> torch.Tensor:
    """STDC's boundary targets: 3x3 laplacian edges of the label map at
    strides 1, 2 and 4, the coarse ones resized (nearest) to the map,
    binarised, fused with the fixed (0.6, 0.3, 0.1) weights and binarised
    again -> [b, H, W] float32 in {0, 1}."""
    lap = torch.tensor([[-1.0, -1.0, -1.0], [-1.0, 8.0, -1.0], [-1.0, -1.0, -1.0]],
                       device=labels.device).reshape(1, 1, 3, 3)
    x = labels.to(torch.float32)[:, None]
    h, w = labels.shape[1:3]

    def edge(stride: int) -> torch.Tensor:
        e = F.conv2d(x, lap, stride=stride, padding=1).clamp_min(0.0)
        return (e > threshold).to(torch.float32).permute(0, 2, 3, 1)  # NHWC

    b1 = edge(1)
    b2 = resize(edge(2), (h, w), mode="nearest")
    b4 = resize(edge(4), (h, w), mode="nearest")
    fused = 0.6 * b1 + 0.3 * b2 + 0.1 * b4
    return (fused[..., 0] > threshold).to(torch.float32)
