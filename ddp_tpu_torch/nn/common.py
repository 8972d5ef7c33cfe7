"""Common building blocks (port of ``ddp_tpu/nn/common.py:27-142``).

Tensors are NHWC at every module boundary, as in the JAX package; a conv
permutes to NCHW inside.

Randomness: ``drop_path`` and ``dropout`` draw their masks from the
``torch.Generator`` the caller passes (``F.dropout`` takes none), with flax's
semantics: keep with probability 1 − rate and scale the kept values by
1 / (1 − rate); drop path draws one mask entry per sample. Both are the
identity outside training or at rate 0.

BatchNorm parity trap: flax normalises with, and updates its running
variance by, the biased batch variance E[x²] − E[x]² (and momentum 0.9 on
the old value); ``torch.nn.BatchNorm2d`` updates with the unbiased one.
``BatchNorm2d`` here keeps torch's parameters and buffers and does the flax
update.

GELU parity trap: flax ``nn.gelu`` defaults to the tanh approximation, so
every GELU here is ``F.gelu(x, approximate="tanh")``; exact GELU differs by
about 1e-3 per activation.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.gelu`` (tanh approximation)."""
    return F.gelu(x, approximate="tanh")


_ACTS = {"relu": F.relu, "gelu": gelu, "silu": F.silu, None: None}


def _keep_mask(shape, rate: float, generator: Optional[torch.Generator],
               device) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=device) < 1.0 - rate


def drop_path(x: torch.Tensor, rate: float, training: bool,
              generator: Optional[torch.Generator]) -> torch.Tensor:
    """Stochastic depth: drop the residual branch per sample."""
    if not training or rate == 0.0:
        return x
    mask = _keep_mask((x.shape[0],) + (1,) * (x.ndim - 1), rate, generator, x.device)
    return torch.where(mask, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Element-wise dropout (flax ``nn.Dropout``)."""
    if not training or rate == 0.0:
        return x
    mask = _keep_mask(x.shape, rate, generator, x.device)
    return torch.where(mask, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def promoted(module: nn.Module, *args: torch.Tensor) -> torch.Tensor:
    """``module(*args)`` computed in the promoted type of the float ``args``
    and the module's parameters, as JAX promotes bf16 weights against
    float32 activations: the inputs are cast to it, and the parameters too
    (through ``functional_call``, so gradients reach them) where they differ."""
    params = dict(module.named_parameters())
    dtype = args[0].dtype
    for a in list(args[1:]) + list(params.values()):
        dtype = torch.promote_types(dtype, a.dtype)
    args = tuple(a.to(dtype) for a in args)
    if all(p.dtype == dtype for p in params.values()):
        return module(*args)
    return functional_call(module, {n: p.to(dtype) for n, p in params.items()}, args)


def trunc_normal(shape, gen: torch.Generator, std: float = 0.02) -> torch.Tensor:
    """flax ``trunc_normal_init(std)`` (``ddp_tpu/nn/common.py:23``): N(0, 1)
    truncated to ±2, times ``std``, with no variance correction."""
    return nn.init.trunc_normal_(torch.empty(shape), 0.0, 1.0, -2.0, 2.0, generator=gen) * std


FLAX_MOMENTUM = 0.9


def _flax_batch_stats(bn: nn.modules.batchnorm._BatchNorm, xf: torch.Tensor, dims
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The batch mean and biased variance of ``xf`` over ``dims``, and flax's
    update of ``bn``'s running statistics:
    ``running = 0.9 · running + 0.1 · batch``."""
    mean = xf.mean(dim=dims)
    var = torch.clamp((xf * xf).mean(dim=dims) - mean * mean, min=0.0)
    with torch.no_grad():
        bn.running_mean.copy_(FLAX_MOMENTUM * bn.running_mean + (1.0 - FLAX_MOMENTUM) * mean)
        bn.running_var.copy_(FLAX_MOMENTUM * bn.running_var + (1.0 - FLAX_MOMENTUM) * var)
    return mean, var


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm over NCHW with flax's training semantics: statistics in
    float32 (float64 for float64 inputs), the biased variance for
    normalising and for the running update (``_flax_batch_stats``). At
    eval, torch's running-stats normalisation (the same formula as
    flax's)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean, var = _flax_batch_stats(self, xf, (0, 2, 3))
        mul = torch.rsqrt(var + self.eps) * self.weight.to(xf.dtype)
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias.to(xf.dtype)[:, None, None]
        return y.to(x.dtype)


class TokenBatchNorm(nn.BatchNorm1d):
    """BatchNorm over the last axis of a channels-last tensor [..., C] (flax
    ``nn.BatchNorm`` on tokens [b, N, C] or on NHWC maps): the statistics
    reduce over every other axis, with ``BatchNorm2d``'s flax training
    semantics; at eval, the running statistics."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if self.training:
            mean, var = _flax_batch_stats(self, xf, tuple(range(x.ndim - 1)))
        else:
            mean, var = self.running_mean.to(xf.dtype), self.running_var.to(xf.dtype)
        mul = torch.rsqrt(var + self.eps) * self.weight.to(xf.dtype)
        return ((xf - mean) * mul + self.bias.to(xf.dtype)).to(x.dtype)


def make_norm(norm: Optional[str], channels: int) -> Optional[nn.Module]:
    """'GN' (32 groups), 'BN'/'SyncBN' (flax-semantics BatchNorm), 'LN' (over
    the channels, eps 1e-5 as flax's ``make_norm``), or None. GN and BN take
    NCHW, LN channels last."""
    if norm is None:
        return None
    if norm == "GN":
        return nn.GroupNorm(32, channels, eps=1e-5)
    if norm in ("BN", "SyncBN"):
        return BatchNorm2d(channels, eps=1e-5)
    if norm == "LN":
        return nn.LayerNorm(channels, eps=1e-5)
    raise ValueError(f"unknown norm {norm!r}")


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def same_pads(size: Sequence[int], kernel: Sequence[int], stride: Sequence[int],
              dilation: Sequence[int] = (1, 1)) -> Tuple[Tuple[int, int], ...]:
    """flax's ``SAME`` padding per spatial axis, (before, after): the total
    max((ceil(in/s) − 1)·s + (k − 1)·d + 1 − in, 0), the smaller half before
    (a strided conv's extra row goes after, where torch's symmetric padding
    would put one before too)."""
    pads = []
    for n, k, s, d in zip(size, kernel, stride, dilation):
        total = max((-(-n // s) - 1) * s + (k - 1) * d + 1 - n, 0)
        pads.append((total // 2, total - total // 2))
    return tuple(pads)


def _f_pad(pads) -> list:
    """(before, after) per axis, first axis first -> ``F.pad``'s order."""
    return [p for pair in reversed(pads) for p in pair]


class Conv2dSame(nn.Conv2d):
    """A conv with flax's padding (NCHW): ``SAME`` (``same_pads``; symmetric
    padding passed to the conv itself, else an explicit ``F.pad``) or
    ``VALID``. Bias-free unless ``bias``."""

    def __init__(self, in_channels: int, out_channels: int, kernel, stride=1,
                 dilation=1, groups: int = 1, bias: bool = False, padding: str = "SAME"):
        super().__init__(in_channels, out_channels, kernel, stride=stride, dilation=dilation,
                         groups=groups, bias=bias)
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
        self.same = padding == "SAME"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.same:
            return self._conv_forward(x, self.weight, self.bias)
        pads = same_pads(x.shape[2:], self.kernel_size, self.stride, self.dilation)
        if all(lo == hi for lo, hi in pads):
            return F.conv2d(x, self.weight, self.bias, self.stride, tuple(lo for lo, _ in pads),
                            self.dilation, self.groups)
        return F.conv2d(F.pad(x, _f_pad(pads)), self.weight, self.bias, self.stride, 0,
                        self.dilation, self.groups)


class Conv(Conv2dSame):
    """flax ``nn.Conv``: NHWC in and out (a conv on the channels-last view),
    ``SAME`` padding unless ``VALID``, with a bias unless told otherwise."""

    def __init__(self, in_channels: int, out_channels: int, kernel, stride=1,
                 dilation=1, groups: int = 1, bias: bool = True, padding: str = "SAME"):
        super().__init__(in_channels, out_channels, kernel, stride, dilation, groups, bias,
                         padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def max_pool_same(x: torch.Tensor, kernel, stride) -> torch.Tensor:
    """flax ``max_pool(..., padding="SAME")`` on NCHW: -inf padding,
    ``same_pads``'s split."""
    kernel, stride = _pair(kernel), _pair(stride)
    pads = same_pads(x.shape[2:], kernel, stride)
    return F.max_pool2d(F.pad(x, _f_pad(pads), value=float("-inf")), kernel, stride)


def avg_pool_same(x: torch.Tensor, kernel, stride) -> torch.Tensor:
    """flax ``avg_pool(..., padding="SAME")`` on NCHW: zero padding, and every
    window divided by its full size, padding included."""
    kernel, stride = _pair(kernel), _pair(stride)
    pads = same_pads(x.shape[2:], kernel, stride)
    return F.avg_pool2d(F.pad(x, _f_pad(pads)), kernel, stride)


class ConvModule(nn.Module):
    """conv -> norm -> act (mmcv ConvModule; bias only without a norm), flax
    ``SAME`` padding at any kernel size and ``stride``. NHWC in and out."""

    def __init__(self, in_channels: int, features: int,
                 kernel_size: Tuple[int, int] = (1, 1), norm: Optional[str] = None,
                 act: Optional[str] = None, stride=1):
        super().__init__()
        self.conv = Conv2dSame(in_channels, features, kernel_size, stride, bias=norm is None)
        self.norm = make_norm(norm, features)
        self.act = _ACTS[act]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x.permute(0, 3, 1, 2))
        if self.norm is not None and not isinstance(self.norm, nn.LayerNorm):
            x = self.norm(x)
        x = x.permute(0, 2, 3, 1)
        if isinstance(self.norm, nn.LayerNorm):
            x = self.norm(x)
        if self.act is not None:
            x = self.act(x)
        return x


class Mlp(nn.Module):
    """Linear -> act -> Linear (transformer FFN core / time MLPs)."""

    def __init__(self, in_dim: int, hidden: int, out: int,
                 act: Callable[[torch.Tensor], torch.Tensor] = gelu):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, hidden)
        self.fc2 = nn.Linear(hidden, out)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


def promoted_dtype(x: torch.Tensor, *params: Optional[torch.Tensor]) -> torch.dtype:
    """JAX's promotion of an activation against a layer's parameters (a
    flax layer with ``dtype=None``): bf16 against float32 is float32."""
    dtype = x.dtype
    for p in params:
        if p is not None:
            dtype = torch.promote_types(dtype, p.dtype)
    return dtype


def _cast(p: Optional[torch.Tensor], dtype: torch.dtype) -> Optional[torch.Tensor]:
    return None if p is None else p.to(dtype)


class PConv2d(nn.Conv2d):
    """``nn.Conv2d`` (NCHW) in the promoted type of its input and weights, as
    a flax ``Conv`` computes. ``zero_init``: ``init_params_`` starts the
    kernel at 0 (flax's ``kernel_init=zero_init``)."""

    def __init__(self, *args, zero_init: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        self.zero_init = zero_init

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = promoted_dtype(x, self.weight)
        return self._conv_forward(x.to(dtype), self.weight.to(dtype), _cast(self.bias, dtype))


class PLinear(nn.Linear):
    """``nn.Linear`` in the promoted type of its input and weights (flax
    ``Dense``); ``zero_init`` as ``PConv2d``'s."""

    def __init__(self, *args, zero_init: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        self.zero_init = zero_init

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = promoted_dtype(x, self.weight)
        return F.linear(x.to(dtype), self.weight.to(dtype), _cast(self.bias, dtype))


class PGroupNorm(nn.GroupNorm):
    """``nn.GroupNorm`` (NCHW) in the promoted type (flax ``GroupNorm``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = promoted_dtype(x, self.weight)
        return F.group_norm(x.to(dtype), self.num_groups, self.weight.to(dtype),
                            self.bias.to(dtype), self.eps)


class PLayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` in the promoted type (flax ``LayerNorm``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = promoted_dtype(x, self.weight)
        return F.layer_norm(x.to(dtype), self.normalized_shape, self.weight.to(dtype),
                            self.bias.to(dtype), self.eps)


def init_params_(module: nn.Module, seed: int) -> None:
    """Fill every parameter from ``torch.Generator().manual_seed(seed)``, drawn
    on the CPU so that the weights do not depend on the device:
    matrices and conv kernels N(0, 1/fan_in), norm scales 1, biases 0,
    Swin relative-position biases and ViT's position embedding and class
    token N(0, 0.02^2), DAHead's gates 0, sinusoid frequencies N(0, 1).
    The msda layers get the reference's init (``ddp_tpu/nn/transformer.py:
    86-103``): ``sampling_offsets`` and ``attention_weights`` kernels 0, the
    offsets' bias mmcv's ring (``DeformableAttention.offset_bias``),
    ``value_proj`` and ``output_proj`` kernels xavier-uniform; the learned
    position tables U(0, 1). ConvNeXt's layer scales ``gamma`` keep their
    block's ``layer_scale_init`` (1e-6, as the JAX package's init). The depth
    head's ``conv_depth`` bias starts at 0.5 (``ddp_tpu/nn/heads.py:142,145``),
    so that a fresh head's output is above zero, where relu passes gradients.
    A sparse conv's ``kernel`` [K, Cin, Cout] is N(0, 1/(K·Cin)), flax's
    fan-in of that shape. A layer marked ``zero_init`` (the UNet's and
    ControlNet's zero convolutions) starts at 0, and CLIP's
    ``position_embedding`` at N(0, 0.01^2), as their flax inits. A module
    with a ``flax_init(leaf, shape, generator)`` method gives its own
    parameters' flax init where that returns a tensor (the compat zoo's bare
    parameters: CGNet's PReLU slopes, the Encoding's codewords and scales,
    CC's gate, K-Net's kernels, Segmenter's class embedding); then each
    module with an ``init_buffers_(generator)`` method refills its drawn
    buffers (EMANet's bases), in module order."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            owner, _, leaf = name.rpartition(".")
            parent, _, kind = owner.rpartition(".")
            own = getattr(module.get_submodule(owner), "flax_init", None)
            own = own(leaf, p.shape, gen) if own is not None else None
            if own is not None:
                val = own
            elif getattr(module.get_submodule(owner), "zero_init", False):
                val = torch.zeros(p.shape)
            elif leaf == "position_embedding":
                val = torch.randn(p.shape, generator=gen) * 0.01
            elif leaf in ("pam_gamma", "cam_gamma"):
                val = torch.zeros(p.shape)
            elif leaf in ("relative_position_bias_table", "pos_embed", "cls_token"):
                val = torch.randn(p.shape, generator=gen) * 0.02
            elif leaf == "weights":
                val = torch.randn(p.shape, generator=gen)
            elif kind == "conv_depth" and leaf == "bias":
                val = torch.full(p.shape, 0.5)
            elif kind == "sampling_offsets" and leaf == "bias":
                val = module.get_submodule(parent).offset_bias()
            elif kind in ("sampling_offsets", "attention_weights") or leaf == "bias":
                val = torch.zeros(p.shape)
            elif kind in ("value_proj", "output_proj"):
                limit = (6.0 / (p.shape[0] + p.shape[1])) ** 0.5
                val = (torch.rand(p.shape, generator=gen) * 2.0 - 1.0) * limit
            elif kind in ("row_embed", "col_embed"):
                val = torch.rand(p.shape, generator=gen)
            elif leaf == "gamma":
                val = torch.full(p.shape, module.get_submodule(owner).layer_scale_init)
            elif p.ndim == 1:
                val = torch.ones(p.shape)
            elif leaf == "kernel":  # a sparse conv's [K, Cin, Cout]
                val = torch.randn(p.shape, generator=gen) / (p.shape[0] * p.shape[1]) ** 0.5
            else:
                fan_in = p[0].numel()
                val = torch.randn(p.shape, generator=gen) / fan_in ** 0.5
            p.copy_(val)
        for m in module.modules():
            if hasattr(m, "init_buffers_"):
                m.init_buffers_(gen)
