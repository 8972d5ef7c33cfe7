"""Decode-head registry (port of ``ddp_tpu/nn/head_registry.py:26-91``):
the mmseg ``HEADS`` surface (builder.py ``build_head(cfg)``) as a name ->
class map, so a head is chosen by a config string, as the reference's
``decode_head=dict(type=...)``. It holds JAX's 31 names: part I
(``compat_heads.py``), part II (``compat_heads2.py``) and the fcn family
(``heads.py``).

``build_head("uper", in_channels=[...], num_classes=19, channels=256)``
returns a module that takes a list of NHWC maps (``in_channels``: their
channels) and a generator. As in JAX, the one-channel ``STDCHead`` drops
``num_classes``, and so do ``NNHead`` and ``IdentityHead``; ``PSAHead``
also takes ``feat_size``, the map size its attention convs are built for.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
from torch import nn

from .compat_heads import (ASPPHead, DAHead, DepthwiseSeparableASPPHead, DPTHead, FPNHead,
                           LRASPPHead, NLHead, OCRHead, PointHead, PSPHead, SegformerHead,
                           SETRMLAHead, SETRUPHead, UPerHead)
from .compat_heads2 import (ANNHead, APCHead, CCHead, DMHead, DNLHead, EMAHead, EncHead, GCHead,
                            ISAHead, KNetHead, PSAHead, SegmenterMaskHead, SepFCNHead, STDCHead)
from .heads import FCNHead, IdentityHead, NNHead

HEADS: Dict[str, Any] = {
    # part I (compat_heads.py)
    "psp": PSPHead,
    "uper": UPerHead,
    "aspp": ASPPHead,
    "sep_aspp": DepthwiseSeparableASPPHead,
    "segformer": SegformerHead,
    "ocr": OCRHead,
    "da": DAHead,
    "nl": NLHead,
    "lraspp": LRASPPHead,
    "fpn": FPNHead,
    "setr_up": SETRUPHead,
    "setr_mla": SETRMLAHead,
    "dpt": DPTHead,
    "point": PointHead,
    # part II (compat_heads2.py)
    "ann": ANNHead,
    "apc": APCHead,
    "cc": CCHead,
    "dm": DMHead,
    "dnl": DNLHead,
    "ema": EMAHead,
    "enc": EncHead,
    "gc": GCHead,
    "isa": ISAHead,
    "knet": KNetHead,
    "psa": PSAHead,
    "segmenter_mask": SegmenterMaskHead,
    "sep_fcn": SepFCNHead,
    "stdc": STDCHead,
    # fcn family (heads.py)
    "fcn": FCNHead,
    "nn": NNHead,
    "identity": IdentityHead,
}


class _LastLevel(nn.Module):
    """Adapter: the fcn-family heads take one map; the registry's interface
    is a list of maps (in_index=-1)."""

    def __init__(self, head: nn.Module):
        super().__init__()
        self.head = head

    def forward(self, feats, generator: Optional[torch.Generator] = None):
        return self.head(feats[-1], generator)


def build_head(name: str, in_channels: Sequence[int], **kwargs) -> nn.Module:
    """Construct a decode head by registry name (build_head equivalent) for
    maps of ``in_channels`` channels."""
    try:
        cls = HEADS[name]
    except KeyError:
        raise ValueError(f"unknown head {name!r}; available: {sorted(HEADS)}") from None
    if cls is IdentityHead:
        kwargs.pop("num_classes", None)
        return _LastLevel(cls(**kwargs))
    if cls is STDCHead:  # a fixed one-channel boundary head
        kwargs.pop("num_classes", None)
        return cls(in_channels=list(in_channels), **kwargs)
    if cls is NNHead:
        kwargs.pop("num_classes", None)
        return _LastLevel(cls(in_channels[-1], **kwargs))
    if cls is FCNHead:
        return _LastLevel(cls(in_channels=in_channels[-1], **kwargs))
    return cls(in_channels=list(in_channels), **kwargs)
