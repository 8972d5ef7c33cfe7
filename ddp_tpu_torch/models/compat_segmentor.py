"""Compat (non-diffusion) segmentors: EncoderDecoder and CascadeEncoderDecoder
(port of ``ddp_tpu/models/compat_segmentor.py:28-155``).

  - ``EncoderDecoder`` (mmseg encoder_decoder.py): backbone -> a decode head
    from ``head_registry.HEADS`` (+ the FCN aux head, weight 0.4). A head
    whose output is a tuple, EncHead's ``(logits, se_logits)``, adds the SE
    loss: 0.2 · the mean sigmoid BCE of the SE logits against the classes
    present in each image (``enc_onehot_labels``), log key ``loss_se``;
    ``predict`` ignores the SE logits.
  - ``CascadeEncoderDecoder`` (mmseg cascade_encoder_decoder.py), OCRNet's
    form: the backbone's maps resized to the first and concatenated, an
    FCNHead (weight 0.4), then an OCRHead on the same maps and the FCN's
    logits. Both stages take ``channels`` (the published OCRNet's FCN has
    270; the JAX package's one width is kept).

The backbone is any module of the zoo (``resnet.py``, ``mobile_hrnet.py``,
``mit.py``, ``vit.py``): it maps NHWC images to a tuple of NHWC maps and
names their channels in ``out_channels``. ``forward(img, gt, generator)``
returns (loss, logs) with the JAX package's log keys: the logits resized
bilinearly to the labels, mmseg's cross-entropy (ignore 255, the mean over
all pixels), accuracy. ``predict(img)`` runs the modules in eval mode, as
JAX's ``train=False``, and returns the argmax at the image's size. The loss
is the resize and ``cross_entropy_seg`` in plain PyTorch, as in JAX: these
paths launch none of the port's CUDA kernels.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ..nn.compat_heads import OCRHead
from ..nn.compat_heads2 import enc_onehot_labels
from ..nn.head_registry import build_head
from ..nn.heads import FCNHead
from ..nn.losses import cross_entropy_seg, seg_accuracy
from ..ops.resize import resize


def _resize_concat(feats: Sequence[torch.Tensor]) -> torch.Tensor:
    """mmseg input_transform='resize_concat': every level upsampled to the
    first level's size and concatenated."""
    target = feats[0].shape[1:3]
    return torch.cat([feats[0]] + [resize(f, target, mode="bilinear") for f in feats[1:]],
                     dim=-1)


@contextlib.contextmanager
def _eval_mode(module: nn.Module):
    was = module.training
    module.eval()
    try:
        yield
    finally:
        module.train(was)


class CascadeEncoderDecoder(nn.Module):
    """Two-stage cascade, FCN -> OCR."""

    def __init__(self, backbone: nn.Module, num_classes: int, channels: int = 256,
                 ocr_channels: int = 128, stage0_weight: float = 0.4,
                 align_corners: bool = False):
        super().__init__()
        in_ch = sum(backbone.out_channels)
        self.stage0_weight = stage0_weight
        self.align_corners = align_corners
        self.backbone = backbone
        self.stage0 = FCNHead(num_classes, in_ch, channels, norm="BN")
        self.stage1 = OCRHead(num_classes, [in_ch], channels=channels, ocr_channels=ocr_channels)

    def forward_logits(self, img: torch.Tensor, generator: Optional[torch.Generator] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        fused = _resize_concat(self.backbone(img, generator))
        logits0 = self.stage0(fused, generator)
        return logits0, self.stage1([fused], logits0, generator)

    def forward(self, img: torch.Tensor, gt: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """img [B, H, W, C], gt [B, H, W] int -> (loss, logs)."""
        logits0, logits1 = self.forward_logits(img, generator)
        full = gt.shape[1:3]
        up0 = resize(logits0, full, mode="bilinear", align_corners=self.align_corners)
        up1 = resize(logits1, full, mode="bilinear", align_corners=self.align_corners)
        loss0 = self.stage0_weight * cross_entropy_seg(up0, gt)
        loss1 = cross_entropy_seg(up1, gt)
        loss = loss0 + loss1
        return loss, {"decode_0.loss_ce": loss0, "decode_1.loss_ce": loss1,
                      "decode_1.acc_seg": seg_accuracy(up1, gt), "loss": loss}

    @torch.no_grad()
    def predict(self, img: torch.Tensor) -> torch.Tensor:
        """The last stage's argmax (only the last head drives inference)."""
        with _eval_mode(self):
            _, logits1 = self.forward_logits(img)
        up = resize(logits1, img.shape[1:3], mode="bilinear", align_corners=self.align_corners)
        return torch.argmax(up, dim=-1)


def _se_loss(se_logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean sigmoid BCE with logits, JAX's stable form:
    max(z, 0) − z·t + log1p(exp(−|z|))."""
    return torch.mean(torch.clamp_min(se_logits, 0) - se_logits * target
                      + torch.log1p(torch.exp(-se_logits.abs())))


class EncoderDecoder(nn.Module):
    """Generic encoder-decoder: backbone -> ``build_head(head_name)`` (+ the
    FCN aux head on ``aux_in_index``, weight ``aux_weight``); a tuple head
    output is ``(logits, se_logits)`` (EncHead)."""

    def __init__(self, backbone: nn.Module, head_name: str, num_classes: int,
                 head_kwargs: Optional[Dict] = None, aux_head: bool = True,
                 aux_weight: float = 0.4, aux_in_index: int = -2, align_corners: bool = False):
        super().__init__()
        in_channels = list(backbone.out_channels)
        self.aux_weight = aux_weight
        self.aux_in_index = aux_in_index
        self.align_corners = align_corners
        self.num_classes = num_classes
        self.backbone = backbone
        kw = dict(head_kwargs or {})
        kw.setdefault("num_classes", num_classes)
        self.decode_head = build_head(head_name, in_channels, **kw)
        self.auxiliary_head = (FCNHead(num_classes, in_channels[aux_in_index], norm="BN")
                               if aux_head else None)

    def _decode(self, feats, generator: Optional[torch.Generator]):
        """(logits, SE logits or None); a tuple head output is unpacked as
        JAX unpacks it (DAHead's three outputs raise)."""
        out = self.decode_head(list(feats), generator)
        logits, se_logits = out if isinstance(out, tuple) else (out, None)
        return logits, se_logits

    def forward_logits(self, img: torch.Tensor, generator: Optional[torch.Generator] = None):
        """(logits, aux logits or None, SE logits or None)."""
        feats = self.backbone(img, generator)
        out, se_logits = self._decode(feats, generator)
        aux = (self.auxiliary_head(feats[self.aux_in_index], generator)
               if self.auxiliary_head is not None else None)
        return out, aux, se_logits

    def forward(self, img: torch.Tensor, gt: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """img [B, H, W, C], gt [B, H, W] int -> (loss, logs)."""
        logits, aux, se_logits = self.forward_logits(img, generator)
        full = gt.shape[1:3]
        up = resize(logits, full, mode="bilinear", align_corners=self.align_corners)
        loss = cross_entropy_seg(up, gt)
        logs = {"decode.loss_ce": loss, "decode.acc_seg": seg_accuracy(up, gt)}
        if aux is not None:
            up_aux = resize(aux, full, mode="bilinear", align_corners=self.align_corners)
            loss_aux = self.aux_weight * cross_entropy_seg(up_aux, gt)
            logs["aux.loss_ce"] = loss_aux
            loss = loss + loss_aux
        if se_logits is not None:
            loss_se = 0.2 * _se_loss(se_logits, enc_onehot_labels(gt, self.num_classes)
                                     .to(se_logits.dtype))
            logs["loss_se"] = loss_se
            loss = loss + loss_se
        logs["loss"] = loss
        return loss, logs

    @torch.no_grad()
    def predict(self, img: torch.Tensor) -> torch.Tensor:
        with _eval_mode(self):  # the aux head does not change the argmax: not run
            logits, _ = self._decode(self.backbone(img), None)
        up = resize(logits, img.shape[1:3], mode="bilinear", align_corners=self.align_corners)
        return torch.argmax(up, dim=-1)
