"""DDPSegmentor serving path (port of ``ddp_tpu/models/segmentor.py:39-145,229-294``).

Swin -> FPN -> MultiStageMerging gives one 1/4-scale feature map, encoded
once per image. Then ``diffusion.timesteps`` DDIM steps, each: 1x1 fusion conv
over [features, latent] plus the time MLP of the log-SNR, the time-FiLM
window decoder, argmax, and the argmax re-embedded through the encode-map
CUDA kernel (``ops/q_sample.py``). Softmax is averaged over the steps, over
the randsteps hypotheses (folded r-major into the batch), then bilinearly
upsampled. Images are NHWC, probabilities [B, H, W, K].

The training forward (``__call__`` of the JAX module) is not ported yet.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..core import diffusion as diff
from ..core.diffusion import DiffusionConfig
from ..device import resolve_device
from ..nn.common import ConvModule
from ..nn.fpn import FPN, MultiStageMerging
from ..nn.heads import DeformableHeadWithTime, FCNHead
from ..nn.swin import SwinTransformer, swin_variant
from ..nn.time_embed import TimeMLP
from ..ops import q_sample
from ..ops.resize import resize


class DDPSegmentor(nn.Module):
    def __init__(self, num_classes: int = 150, backbone_type: str = "swin",
                 backbone_variant: str = "tiny", embed_dims: int = 256,
                 bit_scale: float = 0.01, diffusion: DiffusionConfig = DiffusionConfig(),
                 align_corners: bool = False, decoder_layers: int = 6,
                 decoder_heads: int = 8, decoder_ffn_dim: int = 1024,
                 decoder_attn: str = "window", decoder_window: int = 8,
                 decoder_film: str = "v1", decoder_pos: str = "sine",
                 device=None):
        super().__init__()
        if backbone_type != "swin":
            raise NotImplementedError(f"backbone {backbone_type!r} is not ported yet")
        self.num_classes = num_classes
        self.embed_dims = embed_dims
        self.bit_scale = bit_scale
        self.diffusion = diffusion
        self.align_corners = align_corners
        with torch.device(resolve_device(device)):
            kw = swin_variant(backbone_variant)
            self.backbone = SwinTransformer(**kw)
            dims = [kw["embed_dims"] * 2 ** i for i in range(len(kw["depths"]))]
            self.neck_fpn = FPN(dims, embed_dims, num_outs=4)
            self.neck_merge = MultiStageMerging(4 * embed_dims, embed_dims)
            self.decode_head = DeformableHeadWithTime(
                num_classes, embed_dims, num_layers=decoder_layers,
                num_heads=decoder_heads, ffn_dim=decoder_ffn_dim,
                attn_type=decoder_attn, film=decoder_film, pos_type=decoder_pos,
                window=decoder_window)
            self.aux_head = FCNHead(num_classes, embed_dims, embed_dims)
            # K+1 entries: index num_classes is the ignore/padding class (ddp.py:78)
            self.embedding_table = nn.Embedding(num_classes + 1, embed_dims)
            # fusion conv: plain 1x1, bias, no norm/act (ddp.py:92-100)
            self.transform = ConvModule(2 * embed_dims, embed_dims, (1, 1))
            self.time_mlp = TimeMLP(dim=embed_dims * 4)
        self.eval()

    # --- building blocks -------------------------------------------------
    def extract_feat(self, img: torch.Tensor) -> torch.Tensor:
        """backbone -> FPN -> merge: [B, H, W, 3] -> [B, H/4, W/4, C]."""
        return self.neck_merge(self.neck_fpn(self.backbone(img)))

    def encode_map(self, labels: torch.Tensor) -> torch.Tensor:
        """Class-index map [...] -> squashed analog-bits latent [..., C]."""
        table = self.embedding_table.weight
        flat = q_sample.encode_map(labels.reshape(-1), table, self.bit_scale)
        return flat.reshape(labels.shape + (table.shape[-1],))

    def denoise_logits(self, x: torch.Tensor, mask_t: torch.Tensor,
                       log_snr: torch.Tensor) -> torch.Tensor:
        """Fuse conditioning features with the noisy latent and decode."""
        feat = self.transform(torch.cat([x, mask_t], dim=-1))
        return self.decode_head(feat, self.time_mlp(log_snr))

    # --- inference -------------------------------------------------------
    def _rollout_hypotheses(self, img: torch.Tensor,
                            generator: Optional[torch.Generator] = None,
                            init_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Encode once, run the randsteps-folded rollout; per-hypothesis class
        probabilities [r, B, h/4, w/4, K] before ensemble averaging.

        ``init_noise`` [r·B, h/4, w/4, C] is the initial latent; when it is
        None it is drawn from ``generator`` (torch's default one if None)."""
        cfg = self.diffusion
        x = self.extract_feat(img)
        b, h, w, c = x.shape
        r = cfg.randsteps
        xr = x.repeat(r, 1, 1, 1)  # (r b) folding, r-major like the reference
        shape = (r * b, h, w, c)
        if init_noise is None:
            init_noise = torch.randn(shape, generator=generator, dtype=x.dtype,
                                     device=x.device)
        elif tuple(init_noise.shape) != shape:
            raise ValueError(f"init_noise shape {tuple(init_noise.shape)} != {shape}")
        step_noise = None
        if cfg.method == "ddpm":
            step_noise = [torch.randn(shape, generator=generator, dtype=x.dtype,
                                      device=x.device) for _ in range(cfg.timesteps)]

        def denoise_fn(mask_t, log_snr):
            logits = self.denoise_logits(xr, mask_t, log_snr)
            return logits, self.encode_map(torch.argmax(logits, dim=-1))

        out = diff.rollout(cfg, denoise_fn, init_noise, step_noise)
        return out.reshape(r, b, h, w, self.num_classes)

    @torch.no_grad()
    def sample(self, img: torch.Tensor, generator: Optional[torch.Generator] = None,
               init_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Whole-image inference: class probabilities [B, H, W, K]
        (softmax-accumulated when cfg.accumulation, ddim_sample ddp.py:215-246)."""
        out = self._rollout_hypotheses(img, generator, init_noise).mean(dim=0)
        return resize(out, tuple(img.shape[1:3]), mode="bilinear",
                      align_corners=self.align_corners)

    @torch.no_grad()
    def sample_with_uncertainty(
        self, img: torch.Tensor, generator: Optional[torch.Generator] = None,
        init_noise: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Probabilities [B, H, W, K] plus per-pixel uncertainty maps [B, H, W]
        from the randsteps ensemble: ``variance`` (mean over classes of the
        across-hypothesis variance) and ``entropy`` (nats, of the mean)."""
        hyp = self._rollout_hypotheses(img, generator, init_noise)
        if not self.diffusion.accumulation:
            hyp = torch.softmax(hyp, dim=-1)
        probs = hyp.mean(dim=0)
        var = hyp.var(dim=0, unbiased=False).mean(dim=-1)
        p = torch.clamp(probs / torch.clamp(probs.sum(dim=-1, keepdim=True), min=1e-12),
                        1e-12, 1.0)
        ent = -(p * torch.log(p)).sum(dim=-1)
        full = tuple(img.shape[1:3])
        ac = self.align_corners
        probs_up = resize(probs, full, mode="bilinear", align_corners=ac)
        var_up = resize(var[..., None], full, mode="bilinear", align_corners=ac)[..., 0]
        ent_up = resize(ent[..., None], full, mode="bilinear", align_corners=ac)[..., 0]
        return probs_up, {"variance": var_up, "entropy": ent_up}

    @torch.no_grad()
    def predict(self, img: torch.Tensor, generator: Optional[torch.Generator] = None,
                init_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """argmax segmentation map [B, H, W]."""
        return torch.argmax(self.sample(img, generator, init_noise), dim=-1)
