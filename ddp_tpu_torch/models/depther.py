"""DDPDepther (port of ``ddp_tpu/models/depther.py:34-183``): monocular
depth as noise-to-map diffusion (the reference's depth/depth/models/depther/
ddp.py:34-247, configs ddp_{nyu,kitti}/ddp_swin*_scale01.py).

Swin or ConvNeXt -> FPN -> MultiStageMerging gives one 1/4-scale feature
map; the depth latent is ONE channel: metric depth min-max normalised to
[-1, 1]·bit_scale.

Training (``forward``): the ground truth is resized to the feature grid
*bilinearly*, normalised, and corrupted in the gamma form
sqrt(gamma)·x + sqrt(1 − gamma)·noise with ``cosine_gamma(t)``,
t ~ U(sample_range); a 1x1 fusion conv (``down``) over [features, latent],
the time MLP of the raw t (not the log-SNR, unlike the segmentor) and the
time-FiLM msda decoder (``DeformableDepthHead``) predict metric depth, which
is bilinearly upsampled to the ground truth's size and scored by SigLoss.

Serving (``sample``): ``diffusion.timesteps`` DDIM steps in the gamma form on
the grid t_now = 1 − step/T, t_next = max(1 − (step + 1 + td)/T, 0) (no
sample_range scaling), each re-normalising the predicted depth, clamped to
±bit_scale, as the x0 estimate (an 'upconv' head's x4 prediction is resized
back to the latent grid first); randsteps hypotheses are folded r-major into
the batch, clamped to [min_depth, max_depth], averaged, and bilinearly
resized to the image. Images are NHWC, depth [B, H, W] in metres.

Random draws (t, the noise, drop path masks) come from the
``torch.Generator`` the caller passes; ``t`` and ``noise`` may be given.

Mixed precision: the JAX package's bf16 policy gives the depther bf16
weights, image and ground truth, but t and gamma stay float32, so the
corrupted latent is float32 and JAX's type promotion runs the fusion conv,
the time MLP and the decoder in float32 on the bf16-rounded weights. The
port does the same (``nn/common.py: promoted``): those three modules run
in the promoted type of their inputs and weights.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..core import diffusion as diff
from ..core.diffusion import DiffusionConfig
from ..core.schedules import cosine_gamma, right_pad_dims_to
from ..device import resolve_device
from ..nn.common import ConvModule, promoted
from ..nn.convnext import ConvNeXt, convnext_variant
from ..nn.fpn import FPN, MultiStageMerging
from ..nn.heads import DeformableDepthHead
from ..nn.losses import sig_loss
from ..nn.swin import SwinTransformer, swin_variant
from ..nn.time_embed import TimeMLP
from ..ops.resize import resize
from ..parallel.global_batch import global_draw


class DDPDepther(nn.Module):
    def __init__(self, backbone_type: str = "swin", backbone_variant: str = "tiny",
                 embed_dims: int = 256, bit_scale: float = 0.1,
                 diffusion: DiffusionConfig = DiffusionConfig(timesteps=3),
                 max_depth: float = 10.0, min_depth: float = 1e-3,
                 drop_path_rate: float = 0.3, decoder_layers: int = 6,
                 decoder_heads: int = 8, decoder_ffn_dim: int = 1024,
                 align_corners: bool = False, head_variant: str = "deform",
                 depth_act: str = "relu", decoder_remat: bool = False, device=None):
        super().__init__()
        if backbone_type not in ("swin", "convnext"):
            raise ValueError(f"unknown backbone {backbone_type!r}")
        self.embed_dims = embed_dims
        self.bit_scale = bit_scale
        self.diffusion = diffusion
        self.max_depth = max_depth
        self.min_depth = min_depth
        self.align_corners = align_corners
        with torch.device(resolve_device(device)):
            if backbone_type == "swin":
                kw = swin_variant(backbone_variant)
                self.backbone = SwinTransformer(drop_path_rate=drop_path_rate, **kw)
                dims = [kw["embed_dims"] * 2 ** i for i in range(len(kw["depths"]))]
            else:
                kw = convnext_variant(backbone_variant)
                self.backbone = ConvNeXt(drop_path_rate=drop_path_rate, **kw)
                dims = list(kw["dims"])
            self.neck_fpn = FPN(dims, embed_dims, num_outs=4)
            self.neck_merge = MultiStageMerging(4 * embed_dims, embed_dims)
            self.decode_head = DeformableDepthHead(
                embed_dims, num_layers=decoder_layers, num_heads=decoder_heads,
                ffn_dim=decoder_ffn_dim, min_depth=min_depth, variant=head_variant,
                act=depth_act, remat=decoder_remat)
            # fusion conv over [features, latent]: 256 + 1 -> 256, bias, no norm
            self.down = ConvModule(embed_dims + 1, embed_dims, (1, 1))
            self.time_mlp = TimeMLP(dim=embed_dims * 4)
        self.eval()

    # --- building blocks -------------------------------------------------
    def extract_feat(self, img: torch.Tensor,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """backbone -> FPN -> merge: [B, H, W, 3] -> [B, H/4, W/4, C]."""
        return self.neck_merge(self.neck_fpn(self.backbone(img, generator)))

    def normalize_depth(self, depth: torch.Tensor) -> torch.Tensor:
        """Metric depth -> the [−1, 1]·bit_scale latent (ddp.py:133-136)."""
        norm = (depth - self.min_depth) / (self.max_depth - self.min_depth)
        return (norm * 2.0 - 1.0) * self.bit_scale

    def denoise_depth(self, x: torch.Tensor, depth_t: torch.Tensor,
                      t: torch.Tensor) -> torch.Tensor:
        """Fuse the features with the noisy latent and decode metric depth
        [B, h, w, 1] ([B, 4h, 4w, 1] for the 'upconv' head)."""
        dtype = torch.promote_types(x.dtype, depth_t.dtype)
        feat = promoted(self.down, torch.cat([x.to(dtype), depth_t.to(dtype)], dim=-1))
        t_emb = promoted(self.time_mlp, t)  # the raw t (ddp.py:137)
        return promoted(self.decode_head, feat, t_emb)

    # --- training --------------------------------------------------------
    def forward(self, img: torch.Tensor, depth_gt: torch.Tensor,
                t: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Training loss and logs. img [B, H, W, 3]; depth_gt [B, H, W] metric
        depth, <= 0 where invalid; ``t`` [B] and ``noise`` (the latent's
        shape, [B, h, w, 1]) are drawn from ``generator`` when None. Drop path
        acts as the module's mode (``train()``/``eval()``) says."""
        x = self.extract_feat(img, generator)
        b, h, w, _ = x.shape
        gt_small = resize(depth_gt[..., None], (h, w), mode="bilinear",
                          align_corners=self.align_corners)
        latent = self.normalize_depth(gt_small)  # [B, h, w, 1]
        if t is None:
            t = diff.sample_times(b, self.diffusion.sample_range, generator, x.device)
        gamma = right_pad_dims_to(latent.ndim, cosine_gamma(t))
        if noise is None:
            noise = global_draw(lambda s: torch.randn(s, generator=generator,
                                                      dtype=latent.dtype, device=x.device),
                                latent.shape)
        noise = noise.reshape(latent.shape).to(latent.dtype)
        corrupted = torch.sqrt(gamma) * latent + torch.sqrt(1.0 - gamma) * noise
        pred = self.denoise_depth(x, corrupted, t)
        pred_up = resize(pred, tuple(depth_gt.shape[1:3]), mode="bilinear",
                         align_corners=self.align_corners)[..., 0]
        loss = sig_loss(pred_up, depth_gt)
        return loss, {"decode.loss_depth": loss, "loss": loss}

    # --- inference -------------------------------------------------------
    def _time_pairs(self) -> np.ndarray:
        """(t_now, t_next) per step, float32 [T, 2]; no sample_range scaling
        (ddp.py:213-221)."""
        steps, td = self.diffusion.timesteps, self.diffusion.time_difference
        return np.asarray([(1.0 - s / steps, max(1.0 - (s + 1 + td) / steps, 0.0))
                           for s in range(steps)], np.float32)

    def _rollout_hypotheses(self, img: torch.Tensor,
                            generator: Optional[torch.Generator] = None,
                            noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Encode once, run the randsteps-folded DDIM rollout; the metric
        depth of every hypothesis [r, B, ph, pw], clamped to [min_depth,
        max_depth], before the ensemble average. ``noise`` [r·B, h, w, 1] is
        the initial latent, drawn from ``generator`` when None."""
        x = self.extract_feat(img)
        b, h, w, _ = x.shape
        r = self.diffusion.randsteps
        xr = x.repeat(r, 1, 1, 1)  # (r b) folding, r-major like the reference
        shape = (r * b, h, w, 1)
        if noise is None:
            noise = torch.randn(shape, generator=generator, dtype=x.dtype, device=x.device)
        elif tuple(noise.shape) != shape:
            raise ValueError(f"noise shape {tuple(noise.shape)} != {shape}")
        depth_t = noise.to(x.dtype)
        pred = None
        for t_now, t_next in self._time_pairs().tolist():
            tb = torch.full((r * b,), t_now, dtype=x.dtype, device=x.device)
            pred = self.denoise_depth(xr, depth_t, tb)
            pred_lat = (pred if tuple(pred.shape[1:3]) == (h, w) else
                        resize(pred, (h, w), mode="bilinear", align_corners=self.align_corners))
            x0 = torch.clamp(self.normalize_depth(pred_lat), -self.bit_scale, self.bit_scale)
            # the schedule's scalars in float32, as the JAX package computes them
            a_now = cosine_gamma(torch.tensor(t_now, dtype=torch.float32))
            a_next = cosine_gamma(torch.tensor(t_next, dtype=torch.float32))
            s_now = torch.sqrt(a_now).item()
            d_now = torch.sqrt(torch.clamp(1.0 - a_now, min=1e-8)).item()
            s_next, d_next = torch.sqrt(a_next).item(), torch.sqrt(1.0 - a_next).item()
            eps = (depth_t - s_now * x0) / d_now
            depth_t = s_next * x0 + d_next * eps
        ph, pw = pred.shape[1:3]
        return torch.clamp(pred.reshape(r, b, ph, pw), self.min_depth, self.max_depth)

    def _up(self, a: torch.Tensor, size) -> torch.Tensor:
        return resize(a[..., None], tuple(size), mode="bilinear",
                      align_corners=self.align_corners)[..., 0]

    @torch.no_grad()
    def sample(self, img: torch.Tensor, generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Metric depth [B, H, W]: the randsteps-averaged rollout, resized to
        the image."""
        return self._up(self._rollout_hypotheses(img, generator, noise).mean(dim=0),
                        img.shape[1:3])

    @torch.no_grad()
    def sample_with_uncertainty(
        self, img: torch.Tensor, generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Metric depth [B, H, W] and the randsteps ensemble's per-pixel
        uncertainty [B, H, W] in metres: ``std`` (population standard
        deviation across hypotheses; 0 at randsteps 1), ``interval_low`` and
        ``interval_high`` (their 10th and 90th percentiles, linear
        interpolation as ``jnp.percentile``)."""
        hyp = self._rollout_hypotheses(img, generator, noise)
        q = torch.quantile(hyp.float(), torch.tensor([0.1, 0.9], device=hyp.device), dim=0,
                           interpolation="linear").to(hyp.dtype)
        full = img.shape[1:3]
        return self._up(hyp.mean(dim=0), full), {
            "std": self._up(hyp.std(dim=0, correction=0), full),
            "interval_low": self._up(q[0], full), "interval_high": self._up(q[1], full)}
