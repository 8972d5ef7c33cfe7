"""DDPBEVCamera (port of ``ddp_tpu/models/bev.py``): camera-only BEV map
segmentation as noise-to-map diffusion (the reference's fusion_models/ddp.py
in its camera-only configuration, ddp-camera-bev256d2-lss-scale001-d5-
lr5e-5.yaml).

Swin (stages 1-3) on every camera -> ``GeneralizedLSSFPN`` -> ``LSSTransform``
(depth softmax ⊗ features -> frustum unprojection through the rig ->
``bev_pool`` -> stride-2 downsample) -> ``GeneralizedResNet`` + ``LSSFPN`` give
the BEV features [B, G, G, C] (G = 128 at nuScenes scale).

Training (``forward``): the multi-label masks [B, outG, outG, K] are
nearest-resized to G, each class k embedded as index (k+1)·mask (0 where
absent), averaged over the classes and squashed (``encode_masks``; the JAX
package computes this in XLA, not in its Pallas encode kernel), corrupted
at t ~ U(sample_range) (``diff.q_sample`` on the cosine log-SNR); the 1x1
fusion conv over [features, latent] and the time MLP of the log-SNR feed
``bev_grid_transform`` to the output grid and the time-FiLM decoder, whose
per-class logits are scored by the sigmoid focal loss, summed over classes.

Serving (``sample``): ``diffusion.timesteps`` DDIM steps on the BEV's own
time grid, t_now = 1 − step/T, t_next = max(1 − (step + 1 + td)/T, 0) (no
sample_range scaling, ddp.py:130-138); each step thresholds the sigmoid
scores at 0.5, nearest-resizes them to G and re-embeds them as x0; the
scores are averaged over the steps, then over the randsteps hypotheses
(folded r-major into the batch). ``sample_with_uncertainty`` also gives the
hypotheses' variance and the Bernoulli entropy of the mean.

Random draws (t, the noise, drop path masks) come from the
``torch.Generator`` the caller passes; ``t`` and ``noise`` may be given.

Mixed precision: under the JAX package's bf16 policy t stays float32, so
the corrupted latent is float32 and type promotion runs the fusion conv,
the time MLP, the grid transform and the decoder in float32 on the
bf16-rounded weights; the port does the same (``nn/common.py: promoted``).
The rig, cast to bf16 by the policy, is cast back to float32 for the
geometry, as in JAX.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..core import diffusion as diff
from ..core.diffusion import DiffusionConfig
from ..device import resolve_device
from ..nn.bev import GeneralizedLSSFPN, GeneralizedResNet, LSSFPN, LSSTransform, \
    bev_grid_transform
from ..nn.common import ConvModule, promoted
from ..nn.heads import DeformableHeadWithTime
from ..nn.losses import sigmoid_focal_loss
from ..nn.swin import SwinTransformer, swin_variant
from ..nn.time_embed import TimeMLP
from ..ops.resize import resize

MAP_CLASSES = ("drivable_area", "ped_crossing", "walkway", "stop_line", "carpark_area",
               "divider")

class DDPBEVCamera(nn.Module):
    THRESHOLD = 0.5  # a class is present where its score exceeds this

    def __init__(self, num_classes: int = 6, embed_dims: int = 256, bit_scale: float = 0.01,
                 diffusion: DiffusionConfig = DiffusionConfig(timesteps=3, randsteps=5),
                 backbone_variant: str = "tiny", image_size: Tuple[int, int] = (256, 704),
                 out_grid: int = 200,
                 input_scope=((-51.2, 51.2, 0.8), (-51.2, 51.2, 0.8)),
                 output_scope=((-50.0, 50.0, 0.5), (-50.0, 50.0, 0.5)),
                 xbound=(-51.2, 51.2, 0.4), ybound=(-51.2, 51.2, 0.4),
                 zbound=(-10.0, 10.0, 20.0), dbound=(1.0, 60.0, 0.5),
                 lss_out_channels: int = 80, depth_topk: int = 0,
                 bev_blocks=((2, 160, 2), (2, 320, 2), (2, 640, 1)),
                 decoder_layers: int = 5, decoder_heads: int = 8, decoder_ffn_dim: int = 1024,
                 decoder_attn: str = "msda", drop_path_rate: float = 0.3,
                 bev_in_channels: Optional[int] = None, device=None):
        super().__init__()
        if num_classes > len(MAP_CLASSES):
            raise ValueError(f"at most {len(MAP_CLASSES)} map classes, got {num_classes}")
        self.num_classes = num_classes
        self.embed_dims = embed_dims
        self.bit_scale = bit_scale
        self.diffusion = diffusion
        self.out_grid = out_grid
        self.input_scope = input_scope
        self.output_scope = output_scope
        with torch.device(resolve_device(device)):
            kw = swin_variant(backbone_variant)
            kw["out_indices"] = (1, 2, 3)
            self.backbone = SwinTransformer(drop_path_rate=drop_path_rate, **kw)
            self.camera_neck = GeneralizedLSSFPN(
                [kw["embed_dims"] * 2 ** i for i in (1, 2, 3)], embed_dims)
            self.vtransform = LSSTransform(
                embed_dims, lss_out_channels, image_size,
                (image_size[0] // 8, image_size[1] // 8), xbound, ybound, zbound, dbound,
                depth_topk=depth_topk)
            # the BEV ResNet reads the LSS output (a fusion model: the fuser's)
            self.bev_backbone = GeneralizedResNet(
                bev_in_channels or lss_out_channels * self.vtransform.nx[2], bev_blocks)
            self.bev_neck = LSSFPN((bev_blocks[-1][1], bev_blocks[0][1]), embed_dims)
            self.decode_head = DeformableHeadWithTime(
                num_classes, embed_dims, num_layers=decoder_layers, num_heads=decoder_heads,
                ffn_dim=decoder_ffn_dim, attn_type=decoder_attn)
            self.embedding_table = nn.Embedding(num_classes + 1, embed_dims)
            self.transform = ConvModule(2 * embed_dims, embed_dims, (1, 1))
            self.time_mlp = TimeMLP(dim=embed_dims * 4)
        self.eval()

    # --- encoders --------------------------------------------------------
    def extract_bev_feat(self, img: torch.Tensor, *rig: torch.Tensor,
                         generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Cameras [B, N, H, W, 3] and the rig (cam2lidar rots [B, N, 3, 3],
        trans [B, N, 3], intrins [B, N, 3, 3], post rots, post trans) -> the
        BEV features [B, G, G, C]."""
        return self.bev_neck(self.bev_backbone(self.extract_camera(img, *rig,
                                                                   generator=generator)))

    def extract_camera(self, img: torch.Tensor, *rig: torch.Tensor,
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The LSS output [B, G', G', nz·C_lss] (before the BEV ResNet)."""
        b, n, h, w, _ = img.shape
        feats = self.camera_neck(self.backbone(img.reshape(b * n, h, w, 3), generator))
        return self.vtransform(feats[0].reshape(b, n, *feats[0].shape[1:]), *rig)

    # --- latent codec ----------------------------------------------------
    def encode_masks(self, masks: torch.Tensor) -> torch.Tensor:
        """Multi-label masks [N, G, G, K] at the latent grid -> the latent
        [N, G, G, C]: class k's index k+1 where present (0 where absent),
        embedded, averaged over the classes, squashed (ddp.py:206-211)."""
        factor = torch.arange(1, self.num_classes + 1, device=masks.device)
        emb = self.embedding_table(masks.long() * factor).mean(dim=-2)
        return (torch.sigmoid(emb) * 2.0 - 1.0) * self.bit_scale

    def denoise_logits(self, x: torch.Tensor, mask_t: torch.Tensor,
                       log_snr: torch.Tensor) -> torch.Tensor:
        """Fuse and decode: logits on the output grid [N, outG, outG, K]."""
        dtype = torch.promote_types(x.dtype, mask_t.dtype)
        feat = promoted(self.transform, torch.cat([x.to(dtype), mask_t.to(dtype)], dim=-1))
        t_emb = promoted(self.time_mlp, log_snr)
        feat = bev_grid_transform(feat, self.input_scope, self.output_scope)
        return promoted(self.decode_head, feat, t_emb)

    # --- training --------------------------------------------------------
    def forward(self, img: torch.Tensor, cam2lidar_rots: torch.Tensor,
                cam2lidar_trans: torch.Tensor, intrins: torch.Tensor, post_rots: torch.Tensor,
                post_trans: torch.Tensor, gt_masks: torch.Tensor,
                t: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Training loss and logs (``map.<class>.focal`` and ``loss``).
        gt_masks [B, outG, outG, K] binary; ``t`` [B] and ``noise`` (the
        latent's shape, [B, G, G, C]) are drawn from ``generator`` when None.
        Drop path acts as the module's mode says."""
        x = self.extract_bev_feat(img, cam2lidar_rots, cam2lidar_trans, intrins, post_rots,
                                  post_trans, generator=generator)
        return self._train_loss(x, gt_masks, t, noise, generator)

    def _train_loss(self, x: torch.Tensor, gt_masks: torch.Tensor, t: Optional[torch.Tensor],
                    noise: Optional[torch.Tensor], generator: Optional[torch.Generator]
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The loss and logs of the BEV features x [B, G, G, C] (``forward``
        after the encoder)."""
        b, g = x.shape[:2]
        latent = self.encode_masks(resize(gt_masks.float(), (g, g), mode="nearest"))
        if t is None:
            t = diff.sample_times(b, self.diffusion.sample_range, generator, x.device)
        log_snr = self.diffusion.log_snr_fn(t.float())
        if noise is None:
            noise = torch.randn(latent.shape, generator=generator, dtype=latent.dtype,
                                device=x.device)
        noised = diff.q_sample(latent, log_snr, noise.reshape(latent.shape).to(latent.dtype))
        logits = self.denoise_logits(x, noised, log_snr)
        losses: Dict[str, torch.Tensor] = {}
        total = None
        for k, name in enumerate(MAP_CLASSES[:self.num_classes]):
            lk = sigmoid_focal_loss(logits[..., k], gt_masks[..., k].to(logits.dtype)).mean()
            losses[f"map.{name}.focal"] = lk
            total = lk if total is None else total + lk
        losses["loss"] = total
        return total, losses

    # --- inference -------------------------------------------------------
    def _time_pairs(self) -> np.ndarray:
        steps, td = self.diffusion.timesteps, self.diffusion.time_difference
        return np.asarray([(1.0 - s / steps, max(1.0 - (s + 1 + td) / steps, 0.0))
                           for s in range(steps)], np.float64)

    def _rollout_hypotheses(self, img: torch.Tensor, *rig: torch.Tensor,
                            generator: Optional[torch.Generator] = None,
                            noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The DDIM rollout with step accumulation, the randsteps hypotheses
        kept apart: sigmoid scores [r, B, outG, outG, K]. ``noise`` [r·B, G,
        G, C] is the initial latent, drawn from ``generator`` when None. ``rig``:
        the rest of ``extract_bev_feat``'s inputs."""
        x = self.extract_bev_feat(img, *rig)
        b, g, _, c = x.shape
        r = self.diffusion.randsteps
        xr = x.repeat(r, 1, 1, 1)  # (r b) folding, r-major like the reference
        shape = (r * b, g, g, c)
        if noise is None:
            noise = torch.randn(shape, generator=generator, dtype=x.dtype, device=x.device)
        elif tuple(noise.shape) != shape:
            raise ValueError(f"noise shape {tuple(noise.shape)} != {shape}")
        mask_t = noise.to(x.dtype)
        outs = []
        for t_now, t_next in self._time_pairs().tolist():
            log_snr = self.diffusion.log_snr_fn(
                torch.full((r * b,), t_now, dtype=x.dtype, device=x.device))
            log_snr_next = self.diffusion.log_snr_fn(
                torch.full((r * b,), t_next, dtype=x.dtype, device=x.device))
            probs = torch.sigmoid(self.denoise_logits(xr, mask_t, log_snr))
            pred = (probs > self.THRESHOLD).float()
            x0 = self.encode_masks(resize(pred, (g, g), mode="nearest"))
            mask_t = diff.ddim_update(mask_t, x0, log_snr, log_snr_next)
            outs.append(probs)
        out = torch.stack(outs, dim=0)
        return out.reshape(len(outs), r, b, *out.shape[2:]).mean(dim=0)

    @torch.no_grad()
    def sample(self, img: torch.Tensor, cam2lidar_rots: torch.Tensor,
               cam2lidar_trans: torch.Tensor, intrins: torch.Tensor, post_rots: torch.Tensor,
               post_trans: torch.Tensor, generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Sigmoid scores [B, outG, outG, K]: the step-accumulated rollout,
        averaged over the randsteps hypotheses."""
        return self._rollout_hypotheses(img, cam2lidar_rots, cam2lidar_trans, intrins,
                                        post_rots, post_trans, generator=generator,
                                        noise=noise).mean(dim=0)

    @torch.no_grad()
    def sample_with_uncertainty(
        self, img: torch.Tensor, cam2lidar_rots: torch.Tensor, cam2lidar_trans: torch.Tensor,
        intrins: torch.Tensor, post_rots: torch.Tensor, post_trans: torch.Tensor,
        generator: Optional[torch.Generator] = None, noise: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Scores [B, outG, outG, K] and the per-cell uncertainty [B, outG,
        outG]: ``variance``, the class mean of the hypotheses' (population)
        variance (0 at randsteps 1), and ``entropy``, the class mean of the
        Bernoulli entropy (nats) of the mean score."""
        return self._uncertainty(self._rollout_hypotheses(
            img, cam2lidar_rots, cam2lidar_trans, intrins, post_rots, post_trans,
            generator=generator, noise=noise))

    @staticmethod
    def _uncertainty(hyp: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The scores and uncertainty maps of the hypotheses [r, B, outG, outG, K]."""
        scores = hyp.mean(dim=0)
        var = hyp.var(dim=0, correction=0).mean(dim=-1)
        p = torch.clamp(scores, 1e-12, 1.0 - 1e-12)
        ent = (-(p * torch.log(p) + (1 - p) * torch.log1p(-p))).mean(dim=-1)
        return scores, {"variance": var, "entropy": ent}
