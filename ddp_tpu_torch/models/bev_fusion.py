"""DDPBEVFusion (port of ``ddp_tpu/models/bev_fusion.py:40-254``): camera +
lidar BEV map segmentation (the reference's fusion_models/ddp.py with
ddp-fusion-bev256d2-lss-scale001-d5-lr5e-5.yaml).

The camera branch is ``DDPBEVCamera``'s (Swin stages 1-3 -> camera FPN ->
LSS, 80 channels on the 128² grid). The lidar branch takes the host's hard
voxelization (mean point features per voxel, [B, cap0, 5]) and rulebooks
(``data/bev_datasets.py``), runs 12 ``SparseConvLayer``s (the SparseEncoder
layout: channels 16, (32, 32, 32), (64, 64, 64), (64, 64, 64), then a (1, 1, 3)
conv down z to ``lidar_channels``) over the batch folded into the voxel axis,
so that each BatchNorm's statistics span the whole batch, and densifies the
last level into [B, hw, hw, z·lidar_channels]. ``fuse`` concatenates the two
BEVs, runs the ConvFuser (a 3x3 conv and BN; the JAX package's has no ReLU)
and the BEV ResNet and FPN. The diffusion head, the focal loss and the
rollout are the camera model's (inherited).

Batch values, in order (``data/bev_datasets.py: FUSION_BATCH_KEYS``): the
cameras and the rig, ``voxel_feats`` [B, cap0, F] and ``rulebooks`` (a dict
of int32 arrays [B, K, cap] for subm1, spconv2, subm2, spconv3, subm3,
spconv4, subm4 and down, plus down_coords [B, cap4, 3] and down_valid
[B, cap4]), then ``gt_masks``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..device import resolve_device
from ..nn.common import ConvModule
from ..nn.sparse_conv import SparseConvLayer, densify
from .bev import DDPBEVCamera

# the level each gather rulebook reads from
_IN_LEVEL = {"subm1": "subm1", "spconv2": "subm1", "subm2": "spconv2", "spconv3": "spconv2",
             "subm3": "spconv3", "spconv4": "spconv3", "subm4": "spconv4", "down": "spconv4"}
_ENCODER_CHANNELS = ((16,), (32, 32, 32), (64, 64, 64), (64, 64, 64))
LIDAR_FEATURES = 5  # a voxel's mean point: x, y, z, intensity, time lag


class DDPBEVFusion(DDPBEVCamera):
    def __init__(self, *, lidar_channels: int = 128, lidar_dense_hw: int = 128,
                 lidar_dense_z: int = 2, embed_dims: int = 256, lss_out_channels: int = 80,
                 device=None, **kw):
        super().__init__(embed_dims=embed_dims, lss_out_channels=lss_out_channels,
                         bev_in_channels=embed_dims, device=device, **kw)
        self.lidar_dense_hw = lidar_dense_hw
        self.lidar_dense_z = lidar_dense_z
        defs = [("lidar_conv_input", _ENCODER_CHANNELS[0][0], "subm1", 27)]
        defs += [(f"lidar_enc0_{j}", ch, "subm1", 27)
                 for j, ch in enumerate(_ENCODER_CHANNELS[0])]
        for si in range(1, 4):
            chans = _ENCODER_CHANNELS[si]
            defs.append((f"lidar_enc{si}_0", chans[0], f"spconv{si + 1}", 27))
            defs += [(f"lidar_enc{si}_{j}", ch, f"subm{si + 1}", 27)
                     for j, ch in enumerate(chans[1:], start=1)]
        defs.append(("lidar_conv_out", lidar_channels, "down", 3))
        self.lidar_layer_defs = tuple((name, key) for name, _, key, _ in defs)
        cam_channels = lss_out_channels * self.vtransform.nx[2]
        with torch.device(resolve_device(device)):
            cin = LIDAR_FEATURES
            for name, ch, _, k in defs:
                setattr(self, name, SparseConvLayer(cin, ch, num_offsets=k))
                cin = ch
            self.fuser_conv = ConvModule(cam_channels + lidar_dense_z * lidar_channels,
                                         embed_dims, (3, 3), norm="BN")
        self.eval()

    # --- encoders --------------------------------------------------------
    @staticmethod
    def fold_rulebooks(rulebooks: Dict[str, torch.Tensor], cap0: int
                       ) -> Dict[str, torch.Tensor]:
        """Per-sample gather rulebooks [B, K, cap] -> one [K, B·cap] over the
        batch folded into the voxel axis: sample b's input rows shifted by b
        times its input level's capacity, -1 kept."""
        b = rulebooks["subm1"].shape[0]
        in_cap = {key: rulebooks[src].shape[-1] for key, src in _IN_LEVEL.items()}
        in_cap["subm1"] = in_cap["spconv2"] = cap0
        folded = {}
        for key, cap in in_cap.items():
            g = rulebooks[key]
            offs = (torch.arange(b, device=g.device, dtype=g.dtype) * cap)[:, None, None]
            g = torch.where(g >= 0, g + offs, -1)
            folded[key] = g.transpose(0, 1).reshape(g.shape[1], -1)
        return folded

    def extract_lidar_dense(self, voxel_feats: torch.Tensor,
                            rulebooks: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Voxel features [B, cap0, F] and the rulebooks -> the lidar BEV
        [B, hw, hw, z·lidar_channels], under a ``lidar_branch`` profiler
        range."""
        with torch.profiler.record_function("lidar_branch"):
            b, cap0, cf = voxel_feats.shape
            folded = self.fold_rulebooks(rulebooks, cap0)
            x = voxel_feats.reshape(b * cap0, cf)
            for name, key in self.lidar_layer_defs:
                x = getattr(self, name)(x, folded[key])
            coords = rulebooks["down_coords"].reshape(-1, 3)
            valid = rulebooks["down_valid"].reshape(-1)
            return densify(x, coords, valid, b, self.lidar_dense_hw, self.lidar_dense_z)

    def fuse(self, cam_bev: torch.Tensor, lidar_bev: torch.Tensor) -> torch.Tensor:
        x = self.fuser_conv(torch.cat([cam_bev, lidar_bev.to(cam_bev.dtype)], dim=-1))
        return self.bev_neck(self.bev_backbone(x))

    def extract_bev_feat(self, img: torch.Tensor, cam2lidar_rots: torch.Tensor,
                         cam2lidar_trans: torch.Tensor, intrins: torch.Tensor,
                         post_rots: torch.Tensor, post_trans: torch.Tensor,
                         voxel_feats: torch.Tensor, rulebooks: Dict[str, torch.Tensor],
                         generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The fused BEV features [B, G, G, C]."""
        cam = self.extract_camera(img, cam2lidar_rots, cam2lidar_trans, intrins, post_rots,
                                  post_trans, generator=generator)
        return self.fuse(cam, self.extract_lidar_dense(voxel_feats, rulebooks))

    # --- training --------------------------------------------------------
    def forward(self, img: torch.Tensor, cam2lidar_rots: torch.Tensor,
                cam2lidar_trans: torch.Tensor, intrins: torch.Tensor, post_rots: torch.Tensor,
                post_trans: torch.Tensor, voxel_feats: torch.Tensor,
                rulebooks: Dict[str, torch.Tensor], gt_masks: torch.Tensor,
                t: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Training loss and logs, as ``DDPBEVCamera.forward``."""
        x = self.extract_bev_feat(img, cam2lidar_rots, cam2lidar_trans, intrins, post_rots,
                                  post_trans, voxel_feats, rulebooks, generator=generator)
        return self._train_loss(x, gt_masks, t, noise, generator)

    # --- inference -------------------------------------------------------
    @torch.no_grad()
    def sample(self, img: torch.Tensor, cam2lidar_rots: torch.Tensor,
               cam2lidar_trans: torch.Tensor, intrins: torch.Tensor, post_rots: torch.Tensor,
               post_trans: torch.Tensor, voxel_feats: torch.Tensor,
               rulebooks: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Sigmoid scores [B, outG, outG, K], as ``DDPBEVCamera.sample``."""
        return self._rollout_hypotheses(img, cam2lidar_rots, cam2lidar_trans, intrins,
                                        post_rots, post_trans, voxel_feats, rulebooks,
                                        generator=generator, noise=noise).mean(dim=0)

    @torch.no_grad()
    def sample_with_uncertainty(
        self, img: torch.Tensor, cam2lidar_rots: torch.Tensor, cam2lidar_trans: torch.Tensor,
        intrins: torch.Tensor, post_rots: torch.Tensor, post_trans: torch.Tensor,
        voxel_feats: torch.Tensor, rulebooks: Dict[str, torch.Tensor],
        generator: Optional[torch.Generator] = None, noise: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Scores and uncertainty maps, as ``DDPBEVCamera.sample_with_uncertainty``."""
        return self._uncertainty(self._rollout_hypotheses(
            img, cam2lidar_rots, cam2lidar_trans, intrins, post_rots, post_trans, voxel_feats,
            rulebooks, generator=generator, noise=noise))
