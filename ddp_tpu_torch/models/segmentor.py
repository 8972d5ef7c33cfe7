"""DDPSegmentor (port of ``ddp_tpu/models/segmentor.py:39-294``).

Swin or ConvNeXt -> FPN -> MultiStageMerging gives one 1/4-scale feature
map.

Training (``forward``, the JAX module's ``__call__``): the ground truth,
nearest-downsampled to the feature grid with 255 mapped to K, is embedded,
squashed and corrupted at t ~ U(sample_range) in one q_sample CUDA kernel
(``ops/q_sample.py``; its backward is the dtable kernel); the fusion conv and
the time-FiLM decoder (msda or window attention) give logits, the FCN aux
head runs on the clean features, and both losses are the fused x4 upsample +
cross-entropy CUDA kernels (``ops/upsample_ce.py``). ``loss_at="quarter"``,
``self_aligned`` and the resize + CE branch for a non-integer scale follow
the JAX module.

Serving: ``diffusion.timesteps`` DDIM steps, each: 1x1 fusion conv over
[features, latent] plus the time MLP of the log-SNR, the time-FiLM
decoder, argmax, and the argmax re-embedded through the encode-map CUDA
kernel. Softmax is averaged over the steps, over the randsteps hypotheses
(folded r-major into the batch), then bilinearly upsampled. Images are NHWC,
probabilities [B, H, W, K].

Random draws (t, the noise, dropout and drop path masks) come from the
``torch.Generator`` the caller passes; ``t`` and ``noise`` may be given.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..core import diffusion as diff
from ..core.diffusion import DiffusionConfig
from ..core.schedules import log_snr_to_alpha_sigma
from ..device import resolve_device
from ..nn.common import ConvModule
from ..nn.convnext import ConvNeXt, convnext_variant
from ..nn.fpn import FPN, MultiStageMerging
from ..nn.heads import DeformableHeadWithTime, FCNHead
from ..nn.losses import cross_entropy_seg, seg_accuracy
from ..nn.swin import SwinTransformer, swin_variant
from ..nn.time_embed import TimeMLP
from ..ops import q_sample
from ..ops.resize import resize, resize_nearest
from ..ops.upsample_ce import upsample_ce


def latent_grid(backbone_type: str, input_size: Tuple[int, int]) -> Tuple[int, int]:
    """The 1/4-scale feature grid of an (H, W) image: Swin pads the image to
    its patch size, ConvNeXt's stem floors."""
    h, w = input_size
    if backbone_type == "swin":
        return -(-h // 4), -(-w // 4)
    return h // 4, w // 4


class DDPSegmentor(nn.Module):
    def __init__(self, num_classes: int = 150, backbone_type: str = "swin",
                 backbone_variant: str = "tiny", embed_dims: int = 256,
                 bit_scale: float = 0.01, diffusion: DiffusionConfig = DiffusionConfig(),
                 align_corners: bool = False, decoder_layers: int = 6,
                 decoder_heads: int = 8, decoder_ffn_dim: int = 1024,
                 decoder_attn: str = "msda", decoder_window: int = 8,
                 decoder_film: str = "v1", decoder_pos: str = "sine",
                 aux_weight: float = 0.4, drop_path_rate: float = 0.3,
                 self_aligned: bool = False, loss_at: str = "full",
                 input_size: Optional[Tuple[int, int]] = None, device=None):
        """``input_size``: the image size (H, W) the model is built for; the
        learned position tables are sized for its latent grid, as the JAX
        package's init sizes them from its input (None: tables of 50)."""
        super().__init__()
        if backbone_type not in ("swin", "convnext"):
            raise ValueError(f"unknown backbone {backbone_type!r}")
        if loss_at not in ("full", "quarter"):
            raise ValueError(f"loss_at must be 'full' or 'quarter', got {loss_at!r}")
        self.num_classes = num_classes
        self.embed_dims = embed_dims
        self.bit_scale = bit_scale
        self.diffusion = diffusion
        self.align_corners = align_corners
        self.aux_weight = aux_weight
        self.self_aligned = self_aligned
        self.loss_at = loss_at
        with torch.device(resolve_device(device)):
            if backbone_type == "swin":
                kw = swin_variant(backbone_variant)
                self.backbone = SwinTransformer(drop_path_rate=drop_path_rate, **kw)
                dims = [kw["embed_dims"] * 2 ** i for i in range(len(kw["depths"]))]
            else:
                kw = convnext_variant(backbone_variant)
                self.backbone = ConvNeXt(drop_path_rate=drop_path_rate, **kw)
                dims = list(kw["dims"])
            pos_grid = (50, 50) if input_size is None else latent_grid(backbone_type,
                                                                        input_size)
            self.neck_fpn = FPN(dims, embed_dims, num_outs=4)
            self.neck_merge = MultiStageMerging(4 * embed_dims, embed_dims)
            self.decode_head = DeformableHeadWithTime(
                num_classes, embed_dims, num_layers=decoder_layers,
                num_heads=decoder_heads, ffn_dim=decoder_ffn_dim,
                attn_type=decoder_attn, film=decoder_film, pos_type=decoder_pos,
                window=decoder_window, pos_grid=pos_grid)
            self.aux_head = FCNHead(num_classes, embed_dims, embed_dims)
            # K+1 entries: index num_classes is the ignore/padding class (ddp.py:78)
            self.embedding_table = nn.Embedding(num_classes + 1, embed_dims)
            # fusion conv: plain 1x1, bias, no norm/act (ddp.py:92-100)
            self.transform = ConvModule(2 * embed_dims, embed_dims, (1, 1))
            self.time_mlp = TimeMLP(dim=embed_dims * 4)
        self.eval()

    # --- building blocks -------------------------------------------------
    def extract_feat(self, img: torch.Tensor,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """backbone -> FPN -> merge: [B, H, W, 3] -> [B, H/4, W/4, C]."""
        return self.neck_merge(self.neck_fpn(self.backbone(img, generator)))

    def encode_map(self, labels: torch.Tensor) -> torch.Tensor:
        """Class-index map [...] -> squashed analog-bits latent [..., C]."""
        table = self.embedding_table.weight
        flat = q_sample.encode_map(labels.reshape(-1), table, self.bit_scale)
        return flat.reshape(labels.shape + (table.shape[-1],))

    def corrupt_fused(self, labels: torch.Tensor, t: Optional[torch.Tensor] = None,
                      noise: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Embed, squash and corrupt an int label map [B, h, w] in one q_sample
        kernel. ``t`` [B] (drawn from U(sample_range) when None) and ``noise``
        [B·h·w, C] in the table's type (drawn N(0, 1) when None).
        Returns (x_t [B, h, w, C], log_snr [B])."""
        b, h, w = labels.shape
        table = self.embedding_table.weight
        if t is None:
            t = diff.sample_times(b, self.diffusion.sample_range, generator, labels.device)
        log_snr = self.diffusion.log_snr_fn(t.float())
        alpha, sigma = log_snr_to_alpha_sigma(log_snr)
        if noise is None:
            noise = torch.randn((b * h * w, table.shape[-1]), generator=generator,
                                dtype=table.dtype, device=labels.device)
        rows = q_sample.q_sample(labels.reshape(-1), table, self.bit_scale,
                                 alpha.repeat_interleave(h * w),
                                 sigma.repeat_interleave(h * w),
                                 noise.reshape(b * h * w, -1).to(table.dtype))
        return rows.reshape(b, h, w, table.shape[-1]), log_snr

    def denoise_logits(self, x: torch.Tensor, mask_t: torch.Tensor,
                       log_snr: torch.Tensor) -> torch.Tensor:
        """Fuse conditioning features with the noisy latent and decode."""
        feat = self.transform(torch.cat([x, mask_t], dim=-1))
        return self.decode_head(feat, self.time_mlp(log_snr))

    # --- training --------------------------------------------------------
    def forward(self, img: torch.Tensor, gt: torch.Tensor, t: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Training loss and logs (forward_train, ddp.py:131-178). img
        [B, H, W, 3]; gt [B, H, W] int labels, 255 = ignore; ``t`` [B] and
        ``noise`` (the latent's shape, or [B·h·w, C]) are drawn from
        ``generator`` when None. BatchNorm, dropout and drop path act as the
        module's mode (``train()``/``eval()``) says."""
        gt = gt.long()
        x = self.extract_feat(img, generator)
        b, h, w, c = x.shape
        cfg = self.diffusion
        if self.self_aligned:
            # stage 1 (no gradient: only its argmax is used) decodes pure
            # noise at t = 1 and re-embeds the model's own prediction; stage 2
            # corrupts that with the same noise (self_aligned_ddp.py:149-173)
            if noise is None:
                noise = torch.randn(x.shape, generator=generator, dtype=x.dtype,
                                    device=x.device)
            noise = noise.reshape(x.shape).to(x.dtype)
            with torch.no_grad():
                log_snr1 = cfg.log_snr_fn(torch.ones(b, dtype=x.dtype, device=x.device))
                pred = torch.argmax(self.denoise_logits(x, noise, log_snr1), dim=-1)
            latent = self.encode_map(pred)
            if t is None:
                t = diff.sample_times(b, cfg.sample_range, generator, x.device)
            log_snr = cfg.log_snr_fn(t.to(x.dtype))
            noised = diff.q_sample(latent, log_snr, noise)
        else:
            gt_down = resize_nearest(gt[..., None], (h, w))[..., 0]
            gt_down = torch.where(gt_down == 255, self.num_classes, gt_down)
            noised, log_snr = self.corrupt_fused(gt_down, t, noise, generator)
        logits = self.denoise_logits(x, noised, log_snr)

        # the aux head is skipped at weight 0 (as in the JAX module)
        aux_logits = self.aux_head(x, generator) if self.aux_weight else None
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        full = tuple(gt.shape[1:3])
        s = full[0] // h
        if self.loss_at == "quarter":
            gt_q = resize_nearest(gt[..., None], (h, w))[..., 0]
            loss_ce = cross_entropy_seg(logits, gt_q)
            acc = seg_accuracy(logits, gt_q)
            loss_aux = (self.aux_weight * cross_entropy_seg(aux_logits, gt_q)
                        if aux_logits is not None else zero)
        elif not self.align_corners and s > 1 and full == (h * s, w * s):
            # the fused upsample + CE kernels: the full-resolution logits are
            # never materialised
            loss_ce, acc = upsample_ce(logits, gt, s, with_acc=True)
            loss_aux = (self.aux_weight * upsample_ce(aux_logits, gt, s)
                        if aux_logits is not None else zero)
        else:
            logits_up = resize(logits, full, mode="bilinear", align_corners=self.align_corners)
            loss_ce = cross_entropy_seg(logits_up, gt)
            acc = seg_accuracy(logits_up, gt)
            if aux_logits is not None:
                aux_up = resize(aux_logits, full, mode="bilinear",
                                align_corners=self.align_corners)
                loss_aux = self.aux_weight * cross_entropy_seg(aux_up, gt)
            else:
                loss_aux = zero
        loss = loss_ce + loss_aux
        logs = {"decode.loss_ce": loss_ce, "decode.acc_seg": acc, "aux.loss_ce": loss_aux,
                "loss": loss}
        return loss, logs

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
