"""Configuration of the port (from ``ddp_tpu/config.py:19-172,206-294,334-347,
447-521,569-638,640-673,700-763``).

Holds the segmentation, depth, BEV-camera, BEV-fusion (lidar branch) and
ControlNet fields of ``ModelConfig``, the
data fields, the ``OptimConfig`` and the ``RuntimeConfig`` fields the
training loop and the test CLI read, the dotted-path overrides (``--set
model.bit_scale=0.1``), the ADE20K Swin family (``ade20k_swin_{t,s,b,l}``,
window decoder) and ``ade20k_swin_t_msda`` (the reference's msda decoder),
the Cityscapes ConvNeXt and Swin families
(``cityscapes_{convnext,swin}_{t,s,b,l}``, ``cityscapes_convnext_{t,l}_aligned``),
the NYUv2 and KITTI Swin depthers (``nyu_swin_{t,s,b,l}``,
``kitti_swin_{t,s,b,l}``), the nuScenes camera-only and camera+lidar BEV map
segmentors (``nuscenes_camera``, ``nuscenes_fusion``), the end checks
``converge_seg_window``, ``converge_seg_msda``, ``converge_seg_aligned_msda``,
``converge_seg_quarter``, ``converge_seg_w16h4``, ``converge_depth``,
``converge_bev``, ``converge_bev_fusion`` and ``converge_controlnet``, the SD
1.5 ControlNet fine-tune ``controlnet_sd15``, the test presets ``tiny_seg``,
``smoke``, ``smoke_bev`` and ``smoke_fusion``, and ``build_model``. The
defaults are the JAX package's (``decoder_attn="msda"`` among them). The JAX
package's YAML overlay is not ported (no PyYAML on the card; ROADMAP.md
queue 1).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

from .core.diffusion import DiffusionConfig
from .train.optim import OptimConfig


@dataclass(frozen=True)
class ModelConfig:
    task: str = "seg"
    backbone_type: str = "swin"
    backbone_variant: str = "tiny"
    num_classes: int = 150
    embed_dims: int = 256
    bit_scale: float = 0.01
    diffusion: DiffusionConfig = field(default_factory=DiffusionConfig)
    aux_weight: float = 0.4
    drop_path_rate: float = 0.3
    self_aligned: bool = False
    loss_at: str = "full"  # 'full' (reference parity) | 'quarter'
    # decoder: 'msda' = the reference's deformable attention (8 heads, 1
    # level, 4 points: the shape of every released checkpoint; the JAX
    # package's default); 'window' = the JAX package's dense shifted-window
    # attention (16x16 windows, 4 heads in its seg presets)
    decoder_attn: str = "msda"
    decoder_window: int = 8
    decoder_film: str = "v1"  # 'v1' | 'v2' | 'v3'
    # 'sine' | 'learned' (tables of 50 rows and columns, mmseg's default and
    # the JAX package's max(50, h) for grids up to 50)
    decoder_pos: str = "sine"
    decoder_layers: int = 6
    decoder_heads: int = 8
    decoder_ffn_dim: int = 1024
    # recompute each decoder layer in the backward pass (the JAX package's
    # jax.checkpoint): kept for the presets' parity; build_model refuses it
    # (not ported: ROADMAP.md queue 1)
    decoder_remat: bool = False
    # depth: the head variant ('deform' | 'upconv' | 'spade'), its output
    # activation ('relu', the reference's | 'softplus', which never stops
    # learning) and the metric range the latent is normalised over
    depth_head_variant: str = "deform"
    depth_act: str = "relu"
    max_depth: float = 10.0
    min_depth: float = 1e-3
    # ControlNet (task='controlnet'; SD 1.5 defaults, 'tiny' and 'small' scales
    # for the synthetic runs): the latent scale (SD's 0.18215; a from-scratch
    # VAE's is measured, 1 / std of its sampled latents, and saved in
    # scale.json), and the small stacks' VAE width, res blocks and levels
    # (len - 1 stride-2 levels: (1, 2, 4) gives a 4x-reduced latent)
    cn_size: str = "sd15"  # 'sd15' | 'small' | 'tiny'
    cn_image_size: int = 512
    cn_scale_factor: float = 0.18215
    cn_vae_ch: int = 16
    cn_vae_nrb: int = 1
    cn_vae_mult: tuple = (1, 2, 2, 4)
    # BEV camera (task='bev'; the defaults are the reference's camera-bev256d2
    # geometry): the rig's camera count and image size, the head's output
    # grid, the metric scopes bev_grid_transform resamples between, the LSS
    # voxel bounds (lo, hi, step) and depth bins, the LSS channels, top-k
    # depth-bin pruning (0 = off) and the BEV ResNet's (blocks, channels,
    # stride) stages
    bev_num_cams: int = 6
    bev_image_size: Tuple[int, int] = (256, 704)
    bev_out_grid: int = 200
    bev_input_scope: Tuple = ((-51.2, 51.2, 0.8), (-51.2, 51.2, 0.8))
    bev_output_scope: Tuple = ((-50.0, 50.0, 0.5), (-50.0, 50.0, 0.5))
    bev_xbound: Tuple[float, float, float] = (-51.2, 51.2, 0.4)
    bev_ybound: Tuple[float, float, float] = (-51.2, 51.2, 0.4)
    bev_zbound: Tuple[float, float, float] = (-10.0, 10.0, 20.0)
    bev_dbound: Tuple[float, float, float] = (1.0, 60.0, 0.5)
    bev_lss_channels: int = 80
    bev_depth_topk: int = 0
    bev_blocks: Tuple = ((2, 160, 2), (2, 320, 2), (2, 640, 1))
    # BEV fusion's lidar branch (task='bev_fusion'): the sparse encoder's
    # output channels, the dense lidar BEV's side and z planes, the voxel
    # grid's shape, the voxel capacities of its levels (full, /2, /4, /8,
    # down) and the voxel size in metres
    bev_lidar_channels: int = 128
    bev_lidar_dense_hw: int = 128
    bev_lidar_dense_z: int = 2
    bev_sparse_shape: Tuple[int, int, int] = (1024, 1024, 41)
    bev_voxel_caps: Tuple = (120_000, 60_000, 30_000, 15_000, 15_000)
    bev_voxel_size: Tuple[float, float, float] = (0.1, 0.1, 0.2)


@dataclass(frozen=True)
class DataConfig:
    dataset: str = "ade20k"
    data_root: str = "data/ade/ADEChallengeData2016"
    crop_size: Tuple[int, int] = (512, 512)
    batch_size: int = 16  # global training batch
    # train-pipeline knobs (mmseg transforms.py semantics)
    ratio_range: Tuple[float, float] = (0.5, 2.0)
    cat_max_ratio: float = 0.75
    flip_prob: float = 0.5
    ignore_index: int = 255
    mean: Tuple[float, float, float] = (123.675, 116.28, 103.53)
    std: Tuple[float, float, float] = (58.395, 57.12, 57.375)


@dataclass(frozen=True)
class RuntimeConfig:
    total_iters: int = 160_000
    log_interval: int = 50
    ckpt_interval: int = 16_000
    eval_interval: int = 16_000
    max_keep_ckpts: int = -1
    save_best: str = ""  # metric key, e.g. 'mIoU'; '' disables
    save_best_mode: str = "max"  # 'max' | 'min'
    tensorboard: bool = True
    # train steps per dispatch: on the card one CUDA-graph replay of that many
    # steps (train/step.py: ChunkedTrainStep); hooks fire at chunk ends
    steps_per_dispatch: int = 1
    seed: int = 0
    workdir: str = "work_dirs/default"
    mixed_precision: bool = True  # bf16 forward/backward, f32 masters
    test_mode: str = "whole"  # 'whole' | 'slide' (evaluation/slide.py)
    test_crop: Tuple[int, int] = (1024, 1024)
    test_stride: Tuple[int, int] = (768, 768)


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)
    name: str = "custom"


def _replace_path(cfg: Any, dotted: str, value: Any):
    """Immutable deep-replace along a dotted path of dataclass fields."""
    head, _, rest = dotted.partition(".")
    if not dataclasses.is_dataclass(cfg):
        raise KeyError(f"cannot descend into non-dataclass at {head!r}")
    cur = getattr(cfg, head)
    new = _replace_path(cur, rest, value) if rest else _coerce(cur, value)
    return dataclasses.replace(cfg, **{head: new})


def _coerce(old: Any, value: Any):
    """A string from the command line in the type of the field it replaces."""
    if isinstance(value, str) and old is not None and not isinstance(old, str):
        t = type(old)
        if t is bool:
            return value.lower() in ("1", "true", "yes")
        if t is tuple:
            items = [v for v in value.strip("()[] ").split(",") if v]
            inner = type(old[0]) if old else float
            return tuple(inner(v) for v in items)
        return t(value)
    return value


def apply_overrides(cfg: Config, overrides: Dict[str, Any]) -> Config:
    """``cfg`` with each dotted path of ``overrides`` replaced (an unknown
    field raises AttributeError)."""
    for k, v in overrides.items():
        cfg = _replace_path(cfg, k, v)
    return cfg


_DATA_ROOTS = {
    "ade20k": "data/ade/ADEChallengeData2016",
    "cityscapes": "data/cityscapes",
    "nyu": "data/nyu",
    "kitti": "data/kitti",
    "nuscenes": "data/nuscenes",
    "synthetic": "",
}


def _seg(name, backbone, variant, dataset, classes, crop, bs, bit_scale, timesteps=3,
         accumulation=True, lr=6e-5, grad_clip=0.1, iters=160_000, self_aligned=False,
         drop_path=0.3, decoder_attn="window", **rt) -> Config:
    """A reference seg config as the JAX package's ``_seg`` builds it: window
    presets take the 16x16-window, 4-head decoder shape, msda ones keep the
    reference's 8 heads."""
    win_shape = (dict(decoder_window=16, decoder_heads=4)
                 if decoder_attn == "window" else {})
    return Config(
        name=name,
        model=ModelConfig(
            task="seg", backbone_type=backbone, backbone_variant=variant,
            num_classes=classes, bit_scale=bit_scale, self_aligned=self_aligned,
            drop_path_rate=drop_path, decoder_attn=decoder_attn, **win_shape,
            diffusion=DiffusionConfig(timesteps=timesteps, accumulation=accumulation)),
        data=DataConfig(dataset=dataset, crop_size=crop, batch_size=bs,
                        data_root=_DATA_ROOTS.get(dataset, "data")),
        optim=OptimConfig(lr=lr, grad_clip=grad_clip, total_steps=iters),
        runtime=RuntimeConfig(total_iters=iters, **rt),
    )


PRESETS: Dict[str, Callable[[], Config]] = {
    # the reference config itself, with its msda decoder: the JAX package's
    # _seg("ade20k_swin_t", ..., decoder_attn="msda") (ddp_tpu/config.py:
    # 206-252), which keeps the 8-head shape of the released checkpoints
    # (ddp_tpu's get_config("ade20k_swin_t", {"model.decoder_attn": "msda"})
    # keeps the window preset's 4 heads instead: ROADMAP.md queue 3)
    "ade20k_swin_t_msda": lambda: _seg("ade20k_swin_t_msda", "swin", "tiny", "ade20k", 150,
                                       (512, 512), 16, 0.01, decoder_attn="msda"),
    # the end check of training (ddp_tpu/config.py:334-347): flagship-shaped
    # but tiny (nano Swin, 64-d window decoder of 6 layers, window 8, 8 heads),
    # trained on synthetic 64x64 crops through train() and scored by
    # evaluation/convergence.py; its own workdir, so that a run never
    # overwrites the JAX package's committed result under
    # work_dirs/converge_seg_window
    "converge_seg_window": lambda: Config(
        name="converge_seg_window",
        model=ModelConfig(backbone_variant="nano", num_classes=7, embed_dims=64,
                          decoder_layers=6, decoder_heads=8, decoder_ffn_dim=256,
                          drop_path_rate=0.0, bit_scale=0.01, decoder_attn="window",
                          diffusion=DiffusionConfig(timesteps=3, accumulation=True)),
        data=DataConfig(dataset="synthetic", crop_size=(64, 64), batch_size=16),
        optim=OptimConfig(lr=3e-4, grad_clip=1.0, total_steps=1500, warmup_steps=100,
                          schedule="poly"),
        runtime=RuntimeConfig(total_iters=1500, log_interval=100, ckpt_interval=500,
                              eval_interval=10_000, max_keep_ckpts=1, steps_per_dispatch=10,
                              workdir="work_dirs/torch_converge_seg_window"),
    ),
    # the msda twin of converge_seg_window (ddp_tpu/config.py:394-411); the
    # JAX package's converge_seg is the same model (its decoder_attn
    # defaults to 'msda'), so it is not added a second time
    "converge_seg_msda": lambda: Config(
        name="converge_seg_msda",
        model=ModelConfig(backbone_variant="nano", num_classes=7, embed_dims=64,
                          decoder_layers=6, decoder_heads=8, decoder_ffn_dim=256,
                          drop_path_rate=0.0, bit_scale=0.01, decoder_attn="msda",
                          diffusion=DiffusionConfig(timesteps=3, accumulation=True)),
        data=DataConfig(dataset="synthetic", crop_size=(64, 64), batch_size=16),
        optim=OptimConfig(lr=3e-4, grad_clip=1.0, total_steps=1500, warmup_steps=100,
                          schedule="poly"),
        runtime=RuntimeConfig(total_iters=1500, log_interval=100, ckpt_interval=500,
                              eval_interval=10_000, max_keep_ckpts=1, steps_per_dispatch=10,
                              workdir="work_dirs/torch_converge_seg_msda"),
    ),
    # the self-aligned fine-tune of converge_seg_msda's checkpoint
    # (ddp_tpu/config.py:414-428; the reference's SelfAlignedDDP recipe:
    # 10 DDIM steps, a tenth of the lr, a short schedule)
    "converge_seg_aligned_msda": lambda: Config(
        name="converge_seg_aligned_msda",
        model=ModelConfig(backbone_variant="nano", num_classes=7, embed_dims=64,
                          decoder_layers=6, decoder_heads=8, decoder_ffn_dim=256,
                          drop_path_rate=0.0, bit_scale=0.01, decoder_attn="msda",
                          self_aligned=True,
                          diffusion=DiffusionConfig(timesteps=10, accumulation=True)),
        data=DataConfig(dataset="synthetic", crop_size=(64, 64), batch_size=16),
        optim=OptimConfig(lr=3e-5, grad_clip=1.0, total_steps=300, warmup_steps=0,
                          schedule="poly"),
        runtime=RuntimeConfig(total_iters=300, log_interval=50, ckpt_interval=300,
                              eval_interval=10_000, max_keep_ckpts=1, steps_per_dispatch=10,
                              workdir="work_dirs/torch_converge_seg_aligned_msda"),
    ),
    # the depth end check (ddp_tpu/config.py:447-463): nano Swin, 64-d msda
    # decoder of 6 layers, softplus output, synthetic 64x64 crops
    "converge_depth": lambda: Config(
        name="converge_depth",
        model=ModelConfig(task="depth", backbone_variant="nano", embed_dims=64,
                          decoder_layers=6, decoder_heads=8, decoder_ffn_dim=256,
                          drop_path_rate=0.0, bit_scale=0.1, max_depth=10.0,
                          depth_act="softplus", decoder_attn="msda",
                          diffusion=DiffusionConfig(timesteps=3, accumulation=False)),
        data=DataConfig(dataset="synthetic", crop_size=(64, 64), batch_size=16),
        optim=OptimConfig(lr=1e-4, grad_clip=1.0, total_steps=1500, warmup_steps=300,
                          schedule="cosine"),
        runtime=RuntimeConfig(total_iters=1500, log_interval=100, ckpt_interval=500,
                              eval_interval=10_000, max_keep_ckpts=1, steps_per_dispatch=10,
                              workdir="work_dirs/torch_converge_depth"),
    ),
    # the quarter-resolution CE variant of converge_seg (ddp_tpu/config.py:
    # 374-391): the loss on the 1/4-scale logits; it names no decoder_attn,
    # so it takes the default msda decoder, as in JAX
    "converge_seg_quarter": lambda: Config(
        name="converge_seg_quarter",
        model=ModelConfig(backbone_variant="nano", num_classes=7, embed_dims=64,
                          decoder_layers=6, decoder_heads=8, decoder_ffn_dim=256,
                          drop_path_rate=0.0, bit_scale=0.01, loss_at="quarter",
                          diffusion=DiffusionConfig(timesteps=3, accumulation=True)),
        data=DataConfig(dataset="synthetic", crop_size=(64, 64), batch_size=16),
        optim=OptimConfig(lr=3e-4, grad_clip=1.0, total_steps=1500, warmup_steps=100,
                          schedule="poly"),
        runtime=RuntimeConfig(total_iters=1500, log_interval=100, ckpt_interval=500,
                              eval_interval=10_000, max_keep_ckpts=1, steps_per_dispatch=10,
                              workdir="work_dirs/torch_converge_seg_quarter"),
    ),
    # the 16x16-window, 4-head decoder shape at converge_seg's scale
    # (ddp_tpu/config.py:353-371)
    "converge_seg_w16h4": lambda: Config(
        name="converge_seg_w16h4",
        model=ModelConfig(backbone_variant="nano", num_classes=7, embed_dims=64,
                          decoder_layers=6, decoder_heads=4, decoder_ffn_dim=256,
                          drop_path_rate=0.0, bit_scale=0.01, decoder_attn="window",
                          decoder_window=16,
                          diffusion=DiffusionConfig(timesteps=3, accumulation=True)),
        data=DataConfig(dataset="synthetic", crop_size=(64, 64), batch_size=16),
        optim=OptimConfig(lr=3e-4, grad_clip=1.0, total_steps=1500, warmup_steps=100,
                          schedule="poly"),
        runtime=RuntimeConfig(total_iters=1500, log_interval=100, ckpt_interval=500,
                              eval_interval=10_000, max_keep_ckpts=1, steps_per_dispatch=10,
                              workdir="work_dirs/torch_converge_seg_w16h4"),
    ),
    # nuScenes camera-only BEV map segmentation (bev/configs/nuscenes/seg/
    # ddp-camera-bev256d2-lss-scale001-d5-lr5e-5.yaml, as ddp_tpu/config.py:
    # 299-315 builds it): Swin-T on 6 cameras of 256x704, LSS, 5 window
    # decoder layers on the 200^2 output grid, randsteps 5, lr 5e-5, clip 35
    "nuscenes_camera": lambda: Config(
        name="nuscenes_camera",
        model=ModelConfig(task="bev", backbone_type="swin", backbone_variant="tiny",
                          num_classes=6, bit_scale=0.01, decoder_layers=5,
                          decoder_attn="window",
                          diffusion=DiffusionConfig(timesteps=3, randsteps=5)),
        data=DataConfig(dataset="nuscenes", batch_size=8, data_root=_DATA_ROOTS["nuscenes"],
                        crop_size=(256, 704)),
        optim=OptimConfig(lr=5e-5, grad_clip=35.0, total_steps=42_000, schedule="cosine",
                          warmup_steps=1000),
        runtime=RuntimeConfig(total_iters=42_000, ckpt_interval=2000, eval_interval=2000),
    ),
    # the BEV end check (ddp_tpu/config.py:464-489): nano Swin, 48-d msda
    # decoder of 5 layers (the default attention), the 6-camera synthetic
    # rig at 32x64, a 20^2 output grid over +-8 m
    "converge_bev": lambda: Config(
        name="converge_bev",
        model=ModelConfig(task="bev", backbone_type="swin", backbone_variant="nano",
                          num_classes=3, embed_dims=48, decoder_layers=5, decoder_heads=8,
                          decoder_ffn_dim=192, drop_path_rate=0.0, bit_scale=0.01,
                          diffusion=DiffusionConfig(timesteps=3, randsteps=5),
                          bev_image_size=(32, 64), bev_out_grid=20,
                          bev_input_scope=((-8.0, 8.0, 1.0), (-8.0, 8.0, 1.0)),
                          bev_output_scope=((-8.0, 8.0, 0.8), (-8.0, 8.0, 0.8)),
                          bev_xbound=(-8.0, 8.0, 0.5), bev_ybound=(-8.0, 8.0, 0.5),
                          bev_dbound=(1.0, 9.0, 1.0), bev_lss_channels=24,
                          bev_blocks=((1, 32, 2), (1, 48, 1))),
        data=DataConfig(dataset="synthetic", batch_size=16, crop_size=(32, 64)),
        optim=OptimConfig(lr=1e-3, grad_clip=5.0, total_steps=2500, warmup_steps=100,
                          schedule="cosine"),
        runtime=RuntimeConfig(total_iters=2500, log_interval=100, ckpt_interval=500,
                              eval_interval=10_000, max_keep_ckpts=1, steps_per_dispatch=10,
                              workdir="work_dirs/torch_converge_bev"),
    ),
    # the BEV fusion end check (ddp_tpu/config.py:492-521): converge_bev's
    # camera model plus a 32-channel lidar branch on a 128 x 128 x 41 voxel
    # grid of 0.125 m, capacities 1024/512/256/128/128, a 16^2 lidar BEV
    "converge_bev_fusion": lambda: Config(
        name="converge_bev_fusion",
        model=ModelConfig(task="bev_fusion", backbone_type="swin", backbone_variant="nano",
                          num_classes=3, embed_dims=48, decoder_layers=5, decoder_heads=8,
                          decoder_ffn_dim=192, drop_path_rate=0.0, bit_scale=0.01,
                          diffusion=DiffusionConfig(timesteps=3, randsteps=5),
                          bev_image_size=(32, 64), bev_out_grid=20,
                          bev_input_scope=((-8.0, 8.0, 1.0), (-8.0, 8.0, 1.0)),
                          bev_output_scope=((-8.0, 8.0, 0.8), (-8.0, 8.0, 0.8)),
                          bev_xbound=(-8.0, 8.0, 0.5), bev_ybound=(-8.0, 8.0, 0.5),
                          bev_dbound=(1.0, 9.0, 1.0), bev_lss_channels=24,
                          bev_blocks=((1, 32, 2), (1, 48, 1)),
                          bev_lidar_channels=32, bev_lidar_dense_hw=16, bev_lidar_dense_z=2,
                          bev_sparse_shape=(128, 128, 41),
                          bev_voxel_caps=(1024, 512, 256, 128, 128),
                          bev_voxel_size=(0.125, 0.125, 0.2)),
        data=DataConfig(dataset="synthetic", batch_size=16, crop_size=(32, 64)),
        optim=OptimConfig(lr=1e-3, grad_clip=5.0, total_steps=2500, warmup_steps=100,
                          schedule="cosine"),
        runtime=RuntimeConfig(total_iters=2500, log_interval=100, ckpt_interval=500,
                              eval_interval=10_000, max_keep_ckpts=1, steps_per_dispatch=10,
                              workdir="work_dirs/torch_converge_bev_fusion"),
    ),
    # nuScenes camera + lidar BEV map segmentation (bev/configs/nuscenes/seg/
    # ddp-fusion-bev256d2-lss-scale001-d5-lr5e-5.yaml, as ddp_tpu/config.py:
    # 584-596 builds it): nuscenes_camera plus the lidar branch at its
    # defaults (0.1 x 0.1 x 0.2 m voxels in a 1024 x 1024 x 41 grid, a 128^2
    # x 256-channel lidar BEV)
    "nuscenes_fusion": lambda: Config(
        name="nuscenes_fusion",
        model=ModelConfig(task="bev_fusion", backbone_type="swin", backbone_variant="tiny",
                          num_classes=6, bit_scale=0.01, decoder_layers=5,
                          decoder_attn="window",
                          diffusion=DiffusionConfig(timesteps=3, randsteps=5)),
        data=DataConfig(dataset="nuscenes", batch_size=8, data_root=_DATA_ROOTS["nuscenes"],
                        crop_size=(256, 704)),
        optim=OptimConfig(lr=5e-5, grad_clip=35.0, total_steps=42_000, schedule="cosine",
                          warmup_steps=1000),
        runtime=RuntimeConfig(total_iters=42_000, ckpt_interval=2000, eval_interval=2000),
    ),
    # the ControlNet end check (ddp_tpu/config.py:523-550): the 'small' stack
    # at 64², a 4x-reduced latent (VAE levels (1, 2, 4)), the VAE pretrained
    # first (evaluation/convergence.py: pretrain_vae) and frozen by lr_mult 0,
    # 40k steps of 16 on the card's procedural fill50k
    "converge_controlnet": lambda: Config(
        name="converge_controlnet",
        model=ModelConfig(task="controlnet", cn_size="small", cn_image_size=64,
                          cn_vae_mult=(1, 2, 4)),
        data=DataConfig(dataset="synthetic", crop_size=(64, 64), batch_size=16),
        optim=OptimConfig(lr=2e-4, grad_clip=1.0, total_steps=40_000, warmup_steps=100,
                          schedule="cosine",
                          custom_keys=(("first_stage_model", (0.0, 0.0)),)),
        runtime=RuntimeConfig(total_iters=40_000, log_interval=200, ckpt_interval=2000,
                              eval_interval=100_000, max_keep_ckpts=1, steps_per_dispatch=20,
                              workdir="work_dirs/torch_converge_controlnet"),
    ),
    # the SD 1.5 ControlNet fine-tune (tutorial_train.py: lr 1e-5, the SD
    # stack locked, here by lr_mult 0 rules; ddp_tpu/config.py:553-566)
    "controlnet_sd15": lambda: Config(
        name="controlnet_sd15",
        model=ModelConfig(task="controlnet", cn_size="sd15", cn_image_size=512),
        data=DataConfig(dataset="fill50k", data_root="data/fill50k", crop_size=(512, 512),
                        batch_size=4),
        optim=OptimConfig(lr=1e-5, grad_clip=1.0, total_steps=100_000, schedule="constant",
                          warmup_steps=0,
                          custom_keys=(("diffusion_model", (0.0, 0.0)),
                                       ("first_stage_model", (0.0, 0.0)),
                                       ("cond_stage_model", (0.0, 0.0)))),
        runtime=RuntimeConfig(total_iters=100_000, ckpt_interval=5000,
                              eval_interval=1_000_000, workdir="work_dirs/controlnet_sd15"),
    ),
    # tiny CPU-runnable fusion preset (ddp_tpu/config.py:598-620): 2
    # cameras, a 32-d msda decoder of 1 layer, 2 DDIM steps, 1 randstep, a
    # 24-channel lidar branch at capacities 512/256/128/96/96
    "smoke_fusion": lambda: Config(
        name="smoke_fusion",
        model=ModelConfig(task="bev_fusion", backbone_type="swin", backbone_variant="nano",
                          num_classes=3, embed_dims=32, decoder_layers=1, decoder_heads=4,
                          decoder_ffn_dim=64, drop_path_rate=0.0,
                          diffusion=DiffusionConfig(timesteps=2, randsteps=1),
                          bev_num_cams=2, bev_image_size=(32, 64), bev_out_grid=20,
                          bev_input_scope=((-8.0, 8.0, 1.0), (-8.0, 8.0, 1.0)),
                          bev_output_scope=((-8.0, 8.0, 0.8), (-8.0, 8.0, 0.8)),
                          bev_xbound=(-8.0, 8.0, 0.5), bev_ybound=(-8.0, 8.0, 0.5),
                          bev_dbound=(1.0, 9.0, 1.0), bev_lss_channels=16,
                          bev_blocks=((1, 24, 2), (1, 32, 1)),
                          bev_lidar_channels=24, bev_lidar_dense_hw=16, bev_lidar_dense_z=2,
                          bev_sparse_shape=(128, 128, 41),
                          bev_voxel_caps=(512, 256, 128, 96, 96),
                          bev_voxel_size=(0.125, 0.125, 0.2)),
        data=DataConfig(dataset="synthetic", batch_size=4, crop_size=(32, 64)),
        optim=OptimConfig(lr=1e-3, total_steps=40, warmup_steps=5, grad_clip=5.0),
        runtime=RuntimeConfig(total_iters=40, log_interval=10, ckpt_interval=40,
                              eval_interval=1000, workdir="work_dirs/smoke_fusion"),
    ),
    # tiny CPU-runnable BEV preset (ddp_tpu/config.py:621-638): 2 cameras,
    # a 32-d msda decoder of 1 layer, 2 DDIM steps, 2 randsteps
    "smoke_bev": lambda: Config(
        name="smoke_bev",
        model=ModelConfig(task="bev", backbone_type="swin", backbone_variant="nano",
                          num_classes=3, embed_dims=32, decoder_layers=1, decoder_heads=4,
                          decoder_ffn_dim=64, drop_path_rate=0.0,
                          diffusion=DiffusionConfig(timesteps=2, randsteps=2),
                          bev_num_cams=2, bev_image_size=(32, 64), bev_out_grid=20,
                          bev_input_scope=((-8.0, 8.0, 1.0), (-8.0, 8.0, 1.0)),
                          bev_output_scope=((-8.0, 8.0, 0.8), (-8.0, 8.0, 0.8)),
                          bev_xbound=(-8.0, 8.0, 0.5), bev_ybound=(-8.0, 8.0, 0.5),
                          bev_dbound=(1.0, 9.0, 1.0), bev_lss_channels=16,
                          bev_blocks=((1, 24, 2), (1, 32, 1))),
        data=DataConfig(dataset="synthetic", batch_size=4, crop_size=(32, 64)),
        optim=OptimConfig(lr=1e-3, total_steps=60, warmup_steps=5, grad_clip=5.0),
        runtime=RuntimeConfig(total_iters=60, log_interval=10, ckpt_interval=30,
                              eval_interval=1000, workdir="work_dirs/smoke_bev"),
    ),
    # tiny CPU-runnable smoke preset (ddp_tpu/config.py:569-581): ConvNeXt
    # nano with the msda decoder (the JAX ModelConfig's default attention)
    "smoke": lambda: Config(
        name="smoke",
        model=ModelConfig(task="seg", backbone_type="convnext", backbone_variant="nano",
                          num_classes=7, embed_dims=32, decoder_layers=2, decoder_heads=4,
                          decoder_ffn_dim=64, drop_path_rate=0.0, decoder_attn="msda",
                          diffusion=DiffusionConfig(timesteps=2)),
        data=DataConfig(dataset="synthetic", crop_size=(32, 32), batch_size=8),
        optim=OptimConfig(lr=1e-3, total_steps=100, warmup_steps=10, grad_clip=1.0),
        runtime=RuntimeConfig(total_iters=100, log_interval=10, ckpt_interval=50,
                              eval_interval=50, workdir="work_dirs/smoke"),
    ),
    # test-only scale: swin 'nano', 64-d decoder of 2 layers, window 4, K=7,
    # two randsteps hypotheses so that the r-major folding is exercised
    "tiny_seg": lambda: Config(
        name="tiny_seg",
        model=ModelConfig(backbone_variant="nano", num_classes=7, embed_dims=64,
                          decoder_attn="window", decoder_window=4, decoder_heads=4,
                          decoder_layers=2, decoder_ffn_dim=256, bit_scale=0.01,
                          diffusion=DiffusionConfig(timesteps=3, randsteps=2,
                                                    accumulation=True)),
        data=DataConfig(dataset="synthetic", crop_size=(64, 64), batch_size=2),
        optim=OptimConfig(lr=3e-4, grad_clip=1.0, total_steps=1500, warmup_steps=100),
        runtime=RuntimeConfig(total_iters=1500, log_interval=100, ckpt_interval=500,
                              eval_interval=10_000, max_keep_ckpts=1,
                              workdir="work_dirs/tiny_seg"),
    ),
}


# the ADE20K Swin family (configs/ade/ddp_swin_{t,s,b,l}_2x8_512x512_160k_ade20k.py
# with the JAX package's shipped window decoder shape: 16x16 windows, 4 heads
# of 64; ddp_tpu/config.py:248-252)
for _v in ("tiny", "small", "base", "large"):
    PRESETS[f"ade20k_swin_{_v[0]}"] = lambda v=_v: _seg(
        f"ade20k_swin_{v[0]}", "swin", v, "ade20k", 150, (512, 512), 16, 0.01)

# Cityscapes ConvNeXt and Swin families (configs/cityscapes/ddp_{convnext,swin}_*_
# 4x4_512x1024_160k_cityscapes.py, as ddp_tpu/config.py:254-260 builds them)
for _b in ("convnext", "swin"):
    for _v in ("tiny", "small", "base", "large"):
        PRESETS[f"cityscapes_{_b}_{_v[0]}"] = lambda b=_b, v=_v: _seg(
            f"cityscapes_{b}_{v[0]}", b, v, "cityscapes", 19, (512, 1024), 16, 0.01,
            drop_path=0.4 if b == "convnext" else 0.3)

# the self-aligned fine-tune (configs/cityscapes/ddp_convnext_t_4x4_512x1024_5k_
# cityscapes_aligned.py: 10 DDIM steps, lr 10x lower, 5k iterations;
# ddp_tpu/config.py:262-268)
for _v in ("tiny", "large"):
    PRESETS[f"cityscapes_convnext_{_v[0]}_aligned"] = lambda v=_v: _seg(
        f"cityscapes_convnext_{v[0]}_aligned", "convnext", v, "cityscapes", 19,
        (512, 1024), 16, 0.01, timesteps=10, lr=6e-6, iters=5000, self_aligned=True,
        drop_path=0.4)


# the NYUv2 and KITTI Swin depthers (depth/configs/ddp_{nyu,kitti}/ddp_swin*_
# scale01.py, as ddp_tpu/config.py:270-294 builds them): bit_scale 0.1, 3 DDIM
# steps, the msda decoder, cosine lr 6e-5 after 12,800 warm-up iterations from
# a ratio of 1e-3, grad clip 35, 38,400 iterations at 2 x 8 images
def _depth(name, variant, dataset, max_depth, crop) -> Config:
    return Config(
        name=name,
        model=ModelConfig(task="depth", backbone_type="swin", backbone_variant=variant,
                          bit_scale=0.1, max_depth=max_depth, min_depth=1e-3,
                          decoder_attn="msda",
                          diffusion=DiffusionConfig(timesteps=3, accumulation=False)),
        data=DataConfig(dataset=dataset, crop_size=crop, batch_size=16,
                        data_root=_DATA_ROOTS.get(dataset, "data")),
        optim=OptimConfig(lr=6e-5, grad_clip=35.0, total_steps=38_400, schedule="cosine",
                          warmup_steps=12_800, warmup_ratio=1e-3),
        runtime=RuntimeConfig(total_iters=38_400, ckpt_interval=1600, eval_interval=1600,
                              max_keep_ckpts=2),
    )


for _v in ("tiny", "small", "base", "large"):
    PRESETS[f"nyu_swin_{_v[0]}"] = lambda v=_v: _depth(
        f"nyu_swin_{v[0]}", v, "nyu", 10.0, (416, 544))
    PRESETS[f"kitti_swin_{_v[0]}"] = lambda v=_v: _depth(
        f"kitti_swin_{v[0]}", v, "kitti", 80.0, (352, 704))


def get_config(name: str, overrides: Optional[Dict[str, Any]] = None) -> Config:
    """The preset ``name`` with the dotted-path ``overrides`` applied."""
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    cfg = PRESETS[name]()
    if overrides:
        cfg = apply_overrides(cfg, overrides)
    return cfg


def build_controlnet(cfg: ModelConfig, device=None):
    """The ``ControlNetTrainer`` of ``cfg`` (``ddp_tpu/config.py:729-744``):
    SD 1.5 widths, or the 'tiny' / 'small' UNet with a 64-wide, 2-layer CLIP
    of 512 tokens and the ``cn_vae_*`` VAE."""
    from .models.controlnet import ControlNetTrainer
    from .nn.unet import UNetConfig

    if cfg.cn_size in ("tiny", "small"):
        unet = UNetConfig().tiny() if cfg.cn_size == "tiny" else UNetConfig().small()
        return ControlNetTrainer(unet=unet, clip_width=64, clip_layers=2, clip_vocab=512,
                                 vae_ch=cfg.cn_vae_ch, vae_ch_mult=tuple(cfg.cn_vae_mult),
                                 vae_nrb=cfg.cn_vae_nrb, scale_factor=cfg.cn_scale_factor,
                                 device=device)
    return ControlNetTrainer(unet=UNetConfig(), scale_factor=cfg.cn_scale_factor,
                             device=device)


def build_model(cfg: ModelConfig, device=None, seed: int = 0,
                input_size: Optional[Tuple[int, int]] = None):
    """DDPSegmentor (``task="seg"``), DDPDepther (``task="depth"``),
    DDPBEVCamera (``task="bev"``), DDPBEVFusion (``task="bev_fusion"``) or a
    ControlNetTrainer (``task="controlnet"``, ``build_controlnet``) for
    ``cfg`` on ``device`` (default "cuda"; raises without a GPU unless a
    device is named), weights drawn from ``seed``. ``input_size``: the image
    size the model is built for (the training crop), which sizes a
    segmentor's learned position tables."""
    from .nn.common import init_params_

    if cfg.decoder_remat:
        raise NotImplementedError("decoder_remat (the decoder's layers recomputed in the "
                                  "backward pass) is not ported")
    if cfg.task == "seg":
        from .models.segmentor import DDPSegmentor

        model = DDPSegmentor(
            num_classes=cfg.num_classes, backbone_type=cfg.backbone_type,
            backbone_variant=cfg.backbone_variant, embed_dims=cfg.embed_dims,
            bit_scale=cfg.bit_scale, diffusion=cfg.diffusion,
            decoder_layers=cfg.decoder_layers, decoder_heads=cfg.decoder_heads,
            decoder_ffn_dim=cfg.decoder_ffn_dim, decoder_attn=cfg.decoder_attn,
            decoder_window=cfg.decoder_window, decoder_film=cfg.decoder_film,
            decoder_pos=cfg.decoder_pos,
            aux_weight=cfg.aux_weight, drop_path_rate=cfg.drop_path_rate,
            self_aligned=cfg.self_aligned, loss_at=cfg.loss_at, input_size=input_size,
            device=device)
    elif cfg.task == "depth":
        from .models.depther import DDPDepther

        model = DDPDepther(
            backbone_type=cfg.backbone_type, backbone_variant=cfg.backbone_variant,
            embed_dims=cfg.embed_dims, bit_scale=cfg.bit_scale, diffusion=cfg.diffusion,
            max_depth=cfg.max_depth, min_depth=cfg.min_depth,
            drop_path_rate=cfg.drop_path_rate, decoder_layers=cfg.decoder_layers,
            decoder_heads=cfg.decoder_heads, decoder_ffn_dim=cfg.decoder_ffn_dim,
            head_variant=cfg.depth_head_variant, depth_act=cfg.depth_act, device=device)
    elif cfg.task in ("bev", "bev_fusion"):
        # the JAX package's build_model passes no decoder_window here: the
        # head keeps its default window of 8
        kw = dict(
            num_classes=cfg.num_classes, embed_dims=cfg.embed_dims, bit_scale=cfg.bit_scale,
            diffusion=cfg.diffusion, backbone_variant=cfg.backbone_variant,
            decoder_layers=cfg.decoder_layers, decoder_heads=cfg.decoder_heads,
            decoder_ffn_dim=cfg.decoder_ffn_dim, decoder_attn=cfg.decoder_attn,
            drop_path_rate=cfg.drop_path_rate, image_size=cfg.bev_image_size,
            out_grid=cfg.bev_out_grid, input_scope=cfg.bev_input_scope,
            output_scope=cfg.bev_output_scope, xbound=cfg.bev_xbound, ybound=cfg.bev_ybound,
            zbound=cfg.bev_zbound, dbound=cfg.bev_dbound,
            lss_out_channels=cfg.bev_lss_channels, depth_topk=cfg.bev_depth_topk,
            bev_blocks=cfg.bev_blocks, device=device)
        if cfg.task == "bev":
            from .models.bev import DDPBEVCamera

            model = DDPBEVCamera(**kw)
        else:
            from .models.bev_fusion import DDPBEVFusion

            model = DDPBEVFusion(lidar_channels=cfg.bev_lidar_channels,
                                 lidar_dense_hw=cfg.bev_lidar_dense_hw,
                                 lidar_dense_z=cfg.bev_lidar_dense_z, **kw)
    elif cfg.task == "controlnet":
        model = build_controlnet(cfg, device)
    else:
        raise ValueError(f"unknown task {cfg.task!r}")
    if next(model.parameters()).device.type != "meta":
        init_params_(model, seed)
    return model
