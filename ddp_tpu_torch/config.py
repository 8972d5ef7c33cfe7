"""Configuration of the port (from ``ddp_tpu/config.py:19-142,206-252,640-673``).

Holds the segmentation fields of ``ModelConfig``, the data fields, the
``OptimConfig`` and the ``RuntimeConfig`` fields the training loop reads, the
``ade20k_swin_t`` preset, one tiny test preset, and ``build_model``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Tuple

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
    # decoder: 'window' = dense shifted-window attention (the presets'
    # shape: 16x16 windows, 4 heads); 'msda' is not ported yet
    decoder_attn: str = "window"
    decoder_window: int = 8
    decoder_film: str = "v1"
    decoder_pos: str = "sine"
    decoder_layers: int = 6
    decoder_heads: int = 8
    decoder_ffn_dim: int = 1024


@dataclass(frozen=True)
class DataConfig:
    dataset: str = "ade20k"
    crop_size: Tuple[int, int] = (512, 512)
    batch_size: int = 16  # global training batch
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
    steps_per_dispatch: int = 1  # > 1 is not ported (train() raises)
    seed: int = 0
    workdir: str = "work_dirs/default"
    mixed_precision: bool = True  # bf16 forward/backward, f32 masters


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)
    name: str = "custom"


PRESETS: Dict[str, Callable[[], Config]] = {
    # configs/ade/ddp_swin_t_2x8_512x512_160k_ade20k.py with the JAX package's
    # shipped window decoder shape (16x16 windows, 4 heads of 64)
    "ade20k_swin_t": lambda: Config(
        name="ade20k_swin_t",
        model=ModelConfig(backbone_variant="tiny", num_classes=150, bit_scale=0.01,
                          decoder_attn="window", decoder_window=16, decoder_heads=4,
                          diffusion=DiffusionConfig(timesteps=3, accumulation=True)),
        data=DataConfig(dataset="ade20k", crop_size=(512, 512), batch_size=16),
        optim=OptimConfig(lr=6e-5, grad_clip=0.1, total_steps=160_000),
        runtime=RuntimeConfig(total_iters=160_000),
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


def get_config(name: str) -> Config:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    return PRESETS[name]()


def build_model(cfg: ModelConfig, device=None, seed: int = 0):
    """DDPSegmentor for ``cfg`` on ``device`` (default "cuda"; raises without
    a GPU unless a device is named), weights drawn from ``seed``."""
    if cfg.task != "seg":
        raise NotImplementedError(f"task {cfg.task!r} is not ported yet")
    from .models.segmentor import DDPSegmentor
    from .nn.common import init_params_

    model = DDPSegmentor(
        num_classes=cfg.num_classes, backbone_type=cfg.backbone_type,
        backbone_variant=cfg.backbone_variant, embed_dims=cfg.embed_dims,
        bit_scale=cfg.bit_scale, diffusion=cfg.diffusion,
        decoder_layers=cfg.decoder_layers, decoder_heads=cfg.decoder_heads,
        decoder_ffn_dim=cfg.decoder_ffn_dim, decoder_attn=cfg.decoder_attn,
        decoder_window=cfg.decoder_window, decoder_film=cfg.decoder_film,
        decoder_pos=cfg.decoder_pos, aux_weight=cfg.aux_weight,
        drop_path_rate=cfg.drop_path_rate, self_aligned=cfg.self_aligned,
        loss_at=cfg.loss_at, device=device)
    if next(model.parameters()).device.type != "meta":
        init_params_(model, seed)
    return model
