"""Configuration of the port (from ``ddp_tpu/config.py:19-142,206-252,640-673``).

Holds the segmentation fields of ``ModelConfig``, the data fields the
serving path reads, the ``ade20k_swin_t`` preset, one tiny test preset, and
``build_model``. Training fields arrive with the training slice.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Tuple

from .core.diffusion import DiffusionConfig


@dataclass(frozen=True)
class ModelConfig:
    task: str = "seg"
    backbone_type: str = "swin"
    backbone_variant: str = "tiny"
    num_classes: int = 150
    embed_dims: int = 256
    bit_scale: float = 0.01
    diffusion: DiffusionConfig = field(default_factory=DiffusionConfig)
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
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
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
        decoder_pos=cfg.decoder_pos, device=device)
    if next(model.parameters()).device.type != "meta":
        init_params_(model, seed)
    return model
