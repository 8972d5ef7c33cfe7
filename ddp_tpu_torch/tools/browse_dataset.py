"""Write what a preset's train iterator yields as images (port of
``tools/browse_dataset.py``; the reference's tools/browse_dataset.py).

    python -m ddp_tpu_torch.tools.browse_dataset --preset smoke --num 8 \
        --out work_dirs/browse

For the first ``--num`` samples of ``data/__init__.py: make_train_iter``
(what the train step sees: cropped, flipped, distorted, normalised) it
writes ``<out>/sample_{i}_img.png`` (de-normalised; a BEV scene's cameras
side by side) and ``sample_{i}_ann.png``: the label in the dataset's palette
(255 black), a depth map on a blue-green-red ramp up to ``model.max_depth``,
or a BEV occupancy grid as the palette-weighted sum of its class masks. The
PNGs go through Pillow, as the JAX tool's do.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def _save(arr: np.ndarray, path: str) -> None:
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("browse_dataset writes PNGs through Pillow, which is not "
                          "installed") from e
    Image.fromarray(arr.astype(np.uint8)).save(path)


def _colorize_label(label: np.ndarray, palette) -> np.ndarray:
    pal = np.asarray(palette + [[0, 0, 0]], np.uint8)  # 255 -> black
    return pal[np.clip(label, 0, len(pal) - 1)]


def _colorize_depth(depth: np.ndarray, max_depth: float) -> np.ndarray:
    t = np.clip(depth / max_depth, 0, 1)
    r = np.clip(2 * t - 1, 0, 1)
    g = 1 - np.abs(2 * t - 1)
    b = np.clip(1 - 2 * t, 0, 1)
    return (np.stack([r, g, b], -1) * 255).astype(np.uint8)


def render(cfg, batch, i: int):
    """Sample ``i`` of a train batch as (image, annotation), uint8 arrays."""
    from ..data.seg_datasets import IMAGENET_MEAN, IMAGENET_STD, PALETTES, _procedural_palette

    imgs, labels = np.asarray(batch["image"]), np.asarray(batch["label"])
    if imgs.ndim == 5:  # BEV: [b, ncam, H, W, 3], the cameras side by side
        b, nc, h, w, _ = imgs.shape
        imgs = imgs.transpose(0, 2, 1, 3, 4).reshape(b, h, nc * w, 3)
    mean = np.asarray(IMAGENET_MEAN, np.float32)
    std = np.asarray(IMAGENET_STD, np.float32)
    img = np.clip(imgs[i] * std + mean, 0, 255)
    lbl = labels[i]
    task = cfg.model.task
    if task == "depth":
        ann = _colorize_depth(lbl, cfg.model.max_depth)
    elif task == "bev":  # [G, G, K] class masks
        pal = np.asarray(_procedural_palette(lbl.shape[-1]), np.float32)
        ann = np.clip((lbl[..., :, None] * pal).sum(-2), 0, 255)
    else:
        palette = PALETTES.get(cfg.data.dataset, _procedural_palette(cfg.model.num_classes))
        ann = _colorize_label(lbl, list(palette))
    return img.astype(np.uint8), ann.astype(np.uint8)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="write a preset's train batches as PNGs")
    p.add_argument("--preset", default="converge_seg_window")
    p.add_argument("--num", type=int, default=8)
    p.add_argument("--out", default="work_dirs/browse")
    args = p.parse_args(argv)
    from ..config import get_config
    from ..data import make_train_iter

    cfg = get_config(args.preset)
    os.makedirs(args.out, exist_ok=True)
    it = make_train_iter(cfg, rank=0, world=1)
    written = 0
    while written < args.num:
        batch = next(it)
        for i in range(len(batch["image"])):
            if written >= args.num:
                break
            img, ann = render(cfg, batch, i)
            _save(img, os.path.join(args.out, f"sample_{written}_img.png"))
            _save(ann, os.path.join(args.out, f"sample_{written}_ann.png"))
            written += 1
    it.close()
    print(f"wrote {written} samples to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
