"""ControlNet sampling demo, headless (port of ``tools/control_demo.py``; the
reference's gradio_seg2image_ddp.py ``process``): a hint (a synthetic fill50k
pair's outline, or an image) and a prompt, DDIM with classifier-free
guidance, a PNG row of the samples.

    python -m ddp_tpu_torch.tools.control_demo --preset converge_controlnet \\
        --index 3 --num-samples 4 --steps 20 --scale 9.0 --out demo_cn.png
    python -m ddp_tpu_torch.tools.control_demo --preset controlnet_sd15 \\
        --hint hint.png --prompt "red circle with blue background"

Restores the latest checkpoint under ``--workdir`` (default: the preset's;
without one the seeded random init samples, with a warning) and the latent
scale a trained run saved in ``<workdir>/scale.json``. Prompts go through
the toy word-level tokenizer of ``data/controlnet_data.py``, as JAX's demo
tokenizes them. Runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch


def save_grid(imgs: np.ndarray, path: str) -> str:
    """[n, H, W, 3] uint8 tiled into one row: a PNG through Pillow, else the
    raw array as ``path.npy`` (as JAX's demo). Returns the path written."""
    n, h, w, _ = imgs.shape
    grid = imgs.transpose(1, 0, 2, 3).reshape(h, n * w, 3)
    try:
        from PIL import Image
    except ImportError:
        path += ".npy"
        np.save(path, grid)
    else:
        Image.fromarray(grid).save(path)
    print(f"wrote {path}", flush=True)
    return path


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="ControlNet sampling demo")
    p.add_argument("--preset", default="converge_controlnet")
    p.add_argument("--workdir", default=None, help="checkpoint dir (default: preset workdir)")
    p.add_argument("--hint", default=None,
                   help="hint image path (else the synthetic fill50k pair --index)")
    p.add_argument("--prompt", default=None)
    p.add_argument("--index", type=int, default=0)
    p.add_argument("--num-samples", type=int, default=4)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--scale", type=float, default=9.0, help="classifier-free guidance scale")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="control_demo.png")
    p.add_argument("--set", nargs="*", default=[], metavar="K=V")
    p.add_argument("--device", default=None, help="default: cuda")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from ..config import build_model, get_config
    from ..data.controlnet_data import MAX_LEN, SyntheticFill50k, read_rgb, tokenize
    from ..device import resolve_device
    from ..train.checkpoint import read_model

    cfg = get_config(args.preset, dict(kv.split("=", 1) for kv in args.set))
    workdir = args.workdir or cfg.runtime.workdir
    scale_json = os.path.join(workdir, "scale.json")
    if os.path.exists(scale_json):
        with open(scale_json) as f:
            sf = json.load(f)["cn_scale_factor"]
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, cn_scale_factor=sf))
        print(f"using measured cn_scale_factor {sf:.5f}", flush=True)
    device = resolve_device(args.device)
    model = build_model(cfg.model, device=device, seed=cfg.runtime.seed)
    try:
        step, sd = read_model(workdir)
    except FileNotFoundError:
        print("WARNING: no checkpoint found — sampling from random init", flush=True)
    else:
        model.load_state_dict(sd)
        print(f"restored step {step}", flush=True)
    size = cfg.model.cn_image_size
    if args.hint:
        hint, ids = read_rgb(args.hint, size) / 255.0, tokenize(args.prompt or "")
    else:
        pair = SyntheticFill50k(size=size).load(args.index)
        hint = pair["hint"]
        ids = tokenize(args.prompt) if args.prompt else pair["ids"]
    n = args.num_samples

    def batch(a):
        return torch.from_numpy(np.ascontiguousarray(np.broadcast_to(a, (n,) + a.shape))
                                ).to(device)

    imgs = model.eval().sample(batch(hint.astype(np.float32)), batch(ids),
                               batch(tokenize("", MAX_LEN)), steps=args.steps,
                               guidance_scale=args.scale,
                               generator=torch.Generator(device=device).manual_seed(args.seed))
    imgs = torch.clamp((imgs + 1.0) * 127.5, 0, 255).to(torch.uint8).cpu().numpy()
    save_grid(imgs, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
