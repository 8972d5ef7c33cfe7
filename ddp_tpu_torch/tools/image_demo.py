"""Single-image inference demo (port of ``tools/image_demo.py``).

    python -m ddp_tpu_torch.tools.image_demo PRESET IMAGE [--ckpt PUBLISHED.pt]
        [--out pred.png] [--uncertainty heat.png] [--seed 0] [--set K=V ...]
        [--device cpu]

Reads the image (``data/image_io.py: read_image``), normalises it with the
ImageNet statistics, runs ``DDPSegmentor.predict`` (with ``--uncertainty``
``sample_with_uncertainty``, and writes the across-hypothesis variance as a
grey heat map scaled to its maximum) with the rollout noise drawn from a
generator seeded by ``--seed``, and writes the class map coloured by the
dataset's palette (``data/seg_datasets.py: PALETTES``; a seeded random
colour table where the dataset has none) as a PNG. Runs on the card unless
``--device cpu``.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="segment one image")
    p.add_argument("preset")
    p.add_argument("image")
    p.add_argument("--ckpt", default=None, help="published .pt model state")
    p.add_argument("--out", default="pred.png")
    p.add_argument("--uncertainty", default=None, metavar="PNG",
                   help="also save the randsteps ensemble's per-pixel variance")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--set", nargs="*", default=[], metavar="K=V")
    p.add_argument("--device", default=None, help="default: cuda")
    args = p.parse_args(argv)
    from ..config import get_config
    from ..data.image_io import read_image, write_png
    from ..data.seg_datasets import PALETTES, normalize_image
    from ..device import resolve_device
    from . import segmentor

    cfg = get_config(args.preset, dict(kv.split("=", 1) for kv in args.set))
    device = resolve_device(args.device)
    model = segmentor(cfg, args.ckpt, device)
    img = read_image(args.image, rgb=True).astype(np.float32)
    x = torch.from_numpy(normalize_image(img)[None]).to(device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    if args.uncertainty:
        probs, unc = model.sample_with_uncertainty(x, generator=gen)
        pred = probs.argmax(-1)
        var = unc["variance"][0].cpu().numpy()
        heat = np.clip(var / max(float(var.max()), 1e-12) * 255, 0, 255).astype(np.uint8)
        write_png(args.uncertainty, heat)
        print(f"saved {args.uncertainty} (mean variance {var.mean():.3e}, "
              f"mean entropy {unc['entropy'].mean().item():.3f} nats)")
    else:
        pred = model.predict(x, generator=gen)
    pred = pred[0].cpu().numpy().astype(np.uint8)
    palette = PALETTES.get(cfg.data.dataset)
    if palette is not None:
        color = np.asarray(palette, np.uint8)[pred % len(palette)]
    else:
        color = np.random.default_rng(0).integers(0, 255, (256, 3), dtype=np.uint8)[pred]
    write_png(args.out, color)
    print(f"saved {args.out} (classes present: {sorted(set(pred.reshape(-1).tolist()))[:20]})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
