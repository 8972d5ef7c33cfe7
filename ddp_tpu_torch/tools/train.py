"""Training CLI (port of ``tools/train.py``).

    python -m ddp_tpu_torch.tools.train PRESET [--workdir DIR] [--resume]
        [--set model.bit_scale=0.1 optim.lr=1e-4 ...] [--device cpu]

Builds the preset's config with the overrides, its train batch iterator
(``data/__init__.py: make_train_iter``: synthetic data, an ADE20K or
Cityscapes tree for a segmentor, a nyu, kitti, sunrgbd or cityscapes depth
split for a depther such as ``nyu_swin_t``, under ``data.data_root``; the
synthetic camera rig for a BEV preset such as ``smoke_bev``) and runs
``train/loop.py: train``
on the card (``--device cpu`` for the CPU). The JAX tool's ``--yaml`` overlay
and ``--distributed`` multi-device run are not ported (ROADMAP.md queue 1).
"""
from __future__ import annotations

import argparse
import os
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="ddp_tpu_torch trainer")
    p.add_argument("preset")
    p.add_argument("--workdir", default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--set", nargs="*", default=[], metavar="K=V")
    p.add_argument("--device", default=None, help="default: cuda")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from ..config import get_config
    from ..data import make_train_iter
    from ..train.loop import train

    overrides = dict(kv.split("=", 1) for kv in args.set)
    if args.workdir:
        overrides["runtime.workdir"] = args.workdir
    cfg = get_config(args.preset, overrides)
    os.makedirs(cfg.runtime.workdir, exist_ok=True)
    train(cfg, make_train_iter(cfg), resume=args.resume, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
