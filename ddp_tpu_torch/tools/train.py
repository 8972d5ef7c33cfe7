"""Training CLI (port of ``tools/train.py``).

    python -m ddp_tpu_torch.tools.train PRESET [--workdir DIR] [--resume]
        [--yaml OVERLAY.yaml] [--set model.bit_scale=0.1 optim.lr=1e-4 ...]
        [--device cpu] [--distributed]
    torchrun --nproc_per_node=N -m ddp_tpu_torch.tools.train PRESET --distributed

Builds the preset's config, overlaid by the ``--yaml`` file
(``config.py: load_yaml_overlay``, the YAML subset overlays use) and then the
``--set`` overrides, its train batch iterator
(``data/__init__.py: make_train_iter``: synthetic data, an ADE20K or
Cityscapes tree for a segmentor, a nyu, kitti, sunrgbd or cityscapes depth
split for a depther such as ``nyu_swin_t``, under ``data.data_root``; the
synthetic camera rig for a BEV preset such as ``smoke_bev``) and runs
``train/loop.py: train``
on the card (``--device cpu`` for the CPU). ``--distributed`` joins the
process group torchrun's environment describes (``parallel/mesh.py:
init_distributed``: ``nccl`` on ``cuda:LOCAL_RANK``, ``gloo`` with
``--device cpu``), and the run is data-parallel: each process trains on its
rank's rows of every global batch of ``data.batch_size``.
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
    p.add_argument("--yaml", default=None, help="a YAML overlay of dotted keys or nested mappings")
    p.add_argument("--set", nargs="*", default=[], metavar="K=V")
    p.add_argument("--device", default=None, help="default: cuda")
    p.add_argument("--distributed", action="store_true",
                   help="join torchrun's process group (nccl; gloo with --device cpu)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from ..config import apply_overrides, get_config, load_yaml_overlay
    from ..data import make_train_iter
    from ..parallel.mesh import init_distributed
    from ..train.loop import train

    device = init_distributed(args.device) if args.distributed else args.device

    overrides = dict(kv.split("=", 1) for kv in args.set)
    if args.workdir:
        overrides["runtime.workdir"] = args.workdir
    cfg = get_config(args.preset)
    if args.yaml:
        cfg = load_yaml_overlay(cfg, args.yaml)
    cfg = apply_overrides(cfg, overrides)
    os.makedirs(cfg.runtime.workdir, exist_ok=True)
    try:
        train(cfg, make_train_iter(cfg), resume=args.resume, device=device)
    finally:
        if args.distributed:
            import torch.distributed as dist

            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
