"""Confusion matrix over a validation set (port of ``tools/confusion_matrix.py``).

    python -m ddp_tpu_torch.tools.confusion_matrix PRESET [--ckpt PUBLISHED.pt]
        [--limit N] [--out cm.npy] [--seed 0] [--set K=V ...] [--device cpu]

Predicts each image of ``data/seg_datasets.py: build_eval_dataset`` (the
rollout noise of image i from a generator seeded by (``--seed``, i)),
counts [ground truth, prediction] pairs over the valid pixels into a K × K
int64 matrix, saves it with ``np.save`` and prints aAcc and mAcc. Runs on
the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="confusion matrix of a segmentor")
    p.add_argument("preset")
    p.add_argument("--ckpt", default=None)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--out", default="confusion_matrix.npy")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--set", nargs="*", default=[], metavar="K=V")
    p.add_argument("--device", default=None, help="default: cuda")
    args = p.parse_args(argv)
    from ..config import get_config
    from ..data.seg_datasets import build_eval_dataset
    from ..device import resolve_device
    from ..evaluation.convergence import rollout_generator
    from . import segmentor

    cfg = get_config(args.preset, dict(kv.split("=", 1) for kv in args.set))
    k = cfg.model.num_classes
    device = resolve_device(args.device)
    model = segmentor(cfg, args.ckpt, device)
    cm = np.zeros((k, k), np.int64)
    for i, sample in enumerate(build_eval_dataset(cfg.data)):
        if args.limit is not None and i >= args.limit:
            break
        x = torch.from_numpy(sample["image"][None]).to(device)
        pred = model.predict(x, generator=rollout_generator(args.seed, i, device))[0]
        gt = sample["label"]
        valid = gt != 255
        idx = gt[valid] * k + pred.cpu().numpy()[valid]
        cm += np.bincount(idx.reshape(-1), minlength=k * k).reshape(k, k)
    np.save(args.out, cm)
    acc = np.diag(cm).sum() / max(cm.sum(), 1)
    per_class = np.diag(cm) / np.maximum(cm.sum(1), 1)
    print(f"saved {args.out}; aAcc {acc:.4f}  mAcc {np.nanmean(per_class):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
