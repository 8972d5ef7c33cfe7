"""Ensemble evaluation (port of ``tools/model_ensemble.py``).

    python -m ddp_tpu_torch.tools.model_ensemble PRESET A.pt B.pt ... [--limit N]
        [--seed 0] [--set K=V ...] [--device cpu]

The preset's segmentor with each published model state in turn: for each
image of ``build_eval_dataset`` the class probabilities of ``sample`` (the
rollout noise of image i and checkpoint j from a generator seeded by
(``--seed``, 997·i + j)) summed over the checkpoints, their argmax scored,
and the aAcc / mIoU / mAcc line printed. (The JAX tool prints
``SegMetricAccumulator.summary()``, which its accumulator does not define.)
Runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import sys

import torch


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="score an ensemble of checkpoints")
    p.add_argument("preset")
    p.add_argument("ckpts", nargs="+")
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--set", nargs="*", default=[], metavar="K=V")
    p.add_argument("--device", default=None, help="default: cuda")
    args = p.parse_args(argv)
    from ..config import get_config
    from ..data.seg_datasets import build_eval_dataset
    from ..device import resolve_device
    from ..evaluation.convergence import rollout_generator
    from ..evaluation.metrics import SegMetricAccumulator
    from . import segmentor

    cfg = get_config(args.preset, dict(kv.split("=", 1) for kv in args.set))
    device = resolve_device(args.device)
    models = [segmentor(cfg, c, device) for c in args.ckpts]
    acc = SegMetricAccumulator(cfg.model.num_classes)
    n = 0
    for i, sample in enumerate(build_eval_dataset(cfg.data)):
        if args.limit is not None and i >= args.limit:
            break
        img = torch.from_numpy(sample["image"][None]).to(device)
        prob = sum(m.sample(img, generator=rollout_generator(args.seed, i * 997 + j, device))
                   for j, m in enumerate(models))
        acc.update(prob[0].argmax(-1).cpu().numpy(), sample["label"])
        n += 1
    m = acc.compute()
    print(f"ensemble of {len(models)}: aAcc {m['aAcc'] * 100:.2f} | mIoU {m['mIoU'] * 100:.2f} | "
          f"mAcc {m['mAcc'] * 100:.2f}  (n={n})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
