"""Evaluation CLI (port of the segmentation part of ``tools/test.py``).

    python -m ddp_tpu_torch.tools.test PRESET [--workdir DIR] [--step N]
        [--limit N] [--seed S] [--seeds N] [--set K=V ...] [--uncertainty]
        [--device cpu]

Restores the model of a checkpoint (``<workdir>/ckpts``, the latest unless
``--step``; without one the seeded random init is scored), runs whole-image
or slide inference (``runtime.test_mode``, ``test_crop``, ``test_stride``;
``evaluation/slide.py``) over the val split of ``data.dataset`` and prints
the aAcc / mIoU / mAcc line of each diffusion seed as the JAX tool prints
it. The rollout noise of image i under seed s comes from a generator seeded
by (s, i). ``--uncertainty`` (whole mode only, as in JAX) also prints the
randsteps ensemble's mean variance and predictive entropy. Runs on the card
unless ``--device cpu``. The depth branch of the JAX tool waits for the depth
slice (ROADMAP.md queue 1).
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="ddp_tpu_torch evaluator")
    p.add_argument("preset")
    p.add_argument("--workdir", default=None, help="checkpoint dir to restore")
    p.add_argument("--step", type=int, default=None)
    p.add_argument("--limit", type=int, default=None, help="max eval images")
    p.add_argument("--seed", type=int, default=0, help="diffusion eval seed")
    p.add_argument("--seeds", type=int, default=1,
                   help="average metrics over N diffusion seeds")
    p.add_argument("--set", nargs="*", default=[], metavar="K=V")
    p.add_argument("--uncertainty", action="store_true",
                   help="also report the randsteps ensemble's variance and entropy")
    p.add_argument("--device", default=None, help="default: cuda")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from ..config import build_model, get_config
    from ..data.pipelines import normalize
    from ..data.seg_datasets import SegDataset, SyntheticSegDataset
    from ..device import resolve_device
    from ..train.checkpoint import read_model
    from ..evaluation.convergence import rollout_generator
    from ..evaluation.metrics import SegMetricAccumulator
    from ..evaluation.slide import slide_inference

    cfg = get_config(args.preset, dict(kv.split("=", 1) for kv in args.set))
    if cfg.model.task != "seg":
        raise SystemExit(f"task {cfg.model.task!r} is not ported yet")
    rt = cfg.runtime
    if args.uncertainty and rt.test_mode == "slide":
        raise SystemExit("--uncertainty supports whole-image mode only "
                         "(slide accumulates logits across crops; "
                         "per-crop hypothesis variance is not merged)")
    device = resolve_device(args.device)
    model = build_model(cfg.model, device=device, seed=rt.seed,
                        input_size=cfg.data.crop_size)
    workdir = args.workdir or rt.workdir
    try:
        step, sd = read_model(workdir, args.step)
    except FileNotFoundError:
        if args.step is not None:
            raise
    else:
        model.load_state_dict(sd)
        print(f"restored step {step} from {workdir}")
    model.eval()

    if cfg.data.dataset == "synthetic":
        ds = SyntheticSegDataset(cfg.model.num_classes, cfg.data.crop_size)
    else:
        ds = SegDataset(cfg.data.data_root, "val", cfg.data.dataset)
    n = min(len(ds), args.limit or len(ds))

    def predict(img, gen):
        def fn(im):
            return model.sample(im, generator=gen)

        if rt.test_mode == "slide":
            return slide_inference(fn, img, cfg.model.num_classes, rt.test_crop,
                                   rt.test_stride)
        return fn(img)

    per_seed = []
    for si in range(args.seeds):
        seed = args.seed + si
        acc = SegMetricAccumulator(cfg.model.num_classes)
        unc_var, unc_ent = [], []
        for i in range(n):
            s = normalize(ds.load(i), cfg.data.mean, cfg.data.std)
            img = torch.from_numpy(np.ascontiguousarray(s["image"][None])).to(device)
            gen = rollout_generator(seed, i, device)
            if args.uncertainty:
                probs, unc = model.sample_with_uncertainty(img, generator=gen)
                unc_var.append(unc["variance"].mean().item())
                unc_ent.append(unc["entropy"].mean().item())
            else:
                probs = predict(img, gen)
            acc.update(probs[0].argmax(-1).cpu().numpy(), s["label"])
            if (i + 1) % 50 == 0:
                print(f"[seed {seed}] eval {i + 1}/{n}", flush=True)
        m = acc.compute()
        per_seed.append(m)
        print(f"[seed {seed}] aAcc {m['aAcc'] * 100:.2f} | mIoU {m['mIoU'] * 100:.2f} | "
              f"mAcc {m['mAcc'] * 100:.2f}  (n={n})", flush=True)
        if args.uncertainty:
            print(f"[seed {seed}] mean ensemble variance {np.mean(unc_var):.3e} | "
                  f"mean predictive entropy {np.mean(unc_ent):.3f} nats")
            if cfg.model.diffusion.randsteps == 1:
                print("  (randsteps=1: ensemble variance is trivially 0 — use "
                      "--set model.diffusion.randsteps=5 for hypothesis disagreement)")
    if args.seeds > 1:
        mious = [m["mIoU"] for m in per_seed]
        print(f"seed-averaged mIoU {np.mean(mious) * 100:.2f} ± {np.std(mious) * 100:.2f} "
              f"over {args.seeds} seeds")
    return 0


if __name__ == "__main__":
    sys.exit(main())
