"""Evaluation CLI (port of ``tools/test.py``).

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
randsteps ensemble's mean variance and predictive entropy.

A depth preset (``task="depth"``) is scored over the test split of its
nyu, kitti, sunrgbd or cityscapes tree (or the synthetic data) image by
image, whole, with the rollout noise of image i seeded by (``--seed``, i),
on the Eigen crop (nyu, sunrgbd) or the Garg crop (kitti, cityscapes), and
the nine depth metrics are printed on one line; ``--uncertainty`` also
prints the mean across-hypothesis standard deviation and the mean width of
the 80 % interval (10th to 90th percentile), in metres. Runs on the card
unless ``--device cpu``. A BEV preset is refused, as the JAX tool has no BEV
branch: ``evaluation/convergence.py: eval_bev`` scores a BEV model,
``eval_bev_fusion`` a camera + lidar one; so is a ControlNet preset
(``tools/control_demo.py`` samples one, ``eval_controlnet`` scores one).
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
    if cfg.model.task in ("bev", "bev_fusion"):
        scorer = "eval_bev" if cfg.model.task == "bev" else "eval_bev_fusion"
        raise SystemExit(f"task {cfg.model.task!r} has no test CLI (the JAX tools/test.py "
                         f"has no BEV branch); evaluation/convergence.py: {scorer} scores a "
                         "BEV model")
    if cfg.model.task == "controlnet":
        raise SystemExit("task 'controlnet' has no test CLI (the JAX tools/test.py has no "
                         "ControlNet branch); tools/control_demo.py samples a ControlLDM, "
                         "evaluation/convergence.py: eval_controlnet scores one")
    if cfg.model.task not in ("seg", "depth"):
        raise SystemExit(f"unknown task {cfg.model.task!r}")
    rt = cfg.runtime
    if cfg.model.task == "depth" and rt.test_mode != "whole":
        raise SystemExit("a depther is evaluated on whole images (runtime.test_mode=whole)")
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
    if cfg.model.task == "depth":
        return eval_depth_cli(args, cfg, model, device)

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


def eval_depth_cli(args, cfg, model, device) -> int:
    """The depth branch (``tools/test.py:55-66,101-145``)."""
    from ..data.depth_datasets import DepthDataset, SyntheticDepthDataset, eval_mask
    from ..data.pipelines import normalize
    from ..evaluation.convergence import rollout_generator
    from ..evaluation.metrics import depth_metrics

    if cfg.data.dataset == "synthetic":
        ds = SyntheticDepthDataset(cfg.data.crop_size, max_depth=cfg.model.max_depth)
    else:
        ds = DepthDataset(cfg.data.data_root, "test", cfg.data.dataset)
    n = min(len(ds), args.limit or len(ds))
    preds, gts, masks, unc_std, unc_width = [], [], [], [], []
    for i in range(n):
        s = normalize(ds.load(i), cfg.data.mean, cfg.data.std)
        img = torch.from_numpy(np.ascontiguousarray(s["image"][None])).to(device)
        gen = rollout_generator(args.seed, i, device)
        if args.uncertainty:
            d, unc = model.sample_with_uncertainty(img, generator=gen)
            unc_std.append(unc["std"].mean().item())
            unc_width.append((unc["interval_high"] - unc["interval_low"]).mean().item())
        else:
            d = model.sample(img, generator=gen)
        preds.append(d[0].cpu().numpy())
        gts.append(s["label"])
        masks.append(eval_mask(cfg.data.dataset, s["label"].shape))
    m = depth_metrics(np.stack(preds), np.stack(gts), np.stack(masks))
    print(" | ".join(f"{k} {v:.4f}" for k, v in m.items()) + f"  (n={n})", flush=True)
    if args.uncertainty:
        print(f"mean hypothesis std {np.mean(unc_std):.4f} m | "
              f"mean 80% interval width {np.mean(unc_width):.4f} m")
        if cfg.model.diffusion.randsteps == 1:
            print("  (randsteps=1: hypothesis std is trivially 0 — use "
                  "--set model.diffusion.randsteps=5)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
