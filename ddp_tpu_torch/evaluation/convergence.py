"""The end check of training: the segmentation, depth, BEV camera and BEV
fusion parts of the JAX package's convergence harness
(``tools/run_convergence.py:43-46,102-340,589-720``).

A preset is trained through the real ``train()`` on its synthetic data
(from scratch, or for ``converge_seg_aligned_msda`` fine-tuned from
``converge_seg_msda``'s latest checkpoint, as
``tools/run_convergence.py:651-657`` does), then scored on the T-step DDIM
rollout at T = 1, 3 and 10 over 32 held-out synthetic images (indices from
100,000; training draws from [0, 256)), in batches of 8, averaged over 3
seeds of the rollout noise: a segmentor by ``eval_seg`` (mIoU), a depther by
``eval_depth`` (abs_rel, rmse and a1), a BEV camera model by ``eval_bev``
(map mIoU over 32 held-out synthetic scenes of its rig), a camera + lidar
model by ``eval_bev_fusion`` (the same over its fusion rig, at T = 1 and 3
only, as the JAX harness). The result is written to
``<workdir>/result.json`` in the JAX harness's format::

    python -m ddp_tpu_torch.evaluation.convergence converge_seg_window
    python -m ddp_tpu_torch.evaluation.convergence converge_depth
    python -m ddp_tpu_torch.evaluation.convergence converge_bev
    python -m ddp_tpu_torch.evaluation.convergence converge_bev_fusion

The JAX package's results are ``work_dirs/converge_seg_window``,
``work_dirs/converge_seg_msda``, ``work_dirs/converge_seg_aligned_msda``,
``work_dirs/converge_depth``, ``work_dirs/converge_bev`` and
``work_dirs/converge_bev_fusion`` (``result.json``); the port's presets
write under ``work_dirs/torch_*``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import build_model, get_config
from ..data import make_train_iter
from ..data.bev_datasets import (BEV_BATCH_KEYS, FUSION_BATCH_KEYS, SyntheticBEVDataset,
                                 SyntheticFusionDataset)
from ..data.depth_datasets import SyntheticDepthDataset
from ..data.pipelines import normalize
from ..data.seg_datasets import SyntheticSegDataset
from ..train.checkpoint import read_model
from ..train.loop import stack_batches, train
from ..train.step import tree_map
from .metrics import SegMetricAccumulator, bev_map_iou, depth_metrics

N_EVAL = 32
EVAL_BATCH = 8
SEEDS = (0, 1, 2)
# a fine-tune's preset -> the preset whose latest checkpoint it starts from
FINE_TUNE_FROM = {"converge_seg_aligned_msda": "converge_seg_msda"}
HELDOUT_BASE = 100_000  # synthetic datasets are seeded by index; training uses [0, length)
MEAN = (123.675, 116.28, 103.53)
STD = (58.395, 57.12, 57.375)


def heldout_batches(num_classes: int) -> List[Tuple[np.ndarray, np.ndarray]]:
    """The held-out (images [8, 64, 64, 3] normalised, labels [8, 64, 64])
    batches, in order."""
    return _heldout(SyntheticSegDataset(num_classes, (64, 64)))


def heldout_depth_batches(max_depth: float) -> List[Tuple[np.ndarray, np.ndarray]]:
    """The held-out (images [8, 64, 64, 3] normalised, metric depth
    [8, 64, 64]) batches of the depth end check, in order."""
    return _heldout(SyntheticDepthDataset((64, 64), max_depth=max_depth))


def _heldout(ds) -> List[Tuple[np.ndarray, np.ndarray]]:
    out = []
    for s0 in range(0, N_EVAL, EVAL_BATCH):
        samples = [normalize(ds.load(HELDOUT_BASE + i), MEAN, STD)
                   for i in range(s0, s0 + EVAL_BATCH)]
        out.append((np.stack([s["image"] for s in samples]),
                    np.stack([s["label"] for s in samples])))
    return out


def rollout_generator(seed: int, start: int, device: torch.device) -> torch.Generator:
    """The rollout noise's generator of one (seed, batch start), as the JAX
    harness folds the batch start into the seed's key."""
    mixed = int(np.random.SeedSequence([seed, start]).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(mixed)


def seg_miou(preds: Sequence[np.ndarray], labels: Sequence[np.ndarray],
             num_classes: int) -> float:
    """mIoU of predicted maps against label maps, accumulated image by image."""
    acc = SegMetricAccumulator(num_classes)
    for p, label in zip(preds, labels):
        acc.update(p, label)
    return acc.compute()["mIoU"]


@torch.no_grad()
def eval_seg(model, mc, timesteps_list=(1, 3, 10), seeds=SEEDS) -> Dict[str, float]:
    """Seed-averaged mIoU of the T-step DDIM rollout on the held-out
    synthetic images (the JAX harness's ``eval_seg``): ``mIoU@{T}step`` and
    its standard deviation over the seeds, rounded to 4 places."""
    device = next(model.parameters()).device
    batches = heldout_batches(mc.num_classes)
    out = {}
    for steps in timesteps_list:
        m_t = build_model(_with_timesteps(mc, steps), device=device)
        m_t.load_state_dict(model.state_dict())
        mious = []
        for seed in seeds:
            preds, labels = [], []
            for i, (img, label) in enumerate(batches):
                probs = m_t.sample(torch.from_numpy(img).to(device),
                                   generator=rollout_generator(seed, i * EVAL_BATCH, device))
                preds.extend(probs.argmax(-1).cpu().numpy())
                labels.extend(label)
            mious.append(seg_miou(preds, labels, mc.num_classes))
        out[f"mIoU@{steps}step"] = round(float(np.mean(mious)), 4)
        out[f"mIoU@{steps}step_std"] = round(float(np.std(mious)), 4)
        print(f"  seg {steps}-step: mIoU {out[f'mIoU@{steps}step']:.4f} "
              f"± {out[f'mIoU@{steps}step_std']:.4f}", flush=True)
    return out


def _with_timesteps(mc, steps: int):
    return dataclasses.replace(mc, diffusion=dataclasses.replace(mc.diffusion, timesteps=steps))


@torch.no_grad()
def eval_depth(model, mc, timesteps_list=(1, 3, 10), seeds=SEEDS) -> Dict[str, float]:
    """Seed-averaged depth metrics of the T-step DDIM rollout on the held-out
    synthetic images (the JAX harness's ``eval_depth``, every pixel scored):
    ``abs_rel@{T}step``, ``rmse@{T}step`` with their standard deviations over
    the seeds, and ``a1@{T}step``, rounded to 4 places."""
    device = next(model.parameters()).device
    batches = heldout_depth_batches(mc.max_depth)
    out = {}
    for steps in timesteps_list:
        m_t = build_model(_with_timesteps(mc, steps), device=device)
        m_t.load_state_dict(model.state_dict())
        rels, rmses, a1s = [], [], []
        for seed in seeds:
            preds = [m_t.sample(torch.from_numpy(img).to(device),
                                generator=rollout_generator(seed, i * EVAL_BATCH, device))
                     .cpu().numpy() for i, (img, _) in enumerate(batches)]
            m = depth_metrics(np.concatenate(preds), np.concatenate([d for _, d in batches]))
            rels.append(m["abs_rel"])
            rmses.append(m["rmse"])
            a1s.append(m["a1"])
        for key, vals in (("abs_rel", rels), ("rmse", rmses)):
            out[f"{key}@{steps}step"] = round(float(np.mean(vals)), 4)
            out[f"{key}@{steps}step_std"] = round(float(np.std(vals)), 4)
        out[f"a1@{steps}step"] = round(float(np.mean(a1s)), 4)
        print(f"  depth {steps}-step: abs_rel {out[f'abs_rel@{steps}step']:.4f} "
              f"± {out[f'abs_rel@{steps}step_std']:.4f} rmse {out[f'rmse@{steps}step']:.4f} "
              f"a1 {out[f'a1@{steps}step']:.4f}", flush=True)
    return out


def heldout_bev_batches(mc) -> List[Dict[str, np.ndarray]]:
    """The held-out batches of the BEV end check, in order: 8 scenes each of
    the model's synthetic rig (``BEV_BATCH_KEYS``, images normalised, no
    aug)."""
    ds = SyntheticBEVDataset(num_cams=mc.bev_num_cams, image_size=mc.bev_image_size,
                             out_grid=mc.bev_out_grid, num_classes=mc.num_classes,
                             scope=mc.bev_xbound[1])
    mean, std = np.asarray(MEAN, np.float32), np.asarray(STD, np.float32)
    out = []
    for s0 in range(0, N_EVAL, EVAL_BATCH):
        samples = [ds.load(HELDOUT_BASE + i) for i in range(s0, s0 + EVAL_BATCH)]
        for smp in samples:
            smp["image"] = (smp["image"] - mean) / std
        out.append({k: np.stack([smp[k] for smp in samples]) for k in BEV_BATCH_KEYS})
    return out


def heldout_fusion_batches(mc) -> List[Dict]:
    """The held-out batches of the BEV fusion end check, in order: 8 scenes
    each of the model's synthetic fusion rig (``FUSION_BATCH_KEYS``, images
    normalised, the lidar pattern of each index's own seed, no aug)."""
    ds = SyntheticFusionDataset(sparse_shape=mc.bev_sparse_shape, caps=mc.bev_voxel_caps,
                                voxel_size=mc.bev_voxel_size, num_cams=mc.bev_num_cams,
                                image_size=mc.bev_image_size, out_grid=mc.bev_out_grid,
                                num_classes=mc.num_classes, scope=mc.bev_xbound[1])
    mean, std = np.asarray(MEAN, np.float32), np.asarray(STD, np.float32)
    out = []
    for s0 in range(0, N_EVAL, EVAL_BATCH):
        samples = [ds.load(HELDOUT_BASE + i) for i in range(s0, s0 + EVAL_BATCH)]
        for smp in samples:
            smp["image"] = (smp["image"] - mean) / std
        out.append({k: stack_batches([smp[k] for smp in samples]) for k in FUSION_BATCH_KEYS})
    return out


def _eval_map(model, mc, batches, arg_keys, timesteps_list, seeds, what: str
              ) -> Dict[str, float]:
    device = next(model.parameters()).device
    out = {}
    for steps in timesteps_list:
        m_t = build_model(_with_timesteps(mc, steps), device=device)
        m_t.load_state_dict(model.state_dict())
        mious = []
        for seed in seeds:
            scores = [m_t.sample(*(tree_map(lambda x: torch.as_tensor(x).to(device), b[k])
                                   for k in arg_keys),
                                 generator=rollout_generator(seed, i * EVAL_BATCH, device))
                      .cpu().numpy() for i, b in enumerate(batches)]
            m = bev_map_iou(np.concatenate(scores).transpose(0, 3, 1, 2),
                            np.concatenate([np.asarray(b["label"]) for b in batches]
                                           ).transpose(0, 3, 1, 2))
            mious.append(m["mIoU"])
        out[f"map_mIoU@{steps}step"] = round(float(np.mean(mious)), 4)
        out[f"map_mIoU@{steps}step_std"] = round(float(np.std(mious)), 4)
        if steps == timesteps_list[-1]:
            out.update({k: v for k, v in m.items() if k.startswith("iou_")})
        print(f"  {what} {steps}-step: map mIoU {out[f'map_mIoU@{steps}step']:.4f} "
              f"± {out[f'map_mIoU@{steps}step_std']:.4f}", flush=True)
    return out


@torch.no_grad()
def eval_bev(model, mc, timesteps_list=(1, 3, 10), seeds=SEEDS) -> Dict[str, float]:
    """Seed-averaged BEV map IoU (``bev_map_iou``: the best threshold per
    class, mean over classes) of the T-step DDIM rollout with randsteps
    ensembling on the held-out synthetic scenes (the JAX harness's
    ``eval_bev``): ``map_mIoU@{T}step`` and its standard deviation over the
    seeds, rounded to 4 places, and the last horizon's last seed's
    ``iou_class{k}``."""
    return _eval_map(model, mc, heldout_bev_batches(mc), BEV_BATCH_KEYS[:-1], timesteps_list,
                     seeds, "bev")


@torch.no_grad()
def eval_bev_fusion(model, mc, timesteps_list=(1, 3), seeds=SEEDS) -> Dict[str, float]:
    """``eval_bev`` for a camera + lidar model, on the held-out synthetic
    fusion scenes (``heldout_fusion_batches``), at 1 and 3 DDIM steps (the
    JAX harness's ``eval_bev_fusion``, ``tools/run_convergence.py:264-340``)."""
    return _eval_map(model, mc, heldout_fusion_batches(mc), FUSION_BATCH_KEYS[:-1],
                     timesteps_list, seeds, "bev_fusion")


SCORERS = {"seg": eval_seg, "depth": eval_depth, "bev": eval_bev,
           "bev_fusion": eval_bev_fusion}


def run(preset: str = "converge_seg_window", iters: Optional[int] = None,
        device=None) -> Dict:
    """Train ``preset`` through ``train()`` (stale checkpoints cleared, an old
    train log kept as ``.prev``), from scratch or, for a preset of
    ``FINE_TUNE_FROM``, from its base's latest checkpoint (refused when there
    is none), score it with ``eval_seg`` (a depth preset: ``eval_depth``, a
    BEV preset: ``eval_bev``, a fusion preset: ``eval_bev_fusion``) and write
    ``<workdir>/result.json``. ``iters``
    cuts the run (and its lr schedule) to that many steps."""
    cfg = get_config(preset)
    init_params = None
    if preset in FINE_TUNE_FROM:
        base = FINE_TUNE_FROM[preset]
        try:
            step, init_params = read_model(get_config(base).runtime.workdir)
        except FileNotFoundError as e:
            raise FileNotFoundError(f"{preset} fine-tunes {base}'s checkpoint: run {base} "
                                    f"first ({e})") from None
        print(f"fine-tuning from {base} step {step}", flush=True)
    if iters:
        cfg = dataclasses.replace(
            cfg, runtime=dataclasses.replace(cfg.runtime, total_iters=iters),
            optim=dataclasses.replace(cfg.optim, total_steps=iters))
    workdir = cfg.runtime.workdir
    # a fresh run re-saving a step number would otherwise keep the old weights
    shutil.rmtree(os.path.join(workdir, "ckpts"), ignore_errors=True)
    log = os.path.join(workdir, "train_log.jsonl")
    if os.path.exists(log):
        os.replace(log, log + ".prev")
    os.makedirs(workdir, exist_ok=True)
    print(f"=== {preset} ===", flush=True)
    state = train(cfg, make_train_iter(cfg), device=device, init_params=init_params)
    result = SCORERS[cfg.model.task](state.model, cfg.model)
    result["preset"] = preset
    result["total_iters"] = cfg.runtime.total_iters
    path = os.path.join(workdir, "result.json")
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    print(f"wrote {path}", flush=True)
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Train a preset and score it (end check).")
    ap.add_argument("preset", nargs="?", default="converge_seg_window")
    ap.add_argument("--iters", type=int, help="cut the run to this many steps")
    ap.add_argument("--device", help="default: cuda")
    args = ap.parse_args(argv)
    run(args.preset, args.iters, args.device)


if __name__ == "__main__":
    main()
