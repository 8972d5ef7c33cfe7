"""The end check of training: the segmentation, depth, BEV camera, BEV
fusion and ControlNet parts of the JAX package's convergence harness
(``tools/run_convergence.py:43-46,102-588,589-720``).

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
only, as the JAX harness). ``converge_controlnet`` follows the JAX harness's
ControlNet branch instead (``run_controlnet``): the VAE pretrained and
frozen, 40k steps on batches rendered on the card, then PSNR and MAE of 20
DDIM steps on 8 held-out hints (``eval_controlnet``). The result is written to
``<workdir>/result.json`` in the JAX harness's format::

    python -m ddp_tpu_torch.evaluation.convergence converge_seg_window
    python -m ddp_tpu_torch.evaluation.convergence converge_depth
    python -m ddp_tpu_torch.evaluation.convergence converge_bev
    python -m ddp_tpu_torch.evaluation.convergence converge_bev_fusion
    python -m ddp_tpu_torch.evaluation.convergence converge_controlnet

The JAX package's results are ``work_dirs/converge_seg_window``,
``work_dirs/converge_seg_msda``, ``work_dirs/converge_seg_aligned_msda``,
``work_dirs/converge_depth``, ``work_dirs/converge_bev``,
``work_dirs/converge_bev_fusion`` and ``work_dirs/converge_controlnet``
(``result.json``); the port's presets
write under ``work_dirs/torch_*``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import shutil
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

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


# --- ControlNet (tools/run_convergence.py:342-588) --------------------------------------

@torch.no_grad()
def eval_controlnet(model, mc, workdir: str, steps: int = 20, guidance: float = 1.0,
                    n_grid: int = 8, seed: int = 0) -> Dict:
    """Generation scored against the procedural target: the held-out fill50k
    pairs HELDOUT_BASE + [0, n_grid) through ``sample`` (``steps`` DDIM steps,
    guidance 1.0: the target is determined by hint and prompt, and JAX's
    sweep measured guidance as distortion here, work_dirs/converge_controlnet/
    cfg_sweep.json), images clipped to [-1, 1]; PSNR over the [-1, 1] range
    (peak-to-peak 2) and MAE; a hint | generated | target PNG grid."""
    from ..data.controlnet_data import SyntheticFill50k, tokenize
    from ..tools.control_demo import save_grid

    device = next(model.parameters()).device
    ds = SyntheticFill50k(size=mc.cn_image_size)
    pairs = [ds.load(HELDOUT_BASE + i) for i in range(n_grid)]
    hint = np.stack([p["hint"] for p in pairs])
    ids = np.stack([p["ids"] for p in pairs])
    target = np.stack([p["image"] for p in pairs])
    uncond = np.stack([tokenize("")] * n_grid)
    img = model.eval().sample(
        torch.from_numpy(hint).to(device), torch.from_numpy(ids).to(device),
        torch.from_numpy(uncond).to(device), steps=steps, guidance_scale=guidance,
        generator=torch.Generator(device=device).manual_seed(seed)).cpu().numpy()
    img = np.clip(img, -1.0, 1.0)
    mse = float(np.mean((img - target) ** 2))
    mae = float(np.mean(np.abs(img - target)))
    psnr = float(10.0 * np.log10(4.0 / max(mse, 1e-12)))

    def to_u8(a, lo, hi):
        return np.clip((a - lo) / (hi - lo) * 255.0, 0, 255).astype(np.uint8)

    grid = np.concatenate([np.concatenate(list(to_u8(a, lo, hi)), axis=1)
                           for a, lo, hi in ((hint, 0, 1), (img, -1, 1), (target, -1, 1))])
    png = save_grid(grid[None], os.path.join(workdir, "samples.png"))
    print(f"  controlnet: psnr {psnr:.2f} dB mae {mae:.4f} -> {png}", flush=True)
    return {"psnr_db": round(psnr, 2), "mae": round(mae, 4), "cfg_scale": guidance,
            "ddim_steps": steps, "samples_png": png}


def warmup_cosine_lr(step: int, peak: float, warmup: int, total: int, end: float) -> float:
    """optax.warmup_cosine_decay_schedule(0, peak, warmup, total, end) at ``step``."""
    if step < warmup:
        return peak * step / warmup
    frac = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return end + (peak - end) * 0.5 * (1.0 + math.cos(math.pi * frac))


def pretrain_vae(mc, iters: int = 2500, batch: int = 8, lr: float = 2e-3, seed: int = 0,
                 device=None) -> Tuple[Dict[str, torch.Tensor], float]:
    """Stage 1 of the from-scratch ControlNet check: the VAE that the
    reference takes pretrained from SD, trained here on fill50k images
    (recon MSE + 1e-6 · KL; Adam, global-norm clip 1.0, lr warm-up 50 then
    cosine to lr/1000; step i's ``batch`` pairs drawn by
    ``default_rng((seed, i))`` from the first 1000, as JAX's). Returns
    its state_dict and the latent scale: 1 / std of the sampled latents of 64
    held-out images (ldm's rescale, so that scaled latents are unit-std)."""
    from ..data.controlnet_data import SyntheticFill50k
    from ..device import resolve_device
    from ..nn.autoencoder import AutoencoderKL
    from ..nn.common import init_params_

    dev = resolve_device(device)
    trainer = build_model(mc, device="meta")
    with torch.device(dev):
        vae = AutoencoderKL(embed_dim=trainer.unet_cfg.in_channels, ch=trainer.vae_ch,
                            ch_mult=trainer.vae_ch_mult, num_res_blocks=trainer.vae_nrb)
    init_params_(vae, seed)
    ds = SyntheticFill50k(size=mc.cn_image_size)
    params = list(vae.parameters())
    opt = torch.optim.Adam(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    for i in range(iters):
        idxs = np.random.default_rng((seed, i)).integers(0, len(ds), batch)
        img = torch.from_numpy(np.stack([ds.load(int(j))["image"] for j in idxs])).to(dev)
        x = img.permute(0, 3, 1, 2)
        mean, logvar = vae.encode(x)
        z = mean + torch.exp(0.5 * logvar) * torch.randn(mean.shape, generator=gen, device=dev)
        kl = 0.5 * torch.mean(mean ** 2 + torch.exp(logvar) - 1.0 - logvar)
        loss = torch.mean((vae.decode(z) - x) ** 2) + 1e-6 * kl
        opt.zero_grad(set_to_none=True)
        loss.backward()
        torch.nn.utils.clip_grad_norm_(params, 1.0)
        for group in opt.param_groups:
            group["lr"] = warmup_cosine_lr(i, lr, 50, iters, lr * 1e-3)
        opt.step()
        if i % 100 == 0 or i == iters - 1:
            print(f"  vae pretrain {i}: recon+kl {loss.item():.5f}", flush=True)
    with torch.no_grad():
        probe = np.stack([ds.load(HELDOUT_BASE + 64 + j)["image"] for j in range(64)])
        mean, logvar = vae.encode(torch.from_numpy(probe).to(dev).permute(0, 3, 1, 2))
        z = mean + torch.exp(0.5 * logvar) * torch.randn(
            mean.shape, generator=torch.Generator(device=dev).manual_seed(seed + 2), device=dev)
        scale = float(1.0 / (z.float().std(unbiased=False).item() + 1e-8))
    print(f"  vae latent std {1.0 / scale:.4f} -> scale_factor {scale:.5f}", flush=True)
    return {k: v.detach().clone() for k, v in vae.state_dict().items()}, scale


def train_controlnet_ondevice(cfg, init_params: Mapping[str, torch.Tensor], device=None,
                              seed: int = 0):
    """The ControlNet trainer on batches rendered on the card
    (``device_fill50k_batch``, one batch a step, a chunk's batches drawn
    before its dispatch) through ``ChunkedTrainStep`` (one CUDA-graph replay
    of ``steps_per_dispatch`` steps): the JAX harness's on-device trainer. The
    train_log.jsonl lines of JAX's (step, lr, steps_per_s, grad_norm, loss,
    loss_chunk_mean), a checkpoint and ``scale.json`` at every
    ``ckpt_interval`` crossing and at the end. Returns the TrainState."""
    import time

    from ..data.controlnet_data import device_fill50k_batch
    from ..device import resolve_device
    from ..train.checkpoint import CheckpointManager
    from ..train.loop import batch_keys
    from ..train.optim import make_optimizer
    from ..train.step import TrainState, make_chunked_train_step

    rt = cfg.runtime
    dev = resolve_device(device)
    model = build_model(cfg.model, device=dev, seed=seed)
    model.load_state_dict(init_params)
    optimizer = make_optimizer(cfg.optim, model)
    state = TrainState(model, optimizer, torch.Generator(device=dev).manual_seed(seed))
    data_gen = torch.Generator(device=dev).manual_seed(seed + 1)
    chunk = max(1, rt.steps_per_dispatch)
    chunk_fn = make_chunked_train_step(chunk, mixed_precision=rt.mixed_precision,
                                       batch_keys=batch_keys("controlnet"))
    ckpt = CheckpointManager(rt.workdir, rt.max_keep_ckpts)
    log_path = os.path.join(rt.workdir, "train_log.jsonl")
    b, s = cfg.data.batch_size, cfg.model.cn_image_size

    def save(step_done: int) -> None:
        ckpt.save(step_done, state, meta={"config": cfg, "ondevice_data": True})
        with open(os.path.join(rt.workdir, "scale.json"), "w") as f:
            json.dump({"cn_scale_factor": cfg.model.cn_scale_factor, "step": step_done}, f)

    done = 0
    while done < rt.total_iters:
        n = min(chunk, rt.total_iters - done)
        drawn = [device_fill50k_batch(data_gen, b, s) for _ in range(n)]
        batches = {k: torch.stack([d[i] for d in drawn])
                   for i, k in enumerate(("image", "hint", "ids"))}
        t0 = time.perf_counter()
        logs = chunk_fn(state, batches)
        losses = logs["loss"].cpu().numpy()
        dt = time.perf_counter() - t0
        prev, done = done, done + n
        rec = {"step": done, "lr": optimizer.lr_schedule(done - 1),
               "steps_per_s": round(n / dt, 3), "grad_norm": float(logs["grad_norm"][-1]),
               "loss": float(losses[-1]), "loss_chunk_mean": round(float(losses.mean()), 5)}
        with open(log_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if done // rt.log_interval > prev // rt.log_interval or done == rt.total_iters:
            print(f"  [{done}/{rt.total_iters}] loss {rec['loss_chunk_mean']:.4f} "
                  f"({rec['steps_per_s']:.1f} steps/s)", flush=True)
        if done // rt.ckpt_interval > prev // rt.ckpt_interval or done == rt.total_iters:
            save(done)
    return state


def run_controlnet(cfg, device=None, vae_iters: int = 2500) -> Dict:
    """The ControlNet end check (the JAX harness's controlnet branch): the VAE
    pretrained (``pretrain_vae``) and its latent scale saved in
    ``scale.json``, the model built at that scale with the VAE injected (the
    rest from the preset's seeded init) and trained on the card's procedural
    batches, then scored by ``eval_controlnet``; the scale is reported
    beside the metrics."""
    vae_sd, scale = pretrain_vae(cfg.model, iters=vae_iters, seed=cfg.runtime.seed,
                                 device=device)
    with open(os.path.join(cfg.runtime.workdir, "scale.json"), "w") as f:
        json.dump({"cn_scale_factor": scale}, f)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, cn_scale_factor=scale))
    init = build_model(cfg.model, device="cpu", seed=cfg.runtime.seed).state_dict()
    init.update({f"first_stage_model.{k}": v.cpu() for k, v in vae_sd.items()})
    print("injected the pretrained VAE into first_stage_model", flush=True)
    state = train_controlnet_ondevice(cfg, init, device=device, seed=cfg.runtime.seed)
    result = eval_controlnet(state.model, cfg.model, cfg.runtime.workdir)
    result["cn_scale_factor"] = scale
    return result


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
    if cfg.model.task == "controlnet":
        result = run_controlnet(cfg, device)
    else:
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
