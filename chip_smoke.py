#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``ddp_tpu_torch``).

    python3 chip_smoke.py                  # one CUDA device, from the repo root
    python3 chip_smoke.py --profile OUT    # also write per-kernel device-time
                                           # tables of one sample() call and one
                                           # train step to OUT (and OUT.train)
    python3 chip_smoke.py --phases build,kernels   # a subset (device and
                                           # build always run)
    python3 chip_smoke.py --phases build,converge          # the window end check
    python3 chip_smoke.py --phases build,converge_msda     # the msda end checks
    python3 chip_smoke.py --phases build,converge_depth    # the depth end check
    python3 chip_smoke.py --phases build,converge_bev      # the BEV end check
    python3 chip_smoke.py --phases build,converge_bev_fusion   # the fusion end check
    python3 chip_smoke.py --phases build,converge_controlnet   # the ControlNet end check
    python3 chip_smoke.py --phases build,host_data         # the host's decode and batch times
    python3 chip_smoke.py --phases build,compat_reference,compat_main   # the compat zoo
    python3 chip_smoke.py --phases build,dist,tools,dist_two   # data-parallel and the tools
    python3 chip_smoke.py --phases build,lidar_zoo         # the lidar pieces, decoder_remat

Phases, each printing one JSON line; any failure raises and exits non-zero.
A CLI named below runs as its main(argv) in this process (what
``python -m`` runs, without a new interpreter and CUDA context).
A busy share is the union of the intervals of the kernels and copies that
the card ran in one profiled call over that call's wall time. A profiled
eager call also gives the MSDA op's device ms: the kernels launched in its
ms_deform_attn range and by the backward nodes made there.

  0. device  - needs torch.cuda; prints the card's name and power limit
               (nvidia-smi) on a line of its own. TF32 is switched off for
               matmuls and cuDNN for every phase: the parity checks and the
               timings are float32 unless a phase says bf16.
  1. build   - compiles ddp_tpu_torch/csrc/*.cu with nvcc (sm_90a, one nvcc
               per source, in parallel) and loads the library.
  2. kernels - ptxas's registers and spills of every kernel; each CUDA
               kernel against its plain PyTorch version on the card at the
               main paths' shapes and at edge shapes, with its time (cold L2),
               the plain version's time, one PyTorch call's time where one
               computes the same function, and its bound; the upsample_ce
               forward's and backward's lines also give their tile, grid and
               shared bytes. The table gradient is checked fused
               (squash_dtable: f32/bf16 g and table, with and without alpha,
               random, ragged, contended and region-map labels, and g with a
               row stride) and alone
               (dtable), and timed beside the unfused path it replaced.
  3. reference       - a small sample() through the card and through the CPU.
  4. train_reference - one tiny train step's loss on the card and on the CPU
               (same weights, t, noise and batch; dropout off).
  5. main    - serving: ade20k_swin_t at full width (random weights, seed 0),
               DDPSegmentor.sample on 2x512x512: the encode_map launch count,
               a probability map that agrees with the plain path.
  6. serve   - 4 requests through microbatched_call(model.predict, microbatch=2).
  7. train   - training: ade20k_swin_t at full width and depth, batch 2 of
               512^2, f32, drop path and dropout on (CUDA generator), through
               make_train_step: the kernels' launch counts per step, a finite
               loss, step / forward / backward / optimizer times, img/s and
               peak memory; one step with fixed t and noise and dropout off
               through the kernels and through the plain versions (loss and
               every gradient); then the same step in bf16 (mixed precision).
  8. table_grad - the table gradient's backward at the training path's
               shape, timed and profiled alone, and its autograd node in one
               profiled f32 train step: device time and launches. It calls
               only public functions, so run from an earlier checkout's root
               (the script given by path, e.g. through runpy) it measures
               that checkout's package.
  9. graph   - the train step as one CUDA-graph dispatch
               (make_chunked_train_step) at ade20k_swin_t, 2 x 512^2, f32
               and bf16, from the end of the lr warm-up: the eager step and
               a graphed chunk of 10 steps (timed) and one captured alike
               (10 steps in f32, 4 in bf16) from one state and batch, its
               replay held to the eager steps from the same generator
               state, tensor by tensor, with PyTorch's deterministic
               algorithms on; wall ms per step, img/s, the device
               busy share and the kernels' launches per replayed step (both
               from a profile of one replay), peak memory (and what was
               live before) and capture time;
               after the other phases, a capture that must raise.
 10. loop    - train() on converge_seg_window for 100 iterations, 10 steps
               per dispatch, batches from make_train_iter: the loss halves,
               logs and checkpoints land at the JAX loop's steps, the card
               runs the kernels in the replays of steps 31-50 (profiled),
               and a resume from the step-90 checkpoint continues the run.
 10a. dist   - the data-parallel step at world 1: an NCCL group in this
               process, ade20k_swin_t at 2 x 512^2, f32: the eager step's
               kernel launches with the gradient all-reduce, a 2-step CUDA
               graph with the all-reduce captured held to the eager steps
               without a group (graph's limits), step ms with and without
               the collective (eager, graphed), and what a profile of one
               replay shows of the collective.
 10b. tools  - the model tools on the card at ade20k_swin_t: image_demo on
               a 512^2 PNG, publish_model of 1- and 2-step checkpoints,
               image_demo --ckpt, model_ensemble and confusion_matrix on
               tests/data/ade, get_flops at 512^2, and flip_tta and
               multi_scale_flip_tta of sample() at 512^2 against the plain
               path (the main phase's limits), with encode_map launches; the
               data tools: prepare_nuscenes on tests/data/nuscenes_raw,
               convert_datasets cityscapes on a copy of tests/data/cityscapes,
               browse_dataset smoke, and tools.train smoke --yaml on the card
               and the CPU, each exit 0 with outputs held to the CPU's
               (data_tools_check).
 10c. dist_two - (only when named) two processes of one gloo group on
               cuda:0 train ade20k_swin_t eagerly for 2 steps on a global
               batch of 2, held to two 1-process runs on the whole batch:
               the ranks' logs equal, losses 1e-5 relative (+ 3 x the
               1-process runs' spread), each first-step gradient tensor
               within 1e-3 of its L2 + 3 x two summation orders' distance,
               each parameter tensor after 2 steps within 1e-2 of its
               update (L2); the gloo all-reduce's wall ms; reported, not
               held, a 1-process run without cuDNN against the reference.
 11. msda_main - serving with the msda decoder: ade20k_swin_t_msda at full
               width and depth, its weights seeded random tensors under
               mmseg's names, torch.save'd and loaded onto the card by
               load_mmseg_checkpoint (the report must be empty);
               DDPSegmentor.sample on 2x512x512 against the plain path (the
               main phase's limits), encode_map launches, wall ms, img/s,
               busy share, denoise_step_s; the MSDA op alone at the
               decoder's shape (value [2, 16384, 8, 32], loc [2, 16384, 8, 1,
               4, 2]): forward and forward+backward ms beside grid_sample's,
               and which backward PyTorch's deterministic algorithms accept.
 12. msda_train - training with the msda decoder at 2 x 512^2: one step with
               fixed draws through the kernels and through the plain
               versions, one eager step in f32 and in bf16 (launch counts,
               loss, peak memory), and a graphed chunk of 10 steps (4 held
               to the eager steps as in graph; f32 and bf16).
 13. city_main - serving the Cityscapes ConvNeXt segmentor on one 1024 x
               2048 image: cityscapes_convnext_t with the msda overrides
               (decoder_attn=msda, 8 heads: the released checkpoints' shape),
               its weights seeded random tensors under mmseg's and mmcls's
               names written to a .pth and loaded by load_mmseg_checkpoint
               (the report must be empty), and the preset's own window model;
               each through sample() whole and slide_inference (1024^2 crops,
               stride 768: 3 crops), against the plain path (the main phase's
               limits), with encode_map launches (3 per crop), wall ms,
               img/s, busy share and peak memory. The kernels phase also
               holds every kernel to its plain version at the Cityscapes
               shapes (K = 19) and times it there.
 14. city_train - cityscapes_convnext_t at 4 x 512 x 1024 (the reference's
               per-GPU batch) as msda_train does it: fixed draws through the
               kernels and the plain versions, eager f32 and bf16 steps
               (launches 1/1/2/2), a graphed chunk of 10 steps (4 held to
               the eager steps; f32 and bf16, deterministic algorithms on).
 15. city_data - the entry points on the card: python -m
               ddp_tpu_torch.tools.train smoke on tests/data/cityscapes
               (files through data/image_io.py: read_image), 20 iterations,
               then python -m ddp_tpu_torch.tools.test on its workdir, whole
               and slide; an ADE20K JPEG raises the named ImportError
               without Pillow (its import blocked for the check). The host's
               times at the Cityscapes size are host_data's.
 16. depth_reference - a small depther (converge_depth: nano Swin, 64-d msda
               decoder; its deform head and the upconv head, 2 randsteps) on
               the card and on the CPU from the same weights: the training
               loss with fixed t and noise (1e-5 relative) and sample() from
               the same initial noise (1e-4 m).
 17. depth_main - serving nyu_swin_t at full width and depth (random
               weights, seed 0) on one random 480 x 640 frame (a 120 x 160
               latent grid: 19,200 msda queries, 3 DDIM steps): finite depth
               inside [min_depth, max_depth], no kernel launched, wall ms,
               img/s, busy share (profiled, and the profiled device ms over
               the unprofiled wall ms), peak memory, a sample() of 4 copies
               of the frame; sample_with_uncertainty once at 5 randsteps;
               kitti_swin_t on one 352 x 1216 frame.
 18. depth_train - nyu_swin_t at 2 x 416 x 544 (the reference's per-GPU
               batch), procedural depth maps: the eager step and graphed
               chunks of 1 and 10 steps (4 held), f32 and bf16, held to
               the eager steps as in graph; no kernel launched.
 19. depth_data - the entry points on an NYU-layout tree of full-size PNGs
               (480 x 640 RGB, 16-bit depth in mm, from write_png):
               tools.train converge_depth for 20 iterations at 416 x 544
               crops, batch 16, then tools.test with --uncertainty. The
               host's times are host_data's.
 20. bev_reference - smoke_bev (2 cameras of 32 x 64, nano Swin, 32-d msda
               decoder) on the card and on the CPU from the same weights and
               batch: the loss with fixed t and noise (1e-5 relative) and
               sample()'s scores from the same initial noise (1e-4).
 21. bev_main - serving nuscenes_camera at full width and depth (random
               weights, seed 0) on one scene of the synthetic 6-camera rig
               (6 x 256 x 704, the 128^2 BEV latent, 5 window-decoder layers
               on the 200^2 grid, 3 DDIM steps x 5 randsteps): scores in
               [0, 1], no kernel launched, wall ms, scenes/s, busy share
               (profiled and unprofiled), bev_pool's device ms and share (its
               profiler range), peak memory, sample_with_uncertainty's ms;
               the geometry's displacement and voxel changes when the bf16
               policy casts the rig.
 22. bev_train - nuscenes_camera at the preset's batch of 8 scenes (or the
               largest that fits): bev_pool alone with deterministic
               algorithms off and on; the eager step and a graphed chunk of
               10 steps, f32 and bf16 (ms, scenes/s, busy share, peak
               memory, no kernel launched), graph against eager on 2 scenes
               with deterministic algorithms on; the host's batch of 8 with
               the 3D aug; python -m ddp_tpu_torch.tools.train smoke_bev.
 23. fusion_reference - smoke_fusion (2 cameras of 32 x 64, a 24-channel
               lidar branch) on the card and on the CPU from the same weights
               and batch (rulebooks included): the loss with fixed t and noise
               (1e-5 relative) and sample()'s scores (1e-4); the gather-GEMM
               Function against its plain version on the card at
               nuscenes_fusion's capacities (a dense cloud fills them):
               forward 1e-5, both gradients 1e-4 of their max, with ms; the
               host's voxelize and rulebook ms for that cloud.
 24. fusion_main - serving nuscenes_fusion at full width (the camera model
               of bev_main plus the lidar branch: 12 sparse conv layers on a
               1024 x 1024 x 41 voxel grid at capacities 120,000 / 60,000 /
               30,000 / 15,000 / 15,000, a 128^2 x 256 lidar BEV, the
               ConvFuser) on one scene of the synthetic fusion rig: scores in
               [0, 1], no kernel launched, sample() and
               sample_with_uncertainty() ms, scenes/s, busy share (profiled
               and unprofiled), peak memory, extract_lidar_dense's and
               extract_bev_feat's ms, the host's ms per scene.
 25. fusion_train - nuscenes_fusion at the preset's batch of 8 scenes (f32 at
               the largest that fits, with the peak and error of those that
               do not): f32 and bf16 through the bev_train case (eager, graph
               against eager on 2 scenes with deterministic algorithms on, a
               graphed chunk of 5 steps); the host's batch is fusion_host.
 26. cn_reference - a tiny ControlLDM (converge_controlnet with
               model.cn_size=tiny) on the card and on the CPU from the same
               weights, batch, t and noises: the loss (1e-5 relative) and eps
               (1e-4), and a 3-step DDIM + CFG sample from the same initial
               latent (images 1e-4).
 27. cn_main - serving controlnet_sd15 at full width (SD 1.5 UNet + ControlNet,
               VAE, CLIP-L: 1.43 B parameters, random weights, seed 0):
               ControlLDM.sample at 512^2, 20 DDIM steps, guidance 9, batch 1
               and 4 (f32): s per image, images/s, busy share of a 5-step
               call (profiled and unprofiled), device ms by kernel family and
               SDPA backend, peak memory, no kernel launched;
               tools.control_demo (exit 0, a PNG).
 28. cn_train - controlnet_sd15 at 4 x 512^2 on synthetic fill50k: eager f32
               and bf16 steps (s, forward / backward / optimizer s, img/s,
               peak memory), the frozen parts bitwise unchanged and the
               ControlNet changed, graphed bf16 and f32 chunks (f32 at the
               largest batch that fits, the misses recorded), graph against
               eager at batch 1 with deterministic algorithms on; no kernel
               launched.
 29. compat_reference - the tiny compat models (an EncoderDecoder for each
               of the 14 part-I and 13 part-II registry heads it can drive,
               on a width-8 ResNet-18 or, for SETR-MLA, a nano ViT; the FCN
               -> OCR cascade on a tiny HRNet; the 7 real-time backbones under
               an FCN head; STDCHead on its boundary targets and ICNeck
               alone) on the card and on the CPU from the same weights and
               batch, dropout off: eval logits (1e-4), the train-mode loss
               (1e-5 relative) and EMANet's bases after it (1e-5 of their
               max) in float32, every gradient (1e-4 of its max + 1e-9 of the
               model's largest) in float64, the boundary targets bitwise.
 30. compat_main - the nine published compat configurations at their widths
               (random weights, seed 0, float32): upernet_r50 (ResNetV1c-50,
               UPerHead 512, FCN aux; 150 classes, 512^2),
               deeplabv3plus_r50-d8 (19 classes, 512 x 1024), ocrnet_hr18
               (HRNet-W18, FCN -> OCR 512/256), segformer_mit-b0 (MiT-B0,
               SegformerHead 256; 512^2), dpt_vit-b16 (ViT-B/16 taps 2, 5,
               8, 11, DPTHead seg; 512^2), and on ResNetV1c-50 D8 with the
               FCN aux head at 512 x 1024, 19 classes: encnet_r50-d8
               (EncHead 512, 32 codes, SE loss), ccnet_r50-d8 (CCHead 512,
               2 recurrences) and emanet_r50-d8 (EMAHead 256/512, 64 bases,
               3 stages); fast_scnn (FastSCNN + SepFCNHead 128): predict()
               of one image (ms, img/s, busy share, peak memory) and 3 eager
               train steps at batch 2 with the port's AdamW (step ms, peak
               memory, a finite loss that moves, EncNet's SE loss, EMANet's
               bases moved); 0 launches of the five kernels.
 30b. lidar_zoo - the lidar pieces and decoder_remat: (a) tiny SECOND,
               SECONDFPN, PillarFeatureNet, DLA, VoVNet, DepthLSSTransform and
               SparseEncoder on the card and on the CPU from the same weights
               (eval outputs 1e-4 x max|y| + 1e-6 in float32, each gradient
               1e-4 of its max + 1e-9 of the largest in float64),
               point_pillars_scatter and densify bitwise; (b) at published
               widths (random weights, f32): SparseEncoder -> SECOND ->
               SECONDFPN on the rig's dense sweep at nuscenes_fusion's grid
               and capacities, DepthLSSTransform on 6 cameras with the depth
               canvas of 10 sweeps, PointPillars SECFPN (30,000 pillars of <=
               64 points, a 400^2 canvas), DLA-34 and VoVNet-V2-19-slim on 6 x
               256 x 704: forward and forward + backward ms (median of 3),
               peak GB, 0 launches of the five kernels; (c) decoder_remat on
               ade20k_swin_t_msda at 2 x 512^2, f32: the remat step held to
               the step without as graph is held to eager, the same kernel
               launches (wrappers and a profile), a graphed remat chunk of 2
               held to its eager steps, eager and graphed ms and peak GB with
               and without remat.
 31. fusion_host - (only when named) the host's fusion_batch_iterator
               batch of 8 nuscenes_fusion scenes: the rig's sweeps and dense
               clouds filling every capacity.
 32. host_data - (only when named) the host's times at full size: one
               1024 x 2048 Cityscapes image and label map and one 480 x 640
               NYU frame and depth map decoded by read_png and by Pillow
               (held bitwise to each other), and make_train_iter batches of
               16 crops (cityscapes_convnext_t, converge_depth) with and
               without Pillow.
 33. converge - (only when named) the end check: converge_seg_window's 1500
               iterations through train() and eval_seg's mIoU at 1, 3 and 10
               DDIM steps beside the JAX package's
               work_dirs/converge_seg_window/result.json.
 34. graph_grads - (only when named) where the graphed and the eager step
               part: one ade20k_swin_t step's gradients (fixed draws)
               twice eagerly and once as a CUDA-graph replay, f32 and bf16,
               with PyTorch's deterministic algorithms off and on.
 35. replay_records - (only when named) how often a profile of one
               CUDA-graph replay (ade20k_swin_t_msda, 10 bf16 steps) lacks
               kernel records, with and without the pauses after the
               profile starts and before it stops that every other phase
               takes.
 36. converge_msda - (only when named) the msda end checks:
               converge_seg_msda's 1500 iterations, then
               converge_seg_aligned_msda's 300 from its checkpoint, each
               beside work_dirs/<preset>/result.json of the JAX package.
 37. converge_depth - (only when named) the depth end check: converge_depth's
               1500 iterations through train() and eval_depth's abs_rel,
               rmse and a1 at 1, 3 and 10 DDIM steps beside
               work_dirs/converge_depth/result.json of the JAX package.
 38. converge_bev - (only when named) the BEV end check: converge_bev's 2500
               iterations through train() and eval_bev's map mIoU at 1, 3 and
               10 DDIM steps beside work_dirs/converge_bev/result.json of the
               JAX package.
 39. converge_bev_fusion - (only when named) the fusion end check:
               converge_bev_fusion's 2500 iterations through train() and
               eval_bev_fusion's map mIoU at 1 and 3 DDIM steps beside
               work_dirs/converge_bev_fusion/result.json of the JAX package.
 40. converge_seg_quarter - (only when named) converge_seg_quarter's 1500
               iterations (the CE on the quarter-scale logits) and eval_seg
               beside work_dirs/converge_seg_quarter/result.json.

 41. converge_controlnet - (only when named) the ControlNet end check:
               converge_controlnet through run() (the VAE pretrained and its
               latent scale measured, 40,000 steps on batches rendered on the
               card, PSNR and MAE of 8 held-out hints at 20 DDIM steps and
               guidance 1.0) beside work_dirs/converge_controlnet/result.json;
               on a miss two more starts (runtime.seed 1, 2).

Before the card's line, {"phase_seconds": {...}, "total_s": ...}: host seconds
by phase. The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

BIT_SCALE = 0.01
# the main paths' shapes at ade20k_swin_t, 2 x 512^2: N = 2 x 128 x 128
# decoder tokens, K = 150 classes (151 table rows), C = 256, scale 4
N, K, C = 2 * 128 * 128, 150, 256
CE_SHAPE = (2, 128, 128, K)
SCALE = 4
# by card: HBM bandwidth (bytes/s), float32 peak outside the tensor cores
# (FLOP/s), and the SFU's exponential rate (16 per SM per clock x SMs x boost
# clock), from NVIDIA's data sheets and the CUDA programming guide's
# throughput table (compute capability 9.0); matched against the device name
CARDS = (("H200", 4.8e12, 67e12, 16 * 132 * 1.98e9),
         ("H100 NVL", 3.9e12, 60e12, 16 * 132 * 1.785e9),
         ("H100 PCIe", 2.0e12, 51e12, 16 * 114 * 1.755e9),
         ("H100", 3.35e12, 67e12, 16 * 132 * 1.98e9))


_T0 = time.perf_counter()
_EMITTED = []  # (phase, seconds since the script started) of each emitted line


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)
    _EMITTED.append((obj.get("phase"), time.perf_counter() - _T0))


def phase_seconds() -> dict:
    """Host seconds by phase: the time from the line before each phase's
    lines to its last, summed over its runs of lines (a phase's time ends at
    its last line), and the script's total so far."""
    out, last = {}, 0.0
    for phase, t in _EMITTED:
        key = phase or "other"
        out[key] = out.get(key, 0.0) + t - last
        last = t
    return {"phase_seconds": out, "total_s": time.perf_counter() - _T0}


def card_peaks(name: str):
    for key, bw, f32, sfu in CARDS:
        if key in name:
            return key, bw, f32, sfu
    raise RuntimeError(f"no bandwidth/peak figures for card {name!r}")


def time_ms(fn, reps: int = 30, flush: torch.Tensor = None) -> float:
    """Median device time of ``fn`` by CUDA events, one launch per pair of
    events, after warm-up. ``flush`` (a buffer larger than L2) is rewritten
    before every timed launch, so that each run finds a cold cache as the
    main path does."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def wall_s(fn, reps: int = 5, warmup: int = 1) -> float:
    """Median host time of ``fn`` ending in a device synchronise, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def reset_all_launches() -> None:
    from ddp_tpu_torch.ops import q_sample as Q, upsample_ce as U

    Q.reset_launches()
    U.reset_launches()


def all_launches() -> dict:
    from ddp_tpu_torch.ops import q_sample as Q, upsample_ce as U

    return {**Q.launches, **U.launches}


@contextlib.contextmanager
def plain_kernels():
    """Route the model's kernel calls on CUDA tensors through the plain
    PyTorch versions (comparison runs only)."""
    from ddp_tpu_torch.ops import q_sample as Q, upsample_ce as U

    saved = {(Q, n): getattr(Q, n) for n in ("encode_map_cuda", "q_sample_cuda", "dtable_cuda",
                                             "squash_dtable_cuda")}
    saved.update({(U, n): getattr(U, n) for n in ("upsample_ce_fwd_cuda", "upsample_ce_bwd_cuda")})
    Q.encode_map_cuda, Q.q_sample_cuda = Q.encode_map_plain, Q.q_sample_plain
    Q.dtable_cuda, Q.squash_dtable_cuda = Q.dtable_plain, Q.squash_dtable_plain
    U.upsample_ce_fwd_cuda = U.upsample_ce_fwd_plain
    U.upsample_ce_bwd_cuda = (lambda logits, labels, lse, g, scale, ignore:
                              U.upsample_ce_grad_plain(logits, labels, lse, g[0], scale, ignore))
    try:
        yield
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": name, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
          "tf32": "off (matmul and cudnn) for all phases"})
    return name, smi


def phase_build():
    from ddp_tpu_torch import native
    from ddp_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load_library()
    t1 = time.perf_counter()
    native.load_library()  # the lidar branch's host C++ (g++)
    emit({"phase": "build", "seconds": round(t1 - t0, 3), "library": _build.library_path(),
          "host_ops_seconds": round(time.perf_counter() - t1, 3),
          "host_ops_library": native.library_path()})


# --- kernels ----------------------------------------------------------------

def _gen(seed):
    return torch.Generator().manual_seed(seed)


def kernel_row(card, name, source, replaces, fn, plain_fn, nbytes, flops, exps, err,
               flush, library_fn=None):
    """One row of the kernels line: times (cold L2) and the bound, the larger
    of the bytes over HBM bandwidth and the operations over their peak rate
    (float32 FLOPs, and exponentials on the SFU)."""
    _, bw, f32, sfu = card_peaks(card)
    bytes_ms = nbytes / bw * 1e3
    ops_ms = max(flops / f32, exps / sfu) * 1e3
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": None, "max_abs_err": err,
            "ms": time_ms(fn, flush=flush), "plain_ms": time_ms(plain_fn, flush=flush),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": time_ms(library_fn, flush=flush) if library_fn else None}


def sweep_ms(module, name, values, flush, fn):
    """fn's time with the module constant ``name`` (a grid's blocks per SM)
    set to each of ``values`` in turn, then restored."""
    default, times = getattr(module, name), {}
    try:
        for v in values:
            setattr(module, name, v)
            times[v] = time_ms(fn, flush=flush)
    finally:
        setattr(module, name, default)
    return times


# the Cityscapes paths' shapes (cityscapes_convnext_t): K = 19 classes (20
# table rows), C = 256; serving one 1024 x 2048 image, whole (a 256 x 512
# latent grid) or in 1024^2 slide crops (256 x 256 each); training 4 crops
# of 512 x 1024 (4 x 128 x 256 latents), x4
CITY_K = 19
CITY_SERVE_N = {"slide_crop": 256 * 256, "whole": 256 * 512}
CITY_CE_SHAPE = (4, 128, 256, CITY_K)


def check_encode_map(card, smi, flush, k=K + 1, path_rows=None,
                     edges=((N + 3, C), (1001, C - 6)), sweeps=True, config="ade20k_swin_t"):
    """encode_map against its plain version (f32 and bf16 tables, random
    labels of k table rows) at each path shape {name: rows} and at the edge
    shapes (rows, columns), and timed at each path shape. Returns {name:
    row}."""
    from ddp_tpu_torch.ops import q_sample as Q

    path_rows = path_rows or {"path": N}

    def inputs(rows, cols, dtype):
        g = _gen(0)
        labels = torch.randint(0, k, (rows,), generator=g).cuda()
        return labels, torch.randn(k, cols, generator=g).to(dtype).cuda()

    errs = {}
    for dtype, tol in ((torch.float32, 1e-6 * BIT_SCALE),
                       # one bf16 ulp of |out| < 2^-6: 2^-7 * 2^-7
                       (torch.bfloat16, 2.0 ** -14)):
        # the path shapes, then e.g. a ragged N and a C that is no multiple
        # of the 16-byte vector (the kernel's scalar path)
        for rows, cols in [(n, C) for n in path_rows.values()] + list(edges):
            labels, table = inputs(rows, cols, dtype)
            err = (Q.encode_map_cuda(labels, table, BIT_SCALE).float()
                   - Q.encode_map_plain(labels, table, BIT_SCALE).float()).abs().max().item()
            errs[f"{str(dtype)[6:]}_n{rows}_c{cols}"] = err
            if not err <= tol:
                raise AssertionError(f"encode_map {config} {dtype} N={rows} C={cols}: "
                                     f"err {err} > {tol}")
    rows, line = {}, {"phase": "kernels", "kernel": "encode_map", "config": config,
                      "max_abs_err": errs}
    for name, n in path_rows.items():
        labels, table = inputs(n, C, torch.float32)
        tb = table.to(torch.bfloat16)
        rows[name] = kernel_row(
            card, "encode_map", "ddp_tpu_torch/csrc/encode_map.cu",
            "ddp_tpu/ops/pallas/q_sample.py:75",
            lambda: Q.encode_map_cuda(labels, table, BIT_SCALE),
            lambda: Q.encode_map_plain(labels, table, BIT_SCALE),
            nbytes=n * 8 + k * C * 4 + n * C * 4,  # labels, table read once, out written once
            flops=n * C * 6, exps=n * C, err=errs[f"float32_n{n}_c{C}"], flush=flush)
        rows[name]["shape"] = [n, k, C]
        rows[name]["bf16_ms"] = time_ms(lambda: Q.encode_map_cuda(labels, tb, BIT_SCALE),
                                        flush=flush)
    if sweeps:
        labels, table = inputs(N, C, torch.float32)
        line.update({
            # a plain write of the same bytes: what this card's stores reach
            "fill_same_bytes_ms": time_ms(lambda: torch.empty(N, C, device="cuda").fill_(1.0),
                                          flush=flush),
            "ms_by_blocks_per_sm": sweep_ms(Q, "ENCODE_BLOCKS_PER_SM", (2, 4, 8, 16), flush,
                                            lambda: Q.encode_map_cuda(labels, table,
                                                                      BIT_SCALE))})
    emit({**line, "tolerance": "f32 1e-6 x bit_scale; bf16 one ulp of |out| (2^-14)",
          "library_ms": "null: no single PyTorch call computes gather+squash",
          "rows": rows, "card": smi})
    return rows


def _qs_inputs(n, c, dtype, seed=0, k=K + 1, labels=None):
    """q_sample's inputs on the card: random labels of k table rows unless
    ``labels`` (n of them) are given."""
    g = _gen(seed)
    rand = torch.randint(0, k, (n,), generator=g)
    labels = rand.cuda() if labels is None else labels
    table = torch.randn(k, c, generator=g).to(dtype).cuda()
    alpha, sigma = torch.rand(n, generator=g).cuda(), torch.rand(n, generator=g).cuda()
    noise = torch.randn(n, c, generator=g).to(dtype).cuda()
    return labels, table, alpha, sigma, noise


def check_q_sample(card, smi, flush, n=N, k=K + 1, labels=None,
                   edges=((N + 3, C), (N + 3, 250)), config="ade20k_swin_t"):
    """q_sample against its plain version (f32 and bf16) at the path shape
    (n rows of C, k table rows, ``labels`` or random ones) and the edge
    shapes, timed at the path shape."""
    from ddp_tpu_torch.ops import q_sample as Q

    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for rows, c in ((n, C), *edges):
            args = _qs_inputs(rows, c, dtype, k=k, labels=labels if rows == n else None)
            got = Q.q_sample_cuda(args[0], args[1], BIT_SCALE, *args[2:]).float()
            want = Q.q_sample_plain(args[0], args[1], BIT_SCALE, *args[2:]).float()
            err = (got - want).abs().max().item()
            errs[f"{str(dtype)[6:]}_n{rows}_c{c}"] = err
            # f32: the same roundings in both (no FMA contraction), so only
            # expf's last ulp differs, times bit_scale; bf16: one ulp of the
            # rounded result
            tol = 1e-6 if dtype == torch.float32 else \
                (2.0 ** -8 * want.abs().max()).item()
            if not err <= tol:
                raise AssertionError(f"q_sample {config} {dtype} N={rows} C={c}: "
                                     f"err {err} > {tol}")
    lab, table, alpha, sigma, noise = _qs_inputs(n, C, torch.float32, k=k, labels=labels)
    row = kernel_row(
        card, "q_sample", "ddp_tpu_torch/csrc/q_sample.cu",
        "ddp_tpu/ops/pallas/q_sample.py:83",
        lambda: Q.q_sample_cuda(lab, table, BIT_SCALE, alpha, sigma, noise),
        lambda: Q.q_sample_plain(lab, table, BIT_SCALE, alpha, sigma, noise),
        # labels, alpha, sigma, table and noise read once; out written once
        nbytes=n * (8 + 4 + 4) + k * C * 4 + 2 * n * C * 4,
        flops=n * C * 9, exps=n * C, err=errs[f"float32_n{n}_c{C}"], flush=flush)
    tb, nb = table.to(torch.bfloat16), noise.to(torch.bfloat16)
    row["shape"] = [n, k, C]
    row["bf16_ms"] = time_ms(lambda: Q.q_sample_cuda(lab, tb, BIT_SCALE, alpha, sigma, nb),
                             flush=flush)
    emit({"phase": "kernels", "kernel": "q_sample", "config": config, "max_abs_err": errs,
          "labels": "random" if labels is None else "region map of the train batch",
          "tolerance": "f32 1e-6 absolute; bf16 2^-8 x max|out| (one bf16 ulp)",
          "library_ms": "null: no single PyTorch call computes gather+squash+corrupt",
          "row": row, "card": smi})
    return row


def region_labels(cfg, b: int = 2):
    """The training path's labels: train_batch's ground truth, nearest-
    downsampled to the 1/4-scale grid with 255 mapped to K, flattened, as
    corrupt_fused sees them."""
    from ddp_tpu_torch.ops.resize import resize_nearest

    gt = train_batch(cfg, b)["label"]
    h, w = gt.shape[1] // 4, gt.shape[2] // 4
    down = resize_nearest(gt[..., None], (h, w))[..., 0]
    return torch.where(down == 255, cfg.model.num_classes, down).reshape(-1).contiguous()


def _dtable_inputs(case, n, c, g_dtype, table_dtype, region, seed=1, k=K + 1):
    """labels (random, or 70 % of the rows in one class, or the region map),
    g (for "strided" the second half of the columns of a [n, 2c] tensor, as
    the training path's g is a slice of the fusion conv's input gradient),
    alpha and the table of k rows, on the card."""
    g = _gen(seed)
    labels = torch.randint(0, k, (n,), generator=g)
    if case == "contended":
        labels[torch.rand(n, generator=g) < 0.7] = 3
    elif case == "region":
        labels = region.cpu()
    if case == "strided":
        grad = torch.randn(n, 2 * c, generator=g).to(g_dtype).cuda()[:, c:]
    else:
        grad = torch.randn(n, c, generator=g).to(g_dtype)
    alpha = torch.rand(n, generator=g)
    table = torch.randn(k, c, generator=g).to(table_dtype)
    return labels.cuda(), grad.cuda(), alpha.cuda(), table.cuda()


def _dtable_close(got, want):
    # atomics add in no fixed order: relative 1e-5 of each sum, plus 1e-5 of
    # the largest for sums that cancel to near 0
    return bool(((got - want).abs() <= 1e-5 * want.abs() + 1e-5 * want.abs().max()).all())


def check_dtable(card, smi, flush, config="ade20k_swin_t", b=2, cases=None, row_case="random",
                 extras=True):
    """The table gradient: squash_dtable (the main path's fused kernel) and
    dtable (the same kernel without the squash's derivative, the Pallas
    _dtable_kernel's counterpart) against their plain versions at each case
    {name: (rows, columns, table rows)} (the path's n rows of C, its region
    map from ``config``'s train batch of b images, K + 1 table rows), timed
    at ``row_case`` with index_add_ beside it. With ``extras``, also the
    unfused path it replaced (the plain glue that forms demb, then dtable),
    the fused kernel on region labels and bf16 g, and its grid sized for 1
    to 4 blocks per SM."""
    from ddp_tpu_torch.config import get_config
    from ddp_tpu_torch.ops import q_sample as Q

    cfg = get_config(config)
    k = cfg.model.num_classes + 1
    region = region_labels(cfg, b)
    n = region.numel()
    cases = cases or {"random": (n, C, k), "region": (n, C, k)}
    errs, fused_errs = {}, {}
    for case, (rows, c, kk) in cases.items():
        labels, grad, _, _ = _dtable_inputs(case, rows, c, torch.float32, torch.float32, region,
                                            k=kk)
        grad = grad.contiguous()  # dtable takes a contiguous demb
        got, want = Q.dtable_cuda(labels, grad, kk), Q.dtable_plain(labels, grad, kk)
        errs[f"{case}_n{rows}_c{c}"] = (got - want).abs().max().item()
        if not _dtable_close(got, want):
            raise AssertionError(f"dtable {config} {case}: max abs err "
                                 f"{errs[f'{case}_n{rows}_c{c}']}")
        for g_dtype in (torch.float32, torch.bfloat16):
            for t_dtype in (torch.float32, torch.bfloat16):
                labels, grad, alpha, table = _dtable_inputs(case, rows, c, g_dtype, t_dtype,
                                                            region, k=kk)
                for a in (alpha, None):
                    got = Q.squash_dtable_cuda(labels, grad, a, table, BIT_SCALE)
                    want = Q.squash_dtable_plain(labels, grad, a, table, BIT_SCALE)
                    name = (f"{case}_n{rows}_c{c}_g{str(g_dtype)[6:]}_table{str(t_dtype)[6:]}"
                            f"_{'alpha' if a is not None else 'noalpha'}")
                    fused_errs[name] = (got - want).abs().max().item()
                    if not _dtable_close(got, want):
                        raise AssertionError(f"squash_dtable {config} {name}: max abs err "
                                             f"{fused_errs[name]}")

    def inputs(case, g_dtype):
        return _dtable_inputs(case, n, C, g_dtype, torch.float32, region, k=k)

    labels, grad, alpha, table = inputs(row_case, torch.float32)
    demb = Q._squash_grad(labels, table, BIT_SCALE, grad * alpha[:, None])
    zeros = torch.zeros(k, C, device="cuda")
    row = kernel_row(
        card, "dtable", "ddp_tpu_torch/csrc/q_sample.cu",
        "ddp_tpu/ops/pallas/q_sample.py:93",
        lambda: Q.squash_dtable_cuda(labels, grad, alpha, table, BIT_SCALE),
        lambda: Q.squash_dtable_plain(labels, grad, alpha, table, BIT_SCALE),
        # labels, g, alpha and the table read once, the table's gradient
        # written once; per element of g a multiply-add, per table entry the
        # derivative (an exponential and ~5 FLOPs)
        nbytes=n * 8 + n * C * 4 + n * 4 + 2 * k * C * 4, flops=n * C * 2 + k * C * 5,
        exps=k * C, err=fused_errs[f"{row_case}_n{n}_c{C}_gfloat32_tablefloat32_alpha"],
        flush=flush, library_fn=lambda: zeros.index_add_(0, labels, demb))
    lb, gb, ab, tb = inputs(row_case, torch.bfloat16)
    row["shape"] = [n, k, C]
    row["bf16_ms"] = time_ms(lambda: Q.squash_dtable_cuda(lb, gb, ab, tb, BIT_SCALE),
                             flush=flush)
    line = {"phase": "kernels", "kernel": "dtable", "config": config,
            "max_abs_err": {"dtable": errs, "squash_dtable": fused_errs},
            "tolerance": "|d| <= 1e-5 |want| + 1e-5 max|want| (atomic order)",
            "row_is": f"squash_dtable, f32 g and table, alpha, {row_case} labels; bf16_ms: "
                      "bf16 g, f32 table",
            "library_ms": "torch.zeros(K, C).index_add_(0, labels, demb), demb and zeros "
                          "preallocated"}
    if extras:
        line["times"] = {
            # the parent's path: the plain glue (sigmoid of the table, gather
            # by label, the elementwise products) then the dtable kernel; and
            # the same glue with index_add_
            "unfused_glue_plus_dtable_ms": time_ms(lambda: Q.dtable_cuda(
                labels, Q._squash_grad(labels, table, BIT_SCALE, grad * alpha[:, None]), k),
                flush=flush),
            "unfused_glue_plus_index_add_ms": time_ms(
                lambda: torch.zeros(k, C, device="cuda").index_add_(0, labels, Q._squash_grad(
                    labels, table, BIT_SCALE, grad * alpha[:, None])), flush=flush),
            "dtable_alone_ms": time_ms(lambda: Q.dtable_cuda(labels, demb, k), flush=flush),
        }
        for case in ("random", "region"):
            for g_dtype in (torch.float32, torch.bfloat16):
                lab, gr, al, tab = inputs(case, g_dtype)
                line["times"][f"fused_{case}_g{str(g_dtype)[6:]}_ms"] = time_ms(
                    lambda: Q.squash_dtable_cuda(lab, gr, al, tab, BIT_SCALE), flush=flush)
        line["ms_by_blocks_per_sm"] = sweep_ms(
            Q, "DTABLE_BLOCKS_PER_SM", (1, 2, 3, 4), flush,
            lambda: Q.squash_dtable_cuda(labels, grad, alpha, table, BIT_SCALE))
        line["geometry"] = Q.dtable_geometry(
            n, C, k, torch.cuda.get_device_properties(0).multi_processor_count)._asdict()
    emit(dict(line, row=row, card=smi))
    return row


def _ce_inputs(b, h, w, k, scale, dtype, seed=2, labels="random"):
    """labels: "random" with a block of ignored pixels, "ignored" (every
    pixel 255), "one" (every pixel class k // 2), "outside" (random, with
    rows of valid labels k + 3 and columns of -4, and the logits shifted by
    +3 so that every pixel's max z is positive: then the kernel's correct
    rule for such a label, 0 >= max z, and the plain version's argmax rule
    both count none), or a [b, scale h, scale w] tensor of given labels."""
    g = _gen(seed)
    logits = torch.randn(b, h, w, k, generator=g)
    lab = torch.randint(0, k, (b, scale * h, scale * w), generator=g)
    lab[0, :scale * 3, :scale * 5] = 255  # a block of ignored pixels
    if isinstance(labels, torch.Tensor):
        lab = labels
    elif labels == "ignored":
        lab.fill_(255)
    elif labels == "one":
        lab.fill_(k // 2)
    elif labels == "outside":
        logits += 3.0
        lab[:, 1::5, :] = k + 3
        lab[:, :, 2::7] = -4
    return logits.to(dtype).cuda(), lab.cuda()
def _ce_cases():
    """(name, logits shape, scale, dtype, labels). The backward's tiles are
    8 x 8 for scales 2..5 and 4 x 4 above, the forward's 8 wide and 16, 8 or
    4 high; the edge cases cross the image's edge with ragged tiles, take
    h = 1 (both row taps clamp to one row), the odd scale 3 whose weights
    are not dyadic, scale 8, a last class chunk of 1, 19 or 22 of 32 lanes,
    and valid labels outside [0, K)."""
    cases = [("path", CE_SHAPE, SCALE, torch.float32, "random"),
             ("path_bf16", CE_SHAPE, SCALE, torch.bfloat16, "random"),
             # converge_seg_window's step: 16 images of 16 x 16 latents, K = 7
             ("converge_b16_h16_s4_k7", (16, 16, 16, 7), 4, torch.float32, "random"),
             ("converge_b16_h16_s4_k7_bf16", (16, 16, 16, 7), 4, torch.bfloat16, "random"),
             ("h10_s2_k7", (2, 10, 16, 7), 2, torch.float32, "random"),
             ("h10_s4_k19", (2, 10, 16, 19), 4, torch.float32, "random"),
             ("h12_s4_k19_bf16", (2, 12, 16, 19), 4, torch.bfloat16, "random")]
    for name, shape, scale, labels in (("b1_h13_w11_s4_k33", (1, 13, 11, 33), 4, "random"),
                                       ("b2_h1_w7_s4_k19", (2, 1, 7, 19), 4, "random"),
                                       ("h9_w14_s3_k150", (2, 9, 14, 150), 3, "random"),
                                       ("h6_w9_s8_k33", (1, 6, 9, 33), 8, "random"),
                                       ("h7_w5_s2_k7_ignored", (2, 7, 5, 7), 2, "ignored"),
                                       ("h9_w10_s4_k19_one", (2, 9, 10, 19), 4, "one"),
                                       ("h9_w14_s4_k150_outside", (2, 9, 14, 150), 4,
                                        "outside")):
        cases.append((name, shape, scale, torch.float32, labels))
        cases.append((name + "_bf16", shape, scale, torch.bfloat16, labels))
    return cases


def _ties(logits, labels, scale, ignore_index=255):
    """Valid pixels whose label's upsampled logit ties the maximum though
    the label is not the first argmax (ROADMAP.md queue 3, the accuracy tie
    rule)."""
    from ddp_tpu_torch.ops import upsample_ce as U

    n = 0
    for _, _, _, z, lab in U._phases(logits, labels, scale):
        valid, in_range, _, z_lab = U._label_terms(z, lab, ignore_index)
        n += (valid & in_range & (z_lab >= z.max(-1).values)
              & (z.argmax(-1) != lab)).sum().item()
    return n




def check_upsample_ce(card, smi, flush, cases=None, path_shape=CE_SHAPE, path_labels="random",
                      config="ade20k_swin_t"):
    """The upsample+CE forward and backward against their plain versions on
    each case (name, logits shape, scale, dtype, labels; by default
    _ce_cases), and timed at ``path_shape`` (f32, and bf16 logits) on
    ``path_labels``. Returns the forward's and the backward's rows."""
    from ddp_tpu_torch.ops import upsample_ce as U

    fwd_errs, bwd_errs = {}, {}
    for case, shape, scale, dtype, lab_mode in cases or _ce_cases():
        logits, labels = _ce_inputs(*shape, scale, dtype, labels=lab_mode)
        sums, lse = U.upsample_ce_fwd_cuda(logits, labels, scale)
        want, want_lse = U.upsample_ce_fwd_plain(logits, labels, scale)
        g = torch.full((1,), 0.5, device="cuda")
        # the backward reads the kernel's lse, the plain version its own
        d = U.upsample_ce_bwd_cuda(logits, labels, lse, g, scale)
        d_want = U.upsample_ce_grad_plain(logits, labels, want_lse, g[0], scale)
        lse_err = (lse - want_lse).abs()
        fwd_errs[case] = {"sums": (sums - want).abs().tolist(), "lse": lse_err.max().item()}
        bwd_errs[case] = (d - d_want).abs().max().item()
        # NLL sum: float atomics add in no fixed order (rtol 1e-5); the counts
        # are exact (integers below 2^24), but for ties: the kernel counts a
        # pixel whose label's logit ties the maximum (the Pallas rule), the
        # plain version only the first argmax (bf16 logits at K = 7 tie)
        if not abs(sums[0].item() - want[0].item()) <= 1e-5 * abs(want[0].item()):
            raise AssertionError(f"upsample_ce fwd {config} {case}: nll {sums[0].item()} vs "
                                 f"{want[0].item()}")
        ties = _ties(logits, labels, scale)
        if sums[1:].tolist() != [want[1].item(), want[2].item() + ties]:
            raise AssertionError(f"upsample_ce fwd {config} {case}: counts "
                                 f"{sums[1:].tolist()} vs {want[1:].tolist()} with {ties} ties")
        fwd_errs[case]["ties"] = ties
        # lse: ex2.approx (~2 ulp) per term against expf, and m log2 e rounded
        if not (lse_err <= 4e-6 * want_lse.abs().clamp(min=1.0)).all():
            raise AssertionError(f"upsample_ce fwd {config} {case}: lse max abs err "
                                 f"{lse_err.max().item()}")
        if not ((d - d_want).abs() <= 1e-4 * d_want.abs() + 1e-6).all():
            raise AssertionError(f"upsample_ce bwd {config} {case}: max abs err "
                                 f"{bwd_errs[case]}")
    logits, labels = _ce_inputs(*path_shape, SCALE, torch.float32, labels=path_labels)
    b, h, w, k = path_shape
    _, lse = U.upsample_ce_fwd_cuda(logits, labels, SCALE)
    g = torch.ones(1, device="cuda")
    out_px = b * SCALE * h * SCALE * w
    elems = out_px * k  # upsampled logits, never written
    lat, lab = logits.numel() * 4, labels.numel() * 8
    rows = [kernel_row(
        card, "upsample_ce_fwd", "ddp_tpu_torch/csrc/upsample_ce.cu",
        "ddp_tpu/ops/pallas/upsample_ce.py:122",
        lambda: U.upsample_ce_fwd_cuda(logits, labels, SCALE),
        lambda: U.upsample_ce_fwd_plain(logits, labels, SCALE),
        # logits and labels read once, three sums and the lse written; per
        # upsampled element a column lerp, max/sum updates and the amortised
        # row lerps (~8 FLOPs) and one exponential
        nbytes=lat + lab + 12 + out_px * 4, flops=elems * 8, exps=elems,
        err=fwd_errs["path"]["lse"], flush=flush),
        kernel_row(
        card, "upsample_ce_bwd", "ddp_tpu_torch/csrc/upsample_ce.cu",
        "ddp_tpu/ops/pallas/upsample_ce.py:173",
        lambda: U.upsample_ce_bwd_cuda(logits, labels, lse, g, SCALE),
        lambda: U.upsample_ce_grad_plain(logits, labels, lse, g[0], SCALE),
        # logits, labels and the forward's log-sum-exp read once, dlogits
        # written once; per upsampled element one exponential and ~10 FLOPs
        nbytes=lat + lab + out_px * 4 + lat, flops=elems * 10, exps=elems,
        err=bwd_errs["path"], flush=flush)]
    fgeo, bgeo = U.fwd_geometry(b, h, w, k, SCALE), U.bwd_geometry(b, h, w, k, SCALE)
    # f32, scale 4: tile, grid, shared bytes, registers, local (spill) bytes
    builds = ({"tile": [fgeo.tile_h, fgeo.tile_w], "class_chunk": fgeo.chunk,
               "grid": list(fgeo.grid), "threads": fgeo.threads,
               "dynamic_shared_bytes": fgeo.smem_bytes,
               **U.kernel_attrs("fwd", SCALE, torch.float32)},
              {"tile": [bgeo.tile_h, bgeo.tile_w], "class_chunk": bgeo.chunk,
               "grid": list(bgeo.grid), "threads": 32 * (bgeo.tile_h + 1),
               "dynamic_shared_bytes": bgeo.smem_bytes,
               **U.kernel_attrs("bwd", SCALE, torch.float32)})
    # the same calls with bf16 logits (the mixed-precision step's)
    lb = logits.to(torch.bfloat16)
    bf16_ms = (time_ms(lambda: U.upsample_ce_fwd_cuda(lb, labels, SCALE), flush=flush),
               time_ms(lambda: U.upsample_ce_bwd_cuda(lb, labels, lse, g, SCALE), flush=flush))
    for row, errs, build, ms in zip(rows, (fwd_errs, bwd_errs), builds, bf16_ms):
        row["shape"] = [*path_shape, SCALE]
        row["bf16_ms"] = ms
        emit({"phase": "kernels", "kernel": row["name"], "config": config,
              "max_abs_err": errs,
              "tolerance": "fwd: nll rtol 1e-5 (atomic order), counts exact, "
                           "lse |d| <= 4e-6 max(1, |lse|); bwd: rtol 1e-4, atol 1e-6",
              "library_ms": "null: no single PyTorch call computes a bilinear upsample "
                            "fused with cross-entropy",
              "row": row, "build": build, "card": smi})
    return rows


def phase_kernels(card: str, smi: str):
    """Every kernel against its plain version and timed, at the ADE20K
    paths' shapes (with the edge cases and the sweeps), then at the
    Cityscapes paths' shapes (K = 19; the training kernels on the region map
    and labels of the Cityscapes train batch); each ADE row carries its
    Cityscapes row under "cityscapes"."""
    from ddp_tpu_torch.config import get_config
    from ddp_tpu_torch.ops import _build

    # registers, spills and static shared bytes of every kernel, as ptxas
    # reported them when the library was built
    emit({"phase": "kernels", "ptxas": _build.resource_usage()})
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    k = K + 1
    rows = [check_encode_map(card, smi, flush)["path"], check_q_sample(card, smi, flush),
            # (rows, columns, table rows); "converge": converge_seg_window's
            # step (16 images of 16 x 16 latents, C = 64, K = 7 classes + the
            # ignore row)
            check_dtable(card, smi, flush, cases={
                "random": (N, C, k), "ragged": (N + 3, 250, k), "contended": (N, C, k),
                "region": (N, C, k), "strided": (N, C, k), "converge": (16 * 16 * 16, 64, 8)}),
            *check_upsample_ce(card, smi, flush)]

    city_cfg = get_config("cityscapes_convnext_t")
    b, h, w, _ = CITY_CE_SHAPE
    region = region_labels(city_cfg, b)
    city = check_encode_map(card, smi, flush, k=CITY_K + 1, path_rows=CITY_SERVE_N, edges=(),
                            sweeps=False, config=city_cfg.name)
    city["q_sample"] = check_q_sample(card, smi, flush, n=region.numel(), k=CITY_K + 1,
                                      labels=region, edges=(), config=city_cfg.name)
    city["dtable"] = check_dtable(card, smi, flush, city_cfg.name, b,
                                  cases={"region": (b * h * w, C, CITY_K + 1)},
                                  row_case="region", extras=False)
    batch_labels = train_batch(city_cfg, b)["label"].cpu()
    city["upsample_ce_fwd"], city["upsample_ce_bwd"] = check_upsample_ce(
        card, smi, flush, config=city_cfg.name, path_shape=CITY_CE_SHAPE,
        path_labels=batch_labels,
        cases=[("path", CITY_CE_SHAPE, SCALE, torch.float32, batch_labels),
               ("path_bf16", CITY_CE_SHAPE, SCALE, torch.bfloat16, batch_labels)])
    fields = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "max_abs_err", "shape",
              "bf16_ms")
    for row in rows:
        if row["name"] == "encode_map":
            row["cityscapes"] = {key: {f: city[key][f] for f in fields} for key in CITY_SERVE_N}
        else:
            row["cityscapes"] = {f: city[row["name"]][f] for f in fields}
    return rows


# --- serving ----------------------------------------------------------------

def compare_probs(a: torch.Tensor, b: torch.Tensor):
    return ((a - b).abs().max().item(),
            (a.argmax(-1) == b.argmax(-1)).float().mean().item())


def check_probs(p: torch.Tensor, shape):
    if tuple(p.shape) != tuple(shape):
        raise AssertionError(f"probabilities shape {tuple(p.shape)} != {tuple(shape)}")
    if not torch.isfinite(p).all():
        raise AssertionError("non-finite probabilities")
    dev = (p.sum(-1) - 1.0).abs().max().item()
    if dev > 1e-4:
        raise AssertionError(f"probabilities do not sum to 1 (max dev {dev})")


def phase_reference():
    """A small input through the card (kernels) and the CPU (plain versions)."""
    from ddp_tpu_torch.config import build_model, get_config

    cfg = get_config("tiny_seg")
    g = _gen(11)
    img = torch.randn(2, 64, 64, 3, generator=g)
    m = cfg.model
    noise = torch.randn(2 * m.diffusion.randsteps, 16, 16, m.embed_dims, generator=g)
    cpu = build_model(m, device="cpu", seed=0).sample(img, init_noise=noise)
    gpu = build_model(m, device="cuda", seed=0).sample(img.cuda(), init_noise=noise.cuda())
    check_probs(gpu, (2, 64, 64, m.num_classes))
    diff, agree = compare_probs(gpu.cpu(), cpu)
    emit({"phase": "reference", "preset": cfg.name, "img": [2, 64, 64, 3],
          "max_abs_prob_diff_vs_cpu": diff, "argmax_agreement_vs_cpu": agree})
    if not (diff <= 1e-4 and agree >= 0.999):
        raise AssertionError(f"card vs CPU: prob diff {diff}, agreement {agree}")


def phase_main(smi: str, profile: str = None):
    from ddp_tpu_torch.config import build_model, get_config

    cfg = get_config("ade20k_swin_t")
    m = cfg.model
    b, (h, w) = 2, cfg.data.crop_size
    model = build_model(m, device="cuda", seed=0)
    g = _gen(1)
    img = torch.randn(b, h, w, 3, generator=g).cuda()
    noise = torch.randn(m.diffusion.randsteps * b, h // 4, w // 4, m.embed_dims,
                        generator=g).cuda()

    reset_all_launches()
    probs = model.sample(img, init_noise=noise)
    torch.cuda.synchronize()
    launches = all_launches()
    want = m.diffusion.timesteps  # randsteps are folded into one batch per step
    if launches["encode_map"] != want:
        raise AssertionError(f"encode_map launched {launches['encode_map']} times, want {want}")
    check_probs(probs, (b, h, w, m.num_classes))

    with plain_kernels():  # the only plain run of the serving path on the card
        plain = model.sample(img, init_noise=noise)
    diff, agree = compare_probs(probs, plain)
    del plain
    if not (diff <= 1e-4 and agree >= 0.999):
        raise AssertionError(f"kernel vs plain path: prob diff {diff}, agreement {agree}")

    sec = wall_s(lambda: model.sample(img, init_noise=noise))
    # the stages of one sample() call, each timed alone: the encoder once,
    # then one of the rollout's denoise steps (it runs diffusion.timesteps)
    with torch.no_grad():
        feat = model.extract_feat(img)
        log_snr = torch.zeros(noise.shape[0], device="cuda")
        encode_s = wall_s(lambda: model.extract_feat(img))
        step_s = wall_s(lambda: model.denoise_logits(
            feat.repeat(m.diffusion.randsteps, 1, 1, 1), noise, log_snr))
    emit({"phase": "main", "preset": cfg.name, "img": [b, h, w, 3],
          "decoder_tokens_per_image": (h // 4) * (w // 4), "launches": launches,
          "max_abs_prob_diff_vs_plain": diff, "argmax_agreement_vs_plain": agree,
          "sample_s": sec, "img_per_s": b / sec, "extract_feat_s": encode_s,
          "denoise_step_s": step_s, "dtype": "float32, tf32 off",
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "card": smi})
    if profile:
        busy_line, _ = profile_device(lambda: model.sample(img, init_noise=noise), profile,
                                  f"# one ade20k_swin_t sample() at {b}x{h}x{w}, {smi}\n")
        emit({"phase": "profile", "table": profile, **busy_line, "sample_ms": sec * 1e3,
              "card": smi})
    return model, cfg, launches


# the pauses between a profile's start and the profiled call, and between
# the call's last synchronise and the profile's stop: the profiler drops the
# card's kernel records that it places outside its window (phase
# replay_records)
SETTLE_S = 0.1


def profiled(fn, timed: bool = False, settle_s: float = SETTLE_S):
    """A profile (CPU and CUDA activity) of one call of ``fn``; with
    ``timed`` also the call's wall ms (ending in a device synchronise),
    taken inside the profile, which starts ``settle_s`` before the call and
    stops ``settle_s`` after it."""
    from torch.profiler import ProfilerActivity, profile as prof

    with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        time.sleep(settle_s)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(settle_s)
    return (p, wall_ms) if timed else p


def busy(p, wall_ms: float) -> dict:
    """The device's busy time in a profile and its share of the profiled
    call's wall time: the union of the intervals of the kernels and copies
    the card ran, so that kernels a CUDA graph runs side by side count
    once (a sum of their times can exceed the wall time)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in p.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.is_user_annotation)
    total, end = 0.0, float("-inf")
    for lo, hi in spans:
        if hi > end:
            total += hi - max(lo, end)
            end = hi
    return {"device_busy_ms": total / 1e3, "profiled_wall_ms": wall_ms,
            "busy_share": total / 1e3 / wall_ms}


def device_kernels(p):
    """The kernel rows of a profile's averages (the aten rows repeat their
    kernels' time)."""
    return [e for e in p.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation]


# the CUDA function behind each launch counter (ops/q_sample.py, ops/upsample_ce.py)
KERNEL_FUNCS = {"encode_map": "encode_map_kernel", "q_sample": "q_sample_kernel",
                "dtable": "dtable_kernel", "upsample_ce_fwd": "upsample_ce_fwd_kernel",
                "upsample_ce_bwd": "upsample_ce_bwd_kernel"}


def kernel_launches(p) -> dict:
    """Launches of each of the port's kernels that the card ran in a
    profile, counted by the kernel's name (the profiler also sees the
    kernels of a CUDA-graph replay, which no Python wrapper counts)."""
    counts = dict.fromkeys(KERNEL_FUNCS, 0)
    for e in device_kernels(p):
        for key, func in KERNEL_FUNCS.items():
            if re.search(rf"\b{func}\b", e.key):
                counts[key] += e.count
    return counts


def _kernel_us(e, skip: str) -> float:
    """Device us of the kernels launched under the host event ``e`` and its
    children (not the device-side span of a range named ``skip``)."""
    return (sum(k.duration for k in e.kernels if k.name != skip)
            + sum(_kernel_us(c, skip) for c in e.cpu_children))


def msda_op_ms(p, name: str = "ms_deform_attn"):
    """The MSDA op's device ms in a profile of eager calls, (forward,
    backward): the kernels launched inside its ``ms_deform_attn`` ranges
    (ops/deform_attn.py), and those of the backward nodes made there (the
    profiler gives a backward node the sequence number of the forward op
    that made it). None where no range ran: a path without MSDA, or a
    CUDA-graph replay, which runs no Python. ``name``: another op's range
    (``bev_pool``, ops/bev_pool.py)."""
    cpu = torch.autograd.DeviceType.CPU
    events = p.events()
    ranges = [e for e in events if e.name == name and e.device_type == cpu]
    if not ranges:
        return None
    made, todo = set(), list(ranges)
    while todo:
        e = todo.pop()
        made.update((c.thread, c.sequence_nr) for c in e.cpu_children if c.sequence_nr >= 0)
        todo.extend(e.cpu_children)
    bwd = sum(_kernel_us(e, name) for e in events
              if e.name.startswith("autograd::engine::evaluate_function: ")
              and (e.fwd_thread, e.sequence_nr) in made)
    return sum(_kernel_us(r, name) for r in ranges) / 1e3, bwd / 1e3


def profile_call(fn, path=None, header=""):
    """(busy, launches of the port's kernels) of one profiled call of
    ``fn``; where the call ran the MSDA op or ``bev_pool`` eagerly, busy
    also gives its kernels' device ms (forward and backward) and their share
    of the device's busy time, as for the fusion model's ``lidar_branch``
    range (models/bev_fusion.py). The per-kernel table is written to ``path``
    when given."""
    p, wall_ms = profiled(fn, timed=True)
    if path:
        with open(path, "w") as f:
            f.write(header)
            f.write(p.key_averages().table(sort_by="cuda_time_total", row_limit=60))
    line = busy(p, wall_ms)
    msda = msda_op_ms(p)
    if msda:
        line.update(msda_op_device_ms=sum(msda), msda_op_backward_device_ms=msda[1],
                    msda_op_share_of_device=sum(msda) / line["device_busy_ms"])
    for name in ("bev_pool", "lidar_branch"):
        op = msda_op_ms(p, name)
        if op:
            line.update({f"{name}_device_ms": sum(op), f"{name}_backward_device_ms": op[1],
                         f"{name}_share_of_device": sum(op) / line["device_busy_ms"]})
    return line, kernel_launches(p)


def profile_device(fn, path: str, header: str):
    """Profile one call of ``fn``: (busy, top kernel families), and the
    per-kernel table written to ``path``."""
    p, wall_ms = profiled(fn, timed=True)
    top = sorted(device_kernels(p), key=lambda e: -e.self_device_time_total)[:12]
    with open(path, "w") as f:
        f.write(header)
        f.write(p.key_averages().table(sort_by="cuda_time_total", row_limit=60))
    return busy(p, wall_ms), [(e.key[:90], e.self_device_time_total / 1e3, e.count)
                              for e in top]


def phase_serve(model, cfg, smi: str):
    from ddp_tpu_torch.evaluation.batched import microbatched_call

    n, mb = 4, 2
    h, w = cfg.data.crop_size
    g = _gen(2)
    imgs = torch.randn(n, h, w, 3, generator=g).cuda()
    noise_gen = torch.Generator(device="cuda").manual_seed(3)
    reset_all_launches()
    t0 = time.perf_counter()
    labels = microbatched_call(lambda x: model.predict(x, generator=noise_gen), imgs,
                               microbatch=mb)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = all_launches()
    want = model.diffusion.timesteps * (n // mb)
    if launches["encode_map"] != want:
        raise AssertionError(f"serve: encode_map launched {launches['encode_map']} times, "
                             f"want {want}")
    if tuple(labels.shape) != (n, h, w) or labels.dtype != torch.int64:
        raise AssertionError(f"serve: labels {labels.dtype} {tuple(labels.shape)}")
    lo, hi = labels.min().item(), labels.max().item()
    if not (0 <= lo and hi < model.num_classes):
        raise AssertionError(f"serve: labels outside [0, {model.num_classes}): {lo}..{hi}")
    emit({"phase": "serve", "requests": n, "microbatch": mb, "launches": launches["encode_map"],
          "seconds": sec, "img_per_s": n / sec, "labels_range": [lo, hi], "card": smi})


# --- training ---------------------------------------------------------------

def train_batch(cfg, b: int, device="cuda"):
    """b procedural 512^2 images of cfg's classes (large angular regions, as
    ADE label maps are large regions of one class), normalised, with a band of
    ignored (255) pixels."""
    import numpy as np

    from ddp_tpu_torch.data.seg_datasets import SyntheticSegDataset

    ds = SyntheticSegDataset(cfg.model.num_classes, cfg.data.crop_size, length=b)
    items = [ds.load(i) for i in range(b)]
    mean, std = np.asarray(cfg.data.mean, np.float32), np.asarray(cfg.data.std, np.float32)
    img = np.stack([(it["image"] - mean) / std for it in items]).astype(np.float32)
    label = np.stack([it["label"] for it in items]).astype(np.int64)
    label[:, : label.shape[1] // 16] = 255
    return {"image": torch.from_numpy(img).to(device), "label": torch.from_numpy(label).to(device)}


def fixed_draws(batch, cfg, seed):
    """t [B] and noise [B·h·w, C] for a step whose random draws are fixed."""
    b, h, w = batch["label"].shape
    g = _gen(seed)
    t = torch.rand(b, generator=g) * 0.999
    noise = torch.randn(b * (h // 4) * (w // 4), cfg.model.embed_dims, generator=g)
    return dict(batch, t=t.to(batch["image"].device), noise=noise.to(batch["image"].device))


@contextlib.contextmanager
def stochastic_layers_off(model):
    saved = [(mod, mod.drop_path) for mod in model.modules() if hasattr(mod, "drop_path")]
    aux = model.aux_head.dropout
    for mod, _ in saved:
        mod.drop_path = 0.0
    model.aux_head.dropout = 0.0
    try:
        yield
    finally:
        for mod, rate in saved:
            mod.drop_path = rate
        model.aux_head.dropout = aux


def compare_grads(cfg, model, opt, batch):
    """One step's loss and gradients with fixed t and noise and dropout off,
    through the kernels and through the plain versions."""
    from ddp_tpu_torch.train.step import TrainState, make_train_step

    fixed = fixed_draws(batch, cfg, seed=5)
    state = TrainState(model, opt, torch.Generator(device="cuda").manual_seed(0))
    step = make_train_step()
    with stochastic_layers_off(model):
        g_k, logs_k = step.grads(state, fixed)
        with plain_kernels():
            g_p, logs_p = step.grads(state, fixed)
    loss_k, loss_p = logs_k["loss"].item(), logs_p["loss"].item()
    rel = abs(loss_k - loss_p) / abs(loss_p)
    worst, worst_name = 0.0, None
    for name, a, b in zip(opt.names, g_k, g_p):
        tol = 1e-4 * b.abs().max().item() + 1e-7
        d = (a - b).abs().max().item()
        if d / tol > worst:
            worst, worst_name = d / tol, name
    if not rel <= 1e-5:
        raise AssertionError(f"train: kernel vs plain loss {loss_k} vs {loss_p} (rel {rel})")
    if worst > 1.0:
        raise AssertionError(f"train: gradient of {worst_name} off by {worst} x its tolerance")
    return {"loss_kernels": loss_k, "loss_plain": loss_p, "loss_rel_diff": rel,
            "worst_grad_diff_over_tol": worst, "worst_grad": worst_name,
            "grad_tolerance": "max|d| <= 1e-4 max|g| + 1e-7 per parameter"}


def phase_train_reference(smi: str):
    """One tiny train step's loss on the card (kernels) and on the CPU
    (plain versions), same weights, t, noise and batch, dropout off."""
    from ddp_tpu_torch.config import build_model, get_config
    from ddp_tpu_torch.train.optim import make_optimizer
    from ddp_tpu_torch.train.step import TrainState, make_train_step

    cfg = get_config("tiny_seg")
    batch = fixed_draws(train_batch(cfg, 2, device="cpu"), cfg, seed=7)
    losses = {}
    for dev in ("cpu", "cuda"):
        model = build_model(cfg.model, device=dev, seed=0)
        state = TrainState(model, make_optimizer(cfg.optim, model),
                           torch.Generator(device=dev).manual_seed(0))
        with stochastic_layers_off(model):
            _, logs = make_train_step().grads(state, {k: v.to(dev) for k, v in batch.items()})
        losses[dev] = logs["loss"].item()
    rel = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
    emit({"phase": "train_reference", "preset": cfg.name, "img": [2, 64, 64, 3],
          "loss_card": losses["cuda"], "loss_cpu": losses["cpu"], "rel_diff": rel, "card": smi})
    if not rel <= 1e-5:
        raise AssertionError(f"train card vs CPU: loss {losses['cuda']} vs {losses['cpu']}")


def phase_train(smi: str, profile: str = None):
    from ddp_tpu_torch.config import build_model, get_config
    from ddp_tpu_torch.train.optim import make_optimizer
    from ddp_tpu_torch.train.step import TrainState, make_train_step

    cfg = get_config("ade20k_swin_t")
    b = 2
    model = build_model(cfg.model, device="cuda", seed=0)
    opt = make_optimizer(cfg.optim, model)
    state = TrainState(model, opt, torch.Generator(device="cuda").manual_seed(0))
    batch = train_batch(cfg, b)
    grads_check = compare_grads(cfg, model, opt, batch)

    step = make_train_step(mixed_precision=False)
    per_step = {"q_sample": 1, "dtable": 1, "upsample_ce_fwd": 2, "upsample_ce_bwd": 2,
                "encode_map": 0}
    # the main path: one step, counts set to 0 just before and read just after
    reset_all_launches()
    logs = step(state, batch)
    torch.cuda.synchronize()
    launches = all_launches()
    if launches != per_step:
        raise AssertionError(f"train: launches per step {launches}, want {per_step}")
    step(state, batch)  # second warm-up step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    losses = []
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        logs = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(logs["loss"].item())
    timed_launches = all_launches()
    if any(timed_launches[k] != 5 * v for k, v in per_step.items()):
        raise AssertionError(f"train: launches over 5 steps {timed_launches}")
    if not all(map(lambda x: x == x and abs(x) < float("inf"), losses)):
        raise AssertionError(f"train: non-finite loss {losses}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    step_s = statistics.median(times)

    def forward():
        model.train()
        model(batch["image"], batch["label"], generator=state.generator)
    fwd_s = wall_s(forward, reps=3)
    fwd_bwd_s = wall_s(lambda: step.grads(state, batch), reps=3)
    grads, _ = step.grads(state, batch)
    opt_s = wall_s(lambda: opt.step(grads), reps=3)
    out = {"phase": "train", "preset": cfg.name, "img": [b, 512, 512, 3],
           "decoder_tokens": b * 128 * 128, "dtype": "float32, tf32 off",
           "launches_per_step": launches, "losses": losses,
           "grad_norm": logs["grad_norm"].item(), "step_s": step_s, "img_per_s": b / step_s,
           "forward_s": fwd_s, "backward_s": fwd_bwd_s - fwd_s, "optimizer_s": opt_s,
           "peak_mem_gb": peak, "kernel_vs_plain": grads_check, "card": smi}
    if profile:
        busy_line, top = profile_device(lambda: step(state, batch), profile + ".train",
                                    f"# one ade20k_swin_t f32 train step at {b}x512x512, "
                                    f"{smi}\n")
        out.update(busy_line, top_kernels_ms=top)
    emit(out)

    bf16 = make_train_step(mixed_precision=True)
    for _ in range(2):
        bf16(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        logs = bf16(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(logs["loss"].item())
    if not all(map(lambda x: x == x and abs(x) < float("inf"), losses)):
        raise AssertionError(f"train bf16: non-finite loss {losses}")
    sec = statistics.median(times)
    out = {"phase": "train_bf16", "preset": cfg.name, "img": [b, 512, 512, 3],
           "dtype": "bf16 forward/backward, f32 master weights", "losses": losses,
           "step_s": sec, "img_per_s": b / sec,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "card": smi}
    if profile:
        busy_line, top = profile_device(lambda: bf16(state, batch), profile + ".train_bf16",
                                    f"# one ade20k_swin_t bf16 train step at {b}x512x512, "
                                    f"{smi}\n")
        out.update(busy_line, top_kernels_ms=top)
    emit(out)
    return launches


def backward_node(p, node: str):
    """(device ms, kernel launches) under the autograd node ``node`` of a
    profile: its evaluate_function events and every op below them."""
    def launches(e):
        return len(e.kernels) + sum(launches(ch) for ch in e.cpu_children)

    events = [e for e in p.events()
              if e.name == f"autograd::engine::evaluate_function: {node}"]
    if not events:
        raise AssertionError(f"no {node} in the profile")
    return sum(e.device_time_total for e in events) / 1e3, sum(launches(e) for e in events)


def phase_table_grad(smi: str):
    """The table gradient of the corruption, as the training path takes it:
    autograd.grad of q_sample w.r.t. the table at the path's shape (region-
    map labels, f32), timed and profiled alone, and its autograd node
    (_QSampleBackward) in one profiled f32 train step of ade20k_swin_t. Only
    the package's public functions are called, so the phase also measures an
    earlier checkout's package when run from that checkout's root."""
    from ddp_tpu_torch.config import build_model, get_config
    from ddp_tpu_torch.ops import q_sample as Q
    from ddp_tpu_torch.train.optim import make_optimizer
    from ddp_tpu_torch.train.step import TrainState, make_train_step

    cfg = get_config("ade20k_swin_t")
    labels = region_labels(cfg)
    g = _gen(4)
    table = torch.randn(K + 1, C, generator=g).cuda().requires_grad_(True)
    alpha = torch.rand(N, generator=g).cuda()
    sigma = (1.0 - alpha ** 2).sqrt()
    noise, cot = torch.randn(N, C, generator=g).cuda(), torch.randn(N, C, generator=g).cuda()
    out = Q.q_sample(labels, table, BIT_SCALE, alpha, sigma, noise)

    def backward():
        torch.autograd.grad(out, table, cot, retain_graph=True)

    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    event_ms = time_ms(backward, flush=flush)
    alone = device_kernels(profiled(backward))
    del flush

    model = build_model(cfg.model, device="cuda", seed=0)
    state = TrainState(model, make_optimizer(cfg.optim, model),
                       torch.Generator(device="cuda").manual_seed(0))
    batch = train_batch(cfg, 2)
    step = make_train_step(mixed_precision=False)
    for _ in range(2):
        step(state, batch)
    step_ms, step_launches = backward_node(profiled(lambda: step(state, batch)),
                                           "_QSampleBackward")
    emit({"phase": "table_grad", "shape": [N, C, K + 1], "labels": "region map",
          "alone": {"event_ms": event_ms,
                    "device_ms": sum(e.self_device_time_total for e in alone) / 1e3,
                    "launches": sum(e.count for e in alone),
                    "kernels": [(e.key[:80], e.count, e.self_device_time_total / 1e3)
                                for e in alone]},
          "in_train_step": {"node": "_QSampleBackward", "device_ms": step_ms,
                            "launches": step_launches},
          "card": smi})


# --- the train step as one dispatch (CUDA graphs) and the training loop -----

PER_STEP = {"q_sample": 1, "dtable": 1, "upsample_ce_fwd": 2, "upsample_ce_bwd": 2,
            "encode_map": 0}


def snapshot(state, keep=None):
    """What a step changes: parameters and buffers, the optimizer's moments
    and count, the step and the generator's state. ``keep(name)``: only
    those tensors (and moments) are kept, e.g. the ones a step can change
    where the rest are frozen by lr_mult 0 (their moments then drift, which
    moves nothing)."""
    kept = (lambda name: True) if keep is None else keep
    return ({k: v.detach().clone() for k, v in state.model.state_dict().items() if kept(k)},
            [m.clone() if kept(n) else None for n, m in zip(state.optimizer.names,
                                                            state.optimizer.mu)],
            [m.clone() if kept(n) else None for n, m in zip(state.optimizer.names,
                                                            state.optimizer.nu)],
            state.optimizer.count, state.step, state.generator.get_state())


def restore(state, snap):
    """Write a snapshot back in place (a captured graph keeps its addresses)."""
    sd, mu, nu, count, step, gen = snap
    with torch.no_grad():
        for k, v in state.model.state_dict().items():
            if k in sd:
                v.copy_(sd[k])
        for dst, src in zip(state.optimizer.mu + state.optimizer.nu, mu + nu):
            if src is not None:
                dst.copy_(src)
    state.optimizer.count, state.step = count, step
    state.generator.set_state(gen)


def stacked(batch, n):
    from ddp_tpu_torch.train.step import tree_map

    return {k: tree_map(lambda x: torch.stack([x] * n), v) for k, v in batch.items()}


# a graphed step's or a resumed run's parameters against the reference's:
# each tensor within this share of its update (L2) + 3 x the reference's own
# run-to-run distance
TOL_UPDATE = 1e-3


def l2_by_tensor(a: dict, b: dict) -> dict:
    return {n: (a[n] - b[n]).double().norm().item() for n in a}


def check_by_tensor(ref: dict, other: dict, before: dict, noise: dict):
    """Each parameter tensor t of ``other`` within TOL_UPDATE x ||ref_t -
    before_t|| (the reference's update) + 3 x noise[t] (the L2 distance
    between two runs of the reference: float atomics make the card's runs
    differ) of ``ref``, in L2. Returns (ok, summary)."""
    d, upd = l2_by_tensor(other, ref), l2_by_tensor(ref, before)
    limit = {n: TOL_UPDATE * upd[n] + 3.0 * noise[n] for n in d}
    ratio = {n: d[n] / limit[n] if limit[n] else (0.0 if d[n] == 0 else float("inf"))
             for n in d}
    worst = max(ratio, key=ratio.get)

    def share(x):  # L2 over all tensors, as a share of the update's
        return (sum(v * v for v in x.values()) / sum(v * v for v in upd.values())) ** 0.5

    return ratio[worst] <= 1.0, {
        "tensors_over_limit": sum(r > 1.0 for r in ratio.values()),
        "worst_tensor": worst, "worst_over_limit": ratio[worst], "worst_l2": d[worst],
        "worst_update_l2": upd[worst], "worst_noise_l2": noise[worst],
        "bitwise_equal": f"{sum(v == 0 for v in d.values())} of {len(d)}",
        "noise_bitwise_equal": f"{sum(v == 0 for v in noise.values())} of {len(d)}",
        "l2_over_update": share(d), "noise_l2_over_update": share(noise),
        "limit": f"per tensor: L2 <= {TOL_UPDATE} x L2 of the update + 3 x L2 between two "
                 "runs of the reference"}


def params_of(state, keep=None) -> dict:
    return {k: p.detach().clone() for k, p in state.model.named_parameters()
            if keep is None or keep(k)}


def graph_vs_eager(state, chunk_fn, eager, batch, n, keep=None):
    """n graphed steps (one replay) and n eager steps from one snapshot of
    the state, and n eager steps once more from it: the first step's loss
    (one state, one batch, the same draws) within 1e-5 relative, each later
    step's within 1e-5 relative plus 3x the largest difference between the
    two eager runs' losses (their states drift apart step by step), the same
    generator state after all three (the replay drew what the eager steps
    drew), and every parameter tensor within ``check_by_tensor``'s limit.
    ``keep``: snapshot and compare only these tensors (``snapshot``)."""
    before = snapshot(state, keep)
    params_0 = {k: before[0][k] for k, _ in state.model.named_parameters() if k in before[0]}
    logs_g = chunk_fn(state, stacked(batch, n))
    params_g = params_of(state, keep)
    gen_g = state.generator.get_state()
    restore(state, before)
    logs_e2 = [eager(state, batch) for _ in range(n)]
    params_e2 = params_of(state, keep)
    restore(state, before)
    logs_e = [eager(state, batch) for _ in range(n)]
    params_e = params_of(state, keep)
    loss_g = logs_g["loss"].tolist()
    loss_e = [logs["loss"].item() for logs in logs_e]
    loss_e2 = [logs["loss"].item() for logs in logs_e2]
    loss_rel = abs(loss_g[0] - loss_e[0]) / abs(loss_e[0])
    spread = max(abs(e2 - e) for e, e2 in zip(loss_e, loss_e2))
    losses_ok = loss_rel <= 1e-5 and all(
        abs(g - e) <= 1e-5 * abs(e) + 3.0 * spread for g, e in zip(loss_g, loss_e))
    same_draws = torch.equal(gen_g, state.generator.get_state())
    params_ok, params = check_by_tensor(params_e, params_g, params_0,
                                        l2_by_tensor(params_e2, params_e))
    out = {"n": n, "loss_graph": loss_g, "loss_eager": loss_e, "loss_eager_again": loss_e2,
           "loss_rel_diff_first_step": loss_rel, "losses_within_eager_spread": losses_ok,
           "same_generator_state": same_draws, "params": params}
    if not (losses_ok and same_draws and params_ok):
        emit({"phase": "graph", "failed_check": out})
        raise AssertionError(f"graph vs eager, n={n}: loss rel {loss_rel}, same draws "
                             f"{same_draws}, {params}")
    return out


def check_capture_failure():
    """A capture that fails raises, and leaves a card that still works: a
    chunked step whose forward reads a value on the host (not allowed in a
    stream capture) on tiny_seg."""
    from ddp_tpu_torch.config import build_model, get_config
    from ddp_tpu_torch.train.optim import make_optimizer
    from ddp_tpu_torch.train.step import TrainState, make_chunked_train_step

    cfg = get_config("tiny_seg")
    model = build_model(cfg.model, device="cuda", seed=0)
    state = TrainState(model, make_optimizer(cfg.optim, model),
                       torch.Generator(device="cuda").manual_seed(0))
    chunk = make_chunked_train_step(2)
    grads = chunk.step.grads

    def syncing_grads(state, batch):
        out = grads(state, batch)
        out[1]["loss"].item()
        return out

    chunk.step.grads = syncing_grads
    try:
        chunk(state, stacked(train_batch(cfg, 2), 2))
    except RuntimeError as e:
        err = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    else:
        raise AssertionError("a capture with a host read in it did not raise")
    torch.cuda.synchronize()
    if torch.ones(8, device="cuda").sum().item() != 8.0:
        raise AssertionError("the card misbehaves after a failed capture")
    return err


# the steps of a graphed chunk held to the eager steps (graph_vs_eager) where
# the case holds fewer than the chunk's: under deterministic algorithms the
# eager steps are the phase's cost, and 3 x this many run per case
HELD_STEPS = 4


def graph_case(cfg, mixed: bool, smi: str, profile: str = None, ns=(1, 10), b: int = 2,
               batch=None, per_step: dict = PER_STEP, held_steps: int = HELD_STEPS):
    """``cfg`` (ade20k_swin_t, ade20k_swin_t_msda, cityscapes_convnext_t or
    nyu_swin_t) at b crops of its size (``batch``; train_batch's when None):
    the eager step and the graphed chunks of ``ns`` steps from one state and
    one batch, the card's kernels held to ``per_step`` launches per step
    (the depther's path runs none); a chunk of min(n, ``held_steps``) steps,
    captured alike, held to the eager steps. The optimizer starts
    at the end of the lr warm-up (lr 6e-5, as a run resumed there): at the
    first steps' lr (below 1e-7) an update is a few ulps of a parameter near
    1 (the norms' weights), so one rounding of p - u.lr is a third of it and
    no share of the update can be resolved."""
    from ddp_tpu_torch.config import build_model
    from ddp_tpu_torch.train.optim import make_optimizer
    from ddp_tpu_torch.train.step import TrainState, make_chunked_train_step, make_train_step

    model = build_model(cfg.model, device="cuda", seed=0)
    state = TrainState(model, make_optimizer(cfg.optim, model),
                       torch.Generator(device="cuda").manual_seed(0))
    state.optimizer.count = cfg.optim.warmup_steps
    batch = train_batch(cfg, b) if batch is None else batch
    tag = "bf16" if mixed else "f32"
    eager = make_train_step(mixed_precision=mixed)
    for _ in range(2):
        eager(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    live = torch.cuda.memory_allocated() / 1e9
    eager_s = wall_s(lambda: eager(state, batch), reps=5, warmup=0)
    eager_peak = torch.cuda.max_memory_allocated() / 1e9
    eager_busy, eager_launches = profile_call(
        lambda: eager(state, batch), profile and f"{profile}.{cfg.name}_{tag}_eager",
        f"# one eager {cfg.name} {tag} train step, {smi}\n")
    if eager_launches != per_step:
        raise AssertionError(f"graph {tag}: the card ran {eager_launches} in an eager step")
    if eager_busy.get("msda_op_backward_device_ms", 1.0) <= 0:
        raise AssertionError(f"graph {tag}: no backward kernel was tied to the MSDA op")

    out = {"phase": "graph", "preset": cfg.name, "img": [b, *cfg.data.crop_size, 3],
           "dtype": "bf16 forward/backward, f32 master weights" if mixed
           else "float32, tf32 off", "lr": state.optimizer.lr_schedule(state.optimizer.count),
           "eager": {"wall_ms_per_step": eager_s * 1e3, "img_per_s": b / eager_s,
                     **eager_busy, "launches_profiled": eager_launches,
                     "live_before_gb": live, "peak_mem_gb": eager_peak}}
    for n in ns:
        reps = 5 if n == 1 else 2
        chunk_batch = stacked(batch, n)
        # held with PyTorch's deterministic algorithms on (graph and eager
        # alike): without them its index_add_/index_put_ sum by atomics in an
        # order that follows the card's timing, which differs between eager
        # launches and a replay (phase graph_grads); what remains is the
        # port's own atomics (squash_dtable into the table, the CE sums)
        t_held = time.perf_counter()
        with deterministic_algorithms(True):
            held_n = min(n, held_steps)
            held = make_chunked_train_step(held_n, mixed_precision=mixed)
            held(state, stacked(batch, held_n))  # eager on the capture stream, then capture
            check = graph_vs_eager(state, held, eager, batch, held_n)
        check["wall_s"] = time.perf_counter() - t_held
        del held
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        live = torch.cuda.memory_allocated() / 1e9
        chunk = make_chunked_train_step(n, mixed_precision=mixed)
        chunk(state, chunk_batch)
        sec = wall_s(lambda: chunk(state, chunk_batch), reps=reps, warmup=0) / n
        peak = torch.cuda.max_memory_allocated() / 1e9
        # one replay under the profiler: the card's busy share of it and the
        # launches the card ran, by kernel name
        replay_busy, launched = profile_call(
            lambda: chunk(state, chunk_batch), profile and f"{profile}.{cfg.name}_{tag}_n{n}",
            f"# one replay of {n} graphed {cfg.name} {tag} train steps, {smi}\n")
        replayed = {k: v / n for k, v in launched.items()}
        if replayed != per_step:
            raise AssertionError(f"graph {tag} n={n}: the card ran {launched} in one replay")
        out[f"graph_n{n}"] = {
            "wall_ms_per_step": sec * 1e3, "img_per_s": b / sec,
            "device_busy_ms_per_step": replay_busy["device_busy_ms"] / n,
            "busy_share": replay_busy["busy_share"],
            "profiled_wall_ms_per_step": replay_busy["profiled_wall_ms"] / n,
            "launches_per_replayed_step": replayed, "capture_s": chunk.capture_s[n],
            "live_before_gb": live, "peak_mem_gb": peak,
            "vs_eager_deterministic_algorithms": check}
        del chunk
    emit(dict(out, card=smi))
    return replayed


def phase_graph(smi: str, profile: str = None):
    """The train step as one CUDA-graph dispatch at ade20k_swin_t, f32 and
    bf16."""
    from ddp_tpu_torch.config import get_config

    cfg = get_config("ade20k_swin_t")
    # chunks of 10 only (the dist phase holds a 2-step graph, with the
    # all-reduce, to the eager steps in f32); f32 holds all 10 steps
    launches = graph_case(cfg, False, smi, profile, ns=(10,), held_steps=10)
    torch.cuda.empty_cache()
    graph_case(cfg, True, smi, profile, ns=(10,))
    torch.cuda.empty_cache()
    return launches


@contextlib.contextmanager
def deterministic_algorithms(on: bool):
    """PyTorch's deterministic algorithms on or off (warn-only); yields a
    list that receives the first line of each warning raised inside."""
    import warnings

    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(on, warn_only=True)
    hits = []
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield hits
            hits.extend(sorted({str(w.message).splitlines()[0][:200] for w in caught}))
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])


def graphed_grads(step, state, batch):
    """``step.grads`` as one CUDA-graph replay (a warm-up call on the capture
    stream, the capture, one replay): the replay's gradients."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        step.grads(state, batch)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(state.generator)
    with torch.cuda.graph(graph, stream=stream):
        grads, _ = step.grads(state, batch)
    graph.replay()
    torch.cuda.synchronize()
    return [g.clone() for g in grads]


def grad_diffs(names, ref, other) -> dict:
    """Per gradient tensor: bitwise equal or not (counted by the name's
    first component), and the largest max|d| / max|g|."""
    by_module, worst = {}, []
    for name, a, b in zip(names, ref, other):
        top = name.split(".")[0]
        same = torch.equal(a, b)
        eq, total = by_module.get(top, (0, 0))
        by_module[top] = (eq + same, total + 1)
        if not same:
            worst.append(((a - b).abs().max().item() / max(a.abs().max().item(), 1e-30), name))
    return {"bitwise_equal": {k: f"{eq} of {total}" for k, (eq, total) in by_module.items()},
            "worst_max_diff_over_max_grad": sorted(worst, reverse=True)[:4]}


def phase_graph_grads(smi: str):
    """Where the graphed and the eager step part: one ade20k_swin_t step's
    gradients at 2 x 512^2 (fixed t and noise, dropout and drop path off)
    twice eagerly and once as a CUDA-graph replay of ``TrainStep.grads``,
    f32 and bf16, with PyTorch's deterministic algorithms off and on."""
    from ddp_tpu_torch.config import build_model, get_config
    from ddp_tpu_torch.train.optim import make_optimizer
    from ddp_tpu_torch.train.step import TrainState, make_train_step

    cfg = get_config("ade20k_swin_t")
    model = build_model(cfg.model, device="cuda", seed=0)
    state = TrainState(model, make_optimizer(cfg.optim, model),
                       torch.Generator(device="cuda").manual_seed(0))
    names = state.optimizer.names
    fixed = fixed_draws(train_batch(cfg, 2), cfg, seed=5)
    out = {"phase": "graph_grads", "preset": cfg.name, "img": [2, 512, 512, 3]}
    with stochastic_layers_off(model):
        for mixed in (False, True):
            step = make_train_step(mixed_precision=mixed)
            for det in (False, True):
                case = {}
                with deterministic_algorithms(det) as warned:
                    ref = step.grads(state, fixed)[0]
                    case["eager_vs_eager"] = grad_diffs(names, ref, step.grads(state, fixed)[0])
                    try:
                        case["graph_vs_eager"] = grad_diffs(
                            names, ref, graphed_grads(step, state, fixed))
                    except RuntimeError as e:
                        case["graph_vs_eager"] = f"{type(e).__name__}: {str(e)[:200]}"
                        torch.cuda.synchronize()
                case["warnings"] = warned
                out[f"{'bf16' if mixed else 'f32'}_deterministic_{'on' if det else 'off'}"] = case
                torch.cuda.empty_cache()
    emit(dict(out, card=smi))


def _sync_after_last_kernel_us(p) -> float:
    """The last device synchronise's end less the last kernel's end in a
    profile, us: negative where the profiler placed a kernel after the host
    call that waited for it."""
    cuda = torch.autograd.DeviceType.CUDA
    ev = p.events()
    return (max(e.time_range.end for e in ev if e.name == "cudaDeviceSynchronize")
            - max(e.time_range.end for e in ev
                  if e.device_type == cuda and not e.is_user_annotation))


def phase_replay_records(smi: str, tries: int = 16):
    """How often a profile of one CUDA-graph replay lacks kernel records:
    ade20k_swin_t_msda's 10 graphed bf16 steps at 2 x 512^2 (a replay that
    graph_case profiles), profiled ``tries`` times each with and without the
    pauses SETTLE_S after the profile starts and before it stops, in turn.
    The call runs the same kernels every time (the batch copies, the replay,
    the logs' clones), so each count below the largest is records lost. Per
    profile: records lost, the port's kernels missing or extra, and where the profiler
    placed the last kernel against the host's synchronise; for profiles that
    lost more than 20 records, the kernels short by name. It fails if a
    profile with the pauses miscounts the port's kernels."""
    from collections import Counter

    from ddp_tpu_torch.config import build_model, get_config
    from ddp_tpu_torch.train.optim import make_optimizer
    from ddp_tpu_torch.train.step import TrainState, make_chunked_train_step

    cfg, n = get_config("ade20k_swin_t_msda"), 10
    model = build_model(cfg.model, device="cuda", seed=0)
    state = TrainState(model, make_optimizer(cfg.optim, model),
                       torch.Generator(device="cuda").manual_seed(0))
    state.optimizer.count = cfg.optim.warmup_steps
    chunk_batch = stacked(train_batch(cfg, 2), n)
    chunk = make_chunked_train_step(n, mixed_precision=True)
    for _ in range(2):  # the eager first chunk and the capture, then a replay
        chunk(state, chunk_batch)
    seen = {0.0: [], SETTLE_S: []}
    for _ in range(tries):
        for settle, runs in seen.items():
            p = profiled(lambda: chunk(state, chunk_batch), settle_s=settle)
            runs.append((Counter({e.key: e.count for e in device_kernels(p)}),
                         kernel_launches(p), _sync_after_last_kernel_us(p)))
    most = Counter()
    for runs in seen.values():
        for names, _, _ in runs:
            most |= names
    out = {"phase": "replay_records", "preset": cfg.name, "dtype": "bf16",
           "steps_per_replay": n, "tries": tries,
           "kernel_records_per_call": sum(most.values())}
    for settle, runs in seen.items():
        lost = [most - names for names, _, _ in runs]
        out[f"settle_{settle}_s"] = {
            "records_lost": [sum(c.values()) for c in lost],
            "port_kernels_off": [sum(abs(n * v - launched[k]) for k, v in PER_STEP.items())
                                 for _, launched, _ in runs],
            "sync_after_last_kernel_us": [us for _, _, us in runs],
            "short_by_name": {i: [(k[:60], v) for k, v in c.most_common(4)]
                              for i, c in enumerate(lost) if sum(c.values()) > 20}}
    emit(dict(out, card=smi))
    if any(out[f"settle_{SETTLE_S}_s"]["port_kernels_off"]):
        raise AssertionError(f"replay_records: profiles with the pauses miscounted the port's "
                             f"kernels: {out}")


def _log_steps(workdir):
    with open(os.path.join(workdir, "train_log.jsonl")) as f:
        return [json.loads(line) for line in f]


def profiled_window(batches, start: int, stop: int, out: list):
    """Yield ``batches``; the card's kernels are profiled from the request
    of batch ``start`` to that of batch ``stop``, each after a synchronise,
    and the profile is appended to ``out``. train() takes a chunk's batches
    before it dispatches the chunk, so with start and stop multiples of the
    chunk the window holds whole chunks."""
    from torch.profiler import ProfilerActivity, profile as prof

    p = prof(activities=[ProfilerActivity.CUDA])
    for i, batch in enumerate(batches):
        if i == start:
            torch.cuda.synchronize()
            p.start()
            time.sleep(SETTLE_S)
        elif i == stop:
            torch.cuda.synchronize()
            time.sleep(SETTLE_S)
            p.stop()
            out.append(p)
        yield batch


def phase_loop(smi: str):
    """train() on converge_seg_window for 100 iterations, 10 per dispatch,
    batches from make_train_iter: it learns, logs and checkpoints at the JAX
    loop's steps, and a resume from the step-90 checkpoint continues the run."""
    import dataclasses
    import shutil

    from ddp_tpu_torch.config import get_config
    from ddp_tpu_torch.data import make_train_iter
    from ddp_tpu_torch.train.loop import train

    base = get_config("converge_seg_window")
    root = os.path.join("work_dirs", "chip_smoke_loop")
    shutil.rmtree(root, ignore_errors=True)

    def cfg_at(workdir):
        # log every 25 steps (crossings inside chunks), checkpoint every 45
        # (misaligned: the hook lands at the chunk end)
        return dataclasses.replace(base, runtime=dataclasses.replace(
            base.runtime, total_iters=100, log_interval=25, ckpt_interval=45,
            max_keep_ckpts=-1, tensorboard=False, workdir=workdir))

    cfg = cfg_at(os.path.join(root, "run"))
    window = []
    reset_all_launches()
    t0 = time.perf_counter()
    state = train(cfg, profiled_window(make_train_iter(cfg), 30, 50, window))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # the wrappers launch in the first chunk (eager) and in the capture; a
    # replay runs no Python, so what the card ran in replays is read from
    # the profile of steps 31-50 (two replays)
    host, device = all_launches(), kernel_launches(window[0])
    if host != {k: 20 * v for k, v in PER_STEP.items()} or \
            device != {k: 20 * v for k, v in PER_STEP.items()}:
        raise AssertionError(f"loop: wrapper launches {host} over 100 steps, "
                             f"{device} run by the card in steps 31-50")
    logs = _log_steps(cfg.runtime.workdir)
    ckpt_dir = os.path.join(cfg.runtime.workdir, "ckpts")
    ckpts = sorted(int(f[5:-3]) for f in os.listdir(ckpt_dir) if f.endswith(".pt"))
    # ddp_tpu/train/loop.py:143-214 with 10 steps per dispatch: a log at
    # every crossing of 25 and at the first step; a checkpoint at the chunk
    # end after each crossing of 45, and at the last step
    if [r["step"] for r in logs] != [1, 25, 50, 75, 100] or ckpts != [50, 90, 100]:
        raise AssertionError(f"loop: logs at {[r['step'] for r in logs]}, "
                             f"checkpoints at {ckpts}")
    loss1, loss100 = logs[0]["loss"], logs[-1]["loss"]
    if not loss100 < 0.5 * loss1:
        raise AssertionError(f"loop: loss {loss1} at step 1, {loss100} at step 100")

    def resume(name):
        rdir = os.path.join(root, name)
        os.makedirs(os.path.join(rdir, "ckpts"))
        shutil.copy(os.path.join(ckpt_dir, "step_90.pt"), os.path.join(rdir, "ckpts"))
        rcfg = cfg_at(rdir)
        data = make_train_iter(rcfg)
        for _ in range(90):
            next(data)
        return train(rcfg, data, resume=True), _log_steps(rdir)

    # twice: the two resumed runs' distance is the card's run-to-run noise
    (resumed, rlogs), (again, _) = resume("resumed"), resume("resumed_again")
    p90 = torch.load(os.path.join(ckpt_dir, "step_90.pt"), map_location="cuda",
                     weights_only=True)["model"]

    def params(s):
        return {k: p.detach() for k, p in s.model.named_parameters()}

    # the uninterrupted run is the reference; two resumed runs give the noise
    params_ok, diffs = check_by_tensor(params(state), params(resumed), p90,
                                       l2_by_tensor(params(again), params(resumed)))
    same_draws = torch.equal(state.generator.get_state(), resumed.generator.get_state())
    counters = (resumed.step, resumed.optimizer.count) == (state.step, state.optimizer.count)
    if not (same_draws and counters and params_ok and [r["step"] for r in rlogs] == [91, 100]):
        raise AssertionError(f"loop resume: generator {same_draws}, counters {counters}, "
                             f"{diffs}, logs {[r['step'] for r in rlogs]}")
    emit({"phase": "loop", "preset": cfg.name, "iters": 100, "steps_per_dispatch": 10,
          "batch": [cfg.data.batch_size, *cfg.data.crop_size],
          "wall_s": wall, "steps_per_s": 100 / wall,
          "wall_note": "steps 31-50 ran under the profiler (kernel activity only)",
          "wrapper_launches_100_steps": host, "launches_run_by_card_steps_31_50": device,
          "log_steps": [r["step"] for r in logs], "ckpt_steps": ckpts,
          "loss_step1": loss1, "loss_step100": loss100,
          "resume_from_90": {"same_generator_state": same_draws, "same_step_and_count": counters,
                             "params_vs_uninterrupted": diffs,
                             "loss_step100": rlogs[-1]["loss"],
                             "log_steps": [r["step"] for r in rlogs]},
          "card": smi})
    shutil.rmtree(root, ignore_errors=True)
    return host, device


# --- the msda decoder -----------------------------------------------------------

MSDA_DIR = os.path.join("work_dirs", "chip_smoke_msda")


def msda_inputs(b=2, h=128, w=128, heads=8, points=4, dim=32, seed=21):
    """The decoder's MSDA call at ade20k_swin_t_msda, 2 x 512^2: value [b,
    h·w, heads, dim], locations [b, h·w, heads, 1, points, 2] (each token's
    cell centre plus offsets of a few pixels, some beyond the border) and
    softmaxed weights [b, h·w, heads, 1, points], on the card."""
    from ddp_tpu_torch.nn.transformer import reference_points

    g = _gen(seed)
    value = torch.randn(b, h * w, heads, dim, generator=g)
    ref = torch.from_numpy(reference_points(((h, w),)))[None, :, None, :, None, :]
    offsets = 3.0 * torch.randn(b, h * w, heads, 1, points, 2, generator=g)
    loc = ref + offsets / torch.tensor([w, h], dtype=torch.float32)
    weights = torch.softmax(torch.randn(b, h * w, heads, points, generator=g), dim=-1)
    return (value.cuda(), loc.cuda(), weights.reshape(b, h * w, heads, 1, points).cuda(),
            (h, w))


def grid_sample_msda(value, hw, loc, weights):
    """The same sampling through ``F.grid_sample`` (bilinear, zeros,
    align_corners=False), one level: the library yardstick."""
    import torch.nn.functional as F

    b, s, nh, d = value.shape
    q, p = loc.shape[1], loc.shape[4]
    v = value.permute(0, 2, 3, 1).reshape(b * nh, d, *hw)
    grid = (2.0 * loc[:, :, :, 0] - 1.0).permute(0, 2, 1, 3, 4).reshape(b * nh, q, p, 2)
    out = F.grid_sample(v, grid, mode="bilinear", padding_mode="zeros", align_corners=False)
    wts = weights[:, :, :, 0].permute(0, 2, 1, 3).reshape(b * nh, 1, q, p)
    return (out * wts).sum(-1).reshape(b, nh, d, q).permute(0, 3, 1, 2).reshape(b, q, nh * d)


def msda_op(smi: str):
    """The MSDA op alone at the decoder's shape: forward and forward+backward
    ms (CUDA events, cold L2) of ms_deform_attn (the "gather" form: one
    embedding_bag on a flat index), beside grid_sample's at the same
    sampling; their agreement; and which of the two backwards PyTorch's
    deterministic algorithms accept."""
    from ddp_tpu_torch.ops.deform_attn import ms_deform_attn

    value, loc, weights, hw = msda_inputs()
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    out = ms_deform_attn(value, (hw,), loc, weights)
    ref = grid_sample_msda(value, hw, loc, weights)
    err = (out - ref).abs().max().item()
    if not err <= 1e-5 * max(1.0, ref.abs().max().item()):
        raise AssertionError(f"msda: gather form vs grid_sample max |d| {err}")
    cot = torch.randn(out.shape, generator=_gen(22)).cuda()
    leaves = [t.clone().requires_grad_(True) for t in (value, loc, weights)]

    def fwd_bwd(fn):
        v, lc, w = leaves
        torch.autograd.grad((fn(v, lc, w) * cot).sum(), leaves)

    def gather(v, lc, w):
        return ms_deform_attn(v, (hw,), lc, w)

    def library(v, lc, w):
        return grid_sample_msda(v, hw, lc, w)

    with torch.no_grad():
        fwd_ms = time_ms(lambda: gather(value, loc, weights), flush=flush)
        grid_fwd_ms = time_ms(lambda: library(value, loc, weights), flush=flush)
    fwd_bwd_ms = time_ms(lambda: fwd_bwd(gather), flush=flush)
    grid_fwd_bwd_ms = time_ms(lambda: fwd_bwd(library), flush=flush)
    det = {}
    for name, fn in (("gather", gather), ("grid_sample", library)):
        with deterministic_algorithms(True) as warned:
            runs = []
            for _ in range(2):
                v, lc, w = leaves
                runs.append(torch.autograd.grad((fn(v, lc, w) * cot).sum(), leaves))
            torch.cuda.synchronize()
        det[name] = {"warnings": warned, "grads_bitwise_equal_twice": all(
            torch.equal(a, b) for a, b in zip(*runs))}
        if name == "gather":
            with deterministic_algorithms(True):
                det[name]["fwd_bwd_ms"] = time_ms(lambda: fwd_bwd(gather), flush=flush)
    # cuBLAS warns under deterministic algorithms unless CUBLAS_WORKSPACE_CONFIG
    # is set (its GEMMs here are deterministic all the same); any other
    # warning names an op of the gather form without a deterministic kernel
    others = [w for w in det["gather"]["warnings"] if "CuBLAS" not in w]
    if others or not det["gather"]["grads_bitwise_equal_twice"]:
        raise AssertionError(f"msda: the gather form is not deterministic: {det['gather']}")
    return {"value": list(value.shape), "loc": list(loc.shape), "weights": list(weights.shape),
            "max_abs_diff_vs_grid_sample": err, "fwd_ms": fwd_ms, "fwd_bwd_ms": fwd_bwd_ms,
            "grid_sample_fwd_ms": grid_fwd_ms, "grid_sample_fwd_bwd_ms": grid_fwd_bwd_ms,
            "deterministic_algorithms": det,
            "timing": "median of 30 CUDA-event timings after a 256 MiB rewrite (cold L2), f32"}


def phase_msda_main(smi: str):
    """Serving with the msda decoder: ade20k_swin_t_msda at full width and
    depth, its weights seeded random tensors under mmseg's names written to a
    .pth and loaded onto the card by load_mmseg_checkpoint; sample() on
    2 x 512^2 through the kernels and through the plain versions; then the
    MSDA op alone."""
    import shutil

    from ddp_tpu_torch.config import get_config
    from ddp_tpu_torch.train.torch_import import load_mmseg_checkpoint, synthetic_mmseg_state

    cfg = get_config("ade20k_swin_t_msda")
    m = cfg.model
    b, (h, w) = 2, cfg.data.crop_size
    os.makedirs(MSDA_DIR, exist_ok=True)
    path = os.path.join(MSDA_DIR, "mmseg_random.pth")
    torch.save({"state_dict": {k: torch.from_numpy(v)
                               for k, v in synthetic_mmseg_state(m, seed=0, gn="gn").items()}},
               path)
    t0 = time.perf_counter()
    model, report = load_mmseg_checkpoint(path, cfg, device="cuda")
    load_s = time.perf_counter() - t0
    shutil.rmtree(MSDA_DIR, ignore_errors=True)
    if report["missing"] or report["unused"]:
        raise AssertionError(f"msda import report not empty: {report}")
    g = _gen(31)
    img = torch.randn(b, h, w, 3, generator=g).cuda()
    noise = torch.randn(m.diffusion.randsteps * b, h // 4, w // 4, m.embed_dims,
                        generator=g).cuda()

    reset_all_launches()
    probs = model.sample(img, init_noise=noise)
    torch.cuda.synchronize()
    launches = all_launches()
    if launches["encode_map"] != m.diffusion.timesteps:
        raise AssertionError(f"msda serve: encode_map launched {launches['encode_map']} "
                             f"times, want {m.diffusion.timesteps}")
    check_probs(probs, (b, h, w, m.num_classes))
    with plain_kernels():
        plain = model.sample(img, init_noise=noise)
    diff, agree = compare_probs(probs, plain)
    del plain
    if not (diff <= 1e-4 and agree >= 0.999):
        raise AssertionError(f"msda: kernel vs plain path: prob diff {diff}, agreement {agree}")
    sec = wall_s(lambda: model.sample(img, init_noise=noise))
    busy_line, card_launches = profile_call(lambda: model.sample(img, init_noise=noise))
    with torch.no_grad():
        feat = model.extract_feat(img)
        log_snr = torch.zeros(noise.shape[0], device="cuda")
        step_s = wall_s(lambda: model.denoise_logits(
            feat.repeat(m.diffusion.randsteps, 1, 1, 1), noise, log_snr))
    peak = torch.cuda.max_memory_allocated() / 1e9
    del model, feat
    torch.cuda.empty_cache()
    emit({"phase": "msda_main", "preset": cfg.name, "img": [b, h, w, 3],
          "weights": "seeded random tensors under mmseg names, torch.save'd, "
                     "load_mmseg_checkpoint", "import_report": report, "load_s": load_s,
          "launches": launches, "launches_run_by_card": card_launches,
          "max_abs_prob_diff_vs_plain": diff, "argmax_agreement_vs_plain": agree,
          "sample_s": sec, "img_per_s": b / sec, **busy_line, "denoise_step_s": step_s,
          "dtype": "float32, tf32 off", "peak_mem_gb": peak,
          "msda_op": msda_op(smi), "card": smi})
    return launches


def train_paths(cfg, b: int, phase: str, smi: str, profile: str = None):
    """``cfg`` at full width and depth, b crops of its size: one step with
    fixed draws through the kernels and through the plain versions, one eager
    step in f32 and in bf16 (the kernels' launch counts, loss, peak memory),
    and a graphed chunk of 10 steps (4 held to the eager steps; graph_case,
    f32 and bf16). Returns (launches of the eager f32 step, per replayed step)."""
    from ddp_tpu_torch.config import build_model
    from ddp_tpu_torch.train.optim import make_optimizer
    from ddp_tpu_torch.train.step import TrainState, make_train_step

    model = build_model(cfg.model, device="cuda", seed=0)
    opt = make_optimizer(cfg.optim, model)
    state = TrainState(model, opt, torch.Generator(device="cuda").manual_seed(0))
    batch = train_batch(cfg, b)
    grads_check = compare_grads(cfg, model, opt, batch)
    out = {"phase": phase, "preset": cfg.name, "img": [b, *cfg.data.crop_size, 3],
           "kernel_vs_plain": grads_check}
    launches = None
    for mixed in (False, True):
        step = make_train_step(mixed_precision=mixed)
        step(state, batch)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_all_launches()
        t0 = time.perf_counter()
        logs = step(state, batch)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counted = all_launches()
        if counted != PER_STEP:
            raise AssertionError(f"{phase}: launches per step {counted}, want {PER_STEP}")
        loss = logs["loss"].item()
        if not (loss == loss and abs(loss) < float("inf")):
            raise AssertionError(f"{phase}: non-finite loss {loss}")
        launches = launches or counted
        out["bf16" if mixed else "f32"] = {
            "eager_step_s": sec, "img_per_s": b / sec, "loss": loss,
            "launches_per_step": counted,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    del model, opt, state, step
    torch.cuda.empty_cache()
    emit(dict(out, card=smi))
    graphed = graph_case(cfg, False, smi, profile, ns=(10,), b=b)
    torch.cuda.empty_cache()
    graph_case(cfg, True, smi, profile, ns=(10,), b=b)
    torch.cuda.empty_cache()
    return launches, graphed


def phase_msda_train(smi: str):
    """Training with the msda decoder: ade20k_swin_t_msda at 2 x 512^2
    through train_paths."""
    from ddp_tpu_torch.config import get_config

    return train_paths(get_config("ade20k_swin_t_msda"), 2, "msda_train", smi)


# --- the Cityscapes ConvNeXt segmentor -------------------------------------------

CITY_DIR = os.path.join("work_dirs", "chip_smoke_city")
# the reference's released Cityscapes checkpoints hold an 8-head msda decoder;
# the presets (window decoder) take it by these overrides
CITY_MSDA = {"model.decoder_attn": "msda", "model.decoder_heads": "8"}


def city_serve_case(model, cfg, img, mode: str, label: str, smi: str,
                    profile: str = None) -> dict:
    """One 1024 x 2048 image through ``model``: ``sample`` whole, or
    ``slide_inference`` of ``sample`` over 1024^2 crops at stride 768 (3
    crops). The kernel path against the plain path (the main phase's
    limits; the same generator seed, so the same noise), encode_map
    launches (3 per crop), wall ms, img/s, the busy share and peak memory."""
    from ddp_tpu_torch.evaluation.slide import slide_grid, slide_inference

    m = cfg.model
    crop, stride = (1024, 1024), (768, 768)
    crops = len(slide_grid(img.shape[1], img.shape[2], crop, stride)) if mode == "slide" else 1

    def run():
        gen = torch.Generator(device="cuda").manual_seed(5)
        if mode == "whole":
            return model.sample(img, generator=gen)
        return slide_inference(lambda x: model.sample(x, generator=gen), img, m.num_classes,
                               crop, stride)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    probs = run()
    torch.cuda.synchronize()
    launches = all_launches()
    peak = torch.cuda.max_memory_allocated() / 1e9
    want = m.diffusion.timesteps * crops
    if launches != {**dict.fromkeys(launches, 0), "encode_map": want}:
        raise AssertionError(f"{cfg.name} {mode}: launches {launches}, want {want} encode_map")
    check_probs(probs, (*img.shape[:3], m.num_classes))
    with plain_kernels():
        plain = run()
    diff, agree = compare_probs(probs, plain)
    del plain, probs
    if not (diff <= 1e-4 and agree >= 0.999):
        raise AssertionError(f"{cfg.name} {mode}: kernel vs plain path: prob diff {diff}, "
                             f"agreement {agree}")
    sec = wall_s(run, reps=3)
    busy_line, card_launches = profile_call(
        run, profile and f"{profile}.{cfg.name}_{label}_{mode}",
        f"# one {mode} 1024x2048 call of {cfg.name} ({label} decoder), {smi}\n")
    return {"mode": mode, "crops": crops, "launches": launches,
            "launches_run_by_card": card_launches, "max_abs_prob_diff_vs_plain": diff,
            "argmax_agreement_vs_plain": agree, "wall_ms": sec * 1e3,
            "img_per_s": img.shape[0] / sec, **busy_line, "peak_mem_gb": peak}


def phase_city_main(smi: str, profile: str = None):
    """Serving the Cityscapes ConvNeXt segmentor on one 1024 x 2048 image,
    whole and slide: cityscapes_convnext_t with the msda overrides, its
    weights seeded random tensors under mmseg's and mmcls's names written to a
    .pth and loaded by load_mmseg_checkpoint (the report must be empty), and
    the preset's own window model (random weights, seed 0)."""
    import shutil

    from ddp_tpu_torch.config import build_model, get_config
    from ddp_tpu_torch.train.torch_import import load_mmseg_checkpoint, synthetic_mmseg_state

    cfg = get_config("cityscapes_convnext_t", CITY_MSDA)
    os.makedirs(CITY_DIR, exist_ok=True)
    path = os.path.join(CITY_DIR, "mmseg_random.pth")
    state = synthetic_mmseg_state(cfg.model, seed=0, gn="gn")
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in state.items()}}, path)
    t0 = time.perf_counter()
    model, report = load_mmseg_checkpoint(path, cfg, device="cuda")
    load_s = time.perf_counter() - t0
    shutil.rmtree(CITY_DIR, ignore_errors=True)
    if report["missing"] or report["unused"]:
        raise AssertionError(f"city import report not empty: {report}")
    img = torch.randn(1, 1024, 2048, 3, generator=_gen(41)).cuda()
    out = {"phase": "city_main", "img": list(img.shape), "dtype": "float32, tf32 off",
           "msda_import": {"preset": cfg.name, "overrides": CITY_MSDA, "import_report": report,
                           "tensors": len(state),
                           "values_m": sum(v.size for v in state.values()) / 1e6,
                           "load_s": load_s}}
    launches = {}
    for label, c in (("msda", cfg), ("window", get_config("cityscapes_convnext_t"))):
        if model is None:
            model = build_model(c.model, device="cuda", seed=0, input_size=c.data.crop_size)
        out[label] = {"preset": c.name, "decoder": f"{c.model.decoder_attn}, "
                                                  f"{c.model.decoder_heads} heads"}
        for mode in ("whole", "slide"):
            case = city_serve_case(model, c, img, mode, label, smi, profile)
            out[label][mode] = case
            launches[f"{label}_{mode}"] = case["launches"]
        model = None
        torch.cuda.empty_cache()
    emit(dict(out, card=smi))
    return launches


def phase_city_train(smi: str, profile: str = None):
    """Training the Cityscapes ConvNeXt segmentor: cityscapes_convnext_t at
    4 x 512 x 1024, the reference's per-GPU batch, through train_paths."""
    from ddp_tpu_torch.config import get_config

    return train_paths(get_config("cityscapes_convnext_t"), 4, "city_train", smi, profile)


def write_png(path: str, img) -> None:
    """A PNG of ``img`` ([H, W] uint8 or uint16 grey, or [H, W, 3] uint8 RGB)
    from the standard library's zlib, its rows filtered None, Sub, Up,
    Average and Paeth in turn, as an adaptive encoder mixes them."""
    import struct
    import zlib

    import numpy as np

    h, w = img.shape[:2]
    depth = 16 if img.dtype == np.uint16 else 8
    if depth == 16:  # big-endian samples, filtered byte by byte over 2-byte pixels
        img = img.astype(">u2").view(np.uint8).reshape(h, w, 2)
    bpp = 1 if img.ndim == 2 else img.shape[2]
    rows = img.reshape(h, w * bpp).astype(np.int32)
    prev = np.zeros(w * bpp, np.int32)
    out = []
    for r in range(h):
        cur, kind = rows[r], r % 5
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        p = left + prev - ul
        pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, ul))
        pred = (0, left, prev, (left + prev) >> 1, paeth)[kind]
        out.append(bytes([kind]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes())
        prev = cur

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    header = struct.pack(">IIBBBBB", w, h, depth, 2 if bpp == 3 else 0, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
                + chunk(b"IDAT", zlib.compress(b"".join(out), 6)) + chunk(b"IEND", b""))


# make_train_iter batches of a preset with overrides (a JSON object), timed
# in a process of its own (its prefetch thread ends with it); "PIL" blocked
# makes it read_png's
_BATCH_TIMER = """
import json, sys, time
if sys.argv[3] == "no_pillow":
    sys.modules["PIL"] = None
from ddp_tpu_torch.config import get_config
from ddp_tpu_torch.data import make_train_iter
cfg = get_config(sys.argv[1], json.loads(sys.argv[2]))
it = make_train_iter(cfg)
times = []
for _ in range(int(sys.argv[4])):
    t0 = time.perf_counter()
    batch = next(it)
    times.append(time.perf_counter() - t0)
print(json.dumps({"batch_s": times, "image": list(batch["image"].shape)}))
"""


def city_decode(root: str) -> dict:
    """The host's part of a Cityscapes train step: one 1024 x 2048 RGB image
    and one label map, written with zlib, decoded by read_png and by Pillow
    (where installed; read_image's choice) and held bitwise to each other;
    then make_train_iter batches of cityscapes_convnext_t (16 crops of 512 x
    1024) from four such pairs, through read_image (two batches) and with
    Pillow blocked, through read_png (one batch)."""
    import importlib.util
    import shutil

    import numpy as np

    from ddp_tpu_torch.data.image_io import read_png

    tree = os.path.join(root, CITY_DIR, "city_tree")
    img_dir = os.path.join(tree, "leftImg8bit", "train", "synth")
    ann_dir = os.path.join(tree, "gtFine", "train", "synth")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(ann_dir, exist_ok=True)
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:1024, 0:2048].astype(np.float32)
    smooth = np.stack([128 + 60 * np.sin(xx / 97 + c) * np.cos(yy / 61 - c) for c in range(3)], -1)
    img = (smooth + rng.normal(0, 6, smooth.shape)).clip(0, 255).astype(np.uint8)
    label = ((xx // 128 + 3 * (yy // 96)) % 34).astype(np.uint8)  # labelIds 0..33
    rgb_path, lab_path = os.path.join(img_dir, "a_leftImg8bit.png"), os.path.join(
        ann_dir, "a_gtFine_labelIds.png")
    write_png(rgb_path, img)
    write_png(lab_path, label)
    for i in range(1, 4):
        shutil.copy(rgb_path, os.path.join(img_dir, f"{'abcd'[i]}_leftImg8bit.png"))
        shutil.copy(lab_path, os.path.join(ann_dir, f"{'abcd'[i]}_gtFine_labelIds.png"))
    got_rgb, got_lab = read_png(rgb_path, rgb=True), read_png(lab_path)
    if not (np.array_equal(got_rgb, img) and np.array_equal(got_lab, label)):
        raise AssertionError("city_data: read_png does not give the pixels written")
    out = {"image": [1024, 2048], "filters": "None/Sub/Up/Average/Paeth by row",
           "read_png_rgb_ms": _host_ms(lambda: read_png(rgb_path, rgb=True), 2),
           "read_png_label_ms": _host_ms(lambda: read_png(lab_path), 2)}
    pillow = importlib.util.find_spec("PIL") is not None
    out["pillow_installed"] = pillow
    if pillow:
        from PIL import Image

        def pil(path, rgb):
            with Image.open(path) as im:
                return np.asarray(im.convert("RGB") if rgb else im)

        if not (np.array_equal(pil(rgb_path, True), got_rgb)
                and np.array_equal(pil(lab_path, False), got_lab)):
            raise AssertionError("city_data: read_png differs from Pillow")
        out["pillow_rgb_ms"] = _host_ms(lambda: pil(rgb_path, True), 5)
        out["pillow_label_ms"] = _host_ms(lambda: pil(lab_path, False), 5)

    over = {"data.data_root": tree}
    out["make_train_iter"] = {
        "preset": "cityscapes_convnext_t",
        "read_image": batch_times(root, "cityscapes_convnext_t", over, "read_image", 2),
        "read_png_no_pillow": batch_times(root, "cityscapes_convnext_t", over, "no_pillow", 1)}
    shutil.rmtree(tree, ignore_errors=True)
    return out


def batch_times(root: str, preset: str, overrides: dict, mode: str, n: int) -> dict:
    """Seconds of each of the first n make_train_iter batches of ``preset``
    with ``overrides``, in a process of its own; mode "no_pillow" blocks
    Pillow's import there, so that PNGs go through read_png."""
    proc = subprocess.run([sys.executable, "-c", _BATCH_TIMER, preset, json.dumps(overrides),
                           mode, str(n)], cwd=root, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"batch timer ({preset}, {mode}): exit {proc.returncode}\n"
                             f"{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _host_ms(fn, reps: int) -> float:
    """Median host ms of ``fn`` over ``reps`` calls."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_city_data(smi: str):
    """The entry points on real-format data (``run_cli``): ``python -m
    ddp_tpu_torch.tools.train smoke`` on tests/data/cityscapes (20
    iterations, 10 per dispatch), then ``python -m ddp_tpu_torch.tools.test``
    on its workdir in whole and slide modes (a 32 x 64 crop of the 48 x 96
    images); each must exit 0 and print its mIoU line. An ADE20K JPEG must
    raise the named ImportError where Pillow is missing (its import is
    blocked for that check, since the card has it). The decoders' and the
    train iterator's host times at the Cityscapes size are host_data's."""
    import importlib.util
    import shutil

    from ddp_tpu_torch.data.image_io import read_image
    from ddp_tpu_torch.data.seg_datasets import SegDataset

    root = os.path.dirname(os.path.abspath(__file__))
    workdir = os.path.join(root, CITY_DIR, "smoke")
    shutil.rmtree(workdir, ignore_errors=True)
    sets = ["data.dataset=cityscapes",
            f"data.data_root={os.path.join(root, 'tests', 'data', 'cityscapes')}",
            "model.num_classes=19"]
    line = re.compile(r"\[seed 0\] aAcc [\d.]+ \| mIoU [\d.]+ \| mAcc [\d.]+")
    _, train_s = run_cli("ddp_tpu_torch.tools.train", [
        "smoke", "--workdir", workdir, "--set", *sets, "runtime.total_iters=20",
        "runtime.steps_per_dispatch=10", "runtime.log_interval=10", "runtime.ckpt_interval=20",
        "optim.total_steps=20"])
    logs = _log_steps(workdir)
    out = {"phase": "city_data", "train": {"wall_s": train_s,
                                           "log_steps": [r["step"] for r in logs],
                                           "loss": [r["loss"] for r in logs]}}
    if [r["step"] for r in logs] != [1, 10, 20] or not all(
            r["loss"] == r["loss"] and abs(r["loss"]) < float("inf") for r in logs):
        raise AssertionError(f"city_data train: logs {logs}")
    for mode, extra in (("whole", []), ("slide", ["runtime.test_mode=slide",
                                                  "runtime.test_crop=(32,64)",
                                                  "runtime.test_stride=(16,32)"])):
        text, sec = run_cli("ddp_tpu_torch.tools.test", ["smoke", "--workdir", workdir,
                                                         "--set", *sets, *extra])
        if "restored step 20" not in text or not line.search(text):
            raise AssertionError(f"city_data test {mode}: output {text!r}")
        out[f"test_{mode}"] = {"wall_s": sec, "lines": text.strip().splitlines()}
    # an ADE20K JPEG: read through Pillow where it is installed; without it
    # (here made absent by blocking its import) the named ImportError
    jpg = os.path.join(root, "tests", "data", "ade", "images", "training", "ADE_train_0.jpg")
    pillow = importlib.util.find_spec("PIL") is not None
    out["ade_jpeg"] = {"pillow_installed": pillow}
    if pillow:
        out["ade_jpeg"]["decoded_by_pillow"] = list(read_image(jpg, rgb=True).shape)
    saved = {k: sys.modules.pop(k) for k in list(sys.modules) if k.split(".")[0] == "PIL"}
    sys.modules["PIL"] = None  # import PIL now raises ImportError
    errors = []
    try:
        for name, fn in (("read_image", lambda: read_image(jpg, rgb=True)),
                         ("SegDataset.load", lambda: SegDataset(os.path.join(
                             root, "tests", "data", "ade"), "train", "ade20k").load(0))):
            try:
                fn()
            except ImportError as e:
                if "no JPEG decoder" not in str(e):
                    raise
                errors.append(f"{name}: {e}")
            else:
                raise AssertionError(f"city_data: {name} read a JPEG without Pillow")
    finally:
        del sys.modules["PIL"]
        sys.modules.update(saved)
    out["ade_jpeg"]["without_pillow_raises"] = errors
    shutil.rmtree(CITY_DIR, ignore_errors=True)
    emit(dict(out, card=smi))


def converge_case(preset: str, smi: str):
    """``preset`` through ``run`` (train() and eval_seg) beside the JAX
    package's result for it (work_dirs/<preset>/result.json)."""
    from ddp_tpu_torch.config import get_config
    from ddp_tpu_torch.evaluation.convergence import run

    ref_dir = os.path.join("work_dirs", preset)
    with open(os.path.join(ref_dir, "result.json")) as f:
        ref = json.load(f)
    # the JAX run's last logged loss, where it kept its train log
    has_log = os.path.exists(os.path.join(ref_dir, "train_log.jsonl"))
    ref_loss = _log_steps(ref_dir)[-1] if has_log else {"loss": None, "step": None}
    t0 = time.perf_counter()
    result = run(preset)
    wall = time.perf_counter() - t0
    own = _log_steps(get_config(preset).runtime.workdir)
    miou = {f"{t}step": {"port": result[f"mIoU@{t}step"], "jax": ref[f"mIoU@{t}step"],
                         "diff": result[f"mIoU@{t}step"] - ref[f"mIoU@{t}step"],
                         "port_std": result[f"mIoU@{t}step_std"],
                         "jax_std": ref[f"mIoU@{t}step_std"]} for t in (1, 3, 10)}
    emit({"phase": "converge", "preset": preset, "iters": result["total_iters"],
          "mIoU": miou, "within_0.01_of_jax": all(abs(v["diff"]) <= 0.01 for v in miou.values()),
          "loss_last_logged": {"port": own[-1]["loss"], "jax": ref_loss["loss"],
                               "steps": [own[-1]["step"], ref_loss["step"]]},
          "steps_per_s_logged": [r["steps_per_s"] for r in own], "wall_s": wall, "card": smi})
    if own[-1]["step"] != result["total_iters"] or not result["mIoU@3step"] >= 0.5:
        raise AssertionError(f"converge {preset}: did not learn ({result})")


def phase_converge_msda(smi: str):
    """The msda end checks: converge_seg_msda's 1500 iterations, then
    converge_seg_aligned_msda's 300 from its checkpoint."""
    converge_case("converge_seg_msda", smi)
    converge_case("converge_seg_aligned_msda", smi)


def phase_converge(smi: str):
    """The end check: converge_seg_window trained for its 1500 iterations
    through train() and scored by eval_seg, beside the JAX package's result
    (work_dirs/converge_seg_window)."""
    converge_case("converge_seg_window", smi)


# --- the depther ---------------------------------------------------------------

DEPTH_DIR = os.path.join("work_dirs", "chip_smoke_depth")
# the depth paths run none of the port's kernels
NO_KERNELS = dict.fromkeys(PER_STEP, 0)


def depth_train_batch(cfg, b: int, device="cuda"):
    """b procedural depth maps at cfg's crop (SyntheticDepthDataset, smooth
    fields of 0.9 to 9 m) and their images, normalised, with a band of
    invalid (0) depth at the top."""
    import numpy as np

    from ddp_tpu_torch.data.depth_datasets import SyntheticDepthDataset

    ds = SyntheticDepthDataset(cfg.data.crop_size, length=b, max_depth=cfg.model.max_depth)
    items = [ds.load(i) for i in range(b)]
    mean, std = np.asarray(cfg.data.mean, np.float32), np.asarray(cfg.data.std, np.float32)
    img = np.stack([(it["image"] - mean) / std for it in items]).astype(np.float32)
    depth = np.stack([it["label"] for it in items]).astype(np.float32)
    depth[:, : depth.shape[1] // 16] = 0.0
    return {"image": torch.from_numpy(img).to(device), "label": torch.from_numpy(depth).to(device)}


def check_depth(d: torch.Tensor, shape, mc, what: str) -> None:
    """Depth of ``shape``, finite, inside [mc.min_depth, mc.max_depth]."""
    if tuple(d.shape) != tuple(shape):
        raise AssertionError(f"{what}: depth shape {tuple(d.shape)} != {tuple(shape)}")
    if not torch.isfinite(d).all():
        raise AssertionError(f"{what}: non-finite depth")
    lo, hi = d.min().item(), d.max().item()
    if not (mc.min_depth <= lo and hi <= mc.max_depth):
        raise AssertionError(f"{what}: depth outside [{mc.min_depth}, {mc.max_depth}]: "
                             f"{lo}..{hi}")


def phase_depth_reference(smi: str):
    """A small depther (converge_depth: nano Swin, 64-d msda decoder of 6
    layers; its deform head and the upconv head, 2 randsteps hypotheses) on
    the card and on the CPU from the same weights: the training loss with
    fixed t and noise (drop path off) within 1e-5 relative, and sample()
    from the same initial noise within 1e-4 m."""
    import dataclasses

    from ddp_tpu_torch.config import build_model, get_config

    base = get_config("converge_depth").model
    g = _gen(41)
    b, (h, w) = 2, (64, 64)
    img = torch.randn(b, h, w, 3, generator=g)
    depth = 0.5 + 9.0 * torch.rand(b, h, w, generator=g)
    depth[0, :6] = 0.0
    t = torch.rand(b, generator=g) * 0.999
    noise = torch.randn(b, h // 4, w // 4, 1, generator=g)
    out = {"phase": "depth_reference", "preset": "converge_depth", "img": [b, h, w, 3]}
    for variant in ("deform", "upconv"):
        mc = dataclasses.replace(base, depth_head_variant=variant, diffusion=dataclasses.replace(
            base.diffusion, randsteps=2))
        init = torch.randn(2 * b, h // 4, w // 4, 1, generator=g)
        res = {}
        for dev in ("cpu", "cuda"):
            model = build_model(mc, device=dev, seed=0).train()
            loss, _ = model(img.to(dev), depth.to(dev), t=t.to(dev), noise=noise.to(dev))
            d = model.eval().sample(img.to(dev), noise=init.to(dev))
            check_depth(d, (b, h, w), mc, f"depth_reference {variant} {dev}")
            res[dev] = (loss.item(), d.cpu())
        rel = abs(res["cuda"][0] - res["cpu"][0]) / abs(res["cpu"][0])
        diff = (res["cuda"][1] - res["cpu"][1]).abs().max().item()
        out[variant] = {"loss_card": res["cuda"][0], "loss_cpu": res["cpu"][0],
                        "loss_rel_diff": rel, "sample_max_abs_diff_m": diff}
        if not (rel <= 1e-5 and diff <= 1e-4):
            emit(dict(out, card=smi))
            raise AssertionError(f"depth_reference {variant}: card vs CPU loss rel {rel}, "
                                 f"depth diff {diff} m")
    emit(dict(out, limits="loss 1e-5 relative, depth 1e-4 m", card=smi))


def depth_serve_case(model, img, noise, smi: str, label: str) -> dict:
    """``model.sample`` of ``img`` from ``noise``: the kernels launched (the
    wrappers' counts, from 0), the depth checked, wall ms, img/s, the busy
    share (profiled, and the profiled device ms over the unprofiled wall
    ms: the profiler's host cost slows an eager call), peak memory (with
    what was live before: the weights and what earlier phases hold), and
    the wall ms of one ``sample`` of 4 copies of the frame (a host-bound
    call gains img/s with the batch)."""
    reset_all_launches()
    d = model.sample(img, noise=noise)
    torch.cuda.synchronize()
    launches = all_launches()
    if launches != NO_KERNELS:
        raise AssertionError(f"{label}: kernels launched on the depth path: {launches}")
    check_depth(d, img.shape[:3], model, label)
    torch.cuda.reset_peak_memory_stats()
    live = torch.cuda.memory_allocated() / 1e9
    sec = wall_s(lambda: model.sample(img, noise=noise))
    peak = torch.cuda.max_memory_allocated() / 1e9
    busy_line, card_launches = profile_call(lambda: model.sample(img, noise=noise))
    if card_launches != NO_KERNELS:
        raise AssertionError(f"{label}: the card ran {card_launches}")
    img4, noise4 = img.repeat(4, 1, 1, 1), noise.repeat(4, 1, 1, 1)
    check_depth(model.sample(img4, noise=noise4), img4.shape[:3], model, label + " batch 4")
    sec4 = wall_s(lambda: model.sample(img4, noise=noise4))
    return {"img": list(img.shape), "sample_ms": sec * 1e3, "img_per_s": img.shape[0] / sec,
            **busy_line, "busy_share_unprofiled": busy_line["device_busy_ms"] / (sec * 1e3),
            "live_before_gb": live, "peak_mem_gb": peak,
            "batch4": {"sample_ms": sec4 * 1e3, "img_per_s": 4 / sec4},
            "depth_range_m": [d.min().item(), d.max().item()], "launches": launches}


def phase_depth_main(smi: str):
    """Serving nyu_swin_t at full width and depth (random weights, seed 0) on
    one random 480 x 640 NYU frame: a 120 x 160 latent grid (19,200 msda
    queries), 3 DDIM steps; sample_with_uncertainty once with 5 randsteps;
    then kitti_swin_t on one 352 x 1216 KB-cropped frame (88 x 304 grid)."""
    import dataclasses

    from ddp_tpu_torch.config import build_model, get_config

    cfg = get_config("nyu_swin_t")
    mc = cfg.model
    model = build_model(mc, device="cuda", seed=0)
    g = _gen(43)
    img = torch.randn(1, 480, 640, 3, generator=g).cuda()
    noise = torch.randn(1, 120, 160, 1, generator=g).cuda()
    out = {"phase": "depth_main", "preset": cfg.name, "msda_queries": 120 * 160,
           "timesteps": mc.diffusion.timesteps, "dtype": "float32, tf32 off",
           "nyu": depth_serve_case(model, img, noise, smi, "depth_main nyu")}
    launches = out["nyu"]["launches"]
    with torch.no_grad():
        feat = model.extract_feat(img)
        tb = torch.ones(1, device=img.device)
        out["nyu"]["extract_feat_ms"] = wall_s(lambda: model.extract_feat(img)) * 1e3
        out["nyu"]["denoise_step_ms"] = wall_s(lambda: model.denoise_depth(feat, noise, tb)) * 1e3
    del feat
    model.diffusion = dataclasses.replace(mc.diffusion, randsteps=5)
    unc_noise = torch.randn(5, 120, 160, 1, generator=g).cuda()
    t0 = time.perf_counter()
    d, unc = model.sample_with_uncertainty(img, noise=unc_noise)
    torch.cuda.synchronize()
    unc_s = time.perf_counter() - t0
    check_depth(d, (1, 480, 640), mc, "depth_main uncertainty")
    width = unc["interval_high"] - unc["interval_low"]
    if not (torch.isfinite(unc["std"]).all() and (unc["std"] >= 0).all()
            and (width >= 0).all()):
        raise AssertionError("depth_main: invalid uncertainty maps")
    out["uncertainty"] = {"randsteps": 5, "wall_ms": unc_s * 1e3,
                          "mean_std_m": unc["std"].mean().item(),
                          "mean_interval_width_m": width.mean().item()}
    del model, d, unc
    torch.cuda.empty_cache()
    kcfg = get_config("kitti_swin_t")
    kitti = build_model(kcfg.model, device="cuda", seed=0)
    kimg = torch.randn(1, 352, 1216, 3, generator=g).cuda()
    knoise = torch.randn(1, 88, 304, 1, generator=g).cuda()
    out["kitti"] = dict(depth_serve_case(kitti, kimg, knoise, smi, "depth_main kitti"),
                        preset=kcfg.name, msda_queries=88 * 304)
    del kitti
    torch.cuda.empty_cache()
    emit(dict(out, card=smi))
    return launches


def phase_depth_train(smi: str, profile: str = None):
    """Training nyu_swin_t at 2 x 416 x 544 (the reference's per-GPU batch
    of bs2x8) on procedural depth maps: the eager step and graphed chunks of
    1 and 10 steps, f32 and bf16, through graph_case (held to the eager
    steps with deterministic algorithms on); the eager step's kernel
    launches (none) by the wrappers' counts."""
    from ddp_tpu_torch.config import build_model, get_config
    from ddp_tpu_torch.train.optim import make_optimizer
    from ddp_tpu_torch.train.step import TrainState, make_train_step

    cfg = get_config("nyu_swin_t")
    batch = depth_train_batch(cfg, 2)
    model = build_model(cfg.model, device="cuda", seed=0)
    state = TrainState(model, make_optimizer(cfg.optim, model),
                       torch.Generator(device="cuda").manual_seed(0))
    step = make_train_step()
    step(state, batch)
    reset_all_launches()
    logs = step(state, batch)
    torch.cuda.synchronize()
    eager = all_launches()
    loss = logs["loss"].item()
    if eager != NO_KERNELS or not (0 < loss < float("inf")):
        raise AssertionError(f"depth_train: launches {eager}, loss {loss}")
    del model, state, step
    torch.cuda.empty_cache()
    graphed = graph_case(cfg, False, smi, profile, batch=batch, per_step=NO_KERNELS)
    torch.cuda.empty_cache()
    graph_case(cfg, True, smi, profile, batch=batch, per_step=NO_KERNELS)
    torch.cuda.empty_cache()
    return eager, graphed


def nyu_tree(root: str) -> str:
    """An NYU-layout tree of full-size frames (480 x 640 RGB and 16-bit depth
    in millimetres, PNGs from write_png; 4 train and 2 test frames) under
    DEPTH_DIR, frame 0 read back bitwise by read_png; its path."""
    import numpy as np

    from ddp_tpu_torch.data.image_io import read_png

    tree = os.path.join(root, DEPTH_DIR, "nyu")
    shutil.rmtree(os.path.join(root, DEPTH_DIR), ignore_errors=True)
    os.makedirs(os.path.join(tree, "image"))
    os.makedirs(os.path.join(tree, "depth"))
    rng = np.random.default_rng(9)
    yy, xx = np.mgrid[0:480, 0:640].astype(np.float32)
    names, written = [], []
    for i in range(6):
        field = 0.5 + 0.4 * np.sin(xx / (40 + 9 * i) + i) * np.cos(yy / (31 + 5 * i) - i)
        img = np.stack([field * 200 + 20, np.roll(field, 7, 0) * 200 + 20,
                        np.roll(field, 7, 1) * 200 + 20], -1)
        img = (img + rng.normal(0, 4, img.shape)).clip(0, 255).astype(np.uint8)
        depth = ((0.5 + field * 9.0) * 1000).astype(np.uint16)
        depth[rng.random(depth.shape) < 0.05] = 0  # missing returns
        write_png(os.path.join(tree, "image", f"{i}.png"), img)
        write_png(os.path.join(tree, "depth", f"{i}.png"), depth)
        written.append((img, depth))
        names.append(f"image/{i}.png depth/{i}.png 518.8579\n")
    with open(os.path.join(tree, "nyu_train.txt"), "w") as f:
        f.writelines(names[:4])
    with open(os.path.join(tree, "nyu_test.txt"), "w") as f:
        f.writelines(names[4:])
    rgb0, dep0 = os.path.join(tree, "image", "0.png"), os.path.join(tree, "depth", "0.png")
    got_rgb, got_dep = read_png(rgb0, rgb=True), read_png(dep0)
    if not (np.array_equal(got_rgb, written[0][0]) and got_dep.dtype == np.uint16
            and np.array_equal(got_dep, written[0][1])):
        raise AssertionError("depth_data: read_png does not give the pixels written")
    return tree


def depth_decode(root: str, tree: str) -> dict:
    """The host's part of a depth train step: nyu_tree's frame 0 and its
    depth map decoded by read_png and by Pillow (where installed; held
    bitwise to each other), and make_train_iter batches of converge_depth
    (16 crops of 416 x 544) with and without Pillow."""
    import importlib.util

    import numpy as np

    from ddp_tpu_torch.data.image_io import read_png

    rgb0, dep0 = os.path.join(tree, "image", "0.png"), os.path.join(tree, "depth", "0.png")
    got_rgb, got_dep = read_png(rgb0, rgb=True), read_png(dep0)
    dec = {"frame": [480, 640], "read_png_rgb_ms": _host_ms(lambda: read_png(rgb0, rgb=True), 3),
           "read_png_depth16_ms": _host_ms(lambda: read_png(dep0), 3)}
    dec["pillow_installed"] = importlib.util.find_spec("PIL") is not None
    if dec["pillow_installed"]:
        from PIL import Image

        def pil(path, rgb):
            with Image.open(path) as im:
                return np.asarray(im.convert("RGB") if rgb else im)

        if not (np.array_equal(pil(rgb0, True), got_rgb)
                and np.array_equal(pil(dep0, False), got_dep)):
            raise AssertionError("host_data: read_png differs from Pillow")
        dec["pillow_rgb_ms"] = _host_ms(lambda: pil(rgb0, True), 5)
        dec["pillow_depth16_ms"] = _host_ms(lambda: pil(dep0, False), 5)
    over = {"data.dataset": "nyu", "data.data_root": tree, "data.crop_size": "(416,544)"}
    dec["make_train_iter"] = {
        "preset": "converge_depth, batch 16 of 416x544 crops",
        "read_image": batch_times(root, "converge_depth", over, "read_image", 2),
        "read_png_no_pillow": batch_times(root, "converge_depth", over, "no_pillow", 1)}
    return dec


def phase_depth_data(smi: str):
    """The depth entry points on real-format files (nyu_tree; run_cli): python -m
    ddp_tpu_torch.tools.train converge_depth on it for 20 iterations at
    416 x 544 crops, batch 16, then python -m ddp_tpu_torch.tools.test on its
    workdir: each must exit 0 and print its metric line. The host's decode
    and batch times are host_data's."""
    root = os.path.dirname(os.path.abspath(__file__))
    tree = nyu_tree(root)
    workdir = os.path.join(root, DEPTH_DIR, "train")
    sets = ["data.dataset=nyu", f"data.data_root={tree}"]
    _, train_s = run_cli("ddp_tpu_torch.tools.train", [
        "converge_depth", "--workdir", workdir, "--set", *sets, "data.crop_size=(416,544)",
        "runtime.total_iters=20", "runtime.steps_per_dispatch=10", "runtime.log_interval=10",
        "runtime.ckpt_interval=20", "optim.total_steps=20"])
    logs = _log_steps(workdir)
    out = {"phase": "depth_data", "tree": "nyu layout, 480x640 PNG frames, 4 train 2 test",
           "train": {"wall_s": train_s, "log_steps": [r["step"] for r in logs],
                     "loss": [r["loss"] for r in logs]}}
    if [r["step"] for r in logs] != [1, 10, 20] or not all(
            0 < r["loss"] < float("inf") for r in logs):
        raise AssertionError(f"depth_data train: logs {logs}")
    line = re.compile(r"a1 [\d.]+ \| a2 [\d.]+ \| a3 [\d.]+ \| abs_rel [\d.]+ .*\(n=2\)")
    text, test_s = run_cli("ddp_tpu_torch.tools.test", [
        "converge_depth", "--workdir", workdir, "--uncertainty", "--set", *sets,
        "model.diffusion.randsteps=2"])
    if "restored step 20" not in text or not line.search(text) or "hypothesis std" not in text:
        raise AssertionError(f"depth_data test: output {text!r}")
    out["test"] = {"wall_s": test_s, "lines": text.strip().splitlines()}
    shutil.rmtree(os.path.join(root, DEPTH_DIR), ignore_errors=True)
    emit(dict(out, card=smi))


def phase_host_data(smi: str):
    """The host's decode and batch times at full size (city_data's and
    depth_data's until they moved here, to keep the default run's time):
    city_decode (a 1024 x 2048 Cityscapes image and label map; batches of
    16 crops of cityscapes_convnext_t) and depth_decode (a 480 x 640 NYU
    frame and depth map; batches of 16 crops of converge_depth), each with
    and without Pillow."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    out = {"phase": "host_data", "city": city_decode(root)}
    shutil.rmtree(os.path.join(root, CITY_DIR), ignore_errors=True)
    out["depth"] = depth_decode(root, nyu_tree(root))
    shutil.rmtree(os.path.join(root, DEPTH_DIR), ignore_errors=True)
    emit(dict(out, wall_s=time.perf_counter() - t0, card=smi))


def phase_converge_depth(smi: str):
    """The depth end check: converge_depth's 1500 iterations through train()
    and eval_depth's abs_rel, rmse and a1 at 1, 3 and 10 DDIM steps beside
    the JAX package's work_dirs/converge_depth/result.json. The targets
    (abs_rel within 0.005 and rmse within 0.03 m of JAX at every horizon,
    a1@3 >= 0.99) are reported, not enforced; the phase fails only on a
    run that did not learn (a1@3 below 0.5)."""
    from ddp_tpu_torch.config import get_config
    from ddp_tpu_torch.evaluation.convergence import run

    ref_dir = os.path.join("work_dirs", "converge_depth")
    with open(os.path.join(ref_dir, "result.json")) as f:
        ref = json.load(f)
    ref_logs = _log_steps(ref_dir)
    t0 = time.perf_counter()
    result = run("converge_depth")
    wall = time.perf_counter() - t0
    own = _log_steps(get_config("converge_depth").runtime.workdir)
    by = {}
    for key, tol in (("abs_rel", 0.005), ("rmse", 0.03), ("a1", None)):
        by[key] = {f"{t}step": {"port": result[f"{key}@{t}step"], "jax": ref[f"{key}@{t}step"],
                                "diff": result[f"{key}@{t}step"] - ref[f"{key}@{t}step"]}
                   for t in (1, 3, 10)}
        if tol is not None:
            by[key]["within_target"] = all(abs(v["diff"]) <= tol for v in by[key].values())
    emit({"phase": "converge_depth", "iters": result["total_iters"], **by,
          "a1@3step_at_least_0.99": result["a1@3step"] >= 0.99,
          "loss_curve": {"port": [[r["step"], r["loss"]] for r in own],
                         "jax": [[r["step"], r["loss"]] for r in ref_logs]},
          "steps_per_s_logged": [r["steps_per_s"] for r in own], "wall_s": wall, "card": smi})
    if own[-1]["step"] != result["total_iters"] or not result["a1@3step"] >= 0.5:
        raise AssertionError(f"converge_depth: did not learn ({result})")


# --- BEV camera map segmentation ----------------------------------------------------

BEV_DIR = os.path.join("work_dirs", "chip_smoke_bev")
# the BEV batch's tensors: the cameras, the rig (5), the map masks
BEV_KEYS = ("image", "cam2lidar_rots", "cam2lidar_trans", "intrins", "post_rots",
            "post_trans", "label")


def bev_scenes(cfg, b: int, seed: int = 0, aug: bool = True, device="cuda"):
    """b scenes of the synthetic rig at cfg's camera count, image size and
    output grid, normalised, as tensors on ``device``: a train batch of
    bev_batch_iterator (with the 3D aug), or (``aug`` False) scenes as the
    end check serves them."""
    import numpy as np

    from ddp_tpu_torch.data.bev_datasets import (BEV_BATCH_KEYS, SyntheticBEVDataset,
                                                 bev_batch_iterator)

    mc = cfg.model
    ds = SyntheticBEVDataset(num_cams=mc.bev_num_cams, image_size=mc.bev_image_size,
                             out_grid=mc.bev_out_grid, num_classes=mc.num_classes,
                             scope=mc.bev_xbound[1], length=max(b, 8))
    if aug:
        batch = next(bev_batch_iterator(ds, b, seed=seed, mean=cfg.data.mean,
                                        std=cfg.data.std))
    else:
        scenes = [ds.load(seed * 1000 + i) for i in range(b)]
        mean, std = np.asarray(cfg.data.mean, np.float32), np.asarray(cfg.data.std, np.float32)
        for sc in scenes:
            sc["image"] = (sc["image"] - mean) / std
        batch = {k: np.stack([sc[k] for sc in scenes]) for k in BEV_BATCH_KEYS}
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def bev_latent_shape(model, batch) -> tuple:
    """(G, C) of the model's BEV features for this rig."""
    with torch.no_grad():
        x = model.extract_bev_feat(*(batch[k][:1] for k in BEV_KEYS[:-1]))
    return x.shape[1], x.shape[3]


def check_scores(s: torch.Tensor, shape, what: str) -> None:
    """Sigmoid scores of ``shape``, finite, inside [0, 1]."""
    if tuple(s.shape) != tuple(shape):
        raise AssertionError(f"{what}: scores shape {tuple(s.shape)} != {tuple(shape)}")
    if not (torch.isfinite(s).all() and s.min() >= 0 and s.max() <= 1):
        raise AssertionError(f"{what}: scores not finite or outside [0, 1]")


def phase_bev_reference(smi: str):
    """smoke_bev (2 cameras of 32 x 64, nano Swin, 32-d msda decoder) on the
    card and on the CPU from the same weights and the same augmented batch:
    the training loss with fixed t and noise within 1e-5 relative, and
    sample()'s scores from the same initial noise within 1e-4."""
    from ddp_tpu_torch.config import build_model, get_config

    cfg = get_config("smoke_bev")
    mc = cfg.model
    batch = bev_scenes(cfg, 2, seed=1, device="cpu")
    g = _gen(51)
    t = torch.rand(2, generator=g) * 0.999
    side, c = bev_latent_shape(build_model(mc, device="cpu", seed=0), batch)
    noise = torch.randn(2, side, side, c, generator=g)
    init = torch.randn(mc.diffusion.randsteps * 2, side, side, c, generator=g)
    res = {}
    for dev in ("cpu", "cuda"):
        model = build_model(mc, device=dev, seed=0).train()
        loss, _ = model(*(batch[k].to(dev) for k in BEV_KEYS), t=t.to(dev), noise=noise.to(dev))
        s = model.eval().sample(*(batch[k].to(dev) for k in BEV_KEYS[:-1]), noise=init.to(dev))
        check_scores(s, (2, mc.bev_out_grid, mc.bev_out_grid, mc.num_classes),
                     f"bev_reference {dev}")
        res[dev] = (loss.item(), s.cpu())
    rel = abs(res["cuda"][0] - res["cpu"][0]) / abs(res["cpu"][0])
    diff = (res["cuda"][1] - res["cpu"][1]).abs().max().item()
    out = {"phase": "bev_reference", "preset": cfg.name, "cameras": [2, 32, 64],
           "loss_card": res["cuda"][0], "loss_cpu": res["cpu"][0], "loss_rel_diff": rel,
           "sample_max_abs_diff": diff, "limits": "loss 1e-5 relative, scores 1e-4", "card": smi}
    emit(out)
    if not (rel <= 1e-5 and diff <= 1e-4):
        raise AssertionError(f"bev_reference: card vs CPU loss rel {rel}, scores diff {diff}")


def bf16_rig_check(model, batch) -> dict:
    """What the bf16 policy's cast of the rig does to the LSS geometry: the
    points of lss_geometry from the rig cast to bf16 (and back to float32, as
    the model does) against the float32 rig's, in metres, and the share of
    points whose voxel (or in-range flag) changes."""
    from ddp_tpu_torch.nn.bev import _frustum_on, lss_geometry
    from ddp_tpu_torch.ops.bev_pool import quantize_geometry

    vt = model.vtransform
    rig = [batch[k] for k in BEV_KEYS[1:-1]]
    frustum = _frustum_on(vt.image_size, vt.feature_size, vt.dbound, rig[0].device)
    with torch.no_grad():
        g32 = lss_geometry(frustum, *rig)
        g16 = lss_geometry(frustum, *(r.to(torch.bfloat16) for r in rig))
        dist = (g16 - g32).norm(dim=-1)
        c32, v32 = quantize_geometry(g32, vt.bx, vt.dx, vt.nx)
        c16, v16 = quantize_geometry(g16, vt.bx, vt.dx, vt.nx)
        moved = (c16 != c32).any(dim=-1) | (v16 != v32)
        in_range = v32 | v16
    return {"points": g32[..., 0].numel(), "max_displacement_m": dist.max().item(),
            "mean_displacement_m": dist.mean().item(),
            "share_of_points_changing_voxel": moved.float().mean().item(),
            "share_of_in_range_points_changing_voxel":
                (moved & in_range).float().sum().item() / max(in_range.sum().item(), 1),
            "rig": f"the train pipeline's augmented rig, batch {rig[0].shape[0]}"}


def phase_bev_main(smi: str, profile: str = None):
    """Serving nuscenes_camera at full width (6 cameras of 256 x 704, Swin-T,
    the LSS lift of 118 depth bins onto a 256^2 grid, the 128^2 BEV latent, 5
    window-decoder layers on the 200^2 output grid, 3 DDIM steps x 5
    randsteps; random weights, seed 0) on one scene of the synthetic 6-camera
    rig: scores in [0, 1], no kernel launched, sample() wall ms (median of
    5), img/s, busy share (profiled, and the profiled device ms over the
    unprofiled wall ms), bev_pool's device ms and share in the profiled call,
    peak memory and what was live before; sample_with_uncertainty's ms; the
    bf16 rig's displacement of the geometry."""
    from ddp_tpu_torch.config import build_model, get_config

    cfg = get_config("nuscenes_camera")
    mc = cfg.model
    model = build_model(mc, device="cuda", seed=0)
    batch = bev_scenes(cfg, 1, seed=3, aug=False)
    rig = [batch[k] for k in BEV_KEYS[:-1]]
    side, c = bev_latent_shape(model, batch)
    r = mc.diffusion.randsteps
    noise = torch.randn(r, side, side, c, generator=_gen(53)).cuda()
    shape = (1, mc.bev_out_grid, mc.bev_out_grid, mc.num_classes)
    reset_all_launches()
    scores = model.sample(*rig, noise=noise)
    torch.cuda.synchronize()
    launches = all_launches()
    if launches != NO_KERNELS:
        raise AssertionError(f"bev_main: kernels launched on the BEV path: {launches}")
    check_scores(scores, shape, "bev_main")
    torch.cuda.reset_peak_memory_stats()
    live = torch.cuda.memory_allocated() / 1e9
    sec = wall_s(lambda: model.sample(*rig, noise=noise))
    peak = torch.cuda.max_memory_allocated() / 1e9
    busy_line, card_launches = profile_call(
        lambda: model.sample(*rig, noise=noise), profile and f"{profile}.bev_sample",
        f"# one nuscenes_camera sample(), 6 x 256x704, {smi}\n")
    if card_launches != NO_KERNELS:
        raise AssertionError(f"bev_main: the card ran {card_launches}")
    if not busy_line.get("bev_pool_device_ms", 0) > 0:
        raise AssertionError("bev_main: no kernel in the bev_pool range")
    with torch.no_grad():
        feat = model.extract_bev_feat(*rig)
        xr, tb = feat.repeat(r, 1, 1, 1), torch.ones(r, device="cuda")
        enc_ms = wall_s(lambda: model.extract_bev_feat(*rig)) * 1e3
        step_ms = wall_s(lambda: model.denoise_logits(xr, noise, tb)) * 1e3
    del feat, xr
    model.sample_with_uncertainty(*rig, noise=noise)
    unc_s = wall_s(lambda: model.sample_with_uncertainty(*rig, noise=noise), reps=1, warmup=0)
    s2, unc = model.sample_with_uncertainty(*rig, noise=noise)
    check_scores(s2, shape, "bev_main uncertainty")
    if not ((unc["variance"] >= 0).all() and torch.isfinite(unc["variance"]).all()):
        raise AssertionError("bev_main: invalid variance map")
    rig_check = bf16_rig_check(model, bev_scenes(cfg, 8, seed=4))
    emit({"phase": "bev_main", "preset": cfg.name, "cameras": [6, 256, 704],
          "bev_latent": [side, side, c], "out_grid": mc.bev_out_grid,
          "decoder": f"{mc.decoder_attn}, {mc.decoder_layers} layers",
          "timesteps": mc.diffusion.timesteps, "randsteps": r, "dtype": "float32, tf32 off",
          "sample_ms": sec * 1e3, "scenes_per_s": 1 / sec,
          "img_per_s": mc.bev_num_cams / sec, "img": "camera images, 6 a scene", **busy_line,
          "busy_share_unprofiled": busy_line["device_busy_ms"] / (sec * 1e3),
          "live_before_gb": live, "peak_mem_gb": peak, "extract_bev_feat_ms": enc_ms,
          "denoise_step_ms": step_ms, "sample_with_uncertainty_ms": unc_s * 1e3,
          "mean_variance": unc["variance"].mean().item(),
          "mean_entropy": unc["entropy"].mean().item(), "launches": launches,
          "bf16_rig": rig_check, "card": smi})
    del model
    torch.cuda.empty_cache()
    return launches


def bev_pool_cost(batch, model) -> dict:
    """bev_pool alone at the train step's shapes (features [B, N·D·fH·fW,
    C'] from the batch's own geometry): forward and forward + backward
    device ms, with PyTorch's deterministic algorithms off (index_add_ sums
    by atomics) and on (a sorted sum)."""
    from ddp_tpu_torch.nn.bev import _frustum_on, lss_geometry
    from ddp_tpu_torch.ops.bev_pool import bev_pool, quantize_geometry

    vt = model.vtransform
    rig = [batch[k] for k in BEV_KEYS[1:-1]]
    with torch.no_grad():
        geom = lss_geometry(_frustum_on(vt.image_size, vt.feature_size, vt.dbound, "cuda"),
                            *rig)
        coords, valid = quantize_geometry(geom, vt.bx, vt.dx, vt.nx)
    b = geom.shape[0]
    p = geom[0, ..., 0].numel()
    coords, valid = coords.reshape(b, p, 3), valid.reshape(b, p)
    del geom
    feats = torch.randn(b, p, vt.out_channels, device="cuda", requires_grad=True)
    cot = torch.randn(b, vt.nx[0], vt.nx[1], vt.nx[2] * vt.out_channels, device="cuda")
    out = {"feats": [b, p, vt.out_channels], "in_range_share": valid.float().mean().item()}
    for det in (False, True):
        reps = 3 if det else 10  # the sorted sum takes ~0.7 s at these shapes
        with deterministic_algorithms(det) as warned:
            fwd = time_ms(lambda: bev_pool(feats, coords, valid, *vt.nx), reps=reps)
            both = time_ms(lambda: torch.autograd.grad(
                bev_pool(feats, coords, valid, *vt.nx), feats, cot), reps=reps)
            a = bev_pool(feats.detach(), coords, valid, *vt.nx)
            again = torch.equal(a, bev_pool(feats.detach(), coords, valid, *vt.nx))
        out["deterministic" if det else "atomic"] = {
            "forward_ms": fwd, "forward_backward_ms": both, "bitwise_repeatable": again,
            "warnings": warned}
    del feats, cot
    torch.cuda.empty_cache()
    return out


def fit_batch(cfg, want: int, scenes=None, keys=BEV_KEYS, phase: str = "bev_train"):
    """The largest of want, want/2, ... scenes whose eager f32 step fits on
    the card: (b, batch on the device, the errors of the batches that did
    not fit, with the peak memory each reached). ``scenes(cfg, b)``: the
    batch maker (default ``bev_scenes`` with the aug)."""
    from ddp_tpu_torch.config import build_model
    from ddp_tpu_torch.train.optim import make_optimizer
    from ddp_tpu_torch.train.step import TrainState, make_train_step

    scenes = scenes or (lambda cfg, b: bev_scenes(cfg, b, seed=6))
    b, misses = want, []
    while b >= 1:
        batch = scenes(cfg, b)
        model = build_model(cfg.model, device="cuda", seed=0)
        state = TrainState(model, make_optimizer(cfg.optim, model),
                           torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.reset_peak_memory_stats()
        try:
            make_train_step(batch_keys=keys)(state, batch)
            torch.cuda.synchronize()
            return b, batch, misses
        except torch.cuda.OutOfMemoryError as e:
            misses.append({"batch": b, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                           "error": str(e).splitlines()[0][:300]})
            b //= 2
        finally:
            del model, state
            torch.cuda.empty_cache()
    raise AssertionError(f"{phase}: not even one scene's step fits on the card")


def bev_graph_case(cfg, mixed: bool, batch, check_batch, smi: str, profile: str = None,
                   n: int = 10, keys=BEV_KEYS, phase: str = "bev_train",
                   stage_from_host: bool = False):
    """The BEV train step at ``batch``: eager (wall ms, launches, peak
    memory), graph against eager on ``check_batch`` (a 2-step chunk,
    deterministic algorithms on, graph_vs_eager's limits: it runs eager steps
    while the graph holds its memory, which at the preset's batch does not
    fit beside a graph in 80 GB), and a graphed chunk of ``n`` steps at
    ``batch``: wall ms per step (one replay), scenes/s, the busy share and
    the launches of one profiled replay, peak memory and what was live
    before, capture s; the device ms of one profiled eager step, with the
    share of it that the ``bev_pool`` and ``lidar_branch`` ranges take.
    ``stage_from_host``: the capture reads the chunk's batches from the host,
    so that the graph's static inputs are the only copy on the card while it
    is captured; the timed replays then copy a device copy of them in, as
    the other cases' replays do."""
    from ddp_tpu_torch.config import build_model
    from ddp_tpu_torch.train.optim import make_optimizer
    from ddp_tpu_torch.train.step import (TrainState, make_chunked_train_step, make_train_step,
                                          tree_map)

    b = batch["image"].shape[0]
    model = build_model(cfg.model, device="cuda", seed=0)
    state = TrainState(model, make_optimizer(cfg.optim, model),
                       torch.Generator(device="cuda").manual_seed(0))
    state.optimizer.count = cfg.optim.warmup_steps  # as graph_case: lr past the warm-up
    tag = "bf16" if mixed else "f32"
    eager = make_train_step(mixed_precision=mixed, batch_keys=keys)
    eager(state, batch)
    reset_all_launches()
    loss = eager(state, batch)["loss"].item()
    eager_launches = all_launches()
    if eager_launches != NO_KERNELS or not 0 < loss < float("inf"):
        raise AssertionError(f"{phase} {tag}: launches {eager_launches}, loss {loss}")
    torch.cuda.reset_peak_memory_stats()
    eager_s = wall_s(lambda: eager(state, batch), reps=1, warmup=0)
    eager_peak = torch.cuda.max_memory_allocated() / 1e9
    eager_busy, _ = profile_call(lambda: eager(state, batch))
    with deterministic_algorithms(True) as warned:
        held = make_chunked_train_step(2, mixed_precision=mixed, batch_keys=keys)
        held(state, stacked(check_batch, 2))
        check = graph_vs_eager(state, held, eager, check_batch, 2)
    del held
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    live = torch.cuda.memory_allocated() / 1e9
    chunk = make_chunked_train_step(n, mixed_precision=mixed, batch_keys=keys)
    chunk_batch = stacked(batch, n)
    if stage_from_host:
        chunk_batch = tree_map(lambda x: x.cpu(), chunk_batch)
    line = {"phase": phase, "preset": cfg.name, "batch": [b, 6, 256, 704, 3],
            "dtype": "bf16 forward/backward, f32 master weights (the rig and masks cast to "
                     "bf16, the geometry float32)" if mixed else "float32, tf32 off",
            "eager": {"wall_ms_per_step": eager_s * 1e3, "launches": eager_launches,
                      "peak_mem_gb": eager_peak, "profiled": eager_busy},
            "graph_vs_eager_n2_deterministic_algorithms": dict(
                check, batch=list(check_batch["image"].shape)),
            "deterministic_algorithms_warnings": warned, "card": smi}
    chunk(state, chunk_batch)  # n eager steps on the capture stream, then the capture
    if stage_from_host:
        chunk_batch = tree_map(lambda x: x.cuda(), chunk_batch)
    sec = wall_s(lambda: chunk(state, chunk_batch), reps=1, warmup=0) / n
    peak = torch.cuda.max_memory_allocated() / 1e9
    replay_busy, launched = profile_call(
        lambda: chunk(state, chunk_batch), profile and f"{profile}.{phase}_{tag}_n{n}",
        f"# one replay of {n} graphed {cfg.name} {tag} train steps, {smi}\n")
    replayed = {k: v / n for k, v in launched.items()}
    if replayed != NO_KERNELS:
        raise AssertionError(f"{phase} {tag}: the card ran {launched} in one replay")
    line[f"graph_n{n}"] = {"wall_ms_per_step": sec * 1e3, "scenes_per_s": b / sec,
                           "img_per_s": b * cfg.model.bev_num_cams / sec,
                           "device_busy_ms_per_step": replay_busy["device_busy_ms"] / n,
                           "busy_share": replay_busy["busy_share"],
                           "launches_per_replayed_step": replayed,
                           "capture_s": chunk.capture_s[n], "live_before_gb": live,
                           "peak_mem_gb": peak,
                           "batch_copy": "each replay copies its batch into the graph's "
                                         "inputs, card to card"}
    for name in ("bev_pool", "lidar_branch"):  # the eager step's range, the replay's kernels
        if f"{name}_device_ms" in eager_busy:
            line[f"graph_n{n}"][f"{name}_share_of_replayed_step"] = (
                eager_busy[f"{name}_device_ms"] / (replay_busy["device_busy_ms"] / n))
    emit(line)
    del chunk, model, state
    torch.cuda.empty_cache()
    return replayed


def phase_bev_train(smi: str, profile: str = None):
    """Training nuscenes_camera at the preset's batch of 8 scenes (48
    camera images of 256 x 704; the largest power-of-two batch whose f32
    step fits, where 8 does not), the synthetic rig with the 3D aug:
    bev_pool alone (deterministic algorithms off and on), then f32 and bf16
    through bev_graph_case (graph against eager on the batch's first 2
    scenes); the host's bev_batch_iterator batch of 8 at these shapes (with
    the aug); python -m ddp_tpu_torch.tools.train smoke_bev to exit 0."""
    import shutil

    from ddp_tpu_torch.config import build_model, get_config
    from ddp_tpu_torch.data.bev_datasets import SyntheticBEVDataset, bev_batch_iterator

    cfg = get_config("nuscenes_camera")
    want = cfg.data.batch_size
    b, batch, _ = fit_batch(cfg, want)
    pool = bev_pool_cost(batch, build_model(cfg.model, device="meta"))
    check_batch = {k: v[:2] for k, v in batch.items()}
    graphed = bev_graph_case(cfg, False, batch, check_batch, smi, profile)
    bev_graph_case(cfg, True, batch, check_batch, smi, profile)
    mc = cfg.model
    ds = SyntheticBEVDataset(num_cams=mc.bev_num_cams, image_size=mc.bev_image_size,
                             out_grid=mc.bev_out_grid, num_classes=mc.num_classes,
                             scope=mc.bev_xbound[1], length=512)
    it = bev_batch_iterator(ds, want, seed=0)
    host = []
    for _ in range(2):
        t0 = time.perf_counter()
        next(it)
        host.append(time.perf_counter() - t0)

    root = os.path.dirname(os.path.abspath(__file__))
    workdir = os.path.join(root, BEV_DIR, "smoke_bev")
    shutil.rmtree(os.path.join(root, BEV_DIR), ignore_errors=True)
    _, cli_s = run_cli("ddp_tpu_torch.tools.train", ["smoke_bev", "--workdir", workdir])
    logs = _log_steps(workdir)
    if logs[-1]["step"] != 60 or not all(0 < r["loss"] < float("inf") for r in logs):
        raise AssertionError(f"bev_train: tools.train smoke_bev logs {logs}")
    shutil.rmtree(os.path.join(root, BEV_DIR), ignore_errors=True)
    emit({"phase": "bev_train", "preset": cfg.name, "batch_wanted": want, "batch_run": b,
          "batch_note": "the preset's batch" if b == want else
          f"the preset's batch of {want} does not fit: {b} is the largest that does",
          "bev_pool_alone": pool, "host_batch_s": host,
          "host_batch": f"bev_batch_iterator, {want} scenes of 6 x 256x704 with the 3D aug "
                        "(the first includes the iterator's start)",
          "train_cli_smoke_bev": {"exit": 0, "wall_s": cli_s,
                                  "log_steps": [r["step"] for r in logs],
                                  "loss_first_last": [logs[0]["loss"], logs[-1]["loss"]]},
          "card": smi})
    return graphed


def phase_converge_bev(smi: str):
    """The BEV end check: converge_bev's 2500 iterations through train()
    and eval_bev's map mIoU at 1, 3 and 10 DDIM steps beside the JAX
    package's work_dirs/converge_bev/result.json. The target (within 0.02 of
    JAX at every horizon, 3 steps >= 1 step) is reported, not enforced; the
    phase fails only on a run that did not learn (mIoU@3 below 0.2)."""
    from ddp_tpu_torch.config import get_config
    from ddp_tpu_torch.evaluation.convergence import run

    ref_dir = os.path.join("work_dirs", "converge_bev")
    with open(os.path.join(ref_dir, "result.json")) as f:
        ref = json.load(f)
    ref_logs = _log_steps(ref_dir)
    t0 = time.perf_counter()
    result = run("converge_bev")
    wall = time.perf_counter() - t0
    own = _log_steps(get_config("converge_bev").runtime.workdir)
    miou = {f"{t}step": {"port": result[f"map_mIoU@{t}step"], "jax": ref[f"map_mIoU@{t}step"],
                         "diff": result[f"map_mIoU@{t}step"] - ref[f"map_mIoU@{t}step"],
                         "port_std": result[f"map_mIoU@{t}step_std"],
                         "jax_std": ref[f"map_mIoU@{t}step_std"]} for t in (1, 3, 10)}
    emit({"phase": "converge_bev", "iters": result["total_iters"], "map_mIoU": miou,
          "within_0.02_of_jax": all(abs(v["diff"]) <= 0.02 for v in miou.values()),
          "3step_at_least_1step": result["map_mIoU@3step"] >= result["map_mIoU@1step"],
          "iou_class": {k: v for k, v in result.items() if k.startswith("iou_")},
          "loss_curve": {"port": [[r["step"], r["loss"]] for r in own],
                         "jax": [[r["step"], r["loss"]] for r in ref_logs]},
          "steps_per_s_logged": [r["steps_per_s"] for r in own], "wall_s": wall, "card": smi})
    if own[-1]["step"] != result["total_iters"] or not result["map_mIoU@3step"] >= 0.2:
        raise AssertionError(f"converge_bev: did not learn ({result})")


# --- BEV fusion (camera + lidar) -----------------------------------------------------

FUSION_KEYS = ("image", "cam2lidar_rots", "cam2lidar_trans", "intrins", "post_rots",
               "post_trans", "voxel_feats", "rulebooks", "label")


def fusion_dataset(cfg, length: int = 8, cls=None):
    """The synthetic fusion rig at cfg's cameras, grid, voxels and capacities
    (``cls``: a subclass of SyntheticFusionDataset)."""
    from ddp_tpu_torch.data.bev_datasets import SyntheticFusionDataset

    mc = cfg.model
    return (cls or SyntheticFusionDataset)(sparse_shape=mc.bev_sparse_shape, caps=mc.bev_voxel_caps,
                                  voxel_size=mc.bev_voxel_size, num_cams=mc.bev_num_cams,
                                  image_size=mc.bev_image_size, out_grid=mc.bev_out_grid,
                                  num_classes=mc.num_classes, scope=mc.bev_xbound[1],
                                  length=length)


def fusion_scenes(cfg, b: int, seed: int = 0, device="cuda"):
    """A fusion_batch_iterator batch of b scenes (rulebooks included) as
    tensors on ``device``."""
    from ddp_tpu_torch.data.bev_datasets import fusion_batch_iterator
    from ddp_tpu_torch.train.step import tree_map

    batch = next(fusion_batch_iterator(fusion_dataset(cfg, max(b, 8)), b, seed=seed,
                                       mean=cfg.data.mean, std=cfg.data.std))
    return {k: tree_map(lambda x: torch.from_numpy(x).to(device), v) for k, v in batch.items()}


def dense_cloud(mc, n: int = 400_000, seed=0):
    """n points (from ``default_rng(seed)``) spread over mc's voxel range (x, y uniform in the scope, z
    over the 8.2 m of the grid; intensity and lag uniform): enough that every
    level of the nuScenes rulebooks fills to its capacity."""
    import numpy as np

    rng = np.random.default_rng(seed)
    s, nz = mc.bev_xbound[1], mc.bev_sparse_shape[2] * mc.bev_voxel_size[2]
    pts = rng.uniform(0.0, 1.0, (n, 5)).astype(np.float32)
    pts[:, :2] = pts[:, :2] * 2 * s - s
    pts[:, 2] = pts[:, 2] * nz - 5.0
    return pts, (-s, -s, -5.0, s, s, nz - 5.0)


def fusion_dense_dataset(cfg, length: int):
    """fusion_dataset(cfg) with each scene's sweep replaced by dense_cloud's
    (seeded by the scene and the epoch), voxelized at 10 points a voxel as
    the nuScenes reader does: every level of the rulebooks fills to its
    capacity."""
    from ddp_tpu_torch.data.bev_datasets import (SyntheticBEVDataset, SyntheticFusionDataset,
                                                 lidar_inputs)

    class DenseClouds(SyntheticFusionDataset):
        def load(self, idx, noise_seed=None):
            pts, _ = dense_cloud(cfg.model, seed=(idx, noise_seed or 0))
            return lidar_inputs(SyntheticBEVDataset.load(self, idx), pts, self.pc_range,
                                self.voxel_size, 10, self.sparse_shape, self.caps)

    return fusion_dataset(cfg, length, DenseClouds)


def host_lidar_ms(mc, pts, pc_range, reps: int = 3) -> dict:
    """Median host ms of hard_voxelize and of the encoder's rulebooks for one
    cloud, with the voxels and active sites per level."""
    from ddp_tpu_torch import native
    from ddp_tpu_torch.nn.sparse_conv import build_sparse_encoder_rulebooks

    caps = mc.bev_voxel_caps
    vox = _host_ms(lambda: native.hard_voxelize(pts, pc_range, mc.bev_voxel_size, 10,
                                                caps[0]), reps)
    _, coords, _, nv = native.hard_voxelize(pts, pc_range, mc.bev_voxel_size, 10, caps[0])
    rb_ms = _host_ms(lambda: build_sparse_encoder_rulebooks(coords, nv, mc.bev_sparse_shape,
                                                            caps), reps)
    rb = build_sparse_encoder_rulebooks(coords, nv, mc.bev_sparse_shape, caps)
    active = {k: int((rb[k] >= 0).any(axis=0).sum()) for k in
              ("subm1", "subm2", "subm3", "subm4", "down")}
    return {"points": len(pts), "voxelize_ms": vox, "rulebooks_ms": rb_ms,
            "voxels": nv, "active_sites": active, "caps": list(caps)}, rb


def check_gather_gemm(mc, rb) -> list:
    """The gather-GEMM Function against its plain version on the card at the
    preset's capacities (one scene's rulebooks, filled by a dense cloud):
    the forward within 1e-5 of its max, the features' and the weight's
    gradients within 1e-4·max|g|; forward and forward + backward ms."""
    from ddp_tpu_torch.nn import sparse_conv as S

    caps = mc.bev_voxel_caps
    cases = [("subm1", caps[0], 5, 16), ("spconv2", caps[0], 16, 32),
             ("subm2", caps[1], 32, 32), ("spconv4", caps[2], 64, 64),
             ("subm4", caps[3], 64, 64), ("down", caps[3], 64, mc.bev_lidar_channels)]
    g = _gen(61)
    rows = []
    for key, v_in, cin, cout in cases:
        gather = torch.from_numpy(rb[key]).cuda()
        feats = torch.randn(v_in, cin, generator=g).cuda()
        weight = (torch.randn(gather.shape[0], cin, cout, generator=g)
                  / (gather.shape[0] * cin) ** 0.5).cuda()
        cot = torch.randn(gather.shape[1], cout, generator=g).cuda()
        res = {}
        for name, fn in (("function", S.sparse_conv_gather_gemm),
                         ("plain", S.sparse_conv_gather_gemm_plain)):
            f, w = feats.clone().requires_grad_(True), weight.clone().requires_grad_(True)
            out = fn(f, gather, w)
            df, dw = torch.autograd.grad(out, (f, w), cot)
            res[name] = (out.detach(), df, dw)
            reps = 10 if name == "function" else 3  # the plain backward takes ~0.2-0.8 s
            fwd = time_ms(lambda: fn(feats, gather, weight), reps=reps)
            both = time_ms(lambda: torch.autograd.grad(fn(f, gather, w), (f, w), cot),
                           reps=reps)
            res[name + "_ms"] = (fwd, both)
        (o, df, dw), (op, dfp, dwp) = res["function"], res["plain"]
        errs = {"out": (o - op).abs().max().item() / op.abs().max().item(),
                "dfeats": (df - dfp).abs().max().item() / dfp.abs().max().item(),
                "dweight": (dw - dwp).abs().max().item() / dwp.abs().max().item()}
        row = {"rulebook": key, "feats": [v_in, cin], "gather": list(gather.shape),
               "cout": cout, "valid_entries": int((gather >= 0).sum().item()),
               "rel_err": errs, "function_fwd_ms": res["function_ms"][0],
               "function_fwd_bwd_ms": res["function_ms"][1], "plain_fwd_ms": res["plain_ms"][0],
               "plain_fwd_bwd_ms": res["plain_ms"][1]}
        rows.append(row)
        if not (errs["out"] <= 1e-5 and errs["dfeats"] <= 1e-4 and errs["dweight"] <= 1e-4):
            raise AssertionError(f"fusion_reference: gather-GEMM {key} vs plain {errs}")
        del feats, weight, cot, res, o, df, dw, op, dfp, dwp
    torch.cuda.empty_cache()
    return rows


def phase_fusion_reference(smi: str):
    """smoke_fusion (2 cameras of 32 x 64, a 24-channel lidar branch, a 32-d
    msda decoder) on the card and on the CPU from the same weights and the
    same batch (rulebooks included), t and noise: the loss within 1e-5
    relative and sample()'s scores within 1e-4. Then the gather-GEMM
    Function against its plain version on the card at nuscenes_fusion's
    capacities (check_gather_gemm)."""
    from ddp_tpu_torch.config import build_model, get_config
    from ddp_tpu_torch.train.step import tree_map

    cfg = get_config("smoke_fusion")
    mc = cfg.model
    batch = fusion_scenes(cfg, 2, seed=1, device="cpu")
    g = _gen(57)
    t = torch.rand(2, generator=g) * 0.999
    noise = torch.randn(2, 16, 16, mc.embed_dims, generator=g)
    init = torch.randn(mc.diffusion.randsteps * 2, 16, 16, mc.embed_dims, generator=g)
    res = {}
    for dev in ("cpu", "cuda"):
        model = build_model(mc, device=dev, seed=0).train()
        on = {k: tree_map(lambda x: x.to(dev), v) for k, v in batch.items()}
        loss, _ = model(*(on[k] for k in FUSION_KEYS), t=t.to(dev), noise=noise.to(dev))
        s = model.eval().sample(*(on[k] for k in FUSION_KEYS[:-1]), noise=init.to(dev))
        check_scores(s, (2, mc.bev_out_grid, mc.bev_out_grid, mc.num_classes),
                     f"fusion_reference {dev}")
        res[dev] = (loss.item(), s.cpu())
    rel = abs(res["cuda"][0] - res["cpu"][0]) / abs(res["cpu"][0])
    diff = (res["cuda"][1] - res["cpu"][1]).abs().max().item()
    big = get_config("nuscenes_fusion").model
    pts, pc_range = dense_cloud(big)
    host, rb = host_lidar_ms(big, pts, pc_range)
    gemm = check_gather_gemm(big, rb)
    out = {"phase": "fusion_reference", "preset": cfg.name, "cameras": [2, 32, 64],
           "loss_card": res["cuda"][0], "loss_cpu": res["cpu"][0], "loss_rel_diff": rel,
           "sample_max_abs_diff": diff, "limits": "loss 1e-5 relative, scores 1e-4; "
           "gather-GEMM vs plain: out 1e-5, gradients 1e-4 of their max",
           "gather_gemm_at_nuscenes_fusion_caps": gemm, "dense_cloud_host": host, "card": smi}
    emit(out)
    if not (rel <= 1e-5 and diff <= 1e-4):
        raise AssertionError(f"fusion_reference: card vs CPU loss rel {rel}, scores {diff}")


def phase_fusion_main(smi: str, profile: str = None):
    """Serving nuscenes_fusion at full width (6 cameras of 256 x 704, Swin-T,
    LSS; the lidar branch on a 1024 x 1024 x 41 voxel grid at capacities
    120,000 / 60,000 / 30,000 / 15,000 / 15,000, a 128^2 x 256-channel lidar
    BEV; the ConvFuser, 5 window-decoder layers on the 200^2 grid, 3 DDIM
    steps x 5 randsteps; random weights, seed 0) on one scene of the
    synthetic fusion rig: scores in [0, 1], no kernel launched, sample() and
    sample_with_uncertainty() wall ms (median of 5), scenes/s, busy share
    (profiled and unprofiled), peak memory, extract_lidar_dense's and
    extract_bev_feat's ms, and the host's ms for the scene (load with and
    without the lidar part; fusion_reference times a dense cloud that fills
    the capacities)."""
    import numpy as np

    from ddp_tpu_torch.config import build_model, get_config
    from ddp_tpu_torch.data.bev_datasets import SyntheticBEVDataset
    from ddp_tpu_torch.train.step import tree_map

    cfg = get_config("nuscenes_fusion")
    mc = cfg.model
    model = build_model(mc, device="cuda", seed=0)
    ds = fusion_dataset(cfg)
    scene = ds.load(3)
    mean, std = np.asarray(cfg.data.mean, np.float32), np.asarray(cfg.data.std, np.float32)
    scene["image"] = (scene["image"] - mean) / std
    args = [tree_map(lambda x: torch.from_numpy(np.asarray(x)[None]).cuda(), scene[k])
            for k in FUSION_KEYS[:-1]]
    r = mc.diffusion.randsteps
    noise = torch.randn(r, 128, 128, mc.embed_dims, generator=_gen(59)).cuda()
    shape = (1, mc.bev_out_grid, mc.bev_out_grid, mc.num_classes)
    reset_all_launches()
    scores = model.sample(*args, noise=noise)
    torch.cuda.synchronize()
    launches = all_launches()
    if launches != NO_KERNELS:
        raise AssertionError(f"fusion_main: kernels launched on the fusion path: {launches}")
    check_scores(scores, shape, "fusion_main")
    torch.cuda.reset_peak_memory_stats()
    live = torch.cuda.memory_allocated() / 1e9
    sec = wall_s(lambda: model.sample(*args, noise=noise))
    peak = torch.cuda.max_memory_allocated() / 1e9
    busy_line, card_launches = profile_call(
        lambda: model.sample(*args, noise=noise), profile and f"{profile}.fusion_sample",
        f"# one nuscenes_fusion sample(), 6 x 256x704 + lidar, {smi}\n")
    if card_launches != NO_KERNELS:
        raise AssertionError(f"fusion_main: the card ran {card_launches}")
    with torch.no_grad():
        lidar_ms = wall_s(lambda: model.extract_lidar_dense(args[6], args[7])) * 1e3
        enc_ms = wall_s(lambda: model.extract_bev_feat(*args)) * 1e3
    unc_s = wall_s(lambda: model.sample_with_uncertainty(*args, noise=noise))
    s2, unc = model.sample_with_uncertainty(*args, noise=noise)
    check_scores(s2, shape, "fusion_main uncertainty")
    if not ((unc["variance"] >= 0).all() and torch.isfinite(unc["variance"]).all()):
        raise AssertionError("fusion_main: invalid variance map")
    load_ms = _host_ms(lambda: ds.load(5), 3)
    camera_ms = _host_ms(lambda: SyntheticBEVDataset.load(ds, 5), 3)
    rb = scene["rulebooks"]
    emit({"phase": "fusion_main", "preset": cfg.name, "cameras": [6, 256, 704],
          "voxel_caps": list(mc.bev_voxel_caps), "sparse_shape": list(mc.bev_sparse_shape),
          "scene_voxels": int((rb["subm1"][13] >= 0).sum()),
          "scene_active_down": int(rb["down_valid"].sum()),
          "bev_latent": [128, 128, mc.embed_dims], "out_grid": mc.bev_out_grid,
          "decoder": f"{mc.decoder_attn}, {mc.decoder_layers} layers",
          "timesteps": mc.diffusion.timesteps, "randsteps": r, "dtype": "float32, tf32 off",
          "sample_ms": sec * 1e3, "scenes_per_s": 1 / sec, **busy_line,
          "busy_share_unprofiled": busy_line["device_busy_ms"] / (sec * 1e3),
          "live_before_gb": live, "peak_mem_gb": peak, "extract_lidar_dense_ms": lidar_ms,
          "extract_bev_feat_ms": enc_ms, "sample_with_uncertainty_ms": unc_s * 1e3,
          "mean_variance": unc["variance"].mean().item(),
          "host_scene_load_ms": load_ms, "host_scene_camera_part_ms": camera_ms,
          "host_scene_voxelize_rulebooks_ms": load_ms - camera_ms,
          "launches": launches, "card": smi})
    del model, args, noise
    torch.cuda.empty_cache()
    return launches


def phase_fusion_train(smi: str, profile: str = None):
    """Training nuscenes_fusion at the preset's batch of 8 scenes of the
    synthetic fusion rig (the largest power-of-two batch whose f32 step fits,
    with the measured peak and error of those that did not): f32 (TF32 off)
    and bf16 through bev_graph_case (the eager step, graph against eager on
    2 scenes with deterministic algorithms on, a graphed chunk of 5 steps:
    ms, scenes/s, busy share, peak memory, capture s, no kernel launched).
    The host's batch of 8 is the on-request phase fusion_host."""
    from ddp_tpu_torch.config import get_config

    cfg = get_config("nuscenes_fusion")
    want = cfg.data.batch_size
    b, batch, misses = fit_batch(cfg, want, lambda cfg, b: fusion_scenes(cfg, b, seed=6),
                                 FUSION_KEYS, "fusion_train")

    def head(bt, m):
        return {k: (v[:m] if k != "rulebooks" else {kk: x[:m] for kk, x in v.items()})
                for k, v in bt.items()}

    check_batch = head(batch, 2)
    if b < want:
        batch = fusion_scenes(cfg, want, seed=6)
    bev_graph_case(cfg, True, batch, check_batch, smi, profile, n=5, keys=FUSION_KEYS,
                   phase="fusion_train", stage_from_host=True)
    # f32 at the preset's batch where its eager step fits, else (or where its
    # graph does not fit) at the largest batch that does
    graphed, f32_batch = None, b
    while graphed is None:
        try:
            graphed = bev_graph_case(cfg, False, head(batch, f32_batch), check_batch, smi,
                                     profile, n=5, keys=FUSION_KEYS, phase="fusion_train",
                                     stage_from_host=True)
        except torch.cuda.OutOfMemoryError as e:
            misses.append({"batch": f32_batch, "graph": "the graphed f32 chunk did not fit",
                           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                           "error": str(e).splitlines()[0][:400]})
        if graphed is None:
            gc.collect()
            torch.cuda.empty_cache()
            f32_batch //= 2
            if f32_batch < 1:
                raise AssertionError(f"fusion_train: no graphed f32 step fits: {misses}")
    b = f32_batch
    emit({"phase": "fusion_train", "preset": cfg.name, "batch_wanted": want, "batch_run_f32": b,
          "batch_note": "the preset's batch" if b == want else
          f"the preset's batch of {want} does not fit in f32: {b} is the largest that does",
          "f32_batches_that_did_not_fit": misses, "card": smi})
    return graphed


def phase_fusion_host(smi: str):
    """The host's fusion_batch_iterator batch of nuscenes_fusion's 8 scenes,
    twice each: the rig's 800-point sweeps, and dense clouds that fill every
    level to its capacity."""
    from ddp_tpu_torch.config import get_config
    from ddp_tpu_torch.data.bev_datasets import fusion_batch_iterator

    cfg = get_config("nuscenes_fusion")
    want = cfg.data.batch_size
    host = {}
    for what, ds in (("synthetic_rig", fusion_dataset(cfg, 512)),
                     ("dense_clouds", fusion_dense_dataset(cfg, 512))):
        it = fusion_batch_iterator(ds, want, seed=0)
        host[what] = []
        for _ in range(2):
            t0 = time.perf_counter()
            next(it)
            host[what].append(time.perf_counter() - t0)
    emit({"phase": "fusion_host", "preset": cfg.name, "host_batch_s": host,
          "host_batch": f"fusion_batch_iterator, {want} scenes of 6 x 256x704 + lidar "
                        "(voxelized, rulebooks; the first includes the iterator's start): "
                        "the rig's 800-point sweeps, and dense_cloud's 400,000 points a scene "
                        "at 10 a voxel (every level filled to its capacity)",
          "card": smi})


def phase_converge_bev_fusion(smi: str):
    """The fusion end check: converge_bev_fusion's 2500 iterations through
    train() and eval_bev_fusion's map mIoU at 1 and 3 DDIM steps beside the
    JAX package's work_dirs/converge_bev_fusion/result.json. The target
    (within 0.02 of JAX at each horizon, 3 steps >= 1 step) is reported, not
    enforced; the phase fails only on a run that did not learn (mIoU@3 below
    0.2)."""
    from ddp_tpu_torch.config import get_config
    from ddp_tpu_torch.evaluation.convergence import run

    ref_dir = os.path.join("work_dirs", "converge_bev_fusion")
    with open(os.path.join(ref_dir, "result.json")) as f:
        ref = json.load(f)
    ref_logs = _log_steps(ref_dir)
    t0 = time.perf_counter()
    result = run("converge_bev_fusion")
    wall = time.perf_counter() - t0
    own = _log_steps(get_config("converge_bev_fusion").runtime.workdir)
    miou = {f"{t}step": {"port": result[f"map_mIoU@{t}step"], "jax": ref[f"map_mIoU@{t}step"],
                         "diff": result[f"map_mIoU@{t}step"] - ref[f"map_mIoU@{t}step"],
                         "port_std": result[f"map_mIoU@{t}step_std"],
                         "jax_std": ref[f"map_mIoU@{t}step_std"]} for t in (1, 3)}
    emit({"phase": "converge_bev_fusion", "iters": result["total_iters"], "map_mIoU": miou,
          "within_0.02_of_jax": all(abs(v["diff"]) <= 0.02 for v in miou.values()),
          "3step_at_least_1step": result["map_mIoU@3step"] >= result["map_mIoU@1step"],
          "iou_class": {k: v for k, v in result.items() if k.startswith("iou_")},
          "loss_curve": {"port": [[r["step"], r["loss"]] for r in own],
                         "jax": [[r["step"], r["loss"]] for r in ref_logs]},
          "steps_per_s_logged": [r["steps_per_s"] for r in own], "wall_s": wall, "card": smi})
    if own[-1]["step"] != result["total_iters"] or not result["map_mIoU@3step"] >= 0.2:
        raise AssertionError(f"converge_bev_fusion: did not learn ({result})")


def phase_converge_seg_quarter(smi: str):
    """The quarter-resolution CE end check: converge_seg_quarter's 1500
    iterations (the loss on the 1/4-scale logits, the msda decoder) and
    eval_seg's mIoU at 1, 3 and 10 steps beside the JAX package's
    work_dirs/converge_seg_quarter/result.json (target: each within 0.01)."""
    converge_case("converge_seg_quarter", smi)


# --- ControlNet: SD 1.5 UNet + ControlNet, VAE, CLIP text (controlnet_sd15) ----------

CN_DIR = os.path.join("work_dirs", "chip_smoke_cn")
CN_KEYS = ("image", "hint", "ids")
CN_PARTS = ("diffusion_model", "control_model", "first_stage_model", "cond_stage_model")
CN_FROZEN = ("diffusion_model", "first_stage_model", "cond_stage_model")


def cn_signal_(model, seed: int = 1) -> None:
    """Draw the zero-initialised layers (the UNet's out convs, proj_outs and
    the ControlNet's zero convs, as at JAX's init) N(0, 0.01^2) from a CPU
    generator, so that every part carries signal and gradient, as trained SD
    weights do (at init the UNet's out_conv is 0: eps is 0 and no gradient
    reaches the ControlNet)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            owner = name.rpartition(".")[0]
            if getattr(model.get_submodule(owner), "zero_init", False):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.01)


def cn_inputs(b: int, size: int, seed: int = 0, device="cuda"):
    """(hint, ids, uncond ids) of the synthetic fill50k pairs seed .. seed+b-1
    at ``size``, on ``device``."""
    from ddp_tpu_torch.data.controlnet_data import SyntheticFill50k, tokenize

    ds = SyntheticFill50k(size=size)
    pairs = [ds.load(seed + i) for i in range(b)]
    hint = torch.from_numpy(np.stack([p["hint"] for p in pairs])).to(device)
    ids = torch.from_numpy(np.stack([p["ids"] for p in pairs])).to(device)
    uncond = torch.from_numpy(np.stack([tokenize("")] * b)).to(device)
    return hint, ids, uncond


# kernel families of a ControlLDM profile, matched on the kernel's name
CN_FAMILIES = (("attention (sdpa)", r"fmha|flash|attention|efficient"),
               ("convolution", r"conv|implicit|cudnn|winograd|fprop|dgrad|wgrad|xmma"),
               ("gemm", r"gemm|sgemm|cutlass|matmul"),
               ("norm", r"group_norm|layer_norm|GroupNorm|LayerNorm|welford|batch_norm|"
                        r"RowwiseMoments|ComputeFusedParams|GammaBeta"),
               ("optimizer (_foreach)", r"foreach|multi_tensor"))


def cn_breakdown(p, n_top: int = 10) -> dict:
    """Device ms of a profile by kernel family (the first family whose
    pattern a kernel's name matches; the rest as 'other: elementwise,
    copies, reductions'), the top kernels, and the SDPA kernels by backend."""
    kernels = device_kernels(p)
    fam = {name: 0.0 for name, _ in CN_FAMILIES}
    fam["other: elementwise, copies, reductions"] = 0.0
    sdpa = {}
    for e in kernels:
        ms = e.self_device_time_total / 1e3
        for name, pat in CN_FAMILIES:
            if re.search(pat, e.key, re.I):
                fam[name] += ms
                break
        else:
            fam["other: elementwise, copies, reductions"] += ms
        if re.search(CN_FAMILIES[0][1], e.key, re.I):
            backend = ("flash" if re.search("flash", e.key, re.I) else
                       "memory-efficient (cutlass fmha)" if re.search("fmha|efficient", e.key, re.I)
                       else "other")
            sdpa[backend] = sdpa.get(backend, 0) + e.count
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:n_top]
    return {"device_ms_by_family": fam, "sdpa_kernel_launches_by_backend": sdpa,
            "top_kernels_ms": [(e.key[:90], e.self_device_time_total / 1e3, e.count)
                               for e in top]}


def _cn_reference_eps(model, img, hint, ids, t, noise, post):
    """ε of the model at the fixed draws (the p_losses path through the public
    methods)."""
    z = model.encode_first_stage(img, posterior_noise=post)
    ctx = model.get_learned_conditioning(ids)
    a = model.sqrt_alphas_cumprod[t][:, None, None, None]
    s = model.sqrt_one_minus_alphas_cumprod[t][:, None, None, None]
    return model.apply_model(a * z + s * noise, t, ctx, hint)


def phase_cn_reference(smi: str):
    """A tiny ControlLDM (converge_controlnet, model.cn_size=tiny: a 4x VAE,
    64^2 images, 16^2 latents) on the card and on the CPU from the same
    weights (zero-initialised layers drawn, cn_signal_), batch, t and noises:
    the loss within 1e-5 relative and eps within 1e-4; a 3-step DDIM + CFG
    (guidance 9) sample from the same initial latent, images within 1e-4."""
    from ddp_tpu_torch.config import build_model, get_config

    t0 = time.perf_counter()
    cfg = get_config("converge_controlnet", {"model.cn_size": "tiny"})
    mc = cfg.model
    g = _gen(61)
    s, ls = mc.cn_image_size, mc.cn_image_size // 4
    hint, ids, uncond = cn_inputs(2, s, seed=5, device="cpu")
    img = torch.rand(2, s, s, 3, generator=g) * 2 - 1
    t = torch.tensor([17, 803])
    noise, post, x_t = (torch.randn(2, ls, ls, 4, generator=g) for _ in range(3))
    res = {}
    for dev in ("cpu", "cuda"):
        model = build_model(mc, device="cpu", seed=0)
        cn_signal_(model)
        model = model.to(dev)
        args = [x.to(dev) for x in (img, hint, ids, t, noise, post)]
        with torch.no_grad():
            loss = model.p_losses(*args[:3], t=args[3], noise=args[4],
                                  posterior_noise=args[5])["loss"]
            eps = _cn_reference_eps(model, *args)
            out = model.sample(hint.to(dev), ids.to(dev), uncond.to(dev), steps=3,
                               guidance_scale=9.0, x_T=x_t.to(dev))
        if not torch.isfinite(out).all() or tuple(out.shape) != (2, s, s, 3):
            raise AssertionError(f"cn_reference {dev}: sample {tuple(out.shape)} not finite")
        res[dev] = (loss.item(), eps.cpu(), out.cpu())
    rel = abs(res["cuda"][0] - res["cpu"][0]) / abs(res["cpu"][0])
    eps_diff = (res["cuda"][1] - res["cpu"][1]).abs().max().item()
    img_diff = (res["cuda"][2] - res["cpu"][2]).abs().max().item()
    out = {"phase": "cn_reference", "preset": "converge_controlnet (cn_size=tiny)",
           "images": [2, s, s, 3], "loss_card": res["cuda"][0], "loss_cpu": res["cpu"][0],
           "loss_rel_diff": rel, "eps_max_abs_diff": eps_diff,
           "sample_3_steps_max_abs_diff": img_diff,
           "limits": "loss 1e-5 relative, eps 1e-4, images 1e-4",
           "wall_s": time.perf_counter() - t0, "card": smi}
    emit(out)
    if not (rel <= 1e-5 and eps_diff <= 1e-4 and img_diff <= 1e-4):
        raise AssertionError(f"cn_reference: card vs CPU {out}")


def cn_model(cfg):
    """controlnet_sd15's ControlLDM on the card, seed 0, zero-initialised
    layers drawn (cn_signal_); (model, build s)."""
    from ddp_tpu_torch.config import build_model

    t0 = time.perf_counter()
    model = build_model(cfg.model, device="cuda", seed=0)
    cn_signal_(model)
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0


def phase_cn_main(smi: str):
    """Serving controlnet_sd15 at full width (1.43 B parameters, random
    weights, seed 0): ControlLDM.sample at 512^2, 20 DDIM steps, guidance 9,
    at batch 1 and 4 (f32, TF32 off): finite images in about [-1, 1], s per
    image and images/s, the busy share of a 5-step batch-1 call (profiled,
    and its profiled device ms over its unprofiled wall time), the device ms
    by kernel family and the SDPA backend of that call, peak memory, 0
    launches of the five kernels; python -m ddp_tpu_torch.tools.control_demo
    on the card (run_cli: its own build, 4 samples, a PNG). Returns (model,
    launches)."""
    from ddp_tpu_torch.config import get_config
    from ddp_tpu_torch.models.controlnet import part_sizes

    t_phase = time.perf_counter()
    cfg = get_config("controlnet_sd15")
    model, build_s = cn_model(cfg)
    model.eval()
    sizes = dict(part_sizes(model))
    line = {"phase": "cn_main", "preset": cfg.name, "parameters": sizes,
            "parameters_total": sum(sizes.values()), "build_s": build_s,
            "dtype": "float32, tf32 off", "sampler": "DDIM 20 steps, CFG 9.0 (batch 2N)"}
    launches = None
    for b in (1, 4):
        hint, ids, uncond = cn_inputs(b, 512, seed=b)
        gen = torch.Generator(device="cuda").manual_seed(0)

        def call():
            return model.sample(hint, ids, uncond, steps=20, guidance_scale=9.0, generator=gen)

        torch.cuda.reset_peak_memory_stats()
        live = torch.cuda.memory_allocated() / 1e9
        reset_all_launches()
        t0 = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        counted = all_launches()
        if b == 1:
            launches = counted
        if (counted != NO_KERNELS or tuple(out.shape) != (b, 512, 512, 3)
                or not torch.isfinite(out).all()):
            raise AssertionError(f"cn_main b={b}: launches {counted}, {tuple(out.shape)}, "
                                 f"finite {bool(torch.isfinite(out).all())}")
        # batch 4: the first call is timed (the batch-1 calls loaded every kernel)
        sec = wall_s(call, reps=1, warmup=0) if b == 1 else first_s
        case = {"s_per_call": sec, "s_per_image": sec / b, "images_per_s": b / sec,
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "live_before_gb": live,
                "image_range": [out.min().item(), out.max().item()], "launches": counted}
        if b == 1:
            # a 5-step call profiled (each step the same work; a 20-step trace
            # takes the profiler tens of seconds to read back)
            p, wall_ms = profiled(lambda: model.sample(hint, ids, uncond, steps=5,
                                                       guidance_scale=9.0, generator=gen),
                                  timed=True)
            case["profiled_5_steps"] = busy(p, wall_ms)
            five_s = wall_s(lambda: model.sample(hint, ids, uncond, steps=5,
                                                 guidance_scale=9.0, generator=gen),
                            reps=1, warmup=0)
            case["busy_share_unprofiled_5_steps"] = (
                case["profiled_5_steps"]["device_busy_ms"] / (five_s * 1e3))
            case.update(cn_breakdown(p))
            del p
        line[f"batch_{b}"] = case
    root = os.path.dirname(os.path.abspath(__file__))
    shutil.rmtree(os.path.join(root, CN_DIR), ignore_errors=True)
    png = os.path.join(root, CN_DIR, "demo.png")
    os.makedirs(os.path.dirname(png), exist_ok=True)
    text, demo_s = run_cli("ddp_tpu_torch.tools.control_demo", [
        "--preset", "controlnet_sd15", "--workdir", os.path.join(root, CN_DIR, "none"),
        "--index", "3", "--num-samples", "4", "--steps", "20", "--scale", "9.0", "--out", png])
    if not os.path.exists(png):
        raise AssertionError(f"cn_main: control_demo wrote no {png}\n{text[-2000:]}")
    from PIL import Image

    line["control_demo"] = {"exit": 0, "wall_s": demo_s,
                            "png_shape": list(np.asarray(Image.open(png)).shape),
                            "stdout_tail": text.strip().splitlines()[-2:]}
    shutil.rmtree(os.path.join(root, CN_DIR), ignore_errors=True)
    line.update(wall_s=time.perf_counter() - t_phase, card=smi)
    emit(line)
    return model, launches


def cn_batch(cfg, b: int, device="cuda"):
    """The first batch of make_train_iter (synthetic fill50k at 512^2) cut to b."""
    from ddp_tpu_torch.data import make_train_iter

    host = next(make_train_iter(cfg))
    return {k: torch.from_numpy(v[:b]).to(device) for k, v in host.items()}


def cn_step_case(state, batch, mixed: bool) -> dict:
    """One eager step's s (after one warm-up), forward / backward / optimizer
    s, img/s, peak memory, the loss; 0 launches of the five kernels."""
    from ddp_tpu_torch.train.step import make_train_step

    step = make_train_step(mixed_precision=mixed, batch_keys=CN_KEYS)
    b = batch["image"].shape[0]
    step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    t0 = time.perf_counter()
    logs = step(state, batch)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    counted = all_launches()
    loss = logs["loss"].item()
    if counted != NO_KERNELS or not 0 < loss < float("inf"):
        raise AssertionError(f"cn_train: launches {counted}, loss {loss}")
    peak = torch.cuda.max_memory_allocated() / 1e9

    def forward():
        with torch.no_grad():
            step._loss(state.model, dict(state.model.named_parameters()), batch,
                       state.generator)
    fwd_s = wall_s(forward, reps=1, warmup=0)
    t0 = time.perf_counter()
    grads, _ = step.grads(state, batch)
    torch.cuda.synchronize()
    fwd_bwd_s = time.perf_counter() - t0
    opt_s = wall_s(lambda: state.optimizer.step(grads), reps=1, warmup=0)
    del grads
    return {"step_s": step_s, "img_per_s": b / step_s, "forward_s_no_grad": fwd_s,
            "forward_backward_s": fwd_bwd_s, "optimizer_s": opt_s, "peak_mem_gb": peak,
            "loss": loss, "grad_norm": logs["grad_norm"].item(), "launches": counted}


def cn_graph_case(state, batch, mixed: bool, n: int) -> dict:
    """A graphed chunk of n steps at ``batch``: wall ms per step (one replay),
    img/s, busy share and launches of one profiled replay, capture s, peak."""
    from ddp_tpu_torch.train.step import make_chunked_train_step

    b = batch["image"].shape[0]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    live = torch.cuda.memory_allocated() / 1e9
    chunk = make_chunked_train_step(n, mixed_precision=mixed, batch_keys=CN_KEYS)
    batches = stacked(batch, n)
    try:
        chunk(state, batches)  # n eager steps on the capture stream, then the capture
        sec = wall_s(lambda: chunk(state, batches), reps=1, warmup=0) / n
        peak = torch.cuda.max_memory_allocated() / 1e9
        replay_busy, launched = profile_call(lambda: chunk(state, batches))
        replayed = {k: v / n for k, v in launched.items()}
        if replayed != NO_KERNELS:
            raise AssertionError(f"cn_train: the card ran {launched} in one replay")
        return {"batch": b, "n": n, "wall_ms_per_step": sec * 1e3, "img_per_s": b / sec,
                "busy_share": replay_busy["busy_share"],
                "device_busy_ms_per_step": replay_busy["device_busy_ms"] / n,
                "launches_per_replayed_step": replayed, "capture_s": chunk.capture_s[n],
                "live_before_gb": live, "peak_mem_gb": peak}
    finally:
        del chunk, batches
        gc.collect()
        torch.cuda.empty_cache()


def phase_cn_train(smi: str, model=None, profile: str = None):
    """Training controlnet_sd15 at its batch of 4 x 512^2 on synthetic fill50k
    (data.dataset=synthetic; the SD UNet, VAE and CLIP frozen by lr_mult 0,
    their gradients taken): one eager f32 and one eager bf16 step (s, forward /
    backward / optimizer s, img/s, peak memory; the device ms by family and
    SDPA backend of one profiled f32 step); the frozen parts' tensors bitwise
    unchanged after every step and the ControlNet's changed; a graphed bf16
    chunk and a graphed f32 one (at the largest batch whose graph fits, with
    the recorded out-of-memory errors of those that do not); graph against
    eager at batch 1 with deterministic algorithms on (graph_vs_eager's
    limits, f32 and bf16), with the deterministic-algorithm warnings; 0
    launches of the five kernels. Returns the launches of one eager step."""
    from ddp_tpu_torch.config import get_config
    from ddp_tpu_torch.train.optim import make_optimizer
    from ddp_tpu_torch.train.step import TrainState, make_train_step

    t_phase = time.perf_counter()
    cfg = get_config("controlnet_sd15", {"data.dataset": "synthetic"})
    if model is None:
        model, _ = cn_model(cfg)
    model.train()
    frozen = {k: v.detach().cpu() for k, v in model.named_parameters() if k.startswith(CN_FROZEN)}
    control = {k: v.detach().cpu() for k, v in model.named_parameters()
               if k.startswith("control_model")}
    state = TrainState(model, make_optimizer(cfg.optim, model),
                       torch.Generator(device="cuda").manual_seed(0))
    b = cfg.data.batch_size
    batch = cn_batch(cfg, b)
    line = {"phase": "cn_train", "preset": cfg.name, "batch": [b, 512, 512, 3],
            "frozen": "diffusion_model, first_stage_model, cond_stage_model by lr_mult 0"}
    line["eager_f32"] = cn_step_case(state, batch, False)
    p, wall_ms = profiled(lambda: make_train_step(batch_keys=CN_KEYS)(state, batch), timed=True)
    line["eager_f32"]["profiled"] = busy(p, wall_ms)
    line["eager_f32"].update(cn_breakdown(p))
    if profile:
        with open(profile + ".cn_train", "w") as f:
            f.write(f"# one controlnet_sd15 f32 train step at {b}x512x512, {smi}\n")
            f.write(p.key_averages().table(sort_by="cuda_time_total", row_limit=60))
    del p
    line["eager_bf16"] = cn_step_case(state, batch, True)
    launches = line["eager_f32"]["launches"]
    line["graph_bf16"] = cn_graph_case(state, batch, True, 2)
    f32_graph, misses, gb = None, [], b
    while f32_graph is None and gb >= 1:
        try:
            f32_graph = cn_graph_case(state, {k: v[:gb] for k, v in batch.items()}, False, 2)
        except torch.cuda.OutOfMemoryError as e:
            misses.append({"batch": gb, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                           "error": str(e).splitlines()[0][:400]})
            gb //= 2
    if f32_graph is None:
        raise AssertionError(f"cn_train: no graphed f32 step fits: {misses}")
    line["graph_f32"] = dict(f32_graph, batches_that_did_not_fit=misses)
    one = {k: v[:1] for k, v in batch.items()}
    for mixed in (False, True):
        tag = "bf16" if mixed else "f32"
        eager = make_train_step(mixed_precision=mixed, batch_keys=CN_KEYS)
        gc.collect()
        torch.cuda.empty_cache()
        with deterministic_algorithms(True) as warned:
            from ddp_tpu_torch.train.step import make_chunked_train_step

            held = make_chunked_train_step(2, mixed_precision=mixed, batch_keys=CN_KEYS)
            held(state, stacked(one, 2))
            # the frozen parts cannot move (lr_mult 0, checked below): a snapshot
            # of all 1.43 B parameters three times over does not fit beside the graph
            check = graph_vs_eager(state, held, eager, one, 2,
                                   keep=lambda k: k.startswith("control_model"))
        del held
        gc.collect()
        torch.cuda.empty_cache()
        line[f"graph_vs_eager_b1_{tag}"] = dict(check, deterministic_algorithms_warnings=warned,
                                                compared="control_model's tensors and moments")
    changed_frozen = [k for k, v in model.named_parameters()
                      if k.startswith(CN_FROZEN) and not torch.equal(v.detach().cpu(), frozen[k])]
    control_changed = sum(not torch.equal(v.detach().cpu(), control[k])
                          for k, v in model.named_parameters() if k.startswith("control_model"))
    line["frozen_bitwise_unchanged"] = {"tensors": len(frozen), "changed": changed_frozen[:10],
                                        "steps_taken": state.optimizer.count}
    line["control_model_tensors_changed"] = f"{control_changed} of {len(control)}"
    line.update(wall_s=time.perf_counter() - t_phase, card=smi)
    emit(line)
    if changed_frozen or control_changed == 0:
        raise AssertionError(f"cn_train: frozen tensors changed {changed_frozen[:10]}, "
                             f"control tensors changed {control_changed}")
    del state, model, frozen, control
    gc.collect()
    torch.cuda.empty_cache()
    return launches


CN_TARGET = {"psnr_db": 27.33, "mae": 0.0488}


def phase_converge_controlnet(smi: str):
    """The ControlNet end check: converge_controlnet through run() (the VAE
    pretrained 2500 iterations, its latent scale measured; 40,000 steps on
    batches rendered on the card; 8 held-out hints, 20 DDIM steps, guidance
    1.0) beside the JAX package's work_dirs/converge_controlnet/result.json
    (27.33 dB, MAE 0.0488; scale.json 0.22795). The target (within 1.0 dB
    and 0.01) is reported, not enforced; on a miss two more starts run
    (runtime.seed 1 and 2) and the spread is reported. The phase fails only
    on a run that did not learn (PSNR below 15 dB)."""
    import dataclasses

    from ddp_tpu_torch.config import get_config
    from ddp_tpu_torch.evaluation.convergence import run, run_controlnet

    ref_dir = os.path.join("work_dirs", "converge_controlnet")
    with open(os.path.join(ref_dir, "result.json")) as f:
        ref = json.load(f)
    with open(os.path.join(ref_dir, "scale.json")) as f:
        ref_scale = json.load(f)["cn_scale_factor"]

    def within(r):
        return (abs(r["psnr_db"] - ref["psnr_db"]) <= 1.0 and abs(r["mae"] - ref["mae"]) <= 0.01)

    t0 = time.perf_counter()
    result = run("converge_controlnet")
    wall = time.perf_counter() - t0
    cfg = get_config("converge_controlnet")
    own = _log_steps(cfg.runtime.workdir)
    starts = [dict(seed=0, psnr_db=result["psnr_db"], mae=result["mae"],
                   cn_scale_factor=result["cn_scale_factor"], wall_s=wall)]
    if not within(result):
        for seed in (1, 2):
            c = dataclasses.replace(cfg, runtime=dataclasses.replace(
                cfg.runtime, seed=seed, workdir=f"{cfg.runtime.workdir}_seed{seed}"))
            os.makedirs(c.runtime.workdir, exist_ok=True)
            t1 = time.perf_counter()
            r = run_controlnet(c)
            starts.append(dict(seed=seed, psnr_db=r["psnr_db"], mae=r["mae"],
                               cn_scale_factor=r["cn_scale_factor"],
                               wall_s=time.perf_counter() - t1))
    emit({"phase": "converge_controlnet", "iters": result["total_iters"],
          "psnr_db": {"port": result["psnr_db"], "jax": ref["psnr_db"],
                      "diff": result["psnr_db"] - ref["psnr_db"]},
          "mae": {"port": result["mae"], "jax": ref["mae"], "diff": result["mae"] - ref["mae"]},
          "cn_scale_factor": {"port": result["cn_scale_factor"], "jax": ref_scale},
          "within_1db_and_0.01_of_jax": within(result), "starts": starts,
          "loss_curve": [[r["step"], r["loss_chunk_mean"]] for r in own[::100]] +
          [[own[-1]["step"], own[-1]["loss_chunk_mean"]]],
          "steps_per_s_logged_median": statistics.median(r["steps_per_s"] for r in own),
          "wall_s": wall, "card": smi})
    if own[-1]["step"] != result["total_iters"] or not result["psnr_db"] >= 15.0:
        raise AssertionError(f"converge_controlnet: did not learn ({result})")


# --- the compat zoo: mmseg's EncoderDecoder surface ----------------------------

COMPAT_K = 5
# tiny heads for compat_reference: every registry head that EncoderDecoder
# can drive (ocr and point take a previous stage's logits, and dpt cannot be
# built with num_classes, as in the JAX package)
COMPAT_TINY_HEADS = {
    "psp": dict(channels=16), "uper": dict(channels=16),
    "aspp": dict(channels=16, dilations=(1, 2)),
    "sep_aspp": dict(channels=16, c1_channels=8, dilations=(1, 2)),
    "segformer": dict(channels=16), "da": dict(channels=16), "nl": dict(channels=16),
    "lraspp": dict(channels=16), "fpn": dict(channels=16), "setr_up": dict(channels=16),
    "setr_mla": dict(channels=16), "fcn": dict(channels=16), "nn": dict(channels=16),
    "identity": {}}


# part II (compat_heads2.py): every head EncoderDecoder can drive (STDCHead's
# one channel cannot: ROADMAP queue 3); PSA's attention convs fit the tiny
# ResNet's 2^2 top map at 64^2
COMPAT_TINY_HEADS2 = {
    "ann": dict(channels=16, project_channels=8), "apc": dict(channels=16),
    "cc": dict(channels=16), "dm": dict(channels=16), "dnl": dict(channels=16),
    "ema": dict(channels=16, ema_channels=16, num_bases=8),
    "enc": dict(channels=16, num_codes=8), "gc": dict(channels=16),
    "isa": dict(channels=16, isa_channels=8, down_factor=(2, 2)),
    "knet": dict(channels=16, num_stages=2, num_heads=2),
    "psa": dict(channels=16, feat_size=(2, 2)),
    "segmenter_mask": dict(embed_dims=16, num_heads=2), "sep_fcn": dict(channels=16)}
# the real-time backbones (lightweight.py) at narrow widths, each under an
# FCN head (Fast-SCNN: its SepFCNHead), BiSeNetV1's STDC context at JAX's
# fixed base 64
COMPAT_TINY_BACKBONES = {
    "stdc1": ("STDCNet", dict(base=8)), "stdc2": ("STDCNet", dict(base=8, blocks=(4, 5, 3))),
    "bisenetv1": ("BiSeNetV1", dict(channels=8, spatial_channels=(8, 8, 8, 16))),
    "bisenetv2": ("BiSeNetV2", dict(detail_channels=(8, 8, 16),
                                    semantic_channels=(8, 8, 16, 16))),
    "fast_scnn": ("FastSCNN", dict(channels=(8, 8, 16), global_channels=(8, 16, 16))),
    "cgnet": ("CGNet", dict(channels=(8, 16, 16), blocks=(1, 2))),
    "erfnet": ("ERFNet", dict(channels=(8, 16, 32)))}
# part II-b (transformer_backbones.py) at narrow widths under an FCN head:
# Twins-PCPVT, Twins-SVT whose LSA windows of 3 divide none of a 64^2
# image's grids (every LSA takes the padded path), BEiT on its 8^2 grid,
# EfficientNet (SAME stride-2 pads, a residual block)
_TINY_TWINS = dict(dims=(8, 16, 24, 32), num_heads=(1, 2, 2, 4), sr_ratios=(4, 2, 2, 1))
COMPAT_TINY_BACKBONES2 = {
    "twins_pcpvt": ("Twins", dict(_TINY_TWINS, depths=(1, 2, 1, 1))),
    "twins_svt": ("Twins", dict(_TINY_TWINS, depths=(2, 2, 3, 1), svt=True, window_size=3)),
    "beit": ("BEiT", dict(embed_dim=32, depth=3, num_heads=2, patch_size=8,
                          out_indices=(0, 1, 2), grid=(8, 8))),
    "efficientnet": ("EfficientNet", dict(width_mult=0.25, depth_mult=0.5))}


def compat_tiny(name: str):
    """A tiny compat segmentor: an EncoderDecoder with the registry head
    ``name`` (part I or II) on a width-8 ResNet-18 (SETR-MLA on a nano ViT,
    whose taps share one grid), 'cascade': FCN -> OCR on a tiny HRNet, or
    'backbone:<name>': a backbone of COMPAT_TINY_BACKBONES (real-time) or
    COMPAT_TINY_BACKBONES2 (Twins, BEiT, EfficientNet) under an FCN head.
    Weights from init_params_(seed 0), the attention gates that start at 0
    (DAHead's, CC's) set to 0.1 so that the attention carries signal."""
    from ddp_tpu_torch.models.compat_segmentor import CascadeEncoderDecoder, EncoderDecoder
    from ddp_tpu_torch.nn import lightweight, transformer_backbones
    from ddp_tpu_torch.nn.common import init_params_
    from ddp_tpu_torch.nn.mobile_hrnet import HRNet
    from ddp_tpu_torch.nn.resnet import ResNet
    from ddp_tpu_torch.nn.vit import VisionTransformer, vit_variant

    if name == "cascade":
        model = CascadeEncoderDecoder(HRNet((4, 8, 16, 32), 1, (1, 1, 1)), COMPAT_K,
                                      channels=16, ocr_channels=8)
    elif name.startswith("backbone:"):
        key = name.split(":")[1]
        module = lightweight if key in COMPAT_TINY_BACKBONES else transformer_backbones
        cls, kw = {**COMPAT_TINY_BACKBONES, **COMPAT_TINY_BACKBONES2}[key]
        head = "sep_fcn" if cls == "FastSCNN" else "fcn"
        model = EncoderDecoder(getattr(module, cls)(**kw), head, COMPAT_K,
                               head_kwargs=dict(channels=16))
    else:
        backbone = (VisionTransformer(**vit_variant("nano"), patch_size=4, pretrain_grid=6)
                    if name == "setr_mla" else
                    ResNet(depth=18, stem_channels=8, base_channels=8))
        kw = COMPAT_TINY_HEADS[name] if name in COMPAT_TINY_HEADS else COMPAT_TINY_HEADS2[name]
        model = EncoderDecoder(backbone, name, COMPAT_K, head_kwargs=kw)
    init_params_(model, 0)
    with torch.no_grad():
        for n, p in model.named_parameters():
            if n.endswith("gamma"):
                p.fill_(0.1)
    return model


# the parameters a compat model's loss does not reach, where JAX's gradient
# is 0: EMANet's frozen ema_mid and BiSeNetV2's computed-and-dropped bga_s2
# branch (both run under torch.no_grad), and Fast-SCNN's fusion module, whose
# map JAX's EncoderDecoder does not decode (ROADMAP queue 3); in
# compat_depth, binsformer_swint's Swin stages 1-3, merges and out norms,
# which JAX's BinsFormerHead does not read (_binsformer_unreached, 145
# tensors). The loss of every other model must reach every parameter.
_EMA_MID = ("decode_head.ema_mid.weight", "decode_head.ema_mid.bias")
_CBR = ("conv.weight", "bn.weight", "bn.bias")
COMPAT_UNREACHED = {
    "ema": _EMA_MID, "emanet_r50-d8": _EMA_MID,
    "backbone:bisenetv2": tuple(f"backbone.bga_s2_{p}" for p in _CBR),
    "fast_scnn": tuple(f"backbone.ffm_{m}_{p}" for m in ("dw", "hi", "up") for p in _CBR)}


def grads_of(loss, named, unreached=()):
    """``autograd.grad`` over every named parameter, as strict as its default
    but for ``unreached``: the loss must reach every parameter except
    exactly those, which get 0 (JAX's gradient for them)."""
    grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
    missed = {n for (n, _), g in zip(named, grads) if g is None}
    if missed != set(unreached):
        raise AssertionError(f"the loss does not reach {sorted(missed)}; "
                             f"expected {sorted(unreached)}")
    return [torch.zeros_like(p) if g is None else g for (_, p), g in zip(named, grads)]


def _dropout_off(model):
    for m in model.modules():
        if isinstance(getattr(m, "dropout", None), float):
            m.dropout = 0.0
    return model


def _compat_run(model, img, gt, dtype, forward=None, loss_fn=None, unreached=()):
    """(eval outputs, train loss, logs, {name: grad}, {name: EMA bases after
    the train forward}) of a copy of ``model`` in ``dtype`` on img's
    device, dropout off. A segmentor by default; a module alone through
    ``forward(m, x)`` (its eval outputs) and ``loss_fn(m, x)`` (its loss).
    The loss reaches every parameter but ``unreached`` (grads_of)."""
    import copy

    m = copy.deepcopy(model).to(img.device, dtype).eval()
    x = img.to(dtype)
    with torch.no_grad():
        logits = forward(m, x) if forward else m.forward_logits(x)
    logits = [t for t in (logits if isinstance(logits, tuple) else (logits,)) if t is not None]
    _dropout_off(m).train()
    loss, logs = loss_fn(m, x) if loss_fn else m(x, gt)
    grads = grads_of(loss, list(m.named_parameters()), unreached)
    return ([t.cpu() for t in logits], loss.item(), {k: v.item() for k, v in logs.items()},
            {n: g.cpu() for (n, _), g in zip(m.named_parameters(), grads)},
            {n: b.cpu() for n, b in m.named_buffers() if n.endswith("bases")})


def _packed(shapes, g, b: int = 4):
    """One flat [b, n] tensor of seeded maps [b, h, w, c] for each (h, w, c)
    of ``shapes`` (a module alone takes one input tensor) and the function
    that splits it back into the maps."""
    x = torch.cat([torch.randn(b, h * w * c, generator=g) for h, w, c in shapes], 1)

    def split(t):
        out, i = [], 0
        for h, w, c in shapes:
            out.append(t[:, i:i + h * w * c].reshape(t.shape[0], h, w, c))
            i += h * w * c
        return out

    return x, split


def _sq_loss(outs):
    loss = sum(o.square().mean() for o in outs)
    return loss, {"loss": loss}


def _tuple(o):
    return o if isinstance(o, tuple) else (o,)


def compat_modules_alone(g):
    """The part-II modules no EncoderDecoder drives, each with its input and
    its eval outputs and loss: STDCHead on the boundary targets of blocky
    labels (BCE with logits) and ICNeck on three maps (the mean square of
    its outputs). name -> (module, input, forward, loss_fn, targets)."""
    import torch.nn.functional as F

    from ddp_tpu_torch.nn.common import init_params_
    from ddp_tpu_torch.nn.compat_heads2 import STDCHead, stdc_boundary_targets
    from ddp_tpu_torch.nn.lightweight import ICNeck

    labels = torch.randint(0, COMPAT_K, (4, 5, 5), generator=g)
    labels = labels.repeat_interleave(4, 1).repeat_interleave(4, 2)[:, :16, :16]
    stdc, neck = STDCHead([8], channels=16), ICNeck([8, 16, 32], channels=8)
    for mod in (stdc, neck):
        init_params_(mod, 0)
    maps, split = _packed(((16, 16, 8), (8, 8, 16), (4, 4, 32)), g)

    def stdc_loss(m, x):
        target = stdc_boundary_targets(labels.to(x.device)).to(x.dtype)
        loss = F.binary_cross_entropy_with_logits(m([split(x)[0]])[..., 0], target)
        return loss, {"loss_bd": loss}

    return {"stdc_head": (stdc, maps, lambda m, x: m([split(x)[0]]), stdc_loss, labels),
            "icneck": (neck, maps, lambda m, x: m(split(x)), lambda m, x: _sq_loss(m(split(x))),
                       None)}


def compat_modules_part2(g):
    """The part II-b/c modules that no EncoderDecoder drives, each at a tiny
    width on seeded maps (batch 4), its loss the mean square of its outputs:
    DiffSwin at t = (0.1, 0.4, 0.7, 0.95), every neck (Feature2Pyramid at
    each rescale, HAHI over 3 transformer levels, SkipNeck behind a
    MultiLevelNeck: it has no weights of its own) and every depth head.
    name -> (module, input, forward, loss_fn, None), as compat_modules_alone."""
    from ddp_tpu_torch.nn import depth_heads as dh, necks as nk
    from ddp_tpu_torch.nn.common import init_params_
    from ddp_tpu_torch.nn.diffswin import DiffSwinTransformer

    pyr = ((16, 16, 8), (8, 8, 16), (4, 4, 24), (2, 2, 32))
    ch = [c for _, _, c in pyr]
    t = torch.tensor([0.1, 0.4, 0.7, 0.95])
    hahi = dict(embedding_dim=16, num_points=2, num_heads=2)
    mods = {
        "diffswin": (DiffSwinTransformer(8, (2, 1, 1, 1), (1, 2, 2, 2), window=4,
                                         drop_path_rate=0.0, time_dim=16), None),
        # 64 channels: GroupNorm's 32 groups hold 2 channels of the scale-1
        # branch's 1x1 map (with 1, its output is its bias and the conv's
        # gradient is rounding on both devices)
        "ppm": (nk.PPM(16, 64), ((13, 14, 16),)),
        "psp_neck": (nk.PSPNeck([8, 16], 64), ((16, 16, 8), (12, 13, 16))),
        "multilevel+skip": (torch.nn.Sequential(nk.MultiLevelNeck([16] * 4, 8), nk.SkipNeck()),
                            ((8, 8, 16),) * 4),
        "f2p": (nk.Feature2Pyramid(16), ((5, 6, 16),) * 4),
        "f2p_quarter": (nk.Feature2Pyramid(16, rescales=(0.25, 2.0, 1.0)), ((9, 10, 16),) * 3),
        "hahi": (nk.HAHINeck(ch, (8, 16, 16, 16), **hahi), pyr),
        "jpu": (nk.JPU(ch, mid_channels=8, dilations=(1, 2), start_level=1), pyr),
        "densedepth": (dh.DenseDepthHead(ch, (8, 16, 16, 32)), pyr),
        "adabins": (dh.AdabinsHead(ch, (16, 16), (8, 16, 16, 32), n_bins=16, n_query_channels=8,
                                   embedding_dim=16, patch_size=4), pyr),
        "bts": (dh.BTSHead(ch, channels=8), pyr),
        "newcrf": (dh.NeWCRFHead(ch, channels=8), ((10, 14, 8), (5, 7, 16), (3, 4, 24),
                                                   (2, 2, 32))),
        "binsformer": (dh.BinsFormerHead(ch, n_bins=8, channels=16), pyr),
    }
    out = {}
    for name, (mod, shapes) in mods.items():
        init_params_(mod, 0)
        if shapes is None:  # DiffSwin: an image and t
            x = torch.randn(4, 64, 64, 3, generator=g)

            def fwd(m, x):
                return m(x, t.to(x))
        else:
            x, split = _packed(shapes, g)

            def fwd(m, x, split=split, one=name == "ppm"):
                return tuple(m(split(x)[0])) if one else _tuple(m(split(x)))
        out[name] = (mod, x, fwd, lambda m, x, fwd=fwd: _sq_loss(_tuple(fwd(m, x))), None)
    return out


def compat_loss_checks(g):
    """The zoo's losses (nn/losses.py) on the card and on the CPU from the
    same seeded inputs: labels with ignored pixels and an absent class,
    Lovász 'present' and 'all', the hinge per image and over the batch, the
    chamfer loss with an image without valid depth. name -> the float32
    value's relative difference and the float64 gradient's difference over
    its max."""
    from ddp_tpu_torch.nn import losses as L

    k = COMPAT_K
    logits = torch.randn(4, 32, 32, k, generator=g)
    labels = torch.randint(0, k - 1, (4, 32, 32), generator=g)
    labels[:, :3] = 255
    bin_logits = torch.randn(4, 32, 32, generator=g)
    bin_labels = torch.randint(0, 2, (4, 32, 32), generator=g)
    bin_labels[1, 4:9] = 255
    edges = torch.cumsum(0.1 + torch.rand(4, 17, generator=g), 1)
    depth = 0.5 + 5.0 * torch.rand(4, 32, 32, generator=g)
    depth[0, :4] = 0.0
    depth[2] = 0.0
    bins = torch.randint(0, k, (4, 32, 32), generator=g)
    cases = {
        "dice_loss": (lambda x, d: L.dice_loss(x, d["labels"]), logits),
        "tversky_loss": (lambda x, d: L.tversky_loss(x, d["labels"]), logits),
        "lovasz_softmax_present": (lambda x, d: L.lovasz_softmax(x, d["labels"]), logits),
        "lovasz_softmax_all": (lambda x, d: L.lovasz_softmax(x, d["labels"], "all"), logits),
        "lovasz_hinge_per_image": (lambda x, d: L.lovasz_hinge(x, d["bin_labels"]), bin_logits),
        "lovasz_hinge_batch": (lambda x, d: L.lovasz_hinge(x, d["bin_labels"], per_image=False),
                               bin_logits),
        "focal_seg_loss": (lambda x, d: L.focal_seg_loss(x, d["labels"]), logits),
        "bins_chamfer_loss": (lambda x, d: L.bins_chamfer_loss(x, d["depth"]), edges),
        "mse_depth_loss": (lambda x, d: L.mse_depth_loss(x, d["depth"]), depth.flip(1) + 0.5),
        "ce_bins_loss": (lambda x, d: L.ce_bins_loss(x, d["bins"]), logits)}
    data = {"labels": labels, "bin_labels": bin_labels, "depth": depth, "bins": bins}
    rows = {}
    for name, (fn, x) in cases.items():
        res = {}
        for dev in ("cpu", "cuda"):
            for dt in (torch.float32, torch.float64):
                d = {key: v.to(dev) for key, v in data.items()}
                d["depth"] = d["depth"].to(dt)
                xx = x.to(dev, dt).requires_grad_(True)
                loss = fn(xx, d)
                (grad,) = torch.autograd.grad(loss, [xx])
                res[dev, dt] = (loss.item(), grad.cpu())
        v_cpu, v_card = res["cpu", torch.float32][0], res["cuda", torch.float32][0]
        g_cpu, g_card = res["cpu", torch.float64][1], res["cuda", torch.float64][1]
        rows[name] = {"value": v_cpu, "value_rel_diff_f32": abs(v_card - v_cpu) / abs(v_cpu),
                      "grad_rel_diff_f64": ((g_card - g_cpu).abs().max()
                                            / g_cpu.abs().max()).item()}
    return rows


def _all_maps_loss(gt):
    """A tiny backbone segmentor's loss on ``gt`` plus the mean square of
    each backbone map."""
    def loss_fn(m, x):
        loss, logs = m(x, gt.to(x.device))
        return loss + sum(f.square().mean() for f in m.backbone(x)), logs
    return loss_fn


def phase_compat_reference(smi: str):
    """Each tiny compat model on the card and on the CPU from the same
    weights and batch (4 x 64^2, 5 classes, ignored pixels; the deepest maps
    are 2^2, so a train-mode BatchNorm there sees 16 values a channel),
    dropout off: compat_tiny's 14 part-I EncoderDecoder heads, the FCN ->
    OCR cascade on HRNet, the 13 part-II heads EncoderDecoder can drive
    (EncNet's log keys hold loss_se) and the 7 real-time backbones; then
    STDCHead on stdc_boundary_targets and ICNeck as modules alone
    (compat_modules_alone). A backbone's loss adds the mean square of each
    of its maps, so that the gradient reaches the branches EncoderDecoder
    does not decode; every loss must reach every parameter but
    COMPAT_UNREACHED's. Float32 eval logits within 1e-4 and the
    train-mode loss within 1e-5 relative; every gradient within 1e-4 of its
    max (+ 1e-9 of the model's largest, for tensors whose gradient is 0 but
    for rounding), in float64: in float32 a ReLU input within rounding of 0
    can take the other side on the other device and move every gradient
    upstream (the float32 gradients' worst difference is recorded); EMANet's
    bases after the train forward within 1e-5 of their max (float32), and
    moved; the boundary targets bitwise."""
    from ddp_tpu_torch.nn.compat_heads2 import stdc_boundary_targets

    t0 = time.perf_counter()
    g = _gen(71)
    img = torch.randn(4, 64, 64, 3, generator=g)
    gt = torch.randint(0, COMPAT_K, (4, 64, 64), generator=g)
    gt[:, :2] = 255
    gt[1][gt[1] == 2] = 255  # class 2 absent from image 1: an SE target of 0
    rows, worst = {}, {"logits": 0.0, "loss_rel": 0.0, "grad_rel_f64": 0.0, "bases_rel": 0.0}
    alone = {**compat_modules_alone(g), **compat_modules_part2(g)}
    names = (list(COMPAT_TINY_HEADS) + ["cascade"] + list(COMPAT_TINY_HEADS2)
             + [f"backbone:{b}" for b in (*COMPAT_TINY_BACKBONES, *COMPAT_TINY_BACKBONES2)]
             + list(alone))
    for name in names:
        if name in alone:
            model, x, fwd, loss_fn, labels = alone[name]
        else:
            model, x, fwd, loss_fn, labels = compat_tiny(name), img, None, None, None
            if name.startswith("backbone:"):
                loss_fn = _all_maps_loss(gt)
        unreached = COMPAT_UNREACHED.get(name, ())
        res = {}
        for dev in ("cpu", "cuda"):
            res[dev] = {dt: _compat_run(model, x.to(dev), gt.to(dev), dt, fwd, loss_fn,
                                        unreached)
                        for dt in (torch.float32, torch.float64)}
        c32, g32 = res["cpu"][torch.float32], res["cuda"][torch.float32]
        c64, g64 = res["cpu"][torch.float64], res["cuda"][torch.float64]
        logit_diff = max((a - b).abs().max().item() for a, b in zip(c32[0], g32[0]))
        loss_rel = abs(c32[1] - g32[1]) / abs(c32[1])

        def grad_rel(a, b):
            # a tensor's difference over its limit's scale: its own max plus
            # 1e-9 of the model's largest (biases right before a train-mode
            # BatchNorm, or a key's bias under softmax, get a gradient of 0
            # plus rounding, where a ratio to their own max means nothing)
            top = max(a[n].abs().max().item() for n in a)
            return max(((a[n] - b[n]).abs().max()
                        / (a[n].abs().max() + 1e-9 * top).clamp_min(1e-300)).item() for n in a)

        rows[name] = {"logits_max_abs_diff": logit_diff, "loss_rel_diff": loss_rel,
                      "logs": sorted(c32[2]), "grad_rel_diff_f64": grad_rel(c64[3], g64[3]),
                      "grad_rel_diff_f32": grad_rel(c32[3], g32[3]), "tensors": len(c32[3]),
                      "unreached": len(unreached)}
        worst["logits"] = max(worst["logits"], logit_diff)
        worst["loss_rel"] = max(worst["loss_rel"], loss_rel)
        worst["grad_rel_f64"] = max(worst["grad_rel_f64"], rows[name]["grad_rel_diff_f64"])
        for key, b in c32[4].items():  # the EMA bases after one train-mode forward
            rel = ((b - g32[4][key]).abs().max() / b.abs().max()).item()
            moved = not torch.equal(b, dict(model.named_buffers())[key].float())
            rows[name]["bases"] = {"rel_diff": rel, "moved": moved}
            worst["bases_rel"] = max(worst["bases_rel"], rel if moved else float("inf"))
        if labels is not None:  # the boundary targets, card against CPU
            rows[name]["targets_bitwise"] = torch.equal(
                stdc_boundary_targets(labels), stdc_boundary_targets(labels.cuda()).cpu())
            if not rows[name]["targets_bitwise"]:
                worst["targets"] = "differ"
    if "loss_se" not in rows["enc"]["logs"]:
        worst["enc_logs"] = rows["enc"]["logs"]
    losses = compat_loss_checks(g)
    worst["zoo_loss_rel"] = max(r["value_rel_diff_f32"] for r in losses.values())
    worst["zoo_loss_grad_rel_f64"] = max(r["grad_rel_diff_f64"] for r in losses.values())
    line = {"phase": "compat_reference", "batch": list(img.shape), "classes": COMPAT_K,
            "models": rows, "zoo_losses": losses, "worst": worst,
            "limits": "logits 1e-4 abs, loss 1e-5 relative, EMA bases 1e-5 of their max "
                      "(float32); each gradient 1e-4 of its max + 1e-9 of the model's "
                      "largest (float64); boundary targets bitwise; the zoo's losses: value "
                      "1e-5 relative (float32), gradient 1e-4 of its max (float64)",
            "wall_s": time.perf_counter() - t0, "card": smi}
    emit(line)
    if not (worst["logits"] <= 1e-4 and worst["loss_rel"] <= 1e-5
            and worst["grad_rel_f64"] <= 1e-4 and worst["bases_rel"] <= 1e-5
            and worst["zoo_loss_rel"] <= 1e-5 and worst["zoo_loss_grad_rel_f64"] <= 1e-4
            and "targets" not in worst and "enc_logs" not in worst):
        raise AssertionError(f"compat_reference: card vs CPU {worst}")


def compat_configs():
    """The twelve published configurations of compat_main, at their widths:
    (name, mmseg config, builder, image size, classes). Part II (EncNet,
    CCNet, EMANet on ResNetV1c-50 D8 with the FCN aux head on stage 3;
    Fast-SCNN under JAX's EncoderDecoder, which decodes its last map and
    puts the FCN aux on the one before: ROADMAP queue 3). Part II-b: Twins
    PCPVT-S and SVT-S under UPerHead 512 (drop path 0.2), BEiT-B under
    Feature2Pyramid and UPerHead 768 at 640^2 (drop path 0.1), each with the
    FCN aux head on its third map, as mmseg's in_index 2."""
    from ddp_tpu_torch.models.compat_segmentor import CascadeEncoderDecoder, EncoderDecoder
    from ddp_tpu_torch.nn.compat_heads import DPTHead
    from ddp_tpu_torch.nn.lightweight import FastSCNN
    from ddp_tpu_torch.nn.mit import MixVisionTransformer, mit_variant
    from ddp_tpu_torch.nn.mobile_hrnet import HRNet
    from ddp_tpu_torch.nn.necks import Feature2Pyramid
    from ddp_tpu_torch.nn.resnet import ResNet
    from ddp_tpu_torch.nn.transformer_backbones import BEiT, Twins
    from ddp_tpu_torch.nn.vit import VisionTransformer, vit_variant

    def beit():
        # BEiT-B, patch 16 at 640^2 (the one 40^2 grid its table is built
        # for), taps 3/5/7/11 through Feature2Pyramid(768, (4, 2, 1, 0.5))
        return EncoderDecoder(BackboneWithNeck(
            BEiT(drop_path_rate=0.1, grid=(40, 40)), Feature2Pyramid(768, (4.0, 2.0, 1.0, 0.5))),
            "uper", 150, head_kwargs=dict(channels=768))

    def dpt():
        # JAX's EncoderDecoder hands num_classes to every registry head, and
        # DPTHead takes out_channels (ROADMAP queue 3): the head is set on an
        # EncoderDecoder by hand, as a user would
        model = EncoderDecoder(VisionTransformer(**vit_variant("base"), patch_size=16),
                               "identity", 150, aux_head=False)
        model.decode_head = DPTHead(150, [768] * 4, channels=256,
                                    post_channels=(96, 192, 384, 768), mode="seg")
        return model

    r50_d8 = dict(depth=50, strides=(1, 2, 1, 1), dilations=(1, 1, 2, 4))
    return (
        ("upernet_r50", "configs/upernet/upernet_r50_512x512_160k_ade20k.py",
         lambda: EncoderDecoder(ResNet(depth=50), "uper", 150, head_kwargs=dict(channels=512)),
         (512, 512), 150),
        ("deeplabv3plus_r50-d8",
         "configs/deeplabv3plus/deeplabv3plus_r50-d8_512x1024_40k_cityscapes.py",
         lambda: EncoderDecoder(ResNet(depth=50, strides=(1, 2, 1, 1), dilations=(1, 1, 2, 4)),
                                "sep_aspp", 19, head_kwargs=dict(
                                    channels=512, c1_channels=48, dilations=(1, 12, 24, 36))),
         (512, 1024), 19),
        ("ocrnet_hr18", "configs/ocrnet/ocrnet_hr18_512x1024_40k_cityscapes.py",
         lambda: CascadeEncoderDecoder(HRNet((18, 36, 72, 144), 4, (1, 4, 3)), 19,
                                       channels=512, ocr_channels=256),
         (512, 1024), 19),
        ("segformer_mit-b0", "configs/segformer/segformer_mit-b0_512x512_160k_ade20k.py",
         lambda: EncoderDecoder(MixVisionTransformer(**mit_variant("b0")), "segformer", 150,
                                head_kwargs=dict(channels=256), aux_head=False),
         (512, 512), 150),
        ("dpt_vit-b16", "configs/dpt/dpt_vit-b16_512x512_160k_ade20k.py", dpt, (512, 512), 150),
        ("encnet_r50-d8", "configs/encnet/encnet_r50-d8_512x1024_40k_cityscapes.py",
         lambda: EncoderDecoder(ResNet(**r50_d8), "enc", 19, head_kwargs=dict(
             channels=512, num_codes=32, use_se_loss=True)), (512, 1024), 19),
        ("ccnet_r50-d8", "configs/ccnet/ccnet_r50-d8_512x1024_40k_cityscapes.py",
         lambda: EncoderDecoder(ResNet(**r50_d8), "cc", 19, head_kwargs=dict(
             channels=512, recurrence=2, concat_input=True)), (512, 1024), 19),
        ("emanet_r50-d8", "configs/emanet/emanet_r50-d8_512x1024_80k_cityscapes.py",
         lambda: EncoderDecoder(ResNet(**r50_d8), "ema", 19, head_kwargs=dict(
             channels=256, ema_channels=512, num_bases=64, num_stages=3, momentum=0.1)),
         (512, 1024), 19),
        ("fast_scnn", "configs/fastscnn/fast_scnn_lr0.12_8x4_160k_cityscapes.py",
         lambda: EncoderDecoder(FastSCNN(), "sep_fcn", 19, head_kwargs=dict(
             channels=128, concat_input=False)), (512, 1024), 19),
        ("twins_pcpvt-s_upernet", "configs/twins/twins_pcpvt-s_uperhead_8x4_512x512_160k_ade20k.py",
         lambda: EncoderDecoder(Twins(drop_path_rate=0.2), "uper", 150,
                                head_kwargs=dict(channels=512)), (512, 512), 150),
        ("twins_svt-s_upernet", "configs/twins/twins_svt-s_uperhead_8x2_512x512_160k_ade20k.py",
         lambda: EncoderDecoder(Twins(dims=(64, 128, 256, 512), depths=(2, 2, 10, 4),
                                      num_heads=(2, 4, 8, 16), svt=True, window_size=7,
                                      drop_path_rate=0.2), "uper", 150,
                                head_kwargs=dict(channels=512)), (512, 512), 150),
        ("upernet_beit-base", "configs/beit/upernet_beit-base_8x2_640x640_160k_ade20k.py", beit,
         (640, 640), 150),
    )


def compat_row(model, predict, check, step, lr: float, batch: int, unreached=()) -> dict:
    """What every compat_main and compat_depth row measures of a model on the
    card: ``predict()`` once with the kernel counts from 0 (``check``
    validates its output), then the median of 5 calls after it (ms, img/s),
    the busy share of one profiled call and the peak GB with what was live
    before; then 3 eager train steps of ``batch`` images, ``step()`` ->
    (loss, logs) in train mode (dropout and drop path on), every parameter's
    gradient through grads_of (``unreached`` get 0, as JAX gives them) and
    the port's AdamW (``lr``, constant): step ms, peak GB, the losses and
    logs of each step, whether the loss moved, the kernel counts from 0."""
    from ddp_tpu_torch.train.optim import AdamW, OptimConfig

    torch.cuda.reset_peak_memory_stats()
    live = torch.cuda.memory_allocated() / 1e9
    reset_all_launches()
    out = predict()
    torch.cuda.synchronize()
    serve_counts = all_launches()
    check(out)
    del out
    serve_ms = wall_s(predict, reps=5, warmup=0) * 1e3
    p, wall_ms = profiled(predict, timed=True)
    serve_busy = busy(p, wall_ms)
    del p
    serve_peak = torch.cuda.max_memory_allocated() / 1e9
    params = list(model.named_parameters())
    opt = AdamW(OptimConfig(lr=lr, schedule="constant", warmup_steps=0, warmup_ratio=1.0,
                            grad_clip=1e9), params)
    model.train()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    losses, step_ms, logs_seen = [], [], {}
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss, logs = step()
        grads = grads_of(loss, params, unreached)
        opt.step(grads)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        losses.append(loss.item())
        for key, v in logs.items():
            logs_seen.setdefault(key, []).append(v.item())
        del grads, loss, logs
    return {"parameters": sum(p.numel() for _, p in params), "predict_ms": serve_ms,
            "img_per_s": 1e3 / serve_ms, "predict_busy": serve_busy,
            "predict_peak_gb": serve_peak, "live_before_gb": live, "train_batch": batch,
            "step_ms": step_ms, "train_img_per_s": batch * 1e3 / statistics.median(step_ms[1:]),
            "train_peak_gb": torch.cuda.max_memory_allocated() / 1e9, "losses": losses,
            "logs": logs_seen, "loss_moved": abs(losses[-1] - losses[0]) > 1e-4 * abs(losses[0]),
            "launches_serve": serve_counts, "launches_train": all_launches(),
            "unreached": len(unreached)}


def row_failed(row: dict) -> bool:
    """A row launched one of the five kernels, or its loss did not move or
    was not finite."""
    return (row["launches_serve"] != NO_KERNELS or row["launches_train"] != NO_KERNELS
            or not row["loss_moved"]
            or not all(np.isfinite(v) for vs in row["logs"].values() for v in vs)
            or not all(np.isfinite(row["losses"])))


def add_launches(launches: dict, row: dict) -> None:
    for path in ("serve", "train"):
        for kname, n in row[f"launches_{path}"].items():
            launches[path][kname] += n


class BackboneWithNeck(torch.nn.Module):
    """backbone -> neck as one EncoderDecoder backbone: JAX's EncoderDecoder
    has no neck field, and mmseg's upernet_beit puts Feature2Pyramid
    between BEiT and UPerHead (a composition of this script, as the dpt
    row's head, not a package feature)."""

    def __init__(self, backbone, neck):
        super().__init__()
        self.backbone, self.neck = backbone, neck
        self.out_channels = neck.out_channels

    def forward(self, x, generator=None):
        return self.neck(self.backbone(x, generator))


def diffswin_row():
    """DiffSwin at Swin-T widths (embed 96, depths 2/2/6/2, heads
    3/6/12/24, window 7, time MLP 1024, drop path 0.3), random weights
    (init_params_, seed 0), float32 TF32 off. Nothing in JAX puts a head on
    it, so its loss is the mean square of its four maps: the maps of one
    512^2 image move between t = 0.5 and 0.9; then compat_row with the eval
    forward at t = 0.5 as predict and steps at 2 x 512^2, t ~ U(0, 1), AdamW
    lr 1e-4 (the maps leave LayerNorms, so their mean square is ~1 each
    whatever the blocks do: at 1e-5 it moved by 5e-5 in 3 steps)."""
    from ddp_tpu_torch.nn.common import init_params_
    from ddp_tpu_torch.nn.diffswin import DiffSwinTransformer

    t0 = time.perf_counter()
    model = DiffSwinTransformer()
    init_params_(model, 0)
    model = model.cuda()
    build_s = time.perf_counter() - t0
    g = torch.Generator(device="cuda").manual_seed(0)
    img = torch.randn(2, 512, 512, 3, device="cuda", generator=g)
    one, half = img[:1], torch.full((1,), 0.5, device="cuda")

    @torch.no_grad()
    def predict(t=half):
        return model.eval()(one, t)

    moves = min((a - b).abs().max().item()
                for a, b in zip(predict(), predict(torch.full((1,), 0.9, device="cuda"))))
    shapes = []

    def check(maps):
        shapes.extend(list(m.shape) for m in maps)
        if not all(bool(torch.isfinite(m).all()) for m in maps) or not moves > 1e-4:
            raise AssertionError(f"compat_main diffswin_t: maps {shapes}, t moves them {moves}")

    def step():
        loss = sum(m.square().mean() for m in model(img, torch.rand(2, device="cuda", generator=g),
                                                      g))
        return loss, {"loss": loss}

    row = compat_row(model, predict, check, step, 1e-4, 2)
    row = {"source": "mmseg backbones/diffswin.py DiffSwinTransformer (the reference's "
                     "experimental DDP backbone) at Swin-T widths; no head in JAX: loss = the "
                     "mean square of its four maps",
           "image": [512, 512], "build_s": build_s, "map_shapes": shapes,
           "max_map_change_t_0.5_to_0.9": moves, **row}
    del model, img, one
    gc.collect()
    torch.cuda.empty_cache()
    if row_failed(row):
        emit({"phase": "compat_main", "failed": "diffswin_t", **row})
        raise AssertionError(f"compat_main diffswin_t: {row}")
    return row


def phase_compat_main(smi: str):
    """The twelve published compat configurations (compat_configs) at their
    widths with random weights (init_params_, seed 0), float32, TF32 off:
    predict() of one image (the median of 5 calls after one: ms, img/s, busy
    share of one profiled call, peak memory), then 3 eager train steps at
    batch 2 on one batch (dropout and drop path on, CUDA generator):
    forward, backward (every parameter's gradient: the loss reaches all but
    COMPAT_UNREACHED's, which get 0, as in JAX) and the port's AdamW (lr 1e-5, constant), step ms
    and peak memory; the loss finite and moving; 0 launches of the five
    kernels on both paths; EncNet's SE loss and whether EMANet's bases
    moved; then DiffSwin at Swin-T widths (diffswin_row). Returns the
    launches, summed over the configurations."""
    from ddp_tpu_torch.nn.common import init_params_

    t_phase = time.perf_counter()
    launches = {"serve": dict(NO_KERNELS), "train": dict(NO_KERNELS)}
    rows = {}
    for name, source, build, (h, w), k in compat_configs():
        t0 = time.perf_counter()
        model = build()
        init_params_(model, 0)
        model = model.cuda()
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        g = torch.Generator(device="cuda").manual_seed(0)
        img = torch.randn(2, h, w, 3, device="cuda", generator=g)
        gt = torch.randint(0, k, (2, h, w), device="cuda", generator=g)
        one = img[:1]
        bases0 = {n: b.clone() for n, b in model.named_buffers() if n.endswith("bases")}

        def check(pred, name=name, h=h, w=w, k=k):
            if tuple(pred.shape) != (1, h, w) or not bool(((pred >= 0) & (pred < k)).all()):
                raise AssertionError(f"compat_main {name}: predict {tuple(pred.shape)}")

        # lr 1e-5 without warm-up: at 1e-4 dpt_vit-b16's loss rose 9.4 ->
        # 19.2 -> 63.9 in these 3 steps
        row = compat_row(model, lambda: model.predict(one), check, lambda: model(img, gt, g),
                         1e-5, 2, COMPAT_UNREACHED.get(name, ()))
        for n, b in bases0.items():
            row["bases_moved"] = bool((model.get_buffer(n) - b).abs().max() > 0)
        rows[name] = {"source": source, "image": [h, w], "classes": k, "build_s": build_s, **row}
        add_launches(launches, row)
        del model, img, gt, one, bases0
        gc.collect()
        torch.cuda.empty_cache()
        if (row_failed(row) or row.get("bases_moved") is False
                or (name.startswith("encnet") and "loss_se" not in row["logs"])):
            emit({"phase": "compat_main", "failed": name, **rows[name]})
            raise AssertionError(f"compat_main {name}: launches {row['launches_serve']} "
                                 f"{row['launches_train']}, losses {row['losses']}")
    rows["diffswin_t"] = diffswin_row()
    add_launches(launches, rows["diffswin_t"])
    emit({"phase": "compat_main", "dtype": "float32, tf32 off", "weights": "init_params_(seed 0)",
          "configs": rows, "wall_s": time.perf_counter() - t_phase, "card": smi})
    return launches


# --- the compat zoo's depth heads: the depth toolbox's NYUv2 configurations ---

class DepthComposite(torch.nn.Module):
    """backbone -> (neck) -> a head of nn/depth_heads.py, its depth resized
    bilinearly to the image; the loss is sig_loss (+ ``chamfer`` ·
    bins_chamfer_loss of AdaBins' bin edges). JAX has no depth
    encoder-decoder for these heads, so the composition is this script's."""

    def __init__(self, backbone, head, neck=None, chamfer: float = 0.0, max_depth: float = 10.0):
        super().__init__()
        self.backbone, self.head = backbone, head
        if neck is not None:
            self.neck = neck
        self.chamfer, self.max_depth = chamfer, max_depth

    def depth(self, img, generator=None):
        from ddp_tpu_torch.ops.resize import resize

        feats = self.backbone(img, generator)
        if hasattr(self, "neck"):
            feats = self.neck(feats)
        out = self.head(list(feats))
        d, edges = out if isinstance(out, tuple) else (out, None)
        return resize(d, img.shape[1:3], mode="bilinear")[..., 0], edges

    def forward(self, img, gt, generator=None):
        from ddp_tpu_torch.nn.losses import bins_chamfer_loss, sig_loss

        d, edges = self.depth(img, generator)
        loss = sig_loss(d, gt)
        logs = {"loss_sig": loss}
        if self.chamfer:
            logs["loss_chamfer"] = self.chamfer * bins_chamfer_loss(edges, gt)
            loss = loss + logs["loss_chamfer"]
        return loss, dict(logs, loss=loss)

    @torch.no_grad()
    def predict(self, img):
        was = self.training
        self.eval()
        try:
            return self.depth(img)[0]
        finally:
            self.train(was)


def depth_configs():
    """The six NYUv2 configurations of compat_depth (the Monocular-Depth-
    Estimation-Toolbox's, by their config names), at the backbones' published
    widths: (name, source, build function, serving size, widths the compact JAX head
    takes from its own defaults rather than the config, cuts). The toolbox's
    5-level pyramids (a 1/2 stem level of 64 channels) lose that level: the
    port's ResNet and Swin return 4 maps, as JAX's."""
    from ddp_tpu_torch.nn import depth_heads as dh
    from ddp_tpu_torch.nn.necks import HAHINeck
    from ddp_tpu_torch.nn.resnet import ResNet
    from ddp_tpu_torch.nn.swin import SwinTransformer, swin_variant
    from ddp_tpu_torch.nn.transformer_backbones import EfficientNet

    r50 = (256, 512, 1024, 2048)
    swin = (96, 192, 384, 768)
    no_stem = "the toolbox's 1/2 stem level (64 channels) absent: 4 maps, as JAX's backbone"

    def swin_t():
        return SwinTransformer(**swin_variant("tiny"), drop_path_rate=0.3)

    def adabins():
        backbone = EfficientNet(width_mult=1.6, depth_mult=2.2)
        # the finest tap is 1/4: 104 x 136 at 416 x 544
        return DepthComposite(backbone, dh.AdabinsHead(backbone.out_channels, (104, 136)),
                              chamfer=0.1)

    return (
        ("densedepth_r50", "configs/densedepth/densedepth_r50_nyu_24e.py",
         lambda: DepthComposite(ResNet(depth=50), dh.DenseDepthHead(r50, r50)),
         (480, 640), {}, [no_stem]),
        ("bts_r50", "configs/bts/bts_r50_nyu_24e.py",
         lambda: DepthComposite(ResNet(depth=50), dh.BTSHead(r50)), (480, 640),
         {"channels": "64 (the compact head's default; BTS's bts_size is 512)",
          "_PlaneCoeffs.channels": 32}, []),
        ("adabins_efnetb5", "configs/adabins/adabins_efnetb5ap_nyu_24e.py", adabins, (416, 544),
         {"up_sample_channels": "(128, 256, 512, 1024)", "n_bins": 256,
          "n_query_channels": "128 (47 at 416x544: 48 tokens of 16^2 patches)",
          "embedding_dim": 128, "patch_size": 16, "mViT": "4 layers, 4 heads, FFN 1024"},
         ["serves at 416x544: the head is built for one map size"]),
        ("depthformer_swint", "configs/depthformer/depthformer_swint_w7_nyu.py",
         lambda: DepthComposite(swin_t(), dh.DenseDepthHead(swin, swin),
                                neck=HAHINeck(swin, swin, 256, 8, 8)), (480, 640),
         {"HAHI": "embedding 256, 8 heads, 8 points, BN"},
         [no_stem + " (DepthFormer's conv stem): HAHI's conv level is Swin stage 0"]),
        ("binsformer_swint", "configs/binsformer/binsformer_swint_w7_nyu.py",
         lambda: DepthComposite(swin_t(), dh.BinsFormerHead(swin)), (480, 640),
         {"n_bins": 16, "channels": 64, "dec_layers": 2, "num_heads": 4}, []),
        ("newcrfs_swint", "configs/newcrfs/newcrfs_swint_w7_nyu.py",
         lambda: DepthComposite(swin_t(), dh.NeWCRFHead(swin)), (480, 640),
         {"channels": 64, "crf": "4 heads, window 4"}, []),
    )


def _binsformer_unreached(model) -> tuple:
    """BinsFormerHead reads only the first map (JAX's compact head): Swin's
    later stages, merges and out norms feed nothing the loss reads."""
    later = ("downsample", "stage1", "stage2", "stage3", "out_norm1", "out_norm2", "out_norm3")
    return tuple(n for n, _ in model.named_parameters()
                 if n.startswith(tuple(f"backbone.{p}" for p in later)))


def phase_compat_depth(smi: str):
    """The six depth configurations (depth_configs) at their widths with random
    weights (init_params_, seed 0), float32, TF32 off: predict() of one
    480x640 frame (AdaBins 416x544; the median of 5 calls after one: ms,
    img/s, busy share of one profiled call, peak GB), depth finite and in
    [0, max_depth]; then 3 eager steps at 2 x 416x544 (sig_loss, AdaBins
    + 0.1 bins_chamfer_loss; max_depth 10; drop path on, CUDA generator;
    every parameter's gradient through grads_of: BinsFormer's unreached
    Swin stages named; AdamW lr 1e-4, constant), step ms and peak GB, the
    loss finite and moving; 0 launches of the five kernels on both paths.
    Returns the launches, summed over the configurations."""
    from ddp_tpu_torch.nn.common import init_params_

    t_phase = time.perf_counter()
    launches = {"serve": dict(NO_KERNELS), "train": dict(NO_KERNELS)}
    rows = {}
    for name, source, build, (h, w), head_defaults, cuts in depth_configs():
        t0 = time.perf_counter()
        model = build()
        init_params_(model, 0)
        model = model.cuda()
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        g = torch.Generator(device="cuda").manual_seed(0)
        one = torch.randn(1, h, w, 3, device="cuda", generator=g)
        img = torch.randn(2, 416, 544, 3, device="cuda", generator=g)
        gt = 0.5 + 9.0 * torch.rand(2, 416, 544, device="cuda", generator=g)
        gt[:, :26] = 0.0  # invalid rows
        depth_range = []

        def check(pred, name=name, h=h, w=w, top=model.max_depth):
            depth_range.extend([pred.min().item(), pred.max().item()])
            if (tuple(pred.shape) != (1, h, w) or not bool(torch.isfinite(pred).all())
                    or depth_range[0] < 0 or depth_range[1] > top):
                raise AssertionError(f"compat_depth {name}: predict {tuple(pred.shape)}, "
                                     f"{depth_range}")

        unreached = _binsformer_unreached(model) if name.startswith("binsformer") else ()
        row = compat_row(model, lambda: model.predict(one), check, lambda: model(img, gt, g),
                         1e-4, 2, unreached)
        rows[name] = {"source": source, "serve_image": [h, w], "train_image": [416, 544],
                      "head_widths_from_jax_defaults": head_defaults, "cuts": cuts,
                      "build_s": build_s, "depth_range_m": depth_range, **row}
        if unreached:
            rows[name]["unreached_are"] = ("Swin's downsample0-2, stages 1-3 and out_norm1-3: "
                                           "JAX's BinsFormerHead reads only the first map")
        add_launches(launches, row)
        del model, img, gt, one
        gc.collect()
        torch.cuda.empty_cache()
        if row_failed(row):
            emit({"phase": "compat_depth", "failed": name, **rows[name]})
            raise AssertionError(f"compat_depth {name}: launches {row['launches_serve']} "
                                 f"{row['launches_train']}, losses {row['losses']}")
    emit({"phase": "compat_depth", "dataset": "NYUv2 sizes, random images and depth (0.5-9.5 m, "
                                              "the top 26 rows invalid)",
          "dtype": "float32, tf32 off", "weights": "init_params_(seed 0)", "max_depth": 10.0,
          "configs": rows, "wall_s": time.perf_counter() - t_phase, "card": smi})
    return launches


# --- data-parallel training and the tools ------------------------------------------

DIST_DIR = os.path.join("work_dirs", "chip_smoke_dist")
TOOLS_DIR = os.path.join("work_dirs", "chip_smoke_tools")
ADE_FIXTURE = os.path.join("tests", "data", "ade")


def free_port() -> str:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return str(s.getsockname()[1])


def collective_kernels(p) -> dict:
    """What a profile shows of the gradient all-reduce: NCCL's kernels (by
    name) and device-to-device copies, their count and device ms."""
    out = {"nccl_kernels": 0, "nccl_device_ms": 0.0, "dtod_copies": 0, "dtod_device_ms": 0.0,
           "nccl_kernel_names": []}
    for e in device_kernels(p):
        if re.search("nccl", e.key, re.I):
            out["nccl_kernels"] += e.count
            out["nccl_device_ms"] += e.device_time_total / 1e3
            out["nccl_kernel_names"].append(e.key[:80])
        elif re.search(r"memcpy dtod|device -> device", e.key, re.I):
            out["dtod_copies"] += e.count
            out["dtod_device_ms"] += e.device_time_total / 1e3
    return out


def dist_state(cfg):
    """ade20k_swin_t's train state from seed 0, the optimizer at the end of
    the lr warm-up (graph_case's reason)."""
    from ddp_tpu_torch.config import build_model
    from ddp_tpu_torch.train.optim import make_optimizer
    from ddp_tpu_torch.train.step import TrainState

    model = build_model(cfg.model, device="cuda", seed=0)
    state = TrainState(model, make_optimizer(cfg.optim, model),
                       torch.Generator(device="cuda").manual_seed(0))
    state.optimizer.count = cfg.optim.warmup_steps
    return state


def phase_dist(smi: str):
    """The data-parallel train step at world 1 in this process: an NCCL
    group on 127.0.0.1, ade20k_swin_t at 2 x 512^2, f32 (TF32 off). The
    eager step with the gradient all-reduce (the four kernels' launches); a
    2-step CUDA graph with the all-reduce captured, its replay held to the
    eager steps without a process group from the same state and generator
    (graph_vs_eager, PyTorch's deterministic algorithms on); step ms with and
    without the collective, eager and graphed; what a profile of one replay
    shows of the collective."""
    import torch.distributed as dist

    from ddp_tpu_torch.config import get_config
    from ddp_tpu_torch.parallel.mesh import init_distributed, make_mesh
    from ddp_tpu_torch.train.step import make_chunked_train_step, make_train_step

    t_phase = time.perf_counter()
    cfg = get_config("ade20k_swin_t")
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=free_port())
    device = init_distributed()
    mesh = make_mesh()
    state = dist_state(cfg)
    batch = train_batch(cfg, 2)
    eager = make_train_step()
    reset_all_launches()
    eager(state, batch)
    torch.cuda.synchronize()
    launches = all_launches()
    if launches != PER_STEP:
        raise AssertionError(f"dist: the eager step with the all-reduce launched {launches}")
    eager_ms = wall_s(lambda: eager(state, batch), reps=3, warmup=0) * 1e3
    n = 2
    chunk_batch = stacked(batch, n)
    timed_chunk = make_chunked_train_step(n)
    timed_chunk(state, chunk_batch)  # eager on the capture stream, then the capture
    graph_ms = wall_s(lambda: timed_chunk(state, chunk_batch), reps=3, warmup=0) * 1e3 / n
    p, wall = profiled(lambda: timed_chunk(state, chunk_batch), timed=True)
    replay = dict(busy(p, wall), **collective_kernels(p))
    replay["launches_per_replayed_step"] = {k: v / n for k, v in kernel_launches(p).items()}
    if replay["launches_per_replayed_step"] != PER_STEP:
        raise AssertionError(f"dist: the card ran {replay} in one replay")
    del timed_chunk
    torch.cuda.empty_cache()
    with deterministic_algorithms(True):
        held = make_chunked_train_step(n)
        held(state, chunk_batch)

        def replay_then_leave(state, batches):
            logs = held(state, batches)
            torch.cuda.synchronize()
            dist.destroy_process_group()  # the eager steps below run without a group
            return logs

        check = graph_vs_eager(state, replay_then_leave, eager, batch, n)
    del held
    torch.cuda.empty_cache()
    eager_alone_ms = wall_s(lambda: eager(state, batch), reps=3, warmup=0) * 1e3
    alone = make_chunked_train_step(n)
    alone(state, chunk_batch)
    graph_alone_ms = wall_s(lambda: alone(state, chunk_batch), reps=3, warmup=0) * 1e3 / n
    del alone
    torch.cuda.empty_cache()
    emit({"phase": "dist", "preset": cfg.name, "img": [2, 512, 512, 3],
          "dtype": "float32, tf32 off", "group": "nccl, world 1, in this process",
          "device": str(device), "mesh": [list(mesh.shape), list(mesh.mesh_dim_names)],
          "capture_error_mode": "thread_local", "launches_eager_step": launches,
          "eager_ms_per_step": {"with_all_reduce": eager_ms, "without_group": eager_alone_ms},
          "graph_ms_per_step": {"with_all_reduce": graph_ms, "without_group": graph_alone_ms,
                                "n": n},
          "profiled_replay": replay, "graph_vs_eager_without_group": check,
          "wall_s": time.perf_counter() - t_phase, "card": smi})
    return launches


def run_tool(module, argv) -> str:
    """A tool's main(argv) in this process: its standard output (exit 0)."""
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = module.main(argv)
    if rc != 0:
        raise AssertionError(f"{module.__name__} {argv}: exit {rc}\n{out.getvalue()}")
    return out.getvalue()


def run_cli(module: str, argv) -> tuple:
    """``python -m module *argv`` as its ``main(argv)`` in this process,
    without an interpreter and a CUDA context of its own to start (seconds
    each): (its standard output, wall s); it must exit 0."""
    import importlib

    t0 = time.perf_counter()
    text = run_tool(importlib.import_module(module), list(argv))
    sec = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    return text, sec


def phase_tools(smi: str):
    """The model tools on the card at ade20k_swin_t: image_demo on a 512^2
    PNG (random init), publish_model of a 1-step and a 2-step checkpoint,
    image_demo --ckpt, model_ensemble (both) and confusion_matrix on
    tests/data/ade, get_flops at 512^2; flip_tta and multi_scale_flip_tta of
    sample() at 512^2 through the kernels and the plain versions (the serving
    limits), with their encode_map launches."""
    from ddp_tpu_torch.config import get_config
    from ddp_tpu_torch.data.image_io import write_png
    from ddp_tpu_torch.data.seg_datasets import normalize_image
    from ddp_tpu_torch.evaluation.slide import flip_tta, multi_scale_flip_tta
    from ddp_tpu_torch.tools import (confusion_matrix, get_flops, image_demo, model_ensemble,
                                     publish_model, segmentor)
    from ddp_tpu_torch.train.checkpoint import CheckpointManager
    from ddp_tpu_torch.train.step import make_train_step

    t_phase = time.perf_counter()
    shutil.rmtree(TOOLS_DIR, ignore_errors=True)
    os.makedirs(TOOLS_DIR)
    cfg = get_config("ade20k_swin_t")
    rng = np.random.default_rng(0)
    png = os.path.join(TOOLS_DIR, "in.png")
    write_png(png, rng.integers(0, 256, (512, 512, 3), dtype=np.uint8))
    out, secs, launches = {}, {}, {}

    def timed(name, module, argv):
        reset_all_launches()
        t0 = time.perf_counter()
        out[name] = run_tool(module, argv).strip().splitlines()[-3:]
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        launches[name] = all_launches()["encode_map"]

    timed("image_demo", image_demo, ["ade20k_swin_t", png, "--out",
                                     os.path.join(TOOLS_DIR, "pred.png")])
    state = dist_state(cfg)
    step, batch = make_train_step(), train_batch(cfg, 2)
    run = os.path.join(TOOLS_DIR, "run")
    ckpt, published = CheckpointManager(run), []
    for s in (1, 2):
        step(state, batch)
        state.step = s
        ckpt.save(s, state)
        line = run_tool(publish_model, [run, os.path.join(TOOLS_DIR, "ade"), "--step", str(s)])
        published.append(line.split(" -> ")[1].split(" (")[0])
    del state, step
    torch.cuda.empty_cache()
    ade = ["--set", f"data.data_root={ADE_FIXTURE}"]
    timed("image_demo_ckpt", image_demo, ["ade20k_swin_t", png, "--ckpt", published[0],
                                          "--out", os.path.join(TOOLS_DIR, "pred_ckpt.png")])
    timed("model_ensemble", model_ensemble, ["ade20k_swin_t"] + published + ade)
    timed("confusion_matrix", confusion_matrix, ["ade20k_swin_t", "--ckpt", published[0],
                                                 "--out", os.path.join(TOOLS_DIR, "cm.npy")]
          + ade)
    timed("get_flops", get_flops, ["ade20k_swin_t", "--size", "512"])
    want = {"image_demo": 3, "image_demo_ckpt": 3, "model_ensemble": 2 * 2 * 3,
            "confusion_matrix": 2 * 3}
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"tools: encode_map launches {launches}, want {want}")
    cm = np.load(os.path.join(TOOLS_DIR, "cm.npy"))
    if cm.shape != (150, 150) or cm.sum() <= 0:
        raise AssertionError(f"tools: confusion matrix {cm.shape}, {cm.sum()} pixels")

    model = segmentor(cfg, published[0], torch.device("cuda"))
    img = torch.from_numpy(normalize_image(
        rng.uniform(0, 255, (1, 512, 512, 3)).astype(np.float32))).cuda()
    tta = {}
    for name, fn, n_calls in (("flip_tta", flip_tta, 2),
                              ("multi_scale_flip_tta", multi_scale_flip_tta, 12)):
        def call():
            gen = torch.Generator(device="cuda").manual_seed(3)
            return fn(lambda x: model.sample(x, generator=gen), img)

        reset_all_launches()
        t0 = time.perf_counter()
        probs = call()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        n_encode = all_launches()["encode_map"]
        with plain_kernels():
            plain = call()
        diff, agree = compare_probs(probs, plain)
        check_probs(probs, (1, 512, 512, cfg.model.num_classes))
        tta[name] = {"encode_map_launches": n_encode, "sample_calls": n_calls, "s": sec,
                     "max_abs_prob_diff_vs_plain": diff, "argmax_agreement_vs_plain": agree}
        if n_encode != 3 * n_calls or not (diff <= 1e-4 and agree >= 0.999):
            raise AssertionError(f"tools {name}: {tta[name]}")
        del probs, plain
    del model
    torch.cuda.empty_cache()
    data_tools = data_tools_check()
    emit({"phase": "tools", "preset": cfg.name, "image": [512, 512],
          "eval_data": ADE_FIXTURE + " (2 val images of 64 x 48)", "outputs": out,
          "seconds": secs, "encode_map_launches": launches, "tta": tta,
          "data_tools": data_tools, "wall_s": time.perf_counter() - t_phase, "card": smi})
    return {"image_demo": launches["image_demo"],
            "flip_tta": tta["flip_tta"]["encode_map_launches"],
            "multi_scale_flip_tta": tta["multi_scale_flip_tta"]["encode_map_launches"]}


YAML_OVERLAY = """# tools.train smoke --yaml: 4 float32 steps, logged at steps 1, 2 and 4
runtime:
  total_iters: 4
  log_interval: 2
  ckpt_interval: 4
  mixed_precision: false
data.batch_size: 2
"""


def data_tools_check() -> dict:
    """The data tools and --yaml through run_cli, each exit 0, outputs held
    to the CPU's: prepare_nuscenes on a copy of tests/data/nuscenes_raw (its
    infos read back by NuScenesFusionDataset, every map mask set),
    convert_datasets cityscapes on a copy of tests/data/cityscapes (each
    trainId PNG equal to the labelId -> trainId table applied to its
    labelIds PNG), browse_dataset smoke (its six PNGs written at the crop's
    size; the CPU tests hold them bitwise to JAX's) and tools.train smoke
    --yaml on the card and with --device cpu (the overlay's steps logged by
    both with the same lr and log keys, finite losses: the two devices'
    generators draw different t and noise, so the losses are not compared)."""
    from ddp_tpu_torch.config import get_config
    from ddp_tpu_torch.data.bev_datasets import NuScenesFusionDataset
    from ddp_tpu_torch.data.image_io import read_image
    from ddp_tpu_torch.data.seg_datasets import CITYSCAPES_LABEL2TRAIN

    out, secs = {}, {}
    nusc = os.path.join(TOOLS_DIR, "nuscenes_raw")
    shutil.copytree(os.path.join("tests", "data", "nuscenes_raw"), nusc)
    _, secs["prepare_nuscenes"] = run_cli("ddp_tpu_torch.tools.prepare_nuscenes", [
        "--data-root", nusc, "--max-sweeps", "2", "--grid", "40", "--patch", "16.0"])
    ds = NuScenesFusionDataset(nusc, "train", image_size=(32, 88), out_grid=40,
                               sparse_shape=(80, 80, 41), caps=(4000, 2000, 1000, 500, 500),
                               voxel_size=(0.2, 0.2, 0.2))
    masks = [np.load(os.path.join(nusc, "maps_bev", f))["masks"]
             for f in sorted(os.listdir(os.path.join(nusc, "maps_bev")))]
    out["prepare_nuscenes"] = {"samples": len(ds), "masks": len(masks),
                               "voxel_feats_nonzero": bool(ds.load(0)["voxel_feats"].any())}
    if not (len(ds) == len(masks) == 2 and all(m.any() for m in masks)
            and out["prepare_nuscenes"]["voxel_feats_nonzero"]):
        raise AssertionError(f"tools prepare_nuscenes: {out['prepare_nuscenes']}")
    city = os.path.join(TOOLS_DIR, "cityscapes")
    shutil.copytree(os.path.join("tests", "data", "cityscapes"), city)
    _, secs["convert_datasets"] = run_cli("ddp_tpu_torch.tools.convert_datasets",
                                          ["cityscapes", city])
    pngs = 0
    for dirpath, _, files in os.walk(os.path.join(city, "gtFine")):
        for f in files:
            if f.endswith("_labelTrainIds.png"):
                src = read_image(os.path.join(dirpath, f.replace("_labelTrainIds", "_labelIds")))
                want = CITYSCAPES_LABEL2TRAIN[np.clip(src.astype(np.int32), 0, 255)]
                if not np.array_equal(read_image(os.path.join(dirpath, f)), want):
                    raise AssertionError(f"tools convert_datasets: {f} differs")
                pngs += 1
    out["convert_datasets"] = {"train_id_pngs": pngs}
    browse = os.path.join(TOOLS_DIR, "browse")
    _, secs["browse_dataset"] = run_cli("ddp_tpu_torch.tools.browse_dataset", [
        "--preset", "smoke", "--num", "3", "--out", browse])
    crop = tuple(get_config("smoke").data.crop_size)
    shapes = {f: read_image(os.path.join(browse, f)).shape for f in sorted(os.listdir(browse))}
    out["browse_dataset"] = {"pngs": len(shapes)}
    if sorted(shapes) != [f"sample_{i}_{k}.png" for i in range(3) for k in ("ann", "img")] or any(
            sh[:2] != crop for sh in shapes.values()):
        raise AssertionError(f"tools browse_dataset: {shapes}")
    overlay = os.path.join(TOOLS_DIR, "overlay.yaml")
    with open(overlay, "w") as f:
        f.write(YAML_OVERLAY)
    logs = {}
    for dev in ("cuda", "cpu"):
        wd = os.path.join(TOOLS_DIR, f"yaml_{dev}")
        argv = ["smoke", "--workdir", wd, "--yaml", overlay]
        _, secs[f"train_yaml_{dev}"] = run_cli("ddp_tpu_torch.tools.train",
                                               argv + (["--device", "cpu"] if dev == "cpu"
                                                       else []))
        logs[dev] = [r for r in _log_steps(wd) if "loss" in r]
    steps = {dev: [r["step"] for r in rows] for dev, rows in logs.items()}
    lrs = {dev: [r["lr"] for r in rows] for dev, rows in logs.items()}
    keys = {dev: sorted(rows[0]) for dev, rows in logs.items()}
    finite = all(np.isfinite(r["loss"]) for rows in logs.values() for r in rows)
    out["train_yaml"] = {"steps": steps, "lr": lrs, "keys_equal": keys["cuda"] == keys["cpu"],
                         "finite": finite,
                         "losses": {dev: [r["loss"] for r in rows] for dev, rows in logs.items()}}
    if not (steps["cuda"] == steps["cpu"] == [1, 2, 4] and lrs["cuda"] == lrs["cpu"]
            and keys["cuda"] == keys["cpu"] and finite):
        raise AssertionError(f"tools train --yaml: {out['train_yaml']}")
    return {"outputs": out, "seconds": secs}


def dist_two_steps(state, batch, deterministic: bool = True, cudnn: bool = True):
    """The first step's gradients (the generator put back after), then two
    eager steps, deterministic algorithms on (or off), cuDNN on (or off:
    PyTorch's own convolutions, another summation order): (gradients by
    name, logs)."""
    from ddp_tpu_torch.train.step import make_train_step

    step = make_train_step()
    # only cuDNN's switch: torch.backends.cudnn.flags() would also set TF32 on
    prev, torch.backends.cudnn.enabled = torch.backends.cudnn.enabled, cudnn
    try:
        with deterministic_algorithms(deterministic):
            gen = state.generator.get_state()
            grads, _ = step.grads(state, batch)
            state.generator.set_state(gen)
            names = [k for k, _ in state.model.named_parameters()]
            grads = {k: g.detach().clone() for k, g in zip(names, grads)}
            reset_all_launches()
            logs = [{k: v.item() for k, v in step(state, batch).items()} for _ in range(2)]
    finally:
        torch.backends.cudnn.enabled = prev
    if all_launches() != {k: 2 * v for k, v in PER_STEP.items()}:
        raise AssertionError(f"dist_two: 2 steps launched {all_launches()}")
    return grads, logs


def dist_two_rank(rank: int, port: str, out: str) -> int:
    """One of dist_two's two processes: a gloo group of 2 on CUDA tensors
    (both on cuda:0), ade20k_swin_t on its image of the global batch of 2
    (``dist_two_steps``); the logs, the first step's averaged gradients
    (rank 0), the parameters after and the wall ms of a gloo all-reduce of
    the gradients' size to ``out``."""
    import torch.distributed as dist

    from ddp_tpu_torch.config import get_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=2)
    cfg = get_config("ade20k_swin_t")
    state = dist_state(cfg)
    batch = {k: v[rank:rank + 1] for k, v in train_batch(cfg, 2).items()}
    grads, logs = dist_two_steps(state, batch)
    n = sum(p.numel() for p in state.model.parameters())
    g = torch.ones(n, device="cuda")
    ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_reduce(g)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    torch.save({"logs": logs, "grads": {k: v.cpu() for k, v in grads.items()} if rank == 0
                else None, "params": {k: p.detach().cpu() for k, p in
                                      state.model.named_parameters()},
                "all_reduce_ms": ms, "numel": n}, out)
    dist.destroy_process_group()
    return 0


# dist_two's limits. Two ranks sum in another order than one process: the
# first step's gradient tensor within TOL_GRAD_TWO_RANKS of its L2 + 1e-6 of
# all the gradients' L2 (a gradient that is 0 in exact arithmetic is all
# rounding) + 3 x the L2 between two 1-process runs that sum in two orders
# (deterministic algorithms on and off); a parameter tensor after 2 steps within
# TOL_UPDATE_TWO_RANKS of its update's L2, as AdamW divides each gradient
# element by its own magnitude, so a near-zero element's rounding moves its
# update by up to +-lr (1.1e-3 of the update of aux_head.conv0.norm.bias on
# an H100). A per-rank BatchNorm, per-rank draws or unaveraged gradients
# each fail both limits by more than 50x on an H100
TOL_GRAD_TWO_RANKS = 1e-3
TOL_UPDATE_TWO_RANKS = 1e-2


def phase_dist_two(smi: str):
    """Two processes of one gloo group on cuda:0 (NCCL refuses two ranks on
    one GPU) train ade20k_swin_t eagerly for 2 steps on a global batch of 2
    (one image each, f32, deterministic algorithms on), held to two runs of
    the 1-process eager steps on the whole batch: both ranks' logs equal,
    each step's loss within 1e-5 relative (+ 3 x the two 1-process runs'
    spread), the first step's averaged gradients and each parameter tensor
    after 2 steps within TOL_GRAD_TWO_RANKS's and TOL_UPDATE_TWO_RANKS's
    limits. Reported beside them, not held: a 1-process run without cuDNN
    (another summation order) against the reference, by the same limits."""
    t_phase = time.perf_counter()
    os.makedirs(DIST_DIR, exist_ok=True)
    port = free_port()
    outs = [os.path.join(DIST_DIR, f"rank{r}.pt") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dist-two-rank",
                               str(r), "--port", port, "--out", outs[r]],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(2)]
    try:
        from ddp_tpu_torch.config import get_config

        cfg = get_config("ade20k_swin_t")
        batch = train_batch(cfg, 2)
        runs = []
        for deterministic, cudnn in ((True, True), (True, True), (False, True), (True, False)):
            state = dist_state(cfg)
            before = params_of(state)
            grads, logs = dist_two_steps(state, batch, deterministic, cudnn)
            runs.append((grads, logs, params_of(state)))
            del state
            torch.cuda.empty_cache()
        logs_out = [p.communicate(timeout=600)[0].decode(errors="replace") for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs_out):
        if p.returncode != 0:
            raise AssertionError(f"dist_two: a rank failed:\n{log[-3000:]}")
    ranks = [torch.load(o, weights_only=True) for o in outs]
    (grads_a, logs_a, params_a), (_, logs_b, _), (grads_c, _, _), (grads_d, _, params_d) = runs
    ranks_agree = ranks[0]["logs"] == ranks[1]["logs"]
    loss = [r["loss"] for r in ranks[0]["logs"]]
    ref = [r["loss"] for r in logs_a]
    spread = [abs(x["loss"] - y["loss"]) for x, y in zip(logs_a, logs_b)]
    loss_ok = all(abs(g - e) <= 1e-5 * abs(e) + 3.0 * s for g, e, s in zip(loss, ref, spread))
    got_g = {k: v.cuda() for k, v in ranks[0]["grads"].items()}
    dg, order = l2_by_tensor(got_g, grads_a), l2_by_tensor(grads_c, grads_a)
    norm_g = {k: g.double().norm().item() for k, g in grads_a.items()}
    floor = 1e-6 * sum(v * v for v in norm_g.values()) ** 0.5
    grad_ratio = {k: dg[k] / (TOL_GRAD_TWO_RANKS * norm_g[k] + floor + 3.0 * order[k])
                  for k in dg}
    worst_grad = max(grad_ratio, key=grad_ratio.get)
    max_share = {k: (got_g[k] - g).abs().max().item() / max(g.abs().max().item(), 1e-30)
                 for k, g in grads_a.items()}
    # reported, not held: the 1-process run without cuDNN (its convolutions'
    # sums in PyTorch's own order) against the reference, beside the 2 ranks'
    # distance: the size of a change of summation order where the ranks' split
    # of the batch changes one
    no_cudnn = l2_by_tensor(grads_d, grads_a)
    all_l2 = lambda d: sum(v * v for v in d.values()) ** 0.5  # noqa: E731
    upd_a = l2_by_tensor(params_a, before)
    off_params = l2_by_tensor(params_d, params_a)
    cudnn_off = {"grads_worst_over_limit": max(
                     no_cudnn[k] / (TOL_GRAD_TWO_RANKS * norm_g[k] + floor + 3.0 * order[k])
                     for k in no_cudnn),
                 "params_worst_over_limit": max(
                     off_params[k] / (TOL_UPDATE_TWO_RANKS * upd_a[k]) if upd_a[k] else
                     (0.0 if off_params[k] == 0 else float("inf")) for k in off_params),
                 "worst_tensor_l2": no_cudnn[worst_grad], "all_l2": all_l2(no_cudnn),
                 "two_ranks_all_l2": all_l2(dg), "all_grads_l2": all_l2(norm_g),
                 "params_l2_over_update": all_l2(off_params) / all_l2(upd_a)}
    got = {k: v.cuda() for k, v in ranks[0]["params"].items()}
    dist_l2, upd = l2_by_tensor(got, params_a), l2_by_tensor(params_a, before)
    param_ratio = {k: dist_l2[k] / (TOL_UPDATE_TWO_RANKS * upd[k]) if upd[k] else
                   (0.0 if dist_l2[k] == 0 else float("inf")) for k in dist_l2}
    worst_param = max(param_ratio, key=param_ratio.get)
    out = {"phase": "dist_two", "preset": cfg.name, "group": "gloo, 2 processes on cuda:0",
           "global_batch": [2, 512, 512, 3], "dtype": "float32, tf32 off",
           "ranks_logged_alike": ranks_agree, "loss_two_ranks": loss, "loss_one_process": ref, "loss_one_process_again":
               [r["loss"] for r in logs_b], "grad_norm_two_ranks":
               [r["grad_norm"] for r in ranks[0]["logs"]],
           "grad_norm_one_process": [r["grad_norm"] for r in logs_a], "losses_ok": loss_ok,
           "first_step_grads": {
               "worst_tensor": worst_grad, "worst_over_limit": grad_ratio[worst_grad],
               "worst_l2": dg[worst_grad], "its_l2": norm_g[worst_grad],
               "its_two_orders_l2": order[worst_grad],
               "largest_max_abs_diff_share": max(max_share.values()),
               "its_tensor": max(max_share, key=max_share.get),
               "one_process_without_cudnn": cudnn_off,
               "limit": f"per tensor: L2 <= {TOL_GRAD_TWO_RANKS} x L2 of the gradient + 1e-6 "
                        "x L2 of all the gradients + 3 x L2 between 1-process runs with "
                        "deterministic algorithms on and off"},
           "params_after_2_steps": {
               "worst_tensor": worst_param, "worst_over_limit": param_ratio[worst_param],
               "tensors_over_1e-3_of_update": sum(r > 0.1 for r in param_ratio.values()),
               "l2_over_update": (sum(v * v for v in dist_l2.values())
                                  / sum(v * v for v in upd.values())) ** 0.5,
               "limit": f"per tensor: L2 <= {TOL_UPDATE_TWO_RANKS} x L2 of the update"},
           "all_reduce_wall_ms": ranks[0]["all_reduce_ms"],
           "all_reduce_numel": ranks[0]["numel"], "wall_s": time.perf_counter() - t_phase,
           "card": smi}
    emit(out)
    if not (ranks_agree and loss_ok and grad_ratio[worst_grad] <= 1.0
            and param_ratio[worst_param] <= 1.0):
        raise AssertionError(f"dist_two: {out}, rank 1 logged {ranks[1]['logs']}")


# --- the lidar pieces and decoder_remat ------------------------------------------

NO_LAUNCHES = dict.fromkeys(PER_STEP, 0)
# the card vs CPU limits of lidar_zoo's tiny modules (compat_reference's)
ZOO_OUT_REL, ZOO_GRAD_REL = 1e-4, 1e-4


def _dla_unreached(model) -> tuple:
    """DLA's projections in a tree of more than one level: JAX computes and
    drops them, so the loss reaches none of their parameters."""
    from ddp_tpu_torch.nn.dla_vovnet import _Tree

    return tuple(f"{name}.{leaf}" for name, m in model.named_modules()
                 if isinstance(m, _Tree) and m.levels > 1 and hasattr(m, "project")
                 for leaf in ("project.weight", "project_bn.weight", "project_bn.bias"))


class SparseSECOND(torch.nn.Module):
    """BEVFusion's lidar path as one module: SparseEncoder of one sweep ->
    its dense BEV -> SECOND -> SECONDFPN (NHWC)."""

    def __init__(self, encoder, second, fpn):
        super().__init__()
        self.encoder, self.second, self.fpn = encoder, second, fpn

    def forward(self, voxel_feats, rulebooks):
        return self.fpn(self.second(self.encoder(voxel_feats, rulebooks)[None]))


class PointPillars(torch.nn.Module):
    """PillarFeatureNet -> point_pillars_scatter onto an nx x ny canvas ->
    SECOND -> SECONDFPN (NHWC)."""

    def __init__(self, pfn, second, fpn, nx: int, ny: int):
        super().__init__()
        self.pfn, self.second, self.fpn, self.nx, self.ny = pfn, second, fpn, nx, ny

    def forward(self, feats, counts, coords, valid):
        from ddp_tpu_torch.nn.second import point_pillars_scatter

        canvas = point_pillars_scatter(self.pfn(feats, counts, coords), coords, valid,
                                       self.nx, self.ny)
        return self.fpn(self.second(canvas))


def _pillars(pts, pc_range, voxel_size, max_points: int, max_pillars: int):
    """Hard-voxelized pillars of ``pts`` [P, 4] as PillarFeatureNet's inputs
    [1, P', N, 4], counts, (ix, iy) coords and the valid mask."""
    from ddp_tpu_torch import native

    vox, coords, counts, n = native.hard_voxelize(pts, pc_range, voxel_size, max_points,
                                                  max_pillars)
    valid = np.arange(max_pillars) < n
    return [torch.from_numpy(a)[None] for a in (vox, counts, coords[:, :2].copy(), valid)]


def _sweeps(mc, n: int = 10, points: int = 40_000):
    """n past sweeps of the rig's dense cloud (seeded), each turned and moved
    a little and 0.05 s older than the one after it."""
    out = []
    for i in range(n):
        pts, _ = dense_cloud(mc, points, seed=100 + i)
        a = 0.002 * (i + 1)
        rot = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
        out.append({"points": pts, "sensor2lidar_rotation": rot,
                    "sensor2lidar_translation": np.array([0.5 * (i + 1), 0.0, 0.0]),
                    "timestamp": -0.05 * (i + 1)})
    return out


def lidar_tiny_cases(g):
    """The tiny lidar modules with their inputs (CPU tensors), forward and
    loss (compat_reference's form: one float input, the rest captured and
    moved to its device), and the parameters the loss cannot reach."""
    from ddp_tpu_torch import native
    from ddp_tpu_torch.data.bev_datasets import SyntheticBEVDataset, rasterize_lidar_depth
    from ddp_tpu_torch.nn.bev import DepthLSSTransform
    from ddp_tpu_torch.nn.common import init_params_
    from ddp_tpu_torch.nn.dla_vovnet import DLA, VoVNet
    from ddp_tpu_torch.nn.second import SECOND, SECONDFPN, PillarFeatureNet
    from ddp_tpu_torch.nn.sparse_conv import (SparseEncoder, build_sparse_encoder_rulebooks,
                                              mean_voxel_features)

    def seeded(m, seed):
        init_params_(m, seed)
        return m

    def mapped(m, *args):  # move the captured inputs to x's device (floats in its type)
        def cast(a, x):
            if isinstance(a, dict):
                return {k: cast(v, x) for k, v in a.items()}
            return a.to(x.device, x.dtype) if a.is_floating_point() else a.to(x.device)

        fwd = lambda mod, x: mod(x, *(cast(a, x) for a in args))  # noqa: E731
        return fwd, (lambda mod, x: _sq_loss(_tuple(fwd(mod, x))))

    cases = {}
    second = seeded(SECOND(8, (8, 16), (1, 2), (1, 2)), 1)
    cases["second"] = (second, torch.randn(2, 16, 16, 8, generator=g), *mapped(second), ())
    fpn = seeded(SECONDFPN((8, 8), (8, 8), (0.5, 2)), 2)
    xs = torch.randn(2, 16 * 16 * 8 + 4 * 4 * 8, generator=g)
    split = (lambda x: [x[:, :2048].reshape(2, 16, 16, 8), x[:, 2048:].reshape(2, 4, 4, 8)])
    cases["second_fpn"] = (fpn, xs, lambda m, x: m(split(x)),
                           lambda m, x: _sq_loss(_tuple(m(split(x)))), ())
    rng = np.random.default_rng(3)
    pts = rng.uniform(-4, 4, (3000, 4)).astype(np.float32)
    pts[:, 2] = rng.uniform(-1, 1, 3000)
    feats, counts, coords, valid = _pillars(pts, (-4.0, -4.0, -2.0, 4.0, 4.0, 2.0),
                                            (0.5, 0.5, 4.0), 6, 80)
    pfn = seeded(PillarFeatureNet(4, (8, 16), (0.5, 0.5), (-4.0, -4.0), with_distance=True), 3)
    cases["pillar_feature_net"] = (pfn, feats, *mapped(pfn, counts, coords), ())
    dla = seeded(DLA(3, levels=(1, 1, 1, 1, 2, 1), channels=(4, 8, 8, 16, 24, 32)), 4)
    cases["dla"] = (dla, torch.randn(2, 32, 32, 3, generator=g), *mapped(dla),
                    _dla_unreached(dla))
    vov = seeded(VoVNet(3, (4, 8), (8, 16), (1, 2), 2), 5)
    cases["vovnet"] = (vov, torch.randn(2, 16, 16, 3, generator=g), *mapped(vov), ())
    lss_kw = dict(image_size=(32, 64), feature_size=(4, 8), xbound=(-8.0, 8.0, 1.0),
                  ybound=(-8.0, 8.0, 1.0), dbound=(1.0, 9.0, 1.0))
    lss = seeded(DepthLSSTransform(8, 8, **lss_kw), 6)
    rig = [torch.from_numpy(a)[None] for a in SyntheticBEVDataset(2, (32, 64), scope=8.0).rig()]
    cloud = rng.uniform(-8, 8, (3000, 5)).astype(np.float32)
    canvas = torch.from_numpy(rasterize_lidar_depth(cloud, *(r[0].numpy() for r in rig),
                                                    (32, 64)))[None]
    cases["depth_lss"] = (lss, torch.randn(1, 2, 4, 8, 8, generator=g),
                          *mapped(lss, canvas, *rig), ())
    cloud[:, 2] = rng.uniform(-4.8, 3.0, 3000)
    vox, vcoords, vcounts, nv = native.hard_voxelize(cloud, (-8.0, -8.0, -5.0, 8.0, 8.0, 3.2),
                                                     (0.25, 0.25, 0.2), 4, 400)
    rb = {k: torch.from_numpy(v) for k, v in build_sparse_encoder_rulebooks(
        vcoords, nv, (64, 64, 41), (400, 160, 80, 40, 40)).items()}
    enc = seeded(SparseEncoder(5, 4, 8, ((4,), (8, 8), (8, 8), (8, 8)), 8, 2), 7)
    cases["sparse_encoder"] = (enc, torch.from_numpy(mean_voxel_features(vox, vcounts)),
                               *mapped(enc, rb), ())
    return cases


def lidar_reference(smi: str) -> dict:
    """lidar_zoo (a): each tiny lidar module on the card and on the CPU from
    the same weights and inputs: eval outputs in float32 within 1e-4 ·
    max|y| + 1e-6; train-mode gradients of the mean-square loss in float64,
    each within 1e-4 of its max + 1e-9 of the module's largest;
    point_pillars_scatter and densify bitwise."""
    from ddp_tpu_torch.nn.second import point_pillars_scatter
    from ddp_tpu_torch.nn.sparse_conv import densify

    g = _gen(81)
    rows, worst = {}, {"out_rel": 0.0, "grad_rel_f64": 0.0}
    for name, (model, x, fwd, loss_fn, unreached) in lidar_tiny_cases(g).items():
        res = {dev: {dt: _compat_run(model, x.to(dev), None, dt, fwd, loss_fn, unreached)
                     for dt in (torch.float32, torch.float64)} for dev in ("cpu", "cuda")}
        c32, g32 = res["cpu"][torch.float32], res["cuda"][torch.float32]
        c64, g64 = res["cpu"][torch.float64], res["cuda"][torch.float64]
        out_rel = max(((a - b).abs().max() / (1e-6 + a.abs().max() * 1.0)).item()
                      for a, b in zip(c32[0], g32[0]))
        out_ok = all((a - b).abs().max().item() <= ZOO_OUT_REL * a.abs().max().item() + 1e-6
                     for a, b in zip(c32[0], g32[0]))
        top = max(v.abs().max().item() for v in c64[3].values())
        grad_rel = max(((c64[3][n] - g64[3][n]).abs().max()
                        / (c64[3][n].abs().max() + 1e-9 * top).clamp_min(1e-300)).item()
                       for n in c64[3])
        rows[name] = {"outputs": [list(t.shape) for t in c32[0]], "out_rel_diff": out_rel,
                      "outputs_within_limit": out_ok, "grad_rel_diff_f64": grad_rel,
                      "tensors": len(c64[3]), "unreached": len(unreached)}
        worst["out_rel"] = max(worst["out_rel"], out_rel if out_ok else float("inf"))
        worst["grad_rel_f64"] = max(worst["grad_rel_f64"], grad_rel)
    feats = torch.randn(2, 50, 16, generator=g)
    cells = torch.stack([torch.randperm(400, generator=g)[:50] for _ in range(2)])
    coords = torch.stack([cells % 20, cells // 20], -1).int()
    valid = torch.rand(2, 50, generator=g) < 0.9
    scatter = torch.equal(point_pillars_scatter(feats, coords, valid, 20, 20),
                          point_pillars_scatter(feats.cuda(), coords.cuda(), valid.cuda(), 20,
                                                20).cpu())
    rows_d = torch.randn(2 * 60, 8, generator=g)
    flat = torch.stack([torch.randperm(8 * 8 * 2, generator=g)[:60] for _ in range(2)]).reshape(-1)
    dc = torch.stack([flat // 16, (flat // 2) % 8, flat % 2], -1).int()
    dvalid = torch.rand(120, generator=g) < 0.8
    dense = torch.equal(densify(rows_d, dc, dvalid, 2, 8, 2),
                        densify(rows_d.cuda(), dc.cuda(), dvalid.cuda(), 2, 8, 2).cpu())
    out = {"models": rows, "worst": worst, "scatter_bitwise": scatter,
           "densify_bitwise": dense,
           "limits": "outputs 1e-4 x max|y| + 1e-6 (float32); each gradient 1e-4 of its max "
                     "+ 1e-9 of the module's largest (float64); scatters bitwise"}
    if not (worst["out_rel"] <= ZOO_OUT_REL and worst["grad_rel_f64"] <= ZOO_GRAD_REL
            and scatter and dense):
        emit({"phase": "lidar_zoo", "failed_check": out, "card": smi})
        raise AssertionError(f"lidar_zoo: card vs CPU {worst}, scatter {scatter}, "
                             f"densify {dense}")
    return out


def zoo_row(model, args, reps: int = 3) -> dict:
    """A model at published widths on the card (f32, TF32 off): eval
    forward ms and forward + backward ms (train mode, the mean-square
    loss), medians of ``reps`` after one warm-up, peak GB, launches of the
    five kernels, and finite outputs."""
    def fwd():
        with torch.no_grad():
            return model.eval()(*args)

    def step():
        model.train()
        loss = sum(o.float().square().mean() for o in _tuple(model(*args)))
        loss.backward()
        model.zero_grad(set_to_none=True)
        return loss

    reset_all_launches()
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    live = torch.cuda.memory_allocated() / 1e9
    out = _tuple(fwd())
    finite = all(bool(torch.isfinite(o).all()) for o in out)
    fwd_ms = wall_s(fwd, reps=reps) * 1e3
    step_ms = wall_s(step, reps=reps) * 1e3
    launches = all_launches()
    row = {"outputs": [list(o.shape) for o in out], "finite": finite,
           "forward_ms": fwd_ms, "forward_backward_ms": step_ms,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "live_before_gb": live,
           "params_m": sum(p.numel() for p in model.parameters()) / 1e6,
           "launches": launches}
    if not finite or launches != NO_LAUNCHES:
        raise AssertionError(f"lidar_zoo: {row}")
    return row


def lidar_published(smi: str) -> dict:
    """lidar_zoo (b): the lidar pieces at published widths (random weights,
    seed 0), each through zoo_row."""
    from ddp_tpu_torch import native
    from ddp_tpu_torch.config import get_config
    from ddp_tpu_torch.data.bev_datasets import SyntheticBEVDataset, rasterize_lidar_depth
    from ddp_tpu_torch.data.transforms_3d import multi_sweep_points
    from ddp_tpu_torch.nn.bev import DepthLSSTransform
    from ddp_tpu_torch.nn.common import init_params_
    from ddp_tpu_torch.nn.dla_vovnet import DLA, VoVNet
    from ddp_tpu_torch.nn.second import SECOND, SECONDFPN, PillarFeatureNet
    from ddp_tpu_torch.nn.sparse_conv import (SparseEncoder, build_sparse_encoder_rulebooks,
                                              mean_voxel_features)

    mc = get_config("nuscenes_fusion").model
    g = _gen(91)
    rows, host = {}, {}

    def built(m):
        init_params_(m, 0)
        return m.cuda()

    # BEVFusion's lidar path on the rig's dense sweep at nuscenes_fusion's
    # voxel grid and capacities
    pts, pc_range = dense_cloud(mc)
    t0 = time.perf_counter()
    vox, coords, counts, nv = native.hard_voxelize(pts, pc_range, mc.bev_voxel_size, 10,
                                                   mc.bev_voxel_caps[0])
    rb = build_sparse_encoder_rulebooks(coords, nv, mc.bev_sparse_shape, mc.bev_voxel_caps)
    host["sparse_s"] = time.perf_counter() - t0
    model = built(SparseSECOND(SparseEncoder(5), SECOND(256, (128, 256), (5, 5), (1, 2)),
                               SECONDFPN((128, 256), (256, 256), (1, 2))))
    rows["sparse_encoder_second_secondfpn"] = dict(zoo_row(model, (
        torch.from_numpy(mean_voxel_features(vox, counts)).cuda(),
        {k: torch.from_numpy(v).cuda() for k, v in rb.items()})), voxels=nv,
        sparse_shape=list(mc.bev_sparse_shape), caps=list(mc.bev_voxel_caps))
    del model
    # DepthLSSTransform on 6 cameras: the depth canvas of the key sweep and
    # 10 past sweeps
    t0 = time.perf_counter()
    rig = SyntheticBEVDataset(6, (256, 704), scope=51.2).rig()
    cloud = multi_sweep_points(pts, _sweeps(mc), np.random.default_rng(0), sweeps_num=10)
    canvas = rasterize_lidar_depth(cloud, *rig, (256, 704))
    host["depth_canvas_s"] = time.perf_counter() - t0
    lss = built(DepthLSSTransform(256))
    rows["depth_lss_transform"] = dict(zoo_row(lss, (
        torch.randn(1, 6, 32, 88, 256, generator=g).cuda(), torch.from_numpy(canvas)[None].cuda(),
        *(torch.from_numpy(a)[None].cuda() for a in rig))), points=len(cloud),
        canvas_pixels_set=int((canvas > 0).sum()))
    del lss
    # PointPillars SECFPN on nuScenes: 0.25 m pillars over +-50 m (a 400^2
    # canvas), <= 64 points in each of <= 30,000 pillars, 64 channels
    t0 = time.perf_counter()
    feats, counts_p, coords_p, valid = _pillars(pts[:, :4].copy(), (-50.0, -50.0, -5.0, 50.0,
                                                                    50.0, 3.0),
                                                (0.25, 0.25, 8.0), 64, 30_000)
    host["pillars_s"] = time.perf_counter() - t0
    pp = built(PointPillars(PillarFeatureNet(4, (64,), (0.25, 0.25), (-50.0, -50.0)),
                            SECOND(64, (64, 128, 256), (3, 5, 5), (2, 2, 2)),
                            SECONDFPN((64, 128, 256), (128, 128, 128), (1, 2, 4)), 400, 400))
    rows["pointpillars_secfpn"] = dict(zoo_row(pp, tuple(t.cuda() for t in (
        feats, counts_p, coords_p, valid))), pillars=int(valid.sum()))
    del pp
    for name, m in (("dla34", DLA()), ("vovnet_v2_19_slim", VoVNet())):
        rows[name] = zoo_row(built(m), (torch.randn(6, 256, 704, 3, generator=g).cuda(),))
        del m
    return {"models": rows, "host_s": host}


def remat_case(smi: str) -> dict:
    """lidar_zoo (c): decoder_remat on ade20k_swin_t_msda at 2 x 512^2, f32,
    from one state (the end of the lr warm-up) and batch: the eager step with
    and without remat (the flag toggled on the one model) held as graph is
    held to eager (first loss 1e-5 relative; each parameter tensor within
    1e-3 of its update + 3 x two runs' distance without remat), the launches
    of the five kernels in a remat step (the wrappers' counts, and a
    profile's) equal to the step's without, a graphed remat chunk of 2 steps
    held to its eager steps (deterministic algorithms on), and the eager
    and graphed step ms and peak GB with and without remat."""
    from ddp_tpu_torch.config import get_config
    from ddp_tpu_torch.train.step import make_chunked_train_step, make_train_step

    cfg = get_config("ade20k_swin_t_msda")
    state = dist_state(cfg)
    encoder = state.model.decode_head.encoder
    batch = train_batch(cfg, 2)
    eager = make_train_step()
    out = {"preset": cfg.name, "img": [2, *cfg.data.crop_size, 3], "dtype": "float32, tf32 off"}
    eager(state, batch)  # fill the device caches (masks, reference points)
    before = snapshot(state)
    params_0 = {k: before[0][k] for k, _ in state.model.named_parameters()}
    runs = {}
    for key, remat in (("plain", False), ("plain_again", False), ("remat", True)):
        restore(state, before)
        encoder.remat = remat
        reset_all_launches()
        logs = eager(state, batch)
        runs[key] = (logs["loss"].item(), params_of(state), all_launches())
    restore(state, before)
    loss_rel = abs(runs["remat"][0] - runs["plain"][0]) / abs(runs["plain"][0])
    params_ok, params = check_by_tensor(runs["plain"][1], runs["remat"][1], params_0,
                                        l2_by_tensor(runs["plain_again"][1], runs["plain"][1]))
    _, profiled_launches = profile_call(lambda: eager(state, batch))
    out["remat_vs_plain"] = {"loss_plain": runs["plain"][0], "loss_remat": runs["remat"][0],
                             "loss_rel_diff": loss_rel, "params": params,
                             "launches_plain": runs["plain"][2],
                             "launches_remat": runs["remat"][2],
                             "launches_remat_profiled": profiled_launches}
    restore(state, before)
    for key, remat in (("plain", False), ("remat", True)):
        encoder.remat = remat
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ms = wall_s(lambda: eager(state, batch), reps=3) * 1e3
        row = {"eager_ms": ms, "eager_peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        torch.cuda.reset_peak_memory_stats()
        with deterministic_algorithms(True):
            chunk = make_chunked_train_step(2)
            chunk(state, stacked(batch, 2))  # eager on the capture stream, then capture
            # the capture's peak: the graph's pool holds what its steps keep
            row["graph_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            if remat:
                row["graph_vs_eager"] = graph_vs_eager(state, chunk, eager, batch, 2)
        row["graph_ms_per_step"] = wall_s(lambda: chunk(state, stacked(batch, 2)), reps=3) * 500
        out[key] = row
        del chunk
        torch.cuda.empty_cache()
    encoder.remat = False
    ok = (loss_rel <= 1e-5 and params_ok and runs["remat"][2] == runs["plain"][2] == PER_STEP
          and profiled_launches == PER_STEP)
    if not ok:
        emit({"phase": "lidar_zoo", "failed_check": out, "card": smi})
        raise AssertionError(f"lidar_zoo remat: loss rel {loss_rel}, {params}, launches "
                             f"{runs['remat'][2]} / {profiled_launches}")
    return out


def phase_lidar_zoo(smi: str) -> dict:
    """The lidar pieces card vs CPU and at published widths, and
    decoder_remat (lidar_tiny_cases, lidar_published, remat_case)."""
    t0 = time.perf_counter()
    reference = lidar_reference(smi)
    published = lidar_published(smi)
    gc.collect()
    torch.cuda.empty_cache()
    remat = remat_case(smi)
    emit({"phase": "lidar_zoo", "reference": reference, "published": published,
          "decoder_remat": remat, "wall_s": time.perf_counter() - t0, "card": smi})
    return {"lidar_zoo": {k: sum(r["launches"][k] for r in published["models"].values())
                          for k in PER_STEP},
            "remat_train": remat["remat_vs_plain"]["launches_remat"]}


PHASES = ("build", "kernels", "reference", "train_reference", "main", "serve", "train",
          "table_grad", "graph", "loop", "dist", "tools", "dist_two", "msda_main", "msda_train", "city_main", "city_train",
          "city_data", "depth_reference", "depth_main", "depth_train", "depth_data",
          "bev_reference", "bev_main", "bev_train", "fusion_reference", "fusion_main",
          "fusion_train", "fusion_host", "cn_reference", "cn_main", "cn_train",
          "compat_reference", "compat_main", "compat_depth", "lidar_zoo", "host_data",
          "converge",
          "graph_grads",
          "replay_records", "converge_msda", "converge_depth", "converge_bev",
          "converge_bev_fusion", "converge_seg_quarter", "converge_controlnet")
ON_REQUEST = ("dist_two", "fusion_host", "host_data", "converge", "graph_grads",
              "replay_records",
              "converge_msda",
              "converge_depth", "converge_bev", "converge_bev_fusion", "converge_seg_quarter",
              "converge_controlnet")
DEFAULT_PHASES = tuple(p for p in PHASES if p not in ON_REQUEST)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", help="write per-kernel device-time tables here")
    ap.add_argument("--phases", default=",".join(DEFAULT_PHASES),
                    help="comma-separated subset of the phases after device (default: all "
                         "but dist_two, fusion_host, host_data, converge, graph_grads, replay_records, "
                         "converge_msda, "
                         "converge_depth, converge_bev, converge_bev_fusion, "
                         "converge_seg_quarter and converge_controlnet; serve needs main)")
    # one of dist_two's processes (chip_smoke.py starts them itself)
    ap.add_argument("--dist-two-rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.dist_two_rank is not None:
        return dist_two_rank(args.dist_two_rank, args.port, args.out)
    phases = args.phases.split(",")
    if not set(phases) <= set(PHASES) or ("serve" in phases and "main" not in phases):
        ap.error(f"--phases takes a subset of {','.join(PHASES)}; serve needs main")
    import ddp_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)
    name, smi = phase_device()
    phase_build()
    kernels = phase_kernels(name, smi) if "kernels" in phases else []
    if "reference" in phases:
        phase_reference()
    if "train_reference" in phases:
        phase_train_reference(smi)
    launches = {}
    if "main" in phases:
        model, cfg, launches["serve"] = phase_main(smi, args.profile)
        if "serve" in phases:
            phase_serve(model, cfg, smi)
        del model
        torch.cuda.empty_cache()
    if "train" in phases:
        launches["train"] = phase_train(smi, args.profile)
    if "table_grad" in phases:
        phase_table_grad(smi)
    if "graph" in phases:
        launches["graph"] = phase_graph(smi, args.profile)
    if "loop" in phases:
        launches["loop_wrappers"], launches["loop"] = phase_loop(smi)
    if "dist" in phases:
        launches["dist"] = phase_dist(smi)
        gc.collect()
        torch.cuda.empty_cache()
    if "tools" in phases:
        for key, n in phase_tools(smi).items():
            launches[f"tools_{key}"] = dict(NO_KERNELS, encode_map=n)
        gc.collect()
        torch.cuda.empty_cache()
    if "dist_two" in phases:
        phase_dist_two(smi)
    if "msda_main" in phases:
        launches["msda_serve"] = phase_msda_main(smi)
    if "msda_train" in phases:
        launches["msda_train"], launches["msda_graph"] = phase_msda_train(smi)
    if "city_main" in phases:
        for key, counted in phase_city_main(smi, args.profile).items():
            launches[f"city_{key}"] = counted
    if "city_train" in phases:
        launches["city_train"], launches["city_graph"] = phase_city_train(smi, args.profile)
    if "city_data" in phases:
        phase_city_data(smi)
    if "depth_reference" in phases:
        phase_depth_reference(smi)
    if "depth_main" in phases:
        launches["depth_serve"] = phase_depth_main(smi)
    if "depth_train" in phases:
        launches["depth_train"], launches["depth_graph"] = phase_depth_train(smi, args.profile)
    if "depth_data" in phases:
        phase_depth_data(smi)
    if "bev_reference" in phases:
        phase_bev_reference(smi)
    if "bev_main" in phases:
        launches["bev_serve"] = phase_bev_main(smi, args.profile)
    if "bev_train" in phases:
        launches["bev_graph"] = phase_bev_train(smi, args.profile)
    if "fusion_reference" in phases:
        phase_fusion_reference(smi)
    if "fusion_main" in phases:
        launches["fusion_serve"] = phase_fusion_main(smi, args.profile)
    if "fusion_train" in phases:
        launches["fusion_graph"] = phase_fusion_train(smi, args.profile)
    if "fusion_host" in phases:
        phase_fusion_host(smi)
    if "cn_reference" in phases:
        phase_cn_reference(smi)
    cn = None
    if "cn_main" in phases:
        cn, launches["cn_serve"] = phase_cn_main(smi)
    if "cn_train" in phases:
        launches["cn_train"] = phase_cn_train(smi, cn, args.profile)
    del cn
    gc.collect()
    torch.cuda.empty_cache()
    if "compat_reference" in phases:
        phase_compat_reference(smi)
    if "compat_main" in phases:
        compat = phase_compat_main(smi)
        launches["compat_serve"], launches["compat_train"] = compat["serve"], compat["train"]
    if "compat_depth" in phases:
        compat = phase_compat_depth(smi)
        launches["compat_depth_serve"] = compat["serve"]
        launches["compat_depth_train"] = compat["train"]
    if "lidar_zoo" in phases:
        launches.update(phase_lidar_zoo(smi))
        gc.collect()
        torch.cuda.empty_cache()
    if "host_data" in phases:
        phase_host_data(smi)
    if "converge_controlnet" in phases:
        phase_converge_controlnet(smi)
    if "converge_depth" in phases:
        phase_converge_depth(smi)
    if "converge_bev" in phases:
        phase_converge_bev(smi)
    if "converge_bev_fusion" in phases:
        phase_converge_bev_fusion(smi)
    if "converge_seg_quarter" in phases:
        phase_converge_seg_quarter(smi)
    if "converge" in phases:
        phase_converge(smi)
    if "converge_msda" in phases:
        phase_converge_msda(smi)
    if "graph_grads" in phases:
        phase_graph_grads(smi)
    if "replay_records" in phases:
        phase_replay_records(smi)
    if "graph" in phases:  # last: it leaves a failed capture behind
        emit({"phase": "graph", "failed_capture_raises": check_capture_failure(), "card": smi})
    for row in kernels:
        path = "serve" if row["name"] == "encode_map" else "train"
        row["launches"] = launches[path][row["name"]] if path in launches else None
        row["launches_per"] = "sample() call" if path == "serve" else "train step"
        # the wrappers' counts, read just after the path ran with the counts
        # at 0, and what the card ran in replays, counted in a profile
        row["launches_by_path"] = {
            label: launches[key][row["name"]] for key, label in (
                ("serve", "sample() call"), ("train", "eager train step"),
                ("graph", "replayed step of a 10-step CUDA graph (ade20k_swin_t), profiled"),
                ("loop", "train() on converge_seg_window, steps 31-50 (2 replays), profiled"),
                ("loop_wrappers", "train() on converge_seg_window, 100 steps: wrapper counts "
                                  "(the eager first chunk and the capture)"),
                ("dist", "eager train step of ade20k_swin_t under an NCCL group of 1, with "
                         "the gradient all-reduce"),
                ("tools_image_demo", "tools/image_demo.py on one 512^2 PNG, ade20k_swin_t"),
                ("tools_flip_tta", "flip_tta of sample() on one 512^2 image (2 calls)"),
                ("tools_multi_scale_flip_tta", "multi_scale_flip_tta of sample() on one 512^2 "
                                               "image (6 scales x 2 flips)"),
                ("msda_serve", "sample() call of ade20k_swin_t_msda"),
                ("msda_train", "eager train step of ade20k_swin_t_msda"),
                ("msda_graph", "replayed step of a 10-step CUDA graph (ade20k_swin_t_msda), "
                               "profiled"),
                ("city_msda_whole", "sample() of one 1024x2048 image, cityscapes_convnext_t "
                                    "with the imported msda decoder"),
                ("city_msda_slide", "slide_inference (3 crops of 1024^2) of one 1024x2048 "
                                    "image, cityscapes_convnext_t with the imported msda "
                                    "decoder"),
                ("city_window_whole", "sample() of one 1024x2048 image, cityscapes_convnext_t"),
                ("city_window_slide", "slide_inference (3 crops of 1024^2) of one 1024x2048 "
                                      "image, cityscapes_convnext_t"),
                ("city_train", "eager train step of cityscapes_convnext_t, 4 x 512x1024"),
                ("city_graph", "replayed step of a 10-step CUDA graph (cityscapes_convnext_t, "
                               "4 x 512x1024), profiled"),
                ("depth_serve", "sample() of one 480x640 frame, nyu_swin_t (depther)"),
                ("depth_train", "eager train step of nyu_swin_t (depther), 2 x 416x544"),
                ("depth_graph", "replayed step of a 10-step CUDA graph (nyu_swin_t, depther, "
                                "2 x 416x544), profiled"),
                ("bev_serve", "sample() of one 6-camera 256x704 scene, nuscenes_camera (BEV)"),
                ("bev_graph", "replayed step of a 10-step CUDA graph (nuscenes_camera, BEV, "
                              "the bev_train batch), profiled"),
                ("fusion_serve", "sample() of one scene, nuscenes_fusion (camera + lidar BEV)"),
                ("fusion_graph", "replayed step of a 5-step CUDA graph (nuscenes_fusion, f32, "
                                 "the fusion_train batch), profiled"),
                ("cn_serve", "sample() of one 512^2 image, controlnet_sd15 (20 DDIM steps, "
                             "CFG)"),
                ("cn_train", "eager f32 train step of controlnet_sd15, 4 x 512^2"),
                ("compat_serve", "predict() of one image, summed over the twelve compat_main "
                                 "configurations (upernet_r50, deeplabv3plus_r50-d8, "
                                 "ocrnet_hr18, segformer_mit-b0, dpt_vit-b16, encnet_r50-d8, "
                                 "ccnet_r50-d8, emanet_r50-d8, fast_scnn, "
                                 "twins_pcpvt-s_upernet, twins_svt-s_upernet, "
                                 "upernet_beit-base), and DiffSwin-T's eval forward"),
                ("compat_train", "3 eager train steps at batch 2, summed over the twelve "
                                 "compat_main configurations and DiffSwin-T"),
                ("compat_depth_serve", "predict() of one 480x640 frame (AdaBins 416x544), "
                                       "summed over the six compat_depth configurations "
                                       "(densedepth_r50, bts_r50, adabins_efnetb5, "
                                       "depthformer_swint, binsformer_swint, newcrfs_swint)"),
                ("compat_depth_train", "3 eager train steps at 2 x 416x544, summed over the "
                                       "six compat_depth configurations"),
                ("lidar_zoo", "the lidar pieces at published widths (SparseEncoder -> SECOND -> "
                              "SECONDFPN, DepthLSSTransform, PointPillars SECFPN, DLA-34, "
                              "VoVNet-V2-19-slim): 4 eval forwards and 4 forward + backward "
                              "passes each, summed"),
                ("remat_train", "eager train step of ade20k_swin_t_msda with decoder_remat, "
                                "2 x 512^2, f32"))
            if key in launches}
    print(json.dumps(phase_seconds()), flush=True)
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
