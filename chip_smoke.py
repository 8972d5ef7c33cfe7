#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``ddp_tpu_torch``).

    python3 chip_smoke.py                  # one CUDA device, from the repo root
    python3 chip_smoke.py --profile OUT    # also write a per-kernel device-time
                                           # table of one sample() call to OUT

Phases, each printing one JSON line; any failure raises and exits non-zero:

  0. device  - needs torch.cuda; prints the card's name and power limit
               (nvidia-smi) on a line of its own. TF32 is switched off for
               matmuls and cuDNN for every phase: the parity checks and the
               timings are float32.
  1. build   - compiles ddp_tpu_torch/csrc/*.cu with nvcc (sm_90a) and loads it.
  2. kernels - each CUDA kernel against its plain PyTorch version on the card
               at the main path's shapes (and a ragged one), with its time,
               the plain version's time and its memory/compute bound.
  3. main    - ade20k_swin_t at full width (random weights from seed 0),
               DDPSegmentor.sample on a random 2x512x512 image batch: the
               launch counts must show the kernels ran, the result must be a
               probability map that agrees with the same call through the
               plain versions, and a small input must agree with the CPU.
  4. serve   - 4 requests through microbatched_call(model.predict, microbatch=2).

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import torch

BIT_SCALE = 0.01
ENCODE_SHAPE = dict(n=2 * 128 * 128, k=151, c=256)  # 2 x 512^2 ade20k_swin_t
# HBM bandwidth (bytes/s) and non-tensor-core float32 peak (FLOP/s) by card,
# from NVIDIA's data sheets; matched against torch.cuda.get_device_name()
CARDS = (("H200", 4.8e12, 67e12), ("H100 NVL", 3.9e12, 60e12),
         ("H100 PCIe", 2.0e12, 51e12), ("H100", 3.35e12, 67e12))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_peaks(name: str):
    for key, bw, f32 in CARDS:
        if key in name:
            return key, bw, f32
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


def wall_s(fn, reps: int = 5) -> float:
    """Median host time of ``fn`` ending in a device synchronise, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


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
    from ddp_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load_library()
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "library": _build.library_path()})


def encode_inputs(n, k, c, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    labels = torch.randint(0, k, (n,), generator=g).cuda()
    table = torch.randn(k, c, generator=g).to(dtype).cuda()
    return labels, table


def phase_kernels(card: str, smi: str):
    from ddp_tpu_torch.ops import q_sample as Q

    n, k, c = ENCODE_SHAPE["n"], ENCODE_SHAPE["k"], ENCODE_SHAPE["c"]
    errs = {}
    for dtype, tol in ((torch.float32, 1e-6 * BIT_SCALE),
                       # one bf16 ulp of |out| < 2^-6: 2^-7 * 2^-7
                       (torch.bfloat16, 2.0 ** -14)):
        # the main path's shape, a ragged N, and a C that is no multiple of
        # the 16-byte vector (the kernel's scalar path)
        for rows, cols in ((n, c), (n + 3, c), (1001, c - 6)):
            labels, table = encode_inputs(rows, k, cols, dtype)
            got = Q.encode_map_cuda(labels, table, BIT_SCALE)
            want = Q.encode_map_plain(labels, table, BIT_SCALE)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            errs[f"{str(dtype)[6:]}_n{rows}_c{cols}"] = err
            if not err <= tol:
                raise AssertionError(
                    f"encode_map {dtype} N={rows} C={cols}: max abs err {err} > {tol}")

    labels, table = encode_inputs(n, k, c, torch.float32)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    ms = time_ms(lambda: Q.encode_map_cuda(labels, table, BIT_SCALE), flush=flush)
    plain_ms = time_ms(lambda: Q.encode_map_plain(labels, table, BIT_SCALE), flush=flush)
    key, bw, f32_peak = card_peaks(card)
    nbytes = n * 8 + k * c * 4 + n * c * 4  # labels + table read once, out written once
    ops = n * c * 6  # neg-exp, add, divide, multiply, subtract, multiply per element
    bytes_ms, ops_ms = nbytes / bw * 1e3, ops / f32_peak * 1e3
    row = {"name": "encode_map", "route": "cuda",
           "source": "ddp_tpu_torch/csrc/encode_map.cu",
           "replaces": "ddp_tpu/ops/pallas/q_sample.py:75",
           "launches": None, "max_abs_err": max(v for kk, v in errs.items() if "float32" in kk),
           "ms": ms, "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "library_ms": None}
    emit({"phase": "kernels", "kernel": "encode_map", "shape": dict(ENCODE_SHAPE),
          "bit_scale": BIT_SCALE, "max_abs_err": errs, "ms": ms, "plain_ms": plain_ms,
          "bound_us": row["bound_ms"] * 1e3, "bytes": nbytes, "bandwidth": bw,
          "bandwidth_of": key, "card": smi,
          "library_ms": "null: no single PyTorch call computes gather+squash"})
    return [row]


def _plain_encode(model):
    """model.encode_map through the plain PyTorch version (comparison only)."""
    from ddp_tpu_torch.ops.q_sample import encode_map_plain

    table = model.embedding_table.weight

    def encode(labels):
        flat = encode_map_plain(labels.reshape(-1), table, model.bit_scale)
        return flat.reshape(labels.shape + (table.shape[-1],))
    return encode


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
    g = torch.Generator().manual_seed(11)
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
    from ddp_tpu_torch.ops import q_sample as Q

    cfg = get_config("ade20k_swin_t")
    m = cfg.model
    b, (h, w) = 2, cfg.data.crop_size
    model = build_model(m, device="cuda", seed=0)
    g = torch.Generator().manual_seed(1)
    img = torch.randn(b, h, w, 3, generator=g).cuda()
    noise = torch.randn(m.diffusion.randsteps * b, h // 4, w // 4, m.embed_dims,
                        generator=g).cuda()

    Q.reset_launches()
    probs = model.sample(img, init_noise=noise)
    torch.cuda.synchronize()
    launches = {"encode_map": Q.launches}
    want = m.diffusion.timesteps  # randsteps are folded into one batch per step
    if launches["encode_map"] != want:
        raise AssertionError(f"encode_map launched {launches['encode_map']} times, want {want}")
    check_probs(probs, (b, h, w, m.num_classes))

    model.encode_map = _plain_encode(model)  # the only plain run on the card
    try:
        plain = model.sample(img, init_noise=noise)
    finally:
        del model.encode_map
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
        from torch.profiler import ProfilerActivity, profile as prof

        with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
            model.sample(img, init_noise=noise)
            torch.cuda.synchronize()
        events = p.key_averages()
        # kernel rows only (the aten rows repeat their kernels' time)
        busy_ms = sum(e.self_device_time_total for e in events
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and not e.is_user_annotation) / 1e3
        with open(profile, "w") as f:
            f.write(f"# one ade20k_swin_t sample() at {b}x{h}x{w}, {smi}\n")
            f.write(events.table(sort_by="cuda_time_total", row_limit=60))
        # device busy share: kernel time of the profiled call over the
        # unprofiled wall time of one call
        emit({"phase": "profile", "table": profile, "device_busy_ms": busy_ms,
              "sample_ms": sec * 1e3, "busy_share": busy_ms / (sec * 1e3), "card": smi})
    return model, cfg, launches


def phase_serve(model, cfg, smi: str):
    from ddp_tpu_torch.evaluation.batched import microbatched_call
    from ddp_tpu_torch.ops import q_sample as Q

    n, mb = 4, 2
    h, w = cfg.data.crop_size
    g = torch.Generator().manual_seed(2)
    imgs = torch.randn(n, h, w, 3, generator=g).cuda()
    noise_gen = torch.Generator(device="cuda").manual_seed(3)
    Q.reset_launches()
    t0 = time.perf_counter()
    labels = microbatched_call(lambda x: model.predict(x, generator=noise_gen), imgs,
                               microbatch=mb)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    want = model.diffusion.timesteps * (n // mb)
    if Q.launches != want:
        raise AssertionError(f"serve: encode_map launched {Q.launches} times, want {want}")
    if tuple(labels.shape) != (n, h, w) or labels.dtype != torch.int64:
        raise AssertionError(f"serve: labels {labels.dtype} {tuple(labels.shape)}")
    lo, hi = labels.min().item(), labels.max().item()
    if not (0 <= lo and hi < model.num_classes):
        raise AssertionError(f"serve: labels outside [0, {model.num_classes}): {lo}..{hi}")
    emit({"phase": "serve", "requests": n, "microbatch": mb, "launches": Q.launches,
          "seconds": sec, "img_per_s": n / sec, "labels_range": [lo, hi], "card": smi})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", help="write a per-kernel device-time table here")
    args = ap.parse_args(argv)
    import ddp_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)
    name, smi = phase_device()
    phase_build()
    kernels = phase_kernels(name, smi)
    phase_reference()
    model, cfg, launches = phase_main(smi, args.profile)
    phase_serve(model, cfg, smi)
    for row in kernels:
        row["launches"] = launches[row["name"]]
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
