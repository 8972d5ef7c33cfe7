#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``ddp_tpu_torch``).

    python3 chip_smoke.py                  # one CUDA device, from the repo root
    python3 chip_smoke.py --profile OUT    # also write per-kernel device-time
                                           # tables of one sample() call and one
                                           # train step to OUT (and OUT.train)
    python3 chip_smoke.py --phases build,kernels   # a subset (device and
                                           # build always run)

Phases, each printing one JSON line; any failure raises and exits non-zero:

  0. device  - needs torch.cuda; prints the card's name and power limit
               (nvidia-smi) on a line of its own. TF32 is switched off for
               matmuls and cuDNN for every phase: the parity checks and the
               timings are float32 unless a phase says bf16.
  1. build   - compiles ddp_tpu_torch/csrc/*.cu with nvcc (sm_90a, one nvcc
               per source, in parallel) and loads the library.
  2. kernels - each CUDA kernel against its plain PyTorch version on the card
               at the main paths' shapes and at edge shapes, with its time
               (cold L2), the plain version's time, one PyTorch call's time
               where one computes the same function, and its bound; the
               upsample_ce forward's and backward's lines also give their
               tile, grid, shared bytes, registers and spilled bytes.
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

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import time

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


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


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

    saved = {(Q, n): getattr(Q, n) for n in ("encode_map_cuda", "q_sample_cuda", "dtable_cuda")}
    saved.update({(U, n): getattr(U, n) for n in ("upsample_ce_fwd_cuda", "upsample_ce_bwd_cuda")})
    Q.encode_map_cuda, Q.q_sample_cuda = Q.encode_map_plain, Q.q_sample_plain
    Q.dtable_cuda = Q.dtable_plain
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
    from ddp_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load_library()
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "library": _build.library_path()})


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


def check_encode_map(card, smi, flush):
    from ddp_tpu_torch.ops import q_sample as Q

    k = K + 1
    errs = {}
    for dtype, tol in ((torch.float32, 1e-6 * BIT_SCALE),
                       # one bf16 ulp of |out| < 2^-6: 2^-7 * 2^-7
                       (torch.bfloat16, 2.0 ** -14)):
        # the main path's shape, a ragged N, and a C that is no multiple of
        # the 16-byte vector (the kernel's scalar path)
        for rows, cols in ((N, C), (N + 3, C), (1001, C - 6)):
            g = _gen(0)
            labels = torch.randint(0, k, (rows,), generator=g).cuda()
            table = torch.randn(k, cols, generator=g).to(dtype).cuda()
            err = (Q.encode_map_cuda(labels, table, BIT_SCALE).float()
                   - Q.encode_map_plain(labels, table, BIT_SCALE).float()).abs().max().item()
            errs[f"{str(dtype)[6:]}_n{rows}_c{cols}"] = err
            if not err <= tol:
                raise AssertionError(f"encode_map {dtype} N={rows} C={cols}: err {err} > {tol}")
    g = _gen(0)
    labels = torch.randint(0, k, (N,), generator=g).cuda()
    table = torch.randn(k, C, generator=g).cuda()
    row = kernel_row(
        card, "encode_map", "ddp_tpu_torch/csrc/encode_map.cu",
        "ddp_tpu/ops/pallas/q_sample.py:75",
        lambda: Q.encode_map_cuda(labels, table, BIT_SCALE),
        lambda: Q.encode_map_plain(labels, table, BIT_SCALE),
        nbytes=N * 8 + k * C * 4 + N * C * 4,  # labels, table read once, out written once
        flops=N * C * 6, exps=N * C, err=errs[f"float32_n{N}_c{C}"], flush=flush)
    emit({"phase": "kernels", "kernel": "encode_map", "max_abs_err": errs,
          "tolerance": "f32 1e-6 x bit_scale; bf16 one ulp of |out| (2^-14)",
          "library_ms": "null: no single PyTorch call computes gather+squash",
          "row": row, "card": smi})
    return row


def _qs_inputs(n, c, dtype, seed=0):
    g = _gen(seed)
    labels = torch.randint(0, K + 1, (n,), generator=g).cuda()
    table = torch.randn(K + 1, c, generator=g).to(dtype).cuda()
    alpha, sigma = torch.rand(n, generator=g).cuda(), torch.rand(n, generator=g).cuda()
    noise = torch.randn(n, c, generator=g).to(dtype).cuda()
    return labels, table, alpha, sigma, noise


def check_q_sample(card, smi, flush):
    from ddp_tpu_torch.ops import q_sample as Q

    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for n, c in ((N, C), (N + 3, C), (N + 3, 250)):
            args = _qs_inputs(n, c, dtype)
            got = Q.q_sample_cuda(args[0], args[1], BIT_SCALE, *args[2:]).float()
            want = Q.q_sample_plain(args[0], args[1], BIT_SCALE, *args[2:]).float()
            err = (got - want).abs().max().item()
            errs[f"{str(dtype)[6:]}_n{n}_c{c}"] = err
            # f32: the same roundings in both (no FMA contraction), so only
            # expf's last ulp differs, times bit_scale; bf16: one ulp of the
            # rounded result
            tol = 1e-6 if dtype == torch.float32 else \
                (2.0 ** -8 * want.abs().max()).item()
            if not err <= tol:
                raise AssertionError(f"q_sample {dtype} N={n} C={c}: err {err} > {tol}")
    labels, table, alpha, sigma, noise = _qs_inputs(N, C, torch.float32)
    row = kernel_row(
        card, "q_sample", "ddp_tpu_torch/csrc/q_sample.cu",
        "ddp_tpu/ops/pallas/q_sample.py:83",
        lambda: Q.q_sample_cuda(labels, table, BIT_SCALE, alpha, sigma, noise),
        lambda: Q.q_sample_plain(labels, table, BIT_SCALE, alpha, sigma, noise),
        # labels, alpha, sigma, table and noise read once; out written once
        nbytes=N * (8 + 4 + 4) + (K + 1) * C * 4 + 2 * N * C * 4,
        flops=N * C * 9, exps=N * C, err=errs[f"float32_n{N}_c{C}"], flush=flush)
    emit({"phase": "kernels", "kernel": "q_sample", "max_abs_err": errs,
          "tolerance": "f32 1e-6 absolute; bf16 2^-8 x max|out| (one bf16 ulp)",
          "library_ms": "null: no single PyTorch call computes gather+squash+corrupt",
          "row": row, "card": smi})
    return row


def check_dtable(card, smi, flush):
    from ddp_tpu_torch.ops import q_sample as Q

    k = K + 1
    errs = {}
    for case, n, c in (("random", N, C), ("ragged", N + 3, 250), ("contended", N, C)):
        g = _gen(1)
        labels = torch.randint(0, k, (n,), generator=g)
        if case == "contended":  # 70 % of the rows in one class
            labels[torch.rand(n, generator=g) < 0.7] = 3
        labels = labels.cuda()
        demb = torch.randn(n, c, generator=g).cuda()
        got, want = Q.dtable_cuda(labels, demb, k), Q.dtable_plain(labels, demb, k)
        err = (got - want).abs().max().item()
        errs[f"{case}_n{n}_c{c}"] = err
        # atomics add in no fixed order: relative 1e-5 of each sum, plus 1e-5
        # for sums that cancel to near 0 (each is of ~200 to 23000 unit terms)
        if not ((got - want).abs() <= 1e-5 * want.abs() + 1e-5 * want.abs().max()).all():
            raise AssertionError(f"dtable {case}: max abs err {err}")
    g = _gen(1)
    labels = torch.randint(0, k, (N,), generator=g).cuda()
    demb = torch.randn(N, C, generator=g).cuda()
    zeros = torch.zeros(k, C, device="cuda")
    row = kernel_row(
        card, "dtable", "ddp_tpu_torch/csrc/q_sample.cu",
        "ddp_tpu/ops/pallas/q_sample.py:93",
        lambda: Q.dtable_cuda(labels, demb, k), lambda: Q.dtable_plain(labels, demb, k),
        nbytes=N * 8 + N * C * 4 + k * C * 4, flops=N * C, exps=0,
        err=errs[f"random_n{N}_c{C}"], flush=flush,
        library_fn=lambda: zeros.index_add_(0, labels, demb))
    emit({"phase": "kernels", "kernel": "dtable", "max_abs_err": errs,
          "tolerance": "|d| <= 1e-5 |want| + 1e-5 max|want| (atomic order)",
          "library_ms": "torch.zeros(K, C).index_add_(0, labels, demb), zeros preallocated",
          "row": row, "card": smi})
    return row


def _ce_inputs(b, h, w, k, scale, dtype, seed=2, labels="random"):
    """labels: "random" with a block of ignored pixels, "ignored" (every
    pixel 255), "one" (every pixel class k // 2) or "outside" (random, with
    rows of valid labels k + 3 and columns of -4, and the logits shifted by
    +3 so that every pixel's max z is positive: then the kernel's correct
    rule for such a label, 0 >= max z, and the plain version's argmax rule
    both count none)."""
    g = _gen(seed)
    logits = torch.randn(b, h, w, k, generator=g)
    lab = torch.randint(0, k, (b, scale * h, scale * w), generator=g)
    lab[0, :scale * 3, :scale * 5] = 255  # a block of ignored pixels
    if labels == "ignored":
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


def check_upsample_ce(card, smi, flush):
    from ddp_tpu_torch.ops import upsample_ce as U

    fwd_errs, bwd_errs = {}, {}
    for case, shape, scale, dtype, lab_mode in _ce_cases():
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
        # are exact (integers below 2^24; random logits have no ties)
        if not abs(sums[0].item() - want[0].item()) <= 1e-5 * abs(want[0].item()):
            raise AssertionError(f"upsample_ce fwd {case}: nll {sums[0].item()} vs "
                                 f"{want[0].item()}")
        if sums[1:].tolist() != want[1:].tolist():
            raise AssertionError(f"upsample_ce fwd {case}: counts {sums[1:].tolist()} vs "
                                 f"{want[1:].tolist()}")
        # lse: ex2.approx (~2 ulp) per term against expf, and m log2 e rounded
        if not (lse_err <= 4e-6 * want_lse.abs().clamp(min=1.0)).all():
            raise AssertionError(f"upsample_ce fwd {case}: lse max abs err {lse_err.max().item()}")
        if not ((d - d_want).abs() <= 1e-4 * d_want.abs() + 1e-6).all():
            raise AssertionError(f"upsample_ce bwd {case}: max abs err {bwd_errs[case]}")
    logits, labels = _ce_inputs(*CE_SHAPE, SCALE, torch.float32)
    b, h, w, k = CE_SHAPE
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
        emit({"phase": "kernels", "kernel": row["name"], "bf16_logits_ms": ms,
              "max_abs_err": errs,
              "tolerance": "fwd: nll rtol 1e-5 (atomic order), counts exact, "
                           "lse |d| <= 4e-6 max(1, |lse|); bwd: rtol 1e-4, atol 1e-6",
              "library_ms": "null: no single PyTorch call computes a bilinear upsample "
                            "fused with cross-entropy",
              "row": row, "build": build, "card": smi})
    return rows


def phase_kernels(card: str, smi: str):
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    rows = [check_encode_map(card, smi, flush), check_q_sample(card, smi, flush),
            check_dtable(card, smi, flush)]
    return rows + check_upsample_ce(card, smi, flush)


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
        busy_ms, _ = profile_device(lambda: model.sample(img, init_noise=noise), profile,
                                    f"# one ade20k_swin_t sample() at {b}x{h}x{w}, {smi}\n")
        # device busy share: kernel time of the profiled call over the
        # unprofiled wall time of one call
        emit({"phase": "profile", "table": profile, "device_busy_ms": busy_ms,
              "sample_ms": sec * 1e3, "busy_share": busy_ms / (sec * 1e3), "card": smi})
    return model, cfg, launches


def profile_device(fn, path: str, header: str):
    """Profile one call of ``fn``: (device kernel ms, top kernel families),
    and the per-kernel table written to ``path``."""
    from torch.profiler import ProfilerActivity, profile as prof

    with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        fn()
        torch.cuda.synchronize()
    events = p.key_averages()
    # kernel rows only (the aten rows repeat their kernels' time)
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    with open(path, "w") as f:
        f.write(header)
        f.write(events.table(sort_by="cuda_time_total", row_limit=60))
    return busy_ms, [(e.key[:90], e.self_device_time_total / 1e3, e.count) for e in top]


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
        busy_ms, top = profile_device(lambda: step(state, batch), profile + ".train",
                                      f"# one ade20k_swin_t f32 train step at {b}x512x512, "
                                      f"{smi}\n")
        out.update(device_busy_ms=busy_ms, busy_share=busy_ms / (step_s * 1e3),
                   top_kernels_ms=top)
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
        busy_ms, top = profile_device(lambda: bf16(state, batch), profile + ".train_bf16",
                                      f"# one ade20k_swin_t bf16 train step at {b}x512x512, "
                                      f"{smi}\n")
        out.update(device_busy_ms=busy_ms, busy_share=busy_ms / (sec * 1e3),
                   top_kernels_ms=top)
    emit(out)
    return launches


PHASES = ("build", "kernels", "reference", "train_reference", "main", "serve", "train")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", help="write per-kernel device-time tables here")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of the phases after device (default: all; "
                         "serve needs main)")
    args = ap.parse_args(argv)
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
    for row in kernels:
        path = "serve" if row["name"] == "encode_map" else "train"
        row["launches"] = launches[path][row["name"]] if path in launches else None
        row["launches_per"] = "sample() call" if path == "serve" else "train step"
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
