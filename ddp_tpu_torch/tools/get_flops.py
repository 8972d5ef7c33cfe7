"""FLOPs and parameter count (port of ``tools/get_flops.py``).

    python -m ddp_tpu_torch.tools.get_flops PRESET [--size 512] [--batch 1]
        [--device cpu]

Counts the parameters (the JAX tool's count of ``variables["params"]``: BN
statistics are not parameters) and the FLOPs of one ``sample`` call (the
full rollout) on a zero image, by ``torch.utils.flop_counter.FlopCounterMode``
(PyTorch's counter of its own operators' FLOPs: convolutions, matrix
products, attention; not element-wise work, and not the hand-written CUDA
kernels, which are called outside PyTorch's dispatcher). The JAX tool counts
with XLA's cost analysis of the compiled program, which counts everything
XLA emits, so the two totals differ by what each counter sees. Runs on the
card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import sys
from typing import Callable

import torch

COUNTER = "torch.utils.flop_counter.FlopCounterMode"


def count_flops(fn: Callable[[], object]) -> int:
    """The FLOPs ``FlopCounterMode`` counts while ``fn()`` runs."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="count a preset's parameters and FLOPs")
    p.add_argument("preset")
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--device", default=None, help="default: cuda")
    args = p.parse_args(argv)
    from ..config import build_model, get_config
    from ..device import resolve_device

    cfg = get_config(args.preset)
    device = resolve_device(args.device)
    model = build_model(cfg.model, device=device, seed=0,
                        input_size=(args.size, args.size)).eval()
    n_params = sum(p.numel() for p in model.parameters())
    img = torch.zeros((args.batch, args.size, args.size, 3), device=device)
    gen = torch.Generator(device=device).manual_seed(7)
    flops = count_flops(lambda: model.sample(img, generator=gen))
    print(f"preset:            {args.preset}")
    print(f"input:             {args.batch}x{args.size}x{args.size}x3")
    print(f"params:            {n_params / 1e6:.2f} M")
    print(f"forward flops:     {flops / 1e9:.2f} GFLOPs "
          f"(full {cfg.model.diffusion.timesteps}-step rollout; {COUNTER})")
    print("bytes accessed:    not counted (the counter counts FLOPs only)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
