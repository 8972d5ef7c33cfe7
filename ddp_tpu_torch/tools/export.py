"""Model export for deployment (port of ``tools/export.py``).

    python -m ddp_tpu_torch.tools.export PRESET OUT.pt2 [--size 512] [--batch 1]
        [--ckpt PUBLISHED.pt|.msgpack] [--device cuda|cpu]

Saves the preset's served forward, ``sample`` of a ``--batch`` x ``--size``^2
image batch [B, H, W, 3] (float32, normalised) to the class probabilities
[B, H, W, K] of a segmentor (task ``seg``) or the depth map [B, H, W] of a
depther (task ``depth``), as a ``torch.export`` program: the graph at static
shapes with the weights (``--ckpt``: the port's published ``.pt`` or the JAX
package's published ``.msgpack``; without one the seeded init, with a
warning) and the rollout's initial noise baked in. Any other task exits
non-zero, as the JAX tool fails there (a BEV model's ``sample`` takes the
camera rig as well).

The initial noise is drawn once, from a ``torch.Generator`` seeded 0 on the
export's device, so the program computes ``sample(img, generator)`` with
that generator fresh. The JAX tool closes over ``PRNGKey(0)`` instead; the
two streams differ, so the two packages' programs give different samples
of the same weights.

A loader needs ``torch`` and ``import ddp_tpu_torch.ops.q_sample``, which
registers the op ``ddp_tpu_torch::encode_map`` (the argmax re-embedding,
``timesteps`` calls per segmentor program, none in a depther's): no model
code::

    import torch, ddp_tpu_torch.ops.q_sample
    probs = torch.export.load("OUT.pt2").module()(img)

The export runs on the card unless ``--device cpu``; the program runs on the
device it was exported on.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Tuple

import torch
from torch import nn

TASKS = ("seg", "depth")


class ServedSample(nn.Module):
    """``model.sample(img)`` from the initial noise ``noise`` (a buffer, so
    that an export holds it as a constant)."""

    def __init__(self, model: nn.Module, noise: torch.Tensor):
        super().__init__()
        self.model = model
        self.register_buffer("noise", noise)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        # both sample(img, generator, init_noise / noise)
        return self.model.sample(img, None, self.noise)


def rollout_noise(model: nn.Module, model_cfg, batch: int, size: Tuple[int, int],
                  seed: int = 0) -> torch.Tensor:
    """The initial noise ``model.sample`` draws for a [batch, *size, 3] image
    from a generator seeded ``seed`` on the model's device:
    [randsteps·batch, h, w, C] on the latent grid (C: the segmentor's
    embedding width, 1 for a depther)."""
    from ..models.segmentor import latent_grid

    if model_cfg.task not in TASKS:
        raise ValueError(f"task {model_cfg.task!r}: export takes {TASKS}")
    if model_cfg.diffusion.method != "ddim":
        raise ValueError("export bakes in the initial noise only: a 'ddpm' rollout draws "
                         "noise at every step")
    device = next(model.parameters()).device
    h, w = latent_grid(model_cfg.backbone_type, size)
    c = model_cfg.embed_dims if model_cfg.task == "seg" else 1
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((model_cfg.diffusion.randsteps * batch, h, w, c), generator=gen,
                       device=device)


def export_sample(model: nn.Module, noise: torch.Tensor, img_shape: Tuple[int, ...]
                  ) -> torch.export.ExportedProgram:
    """``torch.export`` of ``ServedSample(model, noise)`` at a float32 image
    batch of ``img_shape`` on the model's device. One eager call first fills
    the device-constant caches (``device.py: device_constant``), so that the
    program holds those constants on the device instead of copying them from
    the host at every call."""
    device = next(model.parameters()).device
    example = torch.zeros(img_shape, dtype=torch.float32, device=device)
    served = ServedSample(model.eval(), noise)
    served(example)
    return torch.export.export(served, (example,))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="export a preset's sample() as a .pt2 program")
    p.add_argument("preset")
    p.add_argument("out")
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--ckpt", default=None,
                   help="published model state: the port's .pt or the JAX package's .msgpack")
    p.add_argument("--device", default=None, help="default: cuda")
    args = p.parse_args(argv)
    from ..config import get_config
    from ..device import resolve_device
    from . import served_model

    cfg = get_config(args.preset)
    if cfg.model.task not in TASKS:
        raise SystemExit(f"task {cfg.model.task!r}: export takes a segmentor or a depther "
                         f"(tasks {TASKS}), as the JAX tool does")
    device = resolve_device(args.device)
    size = (args.size, args.size)
    # a checkpoint's learned position tables are sized for its training
    # crop; the JAX tool's random init is sized for the exported image
    model = served_model(cfg, args.ckpt, device, None if args.ckpt else size)
    noise = rollout_noise(model, cfg.model, args.batch, size)
    program = export_sample(model, noise, (args.batch, *size, 3))
    torch.export.save(program, args.out)
    out = next(n for n in program.graph.nodes if n.op == "output").args[0][0].meta["val"]
    print(f"exported {args.out} ({os.path.getsize(args.out) / 1e6:.1f} MB), "
          f"in {[args.batch, *size, 3]} float32 -> out {list(out.shape)} {out.dtype}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
