"""Publish a checkpoint (port of ``tools/publish_model.py``).

    python -m ddp_tpu_torch.tools.publish_model WORKDIR OUT_PREFIX [--step N]

Strips the checkpoint of ``--step`` (the latest by default) under
``WORKDIR/ckpts`` to the model state (parameters and BN statistics: no
optimizer moments, generator or meta), writes it with ``torch.save`` and
names it ``OUT_PREFIX-<the first 8 hex digits of its sha256>.pt``, the
reference's convention (``train/checkpoint.py: publish``). The other tools
read it with ``--ckpt``.
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="publish a ddp_tpu_torch checkpoint")
    p.add_argument("workdir")
    p.add_argument("out_prefix")
    p.add_argument("--step", type=int, default=None)
    args = p.parse_args(argv)
    from ..train.checkpoint import publish

    try:
        step, path, nbytes = publish(args.workdir, args.out_prefix, args.step)
    except FileNotFoundError as e:
        raise SystemExit(str(e))
    print(f"published step {step} -> {path} ({nbytes / 1e6:.1f} MB)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
