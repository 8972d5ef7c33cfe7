"""Training-log analyzer (port of ``tools/analyze_logs.py``).

    python -m ddp_tpu_torch.tools.analyze_logs WORKDIR_OR_LOG [--keys loss ...]

Reads a workdir's ``train_log.jsonl`` (``train/loop.py: MetricLogger``) and
prints the record count, the mean training speed and, for each key, its
first, last, lowest and highest values: the JAX tool's text.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="summarise a train_log.jsonl")
    p.add_argument("path")
    p.add_argument("--keys", nargs="*", default=None)
    p.add_argument("--interval", type=int, default=1,
                   help="subsample records for the curve printout")
    args = p.parse_args(argv)

    path = args.path
    if os.path.isdir(path):
        path = os.path.join(path, "train_log.jsonl")
    with open(path) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    if not recs:
        print("empty log")
        return 0
    keys = args.keys or [k for k in recs[-1] if k != "step"]

    steps = [r["step"] for r in recs]
    print(f"{len(recs)} records, steps {steps[0]}..{steps[-1]}")
    if "steps_per_s" in recs[-1]:
        sps = [r["steps_per_s"] for r in recs if "steps_per_s" in r][1:]
        if sps:
            avg = sum(sps) / len(sps)
            print(f"avg speed: {avg:.3f} steps/s (min {min(sps):.3f}, max {max(sps):.3f})")
    for k in keys:
        vals = [(r["step"], r[k]) for r in recs if k in r]
        if not vals:
            continue
        vs = [v for _, v in vals]
        best_step, best = min(vals, key=lambda t: t[1])
        print(f"{k:>24}: first {vs[0]:.5g}  last {vs[-1]:.5g}  "
              f"min {best:.5g}@{best_step}  max {max(vs):.5g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
