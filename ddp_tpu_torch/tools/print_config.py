"""Print the resolved config of a preset (port of ``tools/print_config.py``).

    python -m ddp_tpu_torch.tools.print_config PRESET [--set K=V ...]
    python -m ddp_tpu_torch.tools.print_config --list

The config as JSON (dataclasses as objects, tuples as lists, anything else
as its string), the JAX tool's text; with ``--list`` or no preset, the
preset names.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys


def to_dict(obj):
    if dataclasses.is_dataclass(obj):
        return {f.name: to_dict(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [to_dict(v) for v in obj]
    if isinstance(obj, dict):
        return {k: to_dict(v) for k, v in obj.items()}
    return obj


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="print a ddp_tpu_torch preset")
    p.add_argument("preset", nargs="?", default=None)
    p.add_argument("--set", nargs="*", default=[], metavar="K=V")
    p.add_argument("--list", action="store_true", help="list preset names")
    args = p.parse_args(argv)
    from ..config import PRESETS, get_config

    if args.list or args.preset is None:
        for name in sorted(PRESETS):
            print(name)
        return 0
    cfg = get_config(args.preset, dict(kv.split("=", 1) for kv in args.set))
    print(json.dumps(to_dict(cfg), indent=2, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
