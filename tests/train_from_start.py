"""Train an end-check preset from a chosen start and score it as
``python -m ddp_tpu_torch.evaluation.convergence`` does from the preset's
own: the spread of an end check over its random start.

    python tests/train_from_start.py converge_bev --seed 1
    python tests/train_from_start.py converge_bev --init OUT.pt
    python tests/train_from_start.py converge_bev --truncated --seed 1

``--seed`` replaces the preset's seed (the initial weights, the data order
and every draw). ``--init`` replaces the initial weights with a state_dict
file (``torch.save``); ``tests/make_jax_init.py`` writes the JAX package's
as one. ``--truncated`` redraws the port's N(0, 1/fan_in) matrices and
kernels as flax's ``lecun_normal`` draws them: truncated at two standard
deviations and rescaled to the same variance; and the Swin
relative-position tables as flax's truncated N(0, 0.02^2). The result goes
to ``work_dirs/torch_<preset>_<start>/result.json``. Runs on the card unless
given ``--device cpu``.
"""
import argparse
import dataclasses
import json
import os
import shutil
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ddp_tpu_torch.config import build_model, get_config  # noqa: E402
from ddp_tpu_torch.data import make_train_iter  # noqa: E402
from ddp_tpu_torch.evaluation import convergence  # noqa: E402

# init_params_'s layers with an init of their own (not N(0, 1/fan_in)), and
# flax's nn.Embed, which draws a plain normal
OWN_INIT = ("sampling_offsets", "attention_weights", "value_proj", "output_proj",
            "row_embed", "col_embed", "embedding_table")
TRUNC = 0.87962566103423978  # the std of N(0, 1) truncated to [-2, 2]


def truncated_init(model: torch.nn.Module, seed: int) -> dict:
    """``model``'s state_dict with its N(0, 1/fan_in) weights and Swin tables
    redrawn truncated, as flax draws them, from ``seed`` on the CPU."""
    gen = torch.Generator().manual_seed(seed)
    sd = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    for name, p in model.named_parameters():
        if name.endswith("relative_position_bias_table"):
            torch.nn.init.trunc_normal_(sd[name], std=0.02, a=-0.04, b=0.04, generator=gen)
        elif p.ndim >= 2 and not any(k in name.split(".") for k in OWN_INIT):
            std = p[0].numel() ** -0.5 / TRUNC
            torch.nn.init.trunc_normal_(sd[name], std=std, a=-2 * std, b=2 * std,
                                        generator=gen)
    return sd


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("preset")
    ap.add_argument("--seed", type=int, help="train with this seed, not the preset's")
    ap.add_argument("--init", help="a state_dict file (torch.save) to start from")
    ap.add_argument("--truncated", action="store_true",
                    help="redraw the initial weights truncated, as flax draws them")
    ap.add_argument("--iters", type=int, help="cut the run to this many steps")
    ap.add_argument("--device", help="default: cuda")
    args = ap.parse_args(argv)
    if args.init and args.truncated:
        ap.error("--init and --truncated both set the initial weights")
    cfg = get_config(args.preset)
    if args.preset in convergence.FINE_TUNE_FROM:
        ap.error(f"{args.preset} starts from {convergence.FINE_TUNE_FROM[args.preset]}'s "
                 "checkpoint")
    rt = cfg.runtime
    seed = rt.seed if args.seed is None else args.seed
    start = (f"init_{os.path.splitext(os.path.basename(args.init))[0]}" if args.init
             else f"{'trunc_' if args.truncated else ''}seed{seed}")
    rt = dataclasses.replace(rt, seed=seed, workdir=f"work_dirs/torch_{args.preset}_{start}")
    if args.iters:
        rt = dataclasses.replace(rt, total_iters=args.iters)
        cfg = dataclasses.replace(cfg, optim=dataclasses.replace(cfg.optim,
                                                                 total_steps=args.iters))
    cfg = dataclasses.replace(cfg, runtime=rt)
    init_params = None
    if args.init:
        init_params = torch.load(args.init, map_location="cpu", weights_only=True)
    elif args.truncated:
        init_params = truncated_init(build_model(cfg.model, device="cpu", seed=seed), seed)
    # a fresh run re-saving a step number would otherwise keep the old weights
    shutil.rmtree(os.path.join(rt.workdir, "ckpts"), ignore_errors=True)
    os.makedirs(rt.workdir, exist_ok=True)
    print(f"=== {args.preset} from {start} ===", flush=True)
    state = convergence.train(cfg, make_train_iter(cfg), device=args.device,
                              init_params=init_params)
    result = convergence.SCORERS[cfg.model.task](state.model, cfg.model)
    result.update(preset=args.preset, total_iters=rt.total_iters, seed=seed, start=start)
    path = os.path.join(rt.workdir, "result.json")
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    print(f"wrote {path}", flush=True)
    return result


if __name__ == "__main__":
    main()
