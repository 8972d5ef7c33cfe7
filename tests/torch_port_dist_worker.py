"""One rank of the port's data-parallel run on the CPU (gloo), and the
1-process run it is held to (``tests/test_torch_port_distributed.py``).

    python tests/torch_port_dist_worker.py RANK WORLD PORT OUT_JSON WORKDIR

(WORLD 1: the 1-process run, no group.)

Each rank joins a gloo group on 127.0.0.1:PORT through
``parallel/mesh.py: init_distributed`` (torchrun's variables set here) and,
for each task of ``TASKS``, runs ``train/loop.py: train`` for two steps in
float64 on its rows of two fixed global batches (of 4 for ``smoke``, 2 for the others),
recording every step's logs
(``recording``), in a workdir of its own. It writes the logs, the final
state_dict, the files the loop wrote, and the checks of the mesh, the
metric collectives and the rank-sliced iterator to OUT_JSON; the states and
``collectives_case``'s tensors go to OUT_JSON.pt. At WORLD 1 the process
runs the same tasks on the whole global batches, without a group.

The global batches come from the tasks' own iterators at world 1, and the
second half of each (rank 1's rows) is rescaled: its images ×2.5 + 1, a
depth map ×1.7, a fusion sweep's voxel features ×3. So the two ranks' rows
differ in their statistics, and a per-rank BatchNorm, ``sig_loss`` or
accuracy would not give the 1-process run's numbers.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TASKS = ("seg", "depth", "bev", "bev_fusion")
# the global batch by task: one row a rank, but smoke's at 32^2, whose FPN's
# last level is 1 x 1, where GroupNorm needs two rows a rank
GLOBAL_BATCH = {"seg": 4, "depth": 2, "bev": 2, "bev_fusion": 2}
STEPS = 2


def task_config(task: str, workdir: str):
    """The task's tiny preset at its global batch, two steps of one per
    dispatch (logged and checkpointed at step 2), drop path on."""
    from ddp_tpu_torch.config import get_config

    rt = {"runtime.total_iters": STEPS, "runtime.steps_per_dispatch": 1,
          "runtime.log_interval": 1, "runtime.ckpt_interval": STEPS,
          "runtime.eval_interval": 1000, "runtime.tensorboard": False,
          "runtime.workdir": os.path.join(workdir, task),
          "runtime.mixed_precision": False, "data.batch_size": GLOBAL_BATCH[task]}
    if task == "seg":
        return get_config("smoke", {**rt, "model.drop_path_rate": 0.2})
    if task == "depth":  # the tiny depther of tests/test_torch_port_depth.py
        cfg = get_config("converge_depth", {**rt, "model.drop_path_rate": 0.2})
        return dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, decoder_layers=2, decoder_heads=4, decoder_ffn_dim=128))
    return get_config("smoke_bev" if task == "bev" else "smoke_fusion", rt)


def global_batches(cfg):
    """Two global batches of the task's iterator at world 1, rank 1's half
    rescaled (module docstring)."""
    from ddp_tpu_torch.data import make_train_iter

    it = make_train_iter(cfg, world=1)
    out = []
    for _ in range(STEPS):
        b = next(it)
        half = slice(cfg.data.batch_size // 2, None)
        b["image"][half] = b["image"][half] * 2.5 + 1.0
        if cfg.model.task == "depth":
            b["label"][half] = b["label"][half] * 1.7
        if cfg.model.task == "bev_fusion":
            b["voxel_feats"][half] = b["voxel_feats"][half] * 3.0
        out.append(b)
    return out


def rows(value, rank: int, world: int):
    if isinstance(value, dict):
        return {k: rows(v, rank, world) for k, v in value.items()}
    n = value.shape[0] // world
    return np.ascontiguousarray(value[rank * n:(rank + 1) * n])


def float64(value):
    """A batch (value) with its float32 arrays in float64."""
    if isinstance(value, dict):
        return {k: float64(v) for k, v in value.items()}
    return value.astype(np.float64) if value.dtype == np.float32 else value


def recording(make, logs: list):
    """``make_chunked_train_step`` whose steps append their logs to ``logs``."""
    def build(*args, **kwargs):
        chunk = make(*args, **kwargs)
        call = chunk.__call__

        class Recorded:
            def __getattr__(self, name):
                return getattr(chunk, name)

            def __call__(self, state, batches):
                out = call(state, batches)
                logs.append({k: v.tolist() for k, v in out.items()})
                return out

        return Recorded()

    return build


def run_task(task: str, workdir: str, rank: int = 0, world: int = 1):
    """``train`` on this rank's rows of the task's global batches, in
    float64 (the model built under that default dtype, the batches cast):
    (the logs of each dispatch, {"init", "final": state_dicts, "grads": the
    first step's (averaged) gradients by parameter name})."""
    from ddp_tpu_torch.train import loop
    from ddp_tpu_torch.train.step import TrainStep

    cfg = task_config(task, workdir)
    batches = [float64(rows(b, rank, world)) for b in global_batches(cfg)]
    logs: list = []
    out: dict = {}
    make, dtype, step_grads = loop.make_chunked_train_step, torch.get_default_dtype(), \
        TrainStep.grads

    def first_grads(self, state, batch):
        if not out:
            out["init"] = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
        grads, step_logs = step_grads(self, state, batch)
        if "grads" not in out:
            out["grads"] = {n: g.clone() for (n, _), g in
                            zip(state.model.named_parameters(), grads)}
        return grads, step_logs

    loop.make_chunked_train_step = recording(make, logs)
    TrainStep.grads = first_grads
    torch.set_default_dtype(torch.float64)
    try:
        state = loop.train(cfg, iter(batches), device="cpu")
    finally:
        loop.make_chunked_train_step, TrainStep.grads = make, step_grads
        torch.set_default_dtype(dtype)
    out["final"] = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    return logs, out


def collective_inputs():
    """The global batch of the BatchNorm and ``sig_loss`` checks: NHWC
    activations x [4, 6, 5, 8] and a loss weight w, the BN's affine
    parameters and running statistics, and a depth prediction and map
    [4, 8, 10] (a fifth of it invalid); rank 1's rows rescaled."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(4, 6, 5, 8)).astype(np.float32)
    x[2:] = x[2:] * 3.0 + 2.0
    gt = rng.uniform(0.5, 8.0, (4, 8, 10)).astype(np.float32)
    gt[rng.uniform(size=gt.shape) < 0.2] = 0.0
    gt[2:] *= 1.7
    return {"x": x, "w": rng.normal(size=x.shape).astype(np.float32),
            "scale": rng.uniform(0.5, 1.5, 8).astype(np.float32),
            "bias": rng.normal(size=8).astype(np.float32),
            "mean": rng.normal(size=8).astype(np.float32),
            "var": rng.uniform(0.5, 2.0, 8).astype(np.float32),
            "pred": rng.uniform(0.5, 5.0, (4, 8, 10)).astype(np.float32), "gt": gt}


def collectives_case(rank: int = 0, world: int = 1):
    """On this rank's rows of ``collective_inputs``, inside
    ``global_batch()``, in float32: ``BatchNorm2d``'s training output, its
    input gradient of Σ y·w (the sum over every rank's rows) and its running
    statistics after; ``sig_loss`` and its gradient over the ranks' mean
    (what the train step's averaging takes)."""
    from ddp_tpu_torch.nn.common import BatchNorm2d
    from ddp_tpu_torch.nn.losses import sig_loss
    from ddp_tpu_torch.parallel.global_batch import global_batch

    g = collective_inputs()
    mine = {k: torch.from_numpy(rows(v, rank, world)) if v.ndim > 1 else torch.from_numpy(v)
            for k, v in g.items()}
    bn = BatchNorm2d(8).train()
    with torch.no_grad():
        for dst, src in ((bn.weight, "scale"), (bn.bias, "bias"), (bn.running_mean, "mean"),
                         (bn.running_var, "var")):
            dst.copy_(mine[src])
    x = mine["x"].requires_grad_()
    pred = mine["pred"].requires_grad_()
    with global_batch():
        y = bn(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        (y * mine["w"]).sum().backward()
        loss = sig_loss(pred, mine["gt"])
        loss.backward()
    return {"bn_y": y.detach(), "bn_dx": x.grad, "bn_mean": bn.running_mean.clone(),
            "bn_var": bn.running_var.clone(), "sig": loss.detach(),
            "sig_dpred": pred.grad / world}


def main(argv) -> int:
    rank, world, port, out, workdir = int(argv[1]), int(argv[2]), argv[3], argv[4], argv[5]
    torch.set_num_threads(1)
    if world == 1:  # the 1-process run on the whole global batches
        states, result = {}, {}
        for task in TASKS:
            logs, states[task] = run_task(task, os.path.join(workdir, "one"))
            result[task] = {"logs": logs}
        torch.save(states, out + ".pt")
        with open(out, "w") as f:
            json.dump(result, f)
        return 0
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
    import torch.distributed as dist

    from ddp_tpu_torch.data import make_train_iter
    from ddp_tpu_torch.evaluation.dist import allgather_metrics, broadcast_from_host0
    from ddp_tpu_torch.parallel.mesh import init_distributed, local_batch_size, make_mesh

    device = init_distributed("cpu")
    mesh = make_mesh()
    result = {
        "rank": rank, "device": str(device),
        "mesh": {"shape": list(mesh.shape), "names": list(mesh.mesh_dim_names)},
        "local_batch_size": local_batch_size(GLOBAL_BATCH["seg"]),
        # rank r contributes r + 1 everywhere: the sum is 1 + 2 at world 2
        "gathered_hist": allgather_metrics({"hist": np.full(4, rank + 1.0)})["hist"].tolist(),
        "broadcast": broadcast_from_host0({"seed": 100 + rank, "v": np.arange(3) + rank}),
    }
    result["broadcast"]["v"] = result["broadcast"]["v"].tolist()
    seg = task_config("seg", workdir)
    whole, mine = next(make_train_iter(seg, world=1)), next(make_train_iter(seg))
    result["iterator_rows"] = all(np.array_equal(rows(whole[k], rank, world), mine[k])
                                  for k in ("image", "label"))
    states = {"collectives": collectives_case(rank, world)}
    mine = os.path.join(workdir, f"rank{rank}")  # each rank's own, to see who writes
    for task in TASKS:
        logs, states[task] = run_task(task, mine, rank, world)
        wrote = sorted(os.path.relpath(os.path.join(d, f), mine)
                       for d, _, files in os.walk(os.path.join(mine, task)) for f in files)
        result[task] = {"logs": logs, "wrote": wrote}
    torch.save(states, out + ".pt")
    with open(out, "w") as f:
        json.dump(result, f)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
