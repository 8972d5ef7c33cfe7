"""The training loop (port of ``ddp_tpu/train/loop.py:28-239``).

A flat loop around one dispatch of ``runtime.steps_per_dispatch`` train
steps (``train/step.py: ChunkedTrainStep``; on the card one CUDA-graph
replay, as the reference's step or ``lax.scan`` of steps is one jitted
program): the lr schedule and the clip live in the optimizer, checkpoints on
``torch.save``, logging and evaluation on an interval. Checkpoint and eval
hooks fire at chunk-end resolution (a crossing inside a chunk lands on the
chunk's last step), every log-interval crossing inside a chunk is logged
from the chunk's stacked logs, and so is the first step of a run. Every
random draw of the run comes from one ``torch.Generator`` on the device,
seeded from ``runtime.seed`` and saved in each checkpoint, so a resumed run
continues the uninterrupted one.

Data-parallel (``torchrun``, ``parallel/mesh.py: init_distributed``): each
process runs this loop on ``cuda:LOCAL_RANK`` with its rank's rows of every
global batch (the iterators of ``data/__init__.py: make_train_iter`` slice
by rank), the train step averages the gradients over the ranks
(``train/step.py``), and every rank seeds the one generator alike and draws
its rows of the global batch's draws, so that a run of n processes computes
what one process computes on the global batch. A checksum of the parameters
is checked against rank 0's at the start; only rank 0 writes checkpoints,
``train_log.jsonl`` and events, and every rank restores on ``resume``.
"""
from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import Config, build_model
from ..device import resolve_device
from ..evaluation.dist import broadcast_from_host0
from ..parallel.mesh import shard_batch_chunk, world
from .checkpoint import CheckpointManager
from .optim import make_optimizer
from .step import TrainState, make_chunked_train_step


def batch_keys(task: str) -> Tuple[str, ...]:
    """The batch values a task's model takes, in order."""
    if task == "bev":
        from ..data.bev_datasets import BEV_BATCH_KEYS

        return BEV_BATCH_KEYS
    if task == "bev_fusion":
        from ..data.bev_datasets import FUSION_BATCH_KEYS

        return FUSION_BATCH_KEYS
    if task == "controlnet":
        return ("image", "hint", "ids")
    return ("image", "label")


def stack_batches(values: list):
    """One batch value of each of n host batches -> [n, ...] tensors, a dict
    of values stacked key by key (``ddp_tpu/train/loop.py:193-196``)."""
    if isinstance(values[0], dict):
        return {k: stack_batches([v[k] for v in values]) for k in values[0]}
    return torch.from_numpy(np.stack(values))


class MetricLogger:
    """Text + JSONL + TensorBoard-events logger."""

    def __init__(self, workdir: str, interval: int = 50, tensorboard: bool = True):
        os.makedirs(workdir, exist_ok=True)
        self.path = os.path.join(workdir, "train_log.jsonl")
        self.interval = interval
        self._t0 = time.time()
        self._last_step = 0
        self.tb = None
        if tensorboard:
            from .events import TBEventWriter

            self.tb = TBEventWriter(os.path.join(workdir, "tf_logs"))

    def log(self, step: int, logs: Dict[str, float], lr: float):
        now = time.time()
        steps_per_s = (step - self._last_step) / max(now - self._t0, 1e-9)
        self._t0, self._last_step = now, step
        rec = {"step": step, "lr": lr, "steps_per_s": round(steps_per_s, 3)}
        rec.update({k: float(v) for k, v in logs.items()})
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self.tb is not None:
            self.tb.add_scalars(step, {f"train/{k}": v for k, v in rec.items() if k != "step"})
        msg = " ".join(f"{k}={v:.4g}" for k, v in rec.items() if k != "step")
        print(f"[step {step}] {msg}", flush=True)

    def log_eval(self, step: int, metrics: Dict[str, float]):
        if self.tb is not None:
            self.tb.add_scalars(step, {f"val/{k}": float(v) for k, v in metrics.items()
                                       if isinstance(v, (int, float))})


# the tasks whose data-parallel step the 2-process test holds to one process
DISTRIBUTED_TASKS = ("seg", "depth", "bev", "bev_fusion", "controlnet")


def params_checksum(model: torch.nn.Module) -> torch.Tensor:
    """[Σ p, Σ p²] over the parameters and buffers, in float64."""
    sd = [v.detach().double() for v in model.state_dict().values() if v.is_floating_point()]
    return torch.stack([sum(v.sum() for v in sd), sum((v * v).sum() for v in sd)])


def check_distributed(cfg: Config) -> None:
    """Raise where a data-parallel run would not compute the 1-process run
    on the global batch: a task the 2-process test does not cover, or a
    global batch that does not divide over the ranks."""
    n = world()[1]
    if n == 1:
        return
    if cfg.model.task not in DISTRIBUTED_TASKS:
        raise NotImplementedError(f"task {cfg.model.task!r} under {n} processes: its "
                                  "data-parallel step is not held to one process by a test "
                                  "(ROADMAP.md queue 3)")
    if cfg.data.batch_size % n:
        raise ValueError(f"global batch {cfg.data.batch_size} must divide over {n} processes")


def train(cfg: Config, data_iter: Iterator[Dict[str, np.ndarray]],
          eval_fn: Optional[Callable[[TrainState, int], Dict[str, float]]] = None,
          resume: bool = False, device=None,
          init_params: Optional[Mapping[str, torch.Tensor]] = None) -> TrainState:
    """Run ``cfg.runtime.total_iters`` steps on ``device`` (default "cuda";
    raises without a GPU unless ``device="cpu"``), ``runtime.steps_per_dispatch``
    per dispatch. ``data_iter`` yields host batches of the task's keys:
    {'image': [B, H, W, 3], 'label': [B, H, W]} (int classes for a
    segmentor, float metric depth for a depther), ``BEV_BATCH_KEYS`` for
    ``task="bev"``, ``FUSION_BATCH_KEYS`` for ``task="bev_fusion"``,
    {'image', 'hint', 'ids'} for ``task="controlnet"`` (as
    ``ddp_tpu/train/loop.py:93-100`` picks them); with
    ``resume`` it must yield the batches from the restored step on.
    ``init_params``: a state_dict (parameters and BN statistics) loaded
    strictly into the fresh model before the optimizer is built, as the JAX
    loop's ``init_params`` replaces its init. Under a process group each
    rank's ``data_iter`` yields its rows of the global batches and the run
    is data-parallel (module docstring)."""
    rt = cfg.runtime
    check_distributed(cfg)
    rank = world()[0]
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None and dist.is_initialized():
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                      torch.cuda.current_device())))
    model = build_model(cfg.model, device=dev, seed=rt.seed, input_size=cfg.data.crop_size)
    if init_params is not None:
        model.load_state_dict(init_params)
    optimizer = make_optimizer(cfg.optim, model)
    generator = torch.Generator(device=dev).manual_seed(rt.seed)
    state = TrainState(model, optimizer, generator)

    ckpt = CheckpointManager(rt.workdir, rt.max_keep_ckpts, save_best=rt.save_best or None,
                             best_mode=rt.save_best_mode)
    ckpt_meta = {"config": cfg, "num_classes": cfg.model.num_classes}
    start_step = 0
    if resume and ckpt.latest_step() is not None:
        state = ckpt.restore(state)
        start_step = state.step
        print(f"resumed from step {start_step}", flush=True)
    if dist.is_initialized():
        mine = params_checksum(model)
        if not torch.equal(broadcast_from_host0(mine), mine):
            raise RuntimeError(f"rank {rank}: parameters differ from rank 0's at the start "
                               f"(checksum {mine.tolist()})")

    logger = (MetricLogger(rt.workdir, rt.log_interval, tensorboard=rt.tensorboard)
              if rank == 0 else None)

    def crossed(prev: int, now: int, interval: int) -> bool:
        return now // interval > prev // interval or now == rt.total_iters

    def eval_ckpt_hooks(prev: int, now: int) -> None:
        if rank == 0 and crossed(prev, now, rt.ckpt_interval):
            ckpt.save(now, state, meta=ckpt_meta)
        if eval_fn is not None and crossed(prev, now, rt.eval_interval):
            metrics = eval_fn(state, now)
            if rank:
                return
            logger.log_eval(now, metrics)
            if ckpt.save_best_if(now, state, metrics, meta=ckpt_meta):
                print(f"[best @ {now}] {rt.save_best}={metrics.get(rt.save_best)}", flush=True)
            print(f"[eval @ {now}] " + " ".join(
                f"{k}={v:.4f}" for k, v in metrics.items() if isinstance(v, float)), flush=True)

    spd = max(1, rt.steps_per_dispatch)
    for name, interval in (("ckpt_interval", rt.ckpt_interval),
                           ("eval_interval", rt.eval_interval)):
        if interval % spd:
            print(f"[warn] runtime.{name}={interval} is not a multiple of "
                  f"steps_per_dispatch={spd}; the hook fires at the chunk-end step after "
                  "each crossing", flush=True)
    keys = batch_keys(cfg.model.task)
    chunk_fn = make_chunked_train_step(spd, mixed_precision=rt.mixed_precision,
                                       batch_keys=keys)
    step = start_step
    while step < rt.total_iters:
        n = min(spd, rt.total_iters - step)
        chunk = [next(data_iter) for _ in range(n)]
        batches = shard_batch_chunk({k: stack_batches([c[k] for c in chunk]) for k in keys},
                                    cfg.data.batch_size)
        logs = chunk_fn(state, batches)
        prev, step = step, step + n
        crossings = [s for s in range(prev + 1, step + 1) if s % rt.log_interval == 0]
        if prev == start_step and prev + 1 not in crossings:
            crossings.insert(0, prev + 1)
        if crossings and logger is not None:
            logs_host = {k: v.cpu().numpy() for k, v in logs.items()}
            for at in crossings:
                logger.log(at, {k: float(v[at - prev - 1]) for k, v in logs_host.items()},
                           optimizer.lr_schedule(at - 1))
        eval_ckpt_hooks(prev, step)
    return state
