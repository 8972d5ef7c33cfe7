"""The training loop (port of ``ddp_tpu/train/loop.py:28-239``).

A flat loop around one train step: the lr schedule and the clip live in the
optimizer, checkpoints on ``torch.save``, logging and evaluation on an
interval. Every random draw of the run comes from one ``torch.Generator`` on
the device, seeded from ``runtime.seed`` and saved in each checkpoint, so a
resumed run continues the uninterrupted one.

Not in this slice: ``runtime.steps_per_dispatch > 1`` and multi-device
training (both raise ``NotImplementedError``).
"""
from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from ..config import Config, build_model
from ..device import resolve_device
from .checkpoint import CheckpointManager
from .optim import make_optimizer
from .step import TrainState, make_train_step


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


def _to_device(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(device, non_blocking=True) for k, v in batch.items()}


def train(cfg: Config, data_iter: Iterator[Dict[str, np.ndarray]],
          eval_fn: Optional[Callable[[TrainState, int], Dict[str, float]]] = None,
          resume: bool = False, device=None) -> TrainState:
    """Run ``cfg.runtime.total_iters`` steps on ``device`` (default "cuda";
    raises without a GPU unless ``device="cpu"``). ``data_iter`` yields host
    batches {'image': [B, H, W, 3], 'label': [B, H, W]}; with ``resume`` it
    must yield the batches from the restored step on."""
    rt = cfg.runtime
    if rt.steps_per_dispatch > 1:
        raise NotImplementedError("steps_per_dispatch > 1 is not ported (ROADMAP)")
    dev = resolve_device(device)
    model = build_model(cfg.model, device=dev, seed=rt.seed)
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

    logger = MetricLogger(rt.workdir, rt.log_interval, tensorboard=rt.tensorboard)
    step_fn = make_train_step(mixed_precision=rt.mixed_precision)
    for step in range(start_step, rt.total_iters):
        logs = step_fn(state, _to_device(next(data_iter), dev))
        if (step + 1) % rt.log_interval == 0 or step == start_step:
            logger.log(step + 1, {k: v.item() for k, v in logs.items()},
                       optimizer.lr_schedule(step))
        if (step + 1) % rt.ckpt_interval == 0 or (step + 1) == rt.total_iters:
            ckpt.save(step + 1, state, meta=ckpt_meta)
        if eval_fn is not None and ((step + 1) % rt.eval_interval == 0
                                    or (step + 1) == rt.total_iters):
            metrics = eval_fn(state, step + 1)
            logger.log_eval(step + 1, metrics)
            if ckpt.save_best_if(step + 1, state, metrics, meta=ckpt_meta):
                print(f"[best @ {step + 1}] {rt.save_best}={metrics.get(rt.save_best)}",
                      flush=True)
            print(f"[eval @ {step + 1}] " + " ".join(
                f"{k}={v:.4f}" for k, v in metrics.items() if isinstance(v, float)), flush=True)
    return state
