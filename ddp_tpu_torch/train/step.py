"""Train state and train step (port of ``ddp_tpu/train/state.py:24-158``).

One step: the segmentor's training forward on the batch (in ``microbatch``
equal chunks, gradients averaged), the backward pass, and the optimizer
chain (global-norm clip, AdamW, lr multipliers; ``train/optim.py``). BatchNorm
statistics update inside the forward, chunk after chunk, as the JAX package
threads them through its scan. Parameters, optimizer moments and BN
statistics are updated in place (PyTorch's idiom; JAX returns a new state).

``mixed_precision=True`` is the JAX package's bf16 policy: the forward and
backward run on bf16 copies of the parameters and of the float inputs
(``torch.func.functional_call``), so the gradients land as float32 on the
float32 master parameters; the optimizer state and the loss stay float32.
No ``torch.autocast``: it chooses per-op types of its own.

The step's random draws (t, the noise, dropout and drop-path masks) come
from ``state.generator``; a batch may carry ``t`` [B] and ``noise``
([B, h, w, C] or [B·h·w, C]) to fix them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.func import functional_call

from .optim import AdamW


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: AdamW
    generator: torch.Generator
    step: int = 0


def _to_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16) if x.dtype == torch.float32 else x


def _chunk(batch: Dict[str, torch.Tensor], i: int, n: int) -> Dict[str, torch.Tensor]:
    """The i-th of n equal chunks along the batch axis; ``noise`` given as
    [B·h·w, C] rows is split by image."""
    b = batch["image"].shape[0]
    size = b // n
    out = {}
    for key, v in batch.items():
        if key == "noise" and v.shape[0] != b:
            v = v.reshape(b, -1, v.shape[-1])
            out[key] = v[i * size:(i + 1) * size].reshape(-1, v.shape[-1])
        else:
            out[key] = v[i * size:(i + 1) * size]
    return out


class TrainStep:
    """``step(state, batch) -> logs`` (0-d tensors on the model's device, no
    host synchronisation). ``grads(state, batch)`` is the forward and
    backward alone, for timing."""

    def __init__(self, microbatch: int = 1, mixed_precision: bool = False):
        if microbatch < 1:
            raise ValueError(f"microbatch must be >= 1, got {microbatch}")
        self.microbatch = microbatch
        self.mixed_precision = mixed_precision

    def _loss(self, model: nn.Module, params: Dict[str, torch.Tensor],
              chunk: Dict[str, torch.Tensor], generator: torch.Generator):
        kwargs = {"t": chunk.get("t"), "noise": chunk.get("noise"), "generator": generator}
        img, gt = chunk["image"], chunk["label"]
        if not self.mixed_precision:
            return model(img, gt, **kwargs)
        low = {name: p.to(torch.bfloat16) for name, p in params.items()}
        if kwargs["noise"] is not None:
            kwargs["noise"] = _to_bf16(kwargs["noise"])
        return functional_call(model, low, (_to_bf16(img), gt), kwargs)

    def grads(self, state: TrainState, batch: Dict[str, torch.Tensor]
              ) -> Tuple[List[torch.Tensor], Dict[str, torch.Tensor]]:
        model = state.model
        model.train()
        b = batch["image"].shape[0]
        if b % self.microbatch:
            raise ValueError(f"batch {b} does not split into {self.microbatch} chunks")
        params = dict(model.named_parameters())
        leaves = list(params.values())
        total: Optional[List[torch.Tensor]] = None
        chunk_logs = []
        for i in range(self.microbatch):
            loss, logs = self._loss(model, params, _chunk(batch, i, self.microbatch),
                                    state.generator)
            g = torch.autograd.grad(loss.float(), leaves, allow_unused=True)
            g = [torch.zeros_like(p) if x is None else x.float() for x, p in zip(g, leaves)]
            total = g if total is None else torch._foreach_add(total, g)
            chunk_logs.append({k: v.detach().float() for k, v in logs.items()})
        if self.microbatch > 1:
            torch._foreach_div_(total, float(self.microbatch))
        logs = {k: torch.stack([c[k] for c in chunk_logs]).mean() for k in chunk_logs[0]}
        return total, logs

    def __call__(self, state: TrainState, batch: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
        grads, logs = self.grads(state, batch)
        logs["grad_norm"] = state.optimizer.step(grads)
        state.step += 1
        return logs


def make_train_step(microbatch: int = 1, mixed_precision: bool = False) -> TrainStep:
    """The train step (``ddp_tpu.train.state.make_train_step``): batches are
    dicts of tensors on the model's device, 'image' [B, H, W, 3] float and
    'label' [B, H, W] int (255 = ignore)."""
    return TrainStep(microbatch, mixed_precision)
