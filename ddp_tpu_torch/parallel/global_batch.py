"""What a data-parallel train step computes over the global batch.

Under a process group each rank holds its rows of the global batch, but the
JAX package computes some things over the whole batch, which its mesh shards
(``ddp_tpu/nn/common.py``: BatchNorm statistics are "global (sync) when
batch is mesh-sharded"; ``sig_loss``; every random draw, one key sharded
with the batch). A port that only averaged gradients would train something
else. So inside ``global_batch()`` (``train/step.py: TrainStep`` enters it
under a process group):

  - ``all_reduce_sum`` sums a tensor over the ranks, differentiably: its
    backward all-reduces the gradient too. Every rank then computes the
    global quantity, and with the gradients averaged over the ranks the
    step takes the gradient of the global loss. BatchNorm's sums (Σx, Σx²,
    n), ``sig_loss``'s (Σg, Σg², n) and MaskedBatchNorm's go through it.
  - ``sum_over_ranks`` is the same without a gradient (accuracy counts).
  - ``global_draw`` draws for the global batch, from the generator every
    rank seeds alike, and keeps this rank's rows: world n draws n times the
    numbers, and each rank's generator state stays that of a 1-process run.
  - ``mean_over_ranks`` averages the gradients, in buckets of at
    most ``BUCKET`` elements (one collective each, not one per tensor).

A loss that is a mean over equal local shapes needs no reduction of its
own: the mean over the ranks of its averaged gradients is the gradient of
the global mean. ControlNet's ε-MSE is one (``torch.mean`` over the local
[B/n, C, h, w] latents); its GroupNorms are per sample, CLIP draws nothing,
and its three draws (the posterior sample, t, the noise) go through
``global_draw``, so its data-parallel step adds no collective.

A microbatched step (``train/step.py``, k chunks) runs each chunk inside
``global_batch()``: BatchNorm and ``sig_loss`` reduce over the global
chunk, the draws are the global chunk's. So the rows a rank holds in chunk
i must be its share of JAX's chunk i of the global batch, as
``parallel/mesh.py: shard_batch_microbatched`` deals them.

At world 1 (or outside the context) all but ``mean_over_ranks`` are the
identity, so a 1-process run computes exactly what it did without a group.
Collectives are ``all_reduce`` only: gloo has no other on CUDA tensors.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, List, Sequence, Tuple

import torch
import torch.distributed as dist

from .mesh import world

BUCKET = 1 << 25  # elements per gradient all-reduce (128 MiB of float32)

# per thread, as torch's grad mode: the step's forward runs in the thread
# that entered the context (a backward's all-reduce needs no flag)
_STATE = threading.local()


@contextlib.contextmanager
def global_batch():
    """Reductions and draws below act over the global batch inside."""
    prev = getattr(_STATE, "active", False)
    _STATE.active = True
    try:
        yield
    finally:
        _STATE.active = prev


def active_world() -> Tuple[int, int]:
    """(rank, world size) inside ``global_batch()``; (0, 1) outside it."""
    return world() if getattr(_STATE, "active", False) else (0, 1)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = x.contiguous().clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Σ over the ranks of ``x``, with the gradient summed over the ranks in
    backward; ``x`` itself at world 1."""
    return x if active_world()[1] == 1 else _AllReduceSum.apply(x)


def sum_over_ranks(x: torch.Tensor) -> torch.Tensor:
    """Σ over the ranks of ``x`` (no gradient); ``x`` itself at world 1."""
    if active_world()[1] == 1:
        return x
    y = x.detach().contiguous().clone()
    dist.all_reduce(y)
    return y


def global_draw(draw: Callable[[Tuple[int, ...]], torch.Tensor],
                shape: Sequence[int]) -> torch.Tensor:
    """``draw(shape)`` for this rank's rows of the global batch: at world n,
    ``draw`` of n times the leading dimension, and rows ``rank·s[0]`` on.
    ``shape``'s leading dimension must run over the batch, batch-major (a
    [B·h·w, C] noise or [B·windows, ...] mask is)."""
    rank, n = active_world()
    shape = tuple(int(s) for s in shape)
    if n == 1:
        return draw(shape)
    rows = shape[0]
    return draw((rows * n,) + shape[1:])[rank * rows:(rank + 1) * rows]


def mean_over_ranks(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """The mean over the process group of each of ``tensors`` (one dtype):
    each bucket of at most ``BUCKET`` elements is concatenated into one
    buffer, all-reduced and divided by the world size; the results are
    views into those buffers."""
    n = dist.get_world_size()
    out: List[torch.Tensor] = []
    bucket: List[torch.Tensor] = []
    size = 0
    for i, t in enumerate(tensors):
        bucket.append(t)
        size += t.numel()
        if size >= BUCKET or i == len(tensors) - 1:
            flat = torch.cat([b.reshape(-1) for b in bucket])
            dist.all_reduce(flat)
            flat.div_(n)
            out += [f.view_as(b) for f, b in zip(flat.split([b.numel() for b in bucket]),
                                                  bucket)]
            bucket, size = [], 0
    return out
