"""Microbatched inference (port of ``ddp_tpu/evaluation/batched.py``).

Splits a serving batch into fixed-size chunks so that one call never holds
more than ``microbatch`` images' working set, and every call sees one shape.
"""
from __future__ import annotations

import math
from typing import Callable

import torch


def microbatched_call(fn: Callable, batch_leading: torch.Tensor, *rest,
                      microbatch: int = 4):
    """Run ``fn(chunk, *rest_chunks)`` over <=``microbatch``-sized slices of
    the leading axis and concatenate the results. The last chunk is
    zero-padded up to ``microbatch`` and the pad rows are dropped."""
    n = batch_leading.shape[0]
    if n <= microbatch:
        return fn(batch_leading, *rest)
    n_chunks = math.ceil(n / microbatch)
    pad = n_chunks * microbatch - n

    def pad_to(x):
        if pad == 0:
            return x
        return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))], dim=0)

    args = [pad_to(batch_leading)] + [pad_to(r) for r in rest]
    outs = [fn(*[a[c * microbatch:(c + 1) * microbatch] for a in args])
            for c in range(n_chunks)]
    return torch.cat(outs, dim=0)[:n]
