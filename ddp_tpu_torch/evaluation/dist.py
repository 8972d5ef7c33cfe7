"""Collectives for evaluation (port of ``ddp_tpu/evaluation/dist.py``).

The reference collects results on rank 0 (``collect_results_gpu/cpu``,
mmseg/apis/test.py:140-233) and broadcasts its seed from rank 0
(mmseg/apis/train.py:21-49); the JAX package does both with
``multihost_utils``. Here they are ``torch.distributed`` collectives on the
default group: ``all_reduce`` and ``broadcast`` only, on CUDA tensors under
``nccl`` and on the CPU under ``gloo``. Without a group, or at world 1, both
are the identity.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.mesh import world


def _device() -> torch.device:
    return (torch.device("cuda", torch.cuda.current_device())
            if dist.get_backend() == "nccl" else torch.device("cpu"))


def allgather_metrics(local: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Per-process metric arrays (e.g. per-class intersect/union
    histograms) summed over the processes, each in its own dtype."""
    if world()[1] == 1:
        return {k: np.asarray(v) for k, v in local.items()}
    out = {}
    for k, v in local.items():
        a = np.asarray(v)
        t = torch.from_numpy(np.ascontiguousarray(a)).to(_device())
        dist.all_reduce(t)
        out[k] = t.cpu().numpy().astype(a.dtype)
    return out


def broadcast_from_host0(tree: Any) -> Any:
    """Rank 0's value of ``tree`` (nested dicts, lists and tuples of tensors,
    numpy arrays and numbers) on every rank, each leaf of its own type."""
    if world()[1] == 1:
        return tree
    if isinstance(tree, dict):
        return {k: broadcast_from_host0(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(broadcast_from_host0(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.detach().to(_device(), copy=True).contiguous()
        dist.broadcast(t, src=0)
        return t.to(tree.device)
    a = np.asarray(tree)
    t = torch.from_numpy(np.ascontiguousarray(a)).to(_device())
    dist.broadcast(t, src=0)
    b = t.cpu().numpy().astype(a.dtype)
    return b if isinstance(tree, np.ndarray) else type(tree)(b.item())
