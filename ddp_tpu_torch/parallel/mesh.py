"""Process group and device mesh (port of ``ddp_tpu/parallel/mesh.py``).

The JAX package shards the global batch over a ``[data, model]`` mesh of the
devices one program sees, and XLA inserts the gradient psum. Here one
process drives one GPU, as ``torchrun`` launches it, and the processes form
one ``torch.distributed`` group: each feeds its rank's rows of every global
batch (``shard_batch``), and the train step all-reduces the gradients
(``train/step.py``). The port's counterpart of JAX's single-process
multi-device mesh is ``torchrun --nproc_per_node=N``; a process never spans
GPUs. The model axis exists for the mesh's shape only: JAX's loop builds it
at 1 and nothing shards a tensor over it, and the port's loop takes no mesh:
it shards the batch over the ranks.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


def world() -> Tuple[int, int]:
    """(rank, world size) of the default process group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def init_distributed(device=None) -> torch.device:
    """Join the process group that torchrun's environment describes
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``) and return this process's device: ``cuda:LOCAL_RANK``
    with the ``nccl`` backend (the default), the CPU with ``gloo`` when
    ``device`` is "cpu". A group that already exists is kept."""
    dev = resolve_device(device)
    env = os.environ
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT") if k not in env]
    if missing and not dist.is_initialized():
        raise RuntimeError(f"init_distributed needs torchrun's environment; {missing} unset "
                           "(launch with torchrun, or set them for each process)")
    if dev.type == "cuda":
        dev = torch.device("cuda", int(env.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
            rank=int(env["RANK"]), world_size=int(env["WORLD_SIZE"]))
    return dev


def make_mesh(n_data: Optional[int] = None, n_model: int = 1):
    """A ``DeviceMesh`` of shape [n_data, n_model] over the process group's
    ranks, axes (``DATA_AXIS``, ``MODEL_AXIS``); ``n_data`` defaults to the
    world size over ``n_model``, the reference's pure data-parallel layout."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call init_distributed first")
    n = dist.get_world_size()
    if n_data is None:
        n_data = n // n_model
    if n_data * n_model != n:
        raise AssertionError(f"mesh {n_data}x{n_model} != {n} devices")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(n).reshape(n_data, n_model),
                      mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def local_batch_size(global_batch: int) -> int:
    """Rows this process feeds per step (the global batch split evenly)."""
    n = world()[1]
    if global_batch % n:
        raise AssertionError(f"global batch {global_batch} not divisible by {n} processes")
    return global_batch // n


def _to(value, device, dim: int, want: int, path: str):
    if isinstance(value, dict):
        return {k: _to(v, device, dim, want, f"{path}/{k}") for k, v in value.items()}
    x = torch.as_tensor(value)
    if x.shape[dim] != want:
        raise ValueError(f"batch {path!r} has {x.shape[dim]} rows on axis {dim}; this "
                         f"process feeds local_batch_size = {want}")
    return x if device is None else x.to(device)


def shard_batch(batch: Dict[str, Any], global_batch: int, device=None) -> Dict[str, Any]:
    """This process's rows of a global batch (the local batch its iterator
    yields, [local, ...] per value, dicts walked) onto ``device``, each
    value's leading dimension checked to be ``local_batch_size``."""
    want = local_batch_size(global_batch)
    return {k: _to(v, device, 0, want, k) for k, v in batch.items()}


def shard_batch_chunk(batches: Dict[str, Any], global_batch: int, device=None
                      ) -> Dict[str, Any]:
    """``shard_batch`` of a stacked chunk of batches ([T, local, ...])."""
    want = local_batch_size(global_batch)
    return {k: _to(v, device, 1, want, k) for k, v in batches.items()}
