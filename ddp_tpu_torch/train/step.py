"""Train state and train step (port of ``ddp_tpu/train/state.py:24-158``).

One step: the model's training forward on the batch (in ``microbatch``
equal chunks, gradients averaged), the backward pass, and the optimizer
chain (global-norm clip, AdamW, lr multipliers; ``train/optim.py``). BatchNorm
statistics update inside the forward, chunk after chunk, as the JAX package
threads them through its scan. Parameters, optimizer moments and BN
statistics are updated in place (PyTorch's idiom; JAX returns a new state).

The model is called with the batch values named by ``batch_keys``,
positionally and in order, as the JAX step calls its module
(``ddp_tpu/train/state.py:54``), plus ``t=, noise=, generator=``, and returns
``(loss, logs)``: ("image", "label") for a ``DDPSegmentor`` ('label' an int
map, 255 = ignore) or a ``DDPDepther`` ('label' float metric depth, <= 0 =
invalid), the rig tuple ``data/bev_datasets.py: BEV_BATCH_KEYS`` for a
``DDPBEVCamera``, ``FUSION_BATCH_KEYS`` for a ``DDPBEVFusion``, ("image",
"hint", "ids") for a ``ControlNetTrainer`` (its t an int [B]). A batch value
may be a dict of tensors (the fusion batch's ``rulebooks``, int32): chunking,
the bf16 cast, the CUDA graph's static inputs and the loop's stacking walk
it leaf by leaf, as JAX's tree maps do.

``mixed_precision=True`` is the JAX package's bf16 policy: the forward and
backward run on bf16 copies of the parameters and of every float32 batch
value (the image, a depth label or BEV masks, the rig's rotations,
translations and intrinsics, a fusion batch's voxel features, a ControlNet
batch's image and hint, the noise; token ids stay int;
``torch.func.functional_call``), so
the gradients land as float32 on the float32 master parameters; the
optimizer state and the loss stay float32. A given ``t`` stays float32 (JAX
draws it in float32). No ``torch.autocast``: it chooses per-op types of its
own.

The step's random draws (t, the noise, dropout and drop-path masks) come
from ``state.generator``; a batch may carry ``t`` [B] and ``noise``
([B, h, w, C] or [B·h·w, C]; the depther's [B, h, w, 1]) to fix them.

``make_chunked_train_step`` (``ddp_tpu/train/state.py:177-205``) runs n such
steps per call; on CUDA they are one CUDA-graph replay.

Under a ``torch.distributed`` process group (``parallel/mesh.py``) the batch
is this rank's rows of the global batch, as the JAX step's batch is sharded
over the mesh: the step computes BatchNorm statistics, ``sig_loss``,
accuracies and its draws over the global batch (``parallel/global_batch.py``)
and averages the float32 gradients over the ranks before the optimizer (so
the clip sees the global gradient) and the logs after, each in one bucketed
all-reduce. A graphed chunk captures the all-reduce.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.func import functional_call

from ..parallel.global_batch import global_batch, mean_over_ranks
from ..parallel.mesh import world
from .optim import AdamW


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: AdamW
    generator: torch.Generator
    step: int = 0


def _to_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16) if x.dtype == torch.float32 else x


def tree_map(fn: Callable[[torch.Tensor], Any], value):
    """``fn`` over the tensors of a batch value: a tensor, or a dict of batch
    values (the fusion batch's ``rulebooks``), as JAX maps over its leaves."""
    if isinstance(value, dict):
        return {k: tree_map(fn, v) for k, v in value.items()}
    return fn(value)


def _leaves(tree: Dict[str, Any], prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(path, tensor) of every tensor of a batch, nested dicts walked."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def _chunk(batch: Dict[str, Any], i: int, n: int, lead: str) -> Dict[str, Any]:
    """The i-th of n equal chunks along the batch axis of ``batch[lead]``;
    ``noise`` given as [B·h·w, C] rows is split by image."""
    b = batch[lead].shape[0]
    size = b // n
    out = {}
    for key, v in batch.items():
        if key == "noise" and v.shape[0] != b:
            v = v.reshape(b, -1, v.shape[-1])
            out[key] = v[i * size:(i + 1) * size].reshape(-1, v.shape[-1])
        else:
            out[key] = tree_map(lambda x: x[i * size:(i + 1) * size], v)
    return out


def param_grads(loss: torch.Tensor, params: List[torch.Tensor]) -> List[torch.Tensor]:
    """``loss``'s gradient for each of ``params``, 0 for a parameter the loss
    does not reach (one that runs under ``torch.no_grad``, as JAX's
    ``stop_gradient``, or feeds no output the loss reads): JAX's gradient for
    it, so that AdamW's decoupled decay still moves it."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]


class TrainStep:
    """``step(state, batch) -> logs`` (0-d tensors on the model's device, no
    host synchronisation). ``grads(state, batch)`` is the forward and
    backward alone, for timing."""

    def __init__(self, microbatch: int = 1, mixed_precision: bool = False,
                 batch_keys: Tuple[str, ...] = ("image", "label")):
        if microbatch < 1:
            raise ValueError(f"microbatch must be >= 1, got {microbatch}")
        self.microbatch = microbatch
        self.mixed_precision = mixed_precision
        self.batch_keys = tuple(batch_keys)

    def _loss(self, model: nn.Module, params: Dict[str, torch.Tensor],
              chunk: Dict[str, torch.Tensor], generator: torch.Generator):
        kwargs = {"t": chunk.get("t"), "noise": chunk.get("noise"), "generator": generator}
        args = tuple(chunk[k] for k in self.batch_keys)
        if not self.mixed_precision:
            return model(*args, **kwargs)
        low = {name: p.to(torch.bfloat16) for name, p in params.items()}
        if kwargs["noise"] is not None:
            kwargs["noise"] = _to_bf16(kwargs["noise"])
        return functional_call(model, low, tuple(tree_map(_to_bf16, a) for a in args), kwargs)

    def grads(self, state: TrainState, batch: Dict[str, torch.Tensor]
              ) -> Tuple[List[torch.Tensor], Dict[str, torch.Tensor]]:
        """The gradients and logs of one step. Under a process group the
        batch is this rank's rows of the global batch: the forward and
        backward run inside ``global_batch()`` (BatchNorm statistics,
        ``sig_loss`` and accuracies over the global batch, draws of its
        rows), the gradients are averaged over the ranks, and so are the
        logs."""
        b = batch[self.batch_keys[0]].shape[0]
        if b % self.microbatch:
            raise ValueError(f"batch {b} does not split into {self.microbatch} chunks")
        n_ranks = world()[1]
        if n_ranks > 1 and self.microbatch > 1:
            raise NotImplementedError(
                "microbatch > 1 under a process group of more than one rank: the JAX step "
                "chunks the global batch, so each chunk would take rows of every rank "
                "(ROADMAP.md queue 3)")
        model = state.model
        model.train()
        params = dict(model.named_parameters())
        leaves = list(params.values())
        total: Optional[List[torch.Tensor]] = None
        chunk_logs = []
        with global_batch():
            for i in range(self.microbatch):
                loss, logs = self._loss(model, params,
                                        _chunk(batch, i, self.microbatch, self.batch_keys[0]),
                                        state.generator)
                g = [x.float() for x in param_grads(loss.float(), leaves)]
                total = g if total is None else torch._foreach_add(total, g)
                chunk_logs.append({k: v.detach().float() for k, v in logs.items()})
        if self.microbatch > 1:
            torch._foreach_div_(total, float(self.microbatch))
        logs = {k: torch.stack([c[k] for c in chunk_logs]).mean() for k in chunk_logs[0]}
        if dist.is_initialized():
            total = mean_over_ranks(total)
            if n_ranks > 1:
                logs = dict(zip(logs, mean_over_ranks([torch.stack(list(logs.values()))])[0]))
        return total, logs

    def __call__(self, state: TrainState, batch: Dict[str, torch.Tensor],
                 sched: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """One step; ``sched`` as ``AdamW.step`` takes it."""
        grads, logs = self.grads(state, batch)
        logs["grad_norm"] = state.optimizer.step(grads, sched)
        state.step += 1
        return logs


def make_train_step(microbatch: int = 1, mixed_precision: bool = False,
                    batch_keys: Tuple[str, ...] = ("image", "label")) -> TrainStep:
    """The train step (``ddp_tpu.train.state.make_train_step``): batches are
    dicts of tensors on the model's device holding ``batch_keys``: 'image'
    [B, H, W, 3] float and 'label' [B, H, W] (int classes, 255 = ignore, for
    a segmentor; float metric depth, <= 0 = invalid, for a depther), or a BEV
    batch's cameras, rig and masks (``BEV_BATCH_KEYS``)."""
    return TrainStep(microbatch, mixed_precision, batch_keys)


class _Captured(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    inputs: Dict[str, Any]           # static [n, B, ...] batch buffers (nested dicts)
    sched: torch.Tensor              # static [n, 5] schedule rows
    logs: Dict[str, torch.Tensor]    # static [n] log outputs


class ChunkedTrainStep:
    """n train steps per call (``ddp_tpu.train.state.make_chunked_train_step``):
    ``step(state, batches) -> logs``, batches stacked [n, B, ...] (tensors on
    the host or the device), logs stacked [n]. ``state.step`` and
    ``optimizer.count`` advance by n.

    On CUDA the n steps are one ``torch.cuda.CUDAGraph``, captured once per n
    as JAX compiles one program per chunk length (the tail chunk gets its
    own): static input buffers that each call's batches are copied into, the
    [n, 5] rows of ``AdamW.schedule`` that the host writes before each
    replay, static log outputs, and ``state.generator`` registered with the
    graph so that every replay draws new t, noise, dropout and drop-path masks
    from where the last one left the generator. A capture needs warm-up steps
    on its stream, and as the step updates in place they must be real steps:
    the first call runs its n steps eagerly on the capture stream and
    captures after them; a later new n is captured, then replayed. A
    replay runs no Python, so the kernels' launch counters count the eager
    chunk and the capture, not the replays. A capture or replay that fails
    raises: there is no eager fallback. On the CPU (the tests) the same n steps run eagerly."""

    def __init__(self, chunk: int, microbatch: int = 1, mixed_precision: bool = False,
                 batch_keys: Tuple[str, ...] = ("image", "label")):
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        self.chunk = chunk
        self.step = TrainStep(microbatch, mixed_precision, batch_keys)
        self.capture_s: Dict[int, float] = {}  # host seconds of each capture
        self._graphs: Dict[int, _Captured] = {}
        self._stream: Optional[torch.cuda.Stream] = None

    def _steps(self, state: TrainState, batches: Dict[str, torch.Tensor],
               sched: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Step i on batches[:, i] with schedule row i; logs stacked."""
        logs = [self.step(state, {k: tree_map(lambda x: x[i], v) for k, v in batches.items()},
                          sched[i])
                for i in range(sched.shape[0])]
        return {k: torch.stack([step_logs[k] for step_logs in logs]) for k in logs[0]}

    def __call__(self, state: TrainState, batches: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
        opt = state.optimizer
        n = batches[self.step.batch_keys[0]].shape[0]
        if not 1 <= n <= self.chunk:
            raise ValueError(f"a chunk of {n} steps; this step takes 1 to {self.chunk}")
        sched = opt.schedule(n)
        device = opt.params[0].device
        if device.type != "cuda":
            logs = self._steps(state, batches, sched.to(device))
        elif n in self._graphs:
            logs = self._replay(state, self._graphs[n], batches, sched)
        elif self._stream is None:
            logs = self._warm_up_and_capture(state, batches, sched, device)
        else:
            logs = self._replay(state, self._capture(state, batches, sched), batches, sched)
        opt.count += n
        return logs

    def _warm_up_and_capture(self, state: TrainState, batches: Dict[str, torch.Tensor],
                             sched: torch.Tensor, device: torch.device
                             ) -> Dict[str, torch.Tensor]:
        """The first chunk: its steps, eagerly on the capture stream, then
        the capture of their graph for the chunks to come."""
        self._stream = torch.cuda.Stream(device)
        inputs = {k: tree_map(lambda x: x.to(device, copy=True), v)
                  for k, v in batches.items()}
        rows = sched.to(device)
        self._stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(self._stream):
            logs = self._steps(state, inputs, rows)
        torch.cuda.current_stream(device).wait_stream(self._stream)
        self._capture(state, inputs, rows)
        return logs

    def _capture(self, state: TrainState, batches: Dict[str, torch.Tensor],
                 sched: torch.Tensor) -> _Captured:
        """Capture the n steps on ``batches`` (kept as the static inputs when
        they are on the device) and schedule rows; runs no step."""
        device = state.optimizer.params[0].device
        inputs = {k: tree_map(lambda x: x if x.device == device else x.to(device), v)
                  for k, v in batches.items()}
        rows = sched if sched.device == device else sched.to(device)
        graph = torch.cuda.CUDAGraph()
        if not hasattr(graph, "register_generator_state"):
            raise RuntimeError("torch.cuda.CUDAGraph.register_generator_state is missing "
                               f"(PyTorch {torch.__version__}); without it every replay "
                               "would repeat the captured random draws")
        graph.register_generator_state(state.generator)
        step = state.step
        t0 = time.perf_counter()
        # under a process group the gradient all-reduce is captured too; the
        # NCCL watchdog thread queries events meanwhile, which a global-mode
        # capture would count as an error of the capture
        mode = "thread_local" if dist.is_initialized() else "global"
        with torch.cuda.graph(graph, stream=self._stream, capture_error_mode=mode):
            logs = self._steps(state, inputs, rows)
        torch.cuda.synchronize(device)
        self.capture_s[rows.shape[0]] = time.perf_counter() - t0
        state.step = step  # the capture ran no step
        cap = _Captured(graph, inputs, rows, logs)
        self._graphs[rows.shape[0]] = cap
        return cap

    def _replay(self, state: TrainState, cap: _Captured, batches: Dict[str, torch.Tensor],
                sched: torch.Tensor) -> Dict[str, torch.Tensor]:
        given, captured = dict(_leaves(batches)), dict(_leaves(cap.inputs))
        if set(given) != set(captured):
            raise ValueError(f"batch keys {sorted(given)} != captured {sorted(captured)}")
        for k, v in given.items():
            into = captured[k]
            if v.shape != into.shape or v.dtype != into.dtype:
                raise ValueError(f"batch {k!r} {v.dtype} {tuple(v.shape)} != captured "
                                 f"{into.dtype} {tuple(into.shape)}")
            if v.data_ptr() != into.data_ptr():
                into.copy_(v, non_blocking=True)
        cap.sched.copy_(sched, non_blocking=True)
        cap.graph.replay()
        state.step += cap.sched.shape[0]
        return {k: v.clone() for k, v in cap.logs.items()}


def make_chunked_train_step(chunk: int, microbatch: int = 1, mixed_precision: bool = False,
                            batch_keys: Tuple[str, ...] = ("image", "label")
                            ) -> ChunkedTrainStep:
    """``chunk`` train steps per dispatch (``ddp_tpu.train.state.
    make_chunked_train_step``); see ``ChunkedTrainStep``."""
    return ChunkedTrainStep(chunk, microbatch, mixed_precision, batch_keys)
