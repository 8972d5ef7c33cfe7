"""Checkpoints on ``torch.save`` (port of ``ddp_tpu/train/checkpoint.py``).

Same API as the JAX package's orbax manager: periodic ``save`` with
``max_keep`` pruning, ``latest_step`` for auto-resume, and best-checkpoint
tracking by one metric (``save_best_if``, ``best_step``, ``restore_best``).
A checkpoint holds the model's state_dict (parameters and BN statistics),
the optimizer's moments and count, the step, the generator's state and a
JSON-able meta dict. Files are ``<workdir>/ckpts/step_<n>.pt`` and
``<workdir>/ckpts_best/step_<n>.pt``; a save writes a temporary file and
renames it, so a reader never sees half a checkpoint. ``publish`` strips a
checkpoint to the model state for the tools (``read_published``, which also
reads the JAX package's published ``.msgpack``).
"""
from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple

import torch

_NAME = re.compile(r"^step_(\d+)\.pt$")


def _jsonable(obj):
    if dataclasses.is_dataclass(obj):
        return _jsonable(dataclasses.asdict(obj))
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return str(obj)


def _steps(d: str) -> List[int]:
    if not os.path.isdir(d):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(d)) if m)


def _write(d: str, step: int, state, meta: Optional[dict]) -> None:
    payload = {
        "step": int(state.step),
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "generator": state.generator.get_state(),
        "meta": json.dumps(_jsonable(meta)),
    }
    path = os.path.join(d, f"step_{step}.pt")
    torch.save(payload, path + ".tmp")
    os.replace(path + ".tmp", path)


def _read(d: str, step: int, state):
    payload = torch.load(os.path.join(d, f"step_{step}.pt"), map_location="cpu",
                         weights_only=True)
    state.model.load_state_dict(payload["model"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.generator.set_state(payload["generator"])
    state.step = int(payload["step"])
    return state


def read_model(workdir: str, step: Optional[int] = None
               ) -> Tuple[int, Dict[str, torch.Tensor]]:
    """(step, model state_dict) of the checkpoint of ``step`` (the latest when
    None) under ``<workdir>/ckpts``, on the CPU; FileNotFoundError when there
    is none."""
    d = os.path.join(workdir, "ckpts")
    steps = _steps(d)
    if not steps or (step is not None and step not in steps):
        raise FileNotFoundError(f"no checkpoint{'' if step is None else f' of step {step}'} "
                                f"under {os.path.abspath(d)}")
    step = steps[-1] if step is None else step
    payload = torch.load(os.path.join(d, f"step_{step}.pt"), map_location="cpu",
                         weights_only=True)
    return step, payload["model"]


def publish(workdir: str, out_prefix: str, step: Optional[int] = None
            ) -> Tuple[int, str, int]:
    """The model state (parameters and BN statistics) of the checkpoint of
    ``step`` (the latest when None) under ``<workdir>/ckpts``, without the
    optimizer, generator and meta, ``torch.save``d to
    ``<out_prefix>-<the first 8 hex digits of its sha256>.pt``, as the
    reference names a published file: (step, path, bytes)."""
    step, sd = read_model(workdir, step)
    buf = io.BytesIO()
    torch.save(sd, buf)
    blob = buf.getvalue()
    path = f"{out_prefix}-{hashlib.sha256(blob).hexdigest()[:8]}.pt"
    with open(path, "wb") as f:
        f.write(blob)
    return step, path, len(blob)


def read_published(path: str) -> Dict[str, torch.Tensor]:
    """A published model state on the CPU: the port's ``.pt`` (``publish``),
    or the ``.msgpack`` that the JAX package's ``tools/publish_model.py``
    writes (flax's ``{"params", "batch_stats"}``), mapped to the port's names
    by ``params_from_flax``."""
    if path.endswith(".msgpack"):
        from ..convert import params_from_flax, read_flax_msgpack

        tree = read_flax_msgpack(path)
        return params_from_flax(tree["params"], tree.get("batch_stats"))
    return torch.load(path, map_location="cpu", weights_only=True)


class CheckpointManager:
    def __init__(self, workdir: str, max_keep: int = -1,
                 save_best: Optional[str] = None, best_mode: str = "max"):
        """``max_keep`` < 0 keeps every checkpoint. ``save_best``: the metric
        key tracked for the best checkpoint (one kept); ``best_mode``: 'max'
        (mIoU) or 'min' (abs_rel)."""
        if best_mode not in ("max", "min"):
            raise ValueError(f"best_mode must be 'max' or 'min', got {best_mode!r}")
        self.dir = os.path.abspath(os.path.join(workdir, "ckpts"))
        os.makedirs(self.dir, exist_ok=True)
        self.max_keep = max_keep
        self.best_key = save_best
        self.best_mode = best_mode
        self.best_dir = os.path.abspath(os.path.join(workdir, "ckpts_best"))
        self._best_record = os.path.join(self.best_dir, "best.json")

    def save(self, step: int, state, meta: Optional[dict] = None) -> None:
        _write(self.dir, step, state, meta)
        if self.max_keep is not None and self.max_keep >= 0:
            for old in _steps(self.dir)[:-self.max_keep or None]:
                os.remove(os.path.join(self.dir, f"step_{old}.pt"))

    def _best(self) -> Optional[Dict[str, Any]]:
        if not os.path.exists(self._best_record):
            return None
        with open(self._best_record) as f:
            return json.load(f)

    def save_best_if(self, step: int, state, metrics: dict,
                     meta: Optional[dict] = None) -> bool:
        """Keep ``state`` as the best checkpoint when its metric beats the
        recorded best. No-op (False) when save_best is unset or the metric
        is absent from ``metrics``."""
        if not self.best_key or self.best_key not in metrics:
            return False
        value = float(metrics[self.best_key])
        best = self._best()
        if best is not None and not (value > best["value"] if self.best_mode == "max"
                                     else value < best["value"]):
            return False
        os.makedirs(self.best_dir, exist_ok=True)
        _write(self.best_dir, step, state, meta)
        with open(self._best_record + ".tmp", "w") as f:
            json.dump({"step": step, "value": value}, f)
        os.replace(self._best_record + ".tmp", self._best_record)
        for old in _steps(self.best_dir):
            if old != step:
                os.remove(os.path.join(self.best_dir, f"step_{old}.pt"))
        return True

    def best_step(self) -> Optional[int]:
        best = self._best() if self.best_key else None
        return None if best is None else int(best["step"])

    def restore_best(self, state):
        step = self.best_step()
        if step is None:
            raise FileNotFoundError("no best checkpoint recorded")
        return _read(self.best_dir, step, state)

    def latest_step(self) -> Optional[int]:
        steps = _steps(self.dir)
        return steps[-1] if steps else None

    def restore(self, state, step: Optional[int] = None):
        """Load a checkpoint (the latest when ``step`` is None) into ``state``
        in place and return it."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.dir}")
        return _read(self.dir, step, state)
