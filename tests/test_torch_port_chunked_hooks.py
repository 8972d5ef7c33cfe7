"""The chunked loop's hooks (``steps_per_dispatch``) on the CPU, moved
from ``test_torch_port_chunked.py`` (its helpers are imported from there)
so that a parallel run spreads the files.

  - ``train()`` on ``tiny_seg`` with ``steps_per_dispatch=3`` for 7
    iterations logs, checkpoints and evaluates at the steps where
    ``ddp_tpu.train.loop.train`` does with that configuration (the JAX loop
    driven with a stand-in for its compiled chunk, so that it runs in
    seconds), and warns on the same misaligned intervals.

The resume from a chunk-end checkpoint is in
``test_torch_port_chunked_resume.py``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from ddp_tpu.config import get_config as j_get_config
from ddp_tpu.train import loop as jloop
from ddp_tpu.train import state as jstate
from ddp_tpu_torch.data import make_train_iter
from ddp_tpu_torch.train import checkpoint as tckpt
from ddp_tpu_torch.train.loop import train
from test_torch_port_chunked import TOTAL, _cfg, _log


def _port_hooks(tmp_path, monkeypatch, rt):
    saved, evals = [], []
    real_save = tckpt.CheckpointManager.save

    def save(self, step, state, meta=None):
        saved.append(step)
        return real_save(self, step, state, meta)

    monkeypatch.setattr(tckpt.CheckpointManager, "save", save)
    cfg = _cfg(tmp_path / "port", 3, **rt)
    train(cfg, make_train_iter(cfg), device="cpu",
          eval_fn=lambda state, step: evals.append(step) or {"mIoU": 0.5})
    return [r["step"] for r in _log(cfg.runtime.workdir)], saved, evals


def _jax_hooks(tmp_path, monkeypatch, rt):
    """ddp_tpu.train.loop.train with steps_per_dispatch 3 over 7 steps; its
    compiled chunk replaced by one that only advances the step."""
    saved, evals = [], []

    def chunked(model, tx, n, **kw):
        return lambda state, batches: (state.replace(step=state.step + n),
                                       {"loss": np.arange(n, dtype=np.float32)})

    monkeypatch.setattr(jstate, "make_chunked_train_step", chunked)
    monkeypatch.setattr(jloop.CheckpointManager, "save",
                        lambda self, step, state, meta=None: saved.append(step))
    cfg = j_get_config("converge_seg_window")
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, batch_size=2),
        runtime=dataclasses.replace(cfg.runtime, total_iters=TOTAL, steps_per_dispatch=3,
                                    workdir=str(tmp_path / "jax"), tensorboard=False,
                                    max_keep_ckpts=-1, **rt))
    batch = {"image": np.zeros((2, 64, 64, 3), np.float32),
             "label": np.zeros((2, 64, 64), np.int32)}
    jloop.train(cfg, iter([batch] * TOTAL), init_params={"params": {"w": jnp.zeros(3)}},
                eval_fn=lambda state, step: evals.append(step) or {"mIoU": 0.5})
    return [r["step"] for r in _log(cfg.runtime.workdir)], saved, evals


@pytest.mark.parametrize("rt", [
    dict(log_interval=2, ckpt_interval=2, eval_interval=4),  # both misaligned with 3
    dict(log_interval=5, ckpt_interval=3, eval_interval=6),  # aligned; a log inside a chunk
])
def test_hook_steps_match_jax_loop(tmp_path, monkeypatch, capsys, rt):
    jax_steps = _jax_hooks(tmp_path, monkeypatch, rt)
    jax_warn = [line for line in capsys.readouterr().out.splitlines() if "[warn]" in line]
    port_steps = _port_hooks(tmp_path, monkeypatch, rt)
    port_warn = [line for line in capsys.readouterr().out.splitlines() if "[warn]" in line]
    assert port_steps == jax_steps
    assert port_warn == jax_warn
    if rt["log_interval"] == 2:
        assert port_steps == ([1, 2, 4, 6], [3, 6, 7], [6, 7]) and len(port_warn) == 2
