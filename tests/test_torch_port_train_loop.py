"""``train()`` on the CPU, moved from ``test_torch_port_train.py`` so that
a parallel run spreads the two files: 20 steps of ``tiny_seg`` on
SyntheticSegDataset lower the loss and checkpoint the last step; without a
GPU ``train()`` refuses to pick the CPU by itself. ``_batches`` and
``_loop_cfg`` serve ``test_torch_port_train_resume.py`` too.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from ddp_tpu_torch.config import get_config
from ddp_tpu_torch.data.seg_datasets import SyntheticSegDataset
from ddp_tpu_torch.train.checkpoint import CheckpointManager
from ddp_tpu_torch.train.loop import train
from test_torch_port_train import MEAN, STD
from torch_port_threads import _one_torch_thread  # noqa: F401


def _batches(ds, batch_size, start=0):
    i = start * batch_size
    while True:
        items = [ds.load(j % len(ds)) for j in range(i, i + batch_size)]
        i += batch_size
        yield {"image": np.stack([(it["image"] - MEAN) / STD for it in items]),
               "label": np.stack([it["label"] for it in items])}


def _loop_cfg(tmp_path, total, **rt):
    cfg = get_config("tiny_seg")
    return dataclasses.replace(
        cfg,
        optim=dataclasses.replace(cfg.optim, schedule="constant", lr=1e-3, grad_clip=1.0),
        runtime=dataclasses.replace(cfg.runtime, total_iters=total, log_interval=1,
                                    ckpt_interval=total, workdir=str(tmp_path),
                                    mixed_precision=False, tensorboard=False, **rt))


def test_train_loop_loss_falls(tmp_path):
    ds = SyntheticSegDataset(num_classes=7, size=(64, 64), length=64)
    cfg = _loop_cfg(tmp_path, 20)
    train(cfg, _batches(ds, 2), device="cpu")
    with open(tmp_path / "train_log.jsonl") as f:
        losses = [json.loads(line)["loss"] for line in f]
    assert len(losses) == 20 and np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), losses
    assert CheckpointManager(str(tmp_path)).latest_step() == 20


def test_train_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(_loop_cfg(tmp_path, 1), iter(()))
