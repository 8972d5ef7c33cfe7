"""``train()``'s resume on the CPU, moved from ``test_torch_port_train.py``
so that a parallel run spreads the files: 6 steps of ``train()`` straight
equal 3 steps, a checkpoint and 3 resumed ones, bit for bit.
"""
import torch

from ddp_tpu_torch.data.seg_datasets import SyntheticSegDataset
from ddp_tpu_torch.train.loop import train
from test_torch_port_train_loop import _batches, _loop_cfg


def test_resume_is_bit_exact(tmp_path):
    """6 steps straight vs 3 steps, a checkpoint, and a resumed 3 more."""
    ds = SyntheticSegDataset(num_classes=7, size=(64, 64), length=64)
    full = train(_loop_cfg(tmp_path / "a", 6), _batches(ds, 2), device="cpu")
    train(_loop_cfg(tmp_path / "b", 3), _batches(ds, 2), device="cpu")
    resumed = train(_loop_cfg(tmp_path / "b", 6), _batches(ds, 2, start=3), resume=True,
                    device="cpu")
    assert resumed.step == full.step == 6
    a, b = full.model.state_dict(), resumed.model.state_dict()
    for name in a:
        assert torch.equal(a[name], b[name]), name
    assert torch.equal(full.generator.get_state(), resumed.generator.get_state())
