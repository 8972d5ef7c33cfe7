"""A resume from a chunk-end checkpoint (``steps_per_dispatch``) on the CPU,
moved from ``test_torch_port_chunked.py`` (its helpers are imported from
there) so that a parallel run spreads the files: 7 steps straight against a
run resumed from the step-3 checkpoint alone.
"""
import os
import shutil

from ddp_tpu_torch.data import make_train_iter
from ddp_tpu_torch.train import checkpoint as tckpt
from ddp_tpu_torch.train.loop import train
from test_torch_port_chunked import _assert_same_state, _cfg, _log, _skip


def test_resume_from_chunk_end_checkpoint_is_exact(tmp_path):
    """7 steps straight (checkpoints at the chunk ends 3, 6 and 7) against a
    run resumed from the step-3 checkpoint alone."""
    cfg = _cfg(tmp_path / "full", 3, ckpt_interval=2)
    full = train(cfg, make_train_iter(cfg), device="cpu")
    assert tckpt._steps(os.path.join(cfg.runtime.workdir, "ckpts")) == [3, 6, 7]
    resumed_dir = tmp_path / "resumed"
    os.makedirs(resumed_dir / "ckpts")
    shutil.copy(os.path.join(cfg.runtime.workdir, "ckpts", "step_3.pt"), resumed_dir / "ckpts")
    rcfg = _cfg(resumed_dir, 3, ckpt_interval=2)
    resumed = train(rcfg, _skip(make_train_iter(rcfg), 3), resume=True, device="cpu")
    _assert_same_state(full, resumed)
    assert [r["step"] for r in _log(resumed_dir)] == [4]
