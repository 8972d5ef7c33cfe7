"""The port's end check (``ddp_tpu_torch/evaluation/convergence.py``) against
the JAX package's harness (``tools/run_convergence.py``), on the CPU: the
preset, the held-out batches, the mIoU, and ``eval_seg``'s output."""
import dataclasses
import importlib.util
import os

import numpy as np
import pytest

from ddp_tpu.config import get_config as j_get_config
from ddp_tpu.data.pipelines import normalize as j_normalize
from ddp_tpu.data.seg_datasets import SyntheticSegDataset as JSyntheticSegDataset
from ddp_tpu.evaluation.metrics import SegMetricAccumulator as JSegMetricAccumulator
from ddp_tpu_torch.config import build_model, get_config
from ddp_tpu_torch.evaluation import convergence as C

_HARNESS = os.path.join(os.path.dirname(__file__), "..", "tools", "run_convergence.py")


@pytest.fixture(scope="module")
def harness():
    spec = importlib.util.spec_from_file_location("run_convergence", _HARNESS)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_protocol_constants_match_harness(harness):
    assert (C.N_EVAL, C.EVAL_BATCH, C.SEEDS, C.HELDOUT_BASE) == (
        harness.N_EVAL, harness.EVAL_BATCH, harness.SEEDS, harness.HELDOUT_BASE)


def test_preset_matches_jax():
    """Every field the port has equals the JAX preset's, but the workdir."""
    port, ref = get_config("converge_seg_window"), j_get_config("converge_seg_window")
    for part in ("model", "data", "optim", "runtime"):
        for f in dataclasses.fields(getattr(port, part)):
            if f.name == "workdir":
                continue
            a, b = getattr(getattr(port, part), f.name), getattr(getattr(ref, part), f.name)
            if dataclasses.is_dataclass(a):
                a, b = dataclasses.asdict(a), dataclasses.asdict(b)
            assert a == b, (part, f.name)
    assert port.runtime.workdir != ref.runtime.workdir  # never overwrites the JAX result


def test_heldout_batches_match_harness(harness):
    """The harness's batches, built as its eval_seg builds them."""
    ds = JSyntheticSegDataset(7, (64, 64))
    got = C.heldout_batches(7)
    assert len(got) == harness.N_EVAL // harness.EVAL_BATCH
    for (img, label), s0 in zip(got, range(0, harness.N_EVAL, harness.EVAL_BATCH)):
        samples = [j_normalize(ds.load(harness.HELDOUT_BASE + i), (123.675, 116.28, 103.53),
                               (58.395, 57.12, 57.375))
                   for i in range(s0, s0 + harness.EVAL_BATCH)]
        want_img = np.stack([s["image"] for s in samples])
        want_label = np.stack([s["label"] for s in samples])
        assert img.dtype == want_img.dtype and np.array_equal(img, want_img)
        assert label.dtype == want_label.dtype and np.array_equal(label, want_label)


@pytest.mark.parametrize("seed", [0, 1])
def test_miou_matches_jax_metrics(seed):
    """Fixed predictions, with ignored pixels and an absent class."""
    rng = np.random.default_rng(seed)
    labels = [rng.integers(0, 6, (64, 64)) for _ in range(8)]
    labels[0][:5] = 255
    preds = [np.where(rng.random((64, 64)) < 0.8, lab % 7, rng.integers(0, 7, (64, 64)))
             for lab in labels]
    acc = JSegMetricAccumulator(7)
    for p, lab in zip(preds, labels):
        acc.update(p, lab)
    assert C.seg_miou(preds, labels, 7) == acc.compute()["mIoU"]


def test_eval_seg_runs_and_is_deterministic():
    """A random-weight converge_seg_window model, one horizon and one seed:
    the harness's keys, an mIoU in [0, 1], and the same value twice (the
    rollout noise comes from a generator seeded per (seed, batch start))."""
    mc = get_config("converge_seg_window").model
    model = build_model(mc, device="cpu", seed=0)
    a = C.eval_seg(model, mc, timesteps_list=(1,), seeds=(0,))
    b = C.eval_seg(model, mc, timesteps_list=(1,), seeds=(0,))
    assert set(a) == {"mIoU@1step", "mIoU@1step_std"} and a == b
    assert 0.0 <= a["mIoU@1step"] <= 1.0 and a["mIoU@1step_std"] == 0.0
