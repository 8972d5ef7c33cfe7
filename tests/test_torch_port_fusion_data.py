"""The port's fusion and nuScenes data against the JAX package's, on the
CPU, and the fusion task through the train step, the loop and the CLIs.

  - ``SyntheticFusionDataset.load`` (with and without a lidar noise seed)
    and two ``fusion_batch_iterator`` batches (one process, and one rank of
    two): bitwise, the rulebooks included.
  - ``NuScenesBEVDataset`` and ``NuScenesFusionDataset`` on
    ``tests/data/nuscenes`` (JPEGs through Pillow, ``.bin`` sweeps) at
    ``nuscenes_fusion``'s image size and capacities, and a fusion batch of 2
    from it: bitwise.
  - ``make_train_iter`` for ``nuscenes_camera`` and ``smoke_fusion`` with
    ``data.dataset=nuscenes`` and for ``smoke_fusion`` and
    ``converge_bev_fusion`` on the synthetic rig: bitwise; an empty tree
    raises FileNotFoundError.
  - A fusion batch (rulebooks a dict) through the eager step, the chunked
    step and microbatches, f32 and bf16; the bf16 policy casts the voxel
    features and leaves the rulebooks as they are.
  - The end check's held-out fusion batches are JAX's; ``eval_bev_fusion``
    gives its keys; the test CLI refuses a fusion preset; the train CLI
    runs ``smoke_fusion --device cpu`` for 2 steps.
"""
import dataclasses
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from ddp_tpu import config as jconfig
from ddp_tpu.data import bev_datasets as jbd
from ddp_tpu.data import make_train_iter as jmake_train_iter
from ddp_tpu_torch.config import build_model, get_config
from ddp_tpu_torch.data import bev_datasets as tbd
from ddp_tpu_torch.data import make_train_iter
from ddp_tpu_torch.data.bev_datasets import FUSION_BATCH_KEYS
from ddp_tpu_torch.evaluation import convergence as C
from ddp_tpu_torch.tools import test as test_cli
from ddp_tpu_torch.tools import train as train_cli
from ddp_tpu_torch.train import step as tstep
from ddp_tpu_torch.train.loop import stack_batches
from ddp_tpu_torch.train.optim import make_optimizer
from ddp_tpu_torch.train.step import (TrainState, make_chunked_train_step, make_train_step,
                                      tree_map)
from torch_port_threads import _one_torch_thread  # noqa: F401


NUSC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "nuscenes")


def _same(got, want):
    """Bitwise equal (nested) dicts of arrays: values, dtypes and shapes."""
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], dict):
            _same(got[k], want[k])
            continue
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), k


def _synthetic_kw(preset="smoke_fusion"):
    mc = get_config(preset).model
    return dict(sparse_shape=mc.bev_sparse_shape, caps=mc.bev_voxel_caps,
                voxel_size=mc.bev_voxel_size, num_cams=mc.bev_num_cams,
                image_size=mc.bev_image_size, out_grid=mc.bev_out_grid,
                num_classes=mc.num_classes, scope=mc.bev_xbound[1], length=8)


@pytest.mark.parametrize("idx,noise_seed", [(0, None), (3, 2), (100_005, None)])
def test_synthetic_fusion_load_matches_jax(idx, noise_seed):
    kw = _synthetic_kw()
    got = tbd.SyntheticFusionDataset(**kw).load(idx, noise_seed=noise_seed)
    want = jbd.SyntheticFusionDataset(**kw).load(idx, noise_seed=noise_seed)
    _same(got, want)
    assert got["rulebooks"]["down_valid"].any() and got["voxel_feats"].shape == (512, 5)


@pytest.mark.parametrize("rank,world", [(0, 1), (1, 2)])
def test_fusion_batch_iterator_matches_jax(rank, world):
    kw = _synthetic_kw()
    got = tbd.fusion_batch_iterator(tbd.SyntheticFusionDataset(**kw), 4, seed=3, rank=rank,
                                    world=world)
    want = jbd.fusion_batch_iterator(jbd.SyntheticFusionDataset(**kw), 4, seed=3, rank=rank,
                                     world=world)
    for _ in range(3):  # 8 scenes a epoch: the third batch draws new lidar patterns
        g = next(got)
        _same(g, next(want))
        assert set(g) == set(FUSION_BATCH_KEYS) and g["image"].shape[0] == 4 // world
        assert g["rulebooks"]["subm1"].shape == (4 // world, 27, 512)


def test_nuscenes_bev_dataset_matches_jax():
    mc = get_config("nuscenes_fusion").model
    got = tbd.NuScenesBEVDataset(NUSC, "train", image_size=mc.bev_image_size)
    want = jbd.NuScenesBEVDataset(NUSC, "train", image_size=mc.bev_image_size)
    assert len(got) == len(want) == 2
    for i in range(2):
        s = got.load(i)
        _same(s, want.load(i))
        assert s["image"].shape == (6, 256, 704, 3) and s["label"].shape[:2] == (200, 200)
    assert len(tbd.NuScenesBEVDataset(NUSC, "val")) == 0


def test_nuscenes_fusion_batch_matches_jax():
    """A batch of 2 of the nuScenes fixture at nuscenes_fusion's capacities
    (120,000 voxels at the first level): cameras, sweeps, voxels, rulebooks."""
    mc = get_config("nuscenes_fusion").model
    kw = dict(image_size=mc.bev_image_size, sparse_shape=mc.bev_sparse_shape,
              caps=mc.bev_voxel_caps, voxel_size=mc.bev_voxel_size)
    got = next(tbd.fusion_batch_iterator(tbd.NuScenesFusionDataset(NUSC, "train", **kw), 2))
    want = next(jbd.fusion_batch_iterator(jbd.NuScenesFusionDataset(NUSC, "train", **kw), 2))
    _same(got, want)
    assert got["voxel_feats"].shape == (2, 120_000, 5)
    assert got["rulebooks"]["subm1"].shape == (2, 27, 120_000)
    assert (got["rulebooks"]["subm1"] >= 0).any() and got["voxel_feats"][..., 4].max() > 0


@pytest.mark.parametrize("name,overrides", [
    ("nuscenes_camera", {"data.data_root": NUSC, "data.batch_size": 2}),
    ("smoke_fusion", {"data.dataset": "nuscenes", "data.data_root": NUSC,
                      "data.batch_size": 2}),
    ("smoke_fusion", {}), ("converge_bev_fusion", {"data.batch_size": 4})])
def test_make_train_iter_fusion_and_nuscenes_match_jax(name, overrides):
    got = make_train_iter(get_config(name, overrides))
    want = jmake_train_iter(jconfig.get_config(name, overrides))
    for _ in range(2):
        _same(next(got), next(want))


@pytest.mark.parametrize("name", ["nuscenes_camera", "nuscenes_fusion"])
def test_make_train_iter_empty_tree_raises(name, tmp_path):
    with pytest.raises(FileNotFoundError, match="no nuScenes infos"):
        make_train_iter(get_config(name, {"data.data_root": str(tmp_path)}))


# --- the train step and the loop on fusion batches --------------------------------------

def _state(seed=0):
    cfg = get_config("smoke_fusion")
    model = build_model(cfg.model, device="cpu", seed=seed)
    return TrainState(model, make_optimizer(cfg.optim, model), torch.Generator().manual_seed(1))


def _host_batches(n=2, b=2):
    it = make_train_iter(get_config("smoke_fusion", {"data.batch_size": b}))
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize("mixed", [False, True])
def test_fusion_batch_through_eager_and_chunked_steps(mixed):
    """Two steps eagerly and as one chunk of 2 (bit for bit on the CPU), and
    one step of a batch of 4 in 2 microbatches against the chunk-averaged
    gradients of its halves' losses (same BN path: each microbatch folds
    its own scenes)."""
    batches = _host_batches()
    eager_state, chunk_state = _state(), _state()
    eager = make_train_step(mixed_precision=mixed, batch_keys=FUSION_BATCH_KEYS)
    for b in batches:
        eager(eager_state, {k: tree_map(torch.from_numpy, b[k]) for k in FUSION_BATCH_KEYS})
    chunk = make_chunked_train_step(2, mixed_precision=mixed, batch_keys=FUSION_BATCH_KEYS)
    logs = chunk(chunk_state, {k: stack_batches([b[k] for b in batches])
                               for k in FUSION_BATCH_KEYS})
    assert logs["loss"].shape == (2,) and torch.isfinite(logs["loss"]).all()
    for (n, p), q in zip(chunk_state.model.state_dict().items(),
                         eager_state.model.state_dict().values()):
        assert torch.equal(p, q), n
    big = _host_batches(1, 4)[0]
    tb = {k: tree_map(torch.from_numpy, big[k]) for k in FUSION_BATCH_KEYS}
    rng = np.random.RandomState(2)
    tb["t"] = torch.from_numpy(rng.uniform(0, 0.999, 4).astype(np.float32))
    tb["noise"] = torch.from_numpy(rng.randn(4, 16, 16, 32).astype(np.float32))
    g_micro, _ = make_train_step(2, mixed_precision=mixed, batch_keys=FUSION_BATCH_KEYS).grads(
        _state(), tb)
    halves = [tstep._chunk(tb, i, 2, "image") for i in range(2)]
    assert halves[1]["rulebooks"]["subm1"].shape == (2, 27, 512)
    g_halves = [make_train_step(mixed_precision=mixed, batch_keys=FUSION_BATCH_KEYS).grads(
        _state(), h)[0] for h in halves]
    for g, a, b in zip(g_micro, *g_halves):
        assert torch.allclose(g, (a + b) / 2, rtol=1e-5, atol=1e-7)


def test_bf16_policy_casts_voxel_features_not_rulebooks(monkeypatch):
    seen = {}
    model = _state().model
    forward = type(model).forward

    def spy(self, *args, **kw):
        seen["voxel_feats"] = args[6].dtype
        seen["rulebooks"] = {k: v.dtype for k, v in args[7].items()}
        seen["image"] = args[0].dtype
        return forward(self, *args, **kw)

    monkeypatch.setattr(type(model), "forward", spy)
    b = _host_batches(1)[0]
    state = TrainState(model, make_optimizer(get_config("smoke_fusion").optim, model),
                       torch.Generator().manual_seed(0))
    make_train_step(mixed_precision=True, batch_keys=FUSION_BATCH_KEYS)(
        state, {k: tree_map(torch.from_numpy, b[k]) for k in FUSION_BATCH_KEYS})
    assert seen["voxel_feats"] == seen["image"] == torch.bfloat16
    assert set(seen["rulebooks"].values()) == {torch.int32, torch.bool}


def test_heldout_fusion_batches_match_jax():
    mc = get_config("converge_bev_fusion").model
    got = C.heldout_fusion_batches(mc)
    ds = jbd.SyntheticFusionDataset(**{k: v for k, v in _synthetic_kw("converge_bev_fusion")
                                       .items() if k != "length"})
    mean, std = np.asarray(C.MEAN, np.float32), np.asarray(C.STD, np.float32)
    assert len(got) == C.N_EVAL // C.EVAL_BATCH
    for j in (0, len(got) - 1):
        samples = [ds.load(C.HELDOUT_BASE + i) for i in range(j * 8, j * 8 + 8)]
        for smp in samples:
            smp["image"] = (smp["image"] - mean) / std
        want = {k: np.stack([smp[k] for smp in samples]) for k in FUSION_BATCH_KEYS
                if k != "rulebooks"}
        want["rulebooks"] = {k: np.stack([smp["rulebooks"][k] for smp in samples])
                             for k in samples[0]["rulebooks"]}
        _same(tree_map(lambda x: x.numpy(), got[j]), want)


def test_eval_bev_fusion_keys(monkeypatch):
    """eval_bev_fusion on a fresh smoke-scale model: the JAX harness's keys
    (1 and 3 steps), twice the same numbers."""
    mc = dataclasses.replace(get_config("converge_bev_fusion").model, decoder_layers=1)
    small = C.heldout_fusion_batches(mc)[:1]
    monkeypatch.setattr(C, "heldout_fusion_batches", lambda mc: small)
    model = build_model(mc, device="cpu", seed=0)
    out = C.eval_bev_fusion(model, mc, seeds=(0,))
    assert set(out) == {"map_mIoU@1step", "map_mIoU@1step_std", "map_mIoU@3step",
                        "map_mIoU@3step_std", "iou_class0", "iou_class1", "iou_class2"}
    assert out == C.eval_bev_fusion(model, mc, seeds=(0,))
    assert C.SCORERS["bev_fusion"] is C.eval_bev_fusion


def test_test_cli_refuses_fusion(capsys):
    with pytest.raises(SystemExit, match="eval_bev_fusion"):
        test_cli.main(["smoke_fusion", "--device", "cpu"])


def test_train_cli_on_smoke_fusion(tmp_path):
    workdir = str(tmp_path / "smoke_fusion")
    rc = train_cli.main(["smoke_fusion", "--device", "cpu", "--workdir", workdir, "--set",
                         "runtime.total_iters=2", "runtime.log_interval=1",
                         "runtime.ckpt_interval=2", "data.batch_size=2",
                         "runtime.tensorboard=false"])
    assert rc == 0
    with open(os.path.join(workdir, "train_log.jsonl")) as f:
        logs = [__import__("json").loads(line) for line in f]
    assert [r["step"] for r in logs] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in logs)
    assert os.listdir(os.path.join(workdir, "ckpts"))
    shutil.rmtree(workdir)
