"""The port's BEV data against the JAX package, on the CPU.

  - ``data/transforms_3d.py``: ``image_aug_3d`` (train, with a flip, and
    test), ``global_rot_scale_trans`` with points, ``rotate_bev_masks`` and
    ``grid_mask`` (with a rotated mask): bitwise the JAX package's; without
    Pillow a named ImportError.
  - ``SyntheticBEVDataset`` (2- and 6-camera rigs), ``bev_batch_iterator``
    (with the 3D aug; one process, and one rank of two) and ``make_train_iter``'s
    BEV branch: bitwise; a nuScenes preset without its files raises
    FileNotFoundError.
  - ``build_model`` builds the JAX package's BEV heads (msda on the smoke
    and end-check presets, the window decoder with JAX's default window of
    8 on ``nuscenes_camera``) on the card unless told otherwise.
  - The BEV end check's held-out batches are the harness's; ``eval_bev``
    gives its keys, deterministically.

The train step, the end check's ``run`` and the CLIs on BEV batches are in
``test_torch_port_bev_train.py``.
"""
import sys

import numpy as np
import pytest
import torch

from ddp_tpu import config as jconfig
from ddp_tpu.data import bev_datasets as jbd
from ddp_tpu.data import make_train_iter as jmake_train_iter
from ddp_tpu.data import transforms_3d as jt3
from ddp_tpu_torch.config import build_model, get_config
from ddp_tpu_torch.data import bev_datasets as tbd
from ddp_tpu_torch.data import make_train_iter
from ddp_tpu_torch.data import transforms_3d as tt3
from ddp_tpu_torch.data.bev_datasets import BEV_BATCH_KEYS
from ddp_tpu_torch.evaluation import convergence as C
from torch_port_threads import _one_torch_thread  # noqa: F401


def _same(got, want):
    """Bitwise equal dicts of arrays (values, dtypes and shapes)."""
    assert set(got) == set(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), k


def _images(n=3, hw=(40, 72), seed=0):
    return (np.random.RandomState(seed).rand(n, *hw, 3) * 255).astype(np.float32)


# --- transforms_3d ----------------------------------------------------------------------

@pytest.mark.parametrize("is_train,flip", [(True, False), (True, True), (False, False)])
def test_image_aug_3d_matches_jax(is_train, flip):
    kw = dict(final_dim=(32, 64), resize_lim=(0.8, 1.2), bot_pct_lim=(0.0, 0.1),
              rot_lim=(-5.4, 5.4), rand_flip=flip)
    imgs = _images()
    rots = np.tile(np.eye(3, dtype=np.float32), (3, 1, 1))
    rots[:, 0, 1] = 0.05
    trans = np.random.RandomState(1).rand(3, 3).astype(np.float32)
    got = tt3.image_aug_3d(imgs, rots, trans, np.random.default_rng(4),
                           tt3.ImageAug3DConfig(**kw), is_train)
    want = jt3.image_aug_3d(imgs, rots, trans, np.random.default_rng(4),
                            jt3.ImageAug3DConfig(**kw), is_train)
    _same(dict(zip("irt", got)), dict(zip("irt", want)))
    assert got[0].shape == (3, 32, 64, 3)
    assert np.array_equal(got[1], rots) != is_train  # the test mode's resize is 1


def test_global_rot_scale_trans_and_masks_match_jax():
    points = np.random.RandomState(2).randn(50, 5).astype(np.float32) * 5
    masks = (np.random.RandomState(3).rand(20, 20, 3) < 0.3).astype(np.float32)
    for is_train in (True, False):
        got = tt3.global_rot_scale_trans(np.random.default_rng(5), points, is_train=is_train)
        want = jt3.global_rot_scale_trans(np.random.default_rng(5), points, is_train=is_train)
        _same({"p": got[0], "m": got[1]}, {"p": want[0], "m": want[1]})
        assert np.array_equal(tt3.rotate_bev_masks(masks, got[1], 8.0),
                              jt3.rotate_bev_masks(masks, want[1], 8.0))
    _, m = tt3.global_rot_scale_trans(np.random.default_rng(6), None)
    moved = tt3.rotate_bev_masks(masks, m, 8.0)
    assert moved.dtype == masks.dtype and not np.array_equal(moved, masks)


@pytest.mark.parametrize("rotate", [1, 30])
def test_grid_mask_matches_jax(rotate):
    imgs = _images(2, (32, 64), seed=7)
    for seed in range(4):
        got = tt3.grid_mask(imgs, np.random.default_rng(seed), prob=0.8, rotate=rotate)
        want = jt3.grid_mask(imgs, np.random.default_rng(seed), prob=0.8, rotate=rotate)
        assert got.dtype == want.dtype and np.array_equal(got, want), seed


def test_transforms_need_pillow(monkeypatch):
    for k in [k for k in sys.modules if k.split(".")[0] == "PIL"]:
        monkeypatch.delitem(sys.modules, k)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="through Pillow"):
        tt3._pil_resize(_images(1)[0], (36, 20))
    with pytest.raises(ImportError, match="through Pillow"):
        tt3._pil_rotate(_images(1)[0], 3.0)


# --- datasets and iterators ---------------------------------------------------------------

@pytest.mark.parametrize("num_cams", [2, 6])
def test_synthetic_bev_dataset_matches_jax(num_cams):
    kw = dict(num_cams=num_cams, image_size=(32, 64), out_grid=20, num_classes=3, scope=8.0)
    t, j = tbd.SyntheticBEVDataset(**kw), jbd.SyntheticBEVDataset(**kw)
    for a, b in zip(t.rig(), j.rig()):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for idx in (0, 5, 100_003):
        s = t.load(idx)
        _same(s, j.load(idx))
        assert s["image"].shape == (num_cams, 32, 64, 3) and s["label"].shape == (20, 20, 3)
    assert len(t) == len(j) == 128
    assert sum(t.load(i)["label"].sum() for i in range(4)) > 0


@pytest.mark.parametrize("rank,world", [(0, 1), (1, 2)])
def test_bev_batch_iterator_matches_jax(rank, world):
    """Batches of 4 over a 6-scene dataset (so an epoch ends mid-run), with
    the 3D aug (the port's iterator always augments, as JAX's
    make_train_iter asks of its own)."""
    kw = dict(num_cams=6, image_size=(32, 64), out_grid=20, num_classes=3, scope=8.0,
              length=6)
    got = tbd.bev_batch_iterator(tbd.SyntheticBEVDataset(**kw), 4, seed=3, rank=rank,
                                 world=world)
    want = jbd.bev_batch_iterator(jbd.SyntheticBEVDataset(**kw), 4, seed=3, rank=rank,
                                  world=world, aug=True)
    for _ in range(3):
        g = next(got)
        _same(g, next(want))
        assert tuple(g) == BEV_BATCH_KEYS and g["image"].shape[0] == 4 // world


@pytest.mark.parametrize("name", ["smoke_bev", "converge_bev"])
def test_make_train_iter_bev_matches_jax(name):
    got, want = make_train_iter(get_config(name)), jmake_train_iter(jconfig.get_config(name))
    for _ in range(2):
        _same(next(got), next(want))


def test_make_train_iter_refuses_nuscenes():
    """nuScenes data without its files (no infos under ``data.data_root``,
    the preset's ``data/nuscenes`` or an empty tree): a named error, and no
    synthetic stand-in. The reader itself is in test_torch_port_fusion_data.py."""
    with pytest.raises(FileNotFoundError, match="no nuScenes infos under data/nuscenes"):
        make_train_iter(get_config("nuscenes_camera"))
    with pytest.raises(FileNotFoundError, match="no nuScenes infos"):
        make_train_iter(get_config("smoke_bev", {"data.dataset": "nuscenes",
                                                 "data.data_root": "tests/data/nuscenes_none"}))


# --- build_model ----------------------------------------------------------------------------

def test_build_model_bev():
    from ddp_tpu_torch.models.bev import DDPBEVCamera

    mc = get_config("smoke_bev").model
    model = build_model(mc, device="cpu", seed=3)
    assert isinstance(model, DDPBEVCamera) and not model.training
    assert model.decode_head.attn_type == "msda" == mc.decoder_attn
    assert get_config("converge_bev").model.decoder_attn == "msda"
    big = build_model(get_config("nuscenes_camera").model, device="meta")
    assert big.decode_head.attn_type == "window"
    assert big.decode_head.encoder.layer0.attn.window == 8  # JAX passes no decoder_window
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_model(mc)


# --- the end check ----------------------------------------------------------------------------

def test_heldout_bev_batches_match_harness():
    """The scenes and normalisation of tools/run_convergence.py: eval_bev
    (held-out indices from 100,000, batches of 8), on the converge_bev rig."""
    mc = get_config("converge_bev").model
    ds = jbd.SyntheticBEVDataset(num_cams=6, image_size=(32, 64), out_grid=20, num_classes=3,
                                 scope=8.0)
    mean = np.asarray((123.675, 116.28, 103.53), np.float32)
    std = np.asarray((58.395, 57.12, 57.375), np.float32)
    got = C.heldout_bev_batches(mc)
    assert len(got) == C.N_EVAL // C.EVAL_BATCH == 4
    for batch, s0 in zip(got, range(0, C.N_EVAL, C.EVAL_BATCH)):
        samples = [ds.load(C.HELDOUT_BASE + i) for i in range(s0, s0 + C.EVAL_BATCH)]
        for s in samples:
            s["image"] = (s["image"] - mean) / std
        _same(batch, {k: np.stack([s[k] for s in samples]) for k in BEV_BATCH_KEYS})


def test_eval_bev_runs_and_is_deterministic():
    mc = get_config("smoke_bev").model
    model = build_model(mc, device="cpu", seed=0)
    a = C.eval_bev(model, mc, timesteps_list=(1,), seeds=(0,))
    b = C.eval_bev(model, mc, timesteps_list=(1,), seeds=(0,))
    assert a == b and set(a) == {"map_mIoU@1step", "map_mIoU@1step_std", "iou_class0",
                                 "iou_class1", "iou_class2"}
    assert 0.0 <= a["map_mIoU@1step"] <= 1.0 and a["map_mIoU@1step_std"] == 0.0
    assert C.SCORERS["bev"] is C.eval_bev
