"""The port's lidar pieces against the JAX package's, on the CPU (the cases
and checks of the modules: ``tests/torch_port_lidar_cases.py``; DLA, VoVNet
and DepthLSSTransform: ``tests/test_torch_port_lidar_cameras.py``).

  - ``SECOND``, ``SECONDFPN`` (strides 0.5, 1 and 2: a strided conv, a 1x1
    conv and a transposed conv), ``PillarFeatureNet`` (two layers, an empty
    and a full pillar, with the range channel) and ``SparseEncoder`` on
    host-built rulebooks at tiny widths: eval outputs in float32, and one
    float64 training step's outputs, batch statistics and gradients
    (PillarFeatureNet's two layers with padded points against JAX op by
    op: ``OP_BY_OP`` says why).
  - ``point_pillars_scatter`` and ``SparseEncoder``'s densify bitwise.
  - The host functions bitwise: ``multi_sweep_points`` with one
    ``np.random.Generator`` on both sides, ``_remove_close`` and
    ``rasterize_lidar_depth`` (the nearest point wins a shared pixel).
"""
import inspect

import numpy as np
import pytest
import torch

from torch_port_lidar_cases import (CAPS, GROUPS, _points, _rig_batch,
                                    _sparse_inputs, check_eval, check_train)
from ddp_tpu.data import bev_datasets as jbd
from ddp_tpu.data import transforms_3d as jt3
from ddp_tpu.nn import dla_vovnet as jdv
from ddp_tpu.nn import second as jsec
from ddp_tpu_torch.data import bev_datasets as tbd
from ddp_tpu_torch.data import transforms_3d as tt3
from ddp_tpu_torch.nn import bev as tbev
from ddp_tpu_torch.nn import dla_vovnet as tdv
from ddp_tpu_torch.nn import second as tsec
from ddp_tpu_torch.nn import sparse_conv as tsc
from torch_port_threads import _one_torch_thread  # noqa: F401


@pytest.mark.parametrize("name", GROUPS["lidar"])
def test_eval_matches_jax(name):
    check_eval(name)


@pytest.mark.parametrize("name", GROUPS["lidar"])
def test_train_step_matches_jax_float64(name):
    check_train(name)


def test_scatters_are_bitwise_jax():
    """``point_pillars_scatter`` (duplicate-free cells, an invalid pillar)
    and ``SparseEncoder``'s densify of its last level."""
    rng = np.random.RandomState(2)
    feats = rng.randn(2, 7, 3).astype(np.float32)
    cells = np.stack([rng.permutation(20)[:7] for _ in range(2)])
    coords = np.stack([cells % 5, cells // 5], -1).astype(np.int32)
    valid = np.ones((2, 7), bool)
    valid[1, 3] = False
    want = np.asarray(jsec.point_pillars_scatter(feats, coords, valid, 5, 4))
    got = tsec.point_pillars_scatter(torch.from_numpy(feats), torch.from_numpy(coords),
                                     torch.from_numpy(valid), 5, 4)
    assert got.shape == (2, 4, 5, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    _, rb = _sparse_inputs()
    rows = rng.randn(CAPS[4], 6).astype(np.float32)
    hw, z = 8, 2
    flat = (rb["down_coords"][:, 0] * hw + rb["down_coords"][:, 1]) * z + rb["down_coords"][:, 2]
    flat = np.where(rb["down_valid"], flat, hw * hw * z)
    want = np.zeros((hw * hw * z + 1, 6), np.float32)
    np.add.at(want, flat, np.where(rb["down_valid"][:, None], rows, 0.0))
    got = tsc.densify(torch.from_numpy(rows), torch.from_numpy(rb["down_coords"]),
                      torch.from_numpy(rb["down_valid"]), 1, hw, z)[0]
    np.testing.assert_array_equal(got.numpy(), want[:-1].reshape(hw, hw, z * 6))


@pytest.mark.parametrize("n_sweeps,test_mode,remove_close", [
    (0, False, True), (3, False, False), (12, False, True), (12, True, True)])
def test_multi_sweep_points_bitwise(n_sweeps, test_mode, remove_close):
    rng = np.random.RandomState(n_sweeps)
    key = _points(200, 6) * np.array([0.2, 0.2, 1, 1, 1], np.float32)  # some within 1 m
    sweeps = []
    for i in range(n_sweeps):
        a = 0.01 * i
        rot = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
        sweeps.append({"points": _points(50 + i, 10 + i), "sensor2lidar_rotation": rot,
                       "sensor2lidar_translation": rng.randn(3), "timestamp": 1.0 - 0.05 * i})
    kw = dict(sweeps_num=10, timestamp=1.0, remove_close=remove_close, test_mode=test_mode)
    want = jt3.multi_sweep_points(key, sweeps, np.random.default_rng(7), **kw)
    got = tt3.multi_sweep_points(key, sweeps, np.random.default_rng(7), **kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tt3._remove_close(key, 0.5), jt3._remove_close(key, 0.5))


def test_rasterize_lidar_depth_bitwise_nearest_wins():
    rots, trans, intr, post_rots, post_trans = _rig_batch()
    pts = _points(3000, 8)
    # two points on one ray from camera 0: the nearer one must win its pixel
    ray = rots[0] @ np.array([0.1, 0.05, 1.0], np.float32)
    pts[:2, :3] = trans[0] + np.stack([4.0 * ray, 2.0 * ray])
    args = (rots, trans, intr, post_rots, post_trans, (32, 64))
    want = jbd.rasterize_lidar_depth(pts, *args)
    got = tbd.rasterize_lidar_depth(pts, *args)
    assert got.shape == (2, 32, 64, 1) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert (got > 0).sum() > 50
    uvd = intr[0] @ np.array([0.1, 0.05, 1.0], np.float32)
    uv = post_rots[0][:2, :2] @ (uvd[:2] / uvd[2]) + post_trans[0][:2]
    ui, vi = np.round(uv).astype(int)
    np.testing.assert_allclose(got[0, vi, ui, 0], 2.0, rtol=1e-5)


@pytest.mark.parametrize("jmod,tmod", [(jsec, tsec), (jdv, tdv)], ids=["second", "dla_vovnet"])
def test_every_jax_name_has_a_port_counterpart(jmod, tmod):
    names = {n for n, v in vars(jmod).items()
             if (inspect.isclass(v) or inspect.isfunction(v))
             and getattr(v, "__module__", None) == jmod.__name__}
    assert len(names) >= 4
    assert names <= set(vars(tmod)), sorted(names - set(vars(tmod)))
    assert hasattr(tbev, "DepthLSSTransform") and hasattr(tsc, "SparseEncoder")
