"""The port's lidar host ops and sparse convolution
(``ddp_tpu_torch/native``, ``ddp_tpu_torch/nn/sparse_conv.py``) against the
JAX package's, on the CPU. Inputs are seeded numpy; the JAX side is jitted.

  - The C++ voxelizer and rulebooks (the port's copy, built into
    ``ddp_tpu_torch/_build/``) against ``ddp_tpu.native``'s and against the
    port's numpy twins, bitwise, on a seeded cloud with points out of range
    on every side, more points than ``max_points`` in a voxel, and more
    voxels and output sites than the capacities (dropped); a build that
    fails raises with the compiler's output.
  - ``sparse_conv_gather_gemm`` (the autograd Function) and its plain
    version against JAX's, on a subm, a strided, the anisotropic stage-4 and
    the ``down`` rulebook of a real cloud: f32 outputs within 1e-5 relative,
    the features' and the weight's gradients within 1e-3·max|g| + 1e-6 of
    ``jax.grad``; the Function against the plain version the same way.
  - ``transpose_rulebook`` is a bijection between the valid entries of a
    rulebook and those of its transpose, on every level.
  - ``MaskedBatchNorm`` in training (three updates of the running
    statistics, within 1e-6) and eval, f32 and bf16, against JAX's.
  - ``densify`` against JAX's scatter on asymmetric coordinates (x and y
    swapped would land elsewhere), with its gradient.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_tpu import native as jnative
from ddp_tpu.nn import sparse_conv as jsc
from ddp_tpu_torch import native
from ddp_tpu_torch.nn import sparse_conv as tsc
from torch_port_threads import _one_torch_thread  # noqa: F401


# the z extent of nuScenes' grid (41 cells of 0.2 m), a smaller x-y one
SHAPE = (40, 32, 41)
VOXEL = (0.5, 0.5, 0.2)
RANGE = (-10.0, -8.0, -5.0, 10.0, 8.0, 3.2)
CAPS = (600, 200, 90, 40, 30)


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=1)
def _cloud():
    """2,500 points: a quarter spread 1.4x past the range on every axis,
    the rest clustered (so voxels hold more than 4 points)."""
    rng = np.random.RandomState(0)
    lo, hi = np.asarray(RANGE[:3]), np.asarray(RANGE[3:])
    wide = lo - 0.2 * (hi - lo) + rng.rand(625, 3) * 1.4 * (hi - lo)
    centres = lo + rng.rand(60, 3) * (hi - lo)
    tight = centres[rng.randint(0, 60, 1875)] + rng.randn(1875, 3) * 0.6
    pts = np.zeros((2500, 5), np.float32)
    pts[:, :3] = np.concatenate([wide, tight])
    pts[:, 3:] = rng.rand(2500, 2)
    return pts


@functools.lru_cache(maxsize=1)
def _voxelized():
    return native.hard_voxelize(_cloud(), RANGE, VOXEL, max_points=4, max_voxels=CAPS[0])


@functools.lru_cache(maxsize=1)
def _rulebooks():
    _, coords, _, nv = _voxelized()
    return tsc.build_sparse_encoder_rulebooks(coords, nv, SHAPE, CAPS)


def _same(got, want):
    for a, b in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("max_points,max_voxels", [(4, 600), (2, 150)])
def test_hard_voxelize_matches_jax_and_numpy(max_points, max_voxels):
    pts = _cloud()
    got = native.hard_voxelize(pts, RANGE, VOXEL, max_points, max_voxels)
    _same(got, jnative.hard_voxelize(pts, RANGE, VOXEL, max_points, max_voxels))
    _same(got, native.hard_voxelize_plain(pts, RANGE, VOXEL, max_points, max_voxels))
    voxels, coords, counts, nv = got
    assert counts.max() == max_points and (counts[:nv] > 0).all() and not counts[nv:].any()
    if max_voxels == 150:
        assert nv == 150  # the voxels past the capacity are dropped
    lo, vs = np.asarray(RANGE[:3], np.float32), np.asarray(VOXEL, np.float32)
    inside = ((pts[:, :3] >= RANGE[:3]) & (pts[:, :3] < RANGE[3:])).all(axis=1)
    assert 0.5 < inside.mean() < 0.95
    # every kept point lies in its voxel
    for v in range(0, nv, 7):
        p = voxels[v, :counts[v], :3]
        assert (np.floor((p - lo) / vs).astype(np.int32) == coords[v]).all()


@pytest.mark.parametrize("cap", [600, 120])
def test_subm_rulebook_matches_jax_and_numpy(cap):
    _, coords, _, nv = _voxelized()
    n = min(nv, cap)
    got = native.build_subm_rulebook(coords, n, cap)
    _same([got], [jnative.build_subm_rulebook(coords, n, cap)])
    _same([got], [native.build_subm_rulebook_plain(coords, n, cap)])
    assert (got[13, :n] == np.arange(n)).all()  # the centre offset


@pytest.mark.parametrize("kernel,stride,pad,cap", [
    (3, 2, 1, 300), (3, 2, 1, 60),                       # cubic; the second overflows
    ((3, 3, 3), (2, 2, 2), (1, 1, 0), 300),              # the stage-4 entry
    ((1, 1, 3), (1, 1, 2), (0, 0, 0), 400)])             # conv_out, down z
def test_sparse_rulebook_matches_jax_and_numpy(kernel, stride, pad, cap):
    _, coords, _, nv = _voxelized()
    got = native.build_sparse_rulebook(coords, nv, SHAPE, kernel, stride, pad, cap)
    _same(got, jnative.build_sparse_rulebook(coords, nv, SHAPE, kernel, stride, pad, cap))
    _same(got, native.build_sparse_rulebook_plain(coords, nv, SHAPE, kernel, stride, pad, cap))
    if cap == 60:
        assert got[2] == 60


def test_encoder_rulebooks_match_jax():
    _, coords, _, nv = _voxelized()
    got = tsc.build_sparse_encoder_rulebooks(coords, nv, SHAPE, CAPS)
    want = jsc.build_sparse_encoder_rulebooks(coords, nv, SHAPE, CAPS)
    assert list(got) == list(want)
    for k in want:
        _same([got[k]], [want[k]])
    assert got["down_valid"].sum() > 5


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text('extern "C" int hard_voxelize( { this is not C++ }\n')
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        native.load_library()
    assert "broken.cpp" in str(err.value) and "error" in str(err.value)
    assert not [f for f in os.listdir(tmp_path / "build") if f.endswith(".so")]


def test_library_builds_into_the_build_dir():
    native.load_library()
    path = native.library_path()
    assert os.path.dirname(path) == os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(native.__file__))), "_build")
    assert os.path.exists(path)


# --- the gather-GEMM ---------------------------------------------------------------------

# (rulebook, its input level's capacity, Cin, Cout)
LEVELS = [("subm1", CAPS[0], 5, 16), ("spconv2", CAPS[0], 16, 32), ("subm3", CAPS[2], 64, 64),
          ("spconv4", CAPS[2], 64, 64), ("down", CAPS[3], 64, 24)]


def _conv_case(key, v_in, cin, cout, seed=0):
    rng = np.random.RandomState(seed)
    gather = _rulebooks()[key]
    feats = rng.randn(v_in, cin).astype(np.float32)
    weight = (rng.randn(gather.shape[0], cin, cout) / np.sqrt(gather.shape[0] * cin)
              ).astype(np.float32)
    cot = rng.randn(gather.shape[1], cout).astype(np.float32)
    return gather, feats, weight, cot


def _torch_grads(fn, gather, feats, weight, cot):
    f, w = _t(feats).requires_grad_(True), _t(weight).requires_grad_(True)
    out = fn(f, _t(gather), w)
    (out * _t(cot)).sum().backward()
    return out.detach().numpy(), f.grad.numpy(), w.grad.numpy()


def _close_g(got, want):
    assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max() + 1e-6


@pytest.mark.parametrize("key,v_in,cin,cout", LEVELS)
def test_gather_gemm_matches_jax(key, v_in, cin, cout):
    gather, feats, weight, cot = _conv_case(key, v_in, cin, cout)

    def loss(f, w):
        return (jsc.sparse_conv_gather_gemm(f, jnp.asarray(gather), w) * cot).sum()

    want = np.asarray(jax.jit(jsc.sparse_conv_gather_gemm)(
        jnp.asarray(feats), jnp.asarray(gather), jnp.asarray(weight)))
    df_j, dw_j = (np.asarray(g) for g in jax.jit(jax.grad(loss, argnums=(0, 1)))(
        jnp.asarray(feats), jnp.asarray(weight)))
    assert np.abs(want).max() > 0 and np.abs(df_j).max() > 0
    runs = {fn.__name__: _torch_grads(fn, gather, feats, weight, cot)
            for fn in (tsc.sparse_conv_gather_gemm, tsc.sparse_conv_gather_gemm_plain)}
    for out, df, dw in runs.values():
        assert np.abs(out - want).max() <= 1e-5 * np.abs(want).max()
        _close_g(df, df_j)
        _close_g(dw, dw_j)
    (out, df, dw), (out_p, df_p, dw_p) = runs.values()
    assert np.abs(out - out_p).max() <= 1e-5 * np.abs(out_p).max()
    _close_g(df, df_p)
    _close_g(dw, dw_p)
    # rows no offset feeds get nothing; input rows nothing reads get no gradient
    assert not out[~(gather >= 0).any(axis=0)].any()
    read = np.zeros(v_in, bool)
    read[gather[gather >= 0]] = True
    assert not df[~read].any()


@pytest.mark.parametrize("key,v_in", [(k, v) for k, v, _, _ in LEVELS] + [("subm2", CAPS[1])])
def test_transposed_rulebook_is_a_bijection(key, v_in):
    gather = _rulebooks()[key]
    inv = tsc.transpose_rulebook(_t(gather), v_in).numpy()
    assert inv.shape == (gather.shape[0], v_in) and inv.dtype == np.int32
    k_idx, o_idx = np.nonzero(gather >= 0)
    assert (inv[k_idx, gather[k_idx, o_idx]] == o_idx).all()
    assert (inv >= 0).sum() == len(k_idx) > 0
    kk, ii = np.nonzero(inv >= 0)
    assert (gather[kk, inv[kk, ii]] == ii).all()
    # the batch fold keeps it one: two samples' rulebooks side by side
    two = np.concatenate([gather, np.where(gather >= 0, gather + v_in, -1)], axis=1)
    inv2 = tsc.transpose_rulebook(_t(two), 2 * v_in).numpy()
    assert (inv2[:, :v_in] == inv).all()
    assert (inv2[:, v_in:] == np.where(inv >= 0, inv + gather.shape[1], -1)).all()


# --- MaskedBatchNorm ---------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_batch_norm_matches_jax(dtype):
    rng = np.random.RandomState(3)
    c = 12
    xs = [(rng.randn(80, c) * 3 + 1.5).astype(np.float32) for _ in range(3)]
    masks = [rng.rand(80) < p for p in (0.3, 0.6, 0.9)]
    bn = jsc.MaskedBatchNorm()
    v = bn.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]), jnp.asarray(masks[0]), train=False)
    v = {"params": {"scale": jnp.asarray(rng.rand(c).astype(np.float32) + 0.5),
                    "bias": jnp.asarray(rng.randn(c).astype(np.float32))},
         "batch_stats": v["batch_stats"]}
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    tm = tsc.MaskedBatchNorm(c)
    with torch.no_grad():
        tm.scale.copy_(_t(np.asarray(v["params"]["scale"])))
        tm.bias.copy_(_t(np.asarray(v["params"]["bias"])))
    low = {"scale": tm.scale.to(tdt), "bias": tm.bias.to(tdt)}
    jparams = jax.tree_util.tree_map(lambda a: a.astype(jdt), v["params"])
    step = jax.jit(lambda v, x, m: bn.apply(v, x, m, train=True, mutable=["batch_stats"]))
    tol = 1e-5 if dtype == "float32" else 2e-2
    for x, m in zip(xs, masks):
        want, mut = step({"params": jparams, "batch_stats": v["batch_stats"]},
                         jnp.asarray(x).astype(jdt), jnp.asarray(m))
        v = {"params": v["params"], "batch_stats": mut["batch_stats"]}
        got = torch.func.functional_call(tm.train(), low, (_t(x).to(tdt), _t(m)))
        assert got.dtype == tdt
        w = np.asarray(want.astype(jnp.float32))
        assert np.abs(got.float().detach().numpy() - w).max() <= tol * np.abs(w).max()
    for name in ("mean", "var"):
        w = np.asarray(v["batch_stats"][name])
        assert np.abs(getattr(tm, name).numpy() - w).max() <= 1e-6 * np.abs(w).max(), name
    want = bn.apply({"params": jparams, "batch_stats": v["batch_stats"]},
                    jnp.asarray(xs[0]).astype(jdt), jnp.asarray(masks[0]), train=False)
    got = torch.func.functional_call(tm.eval(), low, (_t(xs[0]).to(tdt), _t(masks[0])))
    w = np.asarray(want.astype(jnp.float32))
    assert np.abs(got.float().detach().numpy() - w).max() <= tol * np.abs(w).max()


def test_sparse_conv_layer_matches_jax():
    """conv -> masked BN -> ReLU -> padding rows zeroed, training mode, with
    the weight's and the features' gradients."""
    gather, feats, weight, cot = _conv_case("subm2", CAPS[1], 32, 32, seed=4)
    jl = jsc.SparseConvLayer(32)
    v = jl.init(jax.random.PRNGKey(0), jnp.asarray(feats), jnp.asarray(gather), train=False)
    v = {"params": {**v["params"], "kernel": jnp.asarray(weight)},
         "batch_stats": v["batch_stats"]}

    def loss(p, f):
        out, mut = jl.apply({"params": p, "batch_stats": v["batch_stats"]}, f,
                            jnp.asarray(gather), train=True, mutable=["batch_stats"])
        return (out * cot).sum(), (out, mut)

    (_, (want, mut)), (gp, gf) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1),
                                                            has_aux=True))(
        v["params"], jnp.asarray(feats))
    tl = tsc.SparseConvLayer(32, 32).train()
    with torch.no_grad():
        tl.kernel.copy_(_t(weight))
    f = _t(feats).requires_grad_(True)
    out = tl(f, _t(gather))
    (out * _t(cot)).sum().backward()
    w = np.asarray(want)
    assert np.abs(out.detach().numpy() - w).max() <= 1e-5 * np.abs(w).max()
    assert not out.detach().numpy()[~(gather >= 0).any(axis=0)].any()
    _close_g(f.grad.numpy(), np.asarray(gf))
    _close_g(tl.kernel.grad.numpy(), np.asarray(gp["kernel"]))
    for name in ("scale", "bias"):
        _close_g(getattr(tl.bn, name).grad.numpy(), np.asarray(gp["bn"][name]))
    for name in ("mean", "var"):
        w = np.asarray(mut["batch_stats"]["bn"][name])
        assert np.abs(getattr(tl.bn, name).numpy() - w).max() <= 1e-6 * np.abs(w).max()


# --- densification -----------------------------------------------------------------------

def _jax_densify(x, coords, valid, b, hw, z):
    """``ddp_tpu/models/bev_fusion.py:167-172``."""
    n = x.shape[0]
    boffs = jnp.repeat(jnp.arange(b) * (hw * hw * z), n // b)
    flat_idx = (coords[:, 0] * hw + coords[:, 1]) * z + coords[:, 2] + boffs
    flat_idx = jnp.where(valid, flat_idx, b * hw * hw * z)
    dense = jnp.zeros((b * hw * hw * z + 1, x.shape[-1]), x.dtype)
    dense = dense.at[flat_idx].add(jnp.where(valid[:, None], x, 0.0))
    return dense[:-1].reshape(b, hw, hw, z * x.shape[-1])


def test_densify_matches_jax_on_asymmetric_coordinates():
    b, cap, hw, z, c = 2, 40, 8, 2, 3
    rng = np.random.RandomState(5)
    # every cell but those at (x, y) = (1, 6) and (6, 1)
    free = [i for i in range(hw * hw * z) if (i // (hw * z), i // z % hw) not in ((1, 6), (6, 1))]
    cells = np.stack([rng.permutation(free)[:cap] for _ in range(b)])
    coords = np.stack([cells // (hw * z), cells // z % hw, cells % z], -1).astype(np.int32)
    coords[0, 0] = (1, 6, 1)  # x != y: a swapped axis would land at (6, 1)
    valid = rng.rand(b, cap) < 0.7
    valid[0, 0] = True
    coords[~valid] = 0  # as the host writes padding rows
    x = rng.randn(b * cap, c).astype(np.float32)
    cot = rng.randn(b, hw, hw, z * c).astype(np.float32)
    args = (coords.reshape(-1, 3), valid.reshape(-1))
    want = np.asarray(_jax_densify(jnp.asarray(x), *map(jnp.asarray, args), b, hw, z))
    grad_j = np.asarray(jax.grad(lambda v: (_jax_densify(v, *map(jnp.asarray, args), b, hw, z)
                                            * cot).sum())(jnp.asarray(x)))
    xt = _t(x).requires_grad_(True)
    got = tsc.densify(xt, *map(_t, args), b, hw, z)
    (got * _t(cot)).sum().backward()
    assert tuple(got.shape) == (b, hw, hw, z * c)
    assert np.array_equal(got.detach().numpy(), want)
    assert np.array_equal(xt.grad.numpy(), grad_j)
    assert np.array_equal(want[0, 1, 6, c:], x[0]) and not want[0, 6, 1].any()
