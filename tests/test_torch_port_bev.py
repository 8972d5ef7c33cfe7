"""The port's BEV camera model (``ddp_tpu_torch/models/bev.py`` and the
modules under it) against the JAX package's, on the CPU. The JAX side is
jitted; inputs are seeded numpy.

  - ``quantize_geometry`` / ``bev_pool`` with points out of range on every
    axis (and a grid of 2 Z cells): the indices and the in-range mask
    exactly, the sums and their gradient within 1e-6 relative.
  - ``lss_geometry`` on perturbed rigs, f32 and bf16, within 1e-5 m per 10 m
    of range (1e-5 at the smoke scale); ``bev_grid_transform``
    at the smoke and nuScenes scopes within 1e-6, with its gradient.
  - ``LSSTransform`` (training mode: BN statistics) with all depth bins and
    with ``depth_topk``, within 1e-5 of the output's max; the BEV ResNet and
    both necks on odd grids (flax's asymmetric SAME padding of the stride-2
    convs), within 1e-5.
  - ``sigmoid_focal_loss`` and its gradient within 1e-6; ``bev_map_iou``
    exactly.
  - ``smoke_bev`` with JAX's init carried across by ``convert.py`` (msda
    decoder, its points moved off whole pixels as in
    ``test_torch_port_convnext.py``, and the window decoder of the nuScenes
    preset): the f32 loss
    with fixed t and noise within 1e-5 relative, every gradient within
    1e-3 · max|g| + 1e-6 and the BN statistics within 1e-5 relative; the
    bf16 step: the loss and the float32-run head at PERF.md §2's bf16 limits,
    the bf16-run encoder (where JAX's bf16 gradients miss those limits
    against the exact gradients, a reference behaviour shown here) group by
    group in cosine and norm against JAX's, with planted faults it must
    reject;
    ``sample``, the per-hypothesis rollout and
    ``sample_with_uncertainty`` within 1e-4 from the initial noise JAX drew.
  - Every flax leaf of ``nuscenes_camera`` maps to the port's state_dict.
"""
import dataclasses
import functools
import types

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ddp_tpu.core.diffusion as jdiff
from ddp_tpu import config as jconfig
from ddp_tpu.data.bev_datasets import SyntheticBEVDataset as JSyntheticBEVDataset
from ddp_tpu.evaluation.metrics import bev_map_iou as j_bev_map_iou
from ddp_tpu.nn import bev as jbev
from ddp_tpu.nn.losses import sigmoid_focal_loss as j_focal
from ddp_tpu.ops import bev_pool as jpool
from ddp_tpu_torch.config import build_model, get_config
from ddp_tpu_torch.convert import check_complete, load_flax, params_from_flax
from ddp_tpu_torch.data.bev_datasets import BEV_BATCH_KEYS
from ddp_tpu_torch.evaluation.metrics import bev_map_iou
from ddp_tpu_torch.nn import bev as tbev
from ddp_tpu_torch.nn.losses import sigmoid_focal_loss
from ddp_tpu_torch.ops.bev_pool import bev_pool, quantize_geometry
from ddp_tpu_torch.train import optim as toptim
from ddp_tpu_torch.train import step as tstep
from ddp_tpu_torch.train.step import TrainState, make_train_step
from test_torch_port_convnext import _off_grid
from torch_port_threads import _one_torch_thread  # noqa: F401


RIG = BEV_BATCH_KEYS[:-1]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _randn(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol)


# --- ops and modules --------------------------------------------------------------------

@pytest.mark.parametrize("zbound", [(-10.0, 10.0, 20.0), (-2.0, 2.0, 2.0)])
def test_quantize_geometry_and_bev_pool_match_jax(zbound):
    """Points spread over 1.5x the grid on every axis (so a share falls out
    of range on each), the smoke grid (32 x 32) with 1 or 2 Z cells."""
    bounds = ((-8.0, 8.0, 0.5), (-8.0, 8.0, 0.5), zbound)
    nx, dx, bx = tbev._grid(bounds)
    rng = np.random.RandomState(0)
    b, p, c = 2, 3000, 5
    lo = np.array([x[0] for x in bounds], np.float32)
    hi = np.array([x[1] for x in bounds], np.float32)
    geom = (lo - 0.25 * (hi - lo) + rng.rand(b, p, 3) * 1.5 * (hi - lo)).astype(np.float32)
    geom[0, :30] = np.round(geom[0, :30] * 2.0) / 2.0  # some points on cell borders
    feats = _randn(b, p, c, seed=1)
    jq = jax.jit(lambda g: jpool.quantize_geometry(g, tuple(bx), tuple(dx), tuple(nx)))
    coords_j, valid_j = _np(jq(jnp.asarray(geom)))
    coords, valid = quantize_geometry(_t(geom), bx, dx, nx)
    assert coords.dtype == torch.int32
    assert np.array_equal(coords.numpy(), coords_j) and np.array_equal(valid.numpy(), valid_j)
    for axis in range(3):
        assert ((coords_j[..., axis] < 0) | (coords_j[..., axis] >= nx[axis])).any(), axis
    assert 0.2 < valid_j.mean() < 0.8

    cot = _randn(b, nx[0], nx[1], nx[2] * c, seed=2)

    def jfn(f):
        out = jpool.bev_pool(f, jnp.asarray(coords_j), jnp.asarray(valid_j), *nx)
        return out, (out * cot).sum()

    want, grad_j = jax.jit(lambda f: (jfn(f)[0], jax.grad(lambda g: jfn(g)[1])(f)))(
        jnp.asarray(feats))
    f = _t(feats).requires_grad_(True)
    got = bev_pool(f, coords, valid, *nx)
    (got * _t(cot)).sum().backward()
    assert tuple(got.shape) == (b, nx[0], nx[1], nx[2] * c)
    scale = np.abs(np.asarray(want)).max()
    assert np.abs(got.detach().numpy() - np.asarray(want)).max() <= 1e-6 * scale
    gj = np.asarray(grad_j)
    assert np.abs(f.grad.numpy() - gj).max() <= 1e-6 * np.abs(gj).max()
    assert not f.grad.numpy()[~valid.numpy()].any()


def _rig(b=2, n=6, seed=0, hw=(32, 64)):
    """The synthetic rig of n cameras, perturbed: rotated, shifted and with
    a post-transform (resize, crop, small rotation) per camera."""
    rots, trans, intr, prots, ptrans = JSyntheticBEVDataset(num_cams=n, image_size=hw).rig()
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(b):
        th = rng.uniform(-0.3, 0.3)
        rz = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]],
                      np.float32)
        pr = np.tile(np.eye(3, dtype=np.float32), (n, 1, 1))
        a = rng.uniform(-0.1, 0.1, n)
        s = rng.uniform(0.9, 1.1, n)
        pr[:, 0, 0], pr[:, 0, 1] = s * np.cos(a), s * np.sin(a)
        pr[:, 1, 0], pr[:, 1, 1] = -s * np.sin(a), s * np.cos(a)
        pt = np.zeros((n, 3), np.float32)
        pt[:, :2] = rng.uniform(-4, 4, (n, 2))
        out.append((np.einsum("ij,njk->nik", rz, rots).astype(np.float32),
                    (trans + rng.uniform(-0.5, 0.5, 3)).astype(np.float32), intr, pr, pt))
    return [np.stack(x) for x in zip(*out)]


@pytest.mark.parametrize("image_size,dbound", [((32, 64), (1.0, 9.0, 1.0)),
                                               ((256, 704), (1.0, 60.0, 0.5))])
def test_lss_geometry_matches_jax(image_size, dbound):
    feat = (image_size[0] // 8, image_size[1] // 8)
    frustum = jbev.frustum_grid(image_size, feat, dbound)
    assert np.array_equal(tbev.frustum_grid(image_size, feat, dbound), frustum)
    rig = _rig(hw=image_size)
    want = jax.jit(jbev.lss_geometry)(jnp.asarray(frustum), *map(jnp.asarray, rig))
    got = tbev.lss_geometry(_t(frustum), *map(_t, rig))
    assert got.dtype == torch.float32 and tuple(got.shape) == tuple(want.shape)
    # 1e-5 m per 10 m of range: 1e-5 at the smoke rig (points within 9 m),
    # the same relative precision (a few float32 ulps) at nuScenes' 60 m
    atol = 1e-5 * max(1.0, np.abs(np.asarray(want)).max() / 10.0)
    _close(got, want, atol=atol)
    # a bf16 rig is cast back to float32 for the geometry, as in JAX
    low = [x.astype(jnp.bfloat16) for x in map(jnp.asarray, rig)]
    want16 = jax.jit(jbev.lss_geometry)(jnp.asarray(frustum), *low)
    got16 = tbev.lss_geometry(_t(frustum), *(_t(r).to(torch.bfloat16) for r in rig))
    assert got16.dtype == torch.float32
    _close(got16, np.asarray(want16), atol=atol)


@pytest.mark.parametrize("preset", ["smoke_bev", "nuscenes_camera"])
def test_bev_grid_transform_matches_jax(preset):
    mc = get_config(preset).model
    g = 16 if preset == "smoke_bev" else 128
    x = _randn(2, g, g, 8, seed=3)
    cot = _randn(2, mc.bev_out_grid, mc.bev_out_grid, 8, seed=4)

    def jfn(x):
        return (jbev.bev_grid_transform(x, mc.bev_input_scope, mc.bev_output_scope) * cot).sum()

    want = jax.jit(lambda x: jbev.bev_grid_transform(x, mc.bev_input_scope,
                                                     mc.bev_output_scope))(jnp.asarray(x))
    grad_j = jax.jit(jax.grad(jfn))(jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    got = tbev.bev_grid_transform(xt, mc.bev_input_scope, mc.bev_output_scope)
    (got * _t(cot)).sum().backward()
    _close(got.detach(), want, atol=1e-6)
    _close(xt.grad, grad_j, atol=1e-6 * np.abs(np.asarray(grad_j)).max())


def _port(tmodule, variables):
    load_flax(tmodule, _np(variables["params"]), _np(variables.get("batch_stats")))
    return tmodule


def _stats_close(tmodule, mutated, rtol=1e-5):
    want = params_from_flax({}, _np(mutated))
    sd = tmodule.state_dict()
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        w = v.numpy()
        assert np.abs(sd[k].numpy() - w).max() <= rtol * max(np.abs(w).max(), 1e-6), k


@pytest.mark.parametrize("topk", [0, 3])
def test_lss_transform_matches_jax(topk):
    """The smoke rig (2 cameras at 32 x 64, features 4 x 8, 8 depth bins),
    training mode: the pooled, downsampled BEV and the BN statistics; with
    ``depth_topk`` the 3 most likely bins of each pixel."""
    kw = dict(out_channels=16, image_size=(32, 64), feature_size=(4, 8),
              xbound=(-8.0, 8.0, 0.5), ybound=(-8.0, 8.0, 0.5), dbound=(1.0, 9.0, 1.0),
              depth_topk=topk)
    jm = jbev.LSSTransform(**kw)
    feats = _randn(2, 2, 4, 8, 32, seed=5) * 3.0
    rig = _rig(n=2)
    args = (jnp.asarray(feats), *map(jnp.asarray, rig))
    v = _np(jax.jit(lambda: jm.init(jax.random.PRNGKey(0), *args))())
    want, mut = jax.jit(lambda v: jm.apply(v, *args, train=True, mutable=["batch_stats"]))(v)
    tm = _port(tbev.LSSTransform(32, **kw), v).train()
    got = tm(_t(feats), *map(_t, rig))
    assert tuple(got.shape) == (2, 16, 16, 16)
    _close(got.detach(), want, atol=1e-5 * np.abs(np.asarray(want)).max())
    _stats_close(tm, mut["batch_stats"])


def test_bev_backbone_and_necks_match_jax():
    """GeneralizedResNet on a 13 x 11 grid (odd: the stride-2 SAME pads 1
    before and 1 after, an even one 0 and 1), then LSSFPN; the camera FPN on
    three levels of a Swin-like pyramid; training mode, BN statistics."""
    blocks = ((1, 24, 2), (2, 32, 2), (1, 40, 1))
    x = _randn(2, 13, 11, 16, seed=6)
    jr = jbev.GeneralizedResNet(blocks=blocks)
    vr = _np(jax.jit(lambda: jr.init(jax.random.PRNGKey(1), jnp.asarray(x)))())
    outs, mut = jax.jit(lambda v: jr.apply(v, jnp.asarray(x), mutable=["batch_stats"]))(vr)
    tr = _port(tbev.GeneralizedResNet(16, blocks), vr).train()
    got = tr(_t(x))
    assert [tuple(o.shape[1:3]) for o in got] == [(7, 6), (4, 3), (4, 3)]
    for g, w in zip(got, outs):
        _close(g.detach(), w, atol=1e-5)
    _stats_close(tr, mut["batch_stats"])

    jn = jbev.LSSFPN(out_channels=24)
    xs = [np.asarray(o) for o in outs]
    vn = _np(jax.jit(lambda: jn.init(jax.random.PRNGKey(2), [jnp.asarray(a) for a in xs]))())
    want, mut = jax.jit(lambda v: jn.apply(v, [jnp.asarray(a) for a in xs],
                                           mutable=["batch_stats"]))(vn)
    tn = _port(tbev.LSSFPN((40, 24), 24), vn).train()
    _close(tn([_t(a) for a in xs]).detach(), want, atol=1e-5)
    _stats_close(tn, mut["batch_stats"])

    levels = [_randn(2, 9, 22, 32, seed=7), _randn(2, 5, 11, 64, seed=8),
              _randn(2, 3, 6, 128, seed=9)]
    jf = jbev.GeneralizedLSSFPN(48)
    lv = [jnp.asarray(a) for a in levels]
    vf = _np(jax.jit(lambda: jf.init(jax.random.PRNGKey(3), lv))())
    want, mut = jax.jit(lambda v: jf.apply(v, lv, mutable=["batch_stats"]))(vf)
    tf = _port(tbev.GeneralizedLSSFPN([32, 64, 128], 48), vf).train()
    got = tf([_t(a) for a in levels])
    assert len(got) == 2
    for g, w in zip(got, want):
        _close(g.detach(), w, atol=1e-5)
    _stats_close(tf, mut["batch_stats"])


def test_sigmoid_focal_loss_matches_jax():
    logits = _randn(3, 20, 20, seed=10) * 4.0
    target = (np.random.RandomState(11).rand(3, 20, 20) < 0.3).astype(np.float32)
    want = jax.jit(j_focal)(jnp.asarray(logits), jnp.asarray(target))
    grad_j = jax.jit(jax.grad(lambda x: j_focal(x, jnp.asarray(target)).sum()))(
        jnp.asarray(logits))
    x = _t(logits).requires_grad_(True)
    got = sigmoid_focal_loss(x, _t(target))
    got.sum().backward()
    _close(got.detach(), want, atol=1e-6)
    _close(x.grad, grad_j, atol=1e-6)


def test_bev_map_iou_matches_jax():
    rng = np.random.RandomState(12)
    scores = rng.rand(4, 3, 20, 20).astype(np.float32)
    gt = (rng.rand(4, 3, 20, 20) < 0.4).astype(np.float32)
    gt[:, 2] = 0.0  # a class with no ground truth
    got, want = bev_map_iou(scores, gt), j_bev_map_iou(scores, gt)
    assert got == want and set(got) == {"iou_class0", "iou_class1", "iou_class2", "mIoU"}


# --- the smoke_bev model -----------------------------------------------------------------

def _model_cfg(attn):
    mc = get_config("smoke_bev").model
    return mc if attn == "msda" else dataclasses.replace(mc, decoder_attn="window")


@functools.lru_cache(maxsize=4)
def _jax_init(attn):
    mc = _model_cfg(attn)
    jm = jconfig.build_model(jconfig.get_config("smoke_bev", {"model.decoder_attn": attn}).model)
    batch = _batch(1)
    variables = jax.jit(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)},
        *[jnp.asarray(batch[k]) for k in BEV_BATCH_KEYS], train=False))()
    # the msda points off whole pixels of the 20 x 20 output grid
    return mc, jm, _np(_off_grid(variables))


def _port_model(mc, variables):
    tm = build_model(mc, device="cpu")
    load_flax(tm, variables["params"], variables["batch_stats"])
    return tm


def _batch(b=2, seed=0):
    """b scenes of the smoke rig, augmented (the train pipeline), normalised."""
    from ddp_tpu_torch.data.bev_datasets import SyntheticBEVDataset, bev_batch_iterator

    ds = SyntheticBEVDataset(num_cams=2, image_size=(32, 64), out_grid=20, num_classes=3,
                             scope=8.0, length=16)
    return next(bev_batch_iterator(ds, b, seed=seed))


def _draws(b=2, g=16, c=32):
    rng = np.random.RandomState(1)
    return (rng.uniform(0.0, 0.999, b).astype(np.float32),
            rng.randn(b, g, g, c).astype(np.float32))


class _FixedRandom:
    """Stands in for ``jax`` in ``ddp_tpu.core.diffusion``: its t and noise
    draws return the test's arrays (the noise in the dtype asked for)."""

    def __init__(self, t, noise):
        self.random = types.SimpleNamespace(
            split=jax.random.split,
            uniform=lambda key, shape, minval=0.0, maxval=1.0: jnp.asarray(t),
            normal=lambda key, shape, dtype=jnp.float32: jnp.asarray(noise).astype(dtype))


def _jax_loss_and_grads(jm, variables, batch, t, noise, mixed_precision, *more):
    """The JAX model's training loss, gradients and updated BN statistics at
    the test's t and noise; ``mixed_precision``: ``ddp_tpu/train/state.py``'s
    bf16 policy (bf16 parameters and float32 batch values). Given ``more``
    batches, a list of those triples, one per batch, from one compiled step."""
    low = (lambda x: x.astype(jnp.bfloat16) if x.dtype == jnp.float32 else x) \
        if mixed_precision else (lambda x: x)

    def run(params, stats, args):
        def loss_fn(p):
            (loss, _), mut = jm.apply(
                {"params": jax.tree_util.tree_map(low, p), "batch_stats": stats},
                *[low(a) for a in args], train=True, mutable=["batch_stats"],
                rngs={"diffusion": jax.random.PRNGKey(3), "dropout": jax.random.PRNGKey(4)})
            return loss.astype(jnp.float32), mut["batch_stats"]

        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdiff, "jax", _FixedRandom(t, noise))
        step = jax.jit(run)
        out = [step(variables["params"], variables["batch_stats"],
                    [jnp.asarray(b[k]) for k in BEV_BATCH_KEYS]) for b in (batch, *more)]
    out = [(float(loss), _np(grads), _np(stats)) for (loss, stats), grads in out]
    return out if more else out[0]


@pytest.mark.parametrize("attn", ["msda", "window"])
def test_bev_loss_and_grads_match_jax(attn):
    mc, jm, variables = _jax_init(attn)
    batch = _batch()
    t, noise = _draws()
    loss_j, grads_j, stats_j = _jax_loss_and_grads(jm, variables, batch, t, noise, False)
    tm = _port_model(mc, variables).train()
    loss, logs = tm(*[_t(batch[k]) for k in BEV_BATCH_KEYS], t=_t(t), noise=_t(noise))
    loss.backward()
    np.testing.assert_allclose(loss.item(), loss_j, rtol=1e-5)
    assert set(logs) == {"loss", "map.drivable_area.focal", "map.ped_crossing.focal",
                         "map.walkway.focal"}
    want = params_from_flax(grads_j)
    named = dict(tm.named_parameters())
    assert set(want) == set(named)
    for name, p in named.items():
        g = p.grad.numpy() if p.grad is not None else np.zeros(p.shape, np.float32)
        w = want[name].numpy()
        tol = 1e-3 * np.abs(w).max() + 1e-6
        assert np.abs(g - w).max() <= tol, (name, np.abs(g - w).max(), tol)
    _stats_close(tm, stats_j)


# the modules JAX runs in float32 under the bf16 policy (t, and so the
# corrupted latent, stay float32 and promote them); the rest run in bf16
F32_UNDER_BF16 = ("transform.", "time_mlp.", "decode_head.", "embedding_table.")
# the bf16-run encoder's modules, held group by group
ENCODER_GROUPS = ("backbone.", "camera_neck.", "vtransform.", "bev_backbone.", "bev_neck.")


def _bf16_rig(batch):
    """The batch as the bf16 policy's geometry sees it: the rig rounded to
    bf16 (``lss_geometry`` casts it back to float32)."""
    out = dict(batch)
    for k in RIG:
        if batch[k].dtype == np.float32:
            out[k] = np.asarray(jnp.asarray(batch[k]).astype(jnp.bfloat16).astype(jnp.float32))
    return out


def _port_bf16_grads(mc, variables, batch, t, noise):
    tm = _port_model(mc, variables)
    state = TrainState(tm, toptim.make_optimizer(get_config("smoke_bev").optim, tm),
                       torch.Generator().manual_seed(0))
    tb = {k: _t(v) for k, v in batch.items()}
    tb.update(t=_t(t), noise=_t(noise))
    grads, logs = make_train_step(mixed_precision=True, batch_keys=BEV_BATCH_KEYS).grads(
        state, tb)
    return logs["loss"].item(), {n: g.numpy() for n, g in zip(state.optimizer.names, grads)}


@functools.lru_cache(maxsize=1)
def _bf16_case():
    """On one batch: the port's bf16 step's loss and gradients
    (``make_train_step(mixed_precision=True)`` with the BEV batch keys, from
    JAX's init); JAX's bf16-policy loss and gradients; JAX's float32
    gradients; and JAX's float32 gradients on the bf16-rounded rig, the exact
    gradients of the function the bf16 policy computes."""
    mc, jm, variables = _jax_init("msda")
    batch = _batch()
    t, noise = _draws()
    loss16, want16, _ = _jax_loss_and_grads(jm, variables, batch, t, noise, True)
    (_, want32, _), (_, exact, _) = _jax_loss_and_grads(jm, variables, batch, t, noise, False,
                                                        _bf16_rig(batch))
    loss, got = _port_bf16_grads(mc, variables, batch, t, noise)
    arrays = [{n: v.numpy() for n, v in params_from_flax(w).items()}
              for w in (want16, want32, exact)]
    return (loss, loss16, got, *arrays)


def _l2(a, b, names):
    return float(np.sqrt(sum(((a[n] - b[n]).astype(np.float64) ** 2).sum() for n in names)))


def _vec(grads, prefix):
    return np.concatenate([grads[n].ravel().astype(np.float64)
                           for n in sorted(grads) if n.startswith(prefix)])


def _cos(a, b):
    return float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-300))


def _encoder_faults(got, want16, exact, margin=0.05):
    """The encoder groups where ``got`` (bf16-run gradients) fails the bf16
    encoder criterion: its cosine with ``exact`` at least JAX's bf16
    gradients' less ``margin``, and its L2 norm within 1.25x either way of
    theirs."""
    bad = []
    for group in ENCODER_GROUPS:
        g, w, e = _vec(got, group), _vec(want16, group), _vec(exact, group)
        ratio = np.linalg.norm(g) / np.linalg.norm(w)
        if not (_cos(g, e) >= _cos(w, e) - margin and 0.8 <= ratio <= 1.25):
            bad.append((group, _cos(g, e), _cos(w, e), ratio))
    return bad


def test_bev_bf16_step_matches_jax():
    """PERF.md §2's bf16 limits (``test_bf16_train_step_matches_jax``'s): the
    loss within 1e-2 relative; each gradient of the modules JAX runs in
    float32 under the policy (fusion conv, time MLP, decoder, embedding
    table) within 2^-2 · max|g| of JAX's bf16 gradient, the median within
    2^-5, and no further from JAX's f32 gradient than twice JAX's bf16 one
    plus 2^-5 · max|g|. The camera and BEV encoder run in bf16, where JAX's
    own bf16 gradients miss those limits against the exact gradients of the
    same function (the test below). There, in each of its five module
    groups, the port's bf16 gradients must be at least as well aligned
    (cosine) with the exact gradients as JAX's bf16 gradients are, less
    0.05, with an L2 norm within 1.25x of theirs; JAX's own cosine must be
    at least 0.7. The exact gradients are JAX's float32 ones on the
    bf16-rounded rig: the rig and masks are bf16 in both packages and the
    geometry float32 again."""
    loss, loss16, got, want16, want32, exact = _bf16_case()
    assert abs(loss - loss16) <= 1e-2 * abs(loss16)
    head = [n for n in got if n.startswith(F32_UNDER_BF16)]
    rel = []
    for name in head:
        g, w16, w32 = got[name], want16[name], want32[name]
        d = np.abs(g - w16).max()
        rel.append(d / max(np.abs(w16).max(), 1e-30))
        assert d <= 2.0 ** -2 * np.abs(w16).max(), (name, d)
        port_err, ref_err = np.abs(g - w32).max(), np.abs(w16 - w32).max()
        assert port_err <= 2.0 * ref_err + 2.0 ** -5 * np.abs(w32).max(), (name, port_err,
                                                                            ref_err)
    assert np.median(rel) <= 2.0 ** -5, np.median(rel)
    encoder = [n for n in got if not n.startswith(F32_UNDER_BF16)]
    assert len(head) + len(encoder) == len(got) and len(encoder) > 100
    assert all(n.startswith(ENCODER_GROUPS) for n in encoder)
    for group in ENCODER_GROUPS:
        assert _cos(_vec(want16, group), _vec(exact, group)) >= 0.7, group
    assert _encoder_faults(got, want16, exact) == []


def _rig_left_float32(mc, variables):
    """The port's bf16 step with a planted policy fault: the rig is not cast
    to bf16 (its 3 x 3 and 3-vector values pass through as float32)."""
    batch = _batch()
    t, noise = _draws()
    cast = tstep._to_bf16
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tstep, "_to_bf16",
                   lambda x: x if x.shape[-2:] == (3, 3) or x.dim() == 3 else cast(x))
        return _port_bf16_grads(mc, variables, batch, t, noise)[1]


@pytest.mark.parametrize("fault", ["zeroed", "sign_flipped", "half_scale",
                                   "backbone_zeroed", "bev_backbone_flipped",
                                   "rig_left_float32"])
def test_bev_bf16_encoder_check_rejects_planted_faults(fault):
    """The bf16 encoder criterion of ``test_bev_bf16_step_matches_jax``
    rejects a wrong gradient: zeroed, sign-flipped or halved over the whole
    encoder, zeroed or flipped in one group, or the port's step with the rig
    left in float32 (a wrong policy: the geometry then differs from the one
    the exact gradients are taken at)."""
    _, _, got, want16, _, exact = _bf16_case()
    if fault == "rig_left_float32":
        mc, _, variables = _jax_init("msda")
        bad = _rig_left_float32(mc, variables)
    else:
        scale = {"zeroed": 0.0, "sign_flipped": -1.0, "half_scale": 0.5,
                 "backbone_zeroed": 0.0, "bev_backbone_flipped": -1.0}[fault]
        group = {"backbone_zeroed": "backbone.", "bev_backbone_flipped": "bev_backbone."}.get(
            fault, "")
        bad = {n: scale * g if n.startswith(group) and not n.startswith(F32_UNDER_BF16)
               else g for n, g in got.items()}
    assert _encoder_faults(got, want16, exact) == []
    assert _encoder_faults(bad, want16, exact) != []


def test_bev_bf16_encoder_grads_reference_discrepancy():
    """Reference behaviour: under the bf16 policy JAX's gradients of the
    camera and BEV encoder (Swin, camera FPN, LSS, BEV ResNet and FPN; 121
    tensors at smoke_bev) miss PERF.md §2's bf16 limits against themselves,
    for two reasons of about equal size (ROADMAP.md queue 3):
      - the policy's bf16 rig moves the geometry: JAX's float32 gradients on
        the bf16-rounded rig are 0.82 of the f32 gradients' L2 away from
        those on the float32 rig;
      - bf16 arithmetic on that same rig puts JAX's bf16 gradients 0.59 of
        that L2 away from its exact gradients (the BEV FPN next to the head
        0.21, Swin furthest from it 0.72), with a median max|Δ| per tensor
        of over a quarter of max|g|.
    The head, run in float32, agrees to 0.035."""
    _, _, got, want16, want32, exact = _bf16_case()
    encoder = [n for n in got if not n.startswith(F32_UNDER_BF16)]
    head = [n for n in got if n.startswith(F32_UNDER_BF16)]
    zero = {n: np.zeros_like(v) for n, v in want32.items()}
    assert _l2(exact, want32, encoder) > 0.5 * _l2(want32, zero, encoder)
    assert _l2(want16, exact, encoder) > 0.4 * _l2(exact, zero, encoder)
    per = [np.abs(want16[n] - exact[n]).max() / max(np.abs(exact[n]).max(), 1e-30)
           for n in encoder]
    assert np.median(per) > 0.25, np.median(per)
    assert _l2(want16, want32, head) < 0.1 * _l2(want32, zero, head)


@functools.lru_cache(maxsize=2)
def _jax_rollouts():
    """JAX's sample, per-hypothesis rollout and sample_with_uncertainty on one
    batch, each with the initial noise it drew (the first denoise_logits
    call's latent, captured)."""
    mc, jm, variables = _jax_init("msda")
    batch = _batch(seed=5)
    rig = [jnp.asarray(batch[k]) for k in RIG]

    def run(variables, rig):
        out = {}
        for method in ("sample", "_rollout_hypotheses", "sample_with_uncertainty"):
            cap = {}

            def capture(next_fun, args, kwargs, context):
                if context.method_name == "denoise_logits" and "noise" not in cap:
                    cap["noise"] = args[1]
                return next_fun(*args, **kwargs)

            with fnn.intercept_methods(capture):
                res = jm.apply(variables, *rig, method=getattr(jm, method),
                               rngs={"diffusion": jax.random.PRNGKey(7)})
            out[method] = (res, cap["noise"])
        return out

    return mc, variables, batch, _np(jax.jit(run)(variables, rig))


def test_bev_sample_matches_jax():
    mc, variables, batch, jout = _jax_rollouts()
    tm = _port_model(mc, variables)
    rig = [_t(batch[k]) for k in RIG]
    want, noise = jout["sample"]
    got = tm.sample(*rig, noise=_t(noise))
    assert tuple(got.shape) == (2, 20, 20, 3) and tuple(noise.shape) == (4, 16, 16, 32)
    _close(got, want, atol=1e-4)
    assert 0.0 <= got.min() and got.max() <= 1.0
    want_h, noise_h = jout["_rollout_hypotheses"]
    with torch.no_grad():
        got_h = tm._rollout_hypotheses(*rig, noise=_t(noise_h))
    assert got_h.shape[0] == mc.diffusion.randsteps
    _close(got_h, want_h, atol=1e-4)
    with pytest.raises(ValueError, match="noise shape"):
        tm.sample(*rig, noise=_t(noise[:2]))


def test_bev_sample_with_uncertainty_matches_jax():
    mc, variables, batch, jout = _jax_rollouts()
    tm = _port_model(mc, variables)
    (want, want_unc), noise = jout["sample_with_uncertainty"]
    got, unc = tm.sample_with_uncertainty(*[_t(batch[k]) for k in RIG], noise=_t(noise))
    _close(got, want, atol=1e-4)
    assert set(unc) == {"variance", "entropy"}
    for key in unc:
        assert tuple(unc[key].shape) == (2, 20, 20)
        _close(unc[key], want_unc[key], atol=1e-4)
    assert unc["variance"].max() > 0  # the hypotheses differ


def test_bridge_covers_nuscenes_camera():
    """Every flax leaf of nuscenes_camera's model (6 cameras of 256 x 704,
    Swin-T, the window decoder) maps to a torch entry and fills every one.
    Shapes only: jax.eval_shape and the meta device."""
    cfg = get_config("nuscenes_camera")
    jm = jconfig.build_model(jconfig.get_config("nuscenes_camera").model)
    mc = cfg.model
    n, (h, w) = mc.bev_num_cams, mc.bev_image_size
    shapes = {"image": (1, n, h, w, 3), "cam2lidar_rots": (1, n, 3, 3),
              "cam2lidar_trans": (1, n, 3), "intrins": (1, n, 3, 3), "post_rots": (1, n, 3, 3),
              "post_trans": (1, n, 3), "label": (1, 200, 200, 6)}
    abstract = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)},
        *[jnp.zeros(shapes[k]) for k in BEV_BATCH_KEYS], train=False))
    leaves = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.zeros((), s.dtype), s.shape), abstract)
    sd = params_from_flax(leaves["params"], leaves["batch_stats"])
    model = build_model(mc, device="meta")
    check_complete(model, sd)
    assert tuple(sd["vtransform.depthnet.weight"].shape) == (118 + 80, 256, 1, 1)
    assert tuple(sd["embedding_table.weight"].shape) == (7, 256)
    assert model.decode_head.attn_type == "window"
