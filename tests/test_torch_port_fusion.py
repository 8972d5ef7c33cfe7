"""The port's camera + lidar BEV model (``ddp_tpu_torch/models/bev_fusion.py``)
against the JAX package's ``DDPBEVFusion``, on the CPU, at ``smoke_fusion``
(2 cameras of 32 x 64, a 24-channel lidar branch at capacities
512/256/128/96/96, a 32-d msda decoder), with JAX's init carried across by
``convert.py`` (the msda points moved off whole pixels, as in
``test_torch_port_convnext.py``). The JAX side is jitted; the batch is 2
scenes of the synthetic fusion rig (``fusion_batch_iterator``, bitwise
JAX's), rulebooks included. PERF.md §2's limits:

  - f32: the loss with fixed t and noise within 1e-5 relative, every
    gradient (the sparse conv kernels and masked BN included) within
    1e-3·max|g| + 1e-6, the BN statistics (the masked ones too) within 1e-5
    relative (a running mean relative to its channels' running std where
    that is larger: ``_stats_close_scaled``); the folded rulebooks against
    JAX's fold.
  - bf16 (``make_train_step(mixed_precision=True)``): the loss within 1e-2
    relative; the float32-run head to the bf16 limits of
    ``test_bev_bf16_step_matches_jax``; the bf16-run encoder group by group
    (the five camera-BEV groups, the lidar branch and the fuser) in cosine
    with the exact gradients (JAX's f32 gradients on the bf16-rounded
    inputs) and in L2 norm against JAX's bf16 gradients. A zeroed lidar
    gradient, or one lidar layer's flipped, fails that criterion.
  - ``sample`` (step-accumulated scores of the 2-step rollout, from the
    initial noise JAX drew), the per-hypothesis rollout and
    ``sample_with_uncertainty`` at 2 randsteps, within 1e-4.
  - Every flax leaf of ``smoke_fusion`` and ``nuscenes_fusion`` maps to the
    port's state_dict; ``build_model`` builds the fusion model on the card
    unless told otherwise.
"""
import dataclasses
import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ddp_tpu.core.diffusion as jdiff
from ddp_tpu import config as jconfig
from ddp_tpu_torch.config import build_model, get_config
from ddp_tpu_torch.convert import check_complete, load_flax, params_from_flax
from ddp_tpu_torch.data.bev_datasets import (FUSION_BATCH_KEYS, SyntheticFusionDataset,
                                             fusion_batch_iterator)
from ddp_tpu_torch.models.bev_fusion import DDPBEVFusion
from ddp_tpu_torch.train import optim as toptim
from ddp_tpu_torch.train.step import TrainState, make_train_step, tree_map
from test_torch_port_bev import ENCODER_GROUPS, F32_UNDER_BF16, _close, _cos, _FixedRandom, _vec
from test_torch_port_convnext import _off_grid

ARGS = FUSION_BATCH_KEYS[:-1]
FUSION_GROUPS = ENCODER_GROUPS + ("lidar_", "fuser_conv.")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return tree_map(lambda x: torch.from_numpy(np.array(x)), a)


def _j(a):
    return jax.tree_util.tree_map(jnp.asarray, a)


def _batch(b=2, seed=0):
    mc = get_config("smoke_fusion").model
    ds = SyntheticFusionDataset(sparse_shape=mc.bev_sparse_shape, caps=mc.bev_voxel_caps,
                                voxel_size=mc.bev_voxel_size, num_cams=2, image_size=(32, 64),
                                out_grid=20, num_classes=3, scope=8.0, length=16)
    return next(fusion_batch_iterator(ds, b, seed=seed))


def _model_cfg(randsteps=1):
    mc = get_config("smoke_fusion").model
    return dataclasses.replace(mc, diffusion=dataclasses.replace(mc.diffusion,
                                                                 randsteps=randsteps))


def _jax_model(randsteps=1):
    jmc = jconfig.get_config("smoke_fusion").model
    return jconfig.build_model(dataclasses.replace(
        jmc, diffusion=dataclasses.replace(jmc.diffusion, randsteps=randsteps)))


@functools.lru_cache(maxsize=1)
def _jax_init():
    jm = _jax_model()
    batch = jax.tree_util.tree_map(lambda x: x[:1], _batch())
    variables = jax.jit(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)}, *[_j(batch[k]) for k in FUSION_BATCH_KEYS],
        train=False))()
    return _np(_off_grid(variables))


def _port_model(variables, randsteps=1):
    tm = build_model(_model_cfg(randsteps), device="cpu")
    load_flax(tm, variables["params"], variables["batch_stats"])
    return tm


def _draws(b=2, g=16, c=32):
    rng = np.random.RandomState(1)
    return (rng.uniform(0.0, 0.999, b).astype(np.float32),
            rng.randn(b, g, g, c).astype(np.float32))


def _bf16_inputs(batch):
    """The batch as the bf16 policy sees it: every float value rounded to bf16."""
    def rnd(x):
        if x.dtype != np.float32:
            return x
        return np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    return jax.tree_util.tree_map(rnd, batch)


@functools.lru_cache(maxsize=1)
def _jax_grads():
    """JAX's loss, gradients and BN statistics at the test's t and noise:
    the bf16 policy's, the float32 ones, and the float32 ones on the
    bf16-rounded inputs (one compiled step for the two float32 runs)."""
    jm, variables = _jax_model(), _jax_init()
    batch = _batch()
    t, noise = _draws()

    def run(params, stats, args, mixed):
        low = (lambda x: x.astype(jnp.bfloat16) if x.dtype == jnp.float32 else x) \
            if mixed else (lambda x: x)

        def loss_fn(p):
            (loss, _), mut = jm.apply(
                {"params": jax.tree_util.tree_map(low, p), "batch_stats": stats},
                *jax.tree_util.tree_map(low, args), train=True, mutable=["batch_stats"],
                rngs={"diffusion": jax.random.PRNGKey(3), "dropout": jax.random.PRNGKey(4)})
            return loss.astype(jnp.float32), mut["batch_stats"]

        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdiff, "jax", _FixedRandom(t, noise))
        for name, b, mixed in (("f32", batch, False), ("exact", _bf16_inputs(batch), False),
                               ("bf16", batch, True)):
            step = out.get("_f32step") if not mixed else None
            if step is None:
                step = jax.jit(functools.partial(run, mixed=mixed))
                if not mixed:
                    out["_f32step"] = step
            (loss, stats), grads = step(variables["params"], variables["batch_stats"],
                                        [_j(b[k]) for k in FUSION_BATCH_KEYS])
            out[name] = (float(loss), _np(grads), _np(stats))
    del out["_f32step"]
    return batch, t, noise, out


def test_fold_matches_jax():
    """The batch folded into the voxel axis: each sample's rows shifted by
    its input level's capacity, -1 kept (``bev_fusion.py:144-160``)."""
    batch = _batch()
    rb = batch["rulebooks"]
    folded = DDPBEVFusion.fold_rulebooks(_t(rb), batch["voxel_feats"].shape[1])
    caps = {k: rb[k].shape[-1] for k in rb if k not in ("down_coords", "down_valid")}
    cap0 = batch["voxel_feats"].shape[1]
    in_cap = {"subm1": cap0, "spconv2": cap0, "subm2": caps["spconv2"],
              "spconv3": caps["spconv2"], "subm3": caps["spconv3"],
              "spconv4": caps["spconv3"], "subm4": caps["spconv4"], "down": caps["spconv4"]}
    assert set(folded) == set(in_cap)
    for key, cap in in_cap.items():
        g = rb[key]
        offs = (np.arange(2, dtype=g.dtype) * cap)[:, None, None]
        want = np.moveaxis(np.where(g >= 0, g + offs, -1), 0, 1).reshape(g.shape[1], -1)
        assert np.array_equal(folded[key].numpy(), want), key


def test_fusion_loss_and_grads_match_jax():
    batch, t, noise, jout = _jax_grads()
    loss_j, grads_j, stats_j = jout["f32"]
    tm = _port_model(_jax_init()).train()
    loss, logs = tm(*[_t(batch[k]) for k in FUSION_BATCH_KEYS], t=_t(t), noise=_t(noise))
    loss.backward()
    np.testing.assert_allclose(loss.item(), loss_j, rtol=1e-5)
    assert set(logs) == {"loss", "map.drivable_area.focal", "map.ped_crossing.focal",
                         "map.walkway.focal"}
    want = params_from_flax(grads_j)
    named = dict(tm.named_parameters())
    assert set(want) == set(named)
    assert sum(n.startswith("lidar_") for n in named) == 36
    for name, p in named.items():
        g = p.grad.numpy() if p.grad is not None else np.zeros(p.shape, np.float32)
        w = want[name].numpy()
        tol = 1e-3 * np.abs(w).max() + 1e-6
        assert np.abs(g - w).max() <= tol, (name, np.abs(g - w).max(), tol)
    assert np.abs(named["lidar_conv_input.kernel"].grad.numpy()).max() > 0
    _stats_close_scaled(tm, stats_j)
    assert tm.lidar_enc3_2.bn.mean.abs().max() > 0  # the masked statistics moved


def _stats_close_scaled(tmodule, stats, rtol=1e-5):
    """Every BN statistic within ``rtol`` relative, a running mean relative
    to the larger of its own max and its channels' running std: behind the
    fuser's BN the BEV ResNet's first means are about 1 % of the
    activations' spread, so float32 rounding of the activations (about 1e-7
    of their scale, summed in another order by XLA and ATen) is 1e-5 of the
    mean itself."""
    want = params_from_flax({}, stats)
    sd = tmodule.state_dict()
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        w = v.numpy()
        scale = max(np.abs(w).max(), 1e-6)
        for mean, var in (("running_mean", "running_var"), ("bn.mean", "bn.var")):
            if k.endswith(mean):
                scale = max(scale, np.sqrt(want[k[:-len(mean)] + var].numpy()).max())
        assert np.abs(sd[k].numpy() - w).max() <= rtol * scale, k


def _port_bf16_grads(variables, batch, t, noise):
    tm = _port_model(variables)
    state = TrainState(tm, toptim.make_optimizer(get_config("smoke_fusion").optim, tm),
                       torch.Generator().manual_seed(0))
    tb = {k: _t(v) for k, v in batch.items()}
    tb.update(t=_t(t), noise=_t(noise))
    grads, logs = make_train_step(mixed_precision=True, batch_keys=FUSION_BATCH_KEYS).grads(
        state, tb)
    return logs["loss"].item(), {n: g.numpy() for n, g in zip(state.optimizer.names, grads)}


@functools.lru_cache(maxsize=1)
def _bf16_case():
    batch, t, noise, jout = _jax_grads()
    loss, got = _port_bf16_grads(_jax_init(), batch, t, noise)
    arrays = [{n: v.numpy() for n, v in params_from_flax(jout[k][1]).items()}
              for k in ("bf16", "f32", "exact")]
    return (loss, jout["bf16"][0], got, *arrays)


def _encoder_faults(got, want16, exact, margin=0.05):
    """The groups where ``got`` fails the bf16 encoder criterion (as
    ``test_torch_port_bev._encoder_faults``, over the fusion groups)."""
    bad = []
    for group in FUSION_GROUPS:
        g, w, e = _vec(got, group), _vec(want16, group), _vec(exact, group)
        ratio = np.linalg.norm(g) / np.linalg.norm(w)
        if not (_cos(g, e) >= _cos(w, e) - margin and 0.8 <= ratio <= 1.25):
            bad.append((group, _cos(g, e), _cos(w, e), ratio))
    return bad


def test_fusion_bf16_step_matches_jax():
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
    assert len(head) + len(encoder) == len(got)
    assert all(n.startswith(FUSION_GROUPS) for n in encoder)
    for group in FUSION_GROUPS:
        assert _cos(_vec(want16, group), _vec(exact, group)) >= 0.7, group
    assert _encoder_faults(got, want16, exact) == []


@pytest.mark.parametrize("fault", ["lidar_zeroed", "lidar_layer_flipped"])
def test_fusion_bf16_encoder_check_rejects_planted_faults(fault):
    """The criterion of ``test_fusion_bf16_step_matches_jax`` rejects the
    port's bf16 gradients with the whole lidar branch's zeroed, or with one
    lidar layer's (``lidar_enc1_0``) sign flipped."""
    _, _, got, want16, _, exact = _bf16_case()
    prefix, scale = {"lidar_zeroed": ("lidar_", 0.0),
                     "lidar_layer_flipped": ("lidar_enc1_0.", -1.0)}[fault]
    bad = {n: scale * g if n.startswith(prefix) else g for n, g in got.items()}
    assert _encoder_faults(got, want16, exact) == []
    assert [f[0] for f in _encoder_faults(bad, want16, exact)] == ["lidar_"]


@functools.lru_cache(maxsize=1)
def _jax_rollouts():
    """JAX's sample, per-hypothesis rollout and sample_with_uncertainty at 2
    randsteps, each with the initial noise it drew (captured)."""
    jm, variables = _jax_model(randsteps=2), _jax_init()
    batch = _batch(seed=5)
    args = [_j(batch[k]) for k in ARGS]

    def run(variables, args):
        out = {}
        for method in ("sample", "_rollout_hypotheses", "sample_with_uncertainty"):
            cap = {}

            def capture(next_fun, a, kwargs, context):
                if context.method_name == "denoise_logits" and "noise" not in cap:
                    cap["noise"] = a[1]
                return next_fun(*a, **kwargs)

            with fnn.intercept_methods(capture):
                res = jm.apply(variables, *args, method=getattr(jm, method),
                               rngs={"diffusion": jax.random.PRNGKey(7)})
            out[method] = (res, cap["noise"])
        return out

    return batch, _np(jax.jit(run)(variables, args))


def test_fusion_sample_matches_jax():
    batch, jout = _jax_rollouts()
    tm = _port_model(_jax_init(), randsteps=2)
    args = [_t(batch[k]) for k in ARGS]
    want, noise = jout["sample"]
    got = tm.sample(*args, noise=_t(noise))
    assert tuple(got.shape) == (2, 20, 20, 3) and tuple(noise.shape) == (4, 16, 16, 32)
    _close(got, want, atol=1e-4)
    want_h, noise_h = jout["_rollout_hypotheses"]
    with torch.no_grad():
        got_h = tm._rollout_hypotheses(*args, noise=_t(noise_h))
    assert got_h.shape[0] == 2
    _close(got_h, want_h, atol=1e-4)


def test_fusion_sample_with_uncertainty_matches_jax():
    batch, jout = _jax_rollouts()
    tm = _port_model(_jax_init(), randsteps=2)
    (want, want_unc), noise = jout["sample_with_uncertainty"]
    got, unc = tm.sample_with_uncertainty(*[_t(batch[k]) for k in ARGS], noise=_t(noise))
    _close(got, want, atol=1e-4)
    assert set(unc) == {"variance", "entropy"}
    for key in unc:
        assert tuple(unc[key].shape) == (2, 20, 20)
        _close(unc[key], want_unc[key], atol=1e-4)
    assert unc["variance"].max() > 0


@pytest.mark.parametrize("preset", ["smoke_fusion", "nuscenes_fusion"])
def test_bridge_covers_the_fusion_model(preset):
    """Every flax leaf maps to a torch entry and fills every one (shapes
    only: jax.eval_shape and the meta device)."""
    mc = get_config(preset).model
    jm = jconfig.build_model(jconfig.get_config(preset).model)
    n, (h, w) = mc.bev_num_cams, mc.bev_image_size
    caps = mc.bev_voxel_caps
    rb = {k: (1, 27, c) for k, c in zip(("subm1", "spconv2", "subm2", "spconv3", "subm3",
                                         "spconv4", "subm4"),
                                        (caps[0], caps[1], caps[1], caps[2], caps[2], caps[3],
                                         caps[3]))}
    rb["down"] = (1, 3, caps[4])
    shapes = {"image": (1, n, h, w, 3), "cam2lidar_rots": (1, n, 3, 3),
              "cam2lidar_trans": (1, n, 3), "intrins": (1, n, 3, 3), "post_rots": (1, n, 3, 3),
              "post_trans": (1, n, 3), "voxel_feats": (1, caps[0], 5),
              "label": (1, mc.bev_out_grid, mc.bev_out_grid, mc.num_classes)}
    zeros = {k: jnp.zeros(s) for k, s in shapes.items()}
    zeros["rulebooks"] = {k: jnp.zeros(s, jnp.int32) for k, s in rb.items()}
    zeros["rulebooks"]["down_coords"] = jnp.zeros((1, caps[4], 3), jnp.int32)
    zeros["rulebooks"]["down_valid"] = jnp.zeros((1, caps[4]), bool)
    abstract = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)}, *[zeros[k] for k in FUSION_BATCH_KEYS],
        train=False))
    leaves = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.zeros((), s.dtype), s.shape), abstract)
    sd = params_from_flax(leaves["params"], leaves["batch_stats"])
    model = build_model(mc, device="meta")
    check_complete(model, sd)
    cl = mc.bev_lidar_channels
    assert tuple(sd["lidar_conv_out.kernel"].shape) == (3, 64, cl)
    assert tuple(sd["lidar_conv_input.kernel"].shape) == (27, 5, 16)
    assert tuple(sd["lidar_enc3_2.bn.var"].shape) == (64,)
    assert tuple(sd["fuser_conv.conv.weight"].shape) == (
        mc.embed_dims, mc.bev_lss_channels + 2 * cl, 3, 3)


def test_build_model_fusion():
    model = build_model(get_config("smoke_fusion").model, device="cpu", seed=3)
    assert isinstance(model, DDPBEVFusion) and not model.training
    assert not any(m.training for m in model.modules())
    k = model.lidar_enc1_0.kernel
    assert abs(k.std().item() * (27 * 16) ** 0.5 - 1.0) < 0.1  # N(0, 1/(K·Cin))
    assert (model.lidar_enc1_0.bn.var == 1).all() and (model.lidar_enc1_0.bn.mean == 0).all()
    big = build_model(get_config("nuscenes_fusion").model, device="meta")
    assert big.decode_head.attn_type == "window" and big.lidar_dense_hw == 128
    assert big.bev_backbone.stage0_block0.conv1.in_channels == 256
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_model(get_config("smoke_fusion").model)
