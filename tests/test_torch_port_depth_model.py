"""The port's depther (``ddp_tpu_torch/models/depther.py``) as a whole
against the JAX package's, on the CPU (split from
``test_torch_port_depth.py``, which holds its modules, presets and train
steps, and whose helpers this file imports). The JAX side is jitted; inputs
are seeded numpy.

  - A tiny depther (nano Swin, 64-d msda decoder of 2 layers, 64 x 64
    crops), JAX's init carried across by ``convert.py``: the f32 training
    loss with fixed t and noise within 1e-5 relative and every gradient within
    1e-3 · max|g| + 1e-6; the bf16 step at
    ``test_bf16_train_step_matches_jax``'s tolerances; ``sample``, the
    per-hypothesis rollout (randsteps 2) and ``sample_with_uncertainty``'s
    std and 10/90 % interval within 1e-4 m from the initial noise JAX drew.
  - Every flax leaf of nyu_swin_t's depther maps to the port's state_dict.
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

from ddp_tpu.models import depther as jdepther
from ddp_tpu_torch.config import build_model, get_config
from ddp_tpu_torch.convert import load_flax, params_from_flax
from ddp_tpu_torch.train import optim as toptim
from ddp_tpu_torch.train.step import TrainState, make_train_step
from test_torch_port_depth import (HW, _close, _depth_maps, _jax_model, _model_cfg, _np,
                                   _randn, _t)


# --- the tiny depther -----------------------------------------------------------------

@functools.lru_cache(maxsize=4)
def _jax_init(variant, act):
    mc = _model_cfg(variant, act)
    jm = _jax_model(mc)
    variables = jax.jit(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)},
        jnp.zeros((1,) + HW + (3,)), jnp.ones((1,) + HW), train=False))()
    return mc, jm, _np(variables)


def _port_model(mc, variables):
    tm = build_model(dataclasses.replace(mc, drop_path_rate=0.0), device="cpu")
    load_flax(tm, variables["params"])
    return tm


def _draws(mc, b=2):
    h, w = HW[0] // 4, HW[1] // 4
    rng = np.random.RandomState(1)
    return (rng.uniform(0.0, 0.999, b).astype(np.float32),
            rng.randn(b, h, w, 1).astype(np.float32))


class _FixedRandom:
    """Stands in for ``jax`` in the JAX depther's module: its t and noise
    draws return the test's arrays (the noise in the dtype asked for)."""

    def __init__(self, t, noise):
        self.random = types.SimpleNamespace(
            split=jax.random.split,
            uniform=lambda key, shape, minval=0.0, maxval=1.0: jnp.asarray(t),
            normal=lambda key, shape, dtype=jnp.float32: jnp.asarray(noise).astype(dtype))


def _jax_loss_and_grads(jm, variables, img, gt, t, noise, mixed_precision):
    """The JAX depther's training loss and gradients at the test's t and
    noise; ``mixed_precision``: the bf16 policy of ``ddp_tpu/train/state.py``
    (bf16 casts of the parameters, the image and the depth map)."""
    low = (lambda x: x.astype(jnp.bfloat16) if x.dtype == jnp.float32 else x) \
        if mixed_precision else (lambda x: x)

    def run(params):
        def loss_fn(p):
            loss, logs = jm.apply({"params": jax.tree_util.tree_map(low, p)},
                                  low(jnp.asarray(img)), low(jnp.asarray(gt)), train=True,
                                  rngs={"diffusion": jax.random.PRNGKey(3),
                                        "dropout": jax.random.PRNGKey(4)})
            return loss.astype(jnp.float32)

        return jax.value_and_grad(loss_fn)(params)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdepther, "jax", _FixedRandom(t, noise))
        loss, grads = jax.jit(run)(variables["params"])
    return float(loss), _np(grads)


def _port_state(mc, variables):
    tm = _port_model(mc, variables)
    return TrainState(tm, toptim.make_optimizer(get_config("converge_depth").optim, tm),
                      torch.Generator().manual_seed(0))


@pytest.mark.parametrize("variant,act", [("deform", "relu"), ("upconv", "softplus")])
def test_depther_loss_and_grads_match_jax(variant, act):
    mc, jm, variables = _jax_init(variant, act)
    img, gt = _randn(2, *HW, 3, seed=5), _depth_maps()
    t, noise = _draws(mc)
    loss_j, grads_j = _jax_loss_and_grads(jm, variables, img, gt, t, noise, False)
    tm = _port_model(mc, variables).train()
    loss, logs = tm(_t(img), _t(gt), t=_t(t), noise=_t(noise))
    loss.backward()
    np.testing.assert_allclose(loss.item(), loss_j, rtol=1e-5)
    assert logs["decode.loss_depth"] is logs["loss"]
    want = params_from_flax(grads_j)
    named = dict(tm.named_parameters())
    assert set(want) == set(named)
    for name, p in named.items():
        g = p.grad.numpy() if p.grad is not None else np.zeros(p.shape, np.float32)
        w = want[name].numpy()
        tol = 1e-3 * np.abs(w).max() + 1e-6
        assert np.abs(g - w).max() <= tol, (name, np.abs(g - w).max(), tol)


def test_depther_bf16_step_matches_jax():
    """test_bf16_train_step_matches_jax's tolerances: the loss within 1e-2
    relative, each gradient within 2^-2 · max|g| of JAX's bf16 gradient and
    the median within 2^-5, and the port's bf16 gradient no further from
    JAX's f32 gradient than twice JAX's bf16 one plus 2^-5 · max|g|. JAX
    runs the fusion conv, time MLP and decoder in float32 here (type
    promotion against the float32 latent); so does the port."""
    mc, jm, variables = _jax_init("deform", "softplus")
    img, gt = _randn(2, *HW, 3, seed=5), _depth_maps()
    t, noise = _draws(mc)
    loss16, want16 = _jax_loss_and_grads(jm, variables, img, gt, t, noise, True)
    _, want32 = _jax_loss_and_grads(jm, variables, img, gt, t, noise, False)
    state = _port_state(mc, variables)
    batch = {"image": _t(img), "label": _t(gt), "t": _t(t), "noise": _t(noise)}
    grads, logs = make_train_step(mixed_precision=True).grads(state, batch)
    assert abs(logs["loss"].item() - loss16) <= 1e-2 * abs(loss16)
    want16, want32 = params_from_flax(want16), params_from_flax(want32)
    rel = []
    for name, g in zip(state.optimizer.names, grads):
        g, w16, w32 = g.numpy(), want16[name].numpy(), want32[name].numpy()
        d = np.abs(g - w16).max()
        rel.append(d / max(np.abs(w16).max(), 1e-30))
        assert d <= 2.0 ** -2 * np.abs(w16).max(), (name, d)
        port_err, ref_err = np.abs(g - w32).max(), np.abs(w16 - w32).max()
        assert port_err <= 2.0 * ref_err + 2.0 ** -5 * np.abs(w32).max(), (name, port_err,
                                                                            ref_err)
    assert np.median(rel) <= 2.0 ** -5, np.median(rel)


@functools.lru_cache(maxsize=4)
def _jax_rollouts(variant, act):
    """JAX's sample, per-hypothesis rollout and sample_with_uncertainty on
    one image batch, with the initial noise each drew (the first
    denoise_depth call's latent, captured)."""
    mc, jm, variables = _jax_init(variant, act)
    img = _randn(2, *HW, 3, seed=6)

    def run(variables, img):
        out = {}
        for method in ("sample", "_rollout_hypotheses", "sample_with_uncertainty"):
            cap = {}

            def capture(next_fun, args, kwargs, context):
                if context.method_name == "denoise_depth" and "noise" not in cap:
                    cap["noise"] = args[1]
                return next_fun(*args, **kwargs)

            with fnn.intercept_methods(capture):
                res = jm.apply(variables, img, method=getattr(jm, method),
                               rngs={"diffusion": jax.random.PRNGKey(7)})
            out[method] = (res, cap["noise"])
        return out

    return mc, variables, img, _np(jax.jit(run)(variables, jnp.asarray(img)))


@pytest.mark.parametrize("variant,act", [("deform", "relu"), ("upconv", "softplus")])
def test_depther_sample_matches_jax(variant, act):
    mc, variables, img, jout = _jax_rollouts(variant, act)
    tm = _port_model(mc, variables)
    want, noise = jout["sample"]
    got = tm.sample(_t(img), noise=_t(noise))
    assert tuple(got.shape) == (2,) + HW
    _close(got, want, atol=1e-4)
    assert got.min() >= mc.min_depth and got.max() <= mc.max_depth
    want_h, noise_h = jout["_rollout_hypotheses"]
    with torch.no_grad():
        got_h = tm._rollout_hypotheses(_t(img), noise=_t(noise_h))
    assert got_h.shape[0] == 2
    _close(got_h, want_h, atol=1e-4)


def test_sample_with_uncertainty_matches_jax():
    mc, variables, img, jout = _jax_rollouts("deform", "relu")
    tm = _port_model(mc, variables)
    (want, want_unc), noise = jout["sample_with_uncertainty"]
    got, unc = tm.sample_with_uncertainty(_t(img), noise=_t(noise))
    _close(got, want, atol=1e-4)
    assert set(unc) == {"std", "interval_low", "interval_high"}
    for key in unc:
        _close(unc[key], want_unc[key], atol=1e-4)
    assert (unc["interval_high"] >= unc["interval_low"]).all()
    # the hypotheses differ, so the spread is not trivially 0
    assert unc["std"].max() > 0
    with pytest.raises(ValueError, match="noise shape"):
        tm.sample(_t(img), noise=_t(noise[:2]))


def test_bridge_covers_the_depther():
    """Every flax leaf of nyu_swin_t's depther (both head variants) maps to
    a torch entry and fills every one. Shapes only: jax.eval_shape and the
    meta device."""
    for variant in ("deform", "upconv"):
        mc = dataclasses.replace(get_config("nyu_swin_t").model, depth_head_variant=variant)
        jm = _jax_model(mc)
        shapes = jax.eval_shape(lambda: jm.init(
            {"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1),
             "dropout": jax.random.PRNGKey(2)},
            jnp.zeros((1, 64, 64, 3)), jnp.ones((1, 64, 64)), train=False))
        leaves = jax.tree_util.tree_map(
            lambda s: np.broadcast_to(np.zeros((), s.dtype), s.shape), shapes["params"])
        sd = params_from_flax(leaves)
        from ddp_tpu_torch.convert import check_complete
        check_complete(build_model(mc, device="meta"), sd)
        assert tuple(sd["down.conv.weight"].shape) == (256, 257, 1, 1)
        assert ("decode_head.up_conv.conv.weight" in sd) == (variant == "upconv")
