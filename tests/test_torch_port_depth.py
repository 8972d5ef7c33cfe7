"""The port's depther (``ddp_tpu_torch/models/depther.py``) against the JAX
package's, on the CPU. The JAX side is jitted; inputs are seeded numpy.

  - ``cosine_gamma`` within 1e-6; ``pixel_shuffle`` bitwise (the JAX layout,
    not ``F.pixel_shuffle``'s); ``DeformableDepthHead`` for each variant
    (deform, upconv, spade) x activation (relu, softplus) within 1e-5;
    ``sig_loss``'s value and gradient with invalid pixels within 1e-6
    relative; ``depth_metrics`` within 1e-12.
  - A tiny depther (nano Swin, 64-d msda decoder of 2 layers, 64 x 64
    crops), JAX's init carried across by ``convert.py``: the f32 training
    loss with fixed t and noise within 1e-5 relative and every gradient within
    1e-3 · max|g| + 1e-6; the bf16 step at
    ``test_bf16_train_step_matches_jax``'s tolerances; ``sample``, the
    per-hypothesis rollout (randsteps 2) and ``sample_with_uncertainty``'s
    std and 10/90 % interval within 1e-4 m from the initial noise JAX drew.
  - The presets and ``build_model``; ``conv_depth``'s bias init;
    ``build_model`` refuses ``decoder_remat`` (not ported); a depth batch (float label) through the eager step and the
    chunked step, which must agree bit for bit on the CPU.
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

from ddp_tpu import config as jconfig
from ddp_tpu.core.diffusion import DiffusionConfig as JDiffusionConfig
from ddp_tpu.core.schedules import cosine_gamma as j_cosine_gamma
from ddp_tpu.evaluation.metrics import depth_metrics as j_depth_metrics
from ddp_tpu.models import depther as jdepther
from ddp_tpu.nn import heads as jheads
from ddp_tpu.nn.losses import sig_loss as j_sig_loss
from ddp_tpu_torch.config import build_model, get_config
from ddp_tpu_torch.convert import load_flax, params_from_flax
from ddp_tpu_torch.core.schedules import cosine_gamma
from ddp_tpu_torch.evaluation.metrics import depth_metrics
from ddp_tpu_torch.nn import heads as theads
from ddp_tpu_torch.nn.losses import sig_loss
from ddp_tpu_torch.train import optim as toptim
from ddp_tpu_torch.train.step import TrainState, make_chunked_train_step, make_train_step

HW = (64, 64)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _randn(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol)


# --- modules ------------------------------------------------------------------------

def test_cosine_gamma_matches_jax():
    t = np.concatenate([np.linspace(0.0, 1.0, 101), np.random.RandomState(0).rand(64)]
                       ).astype(np.float32)
    _close(cosine_gamma(_t(t)), jax.jit(j_cosine_gamma)(jnp.asarray(t)), atol=1e-6)


@pytest.mark.parametrize("scale", [2, 4])
def test_pixel_shuffle_is_the_jax_layout(scale):
    x = _randn(2, 3, 5, 8 * scale * scale)
    got = theads.pixel_shuffle(_t(x), scale).numpy()
    assert np.array_equal(got, np.asarray(jheads.pixel_shuffle(jnp.asarray(x), scale)))
    # torch's own pixel_shuffle orders the input channels (c', sy, sx): not this
    theirs = torch.nn.functional.pixel_shuffle(_t(x).permute(0, 3, 1, 2), scale)
    assert not np.array_equal(got, theirs.permute(0, 2, 3, 1).numpy())


@pytest.mark.parametrize("act", ["relu", "softplus"])
@pytest.mark.parametrize("variant", ["deform", "upconv", "spade"])
def test_depth_head_matches_jax(variant, act):
    """An 8 x 16 grid, 2 layers; conv_depth's bias is moved to -0.3 so that
    relu clips part of the map."""
    kw = dict(num_layers=2, num_heads=4, ffn_dim=128, variant=variant, act=act)
    jm = jheads.DeformableDepthHead(64, **kw)
    x, time = _randn(2, 8, 16, 64), _randn(2, 256, seed=1)
    v = jax.jit(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(time)))()
    params = jax.tree_util.tree_map(lambda a: a, v["params"])
    params["conv_depth"]["bias"] = params["conv_depth"]["bias"] - 0.8
    tm = theads.DeformableDepthHead(64, **kw)
    load_flax(tm, _np(params))
    with torch.no_grad():
        got = tm(_t(x), _t(time))
    want = jax.jit(jm.apply)({"params": params}, jnp.asarray(x), jnp.asarray(time))
    assert tuple(got.shape) == ((2, 32, 64, 1) if variant == "upconv" else (2, 8, 16, 1))
    _close(got, want, atol=1e-5)
    assert got.min().item() >= 1e-3 - 1e-7
    if act == "relu":
        assert (got == 1e-3).any()


def _depth_maps(seed=0, shape=(2,) + HW):
    rng = np.random.RandomState(seed)
    gt = rng.uniform(0.5, 9.5, shape).astype(np.float32)
    gt[0, :5, :9] = 0.0
    gt[1, -4:, :] = 0.0
    return gt


def test_sig_loss_matches_jax():
    gt = _depth_maps()
    pred = np.random.RandomState(1).uniform(0.3, 9.0, gt.shape).astype(np.float32)
    loss_j, grad_j = jax.jit(jax.value_and_grad(j_sig_loss))(jnp.asarray(pred), jnp.asarray(gt))
    p = _t(pred).requires_grad_(True)
    loss = sig_loss(p, _t(gt))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-6)
    g, gj = p.grad.numpy(), np.asarray(grad_j)
    assert np.abs(g - gj).max() <= 1e-6 * np.abs(gj).max()
    assert not g[gt <= 0].any()
    # no valid pixel: sqrt(1e-12), as in JAX
    zero = np.zeros_like(gt)
    np.testing.assert_allclose(sig_loss(_t(pred), _t(zero)).item(),
                               float(j_sig_loss(jnp.asarray(pred), jnp.asarray(zero))), rtol=1e-6)


def test_depth_metrics_match_jax():
    gt = _depth_maps(2)
    pred = gt * np.random.RandomState(3).uniform(0.7, 1.4, gt.shape).astype(np.float32) + 0.01
    mask = np.random.RandomState(4).rand(*gt.shape) < 0.8
    for m in (None, mask):
        got, want = depth_metrics(pred, gt, m), j_depth_metrics(pred, gt, m)
        assert set(got) == set(want)
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-12 * max(1.0, abs(want[k])), k


# --- the tiny depther -----------------------------------------------------------------

def _model_cfg(variant="deform", act="relu", randsteps=2):
    mc = get_config("converge_depth").model
    return dataclasses.replace(
        mc, decoder_layers=2, decoder_heads=4, decoder_ffn_dim=128,
        depth_head_variant=variant, depth_act=act,
        diffusion=dataclasses.replace(mc.diffusion, randsteps=randsteps))


def _jax_model(mc):
    d = mc.diffusion
    return jdepther.DDPDepther(
        backbone_variant=mc.backbone_variant, embed_dims=mc.embed_dims,
        bit_scale=mc.bit_scale, max_depth=mc.max_depth, min_depth=mc.min_depth,
        drop_path_rate=0.0, decoder_layers=mc.decoder_layers, decoder_heads=mc.decoder_heads,
        decoder_ffn_dim=mc.decoder_ffn_dim, head_variant=mc.depth_head_variant,
        depth_act=mc.depth_act,
        diffusion=JDiffusionConfig(timesteps=d.timesteps, randsteps=d.randsteps,
                                   accumulation=d.accumulation))


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


# --- configuration, init, training ------------------------------------------------------

@pytest.mark.parametrize("name", ["nyu_swin_t", "nyu_swin_l", "kitti_swin_t", "kitti_swin_b",
                                  "converge_depth"])
def test_depth_presets_match_jax(name):
    port, ref = get_config(name), jconfig.get_config(name)
    for part in ("model", "data", "optim", "runtime"):
        for f in dataclasses.fields(getattr(port, part)):
            a, b = getattr(getattr(port, part), f.name), getattr(getattr(ref, part), f.name)
            if f.name == "workdir" and name == "converge_depth":
                assert a == "work_dirs/torch_converge_depth" and b == "work_dirs/converge_depth"
                continue
            if dataclasses.is_dataclass(a):
                a, b = dataclasses.asdict(a), dataclasses.asdict(b)
            assert a == b, (part, f.name)


def test_build_model_depth():
    from ddp_tpu_torch.models.depther import DDPDepther

    mc = _model_cfg()
    model = build_model(mc, device="cpu", seed=3)
    assert isinstance(model, DDPDepther) and not model.training
    sd = model.state_dict()
    assert torch.equal(sd["decode_head.conv_depth.bias"], torch.full((1,), 0.5))
    assert not sd["down.conv.bias"].any()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_model(mc)
    with pytest.raises(NotImplementedError, match="bev_fusion"):
        build_model(dataclasses.replace(mc, task="bev_fusion"), device="cpu")


def _depth_batch(mc, b=2, seed=0):
    img = _randn(b, *HW, 3, seed=seed)
    return {"image": _t(img), "label": _t(_depth_maps(seed, (b,) + HW))}


@pytest.mark.parametrize("task", ["seg", "depth"])
def test_build_model_refuses_decoder_remat(task):
    mc = get_config("converge_depth" if task == "depth" else "converge_seg_msda").model
    with pytest.raises(NotImplementedError, match="decoder_remat"):
        build_model(dataclasses.replace(mc, decoder_remat=True), device="cpu", seed=1)


@pytest.mark.parametrize("mixed", [False, True])
def test_depth_batch_through_eager_and_chunked_steps(mixed):
    """A float depth label through make_train_step and a 2-step chunk of
    make_chunked_train_step from the same state: the same losses and
    parameters, bit for bit, on the CPU (the card runs the chunk as one
    CUDA graph; chip_smoke.py's depth_train holds it to the eager steps)."""
    mc = _model_cfg()
    cfg = get_config("converge_depth")
    batches = [_depth_batch(mc, seed=s) for s in (0, 1)]
    results = []
    for chunked in (False, True):
        model = build_model(mc, device="cpu", seed=2)
        state = TrainState(model, toptim.make_optimizer(cfg.optim, model),
                           torch.Generator().manual_seed(0))
        state.optimizer.count = cfg.optim.warmup_steps
        if chunked:
            logs = make_chunked_train_step(2, mixed_precision=mixed)(
                state, {k: torch.stack([b[k] for b in batches]) for k in ("image", "label")})
            losses = logs["loss"].tolist()
        else:
            step = make_train_step(mixed_precision=mixed)
            losses = [step(state, b)["loss"].item() for b in batches]
        results.append((losses, {k: v.clone() for k, v in model.state_dict().items()}))
    assert results[0][0] == results[1][0]
    assert all(l == l for l in results[0][0])
    for k, v in results[0][1].items():
        assert torch.equal(v, results[1][1][k]), k
