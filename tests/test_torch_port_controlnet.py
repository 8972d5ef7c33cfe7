"""The port's ControlLDM stack (``ddp_tpu_torch/nn/{attention,unet,autoencoder,
clip_text}.py``, ``models/controlnet.py``) against the JAX package's, on the
CPU. The JAX side is jitted; inputs and a jitter of JAX's init (so that its
zero-initialised convolutions carry signal) are seeded numpy, carried across
by ``convert.py``. The port is NCHW inside, JAX NHWC.

  - Each attention block, ``ResBlock``, ``SpatialTransformer``, the VAE's
    encode and decode, the CLIP encoder, ``UNetModel`` with and without
    control residuals, ``ControlNet``'s residuals (5 at the tiny scale) and
    ``HintEncoder`` at 4x and 8x: 1e-5 of the output's scale; ``HintEncoder``
    refuses 16x.
  - ``ControlLDM.p_losses`` with fixed t and noises: the loss within 1e-5
    relative and every gradient within 1e-3 · max|g| + 1e-6; the bf16 step
    at the depther's bf16 tolerances; ``sample`` (3 DDIM steps, guidance 9,
    with and without guess mode) from JAX's initial latent within 1e-4, f32
    and with bf16 weights.
  - One optimizer step of ``controlnet_sd15``'s frozen-key rules against
    JAX's optimizer: the global norm over every gradient (frozen parts
    included), frozen tensors bitwise unchanged, the trained ones within
    1e-6 of JAX's update.
  - ``add_control_from_sd``; ``controlnet_sd15``'s parameter counts.
  - Reference discrepancies the port follows JAX in: flax's eps 1e-6 in
    every GroupNorm and LayerNorm (torch's and the reference's 1e-5), the
    tanh GELU in GEGLU (the reference's: erf), each gap stated.
"""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ddp_tpu import config as jconfig
from ddp_tpu.models import controlnet as jcn
from ddp_tpu.nn import attention as jatt
from ddp_tpu.nn import autoencoder as jvae
from ddp_tpu.nn import clip_text as jclip
from ddp_tpu.nn import unet as junet
from ddp_tpu_torch.config import build_model, get_config
from ddp_tpu_torch.convert import load_flax, params_from_flax
from ddp_tpu_torch.models.controlnet import add_control_from_sd, part_sizes
from ddp_tpu_torch.nn import attention as tatt
from ddp_tpu_torch.nn import autoencoder as tvae
from ddp_tpu_torch.nn import clip_text as tclip
from ddp_tpu_torch.nn import unet as tunet
from ddp_tpu_torch.train.optim import make_optimizer
from ddp_tpu_torch.train.step import TrainState, make_train_step
from torch_port_threads import _one_torch_thread  # noqa: F401

TINY = dict(model_channels=32, num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
            num_heads=2, context_dim=16)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _randn(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _jitter(params, seed=0, scale=0.05):
    """JAX's init plus seeded noise: zero-initialised kernels carry signal."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + scale * rng.randn(*np.shape(p))).astype(np.float32), params)


def _nchw(a):
    return _t(np.asarray(a).transpose(0, 3, 1, 2))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _close_scaled(got, want, rel=1e-5):
    want = np.asarray(want)
    tol = rel * max(np.abs(want).max(), 1.0)
    assert np.abs(np.asarray(got) - want).max() <= tol, (np.abs(np.asarray(got) - want).max(),
                                                         tol)


def _jax_module(module, *inputs, seed=0):
    """(JAX output, jittered params) of ``module`` on ``inputs``."""
    params = jax.jit(module.init)(jax.random.PRNGKey(seed), *inputs)["params"]
    params = _jitter(params, seed)
    return _np(jax.jit(module.apply)({"params": params}, *inputs)), params


def _port(module, params):
    load_flax(module, params)
    return module.eval()


# --- blocks ------------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["self_attention", "cross_attention", "geglu", "transformer_block",
                                  "spatial_transformer", "vae_attention"])
def test_attention_blocks_match_jax(kind):
    x_tok, ctx = _randn(2, 16, 32, seed=1), _randn(2, 7, 24, seed=2)
    x_map = _randn(2, 4, 4, 64, seed=3)
    if kind == "self_attention":
        j, tm, args = jatt.CrossAttention(32, None, 4, 8), tatt.CrossAttention(32, None, 4, 8), \
            (x_tok,)
    elif kind == "cross_attention":
        j, tm, args = jatt.CrossAttention(32, 24, 4, 8), tatt.CrossAttention(32, 24, 4, 8), \
            (x_tok, ctx)
    elif kind == "geglu":
        j, tm, args = jatt.GEGLUFeedForward(32), tatt.GEGLUFeedForward(32), (x_tok,)
    elif kind == "transformer_block":
        j, tm, args = (jatt.BasicTransformerBlock(32, 24, 4, 8),
                       tatt.BasicTransformerBlock(32, 24, 4, 8), (x_tok, ctx))
    elif kind == "spatial_transformer":
        j, tm, args = (jatt.SpatialTransformer(64, 2, 16, 2, 24),
                       tatt.SpatialTransformer(64, 2, 16, 2, 24), (x_map, ctx))
    else:
        j, tm, args = jatt.VAEAttnBlock(64), tatt.VAEAttnBlock(64), (x_map,)
    want, params = _jax_module(j, *map(jnp.asarray, args))
    tm = _port(tm, params)
    with torch.no_grad():
        if args[0].ndim == 4:
            got = _nhwc(tm(_nchw(args[0]), *map(_t, args[1:])))
        else:
            got = tm(*map(_t, args)).numpy()
    _close_scaled(got, want)


@pytest.mark.parametrize("cin,cout,sss", [(64, 64, False), (32, 64, False), (64, 32, True)])
def test_resblock_matches_jax(cin, cout, sss):
    x, emb = _randn(2, 8, 8, cin, seed=4), _randn(2, 40, seed=5)
    want, params = _jax_module(junet.ResBlock(cin, cout, sss), jnp.asarray(x), jnp.asarray(emb))
    tm = _port(tunet.ResBlock(cin, cout, 40, sss), params)
    with torch.no_grad():
        _close_scaled(_nhwc(tm(_nchw(x), _t(emb))), want)
    assert (tm.skip is None) == (cin == cout)


def test_timestep_embedding_matches_jax():
    t = np.array([0, 1, 17, 500, 999], np.int32)
    for dim in (32, 33):
        want = np.asarray(jax.jit(junet.timestep_embedding, static_argnums=1)(t, dim))
        np.testing.assert_allclose(tunet.timestep_embedding(_t(t), dim).numpy(), want,
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("downsample", [4, 8])
def test_hint_encoder_matches_jax(downsample):
    hint = np.random.RandomState(6).rand(2, 32, 32, 3).astype(np.float32)
    want, params = _jax_module(junet.HintEncoder(32, downsample), jnp.asarray(hint))
    tm = _port(tunet.HintEncoder(32, downsample), params)
    with torch.no_grad():
        got = _nhwc(tm(_nchw(hint)))
    assert got.shape == (2, 32 // downsample, 32 // downsample, 32)
    _close_scaled(got, want)


def test_hint_encoder_refuses_16x():
    """JAX's flip logic takes 16 and silently lands the hint at 1/8 of the
    image (a 2x2 hint of a 32x32 image would need 1/16): the port raises."""
    hint = jnp.zeros((1, 32, 32, 3))
    out = jax.jit(junet.HintEncoder(32, 16).init_with_output)(jax.random.PRNGKey(0), hint)[0]
    assert out.shape[1] == 32 // 8
    with pytest.raises(ValueError, match="1, 2, 4 or 8"):
        tunet.HintEncoder(32, 16)


def _unet_inputs(seed=7):
    return (_randn(2, 8, 8, 4, seed=seed), np.array([3, 640], np.int32),
            _randn(2, 5, 16, seed=seed + 1))


@pytest.mark.parametrize("control", ["none", "residuals", "only_mid"])
def test_unet_matches_jax(control):
    cfg = junet.UNetConfig(**TINY)
    x, t, ctx = _unet_inputs()
    skips = tunet.skip_channels(tunet.UNetConfig(**TINY))
    res = None
    if control != "none":
        shapes = [(8, 8), (8, 8), (4, 4), (4, 4)]
        res = [_randn(2, h, w, c, seed=20 + i, scale=0.3) for i, ((h, w), c)
               in enumerate(zip(shapes, skips))] + [_randn(2, 4, 4, 64, seed=30, scale=0.3)]
    j = junet.UNetModel(cfg)
    params = _jitter(jax.jit(j.init)(jax.random.PRNGKey(0), x, t, ctx)["params"])
    only_mid = control == "only_mid"
    want = jax.jit(lambda p, r: j.apply({"params": p}, x, t, ctx, control=r,
                                        only_mid_control=only_mid))(
        params, None if res is None else [jnp.asarray(r) for r in res])
    tm = _port(tunet.UNetModel(tunet.UNetConfig(**TINY)), params)
    with torch.no_grad():
        got = tm(_nchw(x), _t(t), _t(ctx), control=None if res is None else [_nchw(r) for r in res],
                 only_mid_control=only_mid)
    _close_scaled(_nhwc(got), want)


def test_controlnet_residuals_match_jax():
    cfg = junet.UNetConfig(**TINY)
    x, t, ctx = _unet_inputs(seed=9)
    hint = np.random.RandomState(11).rand(2, 64, 64, 3).astype(np.float32)
    want, params = _jax_module(junet.ControlNet(cfg), *map(jnp.asarray, (x, hint, t, ctx)))
    tm = _port(tunet.ControlNet(tunet.UNetConfig(**TINY)), params)
    with torch.no_grad():
        got = tm(_nchw(x), _nchw(hint), _t(t), _t(ctx))
    assert len(got) == len(want) == 5 == tm.n_skips + 1
    for g, w in zip(got, want):
        _close_scaled(_nhwc(g), w)
    sd15 = tunet.UNetConfig()
    assert len(tunet.skip_channels(sd15)) + 1 == 13


def test_vae_encode_decode_matches_jax():
    j = jvae.AutoencoderKL(embed_dim=4, ch=16, ch_mult=(1, 2, 4), num_res_blocks=1)
    img = _randn(2, 16, 16, 3, seed=12, scale=0.5)
    params = jax.jit(lambda k, x: j.init(k, x, method=lambda m, x: m.decode(m.encode(x)[0])))(
        jax.random.PRNGKey(0), img)["params"]
    params = _jitter(params)
    mean, logvar = jax.jit(lambda p, x: j.apply({"params": p}, x, method=j.encode))(params, img)
    z = _randn(2, 4, 4, 4, seed=13)
    dec = jax.jit(lambda p, z: j.apply({"params": p}, z, method=j.decode))(params, z)
    tm = _port(tvae.AutoencoderKL(4, 16, (1, 2, 4), 1), params)
    with torch.no_grad():
        tmean, tlogvar = tm.encode(_nchw(img))
        tdec = tm.decode(_nchw(z))
    _close_scaled(_nhwc(tmean), mean)
    _close_scaled(_nhwc(tlogvar), logvar)
    _close_scaled(_nhwc(tdec), dec)
    # the clip of the log-variance
    with torch.no_grad():
        tm.quant_conv.bias[4:] = 100.0
        assert tm.encode(_nchw(img))[1].max().item() == 20.0


def test_clip_encoder_matches_jax():
    j = jclip.CLIPTextEncoder(vocab_size=64, width=32, layers=2, heads=2, max_len=12)
    ids = np.random.RandomState(14).randint(0, 64, (2, 12)).astype(np.int32)
    want, params = _jax_module(j, jnp.asarray(ids))
    tm = _port(tclip.CLIPTextEncoder(vocab_size=64, width=32, layers=2, heads=2, max_len=12),
               params)
    with torch.no_grad():
        _close_scaled(tm(_t(ids)).numpy(), want)
    assert np.array_equal(tclip.dummy_ids(3), jclip.dummy_ids(3))
    with pytest.raises(RuntimeError, match="tokenizer assets"):
        tclip.tokenize(["a red circle"])
    with pytest.raises(RuntimeError, match="tokenizer assets"):
        jclip.tokenize(["a red circle"])


# --- reference discrepancies (ROADMAP.md queue 3) ----------------------------------------

def test_norm_eps_follows_flax_not_the_reference():
    """flax's GroupNorm and LayerNorm default to eps 1e-6; the reference's
    (ldm's GroupNorm32, nn.LayerNorm, HF CLIP) use 1e-5. The port follows
    JAX; on a map of std 0.03 the two differ by ~2e-2 of the output, on
    unit-variance activations by ~2e-5."""
    mods = [m for m in build_model(get_config("converge_controlnet",
                                              {"model.cn_size": "tiny"}).model, device="meta")
            .modules() if isinstance(m, (torch.nn.GroupNorm, torch.nn.LayerNorm))]
    assert mods and {m.eps for m in mods} == {1e-6}
    x = torch.from_numpy(_randn(2, 64, 8, 8, seed=15, scale=0.03))
    gap_low = (F.group_norm(x, 32, eps=1e-6) - F.group_norm(x, 32, eps=1e-5)).abs().max().item()
    x1 = torch.from_numpy(_randn(2, 64, 8, 8, seed=15))
    gap_unit = (F.group_norm(x1, 32, eps=1e-6) - F.group_norm(x1, 32, eps=1e-5)).abs().max().item()
    assert 1e-2 < gap_low < 5e-2 and gap_unit < 5e-5, (gap_low, gap_unit)


def test_geglu_gelu_is_tanh_as_jax_not_erf():
    """JAX's GEGLU calls ``jax.nn.gelu`` (tanh form); the reference's GEGLU
    the exact erf GELU. The port follows JAX: the gate's gap to erf is up to
    ~1e-3 per activation."""
    gate = np.linspace(-6, 6, 4001).astype(np.float32)
    want = np.asarray(jax.jit(jax.nn.gelu)(gate))
    tanh = tatt.gelu(_t(gate)).numpy()
    erf = F.gelu(_t(gate)).numpy()
    np.testing.assert_allclose(tanh, want, rtol=0, atol=1e-6)
    gap = np.abs(tanh - erf).max()
    assert 1e-4 < gap < 2e-3, gap


# --- the ControlLDM ----------------------------------------------------------------------

S = 32  # image side of the tiny stack (8x VAE: a 4x4 latent)


def _mc():
    return get_config("converge_controlnet", {"model.cn_size": "tiny",
                                              "model.cn_vae_mult": "(1,2,2,4)"}).model


@functools.lru_cache(maxsize=1)
def _ldm():
    mc = _mc()
    jm = jconfig.build_model(jconfig.get_config(
        "converge_controlnet", {"model.cn_size": "tiny", "model.cn_vae_mult": "(1,2,2,4)"}).model)
    z = jnp.zeros((1, S, S, 3))
    params = jax.jit(lambda: jm.init({"params": jax.random.PRNGKey(0),
                                      "diffusion": jax.random.PRNGKey(1)},
                                     z, z, jnp.zeros((1, 77), jnp.int32), train=False))()
    return mc, jm, _jitter(params["params"], seed=1, scale=0.03)


def _batch(b=2, seed=16):
    rng = np.random.RandomState(seed)
    img = (rng.rand(b, S, S, 3) * 2 - 1).astype(np.float32)
    hint = (rng.rand(b, S, S, 3) > 0.8).astype(np.float32)
    ids = rng.randint(0, 16, (b, 77)).astype(np.int32)
    t = np.array([5, 731], np.int32)[:b]
    noise, post = _randn(b, 4, 4, 4, seed=seed + 1), _randn(b, 4, 4, 4, seed=seed + 2)
    return img, hint, ids, t, noise, post


class _FixedRandom:
    """Stands in for ``jax`` in the JAX ControlLDM's module: randint returns
    the test's t, normal the posterior noise then the noise (the order
    p_losses draws them), in the dtype asked for."""

    def __init__(self, t, normals):
        queue = list(normals)
        self.random = types.SimpleNamespace(
            split=jax.random.split,
            randint=lambda key, shape, lo, hi: jnp.asarray(t),
            normal=lambda key, shape, dtype=jnp.float32: jnp.asarray(queue.pop(0)).astype(dtype))
        self.lax, self.tree_util = jax.lax, jax.tree_util


@functools.lru_cache(maxsize=2)
def _jax_batch_grads(mixed):
    """JAX's loss and gradients at ``_batch()``'s inputs and draws (shared by
    the tests that compare against them)."""
    params = _ldm()[2]
    return _jax_loss_and_grads(params, *_batch(), mixed)


def _jax_loss_and_grads(params, img, hint, ids, t, noise, post, mixed):
    mc, jm, _ = _ldm()
    low = (lambda x: x.astype(jnp.bfloat16) if x.dtype == jnp.float32 else x) \
        if mixed else (lambda x: x)

    def run(params):
        def loss_fn(p):
            loss, _ = jm.apply({"params": jax.tree_util.tree_map(low, p)}, low(jnp.asarray(img)),
                               low(jnp.asarray(hint)), jnp.asarray(ids), train=True,
                               rngs={"diffusion": jax.random.PRNGKey(3)})
            return loss.astype(jnp.float32)

        return jax.value_and_grad(loss_fn)(params)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcn, "jax", _FixedRandom(t, [post, noise]))
        loss, grads = jax.jit(run)(params)
    return float(loss), _np(grads)


def _port_ldm(params):
    tm = build_model(_mc(), device="cpu")
    load_flax(tm, params)
    return tm


def test_p_losses_and_grads_match_jax():
    params = _ldm()[2]
    img, hint, ids, t, noise, post = _batch()
    loss_j, grads_j = _jax_batch_grads(False)
    tm = _port_ldm(params).train()
    loss, logs = tm(_t(img), _t(hint), _t(ids), t=_t(t), noise=_t(noise),
                    posterior_noise=_t(post))
    loss.backward()
    np.testing.assert_allclose(loss.item(), loss_j, rtol=1e-5)
    assert logs["loss"] is loss
    want = params_from_flax(grads_j)
    named = dict(tm.named_parameters())
    assert set(want) == set(named)
    nonzero = 0
    for name, p in named.items():
        g = p.grad.numpy() if p.grad is not None else np.zeros(p.shape, np.float32)
        w = want[name].numpy()
        tol = 1e-3 * np.abs(w).max() + 1e-6
        assert np.abs(g - w).max() <= tol, (name, np.abs(g - w).max(), tol)
        nonzero += bool(np.abs(w).max() > 0)
    # the frozen parts' gradients are taken: the VAE encoder's and CLIP's too
    assert nonzero == len(named) - sum("first_stage_model.decoder" in n
                                       or "post_quant_conv" in n for n in named)


def test_p_losses_bf16_step_matches_jax():
    """The bf16 train step against JAX's. Here, unlike the depther, the bf16
    VAE encoder and CLIP feed z and the context to every other part, so two
    bf16 runs differ by bf16's own error throughout (median 6 % of a tensor's
    max, PR 14): the port is held to be as close to the exact gradient (JAX's
    f32 one) as JAX's bf16 one is. Each gradient within 2^-2 · max|g| of JAX's
    bf16 one and no further from JAX's f32 gradient than 3x JAX's bf16 one
    plus 2^-5 · max|g|; over each part (UNet, ControlNet, VAE, CLIP) the L2
    distance to the f32 gradients within 1.5x JAX's bf16 one's; the median of
    the per-tensor distances to JAX's bf16 gradients within 2^-3; the loss
    within 1e-2 relative. Gradients zero in exact arithmetic (a bias before a
    GroupNorm of one channel per group: below 1e-5 of the largest) are held
    to 1e-3 of the largest gradient. The UNet and ControlNet run float32 on
    bf16-rounded weights (the corrupted latent is float32)."""
    params = _ldm()[2]
    img, hint, ids, t, noise, post = _batch()
    loss16, want16 = _jax_batch_grads(True)
    _, want32 = _jax_batch_grads(False)
    tm = _port_ldm(params)
    state = TrainState(tm, make_optimizer(get_config("controlnet_sd15").optim, tm),
                       torch.Generator().manual_seed(0))
    step = make_train_step(mixed_precision=True, batch_keys=("image", "hint", "ids"))
    orig = tm.forward

    def fixed_posterior(img, hint, ids, t=None, noise=None, generator=None):
        return orig(img, hint, ids, t=t, noise=noise, generator=generator,
                    posterior_noise=_t(post))

    tm.forward = fixed_posterior
    batch = {"image": _t(img), "hint": _t(hint), "ids": _t(ids), "t": _t(t), "noise": _t(noise)}
    grads, logs = step.grads(state, batch)
    assert abs(logs["loss"].item() - loss16) <= 1e-2 * abs(loss16)
    want16, want32 = params_from_flax(want16), params_from_flax(want32)
    top = max(np.abs(w.numpy()).max() for w in want32.values())
    rel, sq = [], {}
    for name, g in zip(state.optimizer.names, grads):
        g, w16, w32 = g.numpy(), want16[name].numpy(), want32[name].numpy()
        if np.abs(w32).max() < 1e-5 * top:
            assert np.abs(g).max() <= 1e-3 * top, name
            continue
        d = np.abs(g - w16).max()
        rel.append(d / np.abs(w16).max())
        assert d <= 2.0 ** -2 * np.abs(w16).max(), (name, d)
        port_err, ref_err = np.abs(g - w32).max(), np.abs(w16 - w32).max()
        assert port_err <= 3.0 * ref_err + 2.0 ** -5 * np.abs(w32).max(), (name, port_err,
                                                                            ref_err)
        part = sq.setdefault(name.split(".")[0], [0.0, 0.0])
        part[0] += float(np.sum(np.square(g - w32, dtype=np.float64)))
        part[1] += float(np.sum(np.square(w16 - w32, dtype=np.float64)))
    assert len(sq) == 4
    for part, (port_sq, ref_sq) in sq.items():
        assert port_sq ** 0.5 <= 1.5 * ref_sq ** 0.5, (part, port_sq ** 0.5, ref_sq ** 0.5)
    assert np.median(rel) <= 2.0 ** -3, np.median(rel)


def _jax_sample(guess_mode, bf16):
    """JAX's sample (3 DDIM steps, guidance 9) and the initial latent it drew."""
    mc, jm, params = _ldm()
    img, hint, ids, *_ = _batch(seed=17)
    uncond = np.tile(np.asarray([0, 1] + [2] * 75, np.int32), (2, 1))
    cast = (lambda p: p.astype(jnp.bfloat16)) if bf16 else (lambda p: p)
    rng = jax.random.PRNGKey(8)
    out = jax.jit(lambda p: jm.apply(
        {"params": jax.tree_util.tree_map(cast, p)},
        method=lambda m: m.ldm.sample(rng, jnp.asarray(hint), jnp.asarray(ids),
                                      jnp.asarray(uncond), steps=3, guidance_scale=9.0,
                                      guess_mode=guess_mode)))(params)
    x_t = jax.random.normal(jax.random.split(rng)[1], (2, S // 8, S // 8, 4), jnp.float32)
    return np.asarray(out, np.float32), x_t, hint, ids, uncond


@pytest.mark.parametrize("case", ["f32", "f32_guess_mode", "bf16"])
def test_sample_matches_jax(case):
    """3 DDIM steps at guidance 9 from the initial latent JAX drew (with eta 0
    no other noise enters): f32 within 1e-4 (with and without guess mode).
    With bf16 weights both run the UNet in float32 but CLIP and the hint
    encoder in bf16, whose rounding guidance 9 amplifies: the port within
    2^-5 of the image's scale of JAX's bf16 sample, and no further from JAX's
    f32 sample than 2x JAX's bf16 one plus 1e-4."""
    mc, jm, params = _ldm()
    bf16 = case == "bf16"
    want, x_t, hint, ids, uncond = _jax_sample(case == "f32_guess_mode", bf16)
    tm = _port_ldm(params)
    if bf16:
        tm = tm.to(torch.bfloat16)
    got = tm.sample(_t(hint), _t(ids), _t(uncond), steps=3, guidance_scale=9.0,
                    guess_mode=case == "f32_guess_mode", x_T=_t(x_t))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, S, S, 3)
    got = got.numpy()
    if not bf16:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
        return
    want32 = _jax_sample(False, False)[0]
    assert np.abs(got - want).max() <= 2.0 ** -5 * np.abs(want32).max()
    assert np.abs(got - want32).max() <= 2.0 * np.abs(want - want32).max() + 1e-4, (
        np.abs(got - want32).max(), np.abs(want - want32).max())


def test_frozen_keys_clip_over_all_gradients_as_jax():
    """One step of controlnet_sd15's optimizer (lr_mult 0 on the UNet, VAE and
    CLIP) on the same gradients: the global norm is over every gradient, the
    frozen tensors are bitwise unchanged and the ControlNet's update is JAX's."""
    from ddp_tpu.train.optim import make_optimizer as jmake_optimizer

    params = _ldm()[2]
    _, grads_j = _jax_batch_grads(False)
    grads_j = jax.tree_util.tree_map(lambda g: g * 50.0, grads_j)  # past the clip of 1.0
    optim_cfg = jconfig.get_config("controlnet_sd15").optim
    tx = jmake_optimizer(optim_cfg, params)
    updates, _ = jax.jit(tx.update)(grads_j, tx.init(params), params)
    new_j = params_from_flax(_np(jax.tree_util.tree_map(lambda p, u: p + u, params, updates)))
    tm = _port_ldm(params)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    opt = make_optimizer(get_config("controlnet_sd15").optim, tm)
    g_flat = params_from_flax(grads_j)
    norm = opt.step([g_flat[n].clone() for n in opt.names])
    want_norm = float(np.sqrt(sum(float(np.sum(np.square(np.asarray(g, np.float64))))
                                  for g in jax.tree_util.tree_leaves(grads_j))))
    np.testing.assert_allclose(norm.item(), want_norm, rtol=1e-5)
    frozen = ("diffusion_model", "first_stage_model", "cond_stage_model")
    changed, changed_j = 0, 0
    for name, p in tm.named_parameters():
        if name.startswith(frozen):
            assert torch.equal(p, before[name]), name
            assert torch.equal(new_j[name], before[name]), name
        else:
            np.testing.assert_allclose(p.detach().numpy(), new_j[name].numpy(), rtol=0,
                                       atol=1e-6)
            changed += not torch.equal(p, before[name])
            changed_j += not torch.equal(new_j[name], before[name])
    # lr 1e-5: a step moves a tensor of |p| ~ 1 by less than its float32 ulp here and there
    assert changed >= changed_j - 2 and changed > 60


def test_add_control_from_sd_matches_jax():
    mc, jm, params = _ldm()
    sd_params = params["ldm"]["diffusion_model"]
    ctrl_init = _jitter(params["ldm"]["control_model"], seed=5)
    want = params_from_flax(jcn.add_control_from_sd(sd_params, ctrl_init))
    got = add_control_from_sd(params_from_flax(sd_params), params_from_flax(ctrl_init))
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert any(torch.equal(got[k], params_from_flax(sd_params)[k]) for k in got
               if k.startswith("encoder."))


def test_controlnet_sd15_parameter_counts():
    """controlnet_sd15's ControlLDM: the parameter counts of jax.eval_shape of
    the JAX model (1.43 B, 5.71 GB in f32), built on the meta device."""
    m = build_model(get_config("controlnet_sd15").model, device="meta")
    assert dict(part_sizes(m)) == {"diffusion_model": 859_520_964,
                                   "control_model": 361_279_120,
                                   "first_stage_model": 83_653_863,
                                   "cond_stage_model": 123_060_480}
    assert m.latent_downsample == 8 and m.control_model.n_skips + 1 == 13
