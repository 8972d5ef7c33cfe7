"""The port's msda decoder against the JAX package, on the CPU.

  - ``ops/deform_attn.py: ms_deform_attn`` against ``ms_deform_attn_xla``
    (2 levels of unequal size, locations across and beyond every border):
    forward within 1e-5 abs in f32, the gradients w.r.t. value, locations and
    weights within 1e-5 · max|g|.
  - mmcv's offset-bias ring, bitwise; ``DeformableAttention`` with a random
    offset kernel (points move off their cells), static and per-batch
    reference points; encoder layers {msda, window} × FiLM {v1, v2, v3}; the
    head with sine and learned positions. Float32, atol 1e-5 (the layers'
    tolerance, ``test_torch_port_layers.py``).
  - A tiny msda segmentor (``tiny_seg`` with ``decoder_attn="msda"``):
    ``sample``'s step-1 logits within 1e-4 abs; the f32 training loss within
    1e-5 relative and every gradient within 1e-3 · max|g| + 1e-6; the bf16
    step at ``test_bf16_train_step_matches_jax``'s tolerances.
  - ``init_params_`` gives the msda layers the reference's init.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ddp_tpu.core.diffusion as jdiff
from ddp_tpu import config as jconfig
from ddp_tpu.nn import heads as jheads
from ddp_tpu.nn import transformer as jtr
from ddp_tpu.ops.deform_attn import ms_deform_attn_xla
from ddp_tpu_torch.config import build_model, get_config
from ddp_tpu_torch.convert import check_complete, load_flax, params_from_flax
from ddp_tpu_torch.nn import heads as theads
from ddp_tpu_torch.nn import transformer as ttr
from ddp_tpu_torch.ops.deform_attn import ms_deform_attn
from ddp_tpu_torch.train import optim as toptim
from ddp_tpu_torch.train.step import TrainState, make_train_step
from test_torch_port_segmentor import _jax_sample
from test_torch_port_train import _batch, _jax_model, _jax_train_forward, _no_dropout

ATOL = 1e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _randn(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol)


def _port(tmodule, variables):
    load_flax(tmodule, _np(variables["params"]), _np(variables.get("batch_stats")))
    return tmodule.eval()


# --- the sampling core ------------------------------------------------------------

def test_ms_deform_attn_matches_xla():
    """Levels 5x7 and 3x2; locations in [-0.3, 1.3], so corners fall inside,
    across and beyond every border, plus points pinned to the exact edges."""
    rng = np.random.RandomState(0)
    shapes = ((5, 7), (3, 2))
    b, nh, d, q, p = 2, 3, 4, 6, 3
    s = sum(h * w for h, w in shapes)
    value = rng.randn(b, s, nh, d).astype(np.float32)
    loc = rng.uniform(-0.3, 1.3, (b, q, nh, len(shapes), p, 2)).astype(np.float32)
    loc[0, 0, :, :, 0] = 0.0
    loc[0, 1, :, :, 0] = 1.0
    weights = rng.rand(b, q, nh, len(shapes), p).astype(np.float32)
    cot = rng.randn(b, q, nh * d).astype(np.float32)

    def loss(v, lc, w):
        return jnp.sum(ms_deform_attn_xla(v, shapes, lc, w) * cot)

    args = [jnp.asarray(a) for a in (value, loc, weights)]
    want = jax.jit(lambda v, lc, w: ms_deform_attn_xla(v, shapes, lc, w))(*args)
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*args)
    tv, tl, tw = [torch.tensor(a, requires_grad=True) for a in (value, loc, weights)]
    got = ms_deform_attn(tv, shapes, tl, tw)
    assert tuple(got.shape) == (b, q, nh * d)
    _close(got.detach(), want)
    (got * _t(cot)).sum().backward()
    for name, t, g in (("value", tv, grads[0]), ("loc", tl, grads[1]),
                       ("weights", tw, grads[2])):
        g = np.asarray(g)
        err = np.abs(t.grad.numpy() - g).max()
        assert err <= 1e-5 * np.abs(g).max(), (name, err, np.abs(g).max())


def test_offset_bias_init_is_the_reference_ring():
    for h, l, p in ((8, 1, 4), (4, 2, 3), (6, 1, 1)):
        got, want = ttr.offset_bias_init(h, l, p), jtr._offset_bias_init(h, l, p)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    _close(ttr.reference_points(((5, 7), (3, 2))), jtr.reference_points(((5, 7), (3, 2))),
           atol=0)


# --- layers -------------------------------------------------------------------------

@pytest.mark.parametrize("refs", ["static", "per_batch"])
def test_deformable_attention(refs):
    """A random offset kernel (0.5 / sqrt(C) scale, offsets of a few pixels)
    so that the points leave their reference cells; value != query."""
    shapes = ((6, 9),)
    c, nq = 32, 54
    jm = jtr.DeformableAttention(c, num_heads=4, num_levels=1, num_points=3)
    query, value, pos = _randn(2, nq, c), _randn(2, nq, c, seed=1), _randn(nq, c, seed=2)
    ref = jtr.reference_points(shapes)
    if refs == "per_batch":
        ref = np.clip(ref[None] + 0.1 * _randn(2, *ref.shape, seed=3), 0.0, 1.0)
    args = (jnp.asarray(query), jnp.asarray(value), jnp.asarray(pos), jnp.asarray(ref), shapes)
    v = jax.jit(lambda: jm.init(jax.random.PRNGKey(0), *args))()
    so = v["params"]["sampling_offsets"]
    v = {"params": dict(v["params"], sampling_offsets=dict(
        so, kernel=jnp.asarray(_randn(*so["kernel"].shape, seed=4) * 0.5 / c ** 0.5)))}
    tm = _port(ttr.DeformableAttention(c, num_heads=4, num_levels=1, num_points=3), v)
    with torch.no_grad():
        got = tm(_t(query), _t(value), _t(pos), _t(ref), shapes)
    _close(got, jax.jit(lambda v: jm.apply(v, *args))(v))


@pytest.mark.parametrize("film", ["v1", "v2", "v3"])
@pytest.mark.parametrize("attn", ["msda", "window"])
def test_time_film_encoder_layer(attn, film):
    """8x12 grid; window 4 with shift 2; msda with its reference init plus a
    random offset kernel."""
    shapes = ((8, 12),)
    kw = dict(ffn_dim=128, attn_type=attn, window=4, shift=2, film=film)
    jm = jtr.TimeFiLMEncoderLayer(64, 4, **kw)
    q, pos, time = _randn(2, 96, 64), _randn(96, 64, seed=1), _randn(2, 256, seed=2)
    ref = jtr.reference_points(shapes) if attn == "msda" else None
    args = (jnp.asarray(q), jnp.asarray(time), jnp.asarray(pos),
            None if ref is None else jnp.asarray(ref), shapes)
    v = jax.jit(lambda: jm.init(jax.random.PRNGKey(0), *args))()
    if attn == "msda":
        params = jax.tree_util.tree_map(lambda a: a, v["params"])
        so = params["attn"]["sampling_offsets"]
        so["kernel"] = jnp.asarray(_randn(*so["kernel"].shape, seed=5) * 0.06)
        v = {"params": params}
    tm = _port(ttr.TimeFiLMEncoderLayer(64, 4, **kw), v)
    with torch.no_grad():
        got = tm(_t(q), _t(time), _t(pos), None if ref is None else _t(ref), shapes)
    _close(got, jax.jit(lambda v: jm.apply(v, *args))(v))


@pytest.mark.parametrize("pos_type", ["sine", "learned"])
def test_deformable_head_msda(pos_type):
    """msda head of 2 layers on a 10x12 grid; learned tables of 50 entries
    (JAX's max(50, h)), filled U(0, 1) by flax."""
    kw = dict(num_layers=2, num_heads=4, ffn_dim=128, attn_type="msda", pos_type=pos_type)
    jm = jheads.DeformableHeadWithTime(7, 64, **kw)
    x, time = _randn(2, 10, 12, 64), _randn(2, 256, seed=1)
    v = jax.jit(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(time)))()
    tm = _port(theads.DeformableHeadWithTime(7, 64, **kw), v)
    with torch.no_grad():
        got = tm(_t(x), _t(time))
    assert tuple(got.shape) == (2, 10, 12, 7)
    _close(got, jax.jit(jm.apply)(v, jnp.asarray(x), jnp.asarray(time)))


# --- the tiny msda segmentor ------------------------------------------------------

def _msda_cfg():
    cfg = get_config("tiny_seg")
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, decoder_attn="msda"))


def test_msda_sample_matches_jax():
    """Same weights and initial noise; step-1 logits within 1e-4 abs (f32),
    the final probabilities by value and argmax (later steps re-embed an
    argmax)."""
    cfg = _msda_cfg()
    jm = _jax_model(cfg.model)
    variables = jax.jit(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)},
        jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 64, 64), jnp.int32), train=False))()
    img = _randn(2, 64, 64, 3)
    want, j_noise, j_logits = _jax_sample(jm, variables, img)
    tm = build_model(cfg.model, device="cpu")
    load_flax(tm, _np(variables["params"]), _np(variables["batch_stats"]))
    tcap = []
    denoise = tm.denoise_logits
    tm.denoise_logits = lambda *a: tcap.append(denoise(*a)) or tcap[-1]
    got = tm.sample(_t(img), init_noise=_t(j_noise)).numpy()
    _close(tcap[0].numpy(), j_logits, atol=1e-4)
    _close(got, want, atol=1e-4)
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.999


@functools.lru_cache(maxsize=1)
def _jax_steps():
    """JAX's f32 and bf16 training forward and gradients of the tiny msda
    segmentor at the test's batch, t and noise (dropout off)."""
    cfg = _msda_cfg()
    jm = _jax_model(cfg.model)
    variables = jax.jit(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)},
        jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 64, 64), jnp.int32), train=False))()
    img, gt = _batch((64, 64))
    rng = np.random.RandomState(1)
    t = rng.uniform(0.0, 0.999, 2).astype(np.float32)
    noise = rng.randn(2 * 16 * 16, cfg.model.embed_dims).astype(np.float32)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdiff, "sample_times", lambda *a, **k: jnp.asarray(t))
        for mixed in (False, True):
            out[mixed] = _jax_train_forward(jm, variables, jnp.asarray(img), jnp.asarray(gt),
                                            jnp.asarray(t), jnp.asarray(noise),
                                            mixed_precision=mixed)
    return cfg, variables, (img, gt, t, noise), out


def _port_state(cfg, variables):
    tm = build_model(dataclasses.replace(cfg.model, drop_path_rate=0.0), device="cpu")
    load_flax(tm, _np(variables["params"]), _np(variables["batch_stats"]))
    return TrainState(_no_dropout(tm), toptim.make_optimizer(cfg.optim, tm),
                      torch.Generator().manual_seed(0))


def test_msda_train_step_matches_jax():
    cfg, variables, (img, gt, t, noise), jax_out = _jax_steps()
    loss_j, _, grads_j = jax_out[False]
    state = _port_state(cfg, variables)
    batch = {"image": _t(img), "label": _t(gt), "t": _t(t), "noise": _t(noise)}
    grads, logs = make_train_step(mixed_precision=False).grads(state, batch)
    np.testing.assert_allclose(logs["loss"].item(), float(loss_j), rtol=1e-5)
    want = params_from_flax(grads_j)
    assert set(want) == set(state.optimizer.names)
    for name, g in zip(state.optimizer.names, grads):
        w = want[name].numpy()
        tol = 1e-3 * np.abs(w).max() + 1e-6
        assert np.abs(g.numpy() - w).max() <= tol, (name, np.abs(g.numpy() - w).max(), tol)


def test_msda_bf16_train_step_matches_jax():
    """test_bf16_train_step_matches_jax's tolerances: the loss within 1e-2
    relative, each gradient within 2^-2 · max|g| of JAX's bf16 gradient and
    the median within 2^-5, and the port's bf16 gradient no further from
    JAX's f32 gradient than twice JAX's bf16 one plus 2^-5 · max|g|."""
    cfg, variables, (img, gt, t, noise), jax_out = _jax_steps()
    state = _port_state(cfg, variables)
    batch = {"image": _t(img), "label": _t(gt), "t": _t(t), "noise": _t(noise)}
    grads, logs = make_train_step(mixed_precision=True).grads(state, batch)
    loss_j = float(jax_out[True][0])
    assert abs(logs["loss"].item() - loss_j) <= 1e-2 * abs(loss_j)
    want16, want32 = params_from_flax(jax_out[True][2]), params_from_flax(jax_out[False][2])
    rel = []
    for name, g in zip(state.optimizer.names, grads):
        g, w16, w32 = g.numpy(), want16[name].numpy(), want32[name].numpy()
        d = np.abs(g - w16).max()
        rel.append(d / np.abs(w16).max())
        assert d <= 2.0 ** -2 * np.abs(w16).max(), (name, d)
        port_err, ref_err = np.abs(g - w32).max(), np.abs(w16 - w32).max()
        assert port_err <= 2.0 * ref_err + 2.0 ** -5 * np.abs(w32).max(), (name, port_err,
                                                                            ref_err)
    assert np.median(rel) <= 2.0 ** -5, np.median(rel)


@pytest.mark.parametrize("preset,film,pos", [("tiny_seg", "v2", "learned"),
                                             ("ade20k_swin_t_msda", "v1", "sine")])
def test_bridge_covers_msda(preset, film, pos):
    """convert.py maps every flax leaf of the msda decoder (attn/
    {sampling_offsets, attention_weights, value_proj, output_proj},
    pos_enc/{row,col}_embed/embedding, v2's 4C time_mlp) and fills every
    torch entry. Shapes only: jax.eval_shape and the meta device."""
    cfg = get_config(preset)
    m = dataclasses.replace(cfg.model, decoder_attn="msda", decoder_film=film,
                            decoder_pos=pos)
    jm = _jax_model(m, decoder_film=film, decoder_pos=pos)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)},
        jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 64, 64), jnp.int32), train=False))

    def leaves(tree):
        return jax.tree_util.tree_map(
            lambda s: np.broadcast_to(np.zeros((), s.dtype), s.shape), tree)

    sd = params_from_flax(leaves(shapes["params"]), leaves(shapes["batch_stats"]))
    check_complete(build_model(m, device="meta"), sd)
    layer = "decode_head.encoder.layer0"
    assert tuple(sd[f"{layer}.time_mlp.weight"].shape) == (
        (4 if film == "v2" else 2) * m.embed_dims, 4 * m.embed_dims)
    assert ("decode_head.pos_enc.row_embed.weight" in sd) == (pos == "learned")


@pytest.mark.parametrize("preset", ["ade20k_swin_t_msda", "converge_seg_msda",
                                    "converge_seg_aligned_msda"])
def test_msda_presets_match_jax(preset):
    """Every field the port has equals the JAX preset's, but the workdir:
    ade20k_swin_t_msda is the JAX package's _seg("ade20k_swin_t", ...,
    decoder_attn="msda") (8 heads), the end checks its presets of the same
    names, whose results the port's runs never overwrite."""
    if preset == "ade20k_swin_t_msda":
        ref = jconfig._seg("ade20k_swin_t", "swin", "tiny", "ade20k", 150, (512, 512), 16,
                           0.01, decoder_attn="msda")
    else:
        ref = jconfig.get_config(preset)
        assert get_config(preset).runtime.workdir == f"work_dirs/torch_{preset}"
    port = get_config(preset)
    assert port.model.decoder_heads == 8 and port.model.decoder_attn == "msda"
    for part in ("model", "data", "optim", "runtime"):
        for f in dataclasses.fields(getattr(port, part)):
            if f.name == "workdir":
                continue
            a, b = getattr(getattr(port, part), f.name), getattr(getattr(ref, part), f.name)
            if dataclasses.is_dataclass(a):
                a, b = dataclasses.asdict(a), dataclasses.asdict(b)
            assert a == b, (part, f.name)


# --- init ---------------------------------------------------------------------------

def test_init_params_msda_layers():
    """Offsets' and attention weights' kernels 0, the offsets' bias the ring,
    attention weights' bias 0, value/output projections xavier-uniform
    (bound sqrt(6 / (fan_in + fan_out)), variance bound^2 / 3), learned
    position tables U(0, 1)."""
    m = dataclasses.replace(_msda_cfg().model, decoder_pos="learned")
    model = build_model(m, device="cpu", seed=3)
    sd = model.state_dict()
    for i in range(m.decoder_layers):
        a = f"decode_head.encoder.layer{i}.attn"
        for name in ("sampling_offsets.weight", "attention_weights.weight",
                     "attention_weights.bias"):
            assert not sd[f"{a}.{name}"].any(), name
        np.testing.assert_array_equal(sd[f"{a}.sampling_offsets.bias"].numpy(),
                                      jtr._offset_bias_init(m.decoder_heads, 1, 4))
        for name in ("value_proj", "output_proj"):
            w = sd[f"{a}.{name}.weight"]
            bound = (6.0 / (w.shape[0] + w.shape[1])) ** 0.5
            assert w.abs().max() <= bound and w.abs().max() > 0.9 * bound, name
            assert abs(w.var().item() / (bound ** 2 / 3) - 1.0) < 0.1, name
            assert not sd[f"{a}.{name}.bias"].any()
    for name in ("row_embed", "col_embed"):
        w = sd[f"decode_head.pos_enc.{name}.weight"]
        assert tuple(w.shape) == (50, m.embed_dims // 2)
        assert w.min() >= 0.0 and w.max() < 1.0 and abs(w.mean().item() - 0.5) < 0.05
