"""The port's ConvNeXt backbone and the ``smoke`` segmentor (ConvNeXt nano,
msda decoder) against the JAX package, on the CPU.

  - ``ConvNeXtBlock`` and ``ConvNeXt`` nano with the JAX init's weights
    (layer scales raised to 0.5 so that every block matters), through
    ``convert.py``: float32, atol 1e-5.
  - The ``smoke`` segmentor: ``sample``'s step-1 logits with the noise JAX
    drew (1e-4 abs); one f32 training forward and backward with the same t
    and noise (loss 1e-5 rel, every gradient 1e-3·max|g| + 1e-6).
  - The ConvNeXt importer against the JAX package's ``import_ddp_seg(state,
    "convnext", "nano")`` on one seeded mmcls/mmseg-named state: empty
    reports, step-1 and aux logits 1e-4 abs.
  - Learned positions on a 64x72 grid (tables sized max(50, h) x max(50, w),
    as JAX's init sizes them) against the JAX head, 1e-5.
  - The GELU of the JAX package (tanh) against mmcls's (erf) on
    ConvNeXt-T's backbone with seeded imported weights (ROADMAP.md queue 3).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import ddp_tpu.core.diffusion as jdiff
from ddp_tpu.config import build_model as jbuild_model
from ddp_tpu.config import get_config as jget_config
from ddp_tpu.nn import convnext as jconvnext
from ddp_tpu.nn import heads as jheads
from ddp_tpu.train.torch_import import import_ddp_seg
from ddp_tpu_torch.config import build_model, get_config
from ddp_tpu_torch.convert import check_complete, load_flax, params_from_flax
from ddp_tpu_torch.nn import convnext as tconvnext
from ddp_tpu_torch.nn import heads as theads
from ddp_tpu_torch.train import torch_import as TI
from test_torch_port_segmentor import _jax_sample
from test_torch_port_train import _batch, _jax_train_forward, _no_dropout

HW = (48, 96)  # the tiny Cityscapes files' size


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _randn(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _raise_gammas(variables):
    return jax.tree_util.tree_map_with_path(
        lambda path, a: a + 0.5 if "gamma" in jax.tree_util.keystr(path) else a, variables)


def test_convnext_block_matches_jax():
    jm = jconvnext.ConvNeXtBlock(32)
    x = _randn(2, 9, 13, 32)
    v = _raise_gammas(jax.jit(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))())
    tm = tconvnext.ConvNeXtBlock(32)
    load_flax(tm, _np(v["params"]))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x))),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("hw", [HW, (50, 70)])
def test_convnext_backbone_matches_jax(hw):
    """(50, 70): the stem and the downsamplers floor odd sizes (12x17, 6x8,
    3x4, 1x2)."""
    kw = jconvnext.convnext_variant("nano")
    jm = jconvnext.ConvNeXt(drop_path_rate=0.0, **kw)
    x = _randn(2, *hw, 3)
    v = _raise_gammas(jax.jit(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))())
    tm = tconvnext.ConvNeXt(drop_path_rate=0.0, **tconvnext.convnext_variant("nano"))
    load_flax(tm, _np(v["params"]))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    want = jax.jit(jm.apply)(v, jnp.asarray(x))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)


def test_convnext_init_and_drop_path():
    """The init gives the layer scales 1e-6 (JAX's), drop path grows
    linearly over the blocks to the preset's 0.4."""
    m = get_config("cityscapes_convnext_t").model
    model = build_model(m, device="meta")
    rates = [blk.drop_path for blk in model.backbone.modules()
             if isinstance(blk, tconvnext.ConvNeXtBlock)]
    assert len(rates) == 18 and rates[0] == 0.0 and rates[-1] == pytest.approx(0.4)
    tiny = build_model(get_config("smoke").model, device="cpu")
    assert torch.equal(tiny.backbone.stage2_block0.gamma, torch.full((64,), 1e-6))


def _off_grid(variables):
    """The msda offsets' bias (mmcv's ring of whole pixels at init) moved by
    N(0, 0.3^2) pixels: a point exactly on a pixel centre sits on the kink of
    bilinear sampling, where the two packages' roundings of its location
    pick different corners and so different offset gradients."""
    rng = np.random.RandomState(9)

    def move(path, a):
        key = jax.tree_util.keystr(path)
        if "sampling_offsets" in key and "bias" in key:
            return a + jnp.asarray(0.3 * rng.randn(*a.shape).astype(np.float32))
        return a

    return jax.tree_util.tree_map_with_path(move, variables)


def _smoke():
    cfg = get_config("smoke")
    jm = jbuild_model(jget_config("smoke").model)
    variables = jax.jit(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)},
        jnp.zeros((1, *HW, 3)), jnp.zeros((1, *HW), jnp.int32), train=False))()
    return cfg, jm, _off_grid(_raise_gammas(variables))


@pytest.mark.parametrize("preset", ["smoke", "cityscapes_convnext_t"])
def test_bridge_is_complete(preset):
    """Every flax leaf of the JAX segmentor has a home in the port's and every
    entry is filled (shapes from jax.eval_shape, the port on the meta
    device)."""
    jm = jbuild_model(jget_config(preset).model)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)},
        jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 64, 64), jnp.int32), train=False))

    def leaves(tree):
        return jax.tree_util.tree_map(
            lambda s: np.broadcast_to(np.zeros((), s.dtype), s.shape), tree)

    sd = params_from_flax(leaves(shapes["params"]), leaves(shapes["batch_stats"]))
    check_complete(build_model(get_config(preset).model, device="meta"), sd)


def test_smoke_sample_matches_jax():
    cfg, jm, variables = _smoke()
    img = _randn(2, *HW, 3, seed=1)
    want, j_noise, j_logits = _jax_sample(jm, variables, img)
    tm = build_model(cfg.model, device="cpu")
    load_flax(tm, _np(variables["params"]), _np(variables["batch_stats"]))
    tcap = []
    denoise = tm.denoise_logits
    tm.denoise_logits = lambda *a: tcap.append(denoise(*a)) or tcap[-1]
    got = tm.sample(torch.from_numpy(img), init_noise=torch.from_numpy(j_noise)).numpy()
    assert tcap[0].shape == (2, HW[0] // 4, HW[1] // 4, cfg.model.num_classes)
    np.testing.assert_allclose(tcap[0].numpy(), j_logits, rtol=0, atol=1e-4)
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.999


def test_smoke_train_step_matches_jax(monkeypatch):
    """One f32 training forward and backward, dropout off, the same t and
    noise: losses 1e-5 rel, every gradient 1e-3·max|g| + 1e-6."""
    cfg, jm, variables = _smoke()
    m = cfg.model
    img, gt = _batch(HW)
    rng = np.random.RandomState(1)
    t = rng.uniform(0.0, 0.999, 2).astype(np.float32)
    noise = rng.randn(2 * (HW[0] // 4) * (HW[1] // 4), m.embed_dims).astype(np.float32)
    monkeypatch.setattr(jdiff, "sample_times", lambda *a, **k: jnp.asarray(t))
    loss_j, (logs_j, _, _), grads_j = _jax_train_forward(
        jm, variables, jnp.asarray(img), jnp.asarray(gt), jnp.asarray(t), jnp.asarray(noise))

    tm = build_model(m, device="cpu")
    load_flax(tm, _np(variables["params"]), _np(variables["batch_stats"]))
    _no_dropout(tm).train()
    loss, logs = tm(torch.from_numpy(img), torch.from_numpy(gt), t=torch.from_numpy(t),
                    noise=torch.from_numpy(noise))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    for key in ("decode.loss_ce", "aux.loss_ce"):
        np.testing.assert_allclose(logs[key].item(), float(logs_j[key]), rtol=1e-5, err_msg=key)
    want = params_from_flax(grads_j)
    named = dict(tm.named_parameters())
    assert set(want) == set(named)
    for name, p in named.items():
        g = p.grad.numpy() if p.grad is not None else np.zeros(p.shape, np.float32)
        w = want[name].numpy()
        tol = 1e-3 * np.abs(w).max() + 1e-6
        assert np.abs(g - w).max() <= tol, (name, np.abs(g - w).max(), tol)


def test_convnext_import_matches_jax_import():
    """One seeded state under mmcls's ConvNeXt names and mmseg's neck and
    head names through both importers and both forwards."""
    cfg = get_config("smoke")
    m = cfg.model
    state = TI.synthetic_mmseg_state(m)
    assert "backbone.stages.2.0.pointwise_conv1.weight" in state
    jvars, jreport = import_ddp_seg(state, "convnext", "nano", decoder_layers=m.decoder_layers)
    assert jreport == {"missing": [], "unused": []}
    tm = build_model(m, device="cpu")
    assert TI.load_mmseg_state(tm, state, cfg) == {"missing": [], "unused": []}
    assert torch.equal(tm.backbone.stage1_block0.dwconv.weight,
                       torch.from_numpy(state["backbone.stages.1.0.depthwise_conv.weight"]))

    jm = jbuild_model(jget_config("smoke").model)
    img = _randn(2, *HW, 3, seed=2)
    _, j_noise, j_logits = _jax_sample(jm, jvars, img)
    aux_want = jax.jit(lambda v, x: jm.apply(
        v, x, method=lambda mod, x: mod.aux_head(mod.extract_feat(x))))(jvars, jnp.asarray(img))
    tcap = []
    denoise = tm.denoise_logits
    tm.denoise_logits = lambda *a: tcap.append(denoise(*a)) or tcap[-1]
    with torch.no_grad():
        tm.sample(torch.from_numpy(img), init_noise=torch.from_numpy(j_noise))
        aux = tm.aux_head(tm.extract_feat(torch.from_numpy(img))).numpy()
    assert np.abs(j_logits).max() > 1.0  # the weights give logits of O(1), not ~0
    np.testing.assert_allclose(tcap[0].numpy(), j_logits, rtol=0, atol=1e-4)
    np.testing.assert_allclose(aux, np.asarray(aux_want), rtol=0, atol=1e-4)


def test_cityscapes_msda_checkpoint_shape_loads():
    """A released Cityscapes checkpoint holds ConvNeXt-T and an 8-head msda
    decoder: the preset with the two overrides takes its names and shapes
    with an empty report (meta device: nothing full-size is allocated)."""
    cfg = get_config("cityscapes_convnext_t", {"model.decoder_attn": "msda",
                                               "model.decoder_heads": "8"})
    state = TI.synthetic_mmseg_state(cfg.model)
    sd, report, _ = TI.import_mmseg_seg(state, cfg.model)
    assert report == {"missing": [], "unused": []}
    want = build_model(cfg.model, device="meta").state_dict()
    assert set(sd) == set(want)
    assert all(tuple(sd[k].shape) == tuple(v.shape) for k, v in want.items())
    # the preset as it is (window decoder) is refused by name
    with pytest.raises(ValueError, match="msda"):
        TI.import_mmseg_seg(state, get_config("cityscapes_convnext_t").model)


def test_learned_positions_above_50_match_jax():
    """decoder_pos='learned' on a 64x72 grid: JAX sizes the tables max(50,
    64) x max(50, 72) at init; the port sizes them for the grid it is built
    for. Weights bridge with their shapes; outputs 1e-5."""
    kw = dict(num_layers=1, num_heads=4, ffn_dim=64, attn_type="msda", pos_type="learned")
    jm = jheads.DeformableHeadWithTime(7, 32, **kw)
    x, time = _randn(1, 64, 72, 32), _randn(1, 128, seed=1)
    v = jax.jit(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(time)))()
    assert v["params"]["pos_enc"]["row_embed"]["embedding"].shape == (64, 16)
    assert v["params"]["pos_enc"]["col_embed"]["embedding"].shape == (72, 16)
    tm = theads.DeformableHeadWithTime(7, 32, pos_grid=(64, 72), **kw)
    load_flax(tm, _np(v["params"]))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(time)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x),
                                                                jnp.asarray(time))),
                               rtol=0, atol=1e-5)
    # the segmentor sizes them from the image size it is built for
    m = dataclasses.replace(get_config("cityscapes_convnext_t").model, decoder_pos="learned")
    model = build_model(m, device="meta", input_size=(512, 1024))
    assert tuple(model.decode_head.pos_enc.row_embed.weight.shape) == (128, 128)
    assert tuple(model.decode_head.pos_enc.col_embed.weight.shape) == (256, 128)
    with pytest.raises(ValueError, match="position tables"):
        tm(torch.zeros(1, 65, 72, 32), torch.from_numpy(time))


def test_gelu_tanh_vs_erf_reference_discrepancy(monkeypatch):
    """Reference fault (ROADMAP.md queue 3): the JAX package's ConvNeXt (and
    Swin) GELU is flax's tanh approximation, mmcls's is the exact erf form.
    ConvNeXt-T with seeded imported weights (mmcls names, layer scales
    0.5 + N(0, 0.1)) on one 64x128 image: the port follows JAX (tanh); with
    the erf GELU the four LN'd stage outputs (values of O(1)) move by max |d|
    4.6e-4, 7.1e-4, 8.8e-4 and 9.6e-4, growing with depth, some hundred times
    float32 rounding. Held: each between 2e-4 and 1e-2."""
    cfg = get_config("cityscapes_convnext_t", {"model.decoder_attn": "msda",
                                               "model.decoder_heads": "8"})
    state = TI.synthetic_mmseg_state(cfg.model)
    sd, _, _ = TI.import_mmseg_seg(state, cfg.model)
    backbone = tconvnext.ConvNeXt(drop_path_rate=0.0, **tconvnext.convnext_variant("tiny"))
    backbone.load_state_dict({k[len("backbone."):]: v for k, v in sd.items()
                              if k.startswith("backbone.")})
    x = torch.from_numpy(_randn(1, 64, 128, 3, seed=3))
    with torch.no_grad():
        tanh = backbone(x)
        monkeypatch.setattr(tconvnext, "gelu", lambda a: F.gelu(a))
        erf = backbone(x)
    diffs = [(a - b).abs().max().item() for a, b in zip(tanh, erf)]
    assert all(2e-4 < d < 1e-2 for d in diffs), diffs
