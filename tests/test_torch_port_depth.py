"""The port's depther (``ddp_tpu_torch/models/depther.py``) against the JAX
package's, on the CPU. The JAX side is jitted; inputs are seeded numpy.

  - ``cosine_gamma`` within 1e-6; ``pixel_shuffle`` bitwise (the JAX layout,
    not ``F.pixel_shuffle``'s); ``DeformableDepthHead`` for each variant
    (deform, upconv, spade) x activation (relu, softplus) within 1e-5;
    ``sig_loss``'s value and gradient with invalid pixels within 1e-6
    relative; ``depth_metrics`` within 1e-12.
  - The tiny depther as a whole against JAX's (loss, gradients, the bf16
    step, sample, uncertainty, the bridge): ``test_torch_port_depth_model.py``.
  - The presets and ``build_model``; ``conv_depth``'s bias init;
    ``build_model`` refuses ``decoder_remat`` (not ported); a depth batch (float label) through the eager step and the
    chunked step, which must agree bit for bit on the CPU.
"""
import dataclasses

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
from ddp_tpu_torch.convert import load_flax
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


# --- the tiny depther's configuration (its tests: test_torch_port_depth_model.py) --

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
    with pytest.raises(ValueError, match="unknown task"):
        build_model(dataclasses.replace(mc, task="not_a_task"), device="cpu")


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
