"""The port's compat segmentors with the part-II heads and backbones
(``ddp_tpu_torch/models/compat_segmentor.py``: EncHead's SE-loss branch,
EMANet's frozen conv) against the JAX package's, on the CPU, and the weight
bridge of the four part-II configurations that ``chip_smoke.py`` runs at
full width.

Weights: the flax variable tree shaped by ``jax.eval_shape`` and filled with
seeded numpy values, carried across by ``convert.py``; the JAX side is
jitted once for both training steps. Dropout is 0 on both sides (the JAX aux head through
a subclass), so neither draws.

  - A tiny EncNet (ResNet-18 at width 8, EncHead 16 with 8 codes and the SE
    loss, the FCN aux head) and a tiny EMANet (EMAHead 16, 8 bases): one
    training step's forward and backward in float64 on both sides, as the
    part-I segmentor test holds them: the loss within 1e-5 relative and
    every log key (``loss_se`` among them), every gradient within
    1e-3 · max|g| + 1e-6, the BatchNorm statistics and the EMA bases within
    1e-5 of their max; the EncNet's float32 ``predict`` equal to JAX's
    argmax on at least 99.9 % of the pixels.
  - EMANet's frozen ``ema_mid`` conv: its gradient is exactly 0 on both
    sides (the port's ``train/step.py: param_grads`` fills 0 for the
    parameters the loss does not reach), and one AdamW step (constant lr 1e-3, weight decay 0.05,
    float32) moves it as optax moves it (the kernel by its decay only),
    within 1e-6 relative + 1e-5 · lr.
  - Every flax leaf of encnet_r50-d8, ccnet_r50-d8, emanet_r50-d8 and
    fast_scnn maps through ``params_from_flax`` onto the port's modules
    (``check_complete``), shapes from ``jax.eval_shape``, the port built on
    the meta device.
  - Four reference gaps the port follows (ROADMAP queue 3).
"""
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ddp_tpu.models import compat_segmentor as jseg
from ddp_tpu.nn import head_registry as jreg
from ddp_tpu.nn import heads as jheads
from ddp_tpu.nn import lightweight as jlw
from ddp_tpu.nn import losses as jlosses
from ddp_tpu.nn import resnet as jres
from ddp_tpu.train import optim as joptim
from ddp_tpu_torch.convert import check_complete, load_flax, params_from_flax
from ddp_tpu_torch.models import compat_segmentor as tseg
from ddp_tpu_torch.nn import head_registry as treg
from ddp_tpu_torch.nn import lightweight as tlw
from ddp_tpu_torch.nn import resnet as tres
from ddp_tpu_torch.train import optim as toptim
from ddp_tpu_torch.train.step import param_grads

K = 5
B, S = 3, 48


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: beside the other test workers an OpenMP team
    waits at every one of the many small ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def fill_variables(shapes, seed: int = 0):
    """Seeded numpy leaves for a flax variables tree of shapes."""
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name, shape = path[-1].key, s.shape
        if name == "kernel":
            return rng.randn(*shape) / np.sqrt(max(np.prod(shape[:-1]), 1))
        if name == "scale":
            return 1.0 + 0.1 * rng.randn(*shape)
        if name == "var":
            return rng.uniform(0.5, 1.5, shape)
        return 0.1 * rng.randn(*shape)

    tree = jax.tree_util.tree_map_with_path(leaf, shapes)
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


class _JaxEncoderDecoder(jseg.EncoderDecoder):
    """JAX's EncoderDecoder with the aux head's dropout at 0."""

    def setup(self):
        kw = dict(self.head_kwargs or {})
        kw.setdefault("num_classes", self.num_classes)
        self.decode_head = jreg.build_head(self.head_name, **kw)
        self.auxiliary_head = jheads.FCNHead(self.num_classes, norm="BN", dropout=0.0)


def _dropout_off(model):
    for m in model.modules():
        if isinstance(getattr(m, "dropout", None), float):
            m.dropout = 0.0
    return model


TINY = dict(depth=18, stem_channels=8, base_channels=8)
HEAD_KW = {"encnet": ("enc", dict(channels=16, num_codes=8, dropout=0.0)),
           "emanet": ("ema", dict(channels=16, ema_channels=16, num_bases=8, dropout=0.0))}


def _jax_model(name):
    head, kw = HEAD_KW[name]
    return _JaxEncoderDecoder(jres.ResNet(**TINY), head, K, head_kwargs=kw)


def _port_model(name):
    head, kw = HEAD_KW[name]
    return _dropout_off(tseg.EncoderDecoder(tres.ResNet(**TINY), head, K, head_kwargs=kw))


def _batch(seed=3):
    rng = np.random.RandomState(seed)
    img = rng.randn(B, S, S, 3).astype(np.float32)
    gt = rng.randint(0, K, (B, S, S)).astype(np.int32)
    gt[:, :4] = 255  # ignored pixels
    gt[1][gt[1] == 2] = 255  # class 2 absent from image 1: an SE target of 0
    return img, gt


@contextlib.contextmanager
def float64():
    """JAX with 64-bit floats inside (the tests run it at 32 otherwise)."""
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


@functools.lru_cache(maxsize=None)
def jax_cases():
    """name -> (variables, (loss, logs), grads, new batch stats) of one
    float64 training step of each model, both in one jitted call, and the
    float32 predict of the EncNet."""
    img, gt = _batch()
    rngs = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}
    jmods = {n: _jax_model(n) for n in HEAD_KW}
    variables = {n: fill_variables(jax.eval_shape(lambda: m.init(rngs, img, gt, train=False)))
                 for n, m in jmods.items()}

    def steps(params, stats, img, gt):
        def loss_fn(p, st, jmod):
            (loss, logs), new = jmod.apply({"params": p, "batch_stats": st}, img, gt,
                                           train=True, mutable=["batch_stats"])
            return loss, (logs, new["batch_stats"])

        return {n: jax.value_and_grad(loss_fn, has_aux=True)(params[n], stats[n], m)
                for n, m in jmods.items()}

    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    with float64():
        out = jax.jit(steps)({n: _f64(v["params"]) for n, v in variables.items()},
                             {n: _f64(v["batch_stats"]) for n, v in variables.items()},
                             _f64(img), gt)
        cases = {n: (variables[n], (float(loss), {k: float(v) for k, v in logs.items()}),
                     to_np(grads), to_np(stats))
                 for n, ((loss, (logs, stats)), grads) in out.items()}
    enc = jmods["encnet"]
    pred = jax.jit(lambda v, x: enc.apply(v, x, method=enc.predict))(variables["encnet"], img)
    return cases, np.asarray(pred)


def jax_case(name):
    return jax_cases()[0][name]


def _port_step(name):
    variables, *_ = jax_case(name)
    model = _port_model(name)
    load_flax(model, variables["params"], variables["batch_stats"])
    img, gt = (torch.from_numpy(a) for a in _batch())
    model.double().train()
    loss, logs = model(img.double(), gt.long())
    params = list(model.parameters())
    for p, g in zip(params, param_grads(loss, params)):  # as the port's train step
        p.grad = g
    return model, loss, logs


@pytest.mark.parametrize("name", ["encnet", "emanet"])
def test_segmentor_step_matches_jax(name):
    variables, (loss_j, logs_j), grads_j, stats_j = jax_case(name)
    model, loss, logs = _port_step(name)
    assert abs(loss.item() - loss_j) <= 1e-5 * abs(loss_j)
    assert set(logs) == set(logs_j)
    if name == "encnet":
        assert "loss_se" in logs and logs["loss_se"].item() > 0
    for k, v in logs_j.items():
        assert abs(logs[k].item() - v) <= 1e-5 * max(abs(v), 1e-3), k
    named = dict(model.named_parameters())
    want_g = params_from_flax(grads_j)
    assert set(want_g) == set(named)
    for key, w in want_g.items():
        w = w.numpy()
        err = np.abs(named[key].grad.numpy() - w).max()
        assert err <= 1e-3 * np.abs(w).max() + 1e-6, (key, err)
    sd = model.state_dict()
    stats = params_from_flax(variables["params"], stats_j)
    if name == "emanet":
        assert "decode_head.ema.bases" in stats
    for key, w in stats.items():
        if not key.endswith("num_batches_tracked"):
            w = w.numpy()
            assert np.abs(sd[key].numpy() - w).max() <= 1e-5 * np.abs(w).max() + 1e-7, key
    if name == "encnet":  # predict, float32, in eval mode with JAX's statistics
        pred_j = jax_cases()[1]
        load_flax(model.float(), variables["params"], variables["batch_stats"])
        pred = model.predict(torch.from_numpy(_batch()[0])).numpy()
        assert pred.shape == pred_j.shape
        assert (pred == pred_j).mean() >= 0.999


def test_emanet_frozen_conv_and_adamw_step_match_jax():
    """JAX's stop_gradient gives ema_mid a gradient of exactly 0, and so does
    the port's param_grads (ema_mid runs under torch.no_grad); AdamW's
    decoupled decay still moves them, in both packages."""
    variables, _, grads_j, _ = jax_case("emanet")
    model, _, _ = _port_step("emanet")
    for leaf in ("kernel", "bias"):
        assert not np.asarray(grads_j["decode_head"]["ema_mid"][leaf]).any()
    mid = model.decode_head.ema_mid
    assert mid.weight.grad is not None and mid.bias.grad is not None
    assert not mid.weight.grad.any() and not mid.bias.grad.any()

    cfg = dict(lr=1e-3, schedule="constant", warmup_steps=0, warmup_ratio=1.0,
               weight_decay=0.05, grad_clip=100.0)
    # optax on the frozen conv's subtree alone (Adam is per parameter, and
    # the clip at 100 is inactive: the port's global norm is checked below)
    jparams = {"decode_head": {"ema_mid": variables["params"]["decode_head"]["ema_mid"]}}
    jgrads = {"decode_head": {"ema_mid": jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), grads_j["decode_head"]["ema_mid"])}}
    tx = joptim.make_optimizer(joptim.OptimConfig(**cfg), jparams)
    upd, _ = tx.update(jgrads, tx.init(jparams), jparams)
    want = params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                   optax.apply_updates(jparams, upd)))
    port_grads = {n: p.grad.float() for n, p in model.named_parameters()}
    load_flax(model.float(), variables["params"], variables["batch_stats"])
    opt = toptim.make_optimizer(toptim.OptimConfig(**cfg), model)
    assert opt.step([port_grads[n] for n in opt.names]).item() < cfg["grad_clip"]
    for key in ("decode_head.ema_mid.weight", "decode_head.ema_mid.bias"):
        got = dict(model.named_parameters())[key].detach().numpy()
        before = params_from_flax(jparams)[key].numpy()
        np.testing.assert_allclose(got, want[key].numpy(), rtol=1e-6, atol=1e-5 * 1e-3,
                                   err_msg=key)
        if key.endswith("weight"):  # decayed, by lr·wd·p and nothing else
            np.testing.assert_allclose(got, before * (1 - 1e-3 * 0.05), rtol=1e-6)


def test_autograd_grad_reaches_every_parameter():
    """``torch.autograd.grad`` over every parameter of EMANet and of
    BiSeNetV2 (a loss over all its maps) reaches all of them but the ones
    that run under ``torch.no_grad``, as JAX's ``stop_gradient`` or its
    computed-and-dropped branch: ``ema_mid`` and ``bga_s2``, whose BatchNorm
    statistics still move in training. ``param_grads`` gives those exactly
    0, as JAX does, and every other parameter its gradient."""
    img, gt = (torch.from_numpy(a) for a in _batch())
    ema = _port_model("emanet").train()
    bise = tlw.BiSeNetV2((8, 8, 16), (8, 8, 16, 16)).train()
    stats0 = bise.bga_s2_bn.running_mean.clone()
    for model, loss_fn in ((ema, lambda: ema(img, gt.long())[0]),
                           (bise, lambda: sum(o.square().mean() for o in bise(img)))):
        named = list(model.named_parameters())
        params = [p for _, p in named]
        loss = loss_fn()
        grads = torch.autograd.grad(loss, params, allow_unused=True, retain_graph=True)
        unreached = {n for (n, _), g in zip(named, grads) if g is None}
        assert unreached == ({"decode_head.ema_mid.weight", "decode_head.ema_mid.bias"}
                             if model is ema else {"bga_s2_conv.weight", "bga_s2_bn.weight",
                                                   "bga_s2_bn.bias"}), unreached
        for (n, p), g, want in zip(named, param_grads(loss, params), grads):
            assert g.shape == p.shape
            assert not g.any() if n in unreached else torch.equal(g, want), n
    assert not torch.equal(bise.bga_s2_bn.running_mean, stats0)


# the four part-II configurations of chip_smoke.py's compat_main, at their
# widths: (JAX model, port model factory)
def _published():
    r50_d8 = dict(depth=50, strides=(1, 2, 1, 1), dilations=(1, 1, 2, 4))
    heads = {
        "encnet_r50-d8": ("enc", dict(channels=512, num_codes=32, use_se_loss=True)),
        "ccnet_r50-d8": ("cc", dict(channels=512, recurrence=2, concat_input=True)),
        "emanet_r50-d8": ("ema", dict(channels=256, ema_channels=512, num_bases=64,
                                      num_stages=3, momentum=0.1)),
    }
    out = {name: (jseg.EncoderDecoder(jres.ResNet(**r50_d8), head, 19, head_kwargs=kw),
                  functools.partial(tseg.EncoderDecoder, tres.ResNet(**r50_d8), head, 19,
                                    head_kwargs=kw))
           for name, (head, kw) in heads.items()}
    fast = dict(channels=128, concat_input=False)
    out["fast_scnn"] = (jseg.EncoderDecoder(jlw.FastSCNN(), "sep_fcn", 19, head_kwargs=fast),
                        lambda: tseg.EncoderDecoder(tlw.FastSCNN(), "sep_fcn", 19,
                                                    head_kwargs=fast))
    return out


@pytest.mark.parametrize("name", ["encnet_r50-d8", "ccnet_r50-d8", "emanet_r50-d8",
                                  "fast_scnn"])
def test_published_configs_map_every_flax_leaf(name):
    jmod, tmod = _published()[name]
    with torch.device("meta"):
        tmod = tmod()
    img = jnp.zeros((1, 64, 64, 3))
    rngs = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}
    shapes = jax.eval_shape(lambda: jmod.init(rngs, img, jnp.zeros((1, 64, 64), jnp.int32),
                                              train=False))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    check_complete(tmod, params_from_flax(zeros["params"], zeros.get("batch_stats")))


@pytest.mark.parametrize("gap", ["fast_scnn_decodes_lower", "stdc_head", "knet_all_stages",
                                 "psa_one_size"])
def test_part_two_reference_gaps_the_port_follows(gap):
    """Where the JAX package departs from mmseg, the port follows it (ROADMAP
    queue 3): FastSCNN returns (fused, higher, lower) (mmseg: (higher,
    lower, fused), decoded at in_index -1), so EncoderDecoder's head decodes
    the 1/32 map; STDCHead's one channel cannot drive EncoderDecoder's
    cross-entropy (JAX's loss is NaN, the port's gather raises); KNet's
    ``all_stages`` list cannot pass EncoderDecoder; PSAHead's weights fit one
    map size."""
    img, gt = (torch.from_numpy(a) for a in _batch())
    if gap == "fast_scnn_decodes_lower":
        model = tseg.EncoderDecoder(tlw.FastSCNN((8, 8, 16), (8, 16, 16)), "sep_fcn", K,
                                    head_kwargs=dict(channels=8))
        assert model.backbone.out_channels == (32, 16, 16)
        with torch.no_grad():
            logits, aux, _ = model.eval().forward_logits(img)
        assert logits.shape == (B, 2, 2, K) and aux.shape == (B, 6, 6, K)  # 1/32, 1/8
        jm = jseg.EncoderDecoder(jlw.FastSCNN((8, 8, 16), (8, 16, 16)), "sep_fcn", K,
                                 head_kwargs=dict(channels=8))
        shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), img.numpy(),
                                                method=jm.forward_logits))
        out = jax.eval_shape(lambda v: jm.apply(v, img.numpy(), method=jm.forward_logits),
                             shapes)
        assert out[0].shape == (B, 2, 2, K)
    elif gap == "stdc_head":
        model = tseg.EncoderDecoder(tres.ResNet(**TINY), "stdc", K, head_kwargs=dict(channels=8))
        with torch.no_grad():
            assert model.eval().forward_logits(img)[0].shape[-1] == 1
        with pytest.raises((RuntimeError, IndexError)):
            model(img, gt.long())
        one = jnp.zeros((1, 2, 2, 1))
        assert not np.isfinite(float(jlosses.cross_entropy_seg(one, jnp.ones((1, 2, 2),
                                                                             jnp.int32))))
    elif gap == "knet_all_stages":
        model = tseg.EncoderDecoder(tres.ResNet(**TINY), "knet", K, head_kwargs=dict(
            channels=16, num_stages=1, num_heads=2, all_stages=True))
        with pytest.raises(AttributeError):
            model(img, gt.long())
        jm = jseg.EncoderDecoder(jres.ResNet(**TINY), "knet", K, head_kwargs=dict(
            channels=16, num_stages=1, num_heads=2, all_stages=True))
        with pytest.raises(AttributeError):
            jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), img.numpy(),
                                           gt.numpy(), train=False))
    else:
        head = treg.build_head("psa", [8], num_classes=K, feat_size=(4, 4), channels=8)
        with torch.no_grad():
            assert head.eval()([torch.randn(1, 4, 4, 8)]).shape == (1, 4, 4, K)
            with pytest.raises(ValueError, match="built for"):
                head([torch.randn(1, 6, 6, 8)])
        jh = jreg.build_head("psa", num_classes=K, channels=8)
        shapes = jax.eval_shape(lambda: jh.init(jax.random.PRNGKey(0), [jnp.zeros((1, 4, 4, 8))]))
        assert shapes["params"]["collect_attn1"]["kernel"].shape == (1, 1, 8, 4)
        with pytest.raises(Exception, match="shape"):
            jax.eval_shape(lambda v: jh.apply(v, [jnp.zeros((1, 6, 6, 8))]), shapes)
