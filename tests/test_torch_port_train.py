"""The torch port's training slice against the JAX package, on the CPU.

  - The tiny preset's training forward and backward against JAX's
    ``DDPSegmentor.__call__`` (train=True) with the same weights (through
    ``convert.load_flax``), the same t and noise, and dropout and drop path
    off: losses, accuracy, every parameter's gradient and the BatchNorm
    statistics after the step, for ``loss_at`` full (the fused upsample+CE),
    quarter, the resize + CE branch, and ``self_aligned``. JAX's PRNG cannot
    be reproduced in torch, so on the JAX side ``sample_times`` returns the
    test's t, ``corrupt_fused`` is routed through the JAX package's own
    ``fused_q_sample`` with the test's noise (an ``nn.intercept_methods``
    interceptor, which also makes ``nn.Dropout`` the identity), and the
    self-aligned branch's noise is captured from its first ``denoise_logits``
    call and handed to the port.
  - The optimizer against ``make_optimizer``'s optax chain, the decay mask and
    lr multipliers of every parameter of ``ade20k_swin_t``.
  - microbatching, ``train()`` on SyntheticSegDataset, bit-exact resume, and
    the statistics of dropout and drop path.
"""
import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ddp_tpu.core.diffusion as jdiff
from ddp_tpu.core.diffusion import DiffusionConfig as JDiffusionConfig
from ddp_tpu.core.schedules import log_snr_to_alpha_sigma as j_alpha_sigma
from ddp_tpu.models.segmentor import DDPSegmentor as JDDPSegmentor
from ddp_tpu.ops.pallas.q_sample import fused_q_sample
from ddp_tpu.train import optim as joptim
from ddp_tpu_torch.config import build_model, get_config
from ddp_tpu_torch.convert import load_flax, params_from_flax
from ddp_tpu_torch.data.seg_datasets import SyntheticSegDataset
from ddp_tpu_torch.nn.common import drop_path, dropout
from ddp_tpu_torch.train import optim as toptim
from ddp_tpu_torch.train.checkpoint import CheckpointManager
from ddp_tpu_torch.train.loop import train
from ddp_tpu_torch.train.step import TrainState, make_train_step

MEAN = np.array([123.675, 116.28, 103.53], np.float32)
STD = np.array([58.395, 57.12, 57.375], np.float32)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_model(m, **kw):
    d = m.diffusion
    args = dict(num_classes=m.num_classes, backbone_variant=m.backbone_variant,
                embed_dims=m.embed_dims, bit_scale=m.bit_scale, drop_path_rate=0.0,
                decoder_layers=m.decoder_layers, decoder_heads=m.decoder_heads,
                decoder_ffn_dim=m.decoder_ffn_dim, decoder_attn=m.decoder_attn,
                decoder_window=m.decoder_window,
                diffusion=JDiffusionConfig(timesteps=d.timesteps, randsteps=d.randsteps,
                                           accumulation=d.accumulation))
    args.update(kw)
    return JDDPSegmentor(**args)


def _no_dropout(model):
    """The port's tiny model with drop path and dropout off."""
    for mod in model.modules():
        if hasattr(mod, "drop_path"):
            mod.drop_path = 0.0
    model.aux_head.dropout = 0.0
    return model


def _batch(hw, b=2, k=7, seed=0):
    rng = np.random.RandomState(seed)
    img = rng.randn(b, *hw, 3).astype(np.float32)
    gt = rng.randint(0, k, (b, *hw)).astype(np.int32)
    gt[0, :5, :9] = 255
    gt[1, -4:, :] = 255
    return img, gt


def _jax_train_forward(jm, variables, img, gt, t, noise):
    """JAX loss, logs, grads and new batch_stats with the test's t and noise
    (and, for self_aligned, the stage-1 noise JAX drew, captured)."""

    def run(params, stats):
        cap = {}

        def intercept(next_fun, args, kwargs, context):
            if isinstance(context.module, fnn.Dropout):
                return args[0]
            if context.method_name == "corrupt_fused":
                mod, labels = context.module, args[1]
                b, h, w = labels.shape
                log_snr = mod.diffusion.log_snr_fn(t)
                alpha, sigma = j_alpha_sigma(log_snr)
                table = mod.embedding_table.embedding
                rows = fused_q_sample(labels.reshape(-1), table, mod.bit_scale,
                                      jnp.repeat(alpha, h * w), jnp.repeat(sigma, h * w),
                                      noise.reshape(b * h * w, -1))
                return rows.reshape(b, h, w, -1), log_snr
            if context.method_name == "denoise_logits" and "noise" not in cap:
                cap["noise"] = args[1]
            return next_fun(*args, **kwargs)

        def loss_fn(p):
            with fnn.intercept_methods(intercept):
                (loss, logs), mut = jm.apply(
                    {"params": p, "batch_stats": stats}, img, gt, train=True,
                    rngs={"diffusion": jax.random.PRNGKey(3), "dropout": jax.random.PRNGKey(4)},
                    mutable=["batch_stats"])
            return loss, (logs, mut["batch_stats"], cap["noise"])

        (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        return loss, aux, grads

    return _np(jax.jit(run)(variables["params"], variables["batch_stats"]))


@pytest.mark.parametrize("case", ["full", "quarter", "resize", "self_aligned"])
def test_train_forward_and_grads_match_jax(case, monkeypatch):
    """'resize': a 66x66 image gives a 17x17 grid, not a x4 of the labels, so
    both packages take the resize + CE branch."""
    cfg = get_config("tiny_seg")
    m = cfg.model
    kw = {"quarter": dict(loss_at="quarter"), "self_aligned": dict(self_aligned=True)}.get(
        case, {})
    hw = (66, 66) if case == "resize" else (64, 64)
    jm = _jax_model(m, decoder_attn="window", **kw)
    variables = jax.jit(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)},
        jnp.zeros((1,) + hw + (3,)), jnp.zeros((1,) + hw, jnp.int32), train=False))()
    # non-trivial BN statistics, so that the running update is checked
    variables = dict(variables, batch_stats=jax.tree_util.tree_map(
        lambda a: a + 0.5, variables["batch_stats"]))
    img, gt = _batch(hw)
    h = -(-hw[0] // 4)
    rng = np.random.RandomState(1)
    t = rng.uniform(0.0, 0.999, 2).astype(np.float32)
    noise = rng.randn(2 * h * h, m.embed_dims).astype(np.float32)
    monkeypatch.setattr(jdiff, "sample_times", lambda *a, **k: jnp.asarray(t))
    loss_j, (logs_j, stats_j, noise_j), grads_j = _jax_train_forward(
        jm, variables, jnp.asarray(img), jnp.asarray(gt), jnp.asarray(t), jnp.asarray(noise))

    tm = build_model(dataclasses.replace(m, drop_path_rate=0.0, **kw), device="cpu")
    load_flax(tm, _np(variables["params"]), _np(variables["batch_stats"]))
    _no_dropout(tm).train()
    port_noise = noise_j if case == "self_aligned" else noise
    loss, logs = tm(torch.from_numpy(img), torch.from_numpy(gt), t=torch.from_numpy(t),
                    noise=torch.from_numpy(np.asarray(port_noise)))
    loss.backward()

    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    for key in ("decode.loss_ce", "aux.loss_ce", "loss"):
        np.testing.assert_allclose(logs[key].item(), float(logs_j[key]), rtol=1e-5, err_msg=key)
    np.testing.assert_allclose(logs["decode.acc_seg"].item(), float(logs_j["decode.acc_seg"]),
                               atol=1e-3)
    want = params_from_flax(grads_j)
    named = dict(tm.named_parameters())
    assert set(want) == set(named)
    for name, p in named.items():
        g = p.grad.numpy() if p.grad is not None else np.zeros(p.shape, np.float32)
        w = want[name].numpy()
        tol = 1e-3 * np.abs(w).max() + 1e-6
        assert np.abs(g - w).max() <= tol, (name, np.abs(g - w).max(), tol)
    sd = tm.state_dict()
    for name, v in params_from_flax(variables["params"], stats_j).items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[name].numpy(), v.numpy(), rtol=1e-5, err_msg=name)


def _opt_cases():
    base = dict(lr=1e-3, total_steps=20, weight_decay=0.05)
    return {
        # grad_clip 0.5 is far below the random gradients' norm: clip active
        "warmup_poly_clip": dict(base, warmup_steps=3, warmup_ratio=1e-3, grad_clip=0.5),
        "cyclic": dict(base, schedule="cyclic", total_steps=8, grad_clip=100.0),
        "layer_decay": dict(base, warmup_steps=0, grad_clip=100.0, layer_decay_rate=0.8),
    }


@pytest.mark.parametrize("case", sorted(_opt_cases()))
def test_optimizer_matches_optax(case):
    cfg_kw = _opt_cases()[case]
    m = get_config("tiny_seg").model
    jm = _jax_model(m, decoder_attn="window")
    params = jax.jit(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)},
        jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 64, 64), jnp.int32), train=False))()["params"]
    tx = joptim.make_optimizer(joptim.OptimConfig(**cfg_kw), params)
    peak_lr = cfg_kw["lr"] * (10.0 if cfg_kw.get("schedule") == "cyclic" else 1.0)
    opt_state = tx.init(params)
    tm = build_model(m, device="cpu")
    sd = params_from_flax(_np(params))
    with torch.no_grad():
        for name, p in tm.named_parameters():
            p.copy_(sd[name])
    topt = toptim.make_optimizer(toptim.OptimConfig(**cfg_kw), tm)
    rng = np.random.RandomState(0)
    update = jax.jit(lambda g, s, p: tx.update(g, s, p))
    for _ in range(5):
        grads = jax.tree_util.tree_map(
            lambda a: jnp.asarray(rng.randn(*a.shape).astype(np.float32)), params)
        upd, opt_state = update(grads, opt_state, params)
        params = optax.apply_updates(params, upd)
        tg = params_from_flax(_np(grads))
        g_norm = topt.step([tg[name] for name in topt.names])
        np.testing.assert_allclose(g_norm.item(), float(optax.global_norm(grads)), rtol=1e-6)
    want = params_from_flax(_np(params))
    for name, p in tm.named_parameters():
        # atol 1e-5 x the peak lr: XLA's float32 pow makes optax's bias
        # corrections (decay ** count) ~1e-6 relative off the correctly
        # rounded value (measured), which moves each step by ~lr * 1e-6; rtol
        # cannot hold that for parameters near 0
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-6,
                                   atol=1e-5 * peak_lr, err_msg=name)


@pytest.mark.parametrize("layer_decay", [None, 0.9])
def test_decay_mask_and_lr_mults_match_jax(layer_decay):
    """Every parameter of ade20k_swin_t: the port's (lr_mult, decay) from its
    torch name equals the JAX package's from the flax path."""
    cfg = get_config("ade20k_swin_t")
    jm = _jax_model(cfg.model, decoder_attn="window")
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)},
        jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 64, 64), jnp.int32), train=False))["params"]
    jcfg = joptim.OptimConfig(layer_decay_rate=layer_decay)
    tcfg = toptim.OptimConfig(layer_decay_rate=layer_decay)
    # each leaf carries its own index through the bridge's rename and transpose
    flat, tree = jax.tree_util.tree_flatten_with_path(shapes)
    ids = jax.tree_util.tree_unflatten(tree, [
        np.broadcast_to(np.float32(i), s.shape) for i, (_, s) in enumerate(flat)])
    index_of = {name: int(v.reshape(-1)[0]) for name, v in params_from_flax(ids).items()}
    want = {}
    for i, (path, s) in enumerate(flat):
        lm, dm = joptim._rule_for(joptim._path_str(path), np.zeros((1,) * len(s.shape)),
                                  jcfg.custom_keys)
        if layer_decay is not None:
            lid = joptim.layer_id_for_path(joptim._path_str(path), jcfg.layer_decay_num_layers)
            lm *= layer_decay ** (jcfg.layer_decay_num_layers + 1 - lid)
        want[i] = (lm, dm > 0)
    named = list(build_model(cfg.model, device="meta").named_parameters())
    mults, mask = toptim.param_rules(tcfg, named)
    assert len(named) == len(flat)
    for (name, _), lm, dm in zip(named, mults, mask):
        assert (lm, dm) == pytest.approx(want[index_of[name]]), name


def test_lr_schedules_match_jax():
    for kw in (dict(), dict(schedule="cosine", min_lr=1e-6), dict(schedule="constant"),
               dict(schedule="cyclic", total_steps=100)):
        jl = joptim.make_lr_schedule(joptim.OptimConfig(**kw))
        tl = toptim.make_lr_schedule(toptim.OptimConfig(**kw))
        for step in (0, 1, 700, 1500, 40, 99, 80_000, 160_000):
            # atol: near the cyclic floor (lr·1e-4) JAX's float32 cosine is
            # ~1e-11 off the double-precision schedule
            np.testing.assert_allclose(tl(step), float(jl(step)), rtol=1e-6, atol=1e-6 * 6e-5,
                                       err_msg=str(kw))
    jm = joptim.make_momentum_schedule(joptim.OptimConfig(total_steps=100))
    tmom = toptim.make_momentum_schedule(toptim.OptimConfig(total_steps=100))
    for step in (0, 20, 40, 70, 100):
        np.testing.assert_allclose(tmom(step), float(jm(step)), rtol=1e-6)


def _tiny_state(seed=0, **model_kw):
    cfg = get_config("tiny_seg")
    model = _no_dropout(build_model(dataclasses.replace(cfg.model, drop_path_rate=0.0,
                                                        **model_kw), device="cpu", seed=seed))
    return TrainState(model, toptim.make_optimizer(cfg.optim, model),
                      torch.Generator().manual_seed(seed))


def test_microbatch_matches_full_batch():
    """Fixed t and noise; aux_weight 0 takes BatchNorm (whose statistics are
    per chunk) off the path, so the two chunkings give the same gradients."""
    img, gt = _batch((64, 64), b=4)
    rng = np.random.RandomState(2)
    batch = {"image": torch.from_numpy(img), "label": torch.from_numpy(gt),
             "t": torch.from_numpy(rng.uniform(0, 0.999, 4).astype(np.float32)),
             "noise": torch.from_numpy(rng.randn(4 * 16 * 16, 64).astype(np.float32))}
    got = {}
    for mb in (1, 2):
        state = _tiny_state(aux_weight=0.0)
        got[mb] = make_train_step(microbatch=mb).grads(state, batch)
    (g1, l1), (g2, l2) = got[1], got[2]
    np.testing.assert_allclose(l1["loss"].item(), l2["loss"].item(), rtol=1e-5)
    for a, b in zip(g1, g2):
        assert (a - b).abs().max().item() <= 1e-5 * a.abs().max().item() + 1e-7


def _batches(ds, batch_size, start=0):
    i = start * batch_size
    while True:
        items = [ds.load(j % len(ds)) for j in range(i, i + batch_size)]
        i += batch_size
        yield {"image": np.stack([(it["image"] - MEAN) / STD for it in items]),
               "label": np.stack([it["label"] for it in items])}


def _loop_cfg(tmp_path, total, **rt):
    cfg = get_config("tiny_seg")
    return dataclasses.replace(
        cfg,
        optim=dataclasses.replace(cfg.optim, schedule="constant", lr=1e-3, grad_clip=1.0),
        runtime=dataclasses.replace(cfg.runtime, total_iters=total, log_interval=1,
                                    ckpt_interval=total, workdir=str(tmp_path),
                                    mixed_precision=False, tensorboard=False, **rt))


def test_train_loop_loss_falls(tmp_path):
    ds = SyntheticSegDataset(num_classes=7, size=(64, 64), length=64)
    cfg = _loop_cfg(tmp_path, 20)
    train(cfg, _batches(ds, 2), device="cpu")
    import json

    with open(tmp_path / "train_log.jsonl") as f:
        losses = [json.loads(line)["loss"] for line in f]
    assert len(losses) == 20 and np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), losses
    assert CheckpointManager(str(tmp_path)).latest_step() == 20


def test_resume_is_bit_exact(tmp_path):
    """6 steps straight vs 3 steps, a checkpoint, and a resumed 3 more."""
    ds = SyntheticSegDataset(num_classes=7, size=(64, 64), length=64)
    full = train(_loop_cfg(tmp_path / "a", 6), _batches(ds, 2), device="cpu")
    train(_loop_cfg(tmp_path / "b", 3), _batches(ds, 2), device="cpu")
    resumed = train(_loop_cfg(tmp_path / "b", 6), _batches(ds, 2, start=3), resume=True,
                    device="cpu")
    assert resumed.step == full.step == 6
    a, b = full.model.state_dict(), resumed.model.state_dict()
    for name in a:
        assert torch.equal(a[name], b[name]), name
    assert torch.equal(full.generator.get_state(), resumed.generator.get_state())


def test_dropout_and_drop_path_statistics():
    g = torch.Generator().manual_seed(0)
    x = torch.ones(20000, 8)
    y = dropout(x, 0.3, True, g)
    assert abs((y == 0).float().mean().item() - 0.3) < 0.01
    assert abs(y.mean().item() - 1.0) < 0.02
    assert torch.equal(dropout(x, 0.3, False, g), x)
    z = drop_path(torch.ones(20000, 4, 4, 2), 0.25, True, g)
    per_sample = z.reshape(20000, -1)
    assert ((per_sample == 0).all(1) | (per_sample == 1 / 0.75).all(1)).all()
    assert abs((per_sample[:, 0] == 0).float().mean().item() - 0.25) < 0.01
    assert abs(z.mean().item() - 1.0) < 0.02
    # the same generator state gives the same masks
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    assert torch.equal(dropout(x, 0.5, True, g1), dropout(x, 0.5, True, g2))


def test_swin_drop_path_rates_match_jax():
    model = build_model(get_config("ade20k_swin_t").model, device="meta")
    rates = [mod.drop_path for name, mod in model.backbone.named_children()
             if name.startswith("stage")]
    np.testing.assert_allclose(rates, np.linspace(0, 0.3, 12))
    assert model.aux_head.dropout == 0.1


def test_train_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(_loop_cfg(tmp_path, 1), iter(()))
    with pytest.raises(NotImplementedError, match="steps_per_dispatch"):
        train(_loop_cfg(tmp_path, 1, steps_per_dispatch=2), iter(()), device="cpu")
