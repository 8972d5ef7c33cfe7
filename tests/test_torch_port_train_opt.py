"""The optimizer and microbatching on the CPU, moved from
``test_torch_port_train.py`` so that a parallel run spreads the files.

  - The optimizer against ``make_optimizer``'s optax chain (warm-up with an
    active clip, the cyclic schedule, layer decay), 5 steps of random
    gradients from JAX's init of ``tiny_seg``.
  - Two microbatches give the full batch's loss and gradients.

The bit-exact resume is in ``test_torch_port_train_resume.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ddp_tpu.train import optim as joptim
from ddp_tpu_torch.config import build_model, get_config
from ddp_tpu_torch.convert import params_from_flax
from ddp_tpu_torch.train import optim as toptim
from ddp_tpu_torch.train.step import TrainState, make_train_step
from test_torch_port_train import _batch, _jax_model, _no_dropout, _np
from torch_port_threads import _one_torch_thread  # noqa: F401


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
