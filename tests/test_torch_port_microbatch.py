"""The port's 1-process microbatched train step against the JAX package's.

``make_train_step(microbatch=2).grads`` of the port against JAX's
``make_train_step(microbatch=2, jit=False)`` (``ddp_tpu/train/state.py:49``,
its ``lax.scan`` over the chunks), on ``tiny_seg`` with the same converted
weights and BatchNorm on (the aux head; statistics offset from their init so
that the running update is checked, and threaded from chunk to chunk in
both packages). JAX's PRNG cannot be reproduced in torch, so each chunk's t
and noise are the test's: on the JAX side ``sample_times`` returns the
chunk's t and ``corrupt_fused`` is routed through the JAX package's own
``fused_q_sample`` with the chunk's noise (the interceptor of
``test_torch_port_train.py``, which also makes ``nn.Dropout`` the
identity), the chunk picked by the index the scan folds into its keys; the
port takes the same t and noise through the batch's ``t`` and ``noise``.
A transformation that keeps the gradients as its state and moves nothing
stands in for JAX's optimizer, so the gradients are read exactly.

Held to the training limits of PERF.md §2: the losses within 1e-5
relative (the accuracy within 1e-3), each gradient within 1e-3 of its
largest element + 1e-6, the BatchNorm statistics after the step within
1e-5 relative.
"""
import dataclasses
import types

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

import ddp_tpu.core.diffusion as jdiff
from ddp_tpu.core.schedules import log_snr_to_alpha_sigma as j_alpha_sigma
from ddp_tpu.ops.pallas.q_sample import fused_q_sample
from ddp_tpu.train import state as jstate
from ddp_tpu_torch.config import build_model, get_config
from ddp_tpu_torch.convert import load_flax, params_from_flax
from ddp_tpu_torch.train import optim as toptim
from ddp_tpu_torch.train.step import TrainState, make_train_step
from test_torch_port_train import _batch, _jax_model, _no_dropout, _np
from torch_port_threads import _one_torch_thread  # noqa: F401

B, K = 4, 2  # the batch and its chunks


def _kept_grads():
    """An optax transformation whose state is the last gradients and whose
    updates are 0."""
    zeros = lambda tree: jax.tree_util.tree_map(jnp.zeros_like, tree)  # noqa: E731
    return optax.GradientTransformation(zeros, lambda g, s, p=None: (zeros(g), g))


def _jax_microbatched_step(jm, variables, img, gt, t, noise, monkeypatch):
    """JAX's step at microbatch K on the whole batch, chunk i's draws t[i]
    and noise[i] ([K, B/K] and [K, B/K·h·w, C]): (logs, gradients, batch
    statistics after)."""
    tx = _kept_grads()
    step = jstate.make_train_step(jm, tx, jit=False, microbatch=K)
    state = jstate.TrainState.create(variables["params"], tx, variables["batch_stats"])
    chunk = {}

    def fold_in(key, data):  # the scan's last fold_in before a forward is the chunk's
        chunk["i"] = data
        return jax.random.fold_in(key, data)

    monkeypatch.setattr(jstate, "jax", types.SimpleNamespace(
        random=types.SimpleNamespace(split=jax.random.split, fold_in=fold_in),
        tree_util=jax.tree_util, value_and_grad=jax.value_and_grad, lax=jax.lax))
    monkeypatch.setattr(jdiff, "sample_times", lambda *a, **k: t[chunk["i"]])

    def intercept(next_fun, args, kwargs, context):
        if isinstance(context.module, fnn.Dropout):
            return args[0]
        if context.method_name == "corrupt_fused":
            mod, labels = context.module, args[1]
            b, h, w = labels.shape
            log_snr = mod.diffusion.log_snr_fn(t[chunk["i"]])
            alpha, sigma = j_alpha_sigma(log_snr)
            rows = fused_q_sample(labels.reshape(-1), mod.embedding_table.embedding,
                                  mod.bit_scale, jnp.repeat(alpha, h * w),
                                  jnp.repeat(sigma, h * w), noise[chunk["i"]])
            return rows.reshape(b, h, w, -1), log_snr
        return next_fun(*args, **kwargs)

    def run(state, batch):
        with fnn.intercept_methods(intercept):
            new, logs = step(state, batch)
        return logs, new.opt_state, new.batch_stats

    return _np(jax.jit(run)(state, {"image": img, "label": gt}))


def test_microbatched_step_matches_jax(monkeypatch):
    m = get_config("tiny_seg").model
    jm = _jax_model(m, decoder_attn="window")
    variables = jax.jit(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)},
        jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 64, 64), jnp.int32), train=False))()
    variables = dict(variables, batch_stats=jax.tree_util.tree_map(
        lambda a: a + 0.5, variables["batch_stats"]))
    img, gt = _batch((64, 64), b=B)
    rng = np.random.RandomState(1)
    t = rng.uniform(0.0, 0.999, B).astype(np.float32)
    noise = rng.randn(B * 16 * 16, m.embed_dims).astype(np.float32)
    logs_j, grads_j, stats_j = _jax_microbatched_step(
        jm, variables, jnp.asarray(img), jnp.asarray(gt), jnp.asarray(t.reshape(K, -1)),
        jnp.asarray(noise.reshape(K, -1, m.embed_dims)), monkeypatch)

    tm = build_model(dataclasses.replace(m, drop_path_rate=0.0), device="cpu")
    load_flax(tm, _np(variables["params"]), _np(variables["batch_stats"]))
    state = TrainState(_no_dropout(tm), toptim.make_optimizer(get_config("tiny_seg").optim, tm),
                       torch.Generator().manual_seed(0))
    batch = {"image": torch.from_numpy(img), "label": torch.from_numpy(gt),
             "t": torch.from_numpy(t), "noise": torch.from_numpy(noise)}
    grads, logs = make_train_step(microbatch=K).grads(state, batch)

    for key in ("decode.loss_ce", "aux.loss_ce", "loss"):
        np.testing.assert_allclose(logs[key].item(), float(logs_j[key]), rtol=1e-5, err_msg=key)
    np.testing.assert_allclose(logs["decode.acc_seg"].item(), float(logs_j["decode.acc_seg"]),
                               atol=1e-3)
    want = params_from_flax(grads_j)
    names = [n for n, _ in tm.named_parameters()]
    assert set(want) == set(names)
    for name, g in zip(names, grads):
        w = want[name].numpy()
        tol = 1e-3 * np.abs(w).max() + 1e-6
        assert np.abs(g.numpy() - w).max() <= tol, (name, np.abs(g.numpy() - w).max(), tol)
    sd = tm.state_dict()
    n_stats = 0
    for name, v in params_from_flax(variables["params"], stats_j).items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[name].numpy(), v.numpy(), rtol=1e-5, err_msg=name)
            n_stats += 1
    assert n_stats > 0
