"""The port's neck zoo (``ddp_tpu_torch/nn/necks.py``) against the JAX
package's, on the CPU.

Weights: each neck's flax variable tree, shaped by ``jax.eval_shape``
(``flax_shapes.shapes_of``) and
filled with seeded numpy values, carried across by ``convert.py``; the JAX
side is one jitted call for every eval case and one float64 call for the
training case.

  - PPM (odd sizes, so each pooled grid cuts rows), PSPNeck,
    MultiLevelNeck (four maps, and one map shared by every scale),
    Feature2Pyramid at each rescale (x4, x2, x1, x0.5 on odd grids, and
    x0.25), SkipNeck, HAHINeck over 3 transformer levels with and without
    its self- and cross-attention, and JPU from a start level: eval maps
    within 1e-4 · max|y| + 1e-6, each map's channels as ``out_channels``
    names them. Feature2Pyramid raises KeyError on another rescale.
  - A float64 training-mode forward and backward of HAHINeck (3 levels:
    per-level starts, normalizers and per-batch reference points of the
    MSDA op) and Feature2Pyramid (its x4 BatchNorm): the loss (the mean
    square of every output) within 1e-5 relative, every gradient within
    1e-3 · max|g| + 1e-6, the BatchNorm statistics within 1e-5 of their
    max.
  - flax's ``ConvTranspose`` (SAME, k = s = 2) through ``convert.py``'s
    rule against ``nn.ConvTranspose2d``; without the tap reversal it
    differs.
  - The reference gap the port follows (the neck PPM's cut rows), and
    every class and function of JAX's necks has a port counterpart.
"""
import contextlib
import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from flax_shapes import shapes_of

from ddp_tpu.nn import necks as jnk
from ddp_tpu_torch.convert import load_flax, params_from_flax
from ddp_tpu_torch.nn import necks as tnk
from torch_port_threads import _one_torch_thread  # noqa: F401


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


PYR = [(2, 16, 16, 8), (2, 8, 8, 16), (2, 4, 4, 16), (2, 2, 2, 16)]
HAHI = dict(embedding_dim=16, num_points=2, num_heads=2)
HAHI_OUT = (8, 16, 16, 16)
F2P_IN = [(2, 5, 6, 16)] * 4
# name -> (JAX module, port module factory, input shapes); a PPM takes one map
CASES = {
    "ppm_odd": (jnk.PPM(32), lambda: tnk.PPM(16, 32), [(2, 13, 14, 16)]),
    "psp_neck": (jnk.PSPNeck(32), lambda: tnk.PSPNeck([8, 16], 32),
                 [(2, 16, 16, 8), (2, 12, 13, 16)]),
    "multilevel": (jnk.MultiLevelNeck(8), lambda: tnk.MultiLevelNeck([16] * 4, 8),
                   [(2, 8, 8, 16)] * 4),
    "multilevel_one": (jnk.MultiLevelNeck(8), lambda: tnk.MultiLevelNeck([16], 8),
                       [(2, 8, 8, 16)]),
    "f2p": (jnk.Feature2Pyramid(16), lambda: tnk.Feature2Pyramid(16), F2P_IN),
    "f2p_quarter": (jnk.Feature2Pyramid(16, rescales=(0.25, 2.0, 1.0)),
                    lambda: tnk.Feature2Pyramid(16, rescales=(0.25, 2.0, 1.0)),
                    [(2, 9, 10, 16)] * 3),
    "skip": (jnk.SkipNeck(), lambda: tnk.SkipNeck(), [(2, 8, 8, 4)] * 4),
    "hahi": (jnk.HAHINeck(HAHI_OUT, **HAHI), lambda: tnk.HAHINeck([8, 16, 16, 16], HAHI_OUT,
                                                                  **HAHI), PYR),
    "hahi_no_self": (jnk.HAHINeck(HAHI_OUT, **HAHI, self_att=False),
                     lambda: tnk.HAHINeck([8, 16, 16, 16], HAHI_OUT, **HAHI, self_att=False),
                     PYR),
    "hahi_no_cross": (jnk.HAHINeck(HAHI_OUT, **HAHI, cross_att=False),
                      lambda: tnk.HAHINeck([8, 16, 16, 16], HAHI_OUT, **HAHI,
                                           cross_att=False), PYR),
    "jpu": (jnk.JPU(mid_channels=8, dilations=(1, 2), start_level=1),
            lambda: tnk.JPU([8, 16, 16, 16], mid_channels=8, dilations=(1, 2), start_level=1),
            PYR),
}
TRAIN = ("hahi", "f2p")


def _arg(name, xs):
    return xs[0] if name.startswith("ppm") else xs


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


def _sq_loss(outs):
    return sum((o * o).mean() for o in outs)


@functools.lru_cache(maxsize=None)
def jax_cases():
    """name -> (variables, inputs, float32 eval outputs, float64 training
    (loss, grads, new batch stats) or None)."""
    rng = np.random.RandomState(1)
    variables, inputs = {}, {}
    for name, (jmod, _, shapes) in CASES.items():
        inputs[name] = [rng.randn(*s).astype(np.float32) for s in shapes]
        variables[name] = fill_variables(shapes_of(jmod, _arg(name, inputs[name]), train=False))
    ev = jax.jit(lambda vs, xs: {n: CASES[n][0].apply(vs[n], _arg(n, xs[n]), train=False)
                                 for n in CASES})(variables, inputs)

    def train(vs, xs):
        out = {}
        for n in TRAIN:
            def loss_fn(p, n=n):
                outs, new = CASES[n][0].apply({**vs[n], "params": p}, xs[n], train=True,
                                              mutable=["batch_stats"])
                return _sq_loss(outs), new["batch_stats"]

            (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(vs[n]["params"])
            out[n] = (loss, grads, stats)
        return out

    with float64():
        tr = jax.jit(train)({n: _f64(variables[n]) for n in TRAIN},
                            {n: _f64(inputs[n]) for n in TRAIN})
        tr = {n: (float(v[0]), *jax.tree_util.tree_map(np.asarray, v[1:])) for n, v in tr.items()}
    return {n: (variables[n], inputs[n], [np.asarray(o) for o in ev[n]], tr.get(n))
            for n in CASES}


def _port(name):
    variables = jax_cases()[name][0]
    model = CASES[name][1]()
    load_flax(model, variables.get("params", {}), variables.get("batch_stats"))
    return model


def _close_scaled(got, want, rel=1e-4, floor=1e-6):
    err = np.abs(got - want).max()
    tol = rel * np.abs(want).max() + floor
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("name", sorted(CASES))
def test_neck_matches_jax(name):
    _, xs, want, _ = jax_cases()[name]
    model = _port(name).eval()
    with torch.no_grad():
        got = model(_arg(name, [torch.from_numpy(x) for x in xs]))
    assert len(got) == len(want)
    if hasattr(model, "out_channels"):
        assert [w.shape[-1] for w in want] == list(model.out_channels)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close_scaled(g.numpy(), w)


@pytest.mark.parametrize("name", TRAIN)
def test_neck_training_step_matches_jax(name):
    variables, xs, _, (loss_j, grads_j, stats_j) = jax_cases()[name]
    model = _port(name).double().train()
    loss = _sq_loss(model([torch.from_numpy(x).double() for x in xs]))
    assert abs(loss.item() - loss_j) <= 1e-5 * abs(loss_j)
    named = dict(model.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    want = params_from_flax(grads_j)
    assert set(want) == set(named)
    for key, w in want.items():
        w = w.numpy()
        err = np.abs(grads[key].numpy() - w).max()
        assert err <= 1e-3 * np.abs(w).max() + 1e-6, (key, err)
    if name == "hahi":  # the 3-level MSDA layers carry signal
        assert np.abs(want["self_attn.sampling_offsets.weight"].numpy()).max() > 0
        assert np.abs(want["cross_attn.sampling_offsets.weight"].numpy()).max() > 0
    sd = model.state_dict()
    stats = params_from_flax({}, stats_j)
    assert stats
    for key, w in stats.items():
        if not key.endswith("num_batches_tracked"):
            w = w.numpy()
            assert np.abs(sd[key].numpy() - w).max() <= 1e-5 * np.abs(w).max() + 1e-7, key


def test_feature2pyramid_refuses_an_unknown_rescale():
    x = np.zeros((1, 4, 4, 8), np.float32)
    with pytest.raises(KeyError, match="invalid rescale"):
        jnk.Feature2Pyramid(8, rescales=(3.0,)).init(jax.random.PRNGKey(0), [x])
    with pytest.raises(KeyError, match="invalid rescale"):
        tnk.Feature2Pyramid(8, rescales=(3.0,))


def test_conv_transpose_conversion_matches_flax():
    """flax ConvTranspose (transpose_kernel=False, SAME, k = s = 2) computes
    out[2i + j] = x[i]·w[1 − j]; the rule reverses the taps."""
    rng = np.random.RandomState(5)
    x = rng.randn(2, 3, 5, 4).astype(np.float32)
    kernel = rng.randn(2, 2, 4, 6).astype(np.float32)
    bias = rng.randn(6).astype(np.float32)
    want = np.asarray(fnn.ConvTranspose(6, (2, 2), strides=(2, 2)).apply(
        {"params": {"kernel": kernel, "bias": bias}}, jnp.asarray(x)))
    sd = params_from_flax({"up2_0": {"kernel": kernel, "bias": bias}})
    conv = torch.nn.ConvTranspose2d(4, 6, 2, 2)
    conv.load_state_dict({"weight": sd["up2_0.weight"], "bias": sd["up2_0.bias"]})
    with torch.no_grad():
        got = conv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 6, 10, 6)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    with torch.no_grad():  # the plain layout change, taps not reversed, differs
        conv.weight.copy_(torch.from_numpy(kernel.transpose(2, 3, 0, 1)))
        plain = conv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert np.abs(plain - want).max() > 0.1


def test_reference_gap_neck_ppm_cuts_rows():
    """The neck's PPM averages the map cut to h // s · s rows and w // s · s
    columns, in JAX and in the port; mmseg's adaptive pool covers them all
    (ROADMAP queue 3)."""
    x = torch.from_numpy(np.random.RandomState(2).randn(1, 7, 8, 32).astype(np.float32))
    ppm = tnk.PPM(32, 32, pool_scales=(3,)).eval()
    conv = ppm.pool3
    with torch.no_grad():
        got = conv(x[:, :6, :6].reshape(1, 3, 2, 3, 2, 32).mean(dim=(2, 4)))
        full = conv(torch.nn.functional.adaptive_avg_pool2d(
            x.permute(0, 3, 1, 2), 3).permute(0, 2, 3, 1))
        branch = ppm(x)[0]
    from ddp_tpu_torch.ops.resize import resize

    np.testing.assert_allclose(branch.numpy(), resize(got, (7, 8)).numpy(), rtol=1e-6,
                               atol=1e-6)
    assert (got - full).abs().max() > 1e-3


def test_every_jax_name_has_a_port_counterpart():
    names = {n for n, v in vars(jnk).items()
             if inspect.isclass(v) or inspect.isfunction(v)
             if getattr(v, "__module__", None) == jnk.__name__}
    assert len(names) >= 7
    missing = sorted(n for n in names if not hasattr(tnk, n))
    assert not missing, missing
