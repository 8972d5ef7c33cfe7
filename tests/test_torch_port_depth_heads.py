"""The port's depth decode heads (``ddp_tpu_torch/nn/depth_heads.py``) against
the JAX package's, on the CPU.

Weights: each head's flax variable tree, shaped by ``jax.eval_shape``
(``flax_shapes.shapes_of``) and
filled with seeded numpy values, carried across by ``convert.py``; the JAX
side is one float64 jitted call: every head's forward and its VJP.

  - DenseDepthHead (sigmoid, and relu with BatchNorm in the decoder),
    AdabinsHead (8 queries out of 64 tokens, and 11 out of 12: fewer than
    ``n_query_channels``), BTSHead, NeWCRFHead on sizes its windows pad,
    and BinsFormerHead: the port's float32 eval outputs within 1e-4 · max|y|
    + 1e-6 of JAX's float64 ones (AdaBins: depth and bin edges);
    ``local_planar_guidance`` alone.
  - The gradient of each of the five heads' mean square depth (AdaBins:
    plus its edges') in float64: loss within 1e-5 relative, every gradient
    within 1e-3 · max|g| + 1e-6.
  - flax's ``MultiHeadDotProductAttention`` through ``convert.py``'s rule.
  - AdabinsHead refuses a second map size and more than 500 tokens.
  - The reference gap the port follows (AdaBins' query count and
    ``conv_out`` width), and every class and function of JAX's depth heads
    has a port counterpart.
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

from ddp_tpu.nn import depth_heads as jdh
from ddp_tpu_torch.convert import load_flax, params_from_flax
from ddp_tpu_torch.nn import depth_heads as tdh


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
            return rng.randn(*shape) / np.sqrt(max(np.prod(shape[:-2 if len(shape) == 3 and
                                                                path[-2].key == "out"
                                                                else -1]), 1))
        if name == "scale":
            return 1.0 + 0.1 * rng.randn(*shape)
        if name == "var":
            return rng.uniform(0.5, 1.5, shape)
        return 0.1 * rng.randn(*shape)

    tree = jax.tree_util.tree_map_with_path(leaf, shapes)
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


CH = (8, 16, 24, 32)
UP = (8, 16, 16, 32)


def _pyr(h, w, ch=CH):
    return [(2, -(-h // 2 ** i), -(-w // 2 ** i), c) for i, c in enumerate(ch)]


ADA = dict(up_sample_channels=UP, n_bins=16, n_query_channels=16, embedding_dim=16,
           patch_size=4)
# name -> (JAX head, port head factory, input shapes)
CASES = {
    "densedepth": (jdh.DenseDepthHead(UP), lambda: tdh.DenseDepthHead(CH, UP), _pyr(16, 16)),
    "densedepth_relu_bn": (jdh.DenseDepthHead(UP, scale_up=False, norm="BN"),
                           lambda: tdh.DenseDepthHead(CH, UP, scale_up=False, norm="BN"),
                           _pyr(16, 12)),
    # 8 x 8 tokens: 16 of the 63 are queries
    "adabins": (jdh.AdabinsHead(**ADA), lambda: tdh.AdabinsHead(CH, (32, 32), **ADA),
                _pyr(32, 32)),
    # 4 x 3 tokens: 11 queries, not 16
    "adabins_few": (jdh.AdabinsHead(**ADA), lambda: tdh.AdabinsHead(CH, (16, 12), **ADA),
                    _pyr(16, 12)),
    "bts": (jdh.BTSHead(channels=8), lambda: tdh.BTSHead(CH, channels=8), _pyr(16, 16)),
    # 10 x 14, 5 x 7, 3 x 4: windows of 4 and 3 pad
    "newcrf": (jdh.NeWCRFHead(channels=8), lambda: tdh.NeWCRFHead(CH, channels=8),
               _pyr(10, 14)),
    "binsformer": (jdh.BinsFormerHead(n_bins=8, channels=16),
                   lambda: tdh.BinsFormerHead(CH, n_bins=8, channels=16), _pyr(12, 10)),
}

# the heads whose gradients are held to JAX's (the two variants share their
# modules with densedepth and adabins)
GRADS = ("densedepth", "adabins", "bts", "newcrf", "binsformer")


def _outs(o):
    return o if isinstance(o, tuple) else (o,)


def _sq_loss(outs):
    return sum((o * o).mean() for o in outs)


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
    """name -> (variables, inputs, eval outputs, (loss, grads)); the LPG
    case's plane and output. One float64 jitted call: each head's forward
    and, through its VJP, the gradient of its loss."""
    rng = np.random.RandomState(1)
    variables, inputs = {}, {}
    for name, (jmod, _, shapes) in CASES.items():
        inputs[name] = [rng.randn(*s).astype(np.float32) for s in shapes]
        variables[name] = fill_variables(shapes_of(jmod, inputs[name], train=False))
    plane = rng.randn(2, 3, 4, 4).astype(np.float32)
    plane[..., 2] += 4.0  # keep the denominator away from 0

    def run(vs, xs, plane):
        out = {}
        for n in CASES:
            def fwd(p, n=n):
                return _outs(CASES[n][0].apply({**vs[n], "params": p}, xs[n], train=False))

            if n not in GRADS:
                out[n] = (fwd(vs[n]["params"]), None, None)
                continue
            outs, vjp = jax.vjp(fwd, vs[n]["params"])
            (grads,) = vjp(tuple(2.0 * o / o.size for o in outs))
            out[n] = (outs, _sq_loss(outs), grads)
        return out, jdh.local_planar_guidance(plane, 4)

    with float64():
        out, lpg = jax.jit(run)(_f64(variables), _f64(inputs), _f64(plane))
        out, lpg = jax.tree_util.tree_map(np.asarray, (out, lpg))
    cases = {n: (variables[n], inputs[n], list(o), None if loss is None else (float(loss), g))
             for n, (o, loss, g) in out.items()}
    return cases, (plane, lpg)


def _port(name):
    variables = jax_cases()[0][name][0]
    model = CASES[name][1]()
    load_flax(model, variables["params"], variables.get("batch_stats"))
    return model.eval()


def _close_scaled(got, want, rel=1e-4, floor=1e-6):
    err = np.abs(got - want).max()
    tol = rel * np.abs(want).max() + floor
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("name", sorted(CASES))
def test_head_matches_jax(name):
    _, xs, want, _ = jax_cases()[0][name]
    model = _port(name)
    with torch.no_grad():
        got = _outs(model([torch.from_numpy(x) for x in xs]))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close_scaled(g.numpy(), w)


@pytest.mark.parametrize("name", GRADS)
def test_head_gradients_match_jax(name):
    _, xs, _, (loss_j, grads_j) = jax_cases()[0][name]
    model = _port(name).double()
    loss = _sq_loss(_outs(model([torch.from_numpy(x).double() for x in xs])))
    assert abs(loss.item() - loss_j) <= 1e-5 * abs(loss_j)
    named = dict(model.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    want = params_from_flax(grads_j)
    assert set(want) == set(named)
    for key, w in want.items():
        w = w.numpy()
        err = np.abs(grads[key].numpy() - w).max()
        assert err <= 1e-3 * np.abs(w).max() + 1e-6, (key, err)


def test_local_planar_guidance_matches_jax():
    plane, want = jax_cases()[1]
    got = tdh.local_planar_guidance(torch.from_numpy(plane), 4).numpy()
    assert got.shape == want.shape == (2, 12, 16)
    _close_scaled(got, want, rel=1e-5)


def test_flax_mha_conversion_matches_flax():
    """query/key/value kernels [E, H, D] and out [H, D, E], biases [H, D]."""
    rng = np.random.RandomState(4)
    q, kv = rng.randn(2, 5, 12).astype(np.float32), rng.randn(2, 7, 12).astype(np.float32)
    mha = fnn.MultiHeadDotProductAttention(num_heads=3)
    variables = fill_variables(shapes_of(mha, q, kv))
    want = np.asarray(mha.apply(variables, jnp.asarray(q), jnp.asarray(kv)))
    port = tdh.FlaxMultiHeadAttention(12, 3)
    load_flax(port, variables["params"])
    with torch.no_grad():
        got = port(torch.from_numpy(q), torch.from_numpy(kv)).numpy()
    _close_scaled(got, want, rel=1e-5)


def test_adabins_refuses_a_second_size_and_a_long_sequence():
    model = _port("adabins")
    xs = [torch.zeros(s) for s in _pyr(16, 16)]
    with pytest.raises(ValueError, match="built for"):
        model(xs)
    big = tdh.AdabinsHead(CH, (96, 96), **ADA)  # 24 x 24 = 576 tokens
    with pytest.raises(ValueError, match="500-row"):
        big([torch.zeros(s) for s in _pyr(96, 96)])


def test_reference_gap_adabins_query_count():
    """JAX keeps tgt[:, 1:n_query_channels + 1]: with fewer tokens there are
    fewer queries, and conv_out's input width follows the map's size
    (ROADMAP queue 3). The port fixes it at construction."""
    shapes = {n: jax.tree_util.tree_map(np.shape, jax_cases()[0][n][0]["params"])
              for n in ("adabins", "adabins_few")}
    assert shapes["adabins"]["conv_out"]["kernel"] == (1, 1, 16, 16)
    assert shapes["adabins_few"]["conv_out"]["kernel"] == (1, 1, 11, 16)
    assert _port("adabins").n_queries == 16 and _port("adabins_few").n_queries == 11


def test_every_jax_name_has_a_port_counterpart():
    names = {n for n, v in vars(jdh).items()
             if inspect.isclass(v) or inspect.isfunction(v)
             if getattr(v, "__module__", None) == jdh.__name__}
    assert len(names) >= 10
    missing = sorted(n for n in names if not hasattr(tdh, n))
    assert not missing, missing
