"""The compat zoo's losses in the port (``ddp_tpu_torch/nn/losses.py``:
``dice_loss``, ``tversky_loss``, ``lovasz_softmax``, ``lovasz_hinge``,
``focal_seg_loss``, ``bins_chamfer_loss``, ``mse_depth_loss``,
``ce_bins_loss``) against the JAX package's (``ddp_tpu/nn/losses.py:200-397``),
on the CPU.

Every case's value and ``jax.grad`` come from one float64 jitted call; the
port's value and ``torch.autograd.grad`` are held to them: the value within
1e-5 relative, the gradient within 1e-3 · max|g| + 1e-6. The labels carry
ignored pixels (255) and a class absent from the batch; Lovász-Softmax runs
with 'present' and 'all', the hinge per image and over the whole batch, the
chamfer loss with an image that has no valid pixel, dice and tversky with
and without class weights. Sorting ties (the ignored pixels' zero errors)
keep their order in both packages (stable sorts).
"""
import contextlib
import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_tpu.nn import losses as jl
from ddp_tpu_torch.nn import losses as tl
from torch_port_threads import _one_torch_thread  # noqa: F401


K = 5


def _data():
    rng = np.random.RandomState(0)
    logits = rng.randn(2, 6, 7, K)
    labels = rng.randint(0, K - 1, (2, 6, 7))  # class K - 1 is absent
    labels[:, 0, :3] = 255
    bin_logits = rng.randn(2, 6, 7)
    bin_labels = rng.randint(0, 2, (2, 6, 7))
    bin_labels[1, 2:4] = 255
    edges = np.cumsum(rng.uniform(0.1, 1.0, (2, 9)), axis=1)
    depth = rng.uniform(0.5, 6.0, (2, 6, 7))
    depth[0, :2] = 0.0  # invalid pixels
    depth[1] = 0.0  # an image with no valid pixel
    pred = rng.uniform(0.5, 6.0, (2, 6, 7))
    bins = rng.randint(0, K, (2, 6, 7))
    weight = rng.uniform(0.5, 1.5, K)
    return dict(logits=logits, labels=labels, bin_logits=bin_logits, bin_labels=bin_labels,
                edges=edges, depth=depth, pred=pred, bins=bins, weight=weight)


# name -> (function of (module, differentiated input, data) -> loss,
#          the differentiated input's key)
CASES = {
    "dice": (lambda m, x, d: m.dice_loss(x, d["labels"]), "logits"),
    "dice_weighted": (lambda m, x, d: m.dice_loss(x, d["labels"], exponent=1.0,
                                                  class_weight=d["weight"]), "logits"),
    "tversky": (lambda m, x, d: m.tversky_loss(x, d["labels"]), "logits"),
    "tversky_weighted": (lambda m, x, d: m.tversky_loss(x, d["labels"], alpha=0.5, beta=0.5,
                                                        class_weight=d["weight"]), "logits"),
    "lovasz_softmax_present": (lambda m, x, d: m.lovasz_softmax(x, d["labels"]), "logits"),
    "lovasz_softmax_all": (lambda m, x, d: m.lovasz_softmax(x, d["labels"], classes="all"),
                           "logits"),
    "lovasz_hinge_per_image": (lambda m, x, d: m.lovasz_hinge(x, d["bin_labels"]),
                               "bin_logits"),
    "lovasz_hinge_batch": (lambda m, x, d: m.lovasz_hinge(x, d["bin_labels"],
                                                          per_image=False), "bin_logits"),
    "focal_seg": (lambda m, x, d: m.focal_seg_loss(x, d["labels"]), "logits"),
    "bins_chamfer": (lambda m, x, d: m.bins_chamfer_loss(x, d["depth"]), "edges"),
    "mse_depth": (lambda m, x, d: m.mse_depth_loss(x, d["depth"]), "pred"),
    "ce_bins": (lambda m, x, d: m.ce_bins_loss(x, d["bins"]), "logits"),
}


@contextlib.contextmanager
def float64():
    """JAX with 64-bit floats inside (the tests run it at 32 otherwise)."""
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


@functools.lru_cache(maxsize=None)
def jax_cases():
    """name -> (value, gradient) in float64, all from one jitted call."""
    data = _data()

    def all_cases(d):
        return {n: jax.value_and_grad(lambda x, fn=fn: fn(jl, x, d))(d[key])
                for n, (fn, key) in CASES.items()}

    with float64():
        out = jax.jit(all_cases)({k: jnp.asarray(v) for k, v in data.items()})
        return {n: (float(v), np.asarray(g)) for n, (v, g) in out.items()}


@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_and_gradient_match_jax(name):
    want, want_g = jax_cases()[name]
    fn, key = CASES[name]
    data = {k: torch.from_numpy(v) for k, v in _data().items()}
    x = data[key].clone().requires_grad_(True)
    loss = fn(tl, x, data)
    (g,) = torch.autograd.grad(loss, [x])
    assert abs(loss.item() - want) <= 1e-5 * abs(want), (loss.item(), want)
    assert np.abs(want_g).max() > 0
    err = np.abs(g.numpy() - want_g).max()
    assert err <= 1e-3 * np.abs(want_g).max() + 1e-6, err


def test_chamfer_of_an_image_without_valid_pixels_is_zero():
    data = {k: torch.from_numpy(v) for k, v in _data().items()}
    one = tl.bins_chamfer_loss(data["edges"][1:], data["depth"][1:])
    assert one.item() == 0.0
    both = tl.bins_chamfer_loss(data["edges"], data["depth"])
    assert both.item() == pytest.approx(tl.bins_chamfer_loss(data["edges"][:1],
                                                             data["depth"][:1]).item() / 2)


def test_lovasz_present_skips_absent_classes():
    """'present' averages over the classes in the labels, 'all' over K."""
    data = {k: torch.from_numpy(v) for k, v in _data().items()}
    present = tl.lovasz_softmax(data["logits"], data["labels"]).item()
    every = tl.lovasz_softmax(data["logits"], data["labels"], classes="all").item()
    assert present != every and present == pytest.approx(jax_cases()["lovasz_softmax_present"][0])


def test_every_zoo_loss_has_a_port_counterpart():
    src = inspect.getsource(jl)
    start = src.index("def _one_hot_valid")
    names = {n for n, v in vars(jl).items() if inspect.isfunction(v)
             if getattr(v, "__module__", None) == jl.__name__
             if src.index(f"def {n}(") >= start}
    assert len(names) == 10, sorted(names)
    missing = sorted(n for n in names if not hasattr(tl, n))
    assert not missing, missing
