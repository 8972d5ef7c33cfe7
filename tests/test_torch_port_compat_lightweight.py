"""The port's real-time backbones (``ddp_tpu_torch/nn/lightweight.py``) against
the JAX package's, on the CPU.

Weights: each module's flax variable tree, shaped by ``jax.eval_shape`` and
filled with seeded numpy values, carried across by ``convert.py``; the JAX
side of the eval cases is one jitted call, the training cases a second.

  - STDCNet with the STDC1 (2, 2, 2) and STDC2 (4, 5, 3) block tables at
    base 8, BiSeNetV1 (its STDC context net at JAX's fixed base 64),
    BiSeNetV2, FastSCNN, CGNet and ERFNet at narrow widths, and ICNeck on
    three maps: eval maps within 1e-4 · max|y| + 1e-6, each map's channels
    as ``out_channels`` names them. Odd input sizes (45 x 51; CGNet 33 x 37)
    where JAX accepts them (flax's SAME pads the strided convs and pools
    unevenly there): STDC1, BiSeNetV1/V2, FastSCNN, CGNet; ERFNet's
    conv-beside-pool downsampler needs sides that are multiples of 8.
  - One training-mode forward's BatchNorm running statistics within 1e-5
    of their max, in float64 on both sides, on CGNet (BN + PReLU, the
    image injected) and BiSeNetV2 (whose ``bga_s2`` branch JAX computes and
    drops: its statistics move all the same).
  - ``_NonBottleneck1D``'s rectangular kernels and one-axis dilations pad
    per axis as flax's SAME does.
  - Every class and function of JAX's ``compat_heads2.py`` and
    ``lightweight.py`` has a counterpart of the same name in the port.
"""
import contextlib
import functools
import inspect

import jax
import numpy as np
import pytest
import torch

from ddp_tpu.nn import compat_heads2 as jch2
from ddp_tpu.nn import lightweight as jlw
from ddp_tpu_torch.convert import load_flax, params_from_flax
from ddp_tpu_torch.nn import compat_heads2 as tch2
from ddp_tpu_torch.nn import lightweight as tlw
from ddp_tpu_torch.nn.common import same_pads


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


def _inputs(shapes, seed=1):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in shapes]


ICNECK_IN = [(2, 16, 16, 8), (2, 8, 8, 16), (2, 4, 4, 32)]
BISE2 = dict(detail_channels=(8, 8, 16), semantic_channels=(8, 8, 16, 16))
FAST = dict(channels=(8, 8, 16), global_channels=(8, 16, 16))
CG = dict(channels=(8, 16, 16), blocks=(1, 2))
# name -> (JAX module, port module factory, input shapes); an ICNeck takes
# its three maps as one list, the backbones one image
CASES = {
    "stdc1_odd": (jlw.STDCNet(base=8), lambda: tlw.STDCNet(base=8), [(2, 45, 51, 3)]),
    "stdc2": (jlw.STDCNet(base=8, blocks=(4, 5, 3)),
              lambda: tlw.STDCNet(base=8, blocks=(4, 5, 3)), [(2, 64, 64, 3)]),
    "bisenetv1_odd": (jlw.BiSeNetV1(channels=8, spatial_channels=(8, 8, 8, 16)),
                      lambda: tlw.BiSeNetV1(channels=8, spatial_channels=(8, 8, 8, 16)),
                      [(2, 45, 51, 3)]),
    "bisenetv2_odd": (jlw.BiSeNetV2(**BISE2), lambda: tlw.BiSeNetV2(**BISE2),
                      [(2, 45, 51, 3)]),
    "fast_scnn_odd": (jlw.FastSCNN(**FAST), lambda: tlw.FastSCNN(**FAST), [(2, 45, 51, 3)]),
    "cgnet_odd": (jlw.CGNet(**CG), lambda: tlw.CGNet(**CG), [(2, 33, 37, 3)]),
    "erfnet": (jlw.ERFNet(channels=(8, 16, 32)), lambda: tlw.ERFNet(channels=(8, 16, 32)),
               [(2, 32, 40, 3)]),
    "icneck": (jlw.ICNeck(channels=8), lambda: tlw.ICNeck([8, 16, 32], channels=8), ICNECK_IN),
}
BN_STATS = ("cgnet_odd", "bisenetv2_odd")


def _arg(name, xs):
    return xs if name.startswith("icneck") else xs[0]


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
    """name -> (variables, inputs, float32 eval outputs, the new batch stats
    of a float64 training-mode forward or None); one jitted call for the
    eval outputs, one for the training forwards."""
    variables, inputs = {}, {}
    for name, (jmod, _, shapes) in CASES.items():
        inputs[name] = _inputs(shapes)
        variables[name] = fill_variables(jax.eval_shape(
            lambda: jmod.init(jax.random.PRNGKey(0), _arg(name, inputs[name]))))
    ev = jax.jit(lambda vs, xs: {n: CASES[n][0].apply(vs[n], _arg(n, xs[n]), train=False)
                                 for n in CASES})(variables, inputs)
    with float64():
        new = jax.jit(lambda vs, xs: {
            n: CASES[n][0].apply(vs[n], _arg(n, xs[n]), train=True,
                                 mutable=["batch_stats"])[1]["batch_stats"]
            for n in BN_STATS})(_f64({n: variables[n] for n in BN_STATS}),
                                _f64({n: inputs[n] for n in BN_STATS}))
        new = jax.tree_util.tree_map(np.asarray, new)
    return {n: (variables[n], inputs[n], [np.asarray(o) for o in ev[n]], new.get(n))
            for n in CASES}


def _close_scaled(got, want, rel=1e-4, floor=1e-6):
    err = np.abs(got - want).max()
    tol = rel * np.abs(want).max() + floor
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("name", sorted(CASES))
def test_lightweight_matches_jax(name):
    variables, xs, want, _ = jax_cases()[name]
    model = CASES[name][1]()
    load_flax(model, variables["params"], variables.get("batch_stats"))
    with torch.no_grad():
        got = model.eval()(_arg(name, [torch.from_numpy(x) for x in xs]))
    assert len(got) == len(want) == len(model.out_channels)
    for g, w, c in zip(got, want, model.out_channels):
        assert g.shape == w.shape and w.shape[-1] == c
        _close_scaled(g.numpy(), w)


@pytest.mark.parametrize("name", BN_STATS)
def test_train_batch_stats_match_jax(name):
    variables, xs, _, stats = jax_cases()[name]
    model = CASES[name][1]()
    load_flax(model, variables["params"], variables.get("batch_stats"))
    model.double().train()
    with torch.no_grad():
        model(_arg(name, [torch.from_numpy(x).double() for x in xs]))
    sd = model.state_dict()
    ref = params_from_flax(variables["params"], stats)
    keys = [k for k in ref if not k.endswith("num_batches_tracked")]
    assert len(keys) >= 20
    if name.startswith("bisenetv2"):
        assert "bga_s2_bn.running_mean" in keys
    for key in keys:
        w = ref[key].numpy()
        err = np.abs(sd[key].numpy() - w).max()
        assert err <= 1e-5 * np.abs(w).max() + 1e-7, (key, err)


@pytest.mark.parametrize("dilation", [1, 2, 3])
def test_non_bottleneck_pads_per_axis(dilation):
    """Each conv pads only along its kernel's long axis, by its dilation."""
    block = tlw._NonBottleneck1D(4, dilation=dilation)
    want = {"c31a": ((1, 1), (0, 0)), "c13a": ((0, 0), (1, 1)),
            "c31b": ((dilation, dilation), (0, 0)), "c13b": ((0, 0), (dilation, dilation))}
    for name, pads in want.items():
        conv = getattr(block, name)
        assert same_pads((9, 7), conv.kernel_size, conv.stride, conv.dilation) == pads, name
    x = torch.randn(2, 4, 9, 7)
    with torch.no_grad():
        assert block.eval()(x).shape == x.shape


@pytest.mark.parametrize("jmod,tmod", [(jch2, tch2), (jlw, tlw)],
                         ids=["compat_heads2", "lightweight"])
def test_every_jax_name_has_a_port_counterpart(jmod, tmod):
    """Every class and function defined in the JAX module has one of the
    same name in the port's."""
    names = {n for n, v in vars(jmod).items()
             if inspect.isclass(v) or inspect.isfunction(v)
             if getattr(v, "__module__", None) == jmod.__name__}
    assert len(names) >= 14
    assert names <= set(vars(tmod)), sorted(names - set(vars(tmod)))
