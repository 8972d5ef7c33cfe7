"""The port's compat backbones (``ddp_tpu_torch/nn/{resnet,mobile_hrnet,mit,
vit}.py``) against the JAX package's, on the CPU.

Weights: the flax variable tree of each module is shaped by ``jax.eval_shape``
(no JAX init is compiled; ``flax_shapes.shapes_of`` traces JAX's random
draws as zeros, which halves the shape pass) and filled with seeded numpy values (kernels
N(0, 1/fan_in), biases and BN means N(0, 0.1²), scales 1 + N(0, 0.1²), BN
variances U(0.5, 1.5)), so that every leaf carries signal; ``convert.py``
carries them across. The JAX side is two jitted calls (every case's eval
forward; the training forwards), cached.

  - Cases: ResNet-18 and ResNet-50 at stem and base width 8 (even sizes: the
    strided 3x3s pad asymmetrically), ResNeXt, the dilated D8 ResNet-50,
    MobileNetV2, MobileNetV3-Small (dilated) and -Large (LRASPP's
    published backbone: its block table, with the undilated tail at output
    stride 32), a tiny HRNet,
    UNetBackbone, ResNeSt, a nano MiT, and a nano ViT on a position grid
    that grows and on one that shrinks.
  - Eval outputs (float32), per map, within 1e-4 · max|y| + 1e-6.
  - One training-mode forward's BatchNorm running statistics within 1e-5 of
    their max, on ResNet-18, HRNet (its BatchNorms and fusion convs) and
    MobileNetV2 (depthwise convs, ReLU6; three, to keep the file's time; the
    segmentor tests hold more), in
    float64 on both sides: in float32 the 50-layer bottleneck stacks part
    by up to 3e-5 of the max (5.7e-5 at 64² inputs), growing steadily with
    depth from 2e-8 at the stem, as float32 rounding passes through 50
    BatchNorms that normalise by batch statistics.
  - flax ``SAME`` max and average pooling, and ``jax.image.resize``'s
    bilinear method on a growing and a shrinking grid, against the port.
  - Drop path draws from the generator it is given.
"""
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from flax_shapes import shapes_of

from ddp_tpu.nn import mit as jmit
from ddp_tpu.nn import mobile_hrnet as jmh
from ddp_tpu.nn import resnet as jres
from ddp_tpu.nn import vit as jvit
from ddp_tpu_torch.convert import load_flax, params_from_flax
from ddp_tpu_torch.nn import common as tcommon
from ddp_tpu_torch.nn import mit as tmit
from ddp_tpu_torch.nn import mobile_hrnet as tmh
from ddp_tpu_torch.nn import resnet as tres
from ddp_tpu_torch.nn import vit as tvit


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
        name = path[-1].key
        shape = s.shape
        if name == "kernel":
            return rng.randn(*shape) / np.sqrt(max(np.prod(shape[:-1]), 1))
        if name == "scale":
            return 1.0 + 0.1 * rng.randn(*shape)
        if name == "var":
            return rng.uniform(0.5, 1.5, shape)
        return 0.1 * rng.randn(*shape)

    tree = jax.tree_util.tree_map_with_path(leaf, shapes)
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _inputs(shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# name -> (JAX module, port module factory, input shape)
CASES = {
    "resnet18": (jres.ResNet(depth=18, stem_channels=8, base_channels=8),
                 lambda: tres.ResNet(depth=18, stem_channels=8, base_channels=8), (2, 32, 32, 3)),
    "resnet50": (jres.ResNet(depth=50, stem_channels=8, base_channels=8),
                 lambda: tres.ResNet(depth=50, stem_channels=8, base_channels=8), (2, 32, 32, 3)),
    "resnext": (jres.resnext(depth=50, groups=4, width_per_group=16, stem_channels=8,
                             base_channels=8),
                lambda: tres.resnext(depth=50, groups=4, width_per_group=16, stem_channels=8,
                                     base_channels=8), (2, 32, 32, 3)),
    "resnet50_d8": (jres.ResNet(depth=50, stem_channels=8, base_channels=8,
                                strides=(1, 2, 1, 1), dilations=(1, 1, 2, 4)),
                    lambda: tres.ResNet(depth=50, stem_channels=8, base_channels=8,
                                        strides=(1, 2, 1, 1), dilations=(1, 1, 2, 4)),
                    (2, 32, 32, 3)),
    # two repeats where a stage's later blocks take the residual path
    "mobilenet_v2": (jmh.MobileNetV2(width_mult=0.25, repeats=(1, 2, 1, 2, 1, 1, 1)),
                     lambda: tmh.MobileNetV2(width_mult=0.25, repeats=(1, 2, 1, 2, 1, 1, 1)),
                     (2, 32, 32, 3)),
    "mobilenet_v3_small": (jmh.MobileNetV3("small"), lambda: tmh.MobileNetV3("small"),
                           (2, 32, 32, 3)),
    # LRASPP's published backbone: the large block table, with the undilated
    # tail (the dilated conversion is held on small)
    "mobilenet_v3_large_undilated": (jmh.MobileNetV3("large", dilated=False),
                                     lambda: tmh.MobileNetV3("large", dilated=False),
                                     (2, 32, 32, 3)),
    "hrnet": (jmh.HRNet(widths=(4, 8, 16), blocks_per_stage=1, stage_modules=(1, 1)),
              lambda: tmh.HRNet(widths=(4, 8, 16), blocks_per_stage=1, stage_modules=(1, 1)),
              (2, 32, 32, 3)),
    "unet": (jmh.UNetBackbone(base_channels=4, num_stages=3),
             lambda: tmh.UNetBackbone(base_channels=4, num_stages=3), (2, 20, 20, 3)),
    "resnest": (jmh.ResNeSt(depth=50, base_channels=8),
                lambda: tmh.ResNeSt(depth=50, base_channels=8), (2, 32, 32, 3)),
    "mit_nano": (jmit.MixVisionTransformer(**jmit.mit_variant("nano"), drop_path_rate=0.0),
                 lambda: tmit.MixVisionTransformer(**tmit.mit_variant("nano"),
                                                   drop_path_rate=0.0), (2, 64, 64, 3)),
    # the 6² pretrain grid grows to 8² (32² input, patch 4) and shrinks to 4²
    "vit_nano_grow": (jvit.VisionTransformer(**jvit.vit_variant("nano"), patch_size=4,
                                             pretrain_grid=6, final_norm=True),
                      lambda: tvit.VisionTransformer(**tvit.vit_variant("nano"), patch_size=4,
                                                     pretrain_grid=6, final_norm=True),
                      (2, 32, 32, 3)),
    "vit_nano_shrink": (jvit.VisionTransformer(**jvit.vit_variant("nano"), patch_size=4,
                                               pretrain_grid=6),
                        lambda: tvit.VisionTransformer(**tvit.vit_variant("nano"),
                                                       patch_size=4, pretrain_grid=6),
                        (2, 16, 16, 3)),
}


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


# the cases whose training-mode BatchNorm statistics are held to JAX's
BN_STATS = ("resnet18", "hrnet", "mobilenet_v2")


@functools.lru_cache(maxsize=None)
def jax_cases():
    """name -> (variables, input, float32 eval outputs, the new batch stats of
    a float64 training-mode forward or None): every case's eval forward in
    one jitted call, the BN_STATS cases' training forwards in a second (two
    compiles, not one or two per case)."""
    variables, xs = {}, {}
    for name, (jmod, _, shape) in CASES.items():
        xs[name] = _inputs(shape)
        variables[name] = fill_variables(
            shapes_of(jmod, xs[name]))
    ev = jax.jit(lambda vs, xx: {n: CASES[n][0].apply(vs[n], xx[n], train=False)
                                 for n in CASES})(variables, xs)
    with float64():
        new = jax.jit(lambda vs, xx: {
            n: CASES[n][0].apply(vs[n], xx[n], train=True, mutable=["batch_stats"])[1]
            for n in BN_STATS})({n: _f64(variables[n]) for n in BN_STATS},
                                {n: _f64(xs[n]) for n in BN_STATS})
        stats = {n: jax.tree_util.tree_map(np.asarray, new[n]["batch_stats"]) for n in BN_STATS}
    return {n: (variables[n], xs[n], [np.asarray(o) for o in ev[n]], stats.get(n))
            for n in CASES}


def jax_case(name):
    return jax_cases()[name]


def _port(name, variables):
    model = CASES[name][1]()
    load_flax(model, variables["params"], variables.get("batch_stats"))
    return model


def _close_scaled(got, want, rel=1e-4, floor=1e-6):
    err = np.abs(got - want).max()
    tol = rel * np.abs(want).max() + floor
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("name", sorted(CASES))
def test_backbone_matches_jax(name):
    variables, x, want, stats = jax_case(name)
    model = _port(name, variables).eval()
    assert len(model.out_channels) == len(want)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert len(got) == len(want)
    for g, w, c in zip(got, want, model.out_channels):
        assert g.shape == w.shape and w.shape[-1] == c
        _close_scaled(g.numpy(), w)
    if stats is None:
        return
    model.double().train()
    with torch.no_grad():
        model(torch.from_numpy(x).double())
    sd = model.state_dict()
    ref = params_from_flax({}, stats)
    assert ref
    for key, w in ref.items():
        if key.endswith("num_batches_tracked"):
            continue
        w = w.numpy()
        err = np.abs(sd[key].numpy() - w).max()
        assert err <= 1e-5 * np.abs(w).max() + 1e-7, (key, err)


@pytest.mark.parametrize("size", [7, 8])
def test_same_pooling_matches_flax(size):
    x = _inputs((2, size, size + 1, 3))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    for k, s in ((3, 2), (2, 2)):
        for jfn, tfn in ((fnn.max_pool, tcommon.max_pool_same),
                         (fnn.avg_pool, tcommon.avg_pool_same)):
            want = np.asarray(jfn(jnp.asarray(x), (k, k), strides=(s, s), padding="SAME"))
            got = tfn(xt, k, s).permute(0, 2, 3, 1).numpy()
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("grid,size", [(6, (4, 4)), (14, (32, 32)), (14, (5, 9)),
                                       (7, (3, 12))])
def test_pos_embed_resize_matches_jax_image_resize(grid, size):
    """Growing (plain bilinear) and shrinking (antialiased) grids, and a
    grid that shrinks along one side and grows along the other."""
    g = _inputs((1, grid, grid, 5))
    want = np.asarray(jax.image.resize(jnp.asarray(g), (1, *size, 5), method="bilinear"))
    got = tvit.resize_pos_grid(torch.from_numpy(g), size).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_drop_path_uses_the_generator():
    block = tmit.MiTBlock(16, 2, 1, drop_path=0.5).train()
    x = torch.from_numpy(_inputs((64, 4, 16)))
    a = block(x, (2, 2), torch.Generator().manual_seed(3))
    b = block(x, (2, 2), torch.Generator().manual_seed(3))
    c = block(x, (2, 2), torch.Generator().manual_seed(4))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    # a sample whose two branches were both dropped comes out as it went in
    # (probability 1/4 each); the others do not
    same = [torch.equal(a[i], x[i]) for i in range(64)]
    assert 0 < sum(same) < 64
