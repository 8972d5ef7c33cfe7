"""The lidar pieces' cases for ``tests/test_torch_port_lidar.py`` and
``tests/test_torch_port_lidar_cameras.py``: tiny modules of both packages,
their inputs, JAX's results and the checks of the port against them.

Weights: each module's flax variable tree, shaped by ``tests/flax_shapes.py:
shapes_of`` and filled with seeded numpy values, carried across by
``convert.py`` (strict: no key missing, none unused). The JAX side is two
jitted calls for each group of modules: the float32 eval outputs, and one
float64 training step (outputs, new batch statistics and the parameter
gradients of a fixed linear loss). ``check_eval``: the port's float32 eval
outputs within 1e-4 · max|y| + 1e-6; ``check_train``: in float64, the
outputs within 1e-6 · max|y|, the batch statistics within 1e-5 of their max
and the gradients within 1e-3 · max|g| + 1e-6.
"""
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from flax_shapes import shapes_of
from ddp_tpu.nn import bev as jbev
from ddp_tpu.nn import dla_vovnet as jdv
from ddp_tpu.nn import second as jsec
from ddp_tpu.nn import sparse_conv as jsc
from ddp_tpu_torch import native
from ddp_tpu_torch.convert import load_flax, params_from_flax
from ddp_tpu_torch.data import bev_datasets as tbd
from ddp_tpu_torch.nn import bev as tbev
from ddp_tpu_torch.nn import dla_vovnet as tdv
from ddp_tpu_torch.nn import second as tsec
from ddp_tpu_torch.nn import sparse_conv as tsc


@contextlib.contextmanager
def float64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def fill_variables(shapes, seed: int = 0):
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


# --- the inputs -----------------------------------------------------------------------

RIG = tbd.SyntheticBEVDataset(num_cams=2, image_size=(32, 64), scope=8.0)
LSS = dict(image_size=(32, 64), feature_size=(4, 8), xbound=(-8.0, 8.0, 1.0),
           ybound=(-8.0, 8.0, 1.0), zbound=(-10.0, 10.0, 20.0), dbound=(1.0, 9.0, 1.0))
SHAPE = (64, 64, 41)  # the z extent of nuScenes' grid, a small x-y one
CAPS = (400, 160, 80, 40, 40)
ENC = dict(base_channels=4, output_channels=8,
           encoder_channels=((4,), (8, 8), (8, 8), (8, 8)), dense_hw=8, dense_z=2)


def _points(n: int, seed: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    pts = np.zeros((n, 5), np.float32)
    pts[:, :2] = rng.uniform(-8, 8, (n, 2))
    pts[:, 2] = rng.uniform(-1.0, 2.0, n)
    pts[:, 3:] = rng.rand(n, 2)
    return pts


def _rig_batch():
    rots, trans, intr, post_rots, post_trans = RIG.rig()
    # an image augmentation: scale 0.9, shift (1.5, -2)
    post_rots = post_rots * np.array([0.9, 0.9, 1.0], np.float32)[:, None]
    post_trans = post_trans + np.array([1.5, -2.0, 0.0], np.float32)
    return rots, trans, intr, post_rots, post_trans


@functools.lru_cache(maxsize=1)
def _sparse_inputs():
    voxel_size = (0.25, 0.25, 0.2)
    pc_range = (-8.0, -8.0, -5.0, 8.0, 8.0, 3.2)
    vox, coords, counts, nv = native.hard_voxelize(_points(1500, 3), pc_range, voxel_size,
                                                   max_points=4, max_voxels=CAPS[0])
    feats = tsc.mean_voxel_features(vox, counts)
    return feats, tsc.build_sparse_encoder_rulebooks(coords, nv, SHAPE, CAPS)


def _pillar_inputs(full: bool = False):
    rng = np.random.RandomState(5)
    b, p, n = 2, 6, 5
    counts = rng.randint(1, n + 1, (b, p)).astype(np.int32)
    counts[0, 0], counts[1, 2] = 0, n  # an empty and a full pillar
    if full:
        counts[:] = n
    coords = rng.randint(0, 10, (b, p, 2)).astype(np.int32)
    feats = rng.randn(b, p, n, 4).astype(np.float32)
    feats[np.arange(n)[None, None] >= counts[..., None]] = 0.0
    return feats, counts, coords


def _cases():
    """name -> (JAX module, port factory, float inputs, int inputs, call):
    call(module, floats, ints) -> the arguments in the module's order."""
    rots, trans, intr, post_rots, post_trans = _rig_batch()
    canvas = tbd.rasterize_lidar_depth(_points(3000, 4), rots, trans, intr, post_rots,
                                       post_trans, LSS["image_size"])
    rig = [a[None] for a in (rots, trans, intr, post_rots, post_trans)]
    feats, rb = _sparse_inputs()
    pf, pcnt, pcoord = _pillar_inputs()
    pf_full, pcnt_full, _ = _pillar_inputs(full=True)
    rng = np.random.RandomState(1)
    fpn_in = [rng.randn(2, 16, 16, 8), rng.randn(2, 8, 8, 8), rng.randn(2, 4, 4, 16)]
    dla = dict(levels=(1, 1, 1, 1, 2, 1), channels=(4, 8, 8, 16, 24, 32))
    vov = dict(stage_ch=(4, 8), concat_ch=(8, 16), blocks=(1, 2), osa_layers=2)
    pfn = dict(feat_channels=(8, 16), voxel_size=(0.5, 0.5), pc_range=(-2.0, -3.0),
               with_distance=True)
    pfn1 = dict(pfn, feat_channels=(16,))
    f32 = lambda *a: [np.asarray(x, np.float32) for x in a]  # noqa: E731
    return {
        "second": (jsec.SECOND(out_channels=(8, 16), layer_nums=(1, 2), layer_strides=(1, 2)),
                   lambda: tsec.SECOND(8, (8, 16), (1, 2), (1, 2)),
                   f32(rng.randn(2, 16, 16, 8)), [], lambda m, f, i: (f[0],)),
        "second_fpn": (jsec.SECONDFPN(out_channels=(8, 8, 8), upsample_strides=(0.5, 1, 2)),
                       lambda: tsec.SECONDFPN((8, 8, 16), (8, 8, 8), (0.5, 1, 2)),
                       f32(*fpn_in), [], lambda m, f, i: (list(f),)),
        "pillar_feature_net": (jsec.PillarFeatureNet(**pfn),
                               lambda: tsec.PillarFeatureNet(4, **pfn), f32(pf), [pcnt, pcoord],
                               lambda m, f, i: (f[0], i[0], i[1])),
        "pillar_feature_net_one_layer": (jsec.PillarFeatureNet(**pfn1),
                                         lambda: tsec.PillarFeatureNet(4, **pfn1), f32(pf),
                                         [pcnt, pcoord], lambda m, f, i: (f[0], i[0], i[1])),
        "pillar_feature_net_full": (jsec.PillarFeatureNet(**pfn),
                                    lambda: tsec.PillarFeatureNet(4, **pfn), f32(pf_full),
                                    [pcnt_full, pcoord], lambda m, f, i: (f[0], i[0], i[1])),
        "dla": (jdv.DLA(**dla), lambda: tdv.DLA(3, **dla), f32(rng.randn(2, 64, 64, 3)), [],
                lambda m, f, i: (f[0],)),
        "vovnet": (jdv.VoVNet(**vov), lambda: tdv.VoVNet(3, **vov), f32(rng.randn(2, 32, 32, 3)),
                   [], lambda m, f, i: (f[0],)),
        "depth_lss": (jbev.DepthLSSTransform(out_channels=8, **LSS),
                      lambda: tbev.DepthLSSTransform(8, 8, **LSS),
                      f32(rng.randn(1, 2, 4, 8, 8), canvas[None], *rig), [],
                      lambda m, f, i: tuple(f)),
        "sparse_encoder": (jsc.SparseEncoder(**ENC), lambda: tsc.SparseEncoder(5, **ENC),
                           [feats], [rb], lambda m, f, i: (f[0], i[0])),
    }


CASES = _cases()


def _flat(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _weights(shapes):
    """The fixed loss's weights, one array per output (a deterministic,
    sign-changing pattern)."""
    return [np.sin(0.37 * np.arange(int(np.prod(s))) + 0.5 * k).reshape(s)
            for k, s in enumerate(shapes)]


def _jax_args(name, floats):
    jmod, _, _, ints, call = CASES[name]
    return call(jmod, floats, [jax.tree_util.tree_map(jnp.asarray, i) for i in ints])


@functools.lru_cache(maxsize=None)
def jax_cases(group: str):
    """name -> (variables, eval outputs, weights of the linear loss, and the
    float64 training outputs, new batch stats and parameter gradients) for
    the cases of ``GROUPS[group]``."""
    cases = {n: CASES[n] for n in GROUPS[group]}
    train_cases = [n for n in cases if n not in OP_BY_OP]
    variables = {}
    for name, (jmod, _, floats, _, _) in cases.items():
        variables[name] = fill_variables(shapes_of(jmod, *_jax_args(name, floats), train=False))
    xs = {n: c[2] for n, c in cases.items()}
    ev = jax.jit(lambda vs, xs: {n: _flat(CASES[n][0].apply(
        vs[n], *_jax_args(n, xs[n]), train=False)) for n in cases})(variables, xs)
    ev = jax.tree_util.tree_map(np.asarray, ev)
    weights = {n: _weights([o.shape for o in ev[n]]) for n in cases}
    with float64():
        f64 = lambda t: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), t)  # noqa
        tr = jax.jit(lambda vs, ws, xs: {n: _jax_train(n, vs[n], ws[n], xs[n])
                                         for n in train_cases})(
            f64(variables), f64(weights), xs)
        with jax.disable_jit():
            tr.update({n: _jax_train(n, f64(variables[n]), f64(weights[n]), xs[n])
                       for n in cases if n in OP_BY_OP})
        tr = jax.tree_util.tree_map(np.asarray, tr)
    return {n: (variables[n], ev[n], weights[n]) + tuple(tr.get(n, ())) for n in cases}


# Under jit, XLA:CPU's float64 gradient of a two-layer PillarFeatureNet
# whose pillars hold padded points is not JAX's op by op (pfn0's kernel
# gradient 5.8 off at a max of 18.4), where op by op JAX agrees with the
# port to 1e-14; one layer, or no padding, agrees under jit too. That
# case's training step is held to JAX op by op (about 10 s of one-op
# compiles).
OP_BY_OP = ("pillar_feature_net",)
# two test files, so that the two groups' JAX compiles run on two workers
GROUPS = {"cameras": ("dla", "vovnet", "depth_lss")}
GROUPS["lidar"] = tuple(n for n in CASES if n not in GROUPS["cameras"])
GROUP_OF = {n: g for g, names in GROUPS.items() for n in names}


def _jax_train(n, v, w, floats):
    """JAX's float64 training step of case ``n``: (outputs, new batch
    stats, parameter gradients of the linear loss with weights ``w``)."""
    jmod, floats = CASES[n][0], [jnp.asarray(f, jnp.float64) for f in floats]

    def loss(p):
        y, st = jmod.apply({"params": p, "batch_stats": v["batch_stats"]},
                           *_jax_args(n, floats), train=True, mutable=["batch_stats"])
        y = _flat(y)
        return sum((a * b).sum() for a, b in zip(y, w)), (y, st)

    g, (y, st) = jax.grad(loss, has_aux=True)(v["params"])
    return y, st["batch_stats"], g


def _port(name):
    variables = jax_cases(GROUP_OF[name])[name][0]
    model = CASES[name][1]()
    load_flax(model, variables["params"], variables.get("batch_stats"))
    return model


def _port_args(name, floats):
    ints = [{k: torch.from_numpy(np.asarray(v)) for k, v in i.items()} if isinstance(i, dict)
            else torch.from_numpy(i) for i in CASES[name][3]]
    return CASES[name][4](None, floats, ints)


def _close_scaled(got, want, rel, floor, what=""):
    err = np.abs(got - want).max()
    tol = rel * np.abs(want).max() + floor
    assert err <= tol, (what, err, tol)


def check_eval(name):
    """The port's eval outputs (float32) against JAX's."""
    want = jax_cases(GROUP_OF[name])[name][1]
    model = _port(name).eval()
    with torch.no_grad():
        got = _flat(model(*_port_args(name, [torch.from_numpy(f) for f in CASES[name][2]])))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close_scaled(g.numpy(), w, 1e-4, 1e-6)


def check_train(name):
    """One training-mode forward and backward of the fixed linear loss in
    float64 on both sides: outputs, the new batch statistics, and each
    parameter's gradient (0 where JAX's loss does not reach a parameter:
    DLA's discarded projections)."""
    _, _, weights, want_y, stats, grads = jax_cases(GROUP_OF[name])[name]
    model = _port(name).double().train()
    got = _flat(model(*_port_args(name, [torch.from_numpy(f).double()
                                         for f in CASES[name][2]])))
    loss = sum((a * torch.from_numpy(w)).sum() for a, w in zip(got, weights))
    named = dict(model.named_parameters())
    tgrads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    for g, w in zip(got, want_y):
        _close_scaled(g.detach().numpy(), w, 1e-6, 0.0, "output")
    variables = jax_cases(GROUP_OF[name])[name][0]
    ref_stats = params_from_flax(variables["params"], stats)
    sd = model.state_dict()
    keys = [k for k in ref_stats if k.endswith(("running_mean", "running_var", ".mean", ".var"))
            and k not in dict(model.named_parameters())]
    assert keys
    for key in keys:
        _close_scaled(sd[key].numpy(), ref_stats[key].numpy(), 1e-5, 0.0, key)
    ref_grads = params_from_flax(grads)
    assert set(ref_grads) == set(named)
    for (key, p), g in zip(named.items(), tgrads):
        g = torch.zeros_like(p) if g is None else g
        _close_scaled(g.numpy(), ref_grads[key].numpy(), 1e-3, 1e-6, key)
