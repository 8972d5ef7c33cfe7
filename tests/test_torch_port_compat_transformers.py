"""The port's Twins, BEiT, EfficientNet (``ddp_tpu_torch/nn/
transformer_backbones.py``) and DiffSwin (``nn/diffswin.py``) against the
JAX package's, on the CPU.

Weights: each module's flax variable tree, shaped by ``jax.eval_shape``
(``flax_shapes.shapes_of``) and
filled with seeded numpy values, carried across by ``convert.py``; the JAX
side is one jitted call for every eval case and one float64 call for the
training cases.

  - Twins-PCPVT, Twins-SVT with LSA windows that divide two of its grids
    and need padding (the −1000 key bias) on the other two, BEiT on a non-square
    token grid, EfficientNet on odd sizes (flax's SAME stride-2 pads) with a
    residual block, and DiffSwin with a shifted window and two times: eval
    maps within 1e-4 · max|y| + 1e-6, each map's channels as
    ``out_channels`` names them.
  - EfficientNet's BatchNorm statistics after one training-mode forward
    within 1e-5 of their max, in float64 on both sides.
  - One float64 training step of ``EncoderDecoder(Twins-SVT tiny, "uper")``
    with the FCN aux head (dropout 0), its windows of 3 padding every grid:
    loss within 1e-5 relative, every gradient within 1e-3 · max|g| + 1e-6.
  - ``init_params_`` gives BEiT's bare parameters JAX's inits.
  - The reference gaps the port follows (ROADMAP queue 3), and every class
    and function of the two JAX modules has a port counterpart.
"""
import contextlib
import functools
import inspect

import jax
import numpy as np
import pytest
import torch
from flax_shapes import shapes_of

from ddp_tpu.models import compat_segmentor as jseg
from ddp_tpu.nn import diffswin as jds
from ddp_tpu.nn import head_registry as jreg
from ddp_tpu.nn import heads as jheads
from ddp_tpu.nn import transformer_backbones as jtb
from ddp_tpu_torch.convert import load_flax, params_from_flax
from ddp_tpu_torch.models import compat_segmentor as tseg
from ddp_tpu_torch.nn import diffswin as tds
from ddp_tpu_torch.nn import transformer_backbones as ttb
from ddp_tpu_torch.nn.common import init_params_

K = 5


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


TWINS = dict(dims=(8, 16, 24, 32), depths=(1, 2, 1, 1), num_heads=(1, 2, 2, 4),
             sr_ratios=(4, 2, 2, 1))
SVT = dict(dims=(8, 16, 24, 32), depths=(2, 2, 3, 1), num_heads=(1, 2, 2, 4),
           sr_ratios=(4, 2, 2, 1), svt=True)
BEIT = dict(embed_dim=32, depth=3, num_heads=2, patch_size=8, out_indices=(0, 2))
EFF = dict(width_mult=0.25, depth_mult=0.5)
DSWIN = dict(embed_dims=8, depths=(2, 1, 1, 1), num_heads=(1, 2, 2, 2), window=4,
             drop_path_rate=0.0, time_dim=16)
# name -> (JAX module, port module factory, image shape); DiffSwin also takes t
CASES = {
    "twins_pcpvt": (jtb.Twins(**TWINS), lambda: ttb.Twins(**TWINS), (2, 64, 64, 3)),
    # 16x12, 8x6, 4x3 and 2x2 grids under windows of 4, 4, 3 and 2: the
    # first and last divide, the 8x6 grid pads its width and the 4x3 its height
    "twins_svt": (jtb.Twins(**SVT, window_size=4), lambda: ttb.Twins(**SVT, window_size=4),
                  (2, 64, 48, 3)),
    "beit": (jtb.BEiT(**BEIT), lambda: ttb.BEiT(**BEIT, grid=(4, 5)), (2, 32, 40, 3)),
    "efficientnet_odd": (jtb.EfficientNet(**EFF), lambda: ttb.EfficientNet(**EFF),
                         (2, 50, 54, 3)),
    "diffswin": (jds.DiffSwinTransformer(**DSWIN), lambda: tds.DiffSwinTransformer(**DSWIN),
                 (2, 64, 64, 3)),
}
T = np.array([0.15, 0.8], np.float32)


def _args(name, x):
    return (x, T) if name == "diffswin" else (x,)


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


SEG_KW = dict(channels=16, dropout=0.0)


def _seg_batch(seed=3):
    rng = np.random.RandomState(seed)
    img = rng.randn(2, 64, 64, 3).astype(np.float32)
    gt = rng.randint(0, K, (2, 64, 64)).astype(np.int32)
    gt[:, :4] = 255
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
    """(cases, step): cases name -> (variables, image, float32 eval maps);
    step: the segmentor's (variables, loss, grads) and EfficientNet's new
    batch stats, both from one float64 call."""
    rng = np.random.RandomState(1)
    variables, xs = {}, {}
    for name, (jmod, _, shape) in CASES.items():
        xs[name] = rng.randn(*shape).astype(np.float32)
        variables[name] = fill_variables(shapes_of(jmod, *_args(name, xs[name])))
    ev = jax.jit(lambda vs, xx: {n: CASES[n][0].apply(vs[n], *_args(n, xx[n]), train=False)
                                 for n in CASES})(variables, xs)
    seg = _JaxEncoderDecoder(jtb.Twins(**SVT, window_size=3), "uper", K, head_kwargs=SEG_KW)
    img, gt = _seg_batch()
    seg_vars = fill_variables(shapes_of(seg, img, gt, train=False), seed=2)
    eff = CASES["efficientnet_odd"][0]

    def train(sv, ev_, img, gt, x):
        def loss_fn(p):
            (loss, _), _ = seg.apply({"params": p, "batch_stats": sv["batch_stats"]}, img, gt,
                                     train=True, mutable=["batch_stats"])
            return loss

        loss, grads = jax.value_and_grad(loss_fn)(sv["params"])
        stats = eff.apply(ev_, x, train=True, mutable=["batch_stats"])[1]["batch_stats"]
        return loss, grads, stats

    with float64():
        loss, grads, stats = jax.jit(train)(_f64(seg_vars), _f64(variables["efficientnet_odd"]),
                                            _f64(img), gt, _f64(xs["efficientnet_odd"]))
        step = (seg_vars, float(loss), jax.tree_util.tree_map(np.asarray, grads),
                jax.tree_util.tree_map(np.asarray, stats))
    return ({n: (variables[n], xs[n], [np.asarray(o) for o in ev[n]]) for n in CASES}, step)


def _close_scaled(got, want, rel=1e-4, floor=1e-6):
    err = np.abs(got - want).max()
    tol = rel * np.abs(want).max() + floor
    assert err <= tol, (err, tol)


def _port(name):
    variables = jax_cases()[0][name][0]
    model = CASES[name][1]()
    load_flax(model, variables["params"], variables.get("batch_stats"))
    return model


@pytest.mark.parametrize("name", sorted(CASES))
def test_backbone_matches_jax(name):
    _, x, want = jax_cases()[0][name]
    model = _port(name).eval()
    with torch.no_grad():
        got = model(*(torch.from_numpy(a) for a in _args(name, x)))
    assert len(got) == len(want) == len(model.out_channels)
    for g, w, c in zip(got, want, model.out_channels):
        assert g.shape == w.shape and w.shape[-1] == c
        _close_scaled(g.numpy(), w)


def test_diffswin_maps_move_with_t():
    _, x, _ = jax_cases()[0]["diffswin"]
    model = _port("diffswin").eval()
    x = torch.from_numpy(x)
    with torch.no_grad():
        a = model(x, torch.tensor([0.1, 0.1]))
        b = model(x, torch.tensor([0.9, 0.9]))
    assert all((p - q).abs().max() > 1e-3 for p, q in zip(a, b))


def test_efficientnet_train_batch_stats_match_jax():
    _, x, _ = jax_cases()[0]["efficientnet_odd"]
    stats = jax_cases()[1][3]
    model = _port("efficientnet_odd").double().train()
    with torch.no_grad():
        model(torch.from_numpy(x).double())
    sd = model.state_dict()
    ref = params_from_flax({}, stats)
    keys = [k for k in ref if not k.endswith("num_batches_tracked")]
    assert len(keys) >= 40 and any("_exp_bn" in k for k in keys)
    for key in keys:
        w = ref[key].numpy()
        err = np.abs(sd[key].numpy() - w).max()
        assert err <= 1e-5 * np.abs(w).max() + 1e-7, (key, err)


def test_twins_uper_step_matches_jax():
    seg_vars, loss_j, grads_j, _ = jax_cases()[1]
    model = _dropout_off(tseg.EncoderDecoder(ttb.Twins(**SVT, window_size=3), "uper", K,
                                             head_kwargs=dict(channels=16)))
    load_flax(model, seg_vars["params"], seg_vars["batch_stats"])
    img, gt = (torch.from_numpy(a) for a in _seg_batch())
    model.double().train()
    loss, _ = model(img.double(), gt.long())
    assert abs(loss.item() - loss_j) <= 1e-5 * abs(loss_j)
    named = dict(model.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    want = params_from_flax(grads_j)
    assert set(want) == set(named)
    for key, w in want.items():
        w = w.numpy()
        err = np.abs(grads[key].numpy() - w).max()
        assert err <= 1e-3 * np.abs(w).max() + 1e-6, (key, err)


def test_init_params_gives_beit_its_flax_inits():
    model = ttb.BEiT(**BEIT, init_values=0.1, grid=(4, 5))
    init_params_(model, 0)
    blk = model.block0
    assert torch.equal(blk.gamma1, torch.full((32,), 0.1))
    assert torch.equal(blk.gamma2, torch.full((32,), 0.1))
    table = blk.rel_pos_table
    assert table.shape == (7 * 9, 2) and table.abs().max() <= 0.04
    assert 0.01 < table.std().item() < 0.03


def _gap_beit_one_grid():
    """JAX shapes BEiT's relative-position table by the grid it is
    initialised on, and its apply fails on another; the port is built for
    one grid and raises on another. Neither has a [CLS] token."""
    variables = jax_cases()[0]["beit"][0]
    assert not any("cls" in "/".join(str(k) for k in path)
                   for path, _ in jax.tree_util.tree_flatten_with_path(variables)[0])
    jmod = CASES["beit"][0]
    with pytest.raises(Exception):
        jmod.apply(variables, np.zeros((1, 40, 40, 3), np.float32))
    model = _port("beit")
    assert not any("cls" in n for n, _ in model.named_parameters())
    with pytest.raises(ValueError, match="token grid"):
        model(torch.zeros(1, 40, 40, 3))


def _gap_lsa_docstring():
    """JAX's LSA docstring says the windows divide the grid at the 512-crop
    configs; at 512², Twins-SVT's stage 0 is 128², which 7 does not divide,
    so the padded path (the −1000 key bias) runs, in both packages."""
    assert "divide" in jtb.LocallyGroupedAttention.__doc__
    assert 512 // 4 == 128 and 128 % 7 == 2
    bias = ttb._pad_key_bias(128, 128, 7, torch.device("cpu"))
    assert bias.shape == (19 * 19, 49) and (bias == -1000.0).any()


def _gap_tanh_gelu():
    """flax's ``nn.gelu`` is the tanh approximation by default; Twins and
    BEiT (their MLPs), Feature2Pyramid, the CRF block and BinsFormer use it
    in JAX, and the port's ``gelu`` is the same (exact GELU differs by up
    to ~1e-3 per activation, beyond the 1e-4 limits above)."""
    from flax import linen as fnn

    from ddp_tpu_torch.nn.common import gelu

    assert inspect.signature(fnn.gelu).parameters["approximate"].default is True
    x = torch.linspace(-3, 3, 101)
    want = np.asarray(fnn.gelu(x.numpy()))
    np.testing.assert_allclose(gelu(x).numpy(), want, rtol=1e-6, atol=1e-6)
    assert (torch.nn.functional.gelu(x) - gelu(x)).abs().max() > 1e-4


GAPS = {"beit_one_grid_no_cls": _gap_beit_one_grid, "lsa_pads_at_512": _gap_lsa_docstring,
        "tanh_gelu": _gap_tanh_gelu}


@pytest.mark.parametrize("gap", sorted(GAPS))
def test_reference_gaps_the_port_follows(gap):
    GAPS[gap]()


@pytest.mark.parametrize("jmod,tmod", [(jtb, ttb), (jds, tds)],
                         ids=["transformer_backbones", "diffswin"])
def test_every_jax_name_has_a_port_counterpart(jmod, tmod):
    names = {n for n, v in vars(jmod).items()
             if inspect.isclass(v) or inspect.isfunction(v)
             if getattr(v, "__module__", None) == jmod.__name__}
    assert names
    missing = sorted(n for n in names if not hasattr(tmod, n))
    assert not missing, missing
