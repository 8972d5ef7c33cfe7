"""The port's compat decode heads (``ddp_tpu_torch/nn/compat_heads.py``, the
registry heads of ``nn/heads.py``, ``nn/head_registry.py``) against the JAX
package's, on the CPU.

Weights: each head's flax variable tree, shaped by ``jax.eval_shape`` and
filled with seeded numpy values (DAHead's gates and NLHead's ``conv_out``
included, which JAX starts at 0), carried across by ``convert.py``; the JAX
side of the registry cases is one jitted call.

  - Every ported registry head on the pyramid of JAX's registry test (maps
    16/8/4/2 with 8/16/32/64 channels, K = 5, batch 2), the heads that want
    one grid (SETR-MLA, DPT in seg and depth mode) on four 8² maps, and
    OCRHead and PointHead with a previous stage's logits: eval logits within
    1e-4 abs. Also DAHead's aux outputs, DeformableHead, FCNHeadWithTime,
    ConvWithTime with a LayerNorm, and ConvModule with stride 2 and a
    LayerNorm.
  - PointHead picks the K most uncertain pixels with ``topk``, whose order
    among equal values is the implementation's own: its inputs here are
    random floats without ties, and a tie-free case checks the picks.
  - The adaptive pool against JAX's matrix, a 2x2 map pooled to 6 included.
  - Dropout draws from the generator it is given.
  - The registry: the port's names are JAX's 31, part I and part II; an
    unknown name raises. Two
    reference gaps the port follows: 'dpt' cannot be built with
    ``num_classes`` in either package; LRASPPHead's gate pools the whole map.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_tpu.nn import compat_heads as jch
from ddp_tpu.nn import head_registry as jreg
from ddp_tpu.nn import heads as jheads
from ddp_tpu_torch.convert import load_flax
from ddp_tpu_torch.nn import compat_heads as tch
from ddp_tpu_torch.nn import head_registry as treg
from ddp_tpu_torch.nn import heads as theads
from torch_port_threads import _one_torch_thread  # noqa: F401

K = 5
PYRAMID = [(2, 16, 16, 8), (2, 8, 8, 16), (2, 4, 4, 32), (2, 2, 2, 64)]
FLAT = [(2, 8, 8, 8), (2, 8, 8, 16), (2, 8, 8, 32), (2, 8, 8, 64)]
PART2 = {"ann", "apc", "cc", "dm", "dnl", "ema", "enc", "gc", "isa", "knet", "psa",
         "segmenter_mask", "sep_fcn", "stdc"}


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


def _maps(shapes, seed=1):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in shapes]


def _chans(shapes):
    return [s[-1] for s in shapes]


# name -> (JAX head, port head factory, input shapes, the previous logits'
# shape or None): OCR's at its (last) map's grid; Point's at the first map's,
# as random floats without ties (upsampled logits repeat at the borders)
def _registry_case(name, shapes=PYRAMID, **kw):
    return (jreg.build_head(name, num_classes=K, **kw),
            lambda: treg.build_head(name, _chans(shapes), num_classes=K, **kw), shapes, None)


CASES = {
    "psp": _registry_case("psp", channels=16),
    "uper": _registry_case("uper", channels=16),
    "aspp": _registry_case("aspp", channels=16, dilations=(1, 2)),
    "sep_aspp": _registry_case("sep_aspp", channels=16, c1_channels=8, dilations=(1, 2)),
    "segformer": _registry_case("segformer", channels=16),
    "da": _registry_case("da", channels=16),
    "nl": _registry_case("nl", channels=16),
    "lraspp": _registry_case("lraspp", channels=16),
    "fpn": _registry_case("fpn", channels=16),
    "setr_up": _registry_case("setr_up", channels=16, num_convs=2, up_scale=2),
    "setr_mla": _registry_case("setr_mla", FLAT, channels=16),
    "fcn": _registry_case("fcn", channels=16),
    "nn": _registry_case("nn", channels=16),
    "identity": _registry_case("identity"),
    "ocr": (jch.OCRHead(K, channels=16, ocr_channels=8),
            lambda: tch.OCRHead(K, _chans(PYRAMID[1:3]), channels=16, ocr_channels=8),
            PYRAMID[1:3], (2, 4, 4, K)),
    "point": (jch.PointHead(K, fc_channels=16, num_fcs=2, point_fraction=0.25),
              lambda: tch.PointHead(K, _chans(PYRAMID), fc_channels=16, num_fcs=2,
                                    point_fraction=0.25), PYRAMID, (2, 16, 16, K)),
    "dpt_seg": (jch.DPTHead(K, channels=16, post_channels=(8, 8, 16, 16), mode="seg"),
                lambda: tch.DPTHead(K, _chans(FLAT), channels=16, post_channels=(8, 8, 16, 16),
                                    mode="seg"), FLAT, None),
    "dpt_depth": (jch.DPTHead(1, channels=16, post_channels=(8, 8, 16, 16)),
                  lambda: tch.DPTHead(1, _chans(FLAT), channels=16,
                                      post_channels=(8, 8, 16, 16)), FLAT, None),
    "da_aux": (jch.DAHead(K, channels=16, return_aux=True),
               lambda: tch.DAHead(K, _chans(PYRAMID), channels=16, return_aux=True),
               PYRAMID, None),
}


@functools.lru_cache(maxsize=None)
def jax_cases():
    """name -> (variables, maps, previous logits or None, JAX eval outputs),
    every case's head applied in one jitted call (one compile, not one each)."""
    rngs = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}
    variables, args = {}, {}
    for name, (jmod, _, shapes, prev_shape) in CASES.items():
        feats = [jnp.asarray(a) for a in _maps(shapes)]
        prev = (jnp.asarray(np.random.RandomState(2).randn(*prev_shape).astype(np.float32))
                if prev_shape else None)
        args[name] = (feats, prev) if prev_shape else (feats,)
        variables[name] = fill_variables(
            jax.eval_shape(lambda: jmod.init(rngs, *args[name], train=False)))
    outs = jax.jit(lambda vs, aa: {n: CASES[n][0].apply(vs[n], *aa[n], train=False)
                                   for n in CASES})(variables, args)
    return {n: (variables[n], [np.asarray(f) for f in args[n][0]],
                None if len(args[n]) == 1 else np.asarray(args[n][1]),
                tuple(np.asarray(o) for o in outs[n]) if isinstance(outs[n], tuple)
                else (np.asarray(outs[n]),)) for n in CASES}


def _port(name, variables):
    model = CASES[name][1]()
    load_flax(model, variables.get("params", {}), variables.get("batch_stats"))
    return model.eval()


@pytest.mark.parametrize("name", sorted(CASES))
def test_head_matches_jax(name):
    variables, feats, prev, want = jax_cases()[name]
    model = _port(name, variables)
    args = [[torch.from_numpy(f) for f in feats]]
    if prev is not None:
        args.append(torch.from_numpy(prev))
    with torch.no_grad():
        got = model(*args)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4)


def _single_map_case(jmod, tmod, x, *extra):
    rngs = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}
    shapes = jax.eval_shape(lambda: jmod.init(rngs, x, *extra, train=False))
    variables = fill_variables(shapes)
    want = np.asarray(jax.jit(lambda v, x, *e: jmod.apply(v, x, *e, train=False))(
        variables, x, *extra))
    load_flax(tmod, variables["params"], variables.get("batch_stats"))
    with torch.no_grad():
        got = tmod.eval()(torch.from_numpy(x), *[torch.from_numpy(e) for e in extra])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("kind", ["deformable", "fcn_with_time", "conv_with_time_ln",
                                  "conv_module_ln_stride2"])
def test_registry_only_heads_match_jax(kind):
    """The heads only the registry builds, and ConvModule with a stride
    (flax's SAME: the extra row after) and a LayerNorm."""
    x = _maps([(2, 6, 6, 16)])[0]
    t = np.random.RandomState(3).randn(2, 64).astype(np.float32)
    if kind == "conv_module_ln_stride2":
        from ddp_tpu.nn.common import ConvModule as JConvModule
        from ddp_tpu_torch.nn.common import ConvModule as TConvModule

        _single_map_case(JConvModule(8, (3, 3), strides=(2, 2), norm="LN", act="relu"),
                         TConvModule(16, 8, (3, 3), norm="LN", act="relu", stride=2), x)
    elif kind == "deformable":
        _single_map_case(jheads.DeformableHead(K, embed_dims=16, num_layers=2, num_heads=2,
                                               ffn_dim=32),
                         theads.DeformableHead(K, embed_dims=16, num_layers=2, num_heads=2,
                                               ffn_dim=32), x)
    elif kind == "fcn_with_time":
        _single_map_case(jheads.FCNHeadWithTime(K, channels=8, norm="BN"),
                         theads.FCNHeadWithTime(K, 16, channels=8, norm="BN", time_in=64), x, t)
    else:
        _single_map_case(jheads.ConvWithTime(8, norm="LN"),
                         theads.ConvWithTime(16, 8, norm="LN", time_in=64), x, t)


def test_point_head_picks_the_most_uncertain_pixels():
    """Tie-free: distinct top-2 gaps, so torch.topk and lax.top_k pick the
    same pixels; the picked pixels are refined, the others keep the coarse
    logits."""
    fine = np.zeros((1, 4, 4, 3), np.float32)
    prev = np.zeros((1, 4, 4, 2), np.float32)
    prev[..., 0] = np.arange(16, dtype=np.float32).reshape(1, 4, 4) * 0.1
    want_unc = np.asarray(jch.point_uncertainty(jnp.asarray(prev)))
    np.testing.assert_allclose(tch.point_uncertainty(torch.from_numpy(prev)).numpy(),
                               want_unc, atol=1e-7)
    head = tch.PointHead(2, [3], fc_channels=4, num_fcs=1, point_fraction=0.25).eval()
    with torch.no_grad():
        out = head([torch.from_numpy(fine)], torch.from_numpy(prev))
    changed = (out.numpy() != prev).any(-1)[0]
    # the 4 most uncertain pixels are the 4 smallest gaps |l0 - l1|: 0..3
    assert set(np.flatnonzero(changed)) == {0, 1, 2, 3}


@pytest.mark.parametrize("size,scale", [(16, 6), (2, 6), (7, 3), (5, 1), (6, 4)])
def test_adaptive_pool_matches_jax_matrix(size, scale):
    x = _maps([(2, size, size + 1, 3)])[0]
    want = np.asarray(jch._adaptive_avg_pool(jnp.asarray(x), scale))
    got = tch._adaptive_avg_pool(torch.from_numpy(x), scale).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tch._adaptive_pool_matrix(size, scale),
                                  np.asarray(jch._adaptive_pool_matrix(size, scale)))


def test_dropout_uses_the_generator():
    out = tch.SegHeadOut(8, K, dropout=0.5).train()
    x = torch.from_numpy(_maps([(4, 8, 8, 8)])[0])
    a = out(x, torch.Generator().manual_seed(5))
    b = out(x, torch.Generator().manual_seed(5))
    c = out(x, torch.Generator().manual_seed(6))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    # the kept inputs are scaled by 1 / (1 - rate): a 1x1 conv of the input
    # with half its entries at 0 and the rest doubled
    mask = torch.rand(x.shape, generator=torch.Generator().manual_seed(5)) < 0.5
    want = out.conv_seg(torch.where(mask, x * 2.0, torch.zeros(())))
    torch.testing.assert_close(a, want)


def test_registry_holds_part_one():
    """Part I and the fcn family are there, and so is part II: the port's
    registry is JAX's 31 names (part II's heads are held to JAX in
    ``test_torch_port_compat_heads2.py``)."""
    assert set(treg.HEADS) == set(jreg.HEADS)
    assert set(CASES) - {"ocr", "point", "dpt_seg", "dpt_depth", "da_aux"} <= set(treg.HEADS)
    assert PART2 <= set(treg.HEADS) and len(treg.HEADS) == 31
    with pytest.raises(ValueError, match="unknown head"):
        treg.build_head("nope", [8])


def test_dpt_is_not_built_with_num_classes_in_either_package():
    """Reference gap (ROADMAP queue 3): JAX's EncoderDecoder passes
    ``num_classes`` to every registry head, and DPTHead takes
    ``out_channels``; the port follows."""
    with pytest.raises(TypeError):
        jreg.build_head("dpt", num_classes=K)
    with pytest.raises(TypeError):
        treg.build_head("dpt", [8] * 4, num_classes=K)


def test_lraspp_gate_pools_the_whole_map():
    """Reference gap (ROADMAP queue 3): LRASPPHead's gate is that of the
    map's global mean, as the JAX package's (mmseg: a 49x49 average pool
    with stride 16)."""
    head = tch.LRASPPHead(K, [8, 16], channels=4).eval()
    f0 = torch.randn(1, 64, 64, 8)
    f1 = torch.randn(1, 64, 64, 16)
    with torch.no_grad():
        out = head([f0, f1])
        flat = f1.mean(dim=(1, 2), keepdim=True).expand_as(f1)
        y = head.aspp_conv(f1) * torch.sigmoid(head.image_pool(flat))
        want = head.conv_seg(head.fuse0(y + head.skip0(f0)))
    torch.testing.assert_close(out, want)
