"""The port's compat decode heads, part II (``ddp_tpu_torch/nn/compat_heads2.py``,
``nn/head_registry.py``) against the JAX package's, on the CPU.

Weights: each head's flax variable tree, shaped by ``jax.eval_shape`` and
filled with seeded numpy values (CC's gate, the Encoding's factors and the
EMA bases included), carried across by ``convert.py``; the JAX side of the
eval cases is one jitted call.

  - Every part-II head on the pyramid of JAX's registry test (maps 16/8/4/2
    with 8/16/32/64 channels, K = 5, batch 2): eval logits within 1e-4 abs;
    EncHead's SE logits too (with laterals), K-Net with ``all_stages``
    (every stage), DMHead with an even filter (sizes 1, 2, 3) and fusion,
    ISAHead also on a 5 x 7 map with ``down_factor`` (2, 3) (padded and
    cropped back), PSAHead also on a 5 x 5 map (ceil division: 3 x 3),
    SepFCNHead with ``concat_input``.
  - EMAHead: one train-mode forward's EMA bases and BatchNorm statistics
    within 1e-5 of their max (float32, dropout 0).
  - ``enc_onehot_labels`` (labels with 255s and one out of range) and
    ``stdc_boundary_targets`` bitwise.
  - The port's CC, EMA module, K-Net updator and PSA (norm None, shrink 1)
    against the per-pixel numpy oracles of ``tests/test_golden_heads.py``
    (the same loops, written out here for the port's weights): 2e-5 (PSA
    2e-4) abs and rel.
  - CC's −inf mask gives finite gradients.
  - ``init_params_`` gives JAX's initialisers: PReLU 0.25, the Encoding's
    factors in (−1, 0) and codewords within ±(num_codes·C)^−½, CC's gate 0,
    unit-norm EMA bases, K-Net's kernels and Segmenter's class embedding
    N(0, 0.02²).
  - The registry holds JAX's 31 names; 'stdc' builds a one-channel head.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_tpu.nn import compat_heads2 as jch2
from ddp_tpu.nn import head_registry as jreg
from ddp_tpu_torch.convert import load_flax, params_from_flax
from ddp_tpu_torch.nn import compat_heads2 as tch2
from ddp_tpu_torch.nn import head_registry as treg
from ddp_tpu_torch.nn.common import init_params_
from ddp_tpu_torch.nn.lightweight import _CGBlock
from test_golden_heads import _dense, _layernorm, _softmax
from torch_port_threads import _one_torch_thread  # noqa: F401

K = 5
PYRAMID = [(2, 16, 16, 8), (2, 8, 8, 16), (2, 4, 4, 32), (2, 2, 2, 64)]


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


def _case(name, shapes=PYRAMID, port_kw=None, **kw):
    """(JAX head, port head factory, input shapes) of registry head ``name``."""
    chans = [s[-1] for s in shapes]
    return (jreg.build_head(name, num_classes=K, **kw),
            lambda: treg.build_head(name, chans, num_classes=K, **kw, **(port_kw or {})),
            shapes)


CASES = {
    "ann": _case("ann", channels=16, project_channels=8),
    "apc": _case("apc", channels=16),
    "cc": _case("cc", channels=16),
    "dm": _case("dm", channels=16, filter_sizes=(1, 2, 3), fusion=True),
    "dnl": _case("dnl", channels=16),
    "ema": _case("ema", channels=16, ema_channels=16, num_bases=8),
    "enc": _case("enc", channels=16, num_codes=8, add_lateral=True),
    "gc": _case("gc", channels=16),
    "isa": _case("isa", channels=16, isa_channels=8, down_factor=(2, 2)),
    "isa_ragged": _case("isa", [(2, 5, 7, 16)], channels=16, isa_channels=8,
                        down_factor=(2, 3)),
    "knet": _case("knet", channels=16, num_stages=2, num_heads=2, all_stages=True),
    "psa": _case("psa", channels=16, port_kw=dict(feat_size=(2, 2))),
    "psa_odd": _case("psa", [(2, 5, 5, 16)], channels=16, port_kw=dict(feat_size=(5, 5))),
    "segmenter_mask": _case("segmenter_mask", embed_dims=16, num_heads=2),
    "sep_fcn": _case("sep_fcn", channels=16, concat_input=True),
    "stdc": _case("stdc", channels=16),
}
# EMAHead in training (dropout 0): its bases and BatchNorm statistics
EMA_TRAIN = _case("ema", channels=16, ema_channels=16, num_bases=8, dropout=0.0)


def _as_tuple(out):
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


@functools.lru_cache(maxsize=None)
def jax_cases():
    """name -> (variables, maps, JAX eval outputs), every case's head applied
    in one jitted call (one compile, not one each), and (variables, maps,
    new batch stats) of one train-mode forward of EMA_TRAIN in the same
    call."""
    rngs = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}
    variables, feats = {}, {}
    for name, (jmod, _, shapes) in list(CASES.items()) + [("ema_train", EMA_TRAIN)]:
        feats[name] = [jnp.asarray(a) for a in _maps(shapes)]
        variables[name] = fill_variables(
            jax.eval_shape(lambda: jmod.init(rngs, feats[name], train=False)))

    def apply(vs, ff):
        outs = {n: CASES[n][0].apply(vs[n], ff[n], train=False) for n in CASES}
        _, new = EMA_TRAIN[0].apply(vs["ema_train"], ff["ema_train"], train=True,
                                    mutable=["batch_stats"])
        return outs, new["batch_stats"]

    outs, ema_stats = jax.jit(apply)(variables, feats)
    cases = {n: (variables[n], [np.asarray(f) for f in feats[n]],
                 tuple(np.asarray(o) for o in _as_tuple(outs[n]))) for n in CASES}
    ema = (variables["ema_train"], [np.asarray(f) for f in feats["ema_train"]],
           jax.tree_util.tree_map(np.asarray, ema_stats))
    return cases, ema


def _port(name, variables):
    model = CASES[name][1]()
    load_flax(model, variables.get("params", {}), variables.get("batch_stats"))
    return model.eval()


@pytest.mark.parametrize("name", sorted(CASES))
def test_head_matches_jax(name):
    variables, feats, want = jax_cases()[0][name]
    model = _port(name, variables)
    with torch.no_grad():
        got = _as_tuple(model([torch.from_numpy(f) for f in feats]))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4)


def test_ema_train_forward_matches_jax():
    """One train-mode forward (dropout 0): the EMA bases move by the
    momentum towards the normalised batch mean, the BatchNorms by flax's."""
    variables, feats, new = jax_cases()[1]
    want = params_from_flax(variables["params"], new)
    model = EMA_TRAIN[1]()
    load_flax(model, variables["params"], variables["batch_stats"])
    before = model.ema.bases.clone()
    with torch.no_grad():
        model.train()([torch.from_numpy(f) for f in feats])
    assert not torch.equal(before, model.ema.bases)
    sd = model.state_dict()
    stats = [k for k in want if k.endswith(("running_mean", "running_var", "bases"))]
    assert "ema.bases" in stats and len(stats) >= 9
    for key in stats:
        w = want[key].numpy()
        err = np.abs(sd[key].numpy() - w).max()
        assert err <= 1e-5 * np.abs(w).max(), (key, err)


def test_enc_onehot_labels_bitwise():
    rng = np.random.RandomState(4)
    labels = rng.randint(0, K, (3, 9, 11)).astype(np.int32)
    labels[0, :4] = 255
    labels[1] = 255  # an image with no valid pixel
    labels[2, 0, 0] = K + 2  # outside [0, K): no class, as jax.nn.one_hot
    labels[2][labels[2] == 3] = 255  # class 3 absent from image 2
    want = np.asarray(jch2.enc_onehot_labels(jnp.asarray(labels), K))
    got = tch2.enc_onehot_labels(torch.from_numpy(labels).long(), K)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[1].sum() == 0 and want[2, 3] == 0 and want[0].sum() == K


@pytest.mark.parametrize("shape", [(2, 32, 32), (1, 13, 18)])
def test_stdc_boundary_targets_bitwise(shape):
    rng = np.random.RandomState(5)
    labels = (rng.randint(0, 4, (shape[0], shape[1] // 4 + 1, shape[2] // 4 + 1))
              .repeat(4, 1).repeat(4, 2)[:, :shape[1], :shape[2]]).astype(np.int32)
    labels[:, :2, :3] = 255
    want = np.asarray(jch2.stdc_boundary_targets(jnp.asarray(labels)))
    got = tch2.stdc_boundary_targets(torch.from_numpy(labels))
    assert got.dtype == torch.float32 and got.shape == shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.mean() < 1


def _np(t):
    return t.detach().double().numpy()


def _conv1x1(conv, x):
    """A port ``Conv`` (1x1) as a dense map on [..., C]."""
    bias = None if conv.bias is None else _np(conv.bias)
    return _dense(x, _np(conv.weight)[:, :, 0, 0].T, bias)


def test_crisscross_attention_oracle():
    b, h, w, c = 2, 5, 7, 8
    x = np.random.RandomState(0).randn(b, h, w, c)
    mod = tch2._CrissCrossAttention(c, reduction=4).double()
    init_params_(mod, 0)
    with torch.no_grad():
        mod.gamma.fill_(0.7)
        out = mod(torch.from_numpy(x)).numpy()
    q, k, v = (_conv1x1(getattr(mod, n), x) for n in ("query", "key", "value"))
    ref = np.empty_like(x)
    for bi in range(b):
        for i in range(h):
            for j in range(w):
                e_col = np.array([-np.inf if u == i else q[bi, i, j] @ k[bi, u, j]
                                  for u in range(h)])
                e_row = np.array([q[bi, i, j] @ k[bi, i, u] for u in range(w)])
                a = _softmax(np.concatenate([e_col, e_row]))
                ctx = (sum(a[u] * v[bi, u, j] for u in range(h))
                       + sum(a[h + u] * v[bi, i, u] for u in range(w)))
                ref[bi, i, j] = x[bi, i, j] + 0.7 * ctx
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)


def test_crisscross_gradients_are_finite():
    mod = tch2.CCHead(K, [8], channels=8, dropout=0.0)
    init_params_(mod, 0)
    with torch.no_grad():
        mod.cca.gamma.fill_(0.5)
    x = torch.randn(2, 5, 6, 8, requires_grad=True)
    mod.train()([x]).square().sum().backward()
    assert torch.isfinite(x.grad).all()
    assert all(torch.isfinite(p.grad).all() for p in mod.parameters())
    assert mod.cca.query.weight.grad.abs().max() > 0


def test_ema_module_oracle():
    b, h, w, c, nb, stages = 2, 4, 5, 6, 8, 3
    x = np.random.RandomState(1).randn(b, h, w, c)
    mod = tch2._EMAModule(c, num_bases=nb, num_stages=stages,
                          generator=torch.Generator().manual_seed(0)).double().eval()
    bases0 = _np(mod.bases)
    out = mod(torch.from_numpy(x)).numpy()
    feats = x.reshape(b, h * w, c)
    ref = np.empty((b, h * w, c))
    for bi in range(b):
        bases, attn = bases0.copy(), None
        for _ in range(stages):
            logits = np.array([[feats[bi, n] @ bases[kk] for kk in range(nb)]
                               for n in range(h * w)])
            attn = _softmax(logits, axis=-1)
            attn_n = attn / (attn.sum(axis=0, keepdims=True) + 1e-12)
            bases = attn_n.T @ feats[bi]
            bases = bases / (np.linalg.norm(bases, axis=-1, keepdims=True) + 1e-12)
        ref[bi] = attn @ bases
    np.testing.assert_allclose(out, ref.reshape(b, h, w, c), rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(_np(mod.bases), bases0)  # eval: the buffer stays


def test_kernel_updator_oracle():
    b, nk, c = 2, 5, 16
    rng = np.random.RandomState(2)
    kernels, group = rng.randn(b, nk, c), rng.randn(b, nk, c)
    mod = tch2._KernelUpdator(c).double()
    init_params_(mod, 0)
    with torch.no_grad():
        for p in mod.parameters():  # norms and biases away from 1 and 0
            p.add_(0.1 * torch.randn(p.shape, generator=torch.Generator().manual_seed(1),
                                     dtype=p.dtype))
        out = mod(torch.from_numpy(kernels), torch.from_numpy(group)).numpy()

    def lin(name, x):
        m = getattr(mod, name)
        return _dense(x, _np(m.weight).T, _np(m.bias))

    def ln(name, x):
        m = getattr(mod, name)
        return _layernorm(x, _np(m.weight), _np(m.bias))

    f, k = lin("feat_in", group), lin("kernel_in", kernels)
    gsum = f[..., c:] + k[..., c:]
    gate_f = 1 / (1 + np.exp(-ln("fg_norm", gsum)))
    gate_k = 1 / (1 + np.exp(-ln("kg_norm", gsum)))
    new = gate_f * ln("f_norm", f[..., :c]) + gate_k * ln("k_norm", k[..., :c])
    ref = np.maximum(ln("out_norm", lin("fc_out", new)), 0.0)
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)


def test_psa_head_oracle():
    """PSAHead (norm None, shrink 1, eval) against a per-pixel pipeline: the
    compact collect branch transposes its [N, N] map (each position
    gathers)."""
    b, h, w, cin, ch, ncls = 1, 4, 4, 6, 8, 3
    x = np.random.RandomState(3).randn(b, h, w, cin)
    head = tch2.PSAHead(ncls, [cin], feat_size=(h, w), channels=ch, shrink_factor=1,
                        norm=None, dropout=0.0).double().eval()
    init_params_(head, 0)
    with torch.no_grad():
        for p in head.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=torch.Generator().manual_seed(1),
                                     dtype=p.dtype))
        out = head([torch.from_numpy(x)]).numpy()
    n = h * w

    def cm(name, inp):  # a ConvModule without a norm: 1x1 conv + bias, ReLU
        return np.maximum(_conv1x1(getattr(head, name).conv, inp), 0)

    def branch(name):
        y = cm(f"{name}_reduce", x)
        a = _conv1x1(getattr(head, f"{name}_attn1"), cm(f"{name}_attn0", y))
        return y.reshape(b, n, ch), a.reshape(b, n, n)

    xc, ac = branch("collect")
    xd, ad = branch("distribute")
    ac = _softmax(np.transpose(ac, (0, 2, 1)), axis=-1)
    ad = _softmax(ad, axis=-1)
    y = np.concatenate([np.einsum("bqk,bkc->bqc", ac, xc),
                        np.einsum("bqk,bkc->bqc", ad, xd)], -1).reshape(b, h, w, 2 * ch)
    cat = np.concatenate([x, cm("proj", y)], axis=-1)
    conv = head.bottleneck.conv
    kern, bias = _np(conv.weight).transpose(2, 3, 1, 0), _np(conv.bias)
    pad = np.pad(cat, ((0, 0), (1, 1), (1, 1), (0, 0)))
    bott = np.empty((b, h, w, ch))
    for i in range(h):
        for j in range(w):
            bott[:, i, j] = np.einsum("bxyc,xyco->bo", pad[:, i:i + 3, j:j + 3], kern) + bias
    ref = _conv1x1(head.out.conv_seg, np.maximum(bott, 0))
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4)


def test_init_params_gives_jax_initialisers():
    enc = tch2.EncHead(K, [8], channels=16, num_codes=8)
    cc = tch2.CCHead(K, [8], channels=16)
    ema = tch2.EMAHead(K, [8], channels=16, ema_channels=16, num_bases=32)
    knet = tch2.KNetHead(K, [8], channels=64, num_stages=1, num_heads=2)
    seg = tch2.SegmenterMaskHead(K, [8], embed_dims=64, num_heads=2, num_layers=1)
    cg = _CGBlock(16, 32)
    for m in (enc, cc, ema, knet, seg, cg):
        with torch.no_grad():
            for p in m.parameters():
                p.fill_(3.0)
            for b in m.buffers():
                b.fill_(3.0)
        init_params_(m, 0)
    torch.testing.assert_close(cg.prelu, torch.full((32,), 0.25))
    scale = enc.encoding.weight
    assert ((scale > -1) & (scale < 0)).all()
    std = (8 * 16) ** -0.5
    cw = enc.encoding.codewords
    assert cw.abs().max() <= std and cw.abs().max() > 0.5 * std
    assert cc.cca.gamma.item() == 0.0
    norms = torch.linalg.vector_norm(ema.ema.bases, dim=-1)
    torch.testing.assert_close(norms, torch.ones(32))
    for p in (knet.kernels, seg.cls_emb):
        assert 0.01 < p.std().item() < 0.03 and p.mean().abs().item() < 0.01
    a, b = tch2.EMAHead(K, [8], channels=16, ema_channels=16), tch2.EMAHead(
        K, [8], channels=16, ema_channels=16)
    init_params_(a, 7)
    init_params_(b, 7)
    torch.testing.assert_close(a.ema.bases, b.ema.bases, rtol=0, atol=0)


def test_registry_holds_jax_names():
    assert set(treg.HEADS) == set(jreg.HEADS)
    assert len(treg.HEADS) == 31
    head = treg.build_head("stdc", [8, 16], num_classes=K, channels=8)
    assert isinstance(head, tch2.STDCHead)
    assert head.out.conv_seg.weight.shape[0] == 1
    with torch.no_grad():
        out = head.eval()([torch.randn(2, 4, 4, 8), torch.randn(2, 2, 2, 16)])
    assert out.shape == (2, 2, 2, 1)
    with pytest.raises(ValueError, match="unknown head"):
        treg.build_head("nope", [8])
