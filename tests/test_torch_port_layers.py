"""Layer-by-layer parity of the torch port against the JAX package, on the CPU.

Each flax module is initialised from a seed, its parameters are carried into
the port's module with ``convert.params_from_flax``, and both run on the same
seeded numpy inputs. Tolerance: float32 on both sides, atol 1e-5 on O(1)
activations; XLA and torch sum matmuls and norms in different orders, which
moves the last few ulps (observed differences are ~1e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_tpu.core import diffusion as jdiff
from ddp_tpu.core import schedules as jsched
from ddp_tpu.evaluation.batched import microbatched_call as j_microbatched_call
from ddp_tpu.evaluation.metrics import SegMetricAccumulator as JAcc
from ddp_tpu.nn import common as jcommon
from ddp_tpu.nn import fpn as jfpn
from ddp_tpu.nn import heads as jheads
from ddp_tpu.nn import pos_embed as jpos
from ddp_tpu.nn import swin as jswin
from ddp_tpu.nn import time_embed as jtime
from ddp_tpu.nn import transformer as jtr
from ddp_tpu.ops import resize as jresize
from ddp_tpu_torch.convert import load_flax
from ddp_tpu_torch.core import diffusion as tdiff
from ddp_tpu_torch.core import schedules as tsched
from ddp_tpu_torch.evaluation.batched import microbatched_call
from ddp_tpu_torch.evaluation.metrics import SegMetricAccumulator
from ddp_tpu_torch.nn import common as tcommon
from ddp_tpu_torch.nn import fpn as tfpn
from ddp_tpu_torch.nn import heads as theads
from ddp_tpu_torch.nn import pos_embed as tpos
from ddp_tpu_torch.nn import swin as tswin
from ddp_tpu_torch.nn import time_embed as ttime
from ddp_tpu_torch.nn import transformer as ttr
from ddp_tpu_torch.ops import resize as tresize

ATOL = 1e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port(tmodule, variables):
    """Load a flax variables dict into the torch module (strict)."""
    load_flax(tmodule, _np(variables["params"]), _np(variables.get("batch_stats")))
    return tmodule.eval()


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol)


def _randn(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# --- schedules and DDIM/DDPM updates ----------------------------------------

def test_schedules_and_updates():
    _close(tsched.sampling_time_pairs(3), jsched.sampling_time_pairs(3), atol=0)
    _close(tsched.sampling_time_pairs(10, (0.0, 0.999), 0.5),
           jsched.sampling_time_pairs(10, (0.0, 0.999), 0.5), atol=0)
    t = np.linspace(0.0, 1.0, 11).astype(np.float32)
    for name in ("cosine", "linear"):
        # log-SNR reaches ~|11|: relative f32 ulps of cos/expm1
        _close(tsched.get_log_snr_fn(name)(_t(t)), jsched.get_log_snr_fn(name)(jnp.asarray(t)),
               atol=1e-4)
    mask_t, x0, noise = _randn(4, 5, 6, 3, seed=1), _randn(4, 5, 6, 3, seed=2), _randn(4, 5, 6, 3, seed=3)
    ls = np.asarray([-3.0, -1.0, 0.5, 2.0], np.float32)
    ls_next = ls + 1.5
    t_next = np.asarray([0.0, 0.2, 0.5, 0.9], np.float32)
    _close(tdiff.ddim_update(_t(mask_t), _t(x0), _t(ls), _t(ls_next)),
           jdiff.ddim_update(mask_t, x0, ls, ls_next))
    _close(tdiff.ddpm_update(_t(mask_t), _t(x0), _t(ls), _t(ls_next), _t(t_next), _t(noise)),
           jdiff.ddpm_update(mask_t, x0, ls, ls_next, t_next, noise))
    _close(tdiff.q_sample(_t(x0), _t(ls), _t(noise)), jdiff.q_sample(x0, ls, noise))


# --- resize -------------------------------------------------------------------

@pytest.mark.parametrize("size", [(16, 16), (5, 7), (13, 29), (3, 2)])
@pytest.mark.parametrize("mode,ac", [("nearest", False), ("bilinear", False),
                                     ("bilinear", True)])
def test_resize(size, mode, ac):
    """Up and down, integer and non-integer ratios, from a 7x11 grid."""
    x = _randn(2, 7, 11, 3)
    got = tresize.resize(_t(x), size, mode=mode, align_corners=ac)
    want = jresize.resize(jnp.asarray(x), size, mode=mode, align_corners=ac)
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want, atol=1e-6)


# --- embeddings -----------------------------------------------------------------

def test_sine_pos_embed():
    _close(tpos.sine_pos_embed(5, 9, num_feats=32), jpos.sine_pos_embed(5, 9, num_feats=32),
           atol=0)


def test_time_mlp():
    jm = jtime.TimeMLP(dim=64)
    ls = np.asarray([-6.0, -1.0, 0.3, 4.0], np.float32)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(ls))
    tm = _port(ttime.TimeMLP(dim=64), v)
    with torch.no_grad():
        _close(tm(_t(ls)), jm.apply(v, jnp.asarray(ls)))


# --- encoder ----------------------------------------------------------------------

def test_swin_nano_padding_and_shift():
    """56x72 input: stage grids 14x18 / 7x9 / 4x5 / 2x3 are padded to the
    window (4) and the shifted blocks run with the -100 mask."""
    kw = jswin.swin_variant("nano")
    kw["depths"] = (2, 2, 1, 1)  # odd blocks are the shifted ones
    jm = jswin.SwinTransformer(drop_path_rate=0.0, **kw)
    x = _randn(2, 56, 72, 3)
    # jitted: eager dispatch of the flax Swin takes tens of seconds on the CPU
    v = jax.jit(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))()
    tm = _port(tswin.SwinTransformer(**kw), v)
    with torch.no_grad():
        got = tm(_t(x))
    want = jax.jit(jm.apply)(v, jnp.asarray(x))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g, w)


def test_fpn_and_merge():
    feats = [_randn(2, 16 // 2 ** i, 18 // 2 ** i, 16 * 2 ** i, seed=i) for i in range(4)]
    jf, jmg = jfpn.FPN(64, num_outs=4), jfpn.MultiStageMerging(64)
    jx = [jnp.asarray(f) for f in feats]
    vf = jf.init(jax.random.PRNGKey(0), jx)
    outs = jf.apply(vf, jx)
    vm = jmg.init(jax.random.PRNGKey(1), outs)
    want = jmg.apply(vm, outs)
    tf = _port(tfpn.FPN([16, 32, 64, 128], 64, num_outs=4), vf)
    tm = _port(tfpn.MultiStageMerging(256, 64), vm)
    with torch.no_grad():
        touts = tf([_t(f) for f in feats])
        got = tm(touts)
    for g, w in zip(touts, outs):
        _close(g, w)
    _close(got, want)


@pytest.mark.parametrize("norm,act", [("GN", None), ("BN", "relu"), (None, "gelu")])
def test_conv_module(norm, act):
    jm = jcommon.ConvModule(32, (3, 3), norm=norm, act=act)
    x = _randn(2, 6, 5, 8)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    if "batch_stats" in v:  # non-trivial running stats, so that the mapping shows
        rng = np.random.RandomState(3)
        v = {"params": v["params"], "batch_stats": jax.tree_util.tree_map(
            lambda a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape), a.dtype), v["batch_stats"])}
    tm = _port(tcommon.ConvModule(8, 32, (3, 3), norm=norm, act=act), v)
    with torch.no_grad():
        _close(tm(_t(x)), jm.apply(v, jnp.asarray(x), train=False))


# --- decoder ------------------------------------------------------------------------

def test_window_self_attention_shift_and_padding():
    """h, w = 10, 13 is not a multiple of the window (4); shift 2 is on."""
    jm = jtr.WindowSelfAttention(64, 4, window=4, shift=2)
    q, pos = _randn(2, 130, 64), _randn(130, 64, seed=1)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(q), jnp.asarray(pos), (10, 13))
    tm = _port(ttr.WindowSelfAttention(64, 4, window=4, shift=2), v)
    with torch.no_grad():
        _close(tm(_t(q), _t(pos), (10, 13)), jm.apply(v, jnp.asarray(q), jnp.asarray(pos), (10, 13)))


def test_time_film_encoder_layer_v1():
    jm = jtr.TimeFiLMEncoderLayer(64, 4, ffn_dim=128, attn_type="window", window=4, shift=2)
    q, pos, time = _randn(2, 96, 64), _randn(96, 64, seed=1), _randn(2, 256, seed=2)
    args = (jnp.asarray(q), jnp.asarray(time), jnp.asarray(pos), None, ((8, 12),))
    v = jm.init(jax.random.PRNGKey(0), *args)
    tm = _port(ttr.TimeFiLMEncoderLayer(64, 4, ffn_dim=128, attn_type="window", window=4,
                                        shift=2), v)
    with torch.no_grad():
        _close(tm(_t(q), _t(time), _t(pos), None, ((8, 12),)), jm.apply(v, *args))


def test_deformable_head_with_time_window():
    jm = jheads.DeformableHeadWithTime(7, 64, num_layers=2, num_heads=4, ffn_dim=128,
                                       attn_type="window", window=4)
    x, time = _randn(2, 10, 12, 64), _randn(2, 256, seed=1)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(time))
    tm = _port(theads.DeformableHeadWithTime(7, 64, num_layers=2, num_heads=4, ffn_dim=128,
                                             attn_type="window", window=4), v)
    with torch.no_grad():
        got = tm(_t(x), _t(time))
    want = jm.apply(v, jnp.asarray(x), jnp.asarray(time))
    assert tuple(got.shape) == (2, 10, 12, 7)
    _close(got, want)


def test_fcn_head():
    jm = jheads.FCNHead(7, 32)
    x = _randn(2, 6, 5, 32)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tm = _port(theads.FCNHead(7, 32, 32), v)
    with torch.no_grad():
        _close(tm(_t(x)), jm.apply(v, jnp.asarray(x)))


# --- evaluation ----------------------------------------------------------------------

def test_microbatched_call_and_metrics():
    x, y = _randn(5, 3, 2), _randn(5, 4, seed=1)

    def fn_t(a, b):
        return a.sum(dim=(1, 2))[:, None] * b + a.shape[0]

    def fn_j(a, b):
        return a.sum(axis=(1, 2))[:, None] * b + a.shape[0]

    for mb in (2, 5, 8):
        _close(microbatched_call(fn_t, _t(x), _t(y), microbatch=mb),
               j_microbatched_call(fn_j, jnp.asarray(x), jnp.asarray(y), microbatch=mb),
               atol=1e-6)

    rng = np.random.RandomState(0)
    tacc, jacc = SegMetricAccumulator(5), JAcc(5)
    for _ in range(3):
        pred = rng.randint(0, 5, (8, 9))
        label = rng.randint(0, 6, (8, 9))
        label[label == 5] = 255
        tacc.update(pred, label)
        jacc.update(pred, label)
    got, want = tacc.compute(), jacc.compute()
    for key in ("aAcc", "mIoU", "mAcc"):
        assert got[key] == want[key]
    np.testing.assert_array_equal(got["IoU_per_class"], want["IoU_per_class"])
