"""The port's compat segmentors (``ddp_tpu_torch/models/compat_segmentor.py``)
against the JAX package's, on the CPU, and the weight bridge of the five
published configurations that ``chip_smoke.py`` runs at full width.

Weights: the flax variable tree shaped by ``jax.eval_shape`` and filled with
seeded numpy values, carried across by ``convert.py``; the JAX side is
jitted once per case. Dropout is 0 (the JAX side through a subclass that
builds its heads with dropout 0; the port's heads get ``dropout = 0``), so
both draw nothing.

  - A tiny UPerNet ``EncoderDecoder`` (ResNet-18 at width 8, UPerHead 16 with
    pool scales 1 and 3, the FCN aux head) and a tiny FCN -> OCR
    ``CascadeEncoderDecoder`` on a two-branch HRNet, one training step's
    forward and backward in float64 on both
    sides: the loss within 1e-5 relative and each log key, every gradient
    within 1e-3 · max|g| + 1e-6, the BatchNorm running statistics within
    1e-5 of their max; the float32 ``predict`` equal to JAX's argmax on at
    least 99.9 % of the pixels. Why float64: a float32 gradient comparison
    is at the mercy of ReLU kinks (a pre-activation within rounding of 0
    takes one side in one package and the other side in the other, and
    every gradient upstream moves): at 2 x 64² a 4-branch tiny HRNet and at
    4 x 48² UPerNet's lateral0 parted by 5-10 %, at 3 x 48² the HRNet's
    fuse conv by 0.6 % in one run of three (XLA's threads sum in another
    order from run to run), and FCNHead alone on 2 x 4² x 32 by 15 % in one
    channel, where the port's float32 gradient is within 5e-7 of its
    float64 one and JAX's float32 is 15 % from JAX's float64. The float32
    forward is held by the backbone and head tests and by ``chip_smoke.py:
    compat_reference``.
  - ``EncoderDecoder`` refuses a tuple head output other than EncHead's
    (logits, SE logits), as JAX's does; two reference gaps the port follows.
  - Every flax leaf of upernet_r50, deeplabv3plus_r50-d8, ocrnet_hr18,
    segformer_mit-b0 and dpt_vit-b16 (ViT-B/16 and its DPTHead) maps
    through ``params_from_flax`` onto the port's modules (``check_complete``),
    shapes from ``jax.eval_shape`` (nothing initialised), the port built on
    the meta device.
"""
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_tpu.models import compat_segmentor as jseg
from ddp_tpu.nn import compat_heads as jch
from ddp_tpu.nn import head_registry as jreg
from ddp_tpu.nn import heads as jheads
from ddp_tpu.nn import mit as jmit
from ddp_tpu.nn import mobile_hrnet as jmh
from ddp_tpu.nn import resnet as jres
from ddp_tpu.nn import vit as jvit
from ddp_tpu_torch.convert import check_complete, load_flax, params_from_flax
from ddp_tpu_torch.models import compat_segmentor as tseg
from ddp_tpu_torch.nn import compat_heads as tch
from ddp_tpu_torch.nn import mit as tmit
from ddp_tpu_torch.nn import mobile_hrnet as tmh
from ddp_tpu_torch.nn import resnet as tres
from ddp_tpu_torch.nn import vit as tvit

K = 5
B, S = 3, 48


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


class _JaxEncoderDecoder(jseg.EncoderDecoder):
    """JAX's EncoderDecoder with the aux head's dropout at 0."""

    def setup(self):
        kw = dict(self.head_kwargs or {})
        kw.setdefault("num_classes", self.num_classes)
        self.decode_head = jreg.build_head(self.head_name, **kw)
        self.auxiliary_head = jheads.FCNHead(self.num_classes, norm="BN", dropout=0.0)


class _JaxCascade(jseg.CascadeEncoderDecoder):
    """JAX's CascadeEncoderDecoder with both stages' dropout at 0."""

    def setup(self):
        self.stage0 = jheads.FCNHead(self.num_classes, self.channels, norm="BN", dropout=0.0)
        self.stage1 = jch.OCRHead(self.num_classes, channels=self.channels,
                                  ocr_channels=self.ocr_channels, dropout=0.0)


def _dropout_off(model):
    for m in model.modules():
        if hasattr(m, "dropout") and isinstance(m.dropout, float):
            m.dropout = 0.0
    return model


HR_TINY = dict(widths=(4, 8), blocks_per_stage=1, stage_modules=(1,))
CASES = {
    "upernet": (lambda: _JaxEncoderDecoder(
                    jres.ResNet(depth=18, stem_channels=8, base_channels=8), "uper", K,
                    head_kwargs=dict(channels=16, pool_scales=(1, 3), dropout=0.0)),
                lambda: tseg.EncoderDecoder(
                    tres.ResNet(depth=18, stem_channels=8, base_channels=8), "uper", K,
                    head_kwargs=dict(channels=16, pool_scales=(1, 3), dropout=0.0))),
    "ocr_cascade": (lambda: _JaxCascade(jmh.HRNet(**HR_TINY), K, channels=16, ocr_channels=8),
                    lambda: tseg.CascadeEncoderDecoder(tmh.HRNet(**HR_TINY), K, channels=16,
                                                       ocr_channels=8)),
}


def _batch(seed=3):
    rng = np.random.RandomState(seed)
    img = rng.randn(B, S, S, 3).astype(np.float32)
    gt = rng.randint(0, K, (B, S, S)).astype(np.int32)
    gt[:, :4] = 255  # ignored pixels
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
def jax_case(name):
    """(variables, (loss, logs), grads, new batch stats) of one float64
    training step, and the float32 predict."""
    jmod = CASES[name][0]()
    img, gt = _batch()
    rngs = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}
    shapes = jax.eval_shape(lambda: jmod.init(rngs, img, gt, train=False))
    variables = fill_variables(shapes)

    def loss_fn(params, stats, img, gt):
        (loss, logs), new = jmod.apply({"params": params, "batch_stats": stats}, img, gt,
                                       train=True, mutable=["batch_stats"])
        return loss, (logs, new["batch_stats"])

    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    with float64():
        (loss, (logs, stats)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            _f64(variables["params"]), _f64(variables["batch_stats"]), _f64(img), gt)
        step = ((float(loss), {k: float(v) for k, v in logs.items()}), to_np(grads),
                to_np(stats))
    pred = jax.jit(lambda v, x: jmod.apply(v, x, method=jmod.predict))(variables, img)
    return (variables, *step, np.asarray(pred))


@pytest.mark.parametrize("name", sorted(CASES))
def test_segmentor_step_matches_jax(name):
    variables, (loss_j, logs_j), grads_j, stats_j, pred_j = jax_case(name)
    model = _dropout_off(CASES[name][1]())
    load_flax(model, variables["params"], variables["batch_stats"])
    img, gt = (torch.from_numpy(a) for a in _batch())
    model.double().train()
    loss, logs = model(img.double(), gt.long())
    loss.backward()
    assert abs(loss.item() - loss_j) <= 1e-5 * abs(loss_j)
    assert set(logs) == set(logs_j)
    for k, v in logs_j.items():
        assert abs(logs[k].item() - v) <= 1e-5 * max(abs(v), 1e-3), k
    named = dict(model.named_parameters())
    want_g = params_from_flax(grads_j)
    assert set(want_g) == set(named)
    for key, w in want_g.items():
        w = w.numpy()
        err = np.abs(named[key].grad.numpy() - w).max()
        assert err <= 1e-3 * np.abs(w).max() + 1e-6, (key, err)
    sd = model.state_dict()
    for key, w in params_from_flax({}, stats_j).items():
        if not key.endswith("num_batches_tracked"):
            w = w.numpy()
            assert np.abs(sd[key].numpy() - w).max() <= 1e-5 * np.abs(w).max() + 1e-7, key
    # predict, float32, in eval mode with the running statistics the JAX side had
    load_flax(model.float(), variables["params"], variables["batch_stats"])
    pred = model.predict(img).numpy()
    assert pred.shape == pred_j.shape
    assert (pred == pred_j).mean() >= 0.999


def test_encoder_decoder_refuses_tuple_heads():
    """A tuple head output is (logits, se_logits), EncHead's (held to JAX in
    ``test_torch_port_compat_segmentor2.py``); DAHead's three aux outputs are
    refused, as JAX's unpacking refuses them."""
    backbone = tres.ResNet(depth=18, stem_channels=8, base_channels=8)
    model = tseg.EncoderDecoder(backbone, "da", K,
                                head_kwargs=dict(channels=16, return_aux=True)).eval()
    img, gt = (torch.from_numpy(a) for a in _batch())
    with pytest.raises(ValueError, match="unpack"):
        model(img, gt.long())
    jm = jseg.EncoderDecoder(jres.ResNet(depth=18, stem_channels=8, base_channels=8), "da", K,
                             head_kwargs=dict(channels=16, return_aux=True))
    with pytest.raises(ValueError, match="unpack"):
        jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), img.numpy(), gt.numpy(),
                                       train=False))


# the five published configurations of chip_smoke.py's compat_main, at
# their widths: (JAX modules, port modules), each a (name, module) list
def _published():
    r50_d8 = dict(depth=50, strides=(1, 2, 1, 1), dilations=(1, 1, 2, 4))
    hr18 = dict(widths=(18, 36, 72, 144), blocks_per_stage=4, stage_modules=(1, 4, 3))
    vit_b = dict(**jvit.vit_variant("base"), patch_size=16)
    dpt = dict(channels=256, post_channels=(96, 192, 384, 768), mode="seg")
    return {
        "upernet_r50": (
            [jseg.EncoderDecoder(jres.ResNet(depth=50), "uper", 150,
                                 head_kwargs=dict(channels=512))],
            lambda: [tseg.EncoderDecoder(tres.ResNet(depth=50), "uper", 150,
                                         head_kwargs=dict(channels=512))]),
        "deeplabv3plus_r50-d8": (
            [jseg.EncoderDecoder(jres.ResNet(**r50_d8), "sep_aspp", 19,
                                 head_kwargs=dict(channels=512, c1_channels=48))],
            lambda: [tseg.EncoderDecoder(tres.ResNet(**r50_d8), "sep_aspp", 19,
                                         head_kwargs=dict(channels=512, c1_channels=48))]),
        "ocrnet_hr18": (
            [jseg.CascadeEncoderDecoder(jmh.HRNet(**hr18), 19, channels=512, ocr_channels=256)],
            lambda: [tseg.CascadeEncoderDecoder(tmh.HRNet(**hr18), 19, channels=512,
                                                ocr_channels=256)]),
        "segformer_mit-b0": (
            [jseg.EncoderDecoder(jmit.MixVisionTransformer(**jmit.mit_variant("b0")),
                                 "segformer", 150, head_kwargs=dict(channels=256),
                                 aux_head=False)],
            lambda: [tseg.EncoderDecoder(tmit.MixVisionTransformer(**tmit.mit_variant("b0")),
                                         "segformer", 150, head_kwargs=dict(channels=256),
                                         aux_head=False)]),
        "dpt_vit-b16": (
            [jvit.VisionTransformer(**vit_b), jch.DPTHead(150, **dpt)],
            lambda: [tvit.VisionTransformer(**vit_b), tch.DPTHead(150, [768] * 4, **dpt)]),
    }


@pytest.mark.parametrize("name", ["upernet_r50", "deeplabv3plus_r50-d8", "ocrnet_hr18",
                                  "segformer_mit-b0", "dpt_vit-b16"])
def test_published_configs_map_every_flax_leaf(name):
    jmods, tmods = _published()[name]
    with torch.device("meta"):
        tmods = tmods()
    img = jnp.zeros((1, 64, 64, 3))
    rngs = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}
    for jmod, tmod in zip(jmods, tmods):
        if isinstance(jmod, jch.DPTHead):
            args = ([jnp.zeros((1, 4, 4, 768))] * 4,)
        elif isinstance(jmod, jvit.VisionTransformer):
            args = (img,)
        else:
            args = (img, jnp.zeros((1, 64, 64), jnp.int32))
        shapes = jax.eval_shape(lambda: jmod.init(rngs, *args, train=False))
        zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
        sd = params_from_flax(zeros["params"], zeros.get("batch_stats"))
        check_complete(tmod, sd)


@pytest.mark.parametrize("gap", ["hrnet_stage1", "cascade_channels"])
def test_reference_gaps_the_port_follows(gap):
    """Where the JAX package simplifies mmseg, the port follows it (ROADMAP
    queue 3): HRNet's stage 1 is two basic blocks at 64 channels (mmseg:
    four bottlenecks to 256); the cascade's FCN stage takes the OCR stage's
    ``channels`` (the published OCRNet's FCN has 270 = sum of HRNet-W18's
    widths)."""
    if gap == "hrnet_stage1":
        x = jnp.zeros((1, 64, 64, 3))
        shapes = jax.eval_shape(lambda: jmh.HRNet(**HR_TINY).init(jax.random.PRNGKey(0), x))
        layer1 = {k for k in shapes["params"] if k.startswith("layer1_")}
        assert layer1 == {"layer1_0"}
        assert shapes["params"]["layer1_0"]["conv1"]["kernel"].shape == (3, 3, 64, 64)
        port = tmh.HRNet(**HR_TINY)
        assert [n for n, _ in port.named_children() if n.startswith("layer1_")] == ["layer1_0"]
        assert tuple(port.layer1_0.conv1.weight.shape) == (64, 64, 3, 3)
    else:
        with torch.device("meta"):
            model = tseg.CascadeEncoderDecoder(tmh.HRNet(), 19, channels=512, ocr_channels=256)
        assert sum(model.backbone.out_channels) == 270
        assert model.stage0.conv0.conv.weight.shape[:2] == (512, 270)
        assert model.stage1.bottleneck.conv.weight.shape[:2] == (512, 270)
