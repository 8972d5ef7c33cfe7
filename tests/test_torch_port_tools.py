"""The port's user tools and the data pieces they read, against the JAX
package on the CPU.

  - The eval data (``ddp_tpu_torch/data/seg_datasets.py``): the palettes and
    class counts, ``normalize_image``, ``CustomSegDataset`` on
    ``tests/data/ade``, ``RepeatDataset``/``ConcatDataset`` and
    ``build_eval_dataset`` (synthetic and ADE20K), bitwise.
  - ``evaluation/slide.py: flip_tta`` and ``multi_scale_flip_tta`` with one
    deterministic prediction function in both packages, within 1e-5.
  - ``tools/print_config`` (every preset of both packages) and
    ``tools/analyze_logs`` text-equal to the JAX tools run through
    ``runpy``.
  - The model tools end to end at ``smoke`` on the CPU: ``publish_model``
    (round trip bitwise, the sha256 name), ``image_demo`` (with and without
    ``--uncertainty``), ``confusion_matrix`` and ``model_ensemble`` (two
    published checkpoints) on ``tests/data/ade``, ``get_flops``: exit 0 and
    the outputs' shapes; ``get_flops``' parameter count equal to JAX's, and
    its counter's FLOPs of one Conv2d and one Linear equal to the hand count.
"""
import contextlib
import io
import json
import os
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_tpu import config as jconfig
from ddp_tpu.data import seg_datasets as jds
from ddp_tpu.evaluation import slide as jslide
from ddp_tpu.evaluation.metrics import SegMetricAccumulator as JSegMetricAccumulator
from ddp_tpu_torch import config as tconfig
from ddp_tpu_torch.data import seg_datasets as tds
from ddp_tpu_torch.data.image_io import read_image, read_png, write_png
from ddp_tpu_torch.evaluation import slide as tslide
from ddp_tpu_torch.tools import (analyze_logs, confusion_matrix, get_flops, image_demo,
                                 model_ensemble, print_config, publish_model)
from torch_port_threads import _one_torch_thread  # noqa: F401


ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
ADE = os.path.join(ROOT, "tests", "data", "ade")
ADE_SET = ["data.dataset=ade20k", f"data.data_root={ADE}", "model.num_classes=150"]


def _jax_tool(name, argv):
    """A JAX tool's standard output, run as ``python tools/<name>.py argv``."""
    out, old = io.StringIO(), sys.argv
    sys.argv = [name] + argv
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_path(os.path.join(ROOT, "tools", f"{name}.py"), run_name="__main__")
    finally:
        sys.argv = old
    return out.getvalue()


def _port_tool(module, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert module.main(argv) == 0
    return out.getvalue()


# --- the eval data ------------------------------------------------------------------

def test_palettes_and_metadata_match_jax():
    assert tds.PALETTES == jds.PALETTES
    assert tds.NUM_CLASSES == jds.NUM_CLASSES
    assert tds.CITYSCAPES_CLASSES == jds.CITYSCAPES_CLASSES
    assert tds.CITYSCAPES_PALETTE == jds.CITYSCAPES_PALETTE
    for n in (1, 21, 256):
        assert tds.voc_palette(n) == jds.voc_palette(n)
    assert (tds.IMAGENET_MEAN, tds.IMAGENET_STD) == (jds.IMAGENET_MEAN, jds.IMAGENET_STD)


def test_normalize_image_is_bitwise_jax():
    img = np.random.default_rng(0).uniform(0, 255, (7, 9, 3)).astype(np.float32)
    got, want = tds.normalize_image(img), jds.normalize_image(img)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    got = tds.normalize_image(img, (1.0, 2.0, 3.0), (4.0, 5.0, 6.0))
    assert np.array_equal(got, jds.normalize_image(img, (1.0, 2.0, 3.0), (4.0, 5.0, 6.0)))


def _same_samples(a, b, n=None):
    assert len(a) == len(b)
    for i in range(len(a) if n is None else n):
        x, y = a.load(i), b.load(i)
        assert x.keys() == y.keys()
        for k in x:
            assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), (i, k)


@pytest.mark.parametrize("split", ["training", "validation"])
def test_custom_seg_dataset_and_wrappers_match_jax(split):
    lut = np.arange(256, dtype=np.int32)[::-1].copy()
    args = (os.path.join(ADE, "images", split), os.path.join(ADE, "annotations", split))
    for kw in ({"reduce_zero_label": True}, {"label_map": lut}, {}):
        t, j = tds.CustomSegDataset(*args, **kw), jds.CustomSegDataset(*args, **kw)
        assert len(t) == 2
        _same_samples(t, j)
    t, j = tds.CustomSegDataset(*args), jds.CustomSegDataset(*args)
    _same_samples(tds.RepeatDataset(t, 3), jds.RepeatDataset(j, 3))
    syn_t, syn_j = tds.SyntheticSegDataset(length=3), jds.SyntheticSegDataset(length=3)
    _same_samples(tds.ConcatDataset([t, syn_t, t]), jds.ConcatDataset([j, syn_j, j]))


@pytest.mark.parametrize("dataset", ["synthetic", "ade20k"])
def test_build_eval_dataset_matches_jax(dataset):
    dc = tconfig.DataConfig(dataset=dataset, data_root=ADE)
    jdc = jconfig.DataConfig(dataset=dataset, data_root=ADE)
    got, want = list(zip(range(3), tds.build_eval_dataset(dc))), \
        list(zip(range(3), jds.build_eval_dataset(jdc)))
    assert len(got) == len(want) == (3 if dataset == "synthetic" else 2)
    for (_, x), (_, y) in zip(got, want):
        for k in ("image", "label"):
            assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), k


def test_write_png_reads_back(tmp_path):
    rng = np.random.default_rng(1)
    grey = rng.integers(0, 256, (5, 7), dtype=np.uint8)
    rgb = rng.integers(0, 256, (4, 6, 3), dtype=np.uint8)
    for img in (grey, rgb):
        path = str(tmp_path / f"_png_{img.ndim}.png")
        write_png(path, img)
        assert np.array_equal(read_png(path), img) and np.array_equal(read_image(path), img)


# --- test-time augmentation ---------------------------------------------------------

_W = np.random.default_rng(3).normal(size=(3, 5)).astype(np.float32)


def _predict_jax(x):
    """Per pixel: tanh of a channel mix, plus a ramp along the width (so a
    mirrored image predicts differently)."""
    ramp = jnp.arange(x.shape[2], dtype=jnp.float32)[None, None, :, None] / x.shape[2]
    return jnp.tanh(x @ _W) + ramp * x[..., :1]


def _predict_torch(x):
    ramp = torch.arange(x.shape[2], dtype=torch.float32)[None, None, :, None] / x.shape[2]
    return torch.tanh(x @ torch.from_numpy(_W)) + ramp * x[..., :1]


@pytest.mark.parametrize("kind", ["flip", "multi_scale", "multi_scale_no_flip"])
def test_tta_matches_jax(kind):
    img = np.random.default_rng(4).normal(size=(2, 12, 16, 3)).astype(np.float32)
    if kind == "flip":
        got = tslide.flip_tta(_predict_torch, torch.from_numpy(img))
        want = jax.jit(lambda x: jslide.flip_tta(_predict_jax, x))(img)
    else:
        flip = kind == "multi_scale"
        got = tslide.multi_scale_flip_tta(_predict_torch, torch.from_numpy(img), flip=flip)
        want = jax.jit(lambda x: jslide.multi_scale_flip_tta(_predict_jax, x, flip=flip))(img)
    assert tuple(got.shape) == want.shape == (2, 12, 16, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


# --- print_config and analyze_logs --------------------------------------------------

SHARED_PRESETS = sorted(set(tconfig.PRESETS) & set(jconfig.PRESETS))


@pytest.mark.parametrize("preset", SHARED_PRESETS)
def test_print_config_matches_jax(preset):
    """The same text, but where the port's end check writes beside the JAX
    package's result: its workdir ``work_dirs/torch_<name>``."""
    got, want = _port_tool(print_config, [preset]), _jax_tool("print_config", [preset])
    workdir = json.loads(want)["runtime"]["workdir"]
    if json.loads(got)["runtime"]["workdir"] != workdir:
        assert preset.startswith("converge_")
        want = want.replace(f'"{workdir}"', f'"{workdir.replace("work_dirs/", "work_dirs/torch_")}"')
    assert got == want


def test_print_config_overrides_and_list():
    argv = ["ade20k_swin_t", "--set", "optim.lr=1e-4", "data.crop_size=(256,256)"]
    assert _port_tool(print_config, argv) == _jax_tool("print_config", argv)
    assert _port_tool(print_config, ["--list"]).split() == sorted(tconfig.PRESETS)


@pytest.fixture(scope="module")
def train_log(tmp_path_factory):
    d = tmp_path_factory.mktemp("log")
    rng = np.random.default_rng(2)
    with open(d / "train_log.jsonl", "w") as f:
        for step in range(10, 110, 10):
            f.write(json.dumps({"step": step, "lr": 1e-4 * step / 100,
                                "steps_per_s": float(rng.uniform(1, 3)),
                                "loss": float(rng.uniform(0, 2)),
                                "decode.acc_seg": float(rng.uniform())}) + "\n")
    return str(d)


@pytest.mark.parametrize("argv", [[], ["--keys", "loss", "absent"], ["--interval", "3"]])
def test_analyze_logs_matches_jax(train_log, argv):
    for path in (train_log, os.path.join(train_log, "train_log.jsonl")):
        assert _port_tool(analyze_logs, [path] + argv) == \
            _jax_tool("analyze_logs", [path] + argv)


# --- the model tools end to end -----------------------------------------------------

@pytest.fixture(scope="module")
def published(tmp_path_factory):
    """Two published smoke checkpoints (steps 1 and 2: the seeded init, and
    it perturbed) and the state_dicts they hold."""
    from ddp_tpu_torch.config import build_model, get_config
    from ddp_tpu_torch.train.checkpoint import CheckpointManager
    from ddp_tpu_torch.train.optim import make_optimizer
    from ddp_tpu_torch.train.step import TrainState

    d = tmp_path_factory.mktemp("pub")
    cfg = get_config("smoke", {"model.num_classes": "150"})
    model = build_model(cfg.model, device="cpu", input_size=cfg.data.crop_size)
    state = TrainState(model, make_optimizer(cfg.optim, model), torch.Generator())
    ckpt = CheckpointManager(str(d / "run"))
    states, paths = [], []
    for step in (1, 2):
        if step == 2:
            with torch.no_grad():
                for p in model.parameters():
                    p.add_(0.01 * torch.randn(p.shape, generator=torch.Generator().manual_seed(9)))
        state.step = step
        ckpt.save(step, state)
        states.append({k: v.clone() for k, v in model.state_dict().items()})
        out = _port_tool(publish_model, [str(d / "run"), str(d / "smoke"), "--step", str(step)])
        paths.append(out.split(" -> ")[1].split(" (")[0])
    return paths, states, str(d)


def test_publish_model_round_trip(published):
    import hashlib

    from ddp_tpu_torch.train.checkpoint import read_published

    paths, states, _ = published
    for path, sd in zip(paths, states):
        blob = open(path, "rb").read()
        assert path.endswith(f"-{hashlib.sha256(blob).hexdigest()[:8]}.pt")
        got = read_published(path)
        assert got.keys() == sd.keys()
        assert all(torch.equal(got[k], sd[k]) for k in sd)
    with pytest.raises(SystemExit):
        publish_model.main([os.path.join(published[2], "none"), "x"])


@pytest.mark.parametrize("uncertainty", [False, True])
def test_image_demo_end_to_end(published, uncertainty):
    d = published[2]
    img = os.path.join(d, "in.png")
    write_png(img, np.random.default_rng(5).integers(0, 256, (64, 96, 3), dtype=np.uint8))
    argv = ["smoke", img, "--ckpt", published[0][1], "--out", os.path.join(d, "pred.png"),
            "--device", "cpu", "--set", "model.num_classes=150", "data.dataset=ade20k"]
    if uncertainty:
        argv += ["--uncertainty", os.path.join(d, "heat.png")]
    out = _port_tool(image_demo, argv)
    assert "saved" in out
    pred = read_image(os.path.join(d, "pred.png"))
    assert pred.shape == (64, 96, 3) and pred.dtype == np.uint8
    # every pixel takes a colour of the ADE20K palette
    pal = {tuple(c) for c in tds.PALETTES["ade20k"]}
    assert {tuple(c) for c in pred.reshape(-1, 3)} <= pal
    if uncertainty:
        assert read_image(os.path.join(d, "heat.png")).shape == (64, 96)


def test_confusion_matrix_and_ensemble_end_to_end(published):
    paths, _, d = published
    out_cm = os.path.join(d, "cm.npy")
    out = _port_tool(confusion_matrix, ["smoke", "--ckpt", paths[0], "--out", out_cm,
                                        "--device", "cpu", "--set"] + ADE_SET)
    cm = np.load(out_cm)
    assert cm.shape == (150, 150) and cm.dtype == np.int64 and "aAcc" in out
    labels = [s["label"] for s in tds.build_eval_dataset(
        tconfig.DataConfig(dataset="ade20k", data_root=ADE))]
    assert cm.sum() == sum(int((lab != 255).sum()) for lab in labels)
    out = _port_tool(model_ensemble, ["smoke"] + paths + ["--device", "cpu", "--set"]
                     + ADE_SET)
    assert out.startswith("ensemble of 2: aAcc") and out.rstrip().endswith("(n=2)")


def test_jax_ensemble_tool_calls_a_missing_summary():
    """The JAX ``tools/model_ensemble.py:67`` prints ``acc.summary()``, which
    ``ddp_tpu/evaluation/metrics.py``'s accumulator does not define (so the
    JAX tool raises after scoring); the port prints its metric line."""
    assert not hasattr(JSegMetricAccumulator, "summary")


def test_get_flops_end_to_end_and_parameters_match_jax():
    from flax_shapes import shapes_of

    out = _port_tool(get_flops, ["smoke", "--size", "64", "--device", "cpu"])
    lines = dict(line.split(":", 1) for line in out.strip().splitlines())
    assert get_flops.COUNTER in lines["forward flops"]
    assert float(lines["forward flops"].split()[0]) > 0
    jm = jconfig.build_model(jconfig.get_config("smoke").model)
    img = jnp.zeros((1, 64, 64, 3))
    variables = shapes_of(jm, img, jnp.zeros((1, 64, 64), jnp.int32), train=False)
    want = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(variables["params"]))
    model = tconfig.build_model(tconfig.get_config("smoke").model, device="cpu",
                                input_size=(64, 64))
    assert sum(p.numel() for p in model.parameters()) == want
    assert lines["params"].strip() == f"{want / 1e6:.2f} M"


def test_flop_counter_counts_conv_and_linear_by_hand():
    conv, lin = torch.nn.Conv2d(3, 4, 3), torch.nn.Linear(10, 5)
    x, y = torch.zeros(1, 3, 8, 8), torch.zeros(2, 10)
    # 2 FLOPs per multiply-add: conv 3·3²·4 per output pixel of 6 × 6;
    # linear 10·5 per row of 2
    assert get_flops.count_flops(lambda: (conv(x), lin(y))) == \
        2 * 3 * 9 * 4 * 36 + 2 * 2 * 10 * 5


def test_group_norm_one_value_per_group_matches_flax():
    """A map with one value per group (32 groups of one channel at 1 x 1, as
    ``smoke``'s FPN top at a 32^2 single image), where ``F.group_norm``
    refuses: the port's GroupNorm gives flax's output (the bias), float32."""
    import flax.linen as fnn

    from ddp_tpu_torch.nn.common import GroupNorm

    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, 1, 1, 32)).astype(np.float32)
    scale, bias = (rng.normal(size=32).astype(np.float32) for _ in range(2))
    gn = fnn.GroupNorm(num_groups=32)
    want = np.asarray(gn.apply({"params": {"scale": scale, "bias": bias}}, x))
    tg = GroupNorm(32, 32, eps=1e-5).eval()
    tg.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias)})
    got = tg(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(want, bias[None, None, None], rtol=0, atol=1e-6)
