"""The port's depth data, metrics' inputs, end check and CLIs against the
JAX package, on the CPU (the tiny files under tests/data, and a KITTI tree
written here; no download).

  - The helpers (Eigen and Garg crops, the KB crop, SUNRGBD's bit-rotated
    depth, Cityscapes' disparity to depth) bitwise the JAX package's.
  - ``DepthDataset`` on tests/data/{nyu, sunrgbd, cityscapes_depth} and on
    a KITTI tree of 376 x 1242 PNGs (wider than 1216, so the KB crop
    bites), both splits: bitwise the JAX package's; with Pillow blocked the
    PNG trees read through ``read_png`` (16-bit depth included) and give the
    same samples. ``SyntheticDepthDataset``, ``depth_batch_iterator`` (a crop
    wider than the images, so the pad bites) and
    ``make_train_iter``'s depth branch: bitwise.
  - The depth end check's held-out batches are the harness's; ``eval_depth``
    gives its keys, deterministically.
  - ``python -m ddp_tpu_torch.tools.train`` and ``tools.test`` (called
    in-process) on tests/data/nyu with ``--device cpu``: the run logs and
    checkpoints, the evaluator restores it and prints the nine metrics (and,
    with ``--uncertainty``, the ensemble's spread).
"""
import dataclasses
import importlib.util
import json
import os
import re
import sys

import numpy as np
import pytest
from PIL import Image

from ddp_tpu import config as jconfig
from ddp_tpu.data import depth_datasets as jdd
from ddp_tpu.data import make_train_iter as jmake_train_iter
from ddp_tpu_torch import config as tconfig
from ddp_tpu_torch.config import build_model, get_config
from ddp_tpu_torch.data import depth_datasets as tdd
from ddp_tpu_torch.data import make_train_iter
from ddp_tpu_torch.evaluation import convergence as C
from ddp_tpu_torch.tools import test as test_cli
from ddp_tpu_torch.tools import train as train_cli
from torch_port_threads import _one_torch_thread  # noqa: F401


DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
ROOTS = {"nyu": "nyu", "sunrgbd": "sunrgbd", "cityscapes": "cityscapes_depth"}


def _same_sample(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    """Two 376 x 1242 KITTI frames (RGB and 16-bit depth at scale 256, zeros
    where LiDAR has no return), both splits."""
    root = tmp_path_factory.mktemp("kitti")
    rng = np.random.default_rng(0)
    os.makedirs(root / "rgb")
    os.makedirs(root / "depth")
    lines = []
    for i in range(2):
        img = rng.integers(0, 256, (376, 1242, 3), dtype=np.uint8)
        depth = (rng.uniform(1.0, 80.0, (376, 1242)) * 256).astype(np.uint16)
        depth[rng.random((376, 1242)) < 0.7] = 0
        Image.fromarray(img).save(root / "rgb" / f"{i}.png")
        Image.fromarray(depth).save(root / "depth" / f"{i}.png")
        lines.append(f"rgb/{i}.png depth/{i}.png 721.5377\n")
    lines.append("rgb/1.png None 721.5377\n")  # no ground truth: skipped
    for split in ("train", "test"):
        (root / f"kitti_{split}.txt").write_text("".join(lines))
    return str(root)


def _root(dataset, kitti_root):
    return kitti_root if dataset == "kitti" else os.path.join(DATA, ROOTS[dataset])


# --- helpers and datasets ---------------------------------------------------------------

def test_helpers_match_jax():
    for shape in ((480, 640), (48, 64), (352, 1216), (48, 96)):
        assert np.array_equal(tdd.nyu_eval_mask(shape), jdd.nyu_eval_mask(shape))
        assert np.array_equal(tdd.garg_crop_mask(shape), jdd.garg_crop_mask(shape))
    rng = np.random.default_rng(1)
    img = rng.random((376, 1242, 3)).astype(np.float32)
    depth = rng.random((376, 1242)).astype(np.float32)
    for got, want in zip(tdd.kb_crop(img, depth), jdd.kb_crop(img, depth)):
        assert got.shape[:2] == (352, 1216) and np.array_equal(got, want)
    assert tdd.kb_crop(img)[1] is None
    raw = rng.integers(0, 2 ** 16, (40, 50), dtype=np.uint16)
    _same_sample({"d": tdd.sunrgbd_decode_depth(raw)}, {"d": jdd.sunrgbd_decode_depth(raw)})
    raw[raw < 3000] = 0
    raw[0, :5] = 1  # disparity 0 where raw is 1
    _same_sample({"d": tdd.cityscapes_disparity_to_depth(raw, 0.209313, 2262.52)},
                 {"d": jdd.cityscapes_disparity_to_depth(raw, 0.209313, 2262.52)})


@pytest.mark.parametrize("split", ["train", "test"])
@pytest.mark.parametrize("dataset", ["nyu", "sunrgbd", "cityscapes", "kitti"])
def test_depth_dataset_matches_jax(dataset, split, kitti_root):
    root = _root(dataset, kitti_root)
    t, j = tdd.DepthDataset(root, split, dataset), jdd.DepthDataset(root, split, dataset)
    assert t.items == j.items and len(t) == 2
    for i in range(len(t)):
        a = t.load(i)
        _same_sample(a, j.load(i))
        assert (a["label"] > 0).any() and a["label"].min() >= 0
    if dataset == "kitti":
        assert a["image"].shape == (352, 1216, 3)
    with pytest.raises(ValueError, match="unknown depth dataset"):
        tdd.DepthDataset(root, split, "make3d")


@pytest.mark.parametrize("dataset", ["cityscapes", "kitti"])
def test_png_trees_without_pillow(dataset, kitti_root, monkeypatch):
    """Pillow blocked: the RGB images and the 16-bit depth (disparity) PNGs
    go through read_png and give the JAX package's samples (read through
    Pillow first)."""
    root = _root(dataset, kitti_root)
    want = [jdd.DepthDataset(root, "test", dataset).load(i) for i in range(2)]
    for k in [k for k in sys.modules if k.split(".")[0] == "PIL"]:
        monkeypatch.delitem(sys.modules, k)
    monkeypatch.setitem(sys.modules, "PIL", None)
    t = tdd.DepthDataset(root, "test", dataset)
    for i in range(2):
        _same_sample(t.load(i), want[i])


def test_eval_masks_by_dataset():
    shape = (480, 640)
    for dataset, want in (("nyu", jdd.nyu_eval_mask(shape)), ("sunrgbd", jdd.nyu_eval_mask(shape)),
                          ("kitti", jdd.garg_crop_mask(shape)),
                          ("cityscapes", jdd.garg_crop_mask(shape)),
                          ("synthetic", np.ones(shape, bool))):
        assert np.array_equal(tdd.eval_mask(dataset, shape), want), dataset


def test_synthetic_depth_matches_jax():
    t = tdd.SyntheticDepthDataset((48, 72), length=10, max_depth=80.0)
    j = jdd.SyntheticDepthDataset((48, 72), length=10, max_depth=80.0)
    assert len(t) == len(j) == 10
    for i in (0, 7, 100_003):
        _same_sample(t.load(i), j.load(i))


def test_depth_batch_iterator_matches_jax():
    """Batches of 3 from 2 files (the epoch crosses into the next
    permutation), 40 x 72 crops of 48 x 64 images: the width is padded."""
    ds = tdd.DepthDataset(os.path.join(DATA, "nyu"), "train", "nyu")
    jds = jdd.DepthDataset(os.path.join(DATA, "nyu"), "train", "nyu")
    t_it = tdd.depth_batch_iterator(ds, 3, (40, 72), seed=4)
    j_it = jdd.depth_batch_iterator(jds, 3, (40, 72), seed=4, train=True)
    for _ in range(3):
        a, b = next(t_it), next(j_it)
        assert a["image"].shape == (3, 40, 72, 3) and a["label"].shape == (3, 40, 72)
        assert not a["label"][:, :, 64:].any()
        _same_sample(a, b)
    with pytest.raises(ValueError, match="does not split"):
        tdd.depth_batch_iterator(ds, 3, (40, 72), world=2)


def _depth_cfgs(dataset, root, **extra):
    over = {"data.dataset": dataset, "data.data_root": root, "data.batch_size": "4",
            "data.crop_size": "(32,40)", "runtime.seed": "3", **extra}
    return tconfig.get_config("converge_depth", over), jconfig.get_config("converge_depth", over)


@pytest.mark.parametrize("dataset", ["nyu", "synthetic", "kitti"])
def test_make_train_iter_depth_matches_jax(dataset, kitti_root):
    root = "" if dataset == "synthetic" else _root(dataset, kitti_root)
    t_cfg, j_cfg = _depth_cfgs(dataset, root)
    t_it, j_it = make_train_iter(t_cfg), jmake_train_iter(j_cfg)
    for _ in range(2):
        a, b = next(t_it), next(j_it)
        assert a["image"].shape == (4, 32, 40, 3) and a["label"].dtype == np.float32
        _same_sample(a, b)


def test_make_train_iter_depth_empty_root_raises(tmp_path):
    t_cfg, _ = _depth_cfgs("nyu", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="no data for nyu"):
        make_train_iter(t_cfg)


# --- the depth end check ------------------------------------------------------------------

def test_heldout_depth_batches_match_harness():
    spec = importlib.util.spec_from_file_location(
        "run_convergence", os.path.join(DATA, "..", "..", "tools", "run_convergence.py"))
    harness = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(harness)
    from ddp_tpu.data.pipelines import normalize as jnormalize

    ds = jdd.SyntheticDepthDataset((64, 64), max_depth=10.0)
    got = C.heldout_depth_batches(10.0)
    assert len(got) == harness.N_EVAL // harness.EVAL_BATCH
    for (img, depth), s0 in zip(got, range(0, harness.N_EVAL, harness.EVAL_BATCH)):
        samples = [jnormalize(ds.load(harness.HELDOUT_BASE + i), (123.675, 116.28, 103.53),
                              (58.395, 57.12, 57.375))
                   for i in range(s0, s0 + harness.EVAL_BATCH)]
        _same_sample({"image": img, "label": depth},
                     {"image": np.stack([s["image"] for s in samples]),
                      "label": np.stack([s["label"] for s in samples])})


def test_eval_depth_runs_and_is_deterministic():
    """A random-weight depther (converge_depth with 2 decoder layers), one
    horizon and one seed: the harness's keys, finite metrics, the same
    values twice."""
    mc = dataclasses.replace(get_config("converge_depth").model, decoder_layers=2)
    model = build_model(mc, device="cpu", seed=0)
    a = C.eval_depth(model, mc, timesteps_list=(1,), seeds=(0,))
    b = C.eval_depth(model, mc, timesteps_list=(1,), seeds=(0,))
    assert set(a) == {"abs_rel@1step", "abs_rel@1step_std", "rmse@1step", "rmse@1step_std",
                      "a1@1step"} and a == b
    assert 0.0 <= a["a1@1step"] <= 1.0 and a["rmse@1step"] > 0 and a["rmse@1step_std"] == 0.0


# --- the CLIs on tests/data/nyu -------------------------------------------------------------

SETS = ["data.dataset=nyu", f"data.data_root={os.path.join(DATA, 'nyu')}",
        "model.decoder_layers=2"]
LINE = re.compile(r"^a1 [\d.]+ \| a2 [\d.]+ \| a3 [\d.]+ \| abs_rel [\d.]+ \| sq_rel [\d.]+ \| "
                  r"rmse [\d.]+ \| rmse_log [\d.]+ \| log10 [\d.]+ \| silog [\d.]+  \(n=2\)$",
                  re.M)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """4 iterations of converge_depth (2 decoder layers) on the tiny NYU
    files, 32 x 48 crops, 2 per dispatch."""
    workdir = str(tmp_path_factory.mktemp("depth_nyu"))
    assert train_cli.main(["converge_depth", "--workdir", workdir, "--device", "cpu", "--set",
                           *SETS, "data.crop_size=(32,48)", "data.batch_size=2",
                           "runtime.total_iters=4", "runtime.steps_per_dispatch=2",
                           "runtime.log_interval=2", "runtime.ckpt_interval=4",
                           "runtime.tensorboard=false", "optim.total_steps=4"]) == 0
    return workdir


def test_train_cli_on_nyu(trained):
    with open(os.path.join(trained, "train_log.jsonl")) as f:
        logs = [json.loads(line) for line in f]
    assert [r["step"] for r in logs] == [1, 2, 4]
    assert all(0 < r["loss"] < float("inf") and r["loss"] == r["decode.loss_depth"]
               for r in logs)
    assert os.listdir(os.path.join(trained, "ckpts")) == ["step_4.pt"]


@pytest.mark.parametrize("uncertainty", [False, True])
def test_test_cli_on_nyu(trained, uncertainty, capsys):
    extra = ["--uncertainty"] if uncertainty else []
    assert test_cli.main(["converge_depth", "--workdir", trained, "--device", "cpu", *extra,
                          "--set", *SETS, "model.diffusion.randsteps=2"]) == 0
    out = capsys.readouterr().out
    assert f"restored step 4 from {trained}" in out
    assert len(LINE.findall(out)) == 1, out
    assert ("mean hypothesis std" in out and "mean 80% interval width" in out) == uncertainty
    with pytest.raises(SystemExit, match="whole images"):
        test_cli.main(["converge_depth", "--workdir", trained, "--device", "cpu",
                       "--set", *SETS, "runtime.test_mode=slide"])


def test_train_cli_nyu_swin_t_reaches_the_depth_loader(monkeypatch, tmp_path):
    """``python -m ddp_tpu_torch.tools.train nyu_swin_t`` builds its batches
    through make_train_iter's depth branch (train() itself is replaced, so
    that no Swin-T step runs here): the first batch is the JAX package's."""
    import ddp_tpu_torch.train.loop as loop

    seen = {}

    def fake_train(cfg, data_iter, resume=False, device=None):
        seen["cfg"], seen["batch"] = cfg, next(data_iter)

    monkeypatch.setattr(loop, "train", fake_train)
    sets = [f"data.data_root={os.path.join(DATA, 'nyu')}", "data.crop_size=(32,48)",
            "data.batch_size=2"]
    assert train_cli.main(["nyu_swin_t", "--workdir", str(tmp_path), "--device", "cpu",
                           "--set", *sets]) == 0
    assert seen["cfg"].model.task == "depth" and seen["cfg"].data.dataset == "nyu"
    want = next(jmake_train_iter(jconfig.get_config("nyu_swin_t", dict(
        s.split("=", 1) for s in sets))))
    _same_sample(seen["batch"], want)
