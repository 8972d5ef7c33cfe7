"""The port's data tools against the JAX package's, on the CPU.

  - ``tools/prepare_nuscenes``: on a copy of ``tests/data/nuscenes_raw`` each
    package's tool writes its infos pickles and map masks; the pickled dicts
    are equal key by key (arrays bitwise), the masks bitwise, and the port's
    ``NuScenesBEVDataset`` and ``NuScenesFusionDataset`` read the port's.
  - ``tools/convert_datasets``: ``cityscapes`` on a copy of
    ``tests/data/cityscapes`` (the PNG files byte for byte), ``voc-aug`` on a
    tiny VOC tree with an SBD ``cls/*.mat`` written by scipy (masks and the
    ``train_aug`` list), ``ade20k``'s layout check.
  - ``tools/browse_dataset``: the PNGs it writes for ``smoke`` (a seg preset)
    and ``smoke_bev`` decode to the JAX tool's arrays, bitwise.
  - ``seg_batch_iterator``'s ``img_scale``, ``train=False`` and ``prefetch``:
    JAX's batches bitwise.

The JAX tools run in this process through ``runpy``, as ``python
tools/<name>.py``.
"""
import contextlib
import io
import os
import pickle
import runpy
import shutil
import sys

import numpy as np
import pytest
from PIL import Image

from ddp_tpu.data import seg_datasets as jsd
from ddp_tpu_torch.data import bev_datasets as tbd
from ddp_tpu_torch.data import seg_datasets as tsd
from ddp_tpu_torch.tools import browse_dataset, convert_datasets, prepare_nuscenes

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
DATA = os.path.join(ROOT, "tests", "data")


def _jax_tool(name, argv):
    out, old = io.StringIO(), sys.argv
    sys.argv = [name] + list(argv)
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_path(os.path.join(ROOT, "tools", f"{name}.py"), run_name="__main__")
    finally:
        sys.argv = old
    return out.getvalue()


def _port_tool(module, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert module.main(list(argv)) == 0
    return out.getvalue()


def _copies(tmp_path, src):
    """Two copies of ``src``: one for each package's tool."""
    dirs = []
    for side in ("jax", "port"):
        d = str(tmp_path / side)
        shutil.copytree(src, d)
        dirs.append(d)
    return dirs


def _same(a, b, where=""):
    """Pickled values equal: dicts key by key, lists item by item, arrays
    bitwise with their dtype."""
    assert type(a) is type(b), where
    if isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            _same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, where


def test_prepare_nuscenes_matches_jax(tmp_path):
    jroot, troot = _copies(tmp_path, os.path.join(DATA, "nuscenes_raw"))
    argv = ["--version", "v1.0-mini", "--max-sweeps", "2", "--grid", "40", "--patch", "16.0"]
    j_out = _jax_tool("prepare_nuscenes", ["--data-root", jroot] + argv)
    t_out = _port_tool(prepare_nuscenes, ["--data-root", troot] + argv)
    assert t_out.replace(troot, "R") == j_out.replace(jroot, "R")
    for split in ("train", "val"):
        with open(os.path.join(jroot, f"nuscenes_infos_{split}.pkl"), "rb") as f:
            want = pickle.load(f)
        with open(os.path.join(troot, f"nuscenes_infos_{split}.pkl"), "rb") as f:
            got = pickle.load(f)
        _same(got, want, split)
    assert len(got["infos"]) == 0 and len(want["infos"]) == 0  # one scene: all in train
    masks = sorted(os.listdir(os.path.join(jroot, "maps_bev")))
    assert masks and masks == sorted(os.listdir(os.path.join(troot, "maps_bev")))
    for name in masks:
        a = np.load(os.path.join(jroot, "maps_bev", name))["masks"]
        b = np.load(os.path.join(troot, "maps_bev", name))["masks"]
        assert a.dtype == b.dtype == np.uint8 and a.any()
        np.testing.assert_array_equal(b, a)
    ds = tbd.NuScenesBEVDataset(troot, "train", image_size=(32, 88), out_grid=40)
    fusion = tbd.NuScenesFusionDataset(troot, "train", image_size=(32, 88), out_grid=40,
                                       sparse_shape=(80, 80, 41), caps=(4000, 2000, 1000, 500,
                                                                        500),
                                       voxel_size=(0.2, 0.2, 0.2))
    assert len(ds) == len(fusion) == 2
    s, f = ds.load(0), fusion.load(1)
    assert s["image"].shape == (6, 32, 88, 3) and s["label"].shape[:2] == (40, 40)
    assert s["label"].any() and f["voxel_feats"].any()


def test_convert_cityscapes_matches_jax_byte_for_byte(tmp_path):
    jroot, troot = _copies(tmp_path, os.path.join(DATA, "cityscapes"))
    assert "wrote 4" in _jax_tool("convert_datasets", ["cityscapes", jroot])
    assert "wrote 4" in _port_tool(convert_datasets, ["cityscapes", troot])
    n = 0
    for dirpath, _, files in os.walk(os.path.join(jroot, "gtFine")):
        for name in files:
            if name.endswith("_labelTrainIds.png"):
                other = os.path.join(troot, os.path.relpath(os.path.join(dirpath, name), jroot))
                with open(os.path.join(dirpath, name), "rb") as a, open(other, "rb") as b:
                    assert a.read() == b.read(), name
                n += 1
    assert n == 4


def _voc_tree(root):
    """VOC2012 with one mask and a train list; SBD with two ``.mat`` masks
    (one VOC has, which VOC's wins) and its own train list."""
    from scipy.io import savemat

    rng = np.random.RandomState(0)
    voc = os.path.join(root, "VOC2012")
    os.makedirs(os.path.join(voc, "SegmentationClass"))
    os.makedirs(os.path.join(voc, "ImageSets", "Segmentation"))
    Image.fromarray(rng.randint(0, 21, (6, 8)).astype(np.uint8)).save(
        os.path.join(voc, "SegmentationClass", "a.png"))
    with open(os.path.join(voc, "ImageSets", "Segmentation", "train.txt"), "w") as f:
        f.write("a\nmissing\n")
    cls = os.path.join(root, "benchmark_RELEASE", "dataset", "cls")
    os.makedirs(cls)
    for name in ("a", "b"):
        seg = rng.randint(0, 21, (5, 7)).astype(np.uint8)
        savemat(os.path.join(cls, f"{name}.mat"),
                {"GTcls": {"Segmentation": seg, "Boundaries": np.zeros(1)}})
    with open(os.path.join(root, "benchmark_RELEASE", "dataset", "train.txt"), "w") as f:
        f.write("b\n")


def test_convert_voc_aug_and_ade20k_match_jax(tmp_path):
    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "port")
    _voc_tree(jroot)
    _voc_tree(troot)
    j_out = _jax_tool("convert_datasets", ["voc-aug", jroot])
    t_out = _port_tool(convert_datasets, ["voc-aug", troot])
    assert t_out.replace(troot, "R") == j_out.replace(jroot, "R")
    aug = os.path.join("VOC2012", "SegmentationClassAug")
    names = sorted(os.listdir(os.path.join(jroot, aug)))
    assert names == ["a.png", "b.png"] == sorted(os.listdir(os.path.join(troot, aug)))
    for name in names:
        a = np.asarray(Image.open(os.path.join(jroot, aug, name)))
        b = np.asarray(Image.open(os.path.join(troot, aug, name)))
        np.testing.assert_array_equal(b, a)
    lst = os.path.join("VOC2012", "ImageSets", "Segmentation", "train_aug.txt")
    with open(os.path.join(jroot, lst)) as f, open(os.path.join(troot, lst)) as g:
        assert f.read() == g.read() == "a\nb\n"
    ade = os.path.join(DATA, "ade")
    assert (_port_tool(convert_datasets, ["ade20k", ade])
            == _jax_tool("convert_datasets", ["ade20k", ade]))


@pytest.mark.parametrize("preset", ["smoke", "smoke_bev"])
def test_browse_dataset_matches_jax(preset, tmp_path):
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    _jax_tool("browse_dataset", ["--preset", preset, "--num", "3", "--out", jout])
    _port_tool(browse_dataset, ["--preset", preset, "--num", "3", "--out", tout])
    names = sorted(os.listdir(jout))
    assert len(names) == 6 and names == sorted(os.listdir(tout))
    for name in names:
        a = np.asarray(Image.open(os.path.join(jout, name)))
        b = np.asarray(Image.open(os.path.join(tout, name)))
        assert a.shape == b.shape and a.dtype == b.dtype == np.uint8, name
        np.testing.assert_array_equal(b, a, err_msg=name)


@pytest.mark.parametrize("kw", [dict(img_scale=(96, 48), prefetch=0),
                                dict(train=False, prefetch=1)], ids=["img_scale", "eval"])
def test_seg_batch_iterator_options_match_jax(kw):
    args = dict(batch_size=3, crop=(40, 48), seed=2, **kw)
    it_t = tsd.seg_batch_iterator(tsd.SyntheticSegDataset(5, (64, 56), length=4), **args)
    it_j = jsd.seg_batch_iterator(jsd.SyntheticSegDataset(5, (64, 56), length=4), **args)
    for _ in range(3):
        got, want = next(it_t), next(it_j)
        for k in ("image", "label"):
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
            np.testing.assert_array_equal(got[k], want[k])
    it_t.close()
    it_j.close()
