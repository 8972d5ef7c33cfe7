"""The port's seg train data pipeline against the JAX package's, on the CPU.

  - ``pil_resize_bilinear`` / ``pil_resize_nearest`` (numpy) against Pillow
    itself, exactly, up and down over ratios 0.5-2.0 and odd sizes;
  - every transform and ``seg_train_pipeline`` against
    ``ddp_tpu.data.pipelines``, bitwise, on the same ``np.random.Generator``;
  - ``seg_batch_iterator`` and ``make_train_iter`` against the JAX
    package's, bitwise, batch by batch (``converge_seg_window``'s crop and
    batch, an epoch boundary, rank slicing).
"""
import dataclasses

import numpy as np
import pytest
from PIL import Image

from ddp_tpu.data import make_train_iter as j_make_train_iter
from ddp_tpu.data import pipelines as jp
from ddp_tpu.data import seg_datasets as jsd
from ddp_tpu.config import get_config as j_get_config
from ddp_tpu_torch.config import get_config
from ddp_tpu_torch.data import make_train_iter
from ddp_tpu_torch.data import pipelines as tp
from ddp_tpu_torch.data import seg_datasets as tsd


def _sizes(seed, n):
    """(in_h, in_w, out_w, out_h) with out/in ratios in [0.5, 2.0], both ways."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        h, w = rng.integers(3, 97, 2)
        rh, rw = rng.uniform(0.5, 2.0, 2)
        yield int(h), int(w), max(1, int(w * rw)), max(1, int(h * rh))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bilinear_resample_equals_pillow(seed):
    rng = np.random.default_rng(100 + seed)
    for h, w, ow, oh in _sizes(seed, 40):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        want = np.asarray(Image.fromarray(img).resize((ow, oh), Image.BILINEAR))
        got = tp.pil_resize_bilinear(img, (ow, oh))
        assert got.dtype == want.dtype and np.array_equal(got, want), (h, w, ow, oh)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nearest_resample_equals_pillow(seed):
    rng = np.random.default_rng(200 + seed)
    for h, w, ow, oh in _sizes(seed, 40):
        lab = rng.integers(-3, 300, (h, w)).astype(np.int32)
        want = np.asarray(Image.fromarray(lab, mode="I").resize((ow, oh), Image.NEAREST))
        got = tp.pil_resize_nearest(lab, (ow, oh))
        assert got.dtype == want.dtype and np.array_equal(got, want), (h, w, ow, oh)


def _same(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert np.array_equal(a[k], b[k]), k


def _sample(seed, hw=(64, 64), k=7):
    s = jsd.SyntheticSegDataset(k, hw).load(seed)
    s["label"][:3, :5] = 255
    return s


@pytest.mark.parametrize("name,hw,args", [
    ("random_resize", (64, 64), ((512, 64), (0.5, 2.0))),
    # a ragged ratio on a non-square image
    ("random_resize", (50, 37), ((2048, 37), (0.73, 1.61))),
    ("random_crop", (64, 64), ((48, 40), 0.75)),
    ("random_flip", (64, 64), (0.5,)),
    ("photo_metric_distortion", (64, 64), ()),
])
def test_transforms_bitwise(name, hw, args):
    for seed in range(6):
        sample = _sample(seed, hw)
        want = getattr(jp, name)(sample, np.random.default_rng(seed), *args)
        got = getattr(tp, name)(sample, np.random.default_rng(seed), *args)
        _same(got, want)


def test_normalize_and_pad_bitwise():
    s = _sample(3, (40, 50))
    _same(tp.normalize(s, (1.0, 2.0, 3.0), (4.0, 5.0, 6.0)),
          jp.normalize(s, (1.0, 2.0, 3.0), (4.0, 5.0, 6.0)))
    _same(tp.pad_to(s, (64, 64)), jp.pad_to(s, (64, 64)))


@pytest.mark.parametrize("ratio_range", [(0.5, 2.0), (0.61, 0.61), (1.37, 1.37)])
def test_seg_train_pipeline_bitwise(ratio_range):
    for seed in range(8):
        sample = _sample(seed)
        kw = dict(crop=(64, 64), img_scale=(2048, 64), ratio_range=ratio_range)
        _same(tp.seg_train_pipeline(sample, np.random.default_rng((0, 0, seed)), **kw),
              jp.seg_train_pipeline(sample, np.random.default_rng((0, 0, seed)), **kw))


@pytest.mark.parametrize("rank,world", [(0, 1), (1, 2)])
def test_seg_batch_iterator_bitwise(rank, world):
    """Batch 4 over a dataset of 10: the third batch crosses into epoch 1."""
    kw = dict(batch_size=4, crop=(64, 64), seed=3, rank=rank, world=world)
    it_t = tsd.seg_batch_iterator(tsd.SyntheticSegDataset(7, (64, 64), length=10), **kw)
    it_j = jsd.seg_batch_iterator(jsd.SyntheticSegDataset(7, (64, 64), length=10), **kw)
    for _ in range(4):
        _same(next(it_t), next(it_j))


def test_make_train_iter_converge_seg_window_bitwise():
    """converge_seg_window's batch (16 synthetic 64x64 crops) from both
    packages' make_train_iter: the first two batches agree bit for bit."""
    cfg, jcfg = get_config("converge_seg_window"), j_get_config("converge_seg_window")
    assert (cfg.data.batch_size, cfg.data.crop_size, cfg.data.ratio_range, cfg.data.cat_max_ratio,
            cfg.data.flip_prob) == (jcfg.data.batch_size, jcfg.data.crop_size,
                                    jcfg.data.ratio_range, jcfg.data.cat_max_ratio,
                                    jcfg.data.flip_prob)
    it_t, it_j = make_train_iter(cfg), j_make_train_iter(jcfg)
    for _ in range(2):
        b = next(it_t)
        assert b["image"].shape == (16, 64, 64, 3) and b["label"].shape == (16, 64, 64)
        _same(b, next(it_j))


def test_make_train_iter_refuses_real_datasets(tmp_path):
    """Real-format datasets are read since the seg data slice: one whose root
    holds no files is refused by name (FileNotFoundError, as in JAX), and a
    dataset the loader does not know by ValueError."""
    cfg = get_config("converge_seg_window")

    def with_data(**kw):
        return dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, **kw))

    with pytest.raises(FileNotFoundError, match="no data found for ade20k"):
        make_train_iter(with_data(dataset="ade20k", data_root=str(tmp_path)))
    with pytest.raises(ValueError, match="unknown dataset 'voc'"):
        make_train_iter(with_data(dataset="voc", data_root=str(tmp_path)))
