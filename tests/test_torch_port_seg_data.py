"""The port's real-format segmentation data against the JAX package and
Pillow, on the CPU (the tiny files under tests/data; no download).

  - ``read_png`` is bitwise Pillow's ``np.asarray(Image.open(p))`` (and
    ``.convert("RGB")``) on every PNG under tests/data/{ade,cityscapes}, and
    on files written here, one per filter type (None, Sub, Up, Average,
    Paeth) and colour type (L, RGB, LA, RGBA, palette), plus mixed filters
    on 1/2/4-bit palettes and 16-bit grayscale; an interlaced file is
    refused by name; ``read_image`` reads through Pillow, and without
    Pillow reads a PNG through ``read_png`` and refuses a JPEG with an
    ImportError naming the missing decoder.
  - ``SegDataset`` (ADE20K and Cityscapes) and the label maps: bitwise the
    JAX package's; so are the normalised val samples that the test CLI
    scores (``SegDataset`` or ``SyntheticSegDataset``, then ``normalize``
    with the config's mean and std, as ``tools/test.py`` builds them).
  - ``make_train_iter``'s first batches on both tiny datasets: bitwise the
    JAX package's; an empty data root raises FileNotFoundError.
  - The default train scale for a Cityscapes crop (a suspected reference
    fault, ROADMAP.md queue 3).
"""
import dataclasses
import glob
import inspect
import os
import struct
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from ddp_tpu import config as jconfig
from ddp_tpu.data import make_train_iter as jmake_train_iter
from ddp_tpu.data import seg_datasets as jsd
from ddp_tpu_torch import config as tconfig
from ddp_tpu_torch.data import make_train_iter
from ddp_tpu_torch.data import seg_datasets as tsd
from ddp_tpu_torch.data.image_io import read_image, read_png

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def _pngs():
    return sorted(glob.glob(os.path.join(DATA, "ade", "**", "*.png"), recursive=True)
                  + glob.glob(os.path.join(DATA, "cityscapes", "**", "*.png"), recursive=True))


def test_read_png_matches_pillow_on_the_test_data():
    paths = _pngs()
    assert len(paths) == 12
    for p in paths:
        with Image.open(p) as im:
            want, want_rgb = np.asarray(im), np.asarray(im.convert("RGB"))
        got = read_png(p)
        assert got.dtype == want.dtype and np.array_equal(got, want), p
        assert np.array_equal(read_png(p, rgb=True), want_rgb), p
        assert np.array_equal(read_image(p), want), p


# --- PNG files written here ----------------------------------------------------

def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _write_png(path, rows: np.ndarray, width: int, depth: int, colour: int, bpp: int,
               kinds, palette=None, interlace: int = 0):
    """A PNG of the image bytes ``rows`` [H, row bytes], row r filtered with
    ``kinds[r % len(kinds)]`` (the PNG specification's five filters), its
    data split over two IDAT chunks."""
    prev = np.zeros(rows.shape[1], np.int32)
    out = []
    for r in range(rows.shape[0]):
        cur = rows[r].astype(np.int32)
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        k = kinds[r % len(kinds)]
        pred = (0, left, prev, (left + prev) >> 1, _paeth(left, prev, ul))[k]
        out.append(bytes([k]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes())
        prev = cur
    data = zlib.compress(b"".join(out))
    body = _chunk(b"IHDR", struct.pack(">IIBBBBB", width, rows.shape[0], depth, colour, 0, 0,
                                       interlace))
    if palette is not None:
        body += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    body += _chunk(b"IDAT", data[:len(data) // 2]) + _chunk(b"IDAT", data[len(data) // 2:])
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + body + _chunk(b"IEND", b""))


def _same_as_pillow(path):
    with Image.open(path) as im:
        want, want_rgb = np.asarray(im), np.asarray(im.convert("RGB"))
    got = read_png(str(path))
    assert got.dtype == want.dtype and np.array_equal(got, want)
    if want.dtype == np.uint8:
        assert np.array_equal(read_png(str(path), rgb=True), want_rgb)


@pytest.mark.parametrize("colour,channels", [(0, 1), (2, 3), (4, 2), (6, 4), (3, 1)],
                         ids=["L", "RGB", "LA", "RGBA", "P"])
@pytest.mark.parametrize("kind", range(5), ids=["none", "sub", "up", "average", "paeth"])
def test_read_png_each_filter_and_colour_type(tmp_path, colour, channels, kind):
    rng = np.random.RandomState(10 * colour + kind)
    if colour == 3:
        img = rng.randint(0, 20, (13, 17)).astype(np.uint8)
        palette = rng.randint(0, 256, (20, 3))
    else:
        img = rng.randint(0, 256, (13, 17 * channels)).astype(np.uint8)
        palette = None
    path = tmp_path / "f.png"
    _write_png(path, img, 17, 8, colour, channels, [kind], palette)
    _same_as_pillow(path)


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_read_png_low_bit_palette(tmp_path, depth):
    rng = np.random.RandomState(depth)
    w, per = 19, 8 // depth
    idx = np.zeros((11, -(-w // per) * per), np.uint8)
    idx[:, :w] = rng.randint(0, 2 ** depth, (11, w))
    packed = np.zeros((11, idx.shape[1] // per), np.uint8)
    for j in range(per):
        packed |= idx[:, j::per] << (8 - depth * (j + 1))
    path = tmp_path / "p.png"
    _write_png(path, packed, w, depth, 3, 1, [0, 1, 2, 3, 4],
               rng.randint(0, 256, (2 ** depth, 3)))
    _same_as_pillow(path)


def test_read_png_16_bit_gray_and_refusals(tmp_path):
    g16 = np.random.RandomState(3).randint(0, 65536, (9, 10)).astype(">u2")
    path = tmp_path / "g16.png"
    _write_png(path, g16.view(np.uint8).reshape(9, 20), 10, 16, 0, 2, [4, 3, 2, 1, 0])
    _same_as_pillow(path)
    _write_png(tmp_path / "i.png", np.zeros((4, 12), np.uint8), 4, 8, 2, 3, [0], interlace=1)
    with pytest.raises(NotImplementedError, match="interlaced"):
        read_png(str(tmp_path / "i.png"))
    _write_png(tmp_path / "rgb16.png", np.zeros((4, 24), np.uint8), 4, 16, 2, 6, [0])
    with pytest.raises(NotImplementedError, match="16-bit RGB"):
        read_png(str(tmp_path / "rgb16.png"))
    data = bytearray(open(path, "rb").read())
    data[20] ^= 1  # inside IHDR: its CRC no longer holds
    (tmp_path / "bad.png").write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        read_png(str(tmp_path / "bad.png"))


def test_read_image_jpeg_with_and_without_pillow(monkeypatch):
    jpg = os.path.join(DATA, "ade", "images", "training", "ADE_train_0.jpg")
    with Image.open(jpg) as im:
        want = np.asarray(im.convert("RGB"))
    with Image.open(_pngs()[0]) as im:
        want_png = np.asarray(im)
    want_city = jsd.SegDataset(os.path.join(DATA, "cityscapes"), "train", "cityscapes").load(1)
    assert np.array_equal(read_image(jpg, rgb=True), want)
    for name in [k for k in sys.modules if k.split(".")[0] == "PIL"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "PIL", None)  # import PIL raises ImportError
    with pytest.raises(ImportError, match="no JPEG decoder.*ROADMAP.md queue 1"):
        read_image(jpg)
    with pytest.raises(ImportError, match="no JPEG decoder"):
        tsd.SegDataset(os.path.join(DATA, "ade"), "train", "ade20k").load(0)
    # without Pillow a PNG goes through read_png: the same pixels, the same
    # Cityscapes sample as the JAX package's (read with Pillow)
    png = _pngs()[0]
    assert np.array_equal(read_image(png), want_png)
    city = os.path.join(DATA, "cityscapes")
    _same_sample(tsd.SegDataset(city, "train", "cityscapes").load(1), want_city)


# --- datasets ------------------------------------------------------------------

def _same_sample(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("dataset,root", [("ade20k", "ade"), ("cityscapes", "cityscapes")])
@pytest.mark.parametrize("split", ["train", "val"])
def test_seg_dataset_matches_jax(dataset, root, split):
    t = tsd.SegDataset(os.path.join(DATA, root), split, dataset)
    j = jsd.SegDataset(os.path.join(DATA, root), split, dataset)
    assert t.items == j.items and len(t) == 2
    for i in range(len(t)):
        _same_sample(t.load(i), j.load(i))
    labels = np.unique(np.concatenate([t.load(i)["label"].ravel() for i in range(len(t))]))
    top = 150 if dataset == "ade20k" else 19
    assert labels.min() >= 0 and (labels[labels != 255] < top).all()
    with pytest.raises(ValueError, match="unknown dataset"):
        tsd.SegDataset(DATA, split, "voc")


@pytest.mark.parametrize("dataset,root", [("cityscapes", "cityscapes"), ("ade20k", "ade"),
                                          ("synthetic", "")])
def test_eval_samples_match_jax(dataset, root):
    """The samples that ``tools/test.py`` scores in both packages: the val
    split (the procedural set for "synthetic"), normalised with the preset's
    mean and std."""
    from ddp_tpu.data.pipelines import normalize as jnormalize
    from ddp_tpu_torch.data.pipelines import normalize

    over = {"data.dataset": dataset, "data.data_root": os.path.join(DATA, root)}
    t_cfg, j_cfg = tconfig.get_config("smoke", over), jconfig.get_config("smoke", over)
    if dataset == "synthetic":
        t_ds = tsd.SyntheticSegDataset(t_cfg.model.num_classes, t_cfg.data.crop_size)
        j_ds = jsd.SyntheticSegDataset(j_cfg.model.num_classes, j_cfg.data.crop_size)
    else:
        t_ds = tsd.SegDataset(t_cfg.data.data_root, "val", dataset)
        j_ds = jsd.SegDataset(j_cfg.data.data_root, "val", dataset)
    assert np.array_equal(tsd.CITYSCAPES_LABEL2TRAIN, jsd.CITYSCAPES_LABEL2TRAIN)
    for i in range(2):
        _same_sample(normalize(t_ds.load(i), t_cfg.data.mean, t_cfg.data.std),
                     jnormalize(j_ds.load(i), j_cfg.data.mean, j_cfg.data.std))


def _real_cfgs(dataset, root, k):
    over = {"data.dataset": dataset, "data.data_root": os.path.join(DATA, root),
            "data.batch_size": "3", "data.crop_size": "(32,40)", "model.num_classes": str(k),
            "runtime.seed": "5"}
    return tconfig.get_config("smoke", over), jconfig.get_config("smoke", over)


@pytest.mark.parametrize("dataset,root,k", [("cityscapes", "cityscapes", 19),
                                            ("ade20k", "ade", 150)])
def test_make_train_iter_matches_jax(dataset, root, k):
    """The first three batches (an epoch of 2 files crosses into the next
    permutation) through the seg train pipeline, bitwise."""
    t_cfg, j_cfg = _real_cfgs(dataset, root, k)
    t_it, j_it = make_train_iter(t_cfg), jmake_train_iter(j_cfg)
    for _ in range(3):
        a, b = next(t_it), next(j_it)
        assert a["image"].shape == (3, 32, 40, 3)
        _same_sample(a, b)


def test_make_train_iter_empty_root_raises(tmp_path):
    t_cfg, _ = _real_cfgs("cityscapes", "cityscapes", 19)
    t_cfg = dataclasses.replace(t_cfg, data=dataclasses.replace(t_cfg.data,
                                                                data_root=str(tmp_path)))
    with pytest.raises(FileNotFoundError, match="no data found for cityscapes"):
        make_train_iter(t_cfg)


def test_cityscapes_train_scale_reference_discrepancy(monkeypatch):
    """Suspected reference fault (ROADMAP.md queue 3): ``seg_batch_iterator``
    resizes with img_scale (2048, crop[0]) unless given one, which is mmseg's
    ADE20K scale (2048, 512) for a 512^2 crop, but for Cityscapes' 512x1024
    crop it gives (2048, 512) where mmseg's Cityscapes pipeline has (2048,
    1024): a 1024x2048 image at ratio 1 comes out 512x1024, half the
    reference's size. ``make_train_iter`` takes the default in both
    packages; the port copies it."""
    # keyed by crop: the prefetch threads of earlier tests' iterators may
    # still be building their batches through the patched pipeline
    seen = []

    def record(sample, rng, crop, img_scale, *rest):
        seen.append((crop, img_scale))
        return {"image": np.zeros(crop + (3,), np.float32),
                "label": np.zeros(crop, np.int32)}

    monkeypatch.setattr(tsd, "seg_train_pipeline", record)
    cfg, _ = _real_cfgs("cityscapes", "cityscapes", 19)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, crop_size=(512, 1024)))
    next(make_train_iter(cfg))
    assert {s for c, s in seen if c == (512, 1024)} == {(2048, 512)}
    # the JAX package's default is the same expression
    assert "img_scale or (2048, crop[0])" in inspect.getsource(jsd.seg_batch_iterator)
