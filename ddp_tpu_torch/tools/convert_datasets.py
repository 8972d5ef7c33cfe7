"""Offline dataset converters (port of ``tools/convert_datasets.py``; the
reference's tools/convert_datasets/{cityscapes,voc_aug}.py in one entry
point). They convert local folders into the layout ``data/seg_datasets.py:
SegDataset`` indexes, with no network access.

  cityscapes  gtFine ``*_labelIds.png`` -> ``*_labelTrainIds.png`` through
              the labelId -> trainId map the reader applies on the fly
  voc-aug     SBD ``cls/*.mat`` + VOC ``SegmentationClass`` -> merged
              ``SegmentationClassAug`` PNGs and the ``train_aug`` list (VOC's
              own masks first; SBD fills the images VOC lacks)
  ade20k      a layout check only: ADEChallengeData2016 ships converted

    python -m ddp_tpu_torch.tools.convert_datasets cityscapes data/cityscapes
    python -m ddp_tpu_torch.tools.convert_datasets voc-aug data/VOCdevkit

PNGs are read and written through Pillow, as the JAX tool does (a named
ImportError without it); SBD's ``.mat`` files through scipy (skipped with a
message without it, as the JAX tool does).
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def _pillow():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("convert_datasets reads and writes PNGs through Pillow, "
                          "which is not installed") from e
    return Image


def convert_cityscapes(root: str) -> int:
    """Every ``gtFine/<split>/<city>/*_gtFine_labelIds.png`` gets its
    ``*_labelTrainIds.png`` beside it; returns how many were written."""
    from ..data.seg_datasets import CITYSCAPES_LABEL2TRAIN

    image = _pillow()
    n = 0
    gt_dir = os.path.join(root, "gtFine")
    for split in sorted(os.listdir(gt_dir)):
        sd = os.path.join(gt_dir, split)
        if not os.path.isdir(sd):
            continue
        for city in sorted(os.listdir(sd)):
            cd = os.path.join(sd, city)
            for f in sorted(os.listdir(cd)):
                if not f.endswith("_gtFine_labelIds.png"):
                    continue
                with image.open(os.path.join(cd, f)) as im:
                    lbl = np.asarray(im, np.int32)
                tr = CITYSCAPES_LABEL2TRAIN[np.clip(lbl, 0, 255)]
                out = f.replace("_labelIds.png", "_labelTrainIds.png")
                image.fromarray(tr.astype(np.uint8)).save(os.path.join(cd, out))
                n += 1
    print(f"cityscapes: wrote {n} *_labelTrainIds.png")
    return n


def convert_voc_aug(root: str) -> int:
    """``VOC2012/SegmentationClassAug``: VOC's masks, then SBD's
    ``benchmark_RELEASE/dataset/cls/*.mat`` for the images VOC lacks, and
    ``ImageSets/Segmentation/train_aug.txt``: the ids of VOC's and SBD's
    train lists that have a mask. Returns how many masks were written."""
    image = _pillow()
    voc = os.path.join(root, "VOC2012")
    sbd = os.path.join(root, "benchmark_RELEASE", "dataset")
    out_dir = os.path.join(voc, "SegmentationClassAug")
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    names = set()
    voc_cls = os.path.join(voc, "SegmentationClass")
    if os.path.isdir(voc_cls):
        for f in sorted(os.listdir(voc_cls)):
            if f.endswith(".png"):
                with image.open(os.path.join(voc_cls, f)) as im:
                    lbl = np.asarray(im)
                image.fromarray(lbl.astype(np.uint8)).save(os.path.join(out_dir, f))
                names.add(f[:-4])
                n += 1
    mat_dir = os.path.join(sbd, "cls")
    if os.path.isdir(mat_dir):
        try:
            from scipy.io import loadmat
        except ImportError:
            print("scipy unavailable — skipping SBD .mat masks", file=sys.stderr)
            loadmat = None
        if loadmat is not None:
            for f in sorted(os.listdir(mat_dir)):
                if not f.endswith(".mat") or f[:-4] in names:
                    continue
                seg = loadmat(os.path.join(mat_dir, f))["GTcls"][0]["Segmentation"][0]
                image.fromarray(seg.astype(np.uint8)).save(os.path.join(out_dir, f[:-4] + ".png"))
                names.add(f[:-4])
                n += 1
    lists = []
    for lp in (os.path.join(voc, "ImageSets", "Segmentation", "train.txt"),
               os.path.join(sbd, "train.txt")):
        if os.path.exists(lp):
            with open(lp) as fh:
                lists += [ln.strip() for ln in fh if ln.strip()]
    if lists:
        ids = sorted(set(lists) & names)
        out_list = os.path.join(voc, "ImageSets", "Segmentation", "train_aug.txt")
        with open(out_list, "w") as f:
            f.write("\n".join(ids) + "\n")
        print(f"voc-aug: wrote {len(ids)} ids to {out_list}")
    print(f"voc-aug: wrote {n} masks to {out_dir}")
    return n


def check_ade20k(root: str) -> int:
    """1 if ``images/`` and ``annotations/`` hold ``training`` and
    ``validation``, else 0."""
    ok = all(os.path.isdir(os.path.join(root, "images", s))
             and os.path.isdir(os.path.join(root, "annotations", s))
             for s in ("training", "validation"))
    print("ade20k layout:", "ok" if ok else
          "MISSING images/ or annotations/ (expected ADEChallengeData2016)")
    return int(ok)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="offline dataset converters")
    p.add_argument("dataset", choices=["cityscapes", "voc-aug", "ade20k"])
    p.add_argument("root")
    args = p.parse_args(argv)
    {"cityscapes": convert_cityscapes, "voc-aug": convert_voc_aug,
     "ade20k": check_ade20k}[args.dataset](args.root)
    return 0


if __name__ == "__main__":
    sys.exit(main())
