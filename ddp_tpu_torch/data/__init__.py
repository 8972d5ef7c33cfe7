"""Data layer: datasets, pipelines, batch iterators.

``make_train_iter(cfg)`` builds the train batch iterator of a config, as
``ddp_tpu/data/__init__.py`` does (its ``task="seg"`` branch, :115-130).
"""
from __future__ import annotations


def make_train_iter(cfg):
    """The infinite train batch iterator for a Config: segmentation on the
    procedural ``SyntheticSegDataset`` (``data.dataset="synthetic"``) or on an
    ADE20K or Cityscapes tree under ``data.data_root`` (``SegDataset``, its
    train split; FileNotFoundError when it holds nothing), through
    ``seg_batch_iterator`` and the seg train pipeline. Under
    ``torch.distributed`` each process gets its rank's slice of every global
    batch."""
    import torch.distributed as dist

    from .seg_datasets import SegDataset, SyntheticSegDataset, seg_batch_iterator

    if cfg.model.task != "seg":
        raise NotImplementedError(f"task {cfg.model.task!r} has no data loader in the port yet")
    rank, world = ((dist.get_rank(), dist.get_world_size()) if dist.is_initialized()
                   else (0, 1))
    if cfg.data.dataset == "synthetic":
        ds = SyntheticSegDataset(num_classes=cfg.model.num_classes, size=cfg.data.crop_size)
    else:
        ds = SegDataset(cfg.data.data_root, "train", cfg.data.dataset)
        if len(ds) == 0:
            raise FileNotFoundError(
                f"no data found for {cfg.data.dataset} under {cfg.data.data_root}")
    return seg_batch_iterator(
        ds, cfg.data.batch_size, cfg.data.crop_size, seed=cfg.runtime.seed,
        mean=cfg.data.mean, std=cfg.data.std, ratio_range=cfg.data.ratio_range,
        cat_max_ratio=cfg.data.cat_max_ratio, flip_prob=cfg.data.flip_prob,
        rank=rank, world=world)
