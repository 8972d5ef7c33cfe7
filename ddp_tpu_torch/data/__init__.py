"""Data layer: datasets, pipelines, batch iterators.

``make_train_iter(cfg)`` builds the train batch iterator of a config, as
``ddp_tpu/data/__init__.py`` does (its ``task="seg"`` branch, :115-130).
"""
from __future__ import annotations


def make_train_iter(cfg):
    """The infinite train batch iterator for a Config: segmentation on the
    procedural ``SyntheticSegDataset`` through ``seg_batch_iterator`` and the
    seg train pipeline. Under ``torch.distributed`` each process gets its
    rank's slice of every global batch."""
    import torch.distributed as dist

    from .seg_datasets import SyntheticSegDataset, seg_batch_iterator

    if cfg.model.task != "seg":
        raise NotImplementedError(f"task {cfg.model.task!r} has no data loader in the port yet")
    if cfg.data.dataset != "synthetic":
        raise NotImplementedError(
            f"dataset {cfg.data.dataset!r}: the real-format segmentation datasets are not "
            "ported yet (ROADMAP.md queue 1, item 5)")
    rank, world = ((dist.get_rank(), dist.get_world_size()) if dist.is_initialized()
                   else (0, 1))
    ds = SyntheticSegDataset(num_classes=cfg.model.num_classes, size=cfg.data.crop_size)
    return seg_batch_iterator(
        ds, cfg.data.batch_size, cfg.data.crop_size, seed=cfg.runtime.seed,
        mean=cfg.data.mean, std=cfg.data.std, ratio_range=cfg.data.ratio_range,
        cat_max_ratio=cfg.data.cat_max_ratio, flip_prob=cfg.data.flip_prob,
        rank=rank, world=world)
