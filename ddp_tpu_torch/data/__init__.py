"""Data layer: datasets, pipelines, batch iterators.

``make_train_iter(cfg)`` builds the train batch iterator of a config, as
``ddp_tpu/data/__init__.py`` does (all its branches: ``task="controlnet"``,
``"bev_fusion"``, ``"bev"``, ``"depth"`` and ``"seg"``).
"""
from __future__ import annotations


def make_train_iter(cfg, rank=None, world=None):
    """The infinite train batch iterator for a Config. Segmentation: the
    procedural ``SyntheticSegDataset`` (``data.dataset="synthetic"``) or an
    ADE20K or Cityscapes tree under ``data.data_root`` (``SegDataset``),
    through ``seg_batch_iterator`` and the seg train pipeline. Depth: the
    procedural ``SyntheticDepthDataset`` or a nyu, kitti, sunrgbd or
    cityscapes split file under ``data.data_root`` (``DepthDataset``),
    through ``depth_batch_iterator``. BEV camera: the procedural 512-scene
    ``SyntheticBEVDataset`` rig or a preprocessed nuScenes tree
    (``NuScenesBEVDataset``, ``data.crop_size`` images) through
    ``bev_batch_iterator`` with the 3D aug (as JAX's always augments). BEV
    fusion: the 512-scene ``SyntheticFusionDataset`` or ``NuScenesFusionDataset``
    at the model's voxel grid and capacities, through
    ``fusion_batch_iterator``. ControlNet: ``SyntheticFill50k`` (20,000 pairs)
    or a fill50k tree (``Fill50kDataset``) at ``model.cn_image_size``, through
    ``controlnet_batch_iterator``. A tree whose train split holds nothing raises
    FileNotFoundError. Under ``torch.distributed`` each process gets its
    rank's slice of every global batch (a given ``world`` overrides the
    process group's, rank 0 by default: ``world=1`` gives whole global
    batches)."""
    from ..parallel.mesh import world as group_world

    if world is None:
        g_rank, world = group_world()
        rank = g_rank if rank is None else rank
    elif rank is None:
        rank = 0
    d = cfg.data
    m = cfg.model
    if m.task == "controlnet":
        from .controlnet_data import (Fill50kDataset, SyntheticFill50k,
                                      controlnet_batch_iterator)

        if d.dataset == "synthetic":
            # a wide index pool: the generator must interpolate circle position
            # and size rather than memorise pairs
            ds = SyntheticFill50k(size=m.cn_image_size, length=20_000)
        else:
            ds = Fill50kDataset(d.data_root, size=m.cn_image_size)
            if len(ds) == 0:
                raise FileNotFoundError(f"no fill50k prompt.json under {d.data_root}")
        return controlnet_batch_iterator(ds, d.batch_size, seed=cfg.runtime.seed, rank=rank,
                                         world=world)
    if m.task == "bev_fusion":
        from .bev_datasets import (NuScenesFusionDataset, SyntheticFusionDataset,
                                   fusion_batch_iterator)

        lidar = dict(sparse_shape=m.bev_sparse_shape, caps=m.bev_voxel_caps,
                     voxel_size=m.bev_voxel_size)
        if d.dataset == "synthetic":
            ds = SyntheticFusionDataset(num_cams=m.bev_num_cams, image_size=m.bev_image_size,
                                        out_grid=m.bev_out_grid, num_classes=m.num_classes,
                                        scope=m.bev_xbound[1], length=512, **lidar)
        else:
            ds = NuScenesFusionDataset(d.data_root, "train", image_size=d.crop_size,
                                       out_grid=m.bev_out_grid, scope=m.bev_xbound[1], **lidar)
            if len(ds) == 0:
                raise FileNotFoundError(f"no nuScenes infos under {d.data_root}")
        return fusion_batch_iterator(ds, d.batch_size, seed=cfg.runtime.seed, mean=d.mean,
                                     std=d.std, rank=rank, world=world)
    if m.task == "bev":
        from .bev_datasets import NuScenesBEVDataset, SyntheticBEVDataset, bev_batch_iterator

        if d.dataset == "synthetic":
            # 512 train scenes; the end check scores held-out indices
            ds = SyntheticBEVDataset(num_cams=m.bev_num_cams, image_size=m.bev_image_size,
                                     out_grid=m.bev_out_grid, num_classes=m.num_classes,
                                     scope=m.bev_xbound[1], length=512)
        else:
            ds = NuScenesBEVDataset(d.data_root, "train", image_size=d.crop_size,
                                    out_grid=m.bev_out_grid)
            if len(ds) == 0:
                raise FileNotFoundError(f"no nuScenes infos under {d.data_root}")
        return bev_batch_iterator(ds, d.batch_size, seed=cfg.runtime.seed, mean=d.mean,
                                  std=d.std, rank=rank, world=world)
    if m.task == "depth":
        from .depth_datasets import DepthDataset, SyntheticDepthDataset, depth_batch_iterator

        if d.dataset == "synthetic":
            ds = SyntheticDepthDataset(size=d.crop_size, max_depth=cfg.model.max_depth)
        else:
            ds = DepthDataset(d.data_root, "train", d.dataset)
            if len(ds) == 0:
                raise FileNotFoundError(f"no data for {d.dataset} under {d.data_root}")
        return depth_batch_iterator(ds, d.batch_size, d.crop_size, seed=cfg.runtime.seed,
                                    mean=d.mean, std=d.std, rank=rank, world=world)
    if cfg.model.task != "seg":
        raise NotImplementedError(f"task {cfg.model.task!r} has no data loader in the port yet")
    from .seg_datasets import SegDataset, SyntheticSegDataset, seg_batch_iterator

    if d.dataset == "synthetic":
        ds = SyntheticSegDataset(num_classes=cfg.model.num_classes, size=d.crop_size)
    else:
        ds = SegDataset(d.data_root, "train", d.dataset)
        if len(ds) == 0:
            raise FileNotFoundError(f"no data found for {d.dataset} under {d.data_root}")
    return seg_batch_iterator(
        ds, d.batch_size, d.crop_size, seed=cfg.runtime.seed, mean=d.mean, std=d.std,
        ratio_range=d.ratio_range, cat_max_ratio=d.cat_max_ratio, flip_prob=d.flip_prob,
        rank=rank, world=world)
