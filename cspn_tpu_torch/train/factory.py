"""Config -> datasets and loaders (counterpart of cspn_tpu/train/factory.py;
reference L5 dispatch, train.py:64-113)."""

from __future__ import annotations

from cspn_tpu_torch.config import RunConfig
from cspn_tpu_torch.data import DataLoader, KittiDataset, NyuDepthDataset, SyntheticDepthDataset

_SYNTH_HW = (64, 96)


def build_dataset(cfg: RunConfig, split: str, seed=None, return_raw_rgb=False):
    """The configured dataset's `split` ('train'; anything else is the val
    split).  The NYU and KITTI file datasets read `train_list` or
    `eval_list` under `root_dir` in `input_format`, seeded by `seed` or
    cfg.data.seed; `box_crop` None is the dataset's default box and () none.
    The synthetic dataset is the JAX package's at 64x96, or at
    `cfg.data.crop_hw` when set (e.g. (228, 304), the NYU frame)."""
    d = cfg.data
    # geometry overrides: box_crop None = dataset default, () = disabled
    geom = dict(crop_hw=d.crop_hw, input_format=d.input_format)
    if d.box_crop is not None:
        geom["box_crop"] = tuple(d.box_crop) if len(d.box_crop) else None
    files = {"nyudepth": NyuDepthDataset, "kitti": KittiDataset}
    if d.dataset in files:
        return files[d.dataset](
            d.train_list if split == "train" else d.eval_list,
            root_dir=d.root_dir,
            split="train" if split == "train" else "val",
            n_sample=d.n_sample,
            seed=seed if seed is not None else d.seed,
            return_raw_rgb=return_raw_rgb,
            **geom,
        )
    if d.dataset == "synthetic":
        return SyntheticDepthDataset(
            length=32 if split == "train" else 8,
            hw=tuple(d.crop_hw) if d.crop_hw else _SYNTH_HW,
            n_sample=max(d.n_sample, 1),
            seed=seed if seed is not None else 0,
            split=split,
            return_raw_rgb=return_raw_rgb,
        )
    raise ValueError(f"unknown dataset {d.dataset!r}")


def build_loaders(cfg: RunConfig, shard=(0, 1)):
    """The train loader (shuffled, last short batch dropped, sharded) and the
    val loader (in order), as the JAX package builds them."""
    train_ds = build_dataset(cfg, "train")
    val_ds = build_dataset(cfg, "val", seed=0)
    mode = cfg.data.worker_mode
    train_loader = DataLoader(
        train_ds,
        cfg.data.batch_size_train,
        shuffle=True,
        drop_last=True,
        num_workers=cfg.data.num_workers,
        shard=shard,
        worker_mode=mode,
    )
    val_loader = DataLoader(
        val_ds,
        cfg.data.batch_size_eval,
        shuffle=False,
        num_workers=cfg.data.num_workers,
        worker_mode=mode,
    )
    return train_loader, val_loader
