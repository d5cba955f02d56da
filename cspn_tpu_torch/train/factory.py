"""Config -> datasets and loaders (counterpart of cspn_tpu/train/factory.py)."""

from __future__ import annotations

from cspn_tpu_torch.config import RunConfig
from cspn_tpu_torch.data import DataLoader, SyntheticDepthDataset

_SYNTH_HW = (64, 96)


def build_dataset(cfg: RunConfig, split: str, seed=None, return_raw_rgb=False):
    """The synthetic dataset at the JAX package's geometry (64x96), or at
    `cfg.data.crop_hw` when set (e.g. (228, 304), the NYU frame).  The
    NYU/KITTI file datasets are not ported yet."""
    d = cfg.data
    if d.dataset == "synthetic":
        return SyntheticDepthDataset(
            length=32 if split == "train" else 8,
            hw=tuple(d.crop_hw) if d.crop_hw else _SYNTH_HW,
            n_sample=max(d.n_sample, 1),
            seed=seed if seed is not None else 0,
            split=split,
            return_raw_rgb=return_raw_rgb,
        )
    raise NotImplementedError(
        f"dataset {d.dataset!r} is not ported yet (ROADMAP.md Queue 1: NYU/KITTI "
        "file datasets); use dataset='synthetic'"
    )


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
