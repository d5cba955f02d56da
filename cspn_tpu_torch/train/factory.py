"""Config -> dataset (counterpart of cspn_tpu/train/factory.py:build_dataset)."""

from __future__ import annotations

from cspn_tpu_torch.config import RunConfig
from cspn_tpu_torch.data import SyntheticDepthDataset

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
