"""Data: synthetic RGBD frames and stereo pairs, the sparse sampler,
batching, the loader and the Scene Flow stereo reader."""

from cspn_tpu_torch.data.datasets import (
    SyntheticDepthDataset,
    SyntheticStereoDataset,
    batches,
    create_sparse_depth,
)
from cspn_tpu_torch.data.loader import DataLoader
from cspn_tpu_torch.data.stereo import SceneFlowStereoDataset, read_pfm, write_pfm
from cspn_tpu_torch.data.transforms import Normalize

__all__ = [
    "DataLoader",
    "Normalize",
    "SceneFlowStereoDataset",
    "SyntheticDepthDataset",
    "SyntheticStereoDataset",
    "batches",
    "create_sparse_depth",
    "read_pfm",
    "write_pfm",
]
