"""Data (reference L2 layer): the NYU and KITTI file datasets and their
transforms, synthetic RGBD frames and stereo pairs, the sparse sampler,
the loader, manifests and the Scene Flow stereo reader; the host
library's bindings in `data/native.py`."""

from cspn_tpu_torch.data.datasets import (
    KittiDataset,
    NyuDepthDataset,
    SyntheticDepthDataset,
    SyntheticStereoDataset,
    create_sparse_depth,
)
from cspn_tpu_torch.data.loader import DataLoader
from cspn_tpu_torch.data.stereo import SceneFlowStereoDataset, read_pfm, write_pfm
from cspn_tpu_torch.data.transforms import (
    CenterCrop,
    ColorJitter,
    Compose,
    Crop,
    Normalize,
    Resize,
    Rotation,
)

__all__ = [
    "CenterCrop",
    "ColorJitter",
    "Compose",
    "Crop",
    "DataLoader",
    "KittiDataset",
    "Normalize",
    "NyuDepthDataset",
    "Resize",
    "Rotation",
    "SceneFlowStereoDataset",
    "SyntheticDepthDataset",
    "SyntheticStereoDataset",
    "create_sparse_depth",
    "read_pfm",
    "write_pfm",
]
