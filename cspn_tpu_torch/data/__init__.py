"""Data: synthetic RGBD frames, the sparse sampler, batching and the loader."""

from cspn_tpu_torch.data.datasets import SyntheticDepthDataset, batches, create_sparse_depth
from cspn_tpu_torch.data.loader import DataLoader
from cspn_tpu_torch.data.transforms import Normalize

__all__ = ["DataLoader", "Normalize", "SyntheticDepthDataset", "batches", "create_sparse_depth"]
