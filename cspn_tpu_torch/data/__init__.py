"""Data: synthetic RGBD frames, the sparse sampler and batching."""

from cspn_tpu_torch.data.datasets import SyntheticDepthDataset, batches, create_sparse_depth
from cspn_tpu_torch.data.transforms import Normalize

__all__ = ["Normalize", "SyntheticDepthDataset", "batches", "create_sparse_depth"]
