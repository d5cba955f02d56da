"""Host-side transforms: the port's numpy-only copy of the parts of
cspn_tpu/data/transforms.py that the synthetic path and the image dumps use."""

from __future__ import annotations

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


class Normalize:
    """(x - mean) / std per channel on an HWC [0,1] float array."""

    def __init__(self, mean=IMAGENET_MEAN, std=IMAGENET_STD):
        self.mean = np.asarray(mean, dtype=np.float32)
        self.std = np.asarray(std, dtype=np.float32)

    def __call__(self, arr: np.ndarray) -> np.ndarray:
        return (arr - self.mean) / self.std


def unnormalize(arr: np.ndarray, mean=IMAGENET_MEAN, std=IMAGENET_STD) -> np.ndarray:
    """Inverse of Normalize (reference utils.un_normalize, utils.py:175-180)."""
    return arr * np.asarray(std, np.float32) + np.asarray(mean, np.float32)
