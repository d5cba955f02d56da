"""Host-side image/depth transforms: the port's copy of
cspn_tpu/data/transforms.py (reference L2: data_transform.py).

PIL + numpy implementation of the transform chain the reference builds from
torchvision + its own data_transform.py.  Depth maps ride as PIL mode-'F'
images so geometric transforms stay float-exact (the reference's custom
ToTensor keeps mode-'F' un-scaled, data_transform.py:141-187).

PIL is imported where a transform uses it, never when this module is
imported: without PIL, `ColorJitter.draw_params` (pure numpy), `Normalize`,
`unnormalize` and the array transforms still feed the host library's route
(data/native.py).

Semantics matched to the reference:
    Resize      -- shorter side to `size`, bilinear (torchvision Resize)
    Rotation    -- PIL rotate, NEAREST, same canvas (data_transform.py:455-493)
    Crop        -- box crop (left, right, up, down) (data_transform.py:269-293)
    CenterCrop  -- torchvision CenterCrop
    ColorJitter -- brightness/contrast/saturation in [1-a, 1+a], random order
                   (torchvision PIL backend uses ImageEnhance, as here)
    Normalize   -- (x - mean) / std on [0,1] float arrays
    hflip       -- PIL FLIP_LEFT_RIGHT
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


class Compose:
    def __init__(self, transforms: Sequence[Callable]):
        self.transforms = list(transforms)

    def __call__(self, x):
        for t in self.transforms:
            x = t(x)
        return x


class Resize:
    """Resize shorter side to `size` keeping aspect ratio (bilinear)."""

    def __init__(self, size: int):
        self.size = size

    def __call__(self, img):
        from PIL import Image

        w, h = img.size
        if h <= w:
            nh, nw = self.size, max(1, round(w * self.size / h))
        else:
            nw, nh = self.size, max(1, round(h * self.size / w))
        return img.resize((nw, nh), Image.BILINEAR)


class Rotation:
    """Rotate by a fixed angle (degrees), NEAREST, same canvas size."""

    def __init__(self, degrees: float):
        self.degrees = degrees

    def __call__(self, img):
        return img.rotate(self.degrees)


class Crop:
    """Box crop to [left, right) x [up, down) (reference Crop order)."""

    def __init__(self, left: int, right: int, up: int, down: int):
        self.box = (left, up, right, down)

    def __call__(self, img):
        return img.crop(self.box)


class CenterCrop:
    def __init__(self, size: tuple[int, int]):
        self.oh, self.ow = size

    def __call__(self, img):
        w, h = img.size
        left = int(round((w - self.ow) / 2.0))
        up = int(round((h - self.oh) / 2.0))
        return img.crop((left, up, left + self.ow, up + self.oh))


class ColorJitter:
    """Random brightness/contrast/saturation, factors ~ U[1-a, 1+a], applied
    in random order (torchvision semantics)."""

    # op ids shared with the host library's fused augmentation (host_pipeline.cpp)
    BRIGHTNESS, CONTRAST, SATURATION = 0, 1, 2
    _ENHANCERS: dict | None = None  # op -> ImageEnhance class, built at the first call

    def __init__(self, brightness=0.4, contrast=0.4, saturation=0.4, rng=None):
        self.b, self.c, self.s = brightness, contrast, saturation
        self.rng = rng or np.random.default_rng()

    @staticmethod
    def draw_params(brightness, contrast, saturation, rng) -> list[tuple[int, float]]:
        """Draw (op, factor) pairs in application order.  Shared by the PIL
        path below and the host library's route (datasets.py) so both
        consume the identical random stream."""
        specs = []
        for op, a in ((ColorJitter.BRIGHTNESS, brightness),
                      (ColorJitter.CONTRAST, contrast),
                      (ColorJitter.SATURATION, saturation)):
            if a > 0:
                specs.append((op, float(rng.uniform(max(0.0, 1 - a), 1 + a))))
        return [specs[i] for i in rng.permutation(len(specs))]

    @classmethod
    def enhancers(cls) -> dict:
        if cls._ENHANCERS is None:
            from PIL import ImageEnhance

            cls._ENHANCERS = {cls.BRIGHTNESS: ImageEnhance.Brightness,
                              cls.CONTRAST: ImageEnhance.Contrast,
                              cls.SATURATION: ImageEnhance.Color}
        return cls._ENHANCERS

    def __call__(self, img):
        for op, f in self.draw_params(self.b, self.c, self.s, self.rng):
            img = self.enhancers()[op](img).enhance(f)
        return img


class Normalize:
    """(x - mean) / std per channel on an HWC [0,1] float array."""

    def __init__(self, mean=IMAGENET_MEAN, std=IMAGENET_STD):
        self.mean = np.asarray(mean, dtype=np.float32)
        self.std = np.asarray(std, dtype=np.float32)

    def __call__(self, arr: np.ndarray) -> np.ndarray:
        return (arr - self.mean) / self.std


def hflip(img):
    from PIL import Image

    return img.transpose(Image.FLIP_LEFT_RIGHT)


def rgb_to_array(img) -> np.ndarray:
    """PIL RGB -> HWC float32 in [0,1] (torchvision ToTensor semantics)."""
    return np.asarray(img, dtype=np.float32) / 255.0


def depth_to_array(img) -> np.ndarray:
    """PIL mode-'F' depth -> HW float32, values preserved
    (reference data_transform.ToTensor keeps floats un-scaled)."""
    return np.asarray(img, dtype=np.float32)


def unnormalize(arr: np.ndarray, mean=IMAGENET_MEAN, std=IMAGENET_STD) -> np.ndarray:
    """Inverse of Normalize (reference utils.un_normalize, utils.py:175-180)."""
    return arr * np.asarray(std, np.float32) + np.asarray(mean, np.float32)


# --- transforms the reference ships but never chains ------------------------
# (data_transform.py:112-139, 313-321, 386-428).  Provided for API parity so
# user pipelines built against the reference's library keep working; the
# canonical NYU/KITTI chains above never call them, same as upstream.


class DepthNormalize:
    """(depth - mean) / std on a raw depth array (data_transform.py:313-321)."""

    def __init__(self, mean: float, std: float):
        self.mean = mean
        self.std = std

    def __call__(self, depth: np.ndarray) -> np.ndarray:
        return (depth - self.mean) / self.std


class CenterCropRectangle:
    """Center crop an HW(C) array to (height, width) (data_transform.py:417-428)."""

    def __init__(self, height: int, width: int):
        self.height = height
        self.width = width

    def __call__(self, arr: np.ndarray) -> np.ndarray:
        h, w = arr.shape[:2]
        top = (h - self.height) // 2
        left = (w - self.width) // 2
        return arr[top : top + self.height, left : left + self.width]


class Scale:
    """Array smaller-edge scale (data_transform.py:386-415).

    The reference routes through skimage.transform.resize, which rescales
    integer inputs to [0, 1] floats; reproduced here with PIL resampling
    (bicubic/bilinear/nearest per the same `interpolation` strings)."""

    def __init__(self, size, interpolation: str = "bicubic"):
        self.output_size = size
        self.interpolation = interpolation

    @property
    def resample(self):
        from PIL import Image

        return {"bicubic": Image.BICUBIC, "nearest": Image.NEAREST,
                "bilinear": Image.BILINEAR}.get(self.interpolation, Image.BILINEAR)

    def __call__(self, arr: np.ndarray) -> np.ndarray:
        from PIL import Image

        h, w = arr.shape[:2]
        if isinstance(self.output_size, int):
            if h > w:
                new_h, new_w = self.output_size * h // w, self.output_size
            else:
                new_h, new_w = self.output_size, self.output_size * w // h
        else:
            new_h, new_w = self.output_size
        if np.issubdtype(arr.dtype, np.integer):  # skimage img_as_float
            arr = arr.astype(np.float32) / np.float32(np.iinfo(arr.dtype).max)
        arr = arr.astype(np.float32)
        planes = [arr] if arr.ndim == 2 else [arr[..., i] for i in range(arr.shape[-1])]
        resample = self.resample
        out = [np.asarray(Image.fromarray(p, mode="F").resize((new_w, new_h), resample),
                          dtype=np.float32) for p in planes]
        return out[0] if arr.ndim == 2 else np.stack(out, axis=-1)


class ToPILImage:
    """ndarray (HWC or HW) -> PIL Image, value range preserved
    (data_transform.py:112-139)."""

    def __init__(self, mode=None):
        self.mode = mode

    def __call__(self, pic):
        from PIL import Image

        arr = np.asarray(pic)
        if arr.ndim == 3 and arr.shape[2] == 1:
            arr = arr[..., 0]
        if arr.ndim == 2 and self.mode is None and arr.dtype == np.float32:
            return Image.fromarray(arr, mode="F")
        return Image.fromarray(arr, mode=self.mode)
