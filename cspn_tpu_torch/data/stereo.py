"""Scene Flow stereo dataset (counterpart of cspn_tpu/data/stereo.py; the
BASELINE config 5 data path).

The stereo family trains on the Scene Flow datasets (cspn_paddle/README.md:93:
FlyingThings3D / Driving / Monkaa), whose ground-truth disparity ships as
PFM files next to left/right PNG frames.  The loader consumes a 3-column
CSV manifest:

    left,right,disp
    frames/left/0000.png,frames/right/0000.png,disparity/0000.pfm

(paths relative to ``root_dir``).  Samples:
    {'left': [H,W,3] f32 (ImageNet-normalized),
     'right': [H,W,3] f32,
     'disp': [H,W] f32}   (positive left-disparity; inf/NaN mapped to 0 =
                           invalid, matching the masked stereo loss)

Training crops a random (crop_h, crop_w) window (PSMNet protocol: 256x512);
val center-crops.  No photometric augmentation.  PIL is imported only where
a frame is read, so the synthetic path never needs it.
"""

from __future__ import annotations

import csv
import os
import re

import numpy as np

from cspn_tpu_torch.data import transforms as T


def read_pfm(path: str) -> np.ndarray:
    """Read a PFM file (grayscale or RGB) into a float32 array [H, W(,3)].

    Format: 'Pf'/'PF' header, 'W H' line, scale line (sign = endianness),
    then raw rows bottom-to-top."""
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            channels = 3
        elif header == b"Pf":
            channels = 1
        else:
            raise ValueError(f"{path}: not a PFM file (header {header!r})")
        dims = f.readline().decode("ascii")
        m = re.match(r"^\s*(\d+)\s+(\d+)\s*$", dims)
        if not m:
            raise ValueError(f"{path}: malformed PFM dimensions {dims!r}")
        w, h = int(m.group(1)), int(m.group(2))
        scale = float(f.readline().decode("ascii").strip())
        dtype = "<f4" if scale < 0 else ">f4"
        data = np.frombuffer(f.read(w * h * channels * 4), dtype=dtype)
    data = data.reshape(h, w, channels) if channels == 3 else data.reshape(h, w)
    return np.ascontiguousarray(data[::-1]).astype(np.float32)  # flip to top-down


def write_pfm(path: str, data: np.ndarray) -> None:
    """Write a float32 array [H, W] or [H, W, 3] as little-endian PFM."""
    data = np.asarray(data, np.float32)
    if data.ndim == 2:
        header = b"Pf"
    elif data.ndim == 3 and data.shape[2] == 3:
        header = b"PF"
    else:
        raise ValueError(f"PFM needs [H,W] or [H,W,3], got {data.shape}")
    with open(path, "wb") as f:
        f.write(header + b"\n")
        f.write(f"{data.shape[1]} {data.shape[0]}\n".encode("ascii"))
        f.write(b"-1.0\n")
        f.write(np.ascontiguousarray(data[::-1]).astype("<f4").tobytes())


def read_stereo_manifest(csv_file: str) -> list[tuple[str, str, str]]:
    with open(csv_file, newline="") as f:
        rows = list(csv.DictReader(f))
    missing = {"left", "right", "disp"} - set(rows[0].keys() if rows else ())
    if missing:
        raise ValueError(f"{csv_file}: manifest missing columns {sorted(missing)}")
    return [(r["left"], r["right"], r["disp"]) for r in rows]


class SceneFlowStereoDataset:
    """Stereo pairs + PFM disparity from a left,right,disp CSV manifest."""

    def __init__(
        self,
        csv_file: str,
        root_dir: str = ".",
        split: str = "train",
        crop_hw: tuple[int, int] = (256, 512),
        seed: int | None = None,
    ):
        self.rows = read_stereo_manifest(csv_file)
        self.root_dir = root_dir
        self.split = split
        self.crop_hw = crop_hw
        self._seed = seed

    def __len__(self) -> int:
        return len(self.rows)

    def _rng(self, idx: int) -> np.random.Generator:
        if self._seed is None:
            return np.random.default_rng()
        return np.random.default_rng((self._seed, idx))

    def __getitem__(self, idx: int) -> dict[str, np.ndarray]:
        from PIL import Image

        lp, rp, dp = (os.path.join(self.root_dir, p) for p in self.rows[idx])
        left = np.asarray(Image.open(lp).convert("RGB"), np.uint8)
        right = np.asarray(Image.open(rp).convert("RGB"), np.uint8)
        disp = read_pfm(dp)
        if disp.ndim == 3:
            disp = disp[..., 0]
        # Scene Flow disparities can be negative (right view) or non-finite;
        # the loss masks on disp > 0, so clean to that convention
        disp = np.where(np.isfinite(disp), np.abs(disp), 0.0).astype(np.float32)

        ch, cw = self.crop_hw
        h, w = disp.shape
        if h < ch or w < cw:
            raise ValueError(f"frame {h}x{w} smaller than crop {ch}x{cw}")
        if self.split == "train":
            rng = self._rng(idx)
            y0 = int(rng.integers(0, h - ch + 1))
            x0 = int(rng.integers(0, w - cw + 1))
        else:
            y0, x0 = (h - ch) // 2, (w - cw) // 2
        sl = np.s_[y0 : y0 + ch, x0 : x0 + cw]
        norm = T.Normalize()
        return {
            "left": norm(left[sl].astype(np.float32) / 255.0).astype(np.float32),
            "right": norm(right[sl].astype(np.float32) / 255.0).astype(np.float32),
            "disp": disp[sl],
        }
