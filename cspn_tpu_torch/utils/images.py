"""Eval image dumps (counterpart of cspn_tpu/utils/images.py; reference
utils.save_eval_img, utils.py:182-209) and the PNG writer they use.

`save_eval_images` writes %05d_{input,gt,pred}.png into
<model_dir>/eval_result, `save_pred_image` %05d_pred.png into a folder.
Depth maps are scaled for viewing as the JAX package scales them (x25.5
for NYU and the synthetic frames, x1.0 for KITTI), clipped and truncated
to 8-bit grey; the input is the un-normalized RGB.

The writer is the standard library's `zlib` and `struct` (`write_png`:
8-bit grey, 8-bit RGB, 16-bit grey), not PIL, which the card's machine
lacks.  `read_png` decodes what it writes.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from cspn_tpu_torch.data.transforms import unnormalize

_DEPTH_VIS_SCALE = {"nyudepth": 25.5, "kitti": 1.0, "synthetic": 25.5}
_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# (ndim, dtype) -> (PNG bit depth, colour type): 0 is grey, 2 RGB
_FORMATS = {(2, np.dtype(np.uint8)): (8, 0), (3, np.dtype(np.uint8)): (8, 2),
            (2, np.dtype(np.uint16)): (16, 0)}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> str:
    """Write `img` as a PNG: [H, W] uint8 (grey), [H, W, 3] uint8 (RGB) or
    [H, W] uint16 (16-bit grey); no filtering, no interlace."""
    img = np.asarray(img)
    key = (img.ndim, img.dtype)
    if key not in _FORMATS or (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"write_png takes [H, W] uint8 or uint16, or [H, W, 3] uint8; "
                         f"got {img.shape} {img.dtype}")
    depth, colour = _FORMATS[key]
    h, w = img.shape[:2]
    rows = img.astype(">u2" if depth == 16 else np.uint8).reshape(h, -1).view(np.uint8)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)  # filter 0 a row
    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))
    return path


def read_png(path: str) -> np.ndarray:
    """Decode a PNG that `write_png` wrote (no filtering, no interlace)."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path} is not a PNG")
    pos, idat, header = len(_SIGNATURE), b"", None
    while pos < len(data):
        (n,), kind = struct.unpack(">I", data[pos : pos + 4]), data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
    w, h, depth, colour, _, _, interlace = header
    channels = 3 if colour == 2 else 1
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)
    if interlace or rows[:, 0].any():
        raise ValueError(f"{path}: read_png decodes unfiltered, uninterlaced PNGs only")
    img = rows[:, 1:].copy().view(">u2" if depth == 16 else np.uint8)
    img = img.astype(np.uint16 if depth == 16 else np.uint8)
    return img.reshape(h, w, channels) if channels == 3 else img.reshape(h, w)


def _to_u8(x: np.ndarray) -> np.ndarray:
    return np.clip(x, 0.0, 255.0).astype(np.uint8)


def save_eval_images(dataset: str, model_dir: str, index: int, rgb: np.ndarray,
                     gt_depth: np.ndarray, pred_depth: np.ndarray, raw: bool = False) -> str:
    """%05d_{input,gt,pred}.png of one frame into <model_dir>/eval_result:
    `rgb` [H, W, 3] (normalized unless `raw`), the depths [H, W]."""
    folder = os.path.join(model_dir, "eval_result")
    os.makedirs(folder, exist_ok=True)
    scale = _DEPTH_VIS_SCALE.get(dataset, 1.0)
    rgb_arr = rgb if raw else unnormalize(rgb)
    write_png(os.path.join(folder, "%05d_input.png" % index), _to_u8(rgb_arr * 255.0))
    write_png(os.path.join(folder, "%05d_gt.png" % index), _to_u8(gt_depth * scale))
    save_pred_image(dataset, folder, index, pred_depth)
    return folder


def save_pred_image(dataset: str, folder: str, index: int, pred_depth: np.ndarray) -> str:
    """%05d_pred.png of one prediction [H, W] (the `infer` path)."""
    os.makedirs(folder, exist_ok=True)
    path = os.path.join(folder, "%05d_pred.png" % index)
    return write_png(path, _to_u8(pred_depth * _DEPTH_VIS_SCALE.get(dataset, 1.0)))
