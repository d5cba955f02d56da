"""Eval image dumps (counterpart of cspn_tpu/utils/images.py; reference
utils.save_eval_img, utils.py:182-209) and the PNG writer they use.

`save_eval_images` writes %05d_{input,gt,pred}.png into
<model_dir>/eval_result, `save_pred_image` %05d_pred.png into a folder.
Depth maps are scaled for viewing as the JAX package scales them (x25.5
for NYU and the synthetic frames, x1.0 for KITTI), clipped and truncated
to 8-bit grey; the input is the un-normalized RGB.

The writer is the standard library's `zlib` and `struct` (`write_png`:
8-bit grey, 8-bit RGB, 16-bit grey), not PIL, so that no route of the port
that writes or reads PNGs needs PIL.  The reader (`read_png`) decodes non-interlaced 8-bit grey, RGB and
RGBA and 16-bit grey PNGs itself, whatever row filters the encoder chose
(PIL, OpenCV and the KITTI devkit filter their rows): zlib inflates, the
host library undoes the filters (`data/native.py:png_unfilter`; a plain
numpy version, `_unfilter_plain`, is kept for the tests and the card
check).  Any other file goes to PIL, imported for that file; where PIL is
absent that raises an ImportError naming the file and its format.
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


# (bit depth, colour type) -> bytes a pixel, for the PNGs decoded here:
# 8-bit grey, RGB and RGBA, 16-bit grey
_DECODED = {(8, 0): 1, (8, 2): 3, (8, 6): 4, (16, 0): 2}
_COLOURS = {0: "grey", 2: "RGB", 3: "palette", 4: "grey+alpha", 6: "RGBA"}


def _png_header(data: bytes):
    """(IHDR fields (w, h, depth, colour, compression, filter, interlace),
    the joined IDAT bytes) of a PNG file's bytes."""
    pos, idat, header = len(_SIGNATURE), [], None
    while pos + 8 <= len(data):
        (n,), kind = struct.unpack(">I", data[pos : pos + 4]), data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    return header, b"".join(idat)


def _unfilter_plain(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Plain numpy inverse of the PNG row filters, one row at a time (the
    host library's `png_unfilter` does the same in C++): `raw` holds h rows
    of a filter byte and `stride` filtered bytes, `bpp` bytes a pixel."""
    rows = np.asarray(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        kind, src = rows[y, 0], rows[y, 1:].astype(np.int32)
        if kind == 0:
            cur = src
        elif kind == 2:
            cur = (src + prev) & 0xFF
        elif kind in (1, 3, 4):  # Sub, Average, Paeth: sequential along the row, a pixel at a time
            cur = np.zeros(stride + bpp, np.int32)  # bpp zeros at the left: a = c = 0 there
            up = np.concatenate([np.zeros(bpp, np.int32), prev])
            for x in range(bpp, stride + bpp, bpp):
                a, b, c = cur[x - bpp : x], up[x : x + bpp], up[x - bpp : x]
                if kind == 1:
                    pred = a
                elif kind == 3:
                    pred = (a + b) >> 1
                else:
                    p = a + b - c
                    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
                    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
                cur[x : x + bpp] = (src[x - bpp : x] + pred) & 0xFF
            cur = cur[bpp:]
        else:
            raise ValueError(f"row {y} has unknown PNG filter type {kind}")
        out[y] = cur
        prev = cur
    return out


def decode_png(path: str) -> np.ndarray | None:
    """The pixels of a non-interlaced 8-bit grey ([H, W] uint8), RGB ([H, W,
    3]), RGBA ([H, W, 4]) or 16-bit grey ([H, W] uint16) PNG, any row
    filters; None for any other file (another PNG format, or not a PNG)."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        return None
    header, idat = _png_header(data)
    if header is None:
        raise ValueError(f"{path}: a PNG without an IHDR chunk")
    w, h, depth, colour, _, _, interlace = header
    bpp = _DECODED.get((depth, colour))
    if bpp is None or interlace:
        return None
    from cspn_tpu_torch.data import native

    rows = native.png_unfilter(np.frombuffer(zlib.decompress(idat), np.uint8), h, w * bpp, bpp)
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(h, w)
    return rows.reshape(h, w, bpp) if bpp > 1 else rows.reshape(h, w)


def describe_image(path: str) -> str:
    """A few words on a file's image format, for an error message."""
    with open(path, "rb") as f:
        data = f.read(64)
    if not data.startswith(_SIGNATURE):
        return "a file that is not a PNG"
    w, h, depth, colour, _, _, interlace = _png_header(data)[0] or (0,) * 7
    return (f"a {'interlaced ' if interlace else ''}{depth}-bit "
            f"{_COLOURS.get(colour, f'colour type {colour}')} PNG")


def open_with_pil(path: str):
    """PIL's Image.open(path), PIL imported for this file; raises an
    ImportError naming the file and its format where PIL is absent."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"{path} is {describe_image(path)}, which needs PIL to decode, and PIL "
                          "is not installed (read_png decodes non-interlaced 8-bit grey, RGB and "
                          "RGBA and 16-bit grey PNGs without it)") from e
    return Image.open(path)


def read_png(path: str) -> np.ndarray:
    """Decode an image file: the PNGs of `decode_png` here, any other file
    through PIL (`np.asarray(Image.open(path))`)."""
    img = decode_png(path)
    if img is None:
        with open_with_pil(path) as im:
            img = np.asarray(im)
    return img


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
