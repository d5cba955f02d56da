"""ctypes bindings of the port's host library (csrc/host_pipeline.cpp),
the counterpart of cspn_tpu/data/native.py.

The library is built with g++ at first use by ops/_build.py (`HOST_FLAGS`,
the JAX package's native/Makefile flags) into `cspn_tpu_torch/_build/`.
As in the JAX package, the callers ask `available()` / `aug_available()`
first and take the transforms chain (PIL) where the library cannot be
built or loaded (data/datasets.py, which warns once with the compiler's
output, `build_error()`), and utils/images.py:decode_png leaves such PNGs
to PIL.  The bindings themselves raise without the library, with the
compiler's output, as JAX's do without theirs.  The other route a caller
takes by semantics is `aug_pack`'s None for a crop larger than the
resized frame (the library's rc 1).
"""

from __future__ import annotations

import ctypes
import subprocess
import threading

import numpy as np

LIBRARY = "host_pipeline"

_lock = threading.Lock()
# the outcome of this process's one try at the library: None until tried,
# then "" where it loaded, else the build's error with the compiler's output
_build_error: str | None = None


def library() -> ctypes.CDLL:
    """The loaded host library, built first if needed (raises if it cannot be)."""
    from cspn_tpu_torch.ops import _build

    return _build.load(LIBRARY)


def available() -> bool:
    """True where the host library builds and loads.  Tried once a process
    (cspn_tpu/data/native.py:available); a failure keeps its message and
    the compiler's output (`build_error()`)."""
    global _build_error
    with _lock:
        if _build_error is None:
            try:
                library()
                _build_error = ""
            # a failed compile, no g++ (or g++ failing on its target query), a bad .so
            except (RuntimeError, OSError, subprocess.SubprocessError) as e:
                _build_error = str(e)
        return not _build_error


def aug_available() -> bool:
    """True where the library's one-pass augmentation `aug_pack` can run
    (cspn_tpu/data/native.py:aug_available): the library loads (the port's
    source always defines `cspn_aug_pack`)."""
    return available()


def build_error() -> str:
    """Why the library is not available ("" where it is, or not tried yet)."""
    return _build_error or ""


def pack_sample(
    rgb_u8: np.ndarray,
    depth: np.ndarray,
    inv_scale: float,
    p_sample: float,
    seed: int,
    num_threads: int = 4,
) -> tuple[np.ndarray, np.ndarray]:
    """Fused normalize + depth-scale + sparse-sample + RGBD pack.

    rgb_u8: [H, W, 3] uint8; depth: [H, W] float32.
    Returns (rgbd [H, W, 4] f32, depth [H, W] f32).
    """
    lib = library()
    rgb_u8 = np.ascontiguousarray(rgb_u8, dtype=np.uint8)
    depth = np.ascontiguousarray(depth, dtype=np.float32)
    h, w = depth.shape
    out_rgbd = np.empty((h, w, 4), np.float32)
    out_depth = np.empty((h, w), np.float32)
    lib.cspn_pack_sample(
        rgb_u8.ctypes.data, depth.ctypes.data, h, w, ctypes.c_float(inv_scale),
        ctypes.c_float(p_sample), ctypes.c_uint64(seed & (2**64 - 1)),
        out_rgbd.ctypes.data, out_depth.ctypes.data, num_threads,
    )
    return out_rgbd, out_depth


def aug_pack(
    rgb_u8: np.ndarray,
    depth: np.ndarray,
    *,
    resize_hw: tuple[int, int] | None,
    angle: float,
    crop_hw: tuple[int, int],
    flip: bool,
    jitter: list[tuple[int, float]],
    inv_scale: float,
    n_sample: int,
    sparse_denom: str,
    seed: int,
) -> tuple[np.ndarray, np.ndarray] | None:
    """The augmentation chain in one pass (cspn_aug_pack): resize (PIL's
    triangle filter) + rotate (NEAREST) + centre crop + hflip + ColorJitter
    + normalize + depth/s + Bernoulli sparse + RGBD pack.  `jitter` is
    [(op, factor)] in application order, op 0 brightness, 1 contrast, 2
    saturation.  Strided views (the h5 planar layout as
    `rgb.transpose(1, 2, 0)`, box-crop slices) go in without a copy.

    Returns (rgbd [oh,ow,4] f32, depth [oh,ow] f32), or None where the
    library refuses the arguments (rc 1: e.g. a crop larger than the
    resized frame), which the caller then takes through the transforms chain.
    """
    lib = library()
    if rgb_u8.dtype != np.uint8:
        rgb_u8 = rgb_u8.astype(np.uint8)
    if depth.dtype != np.float32:
        depth = depth.astype(np.float32)
    h0, w0 = depth.shape
    rh, rw = resize_hw if resize_hw is not None else (h0, w0)
    oh, ow = crop_hw
    ops = np.asarray([o for o, _ in jitter], dtype=np.int32)
    facs = np.asarray([f for _, f in jitter], dtype=np.float32)
    out_rgbd = np.empty((oh, ow, 4), np.float32)
    out_depth = np.empty((oh, ow), np.float32)
    r_rs, r_cs, r_chs = (s // rgb_u8.itemsize for s in rgb_u8.strides)
    d_rs, d_cs = (s // depth.itemsize for s in depth.strides)
    rc = lib.cspn_aug_pack(
        rgb_u8.ctypes.data, r_rs, r_cs, r_chs,
        depth.ctypes.data, d_rs, d_cs,
        h0, w0, rh, rw,
        ctypes.c_float(angle), oh, ow, int(bool(flip)),
        ops.ctypes.data if len(jitter) else None,
        facs.ctypes.data if len(jitter) else None,
        len(jitter),
        ctypes.c_float(inv_scale), int(n_sample), 0 if sparse_denom == "total" else 1,
        ctypes.c_uint64(seed & (2**64 - 1)),
        out_rgbd.ctypes.data, out_depth.ctypes.data,
    )
    if rc != 0:
        return None
    return out_rgbd, out_depth


def count_valid(depth: np.ndarray, threshold: float = 1e-4) -> int:
    """The number of depth values > threshold."""
    lib = library()
    depth = np.ascontiguousarray(depth, dtype=np.float32)
    return int(lib.cspn_count_valid(depth.ctypes.data, depth.size, threshold))


def png_unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the PNG row filters: `raw` holds h rows of a filter byte and
    `stride` filtered bytes (a decompressed IDAT stream), `bpp` bytes a
    pixel.  Returns the [h, stride] uint8 rows; raises ValueError on an
    unknown filter type."""
    lib = library()
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"{raw.size} bytes for {h} rows of 1 + {stride}")
    out = np.empty((h, stride), np.uint8)
    rc = lib.cspn_png_unfilter(raw.ctypes.data, h, stride, bpp, out.ctypes.data)
    if rc != 0:
        raise ValueError(f"row {rc - 1} has unknown PNG filter type "
                         f"{raw[(rc - 1) * (stride + 1)]}")
    return out
