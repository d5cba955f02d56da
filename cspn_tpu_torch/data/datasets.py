"""Datasets: the port's copy of cspn_tpu/data/datasets.py (reference L2:
nyu_dataset_loader.py / kitti_dataset_loader.py).

CSV manifests (header `Name`, one HDF5 path per row -- same format as the
reference's datalist/*.csv) of per-frame HDF5 files holding `rgb` (CHW uint8)
and `depth` (HW float), or two-column manifests of (rgb, depth) image files
(`input_format='img'`).  Samples are channels-last, as in the JAX package:
    {'rgbd': [H, W, 4] float32, 'depth': [H, W] float32[, 'raw_rgb']}
    {'left': [H, W, 3], 'right': [H, W, 3], 'disp': [H, W]} (stereo)
and equal to the JAX package's for the same seed and index, bit for bit.

Augmentation chains match the reference loaders:
  NYU train (nyu_dataset_loader.py:80-109): scale s~U(1,1.5) -> resize
    int(240*s) -> rotate U(-5,5) -> ColorJitter(0.4,0.4,0.4) -> CenterCrop
    (228,304) -> normalize -> p=.5 joint hflip -> depth /= s -> sparse sample.
  NYU val (:112-129): resize 240 -> CenterCrop, no jitter/flip.
  KITTI (kitti_dataset_loader.py:79-126): box crop (10,1210,130,370) ->
    rotate -> jitter -> CenterCrop (228,912) -> normalize -> flip;
    train divides depth by a random s~U(1,1.5) with no geometric rescale
    (faithful to the reference, where Resize is absent but the division
    remains) -> sparse sample.
  Sparse sampling: Bernoulli p = n_sample / n_pixels for NYU (:141) but
    p = n_sample / n_valid_pixels for KITTI (:138).

The default route (`use_native=True`) runs the whole chain in one pass of
the host library (data/native.py:aug_pack) and needs neither PIL nor, for
`img` manifests of PNG files, anything but numpy and zlib (utils/images.py
reads them).  The transforms chain (PIL, imported for the frame) runs with
`use_native=False`, with `return_raw_rgb` (the image dumps), for a crop
larger than the frame, and, as in the JAX package, wherever the host
library cannot be built (a warning, once, carries the compiler's output);
`hdf5` manifests import h5py for each frame.
"""

from __future__ import annotations

import csv
import os
import warnings
import numpy as np

from cspn_tpu_torch.data import transforms as T


def read_manifest(csv_file: str) -> list[str]:
    """Read a datalist CSV (header row + one path per line)."""
    return [r[0] for r in read_manifest_rows(csv_file)]


def read_manifest_rows(csv_file: str) -> list[list[str]]:
    """Read a datalist CSV keeping all columns (img-format lists have two:
    rgb path, depth path -- nyu_dataset_loader.py:52-60)."""
    with open(csv_file, newline="") as f:
        rows = list(csv.reader(f))
    if rows and rows[0] and rows[0][0].strip().lower() in ("name", "path", "rgb"):
        rows = rows[1:]
    return [r for r in rows if r]


_warned_no_library = False


def _warn_no_library(error: str) -> None:
    """Warn, once a process, that the samples take the transforms chain
    because the host library did not build, with the compiler's output."""
    global _warned_no_library
    if not _warned_no_library:
        _warned_no_library = True
        warnings.warn("the host library (csrc/host_pipeline.cpp) is not available, so the "
                      "samples take the transforms chain (PIL), as the JAX package's do "
                      f"without theirs:\n{error}", RuntimeWarning, stacklevel=3)


# PIL modes whose pixels are bytes: torchvision's ToTensor divides them by 255
_BYTE_MODES = ("L", "P", "RGB", "RGBA", "1")


def load_img_pair(rgb_path: str, depth_path: str) -> tuple[np.ndarray, np.ndarray]:
    """Image frame pair -> (rgb [H, W, 3] uint8, depth [H, W] float32).

    Mirrors the reference 'img' input format (nyu_dataset_loader.py:51-60 /
    kitti_dataset_loader.py:50-60): rgb is `Image.open().convert('RGB')`, the
    depth image is read in its own mode and scaled as torchvision `ToTensor`
    scales it: byte images (8-bit grey, RGB, RGBA, palette, bilevel) divided
    by 255, 16/32-bit integer and float images un-scaled, and a depth stored
    as a multi-band image keeps band 0.  PNGs of utils/images.py:decode_png's
    formats are read without PIL (the default route); any other file through
    PIL, imported for that file.
    """
    from cspn_tpu_torch.utils.images import decode_png, open_with_pil

    rgb = decode_png(rgb_path)
    if rgb is None or rgb.dtype != np.uint8:
        with open_with_pil(rgb_path) as im:
            rgb = np.asarray(im.convert("RGB"))
    elif rgb.ndim == 2:  # grey -> RGB replicates the grey value
        rgb = np.repeat(rgb[..., None], 3, axis=-1)
    else:  # RGBA -> RGB drops alpha
        rgb = np.ascontiguousarray(rgb[..., :3])
    d = decode_png(depth_path)
    if d is None:
        with open_with_pil(depth_path) as im:
            arr, byte = np.asarray(im, dtype=np.float32), im.mode in _BYTE_MODES
    else:
        arr, byte = d.astype(np.float32), d.dtype == np.uint8
    if arr.ndim == 3:  # depth stored as an RGB-ish image: use the first band
        arr = arr[..., 0]
    if byte:
        arr = arr / 255.0  # torchvision ToTensor semantics for byte images
    return rgb, np.ascontiguousarray(arr, dtype=np.float32)


def load_h5_frame(path: str) -> tuple[np.ndarray, np.ndarray]:
    """HDF5 frame -> (rgb HWC uint8, depth HW float32)
    (reference load_h5, nyu_dataset_loader.py:146-151); h5py is imported
    for the frame."""
    import h5py

    with h5py.File(path, "r") as f:
        rgb = np.asarray(f["rgb"]).transpose(1, 2, 0)
        depth = np.asarray(f["depth"], dtype=np.float32)
    return rgb, depth


def create_sparse_depth(
    depth: np.ndarray, n_sample: int, rng: np.random.Generator, denom: str = "total"
) -> np.ndarray:
    """Bernoulli sparse sampling of a depth map.

    denom='total': p = n_sample / n_pixels (NYU, nyu_dataset_loader.py:141)
    denom='valid': p = n_sample / #(depth > 1e-4) (KITTI, kitti_dataset_loader.py:138)
    """
    if denom == "total":
        p = n_sample / depth.size
    elif denom == "valid":
        n_valid = int((depth > 1e-4).sum())
        p = n_sample / max(n_valid, 1)
    else:
        raise ValueError(denom)
    mask = (rng.random(depth.shape) < min(p, 1.0)).astype(np.float32)
    return depth * mask


class _DepthCompletionDataset:
    """Shared train/val logic for the file-manifest datasets."""

    # subclass configuration
    crop_hw: tuple[int, int]
    sparse_denom: str
    resize_base: int | None  # NYU: 240; KITTI: None (box crop instead)
    box_crop: tuple[int, int, int, int] | None

    def __init__(
        self,
        csv_file: str,
        root_dir: str = ".",
        split: str = "train",
        n_sample: int = 500,
        seed: int | None = None,
        return_raw_rgb: bool = False,
        use_native: bool = True,
        crop_hw: tuple[int, int] | None = None,
        box_crop: tuple[int, int, int, int] | None | str = "default",
        input_format: str = "hdf5",
    ):
        if input_format not in ("hdf5", "img"):
            raise ValueError(f"unsupported input_format {input_format!r}")
        self.input_format = input_format
        self.rows = read_manifest_rows(csv_file)
        self.paths = [r[0] for r in self.rows]
        self.root_dir = root_dir
        self.split = split
        self.n_sample = n_sample
        self.return_raw_rgb = return_raw_rgb
        self._seed = seed
        self.use_native = use_native
        # geometry overrides (e.g. KITTI depth-completion benchmark frames,
        # 352x1216 with no box pre-crop, vs the reference's 228x912 training
        # crop); defaults come from the subclass attributes
        if crop_hw is not None:
            self.crop_hw = tuple(crop_hw)
        if box_crop != "default":
            self.box_crop = box_crop

    def __len__(self) -> int:
        return len(self.paths)

    def _rng(self, idx: int) -> np.random.Generator:
        if self._seed is None:
            return np.random.default_rng()
        return np.random.default_rng((self._seed, idx))

    def _load_arrays(self, idx: int) -> tuple[np.ndarray, np.ndarray]:
        """(rgb HWC uint8, depth HW float32) of frame `idx`, without PIL for
        h5 frames and PNG pairs."""
        if self.input_format == "img":
            row = self.rows[idx]
            if len(row) < 2:
                raise ValueError(
                    "input_format='img' needs a two-column manifest "
                    "(rgb path, depth path)"
                )
            return load_img_pair(
                os.path.join(self.root_dir, row[0]),
                os.path.join(self.root_dir, row[1]),
            )
        return load_h5_frame(os.path.join(self.root_dir, self.paths[idx]))

    def _load(self, idx: int):
        """Frame `idx` as PIL images (RGB, mode 'F' depth) for the transforms chain."""
        from PIL import Image

        rgb, depth = self._load_arrays(idx)
        return Image.fromarray(rgb, mode="RGB"), Image.fromarray(depth, mode="F")

    @staticmethod
    def _resize_shorter(h: int, w: int, size: int) -> tuple[int, int]:
        """transforms.Resize geometry: shorter side to `size`, aspect kept."""
        if h <= w:
            return size, max(1, round(w * size / h))
        return max(1, round(h * size / w)), size

    def _native_fast_sample(self, idx: int) -> dict[str, np.ndarray] | None:
        """The whole chain -- resize/rotate/jitter/crop/flip/normalize/÷s/
        sparse/pack -- in one pass of the host library (csrc/host_pipeline.cpp
        cspn_aug_pack), drawing the same random stream as the transforms
        chain, draw for draw.  None where the library refuses the geometry
        (a crop larger than the resized frame) or cannot be built: the
        transforms chain then takes the sample, as the JAX package's does
        (cspn_tpu/data/datasets.py:189-190), with one warning a process
        that carries the compiler's output."""
        from cspn_tpu_torch.data import native

        if not native.aug_available():
            _warn_no_library(native.build_error())
            return None
        rgb, depth = self._load_arrays(idx)
        rng = self._rng(idx)
        if self.box_crop is not None:
            left, right, up, down = self.box_crop
            rgb = rgb[up:down, left:right]
            depth = depth[up:down, left:right]
        h0, w0 = depth.shape
        s = 1.0
        angle = 0.0
        jitter: list[tuple[int, float]] = []
        flip = False
        resize_hw = None
        if self.split == "train":
            s = float(rng.uniform(1.0, 1.5))
            if self.resize_base is not None:
                resize_hw = self._resize_shorter(h0, w0, int(self.resize_base * s))
            angle = float(rng.uniform(-5.0, 5.0))
            jitter = T.ColorJitter.draw_params(0.4, 0.4, 0.4, rng)
            flip = bool(rng.random() < 0.5)
        elif self.resize_base is not None:
            resize_hw = self._resize_shorter(h0, w0, self.resize_base)
        packed = native.aug_pack(
            rgb,
            depth,
            resize_hw=resize_hw,
            angle=angle,
            crop_hw=self.crop_hw,
            flip=flip,
            jitter=jitter,
            inv_scale=1.0 / s,
            n_sample=self.n_sample,
            sparse_denom=self.sparse_denom,
            seed=int(rng.integers(0, 2**63)),
        )
        if packed is None:
            return None
        rgbd, depth_arr = packed
        return {"rgbd": rgbd, "depth": depth_arr}

    def __getitem__(self, idx: int) -> dict[str, np.ndarray]:
        if self.use_native and not self.return_raw_rgb:
            sample = self._native_fast_sample(idx)
            if sample is not None:
                return sample
        rgb, depth = self._load(idx)
        rng = self._rng(idx)

        geom: list = []
        if self.box_crop is not None:
            geom.append(T.Crop(*self.box_crop))
        s = 1.0
        if self.split == "train":
            s = rng.uniform(1.0, 1.5)
            if self.resize_base is not None:
                geom.append(T.Resize(int(self.resize_base * s)))
            geom.append(T.Rotation(rng.uniform(-5.0, 5.0)))
        elif self.resize_base is not None:
            geom.append(T.Resize(self.resize_base))

        rgb_ops = list(geom)
        if self.split == "train":
            rgb_ops.append(T.ColorJitter(0.4, 0.4, 0.4, rng=rng))
        rgb_ops.append(T.CenterCrop(self.crop_hw))
        depth_ops = geom + [T.CenterCrop(self.crop_hw)]

        rgb = T.Compose(rgb_ops)(rgb)
        depth = T.Compose(depth_ops)(depth)

        if self.split == "train" and rng.random() < 0.5:
            rgb, depth = T.hflip(rgb), T.hflip(depth)

        depth_raw = T.depth_to_array(depth)
        inv_scale = (1.0 / s) if self.split == "train" else 1.0

        from cspn_tpu_torch.data import native

        if self.use_native and not self.return_raw_rgb and native.available():
            # the host library's pass: normalize + scale + sparse-sample + pack
            if self.sparse_denom == "total":
                p = self.n_sample / depth_raw.size
            else:
                # the reference counts valid pixels AFTER depth /= s
                # (kitti_dataset_loader.py:132-144): d/s > t <=> d > t/inv
                n_valid = native.count_valid(depth_raw, threshold=1e-4 / inv_scale) or 1
                p = self.n_sample / max(n_valid, 1)
            rgbd, depth_arr = native.pack_sample(
                np.asarray(rgb, dtype=np.uint8),
                depth_raw,
                inv_scale,
                min(p, 1.0),
                int(rng.integers(0, 2**63)),
            )
            return {"rgbd": rgbd, "depth": depth_arr}

        raw_rgb = T.rgb_to_array(rgb)
        rgb_arr = T.Normalize()(raw_rgb)
        depth_arr = depth_raw * inv_scale

        sparse = create_sparse_depth(depth_arr, self.n_sample, rng, self.sparse_denom)
        rgbd = np.concatenate([rgb_arr, sparse[..., None]], axis=-1).astype(np.float32)
        sample = {"rgbd": rgbd, "depth": depth_arr.astype(np.float32)}
        if self.return_raw_rgb:
            # eval-variant loaders additionally return the un-normalized rgb
            # for image dumping (eval_nyu_dataset_loader.py:113-125)
            sample["raw_rgb"] = raw_rgb
        return sample


class NyuDepthDataset(_DepthCompletionDataset):
    crop_hw = (228, 304)
    sparse_denom = "total"
    resize_base = 240
    box_crop = None


class KittiDataset(_DepthCompletionDataset):
    crop_hw = (228, 912)
    sparse_denom = "valid"
    resize_base = None
    box_crop = (10, 1210, 130, 370)


class SyntheticDepthDataset:
    """Procedural RGBD fixture dataset (no files needed): smooth random depth
    surfaces + shading-derived RGB.  Deterministic per (seed, idx).  Used by
    tests and benchmarks; mirrors the real datasets' sample dict."""

    def __init__(
        self,
        length: int = 64,
        hw: tuple[int, int] = (228, 304),
        n_sample: int = 500,
        seed: int = 0,
        split: str = "train",
        return_raw_rgb: bool = False,
        style: str = "smooth",
    ):
        self.length = length
        self.hw = hw
        self.n_sample = n_sample
        self.seed = seed
        self.split = split
        self.return_raw_rgb = return_raw_rgb
        # 'smooth': Gaussian-bump depth with depth-encoding RGB (default,
        # golden-pinned by tests).  'edges': sharp-edged foreground
        # rectangles at constant depths whose RGB shows the *borders*
        # (albedo step + shading line) but whose interiors are textureless
        # and whose albedo is UNCORRELATED with depth -- absolute depth is
        # only recoverable from the sparse channel, so dense completion
        # must spread the sparse anchors within edge-bounded regions: the
        # scenario CSPN's edge-aware propagation exists for (TPAMI Fig. 4
        # analog of the stereo 'edges' fixture above).
        # 'edges_mono': same sharp-edged geometry but albedo affine in
        # depth (0.1 + 0.08*d), so depth IS recoverable from RGB alone --
        # the monocular setting (n_sample=0, BASELINE config 4).  The
        # network's coarse-to-fine decoder blurs the discontinuities; the
        # question the mono ablation asks is whether CSPN's edge-aware
        # propagation restores them (the paper's mono refinement claim).
        if style not in ("smooth", "edges", "edges_mono"):
            # a typo silently falling back to 'smooth' (whose RGB encodes
            # depth) would quietly invalidate the completion ablation
            raise ValueError(f"style must be smooth|edges|edges_mono: {style!r}")
        self.style = style

    def __len__(self):
        return self.length

    def __getitem__(self, idx: int) -> dict[str, np.ndarray]:
        h, w = self.hw
        rng = np.random.default_rng((self.seed, idx))
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        depth = np.full((h, w), 2.0, np.float32)
        for _ in range(6):
            cy, cx = rng.uniform(0, h), rng.uniform(0, w)
            sy, sx = rng.uniform(h / 8, h / 2), rng.uniform(w / 8, w / 2)
            amp = rng.uniform(-1.0, 1.0)
            depth += amp * np.exp(
                -(((yy - cy) / sy) ** 2 + ((xx - cx) / sx) ** 2)
            ).astype(np.float32)
        depth = np.clip(depth, 0.5, 10.0)
        if self.style == "edges_mono":
            for _ in range(4):
                y0 = int(rng.uniform(0, h * 0.7))
                x0 = int(rng.uniform(0, w * 0.7))
                y1 = y0 + int(rng.uniform(h * 0.15, h * 0.4))
                x1 = x0 + int(rng.uniform(w * 0.15, w * 0.4))
                depth[y0:y1, x0:x1] = rng.uniform(0.7, 9.5)
            alb = (0.1 + 0.08 * depth).astype(np.float32)
            gy, gx = np.gradient(depth)
            shade = 1.0 / (1.0 + np.abs(gy) + np.abs(gx))
            raw_rgb = np.stack(
                [alb * shade, alb, shade.astype(np.float32)], axis=-1
            ).astype(np.float32)
        elif self.style == "edges":
            # low-frequency background albedo (independent of depth)
            alb = np.full((h, w), 0.5, np.float32)
            for _ in range(4):
                cy, cx = rng.uniform(0, h), rng.uniform(0, w)
                sy, sx = rng.uniform(h / 6, h / 2), rng.uniform(w / 6, w / 2)
                alb += rng.uniform(-0.25, 0.25) * np.exp(
                    -(((yy - cy) / sy) ** 2 + ((xx - cx) / sx) ** 2)
                ).astype(np.float32)
            # sharp-edged objects: constant depth, flat albedo, both drawn
            # independently -- the RGB edge marks WHERE depth jumps but
            # says nothing about the jump's value
            for _ in range(4):
                y0 = int(rng.uniform(0, h * 0.7))
                x0 = int(rng.uniform(0, w * 0.7))
                y1 = y0 + int(rng.uniform(h * 0.15, h * 0.4))
                x1 = x0 + int(rng.uniform(w * 0.15, w * 0.4))
                depth[y0:y1, x0:x1] = rng.uniform(0.7, 9.5)
                alb[y0:y1, x0:x1] = rng.uniform(0.15, 0.9)
            alb = np.clip(alb, 0.05, 1.0)
            gy, gx = np.gradient(depth)
            shade = 1.0 / (1.0 + np.abs(gy) + np.abs(gx))
            raw_rgb = np.stack(
                [alb * shade, alb, shade.astype(np.float32)], axis=-1
            ).astype(np.float32)
        else:
            gy, gx = np.gradient(depth)
            shade = 1.0 / (1.0 + np.abs(gy) + np.abs(gx))
            raw_rgb = np.stack(
                [shade, depth / 10.0, 1.0 - depth / 10.0], axis=-1
            ).astype(np.float32)
        rgb = T.Normalize()(raw_rgb)
        sparse = create_sparse_depth(depth, self.n_sample, rng, "total")
        rgbd = np.concatenate([rgb, sparse[..., None]], axis=-1).astype(np.float32)
        sample = {"rgbd": rgbd, "depth": depth}
        if self.return_raw_rgb:
            sample["raw_rgb"] = raw_rgb
        return sample


class SyntheticStereoDataset:
    """Procedural stereo fixture: left/right views of a random smooth
    disparity field (right = left warped by disparity along W), used by the
    stereo trainer's tests and smoke runs.  Samples:
        {'left': [H,W,3], 'right': [H,W,3], 'disp': [H,W]}
    style 'smooth': Gaussian-bump disparity; 'edges': adds sharp-edged,
    nearly textureless constant-disparity rectangles (the structure CSPN's
    edge-aware refinement exploits).
    """

    def __init__(
        self,
        length: int = 32,
        hw: tuple[int, int] = (64, 96),
        max_disp: int = 16,
        seed: int = 0,
        style: str = "smooth",
    ):
        if style not in ("smooth", "edges"):
            raise ValueError(f"style must be smooth|edges: {style!r}")
        self.length = length
        self.hw = hw
        self.max_disp = max_disp
        self.seed = seed
        self.style = style

    def __len__(self):
        return self.length

    def __getitem__(self, idx: int) -> dict[str, np.ndarray]:
        h, w = self.hw
        rng = np.random.default_rng((self.seed, idx))
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        disp = np.full((h, w), self.max_disp / 4.0, np.float32)
        for _ in range(4):
            cy, cx = rng.uniform(0, h), rng.uniform(0, w)
            sy, sx = rng.uniform(h / 6, h / 2), rng.uniform(w / 6, w / 2)
            amp = rng.uniform(0, self.max_disp / 3.0)
            disp += amp * np.exp(-(((yy - cy) / sy) ** 2 + ((xx - cx) / sx) ** 2)).astype(np.float32)
        disp = np.clip(disp, 1.0, self.max_disp - 1.0)
        left = rng.random((h, w, 3)).astype(np.float32)
        if self.style == "edges":
            for _ in range(3):
                y0 = int(rng.uniform(0, h * 0.7))
                x0 = int(rng.uniform(0, w * 0.7))
                y1 = y0 + int(rng.uniform(h * 0.15, h * 0.4))
                x1 = x0 + int(rng.uniform(w * 0.15, w * 0.4))
                d_obj = rng.uniform(self.max_disp * 0.5, self.max_disp - 1.0)
                disp[y0:y1, x0:x1] = d_obj
                flat = rng.uniform(0.2, 0.8)
                left[y0:y1, x0:x1] = flat + 0.08 * (left[y0:y1, x0:x1] - left[y0:y1, x0:x1].mean())
            disp = np.clip(disp, 1.0, self.max_disp - 1.0)
            left = np.clip(left, 0.0, 1.0)
        # smooth the texture a bit so matching is learnable
        left = 0.25 * (left + np.roll(left, 1, 0) + np.roll(left, 1, 1) + np.roll(left, -1, 1))
        # left pixel x appears at x - d in the right view
        src = np.clip(xx + disp, 0, w - 1).astype(np.int64)
        right = left[np.arange(h)[:, None], src]
        return {
            "left": left.astype(np.float32),
            "right": right.astype(np.float32),
            "disp": disp,
        }
