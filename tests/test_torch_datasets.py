"""The port's file datasets and everything under them (cspn_tpu_torch/data/
datasets.py, transforms.py, native.py, manifest.py, utils/images.py's PNG
reader, the host library csrc/host_pipeline.cpp) against the JAX package's
(cspn_tpu/data/, native/libcspn_host.so), on the CPU.

Fixtures as the JAX package's tests write them (tests/test_data.py): NYU
frames at 480x640 as h5 files and as PNG pairs written by PIL (RGB plus a
16-bit depth), KITTI frames at 375x1242 (16-bit depth x256, most pixels
invalid).  Everything is held bit for bit: samples, transforms, the host
library's outputs and decoded pixels; the 5-run eval metrics in float64 to
rtol 1e-6 (the inverse-depth metrics 1e-3: JAX's CSPN stays float32).
"""

import dataclasses
import os
import pathlib
import subprocess
import sys
import zlib

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from cspn_tpu import config as jconfig
from cspn_tpu.data import DataLoader as JDataLoader
from cspn_tpu.data import datasets as jdatasets
from cspn_tpu.data import manifest as jmanifest
from cspn_tpu.data import native as jnative
from cspn_tpu.data import transforms as jT
from cspn_tpu.train import evaluate as jevaluate
from cspn_tpu.train import factory as jfactory
from cspn_tpu_torch import config
from cspn_tpu_torch.cli import main
from cspn_tpu_torch.data import DataLoader, datasets, manifest, native
from cspn_tpu_torch.data import transforms as T
from cspn_tpu_torch.ops import _build
from cspn_tpu_torch.train import evaluate, factory
from cspn_tpu_torch.train.metrics import METRIC_KEYS
from cspn_tpu_torch.utils import images

torch.set_num_threads(1)

_REPO = pathlib.Path(__file__).resolve().parent.parent
NYU_HW, KITTI_HW = (480, 640), (375, 1242)


def _write_csv(path, rows, header):
    path.write_text(header + "\n" + "\n".join(rows) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """{(kind, format): manifest path} for kind nyu / kitti and format hdf5 /
    img, every frame in the manifests of both splits."""
    import h5py

    root = tmp_path_factory.mktemp("frames")
    rng = np.random.default_rng(0)
    out = {}
    for kind, hw, n_h5 in (("nyu", NYU_HW, 4), ("kitti", KITTI_HW, 2)):
        h5_rows, img_rows = [], []
        for i in range(n_h5):
            depth = rng.uniform(0.5, 8.0 if kind == "nyu" else 80.0, hw).astype(np.float32)
            if kind == "kitti":
                depth[rng.random(hw) < 0.6] = 0.0  # sparse ground truth
            p = root / f"{kind}{i}.h5"
            with h5py.File(p, "w") as f:
                f["rgb"] = rng.integers(0, 256, (3, *hw), dtype=np.uint8)
                f["depth"] = depth
            h5_rows.append(str(p))
        for i in range(2):
            rgb = rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
            if kind == "nyu":  # millimetres, the NYU toolbox's convention
                depth = rng.integers(500, 8000, hw).astype(np.uint16)
            else:  # metres x 256, the KITTI devkit's, ~7% valid
                depth = (rng.uniform(1.0, 80.0, hw) * 256).astype(np.uint16)
                depth[rng.random(hw) > 0.07] = 0
            rp, dp = root / f"{kind}{i}_rgb.png", root / f"{kind}{i}_depth.png"
            Image.fromarray(rgb).save(rp)
            Image.fromarray(depth).save(dp)  # 16-bit grey (I;16)
            img_rows.append(f"{rp},{dp}")
        out[kind, "hdf5"] = _write_csv(root / f"{kind}_h5.csv", h5_rows, "Name")
        out[kind, "img"] = _write_csv(root / f"{kind}_img.csv", img_rows, "rgb,depth")
    return out


# --- transforms ---------------------------------------------------------------

def _pil_pair(seed=0, hw=(61, 85)):
    rng = np.random.default_rng(seed)
    rgb = Image.fromarray(rng.integers(0, 256, (*hw, 3), dtype=np.uint8))
    depth = Image.fromarray(rng.uniform(0.1, 10, hw).astype(np.float32), mode="F")
    return rgb, depth


def _jitter(mod):
    return mod.ColorJitter(0.4, 0.3, 0.2, rng=np.random.default_rng(5))


_TRANSFORMS = {
    "Resize": lambda m: m.Resize(40),
    "Resize_up": lambda m: m.Resize(130),
    "Rotation": lambda m: m.Rotation(3.7),
    "Crop": lambda m: m.Crop(5, 70, 3, 50),
    "CenterCrop": lambda m: m.CenterCrop((30, 41)),
    "ColorJitter": _jitter,
    "Compose": lambda m: m.Compose([m.Resize(50), m.Rotation(-4.2), m.CenterCrop((40, 50))]),
    "hflip": lambda m: m.hflip,
}
_ARRAY_TRANSFORMS = {
    "rgb_to_array": lambda m: m.rgb_to_array,
    "depth_to_array": lambda m: m.depth_to_array,
    "Normalize": lambda m: (lambda img: m.Normalize()(np.asarray(img, np.float32) / 255.0)),
    "unnormalize": lambda m: (lambda img: m.unnormalize(np.asarray(img, np.float32) / 255.0)),
    "DepthNormalize": lambda m: (lambda img: m.DepthNormalize(2.0, 3.0)(np.asarray(img))),
    "CenterCropRectangle": lambda m: (lambda img: m.CenterCropRectangle(30, 41)(np.asarray(img))),
    "Scale_bicubic": lambda m: (lambda img: m.Scale(40)(np.asarray(img))),
    "Scale_nearest_hw": lambda m: (lambda img: m.Scale((33, 47), "nearest")(np.asarray(img))),
    "ToPILImage": lambda m: (lambda img: np.asarray(m.ToPILImage()(np.asarray(img)))),
}


_RGB_ONLY = ("ColorJitter", "rgb_to_array", "Normalize", "unnormalize")


@pytest.mark.parametrize("name, which", [
    (name, which) for name in [*_TRANSFORMS, *_ARRAY_TRANSFORMS] for which in ("rgb", "depth")
    if which == "rgb" or name not in _RGB_ONLY])
def test_transform_equals_jax(name, which):
    """Each transform on the same RGB or mode-'F' depth image (and, for
    ColorJitter, the same seeded generator) as JAX's: bit for bit."""
    img = _pil_pair()[which == "depth"]
    table = _TRANSFORMS if name in _TRANSFORMS else _ARRAY_TRANSFORMS
    got, want = table[name](T)(img), table[name](jT)(img)
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want), name


def test_color_jitter_draws_and_ops_equal_jax():
    for a in ((0.4, 0.4, 0.4), (0.4, 0.0, 0.2), (0.0, 0.0, 0.0)):
        for seed in range(4):
            got = T.ColorJitter.draw_params(*a, np.random.default_rng(seed))
            assert got == jT.ColorJitter.draw_params(*a, np.random.default_rng(seed))
    assert (T.ColorJitter.BRIGHTNESS, T.ColorJitter.CONTRAST, T.ColorJitter.SATURATION) == (0, 1, 2)
    assert np.array_equal(T.IMAGENET_MEAN, jT.IMAGENET_MEAN)
    assert np.array_equal(T.IMAGENET_STD, jT.IMAGENET_STD)
    # the integer Scale route (skimage's img_as_float)
    arr = np.random.default_rng(3).integers(0, 65535, (20, 30), dtype=np.uint16)
    assert np.array_equal(T.Scale(10, "bilinear")(arr), jT.Scale(10, "bilinear")(arr))


# --- PNG reader ---------------------------------------------------------------

_PIL_KINDS = {
    "grey": lambda rng: rng.integers(0, 256, (37, 53), dtype=np.uint8),
    "rgb": lambda rng: rng.integers(0, 256, (37, 53, 3), dtype=np.uint8),
    "rgba": lambda rng: rng.integers(0, 256, (37, 53, 4), dtype=np.uint8),
    "grey16": lambda rng: rng.integers(0, 65536, (37, 53), dtype=np.uint16),
}


def _smooth(kind):
    """A smooth image: PIL's encoder then mixes its row filters."""
    yy, xx = np.mgrid[0:37, 0:53]
    planes = [(3 * xx + 2 * yy) % 256, (5 * yy) % 256, (xx + yy) % 256, xx % 256]
    if kind == "grey16":
        return ((xx * 1000 + yy * 37) % 65536).astype(np.uint16)
    n = {"grey": 1, "rgb": 3, "rgba": 4}[kind]
    arr = np.stack(planes[:n], -1).astype(np.uint8)
    return arr[..., 0] if n == 1 else arr


@pytest.mark.parametrize("kind", list(_PIL_KINDS))
@pytest.mark.parametrize("content", ["noise", "smooth"])
def test_read_png_equals_pil_and_jax(tmp_path, kind, content):
    """PIL-written PNGs (PIL picks the row filters): read_png gives PIL's
    pixels; load_img_pair gives JAX's arrays in either role."""
    arr = _PIL_KINDS[kind](np.random.default_rng(1)) if content == "noise" else _smooth(kind)
    path = str(tmp_path / f"{kind}.png")
    Image.fromarray(arr).save(path)
    with Image.open(path) as im:
        want = np.asarray(im)
    got = images.read_png(path)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(images.decode_png(path), want)  # decoded without PIL
    other = str(tmp_path / "other.png")
    Image.fromarray(_PIL_KINDS["rgb"](np.random.default_rng(2))).save(other)
    for rgb_path, depth_path in ((path, other), (other, path)):
        rgb, depth = datasets.load_img_pair(rgb_path, depth_path)
        jrgb, jdepth = jdatasets.load_img_pair(rgb_path, depth_path)
        assert rgb.dtype == np.uint8 and np.array_equal(rgb, np.asarray(jrgb))
        assert depth.dtype == np.float32 and np.array_equal(depth, np.asarray(jdepth))


def _filter_rows(rows: np.ndarray, bpp: int) -> np.ndarray:
    """PNG-filter `rows` [h, stride] uint8, row y with filter y % 5."""
    h, stride = rows.shape
    r = rows.astype(np.int32)
    out = np.zeros((h, stride + 1), np.uint8)
    for y in range(h):
        kind = y % 5
        a = np.concatenate([np.zeros(bpp, np.int32), r[y, :-bpp]])
        b = r[y - 1] if y else np.zeros(stride, np.int32)
        c = np.concatenate([np.zeros(bpp, np.int32), b[:-bpp]])
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = a
        elif kind == 2:
            pred = b
        elif kind == 3:
            pred = (a + b) >> 1
        else:
            p = a + b - c
            pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        out[y, 0] = kind
        out[y, 1:] = (r[y] - pred) & 0xFF
    return out


@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6])
def test_png_unfilter_all_five_filters(tmp_path, bpp):
    """Rows under all five filters: the host library and the plain numpy
    version undo them bit for bit; as a file, read_png and PIL agree."""
    rng = np.random.default_rng(bpp)
    rows = rng.integers(0, 256, (23, 17 * bpp), dtype=np.uint8)
    rows[5:12] = rows[4]  # runs that Up and Paeth predict exactly
    raw = _filter_rows(rows, bpp).ravel()
    assert np.array_equal(native.png_unfilter(raw, 23, 17 * bpp, bpp), rows)
    assert np.array_equal(images._unfilter_plain(raw, 23, 17 * bpp, bpp), rows)
    bad = raw.copy()
    bad[7 * (17 * bpp + 1)] = 5
    with pytest.raises(ValueError, match="row 7 has unknown PNG filter type 5"):
        native.png_unfilter(bad, 23, 17 * bpp, bpp)
    if bpp == 6:  # 16-bit RGB: a format read through PIL
        return
    depth, colour = {1: (8, 0), 2: (16, 0), 3: (8, 2), 4: (8, 6)}[bpp]
    path = tmp_path / "f.png"
    path.write_bytes(images._SIGNATURE + images._chunk(
        b"IHDR", images.struct.pack(">IIBBBBB", 17, 23, depth, colour, 0, 0, 0))
        + images._chunk(b"IDAT", zlib.compress(raw.tobytes())) + images._chunk(b"IEND", b""))
    with Image.open(path) as im:
        want = np.asarray(im)
    assert np.array_equal(images.read_png(str(path)), want)
    expect = rows.view(">u2").astype(np.uint16) if bpp == 2 else rows
    assert np.array_equal(want.reshape(23, -1), expect.reshape(23, -1))


def test_read_png_hands_other_files_to_pil(tmp_path):
    """Palette PNGs and JPEGs decode through PIL, as JAX's load_img_pair reads them."""
    rng = np.random.default_rng(4)
    pal = tmp_path / "p.png"
    Image.fromarray(rng.integers(0, 256, (20, 30, 3), dtype=np.uint8)).convert("P").save(pal)
    jpg = tmp_path / "j.jpg"
    Image.fromarray(rng.integers(0, 256, (20, 30, 3), dtype=np.uint8)).save(jpg)
    for p in (pal, jpg):
        assert images.decode_png(str(p)) is None
        with Image.open(p) as im:
            assert np.array_equal(images.read_png(str(p)), np.asarray(im))
    assert images.describe_image(str(pal)) == "a 8-bit palette PNG"
    assert images.describe_image(str(jpg)) == "a file that is not a PNG"
    for a, b in ((pal, jpg), (jpg, pal)):
        rgb, depth = datasets.load_img_pair(str(a), str(b))
        jrgb, jdepth = jdatasets.load_img_pair(str(a), str(b))
        assert np.array_equal(rgb, np.asarray(jrgb)) and np.array_equal(depth, np.asarray(jdepth))


# --- the host library -----------------------------------------------------------

def _aug_case(name, rng):
    big = (rng.integers(0, 256, (480, 640, 3), np.uint8),
           rng.uniform(0.1, 10, (480, 640)).astype(np.float32))
    small = (rng.integers(0, 256, (64, 80, 3), np.uint8),
             rng.uniform(0.1, 10, (64, 80)).astype(np.float32))
    base = dict(resize_hw=None, angle=0.0, crop_hw=(64, 80), flip=False, jitter=[],
                inv_scale=1.0, n_sample=10, sparse_denom="total", seed=1)
    if name == "resize_down":
        return big, dict(base, resize_hw=(240, 320), crop_hw=(240, 320))
    if name == "resize_up":
        return (small[0][:60], small[1][:60]), dict(base, resize_hw=(120, 160), crop_hw=(120, 160))
    if name.startswith("angle"):
        return small, dict(base, angle=float(name.split("_")[1]))
    if name == "crop_flip":
        odd = (rng.integers(0, 256, (61, 85, 3), np.uint8),
               rng.uniform(0.1, 10, (61, 85)).astype(np.float32))
        return odd, dict(base, crop_hw=(30, 40), flip=True)
    if name.startswith("jitter"):
        orders = {"jitter_b": [(0, 1.3)], "jitter_c": [(1, 0.7)], "jitter_s": [(2, 1.25)],
                  "jitter_scb": [(2, 0.8), (1, 1.2), (0, 0.9)],
                  "jitter_cbs": [(1, 1.35), (0, 0.65), (2, 1.05)]}
        return small, dict(base, jitter=orders[name])
    if name.startswith("denom"):
        depth = rng.uniform(1.0, 10, (200, 300)).astype(np.float32)
        depth[:100] = 0.0
        return ((rng.integers(0, 256, (200, 300, 3), np.uint8), depth),
                dict(base, crop_hw=(200, 300), n_sample=600, sparse_denom=name.split("_")[1]))
    if name == "strided":  # the h5 planar layout and a box-crop slice
        chw = rng.integers(0, 256, (3, 100, 120), np.uint8)
        depth = rng.uniform(0.1, 10, (130, 140)).astype(np.float32)[10:110, 15:135]
        return (chw.transpose(1, 2, 0), depth), dict(
            base, resize_hw=(50, 60), angle=2.0, crop_hw=(40, 50), flip=True,
            jitter=[(0, 1.1), (1, 0.9)], inv_scale=0.7, n_sample=50, sparse_denom="valid", seed=9)
    if name == "crop_too_large":
        return small, dict(base, crop_hw=(65, 80))
    raise KeyError(name)


_AUG = ["resize_down", "resize_up", "angle_3.7", "angle_-4.9", "angle_5.0", "crop_flip",
        "jitter_b", "jitter_c", "jitter_s", "jitter_scb", "jitter_cbs", "denom_total",
        "denom_valid", "strided", "crop_too_large"]


@pytest.mark.parametrize("case", _AUG)
def test_aug_pack_equals_jax_library(case):
    (rgb, depth), kw = _aug_case(case, np.random.default_rng(7))
    got, want = native.aug_pack(rgb, depth, **kw), jnative.aug_pack(rgb, depth, **kw)
    if case == "crop_too_large":  # the library's rc 1, in both
        assert got is None and want is None
        return
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


def test_pack_sample_and_count_valid_equal_jax_library():
    rng = np.random.default_rng(11)
    rgb = rng.integers(0, 256, (228, 304, 3), np.uint8)
    depth = rng.uniform(0.0, 5.0, (228, 304)).astype(np.float32)
    depth[rng.random(depth.shape) < 0.3] = 0.0
    for inv, p, seed, threads in ((1.0, 0.01, 3, 4), (0.71, 0.5, 2**62 + 5, 1), (1.3, 1.0, 0, 8)):
        got = native.pack_sample(rgb, depth, inv, p, seed, num_threads=threads)
        want = jnative.pack_sample(rgb, depth, inv, p, seed, num_threads=threads)
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    for t in (1e-4, 1.0, 4.9):
        assert native.count_valid(depth, t) == jnative.count_valid(depth, t)


def test_host_library_build_failure_raises(monkeypatch):
    """No quiet fallback: a library that does not build raises with g++'s output."""
    monkeypatch.setattr(_build, "HOST_FLAGS", _build.HOST_FLAGS + ("--no-such-flag",))
    monkeypatch.setattr(_build, "_loaded", {})
    with pytest.raises(RuntimeError, match="host library build failed(.|\n)*no-such-flag"):
        native.library()
    assert not _build.library_path(native.LIBRARY).exists()


# --- the file datasets ----------------------------------------------------------

def _assert_same_samples(got_ds, want_ds, indices):
    assert len(got_ds) == len(want_ds)
    for i in indices:
        got, want = got_ds[i], want_ds[i]
        assert set(got) == set(want), i
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, (i, k)
            assert np.array_equal(got[k], want[k]), (i, k)


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("fmt", ["hdf5", "img"])
@pytest.mark.parametrize("kind", ["nyu", "kitti"])
def test_file_dataset_equals_jax(files, kind, fmt, split, use_native):
    mine, theirs = {"nyu": (datasets.NyuDepthDataset, jdatasets.NyuDepthDataset),
                    "kitti": (datasets.KittiDataset, jdatasets.KittiDataset)}[kind]
    kw = dict(split=split, n_sample=500, seed=3, use_native=use_native, input_format=fmt)
    got, want = mine(files[kind, fmt], **kw), theirs(files[kind, fmt], **kw)
    _assert_same_samples(got, want, range(2))
    s = got[0]
    assert s["rgbd"].shape == (*got.crop_hw, 4)
    nz = s["rgbd"][..., 3] != 0
    assert nz.any() and np.array_equal(s["rgbd"][..., 3][nz], s["depth"][nz])


_GEOMETRY = {
    # kitti_benchmark's frames: the centre 352x1216 of the whole frame, no box pre-crop
    "kitti_352x1216": ("kitti", "img", dict(crop_hw=(352, 1216), box_crop=None)),
    "kitti_352x1216_h5": ("kitti", "hdf5", dict(crop_hw=(352, 1216), box_crop=None)),
    # a crop larger than the resized frame: the library refuses it (rc 1) and
    # the sample takes the transforms chain and pack_sample, as in JAX
    "nyu_crop_too_large": ("nyu", "img", dict(crop_hw=(250, 330))),
    "kitti_crop_too_large": ("kitti", "hdf5", dict(crop_hw=(240, 1210))),
    "nyu_raw_rgb": ("nyu", "hdf5", dict(return_raw_rgb=True)),
    "kitti_raw_rgb": ("kitti", "img", dict(return_raw_rgb=True)),
}


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("case", list(_GEOMETRY))
def test_file_dataset_geometry_equals_jax(files, case, split):
    kind, fmt, extra = _GEOMETRY[case]
    mine, theirs = {"nyu": (datasets.NyuDepthDataset, jdatasets.NyuDepthDataset),
                    "kitti": (datasets.KittiDataset, jdatasets.KittiDataset)}[kind]
    kw = dict(split=split, n_sample=500, seed=1, input_format=fmt, **extra)
    _assert_same_samples(mine(files[kind, fmt], **kw), theirs(files[kind, fmt], **kw), range(2))


def test_dataset_refuses_what_jax_refuses(files, tmp_path):
    with pytest.raises(ValueError, match="unsupported input_format"):
        datasets.NyuDepthDataset(files["nyu", "img"], input_format="jpeg")
    one_col = _write_csv(tmp_path / "one.csv", ["a.png"], "Name")
    with pytest.raises(ValueError, match="two-column manifest"):
        datasets.NyuDepthDataset(one_col, input_format="img")[0]
    assert datasets.read_manifest(files["nyu", "hdf5"]) == jdatasets.read_manifest(files["nyu", "hdf5"])
    assert (datasets.read_manifest_rows(files["kitti", "img"])
            == jdatasets.read_manifest_rows(files["kitti", "img"]))


# --- the factory, the loaders, manifests -------------------------------------------

def _cfgs(name, files, fmt):
    kind = "kitti" if name.startswith("kitti") else "nyu"
    out = []
    for mod in (config, jconfig):
        cfg = mod.PRESETS[name]
        out.append(dataclasses.replace(cfg, data=dataclasses.replace(
            cfg.data, train_list=files[kind, fmt], eval_list=files[kind, fmt], input_format=fmt)))
    return out


@pytest.mark.parametrize("preset", ["nyu_train", "nyu_eval", "kitti_train", "kitti_benchmark",
                                    "nyu_mono"])
def test_build_dataset_equals_jax(files, preset):
    for fmt in ("hdf5", "img"):
        cfg, jcfg = _cfgs(preset, files, fmt)
        for split, seed in (("train", 2), ("val", None), ("val", 4)):
            got = factory.build_dataset(cfg, split, seed=seed if seed is not None else 0)
            want = jfactory.build_dataset(jcfg, split, seed=seed if seed is not None else 0)
            assert type(got).__name__ == type(want).__name__
            assert (got.crop_hw, got.box_crop, got.split) == (want.crop_hw, want.box_crop, want.split)
            _assert_same_samples(got, want, [0])
    if preset == "nyu_mono":  # n_sample 0: an all-zero sparse channel
        assert not got[0]["rgbd"][..., 3].any()


@pytest.mark.parametrize("mode", ["thread", "process"])
def test_loader_batches_equal_jax(files, mode):
    """One epoch of shuffled b2 batches (and the val order) over the NYU h5
    frames: the port's loader, thread or process workers, against JAX's."""
    ds = datasets.NyuDepthDataset(files["nyu", "hdf5"], split="train", seed=5)
    jds = jdatasets.NyuDepthDataset(files["nyu", "hdf5"], split="train", seed=5)
    kw = dict(shuffle=True, drop_last=True, num_workers=2, seed=3)
    got = list(DataLoader(ds, 2, worker_mode=mode, **kw))
    want = list(JDataLoader(jds, 2, **kw))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.keys() == w.keys() and all(np.array_equal(g[k], w[k]) for k in w)


def test_make_manifest_equals_jax(files, tmp_path, capsys):
    data_dir = str(pathlib.Path(files["nyu", "img"]).parent)
    for pattern, rel in (("**/*.h5", None), ("*_rgb.png", data_dir)):
        a, b = tmp_path / "port.csv", tmp_path / "jax.csv"
        n = manifest.make_manifest(data_dir, str(a), pattern=pattern, relative_to=rel)
        assert n == jmanifest.make_manifest(data_dir, str(b), pattern=pattern, relative_to=rel) > 0
        assert a.read_text() == b.read_text()
        c = tmp_path / "cli.csv"
        args = ["make-manifest", data_dir, str(c), "--pattern", pattern]
        assert main(args + (["--relative-to", rel] if rel else [])) == 0
        assert c.read_text() == b.read_text()
        assert f"wrote {n} rows to {c}" in capsys.readouterr().out


# --- the entry points on files ------------------------------------------------------

def test_run_eval_on_files_equals_jax_float64(files, tmp_path, monkeypatch):
    """run_eval's 5 runs over the NYU h5 val split, through the DataLoader,
    against JAX's run_eval, both in float64 on the same (converted) weights."""
    cfg, jcfg = _cfgs("nyu_eval", files, "hdf5")
    over = dict(arch="resnet18", cspn_backend="reference")
    cfg = dataclasses.replace(cfg, best_model_dir=str(tmp_path), model=dataclasses.replace(
        cfg.model, **over), data=dataclasses.replace(cfg.data, crop_hw=(48, 64), num_workers=2))
    jcfg = dataclasses.replace(jcfg, best_model_dir=str(tmp_path), model=dataclasses.replace(
        jcfg.model, **over), data=dataclasses.replace(jcfg.data, crop_hw=(48, 64), num_workers=2))

    load, step = jevaluate.load_eval_state, jevaluate.make_eval_step
    loaded = {}

    def load64(*a, **kw):
        model, state, extra = load(*a, **kw)
        loaded["variables"] = jax.tree.map(np.asarray, {"params": state.params,
                                                        "batch_stats": state.batch_stats})
        cast = jax.tree.map(lambda v: jax.numpy.asarray(v, jax.numpy.float64), loaded["variables"])
        return model, state.replace(params=cast["params"], batch_stats=cast["batch_stats"]), extra

    def step64(*a, **kw):
        fn = step(*a, **kw)
        return lambda state, rgbd, depth, extra: fn(state, rgbd.astype(np.float64),
                                                    depth.astype(np.float64), extra)

    monkeypatch.setattr(jevaluate, "load_eval_state", load64)
    monkeypatch.setattr(jevaluate, "make_eval_step", step64)
    with jax.enable_x64(True):
        want = jevaluate.run_eval(jcfg, runs=5)

    port_load, port_step = evaluate.load_eval_state, evaluate.make_eval_step
    monkeypatch.setattr(evaluate, "load_eval_state", lambda *a, **kw: port_load(*a, **kw).double())
    monkeypatch.setattr(evaluate, "make_eval_step", lambda *a, **kw: (
        lambda f: lambda rgbd, depth: f(rgbd.double(), depth.double()))(port_step(*a, **kw)))
    got = evaluate.run_eval(cfg, runs=5, device="cpu", jax_variables=loaded["variables"])
    assert len(got["runs"]) == len(want["runs"]) == 5
    # JAX casts the heads to float32 for its CSPN even under x64
    # (cspn_tpu/models/unet.py:180-192), the port keeps float64: the
    # inverse-depth metrics weight that float32 rounding by 1/pred, where
    # this random model predicts just above the 1e-4 mask threshold (8.9e-5
    # relative measured), every other metric within 1e-6
    for run_got, run_want in zip(got["runs"], want["runs"]):
        for k in METRIC_KEYS:
            rtol = 1e-3 if k in ("iRMSE", "iMAE") else 1e-6
            np.testing.assert_allclose(run_got[k], run_want[k], rtol=rtol, err_msg=k)
    # the runs re-seed the sparse sampler: their metrics differ
    assert len({r["MAE"] for r in got["runs"]}) == 5
    short = evaluate.run_eval(cfg, runs=1, device="cpu", max_batches=2,
                              jax_variables=loaded["variables"])
    assert short["runs"][0]["MAE"] != got["runs"][0]["MAE"]  # 2 of the 4 frames


def test_export_takes_the_val_frames_geometry(files, tmp_path, monkeypatch):
    """`export` without --height/--width on a file preset: the val split's
    first frame's geometry, as JAX's cmd_export reads it (the export itself
    is held to JAX's in tests/test_torch_export.py)."""
    from cspn_tpu_torch import export

    seen = {}
    monkeypatch.setattr(export, "export_serving",
                        lambda model, h, w, **kw: seen.setdefault("hw", (h, w)))
    monkeypatch.setattr(export, "save_artifact",
                        lambda program, path, meta, weights: pathlib.Path(path).write_bytes(b""))
    monkeypatch.setattr(export, "op_counts", lambda program: {})
    for kind, preset in (("nyu", "nyu_eval"), ("kitti", "kitti_train")):
        seen.clear()
        assert main(["export", "--preset", preset, "--model", "resnet18", "--cspn-step", "2",
                     "--eval-list", files[kind, "img"], "--input-format", "img", "--device", "cpu",
                     "--best-model-dir", str(tmp_path), "--out", str(tmp_path / "m.pt2")]) == 0
        _, jcfg = _cfgs(preset, files, "img")
        want = jfactory.build_dataset(jcfg, "val", seed=0)[0]["rgbd"].shape[:2]
        assert seen["hw"] == tuple(want) == {"nyu": (228, 304), "kitti": (228, 912)}[kind]


def test_cli_train_from_png_files(files, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(_REPO))
    cmd = [sys.executable, "-m", "cspn_tpu_torch", "train", "--preset", "nyu_train", "--model",
           "resnet18", "--crop-hw", "48,64", "--input-format", "img", "--num-epoch", "1",
           "--device", "cpu", "--train-list", files["nyu", "img"], "--eval-list",
           files["nyu", "img"], "--batch-size-train", "2", "--cspn-step", "4",
           "--num-workers", "2", "--save-dir", str(tmp_path)]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=300, env=env, cwd=tmp_path)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "epoch 0 done" in r.stdout
    assert (tmp_path / "log_train.txt").exists()


_BLOCKED = """
import importlib.abc, importlib, pkgutil, sys
import numpy as np

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("PIL", "h5py"):
            raise ImportError(f"{name} is blocked")

for m in [m for m in sys.modules if m.split(".")[0] in ("PIL", "h5py")]:
    del sys.modules[m]
sys.meta_path.insert(0, Block())
import cspn_tpu_torch
names = [m.name for m in pkgutil.walk_packages(cspn_tpu_torch.__path__, "cspn_tpu_torch.")
         if m.name != "cspn_tpu_torch.__main__"]
for name in names:
    importlib.import_module(name)
from cspn_tpu_torch.data import NyuDepthDataset
ds = NyuDepthDataset(sys.argv[1], split="train", seed=3, input_format="img")
np.save(sys.argv[2], ds[1]["rgbd"])
for mod in ("PIL", "h5py"):
    assert not any(m.split(".")[0] == mod for m in sys.modules), mod
try:
    NyuDepthDataset(sys.argv[3], split="val", seed=0)[0]
except ImportError as e:
    assert "h5py" in str(e), e
else:
    raise AssertionError("an h5 frame read without h5py")
try:
    NyuDepthDataset(sys.argv[1], split="val", seed=0, input_format="img", use_native=False)[0]
except ImportError as e:
    assert "PIL" in str(e), e
else:
    raise AssertionError("the transforms chain ran without PIL")
from cspn_tpu_torch.utils.images import read_png
try:
    read_png(sys.argv[4])
except ImportError as e:
    assert sys.argv[4] in str(e) and "8-bit palette PNG" in str(e), e
else:
    raise AssertionError("a palette PNG read without PIL")
print("modules", len(names))
"""


def test_port_without_pil_and_h5py(files, tmp_path):
    """With PIL and h5py blocked in the import system: every port module
    imports, and a PNG-backed NYU sample is built through the host library,
    equal to the one built here; the routes that need them raise, a palette
    PNG with the file and its format named."""
    out, palette = tmp_path / "sample.npy", tmp_path / "palette.png"
    Image.fromarray(np.zeros((4, 6, 3), np.uint8)).convert("P").save(palette)
    env = dict(os.environ, PYTHONPATH=str(_REPO))
    r = subprocess.run([sys.executable, "-c", _BLOCKED, files["nyu", "img"], str(out),
                        files["nyu", "hdf5"], str(palette)], capture_output=True, text=True,
                       timeout=300, env=env, cwd=tmp_path)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert int(r.stdout.split("modules")[-1]) > 40
    want = datasets.NyuDepthDataset(files["nyu", "img"], split="train", seed=3,
                                    input_format="img")[1]["rgbd"]
    assert np.array_equal(np.load(out), want)
