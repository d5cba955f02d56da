"""Configuration: the port's own copy of cspn_tpu/config.py.

Dataclass configs with named presets mirroring the reference's canonical
runs (train_cspn_nyu.sh:5-16, eval_nyudepth_cspn.sh:10-16) and the BASELINE
configs (BASELINE.json).  Kept field for field with the JAX package so one
preset names the same run in both; fields whose feature is not ported yet
are accepted here and refused where they would be used (see ROADMAP.md):
  1. nyu_eval       -- ResNet50-UNet + 2D CSPN, 24 iters, 500 samples, eval
  2. nyu_train      -- same model, 40-epoch training recipe
  3. kitti_train    -- ResNet18 trunk, 228x912 crops, valid-pixel sampling
  4. nyu_mono       -- monocular (no sparse anchors): n_sample=0
  5. stereo_3d      -- 3D CSPN over a stereo cost volume (paddle demo path)
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class ModelConfig:
    arch: str = "resnet50"  # resnet18|34|50|101|152
    use_cspn: bool = True
    cspn_steps: int = 24
    cspn_norm_type: str = "8sum"  # '8sum' | '8sum_abs'
    cspn_backend: str = "auto"  # 'auto' | 'kernel' | 'reference' (ops/cspn.py)
    dtype: str = "float32"  # 'float32' | 'bfloat16' | 'int8' (serving: the bf16 model, int8 convs)
    # modules kept high-precision under int8 serving (see CSPNUNet.quant_exclude)
    quant_exclude: tuple = ("gud_up_proj_layer4",)
    # int8 serving: static per-site activation scales calibrated at load
    act_static: bool = False
    # opt-in I/O dtype of the CSPN kernel's inputs ('bfloat16': the inputs
    # are rounded through it; arithmetic stays f32)
    cspn_io_dtype: str | None = None


@dataclasses.dataclass
class DataConfig:
    dataset: str = "nyudepth"  # nyudepth | kitti | synthetic
    train_list: str = "data/nyudepth_hdf5/nyudepth_hdf5_train.csv"
    eval_list: str = "data/nyudepth_hdf5/nyudepth_hdf5_val.csv"
    root_dir: str = "."
    # 'hdf5': one-column manifest of per-frame h5 files; 'img': two-column
    # manifest of (rgb, depth) image paths (reference input_format flag,
    # nyu_dataset_loader.py:49-71 / kitti_dataset_loader.py:48-77)
    input_format: str = "hdf5"
    n_sample: int = 500
    batch_size_train: int = 8
    batch_size_eval: int = 1
    num_workers: int = 4
    # 'thread' | 'process' (the JAX package's data/loader.py)
    worker_mode: str = "thread"
    seed: Optional[int] = None
    # geometry overrides (None = dataset default).  crop_hw: output (H, W)
    # (the port's synthetic dataset honours it too); box_crop: pre-crop box
    # (left, right, upper, lower) or () to disable the dataset's default box
    # crop (KITTI benchmark full frames).
    crop_hw: Optional[tuple] = None
    box_crop: Optional[tuple] = None


@dataclasses.dataclass
class OptimConfig:
    lr: float = 0.01
    momentum: float = 0.9
    weight_decay: float = 1e-4
    nesterov: bool = True
    dampening: float = 0.0  # torch SGD dampening (reference train.py:41)
    num_epochs: int = 40
    loss: str = "l1"  # 'l1' | 'berhu'
    # ReduceLROnPlateau on val MAE (reference train.py:283)
    plateau_factor: float = 0.1
    plateau_patience: int = 3
    plateau_min_lr: float = 1e-6
    # gradient all-reduce precision for data-parallel training (None = f32)
    grad_reduce_dtype: Optional[str] = None
    # momentum accumulator storage dtype (None = f32)
    momentum_dtype: Optional[str] = None


@dataclasses.dataclass
class RunConfig:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)
    save_dir: str = "result/base_line"
    best_model_dir: str = "result/base_line"
    resume: bool = False
    pretrained_path: Optional[str] = None  # torch-format .pth for encoder import
    # device mesh: (data, spatial) axis sizes; None = all devices on 'data'
    # (parallel code is not ported yet)
    mesh_data: Optional[int] = None
    mesh_spatial: int = 1
    log_every: int = 500


def _nyu_model():
    return ModelConfig(arch="resnet50")


PRESETS: dict[str, RunConfig] = {}


def _register(name: str, cfg: RunConfig) -> RunConfig:
    PRESETS[name] = cfg
    return cfg


_register(
    "nyu_train",
    RunConfig(
        model=_nyu_model(),
        data=DataConfig(dataset="nyudepth", n_sample=500, batch_size_train=8),
        optim=OptimConfig(num_epochs=40),
        save_dir="result/nyu_cspn_resnet50",
        best_model_dir="result/nyu_cspn_resnet50",
    ),
)

_register(
    "nyu_eval",
    RunConfig(
        model=_nyu_model(),
        data=DataConfig(dataset="nyudepth", n_sample=500, batch_size_eval=1),
        save_dir="result/nyu_cspn_resnet50",
        best_model_dir="result/nyu_cspn_resnet50",
    ),
)

_register(
    "nyu_pos_affinity",
    RunConfig(
        model=ModelConfig(arch="resnet50", cspn_norm_type="8sum_abs"),
        data=DataConfig(dataset="nyudepth", n_sample=500),
        save_dir="result/nyu_cspn_pos",
        best_model_dir="result/nyu_cspn_pos",
    ),
)

_register(
    "kitti_train",
    RunConfig(
        model=ModelConfig(arch="resnet18"),
        data=DataConfig(
            dataset="kitti",
            train_list="data/kitti_hdf5/kitti_hdf5_train.csv",
            eval_list="data/kitti_hdf5/kitti_hdf5_val.csv",
            n_sample=500,
        ),
        optim=OptimConfig(num_epochs=40),
        save_dir="result/kitti_cspn_resnet18",
        best_model_dir="result/kitti_cspn_resnet18",
    ),
)

# KITTI depth-completion benchmark geometry (BASELINE config 3): full
# 352x1216 frames (the benchmark server's padded size), no box pre-crop.
_register(
    "kitti_benchmark",
    RunConfig(
        model=ModelConfig(arch="resnet18"),
        data=DataConfig(
            dataset="kitti",
            train_list="data/kitti_hdf5/kitti_hdf5_train.csv",
            eval_list="data/kitti_hdf5/kitti_hdf5_val.csv",
            n_sample=500,
            batch_size_train=4,
            crop_hw=(352, 1216),
            box_crop=(),
        ),
        optim=OptimConfig(num_epochs=40),
        save_dir="result/kitti_benchmark_cspn",
        best_model_dir="result/kitti_benchmark_cspn",
    ),
)

# monocular depth estimation: no sparse anchors (BASELINE config 4)
_register(
    "nyu_mono",
    RunConfig(
        model=ModelConfig(arch="resnet50"),
        data=DataConfig(dataset="nyudepth", n_sample=0),
        save_dir="result/nyu_mono_cspn",
        best_model_dir="result/nyu_mono_cspn",
    ),
)

_register(
    "synthetic_smoke",
    RunConfig(
        model=ModelConfig(arch="resnet18", cspn_steps=4),
        data=DataConfig(dataset="synthetic", batch_size_train=2, batch_size_eval=2),
        optim=OptimConfig(num_epochs=1),
        save_dir="result/synthetic_smoke",
        best_model_dir="result/synthetic_smoke",
    ),
)
