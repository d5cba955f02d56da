"""Build and load the port's CUDA kernels.

Each source in `csrc/` is compiled by `nvcc` for sm_90a into a shared
library with a plain C interface and loaded with ctypes.  Libraries go into
`cspn_tpu_torch/_build/` (listed in .gitignore), named by a hash of the
source, the shared headers (`csrc/*.cuh`) and the flags, so an edited source
is rebuilt at its next use and an unchanged one is reused.  `build()` starts one `nvcc` per missing library,
all at once, and waits for them together.

Nothing here runs at import time: the CPU tests import every module, on
machines without a CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_c_void_p, _c_int = ctypes.c_void_p, ctypes.c_int
_c_int_p = ctypes.POINTER(ctypes.c_int)

# library name -> (source file, {C function: argtypes}); every function
# returns a cudaError_t as int
KERNELS: dict[str, tuple[str, dict[str, list]]] = {
    "cspn2d_fwd": (
        "cspn2d_fwd.cu",
        {"cspn2d_fwd_f32": [_c_void_p] * 7 + [_c_int] * 5 + [_c_void_p]},
    ),
    "cspn2d_bwd": (
        "cspn2d_bwd.cu",
        {"cspn2d_bwd_f32": [_c_void_p] * 12 + [_c_int] * 6 + [_c_void_p]},
    ),
    "cspn3d_fwd": (
        "cspn3d_fwd.cu",
        {**{f"cspn3d_fwd_{t}": [_c_void_p] * 4 + [_c_int] * 10 + [_c_void_p]
            for t in ("f32", "bf16")},
         "cspn3d_device_limits": [_c_int_p] * 2},
    ),
    "cspn3d_bwd": (
        "cspn3d_bwd.cu",
        {f"cspn3d_bwd_{t}": [_c_void_p] * 7 + [_c_int] * 9 + [_c_void_p] for t in ("f32", "bf16")},
    ),
    "d2s": (
        "d2s.cu",
        {fn: [_c_void_p] * 5 + [_c_int] * 6 + [ctypes.c_longlong, _c_int, _c_void_p]
         for fn in ("d2s", "s2d")},
    ),
    "cspn2d_tiled": (
        "cspn2d_tiled.cu",
        {"cspn2d_tiled_f32": [_c_void_p] * 7 + [_c_int] * 5 + [_c_void_p]},
    ),
    "paddle2d": (
        "paddle2d.cu",
        {"paddle2d_f32": [_c_void_p] * 4 + [_c_int] * 6 + [_c_void_p]},
    ),
    "cspn2d_halo_seg": (
        "cspn2d_halo_seg.cu",
        {"cspn2d_halo_seg_f32": [_c_void_p] * 6 + [_c_int] * 4 + [_c_void_p],
         "cspn2d_halo_seg_states_f32": [_c_void_p] * 7 + [_c_int] * 4 + [_c_void_p]},
    ),
    "cspn2d_halo_seg_bwd": (
        "cspn2d_halo_seg_bwd.cu",
        {"cspn2d_halo_seg_bwd_f32": [_c_void_p] * 11 + [_c_int] * 4 + [_c_void_p]},
    ),
    "step_probe": (
        "step_probe.cu",
        {"step_probe": [_c_void_p] * 3 + [_c_int] * 4 + [_c_void_p]},
    ),
}

_loaded: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    src = b"".join(p.read_bytes() for p in [CSRC / KERNELS[name][0], *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def nvcc_command(name: str, out: Path) -> list[str]:
    return [find_nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / KERNELS[name][0])]


def build(names=None) -> dict[str, str]:
    """Compile every library in `names` (default: all) that is not built
    yet, one nvcc each, all started together.  Returns {name: nvcc output}
    for the libraries it compiled.  Raises if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names or KERNELS:
        out = library_path(name)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = nvcc_command(name, Path(tmp))
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{logs[name]}")
        else:
            os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, argtypes in KERNELS[name][1].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[name] = lib
    return lib
