"""Build and load the port's CUDA kernels and its host library.

Each CUDA source in `csrc/` is compiled by `nvcc` for sm_90a into a shared
library with a plain C interface and loaded with ctypes; the host library
(`csrc/host_pipeline.cpp`: the data layer's augmentation, packing and PNG
unfiltering) is compiled the same way by `g++` with `HOST_FLAGS`, the JAX
package's `native/Makefile` flags.  Libraries go into
`cspn_tpu_torch/_build/` (listed in .gitignore), named by a hash of the
source, the shared headers (`csrc/*.cuh`, for the CUDA sources), the
flags and, for the host library, the CPU target they select, so an edited
source is rebuilt at its next use and an unchanged one is reused.  `build()` starts one compiler per missing library, all at once,
and waits for them together; each compiles to a temporary file that
`os.replace` moves into place, so processes that build at once (test
workers, a loader's worker processes) never load half a file.

Nothing here runs at import time: the CPU tests import every module, on
machines without a CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
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
        {"cspn2d_tiled_f32": [_c_void_p] * 7 + [_c_int] * 5 + [_c_void_p],
         "cspn2d_tiled_io": [_c_void_p] * 3 + [_c_int] * 3 + [_c_void_p] * 4 + [_c_int] * 5
                            + [_c_void_p]},
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
    "int8_conv": (
        "int8_conv.cu",
        {"act_absmax": [_c_void_p, ctypes.c_longlong, _c_int, _c_void_p, _c_void_p, _c_void_p],
         "int8_taps": [_c_void_p, _c_void_p, _c_int, _c_int, _c_void_p] + [_c_int] * 13
                      + [_c_void_p],
         "int8_dequant": [_c_void_p, _c_int, _c_void_p, _c_int, _c_int, _c_void_p, _c_int]
                         + [_c_void_p] * 4 + [_c_int, _c_void_p, _c_int, _c_int, _c_int,
                                              _c_void_p]},
    ),
}

HOST_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-pthread", "-Wall")

_c_long, _c_float, _c_u64 = ctypes.c_long, ctypes.c_float, ctypes.c_uint64

# host library name -> (source file, {C function: (argtypes, restype)})
HOST_LIBRARIES: dict[str, tuple[str, dict[str, tuple[list, object]]]] = {
    "host_pipeline": (
        "host_pipeline.cpp",
        {"cspn_count_valid": ([_c_void_p, ctypes.c_int64, _c_float], ctypes.c_int64),
         "cspn_pack_sample": ([_c_void_p, _c_void_p, _c_int, _c_int, _c_float, _c_float, _c_u64,
                               _c_void_p, _c_void_p, _c_int], None),
         "cspn_aug_pack": ([_c_void_p, _c_long, _c_long, _c_long,  # rgb u8 and its strides
                            _c_void_p, _c_long, _c_long,  # depth f32 and its strides
                            _c_int, _c_int, _c_int, _c_int,  # h0, w0, rh, rw
                            _c_float, _c_int, _c_int, _c_int,  # angle, oh, ow, flip
                            _c_void_p, _c_void_p, _c_int,  # jitter ops, factors, count
                            _c_float, _c_int, _c_int, _c_u64,  # inv_scale, n_sample, denom, seed
                            _c_void_p, _c_void_p], _c_int),  # out rgbd, out depth
         "cspn_png_unfilter": ([_c_void_p, _c_int, _c_long, _c_int, _c_void_p], _c_int)},
    ),
}

# seconds each library's compiler ran in the last build() that compiled it
build_seconds: dict[str, float] = {}

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


def find_cxx() -> str:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found; the host library (csrc/host_pipeline.cpp) cannot be built")
    return cxx


@functools.lru_cache(maxsize=None)
def host_target() -> bytes:
    """The target options -march=native selects on this machine (g++ -Q
    --help=target: this CPU's model and features), so that a host library
    built on one machine is not loaded on another (a checkout copied
    between them)."""
    return subprocess.run([find_cxx(), "-march=native", "-Q", "--help=target"],
                          capture_output=True, check=True, timeout=60).stdout


def library_path(name: str) -> Path:
    if name in HOST_LIBRARIES:
        src, flags = (CSRC / HOST_LIBRARIES[name][0]).read_bytes() + host_target(), HOST_FLAGS
    else:
        src = b"".join(p.read_bytes() for p in [CSRC / KERNELS[name][0], *sorted(CSRC.glob("*.cuh"))])
        flags = NVCC_FLAGS
    digest = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def nvcc_command(name: str, out: Path) -> list[str]:
    return [find_nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / KERNELS[name][0])]


def cxx_command(name: str, out: Path) -> list[str]:
    return [find_cxx(), *HOST_FLAGS, "-o", str(out), str(CSRC / HOST_LIBRARIES[name][0])]


def build(names=None) -> dict[str, str]:
    """Compile every library in `names` (default: all, the host library
    and every CUDA kernel) that is not built yet, one compiler each, all
    started together.  Returns {name: compiler output} for the libraries it
    compiled.  Raises if any compile fails, with the compiler's output."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names or [*HOST_LIBRARIES, *KERNELS]:
        out = library_path(name)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = (cxx_command if name in HOST_LIBRARIES else nvcc_command)(name, Path(tmp))
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, out, time.perf_counter())
    logs, failed = {}, {}
    for name, (proc, tmp, out, t0) in procs.items():
        logs[name] = proc.communicate()[0]
        build_seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            failed[name] = f"{name}: {Path(proc.args[0]).name} exited {proc.returncode}\n{logs[name]}"
        else:
            os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    if failed:
        kind = "CUDA kernel" if any(name in KERNELS for name in failed) else "host library"
        raise RuntimeError(f"{kind} build failed:\n" + "\n".join(failed.values()))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        if name in HOST_LIBRARIES:
            signatures = HOST_LIBRARIES[name][1]
        else:  # every CUDA entry point returns a cudaError_t
            signatures = {fn: (argtypes, ctypes.c_int) for fn, argtypes in KERNELS[name][1].items()}
        for fn, (argtypes, restype) in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _loaded[name] = lib
    return lib
