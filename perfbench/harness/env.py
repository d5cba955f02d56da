"""The run's environment: cache directories inside the checkout, the check
that nothing of JAX or the JAX package is loaded, the device and its peaks."""

from __future__ import annotations

import os
import sys

# Top-level module names a run may not hold: JAX and the JAX package the
# program was ported from.  Compared whole: the program `cspn_tpu_torch`
# begins with `cspn_tpu` and is not one of them.
FORBIDDEN = ("jax", "jaxlib", "flax", "cspn_tpu")

# NVIDIA's data sheets, dense rates at the full power limit (700 W for the
# SXM part): (name substring, HBM bytes/s, bf16 tensor FLOP/s, IEEE float32
# FLOP/s outside the tensor cores); first match wins.
PEAKS = (
    ("H100 PCIe", 2.0e12, 756e12, 51e12),
    ("H100 NVL", 3.9e12, 835e12, 60e12),
    ("H100", 3.35e12, 989e12, 67e12),
)


def set_cache_dirs(root) -> None:
    """Every build and kernel cache at a fixed path inside the checkout, set
    before torch is imported.  The program's own nvcc libraries live in
    cspn_tpu_torch/_build/ inside the checkout already."""
    cache = os.path.join(str(root), ".perfbench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(cache, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules(modules=None) -> list[str]:
    """The loaded top-level module names that are in FORBIDDEN."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def peaks(device_name: str) -> dict:
    for key, hbm, bf16, fp32 in PEAKS:
        if key in device_name:
            return {"hbm_bytes_per_s": hbm, "bf16_flops": bf16, "fp32_flops": fp32}
    raise RuntimeError(f"no published peaks for {device_name!r}")


def device_fields(torch, device) -> dict:
    return {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "count": 1,
        "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))
        if device.type == "cuda" else 0,
    }


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)
