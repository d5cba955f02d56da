"""The card a measurement ran on: nvidia-smi's name and power limit, and
the published peak rates every bound of the port is computed from
(chip_smoke.py's kernel bounds, timing/kernel_roofline.py's rooflines)."""

from __future__ import annotations

import subprocess

import torch

# (name substring, memory bytes/s, f32 non-tensor-core FLOP/s): NVIDIA's data
# sheets, dense rates at the full power limit; first match wins
PEAKS = (
    ("H100 PCIe", 2.0e12, 51e12),
    ("H100 NVL", 3.9e12, 60e12),
    ("H100", 3.35e12, 67e12),
    ("H200", 4.8e12, 67e12),
)


def peaks(name: str) -> tuple[float, float]:
    """(memory bytes/s, f32 FLOP/s) of the card called `name`
    (torch.cuda.get_device_name); raises for a card not in PEAKS."""
    for key, bw, flops in PEAKS:
        if key in name:
            return bw, flops
    raise RuntimeError(f"no published peak rates for {name!r}")


def card_line(device) -> str:
    """nvidia-smi's name and power limit of the card (the CPU: its name)."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[device.index or 0]
