"""The accuracy experiments (counterparts of the JAX package's scripts under
scripts/), run on the card through the hand-written kernels:

  - `completion_refinement_ablation`: UNet +- the 2D CSPN trained from
    scratch on synthetic 'edges' frames (and the monocular variant), per
    seed, paired deltas against `no_cspn`;
  - `merge_ablation_artifacts`: the parts of a sweep resumed with
    `--seed-base`, merged into one artifact;
  - `stereo_refinement_ablation`: PSMNet fine-tuned +- the 3D CSPN from a
    shared base (the staged `--loadmodel` protocol);
  - `precision_deltas`: paired 5-run metric deltas of bf16 CSPN inputs,
    the bf16 model and int8 serving on a trained checkpoint.

Each runs as `python -m cspn_tpu_torch.experiments.<module>` on `--device`
(default cuda) and writes one JSON artifact that names the platform and,
on the card, its name and power limit.
"""

from __future__ import annotations

import json
import os

import torch

from cspn_tpu_torch import resolve_device


def platform_fields(device) -> dict:
    """The record's `platform` ('gpu' or 'cpu') and `card`: nvidia-smi's
    name and power limit on a CUDA device, None on the CPU."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return {"platform": "cpu", "card": None}
    from cspn_tpu_torch.utils.card import card_line

    name, _, power = card_line(dev).rpartition(", ")
    return {"platform": "gpu", "card": {"name": name, "power_limit": power}}


def write_json(path: str, rec: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)


def device_arg(args) -> torch.device:
    """`--device`, or the CPU under `--cpu` (the JAX scripts' flag)."""
    return resolve_device("cpu" if getattr(args, "cpu", False) else args.device)
