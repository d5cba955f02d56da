"""Datalist manifest utilities (counterpart of cspn_tpu/data/manifest.py;
reference datalist/*.csv format: header `Name`, one path per row)."""

from __future__ import annotations

import glob
import os


def make_manifest(
    data_dir: str,
    out_csv: str,
    pattern: str = "**/*.h5",
    relative_to: str | None = None,
) -> int:
    """Write a manifest CSV listing every file matching `pattern` under
    `data_dir` (sorted).  Returns the number of rows written."""
    paths = sorted(glob.glob(os.path.join(data_dir, pattern), recursive=True))
    if relative_to:
        paths = [os.path.relpath(p, relative_to) for p in paths]
    with open(out_csv, "w") as f:
        f.write("Name\n")
        for p in paths:
            f.write(p + "\n")
    return len(paths)
