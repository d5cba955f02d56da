"""A cell of BENCHMARK.json and the files it names, found by name:

    perfbench/configs/<config>.json     the configuration as it is run
    perfbench/traffic/<traffic>.json    the traffic mix's parameters
    perfbench/work/<config>.json        frozen operation and byte counts
    perfbench/limits/<workload>.json    the limits of the output check
    perfbench/metrics/<metric>.py       one reader a per-layer metric
    perfbench/drivers/<kind>.py         the loop of a traffic kind
    perfbench/systems/<system>.py       the program's and the reference's side
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

PERFBENCH = pathlib.Path(__file__).resolve().parent.parent
ROOT = PERFBENCH.parent


def load_json(path: pathlib.Path) -> dict:
    return json.loads(path.read_text())


def load_module(path: pathlib.Path, name: str):
    """The Python file `path` as a module (file names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    work: dict
    limits: dict
    end_to_end: list  # the BENCHMARK.json entries this cell reports
    per_layer: list


def _reports(metric: dict, cell: str, e2e_names: set | None = None) -> bool:
    """An end-to-end metric (e2e_names None) without `workloads` is every
    cell's; a per-layer one without it is every cell's that reports the
    end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_names is None or metric["moves"] in e2e_names


def load_cell(name: str, bench: dict | None = None, root: pathlib.Path = ROOT) -> Cell:
    bench = bench if bench is not None else load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    pb = root / "perfbench"
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, e2e_names)]
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=load_json(root / conf["file"]),
        traffic=load_json(pb / "traffic" / f"{w['traffic']}.json"),
        work=load_json(pb / "work" / f"{w['config']}.json"),
        limits=load_json(pb / "limits" / f"{name}.json"),
        end_to_end=e2e,
        per_layer=per_layer,
    )


def reader(metric: str, root: pathlib.Path = ROOT):
    """The `read(readings)` function of perfbench/metrics/<metric>.py."""
    return load_module(root / "perfbench" / "metrics" / f"{metric}.py",
                       f"perfbench_metric_{metric.replace('.', '_')}").read


def driver(kind: str, root: pathlib.Path = ROOT):
    return load_module(root / "perfbench" / "drivers" / f"{kind}.py", f"perfbench_driver_{kind}")


def system(name: str, root: pathlib.Path = ROOT):
    return load_module(root / "perfbench" / "systems" / f"{name}.py", f"perfbench_system_{name}")
