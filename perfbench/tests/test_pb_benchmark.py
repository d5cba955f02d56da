"""BENCHMARK.json against the benchmark's contract, and every file it names."""

import json
import re

import pytest

from perfbench.harness import cell as cells

BENCH = json.loads((cells.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E = {m["name"] for m in BENCH["end_to_end"]}
WIDTHS = ("hidden", "intermediate", "latent", "state", "width", "head", "expansion", "_dim",
          "_rank", "channel")


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len((cells.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


def test_run_seconds_fit_a_full_check_of_24_cells():
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_lines():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for x in BENCH["configs"] + BENCH["workloads"]:
        assert _line(x["why"])
    for m in BENCH["per_layer"]:
        assert _line(m["layer"])


def test_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and c["file"].startswith("perfbench/")
        assert c["file"] not in files
        files.add(c["file"])
        conf = json.loads((cells.ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]
        for key in c["reduced"]:  # a cut of scale, never of a width
            assert key in conf and not any(w in key for w in WIDTHS), key
        assert _line(c["source"])


def test_metrics():
    assert "setup_s" in E2E
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in E2E
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_and_its_files(name):
    w = {x["name"]: x for x in BENCH["workloads"]}[name]
    assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
    cell = cells.load_cell(name)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e
        assert callable(cells.reader(m["name"]))
    assert callable(cells.driver(cell.traffic["kind"]).run)
    assert cell.limits and all(v.get("limit") is not None for v in cell.limits.values())
    assert (cells.PERFBENCH / "work" / f"{w['config']}.json").exists()


def test_at_most_a_quarter_of_cells_on_four_chips():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(len(BENCH["workloads"]) // 4, 1)
