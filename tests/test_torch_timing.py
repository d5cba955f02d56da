"""The timing drivers (cspn_tpu_torch/timing/) against the JAX package's
timing scripts under scripts/, on the CPU: the derived tables reproduce
the JAX artifacts under result/ from their measured rows (the hybrid
serving policy, the roofline arithmetic, the loader summary), the
roofline arithmetic equals the script's own functions, the fixtures equal
the script's bit for bit, each module's JAX keys are the script's, and
each driver runs end to end at a tiny size and writes an artifact with
those keys.  The card's numbers are in result/torch_h100/."""

import ast
import importlib.util
import json
import os

import jax  # noqa: F401  (the JAX scripts' functions run on the CPU)
import numpy as np
import pytest
import torch

from cspn_tpu_torch.timing import (kernel_roofline, latency_bench, loader_bench, loader_profile,
                                   missing_keys, slope_seconds, stereo_bench, stereo_train_bench,
                                   train_bench)

torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_RESULT = os.path.join(_REPO, "result")
_TIMING = os.path.join(_REPO, "cspn_tpu_torch", "timing")
_MODULES = (latency_bench, train_bench, stereo_bench, stereo_train_bench, kernel_roofline,
            loader_bench, loader_profile)
_HBM_V5E = 819e9  # the JAX script's HBM_GBPS, the rate its artifact was computed at


def _script(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  os.path.join(_REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _artifact(name: str):
    with open(os.path.join(_RESULT, name)) as f:
        return json.load(f)


def _lines(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _schema(obj):
    """The keys of a JSON value as timing/__init__.py:missing_keys reads a
    schema (a list's schema from its first item)."""
    if isinstance(obj, dict):
        return {k: _schema(v) for k, v in obj.items()}
    if isinstance(obj, list) and obj and isinstance(obj[0], dict):
        return [_schema(obj[0])]
    return None


def _printed_keys(script: str, first: str) -> dict:
    """The keys of the dict literal in `script` whose first key is `first`."""
    with open(os.path.join(_REPO, "scripts", f"{script}.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict) and node.keys and getattr(node.keys[0], "value", None) == first:
            return dict.fromkeys(k.value for k in node.keys)
    raise AssertionError(f"no dict starting with {first!r} in scripts/{script}.py")


_ROOFLINE_ROWS = _lines(os.path.join(_RESULT, "kernel_roofline.json"))


# -- the JAX artifacts' derived tables --------------------------------------


def test_hybrid_policy_reproduces_the_jax_artifact():
    rec = _artifact("latency_bench.json")
    assert latency_bench.INT8_FROM == rec["hybrid_policy"]["int8_from"] == 8
    assert latency_bench.hybrid_policy(rec["results"]) == rec["hybrid_policy"]
    # without int8_static rows the int8 buckets take the dynamic path
    rows = [r for r in rec["results"] if r["path"] != "int8_static"]
    got = latency_bench.hybrid_policy(rows)["results"]
    assert [r["path"] for r in got] == ["bf16", "int8", "int8"]
    assert [r["policy_matches_measured_best"] for r in got] == [True, True, True]


def _shape(row: dict) -> list[int]:
    return [int(v) for v in row["shape"].split("x")[:-1]]


@pytest.mark.parametrize("i", range(len(_ROOFLINE_ROWS)))
def test_roofline_arithmetic_reproduces_the_jax_artifact(i):
    """Every derived number of the row from its `us` (or `us_lo` and
    `us_hi`), exactly; `us_per_frame` within what the artifact's rounding of
    `us` to 0.1 us leaves of it (0.05 / n, plus its own rounding to 0.01):
    the script divided the unrounded time (the functions' test below holds
    it exactly)."""
    row = _ROOFLINE_ROWS[i]
    dims = _shape(row)
    if "[decompose]" in row["kernel"]:
        n, h, w = dims
        got = kernel_roofline.decompose(row["us_lo"], row["us_hi"], n, h, w, *row["steps_pair"])
        keys = ("steps_pair", "us_lo", "us_hi", "fixed_us", "per_step_us",
                "compute_fraction_at_24", "per_step_ps_per_px")
    elif row["kernel"].startswith("cspn3d"):
        got = kernel_roofline.roofline_3d(row["us"] * 1e-6, *dims, row["steps"], _HBM_V5E)
        keys = ("us", "min_traffic_MB", "hbm_sol_us", "hbm_sol_fraction", "ps_per_px_step")
    else:
        io = torch.bfloat16 if "bf16io" in row["kernel"] else None
        got = kernel_roofline.roofline_2d(row["us"] * 1e-6, *dims, row["steps"], io, _HBM_V5E)
        keys = ("us", "min_traffic_MB", "hbm_sol_us", "hbm_sol_fraction", "ps_per_px_step")
    assert {k: got[k] for k in keys} == {k: row[k] for k in keys}
    if "us_per_frame" in row:
        assert abs(got["us_per_frame"] - row["us_per_frame"]) <= 0.05 / dims[0] + 0.005 + 1e-9


def test_roofline_arithmetic_matches_the_jax_functions(monkeypatch):
    """The script's probe_2d, probe_3d and decompose_2d with its timing
    replaced by given seconds, against the port's arithmetic at the same
    seconds (its 819 GB/s), at shapes and times the artifact does not hold."""
    jax_mod = _script("kernel_roofline")
    times = iter([123.4567e-6, 98.7654e-6, 311.1e-6, 45.6e-6, 401.2e-6])
    monkeypatch.setattr(jax_mod, "_measure", lambda *a: next(times))
    got, want = [], []
    for io in (None, "bf16"):
        t = 123.4567e-6 if io is None else 98.7654e-6
        want.append(jax_mod.probe_2d(n=3, h=20, w=36, steps=7,
                                     io_dtype=None if io is None else jax.numpy.bfloat16))
        got.append(kernel_roofline.roofline_2d(t, 3, 20, 36, 7, io, _HBM_V5E))
    want.append(jax_mod.probe_3d(n=2, d=4, h=6, w=8, steps=5))
    got.append(kernel_roofline.roofline_3d(311.1e-6, 2, 4, 6, 8, 5, _HBM_V5E))
    for g, wnt in zip(got, want):
        assert {k: g[k] for k in wnt if k in g} == {k: wnt[k] for k in wnt if k in g}
        assert set(wnt) - set(g) == {"kernel", "shape", "steps"}
    dec = jax_mod.decompose_2d(n=2, h=12, w=20)
    assert kernel_roofline.decompose(45.6, 401.2, 2, 12, 20) == {
        k: dec[k] for k in dec if k not in ("kernel", "shape")}


def test_loader_summary_reproduces_the_jax_artifact():
    rec = _artifact("loader_bench.json")
    demand = rec["device_demand_fps"]
    got = loader_bench.summarize(rec["results"], demand["eval_b128"], demand["train_b128"])
    assert got == {k: rec[k] for k in got}
    assert set(got) == {"train_fps_per_worker", "val_fps_per_worker", "workers_to_feed_train",
                        "workers_to_feed_eval"}


def _jax_cfgs() -> list[tuple]:
    """scripts/loader_bench.py's `cfgs` literal, `max(4, cores)` as None."""
    with open(os.path.join(_REPO, "scripts", "loader_bench.py")) as f:
        tree = ast.parse(f.read())
    node = next(n for n in ast.walk(tree)
                if isinstance(n, ast.Assign) and getattr(n.targets[0], "id", None) == "cfgs")
    return [tuple(None if isinstance(e, ast.Call) else e.value for e in t.elts)
            for t in node.value.elts]


@pytest.mark.parametrize("h5,pil", [(True, True), (False, True), (False, False)])
def test_sweep_plan_runs_or_skips_every_jax_row(h5, pil):
    assert list(loader_bench.CFGS) == _jax_cfgs()
    plan, skipped = loader_bench.sweep_plan(loader_bench.CFGS, 2, h5, pil)
    cfgs = [(m, f, s, n, 4 if w is None else w) for m, f, s, n, w in loader_bench.CFGS]
    if h5 and pil:
        assert plan == cfgs and skipped == []
        return
    for m, f, s, n, w in cfgs:
        twin = (m, "img", s, n, w)
        if not n and not pil:
            assert (m, f, s, n, w) not in plan and twin not in plan
            assert any(r["reason"].startswith("PIL") and (r["mode"], r["format"], r["split"],
                       r["native"], r["workers"]) == (m, f, s, n, w) for r in skipped)
        elif f == "hdf5":
            assert twin in plan and any(r["reason"].startswith("h5py") and r["format"] == "hdf5"
                                        and (r["mode"], r["split"], r["native"], r["workers"])
                                        == (m, s, n, w) for r in skipped)
        else:
            assert (m, f, s, n, w) in plan
    assert all(f == "img" for _, f, *_ in plan) and len(set(plan)) == len(plan)
    splits = {(m, s, n) for m, _, s, n, _ in plan}
    assert {("thread", "train", True), ("process", "train", True), ("thread", "val", True),
            ("process", "val", True)} <= splits


def test_fixtures_equal_the_jax_fixtures_bit_for_bit(tmp_path):
    from PIL import Image

    import h5py

    from cspn_tpu_torch.utils.images import read_png

    jax_h5, jax_img = _script("loader_bench").make_fixtures(str(tmp_path / "jax"), 2)
    h5_csv, img_csv = loader_bench.make_fixtures(str(tmp_path / "port"), 2)

    def rows(csv):
        with open(csv) as f:
            return [line.strip().split(",") for line in f.readlines()[1:]]

    def rel(row, side):
        return [os.path.relpath(p, str(tmp_path / side)) for p in row]

    assert [rel(r, "jax") for r in rows(jax_h5)] == [rel(r, "port") for r in rows(h5_csv)]
    assert [rel(r, "jax") for r in rows(jax_img)] == [rel(r, "port") for r in rows(img_csv)]
    for (j,), (p,) in zip(rows(jax_h5), rows(h5_csv)):
        with h5py.File(j) as fj, h5py.File(p) as fp:
            for key in ("rgb", "depth"):
                a, b = np.asarray(fj[key]), np.asarray(fp[key])
                assert a.dtype == b.dtype and np.array_equal(a, b)
    for jr, pr in zip(rows(jax_img), rows(img_csv)):
        for j, p in zip(jr, pr):
            want = np.asarray(Image.open(j))
            assert np.array_equal(np.asarray(Image.open(p)), want)
            assert np.array_equal(read_png(p), want)


def test_fixtures_without_h5py_write_the_same_pngs(tmp_path, monkeypatch):
    h5_csv, img_csv = loader_bench.make_fixtures(str(tmp_path / "with"), 1)
    monkeypatch.setattr(loader_bench, "h5py_available", lambda: False)
    none, img2 = loader_bench.make_fixtures(str(tmp_path / "without"), 1)
    assert h5_csv and none is None and not (tmp_path / "without" / "h5").exists()
    for name in ("00000_rgb.png", "00000_depth.png"):
        assert ((tmp_path / "with" / "img" / name).read_bytes()
                == (tmp_path / "without" / "img" / name).read_bytes())


# -- the JAX scripts' keys ---------------------------------------------------


def test_jax_keys_are_the_jax_scripts_keys():
    assert latency_bench.JAX_KEYS == _schema(_artifact("latency_bench.json"))
    # the train demand is keyed by the batch timing/train_bench measures it at
    # (b16), where the JAX artifact's came from b128 figures
    assert loader_bench.JAX_KEYS == {**_schema(_artifact("loader_bench.json")),
                                     "device_demand_fps": None}
    assert loader_profile.jax_keys("h5") == _schema(_artifact("loader_profile.json"))
    assert stereo_bench.JAX_KEYS == _schema(_lines(os.path.join(_RESULT, "stereo_bench.json"))[0])
    decompose = [r for r in _ROOFLINE_ROWS if "[decompose]" in r["kernel"]]
    probes = [r for r in _ROOFLINE_ROWS if "[decompose]" not in r["kernel"]]
    assert all(_schema(r) == kernel_roofline.JAX_KEYS for r in probes)
    assert all(_schema(r) == kernel_roofline.JAX_DECOMPOSE_KEYS for r in decompose)
    assert train_bench.JAX_KEYS == _printed_keys("train_bench", "metric")
    assert stereo_train_bench.JAX_KEYS == _printed_keys("stereo_train_bench", "metric")


def test_missing_keys_reads_nested_schemas():
    schema = {"a": None, "b": {"c": None}, "rows": [{"x": None, "y": None}]}
    assert missing_keys({"a": 1, "b": {"c": 2}, "rows": [{"x": 1, "y": 2}]}, schema) == []
    assert missing_keys({"b": 3, "rows": [{"x": 1}, {"y": 2}]}, schema) == [
        ".a", ".b", ".rows[0].y", ".rows[1].x"]


# -- each timing module end to end on the CPU ------------------------------


def test_slope_runs_each_chain_once_to_warm_then_each_trial():
    runs = []
    x = torch.zeros(2)

    def chain(reps):
        return lambda: runs.append(reps)

    t, timing = slope_seconds(chain, x, np.random.default_rng(0), 2, 5, 3)
    assert timing == "eager" and np.isfinite(t)
    assert runs == [2, 5] * 4 and float(x.max()) > 0  # x nudged before every run


def _driver_run(name: str, out: str):
    """Each driver through its entry point on the CPU at a tiny size;
    returns (its artifact, the schema each row or the record must hold)."""
    cpu = ["--device", "cpu", "--out", out]
    small = dict(batch=1, h=32, w=48, max_disp=16, steps=2, features=4)
    if name == "latency_bench":
        latency_bench.run(1, 1, "cpu", out, arch="resnet18", hw=(32, 48))
        return json.load(open(out)), latency_bench.JAX_KEYS
    if name == "train_bench":
        train_bench.main(cpu + ["--arch", "resnet18", "--batch", "2", "--chain", "2", "--trials",
                                "1", "--height", "32", "--width", "48", "--dtype", "float32"])
        return json.load(open(out)), train_bench.JAX_KEYS
    if name == "stereo_bench":
        stereo_bench.main(cpu, reps=(1, 2), trials=1, **small)
        return _lines(out), [stereo_bench.JAX_KEYS]
    if name == "stereo_train_bench":
        stereo_train_bench.main(cpu, chain=2, trials=1, **small)
        return _lines(out), [stereo_train_bench.JAX_KEYS]
    if name == "kernel_roofline":
        probes = [(kernel_roofline.probe_2d, {"n": 1, "h": 16, "w": 24}),
                  (kernel_roofline.probe_2d, {"n": 1, "h": 16, "w": 24,
                                              "io_dtype": torch.bfloat16}),
                  (kernel_roofline.probe_3d, {"d": 4, "h": 8, "w": 8}),
                  (kernel_roofline.decompose_2d, {"n": 1, "h": 16, "w": 24})]
        rows = kernel_roofline.run(probes, device="cpu", out=out, reps=(1, 2), trials=1)
        assert _lines(out) == rows
        return rows[:3], [kernel_roofline.JAX_KEYS]
    if name == "loader_bench":
        cfgs = [c for c in loader_bench.CFGS if c[0] == "thread" and c[4] in (1, 2)][:4]
        loader_bench.main(cpu + ["--frames", "4", "--batch", "2", "--device-train-fps", "100"],
                          cfgs=cfgs)
        return json.load(open(out)), loader_bench.JAX_KEYS
    loader_profile.main(cpu + ["--frames", "2", "--reps", "1"])
    return json.load(open(out)), loader_profile.jax_keys("h5")


@pytest.mark.parametrize("name", [m.__name__.rsplit(".", 1)[1] for m in _MODULES])
def test_driver_runs_on_the_cpu_and_writes_the_jax_keys(name, tmp_path):
    rec, schema = _driver_run(name, str(tmp_path / "artifact"))
    assert missing_keys(rec, schema) == []
    for r in rec if isinstance(rec, list) else [rec]:
        assert r["platform"] == "cpu" and r["card"] is None


_CARD_ARTIFACTS = {
    "latency_bench.json": lambda rec: [(rec, latency_bench.JAX_KEYS)],
    "train_bench.json": lambda rec: [(rec, train_bench.JAX_KEYS)],
    "stereo_bench.jsonl": lambda rows: [(r, stereo_bench.JAX_KEYS) for r in rows],
    "stereo_train_bench.jsonl": lambda rows: [(r, stereo_train_bench.JAX_KEYS) for r in rows],
    "kernel_roofline.jsonl": lambda rows: [
        (r, kernel_roofline.JAX_DECOMPOSE_KEYS if "[decompose]" in r["kernel"]
         else kernel_roofline.JAX_KEYS) for r in rows],
    "loader_bench.json": lambda rec: [(rec, loader_bench.JAX_KEYS)],
    "loader_profile.json": lambda rec: [(rec, loader_profile.jax_keys(
        "png" if "decode_png_ms" in rec["stages_ms_per_frame"] else "h5"))],
}


@pytest.mark.parametrize("name", sorted(_CARD_ARTIFACTS))
def test_card_artifacts_hold_the_jax_keys_and_name_the_card(name):
    """The full runs committed under result/torch_h100/: the JAX script's
    keys, the card's name and power limit on every record, and no roofline
    fraction above 1.05."""
    path = os.path.join(_RESULT, "torch_h100", name)
    rec = _lines(path) if name.endswith(".jsonl") else _artifact(os.path.join("torch_h100", name))
    for r, schema in _CARD_ARTIFACTS[name](rec):
        assert missing_keys(r, schema) == []
        assert r["platform"] == "gpu" and set(r["card"]) == {"name", "power_limit"}
        assert r["card"]["power_limit"].endswith(" W")
        for k in ("hbm_sol_fraction", "read_sol_fraction"):
            if k in r:
                assert 0 < r[k] <= 1.05


def test_loader_bench_on_the_cpu_needs_the_cards_train_demand(tmp_path):
    with pytest.raises(SystemExit, match="--device-train-fps"):
        loader_bench.main(["--device", "cpu", "--frames", "1", "--out", str(tmp_path / "a")])
    assert not (tmp_path / "a").exists()


def test_roofline_bounds_are_the_cards_only():
    row = kernel_roofline.roofline_2d(1e-3, 2, 8, 8, 24, torch.bfloat16, None)
    assert row["hbm_sol_us"] is row["read_sol_fraction"] is None
    on_card = kernel_roofline.roofline_2d(1e-6, 2, 8, 8, 24, torch.bfloat16, 3.35e12)
    # bf16 I/O: the work-defined bytes (24 a pixel) below the port's (44 a pixel)
    assert on_card["min_traffic_MB"] * 44 == pytest.approx(on_card["bytes_read_MB"] * 24, rel=0.1)
    assert on_card["hbm_sol_fraction"] < on_card["read_sol_fraction"]


# -- the port's boundaries -----------------------------------------------------


@pytest.mark.parametrize("mod", _MODULES, ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_entry_points_default_to_the_card(mod):
    assert mod.build_parser().parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            mod.main([])


def test_timing_modules_import_no_script_and_carry_no_tpu_figure():
    files = sorted(f for f in os.listdir(_TIMING) if f.endswith(".py"))
    assert len(files) == 8
    for f in files:
        with open(os.path.join(_TIMING, f)) as fh:
            src = fh.read()
        for node in ast.walk(ast.parse(src)):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            assert not [n for n in names if n.split(".")[0] in ("scripts", "jax", "cspn_tpu")], f
        # the JAX scripts' TPU figures: v5e's 819 GB/s and the loader's 1073 / 318 frames/s
        for figure in ("819", "1073", "318", "v5e"):
            assert figure not in src, (f, figure)
