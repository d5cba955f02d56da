"""The accuracy experiments (cspn_tpu_torch/experiments/) against the JAX
package's scripts under scripts/, on the CPU at small sizes: the
statistics and artifacts against the scripts' own functions on the same
random per-seed and per-run dicts (the scripts loaded by path; the merge
script run as a subprocess), the arms and the precision variants' settings,
the completion data and loaders bit for bit, a short completion arm, and
the stereo protocol's restore of the base as it was after pretraining.
The sweeps' numbers on the card are in result/torch_h100/."""

import ast
import importlib.util
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from cspn_tpu_torch.experiments import completion_refinement_ablation as comp
from cspn_tpu_torch.experiments import merge_ablation_artifacts, platform_fields
from cspn_tpu_torch.experiments import precision_deltas as prec
from cspn_tpu_torch.experiments import stereo_refinement_ablation as stereo
from cspn_tpu_torch.train.metrics import METRIC_KEYS

torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SCRIPTS = os.path.join(_REPO, "scripts")
# the keys an artifact of the port may hold apart from the JAX script's
_OWN_KEYS = ("what", "platform", "card")


def _script(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  os.path.join(_SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _shared(rec: dict) -> dict:
    return {k: v for k, v in rec.items() if k not in _OWN_KEYS}


def _per_seed(rng, arms, keys, n):
    return {arm: [{k: round(float(rng.uniform(0.0, 2.0)), 4) for k in keys} for _ in range(n)]
            for arm in arms}


def _completion_args(**kw):
    args = comp.parse_args(["--device", "cpu"])
    for k, v in kw.items():
        setattr(args, k, v)
    return args


# -- statistics and artifacts ------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 5])
def test_paired_deltas_match_jax(n):
    jax_mod = _script("completion_refinement_ablation")
    per_seed = _per_seed(np.random.default_rng(n), comp.ARMS, comp.REPORT_KEYS, n)
    assert comp.paired_deltas(per_seed) == jax_mod.paired_deltas(per_seed)


def test_completion_record_matches_jax_write(tmp_path):
    jax_mod = _script("completion_refinement_ablation")
    per_seed = _per_seed(np.random.default_rng(7), comp.ARMS, comp.REPORT_KEYS, 3)
    args = _completion_args(epochs=30, style="edges_mono", n_sample=0,
                            out=str(tmp_path / "jax.json"))
    jax_mod._write(args, per_seed, 3)
    with open(args.out) as f:
        want = json.load(f)
    got = comp.record(args, per_seed, 3, "cpu")
    assert got["platform"] == "cpu" and got["card"] is None
    assert _shared(got) == _shared(want)
    assert list(_shared(got)) == list(_shared(want))


def test_merge_matches_jax_merge_script(tmp_path):
    rng = np.random.default_rng(11)
    args = _completion_args(epochs=30)
    parts = []
    for i, n in enumerate((2, 3)):
        parts.append(str(tmp_path / f"part{i}.json"))
        with open(parts[-1], "w") as f:
            json.dump(comp.record(args, _per_seed(rng, comp.ARMS, comp.REPORT_KEYS, n), n, "cpu"),
                      f, indent=1)
    want_path = str(tmp_path / "jax_merged.json")
    subprocess.run([sys.executable, os.path.join(_SCRIPTS, "merge_ablation_artifacts.py"),
                    want_path, *parts], check=True, capture_output=True, timeout=120)
    got = merge_ablation_artifacts.merge(str(tmp_path / "merged.json"), parts)
    with open(want_path) as f:
        want = json.load(f)
    assert got == want and list(got) == list(want)
    assert got["config"]["seeds"] == 5 and all(len(r) == 5 for r in got["per_seed"].values())
    with open(tmp_path / "merged.json") as f:
        assert json.load(f) == want


def _stereo_per_seed(rng, n):
    return {arm: [{k: float(rng.uniform(0.0, 5.0)) for k in stereo.METRICS} for _ in range(n)]
            for arm in ("no_cspn", "cspn")}


@pytest.mark.parametrize("n", [1, 5])
def test_stereo_record_matches_jax_write(tmp_path, n):
    jax_mod = _script("stereo_refinement_ablation")
    per_seed = _stereo_per_seed(np.random.default_rng(n), n)
    args = stereo.parse_args(["--height", "128", "--width", "192", "--max-disp", "64",
                              "--features", "32", "--prop-step", "8", "--pretrain-epochs", "16",
                              "--finetune-epochs", "16", "--train-size", "256",
                              "--out", str(tmp_path / "jax.json")])
    jax_mod._write(args, per_seed, n)
    with open(args.out) as f:
        want = json.load(f)
    got = stereo.record(args, per_seed, n, "cpu")
    assert _shared(got) == _shared(want) and list(_shared(got)) == list(_shared(want))
    # the population std (ddof=0), as np.std in the JAX script
    d = [a["EPE"] - b["EPE"] for a, b in zip(per_seed["no_cspn"], per_seed["cspn"])]
    assert got["paired_improvement"]["EPE"]["std"] == round(float(np.std(d, ddof=0)), 4)


def _fake_evals(rng):
    """run_eval stand-ins for both packages: 5 random per-run dicts a
    variant, keyed by the settings the config asks for, so that the two
    packages see the same numbers only for the same settings."""
    table, asked = {}, {"jax": [], "port": []}

    def make(side):
        def run_eval(cfg, runs=5, **_):
            m = cfg.model
            key = (m.dtype, tuple(m.quant_exclude), bool(m.act_static), m.cspn_io_dtype)
            asked[side].append(key)
            if key not in table:
                table[key] = [{k: float(rng.uniform(0.01, 3.0)) for k in METRIC_KEYS}
                              for _ in range(runs)]
            rs = table[key]
            return {"runs": rs, "mean": {k: float(np.mean([r[k] for r in rs])) for k in rs[0]}}

        return run_eval

    return make, asked


def _jax_precision(monkeypatch, tmp_path, run_eval):
    import cspn_tpu.train.evaluate as jax_evaluate

    monkeypatch.setattr(jax_evaluate, "run_eval", run_eval)
    monkeypatch.setattr(sys, "argv", ["bf16_io_eval.py", "--out", str(tmp_path / "bf16.json")])
    _script("bf16_io_eval").main()
    with open(tmp_path / "bf16.json") as f:
        bf16 = json.load(f)
    return bf16, _script("int8_bench").metric_deltas(runs=5)


def test_precision_variants_settings_match_int8_bench_and_bf16_io_eval(monkeypatch, tmp_path):
    """The six variants ask run_eval for the settings the JAX scripts ask
    for (bf16_io_eval.py: cspn_io_dtype None / bfloat16; int8_bench.py:84-89:
    dtype, quant_exclude, act_static), on the same preset."""
    from cspn_tpu.config import PRESETS as JAX_PRESETS

    from cspn_tpu_torch.config import PRESETS

    make, asked = _fake_evals(np.random.default_rng(0))
    _jax_precision(monkeypatch, tmp_path, make("jax"))
    prec.run(PRESETS["synthetic_smoke"], runs=5, eval_fn=make("port"))
    assert asked["port"] == asked["jax"] and len(set(asked["port"])) == 6
    jax_base, base = JAX_PRESETS["synthetic_smoke"], PRESETS["synthetic_smoke"]
    for part in ("model", "data", "optim"):
        want = vars(getattr(jax_base, part))
        got = vars(getattr(base, part))
        assert {k: got[k] for k in want if k in got} == {k: v for k, v in want.items() if k in got}


def test_precision_deltas_match_jax_scripts(monkeypatch, tmp_path):
    from cspn_tpu_torch.config import PRESETS

    make, _ = _fake_evals(np.random.default_rng(1))
    bf16, int8 = _jax_precision(monkeypatch, tmp_path, make("jax"))
    got = prec.run(PRESETS["synthetic_smoke"], runs=5, eval_fn=make("port"))
    assert got["bf16_io"]["means"] == bf16["means"]
    assert got["bf16_io"]["paired_deltas_bf16io_vs_f32io"] == bf16["paired_deltas_bf16io_vs_f32io"]
    assert got["dtype_eval"] == int8
    assert got["rmse_delta"] == round(int8["int8"]["RMSE"] - int8["bfloat16"]["RMSE"], 5)
    assert got["irmse_delta"] == round(int8["int8"]["iRMSE"] - int8["bfloat16"]["iRMSE"], 5)
    assert set(got["per_run"]) == {"f32_io", "bf16_io", *prec.DTYPE_VARIANTS}


# -- arms, arguments, data ---------------------------------------------------


def _jax_defaults(name: str) -> dict:
    """{dest: default} of the `ap.add_argument` calls in a JAX script's main."""
    tree = ast.parse(open(os.path.join(_SCRIPTS, f"{name}.py")).read())
    out = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument"
                and isinstance(node.args[0], ast.Constant)):
            dest = node.args[0].value.lstrip("-").replace("-", "_")
            kw = {k.arg: k.value for k in node.keywords}
            if "default" in kw:
                out[dest] = ast.literal_eval(kw["default"])
            elif isinstance(kw.get("action"), ast.Constant) and kw["action"].value == "store_true":
                out[dest] = False
    return out


@pytest.mark.parametrize("name,mod", [("completion_refinement_ablation", comp),
                                      ("stereo_refinement_ablation", stereo)])
def test_arguments_and_defaults_match_the_jax_script(name, mod):
    want = _jax_defaults(name)
    got = vars(mod.build_parser().parse_args([]))
    for dest, default in want.items():
        if dest == "out":  # a new path: the JAX artifact is never overwritten
            assert got[dest] == os.path.join("result", "torch_h100", os.path.basename(default))
        else:
            assert got[dest] == default, dest
    assert got["device"] == "cuda" and got["cpu"] is False


def test_arms_and_small_config_match_the_jax_script():
    jax_mod = _script("completion_refinement_ablation")
    assert comp.ARMS == jax_mod.ARMS and comp.REPORT_KEYS == jax_mod.REPORT_KEYS
    from cspn_tpu.config import ModelConfig as JaxModelConfig

    args = comp.parse_args(["--small"])
    assert ((args.height, args.width, args.prop_step, args.train_size, args.val_size,
             args.batch_size) == (64, 96, 12, 32, 16, 4))
    for arm in comp.ARMS:
        cfg = comp.arm_config(args, arm, "unused")
        want = vars(JaxModelConfig(arch=args.arch, cspn_steps=args.prop_step, **jax_mod.ARMS[arm]))
        got = vars(cfg.model)
        assert {k: got[k] for k in want} == want
        assert (cfg.data.dataset, cfg.data.n_sample, cfg.data.batch_size_train) == (
            "synthetic", args.n_sample, args.batch_size)
        assert cfg.optim.num_epochs == args.epochs and cfg.log_every == 1000


@pytest.mark.parametrize("style,n_sample", [("edges", 500), ("edges_mono", 0)])
def test_seed_data_and_first_batch_match_jax(style, n_sample):
    """Seed 1 at 64x96: the val frames and the first shuffled training batch
    equal the JAX script's datasets through its DataLoader, bit for bit."""
    from cspn_tpu.data import DataLoader as JaxDataLoader
    from cspn_tpu.data.datasets import SyntheticDepthDataset as JaxSynthetic

    args = comp.parse_args(["--small", "--style", style, "--n-sample", str(n_sample)])
    train, val = comp.seed_data(args, 1)

    def jax_ds(length, seed):
        return JaxSynthetic(length=length, hw=(args.height, args.width), n_sample=args.n_sample,
                            seed=seed, style=style)

    jax_val = jax_ds(args.val_size, 101)
    assert len(val) == len(jax_val) == args.val_size
    for i in range(len(val)):
        for k in ("rgbd", "depth"):
            np.testing.assert_array_equal(val[i][k], jax_val[i][k])
    train_loader, val_loader = comp.loaders(args, (train, val))
    want = next(iter(JaxDataLoader(jax_ds(args.train_size, 100), args.batch_size, shuffle=True,
                                   drop_last=True)))
    got = next(iter(train_loader))
    for k in ("rgbd", "depth"):
        np.testing.assert_array_equal(got[k], want[k])
    assert len(list(train_loader)) == args.train_size // args.batch_size
    assert val_loader.batch_size == min(args.batch_size, args.val_size)


# -- runs --------------------------------------------------------------------


def test_run_arm_picks_the_best_epoch_and_leaves_nothing(tmp_path, monkeypatch):
    from cspn_tpu_torch.train import checkpoint

    saves = []
    monkeypatch.setattr(checkpoint.CheckpointManager, "_save",
                        lambda self, tree, name: saves.append(name))
    root = tmp_path / "root"
    root.mkdir()
    args = _completion_args(height=32, width=48, prop_step=2, train_size=8, val_size=4,
                            batch_size=4, epochs=2)
    run = comp.run_arm(args, "cspn", 0, device="cpu", save_root=str(root))
    assert len(run.history) == 2 and not saves and os.listdir(root) == []
    rmses = [h["val"]["RMSE"] for h in run.history]
    best = run.history[int(np.argmin(rmses))]["val"]
    assert run.best == {k: round(best[k], 4) for k in comp.REPORT_KEYS}
    assert all(np.isfinite(h["train_loss"]) for h in run.history)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flat(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def _jax_restored_names(args) -> set:
    """Port names of the leaves the JAX script's partial_restore copies from
    a no-CSPN base into the CSPN model (through the converter's name map):
    the leaves of its output that are the source's, on the two models'
    abstract variables (jax.eval_shape of their init)."""
    import jax.numpy as jnp

    from cspn_tpu.train.state import partial_restore
    from cspn_tpu.train.stereo_loop import StereoConfig, build_stereo_model

    from cspn_tpu_torch.models.convert import port_key

    x = jax.ShapeDtypeStruct((1, args.height, args.width, 3), jnp.float32)
    variables = {}
    for use_cspn in (False, True):
        cfg = StereoConfig(max_disp=args.max_disp, features=args.features,
                           cspn_steps=args.prop_step, use_cspn=use_cspn)
        variables[use_cspn] = jax.eval_shape(build_stereo_model(cfg, True).init,
                                             jax.random.PRNGKey(0), x, x)
    names = set()
    for collection in ("params", "batch_stats"):
        source = dict(_flat(variables[False][collection]))
        out = partial_restore(variables[True][collection], variables[False][collection])
        names |= {port_key(collection, path) for path, leaf in _flat(out)
                  if source.get(path) is leaf}
    return names


def test_stereo_arm_b_starts_from_the_base_as_pretrained():
    """The trap: arm A's SGD updates the base in place, so arm B must take
    the state of the end of pretraining, not of the end of arm A; and it
    takes every tensor but the guidance head's, as the JAX script's
    partial_restore copies them."""
    args = stereo.parse_args(["--device", "cpu", "--pretrain-epochs", "1", "--finetune-epochs",
                              "1", "--height", "32", "--width", "48", "--max-disp", "16",
                              "--features", "4", "--prop-step", "2", "--train-size", "8"])
    seen = {}

    def observe(stage, trainer):
        seen[stage] = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
        if stage == "restored":
            seen["names"] = trainer.restored

    a, b = stereo.run_seed(args, 0, "cpu", observe=observe)
    assert all(np.isfinite(v) for r in (a, b) for v in r.values())
    pretrained, after_a, restored = seen["pretrained"], seen["arm_a"], seen["restored"]
    names = seen["names"]
    assert names and set(names) == {k for k in restored if stereo.HEAD not in k}
    moved = [k for k in names if not torch.equal(after_a[k], pretrained[k])]
    assert moved, "arm A trained nothing: the check below would prove nothing"
    for k in names:
        torch.testing.assert_close(restored[k], pretrained[k], rtol=0, atol=0)
    assert set(names) - {k for k in names if k.endswith("num_batches_tracked")} == \
        _jax_restored_names(args)


# -- entry points ------------------------------------------------------------


@pytest.mark.parametrize("mod,argv", [(comp, ["--small"]), (stereo, []),
                                      (prec, ["--best-model-dir", "."])])
def test_entry_points_default_to_the_card(mod, argv):
    assert mod.build_parser().parse_args(argv).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            mod.main(argv)


def test_platform_fields_on_the_cpu():
    assert platform_fields("cpu") == {"platform": "cpu", "card": None}
