"""The port's serving artifacts (cspn_tpu_torch/export.py) against the JAX
package's (cspn_tpu/export.py), and the kernels' torch custom ops.

A ResNet-18 CSPN-UNet at 64x96 with 3 CSPN steps, its weights the JAX
init, BN statistics calibrated on one seeded batch (eval-mode BN at the
init statistics is numerically meaningless: ROADMAP trap 3) and copied
into JAX's batch_stats, so that both packages serve the same function.
Each mode is exported once per module (`artifacts`).

Tolerances:
  - port artifact against JAX artifact: rtol 1e-4, atol 1e-5 in float64 on
    both sides (the model and its RGBD input in float64, the JAX artifact
    exported and served under jax.enable_x64), as the eval-mode parity
    tests compare full forwards (tests/test_torch_model.py; trap 5).  In
    float32 the two packages' convolutions round apart: 5.3e-5 at outputs
    of ~1, on 0.35% of the values;
  - a reloaded artifact against the port's eager model: 1e-6 relative (the
    graph runs the same ops; measured 0 on the CPU).
On the CPU the ops dispatch to their plain versions when the graph is
traced, so these graphs hold no custom op; tests/test_torch_cuda.py holds
an export on the card to its kernels.
"""

import copy
import dataclasses
import json
import os
import subprocess
import sys
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cspn_tpu import export as jexport
from cspn_tpu.models import unet as junet
from cspn_tpu_torch import config, export
from cspn_tpu_torch.models import convert
from cspn_tpu_torch.ops import cspn_cuda, d2s
from cspn_tpu_torch.train import evaluate
from cspn_tpu_torch.utils import quant

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = (64, 96)
STEPS = 3
RTOL, ATOL = 1e-4, 1e-5
SELF_RTOL = 1e-6
REQUESTS = (1, 3, 5)


def _frames(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((n, *HW, 4)).astype(np.float32)


def _cfg(dtype="float32", act_static=False):
    cfg = config.PRESETS["synthetic_smoke"]
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, cspn_steps=STEPS, dtype=dtype, act_static=act_static))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.fixture(scope="module")
def weights():
    """JAX's init with BN statistics calibrated on the port (momentum 1 over
    one batch) and copied back, and the port's eval model on them."""
    x = _frames(4, seed=0)
    jmodel = junet._make(18, True, cspn_steps=STEPS, cspn_backend="reference")
    v = jax.tree.map(np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(x)))
    model = evaluate.build_model(_cfg(), train=True, device="cpu", seed=None)
    convert.load_jax_variables(model, v)
    evaluate.calibrate_bn_stats(model, torch.from_numpy(x))
    sd = model.state_dict()

    def stats(tree, path=()):
        return {k: stats(c, (*path, k)) if isinstance(c, dict)
                else sd[convert.port_key("batch_stats", (*path, k))].numpy() for k, c in tree.items()}

    v = {"params": v["params"], "batch_stats": stats(v["batch_stats"])}
    return jmodel, v, model


@pytest.fixture(scope="module")
def artifacts(weights, tmp_path_factory):
    """One artifact a mode: {mode: (path, eager model, weights or None)};
    'fixed' (batch 2) and 'symbolic' in float64, for the JAX comparison."""
    _, v, model32 = weights
    folder = tmp_path_factory.mktemp("artifacts")
    model64 = copy.deepcopy(model32).double()
    int8 = {static: evaluate.load_eval_state(_cfg("int8", static), device="cpu", jax_variables=v)
            for static in (False, True)}
    modes = {"fixed": (model64, 2, True), "symbolic": (model64, None, True),
             "float32": (model32, None, True), "no_embed": (model32, None, False),
             "int8": (int8[False], None, True), "int8_static": (int8[True], None, True)}
    out = {}
    for mode, (model, batch, embed) in modes.items():
        path = str(folder / f"{mode}.pt2")
        program = export.export_serving(model, *HW, batch=batch, embed=embed)
        w = None if embed else export.serving_weights(model)
        export.save_artifact(program, path, {"arch": "resnet18", "dtype": "float32",
                                             "cspn_steps": STEPS, "height": HW[0],
                                             "width": HW[1], "batch": batch}, w)
        out[mode] = (path, model, w)
    return out


@pytest.fixture(scope="module")
def loaded(artifacts):
    """Each mode's artifact, loaded once (a load unlifts the whole graph:
    ~10 s for the int8 ones here)."""
    cache = {}

    def load(mode: str) -> export.ServingArtifact:
        if mode not in cache:
            cache[mode] = export.load_artifact(artifacts[mode][0])
        return cache[mode]

    return load


@pytest.fixture(scope="module")
def jax_artifacts(weights, tmp_path_factory):
    jmodel, v, _ = weights
    folder = tmp_path_factory.mktemp("jax_artifacts")
    out = {}
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), v)
        for mode, batch in (("fixed", 2), ("symbolic", None)):
            path = str(folder / f"{mode}.cspn")
            exported = jexport.export_serving(jmodel, v64, *HW, batch=batch,
                                              input_dtype=jnp.float64)
            jexport.save_artifact(exported, path, variables=v64)
            art = jexport.load_artifact(path)
            out[mode] = {n: np.asarray(art.predict(jnp.asarray(_frames(n, 10 + n), jnp.float64)))
                         for n in ((2,) if mode == "fixed" else REQUESTS)}
    return out


@pytest.mark.parametrize("mode", ["fixed", "symbolic"])
def test_artifact_matches_jax_artifact(artifacts, loaded, jax_artifacts, mode):
    art = loaded(mode)
    assert art.meta["input_dtype"] == "float64"
    for n, want in jax_artifacts[mode].items():
        got = art.predict(_frames(n, seed=10 + n))
        assert got.shape == want.shape == (n, *HW) and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode", ["fixed", "symbolic", "float32", "int8", "int8_static"])
def test_reloaded_artifact_equals_the_eager_model(artifacts, loaded, mode):
    _, model, _ = artifacts[mode]
    art = loaded(mode)
    assert art.meta["embedded"] and art.meta["device"] == "cpu"
    assert art.meta["batch"] == (2 if mode == "fixed" else None)
    for n in ((2,) if mode == "fixed" else REQUESTS):
        x = _frames(n, seed=20 + n)
        with torch.no_grad():
            want = model(torch.from_numpy(x).to(art.input_dtype)).numpy()
        assert _rel(art.predict(x), want) <= SELF_RTOL


def test_int8_static_scales_travel_into_the_artifact(artifacts, loaded):
    """The calibrated static scales are in the file (JAX's export drops
    them): the static artifact serves the static model, not the dynamic one."""
    x = _frames(3, seed=30)
    static = loaded("int8_static").predict(x)
    dynamic = loaded("int8").predict(x)
    model = artifacts["int8_static"][1]
    assert all(m.act_max is not None for m in quant.quant_convs(model).values())
    with torch.no_grad():
        want = model(torch.from_numpy(x)).numpy()
    assert _rel(static, want) <= SELF_RTOL
    assert _rel(static, dynamic) > 1e-3  # static scales, not the dynamic ones
    with zipfile.ZipFile(artifacts["int8_static"][0]) as z:
        consts = json.loads(z.read(next(n for n in z.namelist()
                                        if n.endswith("model_constants_config.json"))))
    names = json.dumps(consts)
    assert "act_max" in names and "qcache_0_wq" in names


def test_no_embed_leaves_every_weight_out(artifacts, loaded):
    path, model, weights = artifacts["no_embed"]
    art = loaded("no_embed")
    assert not art.meta["embedded"] and set(art.meta["weights"]) == set(weights)
    with pytest.raises(ValueError, match="no embedded weights"):
        art.predict(_frames(1, seed=40))
    x = torch.from_numpy(_frames(3, seed=41))
    with torch.no_grad():
        want = model(x).numpy()
    assert _rel(art.call(weights, x).numpy(), want) <= SELF_RTOL
    assert os.path.getsize(path) < 0.01 * os.path.getsize(artifacts["float32"][0])
    with zipfile.ZipFile(path) as z:
        stored = [n for n in z.namelist() if "/data/weights/" in n or "/data/constants/" in n]
    assert all(n.endswith("_config.json") for n in stored), stored


def test_call_checks_its_arguments(artifacts, loaded):
    art = loaded("float32")
    x = torch.from_numpy(_frames(1, seed=50))
    with pytest.raises(ValueError, match="takes 1 argument"):
        art.call({}, x)
    with pytest.raises(ValueError, match="takes 1 argument"):
        art.call()
    with pytest.raises(ValueError, match="serves RGBD"):
        art.call(x[..., :3])
    with pytest.raises(ValueError, match="serves RGBD"):
        art.predict(np.zeros((1, 32, 48, 4), np.float32))
    with pytest.raises(ValueError, match="float32 tensors, got torch.float64"):
        art.call(x.double())
    fixed = loaded("fixed")
    with pytest.raises(ValueError, match=r"serves RGBD \[2, "):
        fixed.call(x.double())
    _, _, weights = artifacts["no_embed"]
    bare = loaded("no_embed")
    with pytest.raises(ValueError, match="takes 2 argument"):
        bare.call(x)
    with pytest.raises(ValueError, match="missing"):
        bare.call({k: t for k, t in list(weights.items())[1:]}, x)
    k0 = next(iter(weights))
    with pytest.raises(ValueError, match=k0):
        bare.call(dict(weights, **{k0: weights[k0].double()}), x)


def test_foreign_and_misplaced_files_are_refused(artifacts, tmp_path):
    text = tmp_path / "model.txt"
    text.write_text("not an artifact")
    with pytest.raises(ValueError, match="cspn_tpu_torch.export/1"):
        export.load_artifact(str(text))
    other = tmp_path / "state.pt"  # a zip, but no artifact
    torch.save({"w": torch.zeros(2)}, other)
    with pytest.raises(ValueError, match="cspn_tpu_torch.export/1"):
        export.load_artifact(str(other))
    plain = tmp_path / "plain.pt2"  # a torch.export file without the meta
    torch.export.save(torch.export.export(torch.nn.Linear(2, 2), (torch.zeros(1, 2),)), plain)
    with pytest.raises(ValueError, match="cspn_tpu_torch.export/1"):
        export.load_artifact(str(plain))
    # an artifact whose meta says it was exported on the card
    card = tmp_path / "card.pt2"
    with zipfile.ZipFile(artifacts["no_embed"][0]) as src, zipfile.ZipFile(card, "w") as dst:
        for item in src.infolist():
            data = src.read(item)
            if item.filename.endswith(export.META_FILE):
                data = json.dumps(dict(json.loads(data), device="cuda")).encode()
            dst.writestr(item, data)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="exported on the card"):
            export.load_artifact(str(card))


def test_a_fresh_process_serves_without_the_models(artifacts):
    path, model, _ = artifacts["float32"]
    x = _frames(3, seed=60)
    np.save(os.path.join(os.path.dirname(path), "x.npy"), x)
    code = ("import sys, numpy as np\n"
            "from cspn_tpu_torch.export import load_artifact\n"
            "art = load_artifact(sys.argv[1])\n"
            "np.save(sys.argv[2], art.predict(np.load(sys.argv[3])))\n"
            "assert 'cspn_tpu_torch.models' not in sys.modules, 'the models were imported'\n"
            "assert 'cspn_tpu_torch.config' not in sys.modules, 'the config was imported'\n")
    out = os.path.join(os.path.dirname(path), "served.npy")
    proc = subprocess.run([sys.executable, "-c", code, path, out,
                           os.path.join(os.path.dirname(path), "x.npy")],
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    with torch.no_grad():
        want = model(torch.from_numpy(x)).numpy()
    assert _rel(np.load(out), want) <= SELF_RTOL


class _Ops(torch.nn.Module):
    """The three kernels' ops in one graph: the tiled CSPN, then d2s of its
    output's four copies, then s2d of that (row 10 outside autograd)."""

    def forward(self, g, b, s):
        y = torch.ops.cspn_tpu_torch.cspn2d_tiled(g, b, s, 3, "8sum")[:, None]
        up = torch.ops.cspn_tpu_torch.d2s([y, 2 * y, 3 * y, 4 * y], 2 * y.shape[2] - 1,
                                          2 * y.shape[3])
        return up, torch.ops.cspn_tpu_torch.s2d(up.contiguous(), y.shape[2], y.shape[3], True)


def _op_inputs(n: int, seed: int):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(n, 8, 6, 7, generator=gen), torch.randn(n, 6, 7, generator=gen),
            torch.randn(n, 6, 7, generator=gen).clamp_min(0))


def test_custom_ops_trace_with_a_symbolic_batch(tmp_path):
    """The ops as one node each in a graph with a symbolic batch (their
    fake implementations), served after a save and load by their CPU
    implementations, the plain versions; the launch counters stay 0 (they
    count the CUDA kernels only)."""
    dims = {0: torch.export.Dim("b", min=1, max=64)}
    program = torch.export.export(_Ops(), _op_inputs(2, 0), dynamic_shapes=(dims, dims, dims))
    assert export.op_counts(program) == {"cspn2d_tiled": 1, "d2s": 1, "s2d": 1}
    torch.export.save(program, tmp_path / "ops.pt2")
    module = torch.export.load(tmp_path / "ops.pt2").module()
    before = (cspn_cuda.tiled_launches, d2s.launches, d2s.bwd_launches)
    for n in (1, 3):
        g, b, s = _op_inputs(n, n)
        up, grads = module(g, b, s)
        y = cspn_cuda.cspn_ref.cspn2d_reference(g.movedim(1, -1), b, s, steps=3)[:, None]
        want = d2s.depth_to_space2_ref([y, 2 * y, 3 * y, 4 * y], 11, 14)
        assert torch.equal(up, want)
        full = d2s.space_to_depth2_ref(want, 6, 7)
        assert all(torch.equal(a, w) for a, w in zip(grads, full.chunk(4, 1)))
    assert (cspn_cuda.tiled_launches, d2s.launches, d2s.bwd_launches) == before


@pytest.mark.parametrize("op", ["cspn2d_tiled", "d2s", "s2d"])
def test_opcheck_on_cpu_tensors(op):
    """torch.library.opcheck: schema, fake implementation, autograd
    registration (d2s) and the ops' CPU implementations agree."""
    g, b, s = _op_inputs(2, 1)
    gen = torch.Generator().manual_seed(2)
    cases = {
        "cspn2d_tiled": [(g, b, s, 3, "8sum"), (g, b, None, 2, "8sum_abs")],
        "d2s": [([torch.randn(2, 3, 4, 5, generator=gen, requires_grad=True) for _ in range(4)],
                 7, 9),
                ([torch.randn(2, 12, 4, 5, generator=gen, requires_grad=True)], 8, 10)],
        "s2d": [(torch.randn(2, 3, 7, 9, generator=gen), 4, 5, True),
                (torch.randn(2, 3, 8, 10, generator=gen), 4, 5, False)],
    }
    for args in cases[op]:
        torch.library.opcheck(getattr(torch.ops.cspn_tpu_torch, op), args)


def test_cli_export_check_runs_on_the_cpu(tmp_path):
    """`python -m cspn_tpu_torch export` at int8 with static scales and
    without the weights: --check reloads the file and serves it with the
    caller's weights."""
    out = tmp_path / "m.pt2"
    proc = subprocess.run(
        [sys.executable, "-m", "cspn_tpu_torch", "export", "--preset", "synthetic_smoke",
         "--dataset", "synthetic", "--device", "cpu", "--cspn-step", "2", "--best-model-dir",
         str(tmp_path), "--dtype", "int8", "--act-static", "--no-embed", "--batch", "3",
         "--out", str(out), "--check"],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "roundtrip check max|err| = 0.000e+00" in proc.stdout, proc.stdout
    meta = export.read_meta(str(out))
    assert (meta["dtype"], meta["batch"], meta["embedded"]) == ("int8", 3, False)
    assert any(k.endswith("act_max") for k in meta["weights"])
    assert any(".qcache_0_wq" in k for k in meta["weights"])
