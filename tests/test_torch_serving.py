"""The port's serving front-end, eval driver and CLI (cspn_tpu_torch/
serving.py, train/evaluate.py, cli.py) on the CPU, mirroring
tests/test_serving.py, and the eval driver held against the JAX package's
`run_eval` on the same (converted) weights.

The dual-path server (bf16 below `int8_from`, int8 from it up) is held to
the models it routes to, value for value: a bucket runs one model's
forward on the padded batch, and every model here is per-sample (eval-mode
BN, per-sample CSPN, per-sample or static activation scales), so a padded
bucket equals the exact batch to float rounding (rtol 1e-5; bf16 and int8
outputs to 1e-2 of their range, a bf16 ulp of the float32 CSPN's input).
"""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from cspn_tpu import config as jconfig
from cspn_tpu import serving as jserving
from cspn_tpu.train import evaluate as jevaluate
from cspn_tpu_torch import config
from cspn_tpu_torch.cli import main
from cspn_tpu_torch.models import unet
from cspn_tpu_torch.serving import DepthServer, chunk_plan, load_server, pick_bucket
from cspn_tpu_torch.train import evaluate, factory
from cspn_tpu_torch.train.metrics import METRIC_KEYS
from cspn_tpu_torch.utils import quant

torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("buckets", [(1, 8, 32, 128), (4,), (1, 2), (3, 5, 7)])
def test_pick_bucket_and_chunk_plan_match_jax(buckets):
    for n in range(1, 301):
        assert chunk_plan(n, buckets) == jserving.chunk_plan(n, buckets)
        if n <= buckets[-1]:
            assert pick_bucket(n, buckets) == jserving.pick_bucket(n, buckets)
        else:
            with pytest.raises(ValueError):
                pick_bucket(n, buckets)
    with pytest.raises(ValueError):
        chunk_plan(0, buckets)


@pytest.fixture(scope="module")
def tiny_model():
    model = unet.cspn_unet_resnet18(cspn_steps=2, generator=torch.Generator().manual_seed(0))
    return model.eval()


def _frames(n, seed=0):
    return np.random.default_rng(seed).standard_normal((n, 64, 96, 4)).astype(np.float32)


def test_padded_bucket_output_matches_exact_batch(tiny_model):
    # eval-mode BN, CSPN and the convs are per-sample independent, so the
    # zero pad rows are inert
    x = _frames(3)
    srv = DepthServer(tiny_model, buckets=(4,))
    out = srv.predict(x)
    with torch.no_grad():
        ref = tiny_model(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (3, 64, 96)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    assert srv.served == {"bf16": 3, "int8": 0}  # one path: model_bf16 serves every bucket


def test_chunked_request_across_buckets(tiny_model):
    # 6 samples over buckets (1, 4): chunks [4, 2 -> bucket 4]
    x = _frames(6, seed=1)
    srv = DepthServer(tiny_model, buckets=(1, 4))
    out = srv.predict(x)
    with torch.no_grad():
        ref = tiny_model(torch.from_numpy(x)).numpy()
    assert out.shape == (6, 64, 96)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    assert srv.served == {"bf16": 6, "int8": 0}
    srv.warmup(64, 96)
    assert srv.served == {"bf16": 0, "int8": 0}


def test_server_input_validation(tiny_model):
    with pytest.raises(ValueError):
        DepthServer(tiny_model, buckets=(4, 1))
    # routing, as JAX's path_for: int8 from int8_from up, when there is an int8 model
    srv = DepthServer(tiny_model, model_int8=tiny_model, buckets=(1, 8, 32), int8_from=8)
    assert [srv.path_for(b) for b in (1, 7, 8, 32)] == ["bf16", "bf16", "int8", "int8"]
    assert DepthServer(tiny_model, model_int8=tiny_model, int8_from=None).path_for(128) == "bf16"
    assert DepthServer(tiny_model, int8_from=1).path_for(128) == "bf16"
    srv = DepthServer(tiny_model, buckets=(1,))
    with pytest.raises(ValueError):
        srv.predict(np.zeros((2, 64, 96), np.float32))


def test_graphs_are_the_cards_and_a_weight_load_drops_them(tiny_model):
    """On the CPU the server runs eagerly and refuses CUDA graphs; a weight
    load into a served model drops the server's graphs (they hold the old
    tensors' addresses); a replay adds to the launch counters what its
    capture counted (serving.py:add_counters)."""
    from cspn_tpu_torch.ops import d2s
    from cspn_tpu_torch.serving import LAUNCH_COUNTERS, add_counters, read_counters

    srv = DepthServer(tiny_model, buckets=(1, 4), model_int8=tiny_model)
    assert not srv.cuda_graphs and srv._pool is None
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        DepthServer(tiny_model, buckets=(1,), cuda_graphs=True)
    srv.warmup(64, 96)
    assert srv.graphs == {}
    srv.graphs[4, 64, 96] = "captured"
    tiny_model.load_state_dict(tiny_model.state_dict())
    assert srv.graphs == {}
    del srv  # the model's hook holds the server weakly
    tiny_model.load_state_dict(tiny_model.state_dict())
    before = read_counters()
    assert set(before) == set(LAUNCH_COUNTERS)
    add_counters({("cspn_tpu_torch.ops.d2s", "launches"): 9}, 3)
    assert d2s.launches == before["cspn_tpu_torch.ops.d2s", "launches"] + 27
    add_counters({("cspn_tpu_torch.ops.d2s", "launches"): 9}, -3)
    assert read_counters() == before


def _smoke_cfg(tmp_path, steps=2, **data):
    cfg = config.PRESETS["synthetic_smoke"]
    return dataclasses.replace(
        cfg,
        model=dataclasses.replace(cfg.model, cspn_steps=steps),
        data=dataclasses.replace(cfg.data, **data),
        best_model_dir=str(tmp_path),
    )


def test_build_model_refuses_what_is_not_ported(tmp_path):
    """bf16 and int8 build (the int8 model's convs quantized, serving only);
    the entry points still refuse a CPU-only host unless asked for the CPU."""
    cfg = _smoke_cfg(tmp_path)
    for dtype, quantized in (("bfloat16", False), ("int8", True)):
        c = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, dtype=dtype))
        model = evaluate.build_model(c, device="cpu")
        assert model.dtype == torch.bfloat16 and model.quant == quantized
        assert all(p.dtype == torch.float32 for p in model.parameters())  # until load casts them
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            evaluate.build_model(cfg)  # entry points default to the card
    model = evaluate.build_model(cfg, train=True, device="cpu")
    assert model.training and model.cspn_steps == 2


def test_load_server_from_saved_state_dict(tmp_path):
    """Buckets below int8_from only: one bf16 model, the checkpoint's
    weights cast to bf16 at load (load_eval_state at dtype bfloat16), and
    no int8 model built."""
    cfg = _smoke_cfg(tmp_path)
    model = evaluate.build_model(cfg, device="cpu", seed=7)
    torch.save(model.state_dict(), tmp_path / "best_model.pt")
    srv = load_server(cfg, buckets=(1, 2), device="cpu")
    assert srv.models["int8"] is None
    assert all(p.dtype == torch.bfloat16 for p in srv.models["bf16"].parameters())
    x = _frames(3, seed=2)
    out = srv.predict(x)
    bf16 = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, dtype="bfloat16"))
    with torch.no_grad():
        ref = evaluate.load_eval_state(bf16, device="cpu")(torch.from_numpy(x)).numpy()
        ref32 = model(torch.from_numpy(x)).numpy()
    assert np.isfinite(out).all() and srv.served == {"bf16": 3, "int8": 0}
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    assert 0 < np.abs(out - ref32).max() < 0.05 * np.abs(ref32).max()  # bf16, not float32


@pytest.fixture(scope="module")
def dual_server(tmp_path_factory):
    """load_server over a saved ResNet-18 checkpoint at buckets (1, 4) with
    int8 from 4, and the models it should route to."""
    tmp = tmp_path_factory.mktemp("dual")
    cfg = _smoke_cfg(tmp)
    torch.save(evaluate.build_model(cfg, device="cpu", seed=3).state_dict(), tmp / "best_model.pt")
    srv = load_server(cfg, buckets=(1, 4), device="cpu", int8_from=4)
    return cfg, srv


def test_int8_buckets_route_to_the_int8_model(dual_server):
    """An int8 bucket is the int8 model's forward (its weight cache built,
    the same bf16 weights as the bf16 model's); a padded bucket equals the
    exact batch; a request chunks over both paths; warmup is not traffic."""
    cfg, srv = dual_server
    bf16, int8 = srv.models["bf16"], srv.models["int8"]
    assert int8.quant and not bf16.quant and all(m.qcache for m in quant.quant_convs(int8).values())
    assert all(a.data_ptr() == b.data_ptr()  # one copy of the bf16 weights
               for a, b in zip(bf16.state_dict().values(), int8.state_dict().values()))
    x = _frames(6, seed=4)
    with torch.no_grad():
        want8 = int8(torch.from_numpy(x[:4])).numpy()
        want3 = int8(torch.from_numpy(x[4:5].repeat(3, 0))).numpy()  # the pad rows are zeros
        wantb = bf16(torch.from_numpy(x[5:])).numpy()
    np.testing.assert_allclose(srv.predict(x[:4]), want8, rtol=1e-5, atol=1e-5)
    assert srv.served == {"bf16": 0, "int8": 4}
    # 3 frames pad to bucket 4 (int8): each sample equals serving it alone
    got3 = srv.predict(x[:3])
    np.testing.assert_allclose(got3, want8[:3], rtol=1e-5, atol=1e-2 * np.abs(want8).max())
    assert srv.served == {"bf16": 0, "int8": 7}
    # 6 = a top bucket of 4 (int8) + 2 padded to 4 (int8); 5 = 4 + 1 (bf16)
    got = srv.predict(x[:5])
    np.testing.assert_allclose(got[:4], want8, rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        alone = bf16(torch.from_numpy(x[4:5])).numpy()
    np.testing.assert_allclose(got[4:], alone, rtol=1e-5, atol=1e-5)
    assert srv.served == {"bf16": 1, "int8": 11}
    assert np.isfinite(wantb).all() and np.isfinite(want3).all()
    srv.warmup(64, 96)
    assert srv.served == {"bf16": 0, "int8": 0}
    assert 0 < np.abs(want8 - bf16(torch.from_numpy(x[:4])).detach().numpy()).max()  # int8 differs


def test_load_server_act_static(dual_server):
    """act_static calibrates the int8 model's static activation scales on
    the val split's frames at load; the bf16 model is the dynamic server's."""
    cfg, dyn = dual_server
    srv = load_server(cfg, buckets=(1, 4), device="cpu", int8_from=4, act_static=True)
    convs = quant.quant_convs(srv.models["int8"])
    assert convs and all(m.act_max is not None and not m.calibrating for m in convs.values())
    assert all(m.act_max is None for m in quant.quant_convs(dyn.models["int8"]).values())
    ds = factory.build_dataset(cfg, "val", seed=1)  # frames like the calibration's
    x = np.stack([ds[i]["rgbd"] for i in range(4)])
    out, out_dyn = srv.predict(x), dyn.predict(x)
    assert np.isfinite(out).all() and out.shape == (4, 64, 96)
    rel = np.linalg.norm(out - out_dyn) / np.linalg.norm(out_dyn)
    assert 0 < rel < 0.08  # static against dynamic scales: JAX's int8 bound
    # calibrated on one frame, serving it alone: its dynamic per-sample
    # abs-max is the recorded one; the scales still differ by a rounding,
    # the dynamic one taken in the activations' bf16 and the static one in
    # float32, as JAX's quantize_tensor and module_act_scale take them, and a
    # flipped rounding grows through the random network (2.3% measured)
    model = srv.models["int8"]
    quant.build_act_calibration(model, [torch.from_numpy(x[:1])])
    with torch.no_grad():
        static = model(torch.from_numpy(x[:1])).numpy()
        for m in convs.values():
            m.act_max = None
        dynamic = model(torch.from_numpy(x[:1])).numpy()
    assert np.linalg.norm(static - dynamic) / np.linalg.norm(dynamic) < 0.08


def test_run_eval_matches_jax_run_eval(tmp_path):
    # the JAX driver evaluates its PRNGKey(0) init when it finds no
    # checkpoint; the port evaluates the same weights, converted
    cfg_j = jconfig.PRESETS["synthetic_smoke"]
    cfg_j = dataclasses.replace(
        cfg_j,
        model=dataclasses.replace(cfg_j.model, cspn_steps=2, cspn_backend="reference"),
        data=dataclasses.replace(cfg_j.data, num_workers=0),
        best_model_dir=str(tmp_path),
    )
    want = jevaluate.run_eval(cfg_j, runs=2, max_batches=1)
    _, state, _ = jevaluate.load_eval_state(cfg_j)
    variables = jax.tree.map(np.asarray, {"params": state.params, "batch_stats": state.batch_stats})
    got = evaluate.run_eval(_smoke_cfg(tmp_path), runs=2, max_batches=1, device="cpu",
                            jax_variables=variables)
    assert len(got["runs"]) == 2
    # iRMSE/iMAE weight 1/pred: this random-weight model predicts values
    # just above the 1e-4 mask threshold, where 1/pred turns float32 noise
    # into percent-level changes; their parity on shared inputs is pinned
    # in tests/test_torch_runtime.py
    for k in set(METRIC_KEYS) - {"iRMSE", "iMAE"}:
        # the DELTA keys count pixels under a threshold: a float32 ulp can
        # move one of the 12,288 pixels of a run across it
        np.testing.assert_allclose(got["mean"][k], want["mean"][k], rtol=1e-4, atol=2e-4, err_msg=k)
    for k in ("iRMSE", "iMAE"):
        assert np.isfinite(got["mean"][k]) and got["mean"][k] > 0


def test_cli_eval_and_infer(tmp_path, capsys):
    common = ["--preset", "synthetic_smoke", "--dataset", "synthetic", "--device", "cpu",
              "--cspn-step", "2", "--best-model-dir", str(tmp_path)]
    assert main(["eval", *common, "--runs", "1", "--max-batches", "1"]) == 0
    assert "eval_mean_of_1_runs" in capsys.readouterr().out
    out = tmp_path / "preds.npy"
    assert main(["infer", *common, "--buckets", "1,2", "--max-frames", "3", "--out", str(out)]) == 0
    preds = np.load(out)
    assert preds.shape == (3, 64, 96) and np.isfinite(preds).all()


def test_python_m_eval_runs_on_cpu(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "cspn_tpu_torch", "eval", "--preset", "synthetic_smoke",
         "--dataset", "synthetic", "--device", "cpu", "--cspn-step", "2", "--runs", "1",
         "--max-batches", "1", "--best-model-dir", str(tmp_path)],
        cwd=_REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1"),
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "eval_mean_of_1_runs" in proc.stdout


def test_calibrate_bn_stats_sets_batch_statistics():
    gen = torch.Generator().manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3, bias=False), torch.nn.BatchNorm2d(4))
    x = torch.randn(5, 3, 9, 11, generator=gen)
    evaluate.calibrate_bn_stats(model, x)
    bn = model[1]
    with torch.no_grad():
        y = model[0](x)
    assert not model.training and bn.momentum == 0.1
    torch.testing.assert_close(bn.running_mean, y.mean(dim=(0, 2, 3)))
    torch.testing.assert_close(bn.running_var, y.var(dim=(0, 2, 3), unbiased=True))


def test_profiling_helpers():
    from cspn_tpu_torch.utils import profiling

    cfg = profiling.nyu_eval_synthetic()
    assert cfg.model == config.PRESETS["nyu_eval"].model
    assert (cfg.data.dataset, cfg.data.crop_hw, cfg.data.n_sample) == ("synthetic", (228, 304), 500)
    kinds = [profiling._kind(k) for k in (
        "void (anonymous namespace)::cspn2d_fwd_kernel<false>((anonymous namespace)::MarchArgs)",
        "sm90_xmma_fprop_implicit_gemm_f32f32_tf32f32_f32_nhwckrsc_nchw",
        "void cudnn::bn_fw_inf_1C11_kernel_NCHW<float, float, true, 1>",
        "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>",
    )]
    assert kinds == ["cspn2d_fwd", "conv/matmul", "batch norm", "other"]
