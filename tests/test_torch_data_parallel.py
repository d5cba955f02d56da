"""Data-parallel training (parallel/data.py, parallel/sync_bn.py,
parallel/mesh.py's data axis, the Trainers on a data mesh,
utils/scaling.py) on the CPU, against one process over the joined batch
and against the JAX package's data-parallel steps.

Two processes join a gloo group through a `file://` store under a
temporary directory and each trains on its half of every batch:

  - the port's sync-BN against one `nn.BatchNorm2d` / `BatchNorm3d` over
    the joined batch: output, input and parameter gradients, running
    statistics (float64, 1e-12);
  - one step of the CSPN-UNet (ResNet-18, 32x48, float64, weights from the
    JAX package's init through models/convert.py) on the default route
    (sync-BN, float32-style reduce) against the port's one-process step
    over the joined batch (1e-9) and against the JAX package's GSPMD step
    on a 2-device CPU data mesh (rtol 1e-4, atol 1e-5: the JAX model runs
    its CSPN in float32, tests/test_torch_train_step.py; every metric but
    iRMSE and iMAE, trap 6); the ground truth
    has invalid pixels at random, so the two shards hold different numbers
    of valid pixels and the global masked mean is exercised;
  - the same step on the bf16 route against JAX's
    make_shard_map_train_step(grad_reduce_dtype='bfloat16') on that mesh:
    each parameter within twice the largest change that bf16 rounding makes
    in JAX's own step (against its shard_map step reducing in float32: a
    rank's gradient may round to bf16 the other way on the two sides); the
    hook's bf16 bytes a quarter of its float64 bytes here, and half its
    float32 bytes in the stereo run;
  - `Trainer.fit(1)` at mesh_data=2 and at mesh_data=1, mesh_spatial=2
    against the one-process run (float32, rtol 1e-4, atol 2e-4: DDP sums
    the ranks' gradients and the sync-BN joins their statistics in another
    order than one process does, FIT_ATOL);
  - a tiny `StereoTrainer` at data=2 (bf16 route, float32): replicas equal
    value for value, the hook's bytes; and one stereo step on the default
    route against one process (float64, 1e-9).

`run_scaling_bench` runs 1 and then 2 spawned gloo ranks in each mode (the
mechanics; JAX's model: tests/test_parallel.py:297).  The workers import
no JAX.
"""

import dataclasses
import pathlib
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cspn_tpu.data import SyntheticDepthDataset as JaxSyntheticDepthDataset
from cspn_tpu.models import unet as junet
from cspn_tpu.parallel import mesh as jmesh
from cspn_tpu.train import loop as jloop
from cspn_tpu.train import state as jstate
from cspn_tpu_torch import config
from cspn_tpu_torch.data import SyntheticStereoDataset
from cspn_tpu_torch.models import convert, unet
from cspn_tpu_torch.parallel import make_mesh, shard_batch
from cspn_tpu_torch.parallel.data import DataParallel
from cspn_tpu_torch.train import factory, loop, state, stereo_loop
from cspn_tpu_torch.train.metrics import METRIC_KEYS
from cspn_tpu_torch.utils.scaling import run_scaling_bench

torch.set_num_threads(1)

_ROOT = pathlib.Path(__file__).resolve().parent.parent
F64 = torch.float64
LR, STEPS, HW = 0.01, 2, (32, 48)
RTOL, ATOL = 1e-4, 1e-5
# against JAX, whose model runs its CSPN in float32: iRMSE and iMAE weigh
# 1/pred for predictions just above the mask, which float32 noise moves by
# more (ROADMAP.md Queue 3, trap 6); the float64 one-process comparison
# holds them
JAX_METRICS = tuple(k for k in METRIC_KEYS if k not in ("iRMSE", "iMAE"))
# Trainer.fit in float32, two steps of 16 frames: one process and the two
# ranks sum the gradients and join the BN statistics in other orders; the
# largest difference measured in any tensor was 4.4e-5 (values up to 2.6).
# LG10 joins iRMSE and iMAE there: it too weighs the predictions just above
# the mask, and float32 noise moves which of them count (trap 6)
FIT_ATOL = 2e-4
FIT_METRICS = tuple(k for k in JAX_METRICS if k != "LG10")
# the DELTA metrics count pixels under a ratio: float32 noise moves a few
# of the ~9,800 valid ones across (1e-4 each)
FIT_DELTA_ATOL = 5e-4

_WORKER = textwrap.dedent("""
    import dataclasses
    import sys
    import torch
    import torch.distributed as dist
    sys.path.insert(0, sys.argv[3])
    from cspn_tpu_torch.data import DataLoader, SyntheticStereoDataset
    from cspn_tpu_torch.models import unet
    from cspn_tpu_torch.parallel import make_mesh, replicate, shard_batch
    from cspn_tpu_torch.parallel.data import DataParallel
    from cspn_tpu_torch.parallel.distributed import initialize_multihost
    from cspn_tpu_torch.parallel.sync_bn import SyncBatchNorm, convert_sync_batchnorm
    from cspn_tpu_torch.train import factory, loop, state, stereo_loop

    rank, tmp = int(sys.argv[1]), sys.argv[2]
    torch.set_num_threads(1)
    initialize_multihost(f"file://{tmp}/store", world_size=2, rank=rank, backend="gloo",
                         retries=1, timeout_s=120)
    inp = torch.load(f"{tmp}/inputs.pt", weights_only=False)
    out = {}

    for key, bn in (("bn2d", torch.nn.BatchNorm2d(3)), ("bn3d", torch.nn.BatchNorm3d(3))):
        bn = convert_sync_batchnorm(bn.double())
        assert isinstance(bn, SyncBatchNorm)
        with torch.no_grad():
            bn.weight.copy_(inp["w"])
            bn.bias.copy_(inp["b"])
        x = inp[key][2 * rank:2 * rank + 2].clone().requires_grad_(True)
        y = bn(x)
        ct = inp[key + "_ct"][2 * rank:2 * rank + 2]
        dx, dw, db = torch.autograd.grad((y * ct).sum(), (x, bn.weight, bn.bias))
        out[key] = (y.detach(), dx, dw, db, bn.running_mean.clone(), bn.running_var.clone())

    mesh = make_mesh(2, 1, dist.group.WORLD)
    assert (mesh.data, mesh.data_rank, mesh.spatial) == (2, rank, 1)
    lin = torch.nn.BatchNorm1d(3)
    with torch.no_grad():
        lin.weight.fill_(rank + 2.0)
        lin.running_mean.fill_(rank - 1.0)
    replicate(lin)
    out["replicate"] = (lin.weight.clone(), lin.running_mean.clone())
    rows = shard_batch({"x": inp["x"], "gt": inp["gt"]}, mesh)
    for route in (None, "bfloat16"):
        model = unet._make(18, True, cspn_steps=inp["steps"]).double()
        model.load_state_dict(inp["weights"])
        opt = state.make_optimizer(model.parameters(), inp["lr"], momentum=0.9,
                                   weight_decay=1e-4, nesterov=True)
        dp = DataParallel(model, mesh, route)
        loss, error = loop.make_train_step(model, opt, "l1", dp)(rows["x"], rows["gt"])
        out[f"step_{route}"] = dict(loss=loss, error=error, state=model.state_dict(),
                                    bytes=dict(dp.hook.bytes))

    for key, (d, s) in (("fit_data", (2, 1)), ("fit_spatial", (1, 2))):
        cfg = dataclasses.replace(inp["cfg"], save_dir=f"{tmp}/{key}", mesh_data=d, mesh_spatial=s)
        trainer = loop.Trainer(cfg, *factory.build_loaders(cfg), device="cpu")
        assert (trainer.mesh.data, trainer.mesh.spatial) == (d, s)
        out[key] = trainer.fit(1)

    scfg = inp["stereo_cfg"]
    model = stereo_loop.build_stereo_model(scfg, train=True, device="cpu", seed=0).double()
    opt = state.make_optimizer(model.parameters(), scfg.lr, momentum=0.9, weight_decay=1e-4,
                               nesterov=False)
    step = stereo_loop.make_stereo_train_step(model, opt, float(scfg.max_disp),
                                              data_parallel=DataParallel(model, mesh))
    srows = shard_batch({k: inp[k] for k in ("left", "right", "disp")}, mesh)
    loss, error = step(srows["left"], srows["right"], srows["disp"])
    out["stereo_step"] = dict(loss=loss, error=error, state=model.state_dict())

    scfg = dataclasses.replace(scfg, save_dir=f"{tmp}/stereo")
    train = DataLoader(SyntheticStereoDataset(length=4, hw=(32, 48), max_disp=scfg.max_disp, seed=0),
                       2, shuffle=True, drop_last=True)
    val = DataLoader(SyntheticStereoDataset(length=2, hw=(32, 48), max_disp=scfg.max_disp, seed=1), 2)
    st = stereo_loop.StereoTrainer(scfg, train, val, device="cpu", grad_reduce_dtype="bfloat16")
    result = st.fit(1)
    out["stereo_fit"] = dict(result=result, state=st.model.state_dict(),
                             bytes=dict(st.data_parallel.hook.bytes), steps=len(train),
                             params=sum(p.numel() for p in st.model.parameters()))
    torch.save(out, f"{tmp}/out{rank}.pt")
    dist.destroy_process_group()
""")


def _fit_cfg():
    cfg = config.PRESETS["synthetic_smoke"]
    return dataclasses.replace(
        cfg, log_every=100,
        # 16 frames a step, 8 a rank: at 1 a rank float32 rounding, amplified by
        # train-mode BN over 2 frames, outgrows any tolerance (ROADMAP.md Queue
        # 3, trap 5); the float64 steps above hold the function exactly
        data=dataclasses.replace(cfg.data, crop_hw=HW, batch_size_train=16, num_workers=0),
        model=dataclasses.replace(cfg.model, cspn_steps=STEPS))


def _stereo_cfg():
    return stereo_loop.StereoConfig(max_disp=8, features=4, cspn_steps=2, batch_size=2,
                                    num_epochs=1)


def _batch():
    """4 frames; ground truth >= 2 (kept apart from the predictions, as
    tests/test_torch_train_step.py), a fifth of it invalid at random."""
    ds = JaxSyntheticDepthDataset(length=4, hw=HW, n_sample=64, seed=5)
    x = np.stack([ds[i]["rgbd"] for i in range(4)]).astype(np.float64)
    rng = np.random.default_rng(7)
    gt = 2.0 + np.abs(rng.standard_normal((4, *HW)))
    gt[rng.random((4, *HW)) < 0.2] = 0.0
    return x, gt


def _jax_steps(x, gt):
    """The JAX init (float64 weights), its GSPMD step and its shard_map
    step reducing in bf16 and in float32, on a 2-device data mesh."""
    model = junet._make(18, True, cspn_steps=STEPS, cspn_backend="reference", train=True)
    v = jax.tree.map(np.asarray, jax.jit(model.init)(jax.random.PRNGKey(0),
                                                    jnp.asarray(x[:1], jnp.float32)))
    mesh = jmesh.make_mesh(data=2, spatial=1, devices=jax.devices()[:2])
    out = {}
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), v)
        for name, step in (("gspmd", jloop.make_train_step(model, "l1")),
                           ("bf16", jloop.make_shard_map_train_step(model, mesh, "l1",
                                                                    grad_reduce_dtype="bfloat16")),
                           ("shard_f32", jloop.make_shard_map_train_step(model, mesh, "l1"))):
            st = jmesh.replicate(jstate.TrainState.create(
                apply_fn=model.apply, params=v64["params"], batch_stats=v64["batch_stats"],
                tx=jstate.make_optimizer(LR, momentum=0.9, weight_decay=1e-4, nesterov=True)), mesh)
            b = jmesh.shard_batch({"x": jnp.asarray(x), "gt": jnp.asarray(gt)}, mesh)
            new, loss, error = step(st, b["x"], b["gt"])
            out[name] = dict(loss=float(loss), error={k: float(e) for k, e in error.items()},
                             state={**convert.convert_jax_tree("params", jax.tree.map(np.asarray, new.params)),
                                    **convert.convert_jax_tree("batch_stats",
                                                               jax.tree.map(np.asarray, new.batch_stats))})
    return v64, out


def _one_process_steps(weights, x, gt, inp):
    """The port's one-process steps over the joined batches."""
    model = unet._make(18, True, cspn_steps=STEPS).double()
    model.load_state_dict(weights)
    opt = state.make_optimizer(model.parameters(), LR, momentum=0.9, weight_decay=1e-4,
                               nesterov=True)
    loss, error = loop.make_train_step(model, opt, "l1")(x, gt)
    one = {"step": dict(loss=loss, error=error, state=model.state_dict())}
    scfg = inp["stereo_cfg"]
    smodel = stereo_loop.build_stereo_model(scfg, train=True, device="cpu", seed=0).double()
    sopt = state.make_optimizer(smodel.parameters(), scfg.lr, momentum=0.9, weight_decay=1e-4,
                                nesterov=False)
    loss, error = stereo_loop.make_stereo_train_step(smodel, sopt, float(scfg.max_disp))(
        inp["left"], inp["right"], inp["disp"])
    one["stereo_step"] = dict(loss=loss, error=error, state=smodel.state_dict())
    return one


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Runs the two ranks (and, meanwhile, the JAX steps and the port's
    one-process runs); returns (rank outputs, one-process results, JAX
    results, inputs)."""
    tmp = tmp_path_factory.mktemp("dp")
    rng = np.random.default_rng(0)
    t = lambda *shape: torch.tensor(rng.standard_normal(shape), dtype=F64)  # noqa: E731
    x, gt = _batch()
    v64, jax_out = _jax_steps(x, gt)
    weights = convert.load_jax_variables(unet._make(18, True, cspn_steps=STEPS).double(),
                                         v64).state_dict()
    sds = SyntheticStereoDataset(length=4, hw=HW, max_disp=8, seed=3)
    inp = {"bn2d": t(4, 3, 5, 6) * 2 + 1, "bn2d_ct": t(4, 3, 5, 6),
           "bn3d": t(4, 3, 2, 5, 6) - 1, "bn3d_ct": t(4, 3, 2, 5, 6),
           "w": t(3), "b": t(3), "x": torch.from_numpy(x), "gt": torch.from_numpy(gt),
           "weights": weights, "steps": STEPS, "lr": LR, "cfg": _fit_cfg(),
           "stereo_cfg": _stereo_cfg(),
           **{k: torch.tensor(np.stack([sds[i][k] for i in range(4)]), dtype=F64)
              for k in ("left", "right", "disp")}}
    torch.save(inp, tmp / "inputs.pt")
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(rank), str(tmp), str(_ROOT)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              cwd=str(_ROOT))
             for rank in (0, 1)]
    try:
        one = _one_process_steps(weights, inp["x"], inp["gt"], inp)
        cfg = dataclasses.replace(inp["cfg"], save_dir=str(tmp / "fit_one"))
        one["fit"] = loop.Trainer(cfg, *factory.build_loaders(cfg), device="cpu").fit(1)
        results = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, (_, err)) in enumerate(zip(procs, results)):
        assert p.returncode == 0, (rank, err[-3000:])
    outs = [torch.load(tmp / f"out{rank}.pt", weights_only=False) for rank in (0, 1)]
    return outs, one, jax_out, inp, tmp


def _close(a, b, rtol, atol, what):
    torch.testing.assert_close(torch.as_tensor(a, dtype=F64), torch.as_tensor(b, dtype=F64),
                               rtol=rtol, atol=atol, msg=what)


@pytest.mark.parametrize("key", ["bn2d", "bn3d"])
def test_sync_bn_matches_one_batch_norm_over_the_joined_batch(ranks, key):
    outs, _, _, inp, _ = ranks
    bn = (torch.nn.BatchNorm2d(3) if key == "bn2d" else torch.nn.BatchNorm3d(3)).double()
    with torch.no_grad():
        bn.weight.copy_(inp["w"])
        bn.bias.copy_(inp["b"])
    x = inp[key].clone().requires_grad_(True)
    y = bn(x)
    dx, dw, db = torch.autograd.grad((y * inp[key + "_ct"]).sum(), (x, bn.weight, bn.bias))
    for rank, out in enumerate(outs):
        y_r, dx_r, dw_r, db_r, mean_r, var_r = out[key]
        rows = slice(2 * rank, 2 * rank + 2)
        _close(y_r, y[rows].detach(), 1e-12, 1e-12, f"rank {rank} output")
        _close(dx_r, dx[rows], 1e-12, 1e-12, f"rank {rank} d input")
        _close(mean_r, bn.running_mean, 1e-12, 1e-12, "running mean")
        _close(var_r, bn.running_var, 1e-12, 1e-12, "running variance (unbiased, global count)")
    # each rank's parameter gradients are its share; DDP averages them
    _close(outs[0][key][2] + outs[1][key][2], dw, 1e-12, 1e-12, "d weight")
    _close(outs[0][key][3] + outs[1][key][3], db, 1e-12, 1e-12, "d bias")


def _check_step(got, want, rtol, atol, keys=METRIC_KEYS):
    _close(got["loss"], want["loss"], rtol, atol, "loss")
    for k in keys:
        _close(got["error"][k], want["error"][k], rtol, atol, f"metric {k}")
    state = {k: v for k, v in got["state"].items() if not k.endswith("num_batches_tracked")}
    assert set(state) == set(want["state"]) - {k for k in want["state"]
                                                if k.endswith("num_batches_tracked")}
    for k, v in state.items():
        _close(v, want["state"][k], rtol, atol, f"after the step: {k}")


def test_ddp_sync_bn_step_matches_one_process_over_the_joined_batch(ranks):
    outs, one, _, inp, _ = ranks
    valid = (inp["gt"] > 1e-4).flatten(1).sum(1)
    assert valid[:2].sum() != valid[2:].sum()  # the shards' masked means weigh differently
    for out in outs:
        _check_step(out["step_None"], one["step"], 1e-9, 1e-12)
        assert set(out["step_None"]["bytes"]) == {"float64"}


def test_ddp_sync_bn_step_matches_the_jax_gspmd_step(ranks):
    """The slice as a whole: the DDP step on the default route against the
    JAX package's GSPMD step on a 2-device data mesh, same weights."""
    outs, _, jax_out, _, _ = ranks
    for out in outs:
        _check_step(out["step_None"], jax_out["gspmd"], RTOL, ATOL, JAX_METRICS)


def test_ddp_bf16_route_matches_the_jax_shard_map_step(ranks):
    outs, _, jax_out, inp, _ = ranks
    want = jax_out["bf16"]
    params = {k for k, _ in unet._make(18, True, cspn_steps=STEPS).named_parameters()}
    n_params = sum(v.numel() for k, v in inp["weights"].items() if k in params)
    for out in outs:
        got = out["step_bfloat16"]
        _close(got["loss"], want["loss"], RTOL, ATOL, "loss (pmean of the shards')")
        for k in JAX_METRICS:
            _close(got["error"][k], want["error"][k], RTOL, ATOL, f"metric {k}")
        for k, v in got["state"].items():
            if k.endswith("num_batches_tracked"):
                continue
            w, before = torch.as_tensor(want["state"][k]), inp["weights"][k]
            if k in params:
                # a rank's gradient may round to bf16 the other way here and
                # in JAX (one bf16 ulp, where the two are a rounding apart):
                # held to twice the largest change bf16 rounding makes in
                # JAX's own step (its shard_map step reducing in float32)
                bf16_effect = (w - torch.as_tensor(jax_out["shard_f32"]["state"][k])).abs().max()
                assert (v - w).abs().max() <= 2 * bf16_effect + 1e-12, k
            else:  # running statistics: the pmean of the replicas'
                _close(v, w, RTOL, ATOL, k)
        # float64 buckets here: bf16 on the wire is a quarter of their bytes
        assert got["bytes"] == {"float64": 8 * n_params, "bfloat16": 2 * n_params}
    assert all(torch.equal(outs[0]["step_bfloat16"]["state"][k], v)
               for k, v in outs[1]["step_bfloat16"]["state"].items())


@pytest.mark.parametrize("key", ["fit_data", "fit_spatial"])
def test_trainer_fit_on_a_mesh_matches_one_process(ranks, key):
    """Trainer.fit(1) at mesh_data=2 (sync-BN over the two ranks) and at
    mesh_data=1, mesh_spatial=2 (each rank the whole step): rank 0 alone
    writes its checkpoints, equal to the one-process run's."""
    outs, one, _, _, tmp = ranks
    for out in outs:
        for k in FIT_METRICS:
            atol = FIT_DELTA_ATOL if k.startswith("DELTA") else 1e-6
            _close(out[key][k], one["fit"][k], 1e-4, atol, f"val {k}")
    for name in ("epoch_00.pt", "best_model.pt"):
        got = torch.load(tmp / key / name, weights_only=False)["model"]
        want = torch.load(tmp / "fit_one" / name, weights_only=False)["model"]
        assert set(got) == set(want)
        for k, v in got.items():
            _close(v, want[k], 1e-4, FIT_ATOL, f"{name}: {k}")
    assert sorted(p.name for p in (tmp / key).iterdir()) == sorted(
        p.name for p in (tmp / "fit_one").iterdir())


def test_stereo_trainer_on_a_data_mesh(ranks):
    outs, one, _, _, _ = ranks
    for out in outs:
        _check_step(out["stereo_step"], one["stereo_step"], 1e-9, 1e-12, keys=("EPE", "3px", "D1"))
    fits = [out["stereo_fit"] for out in outs]
    assert np.isfinite(fits[0]["result"]["EPE"]) and fits[0]["result"] == fits[1]["result"]
    for k, v in fits[0]["state"].items():
        assert torch.equal(v, fits[1]["state"][k]), k  # the replicas stay equal
    n, steps = fits[0]["params"], fits[0]["steps"]
    assert fits[0]["bytes"] == {"float32": 4 * n * steps, "bfloat16": 2 * n * steps}


def test_replicate_broadcasts_rank_0s_parameters_and_buffers(ranks):
    for out in ranks[0]:
        weight, mean = out["replicate"]
        assert torch.equal(weight, torch.full((3,), 2.0)) and torch.equal(mean, torch.full((3,), -1.0))


def test_mesh_data_axis_in_one_process():
    mesh = make_mesh()
    assert (mesh.data, mesh.spatial, mesh.data_rank, mesh.data_group) == (1, 1, 0, None)
    batch = {"a": np.arange(8).reshape(4, 2)}
    assert np.array_equal(shard_batch(batch, mesh)["a"], batch["a"])
    with pytest.raises(ValueError, match="process group of 2 x 1 ranks"):
        make_mesh(data=2)
    dp = DataParallel(torch.nn.Linear(2, 2), mesh)
    assert dp.module is dp.model and dp.hook is None and dp.ranks == 1
    with pytest.raises(ValueError, match="grad_reduce_dtype"):
        DataParallel(torch.nn.Linear(2, 2), mesh, "float16")


@pytest.mark.parametrize("mode", ["train", "eval", "stereo"])
def test_run_scaling_bench_mechanics(mode):
    """Weak scaling over 1 and 2 spawned gloo ranks: one record a size,
    efficiency against 1 rank.  The mechanics only: the ranks share the
    host with the other test workers, so the times bound nothing and the
    efficiency is held to its formula, not to a range."""
    records = run_scaling_bench(arch="resnet18", hw=HW, batch_per_device=1, cspn_steps=2,
                                mode=mode, warmup=1, iters=2, max_devices=2, device="cpu")
    assert [r["devices"] for r in records] == [1, 2]
    assert [r["batch"] for r in records] == [1, 2]
    for r in records:
        assert r["frames_per_s"] > 0 and r["ms_per_step"] > 0 and "NOT a scaling" in r["note"]
        assert r["frames_per_s"] == pytest.approx(r["batch"] * 1e3 / r["ms_per_step"])
        assert r["efficiency"] == r["frames_per_s"] / (r["devices"] * records[0]["frames_per_s"])
    assert records[0]["efficiency"] == 1.0
    assert records[0]["model"] == ("PSMNetCSPN" if mode == "stereo" else "resnet18")

