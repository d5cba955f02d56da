"""The port's training modules against the JAX package's: optimizer
trajectories, the plateau LR schedule, TSV logs, loader order, the
pretrained-encoder import, checkpoints, the Trainer and the train CLI, on
the CPU.  The composed train step is held against the JAX one in
tests/test_torch_train_step.py."""

import dataclasses
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cspn_tpu.data import DataLoader as JaxDataLoader
from cspn_tpu.models import torch_import as jtorch_import
from cspn_tpu.models import unet as junet
from cspn_tpu.train import logging as jlogging
from cspn_tpu.train import lr_schedule as jlr
from cspn_tpu.train import state as jstate
from cspn_tpu_torch import cli, config
from cspn_tpu_torch.data import DataLoader
from cspn_tpu_torch.models import convert, torch_import, unet
from cspn_tpu_torch.models.resnet import ResNetEncoder
from cspn_tpu_torch.train import checkpoint, factory, logging, loop, lr_schedule, state
from cspn_tpu_torch.utils import profiling

torch.set_num_threads(1)


# -- optimizer -------------------------------------------------------------

_OPT_CASES = {
    "nesterov": dict(nesterov=True),
    "momentum": dict(nesterov=False),
    "dampening": dict(nesterov=False, dampening=0.3),
    "bf16_momentum": dict(nesterov=True, momentum_dtype="bfloat16"),
}


@pytest.mark.parametrize("case", sorted(_OPT_CASES))
def test_optimizer_trajectory_matches_jax(case):
    kw = dict(learning_rate=0.1, momentum=0.9, weight_decay=1e-4, **_OPT_CASES[case])
    rng = np.random.default_rng(0)
    p0 = {"w": rng.standard_normal((5, 3)).astype(np.float32),
          "b": rng.standard_normal((7,)).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in p0.items()}
             for _ in range(5)]

    jst = jstate.TrainState.create(apply_fn=None, params=jax.tree.map(jnp.asarray, p0),
                                   tx=jstate.make_optimizer(**kw), batch_stats={})
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt = state.make_optimizer(list(tp.values()), **kw)
    for i, g in enumerate(grads):
        if i == 3:  # the plateau schedule's LR change between epochs
            jst = jstate.set_learning_rate(jst, 0.01)
            state.set_learning_rate(opt, 0.01)
        jst = jst.apply_gradients(grads=jax.tree.map(jnp.asarray, g))
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k, p in tp.items():
            want, got = np.asarray(jst.params[k]), p.detach().numpy()
            if case == "bf16_momentum":  # agreement to the bf16 rounding of the buffer
                moved = np.abs(want - p0[k]).max()
                assert np.abs(got - want).max() <= 1e-2 * moved, (i, k)
            else:
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7, err_msg=f"{i} {k}")
    assert state.get_learning_rate(opt) == pytest.approx(jstate.get_learning_rate(jst)) == 0.01
    buffers = [opt.state[p]["momentum_buffer"] for p in tp.values()]
    jbuf = [x for x in jax.tree_util.tree_leaves(jst.opt_state) if getattr(x, "shape", ()) == (5, 3)]
    want_dtype = torch.bfloat16 if case == "bf16_momentum" else torch.float32
    assert all(b.dtype == want_dtype for b in buffers)
    assert any(str(b.dtype) == str(want_dtype).removeprefix("torch.") for b in jbuf)


def test_optimizer_refuses_nesterov_with_dampening():
    p = [torch.nn.Parameter(torch.zeros(2))]
    with pytest.raises(ValueError, match="nesterov requires dampening == 0"):
        state.make_optimizer(p, nesterov=True, dampening=0.3)
    with pytest.raises(ValueError, match="nesterov requires dampening == 0"):
        jstate.make_optimizer(0.1, nesterov=True, dampening=0.3).init({"w": jnp.zeros(2)})
    assert isinstance(state.make_optimizer(p, momentum_dtype="float32"), torch.optim.SGD)


def test_bf16_momentum_state_round_trips():
    p = torch.nn.Parameter(torch.ones(4))
    opt = state.make_optimizer([p], momentum_dtype="bfloat16")
    p.grad = torch.full((4,), 0.3)
    opt.step()
    q = torch.nn.Parameter(p.detach().clone())
    opt2 = state.make_optimizer([q], momentum_dtype="bfloat16")
    opt2.load_state_dict(opt.state_dict())
    assert opt2.state[q]["momentum_buffer"].dtype == torch.bfloat16
    assert torch.equal(opt2.state[q]["momentum_buffer"], opt.state[p]["momentum_buffer"])


def test_partial_restore_copies_matching_names_and_shapes():
    model = torch.nn.Sequential(torch.nn.Linear(3, 2), torch.nn.Linear(2, 4))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    src = {"0.weight": torch.ones(2, 3), "1.weight": torch.ones(5, 2), "2.bias": torch.ones(1)}
    state.partial_restore(model, src)
    sd = model.state_dict()
    assert torch.equal(sd["0.weight"], torch.ones(2, 3))
    for k in ("0.bias", "1.weight", "1.bias"):  # shape mismatch or absent: kept
        assert torch.equal(sd[k], before[k])


# -- plateau schedule and TSV logs -----------------------------------------

@pytest.mark.parametrize("kw, trace", [
    ({}, [1.0] * 6 + [0.5] * 6 + [0.49995] * 3 + [0.4] * 40),
    ({"cooldown": 2, "patience": 1}, [3.0, 2.0, 2.5, 2.6, 2.7, 1.0, 1.1, 1.2, 1.3, 1.4, 1.5]),
    ({"factor": 0.5, "min_lr": 1e-3, "mode": "max"}, list(np.linspace(1, 0, 30))),
])
def test_plateau_schedule_matches_jax(kw, trace):
    ours, theirs = lr_schedule.ReduceLROnPlateau(0.01, **kw), jlr.ReduceLROnPlateau(0.01, **kw)
    assert [ours.step(m) for m in trace] == [theirs.step(m) for m in trace]
    assert vars(ours) == vars(theirs)
    with pytest.raises(ValueError):
        lr_schedule.ReduceLROnPlateau(0.01, factor=1.0)


def test_tsv_logs_are_byte_equal_to_jax(tmp_path):
    rng = np.random.default_rng(3)
    loggers = logging.TsvLogger(str(tmp_path / "port")), jlogging.TsvLogger(str(tmp_path / "jax"))
    for epoch in range(3):
        for split in ("train", "eval"):
            err = {k: float(rng.uniform(0, 20)) for k in logging._LOG_COLUMNS + ("LG10",)}
            for lg in loggers:
                lg.log(split, epoch, 0.01 / (epoch + 1), epoch == 1, err)
    for name in ("log_train.txt", "log_eval.txt"):
        got, want = ((tmp_path / d / name).read_bytes() for d in ("port", "jax"))
        assert got == want and got.count(b"\n") == 4


# -- loader ----------------------------------------------------------------

class _IndexDataset:
    def __len__(self):
        return 23

    def __getitem__(self, i):
        return {"i": np.asarray(i), "x": np.full((2, 3), i, np.float32)}


@pytest.mark.parametrize("shuffle, drop_last, shard, mode", [
    (True, True, (0, 1), "thread"),
    (True, False, (1, 3), "thread"),
    (False, False, (0, 1), "thread"),
    (True, True, (1, 2), "process"),
])
def test_loader_batches_equal_jax(shuffle, drop_last, shard, mode):
    kw = dict(shuffle=shuffle, drop_last=drop_last, shard=shard, num_workers=2, seed=4)
    ours = DataLoader(_IndexDataset(), 4, worker_mode=mode, **kw)
    theirs = JaxDataLoader(_IndexDataset(), 4, **kw)
    assert len(ours) == len(theirs)
    for _ in range(2):  # two epochs: the shuffle is reseeded with the epoch
        got, want = list(ours), list(theirs)
        assert [b["i"].tolist() for b in got] == [b["i"].tolist() for b in want]
        assert all(np.array_equal(b["x"][:, 0, 0], b["i"]) for b in got)


def test_loader_surfaces_worker_errors():
    class Broken(_IndexDataset):
        def __getitem__(self, i):
            if i == 5:
                raise KeyError("frame 5")
            return super().__getitem__(i)

    with pytest.raises(KeyError, match="frame 5"):
        list(DataLoader(Broken(), 4, num_workers=2))
    with pytest.raises(ValueError, match="worker_mode"):
        DataLoader(Broken(), 4, worker_mode="fork")


def test_build_loaders_matches_jax_geometry():
    cfg = dataclasses.replace(config.PRESETS["synthetic_smoke"])
    train_loader, val_loader = factory.build_loaders(cfg)
    assert (train_loader.batch_size, train_loader.shuffle, train_loader.drop_last) == (2, True, True)
    assert (val_loader.batch_size, val_loader.shuffle) == (2, False)
    assert len(train_loader) == 16 and len(val_loader) == 4


# -- pretrained encoder import ---------------------------------------------

def _torchvision_resnet18_state_dict(seed=0):
    """A torchvision-format resnet18 state dict with random values: the
    port's encoder names with `conv1` for the 3-channel stem, plus `fc`."""
    gen = torch.Generator().manual_seed(seed)
    enc = ResNetEncoder("basic", (2, 2, 2, 2), in_channels=3)
    sd = {}
    for k, v in enc.state_dict().items():
        if k.startswith(("conv2.", "bn2.")):
            continue
        sd["conv1.weight" if k == "conv1_1.weight" else k] = (
            v.clone() if k.endswith("num_batches_tracked") else torch.randn(v.shape, generator=gen))
    sd["fc.weight"], sd["fc.bias"] = torch.randn(1000, 512, generator=gen), torch.randn(1000, generator=gen)
    return {"module." + k: v for k, v in sd.items()}


def test_pretrained_encoder_import_equals_jax(tmp_path):
    path = str(tmp_path / "resnet18.pth")
    torch.save(_torchvision_resnet18_state_dict(), path)
    x = jnp.zeros((1, 32, 48, 4), jnp.float32)
    m_j = junet.cspn_unet_resnet18(cspn_steps=2, cspn_backend="reference")
    v = jax.tree.map(np.asarray, jax.jit(m_j.init)(jax.random.PRNGKey(0), x))
    p_tree, s_tree = jtorch_import.load_torch_encoder_params(path)
    v_imported = {"params": jstate.partial_restore(v["params"], p_tree),
                  "batch_stats": jstate.partial_restore(v["batch_stats"], s_tree)}
    want = convert.convert_jax_variables(jax.tree.map(np.asarray, v_imported),
                                         unet.cspn_unet_resnet18(cspn_steps=2))

    model = convert.load_jax_variables(unet.cspn_unet_resnet18(cspn_steps=2), v)
    init = {k: t.clone() for k, t in model.state_dict().items()}
    sd = torch_import.load_torch_encoder_params(path)
    assert "conv1_1.weight" in sd and not any(k.startswith(("fc.", "module.")) for k in sd)
    got = state.partial_restore(model, sd).state_dict()
    for k, w in want.items():
        assert torch.equal(got[k], w), k
    assert not torch.equal(got["layer1.0.conv1.weight"], init["layer1.0.conv1.weight"])
    assert not torch.equal(got["bn1.running_var"], init["bn1.running_var"])
    # the 3-channel stem does not fit the 4-channel one: kept, as in JAX
    assert torch.equal(got["conv1_1.weight"], init["conv1_1.weight"])


# -- checkpoints, Trainer, CLI ---------------------------------------------

def test_checkpoint_round_trip_and_gc(tmp_path):
    mgr = checkpoint.CheckpointManager(str(tmp_path / "ck"), max_to_keep=3)
    assert mgr.latest_epoch() is None and not mgr.has("best_model")
    model = torch.nn.Linear(3, 2)
    opt = state.make_optimizer(model.parameters())
    model(torch.ones(1, 3)).sum().backward()
    opt.step()
    ts = state.TrainState(model, opt, step=7)
    for epoch in range(5):
        mgr.save_epoch(checkpoint.state_to_tree(ts, epoch, 1.5, 0.01), epoch)
    mgr.save_best(checkpoint.state_to_tree(ts, 4, 1.25, 0.001))
    assert sorted(os.listdir(mgr.save_dir)) == ["best_model.pt", "epoch_02.pt", "epoch_03.pt", "epoch_04.pt"]
    assert mgr.latest_epoch() == 4 and mgr.has("epoch_02") and not mgr.has("epoch_01")
    tree = mgr.restore("best_model")
    assert (tree["step"], tree["epoch"], tree["best_rmse"], tree["lr"]) == (7, 4, 1.25, 0.001)
    for k, v in model.state_dict().items():
        assert torch.equal(tree["model"][k], v)
    buf = tree["optimizer"]["state"][0]["momentum_buffer"]
    assert torch.equal(buf, opt.state[model.weight]["momentum_buffer"])


def _smoke_cfg(tmp_path, **optim):
    cfg = config.PRESETS["synthetic_smoke"]
    return dataclasses.replace(
        cfg, save_dir=str(tmp_path), best_model_dir=str(tmp_path), log_every=2,
        data=dataclasses.replace(cfg.data, crop_hw=(32, 48), batch_size_train=8, num_workers=2),
        optim=dataclasses.replace(cfg.optim, **optim))


def test_trainer_fit_and_resume(tmp_path, capsys):
    cfg = _smoke_cfg(tmp_path)
    trainer = loop.Trainer(cfg, *factory.build_loaders(cfg), device="cpu")
    p0 = {k: v.clone() for k, v in trainer.state.model.state_dict().items()}
    result = trainer.fit(1)
    assert np.isfinite(result["RMSE"]) and result["RMSE"] == trainer.best_rmse
    assert trainer.state.step == 4 and trainer.epoch == 1
    assert trainer.ckpt.has("best_model") and trainer.ckpt.latest_epoch() == 0
    moved = [k for k, v in trainer.state.model.state_dict().items() if not torch.equal(v, p0[k])]
    assert "conv1_1.weight" in moved and "gud_up_proj_layer6.conv1.weight" in moved
    out = capsys.readouterr().out
    assert "train ===> Epoch: 0, step: 2" in out and "epoch 0 train steps=2" in out
    assert (tmp_path / "log_eval.txt").read_text().count("\n") == 2

    fresh = loop.Trainer(cfg, *factory.build_loaders(cfg), device="cpu")
    fresh.resume("best_model")
    assert (fresh.epoch, fresh.state.step, fresh.best_rmse) == (1, 4, trainer.best_rmse)
    for k, v in trainer.state.model.state_dict().items():
        assert torch.equal(fresh.state.model.state_dict()[k], v), k
    a, b = trainer.state.optimizer.state_dict(), fresh.state.optimizer.state_dict()
    assert a["param_groups"] == b["param_groups"]
    for i, st in a["state"].items():
        assert torch.equal(st["momentum_buffer"], b["state"][i]["momentum_buffer"])
    assert fresh.fit(1) == {}  # epoch 1 of 1: nothing left to run


def test_trainer_refuses_what_is_not_ported(tmp_path):
    """One process: the bf16 gradient reduce rounds each gradient to bf16
    (JAX's shard_map step on one device); a data axis of 2 needs a process
    group of 2 ranks (tests/test_torch_data_parallel.py runs them); a bf16
    model trains on float32 masters, and 'int8' trains that bf16 model (int8
    is serving-only)."""
    loaders = (None, None)
    trainer = loop.Trainer(_smoke_cfg(tmp_path, grad_reduce_dtype="bfloat16"), *loaders,
                           device="cpu")
    assert trainer.data_parallel.group is None and trainer.data_parallel.module is trainer.state.model
    rng = np.random.default_rng(0)
    trainer.train_step(torch.tensor(rng.standard_normal((2, 32, 48, 4)), dtype=torch.float32),
                       torch.tensor(np.abs(rng.standard_normal((2, 32, 48))), dtype=torch.float32))
    grads = [p.grad for p in trainer.state.model.parameters()]
    assert all(torch.equal(g, g.bfloat16().float()) for g in grads)
    assert any(g.abs().sum() > 0 for g in grads)
    with pytest.raises(ValueError, match="process group of 2 x 1 ranks"):
        loop.Trainer(dataclasses.replace(_smoke_cfg(tmp_path), mesh_data=2), *loaders, device="cpu")
    for dtype in ("bfloat16", "int8"):
        cfg = _smoke_cfg(tmp_path)
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, dtype=dtype))
        model = loop.Trainer(cfg, *loaders, device="cpu").state.model
        assert model.dtype == torch.bfloat16 and not model.quant
        assert all(p.dtype == torch.float32 for p in model.parameters())


def test_train_cli_on_cpu(tmp_path, capsys):
    args = ["train", "--preset", "synthetic_smoke", "--dataset", "synthetic", "--device", "cpu",
            "--save-dir", str(tmp_path), "--crop-hw", "32,48", "--batch-size-train", "8",
            "--cspn-step", "2", "--momentum-dtype", "bfloat16"]
    assert cli.main(args + ["--num-epoch", "1", "--profile-dir", str(tmp_path / "trace")]) == 0
    assert (tmp_path / "best_model.pt").exists() and (tmp_path / "epoch_00.pt").exists()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    assert cli.main(args + ["--num-epoch", "2", "--resume"]) == 0
    assert (tmp_path / "epoch_01.pt").exists()
    assert "epoch 1 done" in capsys.readouterr().out
    # eval reads the model entry of the training checkpoint
    assert cli.main(["eval", "--preset", "synthetic_smoke", "--dataset", "synthetic", "--device", "cpu",
                     "--best-model-dir", str(tmp_path), "--crop-hw", "32,48", "--cspn-step", "2",
                     "--runs", "1"]) == 0
    assert f"==> loaded {tmp_path / 'best_model.pt'}" in capsys.readouterr().out
    # one process: a spatial axis replicates the step (the JAX Trainer hands
    # its mesh to no model), a data axis needs as many ranks
    assert cli.main(args + ["--num-epoch", "1", "--mesh-spatial", "2"]) == 0
    with pytest.raises(ValueError, match="process group"):
        cli.main(args + ["--mesh-data", "2"])
    # bf16 trains (float32 checkpoints), and its checkpoint serves bf16
    bf16_dir = tmp_path / "bf16"
    assert cli.main([*args[:args.index("--save-dir")], "--save-dir", str(bf16_dir),
                     *args[args.index("--save-dir") + 2:], "--num-epoch", "1",
                     "--dtype", "bfloat16"]) == 0
    saved = torch.load(bf16_dir / "best_model.pt", weights_only=False)["model"]
    assert all(v.dtype == torch.float32 for v in saved.values() if v.is_floating_point())


def test_step_timer_and_kernel_kinds():
    timer = profiling.StepTimer(warmup=1)  # no device: the wall clock
    for _ in range(3):
        with timer.step(4):
            time.sleep(0.002)
    assert len(timer.times) == 2 and all(t >= 0.002 for t in timer.times)
    assert 0 < timer.frames_per_s <= 2000 and "steps=2" in timer.summary()
    assert profiling.StepTimer().summary() == "StepTimer: no timed steps"
    kinds = [profiling._kind(k) for k in (
        "void (anonymous namespace)::replay_tile_kernel<true>((anonymous namespace)::MarchArgs)",
        "void (anonymous namespace)::epilogue_kernel(float const*, float*, int, int, int)",
        "(anonymous namespace)::reverse_tile_kernel(float const*, float*, int, int)",
        "void (anonymous namespace)::cspn2d_fwd_kernel<true>((anonymous namespace)::MarchArgs)",
        "void cudnn::detail::dgrad_engine<float, 512, 6, 5, 3, 3, 3, false>(int, int)",
        "sm80_xmma_wgrad_implicit_gemm_indexed_f32f32_f32f32_f32_nhwckrsc_nhwc",
    )]
    assert kinds == ["cspn2d_bwd"] * 3 + ["cspn2d_fwd"] + ["conv/matmul"] * 2
