"""The kitti_benchmark configuration (BASELINE config 3: the ResNet-18
CSPN-UNet on full 352x1216 KITTI frames, 24 CSPN steps) in the port
against the JAX package.

The full forward runs at 44x152 (352x1216 / 8), whose sizes turn odd down
the encoder (44 -> 22 -> 11 -> 6 -> 3 -> 2, 152 -> ... -> 19 -> 10 -> 5),
with the JAX init crossing through models/convert.py, both sides in
float64 and train-mode BN (ROADMAP.md Queue 3, trap 5): rtol 1e-4, atol
1e-5, as tests/test_torch_model.py.  The preset's frames, batch sizes and
the forward kernel each batch gets on the card are pinned without a card.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from cspn_tpu.data import SyntheticDepthDataset as JaxSyntheticDepthDataset
from cspn_tpu.models import unet as junet
from cspn_tpu_torch.config import PRESETS
from cspn_tpu_torch.models import convert, unet
from cspn_tpu_torch.ops import cspn_cuda
from cspn_tpu_torch.train.factory import build_dataset
from cspn_tpu_torch.utils.profiling import kitti_benchmark_synthetic

torch.set_num_threads(1)

KITTI_HW = (352, 1216)


def test_resnet18_forward_at_kitti_eighth_scale_matches_jax():
    ds = JaxSyntheticDepthDataset(length=2, hw=(44, 152), n_sample=500, seed=7)
    x = np.stack([ds[i]["rgbd"] for i in range(2)]).astype(np.float64)
    m = junet._make(18, True, cspn_steps=24, cspn_backend="reference", train=True)
    v = jax.tree.map(np.asarray, jax.jit(m.init)(jax.random.PRNGKey(0), jnp.asarray(x, jnp.float32)))
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), v)
        want, _ = jax.jit(functools.partial(m.apply, mutable=["batch_stats"]))(
            v64, jnp.asarray(x, jnp.float64))
    model = unet._make(18, True, cspn_steps=24).double()
    assert model.subpixel  # the port's default form, as JAX's
    convert.load_jax_variables(model, v64)
    model.train()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 44, 152)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-5)


def test_kitti_benchmark_preset_on_synthetic_frames():
    cfg = kitti_benchmark_synthetic()
    assert (cfg.model.arch, cfg.model.cspn_steps, cfg.data.crop_hw) == ("resnet18", 24, KITTI_HW)
    assert (cfg.data.batch_size_train, cfg.data.batch_size_eval, cfg.data.n_sample) == (4, 1, 500)
    frame = build_dataset(cfg, "val", seed=0)[0]
    assert frame["rgbd"].shape == (*KITTI_HW, 4) and frame["depth"].shape == KITTI_HW
    assert 0 < np.count_nonzero(frame["rgbd"][..., 3]) <= 2 * cfg.data.n_sample


def test_kitti_batches_pick_their_forward_kernel():
    """The b4 train batch's forward, which cspn2d_bwd follows, runs the
    per-step kernel; the b1 eval batch and both serving buckets run the
    tiled one, three launches of 8 steps."""
    cfg = kitti_benchmark_synthetic()
    assert not cspn_cuda.use_tiled(for_backward=True)
    assert cspn_cuda.use_tiled(for_backward=False)
    assert cspn_cuda.plan_tiles(*KITTI_HW, cfg.model.cspn_steps).launch_steps == (8, 8, 8)


def test_builders_turn_on_cudnn_timing_only_for_the_card(monkeypatch):
    """cuDNN's heuristic alone picks FFT convs ~25x slower than timed ones
    at kitti_benchmark's batch 4.  The conv policy is the entry points'
    (set_conv_policy): it sets cuDNN's algorithm timing and TF32 (off
    unless asked, where PyTorch's own default computes convs in TF32) for a
    CUDA device only, and the model builders leave it as they find it."""
    from cspn_tpu_torch import set_conv_policy
    from cspn_tpu_torch.train.evaluate import build_model
    from cspn_tpu_torch.train.stereo_loop import StereoConfig, build_stereo_model

    def build_both():
        build_model(PRESETS["synthetic_smoke"], device="cpu")
        build_stereo_model(StereoConfig(max_disp=8, features=4, cspn_steps=1), device="cpu")

    def policy():
        return (torch.backends.cudnn.benchmark, torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)

    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)  # PyTorch's default
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    build_both()
    assert policy() == (False, True, True)
    set_conv_policy("cpu")
    assert policy() == (False, True, True)
    set_conv_policy(torch.device("cuda", 0))
    assert policy() == (True, False, False)
    build_both()
    assert policy() == (True, False, False)
    set_conv_policy("cuda", autotune=False, tf32=True)
    assert policy() == (False, True, True)


class _Built(Exception):
    pass


def _record_policy_and_stop_at_the_build(monkeypatch):
    """Replace the conv policy with a recorder and every model builder of
    the entry points with one that records and raises _Built."""
    import cspn_tpu_torch
    from cspn_tpu_torch.train import evaluate, loop, stereo_loop

    calls = []

    def policy(device, *, autotune=True, tf32=False):
        calls.append(("policy", torch.device(device).type, autotune, tf32))

    def build(*args, **kwargs):
        calls.append(("build",))
        raise _Built

    for mod in (cspn_tpu_torch, loop, stereo_loop, evaluate):
        monkeypatch.setattr(mod, "set_conv_policy", policy)
    for mod, fn in ((loop, "build_model"), (stereo_loop, "build_stereo_model"),
                    (evaluate, "load_eval_state")):
        monkeypatch.setattr(mod, fn, build)
    return calls


def test_entry_points_set_the_conv_policy_before_building_the_model(monkeypatch):
    """Trainer, StereoTrainer, run_eval and load_server each set the conv
    policy for their device before their first model exists (cuDNN keeps
    the algorithm it first chose for a shape): cuDNN's timing on, and TF32
    off unless the caller asks for it."""
    from cspn_tpu_torch.train import evaluate, loop, stereo_loop
    from cspn_tpu_torch.serving import load_server

    calls = _record_policy_and_stop_at_the_build(monkeypatch)
    entry_points = (
        lambda **kw: loop.Trainer(PRESETS["synthetic_smoke"], None, None, device="cpu", **kw),
        lambda **kw: stereo_loop.StereoTrainer(stereo_loop.StereoConfig(), None, None,
                                               device="cpu", **kw),
        lambda **kw: evaluate.run_eval(PRESETS["synthetic_smoke"], device="cpu", **kw),
        lambda **kw: load_server(PRESETS["synthetic_smoke"], device="cpu", **kw),
    )
    for entry in entry_points:
        for kw, tf32 in (({}, False), ({"tf32": True}, True)):
            calls.clear()
            try:
                entry(**kw)
            except _Built:
                pass
            assert calls == [("policy", "cpu", True, tf32), ("build",)]


def test_cli_tf32_switch_reaches_the_policy(monkeypatch, tmp_path):
    """`--tf32` on train, eval, infer, train-stereo and eval-stereo is the
    one switch: without it every subcommand sets TF32 off, with it on."""
    from cspn_tpu_torch import cli

    calls = _record_policy_and_stop_at_the_build(monkeypatch)
    depth = ["--preset", "synthetic_smoke", "--dataset", "synthetic", "--device", "cpu"]
    stereo = ["--device", "cpu", "--max-disp", "8", "--height", "16", "--width", "24",
              "--train-size", "4", "--save-dir", str(tmp_path)]
    commands = (["train", *depth, "--save-dir", str(tmp_path)], ["eval", *depth],
                ["infer", *depth], ["train-stereo", *stereo], ["eval-stereo", *stereo])
    for argv in commands:
        for extra, tf32 in (([], False), (["--tf32"], True)):
            calls.clear()
            args = cli.build_parser().parse_args(argv + extra)
            try:
                args.fn(args)
            except _Built:
                pass
            assert calls == [("policy", "cpu", True, tf32), ("build",)], argv + extra
