"""The port's stereo path (models/stereo.py, data/stereo.py, the stereo
dataset, train/stereo_loop.py, the stereo CLI) against the JAX package's.

Weights cross through models/convert.py from the JAX `init(PRNGKey(0))` of
PSMNetCSPN(max_disp 16, features 8, cspn_steps 4) at 32x48, the golden
file's recipe (tests/test_golden.py:31-53).

Whole-model comparisons run in float64 on both sides (`jax.enable_x64`):
the randomly initialized network is ill-conditioned in float32 (ROADMAP.md
Queue 3, trap 5).  The JAX model casts its heads to float32 before the
CSPN and the softmax regression (stereo.py:302-305) while the port keeps
float64, so the agreement is that of float32 there: rtol 1e-4, atol 1e-4
on disparities of 1..15 and on the gradients, atol 1e-5 on the loss.
Parts without that cast (cost volume, Conv3d, Hourglass3D) agree to float64
rounding: rtol 1e-9.  The golden file is reproduced in float32 with
tests/test_golden.py's tolerances.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cspn_tpu.data import stereo as jstereo_data
from cspn_tpu.data.datasets import SyntheticStereoDataset as JaxSyntheticStereoDataset
from cspn_tpu.models import stereo as jstereo
from cspn_tpu.train import state as jstate
from cspn_tpu.train import stereo_loop as jloop
from cspn_tpu_torch import cli
from cspn_tpu_torch.data import (
    DataLoader,
    SceneFlowStereoDataset,
    SyntheticStereoDataset,
    read_pfm,
    write_pfm,
)
from cspn_tpu_torch.models import convert, stereo
from cspn_tpu_torch.train import stereo_loop

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-4
MAX_DISP, FEATURES, STEPS, HW = 16, 8, 4, (32, 48)
LR = 1e-3
_GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "psmnet_cspn_32x48.npz")


def _pairs(n=2, seed=7):
    ds = SyntheticStereoDataset(length=n, hw=HW, max_disp=MAX_DISP, seed=seed)
    return tuple(np.stack([ds[i][k] for i in range(n)]) for k in ("left", "right", "disp"))


def _port_model(variables, dtype=torch.float64, **kw):
    model = stereo.PSMNetCSPN(max_disp=MAX_DISP, features=FEATURES, cspn_steps=STEPS, **kw)
    return convert.load_jax_variables(model.to(dtype), variables)


def _recovered_stats(new, old):
    """Real batch statistics from one train-mode apply: the feature
    extractor's BNs were updated twice (left, then right view), the others
    once (torch momentum 0.1)."""
    def one(path, s_new, s_old):
        keep = 0.81 if "feature" in jax.tree_util.keystr(path) else 0.9
        return (np.asarray(s_new) - keep * s_old) / (1.0 - keep)
    return jax.tree_util.tree_map_with_path(one, new, old)


@pytest.fixture(scope="module")
def ref():
    """JAX init (float32, PRNGKey(0)) and float64 train- and eval-mode
    outputs on two synthetic pairs."""
    left, right, disp = _pairs()
    m_train = jstereo.PSMNetCSPN(max_disp=MAX_DISP, features=FEATURES, cspn_steps=STEPS, train=True)
    m_eval = jstereo.PSMNetCSPN(max_disp=MAX_DISP, features=FEATURES, cspn_steps=STEPS, train=False)
    v = jax.tree.map(np.asarray, jax.jit(m_train.init)(
        jax.random.PRNGKey(0), jnp.asarray(left[:1]), jnp.asarray(right[:1])))
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), v)
        l64, r64 = jnp.asarray(left, jnp.float64), jnp.asarray(right, jnp.float64)
        out_train, upd = jax.jit(functools.partial(m_train.apply, mutable=["batch_stats"]))(
            v64, l64, r64)
        v_eval = {"params": v64["params"],
                  "batch_stats": _recovered_stats(upd["batch_stats"], v64["batch_stats"])}
        out_eval = jax.jit(m_eval.apply)(v_eval, l64, r64)
        return dict(v32=v, v64=v64, batch=(left, right, disp), train=np.asarray(out_train),
                    stats=jax.tree.map(np.asarray, upd["batch_stats"]), v_eval=v_eval,
                    eval=np.asarray(out_eval))


def test_forward_matches_jax_in_train_and_eval_mode(ref):
    left, right, _ = (torch.from_numpy(a).double() for a in ref["batch"])
    model = _port_model(ref["v64"]).train()
    with torch.no_grad():
        got = model(left, right).numpy()
    np.testing.assert_allclose(got, ref["train"], rtol=RTOL, atol=ATOL)
    sd = model.state_dict()
    for k, want in convert.convert_jax_tree("batch_stats", ref["stats"]).items():
        np.testing.assert_allclose(sd[k].numpy(), want, rtol=1e-9, err_msg=k)
    model = _port_model(ref["v_eval"]).eval()
    with torch.no_grad():
        got = model(left, right).numpy()
    np.testing.assert_allclose(got, ref["eval"], rtol=RTOL, atol=ATOL)
    assert got.shape == (2, *HW) and got.min() >= 0 and got.max() <= MAX_DISP - 1


def test_golden_output_reproduced(ref):
    """tests/golden/psmnet_cspn_32x48.npz from the converted JAX init, in
    float32 and eval mode at the init statistics, as test_golden.py."""
    s = SyntheticStereoDataset(length=1, hw=HW, max_disp=MAX_DISP, seed=7)[0]
    model = _port_model(ref["v32"], torch.float32).eval()
    with torch.no_grad():
        out = model(torch.from_numpy(s["left"][None]), torch.from_numpy(s["right"][None])).numpy()
    g = np.load(_GOLDEN)
    np.testing.assert_allclose(out.mean(), g["mean"], rtol=1e-4)
    np.testing.assert_allclose(out.std(), g["std"], rtol=1e-3)
    np.testing.assert_allclose(out[0, :6, :6], g["corner"], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(out[0, 14:18, 22:26], g["center"], rtol=1e-3, atol=1e-4)


def test_cost_volume_matches_jax():
    rng = np.random.default_rng(0)
    fl, fr = (rng.standard_normal((2, 4, 6, 3)).astype(np.float32) for _ in range(2))
    want = np.asarray(jstereo.build_cost_volume(jnp.asarray(fl), jnp.asarray(fr), 6))
    got = stereo.build_cost_volume(torch.from_numpy(fl).permute(0, 3, 1, 2),
                                   torch.from_numpy(fr).permute(0, 3, 1, 2), 6)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 4, 1).numpy(), want)
    wide = stereo.build_cost_volume(torch.ones(1, 1, 2, 3), torch.ones(1, 1, 2, 3), 5)
    assert wide[:, 1, 3:].abs().sum() == 0  # no match at d >= W


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("d", [1, 5, 6])
def test_conv3d_matches_jax(stride, d):
    """The JAX package's batched-2D Conv3d (a TPU rewrite) against
    nn.Conv3d(padding=1), odd and even depths, strides 1 and 2."""
    rng = np.random.default_rng(d * 10 + stride)
    x = rng.standard_normal((2, d, 5, 7, 3))
    m = jstereo.Conv3d(features=4, d=d, stride=stride)
    xf = x.reshape(2 * d, 5, 7, 3)
    v = m.init(jax.random.PRNGKey(1), jnp.asarray(xf, jnp.float32))
    with jax.enable_x64(True):
        v = jax.tree.map(lambda a: np.asarray(a, np.float64), v)
        y = np.asarray(m.apply(v, jnp.asarray(xf)))
    conv = stereo.conv3d(3, 4, stride).double()
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(v["params"]["kernel"].transpose(4, 3, 0, 1, 2)))
        got = conv(torch.from_numpy(x).permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1).numpy()
    assert got.shape[1] == (d - 1) // stride + 1
    np.testing.assert_allclose(got, y.reshape(got.shape), rtol=1e-9, atol=1e-12)


def test_hourglass_matches_jax():
    """Hourglass3D in train-mode BN at odd sizes (5x6x7 -> 3x3x4 -> 2x2x2
    and back up), outputs and running statistics, float64."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 5, 6, 7, 8))
    m = jstereo.Hourglass3D(features=4, train=True)
    v = jax.tree.map(np.asarray, jax.jit(m.init)(jax.random.PRNGKey(2), jnp.asarray(x, jnp.float32)))
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), v)
        y, upd = jax.jit(functools.partial(m.apply, mutable=["batch_stats"]))(v64, jnp.asarray(x))
    model = convert.load_jax_variables(stereo.Hourglass3D(8, 4).double(), v64).train()
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(y), rtol=1e-9, atol=1e-12)
    sd = model.state_dict()
    for k, want in convert.convert_jax_tree("batch_stats", upd["batch_stats"]).items():
        np.testing.assert_allclose(sd[k].numpy(), want, rtol=1e-9, err_msg=k)


def test_loss_and_metrics_match_jax():
    rng = np.random.default_rng(1)
    pred = rng.uniform(0, 20, (2, 9, 11))
    gt = rng.uniform(0, 20, (2, 9, 11))
    gt[0, :2] = 0.0  # invalid: gt <= 0 and gt >= max_disp are masked
    loss = stereo.smooth_l1_disparity_loss(torch.from_numpy(pred), torch.from_numpy(gt), 16)
    want = jstereo.smooth_l1_disparity_loss(jnp.asarray(pred), jnp.asarray(gt), 16)
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-6)
    got = stereo.end_point_error(torch.from_numpy(pred), torch.from_numpy(gt), 16)
    want = jstereo.end_point_error(jnp.asarray(pred), jnp.asarray(gt), 16)
    for k in ("EPE", "3px", "D1"):
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-6, err_msg=k)
    empty = stereo.end_point_error(torch.zeros(1, 3, 3), torch.zeros(1, 3, 3), 16)
    assert empty["EPE"].item() == 0.0  # no valid pixel: the count is clamped to 1


@pytest.mark.parametrize("style", ["smooth", "edges"])
def test_synthetic_stereo_dataset_matches_jax(style):
    mine = SyntheticStereoDataset(length=3, hw=(20, 36), max_disp=12, seed=4, style=style)
    theirs = JaxSyntheticStereoDataset(length=3, hw=(20, 36), max_disp=12, seed=4, style=style)
    for i in range(3):
        a, b = mine[i], theirs[i]
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{style}[{i}] {k}")
    with pytest.raises(ValueError, match="smooth|edges"):
        SyntheticStereoDataset(style="blocks")


def test_pfm_round_trip_against_jax(tmp_path):
    rng = np.random.default_rng(2)
    for shape in ((5, 7), (4, 6, 3)):
        data = rng.standard_normal(shape).astype(np.float32)
        write_pfm(str(tmp_path / "a.pfm"), data)
        jstereo_data.write_pfm(str(tmp_path / "b.pfm"), data)
        assert (tmp_path / "a.pfm").read_bytes() == (tmp_path / "b.pfm").read_bytes()
        for path in ("a.pfm", "b.pfm"):
            np.testing.assert_array_equal(read_pfm(str(tmp_path / path)), data)
            np.testing.assert_array_equal(jstereo_data.read_pfm(str(tmp_path / path)), data)
    big_endian = b"Pf\n3 2\n1.0\n" + np.arange(6, dtype=">f4").tobytes()
    (tmp_path / "c.pfm").write_bytes(big_endian)
    np.testing.assert_array_equal(read_pfm(str(tmp_path / "c.pfm")),
                                  jstereo_data.read_pfm(str(tmp_path / "c.pfm")))
    (tmp_path / "d.pfm").write_bytes(b"P6\n")
    with pytest.raises(ValueError, match="not a PFM"):
        read_pfm(str(tmp_path / "d.pfm"))


def test_scene_flow_dataset_matches_jax(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(3)
    rows = ["left,right,disp"]
    for i in range(2):
        for view in ("l", "r"):
            Image.fromarray(rng.integers(0, 256, (24, 40, 3), dtype=np.uint8)).save(
                tmp_path / f"{view}{i}.png")
        disp = rng.uniform(-30, 30, (24, 40)).astype(np.float32)
        disp[0, 0], disp[1, 1] = np.inf, np.nan  # non-finite: invalid (0)
        write_pfm(str(tmp_path / f"d{i}.pfm"), disp)
        rows.append(f"l{i}.png,r{i}.png,d{i}.pfm")
    (tmp_path / "list.csv").write_text("\n".join(rows) + "\n")
    for split, seed in (("train", 5), ("val", None)):
        kw = dict(root_dir=str(tmp_path), split=split, crop_hw=(16, 32), seed=seed)
        mine = SceneFlowStereoDataset(str(tmp_path / "list.csv"), **kw)
        theirs = jstereo_data.SceneFlowStereoDataset(str(tmp_path / "list.csv"), **kw)
        assert len(mine) == len(theirs) == 2
        for i in range(2):
            a, b = mine[i], theirs[i]
            for k in ("left", "right", "disp"):
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{split}[{i}] {k}")
            assert (a["disp"] >= 0).all() and np.isfinite(a["disp"]).all()
    (tmp_path / "bad.csv").write_text("left,right\nl0.png,r0.png\n")
    with pytest.raises(ValueError, match="missing columns"):
        SceneFlowStereoDataset(str(tmp_path / "bad.csv"))
    with pytest.raises(ValueError, match="smaller than crop"):
        SceneFlowStereoDataset(str(tmp_path / "list.csv"), root_dir=str(tmp_path),
                               crop_hw=(32, 64))[0]


def test_train_step_matches_jax(ref):
    """One composed stereo train step (train-mode BN, smooth-L1, backward,
    SGD momentum 0.9, weight decay 1e-4, no Nesterov) against
    cspn_tpu.train.stereo_loop.make_stereo_train_step: the loss, every
    gradient, the BN statistics and the parameters after SGD.  The JAX
    gradients come from its own update: the first SGD step moves each
    parameter by lr * (g + wd * p)."""
    left, right, disp = ref["batch"]
    model_j = jstereo.PSMNetCSPN(max_disp=MAX_DISP, features=FEATURES, cspn_steps=STEPS, train=True)
    with jax.enable_x64(True):
        st = jstate.TrainState.create(
            apply_fn=model_j.apply, params=ref["v64"]["params"],
            batch_stats=ref["v64"]["batch_stats"],
            tx=jstate.make_optimizer(LR, momentum=0.9, weight_decay=1e-4, nesterov=False))
        new_st, loss_j, metrics_j = jloop.make_stereo_train_step(model_j, MAX_DISP)(
            st, jnp.asarray(left, jnp.float64), jnp.asarray(right, jnp.float64),
            jnp.asarray(disp, jnp.float64))
        p_new = jax.tree.map(np.asarray, new_st.params)
        stats_new = jax.tree.map(np.asarray, new_st.batch_stats)
        grads_j = jax.tree.map(lambda old, new: (old - new) / LR - 1e-4 * old,
                               ref["v64"]["params"], p_new)
        loss_j, epe_j = float(loss_j), float(metrics_j["EPE"])

    model = _port_model(ref["v64"])
    optimizer = stereo_loop.make_optimizer(model.parameters(), LR, momentum=0.9, weight_decay=1e-4,
                                           nesterov=False)
    step = stereo_loop.make_stereo_train_step(model, optimizer, MAX_DISP)
    loss, metrics = step(*(torch.from_numpy(a).double() for a in (left, right, disp)))
    np.testing.assert_allclose(loss.item(), loss_j, rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(metrics["EPE"].item(), epe_j, rtol=RTOL, atol=1e-5)
    grads = {k: p.grad.numpy() for k, p in model.named_parameters()}
    want_grads = convert.convert_jax_tree("params", grads_j)
    assert set(grads) == set(want_grads)
    for k, want in want_grads.items():
        scale = np.abs(want).max()
        np.testing.assert_allclose(grads[k], want, rtol=RTOL, atol=ATOL * scale, err_msg=f"grad {k}")
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    p_old = convert.convert_jax_tree("params", ref["v64"]["params"])
    want_params = convert.convert_jax_tree("params", p_new)
    want_stats = convert.convert_jax_tree("batch_stats", stats_new)
    assert set(want_params) | set(want_stats) == {
        k for k in sd if not k.endswith("num_batches_tracked")}
    for k, want in want_params.items():  # each update is lr * (g + wd p): the gradients' tolerance
        delta, want_delta = sd[k] - p_old[k], want - p_old[k]
        np.testing.assert_allclose(delta, want_delta, rtol=RTOL,
                                   atol=ATOL * np.abs(want_delta).max(), err_msg=f"update of {k}")
    for k, want in want_stats.items():  # the statistics see no float32 cast
        np.testing.assert_allclose(sd[k], want, rtol=1e-9, err_msg=f"after the step: {k}")


def test_train_only_freezes_the_rest(ref):
    """train_only: only the matching parameters move (no update, no weight
    decay elsewhere), and the frozen modules' BN running statistics stay
    while they normalize with batch statistics."""
    left, right, disp = (torch.from_numpy(a).double() for a in ref["batch"])
    model = _port_model(ref["v64"])
    before = {k: v.clone() for k, v in model.state_dict().items()}
    trainable = [p for k, p in model.named_parameters() if "guidance3d_head" in k]
    optimizer = stereo_loop.make_optimizer(trainable, LR, momentum=0.9, weight_decay=1e-4,
                                           nesterov=False)
    step = stereo_loop.make_stereo_train_step(model, optimizer, MAX_DISP,
                                              train_only="guidance3d_head")
    step(left, right, disp)
    after = model.state_dict()
    moved = sorted(k for k in before if not torch.equal(before[k], after[k]))
    assert moved == ["guidance3d_head.weight"]
    with torch.no_grad():  # train mode still normalizes with the batch's statistics
        assert not torch.allclose(model.train()(left, right), model.eval()(left, right))


def _stereo_cfg(save_dir, **kw):
    return stereo_loop.StereoConfig(max_disp=MAX_DISP, features=4, cspn_steps=2, batch_size=2,
                                    num_epochs=1, save_dir=str(save_dir), **kw)


def test_stereo_config_matches_jax():
    import dataclasses

    mine = {f.name: f.default for f in dataclasses.fields(stereo_loop.StereoConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(jloop.StereoConfig)}
    assert mine == theirs


def test_trainer_fit_validate_and_run_eval(tmp_path):
    cfg = _stereo_cfg(tmp_path)
    train = DataLoader(SyntheticStereoDataset(4, HW, MAX_DISP, seed=0), 2, shuffle=True,
                       drop_last=True, num_workers=1)
    val = DataLoader(SyntheticStereoDataset(2, HW, MAX_DISP, seed=1), 2, num_workers=1)
    trainer = stereo_loop.StereoTrainer(cfg, train, val, device="cpu")
    p0 = {k: p.detach().clone() for k, p in trainer.model.named_parameters()}
    result = trainer.fit()
    assert set(result) == {"EPE", "3px", "D1"} and all(np.isfinite(v) for v in result.values())
    assert trainer.epoch == 1 and trainer.best_epe == result["EPE"]
    assert all(not torch.equal(p, p0[k]) for k, p in trainer.model.named_parameters())
    assert trainer.ckpt.has("best_model")
    fresh = stereo_loop.StereoTrainer(cfg, train, val, device="cpu", seed=1)
    again = fresh.run_eval("best_model", dump_images=True)
    np.testing.assert_allclose(again["EPE"], result["EPE"], rtol=1e-6)
    pngs = sorted(os.listdir(tmp_path / "eval_result"))
    assert pngs == ["00000_disp.png", "00000_gt.png", "00001_disp.png", "00001_gt.png"]
    # the port's own PNG writer (the card's machine has no PIL): PIL decodes
    # its 16-bit files to the uint16 disparity * 256 that PIL itself wrote
    from PIL import Image

    for i in range(2):
        gt = Image.open(tmp_path / "eval_result" / f"{i:05d}_gt.png")
        want = np.clip(val.dataset[i]["disp"] * 256.0, 0, 65535).astype(np.uint16)
        assert gt.mode == "I;16"
        np.testing.assert_array_equal(np.asarray(gt), want)
        disp = Image.open(tmp_path / "eval_result" / f"{i:05d}_disp.png")
        assert disp.mode == "I;16" and np.asarray(disp).shape == HW


def test_model_options_raise_where_not_ported():
    # bf16 is ported (tests/test_torch_precision.py holds it to JAX's): the
    # convs compute in bf16 on float32 parameters; int8 has no stereo form
    model = stereo_loop.build_stereo_model(
        stereo_loop.StereoConfig(max_disp=8, features=4, cspn_steps=2, dtype="bfloat16"),
        device="cpu")
    assert model.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with torch.no_grad():
        out = model(torch.zeros(1, 16, 24, 3), torch.zeros(1, 16, 24, 3))
    assert out.dtype == torch.float32 and out.shape == (1, 16, 24)
    with pytest.raises(ValueError, match="no int8 form"):
        stereo_loop.build_stereo_model(stereo_loop.StereoConfig(dtype="int8"), device="cpu")
    # a data axis of 2 is two ranks' (DDP, tests/test_torch_data_parallel.py);
    # one process holds one data index
    from cspn_tpu_torch.parallel import make_mesh

    with pytest.raises(ValueError, match="process group of 2 x 2 ranks"):
        stereo.PSMNetCSPN(spatial_mesh=make_mesh(data=2, spatial=2))
    zero = stereo.PSMNetCSPN(max_disp=8, features=4, cspn_steps=2, guidance_zero_init=True,
                             generator=torch.Generator().manual_seed(0))
    assert not zero.guidance3d_head.weight.any() and zero.cost_head.weight.any()
    assert not hasattr(stereo.PSMNetCSPN(max_disp=8, features=4, use_cspn=False), "guidance3d_head")


def test_stereo_cli_on_the_cpu(tmp_path, capsys):
    args = ["--device", "cpu", "--max-disp", str(MAX_DISP), "--features", "4", "--prop-step", "2",
            "--num-epoch", "1", "--batch-size", "2", "--height", "32", "--width", "48",
            "--train-size", "8", "--save-dir", str(tmp_path)]
    assert cli.main(["train-stereo", *args]) == 0
    assert (tmp_path / "best_model.pt").is_file()
    assert cli.main(["eval-stereo", *args, "--dump-images"]) == 0
    out = capsys.readouterr().out
    assert "val EPE" in out and "loaded best_model" in out and "stereo eval: EPE" in out
    assert len(os.listdir(tmp_path / "eval_result")) == 4  # 2 val pairs x (disp, gt)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        cli.main(["eval-stereo", *args[2:]])  # the default device is cuda
