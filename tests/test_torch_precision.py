"""The port's bf16 compute (utils/precision.py, the `dtype` of models/
resnet.py, decoder.py, unet.py and stereo.py, train/evaluate.py:build_model)
against the JAX package's `dtype=jnp.bfloat16` modules on the same weights.

Weights come from the JAX modules' init through models/convert.py; the
inputs from numpy seeds, rounded to bf16 where a module takes bf16.
Tolerances, as rel-norms (||port - JAX|| / ||JAX||):
  - one block at a time (the stem, a BasicBlock and a Bottleneck, the
    decoder's up-projection blocks in both forms), in train mode and in
    eval mode on the serving weights cast to bf16 (running statistics away
    from 0 / 1): 2e-3.  Both sides round every conv and BN output to bf16
    and accumulate in float32, in other orders; eval-mode BN normalizes in
    bf16 arithmetic on both (JAX's resnet.py:96-112 on jnp leaves, the
    port's BatchNorm2d).  Measured at most 5.7e-4 in train mode, 9.1e-4 in
    eval mode (a bf16 ulp, 2^-8, on a few elements).
  - the whole models, each also held nearer JAX's bf16 output than JAX's
    float32 one, so that a port computing in float32 fails:
      * the eval-mode bf16 CSPN-UNet: below 1e-2 and below half its
        distance from JAX's float32 output (measured 7.2e-4 subpixel and
        1.2e-3 plain, against 0.296: the recovered statistics amplify
        bf16 rounding, ROADMAP.md Queue 3, trap 5);
      * the tiny bf16 stereo model in train mode, JAX applied op by op
        (under jit XLA keeps excess precision inside its fusions, measured
        2.1e-4 from the port): below half its distance from JAX's float32
        output (measured 6.1e-5 against 4.4e-4);
      * the bf16 train step: batch statistics and ReLU masks turn each of
        the rare rounding flips where two bf16 implementations differ into
        a full ulp, and each layer's flips into more in the next, so the
        two bf16 steps drift as far apart as either is from the float32
        step (measured: the update 0.153 from JAX's bf16 update, 0.146 from
        its float32 one, JAX's own gap 0.133; the loss 2.6029074 against
        2.6027431 and 2.6023805).  The step is held within twice JAX's own
        gap of JAX's bf16 step, and at least half that gap away from its
        float32 step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cspn_tpu.models import decoder as jdecoder
from cspn_tpu.models import resnet as jresnet
from cspn_tpu.models import stereo as jstereo
from cspn_tpu.models import unet as junet
from cspn_tpu.train import loop as jloop
from cspn_tpu.train import state as jstate
from cspn_tpu.utils.precision import cast_floating as jcast_floating
from cspn_tpu_torch import config
from cspn_tpu_torch.models import convert, decoder, resnet, stereo, unet
from cspn_tpu_torch.train import evaluate, loop, state
from cspn_tpu_torch.utils.precision import cast_floating, torch_dtype

torch.set_num_threads(1)

BF16 = jnp.bfloat16
BLOCK_RTOL = 2e-3
HW = (32, 48)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _bf16(a: np.ndarray) -> np.ndarray:
    """`a` rounded to bf16, as float32."""
    return np.asarray(jnp.asarray(a, BF16).astype(jnp.float32))


def _load(module: torch.nn.Module, variables) -> torch.nn.Module:
    """The JAX variables of a submodule into the port's module (names
    relative to it), every key matched."""
    sd = {}
    for coll in ("params", "batch_stats"):
        for k, a in convert.convert_jax_tree(coll, variables.get(coll, {})).items():
            sd[k] = torch.from_numpy(np.array(a))
    missing, unexpected = module.load_state_dict(sd, strict=False)
    assert not unexpected and all(k.endswith("num_batches_tracked") for k in missing)
    return module


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def test_cast_floating_matches_jax():
    rng = np.random.default_rng(0)
    model = unet.cspn_unet_resnet18(cspn_steps=2, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for b in model.buffers():
            if b.is_floating_point():
                b.copy_(torch.from_numpy(rng.standard_normal(b.shape).astype(np.float32)))
    sd = model.state_dict()
    cast = cast_floating(sd)
    assert set(cast) == set(sd)
    for k, v in cast.items():
        if sd[k].is_floating_point():
            assert v.dtype == torch.bfloat16
            want = np.asarray(jcast_floating(jnp.asarray(sd[k].numpy())).astype(jnp.float32))
            np.testing.assert_array_equal(v.float().numpy(), want, err_msg=k)
        else:  # num_batches_tracked stays an integer
            assert v.dtype == sd[k].dtype and torch.equal(v, sd[k])
    assert all(v.dtype == torch.float32 for v in model.state_dict().values()
               if v.is_floating_point())  # a copy: the model keeps its float32 masters
    assert torch_dtype("float32") is None
    assert torch_dtype("bfloat16") == torch_dtype("int8") == torch.bfloat16
    with pytest.raises(ValueError, match="unknown dtype"):
        torch_dtype("float16")


def _block(kind):
    """(JAX module, the port's module, the input shapes NHWC, forward of
    the port's module on NCHW tensors)."""
    if kind == "stem":
        return (jresnet._StemS2DConv(64, dtype=BF16),
                resnet.Conv2d(4, 64, 7, stride=2, padding=3, bias=False),
                [(2, 32, 48, 4)], lambda m, x: m(x))
    if kind == "basic":
        return (jresnet.BasicBlock(64, stride=2, downsample=True, dtype=BF16),
                resnet.BasicBlock(32, 64, 2, True), [(2, 16, 24, 32)], lambda m, x: m(x))
    if kind == "bottleneck":
        return (jresnet.Bottleneck(16, stride=1, downsample=True, dtype=BF16),
                resnet.Bottleneck(32, 16, 1, True), [(2, 16, 24, 32)], lambda m, x: m(x))
    sub = kind.endswith("subpixel")
    if kind.startswith("up_proj_cat"):
        return (jdecoder.GudiUpProjCat(32, 31, 47, dtype=BF16, subpixel=sub),
                decoder.GudiUpProjCat(64, 16, 32, sub), [(2, 16, 24, 64), (2, 31, 47, 16)],
                lambda m, x, s: m(x, s, 31, 47))
    return (jdecoder.GudiUpProj(128, 31, 47, dtype=BF16, subpixel=sub),
            decoder.GudiUpProj(64, 128, sub), [(2, 16, 24, 64)], lambda m, x: m(x, 31, 47))


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("kind", ["stem", "basic", "bottleneck", "up_proj_subpixel", "up_proj_plain",
                                  "up_proj_cat_subpixel", "up_proj_cat_plain"])
def test_bf16_blocks_match_jax(kind, train):
    """Each block on the same bf16 inputs: bf16 convs, BN statistics in
    float32 with a bf16 output; in eval mode the serving weights cast to
    bf16 (running statistics included)."""
    jmod, pmod, shapes, fwd = _block(kind)
    if kind != "stem":
        jmod = jmod.clone(train=train)
    rng = np.random.default_rng(len(kind) + train)
    xs = [_bf16(rng.standard_normal(s).astype(np.float32)) for s in shapes]
    v = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(0), *map(jnp.asarray, xs)))
    if "batch_stats" in v:  # running statistics away from 0 / 1
        v["batch_stats"] = jax.tree.map(
            lambda a: (a + rng.uniform(0.5, 1.5, a.shape)).astype(np.float32), v["batch_stats"])
    _load(pmod, v).train(train)
    jin = [jnp.asarray(x, BF16) for x in xs]
    if train:
        want = jmod.apply(v, *jin, mutable=["batch_stats"])[0]
    else:
        want = jmod.apply(jcast_floating(jax.tree.map(jnp.asarray, v)), *jin)
        pmod.load_state_dict(cast_floating(pmod.state_dict()), assign=True)
    with torch.no_grad():
        got = fwd(pmod, *[_nchw(x).bfloat16() for x in xs])
    assert got.dtype == torch.bfloat16 and want.dtype == BF16
    want = np.asarray(want.astype(jnp.float32))
    assert _rel(got.float().permute(0, 2, 3, 1).numpy(), want) < BLOCK_RTOL


def _frames(n=2, hw=HW, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, *hw, 4)).astype(np.float32)
    x[..., 3] = np.abs(x[..., 3]) * (rng.random((n, *hw)) < 0.1)
    return x


@pytest.fixture(scope="module")
def unet_vars():
    """The JAX init of the ResNet-18 CSPN-UNet, and eval-mode statistics
    recovered from one train-mode apply (trap 3)."""
    x = _frames()
    m = junet._make(18, True, cspn_steps=2, cspn_backend="reference", train=True)
    v = jax.tree.map(np.asarray, jax.jit(m.init)(jax.random.PRNGKey(0), jnp.asarray(x)))
    _, upd = jax.jit(lambda v_, x_: m.apply(v_, x_, mutable=["batch_stats"]))(v, jnp.asarray(x))
    stats = jax.tree.map(lambda new, old: (np.asarray(new) - 0.9 * old) / 0.1,
                         upd["batch_stats"], v["batch_stats"])
    return x, v, {"params": v["params"], "batch_stats": stats}


@pytest.mark.parametrize("subpixel", [True, False], ids=["subpixel", "plain"])
def test_bf16_model_matches_jax(unet_vars, subpixel):
    """The serving model: JAX's bf16 CSPNUNet on its weights cast to bf16
    (its load_eval_state) against the port's, its weights cast by
    cast_floating."""
    x, _, v = unet_vars
    kw = dict(cspn_steps=2, cspn_backend="reference", subpixel=subpixel)
    want = np.asarray(jax.jit(junet._make(18, True, dtype=BF16, **kw).apply)(jcast_floating(v), x))
    want32 = np.asarray(jax.jit(junet._make(18, True, **kw).apply)(v, x))
    model = unet.cspn_unet_resnet18(cspn_steps=2, subpixel=subpixel, dtype=torch.bfloat16).eval()
    convert.load_jax_variables(model, v)
    model.load_state_dict(cast_floating(model.state_dict()), assign=True)
    assert model.dtype == torch.bfloat16 and not model.training
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == x.shape[:3]  # the CSPN runs float32
    bound = _rel(want, want32)
    assert 1e-3 < bound < 0.3  # bf16 moves the output, by the amplification above
    dist = _rel(got.numpy(), want)
    assert dist < 1e-2 and dist < 0.5 * _rel(got.numpy(), want32)


def test_bf16_train_step_matches_jax():
    """One SGD-Nesterov step of the bf16 model on float32 masters (JAX's
    make_train_step at dtype bfloat16): the loss, and the parameters after
    the step, float32 on both sides.  At 64x96 and a batch of 4: at 32x48
    and 2, train-mode BN over layer4's 1x2 maps makes the bf16 update
    differ from the float32 one by 74% in JAX itself (trap 5)."""
    x = _frames(4, (64, 96))
    v = jax.tree.map(np.asarray, jax.jit(junet._make(18, True, cspn_steps=2, train=True).init)(
        jax.random.PRNGKey(0), jnp.asarray(x)))
    rng = np.random.default_rng(3)
    gt = (2.0 + np.abs(rng.standard_normal(x.shape[:3]))).astype(np.float32)
    lr = 0.01
    kw = dict(cspn_steps=2, cspn_backend="reference", train=True)
    losses = {}
    for dt in (BF16, None):
        mj = junet._make(18, True, dtype=dt, **kw)
        st = jstate.TrainState.create(apply_fn=mj.apply, params=v["params"],
                                      batch_stats=v["batch_stats"],
                                      tx=jstate.make_optimizer(lr, momentum=0.9, weight_decay=1e-4,
                                                               nesterov=True))
        new, loss, _ = jloop.make_train_step(mj, "l1")(st, jnp.asarray(x), jnp.asarray(gt))
        losses[dt] = (float(loss), convert.convert_jax_tree("params",
                                                            jax.tree.map(np.asarray, new.params)))
    cfg = config.PRESETS["synthetic_smoke"]
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, cspn_steps=2,
                                                               dtype="bfloat16"))
    model = evaluate.build_model(cfg, train=True, device="cpu")
    convert.load_jax_variables(model, v)
    assert model.dtype == torch.bfloat16 and not model.quant  # int8 is serving-only
    assert all(p.dtype == torch.float32 for p in model.parameters())  # float32 masters
    opt = state.make_optimizer(model.parameters(), lr, momentum=0.9, weight_decay=1e-4,
                               nesterov=True)
    loss, _ = loop.make_train_step(model, opt, "l1")(torch.from_numpy(x), torch.from_numpy(gt))
    want_loss, want = losses[BF16]
    loss32, want32 = losses[None]
    gap = abs(want_loss - loss32)
    assert abs(loss.item() - want_loss) <= max(2 * gap, 1e-3 * want_loss)
    assert abs(loss.item() - loss32) > 0.5 * gap  # not the float32 step's loss
    old = convert.convert_jax_tree("params", v["params"])
    got = {k: p.detach().numpy() for k, p in model.named_parameters()}
    assert all(p.grad.dtype == torch.float32 for p in model.parameters())
    flat = lambda d: np.concatenate([(d[k] - old[k]).ravel() for k in sorted(old)])  # noqa: E731
    bound = _rel(flat(want), flat(want32))  # the update's bf16 distance in JAX's own step
    assert 1e-4 < bound < 0.5
    assert _rel(flat(got), flat(want)) < min(2 * bound, 0.6)
    assert _rel(flat(got), flat(want32)) > 0.5 * bound  # not the float32 update


def test_bf16_stereo_matches_jax():
    """The tiny stereo model at dtype bfloat16 in training mode (params
    float32; heads, 3D CSPN and regression float32) against JAX's
    PSMNetCSPN(dtype=bf16), both applying their float32 reference CSPN."""
    from cspn_tpu_torch.data import SyntheticStereoDataset
    from cspn_tpu_torch.train import stereo_loop

    ds = SyntheticStereoDataset(length=2, hw=HW, max_disp=8, seed=7)
    left, right = (np.stack([ds[i][k] for i in range(2)]) for k in ("left", "right"))
    kw = dict(max_disp=8, features=4, cspn_steps=2, train=True)
    jl, jr = jnp.asarray(left), jnp.asarray(right)
    v = jax.tree.map(np.asarray, jax.jit(jstereo.PSMNetCSPN(**kw).init)(
        jax.random.PRNGKey(0), jl[:1], jr[:1]))
    # op by op (module docstring)
    want, want32 = (np.asarray(jstereo.PSMNetCSPN(dtype=dt, **kw).apply(
        v, jl, jr, mutable=["batch_stats"])[0]) for dt in (BF16, None))
    model = stereo_loop.build_stereo_model(
        stereo_loop.StereoConfig(max_disp=8, features=4, cspn_steps=2, dtype="bfloat16"),
        train=True, device="cpu")
    convert.load_jax_variables(model, v)
    assert model.dtype == torch.bfloat16
    with torch.no_grad():
        got = model(torch.from_numpy(left), torch.from_numpy(right))
    assert got.dtype == torch.float32 and np.isfinite(got.numpy()).all()
    bound = _rel(want, want32)
    assert 0 < bound < 0.3
    assert _rel(got.numpy(), want) < 0.5 * _rel(got.numpy(), want32)
    with pytest.raises(ValueError, match="no int8 form"):
        stereo.PSMNetCSPN(max_disp=8, features=4, dtype="int8")
