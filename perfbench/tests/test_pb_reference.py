"""The plain reference against the program, float64 at a small size: the
same served function and the same train steps."""

import pytest
import torch

from perfbench.reference import layers, unet
from perfbench.harness import weights


def _program(arch, steps, train=False):
    from cspn_tpu_torch.models.unet import CSPNUNet

    kind, depths = layers.ARCHS[arch]
    return CSPNUNet(block=kind, layers=depths, cspn_steps=steps).double().train(train)


def _inputs(n, h, w, gen):
    x = torch.rand(n, h, w, 4, generator=gen, dtype=torch.float64)
    x[..., 3] = torch.where(torch.rand(n, h, w, generator=gen, dtype=torch.float64) < 0.05,
                            5 * x[..., 3], 0.0)
    return x


@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_layer_list_is_the_programs_state_dict(arch):
    m = _program(arch, 4)
    got = {k: tuple(v.shape) for k, v in m.named_parameters()}
    assert got == layers.param_shapes(arch)
    bn = {k.rsplit(".", 1)[0]: v.shape[0] for k, v in m.state_dict().items()
          if k.endswith("running_mean")}
    assert bn == layers.batch_norms(arch)


@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
@pytest.mark.parametrize("norm_type", ["8sum", "8sum_abs"])
def test_forward_matches_the_program(arch, norm_type):
    gen = torch.Generator().manual_seed(1)
    m = _program(arch, 6)
    m.cspn_norm_type = norm_type
    w = {k: v.double() for k, v in weights.make(arch, 3, "cpu").items()}
    state = m.state_dict()
    with torch.no_grad():
        for k, v in w.items():
            state[k].copy_(v)
        for k, v in state.items():  # BN statistics away from the init's
            if k.endswith("running_var"):
                v.uniform_(0.5, 2.0, generator=gen)
            elif k.endswith("running_mean"):
                v.uniform_(-0.1, 0.1, generator=gen)
    params = {k: state[k] for k in w}
    bufs = {k: v for k, v in state.items() if k.endswith(("running_mean", "running_var"))}
    x = _inputs(2, 36, 52, gen)
    with torch.no_grad():
        a = m(x)
        b = unet.Net(arch, params, bufs, 6, norm_type)(x)
    assert torch.allclose(a, b, rtol=1e-9, atol=1e-9 * float(b.abs().max()))


def test_train_steps_match_the_programs_step():
    from cspn_tpu_torch.train.loop import make_train_step
    from cspn_tpu_torch.train.state import make_optimizer

    gen = torch.Generator().manual_seed(2)
    arch = "resnet18"
    m = _program(arch, 4, train=True)
    w = {k: v.double() for k, v in weights.make(arch, 5, "cpu").items()}
    with torch.no_grad():
        for k, p in m.named_parameters():
            p.copy_(w[k])
    opt = make_optimizer(m.parameters(), 0.01, 0.9, 1e-4, True)
    step = make_train_step(m, opt, "l1")
    batches = [(_inputs(2, 36, 52, gen), 5 * torch.rand(2, 36, 52, generator=gen,
                                                         dtype=torch.float64)) for _ in range(3)]
    losses = [float(step(x, y)[0]) for x, y in batches]
    net = unet.Net(arch, dict(w), unet.bn_buffers(arch, "cpu", torch.float64), 4)
    ref_losses, _ = unet.train_steps(net, batches, 0.01, 0.9, 1e-4)
    p = net.p
    assert losses == pytest.approx([float(x) for x in ref_losses], rel=1e-10)
    for k, q in m.named_parameters():
        assert torch.allclose(q.detach(), p[k], rtol=1e-8, atol=1e-10), k


def test_fake_quant_levels():
    t = torch.linspace(-1, 1, 1001).view(1, 1, 1, -1)
    for quant, levels in (("int8", 127), ("int4", 7)):
        q = unet.fake_quant(t, quant, (1, 2, 3))
        assert len(torch.unique(q)) <= 2 * levels + 1
        assert float((q - t).abs().max()) <= 0.5 / levels + 1e-7
    q = unet.fake_quant(t, "fp8", (1, 2, 3))  # e4m3: 3 mantissa bits, 1/16 apart at most
    assert float(((q - t).abs() / t.abs().clamp_min(2 ** -6)).max()) <= 2 ** -4 + 1e-6
    assert len(torch.unique(q)) < 256
