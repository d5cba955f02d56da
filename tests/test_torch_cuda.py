"""The 2D CSPN CUDA kernels (forward and backward) against their plain
version, on the card.

Marked `cuda`: without a card every test here skips.  On a machine with
one (and without JAX, which tests/conftest.py imports) run:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerance: 1e-4 x max|plain| (FMA contraction and summation order differ),
for the output and for each gradient.
"""

import pytest
import torch

from cspn_tpu_torch.ops import cspn_cuda, cspn_ref
from cspn_tpu_torch.ops.cspn import cspn2d

pytestmark = pytest.mark.cuda

TOL = 1e-4


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.Generator(device="cuda").manual_seed(0)


def _inputs(gen, n, h, w, with_sparse=True):
    g = torch.randn(n, 8, h, w, device="cuda", generator=gen)
    b = torch.rand(n, h, w, device="cuda", generator=gen) * 5
    s = None
    if with_sparse:
        s = torch.where(torch.rand(n, h, w, device="cuda", generator=gen) < 0.05,
                        torch.randn(n, h, w, device="cuda", generator=gen), 0.0)
    return g, b, s


def _plain(g_cf, b, s, steps, norm_type):
    return cspn_ref.cspn2d_reference(g_cf.movedim(1, -1), b, s, steps=steps, norm_type=norm_type)


@pytest.mark.parametrize("norm_type", ["8sum", "8sum_abs"])
@pytest.mark.parametrize("with_sparse", [True, False])
@pytest.mark.parametrize("steps", [0, 1, 2, 24])
@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 13, 17), (3, 33, 65), (2, 228, 304)])
def test_kernel_matches_plain(gen, shape, steps, with_sparse, norm_type):
    g, b, s = _inputs(gen, *shape, with_sparse)
    before = cspn_cuda.launches
    got = cspn_cuda.cspn2d_cuda(g, b, s, steps=steps, norm_type=norm_type, channel_first=True)
    torch.cuda.synchronize()
    assert cspn_cuda.launches == before + 1
    want = _plain(g, b, s, steps, norm_type)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert (got - want).abs().max().item() <= TOL * want.abs().max().item()


def test_zero_gates_and_channels_last(gen):
    g, b, s = _inputs(gen, 2, 13, 17)
    g[0, :, 4:9, 4:9] = 0.0
    got = cspn2d(g.movedim(1, -1), b, s, steps=24)  # NHWC guidance, backend auto
    want = _plain(g, b, s, 24, "8sum")
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= TOL * want.abs().max().item()


def test_bf16_io_rounds_inputs(gen):
    g, b, s = _inputs(gen, 2, 13, 17)
    got = cspn_cuda.cspn2d_cuda(g, b, s, steps=8, channel_first=True, io_dtype=torch.bfloat16)
    r = [t.to(torch.bfloat16).float() for t in (g, b, s)]
    want = _plain(*r, 8, "8sum")
    assert (got - want).abs().max().item() <= TOL * want.abs().max().item()


def test_wrapper_refuses_what_the_kernel_does_not_take(gen):
    g, b, s = _inputs(gen, 2, 13, 17)
    with pytest.raises(TypeError):
        cspn_cuda.cspn2d_cuda(g.double(), b, s, channel_first=True)
    with pytest.raises(ValueError, match="contiguous"):
        cspn_cuda.cspn2d_cuda(g, b.transpose(1, 2).contiguous().transpose(1, 2), s, channel_first=True)
    with pytest.raises(ValueError, match=r"must be \[2,13,17\]"):
        cspn_cuda.cspn2d_cuda(g, b[:, :12].contiguous(), None, channel_first=True)
    with pytest.raises(ValueError, match=r"\[N,8,H,W\]"):
        cspn_cuda.cspn2d_cuda(g[:, :7], b, s, channel_first=True)
    with pytest.raises(ValueError, match="norm_type"):
        cspn_cuda.cspn2d_cuda(g, b, s, channel_first=True, norm_type="8max")
    with pytest.raises(ValueError, match="on cpu"):
        cspn_cuda.cspn2d_cuda(g, b.cpu(), s, channel_first=True)


def _grads(fn, g, b, s, ct):
    g, b = g.clone().requires_grad_(True), b.clone().requires_grad_(True)
    dg, db = torch.autograd.grad((fn(g, b, s) * ct).sum(), (g, b), allow_unused=True)
    return torch.zeros_like(g) if dg is None else dg, db  # steps=0: the plain output is blur


@pytest.mark.parametrize("norm_type", ["8sum", "8sum_abs"])
@pytest.mark.parametrize("with_sparse", [True, False])
@pytest.mark.parametrize("steps", [0, 1, 2, 24])
@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 13, 17), (3, 33, 65), (2, 228, 304)])
def test_backward_kernel_matches_plain(gen, shape, steps, with_sparse, norm_type):
    g, b, s = _inputs(gen, *shape, with_sparse)
    g[0, :, :5, :5] = 0.0  # zero gates (and zero guidance) in one corner
    ct = torch.randn(shape, device="cuda", generator=gen)
    before = cspn_cuda.bwd_launches
    got = _grads(lambda g, b, s: cspn_cuda.cspn2d_cuda(g, b, s, steps=steps, norm_type=norm_type,
                                                         channel_first=True), g, b, s, ct)
    torch.cuda.synchronize()
    assert cspn_cuda.bwd_launches == before + 1
    want = _grads(lambda g, b, s: _plain(g, b, s, steps, norm_type), g, b, s, ct)
    for a, w in zip(got, want):
        assert a.shape == w.shape and a.dtype == torch.float32 and torch.isfinite(a).all()
        assert (a - w).abs().max().item() <= TOL * max(w.abs().max().item(), 1e-30)


def test_backward_takes_strided_cotangents_and_unrounded_residuals(gen):
    g, b, s = _inputs(gen, 2, 13, 17)
    w = torch.randn(2, 17, 13, device="cuda", generator=gen)

    def loss(io_dtype):  # the cotangent reaches the kernel transposed
        def fn(g, b, s):
            return cspn_cuda.cspn2d_cuda(g, b, s, steps=8, channel_first=True, io_dtype=io_dtype)
        return lambda g, b, s: fn(g, b, s).transpose(1, 2) * w

    ones = torch.ones(2, 17, 13, device="cuda")
    got = _grads(loss(None), g, b, s, ones)
    want = _grads(lambda g, b, s: _plain(g, b, s, 8, "8sum").transpose(1, 2) * w, g, b, s, ones)
    for a, x in zip(got, want):
        assert (a - x).abs().max().item() <= TOL * x.abs().max().item()
    # bf16 I/O rounds the forward's inputs only: the backward is the adjoint
    # of the f32 function at the unrounded inputs, as the JAX custom VJP
    for a, x in zip(_grads(loss(torch.bfloat16), g, b, s, ones), got):
        assert torch.equal(a, x)


def test_train_step_on_the_card_launches_both_kernels(gen):
    """A resnet18 train step through the kernels launches each once; its
    gradients are as close to the float64 plain step as the float32 plain
    step's (chip_smoke.py's criterion: 1e-3 x max, or 8x the plain step's
    own distance), with deterministic cuDNN and the ground truth 1 to 2 away
    from every prediction (no L1 sign flips)."""
    from cspn_tpu_torch.models import unet
    from cspn_tpu_torch.train.loop import make_train_step
    from cspn_tpu_torch.train.state import make_optimizer

    torch.backends.cudnn.allow_tf32 = False
    x = torch.randn(2, 64, 96, 4, device="cuda", generator=gen)
    grads = {}
    torch.backends.cudnn.deterministic = True
    try:
        for backend, dtype in (("kernel", torch.float32), ("reference", torch.float32),
                               ("reference", torch.float64)):
            model = unet.cspn_unet_resnet18(cspn_steps=4, cspn_backend=backend,
                                            generator=torch.Generator().manual_seed(0))
            model = model.to("cuda", dtype)
            if backend == "kernel":  # ground truth 1 to 2 from each prediction, either side
                with torch.no_grad():
                    pred = model(x)
                side = torch.where(torch.rand(pred.shape, device="cuda", generator=gen) < 0.5, -1.0, 1.0)
                depth = pred + side * (1.0 + torch.rand(pred.shape, device="cuda", generator=gen))
            step = make_train_step(model, make_optimizer(model.parameters()))
            before = (cspn_cuda.launches, cspn_cuda.bwd_launches)
            loss, error = step(x.to(dtype), depth.to(dtype))
            torch.cuda.synchronize()
            launched = (cspn_cuda.launches - before[0], cspn_cuda.bwd_launches - before[1])
            assert launched == ((1, 1) if backend == "kernel" else (0, 0))
            assert torch.isfinite(loss) and torch.isfinite(error["RMSE"])
            grads[backend, dtype] = {k: p.grad.double() for k, p in model.named_parameters()}
    finally:
        torch.backends.cudnn.deterministic = False
    kernel, plain = grads["kernel", torch.float32], grads["reference", torch.float32]
    for k, g64 in grads["reference", torch.float64].items():
        d_k, d_r = (kernel[k] - g64).abs().max().item(), (plain[k] - g64).abs().max().item()
        assert d_k <= 1e-3 * g64.abs().max().item() or d_k <= 8 * d_r, k


def test_model_on_the_card_uses_the_kernel(gen):
    from cspn_tpu_torch.models import unet

    torch.backends.cudnn.allow_tf32 = False
    model = unet.cspn_unet_resnet18(cspn_steps=4, generator=torch.Generator().manual_seed(0))
    model = model.cuda().eval()
    x = torch.randn(2, 64, 96, 4, device="cuda", generator=gen)
    before = cspn_cuda.launches
    with torch.inference_mode():
        got = model(x)
        model.cspn_backend = "reference"
        want = model(x)
    assert cspn_cuda.launches == before + 1
    assert (got - want).abs().max().item() <= TOL * want.abs().max().item()
