"""The 2D CSPN CUDA kernel against its plain version, on the card.

Marked `cuda`: without a card every test here skips.  On a machine with
one (and without JAX, which tests/conftest.py imports) run:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerance: 1e-4 x max|plain| (FMA contraction and summation order differ).
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


def test_backward_raises_naming_the_roadmap(gen):
    g, b, s = _inputs(gen, 2, 13, 17)
    g.requires_grad_(True)
    out = cspn_cuda.cspn2d_cuda(g, b, s, steps=4, channel_first=True)
    with pytest.raises(NotImplementedError, match="Queue 2 item 2"):
        out.sum().backward()


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
