"""The step-body probe's plain version (cspn_tpu_torch/utils/step_probe.py;
csrc/step_probe.cu runs it on the card) against a numpy transcription of
the TPU probe's loop body (scripts/vpu_probe.py:54-66) on each [8,512]
block: rows outside the block 0, the partial sums grouped by dx in the
probe's order, the two column shifts with zero fill, x 0.124.

Inputs come from numpy seeds.  float32 state: rtol 1e-5, atol 1e-6 over 4
iterations (the plain version fuses each product after the first into its
add, as the kernel's FMAs; the transcription rounds them apart).
"""

import numpy as np
import pytest
import torch

from cspn_tpu_torch.utils import step_probe

torch.set_num_threads(1)

_OFFS = ((1, 1), (1, 0), (1, -1), (0, 1), (0, -1), (-1, 1), (-1, 0), (-1, -1))
_BY_DX = {dx: [d for d, (_, ddx) in enumerate(_OFFS) if ddx == dx] for dx in (1, 0, -1)}


def _shift_w(x, dx):
    if dx == 0:
        return x
    zeros = np.zeros(x.shape[:-1] + (abs(dx),), x.dtype)
    if dx > 0:
        return np.concatenate([x[..., dx:], zeros], axis=-1)
    return np.concatenate([zeros, x[..., :dx]], axis=-1)


def numpy_probe(g, x, iters):
    """vpu_probe.py:54-66 on one block: g [8,H,W], x [H,W], float32."""
    h = x.shape[0]
    xpad = np.zeros((h + 2, x.shape[1]), np.float32)
    xpad[1:h + 1] = x
    for _ in range(iters):
        rows = {dy: xpad[1 + dy:1 + dy + h] for dy in (-1, 0, 1)}
        u = {dx: sum(g[d] * rows[_OFFS[d][0]] for d in ds) for dx, ds in _BY_DX.items()}
        y = u[0] + _shift_w(u[1], 1) + _shift_w(u[-1], -1)
        xpad[1:h + 1] = y * np.float32(0.124)
    return xpad[1:h + 1]


@pytest.mark.parametrize("gate_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("iters", [1, 4])
def test_plain_version_is_the_tpu_probe_body(gate_dtype, iters):
    g, x = step_probe.probe_inputs(2, gate_dtype, torch.float32, seed=iters)
    before = step_probe.launches
    got = step_probe.step_probe(g, x, iters)  # CPU tensors: the plain version
    assert step_probe.launches == before
    assert torch.equal(got, step_probe.step_probe_ref(g, x, iters))
    g32 = g.float().numpy()
    for b in range(2):
        want = numpy_probe(g32[b], x[b].numpy(), iters)
        np.testing.assert_allclose(got[b].numpy(), want, rtol=1e-5, atol=1e-6)


def test_bf16_state_stays_bf16_and_near_the_f32_body():
    g, x = step_probe.probe_inputs(1, torch.bfloat16, torch.bfloat16)
    got = step_probe.step_probe(g, x, 3)
    assert got.dtype == torch.bfloat16
    want = numpy_probe(g[0].float().numpy(), x[0].float().numpy(), 3)
    # bf16 keeps 8 bits: each of the 3 iterations rounds ~6 times
    np.testing.assert_allclose(got[0].float().numpy(), want, rtol=5e-2, atol=1e-2)


def test_probe_refuses_what_the_kernel_does_not_take():
    g, x = step_probe.probe_inputs(1, torch.float32, torch.float32)
    with pytest.raises(TypeError, match="not among"):
        step_probe.step_probe(g, x.to(torch.bfloat16), 1)
    with pytest.raises(ValueError, match=r"\[B,8,8,512\]"):
        step_probe.step_probe(g[:, :, :4].contiguous(), x, 1)


def test_run_probe_measures_only_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        step_probe.run_probe()
