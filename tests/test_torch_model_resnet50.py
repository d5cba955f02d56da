"""The port's ResNet-50 CSPN-UNet (the nyu_eval trunk) against the JAX
package's at 32x48, cspn_steps=8, in train-mode BN and in eval-mode BN with
real batch statistics.  Float64 on both sides, for the reason given in
tests/test_torch_model.py; tolerance rtol 1e-4, atol 1e-5."""

import numpy as np
import pytest
import torch

from test_torch_model import ATOL, RTOL, batch_32x48, jax_reference, port_forward

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def r50():
    x = batch_32x48()
    ref = jax_reference(50, True, x)
    del ref["v32"]  # ~0.9 GB this file does not use
    return x, ref


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_resnet50_forward_matches_jax(r50, mode):
    x, ref = r50
    variables, want = ref[mode]
    got = port_forward(50, True, variables, x, train=mode == "train")
    assert got.shape == want.shape == (2, 32, 48)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
