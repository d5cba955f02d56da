"""The 3D CSPN kernels' schedule on the CPU (ops/cspn3d_cuda.py): the
partition `plan_volume` hands the persistent sweep, the CUDA launches per
call, the rule that a forward keeps its states only when a backward will
follow, and the backward's algorithm (the reverse sweep over the
transposed stencil and the gate cotangents, both on the forward's kept
states) transcribed in plain PyTorch against the TPU backward kernel.

The kernels themselves run only on the card (tests/test_torch_cuda.py,
chip_smoke.py).  Here `_launch` / `_launch_bwd` are replaced by plain
versions with the kernels' interfaces.  Inputs come from numpy seeds.
Tolerance against `affinity_propagate3d_fused_bwd` (interpret mode, float32
gates): rtol 1e-5, atol 1e-5 over 24 steps, as tests/test_torch_cspn3d.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cspn_tpu.ops import cspn3d_pallas
from cspn_tpu_torch.ops import cspn3d_cuda, cspn_ref
from cspn_tpu_torch.ops.neighbors import neighbor_offsets, shift

torch.set_num_threads(1)

H100_SMS, H100_SMEM = 132, 232_448  # SMs; shared memory a block may opt in to (227 KB)
AXES = (-3, -2, -1)


# the stereo b4 volume (and the demo's), the sharded stereo segment (S = 2,
# K = 8), odd test shapes, a volume whose gates exceed the chip (82 MB), a
# volume smaller than one warp's columns; the stereo model's volume at
# 1080x1920 and max_disp 192 (6.2 M voxels), one deeper than 4 x SMs and one
# on a card with 8 KB of shared memory (several bricks a block)
@pytest.mark.parametrize("dhw, smem", [
    ((48, 64, 128), H100_SMEM), ((40, 64, 128), H100_SMEM), ((3, 5, 7), H100_SMEM),
    ((4, 9, 13), H100_SMEM), ((96, 64, 128), H100_SMEM), ((1, 1, 1), H100_SMEM),
    ((4, 33, 32), H100_SMEM), ((9, 3, 50), H100_SMEM), ((48, 270, 480), H100_SMEM),
    ((600, 8, 16), H100_SMEM), ((48, 64, 128), 8192)])
def test_plan_volume_owns_every_voxel_once(dhw, smem):
    plan = cspn3d_cuda.plan_volume(*dhw, H100_SMS, smem)
    owned = np.zeros(int(np.prod(dhw)), np.int64)
    for b in range(plan.blocks):
        voxels = plan.owned(b)
        assert len(voxels) > 0
        np.add.at(owned, voxels, 1)
    assert (owned == 1).all()
    assert plan.blocks == min(plan.bricks, H100_SMS)
    assert plan.loops == (plan.bricks > H100_SMS)
    assert not plan.loops or (plan.n_smem, plan.smem_bytes) == (0, 0)
    assert plan.slabs == -(-dhw[0] // cspn3d_cuda.SLAB)
    assert plan.smem_bytes <= smem
    assert plan.n_smem in cspn3d_cuda.SMEM_PLANES and plan.n_smem + plan.n_l2 == 26
    # with a brick a block, shared memory takes as many planes as the built
    # counts allow
    assert plan.loops or plan.n_l2 == 0 or (
        4 * (plan.n_smem + 3) * cspn3d_cuda.SLAB * plan.cols > smem)


def test_plan_volume_at_the_paths_shapes():
    stereo = cspn3d_cuda.plan_volume(48, 64, 128, H100_SMS, H100_SMEM)
    assert (stereo.slabs, stereo.parts, stereo.cols, stereo.n_smem, stereo.n_l2) == (
        12, 11, 745, 18, 8)
    segment = cspn3d_cuda.plan_volume(40, 64, 128, H100_SMS, H100_SMEM)
    assert (segment.blocks, segment.cols, segment.n_smem, segment.n_l2) == (130, 631, 22, 4)
    big = cspn3d_cuda.plan_volume(96, 64, 128, H100_SMS, H100_SMEM)
    # more columns than a block has threads: each thread takes two
    assert (big.blocks, big.cols, big.n_smem, big.n_l2) == (120, 1639, 6, 20)
    assert big.cols > cspn3d_cuda.SWEEP_THREADS
    tiny = cspn3d_cuda.plan_volume(2, 3, 4, H100_SMS, H100_SMEM)  # smaller than one block
    assert (tiny.blocks, tiny.cols, tiny.n_smem) == (1, 12, 26)
    # fewer SMs: more columns a block
    small_card = cspn3d_cuda.plan_volume(48, 64, 128, 66, H100_SMEM)
    assert (small_card.blocks, small_card.cols) == (60, 1639)
    # 1080x1920 at max_disp 192: one brick a block, every gate read from L2
    full_hd = cspn3d_cuda.plan_volume(48, 270, 480, H100_SMS, H100_SMEM)
    assert (full_hd.bricks, full_hd.blocks, full_hd.cols, full_hd.n_smem) == (132, 132, 11782, 0)
    # wider: a part takes the most columns shared memory holds, the grid
    # the SMs, and 36 blocks a second brick
    wide = cspn3d_cuda.plan_volume(48, 400, 480, H100_SMS, H100_SMEM)
    assert (wide.bricks, wide.blocks, wide.cols, wide.n_smem) == (168, 132, 14528, 0)
    # deeper than 4 x SMs: a slab a brick, 18 blocks a second one
    deep = cspn3d_cuda.plan_volume(600, 8, 16, H100_SMS, H100_SMEM)
    assert (deep.bricks, deep.blocks, deep.cols, deep.n_smem) == (150, 132, 128, 0)
    assert deep.loops and wide.loops and not full_hd.loops


def test_plan_volume_at_both_gate_dtypes():
    """bf16 gates pack two a shared-memory word beside the float32 centre
    weight (slot_words, odd for the banks): every path's volume keeps all 26
    planes on chip at bf16, where float32 keeps 18 (stereo b4, demo3d) or
    22 (the sharded segment)."""
    assert [cspn3d_cuda.slot_words(n, 4) for n in (0, 18, 26)] == [1, 19, 27]
    assert [cspn3d_cuda.slot_words(n, 2) for n in (0, 2, 18, 24, 26)] == [1, 3, 11, 13, 15]
    for dhw, f32_planes in (((48, 64, 128), 18), ((40, 64, 128), 22), ((4, 9, 13), 26)):
        f32 = cspn3d_cuda.plan_volume(*dhw, H100_SMS, H100_SMEM)
        bf16 = cspn3d_cuda.plan_volume(*dhw, H100_SMS, H100_SMEM, gate_bytes=2)
        assert (f32.n_smem, bf16.n_smem, bf16.n_l2) == (f32_planes, 26, 0)
        assert (bf16.blocks, bf16.cols, bf16.parts) == (f32.blocks, f32.cols, f32.parts)
        assert bf16.smem_bytes == 4 * 15 * cspn3d_cuda.SLAB * bf16.cols <= H100_SMEM
    # a card with less shared memory: bf16 still fits more planes than float32
    f32, bf16 = (cspn3d_cuda.plan_volume(48, 64, 128, H100_SMS, 120_000, gate_bytes=b)
                 for b in (4, 2))
    assert f32.n_smem < bf16.n_smem < 26 and bf16.smem_bytes <= 120_000
    assert cspn3d_cuda.slot_words(bf16.n_smem + 2, 2) * 4 * cspn3d_cuda.SLAB * bf16.cols > 120_000


def test_plan_volume_refuses_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="empty"):
        cspn3d_cuda.plan_volume(0, 64, 128, H100_SMS, H100_SMEM)
    with pytest.raises(ValueError, match="int indices"):
        cspn3d_cuda.plan_volume(1 << 11, 1 << 10, 1 << 10, H100_SMS, H100_SMEM)
    with pytest.raises(ValueError, match="no warp"):
        cspn3d_cuda.plan_volume(48, 64, 128, H100_SMS, 4 * cspn3d_cuda.SLAB * 31)


@pytest.mark.parametrize("steps, want", [(24, (1, 2)), (8, (1, 2)), (1, (1, 2)), (0, (0, 0))])
def test_cuda_launches_per_call(steps, want):
    assert cspn3d_cuda.cuda_launches_per_call(steps) == want


def _plain_states(gates, x0, steps):
    xs = [x0]
    for _ in range(steps):
        xs.append(cspn_ref.propagate_nd_reference(gates, xs[-1], 1))
    return xs


def _plain_backward_on_states(gates, x0, states, ct, steps):
    """csrc/cspn3d_bwd.cu's algorithm in plain PyTorch: the reverse sweep
    gathers w_d[q - off_d] v[q - off_d] (the transposed stencil), the gate
    cotangents sum v_{t+1}[p] (x_t[p + off_d] - x_t[p]) over the kept
    states; no replay."""
    offs = neighbor_offsets(3, 3)
    center = 1.0 - gates.sum(1)
    xs = [x0, *states]
    v, vs = ct, [None] * steps  # vs[t] = v_{t+1}
    for t in reversed(range(steps)):
        vs[t] = v
        nv = center * v
        for d, off in enumerate(offs):
            nv = nv + shift(gates[:, d] * v, tuple(-o for o in off), AXES)
        v = nv
    wbar = torch.stack([
        sum(vs[t] * (shift(xs[t], off, AXES) - xs[t]) for t in range(steps))
        if steps else torch.zeros_like(x0) for off in offs], dim=1)
    return wbar, v


@pytest.fixture
def plain_kernels(monkeypatch):
    """`_launch` / `_launch_bwd` replaced by plain versions with the
    kernels' interfaces; records what each call was given."""
    calls = {"fwd": [], "bwd": [], "gate_dtypes": []}

    def fake_launch(gates, x0, steps, keep_states=False):
        calls["gate_dtypes"].append(gates.dtype)
        xs = _plain_states(gates.float(), x0, steps)  # the kernels widen bf16 gates
        states = torch.stack(xs[1:-1]) if keep_states and steps > 1 else (
            x0.new_empty((0, *x0.shape)) if keep_states else None)
        calls["fwd"].append((keep_states, states))
        return xs[-1], states

    def fake_launch_bwd(gates, x0, states, ct, steps):
        calls["bwd"].append(states)
        calls["gate_dtypes"].append(gates.dtype)
        return _plain_backward_on_states(gates.float(), x0, list(states), ct, steps)

    monkeypatch.setattr(cspn3d_cuda, "_launch", fake_launch)
    monkeypatch.setattr(cspn3d_cuda, "_launch_bwd", fake_launch_bwd)
    return calls


def _inputs(seed, shape, requires_grad):
    rng = np.random.default_rng(seed)
    g = rng.random((shape[0], 26, *shape[1:])).astype(np.float32) + 0.05
    g /= g.sum(1, keepdims=True)
    g[0, :, :1, :2, :3] = 0.0  # zero gates: the centre weight is 1 there
    x0 = rng.standard_normal(shape).astype(np.float32)
    ct = rng.standard_normal(shape).astype(np.float32)
    gt, xt = torch.from_numpy(g), torch.from_numpy(x0)
    return g, x0, ct, gt.requires_grad_(requires_grad), xt.requires_grad_(requires_grad)


@pytest.mark.parametrize("shape, steps", [((2, 3, 5, 7), 24), ((1, 4, 9, 13), 5), ((3, 1, 1, 1), 2),
                                          ((1, 2, 3, 4), 1)])
def test_backward_on_kept_states_matches_the_tpu_kernel(plain_kernels, shape, steps):
    g, x0, ct, gt, xt = _inputs(sum(shape) + steps, shape, True)
    out = cspn3d_cuda._run(gt, xt, steps)
    got_w, got_x = torch.autograd.grad(out, (gt, xt), torch.from_numpy(ct))
    (keep, states), = plain_kernels["fwd"]
    assert keep and plain_kernels["bwd"] == [states]  # the backward got the forward's states
    assert states.shape == (steps - 1, *shape)
    want_w, want_x = cspn3d_pallas.affinity_propagate3d_fused_bwd(
        jnp.asarray(x0), jnp.asarray(g), jnp.asarray(ct), steps=steps, interpret=True,
        gate_dtype=jnp.float32)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=1e-5, atol=1e-5)


def test_bf16_gate_route_hands_both_kernels_the_rounded_gates(plain_kernels):
    """gate_dtype bfloat16: the forward and the backward kernel get the same
    bf16 gates (the backward's adjoint at the rounded gates), the gate
    cotangent comes back float32 for the unrounded gates, and the whole
    equals autograd of the plain version of the route."""
    g, x0, ct, gt, xt = _inputs(5, (2, 3, 5, 7), True)
    out = cspn3d_cuda._run(gt, xt, 6, torch.bfloat16)
    got_w, got_x = torch.autograd.grad(out, (gt, xt), torch.from_numpy(ct))
    assert plain_kernels["gate_dtypes"] == [torch.bfloat16] * 2
    assert got_w.dtype == torch.float32
    gp, xp = (torch.from_numpy(a).requires_grad_(True) for a in (g, x0))
    want = cspn3d_cuda.propagate3d_reference(gp, xp, steps=6, gate_dtype=torch.bfloat16)
    want_w, want_x = torch.autograd.grad(want, (gp, xp), torch.from_numpy(ct))
    torch.testing.assert_close(out, want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got_w, want_w, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got_x, want_x, rtol=1e-5, atol=1e-6)
    with torch.no_grad():  # a forward no backward follows rounds the same way
        cspn3d_cuda._run(gt, xt, 6, torch.bfloat16)
    assert plain_kernels["gate_dtypes"][-1] == torch.bfloat16


@pytest.mark.parametrize("case", ["no_grad", "inputs_without_grad", "gates_only", "x0_only"])
def test_forward_keeps_states_only_when_a_backward_follows(plain_kernels, case):
    grad = case in ("gates_only", "x0_only")
    _, _, _, gt, xt = _inputs(1, (2, 3, 5, 7), False)
    if case == "gates_only":
        gt.requires_grad_(True)
    if case == "x0_only":
        xt.requires_grad_(True)
    if case == "no_grad":
        gt.requires_grad_(True)
        with torch.no_grad():
            out = cspn3d_cuda._run(gt, xt, 4)
    else:
        out = cspn3d_cuda._run(gt, xt, 4)
    (keep, states), = plain_kernels["fwd"]
    assert keep == grad and (states is not None) == grad
    assert out.requires_grad == grad
    assert torch.equal(out.detach(), cspn_ref.propagate_nd_reference(gt.detach(), xt.detach(), 4))
    if grad:
        torch.autograd.grad(out.sum(), gt if case == "gates_only" else xt)
        assert plain_kernels["bwd"] == [states]
