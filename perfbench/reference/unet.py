"""The CSPN-UNet forward and its float32 train step in plain PyTorch.

Published form (reference/__init__.py): NHWC RGB-D input, channel 3 the
sparse depth; the encoder (7x7/s2 stem whose pre-BN output is the last
skip, 3x3/s2 max pool, four ResNet stages, a 3x3 conv and BN without ReLU);
the decoder's up-projection blocks, each a zero-insert 2x unpool cropped
to the skip's size, 5x5 convs on it (main and shortcut), a 3x3 conv over
the main branch joined with the skip; the two 3x3 heads on the unpooled
last map (blur depth, 8 affinities); then the 2D CSPN:

    gates_d(p) = g_d(p + o_d) / sum_e |g_e(p + o_e)|      (8sum; 8sum_abs: |g|)
    x <- (1 - sum_d gates_d) * x0 + sum_d gates_d * x(p + o_d)
    x <- (1 - m) * x + m * x0,   m = sign(sparse)

for `steps` steps from x0 = the blur depth, zero outside the image, the
gate order of cspn.py:100-129.

`quant` computes every convolution on operands rounded to a lower
precision, scaled per output channel for the weights and per sample for
the activations: "int8" and "int4" symmetric integers (round half to even,
clipped to +-(2^(b-1) - 1)), "fp8" e4m3 (the largest magnitude scaled to
448).  It is the benchmark's control: the reference in a lower precision
than the one the configuration states.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference import layers

# (dy, dx): gate d multiplies the state at p + offset_d (cspn.py's gate1..gate8)
OFFSETS = ((1, 1), (1, 0), (1, -1), (0, 1), (0, -1), (-1, 1), (-1, 0), (-1, -1))
BN_EPS = 1e-5
BN_MOMENTUM = 0.1


def shift(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """y[..., i, j] = x[..., i + dy, j + dx], zero outside."""
    h, w = x.shape[-2:]
    y = F.pad(x, (max(-dx, 0), max(dx, 0), max(-dy, 0), max(dy, 0)))
    return y[..., max(dy, 0):max(dy, 0) + h, max(dx, 0):max(dx, 0) + w]


def cspn(guidance, blur, sparse, steps: int = 24, norm_type: str = "8sum"):
    """guidance [N, 8, H, W], blur and sparse [N, H, W] -> [N, H, W]."""
    g = guidance.abs() if norm_type == "8sum_abs" else guidance
    shifted = torch.stack([shift(g[:, d], *o) for d, o in enumerate(OFFSETS)], 1)
    denom = shifted.abs().sum(1, keepdim=True)
    ok = denom > 0
    gates = torch.where(ok, shifted / torch.where(ok, denom, torch.ones_like(denom)), 0.0)
    center = 1.0 - gates.sum(1)
    mask = torch.sign(sparse)
    x0 = blur
    x = x0
    for _ in range(steps):
        y = center * x0
        for d, o in enumerate(OFFSETS):
            y = y + gates[:, d] * shift(x, *o)
        x = (1.0 - mask) * y + mask * x0
    return x


QUANT_LEVELS = {"int8": 127, "int4": 7}
FP8_MAX = 448.0  # float8 e4m3's largest finite value


def fake_quant(t: torch.Tensor, quant: str, dims) -> torch.Tensor:
    """`t` rounded to `quant` ("int8", "int4" or "fp8") and scaled back, one
    scale per slice along the dimensions not in `dims`."""
    amax = t.abs().amax(dim=dims, keepdim=True).clamp_min(1e-12)
    if quant == "fp8":
        scale = amax / FP8_MAX
        return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
    levels = QUANT_LEVELS[quant]
    scale = amax / levels
    return torch.clamp(torch.round(t / scale), -levels, levels) * scale


def unpool2x(x: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    n, c, h, w = x.shape
    out = x.new_zeros((n, c, 2 * h, 2 * w))
    out[:, :, ::2, ::2] = x
    return out[:, :, :oh, :ow]


class Net:
    """The functional forward over `params` (conv and BN weights) and
    `buffers` (BN running statistics), both keyed as the state dict."""

    def __init__(self, arch: str, params: dict, buffers: dict, steps: int = 24,
                 norm_type: str = "8sum", quant: str | None = None):
        self.arch, self.p, self.buf = arch, params, buffers
        self.steps, self.norm_type, self.quant = steps, norm_type, quant
        self.train = False

    def conv(self, x, name: str, stride: int = 1, pad: int | None = None):
        w = self.p[f"{name}.weight"]
        if pad is None:
            pad = (w.shape[-1] - 1) // 2
        if self.quant:
            x = fake_quant(x, self.quant, (1, 2, 3))
            w = fake_quant(w, self.quant, (1, 2, 3))
        return F.conv2d(x, w, stride=stride, padding=pad)

    def bn(self, x, name: str):
        return F.batch_norm(x, self.buf[f"{name}.running_mean"], self.buf[f"{name}.running_var"],
                            self.p[f"{name}.weight"], self.p[f"{name}.bias"], self.train,
                            BN_MOMENTUM, BN_EPS)

    def block(self, x, p: str, kind: str, stride: int, ds: bool):
        if kind == "basic":
            out = torch.relu(self.bn(self.conv(x, f"{p}.conv1", stride), f"{p}.bn1"))
            out = self.bn(self.conv(out, f"{p}.conv2"), f"{p}.bn2")
        else:
            out = torch.relu(self.bn(self.conv(x, f"{p}.conv1"), f"{p}.bn1"))
            out = torch.relu(self.bn(self.conv(out, f"{p}.conv2", stride), f"{p}.bn2"))
            out = self.bn(self.conv(out, f"{p}.conv3"), f"{p}.bn3")
        res = self.bn(self.conv(x, f"{p}.downsample.0", stride), f"{p}.downsample.1") if ds else x
        return torch.relu(out + res)

    def up_proj(self, x, p: str, oh: int, ow: int, side=None):
        x = unpool2x(x, oh, ow)
        out = torch.relu(self.bn(self.conv(x, f"{p}.conv1"), f"{p}.bn1"))
        if side is not None:
            out = torch.cat([out, side], 1)
            out = torch.relu(self.bn(self.conv(out, f"{p}.conv1_1"), f"{p}.bn1_1"))
        out = self.bn(self.conv(out, f"{p}.conv2"), f"{p}.bn2")
        return torch.relu(out + self.bn(self.conv(x, f"{p}.sc_conv1"), f"{p}.sc_bn1"))

    def __call__(self, rgbd: torch.Tensor) -> torch.Tensor:
        """rgbd [N, H, W, 4] -> dense depth [N, H, W]."""
        h, w = rgbd.shape[1:3]
        sizes = layers.ceil_half_chain(h, w, 5)
        sparse = rgbd[..., 3]
        x = rgbd.permute(0, 3, 1, 2)
        x = self.conv(x, "conv1_1", 2, 3)
        skip4 = x
        x = F.max_pool2d(torch.relu(self.bn(x, "bn1")), 3, 2, 1)
        skips = {}
        for stage, b, kind, _, _, s, ds in layers.blocks(self.arch):
            x = self.block(x, f"layer{stage}.{b}", kind, s, ds)
            skips[stage] = x  # the stage's output, once its last block ran
        x = self.bn(self.conv(skips[4], "conv2"), "bn2")
        d = self.up_proj(x, "gud_up_proj_layer1", *sizes[4])
        d = self.up_proj(d, "gud_up_proj_layer2", *sizes[3], side=skips[2])
        d = self.up_proj(d, "gud_up_proj_layer3", *sizes[2], side=skips[1])
        d = self.up_proj(d, "gud_up_proj_layer4", *sizes[1], side=skip4)
        u = unpool2x(d, *sizes[0])
        blur = self.conv(u, "gud_up_proj_layer5.conv1")[:, 0]
        guidance = self.conv(u, "gud_up_proj_layer6.conv1")
        return cspn(guidance, blur, sparse, self.steps, self.norm_type)


def bn_buffers(arch: str, device, dtype=torch.float32) -> dict:
    """Fresh running statistics (mean 0, variance 1) of every batch norm."""
    out = {}
    for name, ch in layers.batch_norms(arch).items():
        out[f"{name}.running_mean"] = torch.zeros(ch, device=device, dtype=dtype)
        out[f"{name}.running_var"] = torch.ones(ch, device=device, dtype=dtype)
    return out


def masked_l1(pred: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Mean |pred - label| over the pixels whose label exceeds 1e-4
    (the reference's Wighted_L1_Loss)."""
    mask = (label > 1e-4).to(pred.dtype)
    return ((pred - label).abs() * mask).sum() / mask.sum().clamp_min(1.0)


def train_steps(net: Net, batches, lr: float, momentum: float, weight_decay: float,
                nesterov: bool = True):
    """Run len(batches) SGD steps on net.p (train-mode BN), in place.
    Returns (the losses, the first step's gradient as the optimizer takes it:
    grad + weight_decay * p, per leaf)."""
    names = list(net.p)
    bufs: dict = {}
    losses, first = [], None
    net.train = True
    try:
        for rgbd, depth in batches:
            leaves = [net.p[k].detach().requires_grad_(True) for k in names]
            net.p = dict(zip(names, leaves))
            loss = masked_l1(net(rgbd), depth)
            grads = torch.autograd.grad(loss, leaves)
            losses.append(loss.detach())
            with torch.no_grad():
                new = {}
                for k, p, g in zip(names, leaves, grads):
                    d = g + weight_decay * p
                    if k not in bufs:  # the first step starts the trace at d
                        bufs[k] = d.clone()
                    else:
                        bufs[k] = momentum * bufs[k] + d
                    step = d + momentum * bufs[k] if nesterov else bufs[k]
                    new[k] = p - lr * step
                if first is None:
                    first = {k: bufs[k].clone() for k in names}
            net.p = new
    finally:
        net.train = False
    return losses, first
