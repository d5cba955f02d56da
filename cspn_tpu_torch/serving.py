"""Batch-size-bucketed, dual-path serving front-end (counterpart of
cspn_tpu/serving.py).

`DepthServer` keeps a ladder of batch buckets, pads each request up to the
nearest bucket, and chunks requests larger than the top bucket.  Per-sample
independence of the eval graph (running-stat BN, per-sample CSPN and
per-sample activation scales; static scales do not depend on the batch)
makes the pad rows inert: sliced-off outputs equal serving the exact batch
(tests/test_torch_serving.py).  The buckets bound the set of batch shapes
the card sees; capturing one CUDA graph per bucket is a later slice
(ROADMAP.md Queue 1).

Each bucket serves on one numeric path: below `int8_from` the bf16 model,
from it up the int8 one (the bf16 model with int8 convs,
utils/quant.py), as the JAX package routes its buckets.  `int8_from=8` is
the JAX package's v5e crossover (cspn_tpu/serving.py:11-18); the H100's is
measured by chip_smoke.py phase 13 and written down in PERF.md.  Both
models hold the same bf16-cast weights (`load_server`).  The 2D CSPN runs
float32 on both paths.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cspn_tpu_torch.config import RunConfig


def pick_bucket(n: int, buckets: tuple[int, ...]) -> int:
    """Smallest bucket >= n (n must not exceed max(buckets))."""
    for b in buckets:
        if b >= n:
            return b
    raise ValueError(f"batch {n} exceeds max bucket {buckets[-1]}")


def chunk_plan(n: int, buckets: tuple[int, ...]) -> list[int]:
    """Split a request of n samples into per-chunk sizes: greedy top-bucket
    chunks, then one remainder chunk (padded to its own bucket by the
    caller).  sum(plan) == n."""
    if n <= 0:
        raise ValueError("empty request")
    top = buckets[-1]
    plan = [top] * (n // top)
    if n % top:
        plan.append(n % top)
    return plan


class DepthServer:
    """Bucketed, dual-path serving for eval-mode depth-completion models.

    Parameters
    ----------
    model_bf16 : eval-mode model (e.g. ``load_eval_state(cfg)`` at dtype
        bfloat16, or any model to serve every bucket on); requests run on
        its device.
    buckets : ascending batch sizes.
    model_int8 : the int8 variant (dtype int8, its weight cache built), or
        None to serve every bucket on `model_bf16`.
    int8_from : smallest bucket served on the int8 path (None: none).
    """

    def __init__(self, model_bf16: torch.nn.Module, buckets: tuple[int, ...] = (1, 8, 32, 128),
                 model_int8: torch.nn.Module | None = None, int8_from: int | None = 8):
        if tuple(sorted(buckets)) != tuple(buckets) or len(set(buckets)) != len(buckets):
            raise ValueError(f"buckets must be strictly ascending, got {buckets}")
        self.models = {"bf16": model_bf16, "int8": model_int8}
        self.device = next(model_bf16.parameters()).device
        self.buckets = tuple(int(b) for b in buckets)
        self.int8_from = int8_from
        self.served = {"bf16": 0, "int8": 0}  # request samples per path (observability)

    def path_for(self, bucket: int) -> str:
        if self.models["int8"] is not None and self.int8_from is not None \
                and bucket >= self.int8_from:
            return "int8"
        return "bf16"

    @torch.inference_mode()
    def _run_bucket(self, x: torch.Tensor, n_real: int) -> torch.Tensor:
        path = self.path_for(x.shape[0])
        self.served[path] += n_real
        return self.models[path](x)

    def predict(self, rgbd) -> np.ndarray:
        """Serve one request: rgbd [N,H,W,4] -> dense depth [N,H,W].

        N is arbitrary: chunked over the top bucket, the remainder
        zero-padded up to its bucket and sliced back.
        """
        x = torch.as_tensor(rgbd, dtype=torch.float32)
        if x.ndim != 4:
            raise ValueError(f"expected NHWC rgbd, got shape {tuple(x.shape)}")
        x = x.to(self.device)
        outs = []
        start = 0
        for size in chunk_plan(x.shape[0], self.buckets):
            chunk = x[start : start + size]
            start += size
            bucket = pick_bucket(size, self.buckets)
            if bucket != size:
                pad = chunk.new_zeros((bucket - size,) + tuple(chunk.shape[1:]))
                chunk = torch.cat([chunk, pad])
            outs.append(self._run_bucket(chunk, size)[:size])
        return torch.cat(outs).cpu().numpy()

    def warmup(self, height: int, width: int) -> None:
        """Run every bucket once at the serving geometry (first calls pay
        the kernel build and cuDNN set-up); warmup is not served traffic."""
        for b in self.buckets:
            self._run_bucket(torch.zeros((b, height, width, 4), device=self.device), b)
        for k in self.served:
            self.served[k] = 0


def load_server(cfg: RunConfig, checkpoint: str = "best_model",
                buckets: tuple[int, ...] = (1, 8, 32, 128), device=None, tf32: bool = False,
                int8_from: int | None = 8, act_static: bool | None = None,
                jax_variables=None, torch_checkpoint: str | None = None) -> DepthServer:
    """A DepthServer over `load_eval_state(cfg, ...)`: the bf16 model with
    the weights cast at load, and the int8 model (its weight cache, and
    with `act_static` -- default cfg.model.act_static -- its calibrated
    static activation scales) only when a bucket can route to it
    (cspn_tpu/serving.py:169-212).  The convolution policy is set for the
    card first (`set_conv_policy`: cuDNN's algorithm timing, TF32 only with
    `tf32`).  `jax_variables` and `torch_checkpoint` (a whole model trained
    by the reference) are load_eval_state's."""
    from cspn_tpu_torch import resolve_device, set_conv_policy
    from cspn_tpu_torch.train.evaluate import load_eval_state

    set_conv_policy(resolve_device(device), tf32=tf32)
    want_int8 = int8_from is not None and any(b >= int8_from for b in buckets)
    if act_static is None:
        act_static = cfg.model.act_static

    def variant(dtype: str, static: bool) -> torch.nn.Module:
        model = dataclasses.replace(cfg.model, dtype=dtype, act_static=static)
        return load_eval_state(dataclasses.replace(cfg, model=model), checkpoint, device=device,
                               jax_variables=jax_variables, torch_checkpoint=torch_checkpoint)

    model_bf16 = variant("bfloat16", False)
    model_int8 = variant("int8", act_static) if want_int8 else None
    if model_int8 is not None:  # one copy of the bf16 weights: the int8 model's
        model_bf16.load_state_dict(model_int8.state_dict(), assign=True)
    return DepthServer(model_bf16, buckets, model_int8=model_int8, int8_from=int8_from)
