"""Batch-size-bucketed serving front-end (counterpart of cspn_tpu/serving.py).

`DepthServer` keeps a ladder of batch buckets, pads each request up to the
nearest bucket, and chunks requests larger than the top bucket.  Per-sample
independence of the eval graph (running-stat BN, per-sample CSPN) makes the
pad rows inert: sliced-off outputs equal serving the exact batch
(tests/test_torch_serving.py).  The buckets bound the set of batch shapes
the card sees; capturing one CUDA graph per bucket is a later slice
(ROADMAP.md Queue 1).

This slice serves at the preset's float32.  The JAX package's bf16 / int8
routing (`model_int8`, `int8_from`) is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from cspn_tpu_torch.config import RunConfig

_INT8_TODO = (
    "int8 serving is not ported yet (ROADMAP.md Queue 1: bf16/int8 serving); "
    "this slice serves float32"
)


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
    """Bucketed serving for an eval-mode depth-completion model.

    Parameters
    ----------
    model : eval-mode model (e.g. ``load_eval_state(cfg)``); requests run on
        its device.
    buckets : ascending batch sizes.
    model_int8 : not ported yet; anything but None raises.
    """

    def __init__(self, model: torch.nn.Module, buckets: tuple[int, ...] = (1, 8, 32, 128),
                 model_int8=None):
        if model_int8 is not None:
            raise NotImplementedError(_INT8_TODO)
        if tuple(sorted(buckets)) != tuple(buckets) or len(set(buckets)) != len(buckets):
            raise ValueError(f"buckets must be strictly ascending, got {buckets}")
        self.model = model
        self.device = next(model.parameters()).device
        self.buckets = tuple(int(b) for b in buckets)
        self.served = {"float32": 0}  # request samples served (observability)

    @torch.inference_mode()
    def _run_bucket(self, x: torch.Tensor, n_real: int) -> torch.Tensor:
        self.served["float32"] += n_real
        return self.model(x)

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
                buckets: tuple[int, ...] = (1, 8, 32, 128), device=None) -> DepthServer:
    """A DepthServer over `load_eval_state(cfg, ...)` at the preset's float32."""
    from cspn_tpu_torch.train.evaluate import load_eval_state

    model = load_eval_state(cfg, checkpoint, device=device)
    return DepthServer(model, buckets=buckets)
