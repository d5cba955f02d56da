"""Batch-size-bucketed, dual-path serving front-end (counterpart of
cspn_tpu/serving.py).

`DepthServer` keeps a ladder of batch buckets, pads each request up to the
nearest bucket, and chunks requests larger than the top bucket.  Per-sample
independence of the eval graph (running-stat BN, per-sample CSPN and
per-sample activation scales; static scales do not depend on the batch)
makes the pad rows inert: sliced-off outputs equal serving the exact batch
(tests/test_torch_serving.py).

On the card each bucket runs as one captured CUDA graph, the counterpart
of the JAX package's compiled executable a bucket: keyed by (bucket, H, W),
captured at its first use (`warmup(h, w)` captures every bucket) after a
few eager forwards on a side stream (the first calls build the kernels
with nvcc and let cuDNN time its algorithms, set_conv_policy), all in one
memory pool.  A replay costs the host one launch where the eager forward
costs one a kernel.  `predict` copies each padded chunk into the bucket's
static input, replays, and clones the rows it serves (a request above the
top bucket replays one graph more than once).  A capture that fails
raises: there is no eager fallback on the card; `cuda_graphs=False` gives
the eager server that chip_smoke.py holds the graphs against.  On the CPU
the server runs eagerly.  The kernel wrappers count their launches where
they launch (ops/cspn_cuda.py, ops/d2s.py), which a capture does once and
a replay never: the server takes back what a capture counted and adds it
again at every replay (`LAUNCH_COUNTERS`), so the counts stay exact.
Loading weights into a served model (load_state_dict) drops its graphs,
which hold the old tensors' addresses.

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
import importlib
import weakref

import numpy as np
import torch

from cspn_tpu_torch.config import RunConfig

# eager forwards on a side stream before a bucket's capture
WARMUP_FORWARDS = 3

# the kernel wrappers' launch counters that a served forward can move
LAUNCH_COUNTERS = (
    ("cspn_tpu_torch.ops.cspn_cuda", "launches"),
    ("cspn_tpu_torch.ops.cspn_cuda", "tiled_launches"),
    ("cspn_tpu_torch.ops.cspn_cuda", "bwd_launches"),
    ("cspn_tpu_torch.ops.d2s", "launches"),
    ("cspn_tpu_torch.ops.d2s", "bwd_launches"),
    ("cspn_tpu_torch.ops.cspn_halo_cuda", "launches"),
    ("cspn_tpu_torch.ops.cspn_halo_cuda", "bwd_launches"),
)


def read_counters() -> dict[tuple[str, str], int]:
    return {(m, a): getattr(importlib.import_module(m), a) for m, a in LAUNCH_COUNTERS}


def add_counters(counts: dict[tuple[str, str], int], times: int = 1) -> None:
    for (m, a), v in counts.items():
        if v:
            mod = importlib.import_module(m)
            setattr(mod, a, getattr(mod, a) + times * v)


def capture_graph(fn, device, pool=None, warmup: int = WARMUP_FORWARDS):
    """One call of `fn()` captured as a CUDA graph on `device`, after
    `warmup` eager calls on a side stream; returns (graph, fn's output as
    captured, the launch counts one replay makes).  The counts the capture
    added are taken back: a capture launches nothing."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream(device).wait_stream(side)
    before = read_counters()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
        out = fn()
    per_replay = {k: v - before[k] for k, v in read_counters().items()}
    add_counters(per_replay, -1)
    return graph, out, per_replay


@dataclasses.dataclass
class BucketGraph:
    """One bucket's captured forward: its static input and output and the
    launch counts a replay makes."""

    graph: torch.cuda.CUDAGraph
    x: torch.Tensor
    out: torch.Tensor
    launches: dict


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


def _graph_dropper(server):
    """A load_state_dict post hook that drops `server`'s graphs (holding
    the server weakly, so that a model outliving it keeps no graph alive)."""
    ref = weakref.ref(server)

    def hook(module, incompatible_keys):
        srv = ref()
        if srv is not None:
            srv.drop_graphs()

    return hook


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
    cuda_graphs : one CUDA graph a bucket (None: where the models lie on a
        CUDA device; False: eager forwards, the graphs' comparison).
    """

    def __init__(self, model_bf16: torch.nn.Module, buckets: tuple[int, ...] = (1, 8, 32, 128),
                 model_int8: torch.nn.Module | None = None, int8_from: int | None = 8,
                 cuda_graphs: bool | None = None):
        if tuple(sorted(buckets)) != tuple(buckets) or len(set(buckets)) != len(buckets):
            raise ValueError(f"buckets must be strictly ascending, got {buckets}")
        self.models = {"bf16": model_bf16, "int8": model_int8}
        self.device = next(model_bf16.parameters()).device
        self.buckets = tuple(int(b) for b in buckets)
        self.int8_from = int8_from
        self.served = {"bf16": 0, "int8": 0}  # request samples per path (observability)
        on_card = self.device.type == "cuda"
        if cuda_graphs and not on_card:
            raise ValueError(f"CUDA graphs need a CUDA device, the models lie on {self.device}")
        self.cuda_graphs = on_card if cuda_graphs is None else bool(cuda_graphs)
        self.graphs: dict[tuple[int, int, int], BucketGraph] = {}
        self._pool = torch.cuda.graph_pool_handle() if self.cuda_graphs else None
        for model in self.models.values():
            if model is not None:  # a weight load invalidates the captured addresses
                model.register_load_state_dict_post_hook(_graph_dropper(self))

    def drop_graphs(self) -> None:
        """Forget every captured graph (the next use of a bucket captures anew)."""
        self.graphs.clear()

    def path_for(self, bucket: int) -> str:
        if self.models["int8"] is not None and self.int8_from is not None \
                and bucket >= self.int8_from:
            return "int8"
        return "bf16"

    @torch.inference_mode()
    def _graph(self, bucket: int, h: int, w: int) -> BucketGraph:
        """The bucket's graph at h x w, captured at its first use."""
        g = self.graphs.get((bucket, h, w))
        if g is None:
            x = torch.zeros((bucket, h, w, 4), device=self.device)
            model = self.models[self.path_for(bucket)]
            graph, out, launches = capture_graph(lambda: model(x), self.device, self._pool)
            g = self.graphs[bucket, h, w] = BucketGraph(graph, x, out, launches)
        return g

    @torch.inference_mode()
    def _run_bucket(self, x: torch.Tensor, bucket: int) -> torch.Tensor:
        """The bucket's forward on `x` zero-padded to `bucket` rows, cut back
        to x's rows."""
        n_real = x.shape[0]
        path = self.path_for(bucket)
        self.served[path] += n_real
        if not self.cuda_graphs:
            if bucket != n_real:
                x = torch.cat([x, x.new_zeros((bucket - n_real,) + tuple(x.shape[1:]))])
            return self.models[path](x)[:n_real]
        g = self._graph(bucket, *x.shape[1:3])
        g.x[:n_real].copy_(x)
        g.x[n_real:].zero_()
        g.graph.replay()
        add_counters(g.launches)
        return g.out[:n_real].clone()  # the next replay of this graph overwrites g.out

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
            outs.append(self._run_bucket(x[start : start + size], pick_bucket(size, self.buckets)))
            start += size
        return torch.cat(outs).cpu().numpy()

    def warmup(self, height: int, width: int) -> None:
        """Run every bucket once at the serving geometry, capturing its graph
        on the card (first calls pay the kernel build and cuDNN set-up);
        warmup is not served traffic."""
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
