"""Serving artifacts through `torch.export` (counterpart of cspn_tpu/export.py).

The reference deploys `best_model.pth`, a state dict that its eval.py
rebuilds the model around (eval.py:106-118).  An artifact here is the
traced eval graph instead, one `.pt2` file (`torch.export.save`) that
serves without the model zoo or the config:

  - `export_serving(model, height, width, batch=None)` traces the eval-mode
    model once with gradients off, with a symbolic batch dimension by
    default, so one artifact serves any request size;
  - `save_artifact` writes it with a JSON entry (`cspn_tpu_torch.json`):
    the magic string, the model's `arch`, `dtype`, `cspn_steps`, `height`
    and `width`, whether its float32 convolutions ran in TF32 (`tf32`), the
    device it was traced on, and the weights it leaves out;
  - `load_artifact` reads it back as a `ServingArtifact` (`.call`,
    `.predict`, `.meta`), importing the op registrations and nothing of
    `cspn_tpu_torch.models` or the config.  On the card it sets the
    process's convolution policy as the other entry points do
    (`set_conv_policy`: cuDNN's algorithm timing, TF32 as the meta says),
    since PyTorch's default runs float32 convolutions in TF32 and the
    graph does not carry the flag.

Weights.  By default the file embeds every tensor the graph reads: the
parameters, the BN statistics and, at int8, the weight cache and any
calibrated static activation scales (utils/quant.py:QuantConv keeps them as
buffers, so they travel with the weights and are never baked in as
constants).  With `embed=False` none of them is in the file: the graph
takes them as its first input, a dict {name: tensor} (`serving_weights`),
as the JAX artifact's `call(variables, [qcache,] x)` does.

Devices.  The ops dispatch when the graph is traced, as JAX's CSPN backend
resolves at trace time: an artifact exported on the card holds the
hand-written kernels as the custom ops `cspn_tpu_torch::cspn2d_tiled` (once)
and `cspn_tpu_torch::d2s` (once per subpixel conv, 9 in the CSPN-UNet), at
int8 also the int8 conv's `act_absmax` (once per QuantConv with dynamic
scales), `int8_taps` and `int8_dequant` (once per conv product,
utils/quant.py:kernel_launches), and serves on the card only; one exported
on the CPU holds the plain CSPN, depth-to-space and int8 glue.  The meta records the device and `load_artifact` refuses a
CUDA artifact where no card is visible.

Two faults of the JAX package are not carried over (ADVICE.md r5): the
static activation scales travel into the artifact (JAX's export drops
them, cli.py:255), and `call` / `predict` check what they are given against
what is embedded and raise ValueError (JAX raises a TypeError from inside
the call, export.py:127).
"""

from __future__ import annotations

import itertools
import json
import zipfile

import numpy as np
import torch
from torch import nn

from cspn_tpu_torch import set_conv_policy
from cspn_tpu_torch.ops import cspn_cuda, d2s, quant_cuda  # noqa: F401  (registers the graph's custom ops)

MAGIC = "cspn_tpu_torch.export/1"
META_FILE = "cspn_tpu_torch.json"
# the symbolic batch's range: the tiled CSPN kernel's grid takes 65535 samples
_MAX_BATCH = 65535


def serving_weights(model: nn.Module) -> dict[str, torch.Tensor]:
    """Every tensor of `model` that its eval graph reads, by name: the
    parameters, the buffers (BN statistics), and at int8 the weight cache
    and static activation scales."""
    return dict(itertools.chain(model.named_parameters(), model.named_buffers()))


class _WeightsAsInputs(nn.Module):
    """`model` with its tensors as the first input: the graph `torch.export`
    traces from this holds no weight.  The model is kept outside the
    module tree, so that export lifts none of its tensors."""

    def __init__(self, model: nn.Module):
        super().__init__()
        object.__setattr__(self, "model", model)

    def forward(self, weights: dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
        return torch.func.functional_call(self.model, weights, (x,), strict=True)


def export_serving(model: nn.Module, height: int, width: int, batch: int | None = None,
                   embed: bool = True) -> torch.export.ExportedProgram:
    """Trace the eval-mode `model` on RGBD [batch, height, width, 4] on its
    device: float32, or float64 for a float64 model.  `batch=None` keeps
    the batch symbolic (1 to 65535); an int pins it.  `embed=False` traces
    the graph with the weights as an input (module docstring).  Gradients
    are off, so the 2D CSPN takes its route that no backward follows
    (ops/cspn_cuda.py:use_tiled)."""
    if model.training:
        raise ValueError("export_serving takes an eval-mode model (model.eval())")
    param = next(model.parameters())
    dtype = torch.float64 if param.dtype == torch.float64 else torch.float32
    x = torch.zeros((2 if batch is None else int(batch), height, width, 4), dtype=dtype,
                    device=param.device)
    dims = {0: torch.export.Dim("b", min=1, max=_MAX_BATCH)} if batch is None else None
    with torch.no_grad():
        if embed:
            program = torch.export.export(model, (x,), dynamic_shapes=(dims,))
        else:
            weights = serving_weights(model)
            program = torch.export.export(_WeightsAsInputs(model), (weights, x),
                                          dynamic_shapes=({k: None for k in weights}, dims))
    program.example_inputs = None  # the example frames (and weights) stay out of the file
    for node in program.graph.nodes:  # the exporting checkout's source paths, a third of the graph
        node.meta.pop("stack_trace", None)
    return program


def op_counts(program: torch.export.ExportedProgram) -> dict[str, int]:
    """The `cspn_tpu_torch::` op nodes of an exported graph, by op name."""
    counts: dict[str, int] = {}
    for node in program.graph.nodes:
        name = getattr(node.target, "name", lambda: "")()
        if node.op == "call_function" and name.startswith("cspn_tpu_torch::"):
            key = name.split("::")[1].split(".")[0]
            counts[key] = counts.get(key, 0) + 1
    return counts


def save_artifact(program: torch.export.ExportedProgram, path: str, meta: dict,
                  weights: dict[str, torch.Tensor] | None = None) -> None:
    """Write `program` and its meta into one .pt2 file.  `weights` is
    `serving_weights(model)` for a program traced with `embed=False`: their
    names, shapes and dtypes go into the meta (not their values), for
    `call` to check against."""
    frames = [n for n in program.graph.nodes if n.op == "placeholder"][-1].meta["val"]
    meta = dict(meta, magic=MAGIC, embedded=weights is None, device=frames.device.type,
                input_dtype=str(frames.dtype).removeprefix("torch."),
                tf32=bool(meta.get("tf32", False)))
    if weights is not None:
        meta["weights"] = {k: [list(t.shape), str(t.dtype).removeprefix("torch.")]
                           for k, t in weights.items()}
    torch.export.save(program, path, extra_files={META_FILE: json.dumps(meta)})


def read_meta(path: str) -> dict:
    """The meta of a cspn_tpu_torch artifact; ValueError for any other file."""
    try:
        with zipfile.ZipFile(path) as z:
            name = next((n for n in z.namelist() if n.endswith("/extra/" + META_FILE)), None)
            meta = json.loads(z.read(name)) if name else {}
    except (zipfile.BadZipFile, json.JSONDecodeError, UnicodeDecodeError) as err:
        raise ValueError(f"{path} is not a {MAGIC} artifact ({err})") from None
    if meta.get("magic") != MAGIC:
        raise ValueError(f"{path} is not a {MAGIC} artifact")
    return meta


class ServingArtifact:
    """A loaded artifact.  `.call(x)` (embedded weights) or `.call(weights,
    x)` (without) runs the exported graph on RGBD [N, H, W, 4] (float32
    unless exported otherwise) on the artifact's device and returns [N, H,
    W]; `.predict(rgbd)` serves an array with the embedded weights and
    returns numpy."""

    def __init__(self, program: torch.export.ExportedProgram, meta: dict):
        self.program, self.meta = program, meta
        self.device = torch.device(meta["device"])
        self.input_dtype = getattr(torch, meta["input_dtype"])
        self._module = program.module()

    def _check_frames(self, x) -> None:
        want = (self.meta["height"], self.meta["width"], 4)
        batch = self.meta.get("batch")
        if (not isinstance(x, torch.Tensor) or x.ndim != 4 or tuple(x.shape[1:]) != want
                or (batch is not None and x.shape[0] != batch) or x.dtype != self.input_dtype):
            got = (f"{x.dtype} {tuple(x.shape)}" if isinstance(x, torch.Tensor)
                   else type(x).__name__)
            raise ValueError(f"the artifact serves RGBD [{batch or 'N'}, {want[0]}, {want[1]}, 4] "
                             f"{self.meta['input_dtype']} tensors, got {got}")

    def _check_weights(self, weights) -> None:
        spec = self.meta["weights"]
        if not isinstance(weights, dict):
            raise ValueError(f"weights must be a dict of {len(spec)} tensors "
                             f"(export.serving_weights), got {type(weights).__name__}")
        missing, extra = sorted(set(spec) - set(weights)), sorted(set(weights) - set(spec))
        if missing or extra:
            raise ValueError(f"weights do not match the artifact's: missing {missing[:5]}"
                             f"{'...' if len(missing) > 5 else ''}, unexpected {extra[:5]}"
                             f"{'...' if len(extra) > 5 else ''}")
        for k, (shape, dtype) in spec.items():
            t = weights[k]
            if list(t.shape) != shape or str(t.dtype).removeprefix("torch.") != dtype:
                raise ValueError(f"weight {k}: the artifact takes {dtype} {shape}, got "
                                 f"{t.dtype} {list(t.shape)}")

    def call(self, *args) -> torch.Tensor:
        arity = 1 if self.meta["embedded"] else 2
        if len(args) != arity:
            form = "call(x)" if arity == 1 else "call(weights, x): no weights are embedded"
            raise ValueError(f"the artifact takes {arity} argument(s), {form}; got {len(args)}")
        if arity == 2:
            self._check_weights(args[0])
        self._check_frames(args[-1])
        with torch.no_grad():
            return self._module(*args)

    def predict(self, rgbd) -> np.ndarray:
        if not self.meta["embedded"]:
            raise ValueError("the artifact has no embedded weights; use .call(weights, x)")
        x = torch.as_tensor(np.asarray(rgbd), dtype=self.input_dtype).to(self.device)
        return self.call(x).cpu().numpy()


def load_artifact(path: str) -> ServingArtifact:
    """Load a .pt2 file that `save_artifact` wrote.  Raises ValueError for
    another file, and for a CUDA artifact where no card is visible."""
    meta = read_meta(path)
    if meta["device"] == "cuda" and not torch.cuda.is_available():
        raise ValueError(f"{path} was exported on the card and holds the CUDA kernels; "
                         "torch.cuda.is_available() is False here (export on the CPU for a "
                         "CPU artifact)")
    set_conv_policy(meta["device"], tf32=meta["tf32"])
    return ServingArtifact(torch.export.load(path), meta)
