"""Parameter precision (counterpart of cspn_tpu/utils/precision.py).

Serving casts a checkpoint's floating tensors to bf16 at load: the
decoder's ~260 M conv parameters are re-read every batch, and bf16 halves
those bytes.  Training keeps float32 master parameters (train/state.py);
the 2D CSPN post-process runs float32 at every dtype (models/unet.py casts
the heads back to float32 before it).
"""

from __future__ import annotations

import torch


def cast_floating(state: dict, dtype: torch.dtype = torch.bfloat16) -> dict:
    """A copy of the state dict `state` with every floating tensor
    (parameters, BN weight and bias AND running statistics) cast to
    `dtype`; integer tensors (num_batches_tracked) are kept."""
    return {k: v.to(dtype) if torch.is_tensor(v) and v.is_floating_point() else v
            for k, v in state.items()}


def torch_dtype(name) -> torch.dtype | None:
    """The compute dtype of a config's dtype name: None for float32 (the
    model's own), bf16 for 'bfloat16' and for 'int8' (int8 serving
    dequantizes into bf16, cspn_tpu/train/loop.py:44-45)."""
    if name in (None, "float32", torch.float32):
        return None
    if name in ("bfloat16", "bf16", "int8", torch.bfloat16):
        return torch.bfloat16
    raise ValueError(f"unknown dtype {name!r}; expected float32, bfloat16 or int8")
