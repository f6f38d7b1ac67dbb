"""Mixed-precision policy (``vadcl_tpu/core/dtypes.py``): bf16 compute on
CUDA, fp32 on the CPU.  Parameters, LayerNorm statistics, softmax and all
cluster math stay fp32 whatever the compute dtype."""

from __future__ import annotations

import torch


def compute_dtype(device: torch.device | str) -> torch.dtype:
    """The activation dtype for a device: bf16 on CUDA, fp32 elsewhere."""
    return torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32
