"""Per-card attention-kernel selection: measure once, cache, reuse
(``vadcl_tpu/utils/autotune.py``).

The fused window-attention kernel families trade differently on a card:
``packed`` and ``fold_packed`` (inference only) pack the heads into fewer,
fatter products; ``fold`` runs LN1 and the residual inside the kernel;
``base`` leaves them to plain PyTorch around the kernel.  Which wins is a
measurement, not a constant.

``measure_attn_kernels`` times each family through a Swin block's
attention half (``SwinBlock3D`` without its MLP tail) at the flagship
stage-0 geometry in bf16; in the port those four run kernels 7, 9, A and
10.  ``pick_attn_kernel`` returns the fastest, requiring a >5% win over
``base`` before it leaves it.  ``tuned_attn_kernel`` keeps the pick in a
JSON cache keyed by the card's name, so the measurement runs once per kind
of card.  A kernel that fails to build or launch raises: no failure is
turned into a pick.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from vadcl_tpu_torch.models.layers import init_parameters
from vadcl_tpu_torch.models.swin import SwinBlock3D

# The flagship's first encoder stage: 32 clips of (2, 56, 56) tokens of 96
# channels, 6 heads, windows of (2, 7, 7) (the JAX measurement's geometry).
BATCH, SHAPE, HEADS, WINDOW = 32, (2, 56, 56, 96), 6, (2, 7, 7)
NAMES = ("base", "packed", "fold", "fold_packed")
INFERENCE_ONLY = ("packed", "fold_packed")
DEFAULT_CACHE = os.path.join(os.path.expanduser("~"), ".cache", "vadcl_tpu_torch",
                              "autotune.json")


class AttentionHalf(SwinBlock3D):
    """A Swin block up to its attention residual: the MLP tail is left
    out, so a call runs (LN1,) the attention kernel (and the residual)."""

    def _tail(self, x: torch.Tensor) -> torch.Tensor:
        return x


def measure_attn_kernels(calls: int = 8, repeats: int = 5) -> Dict[str, float]:
    """Seconds per call of the attention half under each family on the
    current card: the median over ``repeats`` of a CUDA-event pair around
    ``calls`` back-to-back calls, divided by ``calls``, after a warm-up
    that builds the kernels and their weight packs.  Raises without a
    card."""
    if not torch.cuda.is_available():
        raise RuntimeError("measure_attn_kernels: no CUDA device is visible")
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator().manual_seed(5)
    block = AttentionHalf(SHAPE[-1], HEADS, WINDOW, fused=True).to(dev)
    init_parameters(block, gen)
    x = torch.rand((BATCH, *SHAPE), generator=gen).to(dev, torch.bfloat16)
    times = {}
    with torch.no_grad():
        for name in NAMES:
            block.attn_kernel = name
            for _ in range(3):
                block(x)
            runs = []
            for _ in range(repeats):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize(dev)
                start.record()
                for _ in range(calls):
                    block(x)
                end.record()
                end.synchronize()
                runs.append(start.elapsed_time(end) / 1e3 / calls)
            times[name] = float(np.median(runs))
    return times


def pick_from_times(times: Dict[str, float], trainable_only: bool = False) -> str:
    """The fastest name, if it beats ``base`` by more than 5%, else
    ``base``; ``trainable_only`` leaves out the inference-only names."""
    if trainable_only:
        times = {k: v for k, v in times.items() if k not in INFERENCE_ONLY}
    best = min(times, key=times.get)
    return best if times[best] < 0.95 * times["base"] else "base"


def pick_attn_kernel(trainable_only: bool = False) -> str:
    """Measure on this card and return the pick; ``"base"`` without a
    card (the CPU runs the kernels' plain versions, whatever the name)."""
    if not torch.cuda.is_available():
        return "base"
    return pick_from_times(measure_attn_kernels(), trainable_only)


def cache_key(trainable_only: bool) -> str:
    """The cache entry of this kind of card."""
    return f"{torch.cuda.get_device_name()}|trainable={bool(trainable_only)}"


def read_cache(path: str) -> dict:
    """The cache at ``path``; empty when it is missing or cannot be read
    or parsed (it is then measured anew)."""
    try:
        with open(path) as f:
            cache = json.load(f)
    except (OSError, ValueError):
        return {}
    return cache if isinstance(cache, dict) else {}


def tuned_attn_kernel(trainable_only: bool = False, cache_path: Optional[str] = None,
                      refresh: bool = False) -> str:
    """``pick_attn_kernel`` through a JSON cache (default
    ``~/.cache/vadcl_tpu_torch/autotune.json``) keyed by
    ``torch.cuda.get_device_name()`` and ``trainable_only``; each entry
    holds the pick and the timings.  A cache file that cannot be read or
    parsed is measured anew and rewritten; ``refresh`` measures anyway.
    ``"base"`` without a card."""
    if not torch.cuda.is_available():
        return "base"
    path = cache_path or DEFAULT_CACHE
    key = cache_key(trainable_only)
    cache = read_cache(path)
    if not refresh and isinstance(cache.get(key), dict) and "pick" in cache[key]:
        return cache[key]["pick"]
    times = measure_attn_kernels()
    pick = pick_from_times(times, trainable_only)
    cache[key] = {"pick": pick, "times_s": times}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(cache, f, indent=1)
    return pick
