"""FLOP counts and model FLOP utilisation (``vadcl_tpu/utils/flops.py``).

The JAX package takes its counts from XLA's cost analysis of the lowered
program.  The port counts with ``torch.utils.flop_counter.FlopCounterMode``,
which counts 2*M*N*K for every matrix product (``mm``, ``addmm``,
``bmm``, ``baddbmm``, attention) and the same for every convolution
(2 * output elements * input channels per group * kernel volume),
forward and, where the function runs one, backward; elementwise work,
reductions and softmax are not counted.  The hand-written kernels are
``ctypes`` calls the counter cannot see, so count a model that runs its
plain versions: on CPU tensors (the wrappers take the plain versions
there) or on ``meta`` tensors, never on the card's fused path.

MFU = achieved FLOP/s over the card's published dense bf16 peak.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

# NVIDIA's published dense (no sparsity) bf16 tensor-core TFLOP/s, by a
# substring of torch.cuda.get_device_name(); the first match wins.
_PEAK_BF16_TFLOPS = (
    ("H100 PCIe", 756.0),
    ("H100 NVL", 835.0),
    ("H100", 989.0),  # SXM (the H100 80GB HBM3)
)


def device_peak_tflops(device: Any = None) -> Optional[float]:
    """The published dense bf16 peak of the card ``device`` (default: the
    current one) in TFLOP/s; None on the CPU or for a card not in the
    table."""
    if device is not None and torch.device(device).type != "cuda":
        return None
    if not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(device)
    for key, peak in _PEAK_BF16_TFLOPS:
        if key in name:
            return peak
    return None


def counted_flops(fn: Callable, *args: Any, **kwargs: Any) -> float:
    """FLOPs of one call ``fn(*args, **kwargs)`` as ``FlopCounterMode``
    counts them (the module docstring): run it on CPU or meta tensors."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())


def mfu_pct(achieved_flops_per_sec: float, peak_tflops: Optional[float]) -> Optional[float]:
    """Achieved FLOP/s as a percentage of ``peak_tflops``; None without a
    peak."""
    if not peak_tflops:
        return None
    return 100.0 * achieved_flops_per_sec / (peak_tflops * 1e12)
