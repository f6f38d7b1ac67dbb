"""Bounds that hold one training run against another of the same Adam
steps from the same weights: a data-parallel run against one process
(``chip_smoke.py``'s phase 6, ``tools/ddp_check_torch.py``, the CPU
distributed tests) and the port against the JAX step (the CPU
train-step parity tests)."""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

# the data-parallel step's losses against one process's in bf16: the bf16
# kernel bound (``chip_smoke.py``'s ``BOUNDS``)
DDP_LOSS_RTOL = 2e-2


def _tensor(x) -> torch.Tensor:
    return x.detach() if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))


def key_bias(name: str, p: torch.Tensor) -> torch.Tensor:
    """True on the key third of a ``qkv_bias``, False elsewhere."""
    mask = torch.zeros_like(_tensor(p), dtype=torch.bool)
    if name.endswith("attn.qkv_bias"):
        c = mask.numel() // 3
        mask[c:2 * c] = True
    return mask


def check_adam_bound(label: str, got: Mapping, want: Mapping, lr: float, steps: int,
                     key_biases_apart: bool = True) -> Dict[str, float]:
    """Hold each tensor of ``got`` against ``want``'s of the same name
    after ``steps`` Adam steps at ``lr``.  Adam moves an element by about
    lr a step whatever its gradient, so an element whose gradient is
    within rounding of zero may step the other way: every element stays
    within 2.5 lr a step, and fewer than 2% of a tensor's elements lie
    beyond one lr.

    With ``key_biases_apart`` the key third of each ``qkv_bias`` (torch
    names) is held to 2 lr a step and left out of the rest: its gradient
    is zero in exact arithmetic (a constant added to every key of a query
    leaves the softmax unchanged), so both runs hold rounding noise there,
    which Adam turns into steps of +-lr whatever its size.

    Raises ``AssertionError`` naming the first tensor out of bounds;
    returns the number of tensors equal bit for bit (``same`` of
    ``tensors``), the largest difference (``worst``, against ``bound``)
    and the largest share of a tensor beyond one lr (``beyond``)."""
    bound = 2.5 * lr * steps
    same, worst, beyond = 0, 0.0, 0.0
    for k, w in want.items():
        g, w = _tensor(got[k]), _tensor(w)
        same += int(torch.equal(g, w))
        diff = (g.float() - w.float()).abs()
        key = key_bias(k, diff) if key_biases_apart else torch.zeros_like(diff, dtype=torch.bool)
        if key.any() and float(diff[key].max()) > 2 * lr * steps:
            raise AssertionError(f"{label}: {k}'s key bias moved more than 2 lr a step")
        rest = diff[~key]
        share = float((rest > lr).float().mean())
        if float(rest.max()) > bound or share >= 0.02:
            raise AssertionError(f"{label}: {k} leaves the Adam bound (largest difference "
                                 f"{float(rest.max()):.3e}, bound {bound:.3e}; {share:.2%} "
                                 f"beyond one lr, bound 2%)")
        worst, beyond = max(worst, float(rest.max())), max(beyond, share)
    return {"same": same, "tensors": len(want), "worst": worst, "beyond": beyond,
            "bound": bound}
