"""Optimizers with the reference's staged parameter gating
(``vadcl_tpu/train/optim.py``).

The reference trains with ``torch.optim.Adam(lr, weight_decay=0.02)`` under a
per-epoch timm cosine schedule and stages which parameters train by flipping
``requires_grad`` at iteration thresholds (``model/backbone.py:46-77``,
``main_predict.py:249-257``).  Here the optimizers are torch's own, with the
learning rate set from the schedule before every step, and a gated
parameter gets ``grad = None`` for the step (``apply_gates``): torch's
optimizers then skip it entirely, so it gets no weight decay, no moment
update and no step-count advance, which is what the JAX package's
``torch_adam`` gates reproduce.  A zero gradient would not do: Adam would
still decay the weight and advance its moments.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Tuple

import numpy as np
import torch


def cosine_epoch_lr(
    base_lr: float,
    min_lr: float,
    epochs: int,
    steps_per_epoch: int,
    warmup_epochs: int = 0,
    warmup_lr_init: float = 1e-6,
) -> Callable[[int], float]:
    """timm CosineLRScheduler stepped per *epoch*:
    lr(e) = min + 0.5 (base - min) (1 + cos(pi e / epochs)), with an optional
    linear warmup over ``warmup_epochs``; evaluated in fp32 as the JAX
    schedule is."""
    f32 = np.float32

    def schedule(step: int) -> float:
        epoch = f32(step // steps_per_epoch)
        cos_lr = f32(min_lr) + f32(0.5 * (base_lr - min_lr)) * (
            f32(1.0) + np.cos(f32(math.pi) * epoch / f32(epochs))
        )
        if warmup_epochs > 0 and epoch < warmup_epochs:
            return float(f32(warmup_lr_init) + f32(base_lr - warmup_lr_init)
                         * (epoch / f32(warmup_epochs)))
        return float(cos_lr)

    return schedule


def param_gate_thresholds(
    named_params: Iterable[Tuple[str, torch.nn.Parameter]],
    cluster_start_iter: int = 0,
    match: str = "cluster",
) -> Dict[str, int]:
    """Unfreeze step per parameter name: a parameter whose name contains
    ``match`` (``cluster1.*``, ``space_cluster.*``, their LayerNorms
    included) unfreezes at ``cluster_start_iter``, every other at 0."""
    return {name: (cluster_start_iter if match in name else 0) for name, _ in named_params}


def apply_gates(named_params: Iterable[Tuple[str, torch.nn.Parameter]],
                thresholds: Dict[str, int], step: int) -> None:
    """Before the optimizer step: a parameter still gated at ``step`` gets
    ``grad = None``; an ungated one without a gradient (not reached by this
    step's loss) gets a zero gradient, as every leaf of the JAX step gets
    one."""
    for name, p in named_params:
        if step < thresholds[name]:
            p.grad = None
        elif p.grad is None:
            p.grad = torch.zeros_like(p)


def build_optimizer(
    name: str,
    params: Iterable[torch.nn.Parameter],
    weight_decay: float,
    b1: float,
    b2: float,
    eps: float,
) -> torch.optim.Optimizer:
    """The reference's ``--optimizer`` choices.  The learning rate is set
    from the schedule before each step (``set_lr``)."""
    params = list(params)
    if name == "adam":
        return torch.optim.Adam(params, lr=0.0, betas=(b1, b2), eps=eps,
                                weight_decay=weight_decay)
    if name == "adamw":
        return torch.optim.AdamW(params, lr=0.0, betas=(b1, b2), eps=eps,
                                 weight_decay=weight_decay)
    if name == "sgd":
        return torch.optim.SGD(params, lr=0.0, momentum=b1, weight_decay=weight_decay)
    if name == "lars":
        raise NotImplementedError(
            "optimizer 'lars' is not ported yet (ROADMAP.md, queue 1, train-step "
            "leftovers); use adam, adamw or sgd"
        )
    raise ValueError(f"unknown optimizer {name!r}")


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr
