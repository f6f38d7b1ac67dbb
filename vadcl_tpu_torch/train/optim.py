"""Optimizers with the reference's staged parameter gating
(``vadcl_tpu/train/optim.py``), updated on the device.

The reference trains with ``torch.optim.Adam(lr, weight_decay=0.02)`` under a
per-epoch timm cosine schedule and stages which parameters train by flipping
``requires_grad`` at iteration thresholds (``model/backbone.py:46-77``,
``main_predict.py:249-257``).  The JAX package turns the flips into gates
(``torch_adam``'s ``leaf_update``): while ``step < threshold`` a leaf gets
no weight decay, no moment update and no count advance, and one compiled
step serves the whole schedule.  The port's optimizers do the same on the
device, so that one captured CUDA graph serves the whole schedule too:

* ``Adam``, ``AdamW`` and ``SGD`` are torch's classes with their state
  layout (``step``, ``exp_avg``, ``exp_avg_sq``; ``momentum_buffer``), so
  checkpoints load both ways, and an update of their own in foreach tensor
  ops.  The learning rate is a 0-d tensor on the parameters' device, which
  ``set_lr`` writes (outside any graph); the per-parameter counts are
  device tensors.
* ``step(masks=...)`` gates: each parameter's mask is a 0-d bool device
  tensor (the train step's ``finite & (step >= threshold)``).  A parameter
  whose mask is false keeps its value, moments and count bit for bit: its
  gradient is replaced by zeros (``torch.where``, which a NaN gradient
  cannot pass), and every factor of the update that would move it is
  multiplied by the mask (``x * 1`` and ``x + 0`` are exact).  So the
  frozen-leaf trap holds (a zero gradient alone would still decay the
  weight and advance the moments), and the non-finite guard of the JAX
  step (``jnp.where(finite, new, old)``) is the same mask.
* ``step()`` without masks is torch's: every parameter with a gradient
  steps.

Every parameter has its state from its first step on (``init_state``), a
gated one with count 0 and zero moments, as in ``torch_adam``.

``lars`` is ``optax.lars(lr, weight_decay=wd, momentum=b1)`` with optax's
defaults (``Lars``), without staged gating, as in the JAX package; its
learning rate is a device function of its own count (``schedule``).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

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


def cosine_epoch_lr_on_device(
    base_lr: float,
    min_lr: float,
    epochs: int,
    steps_per_epoch: int,
    warmup_epochs: int = 0,
    warmup_lr_init: float = 1e-6,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """``cosine_epoch_lr`` as tensor ops on a 0-d count (the JAX
    schedule's ``jnp`` arithmetic), for a learning rate that follows a
    count kept on the device (``Lars``)."""

    def schedule(count: torch.Tensor) -> torch.Tensor:
        epoch = torch.floor_divide(count, steps_per_epoch).to(torch.float32)
        cos_lr = min_lr + 0.5 * (base_lr - min_lr) * (1.0 + torch.cos(math.pi * epoch / epochs))
        if warmup_epochs > 0:
            warm = warmup_lr_init + (base_lr - warmup_lr_init) * (epoch / warmup_epochs)
            return torch.where(epoch < warmup_epochs, warm, cos_lr)
        return cos_lr

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


Masks = Optional[Dict[torch.nn.Parameter, torch.Tensor]]


class DeviceOptimizer:
    """The update machinery ``Adam``, ``AdamW``, ``SGD`` and ``Lars``
    share: the learning rate as a device tensor per parameter group, the
    state made up front, and the subsets of parameters one mask gates."""

    def __init__(self, *args, **kwargs):
        self._lrs: Dict[int, Tuple[torch.Tensor, float]] = {}  # group: (tensor, its value)
        super().__init__(*args, **kwargs)

    def _lr_tensor(self, index: int, group: dict, device: torch.device) -> torch.Tensor:
        """Group ``index``'s learning rate on ``device``: made, or written,
        only where it differs from ``group["lr"]`` (``set_lr`` writes it
        before a captured step, so a capture never bakes one in)."""
        held = self._lrs.get(index)
        if held is None or held[1] != group["lr"] or held[0].device != device:
            t = held[0] if held is not None and held[0].device == device else \
                torch.empty((), dtype=torch.float32, device=device)
            with torch.no_grad():
                t.fill_(float(group["lr"]))
            self._lrs[index] = held = (t, group["lr"])
        return held[0]

    def lr_tensors(self) -> List[torch.Tensor]:
        """The groups' learning-rate tensors made so far."""
        return [t for t, _ in self._lrs.values()]

    def set_lr(self, lr: float) -> None:
        for i, group in enumerate(self.param_groups):
            group["lr"] = lr
            if i in self._lrs:
                self._lr_tensor(i, group, self._lrs[i][0].device)

    def init_state(self, together: Sequence[Sequence[torch.nn.Parameter]] = ()) -> None:
        """Give every parameter its state (zeros, count 0) and move counts
        that a load left on the CPU to the parameter's device; make every
        group's learning-rate tensor.  ``together``: the subsets of
        parameters that step under one mask (``Adam`` checks them)."""
        for i, group in enumerate(self.param_groups):
            for p in group["params"]:
                self._state_of(p, group)
            if group["params"]:
                self._lr_tensor(i, group, group["params"][0].device)

    def _subsets(self, masks: Masks, zero_missing: bool):
        """(group index, group, mask or None, params, grads) per group and
        mask.  Without ``masks``, the parameters with a gradient (every
        parameter, a missing gradient as zeros, with ``zero_missing``)."""
        for i, group in enumerate(self.param_groups):
            subsets: Dict[int, Tuple[Optional[torch.Tensor], list, list]] = {}
            for p in group["params"]:
                if masks is None and p.grad is None and not zero_missing:
                    continue
                mask = None if masks is None else masks[p]
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                _, ps, gs = subsets.setdefault(id(mask), (mask, [], []))
                ps.append(p)
                gs.append(g)
            for mask, ps, gs in subsets.values():
                yield i, group, mask, ps, gs


def _gated(mask: Optional[torch.Tensor], grads: List[torch.Tensor]):
    """(grads, factor): the gradients where ``mask`` holds and zeros
    elsewhere (NaNs too), and ``mask`` as an fp32 factor; without a mask
    the gradients and None.  The gradients (one dtype: the port's
    parameters are fp32) are copied end to end into one buffer
    (``_foreach_copy_``, a few multi-tensor kernels) and go through one
    ``torch.where``, not one a tensor."""
    if mask is None:
        return grads, None
    f = mask.to(torch.float32)
    flat = torch.empty(sum(g.numel() for g in grads), dtype=grads[0].dtype,
                       device=grads[0].device)
    sizes = [g.numel() for g in grads]
    torch._foreach_copy_([v.view_as(g) for v, g in zip(flat.split(sizes), grads)], grads)
    flat = torch.where(mask, flat, 0.0)
    return [v.view_as(g) for v, g in zip(flat.split(sizes), grads)], f


def _keep(mask: Optional[torch.Tensor], factor: float):
    """``factor`` where ``mask`` holds and 1 elsewhere (``x * 1 == x``)."""
    return factor if mask is None else torch.where(mask, factor, 1.0)


def _count(counts: List[torch.Tensor], f: Optional[torch.Tensor]) -> None:
    """Each count plus 1, or plus ``f`` (a 0-d tensor: ``alpha`` picks the
    tensor overload; without it the binding reads ``f`` on the host)."""
    if f is None:
        torch._foreach_add_(counts, 1.0)
    else:
        torch._foreach_add_(counts, f, alpha=1.0)


def _times(f: Optional[torch.Tensor], value):
    return value if f is None else f * value


class Adam(DeviceOptimizer, torch.optim.Adam):
    """``torch.optim.Adam`` (L2 weight decay added to the gradient) with its
    state layout, updated on the device (module docstring).  The parameters
    that step under one mask advance their counts together, so their bias
    correction is one 0-d factor, from the first one's count
    (``init_state`` refuses a load that gives them different counts).
    Without masks each parameter steps on its own (torch's step: one
    without a gradient stays behind)."""

    decoupled = False

    def __init__(self, params, lr: float = 0.0, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, lr=lr, betas=betas, eps=eps, weight_decay=weight_decay)

    def init_state(self, together: Sequence[Sequence[torch.nn.Parameter]] = ()) -> None:
        for ps in together:  # the counts on the host: fresh (0) or loaded
            counts = [self.state[p].get("step", 0.0) for p in ps]
            counts = {float(c) for c in counts
                      if not isinstance(c, torch.Tensor) or c.device.type == "cpu"}
            if len(counts) > 1:
                raise ValueError(f"parameters that step under one gate hold different step "
                                 f"counts {sorted(counts)}: one bias correction serves them")
        super().init_state()

    def _state_of(self, p: torch.nn.Parameter, group: dict) -> dict:
        st = self.state[p]
        if "step" not in st:
            st["step"] = torch.zeros((), dtype=torch.float32, device=p.device)
            st["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            st["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
        elif not isinstance(st["step"], torch.Tensor) or st["step"].device != p.device:
            st["step"] = torch.full((), float(st["step"]), dtype=torch.float32,
                                    device=p.device)  # (a load's host value)
        return st

    @torch.no_grad()
    def step(self, closure=None, masks: Masks = None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for i, group, mask, params, grads in self._subsets(masks, zero_missing=False):
            lr = self._lr_tensor(i, group, params[0].device)
            states = [self._state_of(p, group) for p in params]
            if mask is None:
                for one in zip(params, grads, states):
                    self._update(group, lr, None, *([x] for x in one))
            else:
                self._update(group, lr, mask, params, grads, states)
        return loss

    def _update(self, group, lr, mask, params, grads, states) -> None:
        b1, b2 = group["betas"]
        eps, wd = group["eps"], group["weight_decay"]
        steps = [st["step"] for st in states]
        ms = [st["exp_avg"] for st in states]
        vs = [st["exp_avg_sq"] for st in states]
        grads, f = _gated(mask, grads)
        lr = _times(f, lr)
        _count(steps, f)
        if wd:
            if self.decoupled:
                torch._foreach_mul_(params, 1.0 - lr * wd)
            else:
                grads = torch._foreach_add(grads, params, alpha=wd)
        torch._foreach_mul_(ms, _keep(mask, b1))
        torch._foreach_add_(ms, torch._foreach_mul(grads, _times(f, 1.0 - b1)))
        torch._foreach_mul_(vs, _keep(mask, b2))
        torch._foreach_addcmul_(vs, torch._foreach_mul(grads, _times(f, 1.0 - b2)), grads)
        # a gated leaf that never stepped has count 0: clamp (its update is 0);
        # size = lr / (b1^t - 1) = -lr / (1 - b1^t), root = sqrt(1 - b2^t)
        t = torch.clamp(steps[0], min=1.0)
        size = torch.reciprocal(torch.pow(b1, t) - 1.0) * lr
        root = torch.sqrt(-(torch.pow(b2, t) - 1.0))
        denom = torch._foreach_sqrt(vs)
        torch._foreach_div_(denom, root)
        torch._foreach_add_(denom, eps)
        torch._foreach_addcdiv_(params, torch._foreach_mul(ms, size), denom)


class AdamW(Adam):
    """``torch.optim.AdamW`` (decoupled weight decay: ``p -= lr * wd * p``),
    updated on the device."""

    decoupled = True


class SGD(DeviceOptimizer, torch.optim.SGD):
    """``torch.optim.SGD`` with momentum (no dampening, no Nesterov) and L2
    weight decay, its ``momentum_buffer`` state, updated on the device."""

    def __init__(self, params, lr: float = 0.0, momentum: float = 0.0,
                 weight_decay: float = 0.0):
        super().__init__(params, lr=lr, momentum=momentum, weight_decay=weight_decay)

    def _state_of(self, p: torch.nn.Parameter, group: dict) -> dict:
        st = self.state[p]
        if group["momentum"] and st.get("momentum_buffer") is None:
            st["momentum_buffer"] = torch.zeros_like(p, memory_format=torch.preserve_format)
        return st

    @torch.no_grad()
    def step(self, closure=None, masks: Masks = None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for i, group, mask, params, grads in self._subsets(masks, zero_missing=False):
            lr = self._lr_tensor(i, group, params[0].device)
            states = [self._state_of(p, group) for p in params]
            grads, f = _gated(mask, grads)
            if group["weight_decay"]:
                grads = torch._foreach_add(grads, params, alpha=group["weight_decay"])
            if group["momentum"]:
                d = [st["momentum_buffer"] for st in states]
                torch._foreach_mul_(d, _keep(mask, group["momentum"]))
                torch._foreach_add_(d, grads if f is None else torch._foreach_mul(grads, f))
            else:
                d = grads if f is None else torch._foreach_mul(grads, f)
            torch._foreach_add_(params, torch._foreach_mul(d, -_times(f, lr)))
        return loss


class Lars(DeviceOptimizer, torch.optim.Optimizer):
    """``optax.lars(lr, weight_decay, momentum=momentum)`` with its defaults
    (trust coefficient 0.001, eps 0, weight decay and trust ratio on every
    tensor, ``trace`` momentum without Nesterov), in fp32 per tensor:

      u = g + wd * p
      u = u * (tc * |p| / (|u| + eps))     (* 1 where |p| or |u| is 0)
      trace = -lr * u + momentum * trace
      p = p + trace

    Every tensor steps at every step (no gating; a tensor without a gradient
    steps with a zero one; ``masks`` is the non-finite guard).  Each
    tensor's state is its ``trace`` and ``count`` (a 0-d fp32 device
    tensor, the same for all: optax's schedule count, which a held step
    does not advance).  With ``schedule`` (a device function of the count,
    ``cosine_epoch_lr_on_device``) the learning rate is the schedule's at
    the count, computed once a step on the device; without, the group's."""

    def __init__(self, params, lr: float = 0.0, weight_decay: float = 0.0,
                 momentum: float = 0.9, trust_coefficient: float = 0.001, eps: float = 0.0):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay, momentum=momentum,
                                      trust_coefficient=trust_coefficient, eps=eps))
        self.schedule: Optional[Callable[[torch.Tensor], torch.Tensor]] = None

    @property
    def count(self) -> int:
        """The steps taken (a host read of the device count)."""
        for group in self.param_groups:
            for p in group["params"]:
                if "count" in self.state.get(p, {}):
                    return int(self.state[p]["count"])
        return 0

    def _state_of(self, p: torch.nn.Parameter, group: dict) -> dict:
        st = self.state[p]
        if "trace" not in st:
            st["trace"] = torch.zeros_like(p, dtype=torch.float32)
        count = st.get("count", 0)
        if not isinstance(count, torch.Tensor) or count.device != p.device:
            st["count"] = torch.as_tensor(count, dtype=torch.float32).to(p.device)
        return st

    @torch.no_grad()
    def step(self, closure=None, masks: Masks = None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for i, group, mask, params, grads in self._subsets(masks, zero_missing=True):
            states = [self._state_of(p, group) for p in params]
            counts = [st["count"] for st in states]
            traces = [st["trace"] for st in states]
            lr = (self.schedule(counts[0]) if self.schedule is not None
                  else self._lr_tensor(i, group, params[0].device))
            grads, f = _gated(mask, grads)
            u = torch._foreach_add(grads, params, alpha=group["weight_decay"])
            pn = torch.stack(torch._foreach_norm(params))
            un = torch.stack(torch._foreach_norm(u))
            ratio = torch.where((pn == 0) | (un == 0), torch.ones_like(pn),
                                group["trust_coefficient"] * pn / (un + group["eps"]))
            torch._foreach_mul_(u, list(ratio.unbind()))
            torch._foreach_mul_(u, -_times(f, lr))
            torch._foreach_mul_(traces, _keep(mask, group["momentum"]))
            torch._foreach_add_(traces, u)
            torch._foreach_add_(params, traces if f is None else torch._foreach_mul(traces, f))
            _count(counts, f)
        return loss


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
        return Adam(params, betas=(b1, b2), eps=eps, weight_decay=weight_decay)
    if name == "adamw":
        return AdamW(params, betas=(b1, b2), eps=eps, weight_decay=weight_decay)
    if name == "sgd":
        return SGD(params, momentum=b1, weight_decay=weight_decay)
    if name == "lars":
        return Lars(params, weight_decay=weight_decay, momentum=b1)
    raise ValueError(f"unknown optimizer {name!r}")


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Every group's learning rate (the device tensor too, written now:
    never inside a captured step)."""
    if isinstance(optimizer, DeviceOptimizer):
        optimizer.set_lr(lr)
        return
    for group in optimizer.param_groups:
        group["lr"] = lr
