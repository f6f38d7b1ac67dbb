"""The training step (``vadcl_tpu/train/step.py``): forward, staged losses,
backward through the hand-written kernels, gated torch optimizer update.

Loss parity with ``main_predict.py:273-284``:
  loss = ||(recon - target)^2||_F  +  cluster_loss  +  space_loss
with the predict-mode frame split of ``main_predict.py:234-241`` (input = the
first 4 frames, target = the clip's last frame: at frame_num=4 the target
overlaps the input, the reference's quirk; ``convae_predict`` takes all but
the last frame and targets the true future frame).  Cluster losses turn on
at ``cluster_start_iter``; parameters named "cluster" train from
``cluster_train_start_iter``; the flagship's compactness engages at
``compactness_start_iter``.  The memory families (``convae``,
``convae_predict``) update their bank at every step; their separateness
and compactness ride the cluster and space loss slots.

Unlike the JAX step, which returns a new state, this step updates the
model's parameters and the optimizer's state in place (``TrainState`` holds
both).  Like the JAX step it reads nothing back to the host: the stage
gates are device tensors computed from a device step count, the optimizer
gates each parameter and holds everything on a non-finite loss on the
device (``train/optim.py``), the dropout masks are drawn from that count
on the device, and the metrics stay on the device.  On a CUDA device every
step -- one process, data-parallel, split over a model axis, drawing masks
-- is one captured CUDA graph a step, as the JAX step is one jitted
executable (``utils/graphs.py:CapturedCall`` with ``owned``: the run's
first two steps eager, then one capture, replayed every step; the
collectives are captured with the rest); ``graph=False`` runs the same
step eagerly.  Only ``train(debug_nans=True)`` stays eager.

Data parallelism: inside a process group (``core/mesh.py``) every process
runs the step on its own shard of the global batch.  The JAX step computes
its loss over the global batch, and all three terms are square roots of
batch sums, which do not split over processes: the sums are all-reduced
before each root (``parallel.sharding.global_sum``), so every process holds
the global loss and the gradient of it through its own shard.  The memory
families' losses are global sums over global counts, and their bank's
update reduces its softmax, maxima and sums over the group
(``global_sum``, ``global_max``), so every process holds the same bank.
After the backward the gradients, laid end to end in one buffer allocated
once (``GradientExchange``), are SUMMED over the group by one all-reduce
(``sum_gradients``; an average would not be the JAX step's gradient), as
XLA's psum follows the JAX step's backward; the parameters are rank 0's
from the start (one broadcast when the step is made).  Outside a group
the step runs exactly as a single process always has.

Dropout and drop-path: with any rate above 0 the forward draws its masks
from ``DropKeys(seed + 0x5EED, clock, rank * batch, world * batch)``
(``models/layers.py``), as the JAX step folds the step into
``key(seed + 0x5EED)``: a mask is a hash of the step (the device tensor
``clock``, so a replay draws its own step's masks), the module and the
element's global index, so a data-parallel rank draws the masks its
samples get in one process, and a recompute (``remat``) draws the
forward's.  The masks are not the JAX step's bits.

Tensor parallelism: with ``mesh`` (``core/mesh.py:make_mesh_2d``) and
``model_axis``, the processes form a (data, model) grid.  The processes of
a model group hold the same shard of the batch and split each forward and
backward over the group (``parallel/tp.py``: the fold kernels' window rows,
kernel B's rows, the plain path's heads and MLP hidden width); the batch
sums, the bank's reductions and the gradient sum run over the data group
only, and the dropout masks are drawn by data index, so every process of
a model group draws the same masks.  After the backward every process of
a model group takes its first process's gradients (``GradientExchange``,
in the same buffer), so all hold the same update.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from functools import partial
from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from vadcl_tpu_torch.core.config import TRAINABLE_ATTN_KERNELS, Config
from vadcl_tpu_torch.core.mesh import is_distributed, process_count, process_index
from vadcl_tpu_torch.models.backbone import MEMORY_BACKBONES, VADModel, predicts
from vadcl_tpu_torch.models.layers import DROPOUT_SEED_OFFSET, DropKeys, drop_keys
from vadcl_tpu_torch.ops.cluster import frobenius_norm
from vadcl_tpu_torch.parallel.sharding import global_max, global_sum
from vadcl_tpu_torch.parallel.tp import model_parallel
from vadcl_tpu_torch.train.optim import (
    DeviceOptimizer,
    Lars,
    build_optimizer,
    cosine_epoch_lr,
    cosine_epoch_lr_on_device,
    param_gate_thresholds,
    set_lr,
)
from vadcl_tpu_torch.utils.graphs import CapturedCall, wants_graph

PREDICT_INPUT_FRAMES = 4  # the reference's literal ``video[:, :, 0:4]``


@dataclass
class TrainState:
    """What the JAX ``TrainState`` holds: the step count, the model (its
    parameters and frozen batch statistics) and the optimizer (its state)."""

    step: int
    model: VADModel
    optimizer: torch.optim.Optimizer


class StepMetrics(NamedTuple):
    """A step's metrics, on the device (read them only where needed: a
    read waits for the step); ``lr`` is the schedule's at the step, as the
    JAX step reports it."""

    loss: torch.Tensor
    loss_pixel: torch.Tensor
    cluster_loss: torch.Tensor
    space_loss: torch.Tensor
    lr: float
    grad_finite: torch.Tensor  # 0-d bool; False: the update was held (non-finite loss)
    recon: Optional[torch.Tensor] = None  # carried when dump_every_iters > 0


def normalize_clip(clip: torch.Tensor) -> torch.Tensor:
    """uint8 batches normalize on the device (k / 255 in fp32); float
    batches pass through."""
    if clip.dtype == torch.uint8:
        return clip.float() / 255.0
    return clip


def split_predict_batch(clip, frame_num: int, predict: bool,
                        overlap_quirk: bool = True) -> Tuple:
    """``main_predict.py:234-241``: predict mode feeds the first 4 frames
    (hard-coded in the reference whatever ``frame_num`` is) and targets the
    clip's last frame; at the default frame_num=4 the target is also the
    last input frame.  Reconstruction mode targets the whole clip.
    ``overlap_quirk=False`` is MNAD's split, which ``convae_predict`` takes:
    every frame but the last in, the true future frame as the target."""
    if predict:
        if overlap_quirk:
            return clip[:, :PREDICT_INPUT_FRAMES], clip[:, -1:]
        return clip[:, :-1], clip[:, -1:]
    return clip, clip


def _check_trainable(cfg: Config) -> None:
    m = cfg.model
    if m.fused_attention and m.attn_kernel not in TRAINABLE_ATTN_KERNELS:
        raise ValueError(
            f"attn_kernel={m.attn_kernel!r} is inference-only (no backward); "
            f"trainable kernels: {sorted(TRAINABLE_ATTN_KERNELS)}"
        )


def stochastic(cfg: Config) -> bool:
    """Whether the step draws dropout or drop-path masks."""
    m = cfg.model
    return m.drop_rate > 0 or m.attn_drop_rate > 0 or m.drop_path_rate > 0


def make_loss_fn(model: VADModel, cfg: Config, return_recon: bool = False,
                 data_group=None, data_index: Optional[int] = None,
                 data_size: Optional[int] = None):
    """loss_fn(clip, step) -> (loss, (loss_pixel, cluster_loss, space_loss,
    recon or None)); ``step`` is the step count, a 0-d integer tensor on
    ``clip``'s device or a host int: the stage gates are computed from it on
    the device either way, and a step that draws dropout masks hashes it
    there, so no threshold and no mask is baked into a graph.  Inside a
    process group
    ``clip`` is this process's shard and the losses are the global batch's
    (the module docstring).  Under tensor parallelism ``data_group``,
    ``data_index`` and ``data_size`` name the data group the batch is split
    over (default: the whole group)."""
    _check_trainable(cfg)
    sched = cfg.schedule
    # over the data group (default: the whole process group; the identity
    # outside one)
    reduce = partial(global_sum, group=data_group)
    reduce_max = partial(global_max, group=data_group)
    rank = process_index() if data_index is None else data_index
    world = process_count() if data_size is None else data_size
    backbone = cfg.model.backbone
    predict, memory = predicts(cfg.model), backbone in MEMORY_BACKBONES
    draws = stochastic(cfg)

    def loss_fn(clip: torch.Tensor, step):
        clip = normalize_clip(clip)
        inputs, target = split_predict_batch(clip, cfg.data.frame_num, predict,
                                             overlap_quirk=backbone == "swin")
        b = clip.shape[0]
        at = step if isinstance(step, torch.Tensor) else torch.full(
            (), int(step), dtype=torch.int64, device=clip.device)
        keys = DropKeys(cfg.seed + DROPOUT_SEED_OFFSET, at, rank * b, world * b) if draws else None
        with drop_keys(keys):
            if memory:  # the bank's update over the global batch
                out = model(inputs, global_sum=reduce, global_max=reduce_max,
                            update_memory=True)
            else:
                gate = None
                if cfg.model.compactness and backbone == "swin":
                    gate = (at >= sched.compactness_start_iter).to(torch.float32)
                out = model(inputs, compactness_gate=gate, global_sum=reduce)
        err = out.recon.float() - target.float()
        loss_pixel = frobenius_norm(err * err, reduce)
        cluster_gate = (at >= sched.cluster_start_iter).to(torch.float32)
        cluster_loss = out.cluster_loss * cluster_gate
        space_loss = out.space_loss * cluster_gate
        loss = (sched.recon_weight * loss_pixel + sched.cluster_weight * cluster_loss
                + sched.space_weight * space_loss)
        return loss, (loss_pixel, cluster_loss, space_loss,
                      out.recon if return_recon else None)

    return loss_fn


def create_train_state(model: VADModel, cfg: Config) -> TrainState:
    """A fresh optimizer over the model's parameters at step 0."""
    o = cfg.optim
    opt = build_optimizer(o.optimizer, model.parameters(), o.weight_decay, o.b1, o.b2, o.eps)
    return TrainState(step=0, model=model, optimizer=opt)


def global_grad_norm(grads) -> torch.Tensor:
    """The L2 norm of every gradient together (optax's ``global_norm``)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))


def sum_gradients(flat: torch.Tensor, group) -> None:
    """Sum ``flat`` over ``group`` in place: one all-reduce of every
    gradient laid end to end."""
    dist.all_reduce(flat, group=group)


def _first_rank(group) -> int:
    return dist.get_global_rank(group or dist.group.WORLD, 0)


def _end_to_end(tensors):
    """``tensors`` by dtype, each run with one buffer that holds them end to
    end: a list of (tensors, buffer)."""
    out = []
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        ts = [t for t in tensors if t.dtype == dtype]
        out.append((ts, torch.empty(sum(t.numel() for t in ts), dtype=dtype,
                                    device=ts[0].device)))
    return out


def _views(ts, flat):
    """Views of ``flat`` shaped as ``ts``, in order."""
    return [v.view_as(t) for t, v in zip(ts, flat.split([t.numel() for t in ts]))]


class GradientExchange:
    """The gradients of ``params`` laid end to end in one buffer per dtype,
    allocated once (the same addresses at every step, as a captured step
    needs), exchanged in place: taken from the first process of
    ``model_group`` (a broadcast), then summed over ``data_group`` (an
    all-reduce, ``sum_gradients``; ``dist.group.WORLD`` for the whole
    group), each where its group is not None.  After ``__call__`` every
    gradient is a view of its buffer.

    The model group's broadcast: the parameters used in a split region
    already hold the same summed gradient on every process of the group;
    the others each process computed alone on the same values, and cuDNN's
    weight gradients are not bit-reproducible on the card, so without it
    the processes' parameters would drift apart by rounding, where the JAX
    package holds one replicated value."""

    def __init__(self, params, data_group=None, model_group=None):
        self.data_group, self.model_group = data_group, model_group
        self.buckets = _end_to_end(params)

    def __call__(self) -> None:
        for ps, flat in self.buckets:
            torch.cat([p.grad.reshape(-1) for p in ps], out=flat)
            if self.model_group is not None:
                dist.broadcast(flat, src=_first_rank(self.model_group), group=self.model_group)
            if self.data_group is not None:
                sum_gradients(flat, self.data_group)
            for p, g in zip(ps, _views(ps, flat)):
                p.grad = g


def broadcast_from_first(tensors, group=None) -> None:
    """Every process's ``tensors`` (parameters, buffers) set to the first
    process's of ``group`` (default: rank 0 of the whole group), as
    ``DistributedDataParallel`` does when it is built: one broadcast a
    dtype, of the tensors laid end to end."""
    with torch.no_grad():
        for ts, flat in _end_to_end([t for t in tensors if not t.is_inference()]):
            torch.cat([t.reshape(-1) for t in ts], out=flat)
            dist.broadcast(flat, src=_first_rank(group), group=group)
            for t, v in zip(ts, _views(ts, flat)):
                t.copy_(v)


def _check_model_axis(cfg: Config, mesh, model_axis: Optional[str]) -> None:
    """The JAX step's two guards, in its words."""
    if model_axis is None:
        return
    if mesh is None or model_axis not in mesh.axis_names:
        raise ValueError(
            f"model_axis={model_axis!r} requires a mesh with that axis "
            f"(got {mesh and mesh.axis_names})"
        )
    if cfg.model.fused_attention and cfg.model.attn_kernel not in ("fold", "fold_block"):
        raise ValueError(
            "model-axis parallelism runs the plain attention path or the "
            "fold kernels (attn_kernel='fold'/'fold_block', their window rows "
            "split over the model group); the 'base'/'packed' window-layout "
            "kernels are single-device — set fused_attention=False or "
            "attn_kernel='fold'"
        )


def make_train_step(model: VADModel, cfg: Config, steps_per_epoch: int, mesh=None,
                    model_axis: Optional[str] = None, graph: Optional[bool] = None,
                    capture: Optional[Callable] = None
                    ) -> Callable[[TrainState, torch.Tensor], StepMetrics]:
    """step_fn(state, clip) -> StepMetrics for ``state.model is model``,
    updating ``state`` in place.

    One step: loss and backward at ``state.step``; global-norm clipping
    (``clip_grad`` > 0) over every gradient; the optimizer steps at
    lr(step) (LARS at lr of its own step count, optax's schedule count,
    which a held step does not advance), each parameter gated at its
    threshold (``lars`` gates none) and every one held on a non-finite loss
    (the JAX step's ``jnp.where`` guard); then the step count advances.
    Nothing is read back to the host: the metrics are device tensors.

    ``graph``: None captures the step on a CUDA device (one CUDA graph
    replayed a step, ``utils/graphs.py:CapturedCall``, its collectives
    inside) and runs it eagerly elsewhere; False runs it eagerly; True on
    another device raises.  The choice is logged once, here.  ``capture``
    replaces the capture step (a test's double).

    Inside a process group the step is data-parallel (the module
    docstring): ``clip`` is this process's shard, rank 0's parameters and
    buffers are broadcast here, and after the backward the gradients are
    summed over the group (``GradientExchange``), so the clipping norm, the
    non-finite decision (the loss is the global loss) and the update are the
    same on every process.  The eager and the captured step take that one
    route.

    With ``mesh`` (a ``core.mesh.Mesh2D``) and ``model_axis`` the step is
    tensor-parallel over that axis and data-parallel over the other (the
    module docstring).  ``model_axis`` without a mesh holding it raises, and
    so does a fused model on the single-device ``base`` or ``packed``
    kernels, as in the JAX step."""
    _check_trainable(cfg)
    _check_model_axis(cfg, mesh, model_axis)
    device = next(model.parameters()).device
    captured = capture is not None or wants_graph(graph, device)
    split = is_distributed() and (mesh is None or process_count() > 1)
    logging.getLogger("vadcl_torch").info(
        "train step: " + ("one captured CUDA graph a step" if captured else
                          "eager (graph=False or not on a CUDA device)")
        + (", gradients exchanged between processes" if split else ""))
    model_group = None
    if mesh is None:
        loss_fn = make_loss_fn(model, cfg, return_recon=cfg.dump_every_iters > 0)
        sum_over = dist.group.WORLD if split else None
    else:
        data_axis = next(a for a in mesh.axis_names if a != model_axis)
        group, size = mesh.group(data_axis), mesh.shape[data_axis]
        loss_fn = make_loss_fn(model, cfg, cfg.dump_every_iters > 0, group,
                               mesh.index(data_axis), size)
        sum_over = group if size > 1 else None
        if model_axis is not None and mesh.shape[model_axis] > 1:
            model_group = mesh.group(model_axis)
    o = cfg.optim
    lr_sched = cosine_epoch_lr(o.lr, o.min_lr, o.epochs, steps_per_epoch, o.warmup_epochs)
    lars_sched = cosine_epoch_lr_on_device(o.lr, o.min_lr, o.epochs, steps_per_epoch,
                                           o.warmup_epochs)
    params = list(model.parameters())
    gates = param_gate_thresholds(model.named_parameters(), cfg.schedule.cluster_train_start_iter)
    thresholds = list(gates.values())
    together = [[p for p, t in zip(params, thresholds) if t == u] for u in set(thresholds)]
    exchange = None
    if split:
        broadcast_from_first(params + list(model.buffers()))
        exchange = GradientExchange(params, sum_over, model_group)
    clock = torch.zeros((), dtype=torch.int64, device=device)  # the step count, on the device
    held = {}  # the optimizer the step function below updates

    def device_step(clip: torch.Tensor):
        """The step on the device, the capture's unit: reads ``clock`` and
        the optimizer's learning rate, writes parameters and state in
        place; returns (losses (4,), finite, recon or None)."""
        opt = held["opt"]
        opt.zero_grad(set_to_none=True)
        # the backward inside too: a remat block recomputes its forward there
        with model_parallel(mesh, model_axis):
            loss, (lp, lc, ls, recon) = loss_fn(clip, clock)
            loss.backward()
        finite = torch.isfinite(loss)
        for p in params:  # every leaf gets a gradient, as in the JAX step
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if exchange is not None:
            exchange()
        if cfg.optim.clip_grad > 0:
            grads = [p.grad for p in params]
            scale = torch.clamp(cfg.optim.clip_grad / (global_grad_norm(grads) + 1e-6), max=1.0)
            torch._foreach_mul_(grads, scale)
        if isinstance(opt, Lars):
            masks = dict.fromkeys(params, finite)
        else:
            live = {t: finite & (clock >= t) if t > 0 else finite for t in set(thresholds)}
            masks = {p: live[t] for p, t in zip(params, thresholds)}
        opt.step(masks=masks)
        opt.zero_grad(set_to_none=True)
        losses = torch.stack([loss.detach(), lp.detach(), lc.detach(), ls.detach()]).float()
        return losses, finite, (recon.detach() if recon is not None else None)

    def owned():
        opt = held["opt"]
        return (params + list(model.buffers())
                + [t for st in opt.state.values() for t in st.values()
                   if isinstance(t, torch.Tensor)] + list(opt.lr_tensors()))

    graph_step = (CapturedCall(device_step, device, owned=owned, capture=capture,
                               inputs=lambda: [clock] + list(held["opt"].lr_tensors()))
                  if captured else None)

    def step_fn(state: TrainState, clip: torch.Tensor) -> StepMetrics:
        if state.model is not model:
            raise ValueError("make_train_step: the state holds another model")
        opt = state.optimizer
        if not isinstance(opt, DeviceOptimizer):
            raise TypeError(f"make_train_step: {type(opt).__name__} is not an optimizer of "
                            "train/optim.py (build_optimizer): the step gates on the device")
        if isinstance(opt, Lars):
            opt.schedule = lars_sched
        opt.init_state(together)
        held.update(opt=opt)
        with torch.no_grad():
            clock.fill_(state.step)
        lr = lr_sched(state.step)
        set_lr(opt, lr)
        losses, finite, recon = (device_step if graph_step is None else graph_step)(clip)
        state.step += 1
        return StepMetrics(loss=losses[0], loss_pixel=losses[1], cluster_loss=losses[2],
                           space_loss=losses[3], lr=lr, grad_finite=finite, recon=recon)

    step_fn.graph = graph_step
    return step_fn
