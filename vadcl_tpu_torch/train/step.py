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
both).

Data parallelism: inside a process group (``core/mesh.py``) every process
runs the step on its own shard of the global batch.  The JAX step computes
its loss over the global batch, and all three terms are square roots of
batch sums, which do not split over processes: the sums are all-reduced
before each root (``parallel.sharding.global_sum``), so every process holds
the global loss and the gradient of it through its own shard.  The memory
families' losses are global sums over global counts, and their bank's
update reduces its softmax, maxima and sums over the group
(``global_sum``, ``global_max``), so every process holds the same bank.  The model
runs under ``DistributedDataParallel``, whose gradient all-reduce is made
to SUM those gradients (``_sum_gradients``, a communication hook; the
default hook averages), which gives the JAX step's global gradient.
Outside a group the step runs exactly as a single process always has.

Dropout and drop-path: with any rate above 0 the forward draws its masks
from ``DropKeys(seed + 0x5EED, step, rank * batch, world * batch)``
(``models/layers.py``), as the JAX step folds the step into
``key(seed + 0x5EED)``: a mask is a function of the step, the module and
the sample's global index, so a data-parallel rank draws the masks its
samples get in one process, and a recompute (``remat``) draws the
forward's.  The masks are not the JAX step's bits.

Tensor parallelism: with ``mesh`` (``core/mesh.py:make_mesh_2d``) and
``model_axis``, the processes form a (data, model) grid.  The processes of
a model group hold the same shard of the batch and split each forward and
backward over the group (``parallel/tp.py``: the fold kernels' window rows,
kernel B's rows, the plain path's heads and MLP hidden width); the batch
sums, the bank's reductions and the DDP gradient sum run over the data
group only, and the dropout masks are drawn by data index, so every
process of a model group draws the same masks.  After the backward every
process of a model group takes its first process's gradients
(``same_gradients``), so all hold the same update.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from vadcl_tpu_torch.core.config import TRAINABLE_ATTN_KERNELS, Config
from vadcl_tpu_torch.core.mesh import is_distributed, process_count, process_index
from vadcl_tpu_torch.models.backbone import MEMORY_BACKBONES, VADModel, predicts
from vadcl_tpu_torch.models.layers import DROPOUT_SEED_OFFSET, DropKeys, drop_keys
from vadcl_tpu_torch.ops.cluster import frobenius_norm
from vadcl_tpu_torch.parallel.sharding import global_max, global_sum
from vadcl_tpu_torch.parallel.tp import model_parallel
from vadcl_tpu_torch.train.optim import (
    Lars,
    apply_gates,
    build_optimizer,
    cosine_epoch_lr,
    param_gate_thresholds,
    set_lr,
)

PREDICT_INPUT_FRAMES = 4  # the reference's literal ``video[:, :, 0:4]``


@dataclass
class TrainState:
    """What the JAX ``TrainState`` holds: the step count, the model (its
    parameters and frozen batch statistics) and the optimizer (its state)."""

    step: int
    model: VADModel
    optimizer: torch.optim.Optimizer


class StepMetrics(NamedTuple):
    loss: torch.Tensor
    loss_pixel: torch.Tensor
    cluster_loss: torch.Tensor
    space_loss: torch.Tensor
    lr: float
    grad_finite: bool  # False: the step was skipped (non-finite loss)
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
    recon or None)); ``step`` is the host-side step count.  Inside a
    process group ``clip`` is this process's shard and the losses are the
    global batch's (the module docstring); ``model`` may be the
    ``DistributedDataParallel`` wrapper of a ``VADModel``.  Under tensor
    parallelism ``data_group``, ``data_index`` and ``data_size`` name the
    data group the batch is split over (default: the whole group)."""
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

    def loss_fn(clip: torch.Tensor, step: int):
        clip = normalize_clip(clip)
        inputs, target = split_predict_batch(clip, cfg.data.frame_num, predict,
                                             overlap_quirk=backbone == "swin")
        b = clip.shape[0]
        keys = (DropKeys(cfg.seed + DROPOUT_SEED_OFFSET, int(step), rank * b, world * b)
                if draws else None)
        with drop_keys(keys):
            if memory:  # the bank's update over the global batch
                out = model(inputs, global_sum=reduce, global_max=reduce_max,
                            update_memory=True)
            else:
                gate = None
                if cfg.model.compactness and backbone == "swin":
                    gate = torch.tensor(float(step >= sched.compactness_start_iter),
                                        device=clip.device)
                out = model(inputs, compactness_gate=gate, global_sum=reduce)
        err = out.recon.float() - target.float()
        loss_pixel = frobenius_norm(err * err, reduce)
        cluster_gate = float(step >= sched.cluster_start_iter)
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
    return torch.sqrt(sum((g.float() * g.float()).sum() for g in grads))


def _sum_gradients(process_group, bucket):
    """DDP communication hook: all-reduce a bucket of gradients as a sum
    (the default hook divides it by the world size)."""
    group = process_group if process_group is not None else dist.group.WORLD
    fut = dist.all_reduce(bucket.buffer(), group=group, async_op=True).get_future()
    return fut.then(lambda f: f.value()[0])


def data_parallel(model: VADModel, group=None) -> DistributedDataParallel:
    """``model`` under ``DistributedDataParallel``, its gradients summed
    over ``group`` (default: the whole group; the data group under tensor
    parallelism).  ``broadcast_buffers=False``: the buffers (relative
    position indices) are constant, and a broadcast before every forward
    would bump their version counters, which key the kernels' packed-weight
    cache (``ops/packed.py``).  ``find_unused_parameters`` stays False:
    every parameter enters the loss's graph at every step (a gated loss
    term is multiplied by 0, not skipped; a gated parameter's gradient is
    dropped after the all-reduce)."""
    dev = next(model.parameters()).device
    ddp = DistributedDataParallel(
        model, device_ids=[dev.index] if dev.type == "cuda" else None,
        broadcast_buffers=False, process_group=group)
    ddp.register_comm_hook(group, _sum_gradients)
    return ddp


def same_gradients(params, group) -> None:
    """Hand every process of a model ``group`` the gradients of its first
    process (one broadcast of them all, flattened).  The parameters used in
    a split region already hold the same summed gradient on every process;
    the others each process computed alone on the same values, and cuDNN's
    weight gradients are not bit-reproducible on the card, so without this
    the processes' parameters would drift apart by rounding, where the JAX
    package holds one replicated value."""
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.broadcast(flat, src=dist.get_global_rank(group, 0), group=group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


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
                    model_axis: Optional[str] = None
                    ) -> Callable[[TrainState, torch.Tensor], StepMetrics]:
    """step_fn(state, clip) -> StepMetrics for ``state.model is model``,
    updating ``state`` in place.

    One step: loss and backward at ``state.step``; global-norm clipping
    (``clip_grad`` > 0) over every gradient; gated parameters get no
    gradient (``lars`` gates none); the optimizer steps at lr(step) (LARS at
    lr of its own step count, optax's schedule count, which a skipped step
    does not advance); then the step count advances.  A non-finite loss skips the optimizer step, so parameters
    and optimizer state are held (the JAX step's ``jnp.where`` guard); it
    costs one host read of the loss per step.

    Inside a process group the step is data-parallel (the module
    docstring): ``clip`` is this process's shard, the model runs under
    ``data_parallel`` (which first broadcasts rank 0's parameters), and the
    gradients are the global sum when ``backward`` returns, so the clipping
    norm, the non-finite decision (the loss is the global loss) and the
    update are the same on every process.

    With ``mesh`` (a ``core.mesh.Mesh2D``) and ``model_axis`` the step is
    tensor-parallel over that axis and data-parallel over the other (the
    module docstring).  ``model_axis`` without a mesh holding it raises, and
    so does a fused model on the single-device ``base`` or ``packed``
    kernels, as in the JAX step."""
    _check_trainable(cfg)
    _check_model_axis(cfg, mesh, model_axis)
    model_group = None
    if mesh is None:
        fwd = data_parallel(model) if is_distributed() else model
        loss_fn = make_loss_fn(fwd, cfg, return_recon=cfg.dump_every_iters > 0)
    else:
        data_axis = next(a for a in mesh.axis_names if a != model_axis)
        group, size = mesh.group(data_axis), mesh.shape[data_axis]
        fwd = data_parallel(model, group) if size > 1 else model
        loss_fn = make_loss_fn(fwd, cfg, cfg.dump_every_iters > 0, group,
                               mesh.index(data_axis), size)
        if model_axis is not None and mesh.shape[model_axis] > 1:
            model_group = mesh.group(model_axis)
    lr_sched = cosine_epoch_lr(cfg.optim.lr, cfg.optim.min_lr, cfg.optim.epochs,
                               steps_per_epoch, cfg.optim.warmup_epochs)
    named = list(model.named_parameters())
    gates = param_gate_thresholds(named, cfg.schedule.cluster_train_start_iter)

    def step_fn(state: TrainState, clip: torch.Tensor) -> StepMetrics:
        if state.model is not model:
            raise ValueError("make_train_step: the state holds another model")
        opt = state.optimizer
        opt.zero_grad(set_to_none=True)
        # the backward inside too: a remat block recomputes its forward there
        with model_parallel(mesh, model_axis):
            loss, (lp, lc, ls, recon) = loss_fn(clip, state.step)
            loss.backward()
        if model_group is not None:
            same_gradients(model.parameters(), model_group)
        finite = bool(torch.isfinite(loss))
        lars = isinstance(opt, Lars)
        lr = lr_sched(opt.count if lars else state.step)
        if finite:
            if cfg.optim.clip_grad > 0:
                grads = [p.grad for _, p in named if p.grad is not None]
                scale = torch.clamp(cfg.optim.clip_grad / (global_grad_norm(grads) + 1e-6),
                                    max=1.0)
                for g in grads:
                    g.mul_(scale)
            if not lars:
                apply_gates(named, gates, state.step)
            set_lr(opt, lr)
            opt.step()
        opt.zero_grad(set_to_none=True)
        state.step += 1
        return StepMetrics(loss=loss.detach(), loss_pixel=lp.detach(),
                           cluster_loss=lc.detach(), space_loss=ls.detach(), lr=lr,
                           grad_finite=finite,
                           recon=recon.detach() if recon is not None else None)

    return step_fn
