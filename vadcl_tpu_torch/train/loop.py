"""Epoch training loop (``vadcl_tpu/train/loop.py``): data, step, logging,
checkpoints, eval hook, profiler window.

Kept from the JAX loop: the ``exp.log`` line format; mid-epoch auto-resume
from the newest checkpoint (the loader fast-forwards with ``start_iter``);
one-step-lagged metrics; ``loss_record/*.npy`` truncated to the resumed
step; ``save_every_iters`` / ``save_every_epochs``; ``auc_record.csv`` and
the ``best`` checkpoint; the non-finite-loss abort; the loss-spike batch
dump and the periodic input/recon dump (both need PIL, through
``vadcl_tpu_torch/viz/dumps.py``, which imports it only when used); a
profiler trace of a window of steps; anomaly detection (``debug_nans``).

Inside a process group (``core/mesh.py``, one process per card) every
process runs this loop on its own loader shard and the step is
data-parallel (``train/step.py``).  Only process 0 writes into
``output_dir``: the run stamp, ``exp.log``, checkpoints, loss records,
``auc_record.csv``, dumps and the trace; the others log nowhere.  Every
process resumes from process 0's newest checkpoint, and every save is
followed by a barrier, so no process reads a file half written.

The loader is anything with ``batch_size``, ``steps_per_epoch()`` and
``epoch(e, start_iter=0)`` yielding uint8 (B, T, H, W, 3) numpy batches
(the JAX package's ``HostDataLoader`` protocol); in a group, this
process's shard (``HostDataLoader(host_id=rank, num_hosts=world)``), with
the same ``steps_per_epoch()`` on every process.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from vadcl_tpu_torch.core.config import Config
from vadcl_tpu_torch.core.dtypes import compute_dtype
from vadcl_tpu_torch.core.mesh import barrier, process_count, process_index
from vadcl_tpu_torch.models.backbone import VADModel, model_input_frames, predicts
from vadcl_tpu_torch.train.checkpoint import CheckpointManager
from vadcl_tpu_torch.train.step import (
    TrainState,
    create_train_state,
    make_train_step,
    split_predict_batch,
)
from vadcl_tpu_torch.utils.profiling import StepTimer, trace_steps

__all__ = ["StepTimer", "get_logger", "train"]


def get_logger(path: str, name: str = "vadcl_torch", to_file: bool = True) -> logging.Logger:
    """File logger in the reference's [time][file][line][level] format,
    truncated per run (``misc/utils.py:79-95``).  ``to_file=False`` gives
    a silent logger (a ``NullHandler``, no propagation): the processes
    other than 0 of a group log nowhere."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    if not to_file:
        logger.addHandler(logging.NullHandler())
        logger.propagate = False
        return logger
    logger.propagate = True
    fh = logging.FileHandler(path, "w")
    fh.setFormatter(logging.Formatter(
        "[%(asctime)s][%(filename)s][line:%(lineno)d][%(levelname)s] %(message)s"))
    logger.addHandler(fh)
    return logger


def _dumps():
    """``save_clip_frames`` of ``vadcl_tpu_torch/viz/dumps.py`` (numpy + PIL)."""
    try:
        import PIL  # noqa: F401  the dumps import it at first use
    except ImportError as e:
        raise ImportError(
            "JPEG dumps (dump_every_iters > 0, the loss-spike dump) need PIL, "
            f"which this environment lacks ({e}); set dump_every_iters=0"
        ) from e
    from vadcl_tpu_torch.viz.dumps import save_clip_frames

    return save_clip_frames


def train(
    cfg: Config,
    loader,
    eval_fn: Optional[Callable[[TrainState], float]] = None,
    eval_every_epochs: int = 0,
    max_steps: Optional[int] = None,
    device: str = "cuda",
    profile_steps: int = 0,
    debug_nans: bool = False,
    mesh=None,
    model_axis: Optional[str] = None,
    graph: Optional[bool] = None,
) -> TrainState:
    """Train ``VADModel(cfg.model)`` (any family; the ConvAE families built
    for ``cfg.data.frame_num``-frame clips) from its seeded init
    (``cfg.seed``) or from the newest checkpoint under
    ``<output_dir>/ckpt``, the memory bank included.  Runs on the card
    (``device="cuda"``, compute dtype bf16 with ``cfg.bf16``) unless the
    caller asks for ``device="cpu"`` (fp32, the plain versions of the
    kernels); without a visible card the default raises instead of training
    on the CPU.  Stamps ``run_meta.json`` into the output directory.

    ``profile_steps`` > 0 traces steps ``[2, 2 + profile_steps)`` into
    ``<output_dir>/profile/trace.json`` (``utils/profiling.trace_steps``);
    ``debug_nans`` runs the loop under ``torch.autograd``'s anomaly
    detection, which names the backward op that first makes a NaN (the
    JAX loop's ``jax_debug_nans``).  In a process group (the module
    docstring) ``eval_fn`` runs on every process and must return the same
    AUC on each (``eval.predict.evaluate_videos_distributed``).

    ``mesh`` (``core/mesh.py:make_mesh_2d``) and ``model_axis`` make the
    step tensor-parallel over that axis (``train/step.py``); the loader
    then holds this process's data shard (``host_id`` its data index,
    ``num_hosts`` the data size), the same on every process of its model
    group.

    ``graph`` is ``make_train_step``'s: on a CUDA device every step -- one
    process, under torchrun, with a mesh and model axis, drawing dropout
    masks -- is one captured CUDA graph a step unless ``graph=False``;
    ``debug_nans`` runs eagerly (anomaly detection reads the backward's
    values on the host), and with ``graph=True`` raises."""
    dev = torch.device(device)
    if debug_nans:
        if graph:
            raise ValueError("graph=True: debug_nans runs the step eagerly: anomaly detection "
                             "reads the backward's values on the host (graph=False)")
        graph = False
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "train(): no CUDA device is visible; pass device=\"cpu\" to train on the CPU "
            "(fp32, the kernels' plain versions)"
        )
    is_main, world = process_index() == 0, process_count()
    if is_main:
        os.makedirs(cfg.output_dir, exist_ok=True)
        from vadcl_tpu_torch.utils.provenance import write_run_stamp

        write_run_stamp(cfg.output_dir, cfg, device=dev)
    logger = get_logger(os.path.join(cfg.output_dir, "exp.log"), to_file=is_main)
    ckpt = CheckpointManager(os.path.join(cfg.output_dir, "ckpt"))
    if cfg.dump_every_iters and is_main:
        _dumps()  # fail now, not at the first dump, when PIL is missing

    dtype = compute_dtype(dev) if cfg.bf16 else torch.float32
    model = VADModel(cfg.model, dtype, torch.Generator().manual_seed(cfg.seed),
                     model_input_frames(cfg.model.backbone, cfg.data.frame_num)).to(dev)
    model.train()
    steps_per_epoch = loader.steps_per_epoch()
    state = create_train_state(model, cfg)
    step_fn = make_train_step(model, cfg, steps_per_epoch, mesh=mesh, model_axis=model_axis,
                              graph=graph)

    # auto-resume inside the epoch from the newest checkpoint (epoch, iter)
    latest = ckpt.latest_tag()
    start_epoch, start_iter = 0, 0
    if latest is not None:
        ckpt.restore(latest, state)
        meta = ckpt.metadata(latest)
        start_epoch = int(meta.get("epoch", 0))
        start_iter = int(meta.get("iter", steps_per_epoch - 1)) + 1
        if start_iter >= steps_per_epoch:
            start_epoch, start_iter = start_epoch + 1, 0
        logger.info(f"resumed from checkpoint {latest} at epoch {start_epoch} iter {start_iter}")

    def to_device(batch) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(batch))
        if dev.type == "cuda":
            return t.pin_memory().to(dev, non_blocking=True)
        return t

    def save_checkpoint(tag: str, meta: dict) -> None:
        if is_main:
            ckpt.save(tag, state, meta)
        barrier()  # no process goes on (or resumes) before the file is whole

    shards = world // mesh.shape[model_axis] if model_axis is not None else world
    timer = StepTimer(clips_per_step=loader.batch_size * shards)
    best_auc = -1.0
    spike = {"prev_loss": None, "dumped": False}
    loss_record_dir = os.path.join(cfg.output_dir, "loss_record")
    loss_log = {"loss": [], "loss_pixel": [], "cluster_loss": [], "space_loss": []}

    def flush_loss_records():
        if not is_main or not loss_log["loss"]:
            return
        os.makedirs(loss_record_dir, exist_ok=True)
        for name, vals in loss_log.items():
            np.save(os.path.join(loss_record_dir, f"{name}.npy"), np.asarray(vals))

    if latest is not None and is_main:  # carry the records across the resume, cut at its step
        for name in loss_log:
            p = os.path.join(loss_record_dir, f"{name}.npy")
            if os.path.exists(p):
                loss_log[name] = list(np.load(p)[: state.step])

    def process_metrics(m, epoch_h, it_h, batch_h, step_h):
        loss = float(m.loss)
        if not np.isfinite(loss):
            logger.error(f"Loss is {loss}, stopping training")
            raise FloatingPointError(f"non-finite loss at step {step_h}")
        prev = spike["prev_loss"]
        if is_main and prev is not None and abs(loss - prev) > 10.0 and not spike["dumped"]:
            spike["dumped"] = True  # once per run (main_predict.py:290-294)
            try:
                save = _dumps()
            except ImportError as e:
                logger.warning(f"loss jumped {prev:.3f} -> {loss:.3f}; batch not dumped: {e}")
            else:
                save(batch_h, os.path.join(cfg.output_dir, "bug_data_detect"))
                logger.warning(f"loss jumped {prev:.3f} -> {loss:.3f}; batch dumped")
        spike["prev_loss"] = loss
        if is_main and cfg.dump_every_iters and step_h % cfg.dump_every_iters == 0:
            save = _dumps()
            batch_f = np.asarray(batch_h)
            if batch_f.dtype == np.uint8:
                batch_f = batch_f.astype(np.float32) / 255.0
            _, target = split_predict_batch(batch_f, cfg.data.frame_num, predicts(cfg.model),
                                            overlap_quirk=cfg.model.backbone == "swin")
            save(np.asarray(target), os.path.join(cfg.output_dir, "video_show_origin"))
            save(m.recon.float().cpu().numpy(), os.path.join(cfg.output_dir, "video_show"))
        loss_log["loss"].append(loss)
        loss_log["loss_pixel"].append(float(m.loss_pixel))
        loss_log["cluster_loss"].append(float(m.cluster_loss))
        loss_log["space_loss"].append(float(m.space_loss))
        logger.info(
            "Epoch:[{}/{}]\t batch:[{}/{}]\t loss={:.5f}\t lr={:.7f}\t "
            "clips/s={:.1f}".format(epoch_h, cfg.optim.epochs, it_h, steps_per_epoch, loss,
                                    m.lr, timer.clips_per_sec))

    lagged = None
    t0 = time.time()
    trace = contextlib.ExitStack()
    trace_stop = None
    # (set_detect_anomaly restores the former mode when the loop ends)
    with trace, torch.autograd.set_detect_anomaly(debug_nans or torch.is_anomaly_enabled()):
        for epoch in range(start_epoch, cfg.optim.epochs):
            first_iter = start_iter if epoch == start_epoch else 0
            for it, batch in enumerate(loader.epoch(epoch, start_iter=first_iter),
                                       start=first_iter):
                if profile_steps and trace_stop is None and state.step >= 2:
                    trace.enter_context(trace_steps(os.path.join(cfg.output_dir, "profile"),
                                                    enabled=is_main))
                    trace_stop = state.step + profile_steps
                m = step_fn(state, to_device(batch))
                if trace_stop is not None and state.step == trace_stop:
                    trace.close()  # the trace holds steps [2, 2 + profile_steps)
                timer.tick()
                # metrics with a one-step lag, as the JAX loop consumes them
                if lagged is not None:
                    process_metrics(*lagged)
                lagged = (m, epoch, it, batch, state.step)
                if cfg.save_every_iters and state.step % cfg.save_every_iters == 0:
                    # the checkpoint says step N: the records must hold steps 1..N
                    process_metrics(*lagged)
                    lagged = None
                    save_checkpoint(str(state.step), {"epoch": epoch, "iter": it})
                    flush_loss_records()
                if max_steps is not None and state.step >= max_steps:
                    if lagged is not None:
                        process_metrics(*lagged)
                    flush_loss_records()
                    return state
            if lagged is not None:
                process_metrics(*lagged)
                lagged = None
            flush_loss_records()
            if cfg.save_every_epochs and (epoch + 1) % cfg.save_every_epochs == 0:
                save_checkpoint(str(state.step), {"epoch": epoch, "iter": steps_per_epoch - 1})
            if eval_fn is not None and eval_every_epochs and (epoch + 1) % eval_every_epochs == 0:
                auc = eval_fn(state)
                logger.info(f"epoch {epoch} AUC={auc:.4f}")
                if is_main:
                    with open(os.path.join(cfg.output_dir, "auc_record.csv"), "a") as f:
                        f.write(f"{epoch},{auc:.6f}\n")
                if auc > best_auc:
                    best_auc = auc
                    save_checkpoint("best", {"epoch": epoch, "auc": auc})
    if lagged is not None:
        process_metrics(*lagged)
    flush_loss_records()
    logger.info(f"training done in {time.time() - t0:.1f}s")
    return state
