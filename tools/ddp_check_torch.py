"""Hold the data-parallel path across N processes against one process: the
train step and the eval, on the cards (NCCL) or the CPU (gloo).

  torchrun --standalone --nproc_per_node N tools/ddp_check_torch.py \\
      [--device cuda|cpu] [--preset shanghaitech|tiny] [--global-batch 4] [--steps 4] \\
      [--backbone swin|unet3d|convae|convae_predict] [--per-rank-bank] \
      [--model-parallel M] [--no-graph]

Rank 0 first runs the one-process reference, before any process group
exists: ``make_train_step`` eagerly (``graph=False``; the flagship:
``fold``, fused, predict mode; another ``--backbone``: that family,
reconstruction unless it predicts) on each global batch for ``--steps``
steps from the seeded init, and ``evaluate_videos`` of the seeded init over
four synthetic uint8 videos in two scenes.  Then every process joins the
group (``maybe_initialize_distributed``), runs the same steps on its shard
of each global batch (``--global-batch`` / N clips) and
``evaluate_videos_distributed``.  On the card the group's step is captured
(``make_train_step``'s default: 2 eager steps, then one CUDA graph
replayed a step, its collectives inside); ``--no-graph`` runs it eagerly,
the control.  Then, on the card, every process runs turns (eager, graph,
graph, eager; eager alone with ``--no-graph``) of its step on its shard of
the first batch, the graph's from the checked run's state and the eager's
from a second state: host-clock ms a step, and on rank 0 the profiler's
device-busy ms, the idle share and NCCL's kernels a step, which must be
the same in replayed and eager steps and, across processes, more than 0.  Rank 0 holds the data-parallel run to the
bounds of ``chip_smoke.py``'s phase 6 (``vadcl_tpu_torch/utils/parity.py``:
the losses within the bf16 kernel bound, the parameters within the Adam
bound, the key biases apart; a memory family's bank within the bank bound
of the compute dtype, ``check_bank``, a query sent to another slot only at
a near tie), checks that every process ends on the same parameters (and a
memory family on the same bank) and that the AUCs are the one-process ones
to 1e-12, and prints one JSON line (on the card with its name and power
limit); a failed check exits non-zero.  ``--per-rank-bank`` is the
control: each process updates the bank over its own shard alone (the
group's reductions left out of the update), which the bank gate must
refuse.

``--model-parallel M`` makes the run tensor-parallel: the N processes form
(N / M data) x (M model) groups (``core/mesh.py:make_mesh_2d``), each model
group takes one data shard (``--global-batch`` / (N / M) clips) and splits
the fold kernels' window rows, kernel B's rows and the plain path's heads
and hidden width over its M processes (``parallel/tp.py``); the bounds are
the same.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from vadcl_tpu_torch.core.config import preset
from vadcl_tpu_torch.core.dtypes import compute_dtype
from vadcl_tpu_torch.core.mesh import (
    local_device,
    make_mesh_2d,
    maybe_initialize_distributed,
    process_count,
    shutdown_distributed,
)
from vadcl_tpu_torch.eval.predict import (
    eval_input_frames,
    evaluate_videos,
    evaluate_videos_distributed,
    make_video_scorer,
)
from vadcl_tpu_torch.models import VADModel
from vadcl_tpu_torch.models import memory as memory_module
from vadcl_tpu_torch.models.backbone import (
    BACKBONES,
    MEMORY_BACKBONES,
    model_input_frames,
    predicts,
)
from vadcl_tpu_torch.parallel import cross_host_concat
from vadcl_tpu_torch.train import create_train_state, make_train_step
from vadcl_tpu_torch.utils.parity import (
    BANK_BOUNDS,
    DDP_LOSS_RTOL,
    check_adam_bound,
    check_bank,
    last_update,
    recording_bank_updates,
)
from vadcl_tpu_torch.utils.provenance import smi_line


def synthetic_videos(size: int, seed: int = 0):
    """Four uint8 videos of 20-28 frames in two scenes, each with an
    anomalous span (a bright square)."""
    rng = np.random.RandomState(seed)
    out = []
    for t, scene in ((24, "01"), (20, "01"), (28, "02"), (22, "02")):
        frames = rng.randint(0, 256, (t, size, size, 3)).astype(np.uint8)
        labels = np.zeros(t, np.int64)
        labels[t // 2: t // 2 + 6] = 1
        frames[t // 2: t // 2 + 6, size // 4: size // 2, size // 4: size // 2] = 255
        out.append((frames, labels, scene))
    return out


def build_model(cfg, dev):
    """The seeded init of ``cfg``'s family, built for 4-frame clips."""
    return VADModel(cfg.model, compute_dtype(dev), torch.Generator().manual_seed(0),
                    model_input_frames(cfg.model.backbone, 4)).to(dev)


def bank_of(model):
    """A memory family's bank (None for the others)."""
    if model.config.backbone not in MEMORY_BACKBONES:
        return None
    return model.convae.memory.keys.detach().cpu()


def run_steps(cfg, dev, clips, rows: slice, mesh=None, graph=None):
    """``make_train_step`` (``graph`` as it takes it) from the seeded init
    over ``clips[:, rows]`` (tensor-parallel over ``mesh``'s model axis
    where one is given): the model, the per-step losses and host-clock step
    times, each step's bank update's top-1 slots and score gaps (a memory
    family; empty otherwise), the state and the step function."""
    model = build_model(cfg, dev)
    state = create_train_state(model, cfg)
    step_fn = make_train_step(model, cfg, steps_per_epoch=10, mesh=mesh,
                              model_axis=None if mesh is None else "model", graph=graph)
    losses, times, updates = [], [], []
    memory = cfg.model.backbone in MEMORY_BACKBONES
    with recording_bank_updates(on_device=True) as kept:
        for clip in clips:
            batch = torch.from_numpy(np.ascontiguousarray(clip[rows])).to(dev)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            losses.append(float(step_fn(state, batch).loss))  # the host read synchronises
            times.append(time.perf_counter() - t0)
            if memory:
                u = last_update(kept)
                updates.append((u["slots"], u["gap"]))
    return model, losses, times, updates, state, step_fn


TURN_STEPS, TRACED_STEPS = 4, 2  # a turn's timed steps, then its traced ones


def step_turn(step, clip, trace: bool) -> dict:
    """Host-clock ms a step of ``step(clip)`` over ``TURN_STEPS`` steps;
    then ``TRACED_STEPS`` more, traced by the profiler where ``trace``:
    device-busy ms a step, the unclipped idle share and NCCL's kernels a
    step.  Every process runs the same steps (their collectives meet)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TURN_STEPS):
        step(clip)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / TURN_STEPS * 1e3
    if not trace:
        for _ in range(TRACED_STEPS):
            step(clip)
        torch.cuda.synchronize()
        return {"ms": ms}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(4):  # marker kernels, so that the trace is live before the steps
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        for _ in range(TRACED_STEPS):
            step(clip)
        torch.cuda.synchronize()
    work = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False) and "spin_kernel" not in e.name]
    busy = sum(e.device_time_total for e in work) / 1e3 / TRACED_STEPS
    return {"ms": ms, "busy_ms": busy, "idle": 1 - busy / ms,
            "nccl_kernels": sum("nccl" in e.name.lower() for e in work) / TRACED_STEPS}


def step_turns(steps: dict, clip, trace: bool) -> dict:
    """Turns (eager, graph, graph, eager) of ``step_turn`` over ``steps``
    (``{"eager": fn}``, and ``"graph"`` where the step is captured)."""
    order = ("eager", "graph", "graph", "eager") if "graph" in steps else ("eager",) * 2
    out = {who: [] for who in steps}
    for who in order:
        out[who].append(step_turn(steps[who], clip, trace))
    return out


@contextlib.contextmanager
def per_rank_bank_updates():
    """While open, every bank update runs over this process's queries
    alone (the control of ``--per-rank-bank``)."""
    real = memory_module.memory_update
    memory_module.memory_update = lambda q, k, global_sum=None, global_max=None: real(q, k)
    try:
        yield
    finally:
        memory_module.memory_update = real


def score(cfg, dev, videos, distributed: bool):
    """Mean and per-scene AUC of the seeded init over ``videos``."""
    model = build_model(cfg, dev)
    model.eval()
    predict = predicts(cfg.model)
    scorer = make_video_scorer(lambda c: model(c).recon, frame_num=4, predict=predict,
                               batch_windows=8,
                               input_frames=eval_input_frames(cfg.model.backbone, predict, 4),
                               device=dev)
    if distributed:
        auc, scenes, _ = evaluate_videos_distributed(
            scorer, len(videos), lambda i: videos[i], sorted({v[2] for v in videos}), 4,
            predict)
    else:
        auc, scenes, _ = evaluate_videos(scorer, videos, 4, predict)
    return auc, scenes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--preset", default="shanghaitech")
    ap.add_argument("--global-batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=4,
                    help="steps (the captured step's third replays)")
    ap.add_argument("--backbone", default="swin", choices=list(BACKBONES))
    ap.add_argument("--per-rank-bank", action="store_true",
                    help="the control: each process updates the bank over its own shard alone")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="model groups of this many processes (tensor parallelism)")
    ap.add_argument("--no-graph", action="store_true",
                    help="the control: the group's step eagerly (graph=False)")
    args = ap.parse_args(argv)

    if "RANK" not in os.environ:
        raise SystemExit("run under torchrun: torchrun --standalone --nproc_per_node N ...")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    tp = args.model_parallel
    if world % tp or args.global_batch % (world // tp):
        raise SystemExit(f"--global-batch {args.global_batch} does not split over "
                         f"{world // tp} data shards of {world} processes")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is visible")
    dev = local_device(args.device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)
    base = preset(args.preset)
    cfg = base.replace(model=dataclasses.replace(
        base.model, backbone=args.backbone, predict=args.backbone == "swin",
        fused_attention=True, fused_cluster=True, attn_kernel="fold"))
    size = cfg.data.image_size[0]
    clips = np.random.RandomState(4).randint(
        0, 256, (args.steps, args.global_batch, 4, size, size, 3)).astype(np.uint8)
    videos = synthetic_videos(size)

    if rank == 0:  # the one-process reference, before the group exists
        ref_model, ref_losses, ref_times, ref_updates, _, _ = run_steps(cfg, dev, clips,
                                                                         slice(None), graph=False)
        ref_auc, ref_scenes = score(cfg, dev, videos, distributed=False)
    maybe_initialize_distributed(args.device)
    assert process_count() == world
    mesh, shard, per = None, rank, args.global_batch // world
    if tp > 1:
        mesh = make_mesh_2d(world // tp, tp)
        shard, per = mesh.index("data"), args.global_batch // (world // tp)
    rows = slice(shard * per, (shard + 1) * per)
    graph = False if args.no_graph else None
    per_rank = per_rank_bank_updates if args.per_rank_bank else contextlib.nullcontext
    with per_rank():
        model, losses, times, updates, state, step_fn = run_steps(cfg, dev, clips, rows, mesh,
                                                                  graph)
    # what the checks read, before the turns step the model on
    params = {k: p.detach().clone() for k, p in model.named_parameters()}
    bank = bank_of(model)
    auc, scenes = score(cfg, dev, videos, distributed=True)
    sums = cross_host_concat([float(sum(p.double().sum() for p in params.values()))])
    banks = cross_host_concat([None if bank is None else float(bank.double().sum())])
    every_rank_updates = cross_host_concat([updates])
    turns = None
    if dev.type == "cuda":
        clip = torch.from_numpy(np.ascontiguousarray(clips[0][rows])).to(dev)
        steps = {"eager": lambda x: step_fn(state, x)}
        with per_rank():
            if step_fn.graph is not None:  # the eager step beside the captured one
                _, _, _, _, eager_state, eager_fn = run_steps(cfg, dev, clips[:1], rows, mesh,
                                                              False)
                steps = {"graph": steps["eager"], "eager": lambda x: eager_fn(eager_state, x)}
            turns = step_turns(steps, clip, trace=rank == 0)
    if rank != 0:
        return 0

    ok, bound, bank_check = True, {}, {}
    worst_loss = float(np.max(np.abs(np.subtract(losses, ref_losses)) / np.abs(ref_losses)))
    try:
        bound = check_adam_bound("data-parallel", params, dict(ref_model.named_parameters()),
                                 cfg.optim.lr, args.steps)
    except AssertionError as e:
        print(f"FAILED: {e}")
        ok = False
    bank_bounds = BANK_BOUNDS[compute_dtype(dev)]
    if bank is not None:  # each update's queries in global batch order, step after step
        slots = torch.cat([torch.cat([r[i][0] for r in every_rank_updates[::tp]])
                           for i in range(args.steps)])
        try:
            bank_check = check_bank(
                "data-parallel bank", bank, bank_of(ref_model), slots,
                torch.cat([u[0] for u in ref_updates]), torch.cat([u[1] for u in ref_updates]),
                bank_bounds)
        except AssertionError as e:
            print(f"FAILED: {e}")
            ok = False
    auc_err = max([abs(auc - ref_auc)] + [abs(scenes[s] - ref_scenes[s]) for s in ref_scenes])
    ok = (ok and worst_loss <= DDP_LOSS_RTOL and len(set(sums)) == 1 and len(set(banks)) == 1
          and auc_err <= 1e-12 and scenes.keys() == ref_scenes.keys())
    nccl = None
    if turns is not None:  # NCCL's kernels a step, replayed and eager (rank 0's traces)
        nccl = {who: [t["nccl_kernels"] for t in ts] for who, ts in turns.items()}
        if "graph" in nccl:
            ok = ok and len(set(nccl["graph"] + nccl["eager"])) == 1
        if world > 1:
            ok = ok and min(min(v) for v in nccl.values()) > 0
    bank_diff = None if bank is None else float((bank - bank_of(ref_model)).abs().max())
    print(json.dumps({
        "ok": ok, "world": world, "model_parallel": tp, "device": str(dev),
        "backbone": args.backbone,
        "per_rank_bank": args.per_rank_bank,
        "card": smi_line() if dev.type == "cuda" else "cpu",
        "global_batch": args.global_batch, "losses": losses, "one_process_losses": ref_losses,
        "loss_rel_err": worst_loss, "loss_bound": DDP_LOSS_RTOL,
        "same_params_on_every_rank": len(set(sums)) == 1,
        "same_bank_on_every_rank": len(set(banks)) == 1, "bank_max_diff": bank_diff,
        "bank_rows_diff": bank_check.get("worst"), "bank_queries_apart": bank_check.get("moved"),
        "bank_gap_apart": bank_check.get("gap_apart"),
        "bank_rows_apart": bank_check.get("rows_apart"),
        "bank_bound": None if bank is None else bank_bounds[0],
        "bank_tie_gap": None if bank is None else bank_bounds[1],
        "param_max_diff": bound.get("worst"), "param_bound": bound.get("bound"),
        "auc": auc, "one_process_auc": ref_auc, "auc_abs_err": auc_err,
        "graph": step_fn.graph is not None,
        "step_ms": [t * 1e3 for t in times], "one_process_step_ms": [t * 1e3 for t in ref_times],
        "turns": turns, "nccl_kernels_a_step": nccl,
    }))
    return 0 if ok else 1


if __name__ == "__main__":
    try:
        code = main()
    finally:
        shutdown_distributed()
    sys.exit(code)
