"""One rank of the port's multi-process CPU tests (run by
``tests/test_torch_port_dist.py``, never collected by pytest itself).

  python torch_dist_worker.py <mode> <rank> <world> <workdir>

Joins a gloo process group through a ``FileStore`` at ``<workdir>/store``
(no port), with one torch thread, and runs one mode against the inputs the
test wrote to ``<workdir>/inputs.pt``; it writes what the test checks to
``<workdir>/<mode>_rank<rank>.pt`` and exits 0, or raises.

* ``step``: ``make_train_step`` on this rank's shard of each global batch,
  three steps; then the same from the same weights with the reference's
  semantics (each rank's own loss, DDP's averaged gradients).
* ``train``: ``train()`` uninterrupted for two epochs, then the same run
  stopped after three steps and resumed; rank 1 records every write it
  makes below the workdir (it must make none).
* ``eval``: ``cross_host_gather_ragged`` (rank 1 holds no rows),
  ``cross_host_concat`` and ``evaluate_videos_distributed``.
* ``dropout_step``: ``step``'s first half alone, for a model that draws
  dropout and drop-path masks (each rank draws its own samples' masks).
* ``memory_step``: ``step`` for a memory family (``convae``): three steps
  on this rank's shard, the bank after each; then the same with each
  rank's bank update over its own shard alone (the losses still global).
* ``tp_forward``: tensor parallelism at (1, world): each case's forward
  under ``model_parallel`` on the whole batch, with the number of split
  calls that gathered rows and summed partials; then ``same_gradients`` of
  gradients that differ by rank.
* ``tp_step``: tensor parallelism at (world / model, model): one
  ``make_train_step(mesh=, model_axis="model")`` step a case on this
  rank's data shard of the global batch.
"""

import datetime
import logging
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from vadcl_tpu_torch.models import VADModel  # noqa: E402
from vadcl_tpu_torch.models import memory as memory_mod  # noqa: E402
from vadcl_tpu_torch.models.backbone import MEMORY_BACKBONES, model_input_frames  # noqa: E402
from vadcl_tpu_torch.train import step as step_mod  # noqa: E402

GROUP_TIMEOUT = datetime.timedelta(seconds=90)


def shard(batch, rank, world):
    """This rank's contiguous rows of a global batch."""
    per = len(batch) // world
    return batch[rank * per:(rank + 1) * per]


def run_steps(inputs, rank, world):
    cfg = inputs["cfg"]
    model = VADModel(cfg.model, torch.float32,
                     input_frames=model_input_frames(cfg.model.backbone, cfg.data.frame_num))
    model.load_state_dict(inputs["state_dict"])
    state = step_mod.create_train_state(model, cfg)
    step_fn = step_mod.make_train_step(model, cfg, inputs["steps_per_epoch"])
    losses, banks = [], []
    for clip in inputs["clips"]:
        m = step_fn(state, torch.from_numpy(shard(clip, rank, world)))
        losses.append([float(m.loss), float(m.loss_pixel), float(m.cluster_loss),
                       float(m.space_loss)])
        if cfg.model.backbone in MEMORY_BACKBONES:
            banks.append(model.convae.memory.keys.clone())
    opt = state.optimizer.state
    out = dict(
        losses=losses,
        params={k: p.detach().clone() for k, p in model.named_parameters()},
        moments={k: (opt[p]["exp_avg"].clone(), opt[p]["exp_avg_sq"].clone())
                 for k, p in model.named_parameters() if p in opt},
    )
    if banks:
        out["banks"] = banks
    return out


def run_half_batches(inputs):
    """The control for ``run_steps`` on two ranks, in one process and with
    no collective: each global batch is taken as two half-batch passes
    whose gradients accumulate before the one optimizer step, and each
    half's loss adds the other half's batch sums (from a first pass over
    each half whose graph is dropped) where two ranks would all-reduce
    them.  It does the arithmetic of two ranks at half batch in the order
    they do it."""
    real_make, real_sum = step_mod.make_loss_fn, step_mod.global_sum
    other = {"sums": None}
    seen = []

    def summed(t, group=None):
        seen.append(t.detach())
        return t if other["sums"] is None else t + other["sums"].pop(0)

    def make_loss_fn(model, cfg, return_recon=False, **kw):
        loss_fn = real_make(model, cfg, return_recon, **kw)

        def halves(clip, step):
            a, b = clip[:len(clip) // 2], clip[len(clip) // 2:]
            own = []
            for half in (a, b):
                other["sums"] = None
                seen.clear()
                loss_fn(half, step)
                own.append(list(seen))
            other["sums"] = own[1]
            loss_fn(a, step)[0].backward()
            other["sums"] = own[0]
            return loss_fn(b, step)  # the step's own backward adds b's gradients

        return halves

    step_mod.make_loss_fn, step_mod.global_sum = make_loss_fn, summed
    try:
        return run_steps(inputs, 0, 1)
    finally:
        step_mod.make_loss_fn, step_mod.global_sum = real_make, real_sum


def mode_step(inputs, rank, world):
    out = {"global": run_steps(inputs, rank, world)}
    # the reference's semantics: per-rank losses, gradients averaged by DDP
    step_mod.global_sum = lambda t, group=None: t
    step_mod.data_parallel = lambda m: torch.nn.parallel.DistributedDataParallel(
        m, broadcast_buffers=False)
    out["per_rank"] = run_steps(inputs, rank, world)
    return out


def mode_memory_step(inputs, rank, world):
    out = {"global": run_steps(inputs, rank, world)}
    real = memory_mod.memory_update

    def own_shard(query, keys, global_sum=None, global_max=None):
        return real(query, keys)  # this rank's queries alone

    memory_mod.memory_update = own_shard
    try:
        out["per_rank_bank"] = run_steps(inputs, rank, world)
    finally:
        memory_mod.memory_update = real
    return out


class ShardLoader:
    """In-memory uint8 loader with the HostDataLoader protocol: this rank's
    rows of each global batch."""

    def __init__(self, clips, rank, world):
        self.clips, self.rank, self.world = clips, rank, world
        self.batch_size = clips.shape[1] // world

    def steps_per_epoch(self):
        return len(self.clips)

    def epoch(self, e, start_iter=0):
        for i in range(start_iter, len(self.clips)):
            yield shard(self.clips[(e * len(self.clips) + i) % len(self.clips)], self.rank,
                        self.world)


def mode_train(inputs, rank, world, workdir):
    from vadcl_tpu_torch.core.mesh import barrier
    from vadcl_tpu_torch.train import train

    writes, recording = [], [rank != 0]
    if rank != 0:
        root = os.path.abspath(workdir)

        def audit(event, args):
            if not recording[0]:
                return
            if event == "open" and isinstance(args[0], (str, bytes, os.PathLike)):
                mode, flags = args[1], args[2]
                writing = (mode is not None and any(c in str(mode) for c in "wax+")) or (
                    mode is None and flags & (os.O_WRONLY | os.O_RDWR | os.O_CREAT))
                path = os.path.abspath(os.fsdecode(args[0]))
                if writing and path.startswith(root) and not path.startswith(
                        os.path.join(root, "store")):
                    writes.append((event, path))
            elif event in ("os.mkdir", "os.rename", "os.replace", "os.remove", "shutil.rmtree"):
                path = os.path.abspath(os.fsdecode(args[0]))
                if path.startswith(root):
                    writes.append((event, path))

        sys.addaudithook(audit)
    cfg = inputs["cfg"]
    clips = inputs["clips"]
    runs = {}
    a = train(cfg.replace(output_dir=os.path.join(workdir, "a")),
              ShardLoader(clips, rank, world), device="cpu")
    runs["a"] = {k: p.detach().clone() for k, p in a.model.named_parameters()}
    out_b = os.path.join(workdir, "b")
    stopped = train(cfg.replace(output_dir=out_b), ShardLoader(clips, rank, world),
                    max_steps=inputs["stop_after"], device="cpu")
    runs["stopped_step"] = stopped.step
    barrier()
    b = train(cfg.replace(output_dir=out_b), ShardLoader(clips, rank, world), device="cpu")
    runs["b"] = {k: p.detach().clone() for k, p in b.model.named_parameters()}
    recording[0] = False
    runs["steps"] = (a.step, b.step)
    runs["writes"] = writes
    runs["handlers"] = [type(h).__name__ for h in logging.getLogger("vadcl_torch").handlers]
    return runs


def mode_eval(inputs, rank, world):
    from vadcl_tpu_torch.eval.predict import (
        evaluate_videos_distributed,
        make_video_scorer,
    )
    from vadcl_tpu_torch.parallel import cross_host_concat, cross_host_gather_ragged

    out = {}
    # rank 0 holds 3 rows, rank 1 none, rank 2 (if any) 5
    rows = {0: 3, 1: 0}.get(rank, 5)
    mine = np.arange(rows * 2, dtype=np.float64).reshape(rows, 2) + 100.0 * rank
    out["ragged"] = cross_host_gather_ragged(mine)
    out["ragged_int"] = cross_host_gather_ragged(np.arange(rank + 1, dtype=np.int64))
    out["concat"] = cross_host_concat([f"r{rank}a", f"r{rank}b"])
    model = VADModel(inputs["cfg"].model, torch.float32)
    model.load_state_dict(inputs["state_dict"])
    model.eval()
    scorer = make_video_scorer(lambda c: model(c).recon, frame_num=4, predict=True,
                               batch_windows=4, input_frames=4, device="cpu")
    videos = inputs["videos"]
    auc, scenes, per_video = evaluate_videos_distributed(
        scorer, len(videos), lambda i: videos[i], all_scenes=sorted({v[2] for v in videos}),
        frame_num=4, predict=True)
    out["auc"], out["scenes"] = auc, scenes
    out["local_videos"] = [(v.scene, len(v.scores)) for v in per_video]
    return out


def _tp_model(case):
    cfg = case["cfg"]
    model = VADModel(cfg.model, torch.float32)
    model.load_state_dict(case["state_dict"])
    return cfg, model


def mode_tp_forward(inputs, rank, world):
    from vadcl_tpu_torch.core.mesh import make_mesh_2d
    from vadcl_tpu_torch.parallel import tp

    mesh = make_mesh_2d(1, world)
    calls = {"rows": 0, "partials": 0}
    gather, partial_sum = tp._GatherRows.apply, tp._SumPartials.apply

    def rows(*a):
        calls["rows"] += 1
        return gather(*a)

    def partials(*a):
        calls["partials"] += 1
        return partial_sum(*a)

    tp._GatherRows.apply, tp._SumPartials.apply = rows, partials
    out = {}
    for name, case in inputs["cases"].items():
        _, model = _tp_model(case)
        calls.update(rows=0, partials=0)
        with torch.no_grad(), tp.model_parallel(mesh, "model"):
            o = model(torch.from_numpy(case["clip"]))
        out[name] = dict(recon=o.recon.clone(), cluster_loss=o.cluster_loss.clone(),
                         space_loss=o.space_loss.clone(), calls=dict(calls))
    # same_gradients: every process ends on the model group's first one's
    params = [torch.nn.Parameter(torch.zeros(3, 2)), torch.nn.Parameter(torch.zeros(5))]
    for i, p in enumerate(params):
        p.grad = torch.full_like(p, 10.0 * rank + i)
    step_mod.same_gradients(params, mesh.group("model"))
    out["same_gradients"] = [p.grad.clone() for p in params]
    return out


def tp_step_result(model, state, m):
    """A step's loss terms, parameters and Adam moments (the first moment
    after one step is (1 - b1) times the gradient)."""
    opt = state.optimizer.state
    return dict(loss=[float(m.loss), float(m.loss_pixel), float(m.cluster_loss),
                      float(m.space_loss)],
                params={k: p.detach().clone() for k, p in model.named_parameters()},
                moments={k: opt[p]["exp_avg"].clone() for k, p in model.named_parameters()
                         if p in opt})


def mode_tp_step(inputs, rank, world):
    from vadcl_tpu_torch.core.mesh import make_mesh_2d
    from vadcl_tpu_torch.parallel import tp

    tp_size = inputs["model"]
    mesh = make_mesh_2d(world // tp_size, tp_size)
    data, shards = mesh.index("data"), world // tp_size
    out = {}
    replicate = tp._Replicate.apply
    for name, case in inputs["cases"].items():
        if case.get("unsummed"):  # the control: no gradient sum over the model group
            tp._Replicate.apply = lambda t, group: t
        cfg, model = _tp_model(case)
        state = step_mod.create_train_state(model, cfg)
        step_fn = step_mod.make_train_step(model, cfg, inputs["steps_per_epoch"], mesh=mesh,
                                           model_axis="model")
        m = step_fn(state, torch.from_numpy(shard(case["clip"], data, shards)))
        tp._Replicate.apply = replicate
        out[name] = tp_step_result(model, state, m)
    return out


def main():
    mode, rank, world, workdir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(workdir, "store"), world),
                            rank=rank, world_size=world, timeout=GROUP_TIMEOUT)
    try:
        inputs = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
        if mode == "step":
            out = mode_step(inputs, rank, world)
        elif mode == "train":
            out = mode_train(inputs, rank, world, workdir)
        elif mode == "eval":
            out = mode_eval(inputs, rank, world)
        elif mode == "dropout_step":
            out = {"global": run_steps(inputs, rank, world)}
        elif mode == "memory_step":
            out = mode_memory_step(inputs, rank, world)
        elif mode == "tp_forward":
            out = mode_tp_forward(inputs, rank, world)
        elif mode == "tp_step":
            out = mode_tp_step(inputs, rank, world)
        else:
            raise ValueError(mode)
        torch.save(out, os.path.join(workdir, f"{mode}_rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
