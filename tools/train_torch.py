"""Training CLI of the PyTorch + CUDA port, with the flags of
``tools/train.py``:

  python tools/train_torch.py --preset shanghaitech --data-path /data/frames \\
      --predict --fused [--epochs N] [--max-steps N] [--output-dir log_dir] \\
      [--test-data-path ... --label-path ... --eval-every 4] \\
      [--backbone swin|unet3d|convae|convae_predict]

``--backbone`` picks the model family: the flagship Swin+I3D model
(``swin``), the 3D U-Net, or the MNAD memory autoencoders, whose bank
updates every step and is saved in every checkpoint; ``convae_predict``
always trains to predict the clip's last frame from the frames before it.

Data-parallel on N cards of one host, one process per card:

  torchrun --nproc_per_node N tools/train_torch.py --preset shanghaitech ...

Each process takes ``cuda:LOCAL_RANK`` and its shard of every epoch; the
batch size is per process, the loss is the global batch's, and only rank 0
writes into the output directory (``train/loop.py``); the periodic eval
deals the test videos over the processes (``evaluate_videos_distributed``).

Tensor parallelism, the world cut into (N / M data) x (M model) groups of
consecutive ranks (``core/mesh.py:make_mesh_2d``):

  torchrun --nproc_per_node N tools/train_torch.py --model-parallel M ...

Each model group holds one shard of the batch (the batch size is per data
shard) and splits its forward and backward over its M processes: the plain
path's heads and MLP hidden width (``parallel/tp.py``).  As
``tools/train.py`` does, ``--model-parallel`` above 1 turns ``--fused``
off; the fold kernels on window-row shards are reached through
``train(mesh=, model_axis=)`` with a fused ``fold`` or ``fold_block``
config.  M must divide N.

Checkpoints land under ``<output-dir>/ckpt`` in the JAX package's npz
layout, with auto-resume (either package resumes from the other's).
``--device cuda`` (the default) computes in bf16 and ``--fused`` runs the
hand-written kernels, forward and backward (``--attn-kernel
fold|base|fold_block`` picks the attention kernel, fold by default); it
fails when no GPU is visible.  ``--device cpu`` trains in fp32 with the
kernels' plain versions (under torchrun: gloo).  ``--profile-steps N``
traces steps [2, 2+N) into ``<output-dir>/profile/trace.json``;
``--debug-nans`` turns on autograd's anomaly detection.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from vadcl_tpu_torch.core.config import preset
from vadcl_tpu_torch.core.mesh import (
    local_device,
    make_mesh_2d,
    maybe_initialize_distributed,
    process_count,
    process_index,
    shutdown_distributed,
)
from vadcl_tpu_torch.data import ClipDataset, HostDataLoader
from vadcl_tpu_torch.models.backbone import BACKBONES, predicts
from vadcl_tpu_torch.train.loop import train


def build_eval_fn(cfg, test_dir: str, label_dir: str, device: torch.device):
    """Per-scene AUC of the training model on a test split
    (``vadcl_tpu_torch.eval``), for the loop's eval hook."""
    from vadcl_tpu_torch.eval.predict import (
        eval_input_frames,
        evaluate_videos_distributed,
        make_video_scorer,
        scene_names,
    )

    test_ds = ClipDataset(test_dir, frame_num=cfg.data.frame_num, size=cfg.data.image_size,
                          label_root=label_dir, istest=True)
    predict = predicts(cfg.model)

    def eval_fn(state) -> float:
        model = state.model

        def apply_fn(clips):
            with torch.no_grad():
                return model(clips).recon

        scorer = make_video_scorer(
            apply_fn, frame_num=cfg.data.frame_num, predict=predict,
            batch_windows=cfg.eval.batch_windows,
            input_frames=eval_input_frames(cfg.model.backbone, predict, cfg.data.frame_num),
            device=device,
        )
        auc, per_scene, _ = evaluate_videos_distributed(
            scorer, len(test_ds.videos), test_ds.get_test_video,
            all_scenes=scene_names(test_ds.videos), frame_num=cfg.data.frame_num,
            predict=predict, protocol=cfg.eval.protocol,
        )
        if process_index() == 0:
            print("per-scene AUC:", {k: round(v, 4) for k, v in per_scene.items()})
            print("mean scene AUC:", round(auc, 4))
        return auc

    return eval_fn


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="shanghaitech")
    ap.add_argument("--data-path", required=True)
    ap.add_argument("--test-data-path", default="")
    ap.add_argument("--label-path", default="")
    ap.add_argument("--output-dir", default="log_dir")
    ap.add_argument("--predict", action="store_true")
    ap.add_argument("--epochs", type=int, default=0)
    ap.add_argument("--batch-size", type=int, default=0)
    ap.add_argument("--lr", type=float, default=0.0)
    ap.add_argument("--frame-num", type=int, default=0)
    ap.add_argument("--eval-every", type=int, default=0, help="epochs")
    ap.add_argument("--max-steps", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cluster-start-iter", type=int, default=0)
    ap.add_argument("--dump-every-iters", type=int, default=0,
                    help="dump target+recon JPEGs every N steps (needs PIL); 0 disables")
    ap.add_argument("--no-cluster", action="store_true")
    ap.add_argument("--backbone", default="swin", choices=list(BACKBONES))
    ap.add_argument("--fused", action="store_true",
                    help="hand-written CUDA kernels (fold attention, LN->MLP, cluster heads)")
    ap.add_argument("--attn-kernel", default="auto",
                    choices=["auto", "fold", "base", "fold_block"],
                    help="fused attention kernel: fold (on the unpartitioned tensor), base "
                         "(partitioned windows) or fold_block (the whole Swin block as one "
                         "kernel each way); packed, fold_packed and fold_mix are inference "
                         "only; auto = 'fold' when --fused")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cpu trains with the kernels' plain versions in fp32")
    ap.add_argument("--profile-steps", type=int, default=0,
                    help="trace steps [2, 2+N) into <output-dir>/profile/trace.json")
    ap.add_argument("--debug-nans", action="store_true",
                    help="autograd anomaly detection: name the op that first makes a NaN")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="split heads + MLP hidden over model groups of this many processes "
                         "(tensor parallelism, parallel/tp.py); the processes split as "
                         "(N/M data) x (M model); the plain attention path, so --fused is "
                         "forced off.  1 = pure data parallelism (default)")
    args = ap.parse_args(argv)

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda: no CUDA device is visible; pass --device cpu to "
            "train on the CPU with the kernels' plain versions"
        )
    maybe_initialize_distributed(args.device)
    device = local_device(args.device)
    fused = args.fused
    if args.model_parallel > 1:
        fused = False  # as tools/train.py: the plain path splits its heads and hidden width
    attn_kernel = args.attn_kernel
    if attn_kernel == "auto":
        attn_kernel = "fold" if fused else "base"
    cfg = preset(args.preset)
    cfg = cfg.replace(
        data=dataclasses.replace(
            cfg.data, data_path=args.data_path, test_data_path=args.test_data_path,
            label_path=args.label_path, frame_num=args.frame_num or cfg.data.frame_num,
        ),
        model=dataclasses.replace(
            cfg.model, predict=args.predict, backbone=args.backbone,
            use_cluster=not args.no_cluster, fused_attention=fused,
            fused_cluster=fused, attn_kernel=attn_kernel,
        ),
        schedule=dataclasses.replace(
            cfg.schedule, cluster_start_iter=args.cluster_start_iter,
            cluster_train_start_iter=args.cluster_start_iter,
        ),
        output_dir=args.output_dir, seed=args.seed, dump_every_iters=args.dump_every_iters,
    )
    if args.epochs:
        cfg = cfg.replace(optim=dataclasses.replace(cfg.optim, epochs=args.epochs))
    if args.lr:
        cfg = cfg.replace(optim=dataclasses.replace(cfg.optim, lr=args.lr))
    if args.batch_size:
        cfg = cfg.replace(batch_size_per_device=args.batch_size)

    mesh, model_axis = None, None
    shard, shards = process_index(), process_count()
    if args.model_parallel > 1:
        tp = args.model_parallel
        if shards % tp:
            raise SystemExit(f"--model-parallel {tp} must divide the process count {shards}")
        mesh, model_axis = make_mesh_2d(shards // tp, tp), "model"
        shard, shards = mesh.index("data"), shards // tp  # the batch shards over data only
    ds = ClipDataset(cfg.data.data_path, frame_num=cfg.data.frame_num, size=cfg.data.image_size)
    loader = HostDataLoader(ds, batch_size=cfg.batch_size_per_device, seed=cfg.seed,
                            num_workers=cfg.data.num_workers, prefetch=cfg.data.prefetch,
                            host_id=shard, num_hosts=shards)
    if process_index() == 0:
        print(f"{len(ds)} train clips on {process_count()} x {device}"
              + (f" ({shards} data x {args.model_parallel} model)" if mesh else ""))
    eval_fn = None
    if args.test_data_path and args.eval_every:
        eval_fn = build_eval_fn(cfg, args.test_data_path, args.label_path, device)
    return train(cfg, loader, eval_fn=eval_fn, eval_every_epochs=args.eval_every,
                 max_steps=args.max_steps or None, device=str(device),
                 profile_steps=args.profile_steps, debug_nans=args.debug_nans,
                 mesh=mesh, model_axis=model_axis)


if __name__ == "__main__":
    try:
        main()
    finally:
        shutdown_distributed()
