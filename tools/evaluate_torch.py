"""Evaluation CLI of the PyTorch + CUDA port: checkpoint -> per-scene
frame-level AUROC, with the flags of ``tools/evaluate.py``:

  python tools/evaluate_torch.py --fused --predict \\
      --test-data-path /data/test/frames --label-path /data/test/labels \\
      [--ckpt log_dir/ckpt/ckpt_100.npz | --torch-ckpt reference.pth] \\
      [--protocol stride1|nonoverlap|stride1_first_frame] \\
      [--backbone swin|unet3d|convae|convae_predict]

``--backbone`` picks the model family: the flagship Swin+I3D model
(``swin``), the 3D U-Net, or the MNAD memory autoencoders, of which
``convae_predict`` always scores its predicted frame (``--predict`` or
not) from the window's first ``frame_num - 1`` frames.

On N cards of one host, one process per card: ``torchrun --nproc_per_node
N tools/evaluate_torch.py ...``.  Process r scores videos r, r+N, ... on
``cuda:LOCAL_RANK``; the per-frame scores gather and every process computes
the same per-scene AUC (``evaluate_videos_distributed``), which rank 0
prints; each process writes its own videos' curves to
``<out>.proc<rank>.npz``.

``--ckpt`` takes a checkpoint written by either package (``params/...``
plus ``extras/batch_stats/...`` and a memory family's bank
``extras/memory/...``), loaded strictly; without it the model runs from
its seeded init (seed 0).  ``--torch-ckpt`` takes the reference's own
PyTorch ``Mymodel`` state_dict (a ``.pth``, ``module.``-prefixed or not):
``train/torch_import.py`` renames it to the JAX package's paths and
``tolerant_merge`` loads whatever matches in name and shape, the rest
keeping the seeded init, with the counts printed as ``tools/evaluate.py``
prints them.  ``--device cuda`` (the default) computes in bf16 and
``--fused`` runs the hand-written kernels (``--attn-kernel
fold|base|packed|fold_packed|fold_mix|fold_block`` picks the attention kernel,
fold by default); it fails when no GPU is visible.
``--device cpu`` computes in fp32 with the kernels' plain versions.
On the card each batch of ``--batch-windows`` windows replays one captured
CUDA graph of the window scorer (``eval/predict.py``); the CPU runs eagerly.
Per-video anomaly-score curves go to ``--out`` (npz).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from vadcl_tpu_torch.convert import load_jax_checkpoint
from vadcl_tpu_torch.core.config import preset
from vadcl_tpu_torch.core.dtypes import compute_dtype
from vadcl_tpu_torch.core.mesh import (
    local_device,
    maybe_initialize_distributed,
    process_count,
    process_index,
    shutdown_distributed,
)
from vadcl_tpu_torch.data import ClipDataset
from vadcl_tpu_torch.eval.predict import (
    eval_input_frames,
    evaluate_videos_distributed,
    make_video_scorer,
    scene_names,
)
from vadcl_tpu_torch.models import VADModel
from vadcl_tpu_torch.models.backbone import BACKBONES, model_input_frames, predicts
from vadcl_tpu_torch.train.torch_import import merge_reference_checkpoint


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="shanghaitech")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--torch-ckpt", default="",
                    help="a reference PyTorch .pth (Mymodel state_dict), translated")
    ap.add_argument("--test-data-path", required=True)
    ap.add_argument("--label-path", required=True)
    ap.add_argument("--predict", action="store_true")
    ap.add_argument("--protocol", default="stride1",
                    choices=["stride1", "nonoverlap", "stride1_first_frame"])
    ap.add_argument("--batch-windows", type=int, default=8)
    ap.add_argument("--frame-num", type=int, default=4)
    ap.add_argument("--image-size", type=int, default=0,
                    help="override square eval resolution (must match training)")
    ap.add_argument("--backbone", default="swin", choices=list(BACKBONES))
    ap.add_argument("--fused", action="store_true",
                    help="hand-written CUDA kernels (fold attention, LN->MLP, cluster heads)")
    ap.add_argument("--attn-kernel", default="auto",
                    choices=["auto", "fold", "base", "packed", "fold_packed", "fold_mix",
                             "fold_block"],
                    help="fused attention kernel: fold (on the unpartitioned tensor), base "
                         "(partitioned windows, trainable), packed (partitioned windows, "
                         "inference only), fold_packed (fold with the packed arithmetic, "
                         "inference only), fold_mix (fold_packed in blocks with 12 heads or "
                         "more, fold in the others; inference only) or fold_block (the whole "
                         "Swin block as one kernel); auto = 'fold' when --fused")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cpu runs the kernels' plain versions in fp32")
    ap.add_argument("--out", default="scores.npz")
    args = ap.parse_args(argv)

    cfg = preset(args.preset)
    attn_kernel = args.attn_kernel
    if attn_kernel == "auto":
        attn_kernel = "fold" if args.fused else "base"
    model_cfg = dataclasses.replace(
        cfg.model, predict=args.predict, backbone=args.backbone,
        fused_attention=args.fused, fused_cluster=args.fused,
        attn_kernel=attn_kernel,
    )
    image_size = cfg.data.image_size
    if args.image_size:
        image_size = (args.image_size, args.image_size)
        model_cfg = dataclasses.replace(
            model_cfg,
            cluster=dataclasses.replace(model_cfg.cluster, space_size=args.image_size // 8),
        )
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda: no CUDA device is visible; pass --device cpu to "
            "score on the CPU with the kernels' plain versions"
        )
    maybe_initialize_distributed(args.device)
    device = local_device(args.device)
    main_process = process_index() == 0
    predict = predicts(model_cfg)
    model = VADModel(model_cfg, compute_dtype(device), torch.Generator().manual_seed(0),
                     model_input_frames(args.backbone, args.frame_num))
    if args.torch_ckpt:
        hits, misses, unmatched = merge_reference_checkpoint(model, args.torch_ckpt)
        if main_process:
            print(f"translated torch ckpt: {len(hits)} loaded, {len(misses)} kept, "
                  f"{len(unmatched)} unmatched torch keys")
    elif args.ckpt:
        load_jax_checkpoint(model, args.ckpt)
        if main_process:
            print(f"checkpoint: {args.ckpt} loaded (strict)")
    model = model.to(device).eval()

    scorer = make_video_scorer(
        lambda clips: model(clips).recon,
        frame_num=args.frame_num,
        predict=predict,
        batch_windows=args.batch_windows,
        first_frame_quirk=args.protocol == "stride1_first_frame",
        input_frames=eval_input_frames(args.backbone, predict, args.frame_num),
        device=device,
    )
    ds = ClipDataset(
        args.test_data_path, frame_num=args.frame_num, size=image_size,
        label_root=args.label_path, istest=True,
    )
    proto = "stride1" if args.protocol == "stride1_first_frame" else args.protocol
    auc, per_scene, per_video = evaluate_videos_distributed(
        scorer, len(ds.videos), ds.get_test_video, all_scenes=scene_names(ds.videos),
        frame_num=args.frame_num, predict=predict, protocol=proto,
    )
    out = args.out
    if process_count() > 1:
        stem, ext = os.path.splitext(args.out)
        out = f"{stem}.proc{process_index()}{ext}"  # this process's videos only
    if main_process:
        for scene, a in sorted(per_scene.items()):
            print(f"scene {scene}: AUC = {a:.4f}")
        print(f"mean scene AUC = {auc:.4f}")
    np.savez(
        out,
        **{
            f"video{i}_{v.scene}": np.stack([v.scores, v.labels.astype(np.float64)])
            for i, v in enumerate(per_video)
        },
    )
    print("per-video score curves ->", out)
    return auc


if __name__ == "__main__":
    try:
        main()
    finally:
        shutdown_distributed()
