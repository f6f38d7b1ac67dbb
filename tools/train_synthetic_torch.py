"""End-to-end slice of the PyTorch + CUDA port: synthetic data -> train ->
eval AUC, with the flags of ``tools/train_synthetic.py``:

  python tools/train_synthetic_torch.py [--steps N] [--size 64] [--predict] \\
      [--fused] [--device cuda|cpu] [--root DIR]

Writes the ShanghaiTech-shaped synthetic fixture (``data/synthetic.py``),
trains the tiny flagship config for ``--steps`` steps through ``train()``,
scores the test videos with the sliding-window evaluator (on the card one
captured CUDA graph replayed a batch) and prints the per-scene and mean AUC.  ``--device cuda`` (the default) trains in bf16 and
``--fused`` runs the hand-written kernels; it fails when no GPU is visible.
``--device cpu`` trains in fp32 with the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from vadcl_tpu_torch.core.config import (
    ClusterConfig,
    Config,
    DataConfig,
    ModelConfig,
    OptimConfig,
)
from vadcl_tpu_torch.data import ClipDataset, HostDataLoader, make_synthetic_dataset
from vadcl_tpu_torch.eval.predict import eval_input_frames, evaluate_videos, make_video_scorer
from vadcl_tpu_torch.train.loop import train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--predict", action="store_true")
    ap.add_argument("--fused", action="store_true")
    ap.add_argument("--root", type=str, default="")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cpu trains with the kernels' plain versions in fp32")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is visible; pass --device cpu")

    root = args.root or tempfile.mkdtemp(prefix="vadcl_synth_")
    train_dir, test_dir, label_dir = make_synthetic_dataset(
        root, num_train_videos=4, num_test_videos=4, frames_per_video=32, size=args.size)
    print("fixture at", root)

    size = args.size
    cfg = Config(
        model=ModelConfig(
            embed_dim=32, encoder_depths=(1, 1), encoder_heads=(2, 4),
            decoder_depths=(1, 1), decoder_heads=(4, 2), predict=args.predict,
            fused_attention=args.fused, fused_cluster=args.fused,
            attn_kernel="fold" if args.fused else "base",
            cluster=ClusterConfig(feature_clusters=16, space_clusters=8, space_size=size // 8),
        ),
        data=DataConfig(frame_num=4, image_size=(size, size)),
        optim=OptimConfig(lr=3e-4, min_lr=1e-5, epochs=8),
        batch_size_per_device=8,
        output_dir=os.path.join(root, "run"),
    )

    ds = ClipDataset(train_dir, frame_num=4, size=(size, size))
    loader = HostDataLoader(ds, batch_size=cfg.batch_size_per_device, seed=cfg.seed)
    state = train(cfg, loader, max_steps=args.steps, device=args.device)
    print("trained", state.step, "steps")

    model = state.model.eval()
    scorer = make_video_scorer(
        lambda clips: model(clips).recon, frame_num=4, predict=cfg.model.predict,
        batch_windows=8, input_frames=eval_input_frames("swin", cfg.model.predict, 4),
        device=args.device,
    )
    test_ds = ClipDataset(test_dir, frame_num=4, size=(size, size), label_root=label_dir,
                          istest=True)
    auc, per_scene, _ = evaluate_videos(scorer, test_ds.iter_test_videos(), frame_num=4,
                                        predict=cfg.model.predict, protocol="stride1")
    print("per-scene AUC:", {k: round(v, 4) for k, v in per_scene.items()})
    print("mean scene AUC:", round(auc, 4))
    return auc


if __name__ == "__main__":
    main()
