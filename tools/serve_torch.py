"""Serve: score videos with a deployed ``torch.export`` artifact of the
PyTorch + CUDA port, no model code (the port's ``tools/serve.py``).

Loads the artifact (``tools/export_torch.py``; the weights ride in the
program), walks a directory of frame-folder videos (ShanghaiTech layout,
``SS_VVVV`` names) with the port's ``ClipDataset``, scores every window as
``tools/evaluate_torch.py`` does (PSNR -> per-video min-max anomaly score,
``evaluate_videos``) and writes ``scores.npz``; with ``--label-path`` it
also prints per-scene AUC.  On the card a static-batch artifact replays one
captured CUDA graph of its program a batch (``serve/export.py``); a
dynamic-batch artifact scores a video in one eager call.  The process imports the kernels' ops
(``vadcl_tpu_torch.ops.library``), the data and eval code, and nothing of
``vadcl_tpu_torch.models``.  The artifact runs on the device it was
exported on.

Usage:
  python tools/serve_torch.py --artifact artifact/ --data-path testing/frames \\
      [--label-path test_label] [--protocol stride1] [--out scores.npz]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--artifact", required=True)
    ap.add_argument("--data-path", required=True,
                    help="directory of frame-folder videos (test layout)")
    ap.add_argument("--label-path", default="",
                    help="optional <video>.npy label dir: prints per-scene AUC")
    ap.add_argument("--protocol", default="stride1", choices=["stride1", "nonoverlap"])
    ap.add_argument("--out", default="scores.npz")
    args = ap.parse_args(argv)

    from vadcl_tpu_torch.data.dataset import ClipDataset
    from vadcl_tpu_torch.eval.predict import evaluate_videos, windows_video_scorer
    from vadcl_tpu_torch.serve.export import load_artifact

    art = load_artifact(args.artifact)
    print(
        f"artifact: frame_num={art.frame_num} image={art.image_size} "
        f"predict={art.predict} batch_windows={art.batch_windows} "
        f"device={art.device} input={art.input_dtype}"
    )
    score = art.score
    if art.input_dtype != "uint8":
        # frame folders decode to uint8; float artifacts take [0, 1] pixels
        score = lambda windows: art.score(windows.float() / 255.0)  # noqa: E731
    # (the artifact's score is the captured call; a dynamic batch: a video at once)
    scorer = windows_video_scorer(score, art.frame_num, art.predict,
                                  batch_windows=art.batch_windows, device=art.device,
                                  graph=False)
    ds = ClipDataset(
        args.data_path,
        frame_num=art.frame_num,
        size=tuple(art.image_size),
        label_root=args.label_path or None,
        istest=True,
    )
    auc, per_scene, per_video = evaluate_videos(
        scorer, ds.iter_test_videos(), frame_num=art.frame_num, predict=art.predict,
        protocol=args.protocol,
    )
    if args.label_path:
        for scene, a in sorted(per_scene.items()):
            print(f"scene {scene}: AUC = {a:.4f}")
        print(f"mean scene AUC = {auc:.4f}")
    np.savez(
        args.out,
        **{
            f"video{i}_{v.scene}": np.stack([v.scores, v.labels.astype(np.float64)])
            for i, v in enumerate(per_video)
        },
    )
    print("per-video score curves ->", args.out)
    return auc


if __name__ == "__main__":
    main()
