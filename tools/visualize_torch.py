"""Visual-inspection CLI of the PyTorch + CUDA port, with the subcommands of
``tools/visualize.py``:

  heatmaps  per-frame reconstruction-error jet heat maps over a test video
  tsne      cluster-feature export (with t-SNE) of the latent tokens
  losses    loss curves from .npy records, overlaid
  paradigm  a scores.npz curve against a paradigm curve (csv)

  python tools/visualize_torch.py heatmaps --ckpt run/ckpt/ckpt_100.npz \\
      --video /data/test/frames/01_0025 --out heatmaps/ [--device cuda|cpu]
  python tools/visualize_torch.py tsne --ckpt ... --video ... --out tsne.npz
  python tools/visualize_torch.py losses --records a.npy b.npy --out losses.png
  python tools/visualize_torch.py paradigm --scores scores.npz [--csv temp.csv]

``--ckpt`` reads a checkpoint of either package through ``tolerant_merge``
(whatever matches loads; the rest keeps the seeded init, seed 0).  The model
runs on the card (``--device cuda``, the default, bf16) unless ``--device
cpu`` asks for the CPU (fp32).  matplotlib, pandas and sklearn are
imported only by the subcommands that use them.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch


def _load_model(args):
    from vadcl_tpu_torch.core.config import preset
    from vadcl_tpu_torch.core.dtypes import compute_dtype
    from vadcl_tpu_torch.models import VADModel
    from vadcl_tpu_torch.train.checkpoint import tolerant_merge

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is visible; pass --device cpu")
    device = torch.device(args.device)
    cfg = preset(args.preset)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, predict=args.predict))
    model = VADModel(cfg.model, compute_dtype(device), torch.Generator().manual_seed(0))
    if args.ckpt:
        with np.load(args.ckpt) as z:
            flat = {}
            for k in z.files:
                if k.startswith("params/"):
                    flat[k] = z[k]
                elif k.startswith("extras/"):
                    flat[k.split("/", 1)[1]] = z[k]
        _, hits, _ = tolerant_merge(model, flat)
        print(f"loaded {len(hits)} leaves from {args.ckpt}")
    return cfg, model.to(device).eval(), device


def _clips(frames: np.ndarray, frame_num: int, device):
    """The video's non-overlapping ``frame_num``-frame clips, one at a time,
    as (1, F, H, W, 3) float tensors on ``device``."""
    for start in range(0, frames.shape[0] - frame_num, frame_num):
        clip = frames[None, start:start + frame_num]
        yield start, clip, torch.from_numpy(np.ascontiguousarray(clip)).to(device)


def cmd_heatmaps(args):
    from PIL import Image

    from vadcl_tpu_torch.data.dataset import load_video
    from vadcl_tpu_torch.viz.dumps import error_heatmap

    cfg, model, device = _load_model(args)
    frames = load_video(args.video, cfg.data.image_size)
    os.makedirs(args.out, exist_ok=True)
    with torch.inference_mode():
        for start, clip, t in _clips(frames, args.frame_num, device):
            recon = model(t).recon.float().cpu().numpy()[0]
            for i in range(recon.shape[0]):
                origin = clip[0, -1] if args.predict else clip[0, i]
                Image.fromarray(error_heatmap(recon[i], origin)).save(
                    os.path.join(args.out, f"heat_{start + i:04d}.png"))
    print("heat maps ->", args.out)


def cmd_tsne(args):
    from vadcl_tpu_torch.data.dataset import load_video
    from vadcl_tpu_torch.viz.dumps import export_cluster_embedding

    cfg, model, device = _load_model(args)
    frames = load_video(args.video, cfg.data.image_size)
    feats, labels = [], []
    with torch.inference_mode():
        for _, _, t in _clips(frames, args.frame_num, device):
            out = model(t)
            feats.append(out.feature.float().cpu().numpy())
            labels.append(out.feature_label.cpu().numpy())
    emb, _ = export_cluster_embedding(np.concatenate(feats), np.concatenate(labels), args.out)
    print(f"t-SNE of {emb.shape[0]} tokens ->", args.out)


def cmd_losses(args):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure(figsize=(8, 5))
    for rec in args.records:
        plt.plot(np.load(rec), label=os.path.splitext(os.path.basename(rec))[0])
    plt.xlabel("iteration")
    plt.ylabel("loss")
    plt.legend()
    plt.savefig(args.out, dpi=150, bbox_inches="tight")
    print("loss comparison ->", args.out)


def cmd_paradigm(args):
    """The model's per-video anomaly-score curves (the first ``--frames``
    frames of each video of a ``scores.npz`` from
    ``tools/evaluate_torch.py``) against a reference paradigm curve in the
    ``tool/temp.csv`` format (an index column and one value column);
    ``--export-csv`` writes the first curve in that format."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    with np.load(args.scores) as z:
        curves = {k: z[k][0] for k in sorted(z.files)}
    if not curves:
        raise SystemExit(f"no score curves in {args.scores}")
    other = None
    if args.csv:
        import pandas as pd

        other = pd.read_csv(args.csv, index_col=0).values.ravel()
    plt.figure(figsize=(8, 5))
    plt.title("Comparison of two anomaly detection paradigms")
    for name, scores in curves.items():
        plt.plot(scores[: args.frames], label=name)
    if other is not None:
        plt.plot(other[: args.frames], "k--", label="paradigm (csv)")
    plt.ylabel("Abnormal score")
    plt.xlabel("frames")
    plt.legend(fontsize=7)
    plt.savefig(args.out, dpi=150, bbox_inches="tight")
    print("paradigm comparison ->", args.out)
    if args.export_csv:
        import pandas as pd

        first = next(iter(curves.values()))[: args.frames]
        pd.DataFrame({"0": first}).to_csv(args.export_csv)
        print("score curve (temp.csv format) ->", args.export_csv)


def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name in ("heatmaps", "tsne"):
        p = sub.add_parser(name)
        p.add_argument("--preset", default="shanghaitech")
        p.add_argument("--ckpt", default="")
        p.add_argument("--video", required=True)
        p.add_argument("--out", required=True)
        p.add_argument("--predict", action="store_true")
        p.add_argument("--frame-num", type=int, default=4)
        p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    losses = sub.add_parser("losses")
    losses.add_argument("--records", nargs="+", required=True)
    losses.add_argument("--out", default="losses.png")
    c = sub.add_parser("paradigm")
    c.add_argument("--scores", required=True, help="scores.npz from tools/evaluate_torch.py")
    c.add_argument("--csv", default="", help="paradigm curve, temp.csv format")
    c.add_argument("--frames", type=int, default=24)
    c.add_argument("--out", default="paradigm.png")
    c.add_argument("--export-csv", default="")
    args = ap.parse_args(argv)
    {"heatmaps": cmd_heatmaps, "tsne": cmd_tsne, "losses": cmd_losses,
     "paradigm": cmd_paradigm}[args.cmd](args)


if __name__ == "__main__":
    main()
