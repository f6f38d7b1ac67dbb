"""Export the PyTorch + CUDA port's scorer as a self-contained serving
artifact (``torch.export``), with the flags of ``tools/export.py``:

  python tools/export_torch.py --ckpt log_dir/ckpt/ckpt_100.npz --out artifact/ \\
      [--predict] [--batch-windows 64] [--fused] [--attn-kernel fold] \\
      [--device cuda|cpu] [--check]

The artifact scores uint8 video windows with no model code
(``vadcl_tpu_torch/serve``); its graph calls the hand-written kernels as
``torch.ops.vadcl.*`` ops.  ``--ckpt`` reads a checkpoint of either
package (``params/...``, ``extras/...``) through ``tolerant_merge``:
whatever matches loads, the rest keeps the seeded init (seed 0), and the
counts are printed.  ``--device cuda`` (the default) exports the bf16 model
on the card and fails when none is visible; ``--device cpu`` exports the
fp32 model (the kernels' plain versions).  ``--fused`` needs a static
``--batch-windows``; ``--batch-windows 0`` exports a dynamic batch (the
plain model).  ``--check`` reloads the artifact and holds its scores on
random windows against the live ``window_score_fn``: ``1e-5 + 1e-3 *
max|want|`` in fp32, the bf16 bound of ``utils/parity.py`` in bf16.
``--torch-ckpt`` reads a reference PyTorch ``.pth`` instead, renamed by
``train/torch_import.py`` and merged the same way.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from vadcl_tpu_torch.core.config import preset
from vadcl_tpu_torch.core.dtypes import compute_dtype
from vadcl_tpu_torch.eval.predict import eval_input_frames, window_score_fn
from vadcl_tpu_torch.models import VADModel
from vadcl_tpu_torch.models.backbone import BACKBONES, model_input_frames, predicts
from vadcl_tpu_torch.serve import export_window_scorer, load_artifact, save_artifact
from vadcl_tpu_torch.train.checkpoint import tolerant_merge
from vadcl_tpu_torch.train.torch_import import merge_reference_checkpoint
from vadcl_tpu_torch.utils.parity import score_bound


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="shanghaitech")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--torch-ckpt", default="",
                    help="a reference PyTorch .pth (Mymodel state_dict), translated")
    ap.add_argument("--out", required=True)
    ap.add_argument("--predict", action="store_true")
    ap.add_argument("--first-frame-quirk", action="store_true")
    ap.add_argument("--batch-windows", type=int, default=64,
                    help="0 = dynamic batch (the plain model only)")
    ap.add_argument("--frame-num", type=int, default=4)
    ap.add_argument("--image-size", type=int, default=0)
    ap.add_argument("--backbone", default="swin", choices=list(BACKBONES))
    ap.add_argument("--fused", action="store_true",
                    help="hand-written CUDA kernels (static batch)")
    ap.add_argument("--attn-kernel", default="fold",
                    choices=["fold", "base", "packed", "fold_packed", "fold_mix", "fold_block"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--check", action="store_true",
                    help="reload the artifact and verify it against the live model")
    args = ap.parse_args(argv)

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is visible; pass --device cpu "
                           "to export the plain model on the CPU")
    device = torch.device(args.device)
    cfg = preset(args.preset)
    predict = args.predict or args.backbone == "convae_predict"
    model_cfg = dataclasses.replace(
        cfg.model, predict=args.predict, backbone=args.backbone,
        fused_attention=args.fused, fused_cluster=args.fused,
        attn_kernel=args.attn_kernel if args.fused else "base",
    )
    image_size = cfg.data.image_size
    if args.image_size:
        image_size = (args.image_size, args.image_size)
        model_cfg = dataclasses.replace(
            model_cfg,
            cluster=dataclasses.replace(model_cfg.cluster, space_size=args.image_size // 8),
        )
    dtype = compute_dtype(device)
    model = VADModel(model_cfg, dtype, torch.Generator().manual_seed(0),
                     model_input_frames(args.backbone, args.frame_num))
    if args.torch_ckpt:
        hits, misses, _ = merge_reference_checkpoint(model, args.torch_ckpt)
        print(f"translated torch ckpt: {len(hits)} loaded, {len(misses)} kept")
    elif args.ckpt:
        with np.load(args.ckpt) as z:
            flat = {}
            for k in z.files:
                if k.startswith("params/"):
                    flat[k] = z[k]
                elif k.startswith("extras/"):
                    flat[k.split("/", 1)[1]] = z[k]
        _, hits, misses = tolerant_merge(model, flat)
        print(f"checkpoint: {len(hits)} loaded, {len(misses)} kept at init")
    model = model.to(device).eval()
    input_frames = eval_input_frames(args.backbone, predict, args.frame_num)

    program, meta = export_window_scorer(
        model,
        batch_windows=args.batch_windows or None,
        frame_num=args.frame_num,
        image_size=image_size,
        predict=predict,
        first_frame_quirk=args.first_frame_quirk,
        input_frames=input_frames,
    )
    meta["preset"] = args.preset
    meta["backbone"] = args.backbone
    meta["attn_kernel"] = model_cfg.attn_kernel if args.fused else None
    save_artifact(args.out, program, meta)
    size = os.path.getsize(os.path.join(args.out, "scorer.pt2"))
    print(
        f"exported {size / 1e6:.1f} MB artifact -> {args.out} (device {meta['device']}, "
        f"input {meta['batch_windows'] or 'dyn'}x{meta['frame_num']}x"
        f"{meta['image_size'][0]}x{meta['image_size'][1]}x{meta['channels']} "
        f"{meta['input_dtype']}, ops {meta['ops']})"
    )

    if args.check:
        art = load_artifact(args.out)
        rng = np.random.RandomState(0)
        windows = rng.randint(0, 256, (args.batch_windows or 2, args.frame_num, *image_size, 3),
                              dtype=np.uint8)
        got = art.score(windows).cpu().numpy()
        live = window_score_fn(lambda clips: model(clips).recon, predict,
                               args.first_frame_quirk, input_frames)
        with torch.no_grad():
            want = live(torch.from_numpy(windows).to(device)).cpu().numpy()
        diff = float(np.max(np.abs(got - want)))
        bound = score_bound(want, dtype)
        print(f"reload check: max |artifact - live| = {diff:.3e} (bound {bound:.3e})")
        assert diff <= bound, (diff, bound)


if __name__ == "__main__":
    main()
