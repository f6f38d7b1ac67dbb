"""Where the time goes in the port's scoring forward, or in one training
step, on one NVIDIA GPU.

Runs the flagship predict model (bf16, fused kernels, seeded init) on
``--batch`` 4x224^2 clips under ``torch.profiler`` and prints the device
time by kernel name, the share of the hand-written kernels, and the
device's idle share over the traced window.  By default it times the
forward, the work of one ``evaluate_videos`` batch; with ``--train`` one
``make_train_step`` step on uint8 clips (loss, backward, Adam):

    python tools/profile_torch.py [--batch 16] [--steps 5]
    python tools/profile_torch.py --train --batch 4 --attn-kernel base
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch
from torch.profiler import ProfilerActivity, profile

from vadcl_tpu_torch.core.config import ATTN_KERNELS, TRAINABLE_ATTN_KERNELS, preset
from vadcl_tpu_torch.models import VADModel
from vadcl_tpu_torch.train import create_train_state, make_train_step

# name fragments of the hand-written kernels (csrc/*.cu)
OURS = ("fold_attn", "fold_block", "window_attn", "ln_mlp", "cluster_assign", "space_cluster",
        "center_sq", "sum_partials", "atb_partial", "sum_rows")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--train", action="store_true",
                    help="profile training steps (loss, backward, Adam) instead of the forward")
    ap.add_argument("--attn-kernel", default="fold", choices=sorted(ATTN_KERNELS),
                    help="fused attention kernel; with --train one of "
                         f"{sorted(TRAINABLE_ATTN_KERNELS)} (the others are inference only)")
    args = ap.parse_args(argv)
    if args.train and args.attn_kernel not in TRAINABLE_ATTN_KERNELS:
        ap.error(f"--train needs a trainable kernel: {sorted(TRAINABLE_ATTN_KERNELS)}")
    if not torch.cuda.is_available():
        raise RuntimeError("profiling needs a CUDA device")
    cfg = preset("shanghaitech")
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, predict=True, fused_attention=True, fused_cluster=True,
        attn_kernel=args.attn_kernel,
    ))
    model = VADModel(cfg.model, torch.bfloat16, torch.Generator().manual_seed(0)).cuda()
    if args.train:
        state = create_train_state(model, cfg)
        step_fn = make_train_step(model, cfg, steps_per_epoch=1000)
        clips = torch.randint(0, 256, (args.batch, 4, 224, 224, 3), dtype=torch.uint8,
                              device="cuda")
        run, what = (lambda: step_fn(state, clips)), "train step"
    else:
        model.eval()
        clips = torch.rand(args.batch, 4, 224, 224, 3, device="cuda")

        def run():
            with torch.inference_mode():
                model(clips)

        what = "forward"
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        run()
    torch.cuda.synchronize()
    untraced = (time.perf_counter() - t0) / args.steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device events, without the user annotations the profiler also puts on
    # the device timeline (e.g. Optimizer.step#Adam.step spans the kernels)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e3
    busy = sum(by_name.values())
    ours = sum(v for k, v in by_name.items() if any(o in k for o in OURS))
    print(f"attn_kernel {args.attn_kernel}, batch {args.batch}: {what} {untraced * 1e3:.2f} ms untraced "
          f"({args.batch / untraced:.1f} clips/s), {wall / args.steps * 1e3:.2f} ms traced")
    print(f"device busy {busy / args.steps:.2f} ms per {what} = "
          f"{100 * busy / (wall * 1e3):.1f}% of the traced wall; idle share "
          f"{100 * (1 - busy / (wall * 1e3)):.1f}%")
    print(f"hand-written kernels: {ours / args.steps:.2f} ms per {what} "
          f"({100 * ours / busy:.1f}% of device time)")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:30]:
        print(f"  {ms / args.steps:9.3f} ms  {100 * ms / busy:5.1f}%  {name[:110]}")


if __name__ == "__main__":
    main()
