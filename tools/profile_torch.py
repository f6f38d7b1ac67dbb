"""Where the time goes in the port's scoring forward on one NVIDIA GPU.

Runs the flagship predict model (bf16, fused kernels, seeded init) on
``--batch`` 4x224^2 clips, the work of one ``evaluate_videos`` batch, under
``torch.profiler`` and prints the device time by kernel name, the share of
the hand-written kernels, and the device's idle share over the traced
window:

    python tools/profile_torch.py [--batch 16] [--steps 5]
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

from vadcl_tpu_torch.core.config import preset
from vadcl_tpu_torch.models import VADModel

# name fragments of the hand-written kernels (csrc/*.cu)
OURS = ("fold_attn", "ln_mlp", "cluster_assign", "space_cluster", "center_sq",
        "sum_partials")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profiling needs a CUDA device")
    cfg = dataclasses.replace(
        preset("shanghaitech").model, predict=True, fused_attention=True,
        fused_cluster=True, attn_kernel="fold",
    )
    model = VADModel(cfg, torch.bfloat16, torch.Generator().manual_seed(0)).cuda().eval()
    clips = torch.rand(args.batch, 4, 224, 224, 3, device="cuda")
    with torch.inference_mode():
        for _ in range(3):
            model(clips)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            model(clips)
        torch.cuda.synchronize()
        untraced = (time.perf_counter() - t0) / args.steps
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(args.steps):
                model(clips)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e3
    busy = sum(by_name.values())
    ours = sum(v for k, v in by_name.items() if any(o in k for o in OURS))
    print(f"batch {args.batch}: forward {untraced * 1e3:.2f} ms untraced "
          f"({args.batch / untraced:.1f} clips/s), {wall / args.steps * 1e3:.2f} ms traced")
    print(f"device busy {busy / args.steps:.2f} ms per forward = "
          f"{100 * busy / (wall * 1e3):.1f}% of the traced wall; idle share "
          f"{100 * (1 - busy / (wall * 1e3)):.1f}%")
    print(f"hand-written kernels: {ours / args.steps:.2f} ms per forward "
          f"({100 * ours / busy:.1f}% of device time)")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:25]:
        print(f"  {ms / args.steps:9.3f} ms  {100 * ms / busy:5.1f}%  {name[:110]}")


if __name__ == "__main__":
    main()
