"""Where the time goes in the port's scoring forward, in one training step,
or in its three hot forward kernels alone, on one NVIDIA GPU.

Runs the flagship predict model (bf16, fused kernels, seeded init) on
``--batch`` 4x224^2 clips (``--recon --frame-num F``: the reconstruction
model on Fx224^2 clips) under ``torch.profiler`` and prints the device
time by kernel name, the share of the hand-written kernels, and the
device's idle share over the traced window.  By default it times the
forward, the work of one ``evaluate_videos`` batch; with ``--train`` one
``make_train_step`` step on uint8 clips (loss, backward, Adam), replayed as
the step's captured CUDA graph as ``train()`` runs it (``--no-graph``: the
same step dispatched eagerly):

    python tools/profile_torch.py [--batch 16] [--steps 5]
    python tools/profile_torch.py --train --batch 4 --attn-kernel base [--no-graph]
    python tools/profile_torch.py --recon --frame-num 8 [--train --batch 4]

With ``--kernels-only`` it times fold attention, its packed variant and
LN->MLP at every flagship geometry (``chip_smoke.py``'s table and operands),
bf16, shifted and not, then their backward kernels 6 and 5 and the
whole-block backward at ``--bwd-batch`` clips on both of their bodies
(tensor-core and ``*_tiles``; ``--backward-only``: these alone;
``--forward-only``: the whole-block forward alone, on both of its bodies
beside kernels A then B on the same inputs, at each of ``--batches``), and
prints one JSON object per line: ``ms`` is
``chip_smoke.cuda_ms`` (CUDA events around wrapper calls issued back to back:
the device's time per call unless the host's path to the launch is longer),
``kernel_ms`` the device time of the hand-written kernel alone from the
profiler; last, the host's time per wrapper call on a tiny input:

    python tools/profile_torch.py --kernels-only [--backward-only | --forward-only |
        --window-only]
        [--batches 4 16] [--head-dim 32] [--tag NAME]

(``--head-dim`` runs the attention kernels at the same widths with fewer,
wider heads than the flagship's 16.)  With ``--window-only`` it times
instead the partitioned-window kernels 7, 9 (forward, at each batch) and 8
(backward, at ``--bwd-batch``) at the 4-frame geometries, shifted and not,
on the body the route picks (kernel A's and kernel 6's tensor-core bodies
in bf16) and on their whole-tile bodies forced (``*_tiles``, where the tree
has them); with ``--recon --frame-num F`` the same at the window
geometries of F-frame reconstruction clips (F = 8: windows of 196 and 392
tokens, the row-tiled bodies).  Each launch's device ms is apart
(``launches``: e.g. the qkv product, the attention core and the projection
of the row-tiled forward; the two products, the core, the second pass's
partials and sums and the dx product of the backward).

``--root`` names the tree whose ``vadcl_tpu_torch`` package is run (default:
the tree this file is in), so that two commits can be compared on one card in
one call: unpack the other commit's package into a git-ignored directory
(``git archive <commit> vadcl_tpu_torch | tar -x -C log_dir/parent``) and run
this file once per tree, in turns (parent, change, change, parent).
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# name fragments of the hand-written kernels (csrc/*.cu)
OURS = ("fold_attn", "fold_block", "window_attn", "ln_mlp", "cluster_assign", "space_cluster",
        "center_sq", "sum_partials", "atb_partial", "sum_rows", "rows_attn", "rows_gemm",
        "rows_fwd_gemm", "rows_bwd", "atb_mma")


def device_ms_by_kernel(prof) -> dict:
    """Device milliseconds by kernel name over a profiler's trace, without the
    user annotations the profiler also puts on the device timeline (e.g.
    Optimizer.step#Adam.step spans the kernels)."""
    by_name = {}
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e3
    return by_name


def own_kernel_ms(fn, calls: int = 10) -> float:
    """Device time per call of ``fn``'s hand-written kernels alone: what the
    card spends in them whatever the host does around the launch."""
    fn()
    total = 0.0
    for _ in range(3):  # (a trace now and then comes back empty: read again)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        total = sum(ms for name, ms in device_ms_by_kernel(prof).items() if "vadcl" in name)
        if total > 0:
            break
    return total / calls


def host_us(fn, calls: int = 200) -> float:
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def window_kernels_only(args, smoke, gen, geometries) -> None:
    """Kernels 7 and 9 at each of ``args.batches`` and kernel 8 at
    ``args.bwd_batch``, shifted and not, bf16, at ``geometries`` (name:
    ((D, H, W, C), heads, window, shift)), each with its launches' device ms
    apart; 7, 9 and 8 also on their whole-tile bodies forced (``*_tiles``)
    where the tree has them.  ``body`` names what the route runs
    (``window_body``, and where that is the whole-tile body
    ``window_tile_core``, where the tree has it)."""
    from vadcl_tpu_torch.ops import window_attn as wa

    def body(n, C, nh, backward=False):
        b = wa.window_body(n, C, nh, torch.bfloat16, backward)
        if b == "tile" and hasattr(wa, "window_tile_core"):
            b = wa.window_tile_core(n, C, nh, torch.bfloat16, backward)
        return b

    def line(name, gname, batch, n, shifted, fn, what):
        print(json.dumps({
            "tag": args.tag, "kernel": name, "geometry": gname, "batch": batch, "N": n,
            "shifted": shifted, "body": what, "ms": round(smoke.cuda_ms(fn), 4),
            "kernel_ms": round(own_kernel_ms(fn), 4),
            "launches": [[k, round(ms, 4)] for k, ms in smoke.launch_ms(fn)]}))

    # (a tree without window_attention_packed_tiles runs 9 on its whole-tile body)
    packed_tiles = hasattr(wa, "window_attention_packed_tiles")
    forward = [("window_attention_fused", wa.window_attention_fused, None),
               ("window_attention_packed", wa.window_attention_packed,
                None if packed_tiles else "tile/rows")]
    backward = [("window_attention_fused_bwd", wa.window_attention_fused_bwd, None)]
    if hasattr(wa, "window_attention_fused_tiles"):
        forward.insert(1, ("window_attention_fused_tiles", wa.window_attention_fused_tiles,
                           "tile (forced)"))
        backward.append(("window_attention_fused_bwd_tiles", wa.window_attention_fused_bwd_tiles,
                         "tile (forced)"))
    if packed_tiles:
        forward.append(("window_attention_packed_tiles", wa.window_attention_packed_tiles,
                        "tile (forced)"))
    for gname, ((D, H, W, C), nh, window, shift) in geometries.items():
        n = window[0] * window[1] * window[2]
        for batch in sorted(set(args.batches) | {args.bwd_batch}):
            for shifted in (False, True):
                a = smoke._win_case_at(batch, (D, H, W), C, nh, window,
                                       shift if shifted else (0, 0, 0), torch.bfloat16, gen)
                if batch in args.batches:
                    for name, k, what in forward:
                        line(name, gname, batch, n, shifted, lambda: k(**a),
                             what or body(n, C, nh))
                if batch == args.bwd_batch:
                    w = smoke._win_bwd_case(a, gen)
                    for name, k, what in backward:
                        line(name, gname, batch, n, shifted, lambda: k(**w),
                             what or body(n, C, nh, backward=True))
                    del w
                del a
                torch.cuda.empty_cache()


def backward_kernels_only(args, smoke, gen) -> None:
    """Kernels 6 and 5 and the whole-block backward at the training batch
    (``--bwd-batch``), bf16, at every flagship geometry, each on both of its
    bodies: the tensor-core body the route picks (``fold_attention_bwd``,
    ``ln_mlp_bwd``, ``fold_block_bwd``) and the one it leaves other
    geometries to (``*_tiles``; a tree without ``fold_block_bwd_tiles`` has
    one whole-block body); then kernel 6 at the depth-chunked and long
    layouts' shapes (``chip_smoke.py``'s ``SWIN_B_FOLD_SHAPES`` and
    ``LONG_FOLD_SHAPES``) on the route's head groups and, where the tree has
    them, with one group forced.  ``kernel_ms`` includes the second pass."""
    from vadcl_tpu_torch.ops import fold_attn
    from vadcl_tpu_torch.ops.fold_attn import fold_attention_bwd, fold_attention_bwd_tiles
    from vadcl_tpu_torch.ops.ln_mlp import ln_mlp_bwd, ln_mlp_bwd_tiles

    blocks = [("fold_block_bwd", fold_attn.fold_block_bwd)]
    if hasattr(fold_attn, "fold_block_bwd_tiles"):
        blocks.append(("fold_block_bwd_tiles", fold_attn.fold_block_bwd_tiles))

    bf, batch = torch.bfloat16, args.bwd_batch
    for gname, (dhwc, _, window, shift) in smoke.FOLD_GEOMETRIES.items():
        nh = dhwc[-1] // args.head_dim
        for shifted in (False, True):
            a = smoke._fold_bwd_case((batch, *dhwc), nh, window,
                                     shift if shifted else (0, 0, 0), bf, gen)
            for name, k in (("fold_attention_bwd", fold_attention_bwd),
                            ("fold_attention_bwd_tiles", fold_attention_bwd_tiles)):
                print(json.dumps({
                    "tag": args.tag, "kernel": name, "geometry": gname, "batch": batch,
                    "heads": nh, "shifted": shifted,
                    "ms": round(smoke.cuda_ms(lambda: k(**a)), 4),
                    "kernel_ms": round(own_kernel_ms(lambda: k(**a)), 4)}))
            blk = smoke._block_bwd_case(a, gen)
            for name, k in blocks:
                print(json.dumps({
                    "tag": args.tag, "kernel": name, "geometry": gname, "batch": batch,
                    "heads": nh, "shifted": shifted,
                    "ms": round(smoke.cuda_ms(lambda: k(**blk)), 4),
                    "kernel_ms": round(own_kernel_ms(lambda: k(**blk)), 4)}))
            del blk
        C = dhwc[-1]
        p = smoke._mlp_case(C, 4 * C, gen)[:5]
        x, dy = a["x"], a["dout"]
        for name, k in (("ln_mlp_bwd", ln_mlp_bwd), ("ln_mlp_bwd_tiles", ln_mlp_bwd_tiles)):
            print(json.dumps({
                "tag": args.tag, "kernel": name, "geometry": gname, "batch": batch,
                "tokens": x[..., 0].numel(), "C": C,
                "ms": round(smoke.cuda_ms(lambda: k(x, dy, *p)), 4),
                "kernel_ms": round(own_kernel_ms(lambda: k(x, dy, *p)), 4)}))
        del a, x, dy
        torch.cuda.empty_cache()
    # kernel 6's depth-chunked and long layouts at the shapes chip_smoke.py
    # holds them at (their own batch, shifted): on the route's head groups and,
    # where the tree has head groups, with one group forced
    grouped = hasattr(fold_attn, "fold_bwd_head_groups")
    for label, table in (("(256,196,96)", smoke.LONG_FOLD_SHAPES),
                         ("(64,196,192)", smoke.LONG_FOLD_SHAPES),
                         ("(256,98,128)", smoke.SWIN_B_FOLD_SHAPES),
                         ("(64,98,256)", smoke.SWIN_B_FOLD_SHAPES),
                         ("(64,49,256)", smoke.SWIN_B_FOLD_SHAPES)):
        (D, H, W, C), b, nh, window = table[label]
        a = smoke._fold_bwd_case((b, D, H, W, C), nh, window, (0, 3, 3), bf, gen)
        row = {"tag": args.tag, "kernel": "fold_attention_bwd", "x_windows": label,
               "heads": nh, "shifted": True,
               "head_groups": smoke.head_groups_of(a["x"].shape, nh, window)[0] if grouped else 1,
               "ms": round(smoke.cuda_ms(lambda: fold_attention_bwd(**a)), 4),
               "kernel_ms": round(own_kernel_ms(lambda: fold_attention_bwd(**a)), 4)}
        if grouped:
            with smoke.head_groups_forced_off():
                row["one_group_ms"] = round(smoke.cuda_ms(lambda: fold_attention_bwd(**a)), 4)
                row["one_group_kernel_ms"] = round(
                    own_kernel_ms(lambda: fold_attention_bwd(**a)), 4)
        print(json.dumps(row))
        del a
        torch.cuda.empty_cache()


def block_forward_only(args, smoke, gen) -> None:
    """The whole-block forward at each of ``args.batches``, bf16, at every
    flagship geometry, shifted and not, on both of its bodies: the one the
    route picks (``fold_block``) and PR 4's (``fold_block_tiles``; a tree
    without it runs PR 4's body on ``fold_block``), beside kernels A then B
    (``fold_attention``, ``ln_mlp``) on the same inputs."""
    from vadcl_tpu_torch.ops import fold_attn
    from vadcl_tpu_torch.ops.ln_mlp import ln_mlp

    names = ["fold_block"] + (["fold_block_tiles"] if hasattr(fold_attn, "fold_block_tiles")
                              else [])
    keys = ("ln2_scale", "ln2_bias", "w1", "b1", "w2", "b2")
    for batch in args.batches:
        for gname, (dhwc, _, window, shift) in smoke.FOLD_GEOMETRIES.items():
            nh = dhwc[-1] // args.head_dim
            for shifted in (False, True):
                a = smoke._fold_case((batch, *dhwc), nh, window,
                                     shift if shifted else (0, 0, 0), torch.bfloat16, gen)
                blk = smoke._block_case(a, gen)
                calls = [(name, lambda k=getattr(fold_attn, name): k(**blk)) for name in names]
                calls.append(("fold_attention+ln_mlp", lambda: ln_mlp(
                    fold_attn.fold_attention(**a), *(blk[k] for k in keys))))
                for name, fn in calls:
                    print(json.dumps({
                        "tag": args.tag, "kernel": name, "geometry": gname, "batch": batch,
                        "heads": nh, "shifted": shifted, "ms": round(smoke.cuda_ms(fn), 4),
                        "kernel_ms": round(own_kernel_ms(fn), 4)}))
                del a, blk
                torch.cuda.empty_cache()


def kernels_only(args) -> None:
    from vadcl_tpu_torch.ops import cuda_lib
    from vadcl_tpu_torch.ops.fold_attn import fold_attention, fold_attention_packed
    from vadcl_tpu_torch.ops.ln_mlp import ln_mlp

    # the geometry table, the operands and the timer are chip_smoke.py's
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    t0 = time.perf_counter()
    cuda_lib.library()
    print(json.dumps({"tag": args.tag, "root": args.root, "card": smoke.smi_line(),
                      "build_s": round(time.perf_counter() - t0, 2)}))
    gen = torch.Generator().manual_seed(0)
    if args.recon or args.window_only:
        geometries = (smoke.recon_geometries(args.frame_num) if args.recon
                      else smoke.FOLD_GEOMETRIES)
        with torch.no_grad():
            window_kernels_only(args, smoke, gen, geometries)
        return
    if args.backward_only:
        with torch.no_grad():
            backward_kernels_only(args, smoke, gen)
        return
    if args.forward_only:
        with torch.no_grad():
            block_forward_only(args, smoke, gen)
        return
    bf = torch.bfloat16
    folds = (("fold_attention", fold_attention), ("fold_attention_packed", fold_attention_packed))
    # (no_grad, not inference_mode: tensors made under inference_mode track no
    # version, and the wrappers then pack their operands at every call)
    with torch.no_grad():
        for batch in args.batches:
            for gname, (dhwc, _, window, shift) in smoke.FOLD_GEOMETRIES.items():
                nh = dhwc[-1] // args.head_dim
                for shifted in (False, True):
                    a = smoke._fold_case((batch, *dhwc), nh, window,
                                         shift if shifted else (0, 0, 0), bf, gen)
                    for name, k in folds:
                        print(json.dumps({
                            "tag": args.tag, "kernel": name, "geometry": gname, "batch": batch,
                            "heads": nh, "shifted": shifted, "ms": round(smoke.cuda_ms(lambda: k(**a)), 4),
                            "kernel_ms": round(own_kernel_ms(lambda: k(**a)), 4)}))
                C = dhwc[-1]
                m = smoke._mlp_case(C, 4 * C, gen)
                x = a["x"]
                print(json.dumps({
                    "tag": args.tag, "kernel": "ln_mlp", "geometry": gname, "batch": batch,
                    "tokens": x[..., 0].numel(), "C": C,
                    "ms": round(smoke.cuda_ms(lambda: ln_mlp(x, *m)), 4),
                    "kernel_ms": round(own_kernel_ms(lambda: ln_mlp(x, *m)), 4)}))
        backward_kernels_only(args, smoke, gen)
        # the host's path to one launch, on an input too small to matter
        a = smoke._fold_case((1, 2, 7, 7, 32), 2, (2, 7, 7), (0, 0, 0), bf, gen)
        m = smoke._mlp_case(32, 128, gen)
        print(json.dumps({"tag": args.tag, "host_us_per_call": {
            "fold_attention": round(host_us(lambda: fold_attention(**a)), 1),
            "ln_mlp": round(host_us(lambda: ln_mlp(a["x"], *m)), 1)}}))


def model_profile(args) -> None:
    from vadcl_tpu_torch.core.config import preset
    from vadcl_tpu_torch.models import VADModel
    from vadcl_tpu_torch.train import create_train_state, make_train_step

    cfg = preset("shanghaitech")
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, predict=not args.recon, fused_attention=True, fused_cluster=True,
        attn_kernel=args.attn_kernel,
    ))
    frames = args.frame_num
    model = VADModel(cfg.model, torch.bfloat16, torch.Generator().manual_seed(0)).cuda()
    if args.train:
        state = create_train_state(model, cfg)
        step_fn = make_train_step(model, cfg, steps_per_epoch=1000,
                                  graph=False if args.no_graph else None)
        clips = torch.randint(0, 256, (args.batch, frames, 224, 224, 3), dtype=torch.uint8,
                              device="cuda")
        run, what = (lambda: step_fn(state, clips)), (
            "train step" + (" (eager)" if args.no_graph else " (captured graph)"))
    else:
        model.eval()
        clips = torch.rand(args.batch, frames, 224, 224, 3, device="cuda")

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
    by_name = device_ms_by_kernel(prof)
    busy = sum(by_name.values())
    ours = sum(v for k, v in by_name.items() if any(o in k for o in OURS))
    mode = f"reconstruction, {frames} frames" if args.recon else "predict"
    print(f"attn_kernel {args.attn_kernel}, {mode}, batch {args.batch}: {what} "
          f"{untraced * 1e3:.2f} ms untraced "
          f"({args.batch / untraced:.1f} clips/s), {wall / args.steps * 1e3:.2f} ms traced")
    print(f"device busy {busy / args.steps:.2f} ms per {what} = "
          f"{100 * busy / (wall * 1e3):.1f}% of the traced wall; idle share "
          f"{100 * (1 - busy / (wall * 1e3)):.1f}%")
    print(f"hand-written kernels: {ours / args.steps:.2f} ms per {what} "
          f"({100 * ours / busy:.1f}% of device time)")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:30]:
        print(f"  {ms / args.steps:9.3f} ms  {100 * ms / busy:5.1f}%  {name[:110]}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--train", action="store_true",
                    help="profile training steps (loss, backward, Adam) instead of the forward")
    ap.add_argument("--no-graph", action="store_true",
                    help="with --train: dispatch the step eagerly instead of replaying its "
                         "captured graph")
    ap.add_argument("--attn-kernel", default="fold",
                    help="fused attention kernel (core/config.py:ATTN_KERNELS); with --train "
                         "a trainable one (the others are inference only)")
    ap.add_argument("--kernels-only", action="store_true",
                    help="time fold attention, its packed variant, LN->MLP and the "
                         "backward kernels 6 and 5 alone")
    ap.add_argument("--batches", type=int, nargs="+", default=[4, 16],
                    help="with --kernels-only: the batch sizes")
    ap.add_argument("--head-dim", type=int, default=16,
                    help="with --kernels-only: the attention kernels' head width")
    ap.add_argument("--bwd-batch", type=int, default=4,
                    help="with --kernels-only: the clips of the backward kernels' inputs")
    ap.add_argument("--backward-only", action="store_true",
                    help="with --kernels-only: the backward kernels alone")
    ap.add_argument("--forward-only", action="store_true",
                    help="with --kernels-only: the whole-block forward alone, both bodies")
    ap.add_argument("--window-only", action="store_true",
                    help="with --kernels-only: kernels 7, 9 and 8 alone at the 4-frame "
                         "geometries, each on both bodies")
    ap.add_argument("--tag", default="", help="with --kernels-only: a name on every line")
    ap.add_argument("--root", default=HERE, help="the tree whose vadcl_tpu_torch is run")
    ap.add_argument("--recon", action="store_true",
                    help="the reconstruction model (predict=False) on --frame-num frames")
    ap.add_argument("--frame-num", type=int, default=4,
                    help="frames per clip (predict mode takes 4)")
    args = ap.parse_args(argv)
    if not args.recon and args.frame_num != 4:
        ap.error("predict mode takes 4-frame clips: add --recon for --frame-num")
    args.root = os.path.abspath(args.root)
    sys.path.insert(0, args.root)
    from vadcl_tpu_torch.core.config import ATTN_KERNELS, TRAINABLE_ATTN_KERNELS

    if args.attn_kernel not in ATTN_KERNELS:
        ap.error(f"--attn-kernel is one of {sorted(ATTN_KERNELS)}")
    if args.train and args.attn_kernel not in TRAINABLE_ATTN_KERNELS:
        ap.error(f"--train needs a trainable kernel: {sorted(TRAINABLE_ATTN_KERNELS)}")
    if not torch.cuda.is_available():
        raise RuntimeError("profiling needs a CUDA device")
    (kernels_only if args.kernels_only else model_profile)(args)


if __name__ == "__main__":
    main()
