#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``vadcl_tpu_torch``) on one
NVIDIA GPU.  Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  0. device: CUDA must be available (no CPU fallback); print the card's
     name and power limit as nvidia-smi reports them.
  1. build the fifteen CUDA kernels from ``vadcl_tpu_torch/csrc`` (nvcc, one
     process per source, all started together); the Python mirrors of the
     kernels' shared-memory sizes (the routes' fit predicates and the body
     choice of kernels 7, 8 and 9: whole-tile or row-tiled; the windows a
     block of the bf16 row-tiled forward and backward cores takes; kernel
     B's CUDA-core block and kernel C's instance by width) are held against
     the library's; kernel 10 and the whole-block kernels must fit at the
     four flagship geometries in bf16 and fp32, every window of up to
     392 tokens at the flagship widths, head width 32 and head width 12 must
     map to a body, and every flagship geometry must take the tensor-core
     bodies of 5 and 6 and of the whole-block forward and backward, and, in
     kernels 7, 9 and 8, those of A and 6 (``window_tile_core``), whose blocks
     the library must take wherever the route sends a window, and in the
     ``base`` and ``packed`` blocks unpartitioned (``window_grid_route``).
  2. each forward kernel (A-D, 7: window attention, 9: its packed variant,
     10: the packed fold attention, and the whole-Swin-block kernel)
     against its plain PyTorch version on the card at the flagship shapes,
     at batch 4 (bf16 and fp32) and at the scoring path's batch of 16
     windows (bf16): error against the stated bound and the device time
     of both (kernel 10 beside A, the whole-block kernel beside PR 4's body
     and beside A then B, on the same inputs, two calls for the same bits,
     each body asserted by its counter; then hidden 192, N = 49 on odd
     batches and PR 4's body through its route at head width 48); kernels A
     and 10 in both their modes (LN1 + residual;
     neither) and as the attention branch alone at every geometry, shifted
     and not; an odd batch of 3 and token counts that fill no whole tile of
     kernel B; then edge shapes, a missing qkv bias, and kernels A and 10
     without LN and residual on a window-padded shape.  Kernel C (cluster
     assign) also at N = 1, N off its 64-token block, K = 1, K off its
     32-center chunk, C = 30, the tiny preset's head, a center duplicated
     across chunks and a minimum in the last chunk; two flagship calls give
     the same bits.  Kernel D (space-cluster loss) at BD = 8, 32 and 64 (the
     training, scoring and 8-frame batches), each timed beside its bytes
     bound; two calls, and a call with ``allow_tf32`` flipped, give the same
     bits; then BD = 1, 17 and 130, K = 1, 130 and 1000, HW = 49 and 785,
     maps at a 4-byte offset and a map row equal to a center.  Kernels B and
     C above the flagship's widths: bf16 ``ln_mlp`` at C = 256 / hidden 1024
     and C = 100 / hidden 400 on its CUDA-core body (``ln_mlp_tiles``), fp32
     ``cluster_assign`` at C = 200, 256, 384, 512 and 768 (each wider
     instance), two calls for the same bits, C = 769 refused.
  2/2b, kernels 7, 9 and 8 on A's and 6's bodies: at every 4-frame
     geometry, shifted and not, bf16, the forwards at batch 16 and the
     backward at batch 4 against their plain versions and against their
     whole-tile bodies forced on the same inputs (``*_tiles``), the counter
     of each call's body asserted, two calls for the same bits, the three
     timed.
  2/2b, blocks: bf16 ``base`` and ``packed`` Swin blocks at every 4-frame
     geometry and a window-padded one, shifted and not, at batch 4: the
     unpartitioned route (the fold wrappers on the padded tensor, counted
     on 7, 9 and 8) against the same block forced down the partitioned
     route, forward and ``base``'s gradients, launches and
     ``window_partition`` calls asserted; the attention call that route
     makes inside the block, and under ``base`` its gradients, against
     their plain versions on the inputs it was handed.
  2/2b, head width 12: the bf16 CUDA-core bodies of 7, 9 and 8 against their
     plain versions, whole-tile (N = 98) and row-tiled (N = 196), shifted,
     two calls for the same bits, each timed beside the same body in fp32.
  2b. the backward kernels (5: LN->MLP, 6: fold attention in both its
     modes, 8: window attention, the whole-block backward) against their
     plain versions at the training batch of 4, bf16 and fp32, every
     gradient tensor held separately (its worst err/(tol*max) printed);
     two calls of the tensor-core bodies of 5, 6 and the whole-block
     backward give the same bits; times (5 and 6 beside their old bodies,
     the whole-block backward beside PR 4's body and beside A, 5 and 6 in
     turn); 5 at C = 16 .. 176 and at token counts that fill no whole
     tile, 6 at head width 32; the old bodies through their routes (5 at
     C = 24, 6 at head width 48, the whole-block backward at head width 48
     in bf16 and in fp32); a chunk of windows cut short; workspaces; edge
     shapes.
  2/2b, row-tiled: the row-tiled bodies of 7, 9 and 8 against their plain
     versions at N = 147, 196, 245 and 392, C = 96 / 6 heads, 192 / 12 and
     head width 32, shifted and not, bf16 and fp32, on an odd batch of 3;
     both bodies at the largest N the whole-tile body holds; the bf16
     forward core's edge cases (one mask index or none, a group of windows
     cut short, head widths 32, 48 and 64, N % 4 != 0, the smallest N the
     row-tiled body takes, one strip, no qkv bias), each called twice for the
     same bits; then the frame-8 path's four geometries (forward at batch 16,
     backward at batch 4), timed, each body's launches apart by the
     profiler, shifted and not, two calls for the same bits, and the
     backward's workspace; the bf16 backward core's edge cases (groups cut
     short, no mask, head widths 32-64, the smallest N, one strip, the direct
     layout above N = 512 up to the body before's largest N at each head
     width).
  3. the flagship model (shanghaitech, fused attention and fused cluster
     heads) in fp32 with TF32 off, the card (kernels) against the CPU (plain
     versions) on 224^2 clips: predict mode under ``"base"``, ``"packed"``,
     ``"fold_packed"`` and ``"fold_block"`` at full depth, ``"fold"`` and
     ``"fold_mix"`` at a reduced depth; reconstruction on 8-frame clips under
     ``"fold"`` at full depth and ``"packed"`` at a reduced depth; the fp32
     ``"base"`` and ``"packed"`` models run the whole-tile bodies of 7 and 9
     and partition the windows of each of their 18 blocks.
  3b. the training loss and backward on 1 clip, card against CPU (the loss,
     the set of parameters with a gradient, and every parameter gradient):
     ``"base"`` and ``"fold_block"`` at full depth, ``"fold"`` at a reduced
     depth, ``"fold"`` on a 240^2 clip, whose 60^2 and 30^2 token grids need
     window padding, and ``"fold"`` in reconstruction on 8-frame clips at
     224^2 and 240^2 (reduced depth).
  3c. a fused tiny model at ``embed_dim`` 128 (C = 128 and 256, head width
     32): forward, loss and every gradient, card against CPU in fp32 and
     bf16; kernel B's and kernel 5's CUDA-core bodies and kernel C's
     two-part instance must launch.
  3d. a fused tiny model at ``embed_dim`` 24 (head width 12, C = 24 and 48)
     in bf16, card against CPU: forward, loss and every gradient under
     ``"fold"``, ``"fold_block"`` and ``"base"``, the forward under
     ``"packed"``, and in reconstruction on 8-frame clips under ``"base"``
     and ``"packed"``: no fold kernel launches, the partitioned-window
     kernels 4 times each way.
  4. the scoring path in bf16: in-memory uint8 videos through
     ``evaluate_videos`` (PSNR -> anomaly score -> per-scene AUC) with
     batch_windows=16, once per ``attn_kernel`` in fold, base, packed,
     fold_packed, fold_mix, fold_block in predict mode, and under fold, base
     and packed in reconstruction mode at frame_num 8 at full width and
     depth; the kernels each path must run have launched (the newer paths:
     exactly so many times, 18 row-tiled forwards a forward at frame_num 8)
     and the others have not, no plain version of an attention or MLP
     kernel was handed a CUDA tensor, and ``window_partition`` ran no time
     at 4 frames (the bf16 ``base`` and ``packed`` blocks hand kernels A and
     6 the unpartitioned tensor) and 18 times a forward at frame_num 8.
  5. the training path in bf16: ``train()`` on the flagship config from a
     seeded init with an in-memory uint8 loader at batch 4, 2 warm-up and
     8 timed steps, under ``"fold"``, ``"base"`` and ``"fold_block"`` in
     predict mode and ``"fold"`` and ``"base"`` in reconstruction at
     frame_num 8 (18 row-tiled launches each way a step), with the same
     launch and plain-version checks; a checkpoint round trip into a fresh
     model and optimizer; a ``"packed"``, ``"fold_packed"`` or
     ``"fold_mix"`` train step is refused before any launch.
  6. data parallelism: the flagship ``fold`` train step under
     ``DistributedDataParallel`` on an in-process NCCL group of world size
     1, 3 steps at batch 4, against the one-process step from the same
     weights on the same batches (and the one-process step repeated, the
     card's own run-to-run spread): the loss sums all-reduced and the
     gradients summed every step, the training kernels launched every step,
     the losses and parameters within the bounds of ``DDP_STEPS``' comment;
     its step time beside the FLOP count of a training step
     (``FlopCounterMode`` on the plain model) and the bf16 peak.  Then,
     in the same group of one, 2 ``convae`` steps at batch 4 (full width,
     bf16) against one process: the bank's maxima all-reduced over NCCL
     (``global_max``) and its buffer rebound under DDP every step, the
     losses and parameters within the same bounds and the bank within the
     bf16 bank bound (``utils/parity.py``'s ``check_bank``).
  7. the attention-kernel autotune (``measure_attn_kernels``): base, packed,
     fold and fold_packed through a Swin block's attention half at batch 32,
     kernels 7, 9, A and 10 and nothing else launched; both picks.
  8. ``train(profile_steps=1)``: the trace of step 3 holds host ops and
     the hand-written kernels.
  9. the alternate families at full width (the shanghaitech preset, 224^2,
     frame_num 4: UNet3D at channels 64-1024, ConvAE and ConvAEPredict at
     64-512 with a bank of 10 x 512), none of whose paths launches a
     hand-written kernel (asserted): two ``make_train_step`` steps at batch
     2 in fp32 with TF32 off, card against CPU from the same state each
     step (every loss term, every parameter within the Adam bound, the
     memory bank against the CPU's update and against the plain update of
     the card's own inputs, a query sent to another slot only at a near
     tie: ``utils/parity.py``); ``train()`` in bf16 at batch 4, 5 steps,
     step 2 traced (host-clock ms a step, device-busy ms, and the step's
     FLOP count, ``FlopCounterMode`` on meta tensors, over each: the rate
     and its share of the bf16 peak; unit-norm bank rows, a checkpoint
     round trip with the bank); ``evaluate_videos`` of two videos twice
     with the model left in train mode (the bank bit for bit unmoved, the
     two scorings equal, windows/s).
  10. the serving export at full width (shanghaitech, 224^2, 4-frame
     predict, bf16): ``export_window_scorer`` of the flagship scorer under
     ``"fold"`` and ``"base"`` at batch 16, saved, then loaded and called in
     a second process that must not import ``vadcl_tpu_torch.models``: the
     graph's kernel ops, one call's launches (18 of A or of 7, 18 of B, 1
     of C, 1 of D, nothing else), the scores against the live scorer's
     within the bf16 score bound (``utils/parity.py``), two calls the same
     bits; windows/s of artifact and live, device-busy ms and host ops of a
     traced call of each.
  11. the train-step leftovers at full width: ``train()`` 2 steps at batch 4
     in bf16 under ``"fold"`` and ``"base"`` with ``drop_rate`` 0.1 and
     ``drop_path_rate`` 0.2: exactly A and 6 (or 7 and 8) in every block
     each way, C and D, no kernel B or 5 and no whole-block kernel; the
     fused step against the plain-attention model with the same masks in
     fp32 (loss and every gradient, phase 3b's bounds); host-clock ms,
     device-busy ms and host ops of the dropout step beside the rate-0
     step's, and the time of one mask draw; ``remat`` on against off in
     bf16 with masks drawn (each gradient within the bf16 bound, and the
     run without remat repeated for the card's own spread); one LARS step
     on the card's gradients against the float64 plain update.
  12. tensor parallelism by turns at full width (224^2, 4-frame predict,
     bf16, batch 4) under ``"fold"`` and ``"fold_block"`` at model sizes 2
     and 4 (``parallel/tp.py:model_parallel_by_turns``): each virtual rank's
     window rows through the real kernels in turn (the roll, the row and
     mask-slice splits a model group uses), the outputs gathered, the
     ranks' gradients summed by autograd; the forward the unsplit model's
     bits, the loss and every gradient within the bf16 bound, exactly 18
     launches a rank of each kernel each way; each rank's launches and
     CUDA-event ms inside its turns.
  13. tensor parallelism across cards where two or more are visible:
     ``tools/ddp_check_torch.py --model-parallel 2`` as 2 NCCL processes,
     and dp2 x tp2 on 4 cards, against one process; on one card it says it
     did not run.
  14. the C++ JPEG decoder (``data/native.py``): whether ``g++`` and
     ``jpeglib.h`` are here; where they are, the port's build and decode
     must succeed, its largest difference from PIL and both decoders'
     frames/s are printed; where not, the port reads frames with PIL.
  15. a reference ``.pth`` at the flagship (a seeded model's weights under
     the reference's names and layouts): ``tools/evaluate_torch.py
     --torch-ckpt`` scores two JPEG videos with the bits of ``--ckpt`` of
     the same weights, 18 A, 18 B, 1 C, 1 D a forward and nothing else;
     ``tools/export_torch.py --torch-ckpt`` and ``--ckpt`` give artifacts
     that score the same bits and launch the same kernels.
  16. ``tools/train_synthetic_torch.py --fused`` a few steps on the card in
     a process of its own: exit 0 and a per-scene AUC.
No earlier path was cut: the whole run takes about six minutes on an H100.
The second-to-last line is a JSON object describing each of the fifteen
kernels, kernel B's CUDA-core body, the whole-block forward's and
backward's bodies of PR 4, and the bf16 CUDA-core instances of 7, 8 and 9
(counted on their fp32 bodies' counters, reported from the embed_dim 24
model's runs) (its time beside its roofline bound on
an H100's published peaks: every number in it but the bound is measured in
this run); since kernels 7, 9 and 8 run on A's and 6's bodies, their
entries name those sources and three more entries report their whole-tile
bodies (launched by the fp32 ``base`` and ``packed`` models, phases 3 and
3b);
the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from vadcl_tpu_torch.utils.provenance import smi_line

FOLD_GEOMETRIES = {  # name: ((D, H, W, C) per clip, heads, runtime window, shift)
    "enc_stage0": ((2, 56, 56, 96), 6, (2, 7, 7), (0, 3, 3)),
    "enc_stage1": ((2, 28, 28, 192), 12, (2, 7, 7), (0, 3, 3)),
    "dec_stage0": ((1, 28, 28, 192), 12, (1, 7, 7), (0, 3, 3)),
    "dec_stage1": ((1, 56, 56, 96), 6, (1, 7, 7), (0, 3, 3)),
}
MLP_SHAPES = {96: (2, 56, 56), 192: (2, 28, 28)}  # C: (D, H, W) per clip
PADDED_FOLD = ((2, 63, 63, 96), 6, (2, 7, 7), (0, 3, 3))  # a 240^2 clip's stage 0, padded
# Published peaks of one H100 SXM (dense), the yardstick of every bound_ms:
# device memory rate, bf16 and tf32 tensor-core rates, fp32 rate outside the
# tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12}
BATCH_WINDOWS = 16  # phase 4's batch: the shapes the main path gives each kernel
# |kernel - plain| <= ATOL + RTOL * |plain|, elementwise.  fp32: only the
# summation order differs (~1e-6 at O(1) outputs).  bf16: both round at the
# same cast boundaries, but a different fp32 summation order can flip one
# rounding of an intermediate (one bf16 ulp is 2^-8 relative), which the
# following products carry into O(1) outputs.  Fold attention is also held
# to these bounds without the residual (the attention branch alone, O(1)),
# with its rel-pos bias drawn at unit scale, so that a kernel that drops,
# transposes or misplaces the bias, the mask or the softmax fails.
BOUNDS = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 2e-2)}
MODEL_TOL = 1e-4  # phase 3 recon atol and rtol, fp32: summation order only
CLUSTER_RTOL = 1e-4  # recon and loss: 3xTF32 products (~2^-21) and another sum order
LABEL_GAP = 1e-3  # labels must agree where best and second-best differ by more
DEV = "cuda"  # where the phases put their tensors


def cuda_ms(fn, reps: int = 4, batch: int = 5, warmup: int = 3) -> float:
    """Time of one call on the device, in milliseconds: the median over
    ``reps`` of a CUDA-event pair around ``batch`` calls issued back to back,
    divided by ``batch``.  The calls queue up behind each other, so what is
    read is the device's time per call and not the host's path to the
    launch (unless the host is the slower of the two)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return float(np.median(times))


def launch_ms(fn, calls: int = 10) -> list:
    """Device ms per call of each hand-written kernel ``fn`` launches, in
    launch order, by the profiler: ``[[name, ms], ...]`` (the row-tiled
    forward's qkv product, attention core and projection apart, though both
    products share one kernel's name); empty if the trace has none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    for _ in range(3):  # (a trace now and then comes back empty: read again)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        ours = sorted((e for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA and "vadcl" in e.name),
                      key=lambda e: e.time_range.start)
        if ours and len(ours) % calls == 0:
            per = len(ours) // calls
            return [[ours[i].name.replace("(anonymous namespace)::", "").split("(")[0]
                     .replace("void ", ""),
                     sum(e.device_time_total for e in ours[i::per]) / calls / 1e3]
                    for i in range(per)]
    return []


def bound(tensors, flops: float, peak: str, fp32_flops: float = 0.0) -> dict:
    """The least time the card could take for one call: the largest of the
    bytes of ``tensors`` (every input and output once) over the memory rate,
    ``flops`` over the peak rate of ``peak`` ("bf16", "tf32" or "fp32"), and,
    where a bf16 kernel also has products its contract keeps in fp32,
    ``fp32_flops`` over the fp32 rate (the tensor cores and the fp32 units can
    work at the same time, so the two do not add)."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors if t is not None)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(flops / PEAK_FLOPS[peak], fp32_flops / PEAK_FLOPS["fp32"]) * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations", library_ms=None)


def attn_flops(tokens: int, c: int, n: int, backward: bool = False,
               through_proj: bool = False) -> float:
    """Window attention per token: qkv 6C^2, q.k and p.v 2NC each, proj 2C^2;
    the backward recomputes qkv, q.k and p.v and adds dproj_w, dout.proj^T,
    dv, dp, dq, dk (2NC each), dqkv_w and dx (6C^2 each).  The whole-block
    backward needs the forward ``through_proj`` (to y1, which the tail
    reads): once, however often a kernel's design recomputes it."""
    if not backward:
        return tokens * (8 * c * c + 4 * n * c)
    return tokens * ((24 if through_proj else 22) * c * c + 12 * n * c)


def tensors_of(*groups):
    out = []
    for g in groups:
        for t in (g.values() if isinstance(g, dict) else g):
            if isinstance(t, torch.Tensor):
                out.append(t)
    return out


def check_close(name, got, want, atol, rtol):
    err = (got.float() - want.float()).abs()
    bound = atol + rtol * want.float().abs()
    worst = float((err / bound).max())
    max_abs = float(err.max())
    print(f"  {name}: max_abs_err={max_abs:.3e} worst err/bound={worst:.3f} "
          f"(atol {atol:g}, rtol {rtol:g})")
    if not worst <= 1.0:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return max_abs


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: this smoke test needs an NVIDIA GPU")
    line = smi_line()
    print(f"[0] device: {torch.cuda.get_device_name(0)} | nvidia-smi: {line}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return line


def phase_build():
    from vadcl_tpu_torch.ops import cuda_lib

    t0 = time.perf_counter()
    lib = cuda_lib.library()
    built = cuda_lib.build_seconds
    print(f"[1] kernels ready in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {'%.2f s' % built if built is not None else 'cached'})")
    from vadcl_tpu_torch.ops.fold_attn import fold_smem_bytes

    for n, c, nh in ((98, 96, 6), (98, 192, 12), (49, 192, 12), (49, 96, 6), (98, 32, 2),
                     (98, 24, 2), (392, 96, 6), (98, 96, 3), (98, 192, 6), (49, 64, 2)):
        for bf16 in (0, 1):
            if bf16 and c % 16:
                continue
            mine = (fold_smem_bytes(n, c, nh, bool(bf16)),
                    fold_smem_bytes(n, c, nh, bool(bf16), backward=True))
            theirs = (lib.vadcl_fold_attn_smem_bytes(n, c, nh, bf16),
                      lib.vadcl_fold_attn_bwd_smem_bytes(n, c, nh, bf16))
            if mine != theirs:
                raise AssertionError(f"fold_smem_bytes{(n, c, nh, bf16)} = {mine} but the "
                                     f"library says {theirs}")
    print("  fold_smem_bytes (the route's predicate) agrees with the library's layouts")
    from vadcl_tpu_torch.ops.fold_attn import fold_bwd_body, fold_bwd_mma_smem_bytes
    from vadcl_tpu_torch.ops.ln_mlp import mlp_bwd_body, mlp_bwd_mma_smem_bytes

    for n, c, nh in ((98, 96, 6), (98, 192, 12), (49, 192, 12), (49, 96, 6), (98, 32, 2),
                     (98, 64, 4), (49, 32, 2), (98, 96, 3), (98, 192, 6), (49, 192, 6),
                     (112, 96, 6), (65, 96, 6), (16, 32, 2), (49, 256, 16)):
        mine, theirs = fold_bwd_mma_smem_bytes(n, c, nh), lib.vadcl_fold_attn_bwd_bf16_smem_bytes(n, c, nh)
        if mine != theirs:
            raise AssertionError(f"fold_bwd_mma_smem_bytes{(n, c, nh)} = {mine} but the library "
                                 f"says {theirs}")
    for c in range(16, 193, 16):
        if mlp_bwd_mma_smem_bytes(c) != lib.vadcl_ln_mlp_bwd_bf16_smem_bytes(c):
            raise AssertionError(f"mlp_bwd_mma_smem_bytes({c}) disagrees with the library")
    for gname, ((_, _, _, c), nh, window, _) in FOLD_GEOMETRIES.items():
        n = window[0] * window[1] * window[2]
        if (fold_bwd_body(n, c, nh, torch.bfloat16) != "mma"
                or mlp_bwd_body(c, 4 * c, torch.bfloat16) != "mma"):
            raise AssertionError(f"{gname}: kernels 5 and 6 must run their tensor-core bodies")
    print("  the tensor-core bodies of kernels 5 and 6: their layout mirrors agree with the "
          "library, and every flagship geometry takes them in bf16")
    from vadcl_tpu_torch.ops.cluster_kernels import cluster_assign_shape
    from vadcl_tpu_torch.ops.ln_mlp import mlp_fwd_smem_bytes

    for c in range(1, 801):
        if mlp_fwd_smem_bytes(c) != lib.vadcl_ln_mlp_smem_bytes(c):
            raise AssertionError(f"mlp_fwd_smem_bytes({c}) disagrees with the library")
        packed = lib.vadcl_cluster_assign_shape(c)
        try:
            nt, parts, chunk, stages = cluster_assign_shape(c)
            mine = nt | parts << 8 | chunk << 12 | stages << 20
        except ValueError:
            mine = 0
        if mine != packed:
            raise AssertionError(f"cluster_assign_shape({c}) disagrees with the library")
    print("  kernel B's CUDA-core block and kernel C's instance by width (C = 1 .. 800) agree "
          "with the library")
    from vadcl_tpu_torch.ops.fold_attn import (
        fold_block_fits, fold_block_fwd_body, fold_block_fwd_mma_smem_bytes,
        fold_block_smem_bytes, fold_packed_fits,
    )

    for n, c, nh in ((98, 96, 6), (98, 192, 12), (49, 192, 12), (49, 96, 6), (98, 32, 2),
                     (98, 24, 2), (16, 32, 2), (392, 96, 6)):
        for bf16 in (0, 1):
            if bf16 and c % 16:
                continue
            # (kernel 10 has kernel A's layout, held above)
            mine = (fold_block_smem_bytes(n, c, nh, bool(bf16)),
                    fold_block_smem_bytes(n, c, nh, bool(bf16), backward=True))
            theirs = (lib.vadcl_fold_block_smem_bytes(n, c, nh, bf16),
                      lib.vadcl_fold_block_bwd_smem_bytes(n, c, nh, bf16))
            if mine != theirs:
                raise AssertionError(f"whole-block shared memory {(n, c, nh, bf16)} = "
                                     f"{mine} but the library says {theirs}")
    for gname, ((_, _, _, c), nh, window, _) in FOLD_GEOMETRIES.items():
        n = window[0] * window[1] * window[2]
        for dtype in (torch.bfloat16, torch.float32):
            if not (fold_packed_fits(n, c, nh, dtype)
                    and fold_block_fits(n, c, nh, 4 * c, dtype)):
                raise AssertionError(f"{gname} {dtype}: kernel 10 or the whole-block kernels "
                                     "do not fit 227 KB of shared memory")
        if fold_block_fwd_body(n, c, nh, 4 * c, torch.bfloat16) != "mma":
            raise AssertionError(f"{gname}: the whole-block forward must run its tensor-core "
                                 "body in bf16")
    for n, c, nh in ((98, 96, 6), (98, 192, 12), (49, 192, 12), (49, 96, 6), (98, 32, 2),
                     (98, 64, 4), (49, 32, 2), (98, 96, 3), (98, 192, 6), (49, 192, 6),
                     (112, 96, 6), (65, 96, 6), (16, 32, 2), (49, 128, 4), (98, 48, 3)):
        mine = fold_block_fwd_mma_smem_bytes(n, c, nh)
        theirs = lib.vadcl_fold_block_bf16_smem_bytes(n, c, nh)
        if mine != theirs:
            raise AssertionError(f"fold_block_fwd_mma_smem_bytes{(n, c, nh)} = {mine} but the "
                                 f"library says {theirs}")
    print("  fold_packed_fits / fold_block_fits agree with the library and hold at the four "
          "flagship geometries, bf16 and fp32; the whole-block forward's tensor-core body: "
          "its layout mirror agrees with the library, and every flagship geometry takes it "
          "in bf16")
    from vadcl_tpu_torch.ops.fold_attn import fold_block_bwd_body, fold_block_bwd_mma_smem_bytes

    for n, c, nh in ((98, 96, 6), (98, 192, 12), (49, 192, 12), (49, 96, 6), (98, 32, 2),
                     (98, 64, 4), (49, 32, 2), (98, 96, 3), (98, 192, 6), (49, 192, 6),
                     (112, 96, 6), (65, 96, 6), (16, 32, 2), (49, 128, 4)):
        mine = fold_block_bwd_mma_smem_bytes(n, c, nh)
        theirs = lib.vadcl_fold_block_bwd_bf16_smem_bytes(n, c, nh)
        if mine != theirs:
            raise AssertionError(f"fold_block_bwd_mma_smem_bytes{(n, c, nh)} = {mine} but the "
                                 f"library says {theirs}")
    for gname, ((_, _, _, c), nh, window, _) in FOLD_GEOMETRIES.items():
        n = window[0] * window[1] * window[2]
        if fold_block_bwd_body(n, c, nh, 4 * c, torch.bfloat16) != "mma":
            raise AssertionError(f"{gname}: the whole-block backward must run its tensor-core "
                                 "body in bf16")
    print("  the whole-block backward's tensor-core body: its layout mirror agrees with the "
          "library, and every flagship geometry takes it in bf16")
    from vadcl_tpu_torch.ops.window_attn import rows_smem_bytes, tile_smem_bytes, window_body

    checked = 0
    for c, nh in ((96, 6), (192, 12), (96, 3), (192, 6), (32, 2), (64, 4), (24, 2), (64, 1),
                  (48, 4), (72, 6), (80, 1)):
        for n in (1, 16, 49, 98, 112, 113, 147, 196, 245, 343, 392):
            for bf16 in (0, 1):
                mine = (tile_smem_bytes(n, c, nh, bool(bf16)),
                        tile_smem_bytes(n, c, nh, bool(bf16), backward=True),
                        rows_smem_bytes(n, c, nh, bool(bf16)),
                        rows_smem_bytes(n, c, nh, bool(bf16), backward=True))
                theirs = (lib.vadcl_window_attn_smem_bytes(n, c, nh, bf16),
                          lib.vadcl_window_attn_bwd_smem_bytes(n, c, nh, bf16),
                          lib.vadcl_window_attn_rows_smem_bytes(n, c, nh, bf16),
                          lib.vadcl_window_attn_bwd_rows_smem_bytes(n, c, nh, bf16))
                if mine != theirs:
                    raise AssertionError(f"window attention shared memory {(n, c, nh, bf16)}: "
                                         f"{mine} but the library says {theirs}")
                checked += 1
    from vadcl_tpu_torch.ops.window_attn import rows_group

    groups = 0
    for c, nh in ((96, 6), (192, 12), (96, 3), (64, 2), (128, 2), (96, 2), (64, 1)):
        for n in (1, 16, 98, 113, 147, 196, 245, 343, 392, 432, 433, 800, 801, 848, 849, 1440,
                  2416, 2417):
            for per_class in (1, 2, 3, 5, 8, 16, 64):
                mine = rows_group(n, c, nh, per_class)
                theirs = lib.vadcl_window_attn_rows_group(n, c, nh, per_class)
                if mine != theirs:
                    raise AssertionError(f"rows_group{(n, c, nh, per_class)} = {mine} but the "
                                         f"library says {theirs}")
                if (rows_smem_bytes(n, c, nh, True, group=mine)
                        != lib.vadcl_window_attn_rows_group_smem_bytes(n, c, nh, mine)):
                    raise AssertionError(f"rows_smem_bytes{(n, c, nh)} at group {mine} disagrees "
                                         "with the library")
                groups += 1
    from vadcl_tpu_torch.ops.window_attn import rows_bwd_group

    for c, nh in ((96, 6), (192, 12), (96, 3), (64, 2), (128, 2), (96, 2), (64, 1)):
        for n in (1, 16, 98, 113, 147, 196, 245, 343, 392, 432, 433, 512, 513, 640, 1072):
            for per_class in (1, 2, 3, 4, 5, 8, 16, 64, 256):
                mine = rows_bwd_group(n, c, nh, per_class)
                theirs = lib.vadcl_window_attn_bwd_rows_group(n, c, nh, per_class)
                if mine != theirs:
                    raise AssertionError(f"rows_bwd_group{(n, c, nh, per_class)} = {mine} but "
                                         f"the library says {theirs}")
                if (rows_smem_bytes(n, c, nh, True, backward=True, group=mine)
                        != lib.vadcl_window_attn_bwd_rows_group_smem_bytes(n, c, nh, mine)):
                    raise AssertionError(f"rows_smem_bytes{(n, c, nh)}, backward, at group "
                                         f"{mine} disagrees with the library")
                groups += 1
    for c, nh in ROW_WIDTHS:
        for n in range(1, 393):
            for dtype in (torch.bfloat16, torch.float32):
                for backward in (False, True):
                    window_body(n, c, nh, dtype, backward)  # raises where no body fits
    print(f"  tile_smem_bytes / rows_smem_bytes (the body choice of kernels 7, 8, 9) agree "
          f"with the library at {checked} cases; every N up to 392 at C=96/6, 192/12 and head "
          "width 32 maps to a body, both dtypes and directions; the bf16 row-tiled cores' "
          f"groups of windows (0: the direct layout) and their layouts, forward and backward, "
          f"agree with the library at {groups} cases")
    from vadcl_tpu_torch.ops.fold_attn import SMEM_LIMIT
    from vadcl_tpu_torch.ops.window_attn import window_grid_route, window_tile_core

    for gname, ((_, _, _, c), nh, window, _) in FOLD_GEOMETRIES.items():
        n = window[0] * window[1] * window[2]
        for backward in (False, True):
            if (window_body(n, c, nh, torch.bfloat16, backward) != "tile"
                    or window_tile_core(n, c, nh, torch.bfloat16, backward) != "fold_mma"):
                raise AssertionError(f"{gname}: bf16 kernels 7, 9 and 8 must run on the "
                                     "tensor-core bodies of kernels A and 6")
        if not all(window_grid_route(n, c, nh, torch.bfloat16, p) for p in (False, True)):
            raise AssertionError(f"{gname}: bf16 base and packed blocks must hand kernels A "
                                 "and 6 the unpartitioned tensor")
    folds = 0
    for c, nh in ROW_WIDTHS + ((32, 2), (64, 4), (96, 2), (256, 8), (256, 16), (128, 4)):
        for n in range(1, 150):
            for backward in (False, True):
                # the route: the whole-tile body's windows, where A's or 6's body takes them
                if (window_body(n, c, nh, torch.bfloat16, backward) != "tile"
                        or window_tile_core(n, c, nh, torch.bfloat16, backward) != "fold_mma"):
                    continue
                folds += 1
                smem = (lib.vadcl_fold_attn_bwd_bf16_smem_bytes(n, c, nh) if backward
                        else lib.vadcl_fold_attn_smem_bytes(n, c, nh, 1))
                if smem > SMEM_LIMIT:
                    raise AssertionError(f"window_tile_core{(n, c, nh, backward)} sends a "
                                         "window to a body whose block the library refuses")
    print(f"  the whole-tile route of kernels 7, 9 and 8 (window_tile_core): every flagship "
          f"geometry takes kernels A's and 6's tensor-core bodies in bf16, unpartitioned in "
          f"base and packed blocks (window_grid_route); at the {folds} geometries it sends "
          "there the library's blocks fit")


def _fold_case(shape, nh, window, shift, dtype, gen):
    from vadcl_tpu_torch.ops.window import compute_attn_mask

    B, D, H, W, C = shape
    n = window[0] * window[1] * window[2]
    dev = DEV
    r = lambda *s: torch.randn(*s, generator=gen).to(dev)
    mask = compute_attn_mask(D, H, W, window, shift)
    return dict(
        x=r(*shape).to(dtype), ln_scale=1 + 0.1 * r(C), ln_bias=0.1 * r(C),
        qkv_w=r(C, 3 * C) / C**0.5, qkv_b=0.1 * r(3 * C),
        proj_w=r(C, C) / C**0.5, proj_b=0.1 * r(C), bias=r(nh, n, n),
        mask=None if mask is None else torch.from_numpy(mask).to(dev),
        num_heads=nh, window=window, scale=(C // nh) ** -0.5, shift=shift,
    )


def fold_kernels():
    """(name, kernel, plain version) of kernel A and of kernel 10."""
    from vadcl_tpu_torch.ops.fold_attn import (
        fold_attention, fold_attention_packed, fold_attention_packed_plain,
        fold_attention_plain,
    )

    return (("fold_attention", fold_attention, fold_attention_plain),
            ("fold_attention_packed", fold_attention_packed, fold_attention_packed_plain))


def check_fold(name, a, kernel=None, plain=None) -> float:
    """Kernel A (or ``kernel``: kernel 10) against its plain version on case
    ``a``: the block output (LN1 and residual), the attention branch alone
    (no residual) and the mode with neither LN1 nor residual; returns the
    largest max abs error."""
    if kernel is None:
        _, kernel, plain = fold_kernels()[0]
    bounds = BOUNDS[a["x"].dtype]
    e = check_close(name, kernel(**a), plain(**a), *bounds)
    b = dict(a, residual=False)
    e = max(e, check_close(f"{name} branch", kernel(**b), plain(**b), *bounds))
    c = dict(a, ln_scale=None, ln_bias=None, residual=False)  # the padded blocks' mode
    return max(e, check_close(f"{name} no LN/residual", kernel(**c), plain(**c), *bounds))


def _block_case(a, gen, hidden=None):
    """Kernel A's case ``a`` plus the MLP tail's operands (hidden 4C unless
    given): the arguments of the whole-block kernel and its plain version."""
    C = a["x"].shape[-1]
    ln2_s, ln2_b, w1, b1, w2, b2 = _mlp_case(C, hidden or 4 * C, gen)
    b = {k: v for k, v in a.items() if k not in ("num_heads", "window", "scale", "shift")}
    b.update(ln2_scale=ln2_s, ln2_bias=ln2_b, w1=w1, b1=b1, w2=w2, b2=b2)
    b.update({k: a[k] for k in ("num_heads", "window", "scale", "shift")})
    return b


def check_block_route(name, blk, body):
    """The whole-block forward on ``blk``, and the body (``"mma"``: the
    tensor-core body; ``"tiles"``: PR 4's) that launched."""
    from vadcl_tpu_torch.ops.fold_attn import fold_block, fold_block_tiles

    before = (fold_block.launches, fold_block_tiles.launches)
    got = fold_block(**blk)
    want = (before[0] + 1, before[1]) if body == "mma" else (before[0], before[1] + 1)
    if (fold_block.launches, fold_block_tiles.launches) != want:
        raise AssertionError(f"{name}: did not take the {body} body")
    return got


def mlp_flops(tokens: int, c: int, backward: bool = False) -> float:
    """LN->MLP per token at hidden 4C: fc1 and fc2 8C^2 each; the backward
    recomputes fc1 and adds dw2, dy.w2^T, dw1 and dz.w1^T (8C^2 each)."""
    return tokens * (40.0 if backward else 16.0) * c * c


def _win_case(batch, gname, shifted, dtype, gen, qkv_bias=True):
    """Arguments of kernels 7 and 9 at a flagship geometry: the partitioned
    windows (batch * nW, N, C) of ``batch`` clips, rel-pos bias at unit
    scale, the shift mask when ``shifted``."""
    (D, H, W, C), nh, window, shift = FOLD_GEOMETRIES[gname]
    return _win_case_at(batch, (D, H, W), C, nh, window, shift if shifted else (0, 0, 0),
                        dtype, gen, qkv_bias)


def _win_case_at(batch, dhw, C, nh, window, shift, dtype, gen, qkv_bias=True):
    from vadcl_tpu_torch.ops.window import compute_attn_mask

    D, H, W = dhw
    n = window[0] * window[1] * window[2]
    nw = (D // window[0]) * (H // window[1]) * (W // window[2])
    r = lambda *s: torch.randn(*s, generator=gen).to(DEV)
    mask = compute_attn_mask(D, H, W, window, shift)
    return dict(
        x_windows=r(batch * nw, n, C).to(dtype), qkv_w=r(C, 3 * C) / C**0.5,
        qkv_b=0.1 * r(3 * C) if qkv_bias else None, proj_w=r(C, C) / C**0.5,
        proj_b=0.1 * r(C), bias=r(nh, n, n),
        mask=None if mask is None else torch.from_numpy(mask).to(DEV),
        num_heads=nh, n_windows=nw, scale=(C // nh) ** -0.5,
    )


def window_kernels():
    from vadcl_tpu_torch.ops.window_attn import (
        window_attention_fused, window_attention_fused_plain, window_attention_packed,
        window_attention_packed_plain,
    )

    return (("window_attention_fused", window_attention_fused, window_attention_fused_plain),
            ("window_attention_packed", window_attention_packed, window_attention_packed_plain))


def time_pair(kernel, plain) -> tuple:
    ms, pms = cuda_ms(kernel), cuda_ms(plain)
    print(f"    time: kernel {ms:.4f} ms, plain {pms:.4f} ms")
    return ms, pms


def _mlp_case(C, hidden, gen):
    r = lambda *s: torch.randn(*s, generator=gen).to(DEV)
    return (1 + 0.1 * r(C), 0.1 * r(C), r(C, hidden) / C**0.5, 0.1 * r(hidden),
            r(hidden, C) / hidden**0.5, 0.1 * r(C))


def phase_kernels():
    """Each kernel against its plain version: a batch-4 sweep in bf16 and
    fp32, then the main path's own shapes (batch 16, bf16), whose numbers go
    into the kernels line.  Returns {kernel: stats at batch 16}."""
    from vadcl_tpu_torch.ops.cluster import cdist
    from vadcl_tpu_torch.ops.cluster_kernels import cluster_assign, cluster_assign_plain
    from vadcl_tpu_torch.ops.fold_attn import (
        fold_attention, fold_attention_packed, fold_attention_packed_plain,
        fold_attention_plain, fold_block, fold_block_plain, fold_block_tiles,
    )
    from vadcl_tpu_torch.ops.ln_mlp import ln_mlp, ln_mlp_plain

    gen = torch.Generator().manual_seed(0)
    stats, block_table = {}, []
    for batch in (4, BATCH_WINDOWS):
        dtypes = (torch.bfloat16,) if batch == BATCH_WINDOWS else (torch.bfloat16, torch.float32)
        print(f"[2] kernels vs plain versions, flagship shapes, batch {batch}")

        errs, errs10, errs_blk, errs_old, times = [], [], [], [], {}
        for dtype in dtypes:
            for gname, (dhwc, nh, window, shift) in FOLD_GEOMETRIES.items():
                for shifted in (False, True):
                    a = _fold_case((batch, *dhwc), nh, window,
                                   shift if shifted else (0, 0, 0), dtype, gen)
                    tag = f"{gname} {'shifted' if shifted else 'plain'} {str(dtype)[6:]}"
                    name = f"fold_attention {tag}"
                    errs.append(check_fold(name, a))
                    times[name] = time_pair(lambda: fold_attention(**a),
                                            lambda: fold_attention_plain(**a))
                    # kernel 10 on the same inputs, beside A
                    name = f"fold_attention_packed {tag}"
                    errs10.append(check_fold(name, a, fold_attention_packed,
                                             fold_attention_packed_plain))
                    times[name] = time_pair(lambda: fold_attention_packed(**a),
                                            lambda: fold_attention_packed_plain(**a))
                    # the whole-block kernel, beside A then B on the same inputs
                    blk = _block_case(a, gen)
                    tail = [blk[k] for k in ("ln2_scale", "ln2_bias", "w1", "b1", "w2", "b2")]
                    name = f"fold_block {tag}"
                    body = "mma" if dtype == torch.bfloat16 else "tiles"
                    got = check_block_route(name, blk, body)
                    errs_blk.append(check_close(name, got, fold_block_plain(**blk),
                                                *BOUNDS[dtype]))
                    if dtype == torch.bfloat16:
                        # not bit for bit: kernels A and B sum in another order
                        # than the whole-block kernel's body, so the three are
                        # held together by the bound each has against its plain
                        # version
                        errs_blk.append(check_close(
                            f"{name} vs kernel A then kernel B", got,
                            ln_mlp(fold_attention(**a), *tail), *BOUNDS[dtype]))
                    times[name] = time_pair(lambda: fold_block(**blk),
                                            lambda: fold_block_plain(**blk))
                    two = cuda_ms(lambda: ln_mlp(fold_attention(**a), *tail))
                    print(f"    kernel A then kernel B on the same inputs: {two:.4f} ms")
                    if dtype == torch.bfloat16:
                        # the tensor-core body: two calls, the same bits; PR 4's
                        # body (forced) on the same inputs, held and timed
                        same_bits(name, [got], [fold_block(**blk)])
                        old = fold_block_tiles(**blk)
                        errs_old.append(check_close(f"{name} PR 4's body", old,
                                                    fold_block_plain(**blk), *BOUNDS[dtype]))
                        old_ms = cuda_ms(lambda: fold_block_tiles(**blk))
                        print(f"    PR 4's body (fold_block_tiles) on the same inputs: "
                              f"{old_ms:.4f} ms")
                        block_table.append((batch, tag, times[name][0], old_ms, two))
                    if tag == "enc_stage0 shifted bfloat16":
                        rep_case, rep_blk, rep_two, rep_old = a, blk, two, old_ms
        # the representative time: the flagship's largest block, enc stage 0, bf16, shifted
        tokens = batch * 2 * 56 * 56
        shape = f"x ({batch},2,56,56,96) bf16, nH 6, N 98, shifted"
        for kname, e in (("fold_attention", errs), ("fold_attention_packed", errs10)):
            ms, pms = times[f"{kname} enc_stage0 shifted bfloat16"]
            stats[kname] = dict(
                max_abs_err=max(e), ms=ms, plain_ms=pms, shape=shape,
                **bound(tensors_of(rep_case) + [rep_case["x"]],
                        attn_flops(tokens, 96, 98), "bf16"))
        ms, pms = times["fold_block enc_stage0 shifted bfloat16"]
        blk_bound = bound(tensors_of(rep_blk) + [rep_blk["x"]],
                          attn_flops(tokens, 96, 98) + mlp_flops(tokens, 96), "bf16")
        stats["fold_block"] = dict(
            max_abs_err=max(errs_blk), ms=ms, plain_ms=pms, two_kernel_ms=rep_two,
            old_body_ms=rep_old, shape=shape + ", hidden 384", **blk_bound)
        stats["fold_block_tiles"] = dict(
            max_abs_err=max(errs_old), ms=rep_old, plain_ms=pms,
            shape=shape + ", hidden 384 (forced)", **blk_bound)

        for kname, kernel, plain in window_kernels():
            errs, times = [], {}
            for dtype in dtypes:
                for gname in FOLD_GEOMETRIES:
                    for shifted in (False, True):
                        a = _win_case(batch, gname, shifted, dtype, gen)
                        name = f"{kname} {gname} {'shifted' if shifted else 'plain'} {str(dtype)[6:]}"
                        errs.append(check_close(name, kernel(**a), plain(**a), *BOUNDS[dtype]))
                        if dtype == torch.bfloat16:
                            times[name] = time_pair(lambda: kernel(**a), lambda: plain(**a))
            ms, pms = times[f"{kname} enc_stage0 shifted bfloat16"]
            a = _win_case(batch, "enc_stage0", True, torch.bfloat16, gen)
            stats[kname] = dict(
                max_abs_err=max(errs), ms=ms, plain_ms=pms,
                shape=f"x_windows ({batch * 64},98,96) bf16, nH 6, shifted",
                **bound(tensors_of(a) + [a["x_windows"]],
                        attn_flops(batch * 64 * 98, 96, 98), "bf16"))

        errs, times = [], {}
        for dtype in dtypes:
            for C, dhw in MLP_SHAPES.items():
                p = _mlp_case(C, 4 * C, gen)
                x = torch.randn(batch, *dhw, C, generator=gen).to(DEV, dtype)
                name = f"ln_mlp C={C} {str(dtype)[6:]}"
                errs.append(check_close(name, ln_mlp(x, *p), ln_mlp_plain(x, *p), *BOUNDS[dtype]))
                times[name] = time_pair(lambda: ln_mlp(x, *p), lambda: ln_mlp_plain(x, *p))
        ms, pms = times["ln_mlp C=96 bfloat16"]
        x = torch.empty(batch, 2, 56, 56, 96, dtype=torch.bfloat16)
        stats["ln_mlp"] = dict(max_abs_err=max(errs), ms=ms, plain_ms=pms,
                               shape=f"x ({batch},2,56,56,96) bf16, hidden 384",
                               **bound([x, x, *_mlp_case(96, 384, gen)],
                                       x[..., 0].numel() * 16 * 96 * 96, "bf16"))

        n_tok = batch * 2 * 28 * 28
        tokens = torch.randn(n_tok, 192, generator=gen).cuda()
        centers = torch.rand(1024, 192, generator=gen).cuda()
        got = cluster_assign(tokens, centers, 16.0)
        want = cluster_assign_plain(tokens, centers, 16.0)
        e1 = check_close("cluster_assign recon", got.recon, want.recon, 1e-5, CLUSTER_RTOL)
        check_close("cluster_assign loss", got.loss_sq_sum, want.loss_sq_sum, 0.0, CLUSTER_RTOL)
        top2 = cdist(tokens, centers).topk(2, dim=-1, largest=False).values
        decided = (top2[:, 1] - top2[:, 0]) > LABEL_GAP
        agree = got.labels == want.labels
        print(f"  cluster_assign labels: {int(agree.sum())}/{agree.numel()} equal; "
              f"{int(decided.sum())} with gap > {LABEL_GAP:g}, all equal there: "
              f"{bool(agree[decided].all())}")
        if not bool(agree[decided].all()):
            raise AssertionError("cluster_assign: labels differ where the argmin is decided")
        same_bits("cluster_assign", got, cluster_assign(tokens, centers, 16.0))
        # the split products do not follow the TF32 switch of torch's matmul
        allow_tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = not allow_tf32
        try:
            same_bits("cluster_assign, allow_tf32 flipped", got,
                      cluster_assign(tokens, centers, 16.0))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = allow_tf32
        ms, pms = time_pair(lambda: cluster_assign(tokens, centers, 16.0),
                            lambda: cluster_assign_plain(tokens, centers, 16.0))
        # cdist and assign @ centers, 2 n K c flops each, as the body runs them:
        # three tf32 passes (hi.hi, hi.lo, lo.hi) over the tf32 peak; the same
        # work as fp32 FMA over the fp32 peak is printed beside it
        cl_flops = 4.0 * n_tok * 1024 * 192
        print(f"    the products as fp32 FMA over the fp32 peak: "
              f"{cl_flops / PEAK_FLOPS['fp32'] * 1e3:.4f} ms")
        stats["cluster_assign"] = dict(
            max_abs_err=e1, ms=ms, plain_ms=pms,
            shape=f"tokens ({n_tok},192) x centers (1024,192) fp32",
            **bound([tokens, centers, *got], 3 * cl_flops, "tf32"))

    print("  the whole-block forward, bf16, ms: the tensor-core body | PR 4's body | "
          "kernels A then B")
    for batch, tag, ms, old_ms, two in block_table:
        print(f"    batch {batch:2d} {tag:32s} {ms:.4f} | {old_ms:.4f} | {two:.4f}")
    print("  an odd batch (the last block of paired windows holds one) and token counts "
          "that fill no whole tile of kernel B, bf16:")
    for gname, (dhwc, nh, window, shift) in FOLD_GEOMETRIES.items():
        for shifted in (False, True):
            a = _fold_case((3, *dhwc), nh, window, shift if shifted else (0, 0, 0),
                           torch.bfloat16, gen)
            for kname, kernel, plain in fold_kernels():
                check_fold(f"{kname} batch 3 {gname} {'shifted' if shifted else 'plain'}", a,
                           kernel, plain)
    for C, shape in ((96, (3, 1, 7, 7)), (192, (3, 1, 7, 7)), (96, (5, 1, 56, 56)),
                     (192, (5, 1, 28, 28)), (192, (3, 2, 28, 28))):
        p = _mlp_case(C, 4 * C, gen)
        x = torch.randn(*shape, C, generator=gen).to(DEV, torch.bfloat16)
        check_close(f"ln_mlp C={C}, {x[..., 0].numel()} tokens", ln_mlp(x, *p),
                    ln_mlp_plain(x, *p), *BOUNDS[torch.bfloat16])
    print("  head width 32 (kernels A and 10), widths that are multiples of 16 but not of "
          "32 and missing LN or bias vectors (kernel B), bf16:")
    for batch, dhwc, nh, window in ((3, (2, 14, 14, 96), 3, (2, 7, 7)),
                                    (4, (2, 28, 28, 192), 6, (2, 7, 7)),
                                    (3, (1, 14, 14, 64), 2, (1, 7, 7))):
        for shift in ((0, 0, 0), (0, 3, 3)):
            a = _fold_case((batch, *dhwc), nh, window, shift, torch.bfloat16, gen)
            for kname, kernel, plain in fold_kernels():
                check_fold(f"{kname} head_dim 32, C={dhwc[-1]}, N={window[0] * 49}, "
                           f"shift {shift}", a, kernel, plain)
    for C, tokens in ((16, 147), (48, 1000), (80, 8192), (112, 147), (144, 20000),
                      (176, 9000)):
        p = _mlp_case(C, 4 * C if C % 32 == 0 else 8 * C, gen)  # (hidden % 128 == 0)
        x = torch.randn(tokens, C, generator=gen).to(DEV, torch.bfloat16)
        check_close(f"ln_mlp C={C}, {tokens} tokens", ln_mlp(x, *p), ln_mlp_plain(x, *p),
                    *BOUNDS[torch.bfloat16])
    p = _mlp_case(96, 384, gen)
    x = torch.randn(300, 96, generator=gen).to(DEV, torch.bfloat16)
    zeros = lambda n: torch.zeros(n, device=DEV)
    check_close("ln_mlp without b1 and b2",
                ln_mlp(x, p[0], p[1], p[2], None, p[4], None),
                ln_mlp_plain(x, p[0], p[1], p[2], zeros(384), p[4], zeros(96)),
                *BOUNDS[torch.bfloat16])
    print("  edge shapes (tiny preset widths, fp32 widths off the tensor-core "
          "tiles, ragged counts), correctness only:")
    # C=32 / head_dim 16 (the tiny preset) in both dtypes; C=24 / head_dim 12
    # only in fp32: the bf16 kernels run on 16x16 tensor-core tiles and refuse it
    for dtype, C, nh in ((torch.bfloat16, 32, 2), (torch.float32, 32, 2),
                         (torch.float32, 24, 2)):
        a = _fold_case((2, 2, 14, 14, C), nh, (2, 7, 7), (0, 3, 3), dtype, gen)
        for kname, kernel, plain in fold_kernels():
            check_fold(f"{kname} C={C} nH={nh} {str(dtype)[6:]}", a, kernel, plain)
        blk = _block_case(a, gen)
        check_close(f"fold_block C={C} nH={nh} {str(dtype)[6:]}", fold_block(**blk),
                    fold_block_plain(**blk), *BOUNDS[dtype])
        p = _mlp_case(C, 4 * C, gen)
        x = torch.randn(3, 1, 7, 7, C, generator=gen).to("cuda", dtype)  # 147 tokens
        check_close(f"ln_mlp C={C} {str(dtype)[6:]}", ln_mlp(x, *p), ln_mlp_plain(x, *p),
                    *BOUNDS[dtype])
    a = _fold_case((2, 2, 14, 14, 24), 2, (2, 7, 7), (0, 0, 0), torch.bfloat16, gen)
    p = _mlp_case(24, 96, gen)
    # kernel B takes C=24 in bf16 on its CUDA-core body; A, 10 and the whole
    # block run on 16x16 tensor-core tiles and refuse it (the route's
    # predicates are false there: the block takes kernels 7, 8 and 9, whose
    # CUDA-core bodies phase_narrow_kernels holds)
    check_close("ln_mlp bf16 C=24 (CUDA-core body)", ln_mlp(a["x"], *p),
                ln_mlp_plain(a["x"], *p), *BOUNDS[torch.bfloat16])
    blk = _block_case(a, gen)
    for name, call in (("fold_attention", lambda: fold_attention(**a)),
                       ("fold_attention_packed", lambda: fold_attention_packed(**a)),
                       ("fold_block", lambda: fold_block(**blk))):
        try:
            call()
        except NotImplementedError:
            print(f"  {name} bf16 C=24 refused (NotImplementedError), as it should be")
        else:
            raise AssertionError(f"{name}: bf16 C=24 launched instead of being refused")
    for kname, kernel, plain in window_kernels():
        for dtype, C, nh in ((torch.bfloat16, 32, 2), (torch.float32, 32, 2),
                             (torch.float32, 24, 2)):
            a = _win_case_at(2, (2, 14, 14), C, nh, (2, 7, 7), (0, 3, 3), dtype, gen)
            check_close(f"{kname} C={C} nH={nh} {str(dtype)[6:]}", kernel(**a), plain(**a),
                        *BOUNDS[dtype])
        for dtype in (torch.bfloat16, torch.float32):
            a = _win_case(4, "dec_stage1", True, dtype, gen, qkv_bias=False)
            check_close(f"{kname} no qkv bias {str(dtype)[6:]}", kernel(**a), plain(**a),
                        *BOUNDS[dtype])
    # kernels A and 10 as a block at a window-padded geometry runs them: no
    # LN, no residual; then without a qkv bias; N=392 fits neither (it runs
    # the row-tiled bodies of 7, 8 and 9, phase_row_kernels)
    for kname, kernel, plain in fold_kernels():
        for dtype in (torch.bfloat16, torch.float32):
            dhwc, nh, window, shift = PADDED_FOLD
            for sh in ((0, 0, 0), shift):
                a = dict(_fold_case((4, *dhwc), nh, window, sh, dtype, gen),
                         ln_scale=None, ln_bias=None, residual=False)
                check_close(f"{kname} no LN/residual, padded 63^2, shift {sh} {str(dtype)[6:]}",
                            kernel(**a), plain(**a), *BOUNDS[dtype])
            dhwc, nh, window, shift = FOLD_GEOMETRIES["dec_stage1"]
            a = dict(_fold_case((4, *dhwc), nh, window, shift, dtype, gen), qkv_b=None)
            check_fold(f"{kname} no qkv bias {str(dtype)[6:]}", a, kernel, plain)
    for dtype in (torch.bfloat16, torch.float32):
        dhwc, nh, window, shift = FOLD_GEOMETRIES["dec_stage1"]
        blk = _block_case(dict(_fold_case((4, *dhwc), nh, window, shift, dtype, gen),
                               qkv_b=None), gen)
        check_close(f"fold_block no qkv bias {str(dtype)[6:]}",
                    check_block_route(f"fold_block no qkv bias {str(dtype)[6:]}", blk,
                                      "mma" if dtype == torch.bfloat16 else "tiles"),
                    fold_block_plain(**blk), *BOUNDS[dtype])
    # the tensor-core body at hidden 192 (C = 96: off PR 4's 128-column
    # chunks) and at N = 49 on an odd batch (a chunk of windows cut short);
    # PR 4's body through its route: bf16 head width 48
    for gname, hidden, batch, nh in (("enc_stage0", 192, 2, 6), ("dec_stage1", 384, 3, 6),
                                     ("dec_stage0", 768, 5, 12), ("dec_stage1", 384, 4, 2)):
        dhwc, _, window, shift = FOLD_GEOMETRIES[gname]
        a = _fold_case((batch, *dhwc), nh, window, shift, torch.bfloat16, gen)
        blk = _block_case(a, gen, hidden)
        body = "mma" if nh != 2 else "tiles"
        name = f"fold_block {gname} batch {batch} hidden {hidden} head width {dhwc[-1] // nh}"
        got = check_block_route(name, blk, body)
        check_close(name, got, fold_block_plain(**blk), *BOUNDS[torch.bfloat16])
        if body == "mma":
            same_bits(name, [got], [fold_block(**blk)])
    a = _fold_case((1, 8, 14, 14, 96), 6, (8, 7, 7), (0, 0, 0), torch.bfloat16, gen)
    blk = _block_case(a, gen)
    for name, call in (("fold_attention_packed", lambda: fold_attention_packed(**a)),
                       ("fold_block", lambda: fold_block(**blk))):
        try:
            call()
        except NotImplementedError:
            print(f"  {name} N=392 refused (NotImplementedError): the route's predicate is "
                  "false there")
        else:
            raise AssertionError(f"{name}: N=392 launched instead of being refused")
    # kernel C's edge shapes: narrow widths (C = 30 pads to 32), the tiny
    # preset's feature head (2 clips x 98 tokens of 64, K = 16), K not a
    # multiple of the 32-center chunk, K = 1, N = 1, N not a multiple of the
    # 64-token block; then centers duplicated at k = 5 and 900 (the first
    # wins across chunks) and at 18 and 40 (across the two warps of a row
    # tile), and a token whose minimum lies in the last chunk
    for n, c, k in ((200, 64, 16), (100, 30, 70), (196, 64, 16), (1000, 192, 1000),
                    (300, 192, 1), (1, 192, 1024), (1, 30, 7), (77, 192, 1024),
                    (64, 192, 1000)):
        t, cen = torch.randn(n, c, generator=gen).cuda(), torch.rand(k, c, generator=gen).cuda()
        if (n, k) == (64, 1000):
            cen[900], cen[40] = cen[5], cen[18]
            t[0], t[1], t[2] = cen[5], cen[997] + 1e-3, cen[40]
        got, want = cluster_assign(t, cen, 16.0), cluster_assign_plain(t, cen, 16.0)
        if (n, k) == (64, 1000) and got.labels[:3].tolist() != [5, 997, 18]:
            raise AssertionError(f"cluster_assign: labels {got.labels[:3].tolist()} where the "
                                 "first occurrences are 5 and 18 and the late minimum 997")
        check_close(f"cluster_assign ({n},{c})x({k},{c}) recon", got.recon, want.recon,
                    1e-5, CLUSTER_RTOL)
        check_close(f"cluster_assign ({n},{c})x({k},{c}) loss", got.loss_sq_sum,
                    want.loss_sq_sum, 0.0, CLUSTER_RTOL)
        if not bool((got.labels == want.labels).all()):
            raise AssertionError("cluster_assign: labels differ at an edge shape")
    return stats


WIDE_MLP_CASES = ((256, 1024, (4, 2, 28, 28)), (100, 400, (1000,)))  # C, hidden, token shape
WIDE_CLUSTER_CASES = ((6272, 256, 1024), (1000, 200, 1000), (1000, 384, 1024),
                      (777, 512, 1000), (500, 768, 1024))  # N, C, K


def phase_width_kernels() -> dict:
    """Kernels B and C above the flagship's widths, which the JAX package
    runs (``fused_ln_mlp`` at any C, ``_cluster_kernel`` at any C): bf16
    ``ln_mlp`` at C = 256 / hidden 1024 (an ``embed_dim`` 128 model's inner
    stages) and C = 100 / hidden 400 (C % 16 != 0) on the CUDA-core body,
    which must count on ``ln_mlp_tiles``; fp32 ``cluster_assign`` at
    C = 256 (that model's feature head), 200, 384, 512 and 768, each
    instance of ``csrc/cluster_mma.cu:kCaShapes`` above 192; two calls give
    the same bits.  Returns the CUDA-core body's stats at C = 256 for the
    kernels line."""
    from vadcl_tpu_torch.ops.cluster import cdist
    from vadcl_tpu_torch.ops.cluster_kernels import (
        cluster_assign, cluster_assign_plain, cluster_assign_shape,
    )
    from vadcl_tpu_torch.ops.ln_mlp import ln_mlp, ln_mlp_plain, ln_mlp_tiles, mlp_fwd_body

    print("[2] kernels B and C above the flagship's widths")
    gen = torch.Generator().manual_seed(3)
    stats, errs = {}, []
    for C, hidden, shape in WIDE_MLP_CASES:
        p = _mlp_case(C, hidden, gen)
        x = torch.randn(*shape, C, generator=gen).to(DEV, torch.bfloat16)
        name = f"ln_mlp C={C} hidden {hidden} bf16 ({mlp_fwd_body(C, hidden, x.dtype)} body)"
        before = (ln_mlp.launches, ln_mlp_tiles.launches)
        got = ln_mlp(x, *p)
        if (ln_mlp.launches, ln_mlp_tiles.launches) != (before[0], before[1] + 1):
            raise AssertionError(f"{name}: did not run the CUDA-core body")
        errs.append(check_close(name, got, ln_mlp_plain(x, *p), *BOUNDS[torch.bfloat16]))
        same_bits(name, (got,), (ln_mlp(x, *p),))
        if C == 256:
            ms, pms = time_pair(lambda: ln_mlp(x, *p), lambda: ln_mlp_plain(x, *p))
            tokens = x[..., 0].numel()
            stats["ln_mlp_tiles"] = dict(
                ms=ms, plain_ms=pms, shape=f"x ({tokens},256) bf16, hidden 1024",
                **bound([x, got, *p], mlp_flops(tokens, C), "bf16"))
    # the CUDA-core body forced at the flagship's enc stage 0 width (which the
    # route gives the tensor-core body), beside it, and in fp32 (its route)
    p = _mlp_case(96, 384, gen)
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn(4, 2, 56, 56, 96, generator=gen).to(DEV, dtype)
        name = f"ln_mlp_tiles C=96 hidden 384 {str(dtype)[6:]}"
        errs.append(check_close(name, ln_mlp_tiles(x, *p), ln_mlp_plain(x, *p), *BOUNDS[dtype]))
        if dtype == torch.bfloat16:
            print(f"    time: CUDA-core body {cuda_ms(lambda: ln_mlp_tiles(x, *p)):.4f} ms, "
                  f"tensor-core body {cuda_ms(lambda: ln_mlp(x, *p)):.4f} ms")
    stats["ln_mlp_tiles"]["max_abs_err"] = max(errs)

    for n, c, k in WIDE_CLUSTER_CASES:
        tokens = torch.randn(n, c, generator=gen).cuda()
        centers = torch.rand(k, c, generator=gen).cuda()
        name = f"cluster_assign ({n},{c})x({k},{c}) instance {cluster_assign_shape(c)}"
        got = cluster_assign(tokens, centers, 16.0)
        want = cluster_assign_plain(tokens, centers, 16.0)
        check_close(f"{name} recon", got.recon, want.recon, 1e-5, CLUSTER_RTOL)
        check_close(f"{name} loss", got.loss_sq_sum, want.loss_sq_sum, 0.0, CLUSTER_RTOL)
        top2 = cdist(tokens, centers).topk(2, dim=-1, largest=False).values
        decided = (top2[:, 1] - top2[:, 0]) > LABEL_GAP
        agree = got.labels == want.labels
        print(f"  {name} labels: {int(agree.sum())}/{agree.numel()} equal; "
              f"{int(decided.sum())} with gap > {LABEL_GAP:g}, all equal there: "
              f"{bool(agree[decided].all())}")
        if not bool(agree[decided].all()):
            raise AssertionError(f"{name}: labels differ where the argmin is decided")
        same_bits(name, got, cluster_assign(tokens, centers, 16.0))
        if c == 256:
            allow_tf32 = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = not allow_tf32
            try:
                same_bits(f"{name}, allow_tf32 flipped", got,
                          cluster_assign(tokens, centers, 16.0))
            finally:
                torch.backends.cuda.matmul.allow_tf32 = allow_tf32
            ms, pms = time_pair(lambda: cluster_assign(tokens, centers, 16.0),
                                lambda: cluster_assign_plain(tokens, centers, 16.0))
            b = bound([tokens, centers, *got], 3 * 4.0 * n * k * c, "tf32")
            print(f"    bound {b['bound_ms']:.5f} ms ({b['bound_by']}): "
                  f"{b['bound_ms'] / ms:.2%} of it")
    try:
        cluster_assign(torch.randn(4, 769, device=DEV), torch.rand(8, 769, device=DEV), 16.0)
    except ValueError as e:
        print(f"  cluster_assign C=769 refused: {e}")
    else:
        raise AssertionError("cluster_assign: C=769 launched instead of being refused")
    return stats


def phase_space_kernel() -> dict:
    """Kernel D (space-cluster loss) against its plain version, fp32, at the
    flagship width (192 channels of 28^2 maps, K = 128) at BD = 8 (the
    training batch of 4 clips of 2 frames), 32 (the scoring batch of 16) and
    64 (8-frame reconstruction at batch 16), each timed beside its bound
    (``ms`` in the kernels line: the C entry called back to back, the
    device's time; ``wrapper_ms``: through ``space_cluster_loss``, whose
    host path is longer than the kernel);
    two calls, and a call with ``allow_tf32`` flipped, give the same bits.
    Then edge shapes: the tiny preset's head, BD = 1, 17 and 130 (three
    blocks a channel), K = 1, 130 (two K tiles) and 1000, HW = 785 and maps
    at a 4-byte offset (both through the 4-byte copies), and a map row equal
    to a center (d = 0 through the clamp).  Returns {kernel: stats at BD 32}."""
    from vadcl_tpu_torch.ops import cuda_lib
    from vadcl_tpu_torch.ops.cluster_kernels import space_cluster_loss, space_cluster_loss_plain

    lib = cuda_lib.library()

    def c_entry(maps, scen):
        """The kernel's C entry called directly: its device time, which its
        wrapper's host path (tens of microseconds) would hide."""
        cc, bd, hw = maps.shape
        scratch = torch.empty(lib.vadcl_space_cluster_scratch(cc, bd), device=DEV)
        loss = torch.empty((), device=DEV)
        args = (maps.data_ptr(), scen.data_ptr(), scratch.data_ptr(), loss.data_ptr(), cc, bd,
                hw, scen.shape[1], 32.0, cuda_lib.stream_ptr(maps))
        return lambda: cuda_lib.check(lib.vadcl_space_cluster_loss(*args), "space_cluster_loss")

    gen = torch.Generator().manual_seed(1)
    stats = {}
    print("[2] kernel D (space_cluster_loss) vs its plain version, fp32, flagship width")
    for bd in (2 * TRAIN_BATCH, 2 * BATCH_WINDOWS, 64):
        maps = torch.randn(192, bd, 784, generator=gen).cuda()
        scen = torch.rand(192, 128, 784, generator=gen).cuda()
        got = space_cluster_loss(maps, scen, 32.0)
        e = check_close(f"space_cluster_loss (192,{bd},784)x(192,128,784)", got,
                        space_cluster_loss_plain(maps, scen, 32.0), 0.0, CLUSTER_RTOL)
        # the per-channel cdist product, 2 BD K HW flops a channel, as the
        # body runs it (three tf32 passes: hi.hi, hi.lo, lo.hi) and as fp32 FMA
        flops = 2.0 * 192 * bd * 128 * 784
        print(f"    the products as three TF32 passes over the TF32 peak: "
              f"{3 * flops / PEAK_FLOPS['tf32'] * 1e3:.4f} ms; as fp32 FMA over the fp32 "
              f"peak: {flops / PEAK_FLOPS['fp32'] * 1e3:.4f} ms")
        wms, pms = time_pair(lambda: space_cluster_loss(maps, scen, 32.0),
                             lambda: space_cluster_loss_plain(maps, scen, 32.0))
        ms = cuda_ms(c_entry(maps, scen), batch=20)
        b = bound([maps, scen], 3 * flops, "tf32")
        print(f"    the C entry alone (no wrapper): {ms:.4f} ms; bound {b['bound_ms']:.5f} ms "
              f"({b['bound_by']}): the kernel at {100 * b['bound_ms'] / ms:.2f}% of it")
        if bd == 2 * BATCH_WINDOWS:
            same_bits("space_cluster_loss", (got,), (space_cluster_loss(maps, scen, 32.0),))
            # the split products do not follow the TF32 switch of torch's matmul
            allow_tf32 = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = not allow_tf32
            try:
                same_bits("space_cluster_loss, allow_tf32 flipped", (got,),
                          (space_cluster_loss(maps, scen, 32.0),))
            finally:
                torch.backends.cuda.matmul.allow_tf32 = allow_tf32
            stats["space_cluster_loss"] = dict(
                max_abs_err=e, ms=ms, wrapper_ms=wms, plain_ms=pms,
                shape=f"maps (192,{bd},784) x centers (192,128,784) fp32", **b)
    for cc, bd, k, hw in ((64, 3, 8, 49), (16, 1, 128, 784), (16, 17, 128, 784),
                          (16, 130, 128, 784), (16, 32, 1, 784), (16, 32, 130, 784),
                          (8, 32, 1000, 784), (16, 32, 128, 785)):
        m = torch.randn(cc, bd, hw, generator=gen).cuda()
        sc = torch.rand(cc, k, hw, generator=gen).cuda()
        check_close(f"space_cluster_loss ({cc},{bd},{hw})x({cc},{k},{hw})",
                    space_cluster_loss(m, sc, 32.0), space_cluster_loss_plain(m, sc, 32.0),
                    0.0, CLUSTER_RTOL)
    m = torch.randn(16 * 32 * 784 + 1, generator=gen).cuda()[1:].view(16, 32, 784)
    sc = torch.rand(16, 128, 784, generator=gen).cuda()
    check_close("space_cluster_loss, maps at a 4-byte offset", space_cluster_loss(m, sc, 32.0),
                space_cluster_loss_plain(m, sc, 32.0), 0.0, CLUSTER_RTOL)
    m = torch.randn(16, 32, 784, generator=gen).cuda()
    m[3, 5] = sc[3, 77]
    check_close("space_cluster_loss, a map row equal to a center",
                space_cluster_loss(m, sc, 32.0), space_cluster_loss_plain(m, sc, 32.0),
                0.0, CLUSTER_RTOL)
    return stats


# Backward kernels (phase 2b): every output is held per tensor to
# max|kernel - plain| <= tol * max|plain|, the scheme of the JAX package's
# gradient tests: weight gradients are sums over up to ~25k tokens, where an
# elementwise relative bound is meaningless for entries near zero.  fp32:
# only the summation order differs (a few 1e-7 relative, so 1e-4 leaves
# margin).  bf16: kernel and plain version round at the same cast
# boundaries; a different fp32 summation order can flip one rounding of an
# intermediate (2^-8 relative), whose effect on any output stays well under
# 2% of that output's largest entry.
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
FOLD_BWD_NAMES = ("dx", "dln_s", "dln_b", "dqkv_w", "dqkv_b", "dproj_w", "dproj_b", "dbias")
WIN_BWD_NAMES = ("dx", "dqkv_w", "dqkv_b", "dproj_w", "dproj_b", "dbias")
MLP_BWD_NAMES = ("dx", "dls", "dlb", "dw1", "db1", "dw2", "db2")
BLOCK_BWD_NAMES = FOLD_BWD_NAMES + ("dln2_s", "dln2_b", "dw1", "db1", "dw2", "db2")


def rel_error(got, want, tol) -> tuple:
    """(max abs error, max|want|, err / (tol * max|want|))."""
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    ratio = err / (tol * scale) if scale > 0 else (0.0 if err == 0 else float("inf"))
    return err, scale, ratio


def check_rel(name, got, want, tol) -> float:
    """Per-tensor bound max|got - want| <= tol * max|want|; returns the max
    abs error."""
    err, scale, ratio = rel_error(got, want, tol)
    print(f"  {name}: max_abs_err={err:.3e} max|plain|={scale:.3e} "
          f"err/(tol*max)={ratio:.3f} (tol {tol:g})")
    if not ratio <= 1.0:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return err


def check_grads(name, names, got, want, tol) -> float:
    """Every gradient of a case against its plain version; prints the case's
    worst err/(tol*max) and returns its largest max abs error."""
    if [g is None for g in got] != [w is None for w in want]:
        raise AssertionError(f"{name}: kernel and plain version return different gradients")
    pairs = [(n, g, w) for n, g, w in zip(names, got, want) if w is not None]
    err = max(check_rel(f"{name} {n}", g, w, tol) for n, g, w in pairs)
    worst = max((rel_error(g, w, tol)[2], n) for n, g, w in pairs)
    print(f"  {name}: worst err/(tol*max) {worst[0]:.3f} ({worst[1]})")
    return err


def same_bits(name, got, again) -> None:
    """Two calls of a kernel on the same inputs give the same bits: its sums
    run in a fixed order (no float atomics)."""
    for g, h in zip(got, again):
        if g is not None and not torch.equal(g, h):
            raise AssertionError(f"{name}: two calls on the same inputs differ")
    print(f"  {name}: two calls bit-identical")


def mlp_split_flops(tokens: int, c: int) -> float:
    """Kernel 5's products as its tensor-core body runs them (hidden 4C):
    the fc1 recompute and dy.w2^T one bf16 pass each, dz.w1^T and dw2 two
    (hi and lo of dh, of g), dw1 three (hi.hi, hi.lo, lo.hi): 9 x 8C^2."""
    return tokens * 72.0 * c * c


def _fold_bwd_case(shape, nh, window, shift, dtype, gen):
    """Kernel A's case without proj_b, plus an upstream gradient drawn at
    unit scale: the arguments of kernel 6 and its plain version."""
    a = _fold_case(shape, nh, window, shift, dtype, gen)
    del a["proj_b"]
    a["dout"] = torch.randn(a["x"].shape, generator=gen).to(DEV, dtype)
    return a


def _block_bwd_case(a, gen):
    """Kernel 6's case ``a`` (which has the upstream gradient) plus proj_b
    and the MLP tail's operands without b2: the arguments of the whole-block
    backward and its plain version."""
    C = a["x"].shape[-1]
    ln2_s, ln2_b, w1, b1, w2, _ = _mlp_case(C, 4 * C, gen)
    order = ("x", "dout", "ln_scale", "ln_bias", "qkv_w", "qkv_b", "proj_w")
    b = {k: a[k] for k in order}
    b["proj_b"] = 0.1 * torch.randn(C, generator=gen).to(DEV)
    b.update(bias=a["bias"], mask=a["mask"], ln2_scale=ln2_s, ln2_bias=ln2_b, w1=w1, b1=b1,
             w2=w2, num_heads=a["num_heads"], window=a["window"], scale=a["scale"],
             shift=a["shift"])
    return b


def _win_bwd_case(a, gen):
    """Kernel 7's case without proj_b, plus an upstream gradient at unit
    scale: the arguments of kernel 8 and its plain version."""
    b = {k: v for k, v in a.items() if k != "proj_b"}
    b["dout"] = torch.randn(a["x_windows"].shape, generator=gen).to(DEV, a["x_windows"].dtype)
    return b


def check_block_bwd_route(name, blk, body):
    """The whole-block backward on ``blk`` against its plain version, and the
    body (``"mma"``: the tensor-core body; ``"tiles"``: PR 4's) that launched."""
    from vadcl_tpu_torch.ops.fold_attn import (
        fold_block_bwd, fold_block_bwd_plain, fold_block_bwd_tiles,
    )

    before = (fold_block_bwd.launches, fold_block_bwd_tiles.launches)
    got = fold_block_bwd(**blk)
    check_grads(f"{name} ({body})", BLOCK_BWD_NAMES, got, fold_block_bwd_plain(**blk),
                BWD_TOL[blk["x"].dtype])
    want = (before[0] + 1, before[1]) if body == "mma" else (before[0], before[1] + 1)
    if (fold_block_bwd.launches, fold_block_bwd_tiles.launches) != want:
        raise AssertionError(f"{name}: did not take the {body} body")
    return got


def phase_bwd_kernels(batch: int = 4):
    """Kernels 5, 6 and 8 against their plain versions on the card at batch
    ``batch`` (the training batch), bf16 and fp32: kernels 6 and 8 at the
    four attention geometries, shifted and unshifted, kernel 5 at C=96 and
    C=192; kernel 6 also without LN and residual on a window-padded shape.
    In bf16, 5 and 6 run their tensor-core bodies, each called twice for
    equal bits and timed beside its old body; then the widths, token counts
    and head widths the model does not send, and the old bodies' routes.
    The rel-pos bias and the upstream gradient are drawn at unit scale.
    Returns {kernel: stats of the bf16 case the kernels line reports}."""
    from vadcl_tpu_torch.ops.fold_attn import (
        fold_attention, fold_attention_bwd, fold_attention_bwd_plain, fold_attention_bwd_tiles,
        fold_block_bwd, fold_block_bwd_plain, fold_block_bwd_tiles,
    )
    from vadcl_tpu_torch.ops.ln_mlp import ln_mlp_bwd, ln_mlp_bwd_plain, ln_mlp_bwd_tiles
    from vadcl_tpu_torch.ops.window_attn import (
        window_attention_fused_bwd, window_attention_fused_bwd_plain,
    )

    print(f"[2b] backward kernels vs plain versions, flagship shapes, batch {batch}")
    gen = torch.Generator().manual_seed(5)
    stats = {}
    errs = {"fold_attention_bwd": [], "ln_mlp_bwd": [], "window_attention_fused_bwd": [],
            "fold_block_bwd": []}
    for dtype in (torch.bfloat16, torch.float32):
        tol = BWD_TOL[dtype]
        for gname, (dhwc, nh, window, shift) in FOLD_GEOMETRIES.items():
            for shifted in (False, True):
                a = _fold_bwd_case((batch, *dhwc), nh, window,
                                   shift if shifted else (0, 0, 0), dtype, gen)
                name = f"fold_attention_bwd {gname} {'shifted' if shifted else 'plain'} {str(dtype)[6:]}"
                got, want = fold_attention_bwd(**a), fold_attention_bwd_plain(**a)
                errs["fold_attention_bwd"].append(check_grads(name, FOLD_BWD_NAMES, got, want, tol))
                if dtype == torch.bfloat16:
                    same_bits(name, got, fold_attention_bwd(**a))
                ms, pms = time_pair(lambda: fold_attention_bwd(**a),
                                    lambda: fold_attention_bwd_plain(**a))
                if dtype == torch.bfloat16:
                    old_ms = cuda_ms(lambda: fold_attention_bwd_tiles(**a))
                    print(f"    the shared-memory body on the same inputs: {old_ms:.4f} ms")
                if dtype == torch.bfloat16 and gname == "enc_stage0" and shifted:
                    stats["fold_attention_bwd"] = dict(
                        ms=ms, plain_ms=pms, old_body_ms=old_ms,
                        shape=f"x ({batch},2,56,56,96) bf16, nH 6, N 98, shifted",
                        **bound(tensors_of(a, got), attn_flops(a["x"][..., 0].numel(), 96, 98,
                                                               backward=True), "bf16"))
                # the whole-block backward on the same inputs, all 14 outputs,
                # beside PR 4's body and kernels A, 5 and 6 in turn
                blk = _block_bwd_case(a, gen)
                name = f"fold_block_bwd {gname} {'shifted' if shifted else 'plain'} {str(dtype)[6:]}"
                before = (fold_block_bwd.launches, fold_block_bwd_tiles.launches)
                got, want = fold_block_bwd(**blk), fold_block_bwd_plain(**blk)
                body = ("mma" if (fold_block_bwd.launches, fold_block_bwd_tiles.launches)
                        == (before[0] + 1, before[1]) else "tiles")
                if body != ("mma" if dtype == torch.bfloat16 else "tiles"):
                    raise AssertionError(f"{name}: took the {body} body")
                errs["fold_block_bwd"].append(check_grads(name, BLOCK_BWD_NAMES, got, want, tol))
                ms, pms = time_pair(lambda: fold_block_bwd(**blk),
                                    lambda: fold_block_bwd_plain(**blk))
                if dtype == torch.bfloat16:
                    same_bits(name, got, fold_block_bwd(**blk))
                    old = fold_block_bwd_tiles(**blk)
                    old_err = check_grads(f"{name}, PR 4's body", BLOCK_BWD_NAMES, old, want, tol)
                    old_ms = cuda_ms(lambda: fold_block_bwd_tiles(**blk))
                    print(f"    PR 4's body (fold_block_bwd_tiles) on the same inputs: "
                          f"{old_ms:.4f} ms")
                    fwd = {k: v for k, v in blk.items() if k in a and k != "dout"}
                    tail = [blk[k] for k in ("ln2_scale", "ln2_bias", "w1", "b1", "w2")]

                    def split():
                        y1 = fold_attention(proj_b=blk["proj_b"], **fwd)
                        dy1 = ln_mlp_bwd(y1, blk["dout"], *tail)[0]
                        return fold_attention_bwd(**dict(a, dout=dy1))

                    two = cuda_ms(split)
                    print(f"    kernel A, then 5, then 6 on the same inputs: {two:.4f} ms")
                    if gname == "enc_stage0" and shifted:
                        tokens = a["x"][..., 0].numel()
                        shape = f"x ({batch},2,56,56,96) bf16, nH 6, N 98, shifted, hidden 384"
                        # the attention products in bf16 (the forward to y1 once,
                        # then the backward's), the MLP tail's backward in fp32
                        # FMA, as the contract; beside it the products as the
                        # new body runs them (the tail's split bf16 passes), all
                        # over the bf16 peak
                        attn = attn_flops(tokens, 96, 98, backward=True, through_proj=True)
                        split_bound = bound(tensors_of(blk, got),
                                            attn + mlp_split_flops(tokens, 96), "bf16")
                        print(f"    bound: fp32 FMA tail {bound(tensors_of(blk, got), attn, 'bf16', mlp_flops(tokens, 96, backward=True))['bound_ms']:.5f} ms, "
                              f"split bf16 products {split_bound['bound_ms']:.5f} ms")
                        stats["fold_block_bwd"] = dict(
                            ms=ms, plain_ms=pms, split_ms=two, old_body_ms=old_ms, shape=shape,
                            split_bound_ms=split_bound["bound_ms"],
                            **bound(tensors_of(blk, got), attn, "bf16",
                                    mlp_flops(tokens, 96, backward=True)))
                        stats["fold_block_bwd_tiles"] = dict(
                            ms=old_ms, plain_ms=pms, max_abs_err=old_err, shape=shape,
                            **bound(tensors_of(blk, old), attn, "bf16",
                                    mlp_flops(tokens, 96, backward=True)))
                w = _win_bwd_case(_win_case(batch, gname, shifted, dtype, gen), gen)
                name = (f"window_attention_fused_bwd {gname} "
                        f"{'shifted' if shifted else 'plain'} {str(dtype)[6:]}")
                got = window_attention_fused_bwd(**w)
                errs["window_attention_fused_bwd"].append(check_grads(
                    name, WIN_BWD_NAMES, got, window_attention_fused_bwd_plain(**w), tol))
                if dtype == torch.bfloat16:
                    ms, pms = time_pair(lambda: window_attention_fused_bwd(**w),
                                        lambda: window_attention_fused_bwd_plain(**w))
                    if gname == "enc_stage0" and shifted:
                        stats["window_attention_fused_bwd"] = dict(
                            ms=ms, plain_ms=pms,
                            shape=f"x_windows ({batch * 64},98,96) bf16, nH 6, shifted",
                            **bound(tensors_of(w, got),
                                    attn_flops(batch * 64 * 98, 96, 98, backward=True), "bf16"))
        dhwc, nh, window, shift = PADDED_FOLD
        for sh in ((0, 0, 0), shift):
            a = dict(_fold_bwd_case((batch, *dhwc), nh, window, sh, dtype, gen),
                     ln_scale=None, ln_bias=None, residual=False)
            name = f"fold_attention_bwd no LN/residual, padded 63^2, shift {sh} {str(dtype)[6:]}"
            errs["fold_attention_bwd"].append(check_grads(
                name, FOLD_BWD_NAMES, fold_attention_bwd(**a), fold_attention_bwd_plain(**a), tol))
        for C, dhw in MLP_SHAPES.items():
            p = _mlp_case(C, 4 * C, gen)[:5]
            x = torch.randn(batch, *dhw, C, generator=gen).to(DEV, dtype)
            dy = torch.randn(x.shape, generator=gen).to(DEV, dtype)
            name = f"ln_mlp_bwd C={C} {str(dtype)[6:]}"
            got, want = ln_mlp_bwd(x, dy, *p), ln_mlp_bwd_plain(x, dy, *p)
            errs["ln_mlp_bwd"].append(check_grads(name, MLP_BWD_NAMES, got, want, tol))
            if dtype == torch.bfloat16:
                same_bits(name, got, ln_mlp_bwd(x, dy, *p))
            ms, pms = time_pair(lambda: ln_mlp_bwd(x, dy, *p), lambda: ln_mlp_bwd_plain(x, dy, *p))
            if dtype == torch.bfloat16:
                old_ms = cuda_ms(lambda: ln_mlp_bwd_tiles(x, dy, *p))
                print(f"    the CUDA-core body on the same inputs: {old_ms:.4f} ms")
            if dtype == torch.bfloat16 and C == 96:
                # fc1 recomputed, dw2, dy.w2^T, dw1, dz.w1^T: 8C^2 per token each, fp32
                # operations by the contract; the split bf16 passes the tensor-core
                # body runs, over the bf16 peak, are printed beside it
                tokens = x[..., 0].numel()
                print(f"    the split bf16 products over the bf16 peak: "
                      f"{mlp_split_flops(tokens, C) / PEAK_FLOPS['bf16'] * 1e3:.4f} ms")
                stats["ln_mlp_bwd"] = dict(ms=ms, plain_ms=pms, old_body_ms=old_ms,
                                           shape=f"x ({batch},2,56,56,96) bf16, hidden 384",
                                           **bound([x, dy, *p, *got],
                                                   tokens * 40.0 * C * C, "fp32"))
    bf, tol16 = torch.bfloat16, BWD_TOL[torch.bfloat16]
    print("  the tensor-core bodies at the widths and token counts the model does not "
          "send but they take, bf16:")
    for C, dhw, b in [(C, (1, 7, 7), 3) for C in (16, 48, 80, 112, 144, 176)] + [
            (96, (1, 10, 10), 5), (192, (1, 10, 10), 5)]:
        p = _mlp_case(C, 4 * C, gen)[:5]
        x = torch.randn(b, *dhw, C, generator=gen).to(DEV, bf)
        dy = torch.randn(x.shape, generator=gen).to(DEV, bf)
        name = f"ln_mlp_bwd C={C}, {x[..., 0].numel()} tokens bf16"
        got = ln_mlp_bwd(x, dy, *p)
        errs["ln_mlp_bwd"].append(check_grads(name, MLP_BWD_NAMES, got,
                                              ln_mlp_bwd_plain(x, dy, *p), tol16))
        same_bits(name, got, ln_mlp_bwd(x, dy, *p))
    for dhwc, nh, window, shift in (((2, 56, 56, 96), 3, (2, 7, 7), (0, 3, 3)),
                                    ((1, 28, 28, 64), 2, (1, 7, 7), (0, 3, 3)),
                                    ((2, 14, 14, 32), 2, (2, 7, 7), (0, 0, 0))):
        a = _fold_bwd_case((batch, *dhwc), nh, window, shift, bf, gen)
        name = f"fold_attention_bwd head width 32, C={dhwc[-1]}, N={window[0] * 49}, shift {shift} bf16"
        got = fold_attention_bwd(**a)
        errs["fold_attention_bwd"].append(check_grads(name, FOLD_BWD_NAMES, got,
                                                      fold_attention_bwd_plain(**a), tol16))
        same_bits(name, got, fold_attention_bwd(**a))
        a["qkv_b"] = None
        check_grads(f"{name} without qkv bias", FOLD_BWD_NAMES, fold_attention_bwd(**a),
                    fold_attention_bwd_plain(**a), tol16)
    print("  the bodies the tensor-core ones leave geometries to, through their route, bf16:")
    before = (ln_mlp_bwd.launches, ln_mlp_bwd_tiles.launches)
    p = _mlp_case(24, 96, gen)[:5]
    x = torch.randn(3, 1, 7, 7, 24, generator=gen).to(DEV, bf)
    dy = torch.randn(x.shape, generator=gen).to(DEV, bf)
    check_grads("ln_mlp_bwd C=24 bf16 (CUDA-core body)", MLP_BWD_NAMES, ln_mlp_bwd(x, dy, *p),
                ln_mlp_bwd_plain(x, dy, *p), tol16)
    if (ln_mlp_bwd.launches, ln_mlp_bwd_tiles.launches) != (before[0], before[1] + 1):
        raise AssertionError("ln_mlp_bwd C=24 bf16 did not take the CUDA-core body's route")
    before = (fold_attention_bwd.launches, fold_attention_bwd_tiles.launches)
    a = _fold_bwd_case((batch, 1, 28, 28, 96), 2, (1, 7, 7), (0, 3, 3), bf, gen)
    check_grads("fold_attention_bwd head width 48, N=49 bf16 (shared-memory body)",
                FOLD_BWD_NAMES, fold_attention_bwd(**a), fold_attention_bwd_plain(**a), tol16)
    if (fold_attention_bwd.launches, fold_attention_bwd_tiles.launches) != (before[0],
                                                                            before[1] + 1):
        raise AssertionError("fold_attention_bwd head width 48 did not take the shared-memory "
                             "body's route")
    from vadcl_tpu_torch.ops import cuda_lib

    lib = cuda_lib.library()
    ntok = batch * 2 * 56 * 56
    print(f"  kernel 5 workspace, bf16, {ntok} tokens, C=96: tensor-core body "
          f"{lib.vadcl_ln_mlp_bwd_bf16_workspace_bytes(ntok, 96, 384) / 1e6:.2f} MB, CUDA-core "
          f"body {lib.vadcl_ln_mlp_bwd_workspace_bytes(ntok, 96, 384) / 1e6:.2f} MB")
    for gname, ((D, H, W, C), nh, window, _) in FOLD_GEOMETRIES.items():
        n = window[0] * window[1] * window[2]
        chunks = lib.vadcl_fold_attn_bwd_bf16_dbias_partials(batch, D, H, W, C, nh, *window)
        print(f"  kernel 6 tensor-core body, bf16, batch {batch}, {gname}: workspace "
              f"{lib.vadcl_fold_attn_bwd_bf16_workspace_bytes(batch, D, H, W, C, nh, *window) / 1e6:.1f}"
              f" MB, of it {chunks} d(bias) partials, {chunks * nh * n * n * 4 / 1e6:.1f} MB")
    for gname, ((D, H, W, C), nh, window, _) in FOLD_GEOMETRIES.items():
        n = window[0] * window[1] * window[2]
        bn = batch * (D // window[0]) * (H // window[1]) * (W // window[2])
        ws = lib.vadcl_window_attn_bwd_workspace_bytes(bn, n, C, nh, 1)
        print(f"  kernel 8 workspace, bf16, batch {batch}, {gname}: {ws / 1e6:.1f} MB, of it "
              f"the per-window d(bias) partials {bn * nh * n * n * 4 / 1e6:.1f} MB")
        ws6 = lib.vadcl_fold_attn_bwd_workspace_bytes(batch, D, H, W, C, nh, *window, 1)
        ws5 = lib.vadcl_ln_mlp_bwd_workspace_bytes(batch * D * H * W, C, 4 * C)
        wsb = lib.vadcl_fold_block_bwd_workspace_bytes(batch, D, H, W, C, nh, 4 * C, *window, 1)
        wsn = lib.vadcl_fold_block_bwd_bf16_workspace_bytes(batch, D, H, W, C, nh, 4 * C,
                                                            *window)
        print(f"  whole-block backward workspace, bf16, batch {batch}, {gname}: tensor-core "
              f"body {wsn / 1e6:.1f} MB, PR 4's body {wsb / 1e6:.1f} MB (kernel 6 alone "
              f"{ws6 / 1e6:.1f} MB, kernel 5 alone {ws5 / 1e6:.1f} MB)")
    print("  edge shapes (tiny widths, C=24 / head_dim 12, 147 tokens), fp32 and bf16:")
    for dtype, C, nh in ((torch.bfloat16, 32, 2), (torch.float32, 32, 2),
                         (torch.float32, 24, 2)):
        a = _fold_bwd_case((2, 2, 14, 14, C), nh, (2, 7, 7), (0, 3, 3), dtype, gen)
        check_grads(f"fold_attention_bwd C={C} {str(dtype)[6:]}", FOLD_BWD_NAMES,
                    fold_attention_bwd(**a), fold_attention_bwd_plain(**a), BWD_TOL[dtype])
        for qkv_bias in (True, False):
            blk = _block_bwd_case(a, gen)
            if not qkv_bias:
                blk["qkv_b"] = None
            check_block_bwd_route(f"fold_block_bwd C={C} qkv_bias={qkv_bias} {str(dtype)[6:]}",
                                  blk, "mma" if dtype == torch.bfloat16 else "tiles")
        for qkv_bias in (True, False):
            w = _win_bwd_case(_win_case_at(2, (2, 14, 14), C, nh, (2, 7, 7), (0, 3, 3), dtype,
                                           gen, qkv_bias), gen)
            check_grads(f"window_attention_fused_bwd C={C} qkv_bias={qkv_bias} {str(dtype)[6:]}",
                        WIN_BWD_NAMES, window_attention_fused_bwd(**w),
                        window_attention_fused_bwd_plain(**w), BWD_TOL[dtype])
        p = _mlp_case(C, 4 * C, gen)[:5]
        x = torch.randn(3, 1, 7, 7, C, generator=gen).to(DEV, dtype)
        dy = torch.randn(x.shape, generator=gen).to(DEV, dtype)
        check_grads(f"ln_mlp_bwd C={C} {str(dtype)[6:]}", MLP_BWD_NAMES,
                    ln_mlp_bwd(x, dy, *p), ln_mlp_bwd_plain(x, dy, *p), BWD_TOL[dtype])
    # a bf16 geometry the tensor-core body leaves to PR 4's body: head width 48
    a = _fold_bwd_case((batch, 1, 28, 28, 96), 2, (1, 7, 7), (0, 3, 3), torch.bfloat16, gen)
    for qkv_bias in (True, False):
        blk = _block_bwd_case(a, gen)
        if not qkv_bias:
            blk["qkv_b"] = None
        check_block_bwd_route(f"fold_block_bwd head width 48, N=49, qkv_bias={qkv_bias} bf16",
                              blk, "tiles")
    # a chunk of windows cut short: 320 windows at chunks of 3
    a = _fold_bwd_case((5, 2, 56, 56, 96), 6, (2, 7, 7), (0, 3, 3), torch.bfloat16, gen)
    blk = _block_bwd_case(a, gen)
    got = check_block_bwd_route("fold_block_bwd batch 5 (a chunk cut short) bf16", blk, "mma")
    same_bits("fold_block_bwd batch 5 bf16", got, fold_block_bwd(**blk))
    a = _fold_bwd_case((2, 2, 14, 14, 24), 2, (2, 7, 7), (0, 0, 0), torch.bfloat16, gen)
    try:
        fold_attention_bwd(**a)
    except NotImplementedError:
        print("  fold_attention_bwd bf16 C=24 refused (NotImplementedError), as it should be")
    else:
        raise AssertionError("fold_attention_bwd: bf16 C=24 launched instead of being refused")
    for k in stats:
        if k in errs:
            stats[k]["max_abs_err"] = max(errs[k])
    return stats


def _launched(fn):
    """``fn()`` and the launches it added, {counter: count} of those that moved."""
    from vadcl_tpu_torch.ops import KERNELS

    before = [k.launches for k in KERNELS]
    out = fn()
    return out, {k.__name__: k.launches - b for k, b in zip(KERNELS, before) if k.launches != b}


def phase_window_fold_route(batch: int = BATCH_WINDOWS, train_batch: int = 4) -> dict:
    """Kernels 7, 9 and 8 in bf16 at the flagship's widths, where the route
    runs them on kernel A's (9: its ``packed`` instance) and kernel 6's
    tensor-core bodies without LN and residual on ``window_grid``'s view of
    the windows: at every 4-frame geometry, shifted and not, the forwards at
    ``batch`` clips' windows and the backward at ``train_batch``'s, each
    against its plain version and against the whole-tile body forced on the
    same inputs (``window_attention_fused_tiles``,
    ``window_attention_packed_tiles``, ``window_attention_fused_bwd_tiles``),
    each call's body shown by the one counter that moved, two calls for the
    same bits, each timed beside the other body and the plain version; the
    blocks of both grids printed.  Returns the kernels line's stats of the
    three whole-tile bodies."""
    from vadcl_tpu_torch.ops import cuda_lib
    from vadcl_tpu_torch.ops import window_attn as wa

    print(f"[2/2b] kernels 7, 9 and 8 on the tensor-core bodies of A and 6 (window_grid's "
          f"view) vs plain and vs the whole-tile bodies, bf16, forward at batch {batch}, "
          f"backward at batch {train_batch}")
    lib = cuda_lib.library()
    gen = torch.Generator().manual_seed(15)
    bf, tol = torch.bfloat16, BWD_TOL[torch.bfloat16]
    errs = {"window_attention_fused_tiles": [], "window_attention_packed_tiles": [],
            "window_attention_fused_bwd_tiles": []}
    forwards = (("7", wa.window_attention_fused, wa.window_attention_fused_tiles,
                 wa.window_attention_fused_plain),
                ("9", wa.window_attention_packed, wa.window_attention_packed_tiles,
                 wa.window_attention_packed_plain))
    stats, table = {}, []
    for gname, ((D, H, W, C), nh, window, shift) in FOLD_GEOMETRIES.items():
        n = window[0] * window[1] * window[2]
        for shifted in (False, True):
            tag = f"{gname} {'shifted' if shifted else 'plain'}"
            a = _win_case(batch, gname, shifted, bf, gen)
            for k, kernel, forced, plain in forwards:
                new = lambda: kernel(**a)  # noqa: E731
                old = lambda: forced(**a)  # noqa: E731
                body = "A's packed body" if k == "9" else "A's body"
                got, moved = _launched(new)
                if moved != {kernel.__name__: 1}:
                    raise AssertionError(f"kernel {k} {tag}: launched {moved}, not {body} "
                                         f"counted on {kernel.__name__}")
                tiles, moved = _launched(old)
                if moved != {forced.__name__: 1}:
                    raise AssertionError(f"kernel {k} {tag}: the forced whole-tile body "
                                         f"launched {moved}")
                want = plain(**a)
                check_close(f"kernel {k} on {body} {tag}", got, want, *BOUNDS[bf])
                errs[forced.__name__].append(
                    check_close(f"kernel {k} whole-tile body {tag}", tiles, want, *BOUNDS[bf]))
                check_close(f"kernel {k} on {body} vs the whole-tile body {tag}", got, tiles,
                            *BOUNDS[bf])
                same_bits(f"kernel {k} on {body} {tag}", [got], [new()])
                ms, old_ms = cuda_ms(new), cuda_ms(old)
                pms = cuda_ms(lambda: plain(**a))
                bn = a["x_windows"].shape[0]
                print(f"    time: {body} {ms:.4f} ms, whole-tile body {old_ms:.4f} ms, plain "
                      f"{pms:.4f} ms; {-(-bn // (2 if n <= 64 else 1))} blocks")
                table.append((k, batch, tag, ms, old_ms, pms))
                if gname == "enc_stage0" and shifted:
                    stats[forced.__name__] = dict(
                        ms=old_ms, plain_ms=pms, shape=f"x_windows ({bn},{n},{C}) bf16, "
                        f"nH {nh}, shifted (forced)",
                        **bound(tensors_of(a) + [tiles], attn_flops(bn * n, C, n), "bf16"))
                del got, tiles, want
            del a

            w = _win_bwd_case(_win_case(train_batch, gname, shifted, bf, gen), gen)
            new = lambda: wa.window_attention_fused_bwd(**w)  # noqa: E731
            old = lambda: wa.window_attention_fused_bwd_tiles(**w)  # noqa: E731
            got, moved = _launched(new)
            if moved != {"window_attention_fused_bwd": 1}:
                raise AssertionError(f"kernel 8 {tag}: launched {moved}, not kernel 6's body "
                                     "counted on window_attention_fused_bwd")
            tiles, moved = _launched(old)
            if moved != {"window_attention_fused_bwd_tiles": 1}:
                raise AssertionError(f"kernel 8 {tag}: the forced whole-tile body launched "
                                     f"{moved}")
            want = wa.window_attention_fused_bwd_plain(**w)
            check_grads(f"kernel 8 on 6's body {tag}", WIN_BWD_NAMES, got, want, tol)
            errs["window_attention_fused_bwd_tiles"].append(
                check_grads(f"kernel 8 whole-tile body {tag}", WIN_BWD_NAMES, tiles, want, tol))
            check_grads(f"kernel 8 on 6's body vs the whole-tile body {tag}", WIN_BWD_NAMES,
                        got, tiles, tol)
            same_bits(f"kernel 8 on 6's body {tag}", got, new())
            ms, old_ms = cuda_ms(new), cuda_ms(old)
            pms = cuda_ms(lambda: wa.window_attention_fused_bwd_plain(**w))
            bn = w["x_windows"].shape[0]
            grid = wa.window_grid(w["x_windows"], w["mask"], w["n_windows"])[0].shape
            chunks = lib.vadcl_fold_attn_bwd_bf16_dbias_partials(
                grid[0], 1, 1, grid[3], C, nh, 1, 1, n)
            print(f"    time: 6's body {ms:.4f} ms, whole-tile body {old_ms:.4f} ms, plain "
                  f"{pms:.4f} ms; {chunks} blocks of {-(-bn // chunks)} windows (the d(bias) "
                  "partials)")
            table.append(("8", train_batch, tag, ms, old_ms, pms))
            if gname == "enc_stage0" and shifted:
                stats["window_attention_fused_bwd_tiles"] = dict(
                    ms=old_ms, plain_ms=pms, shape=f"x_windows ({bn},{n},{C}) bf16, nH {nh}, "
                    "shifted (forced)",
                    **bound(tensors_of(w, tiles), attn_flops(bn * n, C, n, backward=True),
                            "bf16"))
            del w, got, tiles, want
            torch.cuda.empty_cache()
    print("  kernels 7, 9 and 8, bf16, ms: A's or 6's body | the whole-tile body | plain")
    for k, b, tag, ms, old_ms, pms in table:
        print(f"    {k} batch {b:2d} {tag:22s} {ms:.4f} | {old_ms:.4f} | {pms:.4f}")
    for k in stats:
        stats[k]["max_abs_err"] = max(errs[k])
    return stats


def _grid_block(name, C, nh, window, shift, gen):
    """A fused Swin block at width ``C`` under ``name`` from a seeded init,
    with non-zero biases and LN affine terms, on the card."""
    from vadcl_tpu_torch.models.layers import init_parameters
    from vadcl_tpu_torch.models.swin import SwinBlock3D

    blk = SwinBlock3D(C, nh, window, shift, fused=True, attn_kernel=name)
    init_parameters(blk, gen)
    with torch.no_grad():
        for p in (blk.attn.qkv_bias, blk.attn.proj_bias, blk.norm1.bias, blk.norm2.bias,
                  blk.mlp.fc1.bias, blk.mlp.fc2.bias):
            p.copy_(0.1 * torch.randn(p.shape, generator=gen))
        blk.attn.relative_position_bias_table.normal_(0.0, 1.0, generator=gen)
    return blk.to(DEV)


@contextlib.contextmanager
def recording_grid_attention():
    """While open, records the first call a Swin block makes to
    ``fold_attention`` or ``fold_attention_packed`` (the unpartitioned route
    of a ``base`` or ``packed`` block): its arguments and output, and, where
    its input wants a gradient, the gradients that reach its output, its
    input, the relative-position bias and the four weights (hooks, removed
    on the way out).  Yields the record, a dict."""
    from vadcl_tpu_torch.models import swin

    rec, handles = {}, []
    real = {k: getattr(swin, k) for k in ("fold_attention", "fold_attention_packed")}

    def keep(key):
        return lambda g: rec.__setitem__(key, g)

    def recorder(fn):
        def call(y, *args, **kw):
            out = fn(y, *args, **kw)
            if not rec:
                rec.update(fn=fn, y=y.detach(), args=args, kw=kw, out=out.detach())
                if y.requires_grad:
                    out.register_hook(keep("dout"))
                    y.register_hook(keep("dy"))
                    args[6].register_hook(keep("dbias"))
                    handles.extend(args[i].register_hook(keep(i)) for i in (2, 3, 4, 5))
            return out
        return call

    for k, fn in real.items():
        setattr(swin, k, recorder(fn))
    try:
        yield rec
    finally:
        for k, fn in real.items():
            setattr(swin, k, fn)
        for h in handles:
            h.remove()


def _grid_attention_vs_plain(tag, rec) -> None:
    """The attention call a block made on the unpartitioned route
    (``recording_grid_attention``) against its plain version on the same
    inputs: the output within kernel 7's bf16 bound and, where gradients
    were recorded, kernel 6's gradients within kernel 8's."""
    from vadcl_tpu_torch.ops import fold_attn as fa

    plain = (fa.fold_attention_packed_plain if rec["fn"] is fa.fold_attention_packed
             else fa.fold_attention_plain)
    args = [a.detach() if torch.is_tensor(a) else a for a in rec["args"]]
    y, shift = rec["y"], rec["kw"]["shift"]
    if rec["kw"]["residual"] or args[0] is not None:
        raise AssertionError(f"{tag}: the unpartitioned route ran LN1 or the residual")
    want = plain(y, *args, False, shift)
    check_close(f"{tag} attention on the unpartitioned tensor vs plain", rec["out"], want,
                *BOUNDS[torch.bfloat16])
    if "dout" in rec:
        _, _, qw, qb, pw, _, bias, mask, nh, window, scale = args
        want = fa.fold_attention_bwd_plain(y, rec["dout"], None, None, qw, qb, pw, bias,
                                           mask, nh, window, scale, shift, False)
        got = (rec["dy"], None, None, rec[2], rec[3], rec[4], rec[5], rec["dbias"])
        check_grads(f"{tag} kernel 6 on the unpartitioned tensor vs plain", FOLD_BWD_NAMES,
                    got, want, BWD_TOL[torch.bfloat16])


def phase_grid_blocks(batch: int = 4) -> dict:
    """bf16 ``base`` and ``packed`` Swin blocks at every 4-frame flagship
    geometry, shifted and not, and at the window-padded 63^2 grid of a 240^2
    clip (60^2 tokens), on ``batch`` clips: the unpartitioned route
    (``fold_attention`` / ``fold_attention_packed`` on the padded tensor,
    counted on 7, 9 and 8: no roll, partition, reverse or roll back)
    against the same block forced down the partitioned route, on the card.
    Each call's launches and ``window_partition`` calls are asserted (the
    unpartitioned route: 7 or 9 and B, under ``base`` with 8 and 5 in the
    backward, no partition; the partitioned one: the same kernels on the
    view, one partition); the forward within kernel 7's bf16 bound (bit for
    bit expected: A's body computes each window alike on either grid),
    ``base``'s gradients of x and of every parameter within kernel 8's (the
    weight sums may run in another order; kernel 6's blocks, one a chunk of
    windows, are printed: a count of windows, alike on both grids); both
    timed.  The attention call of the unpartitioned route's first run, and
    under ``base`` its gradients, are held against their plain versions on
    the inputs the block handed it (``recording_grid_attention``): kernel
    7's and 8's bf16 bounds.  Returns {path: launches} of the
    unpartitioned calls."""
    from vadcl_tpu_torch.models import swin
    from vadcl_tpu_torch.ops import cuda_lib

    print(f"[2/2b] bf16 base and packed blocks without partition copies vs the partitioned "
          f"route, batch {batch}")
    gen = torch.Generator().manual_seed(16)
    bf = torch.bfloat16
    # stage 0 of a 240^2 clip: 60^2 tokens, padded to 63^2 by the block
    geometries = dict(FOLD_GEOMETRIES, padded_60=((2, 60, 60, 96), 6, (2, 7, 7), (0, 3, 3)))
    out = {}
    for gname, ((D, H, W, C), nh, window, shift) in geometries.items():
        for shifted in (False, True):
            sh = shift if shifted else (0, 0, 0)
            x0 = torch.randn(batch, D, H, W, C, generator=gen).to(DEV, bf)
            probe = torch.randn(batch, D, H, W, C, generator=gen).to(DEV)
            for name in ("base", "packed"):
                tag = f"{name} {gname} {'shifted' if shifted else 'plain'}"
                blk = _grid_block(name, C, nh, window, sh, gen)
                train = name == "base"
                attn = "window_attention_packed" if name == "packed" else "window_attention_fused"
                want_moved = {attn: 1, "ln_mlp": 1}
                if train:
                    want_moved.update(window_attention_fused_bwd=1, ln_mlp_bwd=1)

                def run():
                    x = x0.clone().requires_grad_(train)
                    with torch.set_grad_enabled(train):
                        y = blk(x)
                        if train:
                            (y.float() * probe).sum().backward()
                    grads = [x.grad] + [p.grad for p in blk.parameters()] if train else []
                    blk.zero_grad(set_to_none=True)
                    return y.detach(), grads

                results = []
                for grid in (True, False):
                    real = swin.window_grid_route
                    if not grid:
                        swin.window_grid_route = lambda *a, **k: False
                    try:
                        with counting_partitions() as parts, recording_grid_attention() as rec:
                            res, moved = _launched(run)
                        if moved != want_moved or parts[0] != (0 if grid else 1):
                            raise AssertionError(
                                f"{tag} ({'unpartitioned' if grid else 'partitioned'}): "
                                f"launched {moved}, {parts[0]} partitions")
                        if bool(rec) != grid or (train and grid and "dbias" not in rec):
                            raise AssertionError(f"{tag}: the fold wrappers ran {bool(rec)}, "
                                                 f"gradients {sorted(map(str, rec))}")
                        if grid:
                            _grid_attention_vs_plain(tag, rec)
                            del rec
                        ms = cuda_ms(run, reps=2, batch=2, warmup=1)
                    finally:
                        swin.window_grid_route = real
                    results.append((res, ms))
                    if grid:
                        out[f"grid block {tag}"] = moved
                (got, ggrads), ms = results[0]
                (want, wgrads), pms = results[1]
                check_close(f"{tag} forward", got, want, *BOUNDS[bf])
                print(f"  {tag}: forward bit for bit {torch.equal(got, want)}; "
                      f"{'step' if train else 'forward'} {ms:.4f} ms unpartitioned, "
                      f"{pms:.4f} ms partitioned")
                if train:
                    names = ["dx"] + [k for k, _ in blk.named_parameters()]
                    check_grads(f"{tag} gradients", names, ggrads, wgrads,
                                BWD_TOL[bf])
                    dp, hp, wp = (-(-v // w) * w for v, w in zip((D, H, W), window))
                    chunks = cuda_lib.library().vadcl_fold_attn_bwd_bf16_dbias_partials(
                        batch, dp, hp, wp, C, nh, *window)
                    print(f"  {tag}: kernel 6's blocks (d(bias) chunks) {chunks}")
                del blk, results
            torch.cuda.empty_cache()
    return out


def recon_geometries(frame_num: int) -> dict:
    """name: ((D, H, W, C) per clip, heads, runtime window, shift) of the
    flagship's four Swin stages on ``frame_num``-frame reconstruction clips:
    the encoder's token grid has D = frame_num / 2, the decoder's frame_num
    (timedebd doubles it).  At frame_num 8 every window holds 196 or 392
    tokens and runs the row-tiled bodies of kernels 7, 8 and 9."""
    from vadcl_tpu_torch.ops.window import get_window_size

    out = {}
    for name, d, hw, c, nh in (("enc_stage0", frame_num // 2, 56, 96, 6),
                               ("enc_stage1", frame_num // 2, 28, 192, 12),
                               ("dec_stage0", frame_num, 28, 192, 12),
                               ("dec_stage1", frame_num, 56, 96, 6)):
        window, shift = get_window_size((d, hw, hw), (8, 7, 7), (4, 3, 3))
        out[name] = ((d, hw, hw, c), nh, window, shift)
    return out


ROW_WIDTHS = ((96, 6), (192, 12), (96, 3))  # the flagship's, and head width 32


def row_kernels():
    from vadcl_tpu_torch.ops import window_attn as wa

    return (("window_attention_fused_rows", wa.window_attention_fused_rows,
             wa.window_attention_fused_plain),
            ("window_attention_packed_rows", wa.window_attention_packed_rows,
             wa.window_attention_packed_plain))


def _win_case_n(windows, n, C, nh, dtype, gen, masked, n_windows=2, qkv_bias=True):
    """Kernel 7's arguments for ``windows`` windows of ``n`` tokens that no
    window shape need give: ``n_windows`` mask groups of 0 / -100 entries."""
    r = lambda *s: torch.randn(*s, generator=gen).to(DEV)  # noqa: E731
    mask = (torch.rand(n_windows, n, n, generator=gen) < 0.3).float().mul(-100.0).to(DEV)
    return dict(
        x_windows=r(windows, n, C).to(dtype), qkv_w=r(C, 3 * C) / C**0.5,
        qkv_b=0.1 * r(3 * C) if qkv_bias else None, proj_w=r(C, C) / C**0.5,
        proj_b=0.1 * r(C), bias=r(nh, n, n), mask=mask if masked else None, num_heads=nh,
        n_windows=n_windows, scale=(C // nh) ** -0.5,
    )


def phase_row_kernels(batch: int = BATCH_WINDOWS, train_batch: int = 4) -> dict:
    """The row-tiled bodies of kernels 7, 9 (forward) and 8 (backward)
    against their plain versions: at N = 147, 196, 245 and 392 at C = 96 / 6
    heads, 192 / 12 and head width 32, shifted and not, bf16 and fp32, on an
    odd batch of 3 clips; both bodies at the largest N the whole-tile body
    still holds; then the frame-8 path's own shapes (forward at ``batch``
    clips, backward at ``train_batch``), whose numbers go into the kernels
    line, and the backward's workspace.  Returns {kernel: stats}."""
    from vadcl_tpu_torch.ops import cuda_lib
    from vadcl_tpu_torch.ops import window_attn as wa

    gen = torch.Generator().manual_seed(7)
    bwd = ("window_attention_fused_bwd_rows", wa.window_attention_fused_bwd_rows,
           wa.window_attention_fused_bwd_plain)
    errs = {name: [] for name, *_ in row_kernels() + (bwd,)}
    print("[2] row-tiled kernels 7, 9 and [2b] 8 vs plain versions, N 147-392, batch 3")
    for depth in (3, 4, 5, 8):
        for C, nh in ROW_WIDTHS:
            for dtype in (torch.bfloat16, torch.float32):
                for shift in ((0, 0, 0), (0, 3, 3)):
                    a = _win_case_at(3, (depth, 14, 14), C, nh, (depth, 7, 7), shift, dtype, gen)
                    tag = f"N={49 * depth} C={C} nH={nh} shift {shift} {str(dtype)[6:]}"
                    for name, kernel, plain in row_kernels():
                        errs[name].append(check_close(f"{name} {tag}", kernel(**a), plain(**a),
                                                      *BOUNDS[dtype]))
                    w = _win_bwd_case(a, gen)
                    errs[bwd[0]].append(check_grads(f"{bwd[0]} {tag}", WIN_BWD_NAMES,
                                                    bwd[1](**w), bwd[2](**w), BWD_TOL[dtype]))
    print("  both bodies at the largest N the whole-tile body holds:")
    for C, nh in ROW_WIDTHS:
        for dtype in (torch.bfloat16, torch.float32):
            for backward in (False, True):
                n = max(k for k in range(1, 393)
                        if wa.window_body(k, C, nh, dtype, backward) == "tile")
                a = _win_case_n(6, n, C, nh, dtype, gen, masked=True)
                tag = f"N={n} C={C} nH={nh} {str(dtype)[6:]}"
                if backward:
                    w = _win_bwd_case(a, gen)
                    want = bwd[2](**w)
                    check_grads(f"whole-tile kernel 8 {tag}", WIN_BWD_NAMES,
                                wa.window_attention_fused_bwd_tiles(**w), want, BWD_TOL[dtype])
                    check_grads(f"row-tiled kernel 8 {tag}", WIN_BWD_NAMES, bwd[1](**w), want,
                                BWD_TOL[dtype])
                    if wa.window_tile_core(n, C, nh, dtype, backward) == "fold_mma":
                        # the largest window kernel 6's tensor-core body takes
                        check_grads(f"kernel 8 on 6's body {tag}", WIN_BWD_NAMES,
                                    wa.window_attention_fused_bwd(**w), want, BWD_TOL[dtype])
                    continue
                for (name, rows, plain), whole in zip(row_kernels(), (
                        wa.window_attention_fused_tiles, wa.window_attention_packed_tiles)):
                    want = plain(**a)
                    check_close(f"whole-tile {name[:-5]} {tag}", whole(**a), want, *BOUNDS[dtype])
                    check_close(f"row-tiled {name[:-5]} {tag}", rows(**a), want, *BOUNDS[dtype])

    print("  the bf16 forward core's edge cases (windows, N, C / heads, masks; G = windows a "
          "block, 0: the direct layout):")
    smallest = min(k for k in range(1, 393)
                   if wa.window_body(k, 96, 6, torch.bfloat16) == "rows")
    for windows, n, C, nh, nw, masked, qb in (
            (7, 392, 96, 6, 1, False, True),     # nW 1, no mask, odd batch: groups 4 + 3
            (5, 392, 96, 6, 1, True, True),      # one mask for every window: 4 + 1
            (20, 392, 96, 6, 4, True, False),    # 5 windows a mask: 4 + 1, no qkv bias
            (6, 392, 128, 2, 2, True, True),     # head width 64: one window a block
            (6, 196, 128, 2, 2, True, True),     # head width 64 at N 196: two
            (6, 245, 96, 2, 3, True, True),      # head width 48, N % 4 != 0
            (9, 392, 64, 2, 3, True, True),      # head width 32: 3 windows a mask: 2 + 1
            (6, smallest, 96, 6, 2, True, True),  # the smallest N the row-tiled body takes
            (4, 16, 32, 2, 2, True, True),       # one strip, forced
            (4, 441, 128, 2, 2, True, True),     # head width 64 above the staged limit: direct
            (2, 800, 128, 2, 1, True, True),     # the largest N at head width 64: direct
            (2, 2416, 96, 6, 2, False, True),    # the largest N at head width 16: direct
            (3, 833, 32, 2, 3, True, True),      # head width 16 above the staged limit: direct
            (4, 196, 544, 17, 2, True, True),    # C 544: products over two panels of K
            (2, 147, 1040, 65, 2, True, False)):  # C 1040: three panels, no qkv bias
        for name, kernel, plain in row_kernels():
            a = _win_case_n(windows, n, C, nh, torch.bfloat16, gen, masked, nw, qb)
            per = windows // nw if masked else windows
            tag = (f"{windows} windows N={n} C={C} nH={nh} nW={nw} "
                   f"{'masked' if masked else 'no mask'}{'' if qb else ', no qkv bias'} "
                   f"G={wa.rows_group(n, C, nh, per)}")
            got = kernel(**a)
            errs[name].append(check_close(f"{name} {tag}", got, plain(**a),
                                          *BOUNDS[torch.bfloat16]))
            same_bits(f"{name} {tag}", (got,), (kernel(**a),))
            del a, got
    print("  the bf16 backward core's edge cases (G = windows a block, 0: the direct layout, "
          "the body before's footprint, up to its largest N at each head width):")
    smallest = min(k for k in range(1, 393)
                   if wa.window_body(k, 96, 6, torch.bfloat16, backward=True) == "rows")
    for windows, n, C, nh, nw, masked, qb in (
            (12, 196, 96, 6, 4, True, True),     # 3 windows a mask: groups 2 + 1 (cut short)
            (7, 392, 96, 6, 1, False, True),     # no mask, odd batch: groups 4 + 3
            (20, 392, 96, 6, 4, True, False),    # 5 windows a mask: 4 + 1, no qkv bias
            (6, 245, 96, 2, 3, True, True),      # head width 48, N % 4 != 0
            (6, 196, 128, 2, 2, True, True),     # head width 64
            (9, 392, 64, 2, 3, True, True),      # head width 32: 3 windows a mask
            (6, smallest, 96, 6, 2, True, True),  # the smallest N the row-tiled body takes
            (4, 16, 32, 2, 2, True, True),       # one strip, forced
            (4, 539, 32, 2, 2, True, True),      # above N = 512: direct
            (4, 343, 128, 2, 2, True, True),     # head width 64 at N 343: direct
            (2, 1072, 32, 2, 1, True, True),     # the largest N at head width 16: direct
            (2, 640, 64, 2, 1, True, True),      # at 32
            (2, 464, 96, 2, 1, True, True),      # at 48
            (2, 352, 128, 2, 1, True, False)):   # at 64, no qkv bias
        w = _win_bwd_case(_win_case_n(windows, n, C, nh, torch.bfloat16, gen, masked, nw, qb),
                          gen)
        per = windows // nw if masked else windows
        tag = (f"{windows} windows N={n} C={C} nH={nh} nW={nw} "
               f"{'masked' if masked else 'no mask'}{'' if qb else ', no qkv bias'} "
               f"G={wa.rows_bwd_group(n, C, nh, per)}")
        got = bwd[1](**w)
        errs[bwd[0]].append(check_grads(f"{bwd[0]} {tag}", WIN_BWD_NAMES, got, bwd[2](**w),
                                        BWD_TOL[torch.bfloat16]))
        same_bits(f"{bwd[0]} {tag}", got, bwd[1](**w))
        del w, got

    stats = {}
    print(f"  the frame-8 path's shapes, bf16, forward at batch {batch}, backward at batch "
          f"{train_batch}, shifted:")
    for gname, ((D, H, W, C), nh, window, shift) in recon_geometries(RECON_FRAMES).items():
        n = window[0] * window[1] * window[2]
        for name, kernel, plain in row_kernels():
            a = _win_case_at(batch, (D, H, W), C, nh, window, shift, torch.bfloat16, gen)
            out = kernel(**a)
            errs[name].append(check_close(f"{name} {gname}", out, plain(**a),
                                          *BOUNDS[torch.bfloat16]))
            same_bits(f"{name} {gname}", (out,), (kernel(**a),))
            ms, pms = time_pair(lambda: kernel(**a), lambda: plain(**a))
            bn = a["x_windows"].shape[0]
            for tag, args, per in (("shifted", a, bn // a["n_windows"]),
                                   ("unshifted", dict(a, mask=None), bn)):
                split = launch_ms(lambda: kernel(**args))
                print(f"    {tag}: wrapper {cuda_ms(lambda: kernel(**args)):.4f} ms; launches "
                      + ", ".join(f"{k.split('<')[0].split('::')[-1]} {v:.4f}" for k, v in split)
                      + f" ms (G={wa.rows_group(n, C, nh, per)})")
            if gname == "dec_stage1":
                stats[name] = dict(
                    ms=ms, plain_ms=pms, shape=f"x_windows ({a['x_windows'].shape[0]},{n},{C}) "
                    f"bf16, nH {nh}, shifted",
                    **bound(tensors_of(a) + [out],
                            attn_flops(a["x_windows"].shape[0] * n, C, n), "bf16"))
            del a, out
        for shifted in (False, True):
            w = _win_bwd_case(_win_case_at(train_batch, (D, H, W), C, nh, window,
                                           shift if shifted else (0, 0, 0), torch.bfloat16,
                                           gen), gen)
            bn = w["x_windows"].shape[0]
            per = bn // w["n_windows"] if shifted else bn
            tag = f"{gname} {'shifted' if shifted else 'unshifted'}"
            got = bwd[1](**w)
            errs[bwd[0]].append(check_grads(f"{bwd[0]} {tag}", WIN_BWD_NAMES, got, bwd[2](**w),
                                            BWD_TOL[torch.bfloat16]))
            same_bits(f"{bwd[0]} {tag}", got, bwd[1](**w))
            ms, pms = time_pair(lambda: bwd[1](**w), lambda: bwd[2](**w))
            split = launch_ms(lambda: bwd[1](**w))
            print(f"    {tag}: wrapper {ms:.4f} ms; launches "
                  + ", ".join(f"{k.split('<')[0].split('::')[-1]} {v:.4f}" for k, v in split)
                  + f" ms (G={wa.rows_bwd_group(n, C, nh, per)})")
            if gname == "dec_stage1" and shifted:
                stats[bwd[0]] = dict(
                    ms=ms, plain_ms=pms, shape=f"x_windows ({bn},{n},{C}) bf16, nH {nh}, "
                    "shifted",
                    **bound(tensors_of(w, got), attn_flops(bn * n, C, n, backward=True), "bf16"))
            del w, got
            torch.cuda.empty_cache()
    lib = cuda_lib.library()
    for gname, ((D, H, W, C), nh, window, _) in recon_geometries(RECON_FRAMES).items():
        n = window[0] * window[1] * window[2]
        bn = train_batch * (D // window[0]) * (H // window[1]) * (W // window[2])
        ws = lib.vadcl_window_attn_bwd_rows_workspace_bytes(bn, n, C, nh, 1)
        part = lib.vadcl_window_attn_bwd_rows_dbias_bytes(bn, n, nh)
        g = wa.rows_bwd_group(n, C, nh, train_batch)  # shifted: a mask index a clip's window
        groups = (bn // train_batch) * -(-train_batch // g)
        print(f"  row-tiled kernel 8 workspace, bf16, batch {train_batch}, {gname} (N={n}): "
              f"{ws / 1e6:.1f} MB, of it the d(bias) partials {part / 1e6:.1f} MB "
              f"(one per window would be {bn * nh * n * n * 4 / 1e6:.1f} MB); shifted, "
              f"{groups} groups of {g} windows a head over "
              f"{min(groups, part // (nh * n * n * 4))} blocks a head")
    for k in stats:
        stats[k]["max_abs_err"] = max(errs[k])
    return stats


REDUCED_DEPTHS = ((1, 2), (2, 1))  # encoder, decoder: one block per kind of every stage


def flagship_config(attn_kernel: str = "fold", depths=None, image_size: int = 224,
                    predict: bool = True):
    """The shanghaitech model (predict, or with ``predict=False``
    reconstruction) at full width with fused attention and cluster heads;
    ``depths`` cuts (encoder, decoder) depths, ``image_size`` moves the
    spatial cluster head with the input."""
    from vadcl_tpu_torch.core.config import preset

    m = dataclasses.replace(
        preset("shanghaitech").model, predict=predict, fused_attention=True, fused_cluster=True,
        attn_kernel=attn_kernel,
    )
    if depths is not None:
        m = dataclasses.replace(m, encoder_depths=depths[0], decoder_depths=depths[1])
    if image_size != 224:
        m = dataclasses.replace(
            m, cluster=dataclasses.replace(m.cluster, space_size=image_size // 8))
    return m


def phase_model(attn_kernel: str = "fold", depths=None, clips: int = 2, recon: int = 0):
    """The model's outputs, card against CPU; ``recon`` > 0: reconstruction
    mode on clips of that many frames (predict mode on 4 frames otherwise).
    Returns the card's kernel launches."""
    from vadcl_tpu_torch.models import VADModel

    frames = recon or 4
    print(f"[3] flagship model, attn_kernel={attn_kernel}, depths "
          f"{depths or 'full'}, {f'reconstruction, {frames} frames' if recon else 'predict'}, "
          "fp32: card (kernels) vs CPU (plain versions)")
    cpu_model = VADModel(flagship_config(attn_kernel, depths, predict=not recon), torch.float32,
                         torch.Generator().manual_seed(0)).eval()
    gpu_model = copy.deepcopy(cpu_model).cuda()
    clips = torch.rand(clips, frames, 224, 224, 3, generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        t0 = time.perf_counter()
        want = cpu_model(clips)
        t_cpu = time.perf_counter() - t0
        reset_launches()
        with counting_partitions() as parts:
            got = gpu_model(clips.cuda())
            torch.cuda.synchronize()
    from vadcl_tpu_torch.ops import KERNELS

    launches = {k.__name__: k.launches for k in KERNELS}
    launches["window_partition"] = parts[0]
    print(f"  recon {tuple(got.recon.shape)}; CPU forward {t_cpu:.1f} s")
    if tuple(got.recon.shape) != (len(clips), frames if recon else 1, 224, 224, 3) or not bool(
            torch.isfinite(got.recon).all()):
        raise AssertionError("flagship recon has the wrong shape or is not finite")
    check_close("model recon", got.recon.cpu(), want.recon, MODEL_TOL, MODEL_TOL)
    check_close("model cluster_loss", got.cluster_loss.cpu(), want.cluster_loss, 0.0, 1e-4)
    check_close("model space_loss", got.space_loss.cpu(), want.space_loss, 0.0, 1e-4)
    agree = float((got.feature_label.cpu() == want.feature_label).float().mean())
    print(f"  feature labels equal: {agree:.5f}")
    if agree < 0.995:
        raise AssertionError("flagship labels disagree on more than 0.5% of tokens")
    print(f"  kernel launches on the card: {launches}")
    return launches


MODEL_GRAD_TOL = 2e-3  # phase 3b, per tensor: fp32, summation order through ~30 layers


def flagship_train_config(attn_kernel: str = "fold", depths=None, image_size: int = 224,
                          recon: int = 0):
    """The flagship training config; ``recon`` > 0: reconstruction mode on
    clips of that many frames."""
    from vadcl_tpu_torch.core.config import preset

    cfg = preset("shanghaitech")
    if recon:
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, frame_num=recon))
    return cfg.replace(model=flagship_config(attn_kernel, depths, image_size, not recon))


def phase_model_grads(attn_kernel: str = "fold", depths=None, image_size: int = 224,
                      recon: int = 0):
    """Training loss and backward of the flagship model in fp32 with TF32
    off, the card (the forward kernels and their backward kernels) against
    the CPU (plain versions), on one uint8 clip at step 0 with every gate
    on.  At ``image_size`` 240 the 60^2 and 30^2 token grids need window
    padding against the 7x7 windows; ``recon`` > 0: reconstruction mode on
    clips of that many frames."""
    from vadcl_tpu_torch.models import VADModel
    from vadcl_tpu_torch.train.step import make_loss_fn

    print(f"[3b] flagship loss + backward, attn_kernel={attn_kernel}, depths "
          f"{depths or 'full'}, {image_size}^2, "
          f"{f'reconstruction, {recon} frames' if recon else 'predict'}, fp32: card vs CPU")
    cfg = flagship_train_config(attn_kernel, depths, image_size, recon)
    cpu_model = VADModel(cfg.model, torch.float32, torch.Generator().manual_seed(0))
    gpu_model = copy.deepcopy(cpu_model).to(DEV)
    clip = torch.from_numpy(np.random.RandomState(2).randint(
        0, 256, (1, recon or 4, image_size, image_size, 3)).astype(np.uint8))
    t0 = time.perf_counter()
    want, _ = make_loss_fn(cpu_model, cfg)(clip, 0)
    want.backward()
    t_cpu = time.perf_counter() - t0
    reset_launches()
    with counting_partitions() as parts:
        got, _ = make_loss_fn(gpu_model, cfg)(clip.to(DEV), 0)
        got.backward()
        torch.cuda.synchronize()
    from vadcl_tpu_torch.ops import KERNELS

    launches = {k.__name__: k.launches for k in KERNELS}
    launches["window_partition"] = parts[0]
    print(f"  loss card {got.item():.6f} CPU {want.item():.6f}; CPU forward+backward {t_cpu:.1f} s")
    check_close("loss", got.detach().cpu(), want.detach(), 0.0, 1e-4)
    with_grad = [{k for k, p in m.named_parameters() if p.grad is not None}
                 for m in (gpu_model, cpu_model)]
    if with_grad[0] != with_grad[1]:
        raise AssertionError(f"parameters with a gradient differ: card only "
                             f"{sorted(with_grad[0] - with_grad[1])}, CPU only "
                             f"{sorted(with_grad[1] - with_grad[0])}")
    cpu_params = dict(cpu_model.named_parameters())
    worst = ("", 0.0)
    for k, p in gpu_model.named_parameters():
        if p.grad is None:
            continue
        g, w = p.grad.cpu(), cpu_params[k].grad
        err = float((g - w).abs().max())
        ratio = err / (MODEL_GRAD_TOL * float(w.abs().max()) + 1e-12)
        if ratio > worst[1]:
            worst = (k, ratio)
        if not ratio <= 1.0:
            raise AssertionError(f"{k}: gradient max abs err {err} exceeds "
                                 f"{MODEL_GRAD_TOL} * max|CPU grad|")
    print(f"  {len(with_grad[0])} of {len(cpu_params)} parameters have a gradient on both "
          f"sides; worst err/(tol*max) {worst[1]:.3f} at {worst[0]} (tol {MODEL_GRAD_TOL:g})")
    print(f"  kernel launches on the card: {launches}")
    return launches


WIDE_MODEL_TOL = {torch.float32: (1e-4, 2e-3), torch.bfloat16: (2e-2, 1e-1)}
WIDE_MODEL_REQUIRED = {"ln_mlp_tiles", "ln_mlp_bwd_tiles", "cluster_assign"}


def wide_config():
    """The tiny preset fused at ``embed_dim`` 128, encoder heads (4, 8),
    decoder heads (8, 4) (head width 32; C = 128 and 256, the feature head
    256), as ``tests/test_torch_port_widths.py`` holds it against the JAX
    package on the CPU, at its published 56^2."""
    from vadcl_tpu_torch.core.config import preset

    m = preset("tiny").model
    return dataclasses.replace(
        m, embed_dim=128, encoder_heads=(4, 8), decoder_heads=(8, 4), predict=True,
        fused_attention=True, fused_cluster=True, attn_kernel="fold",
        cluster=dataclasses.replace(m.cluster, space_size=56 // 8))


def phase_wide_model(dtype=torch.bfloat16) -> dict:
    """The ``embed_dim`` 128 model's forward, loss (recon . probe + cluster +
    space losses) and every parameter gradient, card against CPU in
    ``dtype``: the kernels at C = 256 (kernel B's CUDA-core body, kernel 5's,
    kernel C's two-part instance) launch, and nothing on the path refuses
    the width.  Bounds (recon atol = rtol, gradients per tensor against
    max|CPU grad|): fp32 1e-4 / 2e-3 (phase 3's: summation order only); bf16
    2e-2 / 1e-1 (both sides round at the same casts, but a different fp32
    order flips single bf16 roundings, which four blocks, the decoder and the
    backward carry).  Returns the launch counts (bf16: the kernels line's
    count for ``ln_mlp_tiles``)."""
    from vadcl_tpu_torch.models import VADModel
    from vadcl_tpu_torch.ops import KERNELS

    name = str(dtype)[6:]
    print(f"[3c] fused tiny model at embed_dim 128 (C = 128 and 256, head width 32), {name}: "
          "forward, loss and gradients, card vs CPU")
    rng = np.random.RandomState(21)
    clip = torch.from_numpy(rng.rand(2, 4, 56, 56, 3).astype(np.float32))
    probe = torch.from_numpy(rng.randn(2, 1, 56, 56, 3).astype(np.float32))
    cpu_model = VADModel(wide_config(), dtype, torch.Generator().manual_seed(21))
    gpu_model = copy.deepcopy(cpu_model).to(DEV)
    atol, gtol = WIDE_MODEL_TOL[dtype]

    def run(model, dev):
        out = model(clip.to(dev))
        loss = (out.recon.float() * probe.to(dev)).sum() + out.cluster_loss + out.space_loss
        loss.backward()
        return out, loss

    want, wloss = run(cpu_model, "cpu")
    reset_launches()
    with plain_versions_refuse_the_card():
        got, gloss = run(gpu_model, DEV)
        torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in KERNELS}
    print(f"  kernel launches on this path: {launches}")
    missing = sorted(k for k in WIDE_MODEL_REQUIRED if launches[k] == 0)
    if missing:
        raise AssertionError(f"wide model: kernels never launched {missing}")
    if tuple(got.recon.shape) != (2, 1, 56, 56, 3) or not bool(torch.isfinite(got.recon).all()):
        raise AssertionError("wide model recon has the wrong shape or is not finite")
    check_close("wide model recon", got.recon.detach().cpu(), want.recon.detach(), atol, atol)
    check_close("wide model loss", gloss.detach().cpu(), wloss.detach(), 0.0, atol)
    cpu_params = dict(cpu_model.named_parameters())
    worst, n = ("", 0.0), 0
    for k, p in gpu_model.named_parameters():
        w = cpu_params[k].grad
        if (p.grad is None) != (w is None):
            raise AssertionError(f"{k}: a gradient on one side only")
        if w is None:
            continue
        n += 1
        err = float((p.grad.float().cpu() - w.float()).abs().max())
        ratio = err / (gtol * float(w.float().abs().max()) + 1e-12)
        worst = max(worst, (k, ratio), key=lambda v: v[1])
        if not ratio <= 1.0:
            raise AssertionError(f"{k}: gradient max abs err {err} exceeds {gtol} * max|CPU grad|")
    print(f"  {n} parameter gradients; worst err/(tol*max) {worst[1]:.3f} at {worst[0]} "
          f"(tol {gtol:g})")
    return launches


# The widths of the embed_dim 24 tiny model (heads (2, 4) / (4, 2)): head
# width 12, which the bf16 tensor-core bodies of 7, 8 and 9 refuse.
NARROW_WIDTHS = ((24, 2), (48, 4))


def phase_narrow_kernels(batch: int = BATCH_WINDOWS, train_batch: int = 4) -> dict:
    """Kernels 7, 9 (forward) and 8 (backward) in bf16 at head width 12 on
    their CUDA-core bodies (window_attn.cu, window_attn_bwd.cu and the
    row-tiled cores' ``<T>`` instances): against their plain versions,
    whole-tile (N = 98) and row-tiled (N = 196, the row-tiled wrappers),
    shifted, each called twice for the same bits, and timed beside the same
    body in fp32 on the same inputs.  Forward at ``batch`` clips' windows,
    backward at ``train_batch``'s.  Returns the kernels line's stats of the
    six instances (C = 48, 4 heads)."""
    from vadcl_tpu_torch.ops import window_attn as wa

    print("[2/2b] kernels 7, 9 and 8 in bf16 at head width 12 (their CUDA-core bodies) vs plain")
    gen = torch.Generator().manual_seed(14)
    stats = {}
    # (the route's wrapper, the counter of its whole-tile body, the row-tiled wrapper, plain)
    fwd = ((wa.window_attention_fused, wa.window_attention_fused_tiles,
            wa.window_attention_fused_rows, wa.window_attention_fused_plain),
           (wa.window_attention_packed, wa.window_attention_packed_tiles,
            wa.window_attention_packed_rows, wa.window_attention_packed_plain))
    for C, nh in NARROW_WIDTHS:
        if wa.window_core(C, nh, torch.bfloat16) != "cuda_core":
            raise AssertionError(f"C={C}/{nh}: not a width of the CUDA-core bodies")
        for rows, window, dhw in ((False, (2, 7, 7), (2, 28, 28)), (True, (4, 7, 7), (4, 28, 28))):
            n = window[0] * window[1] * window[2]
            shift = tuple(w // 2 for w in window)
            for whole, counter, tiled, plain in fwd:
                kernel, counter = (tiled, tiled) if rows else (whole, counter)
                name = f"{counter.__name__} C={C} nH={nh} N={n} shifted bf16"
                a = _win_case_at(batch, dhw, C, nh, window, shift, torch.bfloat16, gen)
                got, moved = _launched(lambda: kernel(**a))
                if moved != {counter.__name__: 1}:
                    raise AssertionError(f"{name}: launched {moved}, not {counter.__name__}")
                e = check_close(name, got, plain(**a), *BOUNDS[torch.bfloat16])
                same_bits(name, [got], [kernel(**a)])
                if C == NARROW_WIDTHS[0][0]:
                    print(f"    launches: {[k for k, _ in launch_ms(lambda: kernel(**a), 2)]}")
                ms, pms = time_pair(lambda: kernel(**a), lambda: plain(**a))
                a32 = dict(a, x_windows=a["x_windows"].float())
                f32_ms = cuda_ms(lambda: kernel(**a32))
                print(f"    the same body in fp32 on the same inputs: {f32_ms:.4f} ms")
                tokens = a["x_windows"].shape[0] * n
                stats[f"{counter.__name__} bf16 CUDA-core"] = dict(
                    max_abs_err=e, ms=ms, plain_ms=pms, fp32_ms=f32_ms,
                    shape=f"x_windows {tuple(a['x_windows'].shape)} bf16, nH {nh}, shifted",
                    **bound(tensors_of(a) + [got], attn_flops(tokens, C, n), "bf16"))
            kernel, counter = ((wa.window_attention_fused_bwd_rows,) * 2 if rows else
                               (wa.window_attention_fused_bwd, wa.window_attention_fused_bwd_tiles))
            name = f"{counter.__name__} C={C} nH={nh} N={n} shifted bf16"
            b = _win_bwd_case(_win_case_at(train_batch, dhw, C, nh, window, shift,
                                           torch.bfloat16, gen), gen)
            got, moved = _launched(lambda: kernel(**b))
            if moved != {counter.__name__: 1}:
                raise AssertionError(f"{name}: launched {moved}, not {counter.__name__}")
            e = check_grads(name, WIN_BWD_NAMES, got, wa.window_attention_fused_bwd_plain(**b),
                            BWD_TOL[torch.bfloat16])
            same_bits(name, got, kernel(**b))
            ms, pms = time_pair(lambda: kernel(**b),
                                lambda: wa.window_attention_fused_bwd_plain(**b))
            b32 = dict(b, x_windows=b["x_windows"].float(), dout=b["dout"].float())
            f32_ms = cuda_ms(lambda: kernel(**b32))
            print(f"    the same body in fp32 on the same inputs: {f32_ms:.4f} ms")
            tokens = b["x_windows"].shape[0] * n
            stats[f"{counter.__name__} bf16 CUDA-core"] = dict(
                max_abs_err=e, ms=ms, plain_ms=pms, fp32_ms=f32_ms,
                shape=f"x_windows {tuple(b['x_windows'].shape)} bf16, nH {nh}, shifted",
                **bound(tensors_of(b, got), attn_flops(tokens, C, n, backward=True), "bf16"))
    return stats


def narrow_config(attn_kernel: str, recon: int = 0):
    """The tiny preset fused at ``embed_dim`` 24 (head width 12 at C = 24
    and 48, hidden 96 and 192), as ``tests/test_torch_port_bf16_widths.py``
    holds it against the JAX package on the CPU; ``recon`` > 0:
    reconstruction mode on clips of that many frames."""
    from vadcl_tpu_torch.core.config import preset

    m = preset("tiny").model
    return dataclasses.replace(
        m, embed_dim=24, predict=not recon, fused_attention=True, fused_cluster=True,
        attn_kernel=attn_kernel, cluster=dataclasses.replace(m.cluster, space_size=56 // 8))


# What the embed_dim 24 model may launch: every Swin block takes kernels 7,
# 8 (or 9) and B, 5 at head width 12 on their CUDA-core bodies, never a fold
# kernel's body (nor kernels 7, 9 and 8 on A's and 6's).
NARROW_FOLD_KERNELS = {"fold_attention", "fold_attention_packed", "fold_block",
                       "fold_block_tiles", "fold_attention_bwd", "fold_attention_bwd_tiles",
                       "fold_block_bwd", "fold_block_bwd_tiles", "window_attention_fused",
                       "window_attention_fused_bwd", "window_attention_packed"}


def phase_narrow_model() -> dict:
    """The ``embed_dim`` 24 model in bf16, card against CPU: under
    ``fold``, ``fold_block`` and ``base`` the forward, the loss (recon .
    probe + cluster + space losses) and every parameter gradient; under
    ``packed`` the forward; in reconstruction on 8-frame clips (N = 196:
    the row-tiled bodies) under ``base`` and ``packed`` the same.  Nothing
    on the path refuses the width, no fold kernel launches, and the
    partitioned-window kernels do, 4 a forward (its 4 Swin blocks).
    Bounds: phase 3c's in bf16 (recon atol = rtol 2e-2, each gradient 1e-1
    of max|CPU grad|).  The CPU side runs torch's own convolutions: oneDNN's
    bf16 convolution backward returns NaN in some runs of this model.
    Returns the launch counts per run."""
    from vadcl_tpu_torch.models import VADModel
    from vadcl_tpu_torch.ops import KERNELS

    print("[3d] fused tiny model at embed_dim 24 (C = 24 and 48, head width 12), bf16: "
          "card vs CPU")
    atol, gtol = WIDE_MODEL_TOL[torch.bfloat16]
    counts = {}
    runs = (("fold", 0, True), ("fold_block", 0, True), ("base", 0, True), ("packed", 0, False),
            ("base", RECON_FRAMES, True), ("packed", RECON_FRAMES, False))
    for attn_kernel, recon, train in runs:
        path = f"narrow model {attn_kernel}" + (", reconstruction" if recon else "")
        rng = np.random.RandomState(24)
        clip = torch.from_numpy(rng.rand(2, recon or 4, 56, 56, 3).astype(np.float32))
        cpu_model = VADModel(narrow_config(attn_kernel, recon), torch.bfloat16,
                             torch.Generator().manual_seed(24))
        gpu_model = copy.deepcopy(cpu_model).to(DEV)

        def run(model, dev):
            out = model(clip.to(dev))
            probe = torch.from_numpy(rng.randn(*out.recon.shape).astype(np.float32)).to(dev)
            loss = (out.recon.float() * probe).sum() + out.cluster_loss + out.space_loss
            if train:
                loss.backward()
            return out, loss

        mkldnn = torch.backends.mkldnn.enabled
        torch.backends.mkldnn.enabled = False
        try:
            rng = np.random.RandomState(25)
            want, wloss = run(cpu_model, "cpu")
        finally:
            torch.backends.mkldnn.enabled = mkldnn
        reset_launches()
        grad = contextlib.nullcontext() if train else torch.no_grad()
        with plain_versions_refuse_the_card(), grad:
            rng = np.random.RandomState(25)
            got, gloss = run(gpu_model, DEV)
            torch.cuda.synchronize()
        launches = {k.__name__: k.launches for k in KERNELS}
        print(f"  {path}: kernel launches {launches}")
        stray = sorted(k for k in NARROW_FOLD_KERNELS if launches[k])
        window = ("window_attention_packed_tiles" if attn_kernel == "packed"
                  else "window_attention_fused_tiles")
        fwd = launches[window] + launches[window.replace("_tiles", "") + "_rows"]
        bwd = (launches["window_attention_fused_bwd_tiles"]
               + launches["window_attention_fused_bwd_rows"])
        if stray or fwd != 4 or bwd != (4 if train else 0):
            raise AssertionError(f"{path}: fold kernels launched {stray}, or not 4 "
                                 f"partitioned-window launches each way ({fwd}, {bwd})")
        if not bool(torch.isfinite(got.recon.float()).all()):
            raise AssertionError(f"{path}: recon is not finite")
        check_close(f"{path} recon", got.recon.detach().cpu(), want.recon.detach(), atol, atol)
        check_close(f"{path} loss", gloss.detach().cpu(), wloss.detach(), 0.0, atol)
        if train:
            cpu_params = dict(cpu_model.named_parameters())
            worst, n = ("", 0.0), 0
            for k, p in gpu_model.named_parameters():
                w = cpu_params[k].grad
                if (p.grad is None) != (w is None):
                    raise AssertionError(f"{k}: a gradient on one side only")
                if w is None:
                    continue
                n += 1
                err = float((p.grad.float().cpu() - w.float()).abs().max())
                ratio = err / (gtol * float(w.float().abs().max()) + 1e-12)
                worst = max(worst, (k, ratio), key=lambda v: v[1])
                if not ratio <= 1.0:
                    raise AssertionError(f"{path} {k}: gradient max abs err {err} exceeds "
                                         f"{gtol} * max|CPU grad|")
            print(f"  {path}: {n} parameter gradients; worst err/(tol*max) {worst[1]:.3f} at "
                  f"{worst[0]} (tol {gtol:g})")
        counts[path] = launches
    return counts


class MemLoader:
    """In-memory uint8 clips with the HostDataLoader protocol; stamps the
    wall clock, after a device synchronize, at every batch request."""

    def __init__(self, batch_size: int, steps: int, seed: int = 0, frames: int = 4,
                 size: int = 224):
        rng = np.random.RandomState(seed)
        self.batch_size, self.steps = batch_size, steps
        self.data = rng.randint(0, 256, (4, batch_size, frames, size, size, 3)).astype(np.uint8)
        self.stamps = []

    def steps_per_epoch(self) -> int:
        return self.steps

    def epoch(self, e, start_iter=0):
        for i in range(start_iter, self.steps):
            torch.cuda.synchronize()
            self.stamps.append(time.perf_counter())
            yield self.data[(e * self.steps + i) % len(self.data)]


TRAIN_BATCH, WARMUP_STEPS, TIMED_STEPS = 4, 2, 8
# The fp32 base and packed models run kernels 7 and 8 (or 9) on their
# whole-tile bodies in each of their 18 blocks, never on A's and 6's, and
# partition the windows of each block (phases 3 and 3b).
FP32_BASE_COUNTS = {
    "model base fp32": {"window_attention_fused_tiles": 18, "window_attention_fused": 0,
                        "window_attention_packed_tiles": 0, "window_partition": 18},
    "model packed fp32": {"window_attention_packed_tiles": 18, "window_attention_packed": 0,
                          "window_attention_fused_tiles": 0, "window_partition": 18},
    "model grads base fp32": {"window_attention_fused_tiles": 18, "window_attention_fused": 0,
                              "window_attention_fused_bwd_tiles": 18,
                              "window_attention_fused_bwd": 0, "window_partition": 18},
}
# The kernels each path must launch; every other kernel of KERNELS must not.
COMMON_FWD = {"ln_mlp", "cluster_assign", "space_cluster_loss"}
SCORING_KERNELS = {
    "fold": COMMON_FWD | {"fold_attention"},
    "base": COMMON_FWD | {"window_attention_fused"},
    "packed": COMMON_FWD | {"window_attention_packed"},
    "fold_packed": COMMON_FWD | {"fold_attention_packed"},
    "fold_mix": COMMON_FWD | {"fold_attention_packed", "fold_attention"},
    "fold_block": {"fold_block", "cluster_assign", "space_cluster_loss"},
}
TRAINING_KERNELS = {
    "fold": SCORING_KERNELS["fold"] | {"ln_mlp_bwd", "fold_attention_bwd"},
    "base": SCORING_KERNELS["base"] | {"ln_mlp_bwd", "window_attention_fused_bwd"},
    "fold_block": SCORING_KERNELS["fold_block"] | {"fold_block_bwd"},
}
# Exact launch counts of the new paths: 18 Swin blocks (12 of them with 12
# heads) a forward, 8 scoring forwards, 10 training steps.
SCORING_COUNTS = {
    "base": {"window_attention_fused": 144, "ln_mlp": 144},
    "packed": {"window_attention_packed": 144, "ln_mlp": 144},
    "fold_packed": {"fold_attention_packed": 144, "ln_mlp": 144},
    "fold_mix": {"fold_attention_packed": 96, "fold_attention": 48, "ln_mlp": 144},
    "fold_block": {"fold_block": 144},
}
TRAINING_COUNTS = {"fold_block": {"fold_block": 180, "fold_block_bwd": 180},
                   "fold": {"fold_attention_bwd": 180, "ln_mlp_bwd": 180},
                   "base": {"window_attention_fused": 180, "window_attention_fused_bwd": 180,
                            "ln_mlp_bwd": 180}}
# Reconstruction at frame_num = 8: every window holds 196 or 392 tokens, so
# all 18 blocks of a forward run a row-tiled body (kernel A stops at 112
# tokens, so a "fold" block takes the partitioned-window route) and the
# whole-tile bodies never launch.  Exact counts: 18 a forward (7 scoring
# forwards of 16 windows), 18 each way a training step (10 steps).
RECON_FRAMES = 8
RECON_SCORING_KERNELS = {
    "fold": COMMON_FWD | {"window_attention_fused_rows"},
    "base": COMMON_FWD | {"window_attention_fused_rows"},
    "packed": COMMON_FWD | {"window_attention_packed_rows"},
}
RECON_TRAINING_KERNELS = {
    k: RECON_SCORING_KERNELS[k] | {"ln_mlp_bwd", "window_attention_fused_bwd_rows"}
    for k in ("fold", "base")
}


@contextlib.contextmanager
def plain_versions_refuse_the_card():
    """While open, the plain version of every attention and MLP kernel raises
    when it is handed a CUDA tensor: the wrappers take them for CPU tensors
    only, so a main-path run that passes shows no kernel of it fell back.
    (The cluster heads' backward recomputes its plain forward by design: the
    JAX custom VJPs recompute in XLA, no Pallas kernel to port.)"""
    from vadcl_tpu_torch.ops import fold_attn, ln_mlp, window_attn

    saved = []
    for mod in (fold_attn, ln_mlp, window_attn):
        for name in [n for n in vars(mod) if n.endswith("_plain")]:
            fn = getattr(mod, name)

            def guard(*args, _fn=fn, _name=name, **kw):
                if any(isinstance(t, torch.Tensor) and t.is_cuda
                       for t in (*args, *kw.values())):
                    raise AssertionError(f"{_name} was called on a CUDA tensor")
                return _fn(*args, **kw)

            saved.append((mod, name, fn))
            setattr(mod, name, guard)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


@contextlib.contextmanager
def counting_partitions():
    """While open, counts the calls of ``vadcl_tpu_torch.models.swin``'s
    ``window_partition`` (a Swin block's partition copy; the bf16 ``base``
    and ``packed`` blocks of 4-frame clips hand kernels A and 6 the
    unpartitioned tensor instead): yields a one-element list."""
    from vadcl_tpu_torch.models import swin

    calls, real = [0], swin.window_partition

    def counted(*args, **kw):
        calls[0] += 1
        return real(*args, **kw)

    swin.window_partition = counted
    try:
        yield calls
    finally:
        swin.window_partition = real


def reset_launches():
    from vadcl_tpu_torch.ops import KERNELS

    for k in KERNELS:
        k.launches = 0


def read_launches(expected, path: str, counts=None, heads: int = 0) -> dict:
    """The launch counts since ``reset_launches``; fails unless exactly the
    ``expected`` kernels launched, the kernels in ``counts`` exactly so many
    times and (with ``heads``) each cluster head ``heads`` times."""
    from vadcl_tpu_torch.ops import KERNELS

    launches = {k.__name__: k.launches for k in KERNELS}
    print(f"  kernel launches on this path: {launches}")
    missing = sorted(k for k in expected if launches[k] == 0)
    stray = sorted(k for k, n in launches.items() if n and k not in expected)
    if missing or stray:
        raise AssertionError(f"{path}: kernels never launched {missing}; kernels that "
                             f"must not launch here but did {stray}")
    want = dict(counts or {})
    if heads:
        want.update(cluster_assign=heads, space_cluster_loss=heads)
    wrong = {k: (launches[k], n) for k, n in want.items() if launches[k] != n}
    if wrong:
        raise AssertionError(f"{path}: launch counts (got, expected) {wrong}")
    return launches


def check_partitions(path: str, calls: int, want: int) -> int:
    """Fails unless a path called ``window_partition`` exactly ``want``
    times: no time on the 4-frame bf16 paths (every route there runs its
    kernels on the unpartitioned tensor), 18 a forward at 8 frames (every
    block partitions its windows for the row-tiled bodies)."""
    print(f"  window_partition calls: {calls}")
    if calls != want:
        raise AssertionError(f"{path}: window_partition called {calls} times, expected {want}")
    return calls


def phase_training(attn_kernel: str = "fold", recon: int = 0):
    """``train()`` on the flagship config in bf16 at batch 4: finite losses,
    moved parameters, exactly this path's kernels launched, and a checkpoint
    that restores params and Adam moments exactly; ``recon`` > 0:
    reconstruction mode on clips of that many frames.  Returns the launch
    counts."""
    from vadcl_tpu_torch.models import VADModel
    from vadcl_tpu_torch.train import CheckpointManager, create_train_state, train

    mode = f"reconstruction, {recon} frames" if recon else "predict"
    print(f"[5] training path, attn_kernel={attn_kernel}, {mode}, bf16: train() at batch "
          f"{TRAIN_BATCH}, {WARMUP_STEPS} warm-up + {TIMED_STEPS} timed steps")
    steps = WARMUP_STEPS + TIMED_STEPS
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(dir=root, prefix=".chip_smoke_train_") as out:
        cfg = flagship_train_config(attn_kernel, recon=recon).replace(
            output_dir=out, batch_size_per_device=TRAIN_BATCH)
        loader = MemLoader(TRAIN_BATCH, steps, frames=recon or 4)
        torch.cuda.reset_peak_memory_stats()
        if recon:
            expected = RECON_TRAINING_KERNELS[attn_kernel]
            counts = {"window_attention_fused_rows": 18 * steps,
                      "window_attention_fused_bwd_rows": 18 * steps,
                      "ln_mlp": 18 * steps, "ln_mlp_bwd": 18 * steps}
        else:
            expected, counts = TRAINING_KERNELS[attn_kernel], TRAINING_COUNTS.get(attn_kernel)
        reset_launches()
        with plain_versions_refuse_the_card(), counting_partitions() as parts:
            state = train(cfg, loader, max_steps=steps, device=DEV)
            torch.cuda.synchronize()
        t_end = time.perf_counter()
        launches = read_launches(expected, f"training, {attn_kernel}, {mode}", counts,
                                 heads=steps)
        launches["window_partition"] = check_partitions(
            f"training, {attn_kernel}, {mode}", parts[0], 18 * steps if recon else 0)
        losses = np.load(os.path.join(out, "loss_record", "loss.npy"))
        wall = t_end - loader.stamps[WARMUP_STEPS]
        print(f"  per-step losses: {[round(float(v), 4) for v in losses]}")
        print(f"  {TIMED_STEPS} steps in {wall:.3f} s = {TIMED_STEPS * TRAIN_BATCH / wall:.2f} "
              f"train clips/s ({wall / TIMED_STEPS * 1e3:.1f} ms/step)")
        print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if state.step != steps or len(losses) != steps or not np.all(np.isfinite(losses)):
            raise AssertionError("training did not run every step with a finite loss")
        init = VADModel(cfg.model, torch.bfloat16, torch.Generator().manual_seed(cfg.seed))
        still = [k for (k, p), (_, q) in zip(state.model.named_parameters(),
                                             init.named_parameters())
                 if torch.equal(p.detach().cpu(), q.detach())]
        if still:
            raise AssertionError(f"parameters that training did not move: {still}")

        mgr = CheckpointManager(os.path.join(out, "ckpt"))
        mgr.save(str(state.step), state, {"epoch": 0, "iter": steps - 1})
        fresh = create_train_state(
            VADModel(cfg.model, torch.bfloat16, torch.Generator().manual_seed(1)).to(DEV), cfg)
        mgr.restore(str(state.step), fresh)
        opt_a, opt_b = state.optimizer.state, fresh.optimizer.state
        for (k, p), (_, q) in zip(state.model.named_parameters(),
                                  fresh.model.named_parameters()):
            same = torch.equal(p, q) and all(
                torch.equal(opt_a[p][s].cpu(), opt_b[q][s].cpu())
                for s in ("step", "exp_avg", "exp_avg_sq"))
            if not same:
                raise AssertionError(f"{k}: checkpoint round trip changed the parameter "
                                     "or its Adam state")
        if fresh.step != state.step:
            raise AssertionError("checkpoint round trip changed the step")
        print(f"  checkpoint round trip: step, {len(opt_a)} parameters and their Adam "
              "moments restored exactly")
    return launches


def phase_training_refused(attn_kernel: str = "packed"):
    """``packed``, ``fold_packed`` and ``fold_mix`` are inference-only:
    building their train step raises before any kernel launches."""
    from vadcl_tpu_torch.models import VADModel
    from vadcl_tpu_torch.train import make_train_step

    cfg = flagship_train_config(attn_kernel)
    model = VADModel(cfg.model, torch.bfloat16, torch.Generator().manual_seed(0)).to(DEV)
    reset_launches()
    try:
        make_train_step(model, cfg, steps_per_epoch=10)
    except ValueError as e:
        print(f"[5] a {attn_kernel} train step is refused: {e}")
    else:
        raise AssertionError(f"make_train_step accepted attn_kernel={attn_kernel!r}")
    read_launches(set(), f"{attn_kernel} train step")


def make_videos(seed: int = 0):
    """Three uint8 videos of ~40 frames at 224^2 in two scenes, each with an
    anomalous span (a bright moving square)."""
    rng = np.random.RandomState(seed)
    videos = []
    for i, (t, scene) in enumerate(((40, "01"), (36, "01"), (44, "02"))):
        base = rng.randint(0, 256, (1, 56, 56, 3)).astype(np.float32)
        base = np.repeat(np.repeat(base, 4, axis=1), 4, axis=2)
        frames = np.empty((t, 224, 224, 3), np.uint8)
        labels = np.zeros(t, np.int64)
        a0, a1 = t // 2, t // 2 + 10
        for f in range(t):
            img = base + rng.randn(224, 224, 3) * 4.0
            if a0 <= f < a1:
                y = 40 + 6 * (f - a0)
                img[y:y + 48, 60:108] = 255.0
                labels[f] = 1
            frames[f] = np.clip(img, 0, 255).astype(np.uint8)
        videos.append((frames, labels, scene))
    return videos


def phase_scoring(attn_kernel: str = "fold", recon: int = 0):
    """``evaluate_videos`` under ``attn_kernel``; ``recon`` > 0:
    reconstruction mode, scoring windows of that many frames (per-window
    MSE of shape (n, recon), one score per frame of each window)."""
    from vadcl_tpu_torch.eval.predict import (
        eval_input_frames, evaluate_videos, make_video_scorer, sliding_windows,
    )
    from vadcl_tpu_torch.models import VADModel

    predict, fn = not recon, recon or 4
    mode = f"reconstruction, {fn} frames" if recon else "predict"
    print(f"[4] scoring path, attn_kernel={attn_kernel}, {mode}, bf16: evaluate_videos on "
          "in-memory uint8 videos")
    model = VADModel(flagship_config(attn_kernel, predict=predict), torch.bfloat16,
                     torch.Generator().manual_seed(0))
    model = model.cuda().eval()
    scorer = make_video_scorer(
        lambda clips: model(clips).recon, frame_num=fn, predict=predict,
        batch_windows=BATCH_WINDOWS, input_frames=eval_input_frames("swin", predict, fn),
        device="cuda",
    )
    videos = make_videos()
    evaluate_videos(scorer, videos[:1], fn, predict)  # warm-up (cuDNN autotune etc.)
    torch.cuda.synchronize()
    n_windows = sum(len(sliding_windows(v[0].shape[0], fn, "stride1")) for v in videos)
    forwards = sum(-(-len(sliding_windows(v[0].shape[0], fn, "stride1")) // BATCH_WINDOWS)
                   for v in videos)
    if recon:
        rows = "window_attention_packed_rows" if attn_kernel == "packed" else \
            "window_attention_fused_rows"
        expected = RECON_SCORING_KERNELS[attn_kernel]
        counts = {rows: 18 * forwards, "ln_mlp": 18 * forwards}
    else:
        expected, counts = SCORING_KERNELS[attn_kernel], SCORING_COUNTS.get(attn_kernel)
    reset_launches()
    t0 = time.perf_counter()
    with plain_versions_refuse_the_card(), counting_partitions() as parts:
        auc, per_scene, per_video = evaluate_videos(scorer, videos, fn, predict, "stride1")
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(expected, f"scoring, {attn_kernel}, {mode}", counts,
                             heads=forwards)
    launches["window_partition"] = check_partitions(
        f"scoring, {attn_kernel}, {mode}", parts[0], 18 * forwards if recon else 0)
    print(f"  {n_windows} windows in {wall:.3f} s = {n_windows / wall:.2f} windows/s; "
          f"mean scene AUC {auc:.4f}; per scene {per_scene}")
    for (frames, _, _), vs in zip(videos, per_video):
        per_window = fn if recon else 1
        if len(vs.scores) != per_window * len(sliding_windows(frames.shape[0], fn, "stride1")) \
                or not np.all(np.isfinite(vs.scores)):
            raise AssertionError("per-video scores have the wrong length or are not finite")
    if not (np.isfinite(auc) and 0.0 <= auc <= 1.0):
        raise AssertionError(f"mean scene AUC {auc} is not a finite probability")
    return launches


DDP_STEPS = 3
# phase 6 holds the data-parallel step against the one-process step on the
# same global batch and weights: the losses to the bf16 kernel bound
# (DDP_LOSS_RTOL), the parameters to the trajectory tests' Adam bound
# (utils/parity.py's check_adam_bound, the key biases apart).
DDP_CHECK_TIMEOUT = 600  # seconds for tools/ddp_check_torch.py's 2 processes
DDP_ZOO_STEPS = 2  # phase 6's convae steps in the group of one
# the reductions a convae step makes over the group: the pixel loss's sum,
# the memory losses' two sums and two counts, the update's sum of
# exponentials and w.T @ q (loss_sums); its two maxima (bank_maxima)
DDP_ZOO_SUMS, DDP_ZOO_MAXIMA = 7, 2


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def counting_data_parallel():
    """While open, counts the loss sums all-reduced in the forward
    (``train.step.global_sum``), the memory bank's maxima all-reduced in
    its update (``train.step.global_max``) and the gradient buckets
    all-reduced by DDP's hook (``train.step._sum_gradients``): yields a
    dict."""
    from vadcl_tpu_torch.train import step

    seen = {"loss_sums": 0, "grad_buckets": 0, "bank_maxima": 0}
    real_sum, real_max, real_hook = step.global_sum, step.global_max, step._sum_gradients

    def counted_sum(t, group=None):
        seen["loss_sums"] += 1
        return real_sum(t, group)

    def counted_max(t, group=None):
        seen["bank_maxima"] += 1
        return real_max(t, group)

    def counted_hook(group, bucket):
        seen["grad_buckets"] += 1
        return real_hook(group, bucket)

    step.global_sum, step.global_max, step._sum_gradients = counted_sum, counted_max, counted_hook
    try:
        yield seen
    finally:
        step.global_sum, step.global_max, step._sum_gradients = real_sum, real_max, real_hook


def train_flops_per_clip(cfg, size: int = 224) -> float:
    """FLOPs of one training step per clip of ``cfg.data.frame_num``
    ``size``^2 frames as ``FlopCounterMode`` counts them (2*M*N*K a
    product, every convolution tap): the plain model (the kernels'
    arithmetic, which the counter cannot see) of ``cfg``'s family on meta
    tensors."""
    from vadcl_tpu_torch.models import VADModel
    from vadcl_tpu_torch.models.backbone import model_input_frames
    from vadcl_tpu_torch.train.step import make_loss_fn
    from vadcl_tpu_torch.utils.flops import counted_flops

    plain = cfg.replace(model=dataclasses.replace(cfg.model, fused_attention=False,
                                                  fused_cluster=False))
    frames = cfg.data.frame_num
    model = VADModel(plain.model, torch.float32, None,
                     model_input_frames(cfg.model.backbone, frames)).to("meta")
    loss_fn = make_loss_fn(model, plain)

    def step():
        clip = torch.zeros(1, frames, size, size, 3, dtype=torch.uint8, device="meta")
        loss, _ = loss_fn(clip, 0)
        loss.backward()

    return counted_flops(step)


@contextlib.contextmanager
def torchrun_env_of_one():
    """While open, the variables torchrun gives a run of one process on
    card 0 (a free localhost port for the rendezvous); the former values
    come back on exit."""
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(_free_port())}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def ddp_check_two_cards(*args: str, control: bool = False, procs: int = 2) -> dict:
    """``tools/ddp_check_torch.py`` under torchrun with ``procs`` processes
    (2 by default), one a card, at global batch 4, with ``args``: its JSON
    line, which must say ok; with ``control`` (``--per-rank-bank``) the bank
    gate must refuse."""
    root = os.path.dirname(os.path.abspath(__file__))
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         str(procs), os.path.join(root, "tools", "ddp_check_torch.py"), "--global-batch", "4",
         "--steps", str(DDP_STEPS), *args] + (["--per-rank-bank"] if control else []),
        capture_output=True, text=True, timeout=DDP_CHECK_TIMEOUT, cwd=root)
    lines = [l for l in out.stdout.splitlines() if l.startswith("{")]
    if (out.returncode != 0) != control or not lines:
        raise AssertionError(f"tools/ddp_check_torch.py {' '.join(args)} on {procs} cards "
                             f"exited {out.returncode}:\n{out.stdout[-3000:]}\n"
                             f"{out.stderr[-3000:]}")
    result = json.loads(lines[-1])
    refused = not result["ok"] and result.get("bank_rows_diff") is None
    if (not result["ok"], refused) != (control, control):
        raise AssertionError(f"tools/ddp_check_torch.py {' '.join(args)} on {procs} cards: "
                             f"{lines[-1]}")
    return result


def phase_ddp(smi: str) -> dict:
    """The flagship ``fold`` train step under ``DistributedDataParallel`` in
    a process group of one process on NCCL, started as a torchrun launch
    starts it (``core.mesh.maybe_initialize_distributed`` from the
    launcher's variables), 3 steps at batch 4, against the one-process
    ``make_train_step`` from the same weights on the same batches; the
    data-parallel run must launch the training path's kernels every step
    (and no plain version on the card), all-reduce the three loss sums a
    step and sum the gradients through the hook.  Prints the step's time
    and FLOP rate beside the card's peak.  Where two or more cards are
    visible, ``tools/ddp_check_torch.py`` then runs as 2 processes at half
    batch each against one process (the train step and the eval), for the
    flagship, for ``convae`` (the bank gated too) and for its control
    (``--per-rank-bank``, which the bank gate must refuse).  Last, in the
    same group of one, ``DDP_ZOO_STEPS`` ``convae`` steps (full
    width, bf16) against the one-process step and the one-process step
    repeated: the losses and bank maxima reduced over NCCL every step,
    the losses and parameters within the same bounds, the bank within the
    bf16 bank bound (``check_bank``: a query sent to another slot only at
    a near tie)."""
    from vadcl_tpu_torch.core.mesh import (
        is_distributed,
        maybe_initialize_distributed,
        process_count,
        shutdown_distributed,
    )
    from vadcl_tpu_torch.models import VADModel
    from vadcl_tpu_torch.train import create_train_state, make_train_step
    from vadcl_tpu_torch.utils.flops import device_peak_tflops, mfu_pct
    from vadcl_tpu_torch.utils.parity import (
        BANK_BOUNDS, DDP_LOSS_RTOL, check_adam_bound, check_bank, recording_bank_updates,
    )

    cards = torch.cuda.device_count()
    print(f"[6] data-parallel training, fold, bf16: {DDP_STEPS} steps at batch {TRAIN_BATCH} "
          f"through DistributedDataParallel, one process on NCCL from torchrun's variables "
          f"({cards} card(s) visible: "
          f"{'then 2 processes at batch 2 each' if cards >= 2 else 'no 2-process run'}), "
          f"against one process")
    cfg = flagship_train_config("fold")
    clips = np.random.RandomState(4).randint(
        0, 256, (DDP_STEPS, TRAIN_BATCH, 4, 224, 224, 3)).astype(np.uint8)
    init = VADModel(cfg.model, torch.bfloat16, torch.Generator().manual_seed(0))

    def run():
        model = copy.deepcopy(init).to(DEV)
        state = create_train_state(model, cfg)
        step_fn = make_train_step(model, cfg, steps_per_epoch=10)
        losses, times = [], []
        for c in clips:
            batch = torch.from_numpy(c).to(DEV)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(step_fn(state, batch).loss))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return model, losses, times

    zoo_cfg = zoo_train_config("convae")
    zoo_clips = np.random.RandomState(7).randint(
        0, 256, (DDP_ZOO_STEPS, TRAIN_BATCH, 4, ZOO_SIZE, ZOO_SIZE, 3)).astype(np.uint8)
    zoo_init = zoo_model(zoo_cfg, torch.bfloat16)

    def run_zoo():
        model = copy.deepcopy(zoo_init).to(DEV)
        state = create_train_state(model, zoo_cfg)
        step_fn = make_train_step(model, zoo_cfg, steps_per_epoch=10)
        with recording_bank_updates() as rec:
            losses = [float(step_fn(state, torch.from_numpy(c).to(DEV)).loss)
                      for c in zoo_clips]
        return model, losses, rec

    ref_model, ref_losses, ref_times = run()
    # the one-process step again: the card's own run-to-run spread (cuDNN's
    # convolution backward may sum in another order from one call to the next)
    again_model, again_losses, again_times = run()
    zoo_ref, zoo_again = run_zoo(), run_zoo()
    with torchrun_env_of_one():
        if not maybe_initialize_distributed("cuda") or process_count() != 1:
            raise AssertionError("maybe_initialize_distributed did not start a group of one")
        try:
            print(f"  process group: {torch.distributed.get_backend()}, world size "
                  f"{process_count()}, card {torch.cuda.current_device()}")
            reset_launches()
            with plain_versions_refuse_the_card(), counting_partitions() as parts, \
                    counting_data_parallel() as seen:
                model, losses, times = run()
            counts = {"fold_attention_bwd": 18 * DDP_STEPS, "ln_mlp_bwd": 18 * DDP_STEPS}
            launches = read_launches(TRAINING_KERNELS["fold"], "data-parallel training, fold",
                                     counts, heads=DDP_STEPS)
            check_partitions("data-parallel training, fold", parts[0], 0)
            reset_launches()
            with plain_versions_refuse_the_card(), counting_data_parallel() as zoo_seen:
                zoo_ddp = run_zoo()
            read_launches(set(), "data-parallel training, convae")
        finally:
            shutdown_distributed()
    if is_distributed():
        raise AssertionError("the process group outlived the phase")
    print(f"  loss sums all-reduced: {seen['loss_sums']}; gradient buckets summed: "
          f"{seen['grad_buckets']}")
    if seen["loss_sums"] != 3 * DDP_STEPS or seen["grad_buckets"] < DDP_STEPS:
        raise AssertionError("the data-parallel step did not all-reduce its loss sums and "
                             "gradients every step")
    print(f"  losses: data-parallel {losses}; one process {ref_losses}, again {again_losses}")
    check_close("one process again, loss", torch.tensor(again_losses), torch.tensor(ref_losses),
                0.0, DDP_LOSS_RTOL)
    check_close("data-parallel loss", torch.tensor(losses), torch.tensor(ref_losses), 0.0,
                DDP_LOSS_RTOL)
    ref = dict(ref_model.named_parameters())
    for label, m in (("one process again", again_model), ("data-parallel", model)):
        b = check_adam_bound(label, dict(m.named_parameters()), ref, cfg.optim.lr, DDP_STEPS)
        print(f"  {label}: {b['same']} of {b['tensors']} parameter tensors bit for bit equal "
              f"to one process; largest difference {b['worst']:.3e} (bound {b['bound']:.3e}), "
              f"at most {b['beyond']:.2%} of a tensor beyond one lr (bound 2%), key biases "
              f"apart")
    flops = train_flops_per_clip(cfg)
    step_s = float(np.median(times[1:]))
    rate = flops * TRAIN_BATCH / step_s
    peak = device_peak_tflops()
    mfu = mfu_pct(rate, peak)
    print(f"  step time (median of steps 2-{DDP_STEPS}, host clock): data-parallel "
          f"{step_s * 1e3:.1f} ms, one process {float(np.median(ref_times[1:])) * 1e3:.1f} ms "
          f"(first run), {float(np.median(again_times[1:])) * 1e3:.1f} ms (again); "
          f"{flops / 1e9:.2f} GFLOP a clip (FlopCounterMode on the plain model) -> "
          f"{rate / 1e12:.2f} TFLOP/s = {mfu if mfu is None else round(mfu, 2)}% of the "
          f"{peak} TFLOP/s bf16 peak [{smi}]")
    if cards >= 2:
        two = ddp_check_two_cards()
        print(f"  2 processes (tools/ddp_check_torch.py, NCCL): losses within "
              f"{two['loss_rel_err']:.3e} of one process (bound {two['loss_bound']}), the same "
              f"parameters on every process, AUC {two['auc']} against one process's "
              f"{two['one_process_auc']}; step ms {two['step_ms']} [{two['card']}]")
        bank = ddp_check_two_cards("--backbone", "convae")
        control = ddp_check_two_cards("--backbone", "convae", control=True)
        print(f"  2 processes, convae: the bank within {bank['bank_rows_diff']:.3e} of one "
              f"process (bound {bank['bank_bound']:g}), {bank['bank_queries_apart']} queries sent "
              f"to another slot; the control (--per-rank-bank) {control['bank_max_diff']:.3e} "
              f"apart, refused [{bank['card']}]")
    else:
        print("  2 processes: not run (one card visible)")
    print(f"  convae, {DDP_ZOO_STEPS} steps at batch {TRAIN_BATCH}, {ZOO_SIZE}^2, bf16: loss sums "
          f"all-reduced {zoo_seen['loss_sums']}, bank maxima all-reduced "
          f"{zoo_seen['bank_maxima']}, gradient buckets summed {zoo_seen['grad_buckets']}")
    if (zoo_seen["loss_sums"] != DDP_ZOO_SUMS * DDP_ZOO_STEPS
            or zoo_seen["bank_maxima"] != DDP_ZOO_MAXIMA * DDP_ZOO_STEPS
            or zoo_seen["grad_buckets"] < DDP_ZOO_STEPS):
        raise AssertionError("the data-parallel convae step did not reduce its losses, its "
                             "bank's update and its gradients over the group every step")
    z_model, z_losses, z_rec = zoo_ddp
    print(f"  convae losses: data-parallel {z_losses}; one process {zoo_ref[1]}, again "
          f"{zoo_again[1]}")
    ref = dict(zoo_ref[0].named_parameters())
    for label, (m, zl, rec) in (("convae, one process again", zoo_again),
                                ("convae, data-parallel", zoo_ddp)):
        check_close(f"{label}, loss", torch.tensor(zl), torch.tensor(zoo_ref[1]), 0.0,
                    DDP_LOSS_RTOL)
        b = check_adam_bound(label, dict(m.named_parameters()), ref, zoo_cfg.optim.lr,
                             DDP_ZOO_STEPS, key_biases_apart=False)
        k = check_bank(f"{label}, bank", m.convae.memory.keys, zoo_ref[0].convae.memory.keys,
                       torch.cat([c["slots"] for c in rec]),
                       torch.cat([c["slots"] for c in zoo_ref[2]]),
                       torch.cat([c["gap"] for c in zoo_ref[2]]), BANK_BOUNDS[torch.bfloat16])
        print(f"  {label}: parameters {b['same']} of {b['tensors']} tensors bit for bit, "
              f"largest difference {b['worst']:.3e} (bound {b['bound']:.3e}); bank rows within "
              f"{k['worst']:.3e} (bound {BANK_BOUNDS[torch.bfloat16][0]:g}), {k['moved']} of "
              f"{sum(len(c['slots']) for c in rec)} queries sent to another slot (largest gap "
              f"{k['gap_apart']:.3e}, tie bound {BANK_BOUNDS[torch.bfloat16][1]:g}), "
              f"{k['rows_apart']} rows left out [{smi}]")
    if not torch.equal(z_model.convae.memory.keys.cpu(), z_rec[-1]["new"]):
        raise AssertionError("the data-parallel convae model does not hold its last update")
    return launches


def phase_autotune(smi: str) -> dict:
    """``measure_attn_kernels``: the attention half of a Swin block at the
    flagship stage-0 geometry under base, packed, fold and fold_packed
    (kernels 7, 9, A and 10 and nothing else, no plain version on the
    card), and both picks."""
    from vadcl_tpu_torch.utils.autotune import measure_attn_kernels, pick_from_times

    print("[7] attention-kernel autotune: B=32, (2, 56, 56, 96), window (2, 7, 7), 6 heads, "
          "bf16, the attention half of a Swin block")
    reset_launches()
    with plain_versions_refuse_the_card(), counting_partitions() as parts:
        times = measure_attn_kernels()
    launches = read_launches({"window_attention_fused", "window_attention_packed",
                              "fold_attention", "fold_attention_packed"}, "autotune")
    check_partitions("autotune", parts[0], 0)
    print(f"  ms a call: {json.dumps({k: v * 1e3 for k, v in times.items()})} [{smi}]")
    picks = {t: pick_from_times(times, t) for t in (False, True)}
    print(f"  pick: {picks[False]}; trainable only: {picks[True]}")
    if picks[True] not in ("base", "fold", "fold_block"):
        raise AssertionError(f"the trainable pick {picks[True]!r} has no backward")
    return launches


def phase_profile() -> dict:
    """``train(profile_steps=1)`` on the flagship ``fold`` config: steps
    [2, 3) traced into ``profile/trace.json``, which must hold the step's
    host ops and name the hand-written kernels."""
    from vadcl_tpu_torch.train import train

    print(f"[8] profiled training, fold, bf16: train(profile_steps=1) at batch {TRAIN_BATCH}")
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(dir=root, prefix=".chip_smoke_profile_") as out:
        cfg = flagship_train_config("fold").replace(output_dir=out,
                                                    batch_size_per_device=TRAIN_BATCH)
        train(cfg, MemLoader(TRAIN_BATCH, 3), max_steps=3, device=DEV, profile_steps=1)
        path = os.path.join(out, "profile", "trace.json")
        size = os.path.getsize(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    ours = [e for e in kernels if "vadcl" in e.get("name", "")]
    busy = sum(e.get("dur", 0) for e in kernels) / 1e3
    print(f"  trace {size} bytes: {len(ops)} host ops, {len(kernels)} device kernels "
          f"({len(ours)} hand-written), {busy:.1f} ms of kernel time")
    if not ops or not ours:
        raise AssertionError("the profiled step's trace holds no host op or no hand-written "
                             "kernel")
    return {"trace_bytes": size, "kernels": len(kernels), "vadcl_kernels": len(ours)}


ZOO_BACKBONES = ("unet3d", "convae", "convae_predict")
ZOO_SIZE = 224  # the shanghaitech preset's frames
ZOO_CHECK_BATCH, ZOO_CHECK_STEPS = 2, 2  # phase 9's fp32 steps, card against CPU
ZOO_BATCH, ZOO_STEPS = 4, 5  # its bf16 train() run: steps 0-1 warm up, 2 traced, 3-4 timed


def _round(v, digits: int = 2):
    return v if v is None else round(v, digits)


def zoo_train_config(backbone: str):
    """The shanghaitech preset (224^2, frame_num 4) with ``backbone``: UNet3D
    at channels 64-1024, ConvAE at 64-512 with a bank of 10 x 512."""
    from vadcl_tpu_torch.core.config import preset

    cfg = preset("shanghaitech")
    return cfg.replace(model=dataclasses.replace(cfg.model, backbone=backbone),
                       data=dataclasses.replace(cfg.data, image_size=(ZOO_SIZE, ZOO_SIZE)))


def zoo_model(cfg, dtype, seed: int = 0):
    from vadcl_tpu_torch.models import VADModel
    from vadcl_tpu_torch.models.backbone import model_input_frames

    return VADModel(cfg.model, dtype, torch.Generator().manual_seed(seed),
                    model_input_frames(cfg.model.backbone, cfg.data.frame_num))


def phase_zoo_check(backbone: str) -> dict:
    """``make_train_step`` of ``backbone`` in fp32 with TF32 off, the card
    against the CPU, ``ZOO_CHECK_STEPS`` steps at batch ``ZOO_CHECK_BATCH``
    on uint8 224^2 clips, each step from the same state (the CPU model and
    optimizer take the card's after a step): every loss term within
    ``FP32_LOSS_RTOL``, every parameter within the Adam bound, and a memory
    family's bank (``check_bank``: a query may take another top-1 slot only
    at a near tie, whose two rows are left out) against the CPU's update of
    the CPU's inputs and against the plain update of the card's own
    inputs.  No hand-written kernel launches on these paths."""
    from vadcl_tpu_torch.models.backbone import MEMORY_BACKBONES
    from vadcl_tpu_torch.ops.memory import memory_update
    from vadcl_tpu_torch.train import create_train_state, make_train_step
    from vadcl_tpu_torch.utils.parity import (
        FP32_LOSS_RTOL, check_adam_bound, check_bank, recording_bank_updates, top1_slots,
    )

    cfg = zoo_train_config(backbone)
    print(f"[9] {backbone}: {ZOO_CHECK_STEPS} train steps at batch {ZOO_CHECK_BATCH}, "
          f"{ZOO_SIZE}^2, fp32, TF32 off: card vs CPU, each step from the same state")
    cpu_model = zoo_model(cfg, torch.float32)
    gpu_model = copy.deepcopy(cpu_model).to(DEV)
    cpu_state, gpu_state = create_train_state(cpu_model, cfg), create_train_state(gpu_model, cfg)
    cpu_step, gpu_step = (make_train_step(m, cfg, steps_per_epoch=10)
                          for m in (cpu_model, gpu_model))
    clips = np.random.RandomState(5).randint(
        0, 256, (ZOO_CHECK_STEPS, ZOO_CHECK_BATCH, cfg.data.frame_num, ZOO_SIZE, ZOO_SIZE, 3)
    ).astype(np.uint8)
    memory = backbone in MEMORY_BACKBONES
    reset_launches()
    out = {}
    for i, clip in enumerate(clips):
        if i:  # the same state on both sides
            cpu_model.load_state_dict(gpu_model.state_dict())
            cpu_state.optimizer.load_state_dict(gpu_state.optimizer.state_dict())
        with recording_bank_updates() as rec:
            t0 = time.perf_counter()
            mc = cpu_step(cpu_state, torch.from_numpy(clip))
            t_cpu = time.perf_counter() - t0
            with plain_versions_refuse_the_card():
                mg = gpu_step(gpu_state, torch.from_numpy(clip).to(DEV))
            torch.cuda.synchronize()
        terms = ("loss", "loss_pixel", "cluster_loss", "space_loss")
        got = torch.tensor([float(getattr(mg, t)) for t in terms])
        want = torch.tensor([float(getattr(mc, t)) for t in terms])
        print(f"  step {i + 1}: losses card {got.tolist()} CPU {want.tolist()}; CPU step "
              f"{t_cpu:.1f} s")
        # (atol: unet3d's memory-loss slots are 0 on both sides)
        check_close(f"{backbone} step {i + 1} losses", got, want, 1e-9, FP32_LOSS_RTOL)
        b = check_adam_bound(f"{backbone} step {i + 1}",
                             {k: p.detach().cpu() for k, p in gpu_model.named_parameters()},
                             dict(cpu_model.named_parameters()), cfg.optim.lr, 1)
        print(f"  parameters: {b['same']} of {b['tensors']} tensors bit for bit, largest "
              f"difference {b['worst']:.3e} (bound {b['bound']:.3e}), at most "
              f"{b['beyond']:.2%} of a tensor beyond one lr")
        if memory:
            cpu_call, gpu_call = rec
            own = memory_update(gpu_call["query"], gpu_call["keys"])
            own_slots, own_gap = top1_slots(gpu_call["query"], gpu_call["keys"])
            a = check_bank(f"{backbone} step {i + 1}, the update of the card's inputs",
                           gpu_call["new"], own, gpu_call["slots"], own_slots, own_gap)
            c = check_bank(f"{backbone} step {i + 1}, card against CPU", gpu_call["new"],
                           cpu_call["new"], gpu_call["slots"], cpu_call["slots"],
                           cpu_call["gap"])
            bank = gpu_model.convae.memory.keys
            norm_err = float((bank.norm(dim=1) - 1).abs().max())
            print(f"  bank: against the plain update of the card's inputs {a['worst']:.3e} "
                  f"({a['moved']} queries apart); against the CPU's {c['worst']:.3e} "
                  f"({c['moved']} of {len(gpu_call['slots'])} queries at near ties, "
                  f"{c['rows_apart']} rows left out); | |row| - 1 | <= {norm_err:.1e}")
            if not torch.equal(bank.cpu(), gpu_call["new"]) or norm_err > 1e-5:
                raise AssertionError(f"{backbone}: the bank is not the update's, or not unit")
            out[f"step {i + 1} queries apart"] = c["moved"]
    read_launches(set(), f"{backbone} train step, fp32")
    return out


def phase_zoo_train(backbone: str, smi: str):
    """``train()`` of ``backbone`` in the card's compute dtype (bf16) at
    batch ``ZOO_BATCH`` for ``ZOO_STEPS`` steps, step 2 traced by
    ``profile_steps``: finite losses, moved parameters, unit-norm bank
    rows, a checkpoint round trip (the bank included); prints the host-clock
    ms of steps 3-4 and the traced step's device-busy ms, and the step's
    FLOPs (``train_flops_per_clip``) over each, beside the bf16 peak.
    Returns the trained model (in train mode, as ``train()`` leaves it)."""
    from vadcl_tpu_torch.models.backbone import MEMORY_BACKBONES
    from vadcl_tpu_torch.train import CheckpointManager, create_train_state, train
    from vadcl_tpu_torch.utils.flops import device_peak_tflops, mfu_pct

    print(f"[9] {backbone}: train() at batch {ZOO_BATCH}, bf16, {ZOO_STEPS} steps")
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(dir=root, prefix=".chip_smoke_zoo_") as out:
        cfg = zoo_train_config(backbone).replace(output_dir=out, batch_size_per_device=ZOO_BATCH)
        loader = MemLoader(ZOO_BATCH, ZOO_STEPS, frames=cfg.data.frame_num, size=ZOO_SIZE)
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        with plain_versions_refuse_the_card():
            state = train(cfg, loader, max_steps=ZOO_STEPS, device=DEV, profile_steps=1)
            torch.cuda.synchronize()
        t_end = time.perf_counter()
        read_launches(set(), f"{backbone} train(), bf16")
        losses = np.load(os.path.join(out, "loss_record", "loss.npy"))
        with open(os.path.join(out, "profile", "trace.json")) as f:
            events = json.load(f)["traceEvents"]
        busy = sum(e.get("dur", 0) for e in events if e.get("cat") == "kernel") / 1e3
        step_ms = (t_end - loader.stamps[3]) / (ZOO_STEPS - 3) * 1e3
        print(f"  losses {[round(float(v), 4) for v in losses]}")
        print(f"  {step_ms:.1f} ms a step (host clock, steps 3-4), traced step 2: {busy:.1f} ms "
              f"device busy; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{smi}]")
        clip_flops = train_flops_per_clip(cfg, ZOO_SIZE)
        peak = device_peak_tflops()
        rates = {"busy": clip_flops * ZOO_BATCH / (busy / 1e3),
                 "host": clip_flops * ZOO_BATCH / (step_ms / 1e3)}
        print(f"  {clip_flops / 1e9:.1f} GFLOP a clip (FlopCounterMode on meta tensors), "
              f"{clip_flops * ZOO_BATCH / 1e12:.3f} TFLOP a step: "
              + "; ".join(f"{r / 1e12:.1f} TFLOP/s over the {k} ms = "
                          f"{_round(mfu_pct(r, peak))}% of the {peak} TFLOP/s bf16 peak"
                          for k, r in rates.items()) + f" [{smi}]")
        if state.step != ZOO_STEPS or len(losses) != ZOO_STEPS or not np.all(np.isfinite(losses)):
            raise AssertionError(f"{backbone}: training did not run every step with a finite loss")
        init = zoo_model(cfg, torch.bfloat16, cfg.seed)
        still = [k for (k, p), (_, q) in zip(state.model.named_parameters(),
                                             init.named_parameters())
                 if torch.equal(p.detach().cpu(), q.detach())]
        if still:
            raise AssertionError(f"{backbone}: parameters that training did not move: {still}")
        mgr = CheckpointManager(os.path.join(out, "ckpt"))
        mgr.save(str(state.step), state, {"epoch": 0, "iter": ZOO_STEPS - 1})
        fresh = create_train_state(zoo_model(cfg, torch.bfloat16, 1).to(DEV), cfg)
        mgr.restore(str(state.step), fresh)
        for (k, a), b in zip(state.model.state_dict().items(), fresh.model.state_dict().values()):
            if not torch.equal(a, b):
                raise AssertionError(f"{backbone}: checkpoint round trip changed {k}")
        if cfg.model.backbone in MEMORY_BACKBONES:
            bank = state.model.convae.memory.keys
            norm_err = float((bank.norm(dim=1) - 1).abs().max())
            moved = float((bank.cpu() - init.convae.memory.keys).abs().max())
            print(f"  bank: | |row| - 1 | <= {norm_err:.1e}, moved {moved:.3e} from its init; "
                  "restored bit for bit")
            if norm_err > 1e-5 or moved == 0.0:
                raise AssertionError(f"{backbone}: the bank's rows are not unit, or it never moved")
    return state.model, {"step_ms": step_ms, "busy_ms": busy, "gflop_per_clip": clip_flops / 1e9,
                         "busy_peak_pct": mfu_pct(rates["busy"], peak)}


def phase_zoo_scoring(backbone: str, model, smi: str) -> dict:
    """``evaluate_videos`` of two synthetic 224^2 videos with the model
    ``train()`` left (train mode, bf16), twice: the bank bit for bit the
    same after both, the two scorings' scores equal; windows/s of the
    second."""
    from vadcl_tpu_torch.eval.predict import (
        eval_input_frames, evaluate_videos, make_video_scorer, sliding_windows,
    )
    from vadcl_tpu_torch.models.backbone import MEMORY_BACKBONES, predicts

    cfg = model.config
    predict = predicts(cfg)
    print(f"[9] {backbone}: scoring, {'predict' if predict else 'reconstruction'}, bf16, the "
          "model in train mode")
    scorer = make_video_scorer(lambda c: model(c).recon, frame_num=4, predict=predict,
                               batch_windows=BATCH_WINDOWS,
                               input_frames=eval_input_frames(cfg.backbone, predict, 4),
                               device=DEV)
    videos = make_videos()[:2]
    memory = cfg.backbone in MEMORY_BACKBONES
    before = model.convae.memory.keys.clone() if memory else None
    reset_launches()
    with plain_versions_refuse_the_card():
        first = evaluate_videos(scorer, videos, 4, predict)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        auc, _, per_video = evaluate_videos(scorer, videos, 4, predict)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    read_launches(set(), f"{backbone} scoring")
    n = sum(len(sliding_windows(v[0].shape[0], 4, "stride1")) for v in videos)
    for a, b in zip(first[2], per_video):
        if not (np.all(np.isfinite(b.scores)) and np.allclose(a.scores, b.scores, rtol=0,
                                                                atol=1e-6)):
            raise AssertionError(f"{backbone}: two scorings disagree or are not finite")
    if memory and not torch.equal(model.convae.memory.keys, before):
        raise AssertionError(f"{backbone}: scoring moved the memory bank")
    print(f"  {n} windows in {wall:.3f} s = {n / wall:.2f} windows/s; mean scene AUC {auc:.4f}; "
          f"two scorings agree{'; the bank unmoved' if memory else ''} [{smi}]")
    return {"windows_per_s": n / wall}


def phase_zoo(smi: str) -> dict:
    """Phase 9: the alternate families at full width."""
    out = {}
    for backbone in ZOO_BACKBONES:
        out[backbone] = phase_zoo_check(backbone)
        model, times = phase_zoo_train(backbone, smi)
        out[backbone].update(times)
        out[backbone].update(phase_zoo_scoring(backbone, model, smi))
        del model
        torch.cuda.empty_cache()
    return out


EXPORT_BATCH = 16  # the scoring path's batch: the artifact's static batch
EXPORT_TIMEOUT = 600  # seconds for the loading process of one artifact
# a forward of the flagship artifact: one launch a Swin block on the route's
# attention counter and on kernel B's, one of each cluster kernel
EXPORT_COUNTS = {
    "fold": {"fold_attention": 18, "ln_mlp": 18, "cluster_assign": 1, "space_cluster_loss": 1},
    "base": {"window_attention_fused": 18, "ln_mlp": 18, "cluster_assign": 1,
             "space_cluster_loss": 1},
}
EXPORT_OPS = ["vadcl.cluster_assign.default", "vadcl.fold_attention.default",
              "vadcl.ln_mlp.default", "vadcl.space_cluster_loss.default"]
# The loading process: the artifact alone, no model code.  Scores the
# windows, counts a call's launches, checks two calls for the same bits and
# traces one call.
SERVE_RUNNER = r"""
import json, sys, time
import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile
from vadcl_tpu_torch.serve import load_artifact
from vadcl_tpu_torch.ops import KERNELS
path, windows_path, out_path = sys.argv[1:4]
art = load_artifact(path)
models = sorted(k for k in sys.modules if k.startswith("vadcl_tpu_torch.models"))
w = torch.from_numpy(np.load(windows_path)).cuda()
art.score(w)
torch.cuda.synchronize()
for k in KERNELS:
    k.launches = 0
got = art.score(w)
torch.cuda.synchronize()
launches = {k.__name__: k.launches for k in KERNELS}
same = bool(torch.equal(got, art.score(w)))
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    art.score(w)
    torch.cuda.synchronize()
events = prof.events()
busy = sum(e.device_time_total for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
host_ops = sum(e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith("aten::")
               for e in events)
json.dump(dict(scores=got.float().cpu().tolist(), launches=launches, same_bits=same,
               busy_ms=busy, host_ops=host_ops, models=models), open(out_path, "w"))
"""


def traced_call(fn) -> tuple:
    """(device-busy ms, host ``aten::`` ops) of one call of ``fn``: the sum
    of the durations of the device work the profiler traced in it, and the
    ATen operators the host dispatched."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):  # (a trace now and then comes back empty: read again)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = prof.events()
        busy = sum(e.device_time_total for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        host_ops = sum(e.device_type == torch.autograd.DeviceType.CPU
                       and e.name.startswith("aten::") for e in events)
        if busy > 0:
            return busy, host_ops
    raise AssertionError("the profiler traced no device work")


def phase_export(smi: str) -> dict:
    """The serving export at full width: the flagship scorer (shanghaitech,
    224^2, 4-frame predict, bf16) under ``fold`` and ``base`` exported by
    ``export_window_scorer`` at batch 16 and saved; a second process loads
    it (importing nothing of ``vadcl_tpu_torch.models``) and scores the
    same uint8 windows as the live scorer, within the bf16 score bound
    (``utils/parity.py``); a call of the loaded program launches one
    attention kernel and one kernel B a block and each cluster kernel once,
    and nothing else; two calls give the same bits.  Then, in this
    process, the artifact and the live scorer in turns (live, artifact,
    artifact, live; ``cuda_ms`` each: back-to-back calls, so the slower of
    host and device is read); windows/s of each, and the device-busy ms and
    host aten ops of one traced call of each."""
    from vadcl_tpu_torch.eval.predict import window_score_fn
    from vadcl_tpu_torch.models import VADModel
    from vadcl_tpu_torch.serve import export_window_scorer, load_artifact, save_artifact
    from vadcl_tpu_torch.utils.parity import score_bound

    out = {}
    root = os.path.dirname(os.path.abspath(__file__))
    windows = np.random.RandomState(3).randint(
        0, 256, (EXPORT_BATCH, 4, 224, 224, 3)).astype(np.uint8)
    for kernel in ("fold", "base"):
        print(f"[10] serving export, attn_kernel={kernel}, bf16: export_window_scorer at "
              f"batch {EXPORT_BATCH}, loaded in a process without the model code")
        model = VADModel(flagship_config(kernel), torch.bfloat16,
                         torch.Generator().manual_seed(0)).cuda().eval()
        live = window_score_fn(lambda clips: model(clips).recon, True, input_frames=4)
        w = torch.from_numpy(windows).cuda()
        with torch.no_grad():
            want = live(w).float().cpu().numpy()
            live_busy, live_ops = traced_call(lambda: live(w))
        t0 = time.perf_counter()
        program, meta = export_window_scorer(model, batch_windows=EXPORT_BATCH, frame_num=4,
                                             image_size=(224, 224), predict=True,
                                             input_frames=4)
        export_s = time.perf_counter() - t0
        if meta["ops"] != EXPORT_OPS:
            raise AssertionError(f"export, {kernel}: the graph's kernel ops {meta['ops']}")
        with tempfile.TemporaryDirectory(dir=root, prefix=".chip_smoke_export_") as tmp:
            path = os.path.join(tmp, "artifact")
            save_artifact(path, program, meta)
            size = os.path.getsize(os.path.join(path, "scorer.pt2"))
            np.save(os.path.join(tmp, "windows.npy"), windows)
            res_path = os.path.join(tmp, "result.json")
            t0 = time.perf_counter()
            run = subprocess.run(
                [sys.executable, "-c", SERVE_RUNNER, path, os.path.join(tmp, "windows.npy"),
                 res_path], capture_output=True, text=True, timeout=EXPORT_TIMEOUT, cwd=root)
            load_s = time.perf_counter() - t0
            if run.returncode != 0:
                raise AssertionError(f"export, {kernel}: the loading process exited "
                                     f"{run.returncode}:\n{run.stderr[-3000:]}")
            with open(res_path) as f:
                res = json.load(f)
            art = load_artifact(path)
        turns = {"live": [], "artifact": []}
        with torch.no_grad():
            for who in ("live", "artifact", "artifact", "live"):
                fn = (lambda: live(w)) if who == "live" else (lambda: art.score(w))
                turns[who].append(cuda_ms(fn))
        got = np.asarray(res["scores"], np.float32)
        err = float(np.max(np.abs(got - want)))
        limit = score_bound(want, torch.bfloat16)
        print(f"  exported in {export_s:.1f} s, {size / 1e6:.1f} MB; loading process "
              f"{load_s:.1f} s; scores max |artifact - live| = {err:.3e} (bound {limit:.3e}); "
              f"two artifact calls same bits: {res['same_bits']}")
        nonzero = {k: n for k, n in res["launches"].items() if n}
        print(f"  launches of one artifact call: {nonzero}")
        if res["models"]:
            raise AssertionError(f"export, {kernel}: the loading process imported {res['models']}")
        if not err <= limit or not np.all(np.isfinite(got)):
            raise AssertionError(f"export, {kernel}: artifact scores disagree with the live "
                                 "scorer")
        if nonzero != EXPORT_COUNTS[kernel]:
            raise AssertionError(f"export, {kernel}: launches {nonzero}, expected "
                                 f"{EXPORT_COUNTS[kernel]}")
        if not res["same_bits"]:
            raise AssertionError(f"export, {kernel}: two artifact calls differ")
        for who, ms in turns.items():
            print(f"  {who}: {', '.join(f'{EXPORT_BATCH / t * 1e3:.1f}' for t in ms)} windows/s "
                  f"({', '.join(f'{t:.2f}' for t in ms)} ms a call, CUDA events around 5 calls "
                  "back to back)")
        print(f"  one traced call: artifact {res['busy_ms']:.2f} ms device busy, "
              f"{res['host_ops']} host aten ops (in the loading process); live "
              f"{live_busy:.2f} ms, {live_ops} ops [{smi}]")
        out[kernel] = dict(turns, busy_ms=res["busy_ms"], live_busy_ms=live_busy,
                           max_abs_err=err)
        del model, program, art
        torch.cuda.empty_cache()
    return out


DROP_RATES = dict(drop_rate=0.1, drop_path_rate=0.2)
DROP_STEPS = 2
# A step that draws masks: the attention kernel without LN and residual
# forward and backward in every block (A and 6 under fold; 7 and 8, on A's
# and 6's bodies, under base), C and D; no kernel B or 5, no whole-block
# kernel (the JAX block's deterministic=False routes).
DROP_KERNELS = {
    "fold": {"fold_attention", "fold_attention_bwd", "cluster_assign", "space_cluster_loss"},
    "base": {"window_attention_fused", "window_attention_fused_bwd", "cluster_assign",
             "space_cluster_loss"},
}
DROP_TIMED_STEPS = 5


def _drop_config(kernel: str, depths=None, **model):
    cfg = flagship_train_config(kernel, depths)
    return cfg.replace(model=dataclasses.replace(cfg.model, **DROP_RATES, **model))


def _loss_grads(model, cfg, clip, step: int = 0):
    from vadcl_tpu_torch.train.step import make_loss_fn

    model.train()
    model.zero_grad(set_to_none=True)
    loss, _ = make_loss_fn(model, cfg)(clip, step)
    loss.backward()
    torch.cuda.synchronize()
    return loss.detach(), {k: p.grad.detach().clone() for k, p in model.named_parameters()
                           if p.grad is not None}


def _step_times(cfg, dtype) -> tuple:
    """(host-clock ms a step over ``DROP_TIMED_STEPS`` untraced steps,
    device-busy ms and host aten ops of one traced step) of
    ``make_train_step`` at batch 4."""
    from vadcl_tpu_torch.models import VADModel
    from vadcl_tpu_torch.train import create_train_state, make_train_step

    model = VADModel(cfg.model, dtype, torch.Generator().manual_seed(0)).to(DEV).train()
    state = create_train_state(model, cfg)
    step_fn = make_train_step(model, cfg, steps_per_epoch=100)
    clips = torch.from_numpy(MemLoader(TRAIN_BATCH, 1).data[0]).to(DEV)
    for _ in range(2):
        step_fn(state, clips)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DROP_TIMED_STEPS):
        step_fn(state, clips)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / DROP_TIMED_STEPS * 1e3
    return (step_ms, *traced_call(lambda: step_fn(state, clips)))


def phase_dropout(smi: str) -> dict:
    """The train-step leftovers at full width (shanghaitech, 224^2, 4-frame
    predict): ``train()`` 2 steps at batch 4 in bf16 under ``fold`` and
    ``base`` with ``drop_rate`` 0.1 and ``drop_path_rate`` 0.2, exactly
    the stochastic route's kernels launched (no kernel B or 5, no
    whole-block kernel); the fused step against the plain-attention model
    with the same masks in fp32 (loss to 1e-4, each gradient to phase 3b's
    bound); ``remat`` on against off in bf16 with masks drawn (each
    gradient to the bf16 bound); one LARS step on the card's gradients
    against the plain update in float64; the host-clock and device-busy ms
    of the dropout step beside the rate-0 step's."""
    from vadcl_tpu_torch.models import VADModel
    from vadcl_tpu_torch.models.layers import (
        DROPOUT_SEED_OFFSET,
        DropKeys,
        drop_keys,
        keep_mask,
    )
    from vadcl_tpu_torch.train import Lars, train

    out = {}
    root = os.path.dirname(os.path.abspath(__file__))
    for kernel in ("fold", "base"):
        print(f"[11] dropout {DROP_RATES['drop_rate']} and drop-path "
              f"{DROP_RATES['drop_path_rate']}, attn_kernel={kernel}, bf16: train() at batch "
              f"{TRAIN_BATCH}, {DROP_STEPS} steps")
        with tempfile.TemporaryDirectory(dir=root, prefix=".chip_smoke_drop_") as tmp:
            cfg = _drop_config(kernel).replace(output_dir=tmp, batch_size_per_device=TRAIN_BATCH)
            reset_launches()
            with plain_versions_refuse_the_card(), counting_partitions() as parts:
                state = train(cfg, MemLoader(TRAIN_BATCH, DROP_STEPS), max_steps=DROP_STEPS,
                              device=DEV)
                torch.cuda.synchronize()
            attn = sorted(DROP_KERNELS[kernel] - {"cluster_assign", "space_cluster_loss"})
            out[f"dropout training {kernel}"] = read_launches(
                DROP_KERNELS[kernel], f"dropout training, {kernel}",
                {k: 18 * DROP_STEPS for k in attn}, heads=DROP_STEPS)
            check_partitions(f"dropout training, {kernel}", parts[0], 0)
            losses = np.load(os.path.join(tmp, "loss_record", "loss.npy"))
            print(f"  losses {[round(float(v), 4) for v in losses]}")
            if state.step != DROP_STEPS or not np.all(np.isfinite(losses)):
                raise AssertionError(f"dropout training, {kernel}: a step did not run or its "
                                     "loss is not finite")
        del state

        print(f"[11] the {kernel} step with masks drawn against the plain-attention model, "
              "fp32, the same masks: loss and gradients")
        cfg = _drop_config(kernel)
        plain_cfg = cfg.replace(model=dataclasses.replace(cfg.model, fused_attention=False))
        fused = VADModel(cfg.model, torch.float32, torch.Generator().manual_seed(0)).to(DEV)
        plain = VADModel(plain_cfg.model, torch.float32, torch.Generator().manual_seed(0)).to(DEV)
        clip = torch.from_numpy(np.random.RandomState(2).randint(
            0, 256, (1, 4, 224, 224, 3)).astype(np.uint8)).to(DEV)
        got_loss, got = _loss_grads(fused, cfg, clip)
        want_loss, want = _loss_grads(plain, plain_cfg, clip)
        check_close("loss", got_loss.cpu(), want_loss.cpu(), 0.0, 1e-4)
        if got.keys() != want.keys():
            raise AssertionError(f"{kernel}: the parameters with a gradient differ")
        worst = max((float((got[k] - want[k]).abs().max())
                     / (MODEL_GRAD_TOL * float(want[k].abs().max()) + 1e-12), k) for k in want)
        print(f"  {len(want)} gradients: worst err/(tol*max) {worst[0]:.2e} at {worst[1]} "
              f"(tol {MODEL_GRAD_TOL:g})")
        if not worst[0] <= 1.0:
            raise AssertionError(f"{kernel}: {worst[1]}'s gradient exceeds the bound")
        del fused, plain, got, want

        print(f"[11] step time with masks drawn against rate 0, {kernel}, bf16, batch "
              f"{TRAIN_BATCH}")
        times = {}
        for label, c in (("rate 0", flagship_train_config(kernel)), ("dropout", cfg)):
            times[label] = _step_times(c, torch.bfloat16)
            print(f"  {label}: {times[label][0]:.1f} ms a step (host clock, "
                  f"{DROP_TIMED_STEPS} untraced steps), one traced step {times[label][1]:.1f} ms "
                  f"device busy, {times[label][2]} host aten ops [{smi}]")
        keys = DropKeys(cfg.seed + DROPOUT_SEED_OFFSET, 0, 0, TRAIN_BATCH)
        for shape in ((TRAIN_BATCH, 1, 1, 1, 1), (TRAIN_BATCH, 2, 56, 56, 384)):
            with drop_keys(keys):
                draw_ms = cuda_ms(lambda: keep_mask("site", shape, 0.9, DEV), batch=20)
            print(f"  one mask draw of {shape}: {draw_ms * 1e3:.1f} us (CUDA events around 20 "
                  "draws back to back)")
        out[kernel] = times

    print("[11] remat on against off, fold, bf16, masks drawn: loss and gradients; then one "
          "LARS step on those gradients")
    runs = []
    clip = torch.from_numpy(MemLoader(2, 1).data[0]).to(DEV)
    for remat in (False, True, False):
        cfg = _drop_config("fold", remat=remat)
        model = VADModel(cfg.model, torch.bfloat16, torch.Generator().manual_seed(0)).to(DEV)
        runs.append((model,) + _loss_grads(model, cfg, clip))
    (m0, l0, g0), (_, l1, g1), (_, l2, g2) = runs
    same = sum(bool(torch.equal(g0[k], g1[k])) for k in g0)
    again = sum(bool(torch.equal(g0[k], g2[k])) for k in g0)
    worst = max((rel_error(g1[k], g0[k], BWD_TOL[torch.bfloat16])[2], k) for k in g0)
    print(f"  loss {float(l0):.6f} / {float(l1):.6f}; {same} of {len(g0)} gradients the same "
          f"bits (remat off run twice: {again}); worst err/(tol*max) {worst[0]:.3f} at "
          f"{worst[1]} (tol {BWD_TOL[torch.bfloat16]:g})")
    if g0.keys() != g1.keys() or not worst[0] <= 1.0 or float(l0) != float(l1):
        raise AssertionError("remat changed the loss or a gradient beyond the bf16 bound")
    lr, wd, mom = 1e-2, 1e-4, 0.9
    params = [p for p in m0.parameters() if p.grad is not None]
    before = [p.detach().double().cpu() for p in params]
    grads = [p.grad.detach().double().cpu() for p in params]
    opt = Lars(params, lr=lr, weight_decay=wd, momentum=mom)
    opt.step()
    torch.cuda.synchronize()
    worst = (0.0, -1)
    for i, (p, p0, g) in enumerate(zip(params, before, grads)):
        u = g + wd * p0
        pn, un = p0.norm(), u.norm()
        ratio = 1.0 if float(pn) == 0.0 or float(un) == 0.0 else 0.001 * pn / un
        step = -lr * u * ratio
        want = p0 + step
        # the fp32 parameter rounds the sum (an ulp of it), and the fp32 norms
        # and products move the update (1e-5 of the largest)
        tol = 2.0 ** -23 * want.abs() + 1e-5 * float(step.abs().max())
        ratio_err = float(((p.detach().double().cpu() - want).abs() / tol).max())
        worst = max(worst, (ratio_err, i))
    print(f"  LARS step on {len(params)} tensors: worst |card - plain| / (ulp + 1e-5 "
          f"max|update|) {worst[0]:.3f}")
    if not worst[0] <= 1.0:
        raise AssertionError("the LARS step disagrees with its plain update")
    del runs, m0
    torch.cuda.empty_cache()
    return out


TP_SIZES = (2, 4)  # virtual model sizes: every flagship stage's window rows (8 or 4) split
TP_KERNELS = ("fold", "fold_block")
# One forward and backward of the flagship by turns at model size m: each of
# the 18 blocks runs its forward kernels and its backward kernels once a
# virtual rank (A and B, 6 and 5; the whole-block kernel each way).
TP_COUNTS = {
    "fold": ("fold_attention", "ln_mlp", "fold_attention_bwd", "ln_mlp_bwd"),
    "fold_block": ("fold_block", "fold_block_bwd"),
}


class TurnClock:
    """The recorder of ``model_parallel_by_turns``: a CUDA event and the sum
    of every kernel counter at each start and end of a virtual rank's turn,
    forward and backward; ``per_rank()`` sums each rank's launches and the
    event-timed ms inside its turns."""

    def __init__(self):
        from vadcl_tpu_torch.ops import KERNELS

        self.kernels, self.marks = KERNELS, []

    def mark(self, rank: int, phase: str, edge: str) -> None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.marks.append((rank, phase, edge, ev, sum(k.launches for k in self.kernels)))

    def per_rank(self) -> dict:
        torch.cuda.synchronize()
        out, open_ = {}, {}
        for rank, phase, edge, ev, n in self.marks:
            if edge == "start":
                open_[(rank, phase)] = (ev, n)
                continue
            ev0, n0 = open_.pop((rank, phase))
            slot = out.setdefault(rank, {"fwd_launches": 0, "bwd_launches": 0,
                                         "fwd_ms": 0.0, "bwd_ms": 0.0})
            slot[f"{phase}_launches"] += n - n0
            slot[f"{phase}_ms"] += ev0.elapsed_time(ev)
        if open_:
            raise AssertionError(f"turns opened and never closed: {sorted(open_)}")
        return out


def phase_tp(smi: str) -> dict:
    """Tensor parallelism by turns on one card at the flagship (shanghaitech,
    224^2, 4-frame predict, bf16, batch 4) under ``fold`` and
    ``fold_block``: ``parallel/tp.py:model_parallel_by_turns`` at model
    sizes 2 and 4 runs each virtual rank's window rows (and kernel B's
    rows) through the real kernels in turn, with the row splits, the mask
    slices and the roll of ``shard_windows_call`` a multi-card run uses;
    the outputs are gathered and autograd sums the ranks' gradients.  The
    forward is held against the unsplit model bit for bit (each window and
    token is computed alone, the same kernel on the same values), the loss
    and every gradient within the bf16 gradient bound (``BWD_TOL``); the
    launches are exactly one a block and rank each way; each virtual rank's
    launches and event-timed ms inside its turns are printed."""
    from vadcl_tpu_torch.models import VADModel
    from vadcl_tpu_torch.parallel.tp import model_parallel_by_turns
    from vadcl_tpu_torch.train.step import make_loss_fn

    out = {}
    clip = torch.from_numpy(MemLoader(TRAIN_BATCH, 1).data[0]).to(DEV)
    for kernel in TP_KERNELS:
        cfg = flagship_train_config(kernel)
        model = VADModel(cfg.model, torch.bfloat16, torch.Generator().manual_seed(0)).to(DEV)
        loss_fn = make_loss_fn(model, cfg)
        with torch.no_grad():
            want = model(clip[:, :4].float() / 255.0)
        l0, g0 = _loss_grads(model, cfg, clip)
        for size in TP_SIZES:
            print(f"[12] tensor parallelism by turns, attn_kernel={kernel}, model size {size}, "
                  f"bf16, batch {TRAIN_BATCH}: forward and one step's gradients against the "
                  "unsplit model")
            clock = TurnClock()
            with model_parallel_by_turns(size, clock), plain_versions_refuse_the_card():
                with torch.no_grad():
                    got = model(clip[:, :4].float() / 255.0)
                clock.marks.clear()
                reset_launches()
                model.zero_grad(set_to_none=True)
                loss, _ = loss_fn(clip, 0)
                loss.backward()
                torch.cuda.synchronize()
            per_rank = clock.per_rank()
            launches = {k: n for k, n in ((k.__name__, k.launches) for k in clock.kernels) if n}
            want_counts = {name: 18 * size for name in TP_COUNTS[kernel]}
            want_counts.update(cluster_assign=1, space_cluster_loss=1)
            grads = {k: p.grad.detach().clone() for k, p in model.named_parameters()
                     if p.grad is not None}
            same = all(torch.equal(a, b) for a, b in (
                (got.recon, want.recon), (got.cluster_loss, want.cluster_loss),
                (got.space_loss, want.space_loss)))
            worst = max((rel_error(grads[k], g0[k], BWD_TOL[torch.bfloat16])[2], k) for k in g0)
            print(f"  forward the same bits as unsplit: {same}; loss {float(loss.detach()):.6f} "
                  f"unsplit {float(l0):.6f}; worst gradient err/(tol*max) {worst[0]:.3f} at "
                  f"{worst[1]} (tol {BWD_TOL[torch.bfloat16]:g}); launches {launches}")
            for rank, r in sorted(per_rank.items()):
                print(f"  virtual rank {rank}: forward {r['fwd_launches']} launches "
                      f"{r['fwd_ms']:.2f} ms, backward {r['bwd_launches']} launches "
                      f"{r['bwd_ms']:.2f} ms (CUDA events around its turns) [{smi}]")
            if not same:
                raise AssertionError(f"tensor parallelism by turns, {kernel}, model {size}: the "
                                     "forward differs from the unsplit model's")
            if grads.keys() != g0.keys() or not worst[0] <= 1.0:
                raise AssertionError(f"tensor parallelism by turns, {kernel}, model {size}: a "
                                     "gradient leaves the bf16 bound")
            check_rel(f"tp {kernel} {size} loss", loss.detach().float().cpu(),
                      l0.float().cpu(), BWD_TOL[torch.bfloat16])
            if launches != want_counts or sorted(per_rank) != list(range(size)):
                raise AssertionError(f"tensor parallelism by turns, {kernel}, model {size}: "
                                     f"launches {launches}, expected {want_counts}")
            per = {r["fwd_launches"] + r["bwd_launches"] for r in per_rank.values()}
            if per != {len(TP_COUNTS[kernel]) * 18}:
                raise AssertionError(f"tensor parallelism by turns: per-rank launches {per_rank}")
            out[f"{kernel} {size}"] = per_rank
        del model
        torch.cuda.empty_cache()
    return out


def phase_tp_cards(smi: str) -> dict:
    """Tensor parallelism across cards, where two or more are visible:
    ``tools/ddp_check_torch.py --model-parallel 2`` as 2 NCCL processes (one
    model group of 2), and on 4 cards dp2 x tp2, each against one process
    (the data-parallel bounds)."""
    cards = torch.cuda.device_count()
    out = {}
    if cards < 2:
        print(f"[13] tensor parallelism across cards: not run, {cards} card visible "
              "(NCCL puts one rank on a card; phase 12 checked the row splits by turns)")
        return out
    for n in (2, 4) if cards >= 4 else (2,):
        print(f"[13] tensor parallelism across {n} cards: tools/ddp_check_torch.py "
              f"--model-parallel 2 ({n // 2} data x 2 model) against one process")
        r = ddp_check_two_cards("--model-parallel", "2", procs=n)
        print(f"  ok {r['ok']}, loss rel err {r['loss_rel_err']:.3e}, param max diff "
              f"{r['param_max_diff']:.3e} (bound {r['param_bound']:.3e}), step ms "
              f"{[round(t, 1) for t in r['step_ms']]} [{smi}]")
        out[n] = r
    return out


_REF_BLOCK = {  # a Swin block's JAX path -> (the reference's name, layout)
    "norm1/scale": ("norm1.weight", None), "norm1/bias": ("norm1.bias", None),
    "norm2/scale": ("norm2.weight", None), "norm2/bias": ("norm2.bias", None),
    "attn/relative_position_bias_table": ("attn.relative_position_bias_table", None),
    "attn/qkv_kernel": ("attn.qkv.weight", "linear"), "attn/qkv_bias": ("attn.qkv.bias", None),
    "attn/proj_kernel": ("attn.proj.weight", "linear"),
    "attn/proj_bias": ("attn.proj.bias", None),
    "mlp/fc1/kernel": ("mlp.fc1.weight", "linear"), "mlp/fc1/bias": ("mlp.fc1.bias", None),
    "mlp/fc2/kernel": ("mlp.fc2.weight", "linear"), "mlp/fc2/bias": ("mlp.fc2.bias", None),
}
_REF_UNIT = {"conv3d/kernel": ("conv3d.weight", "conv"), "bn/scale": ("bn.weight", None),
             "bn/bias": ("bn.bias", None), "bn/mean": ("bn.running_mean", None),
             "bn/var": ("bn.running_var", None)}
_REF_LAYOUT = {"linear": (1, 0), "conv": (4, 3, 0, 1, 2), "convT": (3, 4, 0, 1, 2)}


def _reference_name(path: str):
    """A flagship predict-mode JAX path -> (the reference ``Mymodel`` key,
    its layout): the name map of ``train/torch_import.py`` backwards."""
    import re

    p = path.partition("/")[2]
    m = re.fullmatch(r"(encoder|decoder)/stage(\d+)/block(\d+)/(.*)", p)
    if m:
        side = "layers" if m[1] == "encoder" else "ST_layers"
        name, kind = _REF_BLOCK[m[4]]
        return f"{m[1]}.{side}.{m[2]}.blocks.{m[3]}.{name}", kind
    m = re.fullmatch(r"(encoder|decoder)/inception(\d+)/(\w+)/(.*)", p)
    if m:
        side = "conv_layers" if m[1] == "encoder" else "I3D_layers"
        name, kind = _REF_UNIT[m[4]]
        return f"{m[1]}.{side}.{m[2]}.0.{m[3]}.{name}", kind
    if p.endswith("cluster_center"):
        return p.replace("/", "."), None
    leaf = {"kernel": "weight", "scale": "weight", "bias": "bias"}[p.rsplit("/", 1)[1]]
    head = p.rsplit("/", 1)[0]
    fixed = {"encoder/patch_embed": ("encoder.patch_embed.proj", "conv"),
             "decoder/timedebd": ("decoder.timedebd", "conv"),
             "decoder/upsample0/proj": ("decoder.upsampling.0.proj.0", "convT"),
             "decoder/norm": ("decoder.norm", None),
             "decoder/patchdebed/deconv1": ("decoder.patchdebed.proj.0", "convT"),
             "decoder/patchdebed/conv": ("decoder.patchdebed.proj.2", "conv"),
             "decoder/patchdebed/deconv2": ("decoder.patchdebed.proj.4", "convT"),
             "cluster1/norm": ("cluster1.norm", None),
             "space_cluster/norm": ("space_cluster.norm", None), "norm": ("norm", None)}
    m = re.fullmatch(r"encoder/downsample(\d+)", head)
    if m:
        return f"encoder.downsample.{m[1]}.0.{leaf}", "conv" if leaf == "weight" else None
    name, kind = fixed[head]
    return f"{name}.{leaf}", kind if p.endswith("kernel") else None


def reference_state_dict(model) -> dict:
    """The flagship predict-mode ``model``'s weights as the reference's
    ``Mymodel`` state_dict would hold them (DDP ``module.`` prefix, torch
    layouts), built as ``tests/test_torch_port_torch_import.py`` builds its
    key set."""
    from vadcl_tpu_torch.convert import jax_from_state_dict

    out = {}
    for path, a in jax_from_state_dict(model.state_dict(), predict=True).items():
        key, kind = _reference_name(path)
        a = np.ascontiguousarray(a.transpose(_REF_LAYOUT[kind]) if kind else a)
        out["module." + key] = torch.from_numpy(a)
    return out


REF_BATCH = 16  # the scoring path's batch, for the CLI and the artifact


@contextlib.contextmanager
def counting_forwards():
    """While open, counts the calls of ``VADModel.forward``: yields a
    one-element list."""
    from vadcl_tpu_torch.models import backbone

    calls, real = [0], backbone.VADModel.forward

    def counted(self, *args, **kw):
        calls[0] += 1
        return real(self, *args, **kw)

    backbone.VADModel.forward = counted
    try:
        yield calls
    finally:
        backbone.VADModel.forward = real


def phase_reference_ckpt(smi: str) -> dict:
    """The reference-checkpoint bridge at the flagship (shanghaitech, 224^2,
    4-frame predict, bf16, fused ``fold``): a seeded model's weights written
    as a reference-keyed ``.pth`` and as a JAX-layout checkpoint; two JPEG
    test videos written at 224^2.  ``tools/evaluate_torch.py --torch-ckpt``
    scores them with every weight matched (the printed counts), the same
    score curves, bit for bit, as ``--ckpt`` of the same weights, and one
    launch of A and of B a block and of C and D a forward, nothing else;
    ``tools/export_torch.py --torch-ckpt`` and ``--ckpt`` give artifacts
    whose scores of the same windows are the same bits, and a call of the
    first launches the same kernels as a forward."""
    from tools import evaluate_torch, export_torch
    from vadcl_tpu_torch.convert import jax_from_state_dict
    from vadcl_tpu_torch.data import make_synthetic_dataset
    from vadcl_tpu_torch.models import VADModel
    from vadcl_tpu_torch.serve import load_artifact

    print("[15] reference checkpoint at the flagship, fold, bf16: --torch-ckpt through "
          "tools/evaluate_torch.py and tools/export_torch.py against --ckpt of the same weights")
    root = os.path.dirname(os.path.abspath(__file__))
    out = {}
    with tempfile.TemporaryDirectory(dir=root, prefix=".chip_smoke_ref_") as tmp:
        model = VADModel(flagship_config("fold"), torch.float32, torch.Generator().manual_seed(3))
        pth, npz = os.path.join(tmp, "ref.pth"), os.path.join(tmp, "weights.npz")
        torch.save(reference_state_dict(model), pth)
        flat = jax_from_state_dict(model.state_dict(), predict=True)
        np.savez(npz, **{(k if k.startswith("params/") else "extras/" + k): v
                         for k, v in flat.items()})
        n_keys = len(flat)
        del model
        _, test_dir, label_dir = make_synthetic_dataset(
            os.path.join(tmp, "data"), num_train_videos=1, num_test_videos=2,
            frames_per_video=12, size=224)
        common = ["--preset", "shanghaitech", "--predict", "--fused", "--attn-kernel", "fold",
                  "--test-data-path", test_dir, "--label-path", label_dir,
                  "--batch-windows", str(REF_BATCH)]
        curves = {}
        for flag, path in (("--torch-ckpt", pth), ("--ckpt", npz)):
            reset_launches()
            t0 = time.perf_counter()
            with plain_versions_refuse_the_card(), counting_forwards() as calls:
                curves[flag] = evaluate_torch.main(
                    common + [flag, path, "--out", os.path.join(tmp, f"scores-{flag[2:]}.npz")])
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_launches(set(EXPORT_COUNTS["fold"]), f"evaluate {flag}",
                                     {k: n * calls[0] for k, n in EXPORT_COUNTS["fold"].items()})
            print(f"  evaluate_torch {flag}: {calls[0]} forwards at batch {REF_BATCH}, mean "
                  f"AUC {curves[flag]:.4f}, {wall:.1f} s (the CLI's own wall clock) [{smi}]")
            out[flag] = dict(forwards=calls[0], launches=launches)
        with np.load(os.path.join(tmp, "scores-torch-ckpt.npz")) as a, np.load(
                os.path.join(tmp, "scores-ckpt.npz")) as b:
            same = a.files == b.files and all(np.array_equal(a[k], b[k]) for k in a.files)
        print(f"  score curves of --torch-ckpt and --ckpt the same bits: {same}")
        if not same or curves["--torch-ckpt"] != curves["--ckpt"]:
            raise AssertionError("--torch-ckpt scores differ from the same weights loaded "
                                 "directly")
        windows = torch.from_numpy(np.random.RandomState(5).randint(
            0, 256, (REF_BATCH, 4, 224, 224, 3)).astype(np.uint8)).cuda()
        scores = {}
        for flag, path in (("--torch-ckpt", pth), ("--ckpt", npz)):
            art_dir = os.path.join(tmp, f"art{flag[2:]}")
            export_torch.main(["--preset", "shanghaitech", "--predict", "--fused",
                               "--attn-kernel", "fold", "--batch-windows", str(REF_BATCH),
                               flag, path, "--out", art_dir])
            art = load_artifact(art_dir)
            reset_launches()
            with torch.no_grad():
                scores[flag] = art.score(windows).float().cpu()
            torch.cuda.synchronize()
            read_launches(set(EXPORT_COUNTS["fold"]), f"artifact {flag}", EXPORT_COUNTS["fold"])
            del art
        if not torch.equal(scores["--torch-ckpt"], scores["--ckpt"]):
            raise AssertionError("the --torch-ckpt artifact scores differ from the --ckpt one's")
        print(f"  artifacts of --torch-ckpt and --ckpt: the same score bits on {REF_BATCH} "
              f"windows; {n_keys} weights a checkpoint")
    torch.cuda.empty_cache()
    return out


def phase_native(smi: str) -> dict:
    """The C++ JPEG decoder (``data/native.py``): whether ``g++`` and
    ``jpeglib.h`` are on this machine; where they are, the port's build must
    succeed and decode (a failure raises), its largest difference from PIL
    on 64 JPEG frames (640x360 -> 224^2) is printed with both decoders'
    frames/s; where they are not, the port reads frames with PIL, as the
    JAX package does there."""
    import shutil

    from PIL import Image

    from vadcl_tpu_torch.data import native
    from vadcl_tpu_torch.data.dataset import load_clip

    gxx = shutil.which("g++")
    header = gxx is not None and subprocess.run(
        [gxx, "-fsyntax-only", "-x", "c++", "-"], input="#include <cstdio>\n#include <jpeglib.h>\n",
        capture_output=True, text=True).returncode == 0
    print(f"[14] native JPEG decoder: g++ {'at ' + gxx if gxx else 'missing'}, jpeglib.h "
          f"{'found' if header else 'missing'}")
    if not (gxx and header):
        print("  the port reads frames with PIL here, as the JAX package does without them")
        return {"native": False}
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(dir=root, prefix=".chip_smoke_jpeg_") as tmp:
        rng = np.random.RandomState(0)
        yy, xx = np.mgrid[0:360, 0:640]
        paths = []
        for i in range(64):
            img = np.stack([127 + 120 * np.sin(xx / (30.0 + i) + i),
                            127 + 120 * np.cos(yy / 47.0), rng.randint(0, 40, xx.shape)],
                           -1).astype(np.uint8)
            paths.append(os.path.join(tmp, f"{i:03d}.jpg"))
            Image.fromarray(img).save(paths[-1], quality=90)
        t0 = time.perf_counter()
        lib = native.get_lib()
        build_s = time.perf_counter() - t0
        if lib is None:
            raise AssertionError(f"g++ and jpeglib.h are here but the decoder did not build: "
                                 f"{native.last_error}")
        timing = {}
        for name, use in (("native", True), ("PIL", False)):
            load_clip(paths[:4], (224, 224), use_native=use, as_uint8=True)  # warm
            t0 = time.perf_counter()
            frames = load_clip(paths, (224, 224), use_native=use, as_uint8=True)
            timing[name] = (time.perf_counter() - t0, frames)
        diff = int(np.abs(timing["native"][1].astype(np.int32)
                          - timing["PIL"][1].astype(np.int32)).max())
        fps = {k: len(paths) / t for k, (t, _) in timing.items()}
        print(f"  built in {build_s:.1f} s at {native.library_path()}; 64 frames 640x360 -> "
              f"224^2 uint8: native {fps['native']:.0f} frames/s, PIL {fps['PIL']:.0f} frames/s "
              f"(this host's CPU, files warm in the page cache); max |native - PIL| = {diff} "
              f"uint8 steps [{smi}]")
        if diff > 3:
            raise AssertionError(f"the native decoder is {diff} steps from PIL (bound 3)")
    return {"native": True, "fps": fps, "max_diff": diff}


SYNTH_STEPS = 5
SYNTH_TIMEOUT = 300


def phase_train_synthetic(smi: str) -> dict:
    """``tools/train_synthetic_torch.py --fused`` for a few steps on the
    card, in a process of its own: exit 0 and a per-scene AUC printed."""
    root = os.path.dirname(os.path.abspath(__file__))
    print(f"[16] tools/train_synthetic_torch.py --fused --steps {SYNTH_STEPS} on the card")
    with tempfile.TemporaryDirectory(dir=root, prefix=".chip_smoke_synth_") as tmp:
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, os.path.join(root, "tools", "train_synthetic_torch.py"), "--fused",
             "--steps", str(SYNTH_STEPS), "--root", tmp], capture_output=True, text=True,
            timeout=SYNTH_TIMEOUT, cwd=root)
        wall = time.perf_counter() - t0
    lines = [l for l in run.stdout.splitlines() if "AUC" in l]
    print("\n".join(f"  {l}" for l in lines) + f"\n  exit {run.returncode} in {wall:.1f} s [{smi}]")
    if run.returncode != 0 or not any(l.startswith("per-scene AUC:") for l in lines):
        raise AssertionError(f"tools/train_synthetic_torch.py exited {run.returncode}:\n"
                             f"{run.stdout[-2000:]}\n{run.stderr[-3000:]}")
    return {"wall_s": wall}


REPLACES = {
    "fold_attention": ("vadcl_tpu_torch/csrc/fold_attn_mma.cuh",
                       "vadcl_tpu/ops/pallas_attn_fold.py:165"),
    "ln_mlp": ("vadcl_tpu_torch/csrc/ln_mlp.cu", "vadcl_tpu/ops/pallas_mlp.py:70"),
    "cluster_assign": ("vadcl_tpu_torch/csrc/cluster_mma.cu", "vadcl_tpu/ops/pallas_cluster.py:33"),
    "space_cluster_loss": ("vadcl_tpu_torch/csrc/space_cluster_mma.cu",
                           "vadcl_tpu/ops/pallas_cluster.py:175"),
    "ln_mlp_bwd": ("vadcl_tpu_torch/csrc/ln_mlp_bwd_mma.cu", "vadcl_tpu/ops/pallas_mlp.py:87"),
    "fold_attention_bwd": ("vadcl_tpu_torch/csrc/fold_attn_bwd_mma.cu",
                           "vadcl_tpu/ops/pallas_attn_fold.py:704"),
    "window_attention_fused": ("vadcl_tpu_torch/csrc/fold_attn_mma.cuh",
                               "vadcl_tpu/ops/pallas_attn.py:30"),
    "window_attention_fused_bwd": ("vadcl_tpu_torch/csrc/fold_attn_bwd_mma.cu",
                                   "vadcl_tpu/ops/pallas_attn_bwd.py:27"),
    "window_attention_packed": ("vadcl_tpu_torch/csrc/fold_attn_mma.cuh",
                                "vadcl_tpu/ops/pallas_attn.py:113"),
    "fold_attention_packed": ("vadcl_tpu_torch/csrc/fold_attn_mma.cuh",
                              "vadcl_tpu/ops/pallas_attn_fold.py:386"),
    "fold_block": ("vadcl_tpu_torch/csrc/fold_block_mma.cu",
                   "vadcl_tpu/ops/pallas_attn_fold.py:341"),
    "fold_block_tiles": ("vadcl_tpu_torch/csrc/fold_attn.cu",
                         "vadcl_tpu/ops/pallas_attn_fold.py:341"),
    "fold_block_bwd": ("vadcl_tpu_torch/csrc/fold_block_bwd_mma.cu",
                       "vadcl_tpu/ops/pallas_attn_fold.py:870"),
    "fold_block_bwd_tiles": ("vadcl_tpu_torch/csrc/fold_attn_bwd.cu",
                             "vadcl_tpu/ops/pallas_attn_fold.py:870"),
    "window_attention_fused_rows": ("vadcl_tpu_torch/csrc/window_attn_rows_mma.cu",
                                    "vadcl_tpu/ops/pallas_attn.py:30"),
    "window_attention_fused_bwd_rows": ("vadcl_tpu_torch/csrc/window_attn_bwd_rows_mma.cu",
                                        "vadcl_tpu/ops/pallas_attn_bwd.py:27"),
    "window_attention_packed_rows": ("vadcl_tpu_torch/csrc/window_attn_rows_mma.cu",
                                     "vadcl_tpu/ops/pallas_attn.py:113"),
    "ln_mlp_tiles": ("vadcl_tpu_torch/csrc/ln_mlp.cu", "vadcl_tpu/ops/pallas_mlp.py:70"),
    "window_attention_fused_tiles": ("vadcl_tpu_torch/csrc/window_attn.cu",
                                     "vadcl_tpu/ops/pallas_attn.py:30"),
    "window_attention_fused_bwd_tiles": ("vadcl_tpu_torch/csrc/window_attn_bwd.cu",
                                         "vadcl_tpu/ops/pallas_attn_bwd.py:27"),
    "window_attention_packed_tiles": ("vadcl_tpu_torch/csrc/window_attn.cu",
                                      "vadcl_tpu/ops/pallas_attn.py:113"),
}
# The bf16 CUDA-core instances of 7, 8 and 9 (head widths the tensor-core
# bodies refuse) count their launches on the counter of the same body in
# fp32; each is reported from a run of the embed_dim 24 model, every one of
# whose Swin blocks is at head width 12: (counter, source, TPU kernel, run).
NARROW_ENTRIES = {
    "window_attention_fused_tiles bf16 CUDA-core": (
        "window_attention_fused_tiles", "vadcl_tpu_torch/csrc/window_attn.cu",
        "vadcl_tpu/ops/pallas_attn.py:30", "narrow model base"),
    "window_attention_packed_tiles bf16 CUDA-core": (
        "window_attention_packed_tiles", "vadcl_tpu_torch/csrc/window_attn.cu",
        "vadcl_tpu/ops/pallas_attn.py:113", "narrow model packed"),
    "window_attention_fused_bwd_tiles bf16 CUDA-core": (
        "window_attention_fused_bwd_tiles", "vadcl_tpu_torch/csrc/window_attn_bwd.cu",
        "vadcl_tpu/ops/pallas_attn_bwd.py:27", "narrow model base"),
    "window_attention_fused_rows bf16 CUDA-core": (
        "window_attention_fused_rows", "vadcl_tpu_torch/csrc/window_attn_rows.cu",
        "vadcl_tpu/ops/pallas_attn.py:30", "narrow model base, reconstruction"),
    "window_attention_packed_rows bf16 CUDA-core": (
        "window_attention_packed_rows", "vadcl_tpu_torch/csrc/window_attn_rows.cu",
        "vadcl_tpu/ops/pallas_attn.py:113", "narrow model packed, reconstruction"),
    "window_attention_fused_bwd_rows bf16 CUDA-core": (
        "window_attention_fused_bwd_rows", "vadcl_tpu_torch/csrc/window_attn_bwd_rows.cu",
        "vadcl_tpu/ops/pallas_attn_bwd.py:27", "narrow model base, reconstruction"),
}
# The main path whose launch count the kernels line reports for each kernel.
COUNTED_ON = {
    "fold_attention": "scoring fold", "ln_mlp": "scoring fold",
    "cluster_assign": "scoring fold", "space_cluster_loss": "scoring fold",
    "ln_mlp_bwd": "training fold", "fold_attention_bwd": "training fold",
    "window_attention_fused": "scoring base", "window_attention_fused_bwd": "training base",
    "window_attention_packed": "scoring packed",
    "fold_attention_packed": "scoring fold_packed", "fold_block": "scoring fold_block",
    "fold_block_bwd": "training fold_block",
    "window_attention_fused_rows": "scoring fold, reconstruction",
    "window_attention_fused_bwd_rows": "training fold, reconstruction",
    "window_attention_packed_rows": "scoring packed, reconstruction",
    "ln_mlp_tiles": "wide model",
    "fold_block_bwd_tiles": "model grads fold_block fp32",
    "fold_block_tiles": "model grads fold_block fp32",
    "window_attention_fused_tiles": "model base fp32",
    "window_attention_fused_bwd_tiles": "model grads base fp32",
    "window_attention_packed_tiles": "model packed fp32",
}


def main():
    smi = phase_device()
    phase_build()
    stats = phase_kernels()
    stats.update(phase_space_kernel())
    stats.update(phase_width_kernels())
    stats.update(phase_bwd_kernels(TRAIN_BATCH))
    stats.update(phase_window_fold_route(BATCH_WINDOWS, TRAIN_BATCH))
    phase_grid_blocks(TRAIN_BATCH)
    stats.update(phase_row_kernels(BATCH_WINDOWS, TRAIN_BATCH))
    stats.update(phase_narrow_kernels(BATCH_WINDOWS, TRAIN_BATCH))
    phase_model("fold", REDUCED_DEPTHS)
    counts = {"model base fp32": phase_model("base")}
    counts["model packed fp32"] = phase_model("packed", clips=1)
    phase_model("fold_packed", clips=1)
    phase_model("fold_mix", REDUCED_DEPTHS, clips=1)
    phase_model("fold_block", clips=1)
    phase_model("fold", clips=1, recon=RECON_FRAMES)
    phase_model("packed", REDUCED_DEPTHS, clips=1, recon=RECON_FRAMES)
    phase_model_grads("fold", REDUCED_DEPTHS)
    counts["model grads base fp32"] = phase_model_grads("base")
    for run, want in FP32_BASE_COUNTS.items():
        got = {k: counts[run][k] for k in want}
        if got != want:
            raise AssertionError(f"{run}: launches {got}, expected {want}")
    phase_model_grads("fold", ((2, 2), (2, 2)), image_size=240)
    counts["model grads fold_block fp32"] = phase_model_grads("fold_block")
    fp32_block = counts["model grads fold_block fp32"]
    if (fp32_block["fold_block_bwd_tiles"] != 18 or fp32_block["fold_block_bwd"]
            or fp32_block["fold_block_tiles"] != 18 or fp32_block["fold_block"]):
        raise AssertionError("the fp32 fold_block model must run PR 4's whole-block forward "
                             "and backward in each of its 18 blocks")
    phase_model_grads("fold", REDUCED_DEPTHS, recon=RECON_FRAMES)
    phase_model_grads("fold", REDUCED_DEPTHS, image_size=240, recon=RECON_FRAMES)
    phase_wide_model(torch.float32)
    counts["wide model"] = phase_wide_model(torch.bfloat16)
    counts.update(phase_narrow_model())
    counts.update({f"scoring {k}": phase_scoring(k) for k in SCORING_KERNELS})
    counts.update({f"training {k}": phase_training(k) for k in TRAINING_KERNELS})
    for k in ("packed", "fold_packed", "fold_mix"):
        phase_training_refused(k)
    counts.update({f"scoring {k}, reconstruction": phase_scoring(k, RECON_FRAMES)
                   for k in RECON_SCORING_KERNELS})
    counts.update({f"training {k}, reconstruction": phase_training(k, RECON_FRAMES)
                   for k in RECON_TRAINING_KERNELS})
    counts["data-parallel training fold"] = phase_ddp(smi)
    phase_autotune(smi)
    phase_profile()
    phase_zoo(smi)
    phase_export(smi)
    phase_dropout(smi)
    phase_tp(smi)
    phase_tp_cards(smi)
    phase_native(smi)
    phase_reference_ckpt(smi)
    phase_train_synthetic(smi)
    kernels = [
        dict(name=name, route="cuda", source=REPLACES[name][0], replaces=REPLACES[name][1],
             launches=counts[COUNTED_ON[name]][name], counted_on=COUNTED_ON[name],
             **stats[name])
        for name in REPLACES
    ] + [
        dict(name=name, route="cuda", source=source, replaces=replaces,
             launches=counts[run][counter], counted_on=run, **stats[name])
        for name, (counter, source, replaces, run) in NARROW_ENTRIES.items()
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
