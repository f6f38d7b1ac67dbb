#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``vadcl_tpu_torch``) on one
NVIDIA GPU.  Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  0. device: CUDA must be available (no CPU fallback); print the card's
     name and power limit as nvidia-smi reports them.
  1. build the four CUDA kernels from ``vadcl_tpu_torch/csrc`` (nvcc).
  2. each kernel against its plain PyTorch version on the card at the
     flagship shapes, at batch 4 (bf16 and fp32) and at the scoring path's
     batch of 16 windows (bf16): error against the stated bound and the
     median CUDA-event time of both; then edge shapes for correctness.
  3. the whole flagship model (shanghaitech, predict, fused fold attention
     and fused cluster heads) in fp32 with TF32 off: the card (kernels)
     against the CPU (plain versions) on 2 clips of 4x224^2.
  4. the scoring path in bf16: in-memory uint8 videos through
     ``evaluate_videos`` (PSNR -> anomaly score -> per-scene AUC) with
     batch_windows=16; every kernel must have launched on this path.
The second-to-last line is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import subprocess
import time

import numpy as np
import torch

FOLD_GEOMETRIES = {  # name: ((D, H, W, C) per clip, heads, runtime window, shift)
    "enc_stage0": ((2, 56, 56, 96), 6, (2, 7, 7), (0, 3, 3)),
    "enc_stage1": ((2, 28, 28, 192), 12, (2, 7, 7), (0, 3, 3)),
    "dec_stage0": ((1, 28, 28, 192), 12, (1, 7, 7), (0, 3, 3)),
    "dec_stage1": ((1, 56, 56, 96), 6, (1, 7, 7), (0, 3, 3)),
}
MLP_SHAPES = {96: (2, 56, 56), 192: (2, 28, 28)}  # C: (D, H, W) per clip
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
CLUSTER_RTOL = 1e-4  # recon and loss: fp32 FMA in another order
LABEL_GAP = 1e-3  # labels must agree where best and second-best differ by more


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of one call, in milliseconds."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


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
    cuda_lib.library()
    built = cuda_lib.build_seconds
    print(f"[1] kernels ready in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {'%.2f s' % built if built is not None else 'cached'})")


def _fold_case(shape, nh, window, shift, dtype, gen):
    from vadcl_tpu_torch.ops.window import compute_attn_mask

    B, D, H, W, C = shape
    n = window[0] * window[1] * window[2]
    dev = "cuda"
    r = lambda *s: torch.randn(*s, generator=gen).to(dev)
    mask = compute_attn_mask(D, H, W, window, shift)
    return dict(
        x=r(*shape).to(dtype), ln_scale=1 + 0.1 * r(C), ln_bias=0.1 * r(C),
        qkv_w=r(C, 3 * C) / C**0.5, qkv_b=0.1 * r(3 * C),
        proj_w=r(C, C) / C**0.5, proj_b=0.1 * r(C), bias=r(nh, n, n),
        mask=None if mask is None else torch.from_numpy(mask).to(dev),
        num_heads=nh, window=window, scale=(C // nh) ** -0.5, shift=shift,
    )


def check_fold(name, a) -> float:
    """Kernel A against its plain version on case ``a``: the block output
    (residual added) and the attention branch alone; returns the larger max
    abs error."""
    from vadcl_tpu_torch.ops.fold_attn import fold_attention, fold_attention_plain

    bounds = BOUNDS[a["x"].dtype]
    e = check_close(name, fold_attention(**a), fold_attention_plain(**a), *bounds)
    b = dict(a, residual=False)
    return max(e, check_close(f"{name} branch", fold_attention(**b),
                              fold_attention_plain(**b), *bounds))


def time_pair(kernel, plain) -> tuple:
    ms, pms = cuda_ms(kernel), cuda_ms(plain)
    print(f"    time: kernel {ms:.4f} ms, plain {pms:.4f} ms")
    return ms, pms


def _mlp_case(C, hidden, gen):
    r = lambda *s: torch.randn(*s, generator=gen).to("cuda")
    return (1 + 0.1 * r(C), 0.1 * r(C), r(C, hidden) / C**0.5, 0.1 * r(hidden),
            r(hidden, C) / hidden**0.5, 0.1 * r(C))


def phase_kernels():
    """Each kernel against its plain version: a batch-4 sweep in bf16 and
    fp32, then the main path's own shapes (batch 16, bf16), whose numbers go
    into the kernels line.  Returns {kernel: stats at batch 16}."""
    from vadcl_tpu_torch.ops.cluster import cdist
    from vadcl_tpu_torch.ops.cluster_kernels import (
        cluster_assign, cluster_assign_plain, space_cluster_loss,
        space_cluster_loss_plain,
    )
    from vadcl_tpu_torch.ops.fold_attn import fold_attention, fold_attention_plain
    from vadcl_tpu_torch.ops.ln_mlp import ln_mlp, ln_mlp_plain

    gen = torch.Generator().manual_seed(0)
    stats = {}
    for batch in (4, BATCH_WINDOWS):
        dtypes = (torch.bfloat16,) if batch == BATCH_WINDOWS else (torch.bfloat16, torch.float32)
        print(f"[2] kernels vs plain versions, flagship shapes, batch {batch}")

        errs, times = [], {}
        for dtype in dtypes:
            for gname, (dhwc, nh, window, shift) in FOLD_GEOMETRIES.items():
                for shifted in (False, True):
                    a = _fold_case((batch, *dhwc), nh, window,
                                   shift if shifted else (0, 0, 0), dtype, gen)
                    name = f"fold_attention {gname} {'shifted' if shifted else 'plain'} {str(dtype)[6:]}"
                    errs.append(check_fold(name, a))
                    times[name] = time_pair(lambda: fold_attention(**a),
                                            lambda: fold_attention_plain(**a))
        # the representative time: the flagship's largest block, enc stage 0, bf16, shifted
        ms, pms = times["fold_attention enc_stage0 shifted bfloat16"]
        stats["fold_attention"] = dict(max_abs_err=max(errs), ms=ms, plain_ms=pms,
                                       shape=f"x ({batch},2,56,56,96) bf16, nH 6, N 98, shifted")

        errs, times = [], {}
        for dtype in dtypes:
            for C, dhw in MLP_SHAPES.items():
                p = _mlp_case(C, 4 * C, gen)
                x = torch.randn(batch, *dhw, C, generator=gen).to("cuda", dtype)
                name = f"ln_mlp C={C} {str(dtype)[6:]}"
                errs.append(check_close(name, ln_mlp(x, *p), ln_mlp_plain(x, *p), *BOUNDS[dtype]))
                times[name] = time_pair(lambda: ln_mlp(x, *p), lambda: ln_mlp_plain(x, *p))
        ms, pms = times["ln_mlp C=96 bfloat16"]
        stats["ln_mlp"] = dict(max_abs_err=max(errs), ms=ms, plain_ms=pms,
                               shape=f"x ({batch},2,56,56,96) bf16, hidden 384")

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
        ms, pms = time_pair(lambda: cluster_assign(tokens, centers, 16.0),
                            lambda: cluster_assign_plain(tokens, centers, 16.0))
        stats["cluster_assign"] = dict(max_abs_err=e1, ms=ms, plain_ms=pms,
                                       shape=f"tokens ({n_tok},192) x centers (1024,192) fp32")

        maps = torch.randn(192, 2 * batch, 784, generator=gen).cuda()
        scen = torch.rand(192, 128, 784, generator=gen).cuda()
        e = check_close("space_cluster_loss", space_cluster_loss(maps, scen, 32.0),
                        space_cluster_loss_plain(maps, scen, 32.0), 0.0, CLUSTER_RTOL)
        ms, pms = time_pair(lambda: space_cluster_loss(maps, scen, 32.0),
                            lambda: space_cluster_loss_plain(maps, scen, 32.0))
        stats["space_cluster_loss"] = dict(
            max_abs_err=e, ms=ms, plain_ms=pms,
            shape=f"maps (192,{2 * batch},784) x centers (192,128,784) fp32")

    print("  edge shapes (tiny preset widths, fp32 widths off the tensor-core "
          "tiles, ragged counts), correctness only:")
    # C=32 / head_dim 16 (the tiny preset) in both dtypes; C=24 / head_dim 12
    # only in fp32: the bf16 kernels run on 16x16 tensor-core tiles and refuse it
    for dtype, C, nh in ((torch.bfloat16, 32, 2), (torch.float32, 32, 2),
                         (torch.float32, 24, 2)):
        a = _fold_case((2, 2, 14, 14, C), nh, (2, 7, 7), (0, 3, 3), dtype, gen)
        check_fold(f"fold_attention C={C} nH={nh} {str(dtype)[6:]}", a)
        p = _mlp_case(C, 4 * C, gen)
        x = torch.randn(3, 1, 7, 7, C, generator=gen).to("cuda", dtype)  # 147 tokens
        check_close(f"ln_mlp C={C} {str(dtype)[6:]}", ln_mlp(x, *p), ln_mlp_plain(x, *p),
                    *BOUNDS[dtype])
    a = _fold_case((2, 2, 14, 14, 24), 2, (2, 7, 7), (0, 0, 0), torch.bfloat16, gen)
    p = _mlp_case(24, 96, gen)
    for name, call in (("fold_attention", lambda: fold_attention(**a)),
                       ("ln_mlp", lambda: ln_mlp(a["x"], *p))):
        try:
            call()
        except NotImplementedError:
            print(f"  {name} bf16 C=24 refused (NotImplementedError), as it should be")
        else:
            raise AssertionError(f"{name}: bf16 C=24 launched instead of being refused")
    for n, c, k in ((200, 64, 16), (100, 30, 70)):
        t, cen = torch.randn(n, c, generator=gen).cuda(), torch.rand(k, c, generator=gen).cuda()
        got, want = cluster_assign(t, cen, 16.0), cluster_assign_plain(t, cen, 16.0)
        check_close(f"cluster_assign ({n},{c})x({k},{c}) recon", got.recon, want.recon,
                    1e-5, CLUSTER_RTOL)
        check_close(f"cluster_assign ({n},{c})x({k},{c}) loss", got.loss_sq_sum,
                    want.loss_sq_sum, 0.0, CLUSTER_RTOL)
        if not bool((got.labels == want.labels).all()):
            raise AssertionError("cluster_assign: labels differ at an edge shape")
    m, sc = torch.randn(64, 3, 49, generator=gen).cuda(), torch.rand(64, 8, 49, generator=gen).cuda()
    check_close("space_cluster_loss (64,3,49)x(64,8,49)", space_cluster_loss(m, sc, 32.0),
                space_cluster_loss_plain(m, sc, 32.0), 0.0, CLUSTER_RTOL)
    return stats


def flagship_config():
    from vadcl_tpu_torch.core.config import preset

    cfg = preset("shanghaitech")
    return dataclasses.replace(
        cfg.model, predict=True, fused_attention=True, fused_cluster=True,
        attn_kernel="fold",
    )


def phase_model():
    from vadcl_tpu_torch.models import VADModel

    print("[3] flagship model, fp32: card (kernels) vs CPU (plain versions)")
    cpu_model = VADModel(flagship_config(), torch.float32, torch.Generator().manual_seed(0)).eval()
    gpu_model = copy.deepcopy(cpu_model).cuda()
    clips = torch.rand(2, 4, 224, 224, 3, generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        t0 = time.perf_counter()
        want = cpu_model(clips)
        t_cpu = time.perf_counter() - t0
        got = gpu_model(clips.cuda())
        torch.cuda.synchronize()
    print(f"  recon {tuple(got.recon.shape)}; CPU forward {t_cpu:.1f} s")
    if tuple(got.recon.shape) != (2, 1, 224, 224, 3) or not bool(torch.isfinite(got.recon).all()):
        raise AssertionError("flagship recon has the wrong shape or is not finite")
    check_close("model recon", got.recon.cpu(), want.recon, MODEL_TOL, MODEL_TOL)
    check_close("model cluster_loss", got.cluster_loss.cpu(), want.cluster_loss, 0.0, 1e-4)
    check_close("model space_loss", got.space_loss.cpu(), want.space_loss, 0.0, 1e-4)
    agree = float((got.feature_label.cpu() == want.feature_label).float().mean())
    print(f"  feature labels equal: {agree:.5f}")
    if agree < 0.995:
        raise AssertionError("flagship labels disagree on more than 0.5% of tokens")


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


def phase_scoring():
    from vadcl_tpu_torch.eval.predict import (
        eval_input_frames, evaluate_videos, make_video_scorer, sliding_windows,
    )
    from vadcl_tpu_torch.models import VADModel
    from vadcl_tpu_torch.ops import KERNELS

    print("[4] scoring path, bf16: evaluate_videos on in-memory uint8 videos")
    model = VADModel(flagship_config(), torch.bfloat16, torch.Generator().manual_seed(0))
    model = model.cuda().eval()
    scorer = make_video_scorer(
        lambda clips: model(clips).recon, frame_num=4, predict=True,
        batch_windows=16, input_frames=eval_input_frames("swin", True, 4),
        device="cuda",
    )
    videos = make_videos()
    evaluate_videos(scorer, videos[:1], 4, True)  # warm-up (cuDNN autotune etc.)
    torch.cuda.synchronize()
    for k in KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    auc, per_scene, per_video = evaluate_videos(scorer, videos, 4, True, "stride1")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in KERNELS}
    n_windows = sum(len(sliding_windows(v[0].shape[0], 4, "stride1")) for v in videos)
    print(f"  {n_windows} windows in {wall:.3f} s = {n_windows / wall:.2f} windows/s; "
          f"mean scene AUC {auc:.4f}; per scene {per_scene}")
    print(f"  kernel launches on this path: {launches}")
    for (frames, _, _), vs in zip(videos, per_video):
        if len(vs.scores) != len(sliding_windows(frames.shape[0], 4, "stride1")) or not np.all(
            np.isfinite(vs.scores)
        ):
            raise AssertionError("per-video scores have the wrong length or are not finite")
    if not (np.isfinite(auc) and 0.0 <= auc <= 1.0):
        raise AssertionError(f"mean scene AUC {auc} is not a finite probability")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    return launches


REPLACES = {
    "fold_attention": ("vadcl_tpu_torch/csrc/fold_attn.cu", "vadcl_tpu/ops/pallas_attn_fold.py:165"),
    "ln_mlp": ("vadcl_tpu_torch/csrc/ln_mlp.cu", "vadcl_tpu/ops/pallas_mlp.py:70"),
    "cluster_assign": ("vadcl_tpu_torch/csrc/cluster.cu", "vadcl_tpu/ops/pallas_cluster.py:33"),
    "space_cluster_loss": ("vadcl_tpu_torch/csrc/cluster.cu", "vadcl_tpu/ops/pallas_cluster.py:175"),
}


def main():
    smi = phase_device()
    phase_build()
    stats = phase_kernels()
    phase_model()
    launches = phase_scoring()
    kernels = [
        dict(name=name, route="cuda", source=REPLACES[name][0], replaces=REPLACES[name][1],
             launches=launches[name], **stats[name])
        for name in REPLACES
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
