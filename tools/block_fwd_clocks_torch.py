"""Where the whole-block forward's tensor-core body spends its clocks, and how
variants of it time, on one NVIDIA GPU.

Copies the tree's ``vadcl_tpu_torch`` into ``--out`` (a git-ignored
directory) and changes that copy of ``csrc/fold_block_mma.cu``: by default it
stamps ``clock64()`` at the boundaries of the body's steps (every warp's lane
0, summed over its block's windows: step 1 to y1, step 2 the MLP, step 3 the
store, and the clocks step 2 waits on the weight ring); with ``--variant
NAME`` it applies one of ``VARIANTS`` instead (designs tried and not kept,
and two that take a step's work out to read its cost).  It builds the copy
and runs ``fold_block`` at the four 4-frame flagship geometries
(``chip_smoke.py``'s operands, bf16), shifted and not, at ``--batch`` clips,
printing one JSON line each: the wrapper's ms (``chip_smoke.cuda_ms``),
kernels A then B on the same inputs, and (stamped) the clocks per window and
warp of each step:

    python tools/block_fwd_clocks_torch.py [--batch 16] [--variant NAME]
        [--out log_dir/block_fwd_clocks]

The stamps cost a ``__syncwarp`` and a clock read each; read the shares, not
the absolute time, from the clocks.  ``no_gelu`` and ``no_products`` compute
wrong results and are for timing only.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = "csrc/fold_block_mma.cu"
STEPS = ("step1", "step2", "step3", "step2_ring_wait")

_FC1 = ("#pragma unroll 2\n      for (int k0 = 0; k0 < C; k0 += 16) {\n        uint32_t az[4];")
_BPS = "  return hd == 16 && (ct == 6 || nt == 8) ? 2 : 1;"
_GELU = """#pragma unroll
      for (int nt = 0; nt < 2 * kP; ++nt) {
        const float2 bb =
            *reinterpret_cast<const float2*>(a.b1 + q * kBbPiece + nt * 8 + 2 * t);
        h[nt][0] = gelu_erf(round_to<bf16>(h[nt][0] + bb.x));
        h[nt][1] = gelu_erf(round_to<bf16>(h[nt][1] + bb.y));
        h[nt][2] = gelu_erf(round_to<bf16>(h[nt][2] + bb.x));
        h[nt][3] = gelu_erf(round_to<bf16>(h[nt][3] + bb.y));
      }
#pragma unroll
      for (int p = 0; p < kP; ++p) acc_to_a(ga[p], h[2 * p], h[2 * p + 1]);
      // fc2: B (k = hidden, n = c) stored [c / 8][k][c % 8], two n-tiles a load
#pragma unroll
      for (int np = 0; np < kCt; ++np) {
        if (np >= nct) break;
#pragma unroll
        for (int p = 0; p < kP; ++p) {"""
_FC2_END = ("        }\n      }\n      __syncwarp();\n      if (lane == 0) mbar_arrive(empty + s);\n"
            "    }\n\n    // ---- step 3")
# name: [(text in the source, its replacement), ...]
VARIANTS = {
    "one_block_64": [(_BPS, "  return hd == 16 && ct == 6 ? 2 : 1;")],
    "three_blocks_64": [(_BPS, "  return hd == 16 && nt == 8 ? (ct == 6 ? 3 : 2) : "
                               "(hd == 16 && ct == 6 ? 2 : 1);")],
    "fc1_unrolled": [(_FC1, "#pragma unroll\n      for (int kc = 0; kc < kCt; ++kc) {\n"
                            "        if (kc >= nct) break;\n        const int k0 = 16 * kc;\n"
                            "        uint32_t az[4];")],
    "gelu_fc2_interleaved": [
        (_GELU, _GELU.replace("#pragma unroll\n      for (int nt = 0; nt < 2 * kP; ++nt) {",
                              "#pragma unroll\n      for (int p = 0; p < kP; ++p) {\n"
                              "#pragma unroll\n      for (int nt = 2 * p; nt < 2 * p + 2; ++nt) {")
         .replace("#pragma unroll\n      for (int p = 0; p < kP; ++p) acc_to_a(ga[p], h[2 * p], "
                  "h[2 * p + 1]);\n      // fc2: B (k = hidden, n = c) stored [c / 8][k][c % 8], "
                  "two n-tiles a load\n", "      acc_to_a(ga[p], h[2 * p], h[2 * p + 1]);\n")
         .replace("#pragma unroll\n        for (int p = 0; p < kP; ++p) {", "        {")),
        (_FC2_END, _FC2_END.replace("      }\n      __syncwarp();", "      }\n      }\n      __syncwarp();"))],
    "no_gelu": [('#include "mlp_tail.cuh"  // gelu_erf',
                 '#include "mlp_tail.cuh"  // gelu_erf\n#define gelu_erf(x) (x)')],
    "no_products": [(_FC1, _FC1.replace("k0 < C;", "k0 < 0;")),
                    ("        if (np >= nct) break;\n#pragma unroll\n        for (int p = 0; p < kP",
                     "        if (np >= 0) break;\n#pragma unroll\n        for (int p = 0; p < kP")],
}
_LOOP = "  int seq = 0;\n\n  for (long long widx = wbeg; widx < wend; ++widx) {\n"
_STAMPS = [
    ("namespace vadcl {\n\nconstexpr int kFbBlocks",
     "namespace vadcl {\n__device__ unsigned long long g_fb_clk[8];\n\nconstexpr int kFbBlocks"),
    (_LOOP, "  int seq = 0;\n  unsigned long long fbacc[4] = {0, 0, 0, 0}, fbt = 0;\n"
            "#define FBT(k) do { __syncwarp(); const unsigned long long now = clock64(); "
            "if ((k) > 0) fbacc[(k) - 1] += now - fbt; fbt = now; } while (0)\n\n"
            "  for (long long widx = wbeg; widx < wend; ++widx) {\n    FBT(0);\n"),
    ("    __syncwarp();  // the y1 rows are complete; the o rows are dead\n",
     "    __syncwarp();  // the y1 rows are complete; the o rows are dead\n    FBT(1);\n"),
    ("      const int s = seq & 1;\n      mbar_wait(full + s, (uint32_t)((seq >> 1) & 1));\n",
     "      const int s = seq & 1;\n      {\n        const unsigned long long w0 = clock64();\n"
     "        mbar_wait(full + s, (uint32_t)((seq >> 1) & 1));\n"
     "        fbacc[3] += clock64() - w0;\n      }\n"),
    ("    // ---- step 3: y = round", "    FBT(2);\n    // ---- step 3: y = round"),
    ("    __syncwarp();  // the next window's LN1 overwrites the rows\n  }\n",
     "    __syncwarp();  // the next window's LN1 overwrites the rows\n    FBT(3);\n  }\n"
     "  if (lane == 0) {\n    for (int k = 0; k < 4; ++k) atomicAdd(&g_fb_clk[k], fbacc[k]);\n"
     "    atomicAdd(&g_fb_clk[4], (unsigned long long)(wend - wbeg));\n  }\n"),
]
_READ = """
extern "C" int vadcl_fb_clk(unsigned long long* out) {
  cudaMemcpyFromSymbol(out, vadcl::g_fb_clk, sizeof(unsigned long long) * 8);
  const unsigned long long zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  return (int)cudaMemcpyToSymbol(vadcl::g_fb_clk, zero, sizeof(zero));
}
"""


def prepare(out: str, variant: str) -> None:
    """The tree's package copied into ``out``, its kernel stamped or varied."""
    dst = os.path.join(out, "vadcl_tpu_torch")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(HERE, "vadcl_tpu_torch"), dst,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    path = os.path.join(dst, SOURCE)
    text = open(path).read()
    for marker, changed in (VARIANTS[variant] if variant else _STAMPS):
        if text.count(marker) != 1:
            raise RuntimeError(f"{SOURCE}: marker {marker[:40]!r} is not there once")
        text = text.replace(marker, changed)
    with open(path, "w") as f:
        f.write(text + ("" if variant else _READ))


def measure(batch: int, variant: str) -> None:
    """Runs inside the prepared copy (first on ``sys.path``)."""
    import ctypes

    import torch

    from vadcl_tpu_torch.ops import cuda_lib  # (the prepared copy: first on the path)
    from vadcl_tpu_torch.ops.fold_attn import fold_attention, fold_block
    from vadcl_tpu_torch.ops.ln_mlp import ln_mlp

    sys.path.append(HERE)
    import chip_smoke as smoke

    lib = cuda_lib.library()
    print(json.dumps({"card": smoke.smi_line(), "variant": variant or "clocks",
                      "build_s": cuda_lib.build_seconds}))
    gen = torch.Generator().manual_seed(0)
    keys = ("ln2_scale", "ln2_bias", "w1", "b1", "w2", "b2")
    clk = (ctypes.c_ulonglong * 8)()
    for gname, (dhwc, nh, window, shift) in smoke.FOLD_GEOMETRIES.items():
        for shifted in (False, True):
            a = smoke._fold_case((batch, *dhwc), nh, window, shift if shifted else (0, 0, 0),
                                 torch.bfloat16, gen)
            blk = smoke._block_case(a, gen)
            with torch.no_grad():
                rec = {"variant": variant or "clocks", "geometry": gname, "batch": batch,
                       "shifted": shifted,
                       "ms": round(smoke.cuda_ms(lambda: fold_block(**blk)), 4),
                       "a_then_b_ms": round(smoke.cuda_ms(lambda: ln_mlp(
                           fold_attention(**a), *(blk[k] for k in keys))), 4)}
                if not variant:
                    torch.cuda.synchronize()
                    lib.vadcl_fb_clk(clk)  # (clears what the timing left)
                    fold_block(**blk)
                    torch.cuda.synchronize()
                    lib.vadcl_fb_clk(clk)
                    warps = max(int(clk[4]), 1)  # (windows x strips)
                    rec["clocks_per_window_warp"] = {s: int(clk[k]) // warps
                                                     for k, s in enumerate(STEPS)}
            print(json.dumps(rec), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--variant", default="", choices=[""] + sorted(VARIANTS))
    ap.add_argument("--out", default=os.path.join(HERE, "log_dir", "block_fwd_clocks"))
    ap.add_argument("--measure", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.measure:
        measure(args.batch, args.variant)
        return
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("the clocks need a CUDA device")
    out = os.path.join(args.out, args.variant or "clocks")
    prepare(out, args.variant)
    env = dict(os.environ, PYTHONPATH=os.path.abspath(out))
    subprocess.run([sys.executable, os.path.abspath(__file__), "--measure", "--batch",
                    str(args.batch), "--variant", args.variant], env=env, check=True,
                   timeout=1800)


if __name__ == "__main__":
    main()
