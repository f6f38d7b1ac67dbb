"""Where the whole-block backward's tensor-core body spends its clocks, on one
NVIDIA GPU.

Copies the tree's ``vadcl_tpu_torch`` into ``--out`` (a git-ignored
directory), stamps ``clock64()`` into that copy of
``csrc/fold_block_bwd_mma.cu`` at the boundaries of its steps (warp 0, lane 0
of every block, summed over the block's windows: step 1 to y1, step 2 to dy1,
step 3's heads, dxa, dx), builds the copy, and runs ``fold_block_bwd`` at the
four 4-frame flagship geometries (``chip_smoke.py``'s operands, bf16,
shifted) at ``--batch`` clips.  Per geometry it prints one JSON line: the
wrapper's ms (``chip_smoke.cuda_ms``), the clocks per window of each step,
and the device ms of each kernel of the call by the profiler:

    python tools/block_bwd_clocks_torch.py [--batch 4] [--out log_dir/block_bwd_clocks]

The stamps cost a ``__syncwarp`` and a clock read each; read the shares, not
the absolute time, from the clocks.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = "csrc/fold_block_bwd_mma.cu"
STEPS = ("step1", "step2", "step3_heads", "dxa", "dx")

# (marker in the kernel, the marker with a stamp before or after it)
_LOOP = "  int seq = 0;\n\n  for (long long widx = wbeg; widx < wend; ++widx) {\n"
_END = ("named_barrier(1, kConsumers);  // the next window's tiles overlay other warps' dxa "
        "rows\n  }\n")
_MARKS = (
    ("namespace vadcl {\n\nconstexpr int kBbBlocks",
     "namespace vadcl {\n__device__ unsigned long long g_bb_clk[8];\n\nconstexpr int kBbBlocks"),
    (_LOOP, "  int seq = 0;\n  unsigned long long bbacc[5] = {0, 0, 0, 0, 0}, bbt = 0;\n"
            "#define BBT(k) do { __syncwarp(); const unsigned long long now = clock64(); "
            "if ((k) > 0) bbacc[(k) - 1] += now - bbt; bbt = now; } while (0)\n\n"
            "  for (long long widx = wbeg; widx < wend; ++widx) {\n"),
    ("    // ---- step 1: y1", "    BBT(0);\n    // ---- step 1: y1"),
    ("step 2 overlays them\n", "step 2 overlays them\n    BBT(1);\n"),
    ("z and dY tiles\n", "z and dY tiles\n    BBT(2);\n"),
    ("    // dxa = round(dqkv)", "    BBT(3);\n    // dxa = round(dqkv)"),
    ("    // dx = LN1-vjp(dxa) + dy1", "    BBT(4);\n    // dx = LN1-vjp(dxa) + dy1"),
    (_END, _END.replace("\n  }\n", "\n    BBT(5);\n  }\n") +
     "  if (strip == 0 && lane == 0) {\n    for (int k = 0; k < 5; ++k) atomicAdd(&g_bb_clk[k], "
     "bbacc[k]);\n    atomicAdd(&g_bb_clk[5], (unsigned long long)(wend - wbeg));\n  }\n"),
)
_READ = """
extern "C" int vadcl_bb_clk(unsigned long long* out) {
  cudaMemcpyFromSymbol(out, vadcl::g_bb_clk, sizeof(unsigned long long) * 8);
  const unsigned long long zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  return (int)cudaMemcpyToSymbol(vadcl::g_bb_clk, zero, sizeof(zero));
}
"""


def instrument(out: str) -> None:
    """The tree's package copied into ``out`` with the stamps in its kernel."""
    dst = os.path.join(out, "vadcl_tpu_torch")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(HERE, "vadcl_tpu_torch"), dst,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    path = os.path.join(dst, SOURCE)
    text = open(path).read()
    for marker, stamped in _MARKS:
        if text.count(marker) != 1:
            raise RuntimeError(f"{SOURCE}: marker {marker[:40]!r} is not there once")
        text = text.replace(marker, stamped)
    with open(path, "w") as f:
        f.write(text + _READ)


def measure(batch: int) -> None:
    """Runs inside the instrumented copy (first on ``sys.path``)."""
    import ctypes

    import torch
    from torch.profiler import ProfilerActivity, profile

    from vadcl_tpu_torch.ops import cuda_lib  # (the instrumented copy: first on the path)
    from vadcl_tpu_torch.ops.fold_attn import fold_block_bwd

    sys.path.append(HERE)
    import chip_smoke as smoke

    lib = cuda_lib.library()
    print(json.dumps({"card": smoke.smi_line(), "build_s": cuda_lib.build_seconds}))
    gen = torch.Generator().manual_seed(5)
    clk = (ctypes.c_ulonglong * 8)()
    for gname, (dhwc, nh, window, shift) in smoke.FOLD_GEOMETRIES.items():
        a = smoke._fold_bwd_case((batch, *dhwc), nh, window, shift, torch.bfloat16, gen)
        blk = smoke._block_bwd_case(a, gen)
        ms = smoke.cuda_ms(lambda: fold_block_bwd(**blk))
        torch.cuda.synchronize()
        lib.vadcl_bb_clk(clk)  # (clears what the timing left)
        fold_block_bwd(**blk)
        torch.cuda.synchronize()
        lib.vadcl_bb_clk(clk)
        windows = max(int(clk[5]), 1)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fold_block_bwd(**blk)
            torch.cuda.synchronize()
        by_name = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                name = e.name.split("<")[0].split("(")[0].split("::")[-1]
                by_name[name] = by_name.get(name, 0.0) + e.device_time_total / 1e3 / 5
        print(json.dumps({
            "geometry": gname, "batch": batch, "shifted": True, "ms": round(ms, 4),
            "clocks_per_window": {s: int(clk[k]) // windows for k, s in enumerate(STEPS)},
            "kernel_ms": {k: round(v, 4) for k, v in sorted(by_name.items(),
                                                          key=lambda kv: -kv[1])}}))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--out", default=os.path.join(HERE, "log_dir", "block_bwd_clocks"))
    ap.add_argument("--measure", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.measure:
        measure(args.batch)
        return
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("the clocks need a CUDA device")
    instrument(args.out)
    env = dict(os.environ, PYTHONPATH=os.path.abspath(args.out))
    subprocess.run([sys.executable, os.path.abspath(__file__), "--measure", "--batch",
                    str(args.batch)], env=env, check=True, timeout=1800)


if __name__ == "__main__":
    main()
