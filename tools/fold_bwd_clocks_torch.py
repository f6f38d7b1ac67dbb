"""Where kernel 6's tensor-core bodies spend their clocks, on one NVIDIA GPU.

Copies the tree's ``vadcl_tpu_torch`` into ``--out`` (a git-ignored
directory), stamps ``clock64()`` into that copy of
``csrc/fold_attn_bwd_mma.cu`` at the boundaries of the steps of both bodies
(the one-strip layout and the long layout; warp 0, lane 0 of every block,
summed over the windows the block walks), builds the copy, and runs
``fold_attention_bwd`` at the five shapes of the depth-chunked and long
layouts (``chip_smoke.py``'s operands, bf16, shifted, the training batch).
The steps, per window:

* ``ln1``: LN1 of the warp's rows into the row tile and ``row_ws``;
* per head ``a`` (q, k, v and doa, with their ring waits), ``a_bar`` (the
  named barrier after it), ``b`` (the row phase), ``b_bar``, ``c`` (the
  column phase and the dqkv stores) and, in the long layout, ``c_bar``
  (both once a phase);
* ``dxa_bar`` and ``dxa`` (round(dqkv) . W_qkv^T, with its ring waits);
* with head groups, ``cluster_bar`` (the cluster barrier before the
  partial dxa rows are summed) and ``reduce`` (the sum over the ranks'
  shared memory);
* ``dx`` (the LN vjp and the residual); with head groups ``dln_bar`` (the
  cluster barrier before rank 0 adds the ranks' dLN1 sums) and ``dln_sum``;
  ``end_bar`` (the barrier before the next window reuses shared memory).

Per shape and head-group setting it prints one JSON line: the wrapper's ms
(``chip_smoke.cuda_ms``), the head groups and blocks, the clocks per window
and block of each step, the clocks of them spent waiting on the weight ring,
each step's share, and the device ms of each kernel of the call by the
profiler:

    python tools/fold_bwd_clocks_torch.py [--groups auto,1] [--out log_dir/fold_bwd_clocks]

``--groups`` lists the settings to run: ``auto`` (the wrapper's
``fold_bwd_head_groups``) or a number forced on every shape (a tree
without head groups runs one group whatever is asked).  The stamps cost a
``__syncwarp`` and a clock read each; read the shares, not the absolute
time, from the clocks.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = "csrc/fold_attn_bwd_mma.cu"
STEPS = ("ln1", "a", "a_bar", "b", "b_bar", "c", "c_bar", "dxa_bar", "dxa", "cluster_bar",
         "reduce", "dx", "dln_bar", "dln_sum", "end_bar")
_SLOTS = 16  # clock slots a step list may use
# (label, source of its shape in chip_smoke.py): the long layout's two
# training-batch shapes, then the depth-chunked ones of the Video Swin-B width
SHAPES = (("(256,196,96)", "LONG_FOLD_SHAPES"), ("(64,196,192)", "LONG_FOLD_SHAPES"),
          ("(256,98,128)", "SWIN_B_FOLD_SHAPES"), ("(64,98,256)", "SWIN_B_FOLD_SHAPES"),
          ("(64,49,256)", "SWIN_B_FOLD_SHAPES"))

_CLOCK = """
__device__ unsigned long long g_fb_clk[%(n)d];
// One consumer thread's step clocks: stamp(k) closes the open step and opens
// step k (after a __syncwarp); the clocks spent in ring waits count apart.
struct FbClk {
  unsigned long long acc[%(s)d], wait[%(s)d], t, w0, windows;
  int cur;
  __device__ explicit FbClk(long long w) : t(0), w0(0), windows((unsigned long long)w), cur(0) {
    for (int k = 0; k < %(s)d; ++k) acc[k] = wait[k] = 0;
  }
  __device__ __forceinline__ void stamp(int k) {
    __syncwarp();
    const unsigned long long now = clock64();
    if (t) acc[cur] += now - t;
    t = now;
    cur = k;
  }
  __device__ __forceinline__ void wait_begin() { w0 = clock64(); }
  __device__ __forceinline__ void wait_end() { wait[cur] += clock64() - w0; }
  __device__ ~FbClk() {
    stamp(0);
    if (threadIdx.x == 0) {
      for (int k = 0; k < %(s)d; ++k) {
        atomicAdd(&g_fb_clk[k], acc[k]);
        atomicAdd(&g_fb_clk[%(s)d + k], wait[k]);
      }
      atomicAdd(&g_fb_clk[2 * %(s)d], windows);
    }
  }
};
""" % dict(n=2 * _SLOTS + 1, s=_SLOTS)
_READ = """
extern "C" int vadcl_fb_clk(unsigned long long* out) {
  cudaMemcpyFromSymbol(out, vadcl::g_fb_clk, sizeof(unsigned long long) * %(n)d);
  unsigned long long zero[%(n)d] = {0};
  return (int)cudaMemcpyToSymbol(vadcl::g_fb_clk, zero, sizeof(zero));
}
""" % dict(n=2 * _SLOTS + 1)

_LOOP = r"^([ \t]*)for \(long long widx = wbeg; widx < wend; \+\+widx\) \{\n"
# (regex of one whole line or more, the step stamped before it, the step
# stamped after it, whether the source must hold it)
_ANCHORS = (
    (r"^[ \t]*// \(a\) q, k, v of .*\n", "a", None, True),
    (r"^[ \t]*named_barrier\(1, kConsumers\);  // every strip's q, k, v, doa of head h are in\n",
     "a_bar", "b", True),
    (r"^[ \t]*// \(b\) the row phase of the warp's strip in this phase\n", "b", None, False),
    (r"^[ \t]*named_barrier\(1, kConsumers\);  // the (phase's )?P and ds tiles are complete\n",
     "b_bar", "c", True),
    (r"^[ \t]*named_barrier\(1, kConsumers\);  // every warp is done with the tiles\n",
     "c_bar", "c", False),
    (r"^[ \t]*// dxa = round\(dqkv\) \. W_qkv\^T.*\n", "dxa", None, True),
    (r"^[ \t]*named_barrier\(1, kConsumers\);\n", "dxa_bar", "dxa", False),
    (r"^.*// every rank's dxa rows are in\n", "cluster_bar", "reduce", False),
    (r"^[ \t]+// dx = LN-vjp\(dxa\).*\n", "dx", None, False),
    (r"^[ \t]*#pragma unroll 1\n\s*for \(int st = warp; st < kStrips; st \+= kFbLongWarps\)\n"
     r"[ \t]*fb_dx_strip\(", "dx", None, False),
    (r"^.*// every rank's dLN1 sums are in\n", "dln_bar", "dln_sum", False),
    (r"^.*named_barrier\(1, kConsumers\);  // the next window's .*\n", "end_bar", None, False),
    (r"^.*// the other ranks are done with this block's dxa rows\n", "end_bar", None, False),
)


def _stamp(step: str, indent: str) -> str:
    return f"{indent}fbc.stamp({STEPS.index(step)});\n"


def instrument(out: str) -> None:
    """The tree's package copied into ``out`` with the stamps in kernel 6."""
    dst = os.path.join(out, "vadcl_tpu_torch")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(HERE, "vadcl_tpu_torch"), dst,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    path = os.path.join(dst, SOURCE)
    text = open(path).read()
    marker = "namespace vadcl {\n"
    if text.count(marker) != 1:
        raise RuntimeError(f"{SOURCE}: the namespace opens more than once")
    text = text.replace(marker, marker + _CLOCK)
    loops = len(re.findall(_LOOP, text, flags=re.M))
    if loops != 2:
        raise RuntimeError(f"{SOURCE}: {loops} consumer window loops, expected 2")
    text = re.sub(_LOOP, lambda m: (f"{m.group(1)}FbClk fbc(wend - wbeg);\n{m.group(0)}"
                                    + _stamp("ln1", m.group(1) + "  ")), text, flags=re.M)
    for pattern, before, after, required in _ANCHORS:
        found = len(re.findall(pattern, text, flags=re.M))
        if required and not found:
            raise RuntimeError(f"{SOURCE}: no line matches {pattern[:50]!r}")

        def put(m, before=before, after=after):
            indent = re.match(r"\s*", m.group(0)).group(0).replace("\n", "")
            if indent.startswith("#"):
                indent = ""
            head = _stamp(before, indent or "    ")
            tail = _stamp(after, indent or "    ") if after else ""
            return head + m.group(0) + tail

        text = re.sub(pattern, put, text, flags=re.M)
    text, waits = re.subn(r"mbar_wait\(full \+ ([^;]*)\);",
                          r"{ fbc.wait_begin(); mbar_wait(full + \1); fbc.wait_end(); }", text)
    if not waits:
        raise RuntimeError(f"{SOURCE}: no ring wait found")
    with open(path, "w") as f:
        f.write(text + _READ)


def measure(settings: list) -> None:
    """Runs inside the instrumented copy (first on ``sys.path``)."""
    import contextlib
    import ctypes
    import importlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    from vadcl_tpu_torch.ops import cuda_lib  # (the instrumented copy: first on the path)
    from vadcl_tpu_torch.ops.fold_attn import fold_attention_bwd

    sys.path.append(HERE)
    import chip_smoke as smoke

    fa = importlib.import_module("vadcl_tpu_torch.ops.fold_attn")
    grouped = hasattr(fa, "fold_bwd_head_groups")
    lib = cuda_lib.library()
    lib.vadcl_fb_clk.argtypes = [ctypes.c_void_p]
    print(json.dumps({"card": smoke.smi_line(), "build_s": cuda_lib.build_seconds,
                      "head_groups": grouped}))
    clk = (ctypes.c_ulonglong * (2 * _SLOTS + 1))()

    @contextlib.contextmanager
    def forced(setting):
        if setting == "auto" or not grouped:
            yield
            return
        real = fa.fold_bwd_head_groups
        fa.fold_bwd_head_groups = lambda windows, n, c, nh: int(setting)
        try:
            yield
        finally:
            fa.fold_bwd_head_groups = real

    gen = torch.Generator().manual_seed(27)
    for label, table in SHAPES:
        (D, H, W, C), batch, nh, window = getattr(smoke, table)[label]
        a = smoke._fold_bwd_case((batch, D, H, W, C), nh, window, (0, 3, 3), torch.bfloat16,
                                 gen)
        n = window[0] * window[1] * window[2]
        windows = batch * (D // window[0]) * (H // window[1]) * (W // window[2])
        for setting in settings:
            with forced(setting):
                groups = fa.fold_bwd_head_groups(windows, n, C, nh) if grouped else 1
                blocks = (fa.fold_bwd_blocks(windows, groups) if grouped else
                          lib.vadcl_fold_attn_bwd_bf16_dbias_partials(batch, D, H, W, C, nh,
                                                                       *window))
                ms = smoke.cuda_ms(lambda: fold_attention_bwd(**a))
                torch.cuda.synchronize()
                lib.vadcl_fb_clk(clk)  # (clears what the timing left)
                fold_attention_bwd(**a)
                torch.cuda.synchronize()
                lib.vadcl_fb_clk(clk)
                walked = max(int(clk[2 * _SLOTS]), 1)
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(5):
                        fold_attention_bwd(**a)
                    torch.cuda.synchronize()
            by_name = {}
            for e in prof.events():
                if e.device_type == torch.autograd.DeviceType.CUDA:
                    name = e.name.split("<")[0].split("(")[0].split("::")[-1]
                    by_name[name] = by_name.get(name, 0.0) + e.device_time_total / 1e3 / 5
            per = {s: int(clk[k]) // walked for k, s in enumerate(STEPS)}
            total = max(sum(per.values()), 1)
            print(json.dumps({
                "shape": f"x_windows ({windows},{n},{C}) nH {nh}", "label": label,
                "setting": setting, "head_groups": groups, "blocks": blocks,
                "ms": round(ms, 4), "clocks_per_window": per,
                "ring_wait_per_window": {s: int(clk[_SLOTS + k]) // walked
                                         for k, s in enumerate(STEPS)},
                "shares": {s: round(v / total, 4) for s, v in per.items() if v},
                "kernel_ms": {k: round(v, 4) for k, v in sorted(by_name.items(),
                                                              key=lambda kv: -kv[1])}}))
        del a
        torch.cuda.empty_cache()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--groups", default="auto",
                    help="comma-separated settings: auto (the wrapper's choice) or a number")
    ap.add_argument("--out", default=os.path.join(HERE, "log_dir", "fold_bwd_clocks"))
    ap.add_argument("--instrument-only", action="store_true",
                    help="write the stamped copy and stop (no card needed)")
    ap.add_argument("--measure", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    settings = args.groups.split(",")
    if args.measure:
        measure(settings)
        return
    if not args.instrument_only:
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("the clocks need a CUDA device")
    instrument(args.out)
    if args.instrument_only:
        return
    env = dict(os.environ, PYTHONPATH=os.path.abspath(args.out))
    subprocess.run([sys.executable, os.path.abspath(__file__), "--measure", "--groups",
                    args.groups], env=env, check=True, timeout=1800)


if __name__ == "__main__":
    main()
