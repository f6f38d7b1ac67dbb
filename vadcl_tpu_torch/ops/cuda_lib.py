"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source compiles in its own ``nvcc`` process, all started together,
and one more ``nvcc`` links the objects into a single shared library with a
plain C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -c -o <name>.o csrc/<name>.cu      (one per source)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o libvadcl_kernels.so *.o

The build runs at first use, from the package's own sources, into
``vadcl_tpu_torch/_build/<hash of sources and flags>/``; a later process with
the same sources loads the cached library.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C entry points: name -> (argtypes, restype)
_SIGNATURES = {
    "vadcl_fold_attn": ([_P] * 10 + [_I] * 12 + [_F, _I, _I, _P], _I),
    "vadcl_fold_attn_bf16": ([_P] * 9 + [_I] * 12 + [_F, _I, _I, _P], _I),
    "vadcl_fold_attn_smem_bytes": ([_I] * 4, _L),
    "vadcl_fold_attn_packed": ([_P] * 10 + [_I] * 12 + [_F, _I, _I, _P], _I),
    "vadcl_fold_block": ([_P] * 16 + [_I] * 13 + [_F, _I, _P], _I),
    "vadcl_fold_block_smem_bytes": ([_I] * 4, _L),
    "vadcl_fold_block_bf16": ([_P] * 14 + [_I] * 13 + [_F, _P], _I),
    "vadcl_fold_block_bf16_smem_bytes": ([_I] * 3, _L),
    "vadcl_ln_mlp": ([_P] * 8 + [_I] * 4 + [_P], _I),
    "vadcl_ln_mlp_smem_bytes": ([_I], _L),
    "vadcl_ln_mlp_bf16": ([_P] * 7 + [_I] * 3 + [_P], _I),
    "vadcl_ln_mlp_tokens": ([_I], _I),
    "vadcl_ln_mlp_slab": ([_P] * 8 + [_I] * 3 + [_P], _I),
    "vadcl_ln_mlp_slab_shape": ([_I], _I),
    "vadcl_ln_mlp_slab_smem_bytes": ([_I] * 3, _L),
    "vadcl_fold_attn_bwd": ([_P] * 18 + [_I] * 12 + [_F, _I, _I, _P], _I),
    "vadcl_fold_attn_bwd_smem_bytes": ([_I] * 4, _L),
    "vadcl_fold_attn_bwd_workspace_bytes": ([_I] * 10, _L),
    "vadcl_fold_block_bwd": ([_P] * 30 + [_I] * 13 + [_F, _I, _P], _I),
    "vadcl_fold_block_bwd_smem_bytes": ([_I] * 4, _L),
    "vadcl_fold_block_bwd_workspace_bytes": ([_I] * 11, _L),
    "vadcl_fold_block_bwd_bf16": ([_P] * 26 + [_I] * 13 + [_F, _P], _I),
    "vadcl_fold_block_bwd_bf16_smem_bytes": ([_I] * 3, _L),
    "vadcl_fold_block_bwd_bf16_workspace_bytes": ([_I] * 10, _L),
    "vadcl_window_attn": ([_P] * 8 + [_I] * 5 + [_F, _I, _P], _I),
    "vadcl_window_attn_packed": ([_P] * 8 + [_I] * 5 + [_F, _I, _P], _I),
    "vadcl_window_attn_smem_bytes": ([_I] * 4, _L),
    "vadcl_window_attn_rows": ([_P] * 9 + [_I] * 5 + [_F, _I, _P], _I),
    "vadcl_window_attn_rows_packed": ([_P] * 9 + [_I] * 5 + [_F, _I, _P], _I),
    "vadcl_window_attn_rows_smem_bytes": ([_I] * 4, _L),
    "vadcl_window_attn_rows_workspace_bytes": ([_I] * 4, _L),
    "vadcl_window_attn_rows_group": ([_I] * 4, _I),
    "vadcl_window_attn_rows_group_smem_bytes": ([_I] * 4, _L),
    "vadcl_window_attn_bwd": ([_P] * 14 + [_I] * 5 + [_F, _I, _P], _I),
    "vadcl_window_attn_bwd_rows": ([_P] * 15 + [_I] * 5 + [_F, _I, _P], _I),
    "vadcl_window_attn_bwd_rows_smem_bytes": ([_I] * 4, _L),
    "vadcl_window_attn_bwd_rows_workspace_bytes": ([_I] * 5, _L),
    "vadcl_window_attn_bwd_rows_dbias_bytes": ([_I] * 3, _L),
    "vadcl_window_attn_bwd_rows_group": ([_I] * 4, _I),
    "vadcl_window_attn_bwd_rows_group_smem_bytes": ([_I] * 4, _L),
    "vadcl_window_attn_bwd_smem_bytes": ([_I] * 4, _L),
    "vadcl_window_attn_bwd_workspace_bytes": ([_I] * 5, _L),
    "vadcl_ln_mlp_bwd": ([_P] * 15 + [_I] * 4 + [_P], _I),
    "vadcl_ln_mlp_bwd_workspace_bytes": ([_I] * 3, _L),
    "vadcl_ln_mlp_bwd_tokens": ([_I], _I),
    "vadcl_ln_mlp_bwd_bf16": ([_P] * 14 + [_I] * 3 + [_P], _I),
    "vadcl_ln_mlp_bwd_bf16_workspace_bytes": ([_I] * 3, _L),
    "vadcl_ln_mlp_bwd_bf16_smem_bytes": ([_I], _L),
    "vadcl_ln_mlp_bwd_slab": ([_P] * 15 + [_I] * 3 + [_P], _I),
    "vadcl_ln_mlp_bwd_slab_shape": ([_I], _I),
    "vadcl_ln_mlp_bwd_slab_smem_bytes": ([_I] * 2, _L),
    "vadcl_ln_mlp_bwd_slab_workspace_bytes": ([_I] * 3, _L),
    "vadcl_fold_attn_bwd_bf16": ([_P] * 17 + [_I] * 12 + [_F, _I, _I, _P], _I),
    "vadcl_fold_attn_bwd_bf16_smem_bytes": ([_I] * 3, _L),
    "vadcl_fold_attn_bwd_bf16_workspace_bytes": ([_I] * 10, _L),
    "vadcl_fold_attn_bwd_bf16_dbias_partials": ([_I] * 10, _L),
    "vadcl_cluster_assign": ([_P] * 6 + [_I] * 3 + [_F, _P], _I),
    "vadcl_cluster_assign_scratch": ([_I] * 3, _L),
    "vadcl_cluster_assign_shape": ([_I], _I),
    "vadcl_space_cluster_loss": ([_P] * 4 + [_I] * 4 + [_F, _P], _I),
    "vadcl_space_cluster_scratch": ([_I, _I], _L),
    "vadcl_error_string": ([_I], ctypes.c_char_p),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # wall time of this process's build, if any


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the CUDA kernels cannot be built"
    )


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile the library if this source hash has not been built yet;
    returns its path."""
    global build_seconds
    out_dir = BUILD_ROOT / _source_hash()
    lib_path = out_dir / "libvadcl_kernels.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp_dir:
        objs, procs = [], []
        for src in sources():
            obj = os.path.join(tmp_dir, src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
                   "-c", "-o", obj, str(src)]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
            objs.append(obj)
        logs = [(cmd, proc.communicate()[0], proc.returncode) for cmd, proc in procs]
        for cmd, log, rc in logs:
            if rc != 0:
                raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{log}")
            if verbose:
                print(log)
        tmp_lib = os.path.join(tmp_dir, lib_path.name)
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", tmp_lib, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp_lib, lib_path)  # atomic: concurrent builds race harmlessly
    build_seconds = time.perf_counter() - t0
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error (a refused or failed launch)."""
    if err != 0:
        msg = library().vadcl_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def aligned(t):
    """``t`` contiguous with a 32-byte aligned base, as the tensor-core
    tile loads (WMMA) require of the weight matrices and the 16-byte vector
    loads of the redesigned kernels of their inputs."""
    t = t.contiguous()
    return t if t.data_ptr() % 32 == 0 else t.clone()


def stream_ptr(t) -> int:
    """Handle of PyTorch's current stream on the tensor's device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
