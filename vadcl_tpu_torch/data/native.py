"""ctypes bridge to the threaded C++ JPEG decoder (the port's copy of
``vadcl_tpu/data/native.py``).

Builds ``native/vadcl_decode.cpp`` (read, never edited) at first use with
``g++ -O3 ... -ljpeg`` into the port's own build directory,
``vadcl_tpu_torch/_build/native-<source hash>/libvadcl_decode.so``: a
changed source builds anew, and nothing is written to ``native/_build/``,
which the JAX package's loader owns.  The build goes to a temporary name
and is renamed into place, so processes that build at once do not see a
half-written library.  Where ``g++`` or libjpeg is missing the bridge
reports itself unavailable and ``data/dataset.py:load_clip`` decodes with
PIL, as the JAX package does.  See the C++ file for the ABI.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(_PKG), "native", "vadcl_decode.cpp")
BUILD_ROOT = os.path.join(_PKG, "_build")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
last_error: Optional[str] = None  # why the last build or load failed


def library_path() -> str:
    """Where the library for the current source lives."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_ROOT, f"native-{digest}", "libvadcl_decode.so")


def build(so: str) -> None:
    """Compile the decoder into ``so``; raises with the compiler's output."""
    os.makedirs(os.path.dirname(so), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(so))
    os.close(fd)
    cmd = ["g++", "-O3", "-fPIC", "-shared", "-std=c++17", "-pthread", _SRC, "-o", tmp,
           "-ljpeg"]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        if out.returncode != 0:
            raise RuntimeError(f"native decoder build failed: {out.stderr[-2000:]}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _bind(so: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(so)
    batch_args = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int,
                  ctypes.POINTER(ctypes.c_float), ctypes.c_int]
    lib.vadcl_decode_resize_batch.restype = ctypes.c_int
    lib.vadcl_decode_resize_batch.argtypes = batch_args
    if hasattr(lib, "vadcl_decode_resize_batch_u8"):
        lib.vadcl_decode_resize_batch_u8.restype = ctypes.c_int
        lib.vadcl_decode_resize_batch_u8.argtypes = batch_args[:4] + [
            ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, building it at the first call; None where it
    cannot be built or loaded (``last_error`` says why)."""
    global _lib, _tried, last_error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            so = library_path()
            if not os.path.exists(so):
                build(so)
            _lib = _bind(so)
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            last_error, _lib = f"{type(e).__name__}: {e}", None
        return _lib


def available() -> bool:
    return get_lib() is not None


def _decode(entry: str, paths: Sequence[str], size: Tuple[int, int], dtype, ctype,
            num_threads: int) -> np.ndarray:
    lib = get_lib()
    if lib is None or not hasattr(lib, entry):
        raise RuntimeError(f"native decoder unavailable ({last_error})")
    n = len(paths)
    h, w = size
    out = np.empty((n, h, w, 3), dtype)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    rc = getattr(lib, entry)(arr, n, h, w, out.ctypes.data_as(ctypes.POINTER(ctype)),
                             num_threads)
    if rc != 0:
        raise IOError(f"native decode failed for {paths[rc - 1]!r}")
    return out


def decode_resize_batch(paths: Sequence[str], size: Tuple[int, int],
                        num_threads: int = 8) -> np.ndarray:
    """paths -> (N, H, W, 3) float32 in [0, 1].  Raises on decode failure."""
    return _decode("vadcl_decode_resize_batch", paths, size, np.float32, ctypes.c_float,
                   num_threads)


def has_u8() -> bool:
    lib = get_lib()
    return lib is not None and hasattr(lib, "vadcl_decode_resize_batch_u8")


def decode_resize_batch_u8(paths: Sequence[str], size: Tuple[int, int],
                           num_threads: int = 8) -> np.ndarray:
    """paths -> (N, H, W, 3) uint8 on the PIL quantisation grid (the
    reference pipeline's resize-as-uint8-image point).  Raises on failure."""
    return _decode("vadcl_decode_resize_batch_u8", paths, size, np.uint8, ctypes.c_ubyte,
                   num_threads)
