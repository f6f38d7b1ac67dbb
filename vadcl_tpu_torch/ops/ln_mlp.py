"""Kernel B: the fused LN2 -> MLP -> residual tail of a Swin block.

Replaces ``vadcl_tpu/ops/pallas_mlp.py:_fwd_kernel`` (entry
``fused_ln_mlp``).  The CUDA kernel is ``csrc/ln_mlp.cu``: one block per
token tile, walking the 4C hidden width in chunks so the hidden activation
never reaches device memory; bf16 runs on the tensor cores and needs
C % 16 == 0, C <= 192 and a hidden width divisible by 128.

On a CPU tensor ``ln_mlp`` runs ``ln_mlp_plain``; on a CUDA tensor it
launches the kernel or raises.  Bounds on the card and what the simple
design leaves are in the header of ``csrc/ln_mlp.cu``.
"""

from __future__ import annotations

import torch

from vadcl_tpu_torch.ops import cuda_lib
from vadcl_tpu_torch.ops.fold_attn import _f32, _ln_fast


def gelu_exact_f32(h32: torch.Tensor) -> torch.Tensor:
    """Exact-erf GELU in fp32."""
    return h32 * 0.5 * (1.0 + torch.erf(h32 * 0.7071067811865476))


def ln_mlp_plain(x, ln_scale, ln_bias, w1, b1, w2, b2) -> torch.Tensor:
    """Plain PyTorch version of kernel B with ``_fwd_kernel``'s cast
    boundaries: z = LN2(x) and h = z.W1 + b1 and g = gelu(h) round to the
    compute dtype; products accumulate in fp32; b2 and the residual are
    fp32.  GELU is exact erf (the Pallas kernel's A&S erf differs by at most
    1.5e-7 before rounding)."""
    dt = x.dtype
    x32 = x.float()
    z = _ln_fast(x32, ln_scale, ln_bias).to(dt).float()
    h = (z @ w1.to(dt).float() + b1.float()).to(dt).float()
    g = gelu_exact_f32(h).to(dt).float()
    o = g @ w2.to(dt).float() + b2.float()
    return (x32 + o).to(dt)


def ln_mlp(x, ln_scale, ln_bias, w1, b1, w2, b2) -> torch.Tensor:
    """``y = x + fc2(gelu(fc1(LN(x))))`` over the last axis of x (any
    leading shape); same contract as ``fused_ln_mlp``."""
    if x.device.type == "cpu":
        return ln_mlp_plain(x, ln_scale, ln_bias, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"ln_mlp: unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"ln_mlp: dtype {x.dtype} not supported")
    shape = x.shape
    c = shape[-1]
    ch = w1.shape[1]
    if tuple(w1.shape) != (c, ch) or tuple(w2.shape) != (ch, c):
        raise ValueError(f"ln_mlp: weights {tuple(w1.shape)}, {tuple(w2.shape)} vs C={c}")
    if x.dtype == torch.bfloat16 and (c % 16 or c > 192 or ch % 128):
        raise NotImplementedError(
            f"ln_mlp: the bf16 kernel runs on 16x16 tensor-core tiles and needs "
            f"C % 16 == 0, C <= 192 and a hidden width divisible by 128 "
            f"(got C={c}, hidden {ch})"
        )
    dev, dt = x.device, x.dtype
    x2 = x.reshape(-1, c).contiguous()
    y = torch.empty_like(x2)
    w1c = cuda_lib.aligned(w1.detach().to(device=dev, dtype=dt))
    w2c = cuda_lib.aligned(w2.detach().to(device=dev, dtype=dt))
    ls, lb = _f32(ln_scale, c, dev), _f32(ln_bias, c, dev)
    b1c, b2c = _f32(b1, ch, dev), _f32(b2, c, dev)
    lib = cuda_lib.library()
    err = lib.vadcl_ln_mlp(
        x2.data_ptr(), ls.data_ptr(), lb.data_ptr(), w1c.data_ptr(),
        b1c.data_ptr(), w2c.data_ptr(), b2c.data_ptr(), y.data_ptr(),
        x2.shape[0], c, ch, int(dt == torch.bfloat16), cuda_lib.stream_ptr(x2),
    )
    cuda_lib.check(err, "ln_mlp")
    ln_mlp.launches += 1
    return y.reshape(shape)


ln_mlp.launches = 0
