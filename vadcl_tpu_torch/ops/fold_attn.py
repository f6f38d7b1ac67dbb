"""Kernel A: folded Swin window attention with LN1 and the residual fused.

Replaces ``vadcl_tpu/ops/pallas_attn_fold.py:_fold_kernel`` (entry
``fused_window_attention_folded``, reached through
``folded_block_attention_trainable``).  The CUDA kernel is
``csrc/fold_attn.cu``: one block per (batch, window) that addresses the
window's tokens in the unpartitioned (B, D, H, W, C) tensor by strides;
bf16 runs on the tensor cores and needs C and head_dim to be multiples of 16.

On a CPU tensor ``fold_attention`` runs ``fold_attention_plain``; on a CUDA
tensor it launches the kernel or raises.  Bounds on the card and what the
simple design leaves are in the header of ``csrc/fold_attn.cu``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from vadcl_tpu_torch.ops import cuda_lib
from vadcl_tpu_torch.ops.window import window_partition, window_reverse

Tri = Tuple[int, int, int]


def _ln_fast(x32: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """flax LayerNorm numerics in fp32: fast variance, eps 1e-5."""
    mu = x32.mean(-1, keepdim=True)
    var = torch.clamp((x32 * x32).mean(-1, keepdim=True) - mu * mu, min=0.0)
    return (x32 - mu) * torch.rsqrt(var + 1e-5) * scale.float() + bias.float()


def fold_attention_plain(
    x: torch.Tensor,  # (B, D, H, W, C) compute dtype, already rolled if shifted
    ln_scale: Optional[torch.Tensor],  # (C,) or None: no LN1
    ln_bias: Optional[torch.Tensor],
    qkv_w: torch.Tensor,  # (C, 3C)
    qkv_b: Optional[torch.Tensor],  # (3C,)
    proj_w: torch.Tensor,  # (C, C)
    proj_b: torch.Tensor,  # (C,)
    bias: torch.Tensor,  # (nH, N, N) fp32
    mask: Optional[torch.Tensor],  # (nW, N, N) fp32 or None
    num_heads: int,
    window: Tri,
    scale: float,
    residual: bool = True,
    shift: Tri = (0, 0, 0),
) -> torch.Tensor:
    """Plain PyTorch version of kernel A with the kernel's cast boundaries:
    LN output, qkv, softmax probabilities and the per-head output round to
    the compute dtype; every product accumulates in fp32; scores are scaled
    after the q.k product; bias, mask, softmax and the residual are fp32.
    A non-zero ``shift`` is the shifted-window roll: the result is
    ``roll(f(roll(x, -shift)), shift)``."""
    if any(shift):
        y = fold_attention_plain(
            torch.roll(x, tuple(-s for s in shift), (1, 2, 3)), ln_scale, ln_bias,
            qkv_w, qkv_b, proj_w, proj_b, bias, mask, num_heads, window, scale,
            residual,
        )
        return torch.roll(y, tuple(shift), (1, 2, 3))
    B, D, H, W, C = x.shape
    dt = x.dtype
    hd = C // num_heads
    wins = window_partition(x, window)  # (B*nW, N, C)
    Bn, N, _ = wins.shape
    if ln_scale is not None:
        y = _ln_fast(wins.float(), ln_scale, ln_bias).to(dt)
    else:
        y = wins
    qkv = y.float() @ qkv_w.to(dt).float()
    if qkv_b is not None:
        qkv = qkv + qkv_b.float()
    qkv = qkv.to(dt).reshape(Bn, N, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0].float(), qkv[1].float(), qkv[2].float()  # (Bn, nH, N, hd)
    s = (q @ k.transpose(-2, -1)) * scale + bias[None]
    if mask is not None:
        nW = mask.shape[0]
        s = (s.reshape(Bn // nW, nW, num_heads, N, N) + mask[None, :, None]).reshape(
            Bn, num_heads, N, N
        )
    p = torch.softmax(s, dim=-1).to(dt).float()
    o = (p @ v).to(dt)  # (Bn, nH, N, hd)
    o = o.transpose(1, 2).reshape(Bn, N, C)
    out = o.float() @ proj_w.to(dt).float() + proj_b.float()
    if residual:
        out = out + wins.float()
    return window_reverse(out.to(dt), window, B, D, H, W)


def fold_attention(
    x: torch.Tensor,
    ln_scale: Optional[torch.Tensor],
    ln_bias: Optional[torch.Tensor],
    qkv_w: torch.Tensor,
    qkv_b: Optional[torch.Tensor],
    proj_w: torch.Tensor,
    proj_b: torch.Tensor,
    bias: torch.Tensor,
    mask: Optional[torch.Tensor],
    num_heads: int,
    window: Tri,
    scale: float,
    residual: bool = True,
    shift: Tri = (0, 0, 0),
) -> torch.Tensor:
    """``x + proj(attn(LN1(x)))`` per window (without ``+ x`` when not
    ``residual``), computed on the unpartitioned tensor.  With ``shift`` the
    shifted-window roll is folded in (``mask`` is then the shifted blocks'
    mask).  With a zero shift, the contract of
    ``fused_window_attention_folded(..., ln_scale=, ln_bias=, residual=)``."""
    args = (x, ln_scale, ln_bias, qkv_w, qkv_b, proj_w, proj_b, bias, mask,
            num_heads, window, scale, residual, tuple(shift))
    if x.device.type == "cpu":
        return fold_attention_plain(*args)
    if x.device.type != "cuda":
        raise ValueError(f"fold_attention: unsupported device {x.device}")
    return _fold_attention_cuda(*args)


fold_attention.launches = 0


def _f32(t: Optional[torch.Tensor], n: int, device) -> torch.Tensor:
    if t is None:
        return torch.zeros(n, dtype=torch.float32, device=device)
    return t.detach().to(device=device, dtype=torch.float32).contiguous()


def _fold_attention_cuda(x, ln_scale, ln_bias, qkv_w, qkv_b, proj_w, proj_b,
                         bias, mask, num_heads, window, scale, residual, shift):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fold_attention: dtype {x.dtype} not supported")
    B, D, H, W, C = x.shape
    wd, wh, ww = window
    n = wd * wh * ww
    if C % num_heads or D % wd or H % wh or W % ww:
        raise ValueError(
            f"fold_attention: shape {tuple(x.shape)} is not window-divisible "
            f"by {window} / heads {num_heads}"
        )
    if x.dtype == torch.bfloat16 and (C % 16 or (C // num_heads) % 16):
        raise NotImplementedError(
            f"fold_attention: the bf16 kernel runs on 16x16 tensor-core tiles and "
            f"needs C and head_dim to be multiples of 16 (got C={C}, "
            f"head_dim={C // num_heads})"
        )
    nw = (D // wd) * (H // wh) * (W // ww)
    if tuple(bias.shape) != (num_heads, n, n):
        raise ValueError(f"fold_attention: bias {tuple(bias.shape)} != {(num_heads, n, n)}")
    if mask is not None and tuple(mask.shape) != (nw, n, n):
        raise ValueError(f"fold_attention: mask {tuple(mask.shape)} != {(nw, n, n)}")
    lib = cuda_lib.library()
    is_bf16 = int(x.dtype == torch.bfloat16)
    smem = lib.vadcl_fold_attn_smem_bytes(n, C, num_heads, is_bf16)
    if smem > 232448:
        raise NotImplementedError(
            f"fold_attention: window of {n} tokens at C={C} needs {smem} B of "
            "shared memory per block (> 227 KB); a tiled variant is still to port"
        )
    dev = x.device
    dt = x.dtype
    xc = x.contiguous()
    out = torch.empty_like(xc)
    has_ln = ln_scale is not None
    ln_s = _f32(ln_scale, C, dev) if has_ln else None
    ln_b = _f32(ln_bias, C, dev) if has_ln else None
    qw = cuda_lib.aligned(qkv_w.detach().to(device=dev, dtype=dt))
    pw = cuda_lib.aligned(proj_w.detach().to(device=dev, dtype=dt))
    qb = _f32(qkv_b, 3 * C, dev)
    pb = _f32(proj_b, C, dev)
    bs = bias.detach().to(device=dev, dtype=torch.float32).contiguous()
    mk = (
        mask.detach().to(device=dev, dtype=torch.float32).contiguous()
        if mask is not None else None
    )
    err = lib.vadcl_fold_attn(
        xc.data_ptr(),
        ln_s.data_ptr() if has_ln else None,
        ln_b.data_ptr() if has_ln else None,
        qw.data_ptr(), qb.data_ptr(), pw.data_ptr(), pb.data_ptr(),
        bs.data_ptr(), mk.data_ptr() if mk is not None else None,
        out.data_ptr(),
        B, D, H, W, C, num_heads, wd, wh, ww, shift[0] % D, shift[1] % H,
        shift[2] % W, float(scale), int(bool(residual)), is_bf16,
        cuda_lib.stream_ptr(xc),
    )
    cuda_lib.check(err, "fold_attention")
    fold_attention.launches += 1
    return out
