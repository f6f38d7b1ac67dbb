"""Windowed, shifted 3D attention primitives (``vadcl_tpu/ops/window.py``).

Window partition/reverse are reshapes; the shift mask and the relative
position index are host numpy constants (copied verbatim from the JAX
package), moved to the device by the caller.  ``window_attention`` is the
plain (unfused) multi-head window attention of the JAX default config.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

Tri = Tuple[int, int, int]


def window_partition(x: torch.Tensor, window_size: Tri) -> torch.Tensor:
    """(B, D, H, W, C) -> (B * nW, wd*wh*ww, C), windows in (d, h, w) order."""
    B, D, H, W, C = x.shape
    wd, wh, ww = window_size
    x = x.reshape(B, D // wd, wd, H // wh, wh, W // ww, ww, C)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(-1, wd * wh * ww, C)


def window_reverse(
    windows: torch.Tensor, window_size: Tri, B: int, D: int, H: int, W: int
) -> torch.Tensor:
    """Inverse of window_partition."""
    wd, wh, ww = window_size
    C = windows.shape[-1]
    x = windows.reshape(B, D // wd, H // wh, W // ww, wd, wh, ww, C)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(B, D, H, W, C)


def get_window_size(
    x_size: Sequence[int],
    window_size: Sequence[int],
    shift_size: Optional[Sequence[int]] = None,
):
    """Shrink the window to the input and zero the shift on collapsed axes
    (``model/swin_transformer.py:71-84``)."""
    use_window = list(window_size)
    use_shift = list(shift_size) if shift_size is not None else None
    for i, s in enumerate(x_size):
        if s <= window_size[i]:
            use_window[i] = s
            if use_shift is not None:
                use_shift[i] = 0
    if use_shift is None:
        return tuple(use_window)
    return tuple(use_window), tuple(use_shift)


@lru_cache(maxsize=None)
def relative_position_index(window_size: Tri) -> np.ndarray:
    """(N, N) int32 index into the (2wd-1)(2wh-1)(2ww-1) bias table of the
    *configured* window.  When the runtime window is smaller, callers slice
    ``[:N, :N]`` exactly as the reference's forward does."""
    wd, wh, ww = window_size
    coords = np.stack(
        np.meshgrid(np.arange(wd), np.arange(wh), np.arange(ww), indexing="ij")
    )  # 3, wd, wh, ww
    flat = coords.reshape(3, -1)
    rel = flat[:, :, None] - flat[:, None, :]  # 3, N, N
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += wd - 1
    rel[:, :, 1] += wh - 1
    rel[:, :, 2] += ww - 1
    rel[:, :, 0] *= (2 * wh - 1) * (2 * ww - 1)
    rel[:, :, 1] *= 2 * ww - 1
    return rel.sum(-1).astype(np.int32)


@lru_cache(maxsize=None)
def compute_attn_mask(
    Dp: int, Hp: int, Wp: int, window_size: Tri, shift_size: Tri
) -> Optional[np.ndarray]:
    """Shifted-window attention mask, (nW, N, N) float32 of {0, -100}, or
    None when no axis is shifted (``model/swin_transformer.py:320-333``)."""
    if not any(s > 0 for s in shift_size):
        return None
    img_mask = np.zeros((1, Dp, Hp, Wp, 1), dtype=np.float32)
    cnt = 0
    for d in (
        slice(-window_size[0]),
        slice(-window_size[0], -shift_size[0] if shift_size[0] else None),
        slice(-shift_size[0], None) if shift_size[0] else slice(0, 0),
    ):
        for h in (
            slice(-window_size[1]),
            slice(-window_size[1], -shift_size[1] if shift_size[1] else None),
            slice(-shift_size[1], None) if shift_size[1] else slice(0, 0),
        ):
            for w in (
                slice(-window_size[2]),
                slice(-window_size[2], -shift_size[2] if shift_size[2] else None),
                slice(-shift_size[2], None) if shift_size[2] else slice(0, 0),
            ):
                img_mask[:, d, h, w, :] = cnt
                cnt += 1
    wd, wh, ww = window_size
    m = img_mask.reshape(
        1, Dp // wd, wd, Hp // wh, wh, Wp // ww, ww, 1
    ).transpose(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, wd * wh * ww)
    attn_mask = m[:, None, :] - m[:, :, None]
    return np.where(attn_mask != 0, np.float32(-100.0), np.float32(0.0))


def window_attention(
    x_windows: torch.Tensor,  # (Bn, N, C) compute dtype
    qkv_w: torch.Tensor,  # (C, 3C)
    qkv_b: Optional[torch.Tensor],  # (3C,)
    proj_w: torch.Tensor,  # (C, C)
    proj_b: Optional[torch.Tensor],  # (C,)
    bias: torch.Tensor,  # (nH, N, N) fp32 relative-position bias
    num_heads: int,
    mask: Optional[torch.Tensor] = None,  # (nW, N, N) fp32
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Multi-head window attention with relative position bias and optional
    shift mask (``vadcl_tpu/ops/window.py:window_attention``): q is scaled
    before the scores, scores and softmax are fp32, the value product
    accumulates in fp32 and rounds to the compute dtype."""
    Bn, N, C = x_windows.shape
    dt = x_windows.dtype
    head_dim = C // num_heads
    scale = scale if scale is not None else head_dim**-0.5

    qkv = x_windows @ qkv_w.to(dt)
    if qkv_b is not None:
        qkv = qkv + qkv_b.to(dt)
    qkv = qkv.reshape(Bn, N, 3, num_heads, head_dim).permute(2, 0, 3, 1, 4)
    q = qkv[0] * torch.tensor(scale, dtype=dt)
    k, v = qkv[1], qkv[2]  # (Bn, nH, N, hd)

    attn = q.float() @ k.float().transpose(-2, -1)  # (Bn, nH, N, N) fp32
    attn = attn + bias[None]
    if mask is not None:
        nW = mask.shape[0]
        attn = attn.reshape(Bn // nW, nW, num_heads, N, N) + mask[None, :, None]
        attn = attn.reshape(Bn, num_heads, N, N)
    attn = torch.softmax(attn, dim=-1).to(dt)
    out = (attn.float() @ v.float()).to(dt)
    out = out.transpose(1, 2).reshape(Bn, N, C)
    out = out @ proj_w.to(dt)
    if proj_b is not None:
        out = out + proj_b.to(dt)
    return out
