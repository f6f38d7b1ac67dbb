"""3D convolution primitives with torch semantics over NDHWC tensors
(``vadcl_tpu/ops/convs.py``).

Public functions keep the JAX package's channels-last layout; internally they
permute to NCDHW for ``F.conv3d`` / ``F.conv_transpose3d``.  Weights are in
PyTorch's layouts: Conv3d (Cout, Cin, kd, kh, kw), ConvTranspose3d
(Cin, Cout, kd, kh, kw).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

IntOr3 = Union[int, Sequence[int]]


def _triple(v: IntOr3) -> Tuple[int, int, int]:
    if isinstance(v, int):
        return (v, v, v)
    t = tuple(int(x) for x in v)
    if len(t) != 3:
        raise ValueError(f"expected 3 values, got {v!r}")
    return t  # type: ignore[return-value]


def _ncdhw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 4, 1, 2, 3)


def _ndhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 4, 1)


def conv3d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    stride: IntOr3 = 1,
    padding: IntOr3 = 0,
) -> torch.Tensor:
    """torch.nn.Conv3d over x (B, D, H, W, C); w (Cout, Cin, kd, kh, kw).
    The bias is added after the conv in the compute dtype, as the JAX
    package does."""
    out = F.conv3d(
        _ncdhw(x), w.to(x.dtype), None, stride=_triple(stride),
        padding=_triple(padding),
    )
    out = _ndhwc(out)
    if b is not None:
        out = out + b.to(out.dtype)
    return out


def conv_transpose3d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    stride: IntOr3 = 1,
    padding: IntOr3 = 0,
    output_padding: IntOr3 = 0,
) -> torch.Tensor:
    """torch.nn.ConvTranspose3d over x (B, D, H, W, C); w (Cin, Cout, kd, kh,
    kw).  ``output_padding`` adds rows at the end of each dim (the JAX
    package writes ConvAE's k=3, s=2, p=1, output_padding=1 upsampling as a
    dilated conv padded (1, 2))."""
    out = F.conv_transpose3d(
        _ncdhw(x), w.to(x.dtype), None, stride=_triple(stride),
        padding=_triple(padding), output_padding=_triple(output_padding),
    )
    out = _ndhwc(out)
    if b is not None:
        out = out + b.to(out.dtype)
    return out


def patchify_matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Conv3d with kernel == stride as reshape + one matmul.
    x (B, D, H, W, C) with D, H, W divisible by the kernel;
    w (Cout, Cin, kd, kh, kw)."""
    cout, cin, kd, kh, kw = w.shape
    B, D, H, W, C = x.shape
    if C != cin or D % kd or H % kh or W % kw:
        raise ValueError(f"patchify: input {tuple(x.shape)} vs kernel {tuple(w.shape)}")
    x = x.reshape(B, D // kd, kd, H // kh, kh, W // kw, kw, C)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)  # B, D', H', W', kd, kh, kw, C
    x = x.reshape(B, D // kd, H // kh, W // kw, kd * kh * kw * C)
    wm = w.permute(2, 3, 4, 1, 0).reshape(kd * kh * kw * cin, cout)
    out = x @ wm.to(x.dtype)
    if b is not None:
        out = out + b.to(out.dtype)
    return out


def max_pool3d(x: torch.Tensor, kernel: IntOr3, stride: IntOr3) -> torch.Tensor:
    """Max-pool with VALID padding (a trailing row that fills no window is
    dropped), the ``reduce_window`` pools of ConvAE and UNet3D."""
    return _ndhwc(F.max_pool3d(_ncdhw(x), kernel_size=_triple(kernel), stride=_triple(stride)))


def same_pad_amounts(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """TF-style 'same' padding split of MaxPool3dSamePadding
    (``model/I3D.py:10-39``)."""
    if size % stride == 0:
        total = max(kernel - stride, 0)
    else:
        total = max(kernel - (size % stride), 0)
    front = total // 2
    return front, total - front


def max_pool3d_same(
    x: torch.Tensor, kernel: IntOr3 = 3, stride: IntOr3 = 1
) -> torch.Tensor:
    """MaxPool3dSamePadding parity.  The reference pads with **zeros**, not
    -inf, before max-pooling; that changes boundary values and is kept."""
    k = _triple(kernel)
    s = _triple(stride)
    _, D, H, W, _ = x.shape
    pd = same_pad_amounts(D, k[0], s[0])
    ph = same_pad_amounts(H, k[1], s[1])
    pw = same_pad_amounts(W, k[2], s[2])
    xp = F.pad(_ncdhw(x), (pw[0], pw[1], ph[0], ph[1], pd[0], pd[1]), value=0.0)
    return _ndhwc(F.max_pool3d(xp, kernel_size=k, stride=s))
