"""Kernels 7, 8 and 9: Swin window attention over pre-partitioned windows,
its backward, and the ``packed`` inference variant.

Counterpart of ``vadcl_tpu/ops/pallas_attn.py`` and
``vadcl_tpu/ops/pallas_attn_bwd.py``.  All three take windows ``(Bn, N, C)``,
batch-major (window ``i`` takes ``mask[i % n_windows]``), and compute
``proj(attention(x))`` with no LayerNorm and no residual; they are what
``attn_kernel="base"`` (7 forward, 8 backward) and ``"packed"`` (9, inference
only) run in every Swin block, and what a ``"fold"`` block falls back to
where its window does not fit the fold kernels' shared memory
(``ops/fold_attn.py:fold_fits``).

* ``window_attention_fused``: a ``torch.autograd.Function``, forward kernel
  7 (``_attn_kernel``), backward kernel 8; the contract of
  ``fused_window_attention_trainable``.  It saves its inputs only.
* ``window_attention_fused_bwd``: kernel 8 (``_bwd_kernel`` through
  ``_bwd_call`` and ``_bwd``).
* ``window_attention_packed``: kernel 9 (``_attn_kernel_packed``); asking it
  for a gradient raises.

Each kernel has two bodies.  The whole-tile body (``csrc/window_attn.cu``:
7 and 9 share device code behind a template flag, with an entry point each;
``csrc/window_attn_bwd.cu``, whose cross-window sums go through
``csrc/reduce.cu``) holds a whole (N, N) score tile per head in shared memory
and takes a window only where that fits 227 KB.  The row-tiled body
(``csrc/window_attn_rows.cu`` with its bf16 core and products in
``csrc/window_attn_rows_mma.cu``, ``csrc/window_attn_bwd_rows.cu`` with its
bf16 core in ``csrc/window_attn_bwd_rows_mma.cu``) walks the
keys of a 16-row strip of queries in blocks with a running max and sum and
takes every N, e.g. N = 392 (windows (8, 7, 7) of the 8-frame
reconstruction decoder; the encoder's N = 196 runs kernels A's and 6's long
layouts in bf16, below), and every head width: where K and V of one
head (the backward: also q and dout's slice) outgrow the CUDA-core core's
block, its streamed instance walks the head's channels in chunks as well
(``rows_streams``).  ``window_body`` picks the whole-tile body where it fits
and the row-tiled one elsewhere; ``tile_smem_bytes`` and ``rows_smem_bytes``
mirror the library's size functions (``chip_smoke.py`` holds them against
each other).  Each body counts its own launches: the row-tiled ones (the
streamed instances too) on ``window_attention_fused_rows``,
``window_attention_fused_bwd_rows`` and ``window_attention_packed_rows``,
which also force that body whatever N (to hold it against the plain version
where the whole-tile body would run).

Kernels 7, 8 and 9 run either body only where kernel A's tensor-core body
(forward; its ``packed`` instance, kernel 10's arithmetic, for 9) and kernel
6's (backward) do not take the geometry: in bf16 at head width 16 or 32 and
at most 112 tokens, or at head width 16 and at most 208 (their long layouts:
the 8-frame encoder's N = 196), where those blocks fit (every C up to 256 at
112 tokens, with the weights in depth chunks; C = 96 and 192 at 196;
``window_tile_core`` says ``"fold_mma"``), they run
those bodies without LN and residual on ``window_grid``'s view of the
windows, the rows of one batch element's windows laid end to end as one row
of windows, which is exactly the layout of ``x_windows``.  This comes before
``window_body``'s choice, so a window whose whole tile would not fit (the
backward at N = 98 and C = 128 or 256) runs 6's body, not the row-tiled
one.  Those launches count on
``window_attention_fused``, ``window_attention_packed`` and
``window_attention_fused_bwd``; the whole-tile bodies count on
``window_attention_fused_tiles``, ``window_attention_packed_tiles`` and
``window_attention_fused_bwd_tiles``, which also force them.

Where those bodies take a Swin block's geometry both ways
(``window_grid_route``), a ``base`` or ``packed`` block does not partition at
all: it hands ``fold_attention`` (or ``fold_attention_packed``) the padded,
LN1'd ``(B, D, H, W, C)`` tensor with the block's shift, which their
addressing gathers and rolls, counted on the same three counters.

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches a kernel or raises.  bf16 runs on tensor-core tiles where C and
head_dim are multiples of 16 (the row-tiled body: head_dim at most 64);
fp32, and bf16 at every other width (head width 12 of an ``embed_dim`` 24
or 72 model), run the CUDA-core bodies, whose fp32 arithmetic rounds to the
compute dtype where the bf16 contract rounds (``window_core`` names the
arithmetic a geometry runs; its launches count as those of the same body in
fp32).
"""

from __future__ import annotations

from typing import Optional

import torch

from vadcl_tpu_torch.ops import cuda_lib
from vadcl_tpu_torch.ops import library as _library
from vadcl_tpu_torch.ops.fold_attn import (
    SMEM_LIMIT,
    _fold_attention_bwd_mma,
    _fold_attention_cuda,
    fold_bwd_body,
    fold_fits,
)


def _forward_plain(x, qkv_w, qkv_b, proj_w, proj_b, bias, mask, num_heads, n_windows,
                   scale, packed):
    Bn, N, C = x.shape
    dt = x.dtype
    hd = C // num_heads
    qkv = x.float() @ qkv_w.to(dt).float()
    if qkv_b is not None:
        qkv = qkv + qkv_b.float()
    if packed:  # q is scaled before it is rounded
        qkv = torch.cat((qkv[..., :C] * scale, qkv[..., C:]), -1)
    qkv = qkv.to(dt).reshape(Bn, N, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0].float(), qkv[1].float(), qkv[2].float()  # (Bn, nH, N, hd)
    s = q @ k.transpose(-2, -1)
    if not packed:
        s = s * scale
    s = s + bias.float()[None]
    if mask is not None:
        s = (s.reshape(Bn // n_windows, n_windows, num_heads, N, N)
             + mask.float()[None, :, None]).reshape(Bn, num_heads, N, N)
    if packed:  # per-head row max, e * (1 / sum e)
        e = torch.exp(s - s.amax(-1, keepdim=True))
        p = e * (1.0 / e.sum(-1, keepdim=True))
    else:
        p = torch.softmax(s, dim=-1)
    o = (p.to(dt).float() @ v).to(dt)  # (Bn, nH, N, hd)
    o = o.transpose(1, 2).reshape(Bn, N, C)
    return (o.float() @ proj_w.to(dt).float() + proj_b.float()).to(dt)


def window_attention_fused_plain(x_windows, qkv_w, qkv_b, proj_w, proj_b, bias, mask,
                                 num_heads, n_windows, scale):
    """Plain PyTorch version of kernel 7 with its cast boundaries:
    ``qkv = round(x . W_qkv + b_qkv)``; ``s = (q . k^T) * scale + bias[h] +
    mask[w % nW]`` in fp32, the scale applied after the product;
    ``p = round(softmax(s))``; ``o = round(p . v)`` per head;
    ``out = round(o . W_proj + b_proj)``.  Weights are cast to the compute
    dtype, both biases stay fp32; a missing ``qkv_b`` or ``mask`` is zeros."""
    return _forward_plain(x_windows, qkv_w, qkv_b, proj_w, proj_b, bias, mask, num_heads,
                          n_windows, scale, packed=False)


def window_attention_packed_plain(x_windows, qkv_w, qkv_b, proj_w, proj_b, bias, mask,
                                  num_heads, n_windows, scale):
    """Plain PyTorch version of kernel 9: kernel 7's function except
    ``q = round((x . W + b)[:, :C] * scale)`` (no scale after the product),
    the row max is per head, and ``p = round(e * (1 / sum e))``."""
    return _forward_plain(x_windows, qkv_w, qkv_b, proj_w, proj_b, bias, mask, num_heads,
                          n_windows, scale, packed=True)


def window_attention_fused_bwd_plain(x_windows, dout, qkv_w, qkv_b, proj_w, bias, mask,
                                     num_heads, n_windows, scale):
    """Plain PyTorch version of kernel 8 with ``_bwd_kernel``'s order and
    cast boundaries: the forward recomputed as in kernel 7, keeping the fp32
    ``P`` beside ``p = round(P)``; ``do = round(dout . W_proj^T)``;
    ``dv = p^T . do``; ``dp = do . v^T``; ``ds = P * (dp - sum(dp * P))``;
    ``d(bias)[h] = sum over windows of ds``; ``dss = round(ds * scale)``;
    ``dq = dss . k``, ``dk = dss^T . q``; ``dqkv_b = sum dqkv`` before the
    rounding; ``dqkv_w = x^T . round(dqkv)``;
    ``dx = round(round(dqkv) . W_qkv^T)``.  ``dout`` is cast to the compute
    dtype first.  Returns (dx, dqkv_w, dqkv_b, dproj_w, dproj_b, dbias): dx in
    the compute dtype, the rest fp32 (dqkv_b None without a qkv bias)."""
    Bn, N, C = x_windows.shape
    dt = x_windows.dtype
    nh, hd = num_heads, C // num_heads
    rnd = lambda t: t.to(dt).float()  # noqa: E731  a cast to the compute dtype
    x = x_windows.float()
    do = dout.to(dt).float()
    qw, pw = rnd(qkv_w), rnd(proj_w)
    qkv = x @ qw
    if qkv_b is not None:
        qkv = qkv + qkv_b.float()
    qkv = rnd(qkv).reshape(Bn, N, 3, nh, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]  # (Bn, nH, N, hd)
    s = (q @ k.transpose(-2, -1)) * scale + bias.float()[None]
    if mask is not None:
        s = (s.reshape(Bn // n_windows, n_windows, nh, N, N)
             + mask.float()[None, :, None]).reshape(Bn, nh, N, N)
    P = torch.softmax(s, dim=-1)
    p = rnd(P)
    o = rnd(p @ v).transpose(1, 2).reshape(Bn, N, C)

    dproj_b = do.sum((0, 1))
    dproj_w = o.reshape(-1, C).T @ do.reshape(-1, C)
    doa = rnd(do @ pw.T).reshape(Bn, N, nh, hd).transpose(1, 2)  # (Bn, nH, N, hd)
    dv = p.transpose(-2, -1) @ doa
    dp = doa @ v.transpose(-2, -1)
    ds = P * (dp - (dp * P).sum(-1, keepdim=True))
    dbias = ds.sum(0)
    dss = rnd(ds * scale)
    dq = dss @ k
    dk = dss.transpose(-2, -1) @ q
    dqkv = torch.stack((dq, dk, dv), 2).permute(0, 3, 2, 1, 4).reshape(Bn, N, 3 * C)
    dqkv_b = dqkv.sum((0, 1)) if qkv_b is not None else None
    dqkv_c = rnd(dqkv)
    dqkv_w = x.reshape(-1, C).T @ dqkv_c.reshape(-1, 3 * C)
    dx = (dqkv_c @ qw.T).to(dt)
    return dx, dqkv_w, dqkv_b, dproj_w, dproj_b, dbias


ROWS_MAX_HEAD_DIM = 64  # widest bf16 head the row-tiled tensor-core cores are built for
_ROWS_WARPS = 8  # warps of a row-tiled attention-core block
ROWS_STREAM_DEPTH = 32  # channels a chunk of the streamed CUDA-core cores (window_rows.cuh:kRsDepth)


def _up(v: int, m: int) -> int:
    return -(-v // m) * m


def window_core(c: int, num_heads: int, dtype: torch.dtype, rows: bool = False) -> str:
    """The arithmetic kernels 7, 8 and 9 run at width ``c`` (the whole-tile
    body, or with ``rows`` the row-tiled one): ``"mma"``, the bf16
    tensor-core bodies (C and head_dim multiples of 16; row-tiled head_dim at
    most ``ROWS_MAX_HEAD_DIM``), or ``"cuda_core"``, the CUDA-core bodies
    (``window_attn_kernel<T>``, ``window_attn_bwd_kernel<T>``,
    ``rows_attn_f32_kernel<PACKED, T>``, ``rows_bwd_f32_kernel<T>``): fp32,
    and bf16 at every other width."""
    hd = c // num_heads
    if (dtype == torch.bfloat16 and c % 16 == 0 and hd % 16 == 0
            and (not rows or hd <= ROWS_MAX_HEAD_DIM)):
        return "mma"
    return "cuda_core"


def tile_smem_bytes(n: int, c: int, num_heads: int, bf16: bool, backward: bool = False) -> int:
    """Shared memory of one block of the whole-tile body (forward, or with
    ``backward`` kernel 8): the layouts of ``csrc/window_attn.cu`` and
    ``csrc/window_attn_bwd.cu``; in bf16 at widths the tensor-core body does
    not take, the CUDA-core body's fp32 tiles."""
    hd = c // num_heads
    if not bf16 or window_core(c, num_heads, torch.bfloat16) != "mma":
        hdp = hd + 1
        if not backward:
            return 4 * (2 * n * c + 3 * n * hdp + n * n)
        return 4 * max(n * c + 5 * n * hdp + 2 * n * n, n * c + 33 * c + 33 * n)
    m = _up(n, 16)
    stage = 4 * 256 * 16
    if not backward:
        sizes = [2 * m * c, 2 * m * c] + [2 * m * hd] * 3 + [4 * m * m, 2 * m * m, stage]
        return sum(_up(v, 128) for v in sizes)
    p1 = sum(_up(v, 128) for v in [2 * m * c] + [2 * m * hd] * 4
             + [4 * m * m, 4 * m * m, 2 * m * m] + [4 * m * hd] * 3 + [stage])
    p2 = _up(2 * m * 64, 128) + _up(4 * m * c, 128)
    return max(p1, p2)


def rows_warps(head_dim: int) -> int:
    """Warps of one block of the bf16 row-tiled forward core
    (``csrc/window_attn_rows_mma.cuh:rows_mma_warps``)."""
    return 16 if head_dim <= 32 else 8


_ROWS_BWD_WARPS, _ROWS_BWD_KEY_MAX = 8, 4  # csrc/window_attn_bwd_rows_mma.cuh


def rows_smem_bytes(n: int, c: int, num_heads: int, bf16: bool, backward: bool = False,
                    group: int = 0) -> int:
    """Shared memory of one block of the row-tiled attention core
    (``csrc/window_attn_rows.cu:rows_fwd_smem``, with ``backward``
    ``csrc/window_attn_bwd_rows.cu:rows_bwd_smem``).  bf16 forward
    (``csrc/window_attn_rows_mma.cuh:rows_mma_layout``): at ``group`` G >= 1,
    K and V of the head of G windows, the strip's (bias + mask) tile, the
    next strip's bias and mask rows, the warps' (m, l) pairs and partial
    output strips (206,336 B at N = 392, head_dim 16, G = 4); at ``group`` 0
    the direct layout, the least the core needs: K and V of one head in
    padded rows (38,400 B at N = 392, head_dim 16).  bf16 backward
    (``csrc/window_attn_bwd_rows_mma.cuh:rows_bwd_layout``): at ``group`` G
    >= 1, two tiles of the head of G windows (K and V, then q and dout's
    slice), the strip's (bias + mask) tile (its 16 rows, or its 16 keys as
    rows), the next strip's bias and mask, the row statistics of G windows,
    the warps' partial statistics and strips and their shares of the
    windows' column sums (227,584 B at N = 392, head_dim 16, G = 4); at
    ``group`` 0 the direct layout: q, K, V and dout's slice of one head in
    padded rows, three row statistics and the strips' column sums (86,400 B
    at N = 392, head_dim 16).  fp32, and bf16 at widths the tensor-core
    cores do not take: K and V of one head (the backward also q and dout's
    slice) plus, in the backward, the row statistics and two rows a warp;
    where that outgrows ``SMEM_LIMIT``, the streamed layout
    (``csrc/window_attn_rows.cu:rows_stream_fwd_smem``,
    ``csrc/window_attn_bwd_rows.cu:rows_stream_bwd_smem``): one chunk of
    ``ROWS_STREAM_DEPTH`` channels of K or V, a query chunk and a score row
    a warp (164 N + 1024 B), the backward two of each and the row
    statistics (340 N + 2048 B), whatever the head width."""
    hd = c // num_heads
    if bf16 and window_core(c, num_heads, torch.bfloat16, rows=True) == "mma":
        m = _up(n, 16)
        if not backward:
            if group == 0:
                return 2 * 2 * m * (hd + 8)
            warps = rows_warps(hd)
            return (group * 4 * m * hd + 64 * (m + 8) + 128 * m + 128 * warps
                    + 64 * warps * (hd + 8))
        if group == 0:
            return 2 * 4 * m * (hd + 8) + 4 * (3 * m + m // 16 * 3 * hd)
        w = _ROWS_BWD_WARPS
        return (group * 4 * m * hd + 64 * (m + 8) + 128 * m + group * 12 * m + 256 * w
                + 64 * w * (2 * hd + 8) + group * w * 12 * hd)
    if rows_streams(n, c, num_heads, backward):
        d, w = ROWS_STREAM_DEPTH, _ROWS_WARPS
        if not backward:
            return 4 * (n * (d + 1) + w * (d + n))
        return 4 * (2 * n * (d + 1) + 2 * w * d + 2 * w * n + 3 * n)
    return _rows_whole_head_bytes(n, hd, backward)


def _rows_whole_head_bytes(n: int, hd: int, backward: bool) -> int:
    """The CUDA-core cores' block with the whole head in shared memory
    (``rows_f32_fwd_smem``, ``rows_f32_bwd_smem``)."""
    if not backward:
        return 4 * (2 * n * (hd + 1) + _ROWS_WARPS * (n + hd))
    return 4 * (4 * n * hd + 3 * n + 2 * _ROWS_WARPS * n)


def rows_streams(n: int, c: int, num_heads: int, backward: bool = False) -> bool:
    """Whether the row-tiled CUDA-core core (fp32, and bf16 at widths the
    tensor-core cores do not take) runs its streamed instance
    (``rows_attn_stream_kernel``, ``rows_bwd_stream_kernel``): where the
    whole head's operands outgrow ``SMEM_LIMIT`` (forward: head width 281
    and up at N = 98, 544 at N = 49; backward: 144 and 292)."""
    return _rows_whole_head_bytes(n, c // num_heads, backward) > SMEM_LIMIT


def rows_group(n: int, c: int, num_heads: int, per_class: int) -> int:
    """Windows one block of the bf16 row-tiled forward core takes
    (``csrc/window_attn_rows_mma.cuh:rows_mma_group``): the largest of 8, 4,
    2, 1 that is at most ``per_class`` (the windows sharing one mask; all
    windows without a mask) and fits ``SMEM_LIMIT``; 0 where none fits, and
    the core takes the direct layout (a block per window and head, bias and
    mask read from device memory).  The block's ``rows_warps(head_dim) //
    group`` warps a window each take every so-many-th key block."""
    for g in (8, 4, 2, 1):
        if g <= per_class and rows_smem_bytes(n, c, num_heads, True, group=g) <= SMEM_LIMIT:
            return g
    return 0


def rows_bwd_group(n: int, c: int, num_heads: int, per_class: int) -> int:
    """Windows one block of the bf16 row-tiled backward core takes
    (``csrc/window_attn_bwd_rows_mma.cuh:rows_bwd_group``): the largest of 8,
    4, 2, 1 that is at most ``per_class`` and fits ``SMEM_LIMIT``, where a
    warp's key blocks of a strip (every 8th) number at most 4 (N <= 512); 0
    elsewhere: the direct layout (a block per chunk of windows and head,
    bias and mask read from device memory)."""
    if _up(n, 16) // 16 > _ROWS_BWD_WARPS * _ROWS_BWD_KEY_MAX:
        return 0
    for g in (8, 4, 2, 1):
        if g <= per_class and rows_smem_bytes(n, c, num_heads, True, True, g) <= SMEM_LIMIT:
            return g
    return 0


def window_body(n: int, c: int, num_heads: int, dtype: torch.dtype,
                backward: bool = False) -> str:
    """The body a window of ``n`` tokens at width ``c`` runs in: ``"tile"``
    where the whole-tile body's block fits ``SMEM_LIMIT``, else ``"rows"``
    (``window_core`` says which arithmetic, ``rows_streams`` whether the
    CUDA-core core streams the head's channels).  Every head width takes a
    body; ``NotImplementedError`` is raised only for windows longer than
    every row-tiled layout holds (the streamed CUDA-core cores: N above 1411
    forward, 677 backward)."""
    bf16 = dtype == torch.bfloat16
    if tile_smem_bytes(n, c, num_heads, bf16, backward) <= SMEM_LIMIT:
        return "tile"
    if rows_smem_bytes(n, c, num_heads, bf16, backward) <= SMEM_LIMIT:
        return "rows"
    raise NotImplementedError(
        f"window attention: a window of {n} tokens at C={c}, {num_heads} heads "
        f"({str(dtype)[6:]}) fits neither the whole-tile body nor the row-tiled body"
    )


def window_tile_core(n: int, c: int, num_heads: int, dtype: torch.dtype,
                     backward: bool = False) -> str:
    """``"fold_mma"`` where kernel A's tensor-core body (or with ``backward``
    kernel 6's) takes the geometry without LN and residual on
    ``window_grid``'s view (bf16, head width 16 or 32, at most
    ``fold_max_tokens`` tokens (208 at head width 16: the long layouts, 112
    at 32), C % 16 == 0, its block within ``SMEM_LIMIT`` with the weights
    streamed in depth chunks where whole slices do not fit: ``fold_fits``
    for A, ``fold_bwd_body(...) == "mma"`` for 6); the route
    then runs it whichever body ``window_body`` names.  Else ``"tile"``:
    ``window_body``'s body runs, the whole-tile body of
    ``csrc/window_attn.cu`` / ``csrc/window_attn_bwd.cu`` where it fits."""
    if dtype != torch.bfloat16:
        return "tile"
    if backward:
        takes = fold_bwd_body(n, c, num_heads, dtype) == "mma"
    else:
        takes = fold_fits(n, c, num_heads, dtype)
    return "fold_mma" if takes else "tile"


def window_grid_route(n: int, c: int, num_heads: int, dtype: torch.dtype,
                      packed: bool = False) -> bool:
    """Whether a Swin block with windows of ``n`` tokens at width ``c`` runs
    kernel 7 (with ``packed`` kernel 9) and its backward 8 on kernels A's and
    6's tensor-core bodies, so that the block can hand them the unpartitioned
    tensor through ``fold_attention`` (``fold_attention_packed``):
    ``window_tile_core`` says ``"fold_mma"`` for the forward and, for 7,
    which trains, for the backward too (9 has no backward).  That holds at
    every bf16 window of at most 112 tokens at head width 16 or 32 and C up
    to 256 (the Video Swin-B width's C = 256 with 8 heads too, since A's and
    6's weights stream in depth chunks), and at the 8-frame encoder's 196
    tokens at C = 96 with 6 heads and C = 192 with 12 (the long layouts,
    head width 16).  Elsewhere (fp32, head widths 12, 48 and 64, windows
    above 112 tokens at head width 32 and the decoder's 392) the block
    partitions its windows as before."""
    if dtype != torch.bfloat16:
        return False
    return all(window_tile_core(n, c, num_heads, dtype, backward) == "fold_mma"
               for backward in ((False,) if packed else (False, True)))


def window_grid(x_windows: torch.Tensor, mask: Optional[torch.Tensor], n_windows: int):
    """``(grid, window, shift)``: the windows ``(Bn, N, C)`` as the
    unpartitioned tensor kernels A and 6 address, ``(Bn / nW, 1, 1, nW * N,
    C)`` cut by the window ``(1, 1, N)`` with no shift, a view of the same
    memory.  Window ``w`` of batch element ``b`` is window ``b * nW + w`` and
    takes ``mask[w]``, kernel 7's ``mask[i % nW]``.  ``nW`` is ``n_windows``
    with a mask and 1 without one (``Bn`` need not divide then)."""
    Bn, N, C = x_windows.shape
    nw = n_windows if mask is not None else 1
    return x_windows.reshape(Bn // nw, 1, 1, nw * N, C), (1, 1, N), (0, 0, 0)


class _WindowAttention(torch.autograd.Function):
    """Forward kernel 7, backward kernel 8
    (``fused_window_attention_trainable``'s custom VJP): the inputs are
    saved, the backward recomputes the forward.  ``body`` forces the
    forward's body (``"rows"``, ``"tile"``; None: ``_pick_body`` picks); the
    backward's is picked."""

    @staticmethod
    def forward(ctx, x, qkv_w, qkv_b, proj_w, proj_b, bias, mask, num_heads, n_windows,
                scale, body):
        ctx.save_for_backward(x, qkv_w, qkv_b, proj_w, bias, mask)
        ctx.meta = (num_heads, n_windows, scale)
        return _library.window_attention(x, qkv_w, qkv_b, proj_w, proj_b, bias, mask,
                                         num_heads, n_windows, scale, False, body or "")

    @staticmethod
    def backward(ctx, dout):
        x, qkv_w, qkv_b, proj_w, bias, mask = ctx.saved_tensors
        dx, dqw, dqb, dpw, dpb, dbias = window_attention_fused_bwd(
            x, dout, qkv_w, qkv_b, proj_w, bias, mask, *ctx.meta)
        # weight gradients come back in the parameters' dtype
        return (dx, dqw.to(qkv_w.dtype), None if dqb is None else dqb.to(qkv_b.dtype),
                dpw.to(proj_w.dtype), dpb, dbias.to(bias.dtype), None, None, None, None, None)


class _WindowAttentionPacked(torch.autograd.Function):
    """Kernel 9: forward only, as in the JAX package."""

    @staticmethod
    def forward(ctx, x, qkv_w, qkv_b, proj_w, proj_b, bias, mask, num_heads, n_windows,
                scale, body):
        return _library.window_attention(x, qkv_w, qkv_b, proj_w, proj_b, bias, mask,
                                         num_heads, n_windows, scale, True, body or "")

    @staticmethod
    def backward(ctx, dout):
        raise NotImplementedError(
            "window_attention_packed (attn_kernel='packed') is inference-only: "
            "it has no backward; train with attn_kernel='base' or 'fold'"
        )


def _check_device(what: str, x: torch.Tensor) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")


def window_attention_fused(x_windows, qkv_w, qkv_b, proj_w, proj_b, bias, mask,
                           num_heads: int, n_windows: int, scale: float) -> torch.Tensor:
    """``proj(attention(x_windows))`` over windows ``(Bn, N, C)``: the
    contract of ``fused_window_attention_trainable``.  ``bias`` is the
    pre-gathered (nH, N, N) rel-pos bias, ``mask`` (n_windows, N, N) or None.
    Differentiable (kernel 8); the mask gets no gradient.  Counts the
    launches of kernel A's tensor-core body on ``window_grid``'s view
    (``window_tile_core``: ``"fold_mma"``)."""
    _check_device("window_attention_fused", x_windows)
    return _WindowAttention.apply(x_windows, qkv_w, qkv_b, proj_w, proj_b, bias, mask,
                                  num_heads, n_windows, float(scale), None)


window_attention_fused.launches = 0


def window_attention_fused_tiles(x_windows, qkv_w, qkv_b, proj_w, proj_b, bias, mask,
                                 num_heads: int, n_windows: int,
                                 scale: float) -> torch.Tensor:
    """``window_attention_fused`` with the forward on the whole-tile body of
    ``csrc/window_attn.cu`` wherever it fits; counts that body's launches
    (also those the route makes through ``window_attention_fused``: fp32,
    and the bf16 geometries kernel A's body does not take)."""
    _check_device("window_attention_fused_tiles", x_windows)
    return _WindowAttention.apply(x_windows, qkv_w, qkv_b, proj_w, proj_b, bias, mask,
                                  num_heads, n_windows, float(scale), "tile")


window_attention_fused_tiles.launches = 0


def window_attention_fused_rows(x_windows, qkv_w, qkv_b, proj_w, proj_b, bias, mask,
                                num_heads: int, n_windows: int, scale: float) -> torch.Tensor:
    """``window_attention_fused`` with the forward on the row-tiled body
    whatever N; counts that body's launches (also those the route makes
    through ``window_attention_fused``)."""
    _check_device("window_attention_fused_rows", x_windows)
    return _WindowAttention.apply(x_windows, qkv_w, qkv_b, proj_w, proj_b, bias, mask,
                                  num_heads, n_windows, float(scale), "rows")


window_attention_fused_rows.launches = 0


def window_attention_packed(x_windows, qkv_w, qkv_b, proj_w, proj_b, bias, mask,
                            num_heads: int, n_windows: int, scale: float) -> torch.Tensor:
    """The contract of ``fused_window_attention_packed`` (inference only).
    Counts the launches of kernel A's ``packed`` tensor-core body on
    ``window_grid``'s view (``window_tile_core``: ``"fold_mma"``)."""
    _check_device("window_attention_packed", x_windows)
    return _WindowAttentionPacked.apply(x_windows, qkv_w, qkv_b, proj_w, proj_b, bias,
                                        mask, num_heads, n_windows, float(scale), None)


window_attention_packed.launches = 0


def window_attention_packed_tiles(x_windows, qkv_w, qkv_b, proj_w, proj_b, bias, mask,
                                  num_heads: int, n_windows: int,
                                  scale: float) -> torch.Tensor:
    """``window_attention_packed`` on the whole-tile body of
    ``csrc/window_attn.cu`` wherever it fits; counts that body's launches
    (also those the route makes through ``window_attention_packed``: fp32,
    and the bf16 geometries kernel A's body does not take)."""
    _check_device("window_attention_packed_tiles", x_windows)
    return _WindowAttentionPacked.apply(x_windows, qkv_w, qkv_b, proj_w, proj_b, bias,
                                        mask, num_heads, n_windows, float(scale), "tile")


window_attention_packed_tiles.launches = 0


def window_attention_packed_rows(x_windows, qkv_w, qkv_b, proj_w, proj_b, bias, mask,
                                 num_heads: int, n_windows: int, scale: float) -> torch.Tensor:
    """``window_attention_packed`` on the row-tiled body whatever N; counts
    that body's launches."""
    _check_device("window_attention_packed_rows", x_windows)
    return _WindowAttentionPacked.apply(x_windows, qkv_w, qkv_b, proj_w, proj_b, bias,
                                        mask, num_heads, n_windows, float(scale), "rows")


window_attention_packed_rows.launches = 0


def window_attention_fused_bwd(x_windows, dout, qkv_w, qkv_b, proj_w, bias, mask,
                               num_heads: int, n_windows: int, scale: float,
                               body: Optional[str] = None):
    """Kernel 8: (dx, dqkv_w, dqkv_b, dproj_w, dproj_b, dbias) of
    ``window_attention_fused``, as ``window_attention_fused_bwd_plain``
    returns them (the contract of ``_bwd_call``).  Counts the launches of
    kernel 6's tensor-core body on ``window_grid``'s view
    (``window_tile_core``: ``"fold_mma"``); ``body`` forces the row-tiled
    (``"rows"``) or the whole-tile (``"tile"``) body (else ``_pick_body``
    picks)."""
    _check_device("window_attention_fused_bwd", x_windows)
    args = (x_windows, dout, qkv_w, qkv_b, proj_w, bias, mask, num_heads, n_windows,
            float(scale))
    if x_windows.device.type == "cpu":
        return window_attention_fused_bwd_plain(*args)
    return _backward_cuda(body, *args)


window_attention_fused_bwd.launches = 0


def window_attention_fused_bwd_tiles(x_windows, dout, qkv_w, qkv_b, proj_w, bias, mask,
                                     num_heads: int, n_windows: int, scale: float):
    """Kernel 8 on the whole-tile body of ``csrc/window_attn_bwd.cu`` wherever
    it fits; counts that body's launches (also those the route makes through
    ``window_attention_fused_bwd``: fp32, and the bf16 geometries kernel 6's
    tensor-core body does not take)."""
    return window_attention_fused_bwd(x_windows, dout, qkv_w, qkv_b, proj_w, bias, mask,
                                      num_heads, n_windows, scale, body="tile")


window_attention_fused_bwd_tiles.launches = 0


def window_attention_fused_bwd_rows(x_windows, dout, qkv_w, qkv_b, proj_w, bias, mask,
                                    num_heads: int, n_windows: int, scale: float):
    """Kernel 8 on the row-tiled body whatever N; counts that body's launches."""
    return window_attention_fused_bwd(x_windows, dout, qkv_w, qkv_b, proj_w, bias, mask,
                                      num_heads, n_windows, scale, body="rows")


window_attention_fused_bwd_rows.launches = 0


def _check_windows(what, x, bias, mask, num_heads, n_windows):
    """The checks the three kernels share, whichever body runs."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: dtype {x.dtype} not supported")
    if x.dim() != 3:
        raise ValueError(f"{what}: windows must be (Bn, N, C), got {tuple(x.shape)}")
    Bn, N, C = x.shape
    if C % num_heads:
        raise ValueError(f"{what}: C={C} is not divisible by {num_heads} heads")
    if tuple(bias.shape) != (num_heads, N, N):
        raise ValueError(f"{what}: bias {tuple(bias.shape)} != {(num_heads, N, N)}")
    if mask is not None and (tuple(mask.shape) != (n_windows, N, N) or Bn % n_windows):
        raise ValueError(
            f"{what}: mask {tuple(mask.shape)} != {(n_windows, N, N)}, or the window "
            f"batch {Bn} is not a multiple of n_windows={n_windows}"
        )


def _pick_body(what, body, x, num_heads, backward) -> str:
    """``"fold_mma"`` where ``window_tile_core`` says so, else
    ``window_body``'s choice (``"tile"`` or ``"rows"``); or the forced
    ``body`` (``"rows"``, ``"tile"``) where its block fits."""
    N, C = x.shape[1:]
    if body is None:
        if window_tile_core(N, C, num_heads, x.dtype, backward) == "fold_mma":
            return "fold_mma"
        return window_body(N, C, num_heads, x.dtype, backward)
    bf16 = x.dtype == torch.bfloat16
    size = rows_smem_bytes if body == "rows" else tile_smem_bytes
    if size(N, C, num_heads, bf16, backward) > SMEM_LIMIT:
        raise NotImplementedError(f"{what}: the {'row-tiled' if body == 'rows' else 'whole-tile'}"
                                  f" body does not take N={N}, C={C}, {num_heads} heads in "
                                  f"{str(x.dtype)[6:]}")
    return body


def _operands(x, qkv_w, qkv_b, proj_w, bias, mask):
    """Weights in the compute dtype (aligned for the tensor-core loads), the
    qkv bias (zeros when missing), rel-pos bias and mask in fp32."""
    dev, dt, C = x.device, x.dtype, x.shape[-1]
    f32 = lambda t: t.detach().to(device=dev, dtype=torch.float32).contiguous()  # noqa: E731
    qw = cuda_lib.aligned(qkv_w.detach().to(device=dev, dtype=dt))
    pw = cuda_lib.aligned(proj_w.detach().to(device=dev, dtype=dt))
    qb = torch.zeros(3 * C, dtype=torch.float32, device=dev) if qkv_b is None else f32(qkv_b)
    return qw, qb, pw, f32(bias), None if mask is None else f32(mask)


def _workspace(nbytes: int, dev) -> torch.Tensor:
    return torch.empty(nbytes, dtype=torch.uint8, device=dev)


def _forward_cuda(what, packed, body, x, qkv_w, qkv_b, proj_w, proj_b, bias, mask, num_heads,
                  n_windows, scale):
    lib = cuda_lib.library()
    _check_windows(what, x, bias, mask, num_heads, n_windows)
    body = _pick_body(what, body, x, num_heads, backward=False)
    if body == "fold_mma":
        grid, window, shift = window_grid(x.detach(), mask, n_windows)
        return _fold_attention_cuda(
            grid, None, None, qkv_w, qkv_b, proj_w, proj_b, bias, mask, num_heads, window,
            scale, False, shift, packed=packed,
            counter=window_attention_packed if packed else window_attention_fused,
        ).reshape(x.shape)
    Bn, N, C = x.shape
    is_bf16 = int(x.dtype == torch.bfloat16)
    xc = cuda_lib.aligned(x.detach())
    out = torch.empty_like(xc)
    qw, qb, pw, bs, mk = _operands(xc, qkv_w, qkv_b, proj_w, bias, mask)
    pb = proj_b.detach().to(device=x.device, dtype=torch.float32).contiguous()
    ptrs = (xc.data_ptr(), qw.data_ptr(), qb.data_ptr(), pw.data_ptr(), pb.data_ptr(),
            bs.data_ptr(), mk.data_ptr() if mk is not None else None, out.data_ptr())
    dims = (Bn, N, C, num_heads, max(int(n_windows), 1), float(scale), is_bf16,
            cuda_lib.stream_ptr(xc))
    if body == "rows":
        ws = _workspace(lib.vadcl_window_attn_rows_workspace_bytes(Bn, N, C, is_bf16), x.device)
        entry = lib.vadcl_window_attn_rows_packed if packed else lib.vadcl_window_attn_rows
        err = entry(*ptrs, ws.data_ptr(), *dims)
        counter = window_attention_packed_rows if packed else window_attention_fused_rows
    else:
        entry = lib.vadcl_window_attn_packed if packed else lib.vadcl_window_attn
        err = entry(*ptrs, *dims)
        counter = window_attention_packed_tiles if packed else window_attention_fused_tiles
    cuda_lib.check(err, f"{what} ({body} body)")
    counter.launches += 1
    return out


def _backward_cuda(body, x, dout, qkv_w, qkv_b, proj_w, bias, mask, num_heads, n_windows,
                   scale):
    what = "window_attention_fused_bwd"
    lib = cuda_lib.library()
    _check_windows(what, x, bias, mask, num_heads, n_windows)
    body = _pick_body(what, body, x, num_heads, backward=True)
    if body == "fold_mma":
        grid, window, shift = window_grid(x.detach(), mask, n_windows)
        dx, _, _, dqkv_w, dqkv_b, dproj_w, dproj_b, dbias = _fold_attention_bwd_mma(
            grid, dout.detach().reshape(grid.shape), None, None, qkv_w, qkv_b, proj_w, bias,
            mask, num_heads, window, scale, shift, False,
            counter=window_attention_fused_bwd)
        return dx.reshape(x.shape), dqkv_w, dqkv_b, dproj_w, dproj_b, dbias
    Bn, N, C = x.shape
    dev, dt = x.device, x.dtype
    is_bf16 = int(dt == torch.bfloat16)
    xc = cuda_lib.aligned(x.detach())
    doc = cuda_lib.aligned(dout.detach().to(dt))
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty_like(xc)
    dqkv_w, dqkv_b = torch.empty(C, 3 * C, **f32), torch.empty(3 * C, **f32)
    dproj_w, dproj_b = torch.empty(C, C, **f32), torch.empty(C, **f32)
    dbias = torch.empty(num_heads, N, N, **f32)
    qw, qb, pw, bs, mk = _operands(xc, qkv_w, qkv_b, proj_w, bias, mask)
    outs = (dx.data_ptr(), dqkv_w.data_ptr(), dqkv_b.data_ptr(), dproj_w.data_ptr(),
            dproj_b.data_ptr(), dbias.data_ptr())
    dims = (Bn, N, C, num_heads, max(int(n_windows), 1), float(scale), is_bf16,
            cuda_lib.stream_ptr(xc))
    mp = mk.data_ptr() if mk is not None else None
    if body == "rows":
        ws = _workspace(lib.vadcl_window_attn_bwd_rows_workspace_bytes(Bn, N, C, num_heads,
                                                                       is_bf16), dev)
        qwt, pwt = cuda_lib.aligned(qw.t()), cuda_lib.aligned(pw.t())
        err = lib.vadcl_window_attn_bwd_rows(
            xc.data_ptr(), doc.data_ptr(), qw.data_ptr(), qb.data_ptr(), qwt.data_ptr(),
            pwt.data_ptr(), bs.data_ptr(), mp, *outs, ws.data_ptr(), *dims)
        counter = window_attention_fused_bwd_rows
    else:
        ws = _workspace(lib.vadcl_window_attn_bwd_workspace_bytes(Bn, N, C, num_heads, is_bf16),
                        dev)
        err = lib.vadcl_window_attn_bwd(
            xc.data_ptr(), doc.data_ptr(), qw.data_ptr(), qb.data_ptr(), pw.data_ptr(),
            bs.data_ptr(), mp, *outs, ws.data_ptr(), *dims)
        counter = window_attention_fused_bwd_tiles
    cuda_lib.check(err, f"{what} ({body} body)")
    counter.launches += 1
    return dx, dqkv_w, dqkv_b if qkv_b is not None else None, dproj_w, dproj_b, dbias
