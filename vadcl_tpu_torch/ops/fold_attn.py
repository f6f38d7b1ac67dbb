"""The folded Swin attention kernels, forward and backward: kernel A (LN1 +
window attention + residual on the unpartitioned tensor), kernel 6 (its
backward), kernel 10 (A's head-packed inference variant) and the
whole-Swin-block kernel each way.

Kernel A replaces ``vadcl_tpu/ops/pallas_attn_fold.py:_fold_kernel`` (entry
``fused_window_attention_folded``, reached through
``folded_block_attention_trainable``).  Its CUDA kernel is
``csrc/fold_attn.cu``: blocks that address their windows' tokens in the
unpartitioned (B, D, H, W, C) tensor by strides.  In bf16
(``csrc/fold_attn_mma.cuh``) a warp owns 16 query rows and keeps scores and
probabilities in tensor-core registers; it needs head_dim 16 or 32 and windows of
at most 112 tokens, and takes its weights, rel-pos bias and mask packed
(``pack_fold_weights``, ``pack_fold_scores``; cached per tensor version in
``_packs``).

Kernel 6 replaces ``_fold_bwd_kernel`` (entry ``_fold_bwd_call``), in the two
modes the JAX package calls it in without a tail: ``fuse_ln=True,
residual=True`` (through ``_blk_bwd``, the Swin block's front half) and
``fuse_ln=False, residual=False`` (the backward of
``folded_window_attention_trainable``, which a block at a window-padded
geometry runs).  Its blocks recompute the forward per window and emit dx;
the cross-window sums (weight, bias and LN gradients) go through a
deterministic second pass.  ``fold_bwd_body`` picks one of two bodies: in
bf16 at head width 16 or 32 and at most 112 tokens,
``csrc/fold_attn_bwd_mma.cu`` (kernel A's design turned around: a warp owns
16 query rows and the same 16 key rows, scores and their gradients in
mma.sync registers, kernel A's packs, d(bias) summed per chunk of windows,
the second pass on the tensor cores); fp32 and other bf16 geometries the
shared-memory body of ``csrc/fold_attn_bwd.cu`` (``fold_attention_bwd_tiles``
counts its launches).

Kernel 10 replaces ``_fold_packed_kernel`` (entry
``fused_window_attention_folded_packed``; ``attn_kernel="fold_packed"`` and
``"fold_mix"`` at 12 heads and more): kernel A's contract with the packed
arithmetic (q scaled before it rounds, no scale after q.k, per-head row max,
``p = round(e * (1 / sum e))``), inference only.  It is kernel A's device
code behind a template flag, with its own wrapper, ``fold_attention_packed``.

The whole-block kernels replace ``_fold_kernel`` with ``tail=`` and
``_fold_bwd_kernel`` with ``tail_refs=`` (entry
``folded_full_block_trainable`` and its ``_full_bwd``;
``attn_kernel="fold_block"``): ``fold_block`` computes
``y1 + fc2(gelu(fc1(LN2(y1))))`` with ``y1 = round(x + proj(attn(LN1 x)))``
in one launch, ``fold_block_bwd`` its 14 gradients in one launch plus the
second pass.  ``fold_block_fwd_body`` and ``fold_block_bwd_body`` pick the
bodies: in bf16 at head width 16 or 32, at most 112 tokens, C % 16 == 0,
C <= 192 and a hidden width divisible by 64, ``csrc/fold_block_mma.cu``
(kernel A's strip body to y1, then the MLP on the same 16-row strips, the
hidden activation in registers) and ``csrc/fold_block_bwd_mma.cu`` (the
strip bodies of kernels A, 5 and 6 in turn per window, the second pass on
the tensor cores), both on kernel A's and kernel B's packs; fp32 and other
geometries PR 4's bodies, ``csrc/fold_attn.cu`` and ``csrc/fold_attn_bwd.cu``
(``fold_block_tiles`` and ``fold_block_bwd_tiles`` count their launches),
which reuse the older device code of A, B, 5 and 6.

``fold_attention`` and ``fold_block`` are ``torch.autograd.Function``s (the
backward of ``fold_attention_packed`` raises).  On a CPU tensor every
wrapper runs its plain version (``*_plain``); on a CUDA tensor it launches
its kernel or raises.  Bounds on the card and what the simple designs leave
are in the headers of the two ``.cu`` files.

``fold_fits``, ``fold_packed_fits`` and ``fold_block_fits`` are the port's
counterparts of ``folded_attention_applicable`` / ``folded_bwd_applicable``,
``folded_packed_applicable`` and ``folded_full_block_applicable``: whether
one window's block fits the 227 KB of shared memory a Hopper block may use.
Where it does not, the Swin block takes another route
(``models/swin.py``), and where only kernel 6 does not,
``fold_attention``'s backward replays LN1 outside the kernel and runs kernel
8 (``_blk_bwd``'s fallback).  ``fold_block_fits`` is one predicate for both
directions, so the whole-block backward needs no fallback.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from vadcl_tpu_torch.ops import cuda_lib
from vadcl_tpu_torch.ops import library as _library
from vadcl_tpu_torch.ops.packed import PackCache
from vadcl_tpu_torch.ops.window import window_partition, window_reverse

Tri = Tuple[int, int, int]

SMEM_LIMIT = 232448  # dynamic shared memory one Hopper block may use (227 KB)
_WARPS = 16  # the fold kernels run 512 threads a block


def _up(v: int, m: int) -> int:
    return -(-v // m) * m


FOLD_MAX_TOKENS = 112  # largest window of the bf16 forward: 7 strips of 16 query rows
FOLD_HEAD_DIMS = (16, 32)  # head widths the bf16 forward is built for
PACK_PAD = 8  # elements of padding per packed weight row


def fold_padded_rows(n: int) -> int:
    """Rows the bf16 forward pads a window to: 4 strips of 16 (two such
    windows share a block), 7 strips, or (refused) whole 16s beyond."""
    return 64 if n <= 64 else (FOLD_MAX_TOKENS if n <= FOLD_MAX_TOKENS else _up(n, 16))


def fold_windows_per_block(n: int) -> int:
    return 2 if n <= 64 else 1


def fold_body_smem_bytes(n: int, c: int, num_heads: int) -> int:
    """Shared memory of the bf16 one-window-per-block body with score tiles
    in shared memory (``csrc/fold_attn.cuh:tc_layout``): what the whole-block
    kernels and kernel 6's recompute run."""
    hd = c // num_heads
    m = _up(n, 16)  # the window's rows padded to the 16-row tensor-core tiles
    sizes = [8 * m, 2 * m * c, 2 * m * c, 2 * m * hd, 2 * m * hd, 2 * m * hd,
             4 * m * m, 2 * m * m, 4 * 256 * _WARPS]
    return sum(_up(v, 128) for v in sizes)


def fold_smem_bytes(n: int, c: int, num_heads: int, bf16: bool, backward: bool = False) -> int:
    """Shared memory one block of kernel A (or, with ``backward``, kernel 6)
    needs: the layouts of ``csrc/fold_attn_mma.cuh`` (bf16 forward),
    ``csrc/fold_attn.cuh`` (fp32 forward) and ``csrc/fold_attn_bwd.cu``,
    mirrored here so the route can be chosen without the library
    (``chip_smoke.py`` holds the two against each other).  The bf16 forward
    block is the weight ring plus, per window, LN1(x), the pre-projection
    tile and the double-buffered K and V of one head: at head width 16 two
    blocks fit an SM at N = 98, C = 96 (89,728 B), one at C = 192 (154,240 B)."""
    hd = c // num_heads
    if not bf16:
        hdp = hd + 1
        if not backward:
            return 4 * (2 * n * c + 3 * n * hdp + n * n) + 8 * n
        p1 = n * c + 5 * n * hdp + 2 * n * n
        p2 = n * c + 33 * c + 33 * n + _WARPS * 2 * c
        return 8 * n + 4 * (2 * n + max(p1, p2))
    if not backward:
        rows = fold_padded_rows(n)
        window = 2 * (2 * rows * (c + PACK_PAD) + 4 * rows * (hd + 8))
        return 128 + 2 * 2 * c * (3 * hd + PACK_PAD) + fold_windows_per_block(n) * window
    m = _up(n, 16)

    def total(sizes):
        return sum(_up(v, 128) for v in sizes)

    stage = 4 * 256 * _WARPS
    p1 = total([2 * m * c] + [2 * m * hd] * 4 + [4 * m * m, 4 * m * m, 2 * m * m]
               + [4 * m * hd] * 3 + [stage])
    p2 = total([2 * m * 64, 4 * m * c, 4 * _WARPS * 2 * c])
    return total([8 * m, 4 * m, 4 * m]) + max(p1, p2)


FOLD_BWD_MAX_C = 256  # widest C of kernel 6's tensor-core body (C / 32 column sums a lane)


def fold_bwd_mma_smem_bytes(n: int, c: int, num_heads: int) -> int:
    """Shared memory of one block of kernel 6's tensor-core body
    (``csrc/fold_attn_bwd_mma.cu:fb_layout``): the mbarriers, two ring stages
    (head h's weight slice of kernel A's pack and its W_proj rows), the LN1
    row tile, then a region holding the double-buffered Q, K, V, DOA tiles
    and the round(P) and round(ds * scale) tiles, which the fp32 dxa rows
    overlay after the heads."""
    hd = c // num_heads
    rows = fold_padded_rows(n)
    ldw, ldkv = 3 * hd + PACK_PAD, hd + 8
    npc = -(-c // (3 * hd))
    stage = 2 * (c * ldw + npc * hd * ldw)
    region = 128 + 2 * stage + 2 * rows * (c + PACK_PAD)
    tiles = region + 2 * 2 * 4 * rows * ldkv + 2 * 2 * rows * (rows + 8)
    return max(tiles, region + 4 * rows * (c + 4))


def fold_bwd_body(n: int, c: int, num_heads: int, dtype: torch.dtype) -> Optional[str]:
    """The body kernel 6 runs a window of ``n`` tokens in: ``"mma"`` (the
    tensor-core body: bf16, head width 16 or 32, at most ``FOLD_MAX_TOKENS``
    tokens, C % 16 == 0 and at most ``FOLD_BWD_MAX_C``, its block within
    ``SMEM_LIMIT``), else ``"tiles"`` (the shared-memory body, fp32 and
    every bf16 geometry on whole 16x16 tiles whose block fits), else None
    (the Swin block then replays LN1 and runs kernel 8)."""
    bf16 = dtype == torch.bfloat16
    if (bf16 and c % num_heads == 0 and c % 16 == 0 and c // num_heads in FOLD_HEAD_DIMS
            and n <= FOLD_MAX_TOKENS and c <= FOLD_BWD_MAX_C
            and fold_bwd_mma_smem_bytes(n, c, num_heads) <= SMEM_LIMIT):
        return "mma"
    if bf16 and not _whole_tiles(c, num_heads):
        return None
    if fold_smem_bytes(n, c, num_heads, bf16, backward=True) <= SMEM_LIMIT:
        return "tiles"
    return None


def _whole_tiles(c: int, num_heads: int) -> bool:
    """Whether C and the head width are multiples of 16: what the bf16
    bodies on 16x16 tensor-core tiles (``_check_fold``) take."""
    return c % num_heads == 0 and c % 16 == 0 and (c // num_heads) % 16 == 0


def fold_fits(n: int, c: int, num_heads: int, dtype: torch.dtype,
              backward: bool = False) -> bool:
    """Whether a window of ``n`` tokens at width ``c`` runs in the fold
    kernel (A, or 6 with ``backward``: one of its bodies, ``fold_bwd_body``,
    takes it): its block must fit ``SMEM_LIMIT``, and the bf16 forward, whose
    warps hold a 16 x N strip of scores in registers, takes at most
    ``FOLD_MAX_TOKENS`` tokens (the cap is explicit: kernel 6 would not
    follow a larger window, and the N = 196 and N = 392
    windows of 8-frame reconstruction clips go to the row-tiled bodies of the
    partitioned-window kernels).
    Every other bf16 head width (48 and larger multiples of 16, and widths
    off 16 such as the 12 of an ``embed_dim`` 24 model) goes to the
    partitioned-window kernels, which take it; ``fold_block_fits`` does not
    depend on this predicate, so the whole-block kernels keep 48."""
    bf16 = dtype == torch.bfloat16
    if backward:
        return fold_bwd_body(n, c, num_heads, dtype) is not None
    if bf16 and (n > FOLD_MAX_TOKENS or c // num_heads not in FOLD_HEAD_DIMS
                 or c % num_heads):
        return False
    return fold_smem_bytes(n, c, num_heads, bf16) <= SMEM_LIMIT


# Whether a window runs in kernel 10.  It is kernel A's device code behind a
# template flag (q is scaled in the accumulator registers before it rounds),
# so one predicate (and one size function of the library) serves both kernels.
fold_packed_fits = fold_fits


_MLP_CHUNK = 128  # hidden columns per chunk of the tail (both dtypes)
_TAIL_TOKENS = 32  # tokens per tile of the fp32 tail
_TC_ACC = 6  # fc2 accumulator tiles a warp of the bf16 tail may own
_TAIL_GROUPS_MAX = 4  # 128-thread groups of the block backward's tail step


def _mlp_bwd_group_bytes(c: int) -> int:
    """Shared memory of one 128-thread group of kernel 5's tile body."""
    return 4 * (4 * 16 * (c + 4) + 2 * 16 * (64 + 4) + 16 + 4 * 2 * c)


def fold_block_smem_bytes(n: int, c: int, num_heads: int, bf16: bool,
                          backward: bool = False) -> int:
    """Shared memory one window's block of the whole-block kernel needs
    (forward, or with ``backward`` its backward): the layouts of
    ``csrc/fold_attn.cuh`` in tail mode and of
    ``csrc/fold_attn_bwd.cu:fold_block_bwd_smem_bytes``."""
    hd = c // num_heads
    m = _up(n, 16)

    def total(sizes):
        return sum(_up(v, 128) for v in sizes)

    if backward:
        tokens = _up(8 * n, 128)
        groups = max(1, min(_TAIL_GROUPS_MAX, (SMEM_LIMIT - tokens) // _mlp_bwd_group_bytes(c)))
        body = (fold_body_smem_bytes(n, c, num_heads) if bf16
                else fold_smem_bytes(n, c, num_heads, False))
        return max(body, fold_smem_bytes(n, c, num_heads, bf16, backward=True),
                   tokens + groups * _mlp_bwd_group_bytes(c))
    if not bf16:
        hdp = hd + 1
        region = max(n * c + 3 * n * hdp + n * n,
                     2 * _TAIL_TOKENS * c + _TAIL_TOKENS * _MLP_CHUNK)
        return 4 * (n * c + region) + 8 * n
    front = total([8 * m, 2 * m * c, 2 * m * c])
    stage = 4 * 256 * _WARPS
    return front + max(total([2 * m * hd] * 3 + [4 * m * m, 2 * m * m, stage]),
                       total([4 * m * _MLP_CHUNK, 2 * m * _MLP_CHUNK]),
                       total([4 * m * c]))


FOLD_BLOCK_MMA_MAX_C = 192  # widest C of the whole-block tensor-core bodies
_BB_PIECE = 32  # hidden columns per ring stage of their MLP steps


def fold_block_bwd_mma_smem_bytes(n: int, c: int, num_heads: int) -> int:
    """Shared memory of one block of the whole-block backward's tensor-core
    body (``csrc/fold_block_bwd_mma.cu:bb_layout``): the mbarriers, two ring
    stages (the larger of kernel 6's stage and 32 hidden columns of kernel
    B's pack), the LN1 / y1 row tile, then the largest of the three steps'
    regions: K, V and the o tile (step 1), the round(z) and dY tiles and the
    rows' LN2 statistics (step 2), kernel 6's tiles or its dxa rows (step 3)."""
    hd = c // num_heads
    rows = fold_padded_rows(n)
    ldw, ldkv = 3 * hd + PACK_PAD, hd + 8
    npc = -(-c // (3 * hd))
    stage = max(2 * (c * ldw + npc * hd * ldw), 2 * 2 * c * _BB_PIECE)
    tile = 2 * rows * (c + PACK_PAD)
    region = max(2 * 2 * 2 * rows * ldkv + tile, 2 * tile + 4 * 2 * rows,
                 2 * 2 * 4 * rows * ldkv + 2 * 2 * rows * (rows + 8), 4 * rows * (c + 4))
    return 128 + 2 * stage + tile + region


def fold_block_fwd_mma_smem_bytes(n: int, c: int, num_heads: int) -> int:
    """Shared memory of one block of the whole-block forward's tensor-core
    body (``csrc/fold_block_mma.cu:fb_layout``): the mbarriers, two ring
    stages (the larger of a head slice of kernel A's pack and 32 hidden
    columns of kernel B's pack), the LN1 / y1 row tile, K and V of two heads,
    and the o tile, which holds round(LN2 y1) in the MLP step."""
    hd = c // num_heads
    rows = fold_padded_rows(n)
    stage = max(2 * c * (3 * hd + PACK_PAD), 2 * 2 * c * _BB_PIECE)
    tile = 2 * rows * (c + PACK_PAD)
    return 128 + 2 * stage + tile + 2 * 2 * 2 * rows * (hd + 8) + tile


def fold_block_fwd_body(n: int, c: int, num_heads: int, ch: int, dtype: torch.dtype) -> str:
    """The body the whole-block forward runs a window of ``n`` tokens in:
    ``"mma"`` (the tensor-core body, ``csrc/fold_block_mma.cu``: bf16, head
    width 16 or 32, at most ``FOLD_MAX_TOKENS`` tokens, C % 16 == 0 and at
    most ``FOLD_BLOCK_MMA_MAX_C``, a hidden width divisible by 64, its block
    within ``SMEM_LIMIT``), else ``"tiles"`` (PR 4's body of
    ``csrc/fold_attn.cu``: fp32 and every other geometry ``fold_block_fits``
    admits).  It picks by geometry alone."""
    return "mma" if _block_mma_takes(n, c, num_heads, ch, dtype,
                                     fold_block_fwd_mma_smem_bytes) else "tiles"


def _block_mma_takes(n, c, num_heads, ch, dtype, smem_bytes) -> bool:
    """The conditions both whole-block tensor-core bodies share, with
    ``smem_bytes`` the layout mirror of the one asked about."""
    return (dtype == torch.bfloat16 and c % num_heads == 0 and c % 16 == 0
            and c // num_heads in FOLD_HEAD_DIMS and n <= FOLD_MAX_TOKENS
            and c <= FOLD_BLOCK_MMA_MAX_C and ch > 0 and ch % 64 == 0
            and smem_bytes(n, c, num_heads) <= SMEM_LIMIT)


def fold_block_bwd_body(n: int, c: int, num_heads: int, ch: int, dtype: torch.dtype) -> str:
    """The body the whole-block backward runs a window of ``n`` tokens in:
    ``"mma"`` (the tensor-core body, ``csrc/fold_block_bwd_mma.cu``: bf16,
    head width 16 or 32, at most ``FOLD_MAX_TOKENS`` tokens, C % 16 == 0 and
    at most ``FOLD_BLOCK_MMA_MAX_C``, a hidden width divisible by 64, its
    block within ``SMEM_LIMIT``), else ``"tiles"`` (the body of
    ``csrc/fold_attn_bwd.cu``: fp32 and every other geometry
    ``fold_block_fits`` admits).  It picks by geometry alone."""
    return "mma" if _block_mma_takes(n, c, num_heads, ch, dtype,
                                     fold_block_bwd_mma_smem_bytes) else "tiles"


def _tail_acc_fits(n: int, c: int) -> bool:
    """Whether the warps' fragments of the bf16 tail hold the fc2 accumulator
    of one window: at most ``_TC_ACC`` 16x16 output tiles each."""
    return _up(n, 16) // 16 * (c // 16) <= _TC_ACC * _WARPS


def _block_tiles_take(c: int, num_heads: int, ch: int, dtype: torch.dtype,
                      backward: bool) -> bool:
    """Whether PR 4's whole-block bodies (``csrc/fold_attn.cu``, the
    backward ``csrc/fold_attn_bwd.cu``) take the widths (``_check_block``,
    ``_check_fold``): C and the hidden width multiples of 4, in bf16 whole
    16x16 tiles and a forward hidden width in whole 128-column chunks."""
    if c % 4 or ch % 4 or ch <= 0:
        return False
    if dtype != torch.bfloat16:
        return True
    return _whole_tiles(c, num_heads) and (backward or ch % _MLP_CHUNK == 0)


def fold_block_fits(n: int, c: int, num_heads: int, ch: int, dtype: torch.dtype) -> bool:
    """Whether a window runs in the whole-block kernels, forward **and**
    backward (one predicate, as ``folded_full_block_applicable``): both of
    PR 4's blocks fit ``SMEM_LIMIT`` and, in bf16, the warps' fragments hold
    the fc2 accumulator (at most ``_TC_ACC`` 16x16 tiles each), the memory
    gate as it stood; and some body of each direction takes the geometry at
    hidden width ``ch`` (``fold_block_fwd_body``, ``fold_block_bwd_body``,
    ``_block_tiles_take``), so that a true answer never ends in a refused
    launch."""
    bf16 = dtype == torch.bfloat16
    if bf16 and not _tail_acc_fits(n, c):
        return False
    if not (fold_block_smem_bytes(n, c, num_heads, bf16) <= SMEM_LIMIT
            and fold_block_smem_bytes(n, c, num_heads, bf16, backward=True) <= SMEM_LIMIT):
        return False
    return ((fold_block_fwd_body(n, c, num_heads, ch, dtype) == "mma"
             or _block_tiles_take(c, num_heads, ch, dtype, backward=False))
            and (fold_block_bwd_body(n, c, num_heads, ch, dtype) == "mma"
                 or _block_tiles_take(c, num_heads, ch, dtype, backward=True)))


def _ln_stats(x32: torch.Tensor):
    """xhat and rstd of flax's fast-variance LayerNorm (eps 1e-5), fp32."""
    mu = x32.mean(-1, keepdim=True)
    var = torch.clamp((x32 * x32).mean(-1, keepdim=True) - mu * mu, min=0.0)
    rstd = torch.rsqrt(var + 1e-5)
    return (x32 - mu) * rstd, rstd


def _ln_fast(x32: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """flax LayerNorm numerics in fp32: fast variance, eps 1e-5."""
    return _ln_stats(x32)[0] * scale.float() + bias.float()


def _fold_forward_plain(x, ln_scale, ln_bias, qkv_w, qkv_b, proj_w, proj_b, bias, mask,
                        num_heads, window, scale, residual, shift, packed):
    if any(shift):
        y = _fold_forward_plain(
            torch.roll(x, tuple(-s for s in shift), (1, 2, 3)), ln_scale, ln_bias,
            qkv_w, qkv_b, proj_w, proj_b, bias, mask, num_heads, window, scale,
            residual, (0, 0, 0), packed,
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
    if packed:  # q is scaled before it is rounded
        qkv = torch.cat((qkv[..., :C] * scale, qkv[..., C:]), -1)
    qkv = qkv.to(dt).reshape(Bn, N, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0].float(), qkv[1].float(), qkv[2].float()  # (Bn, nH, N, hd)
    s = q @ k.transpose(-2, -1)
    if not packed:
        s = s * scale
    s = s + bias[None]
    if mask is not None:
        nW = mask.shape[0]
        s = (s.reshape(Bn // nW, nW, num_heads, N, N) + mask[None, :, None]).reshape(
            Bn, num_heads, N, N
        )
    if packed:  # per-head row max, e * (1 / sum e)
        e = torch.exp(s - s.amax(-1, keepdim=True))
        p = (e * (1.0 / e.sum(-1, keepdim=True))).to(dt).float()
    else:
        p = torch.softmax(s, dim=-1).to(dt).float()
    o = (p @ v).to(dt)  # (Bn, nH, N, hd)
    o = o.transpose(1, 2).reshape(Bn, N, C)
    out = o.float() @ proj_w.to(dt).float() + proj_b.float()
    if residual:
        out = out + wins.float()
    return window_reverse(out.to(dt), window, B, D, H, W)


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
    return _fold_forward_plain(x, ln_scale, ln_bias, qkv_w, qkv_b, proj_w, proj_b, bias,
                               mask, num_heads, window, scale, residual, shift, False)


def fold_attention_packed_plain(x, ln_scale, ln_bias, qkv_w, qkv_b, proj_w, proj_b, bias,
                                mask, num_heads, window, scale, residual=True,
                                shift=(0, 0, 0)) -> torch.Tensor:
    """Plain PyTorch version of kernel 10 (``_fold_packed_kernel``): kernel
    A's function except that the qkv row stays fp32 until ``q = round(q *
    scale)`` and k, v round (no scale after the product), the row max is per
    head, and ``p = round(e * (1 / sum e))``."""
    return _fold_forward_plain(x, ln_scale, ln_bias, qkv_w, qkv_b, proj_w, proj_b, bias,
                               mask, num_heads, window, scale, residual, shift, True)


def fold_block_plain(x, ln_scale, ln_bias, qkv_w, qkv_b, proj_w, proj_b, bias, mask,
                     ln2_scale, ln2_bias, w1, b1, w2, b2, num_heads, window, scale,
                     shift=(0, 0, 0)) -> torch.Tensor:
    """Plain PyTorch version of the whole-block forward (``_fold_kernel``
    with ``tail=``): ``y1 = x + proj(attn(LN1 x))`` with kernel A's cast
    boundaries, **rounded to the compute dtype**, then
    ``y1 + fc2(gelu(fc1(LN2 y1)))`` with kernel B's (``_mlp_tail_rows``), so
    the result is what kernels A then B give, bit for bit."""
    from vadcl_tpu_torch.ops.ln_mlp import ln_mlp_plain

    y1 = fold_attention_plain(x, ln_scale, ln_bias, qkv_w, qkv_b, proj_w, proj_b, bias,
                              mask, num_heads, window, scale, True, shift)
    return ln_mlp_plain(y1, ln2_scale, ln2_bias, w1, b1, w2, b2)


def _ln_vjp(dxa: torch.Tensor, xhat: torch.Tensor, rstd: torch.Tensor,
            ln_scale: torch.Tensor) -> torch.Tensor:
    """d(input) of the fast-variance LayerNorm, fp32, from d(output)."""
    dxhat = dxa * ln_scale.float()
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xhat).mean(-1, keepdim=True)
    return rstd * (dxhat - m1 - xhat * m2)


def fold_attention_bwd_plain(
    x: torch.Tensor,  # (B, D, H, W, C) compute dtype, the forward's input
    dout: torch.Tensor,  # (B, D, H, W, C) upstream gradient
    ln_scale: Optional[torch.Tensor],  # None: no LN1 (then ``residual`` is False)
    ln_bias: Optional[torch.Tensor],
    qkv_w: torch.Tensor,
    qkv_b: Optional[torch.Tensor],
    proj_w: torch.Tensor,
    bias: torch.Tensor,
    mask: Optional[torch.Tensor],
    num_heads: int,
    window: Tri,
    scale: float,
    shift: Tri = (0, 0, 0),
    residual: bool = True,
):
    """Plain PyTorch version of kernel 6: the gradients of
    ``fold_attention`` with LN1 and the residual, or (``ln_scale=None,
    residual=False``) with neither, with the cast boundaries of
    ``_fold_bwd_kernel``: LN output, qkv, probabilities, the per-head
    output, ``dout . proj_w^T``, ``ds * scale`` and dqkv round to the compute
    dtype; every product accumulates in fp32; softmax backward, d(bias), the
    LN vjp and the residual are fp32.  Returns (dx, dln_s, dln_b, dqkv_w,
    dqkv_b, dproj_w, dproj_b, dbias), dx in the compute dtype, the rest
    fp32 (dqkv_b is None without a qkv bias, dln_* without LN1)."""
    _check_mode(ln_scale, residual)
    if any(shift):
        back = tuple(-s for s in shift)
        g = fold_attention_bwd_plain(
            torch.roll(x, back, (1, 2, 3)), torch.roll(dout, back, (1, 2, 3)),
            ln_scale, ln_bias, qkv_w, qkv_b, proj_w, bias, mask, num_heads,
            window, scale, residual=residual,
        )
        return (torch.roll(g[0], tuple(shift), (1, 2, 3)),) + g[1:]
    B, D, H, W, C = x.shape
    dt = x.dtype
    nh, hd = num_heads, C // num_heads
    rnd = lambda t: t.to(dt).float()  # noqa: E731  a cast to the compute dtype
    wins = window_partition(x, window).float()  # (Bn, N, C)
    do = window_partition(dout.to(dt), window).float()
    Bn, N, _ = wins.shape
    if ln_scale is not None:
        xhat, rstd = _ln_stats(wins)
        row = rnd(xhat * ln_scale.float() + ln_bias.float())
    else:
        row = wins
    qw, pw = rnd(qkv_w), rnd(proj_w)
    qkv = row @ qw
    if qkv_b is not None:
        qkv = qkv + qkv_b.float()
    qkv = rnd(qkv).reshape(Bn, N, 3, nh, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]  # (Bn, nH, N, hd)
    s = (q @ k.transpose(-2, -1)) * scale + bias.float()[None]
    if mask is not None:
        nw = mask.shape[0]
        s = (s.reshape(Bn // nw, nw, nh, N, N) + mask.float()[None, :, None]).reshape(
            Bn, nh, N, N
        )
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
    dqkv_w = row.reshape(-1, C).T @ dqkv_c.reshape(-1, 3 * C)
    dxa = dqkv_c @ qw.T  # d(LN output), fp32
    if ln_scale is not None:
        dln_s = (dxa * xhat).sum((0, 1))
        dln_b = dxa.sum((0, 1))
        dx = _ln_vjp(dxa, xhat, rstd, ln_scale) + do
    else:
        dln_s = dln_b = None
        dx = dxa
    dx = window_reverse(dx.to(dt), window, B, D, H, W)
    return dx, dln_s, dln_b, dqkv_w, dqkv_b, dproj_w, dproj_b, dbias


FOLD_BLOCK_GRADS = ("dx", "dln_s", "dln_b", "dqkv_w", "dqkv_b", "dproj_w", "dproj_b", "dbias",
                    "dln2_s", "dln2_b", "dw1", "db1", "dw2", "db2")


def fold_block_bwd_plain(x, dout, ln_scale, ln_bias, qkv_w, qkv_b, proj_w, proj_b, bias,
                         mask, ln2_scale, ln2_bias, w1, b1, w2, num_heads, window, scale,
                         shift=(0, 0, 0)):
    """Plain PyTorch version of the whole-block backward
    (``_fold_bwd_kernel`` with ``tail_refs=``): recompute ``y1`` (rounded),
    run the MLP tail's backward on it with kernel 5's numerics (the
    recompute rounds, the products are fp32 on fp32 operands), round
    ``dy1 = dY + LN2-vjp(dz)`` to the compute dtype, and feed it to the
    attention backward with kernel 6's cast boundaries as its upstream
    gradient and residual branch.  Returns the gradients named by
    ``FOLD_BLOCK_GRADS``: dx in the compute dtype, the rest fp32 (dqkv_b
    None without a qkv bias)."""
    from vadcl_tpu_torch.ops.ln_mlp import ln_mlp_bwd_plain

    y1 = fold_attention_plain(x, ln_scale, ln_bias, qkv_w, qkv_b, proj_w, proj_b, bias,
                              mask, num_heads, window, scale, True, shift)
    dy1, *tail = ln_mlp_bwd_plain(y1, dout, ln2_scale, ln2_bias, w1, b1, w2)
    front = fold_attention_bwd_plain(x, dy1, ln_scale, ln_bias, qkv_w, qkv_b, proj_w, bias,
                                     mask, num_heads, window, scale, shift, True)
    return (*front, *tail)


def _check_mode(ln_scale, residual) -> None:
    if (ln_scale is None) == bool(residual):
        raise NotImplementedError(
            "fold_attention: the backward (kernel 6) covers LN1 + residual (the "
            "Swin block's front half) and neither (a block at a window-padded "
            "geometry), the two modes the reference calls it in"
        )


def _fold_bwd_through_windows(x, dout, ln_s, ln_b, qkv_w, qkv_b, proj_w, bias, mask,
                              num_heads, window, scale, shift, residual):
    """The backward of ``fold_attention`` where kernel 6's block does not fit
    shared memory (``_blk_bwd``'s fallback): LN1 is replayed and
    differentiated outside the kernel, the windows are partitioned, and
    kernel 8 (``window_attention_fused_bwd``) does the rest."""
    from vadcl_tpu_torch.ops.window_attn import window_attention_fused_bwd

    B, D, H, W, C = x.shape
    dt = x.dtype
    if any(shift):
        back = tuple(-s for s in shift)
        x, dout = torch.roll(x, back, (1, 2, 3)), torch.roll(dout, back, (1, 2, 3))
    if ln_s is not None:
        xhat, rstd = _ln_stats(x.float())
        xa = (xhat * ln_s.float() + ln_b.float()).to(dt)
    else:
        xa = x
    n_windows = (D // window[0]) * (H // window[1]) * (W // window[2])
    dxa_w, dqw, dqb, dpw, dpb, dbias = window_attention_fused_bwd(
        window_partition(xa, window), window_partition(dout.to(dt), window), qkv_w,
        qkv_b, proj_w, bias, mask, num_heads, n_windows, scale,
    )
    dxa = window_reverse(dxa_w, window, B, D, H, W).float()
    dln_s = dln_b = None
    if ln_s is not None:
        dln_s, dln_b = (dxa * xhat).sum((0, 1, 2, 3)), dxa.sum((0, 1, 2, 3))
        dxa = _ln_vjp(dxa, xhat, rstd, ln_s)
    if residual:
        dxa = dxa + dout.float()
    dx = dxa.to(dt)
    if any(shift):
        dx = torch.roll(dx, tuple(shift), (1, 2, 3))
    return dx, dln_s, dln_b, dqw, dqb, dpw, dpb, dbias


def _counter_name(counter) -> str:
    """The ``vadcl::fold_attention`` op's counter argument: the wrapper's
    name ("" for the op's own)."""
    return "" if counter is None else counter.__name__


class _FoldAttention(torch.autograd.Function):
    """Forward kernel A, backward kernel 6
    (``folded_block_attention_trainable``'s custom VJP with LN1 and the
    residual, ``folded_window_attention_trainable``'s with neither)."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, qkv_w, qkv_b, proj_w, proj_b, bias,
                mask, num_heads, window, scale, residual, shift, counter, bwd_counter):
        args = (x, ln_scale, ln_bias, qkv_w, qkv_b, proj_w, proj_b, bias, mask,
                num_heads, window, scale, residual, shift)
        ctx.save_for_backward(x, ln_scale, ln_bias, qkv_w, qkv_b, proj_w, bias, mask)
        ctx.meta = (num_heads, window, scale, residual, shift, bwd_counter)
        return _library.fold_attention(*args, False, _counter_name(counter))

    @staticmethod
    def backward(ctx, dout):
        x, ln_s, ln_b, qkv_w, qkv_b, proj_w, bias, mask = ctx.saved_tensors
        num_heads, window, scale, residual, shift, bwd_counter = ctx.meta
        _check_mode(ln_s, residual)
        n = window[0] * window[1] * window[2]
        args = (x, dout, ln_s, ln_b, qkv_w, qkv_b, proj_w, bias, mask, num_heads,
                window, scale, shift, residual)
        if fold_fits(n, x.shape[-1], num_heads, x.dtype, backward=True):
            grads = fold_attention_bwd(*args, counter=bwd_counter)
        else:
            grads = _fold_bwd_through_windows(*args)
        return (*grads, None, None, None, None, None, None, None, None)


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
    counter=None,
    bwd_counter=None,
) -> torch.Tensor:
    """``x + proj(attn(LN1(x)))`` per window (without ``+ x`` when not
    ``residual``), computed on the unpartitioned tensor.  With ``shift`` the
    shifted-window roll is folded in (``mask`` is then the shifted blocks'
    mask).  With a zero shift, the contract of
    ``fused_window_attention_folded(..., ln_scale=, ln_bias=, residual=)``.
    Differentiable (kernel 6) with LN1 and the residual, or with neither.
    The launches count on ``counter`` and ``bwd_counter`` where given (a
    ``base`` block's kernels 7 and 8), else on this wrapper and
    ``fold_attention_bwd``."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fold_attention: unsupported device {x.device}")
    return _FoldAttention.apply(x, ln_scale, ln_bias, qkv_w, qkv_b, proj_w, proj_b,
                                bias, mask, num_heads, tuple(window), scale,
                                residual, tuple(shift), counter, bwd_counter)


fold_attention.launches = 0


def fold_attention_bwd(x, dout, ln_scale, ln_bias, qkv_w, qkv_b, proj_w, bias,
                       mask, num_heads, window, scale, shift=(0, 0, 0), residual=True,
                       tiles: bool = False, counter=None):
    """Kernel 6: the gradients of ``fold_attention`` with LN1 and the
    residual, or (``ln_scale=None, residual=False``) with neither, as
    ``fold_attention_bwd_plain`` returns them (the contract of
    ``_fold_bwd_call(..., fuse_ln=, residual=)`` with the shift roll folded
    in).  ``fold_bwd_body`` picks the body; ``tiles`` forces the
    shared-memory body.  Counts the tensor-core body's launches (on
    ``counter`` where given)."""
    _check_mode(ln_scale, residual)
    args = (x, dout, ln_scale, ln_bias, qkv_w, qkv_b, proj_w, bias, mask,
            num_heads, tuple(window), scale, tuple(shift), bool(residual))
    if x.device.type == "cpu":
        return fold_attention_bwd_plain(*args)
    if x.device.type != "cuda":
        raise ValueError(f"fold_attention_bwd: unsupported device {x.device}")
    n = window[0] * window[1] * window[2]
    if not tiles and fold_bwd_body(n, x.shape[-1], num_heads, x.dtype) == "mma":
        return _fold_attention_bwd_mma(*args, counter=counter)
    return _fold_attention_bwd_cuda(*args)


fold_attention_bwd.launches = 0


def fold_attention_bwd_tiles(x, dout, ln_scale, ln_bias, qkv_w, qkv_b, proj_w, bias,
                             mask, num_heads, window, scale, shift=(0, 0, 0), residual=True):
    """Kernel 6 on its shared-memory body (``csrc/fold_attn_bwd.cu``) whatever
    the geometry; counts that body's launches (also those the route makes
    through ``fold_attention_bwd``: fp32, and bf16 geometries the tensor-core
    body does not take)."""
    return fold_attention_bwd(x, dout, ln_scale, ln_bias, qkv_w, qkv_b, proj_w, bias, mask,
                              num_heads, window, scale, shift, residual, tiles=True)


fold_attention_bwd_tiles.launches = 0


class _FoldAttentionPacked(torch.autograd.Function):
    """Kernel 10: forward only, as in the JAX package."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, qkv_w, qkv_b, proj_w, proj_b, bias, mask,
                num_heads, window, scale, residual, shift, counter):
        args = (x, ln_scale, ln_bias, qkv_w, qkv_b, proj_w, proj_b, bias, mask,
                num_heads, window, scale, residual, shift)
        return _library.fold_attention(*args, True, _counter_name(counter))

    @staticmethod
    def backward(ctx, dout):
        raise NotImplementedError(
            "fold_attention_packed (attn_kernel='fold_packed', 'fold_mix', 'packed') is "
            "inference-only: it has no backward; train with attn_kernel='fold', "
            "'fold_block' or 'base'"
        )


def fold_attention_packed(x, ln_scale, ln_bias, qkv_w, qkv_b, proj_w, proj_b, bias, mask,
                          num_heads: int, window: Tri, scale: float, residual: bool = True,
                          shift: Tri = (0, 0, 0), counter=None) -> torch.Tensor:
    """Kernel 10: ``fold_attention``'s contract (optional LN1, optional
    residual, the shift roll folded in) with the packed arithmetic; with a
    zero shift, the contract of ``fused_window_attention_folded_packed``.
    Inference only: asking it for a gradient raises.  The launches count on
    ``counter`` where given (a ``packed`` block's kernel 9), else here."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fold_attention_packed: unsupported device {x.device}")
    return _FoldAttentionPacked.apply(x, ln_scale, ln_bias, qkv_w, qkv_b, proj_w, proj_b,
                                      bias, mask, num_heads, tuple(window), scale,
                                      residual, tuple(shift), counter)


fold_attention_packed.launches = 0


class _FoldBlock(torch.autograd.Function):
    """Forward the whole-block kernel, backward its whole-block backward
    (``folded_full_block_trainable``'s custom VJP): the inputs are saved,
    the backward recomputes the forward."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, qkv_w, qkv_b, proj_w, proj_b, bias, mask,
                ln2_scale, ln2_bias, w1, b1, w2, b2, num_heads, window, scale, shift, tiles):
        ctx.save_for_backward(x, ln_scale, ln_bias, qkv_w, qkv_b, proj_w, proj_b, bias,
                              mask, ln2_scale, ln2_bias, w1, b1, w2)
        ctx.meta = (num_heads, window, scale, shift)
        return _library.fold_block(x, ln_scale, ln_bias, qkv_w, qkv_b, proj_w, proj_b, bias,
                                   mask, ln2_scale, ln2_bias, w1, b1, w2, b2, num_heads,
                                   window, scale, shift, tiles)

    @staticmethod
    def backward(ctx, dout):
        x, *params = ctx.saved_tensors
        g = fold_block_bwd(x, dout, *params, *ctx.meta)
        # (dx, dln1 x2, dqkv x2, dproj x2, dbias), mask, (dln2 x2, dw1, db1, dw2, db2)
        return (*g[:8], None, *g[8:], None, None, None, None, None)


def fold_block(x, ln_scale, ln_bias, qkv_w, qkv_b, proj_w, proj_b, bias, mask,
               ln2_scale, ln2_bias, w1, b1, w2, b2, num_heads: int, window: Tri,
               scale: float, shift: Tri = (0, 0, 0)) -> torch.Tensor:
    """The whole Swin block in one kernel: ``y1 + fc2(gelu(fc1(LN2 y1)))``
    with ``y1 = x + proj(attn(LN1 x))`` per window, on the unpartitioned
    tensor, the shift roll folded in.  With a zero shift, the contract of
    ``folded_full_block_trainable``.  Differentiable (``fold_block_bwd``).
    ``fold_block_fwd_body`` picks the forward's body; counts the
    tensor-core body's launches."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fold_block: unsupported device {x.device}")
    return _FoldBlock.apply(x, ln_scale, ln_bias, qkv_w, qkv_b, proj_w, proj_b, bias, mask,
                            ln2_scale, ln2_bias, w1, b1, w2, b2, num_heads, tuple(window),
                            scale, tuple(shift), False)


fold_block.launches = 0


def fold_block_tiles(x, ln_scale, ln_bias, qkv_w, qkv_b, proj_w, proj_b, bias, mask,
                     ln2_scale, ln2_bias, w1, b1, w2, b2, num_heads: int, window: Tri,
                     scale: float, shift: Tri = (0, 0, 0)) -> torch.Tensor:
    """``fold_block`` with the forward on PR 4's body (``csrc/fold_attn.cu``)
    whatever the geometry; counts that body's launches (also those the route
    makes through ``fold_block``: fp32, and the bf16 geometries the
    tensor-core body does not take)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fold_block_tiles: unsupported device {x.device}")
    return _FoldBlock.apply(x, ln_scale, ln_bias, qkv_w, qkv_b, proj_w, proj_b, bias, mask,
                            ln2_scale, ln2_bias, w1, b1, w2, b2, num_heads, tuple(window),
                            scale, tuple(shift), True)


fold_block_tiles.launches = 0


def fold_block_bwd(x, dout, ln_scale, ln_bias, qkv_w, qkv_b, proj_w, proj_b, bias, mask,
                   ln2_scale, ln2_bias, w1, b1, w2, num_heads, window, scale,
                   shift=(0, 0, 0), tiles: bool = False):
    """The whole-block backward: the gradients of ``fold_block`` as
    ``fold_block_bwd_plain`` returns them (the contract of ``_full_bwd``
    with the shift roll folded in).  ``fold_block_bwd_body`` picks the body;
    ``tiles`` forces the shared-memory body.  Counts the tensor-core body's
    launches."""
    args = (x, dout, ln_scale, ln_bias, qkv_w, qkv_b, proj_w, proj_b, bias, mask,
            ln2_scale, ln2_bias, w1, b1, w2, num_heads, tuple(window), scale, tuple(shift))
    if x.device.type == "cpu":
        return fold_block_bwd_plain(*args)
    if x.device.type != "cuda":
        raise ValueError(f"fold_block_bwd: unsupported device {x.device}")
    n = window[0] * window[1] * window[2]
    if not tiles and fold_block_bwd_body(n, x.shape[-1], num_heads, w1.shape[1],
                                         x.dtype) == "mma":
        return _fold_block_bwd_mma(*args)
    return _fold_block_bwd_cuda(*args)


fold_block_bwd.launches = 0


def fold_block_bwd_tiles(x, dout, ln_scale, ln_bias, qkv_w, qkv_b, proj_w, proj_b, bias, mask,
                         ln2_scale, ln2_bias, w1, b1, w2, num_heads, window, scale,
                         shift=(0, 0, 0)):
    """The whole-block backward on its shared-memory body
    (``csrc/fold_attn_bwd.cu``) whatever the geometry; counts that body's
    launches (also those the route makes through ``fold_block_bwd``: fp32,
    and the bf16 geometries the tensor-core body does not take)."""
    return fold_block_bwd(x, dout, ln_scale, ln_bias, qkv_w, qkv_b, proj_w, proj_b, bias, mask,
                          ln2_scale, ln2_bias, w1, b1, w2, num_heads, window, scale, shift,
                          tiles=True)


fold_block_bwd_tiles.launches = 0


def _f32(t: Optional[torch.Tensor], n: int, device) -> torch.Tensor:
    if t is None:
        return torch.zeros(n, dtype=torch.float32, device=device)
    return t.detach().to(device=device, dtype=torch.float32).contiguous()


_packs = PackCache()


def pack_fold_weights(qkv_w: torch.Tensor, proj_w: torch.Tensor, num_heads: int,
                      dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The attention weights in the bf16 kernel's layout:
    ``(nH + ceil(C / 3hd), C, 3hd + 8)`` in ``dtype``.  Slice ``h < nH`` is
    head h's columns of ``qkv_w`` (its hd of q, then of k, then of v); slice
    ``nH + j`` is columns ``3hd*j ..`` of ``proj_w`` (zero past C).  The 8
    trailing elements of every row are zero padding, so that the
    tensor-core operand loads read no shared-memory bank twice, and a slice is
    one contiguous copy into the kernel's ring."""
    c = qkv_w.shape[0]
    hd = c // num_heads
    if tuple(qkv_w.shape) != (c, 3 * c) or tuple(proj_w.shape) != (c, c) or c % num_heads:
        raise ValueError(f"pack_fold_weights: {tuple(qkv_w.shape)}, {tuple(proj_w.shape)}, "
                         f"{num_heads} heads")
    width = 3 * hd
    nproj = -(-c // width)
    full = c // width  # projection slices without a ragged edge
    # three copies (each casts and permutes in one pass) into a zeroed buffer
    out = torch.zeros(num_heads + nproj, c, width + PACK_PAD, dtype=dtype, device=qkv_w.device)
    out[:num_heads, :, :width].view(num_heads, c, 3, hd).copy_(
        qkv_w.detach().reshape(c, 3, num_heads, hd).permute(2, 0, 1, 3))
    pw = proj_w.detach()
    if full:
        out[num_heads:num_heads + full, :, :width].copy_(
            pw[:, : full * width].reshape(c, full, width).permute(1, 0, 2))
    if nproj > full:
        out[-1, :, : c - full * width].copy_(pw[:, full * width:])
    return out


def unpack_fold_weights(packed: torch.Tensor, num_heads: int):
    """``(qkv_w, proj_w)`` in the packed dtype: the inverse of
    ``pack_fold_weights``."""
    _, c, padded = packed.shape
    width = padded - PACK_PAD
    hd = c // num_heads
    body = packed[..., :width]
    qkv = body[:num_heads].reshape(num_heads, c, 3, hd).permute(1, 2, 0, 3).reshape(c, 3 * c)
    proj = body[num_heads:].permute(1, 0, 2).reshape(c, -1)[:, :c]
    return qkv, proj


@functools.lru_cache(maxsize=None)
def _score_index(n: int) -> np.ndarray:
    """For each slot of the packed score layout (strip, n-tile, lane, 4) the
    flat index into an (n * n + 2) row: the (row, col) entry the mma.sync
    accumulator holds there, ``n * n`` for a padded key column, ``n * n + 1``
    for a padded query row."""
    rows_p = fold_padded_rows(n)
    strips, ntiles = rows_p // 16, rows_p // 8
    s, nt, lane, e = np.meshgrid(np.arange(strips), np.arange(ntiles), np.arange(32),
                                 np.arange(4), indexing="ij")
    row = 16 * s + lane // 4 + 8 * (e // 2)
    col = 8 * nt + 2 * (lane % 4) + e % 2
    idx = np.where(col >= n, n * n, np.where(row >= n, n * n + 1, row * n + col))
    return idx.reshape(-1).astype(np.int64)


_score_indices: dict = {}


def _score_index_on(n: int, device) -> torch.Tensor:
    key = (n, str(device))
    if key not in _score_indices:
        with torch.inference_mode(False):
            _score_indices[key] = torch.from_numpy(_score_index(n)).to(device)
    return _score_indices[key]


def pack_fold_scores(t: torch.Tensor, pad_col: float) -> torch.Tensor:
    """A stack of (N, N) score terms (the rel-pos bias ``(nH, N, N)`` or the
    shift mask ``(nW, N, N)``) in the order of the bf16 kernel's score
    accumulator: ``(G, strips, N' / 8, 32, 4)`` fp32, where strip s, n-tile
    j, lane l, element e is entry ``(16s + l // 4 + 8 (e // 2), 8j + 2 (l % 4)
    + e % 2)``; N' is N padded to 64 or 112.  Padded key columns hold
    ``pad_col`` (-inf in the bias, so that they get probability 0; 0 in the
    mask), padded query rows 0."""
    g, n, _ = t.shape
    rows_p = fold_padded_rows(n)
    flat = t.detach().to(torch.float32).reshape(g, n * n)
    ext = torch.nn.functional.pad(flat, (0, 2), value=pad_col)
    ext[:, -1] = 0.0
    return ext.index_select(1, _score_index_on(n, t.device)).reshape(
        g, rows_p // 16, rows_p // 8, 32, 4)


def unpack_fold_scores(packed: torch.Tensor, n: int) -> torch.Tensor:
    """``(G, N, N)``: the inverse of ``pack_fold_scores`` (padding dropped)."""
    g = packed.shape[0]
    idx = _score_index_on(n, packed.device)
    ext = packed.new_zeros((g, n * n + 2))
    ext[:, idx] = packed.reshape(g, -1)
    return ext[:, : n * n].reshape(g, n, n)


def _vec(t: Optional[torch.Tensor], n: int, device) -> torch.Tensor:
    """``_f32`` with an aligned base: the redesigned kernels read their fp32
    vectors 16 bytes at a time."""
    return cuda_lib.aligned(_f32(t, n, device))


def _fold_vectors(ln_scale, ln_bias, qkv_b, C, dev):
    """The fp32 LN1 scale and bias (None without LN) and qkv bias that kernel
    A and kernel 6's tensor-core body both read: one entry per parameter
    version, so the backward of a step reuses its forward's."""
    has_ln = ln_scale is not None
    return _packs.get(
        tuple(t for t in (ln_scale, ln_bias, qkv_b) if t is not None),
        ("fold vectors", has_ln, qkv_b is None, C, str(dev)),
        lambda: (_vec(ln_scale, C, dev) if has_ln else None,
                 _vec(ln_bias, C, dev) if has_ln else None, _vec(qkv_b, 3 * C, dev)))


def _fold_packs(qkv_w, proj_w, bias, mask, num_heads, dev, dt):
    """Kernel A's packs that A, 10, 6's tensor-core body and the whole-block
    backward read: the weights, the rel-pos bias and the mask (None without
    one), each made once per tensor version."""
    wp = _packs.get((qkv_w, proj_w), ("fold weights", num_heads, str(dev)),
                    lambda: pack_fold_weights(qkv_w.to(dev), proj_w.to(dev), num_heads, dt))
    bs = _packs.get((bias,), ("fold bias", str(dev)),
                    lambda: pack_fold_scores(bias.to(dev), float("-inf")))
    mk = None if mask is None else _packs.get(
        (mask,), ("fold mask", str(dev)), lambda: pack_fold_scores(mask.to(dev), 0.0))
    return wp, bs, mk


def _fold_proj_b(proj_b, C, dev):
    return _packs.get(() if proj_b is None else (proj_b,), ("fold proj_b", C, str(dev)),
                      lambda: _vec(proj_b, C, dev))


def _check_fold(what, x, bias, mask, num_heads, window, smem_bytes, register_scores=False):
    """The checks kernels A and 6 share; ``smem_bytes`` is the library's
    shared-memory size function of the kernel (what ``fold_smem_bytes``
    mirrors); ``register_scores`` adds the bf16 forward's limits."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: dtype {x.dtype} not supported")
    B, D, H, W, C = x.shape
    wd, wh, ww = window
    n = wd * wh * ww
    if C % num_heads or D % wd or H % wh or W % ww:
        raise ValueError(
            f"{what}: shape {tuple(x.shape)} is not window-divisible "
            f"by {window} / heads {num_heads}"
        )
    if x.dtype == torch.bfloat16 and (C % 16 or (C // num_heads) % 16):
        raise NotImplementedError(
            f"{what}: the bf16 kernel runs on 16x16 tensor-core tiles and "
            f"needs C and head_dim to be multiples of 16 (got C={C}, "
            f"head_dim={C // num_heads})"
        )
    nw = (D // wd) * (H // wh) * (W // ww)
    if tuple(bias.shape) != (num_heads, n, n):
        raise ValueError(f"{what}: bias {tuple(bias.shape)} != {(num_heads, n, n)}")
    if mask is not None and tuple(mask.shape) != (nw, n, n):
        raise ValueError(f"{what}: mask {tuple(mask.shape)} != {(nw, n, n)}")
    if register_scores and x.dtype == torch.bfloat16 and (
            C // num_heads not in FOLD_HEAD_DIMS or n > FOLD_MAX_TOKENS):
        raise NotImplementedError(
            f"{what}: the bf16 kernel keeps a 16 x N strip of scores in a warp's "
            f"registers and needs head_dim 16 or 32 and at most {FOLD_MAX_TOKENS} "
            f"tokens per window (got head_dim {C // num_heads}, N={n}): fold_fits() is "
            "false here and the Swin block takes the partitioned-window kernels instead"
        )
    smem = smem_bytes(n, C, num_heads, int(x.dtype == torch.bfloat16))
    if smem > SMEM_LIMIT:
        raise NotImplementedError(
            f"{what}: window of {n} tokens at C={C} needs {smem} B of "
            "shared memory per block (> 227 KB): fold_fits() is false here and "
            "the Swin block takes the partitioned-window kernels instead"
        )


def _fold_operands(x, qkv_w, qkv_b, proj_w, bias, mask):
    """The operands both kernels read, in the layouts they take: weights in
    the compute dtype (16-byte aligned), qkv bias, rel-pos bias and mask
    fp32; a missing mask is a null pointer."""
    dev, dt, C = x.device, x.dtype, x.shape[-1]
    qw = cuda_lib.aligned(qkv_w.detach().to(device=dev, dtype=dt))
    pw = cuda_lib.aligned(proj_w.detach().to(device=dev, dtype=dt))
    bs = bias.detach().to(device=dev, dtype=torch.float32).contiguous()
    mk = None if mask is None else mask.detach().to(device=dev, dtype=torch.float32).contiguous()
    return qw, _f32(qkv_b, 3 * C, dev), pw, bs, mk


def _fold_attention_cuda(x, ln_scale, ln_bias, qkv_w, qkv_b, proj_w, proj_b,
                         bias, mask, num_heads, window, scale, residual, shift,
                         packed=False, counter=None):
    """Kernel A, or with ``packed`` kernel 10 (same arguments and layout).
    The launch counts on ``counter`` (default: the wrapper of A or 10)."""
    lib = cuda_lib.library()
    what = "fold_attention_packed" if packed else "fold_attention"
    counter = counter or (fold_attention_packed if packed else fold_attention)
    _check_fold(what, x, bias, mask, num_heads, window, lib.vadcl_fold_attn_smem_bytes,
                register_scores=True)
    B, D, H, W, C = x.shape
    dev = x.device
    xc = cuda_lib.aligned(x)  # (contiguous; the bf16 kernel loads rows 16 bytes at a time)
    out = torch.empty_like(xc)
    has_ln = ln_scale is not None
    geometry = (B, D, H, W, C, num_heads, *window, shift[0] % D, shift[1] % H, shift[2] % W,
                float(scale), int(bool(residual)))
    if x.dtype == torch.bfloat16:
        # packed operands, made once per tensor version (ops/packed.py)
        wp, bs, mk = _fold_packs(qkv_w, proj_w, bias, mask, num_heads, dev, x.dtype)
        ln_s, ln_b, qb = _fold_vectors(ln_scale, ln_bias, qkv_b, C, dev)
        pb = _fold_proj_b(proj_b, C, dev)
        err = lib.vadcl_fold_attn_bf16(
            xc.data_ptr(),
            ln_s.data_ptr() if has_ln else None, ln_b.data_ptr() if has_ln else None,
            wp.data_ptr(), qb.data_ptr(), pb.data_ptr(), bs.data_ptr(),
            mk.data_ptr() if mk is not None else None, out.data_ptr(),
            *geometry, int(packed), cuda_lib.stream_ptr(xc),
        )
    else:
        ln_s = _f32(ln_scale, C, dev) if has_ln else None
        ln_b = _f32(ln_bias, C, dev) if has_ln else None
        qw, qb, pw, bs, mk = _fold_operands(xc, qkv_w, qkv_b, proj_w, bias, mask)
        pb = _f32(proj_b, C, dev)
        err = (lib.vadcl_fold_attn_packed if packed else lib.vadcl_fold_attn)(
            xc.data_ptr(),
            ln_s.data_ptr() if has_ln else None, ln_b.data_ptr() if has_ln else None,
            qw.data_ptr(), qb.data_ptr(), pw.data_ptr(), pb.data_ptr(),
            bs.data_ptr(), mk.data_ptr() if mk is not None else None, out.data_ptr(),
            *geometry, 0, cuda_lib.stream_ptr(xc),
        )
    cuda_lib.check(err, what)
    counter.launches += 1
    return out


def _check_block(what, x, w1, w2, window, hidden_multiple):
    """The whole-block kernels' checks on the MLP tail's operands."""
    c = x.shape[-1]
    ch = w1.shape[1]
    if tuple(w1.shape) != (c, ch) or tuple(w2.shape) != (ch, c):
        raise ValueError(f"{what}: weights {tuple(w1.shape)}, {tuple(w2.shape)} vs C={c}")
    n = window[0] * window[1] * window[2]
    if x.dtype == torch.bfloat16 and (
            ch % hidden_multiple or not _tail_acc_fits(n, c)):
        raise NotImplementedError(
            f"{what}: the bf16 kernel needs a hidden width divisible by "
            f"{hidden_multiple} and at most {_TC_ACC * _WARPS} 16x16 output tiles per "
            f"window (got hidden {ch}, N={n}, C={c})"
        )
    if c % 4 or ch % 4:
        raise NotImplementedError(
            f"{what}: the tail's vector loads need C and the hidden width to be "
            f"multiples of 4 (got C={c}, hidden {ch})"
        )
    return ch


def _fold_block_cuda(x, ln_scale, ln_bias, qkv_w, qkv_b, proj_w, proj_b, bias, mask,
                     ln2_scale, ln2_bias, w1, b1, w2, b2, num_heads, window, scale, shift,
                     tiles=False):
    """The whole-block forward: ``fold_block_fwd_body``'s body, or with
    ``tiles`` PR 4's."""
    n = window[0] * window[1] * window[2]
    if not tiles and fold_block_fwd_body(n, x.shape[-1], num_heads, w1.shape[1],
                                         x.dtype) == "mma":
        return _fold_block_mma(x, ln_scale, ln_bias, qkv_w, qkv_b, proj_w, proj_b, bias, mask,
                               ln2_scale, ln2_bias, w1, b1, w2, b2, num_heads, window, scale,
                               shift)
    lib = cuda_lib.library()
    B, D, H, W, C = x.shape
    ch = _check_block("fold_block", x, w1, w2, window, _MLP_CHUNK)
    _check_fold("fold_block", x, bias, mask, num_heads, window,
                lib.vadcl_fold_block_smem_bytes)
    dev, dt = x.device, x.dtype
    xc = x.detach().contiguous()
    out = torch.empty_like(xc)
    qw, qb, pw, bs, mk = _fold_operands(xc, qkv_w, qkv_b, proj_w, bias, mask)
    w1c = cuda_lib.aligned(w1.detach().to(device=dev, dtype=dt))
    w2c = cuda_lib.aligned(w2.detach().to(device=dev, dtype=dt))
    ls, lb, pb = _f32(ln_scale, C, dev), _f32(ln_bias, C, dev), _f32(proj_b, C, dev)
    l2s, l2b = _f32(ln2_scale, C, dev), _f32(ln2_bias, C, dev)
    b1c, b2c = _f32(b1, ch, dev), _f32(b2, C, dev)
    err = lib.vadcl_fold_block(
        xc.data_ptr(), ls.data_ptr(), lb.data_ptr(), qw.data_ptr(), qb.data_ptr(),
        pw.data_ptr(), pb.data_ptr(), bs.data_ptr(),
        mk.data_ptr() if mk is not None else None,
        l2s.data_ptr(), l2b.data_ptr(), w1c.data_ptr(), b1c.data_ptr(), w2c.data_ptr(),
        b2c.data_ptr(), out.data_ptr(),
        B, D, H, W, C, num_heads, ch, *window, shift[0] % D, shift[1] % H, shift[2] % W,
        float(scale), int(dt == torch.bfloat16), cuda_lib.stream_ptr(xc),
    )
    cuda_lib.check(err, "fold_block")
    fold_block_tiles.launches += 1
    return out


def _fold_block_mma(x, ln_scale, ln_bias, qkv_w, qkv_b, proj_w, proj_b, bias, mask,
                    ln2_scale, ln2_bias, w1, b1, w2, b2, num_heads, window, scale, shift):
    """The whole-block forward's tensor-core body, on kernel A's and kernel
    B's packs of the same tensors (the entries the backward reads)."""
    from vadcl_tpu_torch.ops.ln_mlp import _mlp_vectors
    from vadcl_tpu_torch.ops.ln_mlp import _packs as mlp_packs
    from vadcl_tpu_torch.ops.ln_mlp import pack_mlp_weights

    lib = cuda_lib.library()
    _check_fold("fold_block", x, bias, mask, num_heads, window,
                lambda n, c, nh, _: lib.vadcl_fold_block_bf16_smem_bytes(n, c, nh),
                register_scores=True)
    B, D, H, W, C = x.shape
    ch = _check_block("fold_block", x, w1, w2, window, 64)
    dev, dt = x.device, x.dtype
    xc = cuda_lib.aligned(x.detach())
    out = torch.empty_like(xc)
    wp, bs, mk = _fold_packs(qkv_w, proj_w, bias, mask, num_heads, dev, dt)
    ls, lb, qb = _fold_vectors(ln_scale, ln_bias, qkv_b, C, dev)
    pb = _fold_proj_b(proj_b, C, dev)
    mp = mlp_packs.get((w1, w2), ("mlp", str(dev)),
                       lambda: pack_mlp_weights(w1.to(dev), w2.to(dev), dt))
    l2s, l2b, b1c = _mlp_vectors(ln2_scale, ln2_bias, b1, C, ch, dev)
    b2c = mlp_packs.get(() if b2 is None else (b2,), ("mlp b2", C, str(dev)),
                        lambda: _vec(b2, C, dev))
    err = lib.vadcl_fold_block_bf16(
        xc.data_ptr(), ls.data_ptr(), lb.data_ptr(), wp.data_ptr(), qb.data_ptr(),
        pb.data_ptr(), bs.data_ptr(), mk.data_ptr() if mk is not None else None,
        l2s.data_ptr(), l2b.data_ptr(), mp.data_ptr(), b1c.data_ptr(), b2c.data_ptr(),
        out.data_ptr(), B, D, H, W, C, num_heads, ch, *window, shift[0] % D, shift[1] % H,
        shift[2] % W, float(scale), cuda_lib.stream_ptr(xc),
    )
    cuda_lib.check(err, "fold_block")
    fold_block.launches += 1
    return out


def _fold_block_bwd_cuda(x, dout, ln_scale, ln_bias, qkv_w, qkv_b, proj_w, proj_b, bias,
                         mask, ln2_scale, ln2_bias, w1, b1, w2, num_heads, window, scale,
                         shift):
    lib = cuda_lib.library()
    B, D, H, W, C = x.shape
    ch = _check_block("fold_block_bwd", x, w1, w2, window, 4)
    _check_fold("fold_block_bwd", x, bias, mask, num_heads, window,
                lib.vadcl_fold_block_bwd_smem_bytes)
    dev, dt = x.device, x.dtype
    is_bf16 = int(dt == torch.bfloat16)
    n = window[0] * window[1] * window[2]
    xc = x.detach().contiguous()
    doc = dout.detach().to(dt).contiguous()
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty_like(xc)
    vec = lambda k: torch.empty(k, **f32)  # noqa: E731
    dln_s, dln_b, dproj_b, dln2_s, dln2_b, db2 = (vec(C) for _ in range(6))
    dqkv_w, dqkv_b = torch.empty(C, 3 * C, **f32), vec(3 * C)
    dproj_w, dbias = torch.empty(C, C, **f32), torch.empty(num_heads, n, n, **f32)
    dw1, db1, dw2 = torch.empty(C, ch, **f32), vec(ch), torch.empty(ch, C, **f32)
    ws = torch.empty(
        lib.vadcl_fold_block_bwd_workspace_bytes(B, D, H, W, C, num_heads, ch, *window,
                                                 is_bf16),
        dtype=torch.uint8, device=dev,
    )
    qw, qb, pw, bs, mk = _fold_operands(xc, qkv_w, qkv_b, proj_w, bias, mask)
    w1c = w1.detach().to(device=dev, dtype=dt).contiguous()
    w2c = w2.detach().to(device=dev, dtype=dt).contiguous()
    ls, lb, pb = _f32(ln_scale, C, dev), _f32(ln_bias, C, dev), _f32(proj_b, C, dev)
    l2s, l2b, b1c = _f32(ln2_scale, C, dev), _f32(ln2_bias, C, dev), _f32(b1, ch, dev)
    outs = (dx, dln_s, dln_b, dqkv_w, dqkv_b, dproj_w, dproj_b, dbias, dln2_s, dln2_b,
            dw1, db1, dw2, db2)
    err = lib.vadcl_fold_block_bwd(
        xc.data_ptr(), doc.data_ptr(), ls.data_ptr(), lb.data_ptr(), qw.data_ptr(),
        qb.data_ptr(), pw.data_ptr(), pb.data_ptr(), bs.data_ptr(),
        mk.data_ptr() if mk is not None else None,
        l2s.data_ptr(), l2b.data_ptr(), w1c.data_ptr(), b1c.data_ptr(), w2c.data_ptr(),
        *(t.data_ptr() for t in outs), ws.data_ptr(),
        B, D, H, W, C, num_heads, ch, *window, shift[0] % D, shift[1] % H, shift[2] % W,
        float(scale), is_bf16, cuda_lib.stream_ptr(xc),
    )
    cuda_lib.check(err, "fold_block_bwd")
    fold_block_bwd_tiles.launches += 1
    return tuple(None if (t is dqkv_b and qkv_b is None) else t for t in outs)


def _fold_block_bwd_mma(x, dout, ln_scale, ln_bias, qkv_w, qkv_b, proj_w, proj_b, bias, mask,
                        ln2_scale, ln2_bias, w1, b1, w2, num_heads, window, scale, shift):
    """The whole-block backward's tensor-core body, on kernel A's and kernel
    B's packs of the same tensors."""
    from vadcl_tpu_torch.ops.ln_mlp import _mlp_vectors
    from vadcl_tpu_torch.ops.ln_mlp import _packs as mlp_packs
    from vadcl_tpu_torch.ops.ln_mlp import pack_mlp_weights

    lib = cuda_lib.library()
    _check_fold("fold_block_bwd", x, bias, mask, num_heads, window,
                lambda n, c, nh, _: lib.vadcl_fold_block_bwd_bf16_smem_bytes(n, c, nh),
                register_scores=True)
    B, D, H, W, C = x.shape
    ch = _check_block("fold_block_bwd", x, w1, w2, window, 64)
    dev, dt = x.device, x.dtype
    n = window[0] * window[1] * window[2]
    xc = cuda_lib.aligned(x.detach())
    doc = cuda_lib.aligned(dout.detach().to(dt))
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty_like(xc)
    vec = lambda k: torch.empty(k, **f32)  # noqa: E731
    dln, dln2 = torch.empty(2, C, **f32), torch.empty(2, C, **f32)  # (scale, bias) each
    dproj_b, db2 = vec(C), vec(C)
    dqkv_w, dqkv_b = torch.empty(C, 3 * C, **f32), vec(3 * C)
    dproj_w, dbias = torch.empty(C, C, **f32), torch.empty(num_heads, n, n, **f32)
    dw1, db1, dw2 = torch.empty(C, ch, **f32), vec(ch), torch.empty(ch, C, **f32)
    ws = torch.empty(
        lib.vadcl_fold_block_bwd_bf16_workspace_bytes(B, D, H, W, C, num_heads, ch, *window),
        dtype=torch.uint8, device=dev,
    )
    # the packs kernels A, 6, B and 5 read (cache hits where they ran on these versions)
    wp, bs, mk = _fold_packs(qkv_w, proj_w, bias, mask, num_heads, dev, dt)
    ls, lb, qb = _fold_vectors(ln_scale, ln_bias, qkv_b, C, dev)
    pb = _fold_proj_b(proj_b, C, dev)
    mp = mlp_packs.get((w1, w2), ("mlp", str(dev)),
                       lambda: pack_mlp_weights(w1.to(dev), w2.to(dev), dt))
    l2s, l2b, b1c = _mlp_vectors(ln2_scale, ln2_bias, b1, C, ch, dev)
    err = lib.vadcl_fold_block_bwd_bf16(
        xc.data_ptr(), doc.data_ptr(), ls.data_ptr(), lb.data_ptr(), wp.data_ptr(),
        qb.data_ptr(), pb.data_ptr(), bs.data_ptr(),
        mk.data_ptr() if mk is not None else None,
        l2s.data_ptr(), l2b.data_ptr(), mp.data_ptr(), b1c.data_ptr(),
        *(t.data_ptr() for t in (dx, dln, dqkv_w, dqkv_b, dproj_w, dproj_b, dbias, dln2, dw1,
                                 db1, dw2, db2)), ws.data_ptr(),
        B, D, H, W, C, num_heads, ch, *window, shift[0] % D, shift[1] % H, shift[2] % W,
        float(scale), cuda_lib.stream_ptr(xc),
    )
    cuda_lib.check(err, "fold_block_bwd")
    fold_block_bwd.launches += 1
    return (dx, dln[0], dln[1], dqkv_w, dqkv_b if qkv_b is not None else None, dproj_w,
            dproj_b, dbias, dln2[0], dln2[1], dw1, db1, dw2, db2)


def _fold_attention_bwd_cuda(x, dout, ln_scale, ln_bias, qkv_w, qkv_b, proj_w,
                             bias, mask, num_heads, window, scale, shift, residual):
    lib = cuda_lib.library()
    _check_fold("fold_attention_bwd", x, bias, mask, num_heads, window,
                lib.vadcl_fold_attn_bwd_smem_bytes)
    B, D, H, W, C = x.shape
    dev, dt = x.device, x.dtype
    is_bf16 = int(dt == torch.bfloat16)
    n = window[0] * window[1] * window[2]
    xc = x.contiguous()
    doc = dout.to(dt).contiguous()
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty_like(xc)
    has_ln = ln_scale is not None
    dln_s = torch.empty(C, **f32) if has_ln else None
    dln_b = torch.empty(C, **f32) if has_ln else None
    dqkv_w, dqkv_b = torch.empty(C, 3 * C, **f32), torch.empty(3 * C, **f32)
    dproj_w, dproj_b = torch.empty(C, C, **f32), torch.empty(C, **f32)
    dbias = torch.empty(num_heads, n, n, **f32)
    ws = torch.empty(
        lib.vadcl_fold_attn_bwd_workspace_bytes(B, D, H, W, C, num_heads, *window, is_bf16),
        dtype=torch.uint8, device=dev,
    )
    ls = _f32(ln_scale, C, dev) if has_ln else None
    lb = _f32(ln_bias, C, dev) if has_ln else None
    qw, qb, pw, bs, mk = _fold_operands(xc, qkv_w, qkv_b, proj_w, bias, mask)
    err = lib.vadcl_fold_attn_bwd(
        xc.data_ptr(), doc.data_ptr(),
        ls.data_ptr() if has_ln else None, lb.data_ptr() if has_ln else None,
        qw.data_ptr(), qb.data_ptr(), pw.data_ptr(), bs.data_ptr(),
        mk.data_ptr() if mk is not None else None,
        dx.data_ptr(),
        dln_s.data_ptr() if has_ln else None, dln_b.data_ptr() if has_ln else None,
        dqkv_w.data_ptr(),
        dqkv_b.data_ptr(), dproj_w.data_ptr(), dproj_b.data_ptr(), dbias.data_ptr(),
        ws.data_ptr(),
        B, D, H, W, C, num_heads, *window, shift[0] % D, shift[1] % H,
        shift[2] % W, float(scale), int(residual), is_bf16, cuda_lib.stream_ptr(xc),
    )
    cuda_lib.check(err, "fold_attention_bwd")
    fold_attention_bwd_tiles.launches += 1
    return (dx, dln_s, dln_b, dqkv_w, dqkv_b if qkv_b is not None else None,
            dproj_w, dproj_b, dbias)


def _fold_attention_bwd_mma(x, dout, ln_scale, ln_bias, qkv_w, qkv_b, proj_w,
                            bias, mask, num_heads, window, scale, shift, residual,
                            counter=None):
    """Kernel 6's tensor-core body, on kernel A's packs of the same tensors.
    The launch counts on ``counter`` (default: ``fold_attention_bwd``)."""
    lib = cuda_lib.library()
    _check_fold("fold_attention_bwd", x, bias, mask, num_heads, window,
                lambda n, c, nh, _: lib.vadcl_fold_attn_bwd_bf16_smem_bytes(n, c, nh),
                register_scores=True)
    B, D, H, W, C = x.shape
    dev, dt = x.device, x.dtype
    n = window[0] * window[1] * window[2]
    xc = cuda_lib.aligned(x)
    doc = cuda_lib.aligned(dout.to(dt))
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty_like(xc)
    has_ln = ln_scale is not None
    dln_s = torch.empty(C, **f32) if has_ln else None
    dln_b = torch.empty(C, **f32) if has_ln else None
    dqkv_w, dqkv_b = torch.empty(C, 3 * C, **f32), torch.empty(3 * C, **f32)
    dproj_w, dproj_b = torch.empty(C, C, **f32), torch.empty(C, **f32)
    dbias = torch.empty(num_heads, n, n, **f32)
    ws = torch.empty(
        lib.vadcl_fold_attn_bwd_bf16_workspace_bytes(B, D, H, W, C, num_heads, *window),
        dtype=torch.uint8, device=dev,
    )
    # the forward's packs of these tensor versions (cache hits within a step)
    wp, bs, mk = _fold_packs(qkv_w, proj_w, bias, mask, num_heads, dev, dt)
    ls, lb, qb = _fold_vectors(ln_scale, ln_bias, qkv_b, C, dev)
    err = lib.vadcl_fold_attn_bwd_bf16(
        xc.data_ptr(), doc.data_ptr(),
        ls.data_ptr() if has_ln else None, lb.data_ptr() if has_ln else None,
        wp.data_ptr(), qb.data_ptr(), bs.data_ptr(),
        mk.data_ptr() if mk is not None else None, dx.data_ptr(),
        dln_s.data_ptr() if has_ln else None, dln_b.data_ptr() if has_ln else None,
        dqkv_w.data_ptr(), dqkv_b.data_ptr(), dproj_w.data_ptr(), dproj_b.data_ptr(),
        dbias.data_ptr(), ws.data_ptr(),
        B, D, H, W, C, num_heads, *window, shift[0] % D, shift[1] % H, shift[2] % W,
        float(scale), int(residual), cuda_lib.stream_ptr(xc),
    )
    cuda_lib.check(err, "fold_attention_bwd")
    (counter or fold_attention_bwd).launches += 1
    return (dx, dln_s, dln_b, dqkv_w, dqkv_b if qkv_b is not None else None,
            dproj_w, dproj_b, dbias)
