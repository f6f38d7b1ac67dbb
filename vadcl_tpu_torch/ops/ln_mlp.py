"""Kernel B: the fused LN2 -> MLP -> residual tail of a Swin block, and
kernel 5, its backward.

Kernel B replaces ``vadcl_tpu/ops/pallas_mlp.py:_fwd_kernel`` (entry
``fused_ln_mlp``).  Its CUDA kernels are in ``csrc/ln_mlp.cu`` and
``csrc/ln_mlp_slab.cu``; all walk the 4C hidden width in chunks so the
hidden activation never reaches device memory, and ``mlp_fwd_body`` picks
one by width.  bf16 at C % 16 == 0, C <= 192 and a hidden width divisible by
128 is a persistent grid of warpgroups that each own 64 tokens, run fc1 and
fc2 as warpgroup matrix multiplies (wgmma), keep the hidden activation in
registers between the two, and read the weights from a shared-memory ring
that a producer warp fills with bulk copies, both weight matrices packed by
hidden chunk (``pack_mlp_weights``, cached per parameter version in
``_packs``); ``ln_mlp`` counts it.  bf16 at C % 16 == 0, 192 < C <= 1024
and a hidden width divisible by 64 runs the slab body: the same design with
fc2's output columns cut into slabs of 256 or 128 across blocks
(``MLP_SLAB_SHAPES``, weights packed by ``pack_mlp_slabs``); ``ln_mlp_slab``
counts it.  Every other width, and fp32, runs the CUDA-core body (32 tokens
a block, fewer above C = 844, fp32 arithmetic, the same cast boundaries),
which ``ln_mlp_tiles`` counts: no width up to C = 28,992 is refused (the
card has run it up to C = 4,096, 4 tokens a block; the 2- and 1-token
blocks above C = 7,200 are routed but have not run on the card).

Kernel 5 replaces ``_bwd_kernel`` (entry ``_vjp_bwd``).  Like the Pallas
backward, every product is fp32 on fp32 operands; per token tile the kernel
recomputes the forward and emits dx, and the weight and bias sums over tokens
go through a deterministic second pass.  It has three bodies, picked by
``mlp_bwd_body``: in bf16 at C % 16 == 0, C <= 192 and a hidden width
divisible by 64 (the flagship's widths) ``csrc/ln_mlp_bwd_mma.cu`` runs every
product on the tensor cores (mma.sync), an fp32 operand split into bf16 hi
and lo parts whose products are summed in fp32, reads B's cached pack and
runs its second pass on the tensor cores too (``csrc/reduce_mma.cu``); in
bf16 at C % 16 == 0, 192 < C <= 592 and a hidden width divisible by 64 (the
Video Swin-B width's C = 256) the slab body ``csrc/ln_mlp_bwd_slab.cu`` does
the same on wgmma with dz's columns cut into slabs (``MLP_BWD_SLAB_SHAPES``),
reading B's slab pack, counted on ``ln_mlp_bwd_slab``; fp32 and every other
width run the CUDA-core body of ``csrc/ln_mlp_bwd.cu`` (vector loads where C
and the hidden width are multiples of 4, scalar loads elsewhere; 16-token
tiles, fewer above C = 772), which ``ln_mlp_bwd_tiles`` counts: no width up
to C = 3,500 is refused.

``ln_mlp`` is a ``torch.autograd.Function``: forward kernel B, backward
kernel 5.  On a CPU tensor both run their plain versions (``ln_mlp_plain``,
``ln_mlp_bwd_plain``); on a CUDA tensor they launch the kernels or raise.
Bounds on the card and what the simple designs leave are in the headers of
the two ``.cu`` files.
"""

from __future__ import annotations

import torch

from vadcl_tpu_torch.ops import cuda_lib
from vadcl_tpu_torch.ops import library as _library
from vadcl_tpu_torch.ops.fold_attn import SMEM_LIMIT, _f32, _ln_fast, _ln_stats, _ln_vjp, _vec
from vadcl_tpu_torch.ops.packed import PackCache

MLP_CHUNK = 64  # hidden columns per packed chunk (csrc/ln_mlp.cu:kMmaChunk)
_packs = PackCache()

# Kernel 5's tensor-core body (csrc/ln_mlp_bwd_mma.cu): a block of 8 warps owns
# 128 tokens; a warp keeps its 16 x C dz accumulator in registers, C being a
# template parameter of the kernel (16 .. 192 in steps of 16).
MLP_BWD_MMA_MAX_C = 192
_M5_ROWS, _M5_WARPS, _M5_PAD = 128, 8, 8


def mlp_bwd_mma_smem_bytes(c: int) -> int:
    """Shared memory of one block of kernel 5's tensor-core body
    (``csrc/ln_mlp_bwd_mma.cu:m5_smem``): two mbarriers, two ring stages of
    one packed chunk, the round(z) and dy tiles (rows padded by 8), the rows'
    LN statistics and the warps' dLN2 column sums: 214,144 B at C = 192."""
    return (128 + 2 * 2 * 2 * c * MLP_CHUNK + 2 * 2 * _M5_ROWS * (c + _M5_PAD)
            + 4 * 2 * _M5_ROWS + 4 * _M5_WARPS * 2 * c)


# Kernel 5's CUDA-core body (csrc/mlp_bwd.cuh): tiles of 16 tokens, or 8, 4, 2
# where 16 tokens' fp32 rows outgrow the block (mlp_bwd_tokens), 128 threads.
_M5T_TOKENS, _M5T_THREADS, _M5T_WARPS, _M5T_PAD = (16, 8, 4, 2), 128, 4, 4


def mlp_bwd_tiles_smem_bytes(c: int, tokens: int = 16) -> int:
    """Shared memory of one block of kernel 5's CUDA-core body at ``tokens``
    tokens a tile (``csrc/mlp_bwd.cuh:mlp_bwd_smem_bytes``): four C-wide fp32
    rows a token (rows padded to 4, then 4), the hidden chunk's two rows
    (4 * 128 / (tokens / 2) columns, padded by 4), rstd, and the warps'
    dLN2 partials."""
    cs = -(-c // 4) * 4 + _M5T_PAD
    hs = 4 * _M5T_THREADS // (tokens // 2) + _M5T_PAD
    return 4 * (4 * tokens * cs + 2 * tokens * hs + tokens + _M5T_WARPS * 2 * c)


def mlp_bwd_tokens(c: int) -> int:
    """Tokens a tile of kernel 5's CUDA-core body holds at width ``c``
    (``csrc/mlp_bwd.cuh:mlp_bwd_tokens``): the most of 16, 8, 4, 2 whose block
    fits ``SMEM_LIMIT``, 0 above C = 3,500."""
    return next((t for t in _M5T_TOKENS if mlp_bwd_tiles_smem_bytes(c, t) <= SMEM_LIMIT), 0)


# Kernel B's CUDA-core body (csrc/ln_mlp.cu:ln_mlp_kernel): 32 tokens a block
# (fewer where they do not fit), the hidden width walked 128 columns at a time
# (csrc/mlp_tail.cuh).
_MLP_TILE_TOKENS, _MLP_TILE_CHUNK = (32, 16, 8, 4, 2, 1), 128
MLP_FWD_MMA_MAX_C = 192

# Kernel B's slab body (csrc/ln_mlp_slab.cu:kMsShapes): (output columns per
# slab, hidden columns per streamed chunk, the widest C), for bf16 at
# C % 16 == 0 from kMsMinC and a hidden width divisible by 64; the route
# gives it the widths above 192 only.
MLP_SLAB_SHAPES = ((256, 64, 256), (128, 16, 1024))
MLP_SLAB_MIN_C, MLP_SLAB_MAX_C = 16, MLP_SLAB_SHAPES[-1][2]
_MS_ROWS, _MS_MAX_STAGES, _MS_HIDDEN = 64, 4, 64


# Kernel 5's slab body (csrc/ln_mlp_bwd_slab.cu:kBsShapes): (dz columns per
# slab, hidden columns per streamed chunk, the widest C), B's slab pack's
# (slab, chunk) at each width, for bf16 at C % 16 == 0 from its minimum and a
# hidden width divisible by 64; the route gives it the widths above 192.  Its
# block holds the 64 x C round(z) and dy tiles beside at least two ring
# stages, so C stops at 592 (230,464 B).
MLP_BWD_SLAB_SHAPES = ((256, 64, 256), (128, 16, 592))
MLP_BWD_SLAB_MIN_C, MLP_BWD_SLAB_MAX_C = 16, MLP_BWD_SLAB_SHAPES[-1][2]
_BS_ROWS, _BS_MAX_STAGES = 64, 4


def mlp_bwd_slab_shape(c: int):
    """(slab, chunk, max C) of kernel 5's slab body's instance at width ``c``
    (``csrc/ln_mlp_bwd_slab.cu:bs_shape``), or None where none takes it."""
    if c < MLP_BWD_SLAB_MIN_C or c % 16:
        return None
    return next((sh for sh in MLP_BWD_SLAB_SHAPES if c <= sh[2]), None)


def mlp_bwd_slab_smem_bytes(c: int, stages: int = 2) -> int:
    """Shared memory of one block of kernel 5's slab body
    (``csrc/ln_mlp_bwd_slab.cu:bs_smem_bytes``): the ring's mbarriers,
    ``stages`` ring stages of W1 (C x chunk) and every slab's W2 piece
    (chunk x slab), and the 64 x C round(z) and dy tiles, all bf16:
    196,672 B at C = 256 (two stages)."""
    cs, hc, _ = mlp_bwd_slab_shape(c)
    slabs = -(-c // cs)
    return 2 * 8 * _BS_MAX_STAGES + stages * 2 * hc * (c + slabs * cs) + 2 * 2 * _BS_ROWS * c


def _bwd_slab_takes(c: int, ch: int, dtype: torch.dtype) -> bool:
    """Whether kernel 5's slab body can run the width (``ln_mlp_bwd_slab``
    forces it there); ``mlp_bwd_body`` gives it only the widths above 192."""
    return (dtype == torch.bfloat16 and mlp_bwd_slab_shape(c) is not None and ch > 0
            and ch % _MS_HIDDEN == 0 and mlp_bwd_slab_smem_bytes(c) <= SMEM_LIMIT)


def mlp_fwd_tokens(c: int) -> int:
    """Tokens a block of kernel B's CUDA-core body holds at width ``c``
    (``csrc/ln_mlp.cu:mlp_tokens``): the most of 32, 16, ..., 1 whose block
    fits ``SMEM_LIMIT``, 0 above C = 28,992."""
    return next((t for t in _MLP_TILE_TOKENS
                 if 4 * (2 * t * c + t * _MLP_TILE_CHUNK) <= SMEM_LIMIT), 0)


def mlp_fwd_smem_bytes(c: int) -> int:
    """Shared memory of one block of kernel B's CUDA-core body
    (``csrc/ln_mlp.cu:mlp_smem_bytes``): the LN output and the fc2 sums of
    its tokens and one GELU chunk, fp32: 81,920 B at C = 256 (32 tokens)."""
    t = mlp_fwd_tokens(c) or 1
    return 4 * (2 * t * c + t * _MLP_TILE_CHUNK)


def mlp_slab_shape(c: int):
    """(slab, chunk, max C) of the slab body's instance at width ``c``
    (``csrc/ln_mlp_slab.cu:ms_shape``), or None where none takes it."""
    if c < MLP_SLAB_MIN_C or c % 16:
        return None
    return next((sh for sh in MLP_SLAB_SHAPES if c <= sh[2]), None)


def mlp_slab_smem_bytes(c: int, groups: int = 1, stages: int = 2) -> int:
    """Shared memory of one block of the slab body
    (``csrc/ln_mlp_slab.cu:ms_smem_bytes``): the ring's mbarriers, each
    consumer warpgroup's 64 x C bf16 z tile, and ``stages`` ring stages of
    W1 (C x chunk) and W2 (chunk x slab) in bf16."""
    cs, hc, _ = mlp_slab_shape(c)
    return 2 * 8 * _MS_MAX_STAGES + groups * 2 * _MS_ROWS * c + stages * 2 * hc * (c + cs)


def _slab_takes(c: int, ch: int, dtype: torch.dtype) -> bool:
    """Whether the slab body can run the width (``ln_mlp_slab`` forces it
    there); ``mlp_fwd_body`` gives it only the widths above 192."""
    return (dtype == torch.bfloat16 and mlp_slab_shape(c) is not None and ch > 0
            and ch % _MS_HIDDEN == 0 and mlp_slab_smem_bytes(c) <= SMEM_LIMIT)


def mlp_fwd_body(c: int, ch: int, dtype: torch.dtype) -> str:
    """The body kernel B runs at width ``c`` and hidden width ``ch``:
    ``"wgmma"`` (bf16, C % 16 == 0, 16 <= C <= 192, a hidden width divisible
    by 128), ``"slab"`` (bf16, C % 16 == 0, 192 < C <= 1024, a hidden width
    divisible by 64) or ``"tiles"`` (the CUDA-core body: fp32, and bf16 at
    every other width).  Raises only above C = 28,992, where not one token's
    fp32 rows fit the CUDA-core body's block."""
    if (dtype == torch.bfloat16 and c % 16 == 0 and 16 <= c <= MLP_FWD_MMA_MAX_C
            and ch % 128 == 0):
        return "wgmma"
    if c > MLP_FWD_MMA_MAX_C and _slab_takes(c, ch, dtype):
        return "slab"
    if mlp_fwd_tokens(c) > 0:
        return "tiles"
    raise NotImplementedError(
        f"ln_mlp: one token at C={c} needs {mlp_fwd_smem_bytes(c)} B of shared memory in the "
        f"CUDA-core body, above the card's {SMEM_LIMIT}"
    )


def mlp_bwd_body(c: int, ch: int, dtype: torch.dtype) -> str:
    """The body kernel 5 runs at width ``c`` and hidden width ``ch``:
    ``"mma"`` (the tensor-core body: bf16, C % 16 == 0, 16 <= C <= 192, a
    hidden width divisible by 64, its block within ``SMEM_LIMIT``),
    ``"slab"`` (the slab body: bf16, C % 16 == 0, 192 < C <= 592, a hidden
    width divisible by 64) or ``"tiles"`` (the CUDA-core body: fp32, and
    bf16 at the widths neither tensor-core body takes, any C and hidden
    width).  Raises only above C = 3,500, where no tile of two tokens fits
    the block."""
    if (dtype == torch.bfloat16 and c % 16 == 0 and 16 <= c <= MLP_BWD_MMA_MAX_C
            and ch % MLP_CHUNK == 0 and mlp_bwd_mma_smem_bytes(c) <= SMEM_LIMIT):
        return "mma"
    if c > MLP_BWD_MMA_MAX_C and _bwd_slab_takes(c, ch, dtype):
        return "slab"
    if mlp_bwd_tokens(c) > 0:
        return "tiles"
    raise NotImplementedError(
        f"ln_mlp_bwd: a tile of two tokens at C={c} needs "
        f"{mlp_bwd_tiles_smem_bytes(c, 2)} B of shared memory, above the card's {SMEM_LIMIT}"
    )


def pack_mlp_weights(w1: torch.Tensor, w2: torch.Tensor,
                     dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Both weight matrices of the MLP in the bf16 kernel's layout:
    ``(hidden / 64, 2 * C * 64)`` in ``dtype``.  Row j is hidden chunk j:
    ``w1[:, 64j:64j+64]`` then ``w2[64j:64j+64, :]``, each as a (k, n) matrix
    in the N-major core-matrix layout the warpgroup matrix multiply reads its
    B operand in, ``[n // 8][k][n % 8]`` (8 consecutive k rows of 8 columns
    are 128 contiguous bytes).  One chunk is one contiguous copy into the
    kernel's shared-memory ring."""
    c, ch = w1.shape
    if tuple(w2.shape) != (ch, c) or ch % MLP_CHUNK or c % 8:
        raise ValueError(f"pack_mlp_weights: {tuple(w1.shape)}, {tuple(w2.shape)}")
    n = ch // MLP_CHUNK
    half = c * MLP_CHUNK
    # two copies (each casts and permutes in one pass)
    out = torch.empty(n, 2 * half, dtype=dtype, device=w1.device)
    out[:, :half].view(n, MLP_CHUNK // 8, c, 8).copy_(
        w1.detach().reshape(c, n, MLP_CHUNK // 8, 8).permute(1, 2, 0, 3))
    out[:, half:].view(n, c // 8, MLP_CHUNK, 8).copy_(
        w2.detach().reshape(n, MLP_CHUNK, c // 8, 8).permute(0, 2, 1, 3))
    return out


def pack_mlp_slabs(w1: torch.Tensor, w2: torch.Tensor, slab: int, chunk: int,
                   dtype: torch.dtype = torch.bfloat16):
    """Both weight matrices in the slab body's layout
    (``csrc/ln_mlp_slab.cu``): ``(w1p, w2p)``, w1p ``(hidden / chunk, C *
    chunk)`` with row j = ``w1[:, chunk j ..]`` and w2p ``(slabs, hidden /
    chunk, chunk * slab)`` with row (s, j) = ``w2[chunk j .., slab s ..]``
    (the columns past C zero), each as a (k, n) matrix in the N-major layout
    of ``pack_mlp_weights``, ``[n // 8][k][n % 8]``.  Each is one contiguous
    copy into the kernel's ring."""
    c, ch = w1.shape
    if tuple(w2.shape) != (ch, c) or ch % chunk or c % 8 or slab % 8:
        raise ValueError(f"pack_mlp_slabs: {tuple(w1.shape)}, {tuple(w2.shape)}")
    n, slabs = ch // chunk, -(-c // slab)
    w1p = torch.empty(n, chunk // 8, c, 8, dtype=dtype, device=w1.device)
    w1p.copy_(w1.detach().reshape(c, n, chunk // 8, 8).permute(1, 2, 0, 3))
    w2pad = torch.zeros(ch, slabs * slab, dtype=dtype, device=w2.device)
    w2pad[:, :c] = w2.detach()
    w2p = w2pad.reshape(n, chunk, slabs, slab // 8, 8).permute(2, 0, 3, 1, 4).contiguous()
    return w1p.reshape(n, chunk * c), w2p.reshape(slabs, n, chunk * slab)


def unpack_mlp_weights(packed: torch.Tensor, c: int):
    """``(w1, w2)`` in the packed dtype: the inverse of ``pack_mlp_weights``."""
    n = packed.shape[0]
    half = c * MLP_CHUNK
    a = packed[:, :half].reshape(n, MLP_CHUNK // 8, c, 8).permute(2, 0, 1, 3)
    b = packed[:, half:].reshape(n, c // 8, MLP_CHUNK, 8).permute(0, 2, 1, 3)
    return a.reshape(c, n * MLP_CHUNK), b.reshape(n * MLP_CHUNK, c)


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


def dgelu_exact_f32(h32: torch.Tensor) -> torch.Tensor:
    """d/dh of the exact-erf GELU in fp32: Phi(h) + h * phi(h)."""
    cdf = 0.5 * (1.0 + torch.erf(h32 * 0.7071067811865476))
    pdf = torch.exp(-0.5 * h32 * h32) * 0.3989422804014327
    return cdf + h32 * pdf


def ln_mlp_bwd_plain(x, dy, ln_scale, ln_bias, w1, b1, w2):
    """Plain PyTorch version of kernel 5 with ``_bwd_kernel``'s numerics:
    the recompute rounds z to the compute dtype for fc1 and h before GELU,
    but the backward products run in fp32 on fp32 operands (the unrounded z
    and g, dy and the weights upcast from the compute dtype).  Returns (dx,
    dls, dlb, dw1, db1, dw2, db2); dx in the compute dtype, the rest fp32."""
    dt = x.dtype
    shape = x.shape
    c = shape[-1]
    x32 = x.reshape(-1, c).float()
    dy32 = dy.reshape(-1, c).to(dt).float()
    xhat, rstd = _ln_stats(x32)
    z = xhat * ln_scale.float() + ln_bias.float()
    w1f, w2f = w1.to(dt).float(), w2.to(dt).float()
    hb = (z.to(dt).float() @ w1f + b1.float()).to(dt).float()
    g = gelu_exact_f32(hb)
    dw2 = g.T @ dy32
    dh = (dy32 @ w2f.T) * dgelu_exact_f32(hb)
    dw1 = z.T @ dh
    dz = dh @ w1f.T
    dx = dy32 + _ln_vjp(dz, xhat, rstd, ln_scale)
    return (dx.to(dt).reshape(shape), (dz * xhat).sum(0), dz.sum(0), dw1,
            dh.sum(0), dw2, dy32.sum(0))


class _LnMlp(torch.autograd.Function):
    """Forward kernel B, backward kernel 5 (``fused_ln_mlp``'s custom VJP).
    ``body`` ("tiles" or "slab") forces the forward's body; "" is
    ``mlp_fwd_body``'s choice."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, w1, b1, w2, b2, body):
        ctx.save_for_backward(x, ln_scale, ln_bias, w1, b1, w2)
        return _library.ln_mlp(x, ln_scale, ln_bias, w1, b1, w2, b2, body)

    @staticmethod
    def backward(ctx, dy):
        x, *params = ctx.saved_tensors
        return (*ln_mlp_bwd(x, dy, *params), None)


def ln_mlp(x, ln_scale, ln_bias, w1, b1, w2, b2) -> torch.Tensor:
    """``y = x + fc2(gelu(fc1(LN(x))))`` over the last axis of x (any
    leading shape); same contract as ``fused_ln_mlp``, differentiable
    (kernel 5).  ``mlp_fwd_body`` picks the body; counts the wgmma body's
    launches (C <= 192)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ln_mlp: unsupported device {x.device}")
    return _LnMlp.apply(x, ln_scale, ln_bias, w1, b1, w2, b2, "")


ln_mlp.launches = 0


def ln_mlp_tiles(x, ln_scale, ln_bias, w1, b1, w2, b2) -> torch.Tensor:
    """``ln_mlp`` with the forward on its CUDA-core body whatever the dtype
    and width; counts that body's launches (also those the route makes
    through ``ln_mlp``: fp32, and bf16 widths the tensor-core body does not
    take)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ln_mlp_tiles: unsupported device {x.device}")
    return _LnMlp.apply(x, ln_scale, ln_bias, w1, b1, w2, b2, "tiles")


ln_mlp_tiles.launches = 0


def ln_mlp_slab(x, ln_scale, ln_bias, w1, b1, w2, b2) -> torch.Tensor:
    """``ln_mlp`` with the forward on its slab body (``csrc/ln_mlp_slab.cu``;
    bf16, C % 16 == 0, 16 <= C <= 1024, a hidden width divisible by 64, else
    it raises on the card: the route gives it 192 < C only); counts that
    body's launches (also those the route makes through ``ln_mlp``)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ln_mlp_slab: unsupported device {x.device}")
    return _LnMlp.apply(x, ln_scale, ln_bias, w1, b1, w2, b2, "slab")


ln_mlp_slab.launches = 0


def _check_mlp(what, x, w1, w2):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: dtype {x.dtype} not supported")
    c = x.shape[-1]
    ch = w1.shape[1]
    if tuple(w1.shape) != (c, ch) or tuple(w2.shape) != (ch, c):
        raise ValueError(f"{what}: weights {tuple(w1.shape)}, {tuple(w2.shape)} vs C={c}")
    return c, ch


def _mlp_vectors(ln_scale, ln_bias, b1, c, ch, dev):
    """The fp32 LN2 scale and bias and first bias that kernel B and kernel 5's
    tensor-core body both read: one entry per parameter version, so the
    backward of a step reuses its forward's (a missing one is zeros, as in
    fp32)."""
    vecs = (ln_scale, ln_bias, b1)
    return _packs.get(
        tuple(t for t in vecs if t is not None),
        ("mlp vectors", tuple(t is None for t in vecs), c, ch, str(dev)),
        lambda: (_vec(ln_scale, c, dev), _vec(ln_bias, c, dev), _vec(b1, ch, dev)))


def _ln_mlp_cuda(x, ln_scale, ln_bias, w1, b1, w2, b2, body: str = "") -> torch.Tensor:
    c, ch = _check_mlp("ln_mlp", x, w1, w2)
    chosen = mlp_fwd_body(c, ch, x.dtype)  # (raises where no body takes it)
    body = body or chosen
    if body == "slab" and not _slab_takes(c, ch, x.dtype):
        raise NotImplementedError(
            f"ln_mlp_slab: the slab body takes bf16, C % 16 == 0, {MLP_SLAB_MIN_C} <= C <= "
            f"{MLP_SLAB_MAX_C} and a hidden width divisible by {_MS_HIDDEN} (got {x.dtype}, "
            f"C={c}, hidden {ch})")
    dev, dt = x.device, x.dtype
    shape = x.shape
    x2 = cuda_lib.aligned(x.reshape(-1, c))  # (contiguous; rows are read 16 bytes at a time)
    y = torch.empty_like(x2)
    lib = cuda_lib.library()
    if body == "wgmma":
        # packed weights and fp32 vectors: made once per parameter version
        wp = _packs.get((w1, w2), ("mlp", str(dev)),
                        lambda: pack_mlp_weights(w1.to(dev), w2.to(dev), dt))
        ls, lb, b1c = _mlp_vectors(ln_scale, ln_bias, b1, c, ch, dev)
        b2c = _packs.get(() if b2 is None else (b2,), ("mlp b2", c, str(dev)),
                         lambda: _vec(b2, c, dev))
        err = lib.vadcl_ln_mlp_bf16(
            x2.data_ptr(), ls.data_ptr(), lb.data_ptr(), wp.data_ptr(), b1c.data_ptr(),
            b2c.data_ptr(), y.data_ptr(), x2.shape[0], c, ch, cuda_lib.stream_ptr(x2),
        )
    elif body == "slab":
        cs, hc, _ = mlp_slab_shape(c)
        w1p, w2p = _packs.get((w1, w2), ("mlp slab", cs, hc, str(dev)),
                              lambda: pack_mlp_slabs(w1.to(dev), w2.to(dev), cs, hc, dt))
        ls, lb, b1c = _mlp_vectors(ln_scale, ln_bias, b1, c, ch, dev)
        b2c = _packs.get(() if b2 is None else (b2,), ("mlp b2", c, str(dev)),
                         lambda: _vec(b2, c, dev))
        err = lib.vadcl_ln_mlp_slab(
            x2.data_ptr(), ls.data_ptr(), lb.data_ptr(), w1p.data_ptr(), w2p.data_ptr(),
            b1c.data_ptr(), b2c.data_ptr(), y.data_ptr(), x2.shape[0], c, ch,
            cuda_lib.stream_ptr(x2),
        )
    else:
        ls, lb = _f32(ln_scale, c, dev), _f32(ln_bias, c, dev)
        b1c, b2c = _f32(b1, ch, dev), _f32(b2, c, dev)
        w1c = w1.detach().to(device=dev, dtype=dt).contiguous()
        w2c = w2.detach().to(device=dev, dtype=dt).contiguous()
        err = lib.vadcl_ln_mlp(
            x2.data_ptr(), ls.data_ptr(), lb.data_ptr(), w1c.data_ptr(),
            b1c.data_ptr(), w2c.data_ptr(), b2c.data_ptr(), y.data_ptr(),
            x2.shape[0], c, ch, int(dt == torch.bfloat16), cuda_lib.stream_ptr(x2),
        )
    cuda_lib.check(err, f"ln_mlp ({body} body)")
    {"wgmma": ln_mlp, "slab": ln_mlp_slab, "tiles": ln_mlp_tiles}[body].launches += 1
    return y.reshape(shape)


def ln_mlp_bwd(x, dy, ln_scale, ln_bias, w1, b1, w2, body: str = ""):
    """Kernel 5: the gradients of ``ln_mlp`` as ``ln_mlp_bwd_plain`` returns
    them (the contract of ``fused_ln_mlp``'s ``_vjp_bwd``).  ``mlp_bwd_body``
    picks the body; ``body`` ("tiles" or "slab") forces one.  Counts the
    narrow tensor-core body's launches (C <= 192)."""
    if x.device.type == "cpu":
        return ln_mlp_bwd_plain(x, dy, ln_scale, ln_bias, w1, b1, w2)
    if x.device.type != "cuda":
        raise ValueError(f"ln_mlp_bwd: unsupported device {x.device}")
    c, ch = _check_mlp("ln_mlp_bwd", x, w1, w2)
    chosen = mlp_bwd_body(c, ch, x.dtype)  # (raises where no body takes it)
    body = body or chosen
    args = (x, dy, ln_scale, ln_bias, w1, b1, w2, c, ch)
    if body == "tiles":
        return _ln_mlp_bwd_tiles(*args)
    if body == "slab":
        if not _bwd_slab_takes(c, ch, x.dtype):
            raise NotImplementedError(
                f"ln_mlp_bwd_slab: the slab body takes bf16, C % 16 == 0, {MLP_BWD_SLAB_MIN_C} "
                f"<= C <= {MLP_BWD_SLAB_MAX_C} and a hidden width divisible by {_MS_HIDDEN} "
                f"(got {x.dtype}, C={c}, hidden {ch})")
        return _ln_mlp_bwd_slab(*args)
    return _ln_mlp_bwd_mma(*args)


ln_mlp_bwd.launches = 0


def ln_mlp_bwd_tiles(x, dy, ln_scale, ln_bias, w1, b1, w2):
    """Kernel 5 on its CUDA-core body (``csrc/ln_mlp_bwd.cu``) whatever the
    dtype and width; counts that body's launches (also those the route makes
    through ``ln_mlp_bwd``: fp32, and bf16 widths the tensor-core bodies do
    not take)."""
    return ln_mlp_bwd(x, dy, ln_scale, ln_bias, w1, b1, w2, body="tiles")


ln_mlp_bwd_tiles.launches = 0


def ln_mlp_bwd_slab(x, dy, ln_scale, ln_bias, w1, b1, w2):
    """Kernel 5 on its slab body (``csrc/ln_mlp_bwd_slab.cu``; bf16, C % 16 ==
    0, 16 <= C <= 592, a hidden width divisible by 64, else it raises on the
    card: the route gives it 192 < C only); counts that body's launches (also
    those the route makes through ``ln_mlp_bwd``)."""
    return ln_mlp_bwd(x, dy, ln_scale, ln_bias, w1, b1, w2, body="slab")


ln_mlp_bwd_slab.launches = 0


def _bwd_outputs(c, ch, dev):
    f32 = dict(dtype=torch.float32, device=dev)
    return (torch.empty(c, **f32), torch.empty(c, **f32), torch.empty(c, ch, **f32),
            torch.empty(ch, **f32), torch.empty(ch, c, **f32), torch.empty(c, **f32))


def _ln_mlp_bwd_mma(x, dy, ln_scale, ln_bias, w1, b1, w2, c, ch):
    dev, dt = x.device, x.dtype
    shape = x.shape
    x2 = cuda_lib.aligned(x.reshape(-1, c))
    dy2 = cuda_lib.aligned(dy.reshape(-1, c).to(dt))
    ntok = x2.shape[0]
    dx = torch.empty_like(x2)
    dls, dlb, dw1, db1, dw2, db2 = _bwd_outputs(c, ch, dev)
    lib = cuda_lib.library()
    ws = torch.empty(lib.vadcl_ln_mlp_bwd_bf16_workspace_bytes(ntok, c, ch),
                     dtype=torch.uint8, device=dev)
    # the forward's pack of this parameter version (a cache hit within a step)
    wp = _packs.get((w1, w2), ("mlp", str(dev)),
                    lambda: pack_mlp_weights(w1.to(dev), w2.to(dev), dt))
    ls, lb, b1c = _mlp_vectors(ln_scale, ln_bias, b1, c, ch, dev)
    err = lib.vadcl_ln_mlp_bwd_bf16(
        x2.data_ptr(), dy2.data_ptr(), ls.data_ptr(), lb.data_ptr(), wp.data_ptr(),
        b1c.data_ptr(), dx.data_ptr(), dls.data_ptr(), dlb.data_ptr(), dw1.data_ptr(),
        db1.data_ptr(), dw2.data_ptr(), db2.data_ptr(), ws.data_ptr(), ntok, c, ch,
        cuda_lib.stream_ptr(x2),
    )
    cuda_lib.check(err, "ln_mlp_bwd")
    ln_mlp_bwd.launches += 1
    return dx.reshape(shape), dls, dlb, dw1, db1, dw2, db2


def _ln_mlp_bwd_slab(x, dy, ln_scale, ln_bias, w1, b1, w2, c, ch):
    dev, dt = x.device, x.dtype
    shape = x.shape
    x2 = cuda_lib.aligned(x.reshape(-1, c))
    dy2 = cuda_lib.aligned(dy.reshape(-1, c).to(dt))
    ntok = x2.shape[0]
    dx = torch.empty_like(x2)
    dls, dlb, dw1, db1, dw2, db2 = _bwd_outputs(c, ch, dev)
    lib = cuda_lib.library()
    ws = torch.empty(lib.vadcl_ln_mlp_bwd_slab_workspace_bytes(ntok, c, ch),
                     dtype=torch.uint8, device=dev)
    # the forward's slab pack of this parameter version (a cache hit within a step)
    cs, hc, _ = mlp_bwd_slab_shape(c)
    w1p, w2p = _packs.get((w1, w2), ("mlp slab", cs, hc, str(dev)),
                          lambda: pack_mlp_slabs(w1.to(dev), w2.to(dev), cs, hc, dt))
    ls, lb, b1c = _mlp_vectors(ln_scale, ln_bias, b1, c, ch, dev)
    err = lib.vadcl_ln_mlp_bwd_slab(
        x2.data_ptr(), dy2.data_ptr(), ls.data_ptr(), lb.data_ptr(), w1p.data_ptr(),
        w2p.data_ptr(), b1c.data_ptr(), dx.data_ptr(), dls.data_ptr(), dlb.data_ptr(),
        dw1.data_ptr(), db1.data_ptr(), dw2.data_ptr(), db2.data_ptr(), ws.data_ptr(), ntok, c,
        ch, cuda_lib.stream_ptr(x2),
    )
    cuda_lib.check(err, "ln_mlp_bwd (slab body)")
    ln_mlp_bwd_slab.launches += 1
    return dx.reshape(shape), dls, dlb, dw1, db1, dw2, db2


def _ln_mlp_bwd_tiles(x, dy, ln_scale, ln_bias, w1, b1, w2, c, ch):
    dev, dt = x.device, x.dtype
    shape = x.shape
    x2 = x.reshape(-1, c).contiguous()
    dy2 = dy.reshape(-1, c).to(dt).contiguous()
    ntok = x2.shape[0]
    dx = torch.empty_like(x2)
    dls, dlb, dw1, db1, dw2, db2 = _bwd_outputs(c, ch, dev)
    lib = cuda_lib.library()
    ws = torch.empty(lib.vadcl_ln_mlp_bwd_workspace_bytes(ntok, c, ch),
                     dtype=torch.uint8, device=dev)
    w1c = w1.detach().to(device=dev, dtype=dt).contiguous()
    w2c = w2.detach().to(device=dev, dtype=dt).contiguous()
    ls, lb, b1c = _f32(ln_scale, c, dev), _f32(ln_bias, c, dev), _f32(b1, ch, dev)
    err = lib.vadcl_ln_mlp_bwd(
        x2.data_ptr(), dy2.data_ptr(), ls.data_ptr(), lb.data_ptr(), w1c.data_ptr(),
        b1c.data_ptr(), w2c.data_ptr(), dx.data_ptr(), dls.data_ptr(),
        dlb.data_ptr(), dw1.data_ptr(), db1.data_ptr(), dw2.data_ptr(),
        db2.data_ptr(), ws.data_ptr(), ntok, c, ch, int(dt == torch.bfloat16),
        cuda_lib.stream_ptr(x2),
    )
    cuda_lib.check(err, "ln_mlp_bwd")
    ln_mlp_bwd_tiles.launches += 1
    return dx.reshape(shape), dls, dlb, dw1, db1, dw2, db2
