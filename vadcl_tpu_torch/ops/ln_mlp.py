"""Kernel B: the fused LN2 -> MLP -> residual tail of a Swin block, and
kernel 5, its backward.

Kernel B replaces ``vadcl_tpu/ops/pallas_mlp.py:_fwd_kernel`` (entry
``fused_ln_mlp``).  Its CUDA kernels are in ``csrc/ln_mlp.cu``; both walk
the 4C hidden width in chunks so the hidden activation never reaches device
memory.  bf16 is a persistent grid of warpgroups that each own 64 tokens,
run fc1 and fc2 as warpgroup matrix multiplies (wgmma), keep the hidden
activation in registers between the two, and read the weights from a
shared-memory ring that a producer warp fills with bulk copies; it needs
C % 16 == 0, C <= 192 and a hidden width divisible by 128, and takes both
weight matrices packed by hidden chunk (``pack_mlp_weights``, cached per
parameter version in ``_packs``).  Every other width, and fp32, runs the
CUDA-core body (32 tokens a block, fp32 arithmetic, the same cast
boundaries), which ``mlp_fwd_body`` picks by width and ``ln_mlp_tiles``
counts.

Kernel 5 replaces ``_bwd_kernel`` (entry ``_vjp_bwd``).  Like the Pallas
backward, every product is fp32 on fp32 operands; per token tile the kernel
recomputes the forward and emits dx, and the weight and bias sums over tokens
go through a deterministic second pass.  It has two bodies, picked by
``mlp_bwd_body``: in bf16 at C % 16 == 0, C <= 192 and a hidden width
divisible by 64 (the model's widths) ``csrc/ln_mlp_bwd_mma.cu`` runs every
product on the tensor cores (mma.sync), an fp32 operand split into bf16 hi
and lo parts whose products are summed in fp32, reads B's cached pack and
runs its second pass on the tensor cores too (``csrc/reduce_mma.cu``); fp32
and every other width run the CUDA-core body of ``csrc/ln_mlp_bwd.cu``
(``ln_mlp_bwd_tiles`` counts its launches).

``ln_mlp`` is a ``torch.autograd.Function``: forward kernel B, backward
kernel 5.  On a CPU tensor both run their plain versions (``ln_mlp_plain``,
``ln_mlp_bwd_plain``); on a CUDA tensor they launch the kernels or raise.
Bounds on the card and what the simple designs leave are in the headers of
the two ``.cu`` files.
"""

from __future__ import annotations

import torch

from vadcl_tpu_torch.ops import cuda_lib
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


# Kernel B's CUDA-core body (csrc/ln_mlp.cu:ln_mlp_kernel): 32 tokens a block,
# the hidden width walked 128 columns at a time (csrc/mlp_tail.cuh).
_MLP_TILE_TOKENS, _MLP_TILE_CHUNK = 32, 128
MLP_FWD_MMA_MAX_C = 192


def mlp_fwd_smem_bytes(c: int) -> int:
    """Shared memory of one block of kernel B's CUDA-core body
    (``csrc/ln_mlp.cu:mlp_smem_bytes``): the LN output and the fc2 sums of 32
    tokens and one GELU chunk, fp32: 81,920 B at C = 256."""
    return 4 * (2 * _MLP_TILE_TOKENS * c + _MLP_TILE_TOKENS * _MLP_TILE_CHUNK)


def mlp_fwd_body(c: int, ch: int, dtype: torch.dtype) -> str:
    """The body kernel B runs at width ``c`` and hidden width ``ch``:
    ``"wgmma"`` (the tensor-core body: bf16, C % 16 == 0, 16 <= C <= 192, a
    hidden width divisible by 128) or ``"tiles"`` (the CUDA-core body: fp32,
    and bf16 at every other width).  Raises only where the CUDA-core body's
    block exceeds ``SMEM_LIMIT`` (C above 844), which no width of the JAX
    package's presets reaches."""
    if (dtype == torch.bfloat16 and c % 16 == 0 and 16 <= c <= MLP_FWD_MMA_MAX_C
            and ch % 128 == 0):
        return "wgmma"
    if mlp_fwd_smem_bytes(c) <= SMEM_LIMIT:
        return "tiles"
    raise NotImplementedError(
        f"ln_mlp: a block of 32 tokens at C={c} needs {mlp_fwd_smem_bytes(c)} B of shared "
        f"memory, above the card's {SMEM_LIMIT}"
    )


def mlp_bwd_body(c: int, ch: int, dtype: torch.dtype) -> str:
    """The body kernel 5 runs at width ``c`` and hidden width ``ch``:
    ``"mma"`` (the tensor-core body: bf16, C % 16 == 0, 16 <= C <= 192, a
    hidden width divisible by 64, its block within ``SMEM_LIMIT``) or
    ``"tiles"`` (the CUDA-core body: fp32, and bf16 at the widths the
    tensor-core body does not take).  Raises where neither takes it."""
    if (dtype == torch.bfloat16 and c % 16 == 0 and 16 <= c <= MLP_BWD_MMA_MAX_C
            and ch % MLP_CHUNK == 0 and mlp_bwd_mma_smem_bytes(c) <= SMEM_LIMIT):
        return "mma"
    if c % 4 == 0 and ch % 4 == 0:
        return "tiles"
    raise NotImplementedError(
        f"ln_mlp_bwd: the kernel's vector loads need C and the hidden width to be "
        f"multiples of 4 (got C={c}, hidden {ch})"
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
    ``tiles`` forces the forward's CUDA-core body."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, w1, b1, w2, b2, tiles):
        ctx.save_for_backward(x, ln_scale, ln_bias, w1, b1, w2)
        if x.device.type == "cpu":
            return ln_mlp_plain(x, ln_scale, ln_bias, w1, b1, w2, b2)
        return _ln_mlp_cuda(x, ln_scale, ln_bias, w1, b1, w2, b2, tiles)

    @staticmethod
    def backward(ctx, dy):
        x, *params = ctx.saved_tensors
        return (*ln_mlp_bwd(x, dy, *params), None)


def ln_mlp(x, ln_scale, ln_bias, w1, b1, w2, b2) -> torch.Tensor:
    """``y = x + fc2(gelu(fc1(LN(x))))`` over the last axis of x (any
    leading shape); same contract as ``fused_ln_mlp``, differentiable
    (kernel 5).  ``mlp_fwd_body`` picks the body; counts the tensor-core
    body's launches."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ln_mlp: unsupported device {x.device}")
    return _LnMlp.apply(x, ln_scale, ln_bias, w1, b1, w2, b2, False)


ln_mlp.launches = 0


def ln_mlp_tiles(x, ln_scale, ln_bias, w1, b1, w2, b2) -> torch.Tensor:
    """``ln_mlp`` with the forward on its CUDA-core body whatever the dtype
    and width; counts that body's launches (also those the route makes
    through ``ln_mlp``: fp32, and bf16 widths the tensor-core body does not
    take)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ln_mlp_tiles: unsupported device {x.device}")
    return _LnMlp.apply(x, ln_scale, ln_bias, w1, b1, w2, b2, True)


ln_mlp_tiles.launches = 0


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


def _ln_mlp_cuda(x, ln_scale, ln_bias, w1, b1, w2, b2, tiles=False) -> torch.Tensor:
    c, ch = _check_mlp("ln_mlp", x, w1, w2)
    body = mlp_fwd_body(c, ch, x.dtype)  # (raises where neither body takes it)
    if tiles:
        body = "tiles"
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
    (ln_mlp if body == "wgmma" else ln_mlp_tiles).launches += 1
    return y.reshape(shape)


def ln_mlp_bwd(x, dy, ln_scale, ln_bias, w1, b1, w2, tiles: bool = False):
    """Kernel 5: the gradients of ``ln_mlp`` as ``ln_mlp_bwd_plain`` returns
    them (the contract of ``fused_ln_mlp``'s ``_vjp_bwd``).  ``mlp_bwd_body``
    picks the body; ``tiles`` forces the CUDA-core body.  Counts the
    tensor-core body's launches."""
    if x.device.type == "cpu":
        return ln_mlp_bwd_plain(x, dy, ln_scale, ln_bias, w1, b1, w2)
    if x.device.type != "cuda":
        raise ValueError(f"ln_mlp_bwd: unsupported device {x.device}")
    c, ch = _check_mlp("ln_mlp_bwd", x, w1, w2)
    if tiles or mlp_bwd_body(c, ch, x.dtype) == "tiles":  # (raises where neither body takes it)
        return _ln_mlp_bwd_tiles(x, dy, ln_scale, ln_bias, w1, b1, w2, c, ch)
    return _ln_mlp_bwd_mma(x, dy, ln_scale, ln_bias, w1, b1, w2, c, ch)


ln_mlp_bwd.launches = 0


def ln_mlp_bwd_tiles(x, dy, ln_scale, ln_bias, w1, b1, w2):
    """Kernel 5 on its CUDA-core body (``csrc/ln_mlp_bwd.cu``) whatever the
    dtype and width; counts that body's launches (also those the route makes
    through ``ln_mlp_bwd``: fp32, and bf16 widths the tensor-core body does
    not take)."""
    return ln_mlp_bwd(x, dy, ln_scale, ln_bias, w1, b1, w2, tiles=True)


ln_mlp_bwd_tiles.launches = 0


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
