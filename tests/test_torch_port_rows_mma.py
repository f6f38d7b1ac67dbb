"""The bf16 attention core of the row-tiled window attention forward (kernels
7 and 9, ``csrc/window_attn_rows_mma.cu``), emulated in torch on the CPU.

The core runs only on the card (``chip_smoke.py``'s ``phase_row_kernels``
holds it against the plain versions there); what the CPU can hold is its
arithmetic.  ``forward_emulation`` repeats it step by step: the strip's
(bias + mask) tile summed first and scaled by log2 e, scores
``v' = fma(s, scale * log2 e, tile)`` (kernel 9: ``fma(s, log2 e, tile)`` on
the pre-scaled q), the softmax in base 2 with 2^ flushed to zero below the
smallest normal, each warp's walk over every (W / G)-th key block (W warps
a block: 16 at head widths 16 and 32, 8 at 48 and 64) with one rescale per
pair of blocks and its sum kept per lane of a quad, the warps' (m, l)
merged in warp order, p rounded to bf16 at the contract's cast
boundary (kernel 7: e / l, kernel 9: e * (1 / l)), the warps' partial
``p . v`` strips summed in warp order, G (windows a block) from the layout
mirror ``rows_group`` (0: the direct layout, a warp a window and strip).
Sums inside one ``mma`` are taken in torch's order,
and where nvcc contracts ``a * b + c`` into one fma the emulation rounds once
in float64 first: both a fp32 rounding apart from the card.

The emulation is held against the plain version and the Pallas kernels in
interpret mode (``fused_window_attention`` / ``_packed``, as
``tests/test_torch_port_rows.py`` runs them) at N = 196 and 392, head widths
16, 32 and 48, shifted and not, on a group of windows cut short, and in
the direct layout above the largest window a staged block holds (N = 441
at head width 64, N = 833 at 16).
Bound: |emulation - reference| <= 2e-2 + 2e-2 |reference| elementwise,
``chip_smoke.py``'s ``BOUNDS[bfloat16]`` for a bf16 kernel against its plain
version (both round at the same casts; a different fp32 order can flip one
bf16 rounding of p or o).  Inputs come from a numpy RandomState; the
rel-pos bias is drawn at unit scale.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse)
from vadcl_tpu.ops.pallas_attn import fused_window_attention, fused_window_attention_packed
from vadcl_tpu.ops.window import compute_attn_mask
from vadcl_tpu_torch.ops.fold_attn import SMEM_LIMIT
from vadcl_tpu_torch.ops.window_attn import (
    rows_group,
    rows_smem_bytes,
    rows_warps,
    window_attention_fused_plain,
    window_attention_packed_plain,
    window_body,
)

T = torch.from_numpy
L2E = np.float32(1.4426950408889634)  # csrc/mma.cuh:kLog2e
TINY = 2.0 ** -126  # smallest normal fp32: ex2.approx.ftz flushes below it
ATOL = RTOL = 2e-2  # chip_smoke.py:BOUNDS[torch.bfloat16]
WIDTHS = {"hd16": (32, 2), "hd32": (64, 2), "hd48": (96, 2), "hd64": (128, 2)}
IMPLS = {"base": (False, window_attention_fused_plain, fused_window_attention),
         "packed": (True, window_attention_packed_plain, fused_window_attention_packed)}


def bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def ex2(x: torch.Tensor) -> torch.Tensor:
    y = torch.exp2(x)
    return torch.where(y < TINY, torch.zeros_like(y), y)


def fma32(a, b, c) -> torch.Tensor:
    """a * b + c with one fp32 rounding (the product of two fp32 values is
    exact in float64)."""
    return (torch.as_tensor(a).double() * torch.as_tensor(b).double()
            + torch.as_tensor(c).double()).float()


def core_emulation(q, k, v, tile, smul, packed: bool, wu: int) -> torch.Tensor:
    """o = round(p . v) of the core for (B, nH, N, hd) q, k, v (bf16 values in
    fp32) and the (B, nH, N, N) tile (bias + mask) * log2 e, with ``wu``
    warps a window."""
    B, nh, N, hd = q.shape
    npad = -(-N // 16) * 16
    nblk = npad // 16
    s = torch.zeros(B, nh, N, npad)
    s[..., :N] = q @ k.transpose(-2, -1)
    t = torch.full((B, nh, N, npad), float("-inf"))
    t[..., :N] = tile
    vv = fma32(s, smul, t)  # v' in log2 units; keys past the window -inf
    blocks = vv.view(B, nh, N, nblk, 2, 4, 2)  # [kb][n tile][lane t][2 columns]
    ms, ls = [], []
    for part in range(wu):  # walk 1 of each warp, two key blocks a step
        kbs = list(range(part, nblk, wu))
        m = torch.full((B, nh, N), float("-inf"))
        lt = torch.zeros(B, nh, N, 4)  # the running sum of each lane of the quad
        for i in range(0, len(kbs), 2):
            va = blocks[..., kbs[i], :, :, :]
            vb = (blocks[..., kbs[i + 1], :, :, :] if i + 1 < len(kbs)
                  else torch.full_like(va, float("-inf")))
            n = torch.maximum(m, torch.maximum(va.amax((-3, -2, -1)), vb.amax((-3, -2, -1))))
            nn = n[..., None, None, None]
            pa, pb = ex2(va - nn), ex2(vb - nn)
            pa, pb = pa[..., 0] + pa[..., 1], pb[..., 0] + pb[..., 1]  # (.., n tile, t)
            add = ((pa[..., 0, :] + pa[..., 1, :]) + pb[..., 0, :]) + pb[..., 1, :]
            lt = fma32(lt, ex2(m - n)[..., None], add)
            m = n
        ms.append(m)
        ls.append((lt[..., 0] + lt[..., 1]) + (lt[..., 2] + lt[..., 3]))
    m, l = ms[0], ls[0]
    if wu > 1:  # merged in warp order
        m = torch.stack(ms).amax(0)
        l = torch.zeros_like(m)
        for mq, lq in zip(ms, ls):
            l = fma32(lq, ex2(mq - m), l)
    e = ex2(vv - m[..., None])  # walk 2 recomputes the scores
    p = e * (1.0 / l)[..., None] if packed else e / l[..., None]
    p = bf16(p)
    vp = torch.zeros(B, nh, npad, hd)
    vp[..., :N, :] = v
    o = None
    for part in range(wu):  # the warps' partial strips, summed in warp order
        cols = torch.cat([torch.arange(kb * 16, kb * 16 + 16) for kb in range(part, nblk, wu)]
                         or [torch.zeros(0, dtype=torch.long)])
        op = p[..., cols] @ vp[..., cols, :]
        o = op if o is None else o + op
    return bf16(o)


def forward_emulation(x, qkv_w, qkv_b, proj_w, proj_b, bias, mask, num_heads, n_windows,
                      scale, packed: bool) -> torch.Tensor:
    """Kernel 7 (``packed``: 9) as the row-tiled body computes it in bf16:
    the qkv product and the projection rounded once from an fp32 sum
    (``rows_fwd_gemm_kernel``), the core as ``core_emulation``."""
    Bn, N, C = x.shape
    nh, hd = num_heads, C // num_heads
    qkv = x.float() @ bf16(qkv_w)
    if qkv_b is not None:
        qkv = qkv + qkv_b.float()
    if packed:
        qkv = torch.cat((qkv[..., :C] * np.float32(scale), qkv[..., C:]), -1)
    qkv = bf16(qkv).reshape(Bn, N, 3, nh, hd).permute(2, 0, 3, 1, 4)
    tile = bias.float()[None].expand(Bn, nh, N, N)
    if mask is not None:
        tile = tile + mask.float().repeat(Bn // n_windows, 1, 1)[:, None]
    tile = tile * L2E
    per_class = Bn // n_windows if mask is not None else Bn
    g = rows_group(N, C, nh, per_class)
    smul = L2E if packed else np.float32(scale) * L2E
    wu = rows_warps(hd) // g if g else 1  # the direct layout: a warp a strip
    o = core_emulation(qkv[0], qkv[1], qkv[2], tile, smul, packed, wu)
    o = o.transpose(1, 2).reshape(Bn, N, C)
    return bf16(o @ bf16(proj_w) + proj_b.float())


def _case(n, width, shifted, seed, images=1, mask=None):
    """``images`` images' four (D, 7, 7) windows of a (D, 14, 14) token grid,
    the shifted ones rolled in H and W as a model block with D <= 8 rolls."""
    (C, nh), D = WIDTHS[width], n // 49
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    if shifted and mask is None:
        mask = compute_attn_mask(D, 14, 14, (D, 7, 7), (0, 3, 3))
    return dict(
        x=f(4 * images, n, C), qkv_w=f(C, 3 * C) / np.sqrt(C), qkv_b=0.1 * f(3 * C),
        proj_w=f(C, C) / np.sqrt(C), proj_b=0.1 * f(C), bias=f(nh, n, n),
        mask=mask if shifted else None, nH=nh, nW=4, scale=(C // nh) ** -0.5,
    )


def _args(a):
    return (T(a["x"]).to(torch.bfloat16), T(a["qkv_w"]), T(a["qkv_b"]), T(a["proj_w"]),
            T(a["proj_b"]), T(a["bias"]), None if a["mask"] is None else T(a["mask"]),
            a["nH"], a["nW"], a["scale"])


def _pallas(fn, a):
    return fn(jnp.asarray(a["x"], jnp.bfloat16), jnp.asarray(a["qkv_w"]),
              jnp.asarray(a["qkv_b"]), jnp.asarray(a["proj_w"]), jnp.asarray(a["proj_b"]),
              jnp.asarray(a["bias"]), None if a["mask"] is None else jnp.asarray(a["mask"]),
              num_heads=a["nH"], n_windows=a["nW"], scale=a["scale"], interpret=True)


def worst(got, want) -> float:
    """max |got - want| / (ATOL + RTOL |want|): within the bound at <= 1."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want) / (ATOL + RTOL * np.abs(want))))


CASES = [(n, w, s) for n in (196, 392) for w in ("hd16", "hd32", "hd48") for s in (False, True)]


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("n, width, shifted", CASES,
                         ids=[f"{n}-{w}-{'shifted' if s else 'unshifted'}" for n, w, s in CASES])
def test_emulation_matches_plain_and_pallas(n, width, shifted, impl):
    packed, plain, pallas = IMPLS[impl]
    a = _case(n, width, shifted, seed=n + 3 * shifted)
    got = forward_emulation(*_args(a), packed=packed)
    assert got.shape == (4, n, WIDTHS[width][0]) and bool(torch.isfinite(got).all())
    assert worst(got, plain(*_args(a)).float()) <= 1.0
    want = np.asarray(_pallas(pallas, a).astype(jnp.float32))
    assert worst(got, want) <= 1.0


@pytest.mark.parametrize("impl", IMPLS)
def test_a_group_cut_short(impl):
    """Three images' windows: three a mask, so G = 2 and the last group of
    each mask holds one window (eight warps a window)."""
    packed, plain, pallas = IMPLS[impl]
    a = _case(196, "hd16", True, seed=11, images=3)
    assert rows_group(196, 32, 2, 3) == 2
    got = forward_emulation(*_args(a), packed=packed)
    assert worst(got, plain(*_args(a)).float()) <= 1.0
    assert worst(got, np.asarray(_pallas(pallas, a).astype(jnp.float32))) <= 1.0


@pytest.mark.parametrize("impl", IMPLS)
def test_bias_and_mask_summed_first_with_a_general_mask(impl):
    """The core adds bias and mask before the score (JAX adds the score to
    the bias first).  With a mask of arbitrary values, not only 0 / -100,
    that order stays within the bound of the plain version's."""
    packed, plain, _ = IMPLS[impl]
    rng = np.random.RandomState(5)
    a = _case(392, "hd16", True, seed=5, mask=(3 * rng.randn(4, 392, 392)).astype(np.float32))
    got = forward_emulation(*_args(a), packed=packed)
    assert worst(got, plain(*_args(a)).float()) <= 1.0


def test_the_bound_catches_a_dropped_mask():
    """The bound has teeth: the emulation handed no mask misses it on a
    shifted case."""
    a = _case(392, "hd16", True, seed=6)
    want = window_attention_fused_plain(*_args(a)).float()
    args = list(_args(a))
    args[6] = None
    assert worst(forward_emulation(*args, packed=False), want) > 1.0


def test_groups_at_the_frame8_geometries():
    """The windows a block takes at the flagship's frame-8 geometries (64
    and 16 windows share a mask at batch 16), and the layouts' sizes."""
    assert rows_group(196, 96, 6, 16) == rows_group(196, 192, 12, 16) == 8
    assert rows_group(392, 96, 6, 16) == rows_group(392, 192, 12, 16) == 4
    assert rows_group(392, 128, 2, 16) == 1  # head width 64
    assert rows_group(392, 96, 6, 3) == 2 and rows_group(392, 96, 6, 1) == 1
    assert rows_smem_bytes(392, 96, 6, True, group=1) == 129536
    assert rows_smem_bytes(392, 96, 6, True, group=4) == 206336
    assert rows_smem_bytes(392, 96, 6, True, group=8) > 232448
    assert rows_smem_bytes(392, 96, 6, True) == 38400  # the direct layout


DIRECT = [(441, "hd64"), (833, "hd16")]


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("n, width", DIRECT, ids=[f"{n}-{w}" for n, w in DIRECT])
def test_the_direct_layout_above_the_staged_limit(n, width, impl):
    """Windows no staged block holds (N above 432 at head width 64, 800 at
    16) take the direct layout: a warp a strip over every key block."""
    packed, plain, pallas = IMPLS[impl]
    C, nh = WIDTHS[width]
    assert rows_group(n, C, nh, 1) == 0 and rows_group(n - 49, C, nh, 1) >= 1
    a = _case(n, width, True, seed=n)
    got = forward_emulation(*_args(a), packed=packed)
    assert got.shape == (4, n, C) and bool(torch.isfinite(got).all())
    assert worst(got, plain(*_args(a)).float()) <= 1.0
    assert worst(got, np.asarray(_pallas(pallas, a).astype(jnp.float32))) <= 1.0


@pytest.mark.parametrize("hd, largest", [(16, 2416), (32, 1440), (48, 1024), (64, 800)])
def test_every_window_the_body_before_took_still_maps_to_rows(hd, largest):
    """The bf16 forward takes every window the row-tiled body before this
    core took (its one-head layout, K and V in rows padded to hd + 8) and
    no more: ``window_body`` routes N up to ``largest`` to it, and raises
    above."""
    C, nh = 2 * hd, 2
    assert window_body(largest, C, nh, torch.bfloat16) == "rows"
    assert rows_smem_bytes(largest, C, nh, True) <= SMEM_LIMIT
    with pytest.raises(NotImplementedError, match="neither"):
        window_body(largest + 16, C, nh, torch.bfloat16)
