"""Swin blocks with 196-token windows in bf16 take kernels A and 6 (their long
layouts), against the JAX block on the CPU.

8-frame reconstruction clips give the flagship's encoder windows of (4, 7, 7)
= 196 tokens: C = 96 with 6 heads (stage 0) and C = 192 with 12 (stage 1),
head width 16.  The port's bf16 tensor-core bodies of A and 6 take them since
their long layouts (``csrc/fold_attn_mma.cuh:fold_attn_mma_long_kernel``,
``csrc/fold_attn_bwd_mma.cu:fold_attn_bwd_long_kernel``: 208 rows, 13 strips
of 16 on seven warps, two strips a warp): a ``fold`` block runs
``fold_attention`` and its backward ``fold_attention_bwd``, a ``fold_packed``
block ``fold_attention_packed``, and a ``base`` block runs kernels 7 and 8 on
those bodies through the unpartitioned route (``window_grid_route``), counted
on 7's and 8's counters.  The JAX package's gates decide its own kernels: at
(196, 96, 6) its ``fold`` block runs ``_fold_kernel`` and
``_fold_bwd_kernel``, at (196, 192, 12) it partitions (its VMEM gate) and
runs ``_attn_kernel`` / ``_bwd_kernel``; both compute the same function.

On the CPU every wrapper runs its plain version (the CUDA bodies run on the
card, where ``chip_smoke.py:long_window_fold_kernels`` holds them against
these plain versions at the 8-frame path's shapes).  The JAX block runs its
Pallas kernels in interpret mode: the fold kernels and the MLP kernels by
its own ``pallas_interpret``, and ``_attn_kernel`` / ``_bwd_kernel`` (its
call site passes no ``interpret``) through a copy of
``fused_window_attention_trainable`` that the test hands the block's module.
One clip, a (4, 14, 14) token grid: four windows.

Bounds (``tests/test_torch_port_bf16_widths.py``'s): the forward within
2e-2 of max|jax| (both round at the same casts; another fp32 summation order
can flip one bf16 rounding), every gradient within 2e-2 of the JAX
gradient's largest entry (``chip_smoke.py:BWD_TOL``).

The long layouts' arithmetic is emulated below.  Kernel 6 sums dv and dk of
a key strip over the query strips phase by phase (G strips a phase, the sums
held across phases): ``test_phased_column_sums_keep_the_whole_tile_bits``
walks those 16-deep mma.sync steps (each step's exact products summed, then
added to one fp32 accumulator) phase by phase and in one walk, and requires
the same bits, both within 1e-6 of the float64 sums (about 2^-20: 13 fp32
additions of 16-term partial sums).  Kernel A and kernel 6's row phase keep a
strip's whole 16 x 208 score row: ``test_padded_score_row_softmax`` holds the
row's arithmetic (bias and mask in accumulator order with -inf in padded key
columns, ex2 with log2 e folded into the scale, the quotient by ``fa_div``)
against float64 softmax within 4e-7 of the row's largest probability (a few
fp32 roundings), with exact zeros in the padded columns.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vadcl_tpu.models.swin as jax_swin
from test_torch_port_fold_models import ROUTE_FNS, _spy
from test_torch_port_swin_b_fold import _jax_run, _mma, _random_leaf, _spy_backward
from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_port_window_attn import assert_rel
from vadcl_tpu.models.swin import SwinBlock3D as JaxSwinBlock3D
from vadcl_tpu.train.checkpoint import flatten_state
from vadcl_tpu_torch.convert import state_dict_from_jax
from vadcl_tpu_torch.models import swin
from vadcl_tpu_torch.ops import fold_attn
from vadcl_tpu_torch.ops.fold_attn import (
    FOLD_LONG_MAX_TOKENS,
    SMEM_LIMIT,
    fold_bwd_body,
    fold_bwd_long_group,
    fold_bwd_mma_smem_bytes,
    fold_depth_chunks,
    fold_fits,
    fold_padded_rows,
    fold_smem_bytes,
    pack_fold_scores,
    unpack_fold_scores,
)
from vadcl_tpu_torch.ops.window_attn import window_grid_route, window_tile_core

BF16 = torch.bfloat16
TOL = 2e-2  # forward: of max|jax|; each gradient: of its largest JAX entry
WINDOW, DHW = (4, 7, 7), (4, 14, 14)  # one clip's 8-frame encoder grid, cut to 4 windows
GEOMS = {"C96_6heads": (96, 6), "C192_12heads": (192, 12)}  # the encoder's two stages
SHIFT = (0, 3, 3)  # D = 4 fits the window: no shift along it


def _blocks(geom, shifted, attn_kernel, seed=7):
    """The JAX block, its variables (random bias table and biases, so that a
    dropped term shows) and the port block carrying the same weights."""
    C, nh = GEOMS[geom]
    shift = SHIFT if shifted else (0, 0, 0)
    jblk = JaxSwinBlock3D(C, nh, WINDOW, shift, fused=True, attn_kernel=attn_kernel,
                          dtype=jnp.bfloat16)
    x = jnp.zeros((1, *DHW, C), jnp.bfloat16)
    params = jax.jit(jblk.init)(jax.random.key(seed), x)["params"]
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map_with_path(  # biases and the rel-pos table at unit scale
        lambda path, p: (jnp.asarray(rng.randn(*p.shape), p.dtype)
                         if _random_leaf(jax.tree_util.keystr(path)) else p), params)
    block = swin.SwinBlock3D(C, nh, WINDOW, shift, fused=True, attn_kernel=attn_kernel)
    block.load_state_dict(state_dict_from_jax(flatten_state({"params": params}), predict=True),
                          strict=True)
    return jblk, params, block


def _inputs(geom, seed=8):
    C, _ = GEOMS[geom]
    rng = np.random.RandomState(seed)
    return rng.randn(1, *DHW, C).astype(np.float32), rng.randn(1, *DHW, C).astype(np.float32)


def _interpret_partitioned(monkeypatch):
    """The JAX block's partitioned call site (``_attn_kernel`` /
    ``_bwd_kernel``) in interpret mode."""
    trainable = jax_swin.fused_window_attention_trainable
    monkeypatch.setattr(jax_swin, "fused_window_attention_trainable",
                        lambda *a: trainable(*a, True))


@pytest.mark.parametrize("attn_kernel", ["fold", "base"])
@pytest.mark.parametrize("shifted", [False, True], ids=["unshifted", "shifted"])
@pytest.mark.parametrize("geom", GEOMS)
def test_long_window_block_takes_a_and_6_and_matches_jax(monkeypatch, geom, shifted,
                                                          attn_kernel):
    """The block's route (A's and 6's long layouts, under ``base`` counted on
    7's and 8's counters, no partition) and its forward and every gradient
    against the JAX block in bf16."""
    C, nh = GEOMS[geom]
    n = WINDOW[0] * WINDOW[1] * WINDOW[2]
    assert fold_fits(n, C, nh, BF16) and fold_bwd_body(n, C, nh, BF16) == "mma"
    assert window_grid_route(n, C, nh, BF16) and window_grid_route(n, C, nh, BF16, True)
    jblk, params, block = _blocks(geom, shifted, attn_kernel)
    x, dout = _inputs(geom)
    _interpret_partitioned(monkeypatch)
    seen = _spy(monkeypatch, *ROUTE_FNS)
    seen_bwd = _spy_backward(monkeypatch)
    partitions = []
    real_partition = swin.window_partition
    monkeypatch.setattr(swin, "window_partition",
                        lambda *a, **k: (partitions.append(1), real_partition(*a, **k))[1])
    xt = torch.from_numpy(x).to(BF16).requires_grad_()
    out = block(xt)
    assert seen == ["fold_attention", "ln_mlp"] and not partitions
    (out.float() * torch.from_numpy(dout).to(BF16).float()).sum().backward()
    counter = "window_attention_fused_bwd" if attn_kernel == "base" else None
    assert seen_bwd == [("fold_attention_bwd", counter)]

    want, gp, gx = _jax_run(jblk, params, x, dout)
    assert out.dtype == BF16
    assert_rel("forward", out.detach().float().numpy(), np.asarray(want.astype(jnp.float32)),
               TOL)
    assert_rel("dx", xt.grad.float().numpy(), np.asarray(gx.astype(jnp.float32)), TOL)
    grads = state_dict_from_jax(flatten_state({"params": gp}), predict=True)
    named = dict(block.named_parameters())
    assert set(grads) == set(named)
    for name, g in grads.items():
        assert named[name].grad is not None, name
        assert_rel(name, named[name].grad.float().numpy(), g.float().numpy(), TOL)


@pytest.mark.parametrize("shifted", [False, True], ids=["unshifted", "shifted"])
@pytest.mark.parametrize("geom", GEOMS)
def test_long_window_block_fold_packed_matches_jax(monkeypatch, geom, shifted):
    """Under ``fold_packed`` (inference) the block runs kernel 10 on A's long
    layout, as the JAX block runs ``_fold_packed_kernel``; forward against
    the JAX block in bf16."""
    jblk, params, block = _blocks(geom, shifted, "fold_packed")
    x, _ = _inputs(geom)
    _interpret_partitioned(monkeypatch)
    seen = _spy(monkeypatch, *ROUTE_FNS)
    with torch.no_grad():
        out = block(torch.from_numpy(x).to(BF16))
    assert seen == ["fold_attention_packed", "ln_mlp"]
    want = jblk.apply({"params": params}, jnp.asarray(x, jnp.bfloat16))
    assert_rel("forward", out.float().numpy(), np.asarray(want.astype(jnp.float32)), TOL)


# --- the layouts and the routes ---------------------------------------------------

# (n, C, heads): (A's block, A's chunks, 6's block, 6's chunks, 6's strips a phase)
LAYOUTS = {
    (196, 96, 6): (148096, 1, 208768, 1, 7),
    (196, 192, 12): (227968, 2, 230784, 4, 7),
}


@pytest.mark.parametrize("geom", LAYOUTS, ids=[f"N{n}_C{c}_{h}heads" for n, c, h in LAYOUTS])
def test_long_layouts_and_routes(geom):
    """The exact bytes of A's and 6's long blocks (``chip_smoke.py`` phase 1
    holds them against the library): A 148,096 B at (196, 96, 6) and, in two
    depth chunks, 227,968 B at (196, 192, 12) (whole slices 249,472 B); 6 with
    7 query strips a phase (two phases), one chunk, 208,768 B, and at (196,
    192, 12) 4 chunks with head h's W_proj rows in two ring items, 230,784 B
    (in one item they would size the stage: 234,368 B; 6 strips a phase at 2
    chunks would fit, 227,712 B, in three phases).  In bf16 the fold route
    and the unpartitioned ``base`` / ``packed`` route; in fp32 every answer as
    before the long layouts."""
    n, c, nh = geom
    fa, fa_k, fb, fb_k, group = LAYOUTS[geom]
    assert fold_padded_rows(n) == FOLD_LONG_MAX_TOKENS == 208
    assert fold_smem_bytes(n, c, nh, True) == fa and fold_depth_chunks(n, c, nh) == fa_k
    assert fold_bwd_mma_smem_bytes(n, c, nh) == fb
    assert fold_depth_chunks(n, c, nh, backward=True) == fb_k
    assert fold_bwd_long_group(c, c // nh, fb_k) == group
    assert max(fa, fb) <= SMEM_LIMIT
    assert fold_attn._fold_fwd_mma_bytes(n, c, c // nh, 1) == {96: 148096, 192: 249472}[c]
    assert fold_attn._fold_bwd_long_proj_items(192, 16, 4) == 2
    assert fold_attn._fold_bwd_long_proj_items(192, 16, 2) == 1
    assert fold_attn._fold_bwd_long_bytes(192, 16, 2, 6) == 227712
    assert fold_attn._fold_bwd_long_bytes(192, 16, 2, 7) > SMEM_LIMIT
    assert fold_fits(n, c, nh, BF16) and fold_bwd_body(n, c, nh, BF16) == "mma"
    for backward in (False, True):
        assert window_tile_core(n, c, nh, BF16, backward) == "fold_mma"
        assert window_tile_core(n, c, nh, torch.float32, backward) == "tile"
    assert window_grid_route(n, c, nh, BF16) and window_grid_route(n, c, nh, BF16, True)
    assert not window_grid_route(n, c, nh, torch.float32)
    assert not fold_fits(n, c, nh, torch.float32)
    assert fold_bwd_body(n, c, nh, torch.float32) is None


def test_flagship_and_swin_b_layouts_are_unchanged():
    """The one-strip-a-warp layouts keep their bytes: the flagship's
    (``tests/test_torch_port_redesign.py``, ``test_torch_port_bwd_mma.py``) and
    the Video Swin-B width's (``tests/test_torch_port_swin_b_fold.py``)."""
    for (n, c, nh), (fa, fb) in {(98, 96, 6): (89728, 148864), (98, 192, 12): (154240, 199040),
                                 (49, 96, 6): (99456, 85120), (49, 192, 12): (170112, 133248),
                                 (98, 256, 8): (207488, 224640), (49, 256, 8): (229504, 153728),
                                 (98, 128, 4): (150144, 182656),
                                 (98, 192, 6): (205440, 210304)}.items():
        assert fold_smem_bytes(n, c, nh, True) == fa, (n, c, nh)
        assert fold_bwd_mma_smem_bytes(n, c, nh) == fb, (n, c, nh)
        assert fold_padded_rows(n) in (64, 112)


# --- the long layouts' arithmetic, emulated ----------------------------------------

STRIPS, WARPS = 13, 7  # 208 rows; consumer warps of both long kernels


def test_two_strips_a_warp_cover_every_strip_once():
    """Warp w owns strips w and w + 7 (warp 6 only strip 6): every strip
    once, and a phase of at most 7 query strips holds at most one strip of a
    warp, for every phase width kernel 6 may take."""
    owned = sorted(s for w in range(WARPS) for s in (w, w + WARPS) if s < STRIPS)
    assert owned == list(range(STRIPS))
    for group in range(1, WARPS + 1):
        phases = [range(q0, min(q0 + group, STRIPS)) for q0 in range(0, STRIPS, group)]
        for w in range(WARPS):
            mine = [s for s in (w, w + WARPS) if s < STRIPS]
            assert all(sum(s in p for s in mine) <= 1 for p in phases), (group, w)


@pytest.mark.parametrize("group", [7, 6, 5, 3, 1])
def test_phased_column_sums_keep_the_whole_tile_bits(group):
    """dv = round(P)^T . doa and dk = round(ds scale)^T . q of every key strip,
    walked over the query strips phase by phase (the P and ds tiles of G
    query strips, the accumulator kept between phases) and in one walk over
    the whole 208-row tiles: the same bits, and within 1e-6 of float64."""
    gen = torch.Generator().manual_seed(24)
    bf = lambda *s: torch.randn(*s, generator=gen).to(BF16).float()  # noqa: E731
    n, hd = 16 * STRIPS, 16
    p, ds, doa, q = bf(n, n).abs() / 20, bf(n, n) / 20, bf(n, hd), bf(n, hd)
    p[:, 196:] = 0  # padded key columns: probability 0, ds 0
    ds[:, 196:] = 0
    for ks in range(STRIPS):
        cols = slice(16 * ks, 16 * ks + 16)
        whole_v = _mma(torch.zeros(16, hd), p[:, cols].t(), doa)
        whole_k = _mma(torch.zeros(16, hd), ds[:, cols].t(), q)
        dv, dk = torch.zeros(16, hd), torch.zeros(16, hd)
        for q0 in range(0, STRIPS, group):
            rows = slice(16 * q0, 16 * min(q0 + group, STRIPS))
            tile_p, tile_ds = p[rows].clone(), ds[rows].clone()  # the phase's tiles
            dv = _mma(dv, tile_p[:, cols].t(), doa[rows])
            dk = _mma(dk, tile_ds[:, cols].t(), q[rows])
        assert torch.equal(dv, whole_v) and torch.equal(dk, whole_k), (group, ks)
        for got, want in ((dv, p[:, cols].double().t() @ doa.double()),
                          (dk, ds[:, cols].double().t() @ q.double())):
            scale = float(want.abs().max())
            if scale:
                assert float((got.double() - want).abs().max()) <= 1e-6 * scale


def _fa_div(e, l, r):
    """``common.cuh:fa_div``: e / l to fp32 rounding from the reciprocal r."""
    q = (e * r).float()
    t = torch.addcmul(e, -q, l)  # fma(-q, l, e): exact in float64, then rounded
    return (t.double() * r.double() + q.double()).float()


@pytest.mark.parametrize("masked", [False, True], ids=["no mask", "masked"])
def test_padded_score_row_softmax(masked):
    """One strip's score row as kernels A and 6 hold it at 208 rows: the
    packed bias (and mask) in accumulator order with -inf in the 12 padded
    key columns, scaled by log2 e, ex2 against the row max, summed, and P by
    ``fa_div``: within 4e-7 of the largest probability of float64 softmax
    over the 196 real keys, exactly 0 in the padded columns; the pack holds
    13 strips of 26 n-tiles and unpacks to the bias."""
    n, nh, scale = 196, 2, 16 ** -0.5
    gen = torch.Generator().manual_seed(5)
    bias = torch.randn(nh, n, n, generator=gen)
    mask = (torch.rand(1, n, n, generator=gen) < 0.3).float() * -100.0
    packed = pack_fold_scores(bias, float("-inf"))
    assert packed.shape == (nh, STRIPS, 2 * STRIPS, 32, 4)
    assert torch.equal(unpack_fold_scores(packed, n), bias)
    q, k = torch.randn(n, 16, generator=gen), torch.randn(n, 16, generator=gen)
    s_qk = torch.zeros(208, 208)
    s_qk[:n, :n] = (q @ k.t()).float()
    full = torch.full((208, 208), float("-inf"))
    full[:, :n] = 0.0
    full[:n, :n] = bias[0] + (mask[0] if masked else 0.0)
    # (bias + mask) / scale + q.k, then * scale * log2 e, as the accumulators run
    t = (full / scale + s_qk) * (scale * 1.4426950408889634)
    m = t.max(-1, keepdim=True).values
    e = torch.exp2(t - m)
    l_ = e.sum(-1, keepdim=True)
    p = _fa_div(e, l_, 1.0 / l_)
    assert torch.all(p[:, n:] == 0)
    ref = torch.softmax((q.double() @ k.double().t()) * scale
                        + (bias[0] + (mask[0] if masked else 0.0)).double(), -1)
    assert float((p[:n, :n].double() - ref).abs().max()) <= 4e-7 * float(ref.abs().max())
