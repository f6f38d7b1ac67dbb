"""The tensor-core bodies of kernels 5 and 6 on the CPU: the routes that pick
them, the arithmetic of the split bf16 products, the packs they read, and
the entry points' defaults (the card unless the caller asks for the CPU, and
the run stamp).

The CUDA bodies run only on the card (``chip_smoke.py`` phase 2b holds them
against their plain versions); what a CPU can check is everything around
them: which body every geometry of the model gets, the Python mirrors of
their shared-memory layouts, the weight addresses they read from kernel A's
and kernel B's packs, and an emulation of kernel 5's split products (the
error budget, fixed before the card sees it)."""

import dataclasses
import inspect
import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse)
from vadcl_tpu.core.config import preset as jax_preset
from vadcl_tpu.ops.pallas_mlp import fused_ln_mlp
from vadcl_tpu.utils.provenance import write_run_stamp as jax_write_run_stamp
from vadcl_tpu_torch.core.config import preset
from vadcl_tpu_torch.eval import predict as port_predict
from vadcl_tpu_torch.ops import fold_attn
from vadcl_tpu_torch.ops.fold_attn import (
    SMEM_LIMIT, fold_bwd_body, fold_bwd_mma_smem_bytes, fold_fits, fold_padded_rows,
    pack_fold_weights,
)
from vadcl_tpu_torch.ops.ln_mlp import (
    MLP_BWD_SLAB_MAX_C, MLP_BWD_SLAB_MIN_C, MLP_BWD_SLAB_SHAPES, MLP_CHUNK, _mlp_vectors,
    dgelu_exact_f32, gelu_exact_f32, ln_mlp_bwd_plain, mlp_bwd_body, mlp_bwd_mma_smem_bytes,
    mlp_bwd_slab_shape, mlp_bwd_slab_smem_bytes, mlp_slab_shape, pack_mlp_slabs,
    pack_mlp_weights,
)
from vadcl_tpu_torch.ops.packed import PackCache
from vadcl_tpu_torch.train import train

T = torch.from_numpy
BF16_BWD_TOL = 2e-2  # chip_smoke.py:BWD_TOL[bf16], per tensor, relative to max|plain|

# (n, C, heads) of every window the model sends to kernel 6: the flagship's
# four stages at 4 frames (the window-padded 63^2 input has enc stage 0's
# windows), the tiny preset's stages, and head widths 32, 48, 64.
K6_GEOMETRIES = {
    "enc_stage0": ((98, 96, 6), "mma"), "enc_stage1": ((98, 192, 12), "mma"),
    "dec_stage0": ((49, 192, 12), "mma"), "dec_stage1": ((49, 96, 6), "mma"),
    "tiny_stage0": ((98, 32, 2), "mma"), "tiny_stage1": ((98, 64, 4), "mma"),
    "tiny_decoder": ((49, 32, 2), "mma"),
    "head32_c96": ((98, 96, 3), "mma"), "head32_c64": ((98, 64, 2), "mma"),
    "head32_c192_n49": ((49, 192, 6), "mma"),
    # whole weight slices would take 276,864 B: two depth chunks, 210,304 B
    "head32_c192_n98": ((98, 192, 6), "mma"),
    # the Video Swin-B width (embed_dim 128, heads (4, 8) / (8, 4)), in
    # depth chunks
    "swin_b_enc_stage0": ((98, 128, 4), "mma"), "swin_b_enc_stage1": ((98, 256, 8), "mma"),
    "swin_b_dec_stage0": ((49, 256, 8), "mma"),
    "head48_n49": ((49, 96, 2), "tiles"), "head64_n49": ((49, 128, 2), "tiles"),
    "head48_n98": ((98, 96, 2), None),
}


@pytest.mark.parametrize("geom", sorted(K6_GEOMETRIES))
def test_kernel6_routes_every_geometry(geom):
    """Which body kernel 6 runs each geometry in, bf16 and fp32.  The
    tensor-core body takes head widths 16 and 32 up to 112 tokens where its
    block fits; wider heads keep the shared-memory body where that fits; a
    None leaves the fold route's backward to kernel 8 (``fold_fits`` false
    for the backward, as before this body existed: ``_FoldAttention``
    replays LN1 and runs kernel 8)."""
    (n, c, nh), want = K6_GEOMETRIES[geom]
    assert fold_bwd_body(n, c, nh, torch.bfloat16) == want
    assert fold_fits(n, c, nh, torch.bfloat16, backward=True) == (want is not None)
    if want == "mma":
        assert fold_bwd_mma_smem_bytes(n, c, nh) <= SMEM_LIMIT
        assert fold_padded_rows(n) in (64, 112, 208)
    if want is None:
        assert fold_bwd_mma_smem_bytes(n, c, nh) > SMEM_LIMIT or c // nh not in (16, 32)
        assert fold_attn.fold_smem_bytes(n, c, nh, True, backward=True) > SMEM_LIMIT
    assert fold_bwd_body(n, c, nh, torch.float32) in ("tiles", None)


def test_kernel6_layout_mirror():
    """The Python mirror of ``csrc/fold_attn_bwd_mma.cu:fb_layout`` at the
    flagship geometries (``chip_smoke.py`` phase 1 holds it against the
    library): ring, row tile, tiles region, with the fp32 dxa rows
    overlaying the per-head tiles."""
    assert fold_bwd_mma_smem_bytes(98, 96, 6) == 148864
    assert fold_bwd_mma_smem_bytes(98, 192, 12) == 199040
    assert fold_bwd_mma_smem_bytes(49, 192, 12) == 133248
    assert fold_bwd_mma_smem_bytes(49, 96, 6) == 85120
    # a larger window pads to 112 rows and does not grow the block
    assert fold_bwd_mma_smem_bytes(65, 96, 6) == fold_bwd_mma_smem_bytes(112, 96, 6)
    # 113-208 tokens take the long layout at head width 16 (208 rows), not at 32
    assert fold_bwd_body(113, 96, 6, torch.bfloat16) == "mma"
    assert fold_bwd_mma_smem_bytes(113, 96, 6) == fold_bwd_mma_smem_bytes(208, 96, 6) == 208768
    assert fold_bwd_body(209, 96, 6, torch.bfloat16) != "mma"
    assert fold_bwd_body(113, 96, 3, torch.bfloat16) != "mma"
    # depth chunks where whole slices do not fit: (98, 192, 6) and the Video
    # Swin-B width's geometries
    assert fold_bwd_mma_smem_bytes(98, 192, 6) == 210304
    assert fold_bwd_mma_smem_bytes(98, 128, 4) == 182656
    assert fold_bwd_mma_smem_bytes(98, 256, 8) == 224640
    assert fold_bwd_mma_smem_bytes(49, 256, 8) == 153728


# C of kernel 5: multiples of 16 up to 192 take the tensor-core body, from
# 208 up to 592 (C_max) the slab body; other multiples of 4, and C above 592,
# the CUDA-core body; fp32 always the latter.
K5_WIDTHS = {c: "mma" for c in range(16, 193, 16)}
K5_WIDTHS.update({c: "slab" for c in (208, 256, 384, 512, MLP_BWD_SLAB_MAX_C)})
K5_WIDTHS.update({c: "tiles" for c in (4, 24, 36, 100, 188, 200, 260,
                                       MLP_BWD_SLAB_MAX_C + 16, 896)})


@pytest.mark.parametrize("c", sorted(K5_WIDTHS))
def test_kernel5_routes_every_width(c):
    assert mlp_bwd_body(c, 4 * c, torch.bfloat16) == K5_WIDTHS[c]
    assert mlp_bwd_body(c, 4 * c, torch.float32) == "tiles"
    if K5_WIDTHS[c] == "mma":
        assert mlp_bwd_mma_smem_bytes(c) <= SMEM_LIMIT
    if K5_WIDTHS[c] == "slab":
        assert mlp_bwd_slab_smem_bytes(c) <= SMEM_LIMIT
        # the forward's slab pack serves: the same (slab, chunk) at every width
        assert mlp_bwd_slab_shape(c)[:2] == mlp_slab_shape(c)[:2]


def test_kernel5_refuses_what_no_body_takes():
    """The CUDA-core body takes C = 30 (scalar loads), which raised before;
    only above C = 3,500, where no two-token tile fits, does the choice
    raise."""
    assert mlp_bwd_body(96, 96 * 4 + 32, torch.bfloat16) == "tiles"  # hidden not a multiple of 64
    assert mlp_bwd_body(256, 1000, torch.bfloat16) == "tiles"  # the same above 192
    assert mlp_bwd_mma_smem_bytes(192) == 214144
    assert mlp_bwd_body(30, 120, torch.bfloat16) == "tiles"
    assert mlp_bwd_body(18, 70, torch.float32) == "tiles"
    with pytest.raises(NotImplementedError):
        mlp_bwd_body(3501, 4 * 3501, torch.bfloat16)


# --- kernel 5's split products -------------------------------------------------

def _split(x: torch.Tensor):
    """hi = round(x), lo = round(x - hi), both bf16 values held in fp32."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def ln_mlp_bwd_split_emulation(x, dy, ln_scale, ln_bias, w1, b1, w2):
    """Kernel 5's tensor-core arithmetic in plain PyTorch: the exact bf16
    products as fp32 products of bf16 values (in float64 here, so that only
    the splits differ from ``ln_mlp_bwd_plain``), every product with an fp32
    operand as the sum of its hi and lo passes: dz = dh_hi.W1^T + dh_lo.W1^T,
    dW2 = g_hi^T.dy + g_lo^T.dy, dW1 = z_hi^T.dh_hi + z_hi^T.dh_lo +
    z_lo^T.dh_hi, db1 = colsum(dh_hi + dh_lo)."""
    from vadcl_tpu_torch.ops.fold_attn import _ln_stats, _ln_vjp

    dt = x.dtype
    c = x.shape[-1]
    x32 = x.reshape(-1, c).float()
    dy32 = dy.reshape(-1, c).to(dt).float()
    xhat, rstd = _ln_stats(x32)
    z = xhat * ln_scale.float() + ln_bias.float()
    w1f, w2f = w1.to(dt).double(), w2.to(dt).double()
    hb = ((z.to(dt).double() @ w1f).float() + b1.float()).to(dt).float()
    g = gelu_exact_f32(hb)
    dh = (dy32.double() @ w2f.T).float() * dgelu_exact_f32(hb)
    (dh_hi, dh_lo), (g_hi, g_lo), (z_hi, z_lo) = _split(dh), _split(g), _split(z)
    d = lambda t: t.double()  # noqa: E731
    dz = (d(dh_hi) @ w1f.T + d(dh_lo) @ w1f.T).float()
    dw2 = (d(g_hi).T @ d(dy32) + d(g_lo).T @ d(dy32)).float()
    dw1 = (d(z_hi).T @ d(dh_hi) + d(z_hi).T @ d(dh_lo) + d(z_lo).T @ d(dh_hi)).float()
    dx = dy32 + _ln_vjp(dz, xhat, rstd, ln_scale)
    return (dx.to(dt).reshape(x.shape), (dz * xhat).sum(0), dz.sum(0), dw1,
            (dh_hi + dh_lo).sum(0), dw2, dy32.sum(0))


def _mlp_case(seed, C=96, tokens=(1, 1, 14, 14)):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    x, dy = f(*tokens, C), f(*tokens, C)
    p = [1 + 0.1 * f(C), 0.1 * f(C), f(C, 4 * C) / np.sqrt(C), 0.1 * f(4 * C),
         f(4 * C, C) / np.sqrt(4 * C), 0.1 * f(C)]
    return x, dy, p


def _ratio(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


MLP_NAMES = ("dx", "dls", "dlb", "dw1", "db1", "dw2", "db2")
# The split leaves each product within ~1e-5 relative of the fp32 product.
# Against the plain version (fp32 products) and against the Pallas backward in
# interpret mode, every fp32 gradient stays within 0.1% of BWD_TOL[bf16]
# (measured here: 4.3e-6 relative to max at worst, dW1).  dx is stored in
# bf16: a sum in another order may flip its last bit, one bf16 ulp (2^-8) of
# an element at most max|dx|, which is 20% of BWD_TOL[bf16].
SPLIT_FRACTION = 1e-3
DX_ULP = 2.0 ** -8


def _hold(name, got, want):
    bound = DX_ULP if name == "dx" else SPLIT_FRACTION * BF16_BWD_TOL
    assert _ratio(got, want) <= bound, (name, _ratio(got, want), bound)


def test_split_products_stay_inside_the_bf16_budget():
    """At a reduced flagship shape (C = 96, hidden 384, 196 tokens: not a
    multiple of the kernel's 128-token block) in bf16, the emulation of the
    split products against ``ln_mlp_bwd_plain`` and against
    ``fused_ln_mlp``'s backward (``_vjp_bwd``, its Pallas kernel in interpret
    mode on the same bf16 inputs)."""
    x, dy, p = _mlp_case(21)
    xb = T(x).to(torch.bfloat16)
    dyb = T(dy).to(torch.bfloat16)
    pt = [T(v) for v in p[:5]]
    got = ln_mlp_bwd_split_emulation(xb, dyb, *pt)
    want = ln_mlp_bwd_plain(xb, dyb, *pt)
    for name, g, w in zip(MLP_NAMES, got, want):
        _hold(name, g.float().numpy(), w.float().numpy())
    xj = jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16)
    _, vjp = jax.vjp(lambda a, *t: fused_ln_mlp(a, *t, True), xj, *map(jnp.asarray, p))
    pallas = vjp(jnp.asarray(dyb.float().numpy()).astype(jnp.bfloat16))
    for name, g, w in zip(MLP_NAMES, got, pallas):
        _hold(name, g.float().numpy(), np.asarray(w.astype(jnp.float32)))


# --- kernel 5's slab body ------------------------------------------------------

def plain_recompute(x, ln_scale, ln_bias, w1, b1):
    """(z, hb) as ``ln_mlp_bwd_plain`` recomputes them: z = LN2(x) in fp32,
    hb = round(round(z) . W1 + b1) by torch's fp32 product."""
    from vadcl_tpu_torch.ops.fold_attn import _ln_stats

    dt, c = x.dtype, x.shape[-1]
    xhat, _ = _ln_stats(x.reshape(-1, c).float())
    z = xhat * ln_scale.float() + ln_bias.float()
    return z, (z.to(dt).float() @ w1.to(dt).float() + b1.float()).to(dt).float()


def pallas_recompute(x, ln_scale, ln_bias, w1, b1):
    """(z, hb) as ``_bwd_kernel`` recomputes them in interpret mode: its
    ``_ln_f32`` and fc1 product on its 512-token tiles (jitted, the same
    operations on the same shapes)."""
    from vadcl_tpu.ops.pallas_mlp import _TILE, _ln_f32

    c = x.shape[-1]
    x2 = x.reshape(-1, c).float().numpy()
    t = x2.shape[0]

    @jax.jit
    def tile(x32, s, b, w, bias):
        z, _, _ = _ln_f32(x32, s, b)
        h = jnp.dot(z.astype(jnp.bfloat16), w.astype(jnp.bfloat16),
                    preferred_element_type=jnp.float32) + bias
        return z, h.astype(jnp.bfloat16).astype(jnp.float32)

    x32 = np.pad(x2, ((0, -t % _TILE), (0, 0)))
    vecs = [jnp.asarray(v.float().numpy()) for v in (ln_scale, ln_bias, w1, b1)]
    zs, hbs = zip(*(tile(jnp.asarray(x32[i:i + _TILE]), *vecs)
                    for i in range(0, x32.shape[0], _TILE)))
    return (T(np.concatenate([np.asarray(v) for v in zs])[:t].copy()),
            T(np.concatenate([np.asarray(v) for v in hbs])[:t].copy()))


def ln_mlp_bwd_slab_emulation(x, dy, ln_scale, ln_bias, w1, b1, w2, recompute=None,
                              drop_lo=False):
    """The slab body's walk (``csrc/ln_mlp_bwd_slab.cu``) in plain PyTorch.
    Per slab of ``MLP_BWD_SLAB_SHAPES``' width and per hidden sub-chunk (32
    columns at slab 256, 16 at 128, in the chunks' order): dg = dy.W2^T (an
    exact bf16 product, in float64 here), dh = dg * gelu'(hb), and
    dz[:, slab] += dh_hi.W1^T + dh_lo.W1^T added into an fp32 accumulator,
    as the wgmma accumulator adds them; dx from the slabs' dz by the
    LN-vjp; z, g and dh as slab 0 writes them, hi/lo pairs, for the second
    pass's 2 (dW2) and 3 (dW1) bf16 passes summed over 1024-token chunks in
    order.  ``recompute`` gives the forward's (z, hb) (the slab body forms
    them once per slab, the same values each time); by default the plain
    version's (``plain_recompute``): a comparator whose fp32 order of h or
    of LN2 differs may round some hb or round(z) to the neighbouring bf16
    value, which moves the gradients by more than the split does, so each
    comparison gives the emulation its comparator's roundings and measures
    the split arithmetic alone.  ``drop_lo`` leaves dz's lo pass out (a
    planted fault)."""
    from vadcl_tpu_torch.ops.fold_attn import _ln_stats, _ln_vjp

    dt = x.dtype
    c, ch = w1.shape
    slab, chunk, _ = mlp_bwd_slab_shape(c)
    sub = min(chunk, 32)
    x32 = x.reshape(-1, c).float()
    dy32 = dy.reshape(-1, c).to(dt).float()
    xhat, rstd = _ln_stats(x32)
    z, hb = recompute or plain_recompute(x, ln_scale, ln_bias, w1, b1)
    w1f, w2f = w1.to(dt).double(), w2.to(dt).double()
    dh = (dy32.double() @ w2f.T).float() * dgelu_exact_f32(hb)
    dh_hi, dh_lo = _split(dh)
    dz = torch.zeros_like(z)
    for s0 in range(0, c, slab):
        cols = slice(s0, min(s0 + slab, c))
        acc = torch.zeros(z.shape[0], cols.stop - s0)
        for j0 in range(0, ch, sub):
            hid = slice(j0, j0 + sub)
            dg = (dy32.double() @ w2f[hid].T).float()
            hi, lo = _split(dg * dgelu_exact_f32(hb[:, hid]))
            part = hi.double() @ w1f[cols, hid].T
            if not drop_lo:
                part = part + lo.double() @ w1f[cols, hid].T
            acc = acc + part.float()
        dz[:, cols] = acc
    (g_hi, g_lo), (z_hi, z_lo) = _split(gelu_exact_f32(hb)), _split(z)
    d = lambda t: t.double()  # noqa: E731
    dw2, dw1 = 0.0, 0.0
    for t0 in range(0, z.shape[0], 1024):  # reduce_mma.cu's chunks, summed in order
        r = slice(t0, t0 + 1024)
        dw2 = dw2 + (d(g_hi[r]).T @ d(dy32[r]) + d(g_lo[r]).T @ d(dy32[r])).float()
        dw1 = dw1 + (d(z_hi[r]).T @ d(dh_hi[r]) + d(z_hi[r]).T @ d(dh_lo[r])
                     + d(z_lo[r]).T @ d(dh_hi[r])).float()
    dx = dy32 + _ln_vjp(dz, xhat, rstd, ln_scale)
    return (dx.to(dt).reshape(x.shape), (dz * xhat).sum(0), dz.sum(0), dw1,
            (dh_hi + dh_lo).sum(0), dw2, dy32.sum(0))


def _slab_case(seed, C, tokens):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    x, dy = f(tokens, C), f(tokens, C)
    p = [1 + 0.1 * f(C), 0.1 * f(C), f(C, 4 * C) / np.sqrt(C), 0.1 * f(4 * C),
         f(4 * C, C) / np.sqrt(4 * C)]
    return T(x).to(torch.bfloat16), T(dy).to(torch.bfloat16), [T(v) for v in p]


@pytest.mark.parametrize("C, tokens", [(256, 300), (384, 200), (MLP_BWD_SLAB_MAX_C, 130)],
                         ids=["C256", "C384", "C_max"])
def test_slab_walk_stays_inside_the_bf16_budget(C, tokens):
    """The slab body's arithmetic at C = 256 (one slab of 256, hidden 1024),
    384 (three slabs of 128) and C_max = 592 (five, the last cut at 80
    columns), hidden 4C, on token counts off the body's 64-token tile, held
    against ``ln_mlp_bwd_plain`` at ``SPLIT_FRACTION x BF16_BWD_TOL`` (dx
    within one bf16 ulp of max|dx|)."""
    x, dy, p = _slab_case(31, C, tokens)
    got = ln_mlp_bwd_slab_emulation(x, dy, *p)
    want = ln_mlp_bwd_plain(x, dy, *p)
    for name, g, w in zip(MLP_NAMES, got, want):
        _hold(name, g.float().numpy(), w.float().numpy())


def test_slab_walk_matches_the_pallas_backward():
    """At C = 256 hidden 1024 (the Video Swin-B width's inner stages), the
    slab walk with the Pallas kernel's own forward roundings against
    ``fused_ln_mlp``'s backward (that kernel in interpret mode) on the same
    bf16 inputs, at the same bounds."""
    x, dy, p = _slab_case(32, 256, 300)
    got = ln_mlp_bwd_slab_emulation(x, dy, *p, recompute=pallas_recompute(x, *p[:4]))
    b2 = np.zeros(256, np.float32)
    xj = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    _, vjp = jax.vjp(lambda a, *t: fused_ln_mlp(a, *t, True), xj,
                     *map(jnp.asarray, [v.numpy() for v in p] + [b2]))
    pallas = vjp(jnp.asarray(dy.float().numpy()).astype(jnp.bfloat16))
    for name, g, w in zip(MLP_NAMES, got, pallas):
        _hold(name, g.float().numpy(), np.asarray(w.astype(jnp.float32)))


def test_slab_walk_without_the_lo_pass_leaves_the_budget():
    """The bound has teeth: dz summed from dh's hi parts alone (one rounding
    of dh, another contract) misses dx and dLN2 by more than the budget."""
    x, dy, p = _slab_case(33, 256, 300)
    got = ln_mlp_bwd_slab_emulation(x, dy, *p, drop_lo=True)
    want = ln_mlp_bwd_plain(x, dy, *p)
    assert _ratio(got[2].numpy(), want[2].numpy()) > SPLIT_FRACTION * BF16_BWD_TOL


def _bs_source():
    return (Path(__file__).resolve().parent.parent / "vadcl_tpu_torch" / "csrc"
            / "ln_mlp_bwd_slab.cu").read_text()


def test_kernel5_slab_instances_agree_with_the_source():
    """``MLP_BWD_SLAB_SHAPES`` is ``kBsShapes``; each instance is kernel B's
    slab pack at its widths (one pack a step), holds its widest C with two
    ring stages within 227 KB, keeps dz at 128 registers a thread or fewer
    (slab / 2), and C_max + 16 outgrows the block: the smem mirror is the
    source's layout (barriers, stages of W1 and every slab's W2 piece, the z
    and dy tiles) at the figures its header states."""
    text = _bs_source()
    body = text[text.index("kBsShapes[] = {"):text.index("};", text.index("kBsShapes[] = {"))]
    table = tuple(tuple(int(v) for v in m)
                  for m in re.findall(r"\{(\d+), (\d+), (\d+)\}", body))
    assert table == MLP_BWD_SLAB_SHAPES
    consts = {n: int(re.search(rf"constexpr int {n} = (\d+);", text).group(1))
              for n in ("kBsRows", "kBsMaxStages", "kBsMinC", "kBsHidden")}
    assert consts == {"kBsRows": 64, "kBsMaxStages": 4, "kBsMinC": MLP_BWD_SLAB_MIN_C,
                      "kBsHidden": 64}
    prev = MLP_BWD_SLAB_MIN_C - 16
    for slab, chunk, max_c in MLP_BWD_SLAB_SHAPES:
        assert mlp_bwd_slab_shape(prev + 16) == mlp_bwd_slab_shape(max_c) == (slab, chunk, max_c)
        assert mlp_slab_shape(max_c)[:2] == (slab, chunk)
        assert mlp_bwd_slab_smem_bytes(max_c) <= SMEM_LIMIT and slab // 2 <= 128
        prev = max_c
    assert mlp_bwd_slab_shape(MLP_BWD_SLAB_MAX_C + 16) is None
    assert mlp_bwd_slab_smem_bytes(MLP_BWD_SLAB_MAX_C) == 230464 and "230,464 B" in text
    assert mlp_bwd_slab_smem_bytes(256) == 64 + 2 * 2 * 64 * (256 + 256) + 4 * 64 * 256 == 196672
    # C_max + 16 in the second instance's layout would outgrow the block
    c = MLP_BWD_SLAB_MAX_C + 16
    assert 64 + 2 * 2 * 16 * (c + 5 * 128) + 4 * 64 * c > SMEM_LIMIT


def test_kernel5_slab_reads_the_forward_pack_transposed():
    """The addresses of ``csrc/ln_mlp_bwd_slab.cu`` in kernel B's slab pack: a
    stage's W1 part read K-major at (k = hidden h, n = c) gives W1^T (dz's B),
    its W2 pieces read K-major at (k = c, n = h) give W2^T (dg's B), and
    every hidden sub-chunk's N-major W1 tile gives W1 (fc1's B)."""
    rng = np.random.RandomState(7)
    for C in (48, 208, 384):
        slab, chunk, _ = mlp_bwd_slab_shape(C)
        Ch = 4 * C
        w1 = T(rng.randn(C, Ch).astype(np.float32))
        w2 = T(rng.randn(Ch, C).astype(np.float32))
        w1p, w2p = pack_mlp_slabs(w1, w2, slab, chunk, torch.float32)
        cc, hh = np.meshgrid(np.arange(C), np.arange(Ch), indexing="ij")
        j, h = hh // chunk, hh % chunk
        # W1 part of stage j: element (c, h) at ((h / 8) C + c) 8 + h % 8
        w1_read = w1p[j, ((h // 8) * C + cc) * 8 + h % 8]
        torch.testing.assert_close(w1_read, w1, rtol=0, atol=0)
        # W2 piece p of stage j: element (h, c') at ((c' / 8) chunk + h) 8 + c' % 8
        piece, cp = cc // slab, cc % slab
        w2t_read = w2p[piece, j, ((cp // 8) * chunk + h) * 8 + cp % 8]
        torch.testing.assert_close(w2t_read, w2.T, rtol=0, atol=0)


def test_split_is_not_a_single_rounding():
    """The split carries what one rounding to bf16 loses: dW1 from z and dh
    rounded once misses by far more than the split's error."""
    x, dy, p = _mlp_case(22)
    xb, dyb = T(x).to(torch.bfloat16), T(dy).to(torch.bfloat16)
    pt = [T(v) for v in p[:5]]
    want = ln_mlp_bwd_plain(xb, dyb, *pt)
    split = ln_mlp_bwd_split_emulation(xb, dyb, *pt)
    err_split = _ratio(split[3].numpy(), want[3].numpy())
    # z and dh rounded once each (2^-9 relative): another contract
    from vadcl_tpu_torch.ops.fold_attn import _ln_stats

    c = x.shape[-1]
    x32 = xb.reshape(-1, c).float()
    xhat, _ = _ln_stats(x32)
    zf = xhat * pt[0] + pt[1]
    w1f, w2f = pt[2].to(torch.bfloat16).double(), pt[4].to(torch.bfloat16).double()
    hb = ((zf.to(torch.bfloat16).double() @ w1f).float() + pt[3]).to(torch.bfloat16).float()
    dh = (dyb.reshape(-1, c).float().double() @ w2f.T).float() * dgelu_exact_f32(hb)
    once = (zf.to(torch.bfloat16).double().T @ dh.to(torch.bfloat16).double()).float()
    err_once = _ratio(once.numpy(), want[3].numpy())
    assert err_split * 20 < err_once


# --- the packs the bodies read --------------------------------------------------

def test_kernel5_reads_the_forward_pack_transposed():
    """The addresses of ``csrc/ln_mlp_bwd_mma.cu`` in B's pack: fc1's B
    operand at element (c, n) of chunk j is ``((n / 8) C + c) 8 + n % 8``;
    the same tiles read as W1^T (k = hidden, n = c) give W1^T, and the second
    half read at ``((c / 8) 64 + n) 8 + c % 8`` gives W2^T."""
    rng = np.random.RandomState(3)
    C, Ch = 48, 192
    w1, w2 = T(rng.randn(C, Ch).astype(np.float32)), T(rng.randn(Ch, C).astype(np.float32))
    pack = pack_mlp_weights(w1, w2, torch.float32)
    half = C * MLP_CHUNK
    cc, jj = np.meshgrid(np.arange(C), np.arange(Ch), indexing="ij")
    chunk, n = jj // MLP_CHUNK, jj % MLP_CHUNK
    w1_read = pack[chunk, ((n // 8) * C + cc) * 8 + n % 8]  # [c][j] = W1
    w2t_read = pack[chunk, half + ((cc // 8) * MLP_CHUNK + n) * 8 + cc % 8]  # [c][j] = W2^T
    torch.testing.assert_close(w1_read, w1, rtol=0, atol=0)
    torch.testing.assert_close(w1_read.T, w1.T, rtol=0, atol=0)  # the dz product's B
    torch.testing.assert_close(w2t_read, w2.T, rtol=0, atol=0)


def test_kernel6_reads_kernel_a_pack():
    """The addresses of ``csrc/fold_attn_bwd_mma.cu`` in kernel A's pack:
    head h's W_proj rows (``W_proj[h hd + d, c]`` in slice ``nH + c // 3hd``,
    row ``h hd + d``, column ``c % 3hd``: the doa product's B, stored
    [n][k]) and slice h read as ``W_qkv[c, 3hd-block]`` (the dxa product's
    B, k = the slice's column)."""
    rng = np.random.RandomState(4)
    for C, nh in ((96, 6), (64, 2), (64, 4)):
        hd = C // nh
        qkv_w = T(rng.randn(C, 3 * C).astype(np.float32))
        proj_w = T(rng.randn(C, C).astype(np.float32))
        pack = pack_fold_weights(qkv_w, proj_w, nh, torch.float32)
        for h in range(nh):
            dd, cc = np.meshgrid(np.arange(hd), np.arange(C), indexing="ij")
            got = pack[nh + cc // (3 * hd), h * hd + dd, cc % (3 * hd)]
            torch.testing.assert_close(got, proj_w[h * hd:(h + 1) * hd], rtol=0, atol=0)
            cols = torch.cat([torch.arange(p * C + h * hd, p * C + (h + 1) * hd)
                              for p in range(3)])
            torch.testing.assert_close(pack[h, :, :3 * hd], qkv_w[:, cols], rtol=0, atol=0)


def test_pack_is_made_again_after_an_in_place_update():
    """The version rule the backward's cache hit relies on: the forward's
    pack serves the backward of the same step, and an optimizer's in-place
    update between them makes a fresh one."""
    rng = np.random.RandomState(5)
    w1 = torch.nn.Parameter(T(rng.randn(32, 128).astype(np.float32)))
    w2 = torch.nn.Parameter(T(rng.randn(128, 32).astype(np.float32)))
    cache, made = PackCache(), []

    def make():
        made.append(1)
        return pack_mlp_weights(w1, w2)

    first = cache.get((w1, w2), ("mlp", "cpu"), make)
    assert cache.get((w1, w2), ("mlp", "cpu"), make) is first and len(made) == 1
    with torch.no_grad():
        w1.add_(1.0)
    fresh = cache.get((w1, w2), ("mlp", "cpu"), make)
    assert len(made) == 2 and fresh is not first
    torch.testing.assert_close(fresh, pack_mlp_weights(w1, w2), rtol=0, atol=0)
    assert not torch.equal(fresh, first)


@pytest.mark.parametrize("kernel", ["mlp", "fold", "fold without LN"])
def test_forward_and_backward_share_one_vector_entry(kernel):
    """Kernel 5's and 6's tensor-core bodies read the fp32 vectors of their
    forwards' cache entry (B's, A's): a second call for the same parameter
    versions returns the very same tensors, and an in-place update makes
    fresh ones."""
    rng = np.random.RandomState(6)
    C = 32
    ls, lb = (torch.nn.Parameter(T(rng.randn(C).astype(np.float32))) for _ in range(2))
    bias = torch.nn.Parameter(T(rng.randn(4 * C if kernel == "mlp" else 3 * C)
                                .astype(np.float32)))
    if kernel == "mlp":
        get = lambda: _mlp_vectors(ls, lb, bias, C, 4 * C, "cpu")
    else:
        with_ln = kernel == "fold"
        get = lambda: fold_attn._fold_vectors(ls if with_ln else None,
                                              lb if with_ln else None, bias, C, "cpu")
    first = get()
    assert all(a is b for a, b in zip(get(), first))
    want = (ls, lb) if kernel != "fold without LN" else (None, None)
    for got, w in zip(first, (*want, bias)):
        if w is None:
            assert got is None
        else:
            torch.testing.assert_close(got, w.detach(), rtol=0, atol=0)
    with torch.no_grad():
        bias.add_(1.0)
    fresh = get()
    assert fresh[2] is not first[2]
    torch.testing.assert_close(fresh[2], bias.detach(), rtol=0, atol=0)


# --- entry points -------------------------------------------------------------

def _tiny_cfg(out):
    base = preset("tiny")
    return base.replace(
        model=dataclasses.replace(base.model, predict=True, fused_attention=True,
                                  fused_cluster=True, attn_kernel="fold"),
        optim=dataclasses.replace(base.optim, epochs=1), output_dir=str(out))


class _OneStep:
    batch_size = 2

    def steps_per_epoch(self):
        return 1

    def epoch(self, e, start_iter=0):
        rng = np.random.RandomState(e)
        for _ in range(start_iter, 1):
            yield rng.randint(0, 256, (2, 4, 56, 56, 3)).astype(np.uint8)


def test_train_defaults_to_the_card_and_refuses_without_one(tmp_path):
    assert inspect.signature(train).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default trains on it")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        train(_tiny_cfg(tmp_path / "run"), _OneStep(), max_steps=1)
    assert not (tmp_path / "run" / "ckpt").exists()


def test_train_on_the_cpu_writes_the_run_stamp(tmp_path):
    state = train(_tiny_cfg(tmp_path / "run"), _OneStep(), max_steps=1, device="cpu")
    assert state.step == 1
    meta = json.loads((tmp_path / "run" / "run_meta.json").read_text())
    jax_path = jax_write_run_stamp(str(tmp_path / "jax"), jax_preset("tiny"))
    jax_meta = json.loads(open(jax_path).read())
    assert set(meta) == set(jax_meta)
    assert meta["topology"]["device"] == "cpu" and meta["topology"]["device_count"] == 0
    assert meta["versions"]["torch"] == torch.__version__
    assert meta["config"]["model"]["attn_kernel"] == "fold"
    assert len(meta["git"]["sha"]) == 40


def test_video_scorer_defaults_to_the_card():
    params = inspect.signature(port_predict.make_video_scorer).parameters
    assert params["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default scores on it")
    with pytest.raises((RuntimeError, AssertionError)):
        port_predict.make_video_scorer(lambda c: c, 4, True, batch_windows=2)
    port_predict.make_video_scorer(lambda c: c, 4, True, batch_windows=2, device="cpu")


def test_both_bodies_count_their_launches():
    """The tensor-core bodies count on ``ln_mlp_bwd`` and
    ``fold_attention_bwd``, the bodies they leave some geometries to on
    counters of their own; CPU calls (the plain versions) count on neither."""
    from vadcl_tpu_torch.ops import KERNELS
    from vadcl_tpu_torch.ops.ln_mlp import ln_mlp_bwd, ln_mlp_bwd_slab, ln_mlp_bwd_tiles

    names = {k.__name__ for k in KERNELS}
    assert {"ln_mlp_bwd", "ln_mlp_bwd_tiles", "ln_mlp_bwd_slab", "fold_attention_bwd",
            "fold_attention_bwd_tiles"} <= names
    before = [k.launches for k in KERNELS]
    x, dy, p = _mlp_case(23, C=32, tokens=(1, 1, 7, 7))
    for fn in (ln_mlp_bwd_tiles, ln_mlp_bwd_slab, ln_mlp_bwd):
        got = fn(T(x), T(dy), *map(T, p[:5]))
        assert len(got) == 7
    assert [k.launches for k in KERNELS] == before
