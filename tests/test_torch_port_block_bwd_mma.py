"""The whole-block backward's bf16 tensor-core body
(``csrc/fold_block_bwd_mma.cu``), emulated in torch on the CPU, and the route
that picks it.

The body runs only on the card (``chip_smoke.py`` phase 2b holds it against
the plain version there); what the CPU can hold is its arithmetic.
``block_bwd_emulation`` repeats the body step by step, per window of the
strips' 16 rows: step 1, kernel A's strip body (LN1 rounded, q, k, v rounded
once from fp32 sums, the scores ``((bias + mask) / scale + q.k) * scale *
log2 e``, ``P = 2^(s - m) / l`` with e flushed below the smallest normal,
``o = round(round(P) . v)``, ``y1 = round(o . W_proj + proj_b + x)``); step 2,
kernel 5's strip body on y1 (LN2 in fp32, ``round(z) . W1`` and ``dY . W2^T``,
``hb = round(h + b1)``, ``dz`` from dh split into bf16 hi and lo,
``dy1 = round(dY + LN2-vjp(dz))``); step 3, kernel 6's strip body with dy1 as
upstream and the residual branch; the per-window sums (d(bias), and per
strip the unrounded dqkv's column sums, dLN1, dLN2) written by a chunk's first
window and added to by the others in window order, a block's strips then
summed in order and the blocks' partials in eight fixed groups; the
second pass's weight sums with their operand splits (``g`` hi + lo against
dY; ``z^T . dh`` as hi.hi + hi.lo + lo.hi).  Sums inside one product are taken
in torch's order.

It is held against ``fold_block_bwd_plain`` (bf16) and against ``jax.vjp`` of
``folded_full_block_trainable`` in bf16 (``_fold_bwd_kernel`` with
``tail_refs`` in interpret mode) at enc stage 0's and enc stage 1's widths
(C = 96 / 6 heads and C = 192 / 12 heads, window (2, 7, 7)) on a 2 x 14 x 14
token grid, shifted and not (the Pallas kernel at enc stage 0, shifted), without a
qkv bias, and on a chunk cut short.
Bound: every one of the 14 gradients separately, max|emulation - reference|
<= 2e-2 * max|reference|: ``chip_smoke.py``'s ``BWD_TOL[torch.bfloat16]`` for
a bf16 kernel against its plain version (both round at the same casts; a
different fp32 order can flip one bf16 rounding of y1, hb, dy1, P, dss or
dqkv).  That bound cannot see dy1 left unrounded (it moves every gradient by
at most 2^-9 of its size), so dx, a bf16 output, is also held bit for bit:
at least ``DX_EQUAL`` of its elements equal the reference's (0.81-0.95 of
them do; with dy1 unrounded 0.53-0.56).  Planted faults
show that the bounds catch dy1 left unrounded and d(bias) added once per
window where it is added once per chunk.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse)
from vadcl_tpu.ops.pallas_attn_fold import folded_full_block_trainable
from vadcl_tpu.ops.window import compute_attn_mask
from vadcl_tpu_torch.ops import KERNELS, fold_attn
from vadcl_tpu_torch.ops.fold_attn import (
    FOLD_BLOCK_GRADS, SMEM_LIMIT, _ln_stats, _ln_vjp, fold_block_bwd, fold_block_bwd_body,
    fold_block_bwd_mma_smem_bytes, fold_block_bwd_plain, fold_block_bwd_tiles, fold_block_fits,
)
from vadcl_tpu_torch.ops.ln_mlp import dgelu_exact_f32, gelu_exact_f32
from vadcl_tpu_torch.ops.window import window_partition, window_reverse

T = torch.from_numpy
L2E = np.float32(1.4426950408889634)  # csrc/mma.cuh:kLog2e
TINY = 2.0 ** -126  # smallest normal fp32: ex2.approx.ftz flushes below it
TOL = 2e-2  # chip_smoke.py:BWD_TOL[torch.bfloat16]
DX_EQUAL = 0.75  # share of dx elements bit-equal to the reference's (0.81-0.95 seen)
BLOCKS = 132  # csrc/fold_block_bwd_mma.cu:kBbBlocks
WINDOW, SHIFT, GRID = (2, 7, 7), (0, 3, 3), (2, 14, 14)
WIDTHS = {"enc_stage0": (96, 6), "enc_stage1": (192, 12)}


def bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def split(t: torch.Tensor):
    """hi = round(x), lo = round(x - hi): the body's split of an fp32 operand."""
    hi = bf16(t)
    return hi, bf16(t - hi)


def _case(width, batch=1, seed=0, qkv_bias=True):
    C, nh = WIDTHS[width]
    rng = np.random.RandomState(seed)
    n, ch = WINDOW[0] * WINDOW[1] * WINDOW[2], 4 * C
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    bf = lambda v: v.astype(jnp.bfloat16).astype(np.float32)  # noqa: E731
    return dict(
        x=bf(f(batch, *GRID, C)), dout=bf(f(batch, *GRID, C)), ln_s=1 + 0.1 * f(C),
        ln_b=0.1 * f(C), qkv_w=f(C, 3 * C) / np.sqrt(C),
        qkv_b=0.1 * f(3 * C) if qkv_bias else None, proj_w=f(C, C) / np.sqrt(C),
        proj_b=0.1 * f(C), bias=f(nh, n, n), ln2_s=1 + 0.1 * f(C), ln2_b=0.1 * f(C),
        w1=f(C, ch) / np.sqrt(C), b1=0.1 * f(ch), w2=f(ch, C) / np.sqrt(ch), b2=0.1 * f(C),
        nh=nh, scale=(C // nh) ** -0.5,
    )


def _mask(shifted):
    return compute_attn_mask(*GRID, WINDOW, SHIFT) if shifted else None


def _owned_sum(per_window, blocks, fault=False):
    """Per-window sums (first axis; then, for the sums over tokens, the
    window's strips of 16 rows) as the body sums them: a block's chunk of
    consecutive windows into one partial a strip (the first window writes it,
    the others add in window order), the strips in order, then the blocks'
    partials in eight groups (blocks g, g + 8, ... in order) and the groups in
    order.  ``fault`` plants the error the bound must catch: the running
    partial added into the total after every window instead of once per
    chunk."""
    n = per_window.shape[0]
    chunk = -(-n // (BLOCKS if blocks is None else blocks))
    rows = []
    for w0 in range(0, n, chunk):
        part = per_window[w0].clone()
        for w in range(w0 + 1, min(w0 + chunk, n)):
            if fault:
                rows.append(part.clone())
            part = part + per_window[w]
        row = part[0]
        for strip in part[1:]:
            row = row + strip
        rows.append(row)
    total = torch.zeros_like(rows[0])
    for g in range(8):
        group = torch.zeros_like(rows[0])
        for r in rows[g::8]:
            group = group + r
        total = total + group
    return total


def _strips(t):
    """(Bn, N, *) token values -> (Bn, strips, *) sums over each strip's rows."""
    bn, n = t.shape[:2]
    pad = -(-n // 16) * 16 - n
    t = torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
    return t.reshape(bn, -1, 16, *t.shape[2:]).sum(2)


def block_bwd_emulation(a, shifted, blocks=None, fault=None):
    """The 14 gradients as the body computes them (see the module docstring);
    ``blocks`` is the target block count (the body's ``kBbBlocks`` when None);
    ``fault`` is None, ``"dy1"`` (dy1 not rounded) or ``"dbias"``."""
    C, nh = a["x"].shape[-1], a["nh"]
    hd, scale = C // nh, np.float32(a["scale"])
    B, D, H, W = a["x"].shape[:4]
    back = (-SHIFT[1], -SHIFT[2])
    roll = (lambda t: torch.roll(t, back, (2, 3))) if shifted else (lambda t: t)
    xw = window_partition(roll(T(a["x"])), WINDOW)  # (Bn, N, C), values bf16
    dyw = window_partition(roll(T(a["dout"])), WINDOW)
    Bn, N, _ = xw.shape
    Wq, Wp, W1, W2 = (bf16(T(a[k])) for k in ("qkv_w", "proj_w", "w1", "w2"))
    qb = T(a["qkv_b"]) if a["qkv_b"] is not None else torch.zeros(3 * C)
    heads = lambda t: t.reshape(Bn, N, nh, hd).transpose(1, 2)  # noqa: E731
    flat = lambda t: t.transpose(1, 2).reshape(Bn, N, -1)  # noqa: E731

    # step 1: y1 on kernel A's strip body
    xhat, rstd = _ln_stats(xw)
    row = bf16(xhat * T(a["ln_s"]) + T(a["ln_b"]))
    qkv = bf16(row @ Wq + qb)
    q, k, v = (heads(qkv[..., i * C:(i + 1) * C]) for i in range(3))
    terms = T(a["bias"])[None].expand(Bn, -1, -1, -1)
    if shifted:
        m = T(_mask(True))
        terms = (terms.reshape(Bn // m.shape[0], m.shape[0], nh, N, N) + m[None, :, None]
                 ).reshape(Bn, nh, N, N)
    s = (terms * (np.float32(1) / scale) + q @ k.transpose(-2, -1)) * (scale * L2E)
    e = torch.exp2(s - s.amax(-1, keepdim=True))
    e = torch.where(e < TINY, torch.zeros_like(e), e)
    P = e / e.sum(-1, keepdim=True)
    o = flat(bf16(bf16(P) @ v))
    y1 = bf16(o @ Wp + T(a["proj_b"]) + xw)

    # step 2: kernel 5's strip body on y1
    xhat2, rstd2 = _ln_stats(y1)
    z = xhat2 * T(a["ln2_s"]) + T(a["ln2_b"])
    hb = bf16(bf16(z) @ W1 + T(a["b1"]))
    g = gelu_exact_f32(hb)
    dh = (dyw @ W2.T) * dgelu_exact_f32(hb)
    dh_hi, dh_lo = split(dh)
    dz = dh_hi @ W1.T + dh_lo @ W1.T
    dy1 = dyw + _ln_vjp(dz, xhat2, rstd2, T(a["ln2_s"]))
    if fault != "dy1":
        dy1 = bf16(dy1)

    # step 3: kernel 6's strip body with dy1 as upstream
    doa = heads(bf16(dy1 @ Wp.T))
    dp = doa @ v.transpose(-2, -1)
    ds = P * (dp - (dp * P).sum(-1, keepdim=True))
    dss = bf16(ds * scale)
    dqkv = torch.cat([flat(dss @ k), flat(dss.transpose(-2, -1) @ q),
                      flat(bf16(P).transpose(-2, -1) @ doa)], -1)  # unrounded
    dqkv_r = bf16(dqkv)
    dxa = dqkv_r @ Wq.T
    dx = bf16(_ln_vjp(dxa, xhat, rstd, T(a["ln_s"])) + dy1)
    dx = window_reverse(dx, WINDOW, B, D, H, W)
    if shifted:
        dx = torch.roll(dx, SHIFT[1:], (2, 3))

    # the owned partials, then the second pass
    two = lambda t: t.reshape(-1, t.shape[-1])  # noqa: E731
    z_hi, z_lo = split(z)
    g_hi, g_lo = split(g)
    dln = _owned_sum(torch.stack([_strips(dxa * xhat), _strips(dxa)], -2), blocks)
    dln2 = _owned_sum(torch.stack([_strips(dz * xhat2), _strips(dz)], -2), blocks)
    return (
        dx, dln[0], dln[1], two(row).T @ two(dqkv_r),
        _owned_sum(_strips(dqkv), blocks) if a["qkv_b"] is not None else None,
        two(o).T @ two(dy1), two(dy1).sum(0),
        _owned_sum(ds[:, None], blocks, fault == "dbias"),
        dln2[0], dln2[1],
        two(z_hi).T @ two(dh_hi) + two(z_hi).T @ two(dh_lo) + two(z_lo).T @ two(dh_hi),
        two(dh_hi + dh_lo).sum(0), two(g_hi + g_lo).T @ two(dyw), two(dyw).sum(0),
    )


def plain_reference(a, shifted):
    """``fold_block_bwd_plain`` on the bf16 inputs."""
    x, dout = (T(a[k]).to(torch.bfloat16) for k in ("x", "dout"))
    opt = lambda v: None if v is None else T(v)  # noqa: E731
    return fold_block_bwd_plain(
        x, dout, T(a["ln_s"]), T(a["ln_b"]), T(a["qkv_w"]), opt(a["qkv_b"]), T(a["proj_w"]),
        T(a["proj_b"]), T(a["bias"]), opt(_mask(shifted)), T(a["ln2_s"]), T(a["ln2_b"]),
        T(a["w1"]), T(a["b1"]), T(a["w2"]), a["nh"], WINDOW, a["scale"],
        SHIFT if shifted else (0, 0, 0))


def pallas_reference(a, shifted):
    """``jax.vjp`` of ``folded_full_block_trainable`` in bf16, interpret mode."""
    rolled = (lambda t: np.roll(t, (-3, -3), (2, 3))) if shifted else (lambda t: t)
    mask = None if not shifted else jnp.asarray(_mask(True))
    keys = ("ln_s", "ln_b", "qkv_w", "qkv_b", "proj_w", "proj_b", "bias", "ln2_s", "ln2_b",
            "w1", "b1", "w2", "b2")
    ops = [jnp.asarray(rolled(a["x"]), jnp.bfloat16)] + [
        None if a[k] is None else jnp.asarray(a[k]) for k in keys]

    def fn(x, ln_s, ln_b, qkv_w, qkv_b, proj_w, proj_b, bias, *tail):
        return folded_full_block_trainable(x, ln_s, ln_b, qkv_w, qkv_b, proj_w, proj_b, bias,
                                           mask, *tail, a["nh"], WINDOW, a["scale"], True)

    _, vjp = jax.vjp(fn, *ops)
    got = vjp(jnp.asarray(rolled(a["dout"]), jnp.bfloat16))
    out = [None if g is None else torch.from_numpy(np.asarray(g.astype(jnp.float32)))
           for g in got[:14]]
    if shifted:
        out[0] = torch.roll(out[0], SHIFT[1:], (2, 3))
    return out


def ratios(got, want) -> dict:
    """Per gradient max|got - want| / (TOL * max|want|): within the bound at <= 1."""
    out = {}
    for name, g, w in zip(FOLD_BLOCK_GRADS, got, want):
        assert (g is None) == (w is None), name
        if w is not None:
            out[name] = float((g.float() - w.float()).abs().max()) / (
                TOL * float(w.float().abs().max()))
    return out


def dx_equal(got, want) -> float:
    """Share of dx's elements bit-equal to the reference's (both bf16 values)."""
    return float((bf16(got[0]) == bf16(want[0])).float().mean())


def assert_within(got, want):
    r = ratios(got, want)
    assert len(r) >= 13 and max(r.values()) <= 1.0, r
    assert dx_equal(got, want) >= DX_EQUAL, dx_equal(got, want)


_CASES = {}


def _setup(width, shifted, qkv_bias=True, batch=1, seed=1):
    key = (width, shifted, qkv_bias, batch, seed)
    if key not in _CASES:
        a = _case(width, batch, seed, qkv_bias)
        _CASES[key] = (a, plain_reference(a, shifted))
    return _CASES[key]


@pytest.mark.parametrize("shifted", [False, True], ids=["unshifted", "shifted"])
@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_emulation_matches_plain(width, shifted):
    a, want = _setup(width, shifted)
    assert_within(block_bwd_emulation(a, shifted), want)


def test_emulation_matches_pallas():
    a, _ = _setup("enc_stage0", True)
    assert_within(block_bwd_emulation(a, True), pallas_reference(a, True))


def test_without_qkv_bias():
    a, want = _setup("enc_stage0", True, qkv_bias=False)
    got = block_bwd_emulation(a, True)
    assert got[FOLD_BLOCK_GRADS.index("dqkv_b")] is None
    assert_within(got, want)


def test_a_chunk_cut_short():
    """Eight windows over three blocks: chunks of 3, 3 and 2 windows."""
    a, want = _setup("enc_stage0", True, batch=2)
    assert_within(block_bwd_emulation(a, True, blocks=3), want)


def test_the_bounds_catch_the_planted_faults():
    """dy1 left unrounded moves dx off the reference's bits; d(bias) added
    into the total after every window of a chunk breaks the per-tensor bound."""
    a, want = _setup("enc_stage0", True, batch=2)
    assert dx_equal(block_bwd_emulation(a, True, blocks=3, fault="dy1"), want) < DX_EQUAL
    r = ratios(block_bwd_emulation(a, True, blocks=3, fault="dbias"), want)
    assert r["dbias"] > 1.0 and max(v for k, v in r.items() if k != "dbias") <= 1.0, r


# -- the route ------------------------------------------------------------------

FLAGSHIP = {"enc_stage0": (98, 96, 6), "enc_stage1": (98, 192, 12),
            "dec_stage0": (49, 192, 12), "dec_stage1": (49, 96, 6)}


@pytest.mark.parametrize("geom", sorted(FLAGSHIP))
def test_flagship_geometries_take_the_new_body_in_bf16_only(geom):
    n, c, nh = FLAGSHIP[geom]
    assert fold_block_bwd_body(n, c, nh, 4 * c, torch.bfloat16) == "mma"
    assert fold_block_bwd_body(n, c, nh, 4 * c, torch.float32) == "tiles"
    assert fold_block_bwd_mma_smem_bytes(n, c, nh) <= SMEM_LIMIT


@pytest.mark.parametrize("n, c, nh, ch, why", [
    (49, 96, 2, 384, "head width 48"), (147, 96, 6, 384, "N above 112"),
    (98, 24, 2, 96, "C % 16"), (49, 256, 16, 1024, "C above 192"),
    (98, 96, 6, 96, "hidden not a multiple of 64"), (98, 192, 6, 768, "block above 227 KB"),
])
def test_the_old_body_keeps_every_other_geometry(n, c, nh, ch, why):
    assert fold_block_bwd_body(n, c, nh, ch, torch.bfloat16) == "tiles", why


def test_layout_mirror_at_the_flagship():
    """``bb_layout``'s bytes, mirrored: enc stage 1 (the largest) is step 3's
    region, kernel 6's body plus nothing."""
    assert fold_block_bwd_mma_smem_bytes(98, 192, 12) == 199040
    assert fold_block_bwd_mma_smem_bytes(98, 96, 6) == 148864
    assert fold_block_bwd_mma_smem_bytes(49, 192, 12) == 134784
    assert fold_block_bwd_mma_smem_bytes(49, 96, 6) == 85120
    assert fold_block_bwd_mma_smem_bytes(98, 192, 6) > SMEM_LIMIT


# fold_block_fits's answers on the tree before the new body: every (n, C,
# heads, dtype) of this grid where it held.
_GRID = [(n, c, nh) for n in (49, 98, 112, 147, 196) for c, nh in (
    (24, 2), (32, 2), (48, 1), (64, 2), (96, 2), (96, 3), (96, 6), (128, 4), (144, 3),
    (192, 6), (192, 12), (256, 8), (256, 16))]
_FITS_BEFORE = {
    "bf16": {(49, c, nh) for c, nh in ((24, 2), (32, 2), (48, 1), (64, 2), (96, 2), (96, 3),
                                       (96, 6), (128, 4), (144, 3), (192, 6), (192, 12),
                                       (256, 8), (256, 16))}
    | {(98, 24, 2), (98, 32, 2), (98, 64, 2), (98, 96, 6), (98, 192, 12), (112, 24, 2),
       (112, 32, 2), (112, 64, 2), (112, 96, 6), (112, 192, 12)},
    "fp32": {(49, c, nh) for c, nh in ((24, 2), (32, 2), (48, 1), (64, 2), (96, 2), (96, 3),
                                       (96, 6), (128, 4), (144, 3), (192, 6), (192, 12),
                                       (256, 8), (256, 16))}
    | {(98, 24, 2), (98, 32, 2), (98, 48, 1), (98, 64, 2), (98, 96, 2), (98, 96, 3),
       (98, 96, 6), (98, 128, 4), (98, 144, 3), (98, 192, 6), (98, 192, 12), (112, 24, 2),
       (112, 32, 2), (112, 64, 2), (112, 96, 3), (112, 96, 6), (147, 24, 2)},
}


# Where that answer was true but the launch raised (bf16 head width 12, and a
# hidden width 4C off the forward's 128-column chunks at head width 48), the
# predicate now also asks whether a body of each direction takes the geometry
# and answers false: the block takes another route.
_RAISED_BEFORE = {(49, 24, 2), (98, 24, 2), (112, 24, 2), (49, 48, 1), (49, 144, 3)}


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_fold_block_fits_answers_as_before(dtype):
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    want = _FITS_BEFORE[dtype] - (_RAISED_BEFORE if dtype == "bf16" else set())
    assert {g for g in _GRID if fold_block_fits(*g, 4 * g[1], dt)} == want


def test_both_bodies_count_their_launches_and_cpu_calls_do_not():
    names = {k.__name__ for k in KERNELS}
    assert {"fold_block_bwd", "fold_block_bwd_tiles"} <= names
    assert len(KERNELS) == 25
    a = _case("enc_stage0", seed=2)
    x, dout = (T(a[k]).to(torch.bfloat16) for k in ("x", "dout"))
    args = [T(a[k]) for k in ("ln_s", "ln_b", "qkv_w", "qkv_b", "proj_w", "proj_b", "bias")]
    tail = [T(a[k]) for k in ("ln2_s", "ln2_b", "w1", "b1", "w2")]
    before = [k.launches for k in KERNELS]
    for fn in (fold_block_bwd, fold_block_bwd_tiles):
        got = fn(x, dout, *args, None, *tail, a["nh"], WINDOW, a["scale"])
        assert len(got) == 14 and got[0].dtype == torch.bfloat16
    assert [k.launches for k in KERNELS] == before
    assert fold_attn.fold_block_bwd_tiles is fold_block_bwd_tiles
