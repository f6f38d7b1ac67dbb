"""The whole-block forward's bf16 tensor-core body
(``csrc/fold_block_mma.cu``), emulated in torch on the CPU, and the route
that picks it.

The body runs only on the card (``chip_smoke.py`` phase 2 holds it against
the plain version there); what the CPU can hold is its arithmetic.
``block_fwd_emulation`` repeats the body per window: step 1, kernel A's
strip body (LN1 rounded, q, k, v rounded once from fp32 sums, the scores
``((bias + mask) / scale + q.k) * scale * log2 e``, ``P = 2^(s - m) / l``
with e flushed below the smallest normal, ``o = round(round(P) . v)``,
``y1 = round(o . W_proj + proj_b + x)``); step 2 on the same rows, LN2 in
fp32, ``z = round(LN2 y1)``, per 32-column ring piece ``h = round(z . W1 +
b1)``, ``g = round(gelu(h))``, fc2 summed into one fp32 tile in ring-piece
order, 16 hidden columns (one k step) at a time; step 3, ``y = round(y1 +
(fc2 + b2))``.  A window's rows are independent of each other outside the
scores, so the strips of 16 rows are one batch axis here, and the padded
rows, which the body computes and never stores, are left out.  Sums inside
one product are taken in torch's order.

It is held against ``fold_block_plain`` (bf16) and against
``folded_full_block_trainable``'s forward in bf16 (``_fold_kernel`` with
``mlp=`` in interpret mode) at enc stage 0's and enc stage 1's widths (C =
96 / 6 heads and C = 192 / 12 heads, window (2, 7, 7)) on a 2 x 14 x 14
token grid, shifted and not, without a qkv bias, at N = 49 (window (1, 7,
7)), and at hidden 192 (off PR 4's 128-column chunks).  Bound:
max|emulation - reference| <= 2e-2 * max|reference| (``chip_smoke.py``'s
``BOUNDS[torch.bfloat16]`` for a bf16 kernel against its plain version:
both round at the same casts, but another fp32 order can flip one bf16
rounding of y1, z, h or g).  That bound cannot see y1 or g left unrounded,
so the output, bf16, is also held bit for bit: at least ``Y_EQUAL`` of its
elements equal the plain version's.  Planted faults show that the bounds
catch y1 left unrounded, g left unrounded and b2 dropped.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse)
from vadcl_tpu.ops.pallas_attn_fold import folded_full_block_trainable
from vadcl_tpu.ops.window import compute_attn_mask
from vadcl_tpu_torch.ops import KERNELS, fold_attn
from vadcl_tpu_torch.ops.fold_attn import (
    SMEM_LIMIT,
    _ln_stats,
    fold_block,
    fold_block_fits,
    fold_block_fwd_body,
    fold_block_fwd_mma_smem_bytes,
    fold_block_plain,
    fold_block_tiles,
)
from vadcl_tpu_torch.ops.ln_mlp import gelu_exact_f32
from vadcl_tpu_torch.ops.window import window_partition, window_reverse

T = torch.from_numpy
L2E = np.float32(1.4426950408889634)  # csrc/mma.cuh:kLog2e
TINY = 2.0 ** -126  # smallest normal fp32: ex2.approx.ftz flushes below it
TOL = 2e-2  # chip_smoke.py:BOUNDS[torch.bfloat16]
# share of outputs bit-equal to the plain version's (0.996-0.9999 seen; 0.49
# with y1 unrounded, 0.71 with g unrounded)
Y_EQUAL = 0.9
PIECE, KSTEP = 32, 16  # hidden columns a ring stage holds, and an mma k step
WIDTHS = {"enc_stage0": (96, 6), "enc_stage1": (192, 12)}
GEOMS = {"N98": ((2, 7, 7), (2, 14, 14)), "N49": ((1, 7, 7), (1, 14, 14))}


def bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _case(width, geom="N98", seed=0, qkv_bias=True, hidden=None):
    C, nh = WIDTHS[width]
    window, grid = GEOMS[geom]
    rng = np.random.RandomState(seed)
    n, ch = window[0] * window[1] * window[2], hidden or 4 * C
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    return dict(
        x=bf16(T(f(1, *grid, C))).numpy(), ln_s=1 + 0.1 * f(C), ln_b=0.1 * f(C),
        qkv_w=f(C, 3 * C) / np.sqrt(C), qkv_b=0.1 * f(3 * C) if qkv_bias else None,
        proj_w=f(C, C) / np.sqrt(C), proj_b=0.1 * f(C), bias=f(nh, n, n),
        ln2_s=1 + 0.1 * f(C), ln2_b=0.1 * f(C), w1=f(C, ch) / np.sqrt(C), b1=0.1 * f(ch),
        w2=f(ch, C) / np.sqrt(ch), b2=0.1 * f(C), nh=nh, scale=(C // nh) ** -0.5,
        window=window, shift=tuple(w // 2 for w in window),
    )


def _mask(a, shifted):
    grid = a["x"].shape[1:4]
    return compute_attn_mask(*grid, a["window"], a["shift"]) if shifted else None


def block_fwd_emulation(a, shifted, fault=None):
    """y as the body computes it (see the module docstring); ``fault`` is
    None, ``"y1"`` (y1 not rounded), ``"g"`` (g not rounded) or ``"b2"``
    (b2 dropped)."""
    C, nh = a["x"].shape[-1], a["nh"]
    hd, scale = C // nh, np.float32(a["scale"])
    B, D, H, W = a["x"].shape[:4]
    window, shift = a["window"], a["shift"]
    back = tuple(-s for s in shift)
    x = T(a["x"])
    xw = window_partition(torch.roll(x, back, (1, 2, 3)) if shifted else x, window)
    Bn, N, _ = xw.shape
    Wq, Wp, W1, W2 = (bf16(T(a[k])) for k in ("qkv_w", "proj_w", "w1", "w2"))
    qb = T(a["qkv_b"]) if a["qkv_b"] is not None else torch.zeros(3 * C)
    heads = lambda t: t.reshape(Bn, N, nh, hd).transpose(1, 2)  # noqa: E731

    # step 1: y1 on kernel A's strip body
    xhat, _ = _ln_stats(xw)
    row = bf16(xhat * T(a["ln_s"]) + T(a["ln_b"]))
    qkv = bf16(row @ Wq + qb)
    q, k, v = (heads(qkv[..., i * C:(i + 1) * C]) for i in range(3))
    terms = T(a["bias"])[None].expand(Bn, -1, -1, -1)
    if shifted:
        m = T(_mask(a, True))
        terms = (terms.reshape(Bn // m.shape[0], m.shape[0], nh, N, N) + m[None, :, None]
                 ).reshape(Bn, nh, N, N)
    s = (terms * (np.float32(1) / scale) + q @ k.transpose(-2, -1)) * (scale * L2E)
    e = torch.exp2(s - s.amax(-1, keepdim=True))
    e = torch.where(e < TINY, torch.zeros_like(e), e)
    P = e / e.sum(-1, keepdim=True)
    o = bf16(bf16(P) @ v).transpose(1, 2).reshape(Bn, N, C)
    y1 = o @ Wp + T(a["proj_b"]) + xw
    if fault != "y1":
        y1 = bf16(y1)

    # step 2: LN2 over the same rows, then the MLP a ring piece at a time
    xhat2, _ = _ln_stats(y1)
    z = bf16(xhat2 * T(a["ln2_s"]) + T(a["ln2_b"]))
    acc = torch.zeros(Bn, N, C)
    for p0 in range(0, W1.shape[1], PIECE):
        h = bf16(z @ W1[:, p0:p0 + PIECE] + T(a["b1"])[p0:p0 + PIECE])
        g = gelu_exact_f32(h)
        if fault != "g":
            g = bf16(g)
        for k0 in range(0, PIECE, KSTEP):
            acc = acc + g[..., k0:k0 + KSTEP] @ W2[p0 + k0:p0 + k0 + KSTEP]

    # step 3: y = round(y1 + (fc2 + b2)), stored by the folded addressing
    y = bf16(y1 + (acc + (0.0 if fault == "b2" else T(a["b2"]))))
    y = window_reverse(y, window, B, D, H, W)
    return torch.roll(y, shift, (1, 2, 3)) if shifted else y


def plain_reference(a, shifted):
    """``fold_block_plain`` on the bf16 input."""
    opt = lambda v: None if v is None else T(v)  # noqa: E731
    return fold_block_plain(
        T(a["x"]).to(torch.bfloat16), T(a["ln_s"]), T(a["ln_b"]), T(a["qkv_w"]),
        opt(a["qkv_b"]), T(a["proj_w"]), T(a["proj_b"]), T(a["bias"]), opt(_mask(a, shifted)),
        T(a["ln2_s"]), T(a["ln2_b"]), T(a["w1"]), T(a["b1"]), T(a["w2"]), T(a["b2"]), a["nh"],
        a["window"], a["scale"], a["shift"] if shifted else (0, 0, 0)).float()


def pallas_reference(a, shifted):
    """``folded_full_block_trainable``'s forward in bf16, interpret mode."""
    back = tuple(-s for s in a["shift"])
    x = np.roll(a["x"], back, (1, 2, 3)) if shifted else a["x"]
    keys = ("ln_s", "ln_b", "qkv_w", "qkv_b", "proj_w", "proj_b", "bias")
    tail = ("ln2_s", "ln2_b", "w1", "b1", "w2", "b2")
    opt = lambda v: None if v is None else jnp.asarray(v)  # noqa: E731
    mask = _mask(a, shifted)
    y = folded_full_block_trainable(
        jnp.asarray(x, jnp.bfloat16), *(opt(a[k]) for k in keys), opt(mask),
        *(opt(a[k]) for k in tail), a["nh"], a["window"], a["scale"], True)
    y = torch.from_numpy(np.asarray(y.astype(jnp.float32)))
    return torch.roll(y, a["shift"], (1, 2, 3)) if shifted else y


def ratio(got, want) -> float:
    """max|got - want| / (TOL * max|want|): within the bound at <= 1."""
    return float((got - want).abs().max()) / (TOL * float(want.abs().max()))


def equal_share(got, want) -> float:
    return float((bf16(got) == bf16(want)).float().mean())


def assert_within(got, want):
    assert ratio(got, want) <= 1.0, ratio(got, want)
    assert equal_share(got, want) >= Y_EQUAL, equal_share(got, want)


_CASES = {}


def _setup(width, shifted, **kw):
    key = (width, shifted, tuple(sorted(kw.items())))
    if key not in _CASES:
        a = _case(width, **kw)
        _CASES[key] = (a, plain_reference(a, shifted))
    return _CASES[key]


@pytest.mark.parametrize("shifted", [False, True], ids=["unshifted", "shifted"])
@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_emulation_matches_plain(width, shifted):
    a, want = _setup(width, shifted)
    assert_within(block_fwd_emulation(a, shifted), want)


@pytest.mark.parametrize("shifted", [False, True], ids=["unshifted", "shifted"])
def test_emulation_matches_pallas(shifted):
    a, _ = _setup("enc_stage0", shifted)
    want = pallas_reference(a, shifted)
    assert ratio(block_fwd_emulation(a, shifted), want) <= 1.0


@pytest.mark.parametrize("case", ["no_qkv_bias", "N49", "hidden192"])
def test_edge_cases(case):
    kw = {"no_qkv_bias": dict(qkv_bias=False), "N49": dict(geom="N49"),
          "hidden192": dict(hidden=192)}[case]
    a, want = _setup("enc_stage0", True, **kw)
    assert_within(block_fwd_emulation(a, True), want)


def test_the_bounds_catch_the_planted_faults():
    """y1 or g left unrounded moves the output off the plain version's bits;
    b2 dropped breaks the bound."""
    a, want = _setup("enc_stage0", True)
    for fault in ("y1", "g"):
        got = block_fwd_emulation(a, True, fault)
        assert ratio(got, want) <= 1.0 and equal_share(got, want) < Y_EQUAL, fault
    assert ratio(block_fwd_emulation(a, True, "b2"), want) > 1.0


# -- the route ------------------------------------------------------------------

FLAGSHIP = {"enc_stage0": (98, 96, 6), "enc_stage1": (98, 192, 12),
            "dec_stage0": (49, 192, 12), "dec_stage1": (49, 96, 6)}


@pytest.mark.parametrize("geom", sorted(FLAGSHIP))
def test_flagship_geometries_take_the_new_body_in_bf16_only(geom):
    n, c, nh = FLAGSHIP[geom]
    assert fold_block_fwd_body(n, c, nh, 4 * c, torch.bfloat16) == "mma"
    assert fold_block_fwd_body(n, c, nh, 4 * c, torch.float32) == "tiles"
    assert fold_block_fits(n, c, nh, 4 * c, torch.bfloat16)
    assert fold_block_fits(n, c, nh, 4 * c, torch.float32)


@pytest.mark.parametrize("n, c, nh, ch, why", [
    (49, 96, 2, 384, "head width 48"), (147, 96, 6, 384, "N above 112"),
    (98, 24, 2, 96, "C % 16"), (49, 256, 16, 1024, "C above 192"),
    (98, 96, 6, 96, "hidden not a multiple of 64"), (98, 96, 6, 0, "no hidden width"),
])
def test_the_old_body_keeps_every_other_geometry(n, c, nh, ch, why):
    assert fold_block_fwd_body(n, c, nh, ch, torch.bfloat16) == "tiles", why


def test_layout_mirror_at_the_flagship():
    """``fb_layout``'s bytes, mirrored: two blocks an SM fit at C = 96."""
    assert fold_block_fwd_mma_smem_bytes(98, 96, 6) == 92800
    assert fold_block_fwd_mma_smem_bytes(98, 192, 12) == 160384
    assert fold_block_fwd_mma_smem_bytes(49, 192, 12) == 112768
    assert fold_block_fwd_mma_smem_bytes(49, 96, 6) == 63616
    assert 2 * fold_block_fwd_mma_smem_bytes(98, 96, 6) <= 228 * 1024
    assert fold_block_fwd_mma_smem_bytes(98, 192, 6) == 205440 <= SMEM_LIMIT


def test_fold_block_fits_takes_hidden_widths_off_128():
    """Where PR 4's forward refused a bf16 hidden width off its 128-column
    chunks, the tensor-core body takes it (C = 48 at 3 heads, hidden 192;
    C = 32 at hidden 64); head width 12 stays refused."""
    assert fold_block_fits(98, 48, 3, 192, torch.bfloat16)
    assert fold_block_fwd_body(98, 48, 3, 192, torch.bfloat16) == "mma"
    assert fold_block_fits(98, 32, 2, 64, torch.bfloat16)
    assert not fold_block_fits(98, 24, 2, 96, torch.bfloat16)


def test_both_bodies_count_their_launches_and_cpu_calls_do_not():
    names = {k.__name__ for k in KERNELS}
    assert {"fold_block", "fold_block_tiles"} <= names
    assert len(KERNELS) == 25
    a, want = _setup("enc_stage0", True)
    opt = lambda v: None if v is None else T(v)  # noqa: E731
    args = [T(a["x"]).to(torch.bfloat16)] + [opt(a[k]) for k in (
        "ln_s", "ln_b", "qkv_w", "qkv_b", "proj_w", "proj_b", "bias")]
    tail = [T(a[k]) for k in ("ln2_s", "ln2_b", "w1", "b1", "w2", "b2")]
    before = [k.launches for k in KERNELS]
    for fn in (fold_block, fold_block_tiles):
        got = fn(*args, opt(_mask(a, True)), *tail, a["nh"], a["window"], a["scale"],
                 a["shift"])
        assert got.dtype == torch.bfloat16 and torch.equal(got.float(), want)
    assert [k.launches for k in KERNELS] == before
    assert fold_attn.fold_block_tiles is fold_block_tiles
