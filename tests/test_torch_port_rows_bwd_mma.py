"""The bf16 attention core of the row-tiled window attention backward (kernel
8, ``csrc/window_attn_bwd_rows_mma.cu``), emulated in torch on the CPU.

The core runs only on the card (``chip_smoke.py``'s ``phase_row_kernels``
holds it against the plain version there); what the CPU can hold is its
arithmetic.  ``backward_emulation`` repeats the body step by step: the qkv
and ``dout . W_proj^T`` products rounded once from fp32 sums; per head, the
groups of G windows that share a mask index (``rows_bwd_group``; 0: the
direct layout, one warp a strip) spread over the head's blocks in order; the
strip's (bias + mask) tile summed first and scaled by log2 e; scores
``v' = fma(s, scale * log2 e, tile)``; phase A's first walk, the group's
windows together, 8 / G warps a window each over every (8 / G)-th key block,
with the online (m, l, rowsum(dp * 2^(v' - m))) kept per lane of a quad and
merged over the quad, then over the window's warps in warp order;
``r = rowsum / l``; the second walk, a window at a time, each of the 8 warps
over every 8th key block: ``P = 2^(v' - m) / l``,
``ds = P * (dp - r)``, ``dq += round(ds * scale) . k``, ``o += round(P) . v``
with the warps' partial strips summed in warp order; d(bias) summed over a
group's windows in window order, then into the block's partial once per
group, the partials summed in order; phase B's walk over the query blocks
from phase A's row statistics (``dk``, ``dv``), the group's windows
together, 8 / G warps a window each taking every (8 / G)-th query block,
merged in warp order; the column sums of the
unrounded dqkv per window, each warp's share over its partial strips, strips
in order, then the warps in order; the weight sums and dx from the rounded
dqkv.
Sums inside one ``mma`` are taken in torch's order, and where the kernel
calls ``fmaf`` the emulation rounds once in float64 first.

It is held against ``window_attention_fused_bwd_plain`` (bf16) and against
``jax.vjp`` of ``fused_window_attention_trainable`` in bf16 (``_bwd_kernel``
in interpret mode) at N = 196 and 392, head widths 16 and 32, shifted and
not, on groups cut short, and in the direct layout (N = 539 at head width
16); with a mask of arbitrary values against the plain version.  Bound: every gradient separately, d(bias) included,
max|emulation - reference| <= 2e-2 * max|reference|: ``chip_smoke.py``'s
``BWD_TOL[torch.bfloat16]`` for a bf16 kernel against its plain version (both
round at the same casts; a different fp32 order can flip one bf16 rounding
of p, dss or dqkv).  A planted fault (the group's d(bias) added into the
partial after every window instead of once per group) misses it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse)
from vadcl_tpu.ops.pallas_attn_bwd import fused_window_attention_trainable
from vadcl_tpu.ops.window import compute_attn_mask
from vadcl_tpu_torch.ops.fold_attn import SMEM_LIMIT
from vadcl_tpu_torch.ops.window_attn import (
    rows_bwd_group,
    rows_smem_bytes,
    window_attention_fused_bwd_plain,
    window_body,
)

T = torch.from_numpy
L2E = np.float32(1.4426950408889634)  # csrc/mma.cuh:kLog2e
TINY = 2.0 ** -126  # smallest normal fp32: ex2.approx.ftz flushes below it
TOL = 2e-2  # chip_smoke.py:BWD_TOL[torch.bfloat16]
WARPS = 8  # csrc/window_attn_bwd_rows_mma.cuh:kRbWarps
BLOCKS = 264  # kRowsBwdBlocks
NAMES = ("dx", "dqkv_w", "dqkv_b", "dproj_w", "dproj_b", "dbias")
WIDTHS = {"hd16": (32, 2), "hd32": (64, 2)}


def bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def ex2(x: torch.Tensor) -> torch.Tensor:
    y = torch.exp2(x)
    return torch.where(y < TINY, torch.zeros_like(y), y)


def fma32(a, b, c) -> torch.Tensor:
    """a * b + c with one fp32 rounding."""
    return (torch.as_tensor(a).double() * torch.as_tensor(b).double()
            + torch.as_tensor(c).double()).float()


def _chunks(bn, nh):
    """csrc/window_attn_bwd_rows_mma.cuh:rows_bwd_chunk, rows_bwd_chunks."""
    want = min(bn, -(-BLOCKS // nh))
    chunk = -(-bn // want)
    return chunk, -(-bn // chunk)


def _walk1(v, d, kbs):
    """One warp's online (m, l, rowsum) over key blocks ``kbs`` of the
    (.., Np, Np) scores v' and dp, per lane of the quad, then summed over it."""
    shape = v.shape[:-1]
    m = torch.full(shape, float("-inf"))
    lt, rt = torch.zeros(*shape, 4), torch.zeros(*shape, 4)
    for kb in kbs:
        vb = v[..., kb * 16:kb * 16 + 16].reshape(*shape, 2, 4, 2)  # [n tile][lane t][col]
        db = d[..., kb * 16:kb * 16 + 16].reshape(*shape, 2, 4, 2)
        n = torch.maximum(m, vb.amax((-3, -2, -1)))
        f = ex2(m - n)
        e = ex2(vb - n[..., None, None, None])
        al, ar = torch.zeros(*shape, 4), torch.zeros(*shape, 4)
        for nt in range(2):
            for c in range(2):
                al = al + e[..., nt, :, c]
                ar = fma32(db[..., nt, :, c], e[..., nt, :, c], ar)
        lt = fma32(lt, f[..., None], al)
        rt = fma32(rt, f[..., None], ar)
        m = n
    quad = lambda x: (x[..., 0] + x[..., 1]) + (x[..., 2] + x[..., 3])  # noqa: E731
    return m, quad(lt), quad(rt)


def _blocks_of(warps, nblk):
    return [list(range(w, nblk, warps)) for w in range(warps)]


def _acc(a, b, kbs):
    """sum over key blocks kbs, in order, of a[.., :, block] . b[.., block, :]."""
    out = None
    for kb in kbs:
        p = a[..., kb * 16:kb * 16 + 16] @ b[..., kb * 16:kb * 16 + 16, :]
        out = p if out is None else out + p
    return out if out is not None else torch.zeros(*a.shape[:-1], b.shape[-1])


def _ordered(parts):
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def core_emulation(q, k, v, do, tile, tile_t, smul, scale, warps, warps_b):
    """One window-head core for (W, nh, Np, hd) q, k, v, do (bf16 values,
    padded rows zero), the phase A tile (.., Np, Np) and phase B's (key rows
    first), with ``warps`` warps on a query strip's second walk and
    ``warps_b`` on its first walk and on a key strip of a window (1 and 1:
    the direct layout).  Returns
    o, dq, dk, dv (fp32 before rounding), ds (.., Np, Np) and the warps'
    partial dq, dk, dv (lists of (.., Np, hd))."""
    nblk = q.shape[-2] // 16
    s = q @ k.transpose(-2, -1)
    d = do @ v.transpose(-2, -1)
    vv = fma32(s, smul, tile)
    blocks = _blocks_of(warps, nblk)
    states = [_walk1(vv, d, kbs) for kbs in _blocks_of(warps_b, nblk)]
    m = torch.stack([st[0] for st in states]).amax(0)
    l, r = torch.zeros_like(m), torch.zeros_like(m)
    for mw, lw, rw in states:  # merged in warp order
        f = ex2(mw - m)
        l, r = fma32(lw, f, l), fma32(rw, f, r)
    r = r / l
    P = ex2(vv - m[..., None]) / l[..., None]
    ds = P * (d - r[..., None])
    dss, p = bf16(ds * np.float32(scale)), bf16(P)
    dqs = [_acc(dss, k, kbs) for kbs in blocks]
    o = _ordered([_acc(p, v, kbs) for kbs in blocks])
    # phase B: key strips over the query blocks, from the row statistics
    st = k @ q.transpose(-2, -1)
    dt = v @ do.transpose(-2, -1)
    pt = ex2(fma32(st, smul, tile_t) - m[..., None, :]) / l[..., None, :]
    dst = bf16(pt * (dt - r[..., None, :]) * np.float32(scale))
    qblocks = _blocks_of(warps_b, nblk)
    dks = [_acc(dst, q, qbs) for qbs in qblocks]
    dvs = [_acc(bf16(pt), do, qbs) for qbs in qblocks]
    return o, _ordered(dqs), _ordered(dks), _ordered(dvs), ds, (dqs, dks, dvs)


def backward_emulation(x, dout, qkv_w, qkv_b, proj_w, bias, mask, num_heads, n_windows, scale,
                       dbias_per_window: bool = False):
    """Kernel 8's row-tiled body in bf16 as the new core computes it; returns
    (dx, dqkv_w, dqkv_b, dproj_w, dproj_b, dbias) as the plain version does.
    ``dbias_per_window`` plants a fault: the group's running d(bias) added
    into the block's partial after every window."""
    Bn, N, C = x.shape
    nh, hd = num_heads, C // num_heads
    Np = -(-N // 16) * 16
    xf = x.float()
    qw, pw = bf16(qkv_w), bf16(proj_w)
    qkv = xf @ qw + (qkv_b.float() if qkv_b is not None else 0.0)
    qkv = bf16(qkv).reshape(Bn, N, 3, nh, hd).permute(2, 0, 3, 1, 4)
    doa = bf16(bf16(dout) @ pw.T).reshape(Bn, N, nh, hd).transpose(1, 2)
    pad = lambda t: torch.nn.functional.pad(t, (0, 0, 0, Np - N))  # noqa: E731
    q, k, v, do = pad(qkv[0]), pad(qkv[1]), pad(qkv[2]), pad(doa)

    bm = bias.float()[None].expand(Bn, nh, N, N)
    if mask is not None:
        bm = bm + mask.float().repeat(Bn // n_windows, 1, 1)[:, None]
    bm = bm * L2E
    tile = torch.full((Bn, nh, Np, Np), float("-inf"))
    tile[..., :, :N] = 0.0  # rows past the window: 0 over the real keys
    tile[..., :N, :N] = bm
    tile_t = torch.full((Bn, nh, Np, Np), float("-inf"))  # [key row][query]
    tile_t[..., :N, :N] = bm.transpose(-2, -1)

    per = Bn // n_windows if mask is not None else Bn
    classes = Bn // per
    G = rows_bwd_group(N, C, nh, per)
    o, dq, dk, dv, ds, parts = core_emulation(q, k, v, do, tile, tile_t,
                                              L2E * np.float32(scale), scale,
                                              WARPS if G else 1, WARPS // G if G else 1)
    ds = ds[..., :N, :N]
    chunk, chunks = _chunks(Bn, nh)
    if G:  # groups of windows sharing a mask index, spread over the head's blocks
        gpc = -(-per // G)
        ng = classes * gpc
        slots = min(ng, chunks)
        groups = [[w + classes * (gi * G + u) for u in range(min(G, per - gi * G))]
                  for w in range(classes) for gi in range(gpc)]
        owners = [groups[ng * s // slots:ng * (s + 1) // slots] for s in range(slots)]
    else:  # chunks of consecutive windows, one window a "group"
        owners = [[[w] for w in range(c * chunk, min(Bn, (c + 1) * chunk))] for c in range(chunks)]
    partials = []
    for mine in owners:
        part = None
        for group in mine:
            acc = None
            for win in group:
                acc = ds[win] if acc is None else acc + ds[win]
                if dbias_per_window:
                    part = acc if part is None else part + acc
            if not dbias_per_window:
                part = acc if part is None else part + acc
        partials.append(part)
    dbias = _ordered(partials)

    unpad = lambda t: t[..., :N, :].transpose(1, 2).reshape(Bn, N, C)  # noqa: E731
    o = bf16(unpad(o))
    dqkv = torch.stack([unpad(t) for t in (dq, dk, dv)], 2).reshape(Bn, N, 3 * C)
    # each warp's column sums of its partial strips, strips in order, then the
    # warps in order (per window and head), then the windows in order
    colsum = lambda t: _ordered([t[..., i:i + 16, :].sum(-2)  # noqa: E731
                                 for i in range(0, N, 16)])
    sums = [_ordered([colsum(t[..., :N, :]) for t in ws]) for ws in parts]  # (Bn, nh, hd)
    dqkv_b = _ordered(list(torch.stack(sums, 1).reshape(Bn, 3 * C))) if qkv_b is not None \
        else None
    dqkv_c = bf16(dqkv)
    do_c = bf16(dout).reshape(-1, C)
    return (bf16(dqkv_c @ qw.T), xf.reshape(-1, C).T @ dqkv_c.reshape(-1, 3 * C), dqkv_b,
            o.reshape(-1, C).T @ do_c, do_c.sum(0), dbias)


def _case(n, width, shifted, seed, images=1):
    """``images`` images' four (D, 7, 7) windows of a (D, 14, 14) token grid;
    the shifted blocks roll in H and W, as a model block with D <= 8 does."""
    (C, nh), D = WIDTHS[width], n // 49
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    return dict(
        x=f(4 * images, n, C), dout=f(4 * images, n, C), qkv_w=f(C, 3 * C) / np.sqrt(C),
        qkv_b=0.1 * f(3 * C), proj_w=f(C, C) / np.sqrt(C), bias=f(nh, n, n),
        mask=compute_attn_mask(D, 14, 14, (D, 7, 7), (0, 3, 3)) if shifted else None,
        nH=nh, nW=4, scale=(C // nh) ** -0.5,
    )


def _args(a):
    return (T(a["x"]).to(torch.bfloat16), T(a["dout"]).to(torch.bfloat16), T(a["qkv_w"]),
            T(a["qkv_b"]), T(a["proj_w"]), T(a["bias"]),
            None if a["mask"] is None else T(a["mask"]), a["nH"], a["nW"], a["scale"])


def _pallas(a):
    """jax.vjp of the trainable Pallas forward (its backward: _bwd_kernel in
    interpret mode), in bf16, with the plain version's proj_b-free contract."""
    mask = None if a["mask"] is None else jnp.asarray(a["mask"])
    x = jnp.asarray(a["x"], jnp.bfloat16)
    args = [x] + [jnp.asarray(a[k]) for k in ("qkv_w", "qkv_b", "proj_w")]
    pb = jnp.zeros(x.shape[-1])
    _, vjp = jax.vjp(lambda x, qw, qb, pw, b: fused_window_attention_trainable(
        x, qw, qb, pw, pb, b, mask, a["nH"], a["nW"], a["scale"], True),
        *args, jnp.asarray(a["bias"]))
    dx, dqw, dqb, dpw, dbias = vjp(jnp.asarray(a["dout"], jnp.bfloat16))
    dpb = jnp.asarray(a["dout"], jnp.bfloat16).astype(jnp.float32).sum((0, 1))
    return [torch.tensor(np.asarray(t.astype(jnp.float32))) for t in (dx, dqw, dqb, dpw, dpb,
                                                                      dbias)]


def worst(got, want) -> dict:
    """Per gradient max|got - want| / (TOL * max|want|): within the bound at <= 1."""
    out = {}
    for name, g, w in zip(NAMES, got, want):
        g, w = g.float(), w.float()
        assert g.shape == w.shape, name
        out[name] = float((g - w).abs().max()) / (TOL * float(w.abs().max()))
    return out


def _hold(a):
    got = backward_emulation(*_args(a))
    assert all(bool(torch.isfinite(t).all()) for t in got)
    plain = worst(got, window_attention_fused_bwd_plain(*_args(a)))
    assert max(plain.values()) <= 1.0, plain
    ref = worst(got, _pallas(a))
    assert max(ref.values()) <= 1.0, ref
    return got


CASES = [(196, "hd16", False), (196, "hd16", True), (392, "hd16", False), (392, "hd16", True),
         (196, "hd32", True), (392, "hd32", False)]


@pytest.mark.parametrize("n, width, shifted", CASES,
                         ids=[f"{n}-{w}-{'shifted' if s else 'unshifted'}" for n, w, s in CASES])
def test_emulation_matches_plain_and_pallas(n, width, shifted):
    a = _case(n, width, shifted, seed=n + 5 * shifted + len(width))
    C, nh = WIDTHS[width]
    assert rows_bwd_group(n, C, nh, 1 if shifted else 4) >= 1  # the staged layout
    _hold(a)


def test_groups_cut_short():
    """Three images: three windows a mask index, so G = 2 and each mask
    index's second group holds one window; the head's groups spread over
    six blocks."""
    a = _case(196, "hd16", True, seed=21, images=3)
    assert rows_bwd_group(196, 32, 2, 3) == 2
    _hold(a)


def test_the_direct_layout_above_the_staged_limit():
    """N = 539 (an (11, 7, 7) window, above 512): no group; a warp a strip
    over every key block, the chunk's d(bias) partial per window."""
    n = 539
    rng = np.random.RandomState(3)
    a = dict(_case(196, "hd16", False, seed=3), x=rng.randn(4, n, 32).astype(np.float32),
             dout=rng.randn(4, n, 32).astype(np.float32),
             bias=rng.randn(2, n, n).astype(np.float32))
    assert rows_bwd_group(n, 32, 2, 4) == 0 and window_body(n, 32, 2, torch.bfloat16, True) == "rows"
    _hold(a)


def test_bias_and_mask_summed_first_with_a_general_mask():
    """The core adds bias and mask before the score (JAX adds the score to
    the bias first).  With a mask of arbitrary values, not only 0 / -100,
    every gradient of that order stays within the bound of the plain
    version's."""
    a = _case(392, "hd16", True, seed=5)
    a["mask"] = (3 * np.random.RandomState(5).randn(4, 392, 392)).astype(np.float32)
    got = backward_emulation(*_args(a))
    plain = worst(got, window_attention_fused_bwd_plain(*_args(a)))
    assert max(plain.values()) <= 1.0, plain


def test_the_bound_catches_d_bias_added_once_per_window():
    """The planted fault: the group's running d(bias) added into the partial
    after every window (window 0 counted G times) misses the bound at
    N = 392, head width 16, where four windows make a group."""
    a = _case(392, "hd16", False, seed=8)
    assert rows_bwd_group(392, 32, 2, 4) == 4
    want = window_attention_fused_bwd_plain(*_args(a))
    good = worst(backward_emulation(*_args(a)), want)
    bad = worst(backward_emulation(*_args(a), dbias_per_window=True), want)
    assert good["dbias"] <= 1.0 < bad["dbias"]


def test_groups_and_layouts_at_the_frame8_geometries():
    """The windows a block takes at the frame-8 geometries in training (batch
    4: 4 windows a mask index shifted; 256 unshifted) and the layouts'
    sizes, the staged layout at its limit and the direct layout's, which is
    the body before's footprint."""
    for c, nh in ((96, 6), (192, 12)):
        assert rows_bwd_group(196, c, nh, 4) == 4 and rows_bwd_group(196, c, nh, 256) == 8
        assert rows_bwd_group(392, c, nh, 4) == rows_bwd_group(392, c, nh, 256) == 4
    assert rows_smem_bytes(392, 96, 6, True, backward=True, group=4) == 227584
    assert rows_smem_bytes(392, 96, 6, True, backward=True, group=8) > SMEM_LIMIT
    assert rows_smem_bytes(392, 96, 6, True, backward=True) == 86400
    assert rows_bwd_group(512, 32, 2, 1) == 1 and rows_bwd_group(513, 32, 2, 1) == 0
    assert rows_bwd_group(392, 128, 2, 4) == 0  # head width 64 at N 392: the direct layout


@pytest.mark.parametrize("hd, largest", [(16, 1072), (32, 640), (48, 464), (64, 352)])
def test_every_window_the_body_before_took_still_maps_to_rows(hd, largest):
    """The bf16 backward takes every window the body before this core took
    (its one-head layout, q, K, V and dout's slice in rows padded to hd + 8)
    and no more: ``window_body`` routes N up to ``largest`` to it, and
    raises above."""
    C, nh = 2 * hd, 2
    assert window_body(largest, C, nh, torch.bfloat16, True) == "rows"
    assert rows_smem_bytes(largest, C, nh, True, backward=True) <= SMEM_LIMIT
    with pytest.raises(NotImplementedError, match="neither"):
        window_body(largest + 16, C, nh, torch.bfloat16, True)
