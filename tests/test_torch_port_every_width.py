"""Fused kernels at every width the JAX package fuses.

Kernel B (``ln_mlp``) runs its wgmma body in bf16 up to C = 192, its slab
body (``csrc/ln_mlp_slab.cu``: fc2's output columns in slabs across blocks)
in bf16 at C % 16 == 0 up to 1024, and its CUDA-core body everywhere else,
with fewer tokens a block where 32 outgrow the block; kernel 5's CUDA-core
body takes scalar loads where C or the hidden width is off a multiple of 4
and narrower tiles where 16 tokens outgrow the block; kernel C splits the
channels of a row tile over a cluster of 2, 4 or 8 blocks above C = 768.
None of these bodies runs here (``chip_smoke.py``'s ``phase_width_kernels``
and ``phase_every_width_models`` hold them against their plain versions on
the card); this file holds what a CPU can check:

* a sweep over C in 1-2048 (``hypothesis``): every body choice returns a
  body, and wherever ``fold_block_fits`` holds both whole-block bodies take
  the geometry; the attention route of a block takes every head width up to
  2048 (one head; from 144 channels the partitioned-window bodies stream
  the head's channels: ``rows_streams``), and the plain versions of 7 and 8
  agree with the JAX kernels in interpret mode at head widths 144 and 288;
* the Python mirrors of the new instance tables against the sources, each
  instance within 227 KB;
* the slab body's weight layout (``pack_mlp_slabs``) walked as the kernel
  walks it, against the plain version;
* kernel C's channel split at C = 896 and 1536 as arithmetic: the slabs'
  partial cross products and |x|^2 summed in block order, held to the plain
  version at ``tests/test_torch_port_cluster_mma.py``'s bounds;
* fused tiny models at ``embed_dim`` 448 (B and the feature head at 896) and
  18 (kernel 5 at C = 18) against the JAX ``VADModel`` with the same weights
  (its fused kernels in interpret mode), forward and every parameter
  gradient at the bounds of ``tests/test_torch_port_fold_models.py``.
"""

import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from test_torch_port_cluster_mma import (
    K_PERM,
    KP_ALIGN,
    _check,
    _inputs,
    parts_product,
    split,
)
from test_torch_port_fold_models import assert_outputs_match
from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse)
from vadcl_tpu.core.config import preset as jax_preset
from vadcl_tpu.models.backbone import VADModel as JaxVADModel
from vadcl_tpu.train.checkpoint import flatten_state, unflatten_into
from vadcl_tpu_torch.convert import jax_from_state_dict, state_dict_from_jax
from vadcl_tpu_torch.core.config import preset
from vadcl_tpu_torch.models import VADModel
from vadcl_tpu_torch.ops.cluster_kernels import (
    CLUSTER_BLOCK_C,
    CLUSTER_MAX_C,
    CLUSTER_SHAPES,
    CLUSTER_SPLITS,
    FusedClusterOut,
    cluster_assign_blocks,
    cluster_assign_plain,
    cluster_assign_shape,
)
from vadcl_tpu_torch.ops.fold_attn import (
    SMEM_LIMIT,
    _block_tiles_take,
    _ln_fast,
    fold_block_bwd_body,
    fold_block_fits,
    fold_block_fwd_body,
    fold_fits,
)
from vadcl_tpu_torch.ops.ln_mlp import (
    MLP_SLAB_MIN_C,
    MLP_SLAB_SHAPES,
    gelu_exact_f32,
    ln_mlp_plain,
    mlp_bwd_body,
    mlp_bwd_tiles_smem_bytes,
    mlp_bwd_tokens,
    mlp_fwd_body,
    mlp_fwd_tokens,
    mlp_slab_shape,
    mlp_slab_smem_bytes,
    pack_mlp_slabs,
)
from vadcl_tpu_torch.ops.window_attn import (
    rows_smem_bytes,
    rows_streams,
    window_attention_fused_bwd_plain,
    window_attention_fused_plain,
    window_body,
)

T = torch.from_numpy
CSRC = Path(__file__).resolve().parent.parent / "vadcl_tpu_torch" / "csrc"
DTYPES = (torch.bfloat16, torch.float32)


# --- every width has a body ---------------------------------------------------

@st.composite
def _geometry(draw):
    c = draw(st.integers(1, 2048))
    divisors = [h for h in range(1, c + 1) if c % h == 0]
    heads = draw(st.sampled_from(divisors))
    return c, heads, draw(st.sampled_from((4, 2))), draw(st.sampled_from(DTYPES))


@settings(max_examples=400, deadline=None, derandomize=True, database=None)
@given(_geometry())
def test_every_width_up_to_2048_has_a_body(geometry):
    """No body choice raises at any C in 1-2048, hidden 4C or 2C, bf16 or
    fp32; wherever the whole-block kernels are admitted both of their bodies
    take the geometry; and at every head width (up to 2048, one head) a
    block's attention route (the fold kernel, else the partitioned-window
    bodies, each way) takes a 4-frame window of 49 or 98 tokens."""
    c, heads, ratio, dtype = geometry
    ch = ratio * c
    assert mlp_fwd_body(c, ch, dtype) in ("wgmma", "slab", "tiles")
    assert mlp_bwd_body(c, ch, dtype) in ("mma", "slab", "tiles")
    shape = cluster_assign_shape(c)
    assert shape in CLUSTER_SHAPES and -(-c // cluster_assign_blocks(c)) <= 8 * shape[0]
    for n in (49, 98):
        if fold_block_fits(n, c, heads, ch, dtype):
            for body, backward in ((fold_block_fwd_body, False), (fold_block_bwd_body, True)):
                got = body(n, c, heads, ch, dtype)
                assert got == "mma" or _block_tiles_take(c, heads, ch, dtype, backward)
        for backward in (False, True):
            if not fold_fits(n, c, heads, dtype, backward=backward):
                assert window_body(n, c, heads, dtype, backward) in ("tile", "rows")


# (N, the head width from which the whole-head CUDA-core core outgrows its
# block: forward, backward) of the 4-frame windows
STREAM_FROM = {98: (281, 144), 49: (544, 292)}


@pytest.mark.parametrize("n", sorted(STREAM_FROM))
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "fp32"])
def test_attention_takes_every_head_width_up_to_2048(n, dtype):
    """Every head width from 1 to 2048 (one head, the widest the sweep's C
    allows) gets a body for a 4-frame window, each way, in bf16 and fp32:
    the partitioned-window bodies of 7 and 8 stream the head's channels
    exactly where the whole head no longer fits (from 281 channels forward
    and 144 backward at N = 98, 544 and 292 at N = 49), in a block whose
    size does not grow with the head (164 N + 1024 and 340 N + 2048 bytes),
    and take the row-tiled body there."""
    for backward in (False, True):
        start = STREAM_FROM[n][backward]
        for hd in range(1, 2049):
            body = window_body(n, hd, 1, dtype, backward)
            assert body in ("tile", "rows"), (hd, backward)
            assert rows_streams(n, hd, 1, backward) == (hd >= start), (hd, backward)
            if hd >= start:
                assert body == "rows"
                assert rows_smem_bytes(n, hd, 1, dtype == torch.bfloat16, backward) == (
                    340 * n + 2048 if backward else 164 * n + 1024)
    # the streamed layouts' own limits: the longest windows they hold
    for backward, longest in ((False, 1411), (True, 677)):
        assert window_body(longest, 1024, 1, dtype, backward) == "rows"
        with pytest.raises(NotImplementedError, match="neither"):
            window_body(longest + 1, 1024, 1, dtype, backward)


def _attn_case(hd, n, seed):
    """Two windows of one head of width ``hd`` (the second window shifted:
    a mask of two window classes), the rel-pos bias at unit scale."""
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    mask = np.where(rng.rand(2, n, n) < 0.2, -100.0, 0.0).astype(np.float32)
    mask[0] = 0.0
    return dict(x=f(2, n, hd), qkv_w=f(hd, 3 * hd) / np.sqrt(hd), qkv_b=0.1 * f(3 * hd),
                proj_w=f(hd, hd) / np.sqrt(hd), proj_b=0.1 * f(hd), bias=f(1, n, n),
                mask=mask, dout=f(2, n, hd), scale=hd ** -0.5)


@pytest.mark.parametrize("hd, n", [(144, 98), (288, 49), (288, 98), (144, 49)])
def test_plain_attention_matches_jax_at_streamed_head_widths(hd, n):
    """The plain versions of kernels 7 and 8, which the card holds the
    streamed cores against, against the JAX kernels (``fused_window_attention``
    and ``fused_window_attention_trainable``'s backward, in interpret mode)
    at head widths the whole-head cores refused, fp32: the forward at
    ``tests/test_pallas_attn.py``'s 2e-5, every gradient within 1e-4 of its
    largest entry (summation order only)."""
    from vadcl_tpu.ops.pallas_attn import fused_window_attention
    from vadcl_tpu.ops.pallas_attn_bwd import fused_window_attention_trainable

    a = _attn_case(hd, n, seed=hd + n)
    names = ("x", "qkv_w", "qkv_b", "proj_w", "proj_b", "bias", "mask")
    port = [T(a[k]) for k in names]
    jx = [jnp.asarray(a[k]) for k in names]
    kw = dict(num_heads=1, n_windows=2, scale=a["scale"], interpret=True)
    want = fused_window_attention(*jx, **kw)
    got = window_attention_fused_plain(*port, 1, 2, a["scale"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    diff = [0, 1, 2, 3, 4, 5]  # x, qkv_w, qkv_b, proj_w, proj_b, bias

    def loss(*args):
        full = list(jx)
        for i, v in zip(diff, args):
            full[i] = v
        out = fused_window_attention_trainable(*full, **kw)
        return jnp.sum(out * jnp.asarray(a["dout"]))

    jgrads = jax.grad(loss, argnums=tuple(range(len(diff))))(*[jx[i] for i in diff])
    dx, dqw, dqb, dpw, dpb, dbias = window_attention_fused_bwd_plain(
        port[0], T(a["dout"]), port[1], port[2], port[3], port[5], port[6], 1, 2, a["scale"])
    for name, g, w in zip(("dx", "dqkv_w", "dqkv_b", "dproj_w", "dproj_b", "dbias"),
                          (dx, dqw, dqb, dpw, dpb, dbias), jgrads):
        w = np.asarray(w, np.float64)
        err = float(np.abs(g.double().numpy() - w).max())
        assert err <= 1e-4 * float(np.abs(w).max()), (name, err)


@pytest.mark.parametrize("c, ch, dtype, body", [
    (193 + 15, 832, torch.bfloat16, "slab"), (256, 1024, torch.bfloat16, "slab"),
    (448, 1792, torch.bfloat16, "slab"), (896, 3584, torch.bfloat16, "slab"),
    (1024, 4096, torch.bfloat16, "slab"), (1040, 4160, torch.bfloat16, "tiles"),
    (896, 3584, torch.float32, "tiles"), (2048, 8192, torch.bfloat16, "tiles"),
    (456, 1824, torch.bfloat16, "tiles"), (256, 1000, torch.bfloat16, "tiles"),
    (192, 768, torch.bfloat16, "wgmma"), (192, 704, torch.bfloat16, "tiles"),
    (96, 320, torch.bfloat16, "tiles"),
])
def test_kernel_b_body_above_192(c, ch, dtype, body):
    """The slab body at bf16 C % 16 == 0, 192 < C <= 1024 and a hidden width
    divisible by 64; the CUDA-core body above 1024, off 16, in fp32 and at
    other hidden widths; at C <= 192 the route never gives the slab body a
    width (which it runs when forced): the wgmma body, else the CUDA-core
    body at a hidden width off 128."""
    assert mlp_fwd_body(c, ch, dtype) == body


# --- the instance tables against the sources ------------------------------------

def _table(text, name, fields):
    body = text[text.index(f"{name}[] = {{"):text.index("};", text.index(f"{name}[] = {{"))]
    pattern = r"\{" + ", ".join([r"(\d+)"] * fields) + r"\}"
    return tuple(tuple(int(v) for v in m) for m in re.findall(pattern, body))


def _consts(text, *names):
    return {n: int(re.search(rf"constexpr (?:int|size_t) {n} = (\d+);", text).group(1))
            for n in names}


def test_slab_instances_agree_with_the_source():
    """``MLP_SLAB_SHAPES`` is ``kMsShapes``; each instance holds its widest C
    in one consumer warpgroup with a two-stage ring within 227 KB, its
    accumulator at 128 registers a thread or fewer (slab / 2), and its
    hidden chunk divides the hidden multiple the body asks for.  The first
    instance also takes C = 16 .. 192 (forced, to be timed beside the wgmma
    body)."""
    text = (CSRC / "ln_mlp_slab.cu").read_text()
    assert _table(text, "kMsShapes", 3) == MLP_SLAB_SHAPES
    consts = _consts(text, "kMsRows", "kMsMaxStages", "kMsMinC", "kMsHidden")
    assert consts == {"kMsRows": 64, "kMsMaxStages": 4, "kMsMinC": MLP_SLAB_MIN_C,
                      "kMsHidden": 64}
    assert MLP_SLAB_MIN_C == 16
    prev = MLP_SLAB_MIN_C - 16
    for slab, chunk, max_c in MLP_SLAB_SHAPES:
        assert mlp_slab_shape(max_c) == (slab, chunk, max_c)
        assert mlp_slab_shape(prev + 16) == (slab, chunk, max_c)
        assert mlp_slab_smem_bytes(max_c, 1, 2) <= SMEM_LIMIT
        assert slab // 2 <= 128 and 64 % chunk == 0 and slab % 32 == 0
        prev = max_c
    assert mlp_slab_smem_bytes(256, 2, 2) == 64 + 2 * 2 * 64 * 256 + 2 * 2 * 64 * 512
    assert mlp_slab_shape(1040) is None and mlp_slab_shape(8) is None
    assert mlp_slab_shape(96) == mlp_slab_shape(192) == MLP_SLAB_SHAPES[0]
    assert mlp_slab_shape(200) is None  # (not a multiple of 16)


def test_cuda_core_tiles_agree_with_the_source():
    """The CUDA-core bodies' token counts: B's 32 tokens a block down to 1
    (C = 844, 1752, ... 28,992 the last widths of each), kernel 5's 16 down
    to 2 (C = 772, 1396, 2331, 3500), from the sources' constants."""
    fwd = _consts((CSRC / "ln_mlp.cu").read_text(), "kTokens")
    bwd = _consts((CSRC / "mlp_bwd.cuh").read_text(), "kMbThreads", "kMbTok", "kMbPad")
    assert fwd == {"kTokens": 32}
    assert bwd == {"kMbThreads": 128, "kMbTok": 16, "kMbPad": 4}
    assert [mlp_fwd_tokens(c) for c in (844, 845, 1752, 1753, 28992, 28993)] == [
        32, 16, 16, 8, 1, 0]
    assert [mlp_bwd_tokens(c) for c in (772, 773, 1396, 1397, 2331, 2332, 3500, 3501)] == [
        16, 8, 8, 4, 4, 2, 2, 0]
    assert mlp_bwd_tiles_smem_bytes(96) == 4 * (4 * 16 * 100 + 2 * 16 * 68 + 16 + 4 * 2 * 96)
    # rows of C = 18 padded to 20, then 4: the scalar loads read the zeros
    assert mlp_bwd_tiles_smem_bytes(18) == 4 * (4 * 16 * 24 + 2 * 16 * 68 + 16 + 4 * 2 * 18)
    with pytest.raises(NotImplementedError, match="shared memory"):
        mlp_fwd_body(28993, 4 * 28993, torch.float32)
    with pytest.raises(NotImplementedError, match="shared memory"):
        mlp_bwd_body(3501, 4 * 3501, torch.float32)


def _ca_smem(nt, parts, chunk, stages, split_):
    """csrc/cluster_mma.cu:ca_smem_bytes with the split's exchange buffers,
    plus the kernel's static arrays."""
    stride = 8 * nt + 4
    xbuf = 2 * 8 * (chunk // 2) * 16 if split_ else 0
    return (4 * (2 * 16 * (4 // parts) * stride + stages * (2 * chunk * stride + chunk) + xbuf)
            + 4 * (64 + 4) + 16 * stages)


@pytest.mark.parametrize("c, blocks, shape", [
    (768, 1, (96, 4, 16, 1)), (769, 2, (64, 4, 16, 2)), (896, 2, (64, 4, 16, 2)),
    (1024, 2, (64, 4, 16, 2)), (1025, 2, (96, 4, 16, 1)), (1536, 2, (96, 4, 16, 1)),
    (1537, 4, (64, 4, 16, 2)), (2048, 4, (64, 4, 16, 2)), (3072, 4, (96, 4, 16, 1)),
    (3073, 8, (64, 4, 16, 2)), (6144, 8, (96, 4, 16, 1)),
])
def test_cluster_split_by_width(c, blocks, shape):
    """Above 768 the fewest of 2, 4, 8 blocks whose slabs of ceil(C / blocks)
    channels fit 768, each on the first instance that holds its slab: the
    two widest (four warps a row tile), with the exchange buffers within
    227 KB."""
    assert cluster_assign_blocks(c) == blocks and cluster_assign_shape(c) == shape
    assert _ca_smem(*shape, blocks > 1) <= SMEM_LIMIT


def test_cluster_split_agrees_with_the_source():
    text = (CSRC / "cluster_mma.cu").read_text()
    assert _consts(text, "kCaMaxBlocks") == {"kCaMaxBlocks": CLUSTER_SPLITS[-1]}
    assert CLUSTER_SPLITS == (1, 2, 4, 8) and CLUSTER_BLOCK_C == 768
    assert CLUSTER_MAX_C == 6144
    assert "return 2 * (kCaThreads / kWarp) * (chunk / 2) * 16;" in text
    with pytest.raises(ValueError, match="6144"):
        cluster_assign_shape(6145)


# --- the slab body's layout ----------------------------------------------------

def slab_body_emulation(x, ln_s, ln_b, w1, b1, w2, b2):
    """Kernel B's slab body on the CPU in bf16's cast boundaries: the weights
    through ``pack_mlp_slabs`` as the kernel reads them (a chunk's W1 as
    [n / 8][k][n % 8], W2 per slab as [n / 8][k][n % 8], columns past C
    zero), each (token tile, slab) item's fc1 recomputed, fc2 summed chunk by
    chunk in fp32, b2 and the residual in fp32 for the slab's columns."""
    c, ch = w1.shape
    slab, chunk, _ = mlp_slab_shape(c)
    w1p, w2p = pack_mlp_slabs(w1, w2, slab, chunk)
    x32 = x.float()
    z = _ln_fast(x32, ln_s, ln_b).to(torch.bfloat16).float()
    y = torch.empty_like(x32)
    for s in range(w2p.shape[0]):
        acc = torch.zeros(x.shape[0], slab)
        for j in range(ch // chunk):
            w1c = w1p[j].view(chunk // 8, c, 8).permute(1, 0, 2).reshape(c, chunk).float()
            h = (z @ w1c + b1[j * chunk:(j + 1) * chunk]).to(torch.bfloat16).float()
            g = gelu_exact_f32(h).to(torch.bfloat16).float()
            w2c = w2p[s, j].view(slab // 8, chunk, 8).permute(1, 0, 2).reshape(chunk, slab)
            acc += g @ w2c.float()
        cols = slice(s * slab, min(c, (s + 1) * slab))
        n = cols.stop - cols.start
        y[:, cols] = x32[:, cols] + (acc[:, :n] + b2[cols])
    return y.to(torch.bfloat16)


@pytest.mark.parametrize("c", [96, 208, 384, 448])
def test_slab_layout_walked_as_the_kernel_walks_it(c):
    """C = 96 (forced: one slab of 256, 160 zero columns), 208 (one slab,
    48 zero columns), 384 (three of 128) and 448 (four, the last half
    zero): the packed layout read back as the
    kernel reads it gives the plain version's result to bf16 rounding (one
    rounding of the output; a flipped intermediate rounding may add one
    more)."""
    rng = np.random.RandomState(c)
    ch = 4 * c
    x = T(rng.randn(96, c).astype(np.float32)).to(torch.bfloat16)
    ln_s, ln_b = T(1 + 0.1 * rng.randn(c).astype(np.float32)), T(0.1 * rng.randn(c).astype(np.float32))
    w1 = T((rng.randn(c, ch) / c ** 0.5).astype(np.float32)).to(torch.bfloat16)
    w2 = T((rng.randn(ch, c) / ch ** 0.5).astype(np.float32)).to(torch.bfloat16)
    b1, b2 = T(0.1 * rng.randn(ch).astype(np.float32)), T(0.1 * rng.randn(c).astype(np.float32))
    got = slab_body_emulation(x, ln_s, ln_b, w1, b1, w2, b2).float()
    want = ln_mlp_plain(x, ln_s, ln_b, w1, b1, w2, b2).float()
    err = (got - want).abs()
    assert float((err / (2e-2 + 2e-2 * want.abs())).max()) <= 1.0
    assert float((err > 0).float().mean()) < 0.02


# --- kernel C's channel split ----------------------------------------------------

def cluster_assign_split_emulation(tokens, centers, alpha: float):
    """Kernel C above 768 on the CPU: the channels cut into slabs of
    ceil(C / blocks), each padded to its instance's channel tiles; per chunk
    every slab's partial cross products (``parts_product`` over its
    channels) and, once, its partial |x|^2 are summed in block order, then
    the online soft-assign of ``tests/test_torch_port_cluster_mma.py`` runs
    on the sums (two warps a row tile taking the halves of each 16-center
    chunk, merged at the end), each slab accumulating its own recon."""
    n, c = tokens.shape
    k = centers.shape[0]
    blocks = cluster_assign_blocks(c)
    tiles, _, chunk, _ = cluster_assign_shape(c)
    slab, cp, half = -(-c // blocks), 8 * tiles, chunk // 2
    kp = -(-k // KP_ALIGN) * KP_ALIGN
    xs, cs = [], []
    for b in range(blocks):
        lo, hi = b * slab, min(c, (b + 1) * slab)
        x = torch.zeros(n, cp)
        x[:, :hi - lo] = tokens[:, lo:hi]
        cen = torch.zeros(kp, cp)
        cen[:k, :hi - lo] = centers[:, lo:hi]
        xs.append(x)
        cs.append(cen)
    xsq = sum((x * x).sum(-1) for x in xs)  # block order
    csq = torch.zeros(kp)
    csq[:k] = (centers * centers).sum(-1)
    xsplit = [split(x, 3) for x in xs]
    csplit = [split(cen, 3) for cen in cs]
    perm = torch.cat([8 * j + K_PERM for j in range(half // 8)])
    inf = torch.tensor(float("inf"))

    def state(starts):
        m = torch.full((n,), float("inf"))
        arg = torch.zeros(n, dtype=torch.int32)
        s, q = torch.zeros(n), torch.zeros(n)
        acc = [torch.zeros(n, cp) for _ in range(blocks)]
        for k0 in starts:
            valid = torch.arange(k0, k0 + half) < k
            cross = sum(parts_product(*xsplit[b], csplit[b][0][k0:k0 + half],
                                      csplit[b][1][k0:k0 + half]) for b in range(blocks))
            d2 = (xsq[:, None] + csq[None, k0:k0 + half]) - 2.0 * cross
            d = torch.where(valid, torch.sqrt(d2.clamp_min(0.0)), inf)
            cmin, cidx = d.min(-1)
            better = cmin < m
            f = torch.where(better, torch.where(torch.isinf(m), torch.zeros(()),
                                                torch.exp(-alpha * (m - cmin))), torch.ones(()))
            m = torch.where(better, cmin, m)
            arg = torch.where(better, (cidx + k0).to(torch.int32), arg)
            s, q = s * f, q * (f * f)
            e = torch.where(valid, torch.exp(-alpha * (d - m[:, None])), torch.zeros(()))
            s = s + e.sum(-1)
            q = q + ((d.nan_to_num(posinf=0.0) * e) ** 2).sum(-1)
            es = split(e[:, perm], 3)
            for b in range(blocks):
                ch_, cl_ = csplit[b]
                acc[b] = acc[b] * f[:, None] + parts_product(
                    *es, ch_[k0:k0 + half][perm].T.contiguous(),
                    cl_[k0:k0 + half][perm].T.contiguous())
        return m, arg, s, q, acc

    m0, a0, s0, q0, r0 = state(range(0, kp, chunk))
    m1, a1, s1, q1, r1 = state(range(half, kp, chunk))
    labels = torch.where((m1 < m0) | ((m1 == m0) & (a1 < a0)), a1, a0)
    mm = torch.minimum(m0, m1)
    f0 = torch.where(torch.isinf(m0), torch.zeros(()), torch.exp(-alpha * (m0 - mm)))
    f1 = torch.where(torch.isinf(m1), torch.zeros(()), torch.exp(-alpha * (m1 - mm)))
    s = s0 * f0 + s1 * f1
    q = q0 * (f0 * f0) + q1 * (f1 * f1)
    recon = torch.cat([(r0[b] * f0[:, None] + r1[b] * f1[:, None])[:, :min(slab, c - b * slab)]
                       for b in range(blocks)], dim=1) * (1.0 / s)[:, None]
    return FusedClusterOut(recon=recon, labels=labels, loss_sq_sum=(q / (s * s)).sum())


@pytest.mark.parametrize("c", [896, 1536])
def test_cluster_split_emulation_matches_plain(c):
    """C = 896 (two blocks of 448 channels on the 64-tile instance) and 1536
    (two of 768 on the 96-tile one), K = 256, against the plain version at
    ``chip_smoke.py``'s bounds (recon, loss; labels wherever the top-2 gap
    is decided)."""
    x, cen = _inputs(128, c, 256, c)
    got = cluster_assign_split_emulation(T(x), T(cen), 16.0)
    _check(got, cluster_assign_plain(T(x), T(cen), 16.0), T(x), T(cen), all_labels=False)


# --- fused tiny models at embed_dim 448 and 18 ------------------------------------

SIZE = 56
MODELS = {  # name: (embed_dim, encoder heads, decoder heads)
    "embed448": (448, (14, 28), (28, 14)),
    "embed18": (18, (6, 12), (12, 6)),
}


def _configs(name):
    """(JAX, port) model configs: the tiny preset fused at the given width,
    one block a stage."""
    embed, enc, dec = MODELS[name]
    out = []
    for make in (jax_preset, preset):
        m = make("tiny").model
        out.append(dataclasses.replace(
            m, embed_dim=embed, encoder_heads=enc, decoder_heads=dec, encoder_depths=(1, 1),
            decoder_depths=(1, 1), predict=True, fused_attention=True, attn_kernel="fold",
            fused_cluster=make is preset,
            cluster=dataclasses.replace(m.cluster, space_size=SIZE // 8)))
    return out


_REFERENCES = {}


def _reference(name):
    """A seeded port model, its weights carried into the JAX variable tree,
    the clip, a probe of the recon, and the JAX model's outputs and
    parameter gradients."""
    if name not in _REFERENCES:
        jcfg, pcfg = _configs(name)
        model = VADModel(pcfg, torch.float32, torch.Generator().manual_seed(14))
        clip = np.random.RandomState(14).rand(1, 4, SIZE, SIZE, 3).astype(np.float32)
        probe = np.random.RandomState(15).randn(1, 1, SIZE, SIZE, 3).astype(np.float32)
        jm = JaxVADModel(config=jcfg)
        template = jax.eval_shape(jm.init, jax.random.key(0), jnp.asarray(clip))
        variables = unflatten_into(template, jax_from_state_dict(model.state_dict(),
                                                                 predict=True))
        extras = {k: v for k, v in variables.items() if k != "params"}

        def loss(params):
            o = jm.apply({"params": params, **extras}, jnp.asarray(clip))
            return jnp.sum(o.recon * probe) + o.cluster_loss + o.space_loss, o

        (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(variables["params"])
        _REFERENCES[name] = (model, clip, probe, out, state_dict_from_jax(
            flatten_state({"params": grads}), predict=True))
    return _REFERENCES[name]


def test_model_widths_reach_the_new_bodies():
    """``embed_dim`` 448 runs B at 448 and 896 on the slab body in bf16,
    kernel 5 at 448 on its slab body and at 896 on the CUDA-core body, and
    its feature head at 896 on two blocks a row tile; the Video Swin-B width
    (``embed_dim`` 128) runs kernel 5 at 128 on the narrow tensor-core body
    and at 256 on the slab body; ``embed_dim`` 18 runs kernel 5 at C = 18
    (scalar loads) and 36 on the CUDA-core body."""
    bf = torch.bfloat16
    assert [mlp_fwd_body(c, 4 * c, bf) for c in (448, 896)] == ["slab", "slab"]
    assert [mlp_bwd_body(c, 4 * c, bf) for c in (448, 896)] == ["slab", "tiles"]
    assert [mlp_bwd_body(c, 4 * c, bf) for c in (128, 256)] == ["mma", "slab"]
    assert [mlp_bwd_body(c, 4 * c, torch.float32) for c in (448, 256)] == ["tiles", "tiles"]
    assert cluster_assign_blocks(2 * 448) == 2
    assert [mlp_bwd_body(c, 4 * c, bf) for c in (18, 36)] == ["tiles", "tiles"]
    assert [mlp_bwd_body(c, 4 * c, torch.float32) for c in (18, 36)] == ["tiles", "tiles"]


def check_tiny_model_matches_jax(name):
    """Forward outputs and every parameter gradient of the model against the
    JAX model (recon atol 1e-4, cluster and space loss rtol 1e-4, hard
    labels identical, gradients within 2e-3 of the JAX gradient's largest
    entry).  (The ``embed_dim`` 448 model runs in
    ``tests/test_torch_port_widths.py``, beside the ``embed_dim`` 128 one:
    each JAX reference compiles for about half a minute, and the two files
    run on different workers.)"""
    model, clip, probe, want, want_grads = _reference(name)
    out = model(T(clip))
    assert out.recon.shape == (1, 1, SIZE, SIZE, 3)
    assert_outputs_match(type(out)(*(v.detach() if isinstance(v, torch.Tensor) else v
                                     for v in out)), want)
    ((out.recon * T(probe)).sum() + out.cluster_loss + out.space_loss).backward()
    got = {k: p.grad for k, p in model.named_parameters()}
    assert set(got) == set(want_grads)
    for k, w in want_grads.items():
        assert got[k] is not None, f"{k}: no gradient"
        scale = float(w.abs().max())
        err = float((got[k] - w).abs().max())
        assert err <= 1e-8 + 2e-3 * scale, f"{k}: max abs err {err} > 2e-3 * {scale}"


def test_embed18_model_matches_jax():
    check_tiny_model_matches_jax("embed18")
