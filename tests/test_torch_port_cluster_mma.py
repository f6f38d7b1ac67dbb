"""Kernel C's tensor-core arithmetic on the CPU (``csrc/cluster_mma.cu``).

The CUDA body runs only on the card (``chip_smoke.py`` phase 2 holds it
against its plain version).  What a CPU can check is its arithmetic:
``cluster_assign_tf32x3_emulation`` below does in torch what the body does,
step by step: tf32 rounding by bit masking, the hi/lo split of both operands
of both products, the channel padding, the chunks of centers (32, or 16 in
the instances above C = 384) split between two warps with product 2's
permuted k order, the online minimum / sum /
sum-of-squares / recon recurrence with its rescaling, and the merge of the
two warps' states.  It is held to the bounds ``chip_smoke.py`` holds the
kernel to, against the plain version and against the Pallas kernel in
interpret mode, and a single-TF32 variant is shown to miss them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse)
from vadcl_tpu.ops.pallas_cluster import fused_cluster_assign
from vadcl_tpu_torch.ops.cluster import cdist
from vadcl_tpu_torch.ops.cluster_kernels import (
    FusedClusterOut,
    cluster_assign_plain,
    cluster_assign_shape,
)

T = torch.from_numpy
KP_ALIGN = 32  # csrc/cluster_mma.cu:kCaKpAlign, centers padded to a multiple of it
CLUSTER_RTOL = 1e-4  # chip_smoke.py: recon and loss
RECON_ATOL = 1e-5  # chip_smoke.py: recon
LABEL_GAP = 1e-3  # chip_smoke.py: labels must agree where the top-2 gap exceeds it
# Product 2's k order inside each 8-center tile: A column t <-> center 2t,
# column t + 4 <-> center 2t + 1 (the product-1 accumulator's layout).
K_PERM = torch.tensor([0, 2, 4, 6, 1, 3, 5, 7])


def tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: round to 10 mantissa bits, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor, passes: int):
    hi = tf32(x)
    return hi, (tf32(x - hi) if passes == 3 else torch.zeros_like(x))


def parts_product(ah, al, bh, bl) -> torch.Tensor:
    """(ah + al) (M, k) . (bh + bl) (N, k)^T as the body's mma.sync passes: lo
    terms, then hi.hi, each product of two tf32 values exact in fp32, summed in
    fp32.  The terms accumulate in place (``addcmul_`` adds an exact product
    with one rounding, as ``+`` of the product does), so one M x N x k
    temporary serves all three."""
    terms = ah[:, None, :] * bl[None]
    terms.addcmul_(al[:, None, :], bh[None])
    terms.addcmul_(ah[:, None, :], bh[None])
    return terms.sum(-1)


def split_product(a, b, passes: int) -> torch.Tensor:
    """a (M, k) . b (N, k)^T as the body's passes (``parts_product``) on the
    splits of both operands."""
    return parts_product(*split(a, passes), *split(b, passes))


def _online_state(x, xsq, cen, csq, k, alpha, passes, starts, half):
    """One warp's online soft-assign over the centers at ``starts`` + 0 ..
    ``half`` - 1 of every chunk: (m, arg, s, Q, recon accumulator) per row.
    (The channel parts of a wide instance each run this same state and split
    only the recon's columns, so they change no value.)"""
    n, cp = x.shape
    m = torch.full((n,), float("inf"))
    arg = torch.zeros(n, dtype=torch.int32)
    s = torch.zeros(n)
    q = torch.zeros(n)
    acc = torch.zeros(n, cp)
    perm = torch.cat([8 * j + K_PERM for j in range(half // 8)])
    # the splits of the tokens and of every center, once per call
    xs, (ch, cl) = split(x, passes), split(cen, passes)
    for k0 in starts:
        valid = torch.arange(k0, k0 + half) < k
        d2 = (xsq[:, None] + csq[None, k0:k0 + half]) - 2.0 * parts_product(
            *xs, ch[k0:k0 + half], cl[k0:k0 + half])
        d = torch.where(valid, torch.sqrt(d2.clamp_min(0.0)), torch.tensor(float("inf")))
        cmin, cidx = d.min(-1)  # torch.min: the first index of the minimum
        better = cmin < m  # strictly smaller: an earlier chunk keeps a tie
        f = torch.where(better, torch.where(torch.isinf(m), torch.zeros(()),
                                            torch.exp(-alpha * (m - cmin))), torch.ones(()))
        m = torch.where(better, cmin, m)
        arg = torch.where(better, (cidx + k0).to(torch.int32), arg)
        s, q, acc = s * f, q * (f * f), acc * f[:, None]
        e = torch.where(valid, torch.exp(-alpha * (d - m[:, None])), torch.zeros(()))
        s = s + e.sum(-1)
        q = q + ((d.nan_to_num(posinf=0.0) * e) ** 2).sum(-1)
        acc = acc + parts_product(*split(e[:, perm], passes),
                                  ch[k0:k0 + half][perm].T.contiguous(),
                                  cl[k0:k0 + half][perm].T.contiguous())
    return m, arg, s, q, acc


def cluster_assign_tf32x3_emulation(tokens, centers, alpha: float, passes: int = 3):
    """Kernel C's body on the CPU: tokens (N, C), centers (K, C) fp32 ->
    recon, labels, loss_sq_sum.  Two warps share each row tile, one taking
    the first half of every chunk of centers (32 centers, or 16 in the
    instance of ``cluster_assign_shape``), the other the second; the second's
    state merges into the first's at the end.  ``passes=1`` keeps only
    hi.hi (one TF32 rounding of each operand)."""
    n, c = tokens.shape
    k = centers.shape[0]
    tiles, _, chunk, _ = cluster_assign_shape(c)
    cp, half = 8 * tiles, chunk // 2
    kp = -(-k // KP_ALIGN) * KP_ALIGN
    x = torch.zeros(n, cp)
    x[:, :c] = tokens
    cen = torch.zeros(kp, cp)
    cen[:k, :c] = centers
    xsq = (x * x).sum(-1)
    csq = (cen * cen).sum(-1)
    m0, a0, s0, q0, r0 = _online_state(x, xsq, cen, csq, k, alpha, passes,
                                       range(0, kp, chunk), half)
    m1, a1, s1, q1, r1 = _online_state(x, xsq, cen, csq, k, alpha, passes,
                                       range(half, kp, chunk), half)
    labels = torch.where((m1 < m0) | ((m1 == m0) & (a1 < a0)), a1, a0)
    mm = torch.minimum(m0, m1)
    f0 = torch.where(torch.isinf(m0), torch.zeros(()), torch.exp(-alpha * (m0 - mm)))
    f1 = torch.where(torch.isinf(m1), torch.zeros(()), torch.exp(-alpha * (m1 - mm)))
    s = s0 * f0 + s1 * f1
    q = q0 * (f0 * f0) + q1 * (f1 * f1)
    recon = (r0 * f0[:, None] + r1 * f1[:, None])[:, :c] * (1.0 / s)[:, None]
    return FusedClusterOut(recon=recon, labels=labels, loss_sq_sum=(q / (s * s)).sum())


def _inputs(n, c, k, seed):
    """Post-LayerNorm-like tokens and uniform centers, as chip_smoke.py draws them."""
    rng = np.random.RandomState(seed)
    return rng.randn(n, c).astype(np.float32), rng.rand(k, c).astype(np.float32)


def _worst(got, want, atol, rtol) -> float:
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


def _check(got, want, tokens, centers, all_labels: bool):
    assert _worst(got.recon, want.recon, RECON_ATOL, CLUSTER_RTOL) <= 1.0
    assert _worst(got.loss_sq_sum, want.loss_sq_sum, 0.0, CLUSTER_RTOL) <= 1.0
    agree = got.labels == want.labels
    if all_labels:
        assert bool(agree.all())
    else:
        top2 = cdist(tokens, centers).topk(2, dim=-1, largest=False).values
        decided = (top2[:, 1] - top2[:, 0]) > LABEL_GAP
        assert bool(agree[decided].all())
        assert int(decided.sum()) > 0.9 * len(decided)


def test_emulation_at_flagship_width_matches_plain_and_pallas():
    """C = 192, K = 1024 (the flagship feature head), 320 tokens."""
    x, cen = _inputs(320, 192, 1024, 0)
    got = cluster_assign_tf32x3_emulation(T(x), T(cen), 16.0)
    _check(got, cluster_assign_plain(T(x), T(cen), 16.0), T(x), T(cen), all_labels=False)
    pallas = fused_cluster_assign(jnp.asarray(x), jnp.asarray(cen), 16.0, True)
    want = FusedClusterOut(*(torch.tensor(np.asarray(v)) for v in pallas))
    _check(got, want, T(x), T(cen), all_labels=False)


@pytest.mark.parametrize(
    "n,c,k",
    [(200, 64, 16), (100, 30, 70), (196, 64, 16), (130, 96, 1000), (1, 30, 1), (77, 8, 33)],
    ids=["edge_200x64x16", "edge_100x30x70", "tiny_preset", "k_not_chunk", "n1_k1", "c8_k33"],
)
def test_emulation_at_edge_shapes(n, c, k):
    """The edge shapes of chip_smoke.py phase 2, the tiny preset's feature head
    (2 clips of 2 x 7 x 7 tokens of width 64, K = 16), K not a multiple of
    the chunk, and single tokens and centers: every label equal."""
    x, cen = _inputs(n, c, k, n + c + k)
    got = cluster_assign_tf32x3_emulation(T(x), T(cen), 16.0)
    _check(got, cluster_assign_plain(T(x), T(cen), 16.0), T(x), T(cen), all_labels=True)
    pallas = fused_cluster_assign(jnp.asarray(x), jnp.asarray(cen), 16.0, True)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(pallas.labels))


def test_first_occurrence_across_a_chunk_boundary():
    """A center duplicated at k = 5 and k = 900 (chunks 0 and 28): the label
    of a token sitting on it is 5.  One duplicated at k = 18 and 40 (the
    second warp's half of chunk 0, the first warp's of chunk 1): 18, the
    merge's tie.  A token whose minimum lies in the last chunk gets that late
    index."""
    x, cen = _inputs(64, 192, 1000, 7)
    cen[900] = cen[5]
    cen[40] = cen[18]
    x[0] = cen[5]
    x[1] = cen[997] + 1e-3
    x[2] = cen[40]
    for fn in (cluster_assign_tf32x3_emulation, cluster_assign_plain):
        out = fn(T(x), T(cen), 16.0)
        assert out.labels[:3].tolist() == [5, 997, 18]


def test_single_tf32_rounding_misses_the_recon_bound():
    """One TF32 pass (hi.hi only) is not the contract: the same inputs miss
    chip_smoke.py's recon bound, so the body needs the hi/lo split."""
    x, cen = _inputs(320, 192, 1024, 0)
    want = cluster_assign_plain(T(x), T(cen), 16.0)
    three = cluster_assign_tf32x3_emulation(T(x), T(cen), 16.0, passes=3)
    one = cluster_assign_tf32x3_emulation(T(x), T(cen), 16.0, passes=1)
    assert _worst(three.recon, want.recon, RECON_ATOL, CLUSTER_RTOL) <= 1.0
    assert _worst(one.recon, want.recon, RECON_ATOL, CLUSTER_RTOL) > 1.0


def test_tf32_rounding_matches_cvt_rna():
    """Nearest with ties away from zero at bit 13, carries into the exponent,
    negative values by magnitude."""
    vals = torch.tensor([1.0 + 2.0**-11, 1.0 + 3 * 2.0**-11, -(1.0 + 2.0**-11),
                         2.0 - 2.0**-12, 1.0 + 2.0**-11 - 2.0**-20], dtype=torch.float32)
    want = torch.tensor([1.0 + 2.0**-10, 1.0 + 2 * 2.0**-10, -(1.0 + 2.0**-10), 2.0, 1.0])
    assert torch.equal(tf32(vals), want)
    hi, lo = split(vals, 3)
    assert torch.equal(tf32(hi), hi) and torch.equal(tf32(lo), lo)
