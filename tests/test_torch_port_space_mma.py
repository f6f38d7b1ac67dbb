"""Kernel D's tensor-core arithmetic on the CPU (``csrc/space_cluster_mma.cu``).

The CUDA body runs only on the card (``chip_smoke.py`` phase 2 holds it
against its plain version).  What a CPU can check is its arithmetic:
``space_cluster_loss_tf32x3_emulation`` below does in torch what the body
does, step by step: tf32 rounding by bit masking (as the body's
``split_tf32`` rounds), the hi/lo split of both operands and the three tf32 products of
each ``wgmma`` k step, HW in zero-padded chunks of 32 accumulated in fp32,
|x|^2 and |c|^2 summed from the same chunks, a (m, s, Q) triple per row for
each warp's 16 centers, merged in warp order within a 128-center K tile and
online across K tiles, then row losses summed per block of rows.  It is held
to the bound ``chip_smoke.py`` holds the kernel to, against the plain version
and against the Pallas kernel in interpret mode, and a single-TF32 variant is
shown to lose the fp32-level accuracy that the split keeps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse)
from vadcl_tpu.ops.pallas_cluster import fused_space_cluster_loss
from vadcl_tpu_torch.ops.cluster_kernels import space_cluster_loss_plain

T = torch.from_numpy
CHUNK = 32  # csrc/space_cluster_mma.cu:kScChunk, HW values a ring stage
WARP_CENTERS = 16  # centers a warp takes
TILE = 128  # csrc/space_cluster_mma.cu:kScCenters, centers a K tile (8 warps)
MAX_ROWS = 64  # csrc/space_cluster_mma.cu:kScMaxRows, rows a block
CLUSTER_RTOL = 1e-4  # chip_smoke.py: loss
ALPHA = 32.0  # the space head's alpha (core/config.py)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: round to 10 mantissa bits, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor, passes: int):
    hi = tf32(x)
    return hi, (tf32(x - hi) if passes == 3 else torch.zeros_like(x))


def row_blocks(bd: int):
    """Blocks a channel takes and the rows each holds: BD split evenly over
    ceil(BD / 64) blocks (``sc_row_blocks``, ``sc_rows``)."""
    nb = -(-bd // MAX_ROWS)
    return nb, -(-bd // nb)


def _chunk_sums(v: torch.Tensor) -> torch.Tensor:
    """sum(v^2) over the last axis, chunk by chunk in fp32."""
    s = torch.zeros(v.shape[:-1])
    for c0 in range(0, v.shape[-1], CHUNK):
        s = s + (v[..., c0:c0 + CHUNK] ** 2).sum(-1)
    return s


def _chunk_products(x, c, passes: int) -> torch.Tensor:
    """x (Cc, R, HWp) . c (Cc, Kp, HWp)^T per channel as the body's mma passes:
    per chunk, the lo terms and then hi.hi (each product of two tf32 values
    exact in fp32), the chunks accumulated in order."""
    xh, xl = split(x, passes)
    ch, cl = split(c, passes)
    acc = torch.zeros(x.shape[0], x.shape[1], c.shape[1])
    for c0 in range(0, x.shape[-1], CHUNK):
        s = slice(c0, c0 + CHUNK)
        t = lambda a, b: a[..., s] @ b[..., s].transpose(1, 2)
        acc = acc + ((t(xh, cl) + t(xl, ch)) + t(xh, ch))
    return acc


def space_cluster_loss_tf32x3_emulation(maps, centers, alpha: float, passes: int = 3):
    """Kernel D's body on the CPU: maps (Cc, BD, HW), centers (Cc, K, HW)
    fp32 -> sum((d * assign)^2).  ``passes=1`` keeps only hi.hi (one TF32
    rounding of each operand)."""
    cc, bd, hw = maps.shape
    k = centers.shape[1]
    hwp = -(-hw // CHUNK) * CHUNK
    kp = -(-k // TILE) * TILE
    x = torch.zeros(cc, bd, hwp)
    x[..., :hw] = maps
    cen = torch.zeros(cc, kp, hwp)
    cen[:, :k, :hw] = centers
    d2 = (_chunk_sums(x)[..., None] + _chunk_sums(cen)[:, None, :]) - 2.0 * _chunk_products(
        x, cen, passes)
    d = torch.where(torch.arange(kp) < k, torch.sqrt(d2.clamp_min(0.0)), torch.tensor(float("inf")))
    # each warp's 16 centers -> (m, s, Q) per row; padded centers: e = 0
    dw = d.view(cc, bd, kp // WARP_CENTERS, WARP_CENTERS)
    m = dw.amin(-1)
    valid = torch.isfinite(dw)
    e = torch.where(valid, torch.exp(-alpha * (dw - m[..., None])), torch.zeros(()))
    s = e.sum(-1)
    q = ((torch.where(valid, dw, torch.zeros(())) * e) ** 2).sum(-1)
    # one thread per row merges the active warps in order, online over K tiles
    run_m = torch.full((cc, bd), float("inf"))
    run_s = torch.zeros(cc, bd)
    run_q = torch.zeros(cc, bd)
    warps = TILE // WARP_CENTERS
    for w0 in range(0, kp // WARP_CENTERS, warps):
        active = [w for w in range(w0, w0 + warps) if WARP_CENTERS * w < k]
        mm = run_m
        for w in active:
            mm = torch.minimum(mm, m[..., w])
        f = torch.where(torch.isinf(run_m), torch.zeros(()), torch.exp(-alpha * (run_m - mm)))
        run_s, run_q = run_s * f, run_q * (f * f)
        for w in active:
            fw = torch.exp(-alpha * (m[..., w] - mm))
            run_s = run_s + s[..., w] * fw
            run_q = run_q + q[..., w] * (fw * fw)
        run_m = mm
    row_loss = run_q / (run_s * run_s)
    nb, rows = row_blocks(bd)
    partials = [row_loss[c, b * rows:(b + 1) * rows].sum() for c in range(cc) for b in range(nb)]
    return torch.stack(partials).sum()


def loss_fp64(maps, centers, alpha: float) -> float:
    """The loss in float64 (cdist's expanded form), the yardstick of accuracy."""
    x, c = maps.double(), centers.double()
    d2 = (x * x).sum(-1, keepdim=True) + (c * c).sum(-1)[:, None, :] - 2.0 * x @ c.transpose(1, 2)
    d = d2.clamp_min(0.0).sqrt()
    a = torch.softmax(-alpha * (d - d.amin(-1, keepdim=True)), -1)
    return float(((d * a) ** 2).sum())


def _inputs(cc, bd, k, hw, seed):
    """Post-LayerNorm-like maps and uniform centers, as chip_smoke.py and the
    model's init draw them."""
    rng = np.random.RandomState(seed)
    return rng.randn(cc, bd, hw).astype(np.float32), rng.rand(cc, k, hw).astype(np.float32)


def _rel(got, want) -> float:
    return abs(float(got) - float(want)) / abs(float(want))


def _check(maps, centers, pallas: bool = True):
    got = space_cluster_loss_tf32x3_emulation(T(maps), T(centers), ALPHA)
    assert _rel(got, space_cluster_loss_plain(T(maps), T(centers), ALPHA)) <= CLUSTER_RTOL
    if pallas:
        want = fused_space_cluster_loss(jnp.asarray(maps), jnp.asarray(centers), ALPHA, True)
        assert _rel(got, np.asarray(want)) <= CLUSTER_RTOL


def test_emulation_at_flagship_width_matches_plain_and_pallas():
    """HW = 28^2, K = 128 (the flagship space head), BD = 32 (the scoring
    batch of 16 clips of 2 frames), four channels."""
    _check(*_inputs(4, 32, 128, 784, 0))


@pytest.mark.parametrize(
    "cc,bd,k,hw",
    [(3, 1, 128, 784), (3, 17, 128, 784), (2, 130, 128, 196), (4, 8, 1, 784),
     (4, 3, 8, 49), (3, 8, 130, 784), (2, 8, 1000, 196), (3, 8, 128, 785)],
    ids=["bd1", "bd17", "bd130_three_blocks", "k1", "tiny_preset", "k130_two_tiles",
         "k1000", "hw785"],
)
def test_emulation_at_edge_shapes(cc, bd, k, hw):
    """The edge shapes of chip_smoke.py phase 2: single rows, rows that fill
    no whole 16-row tile, more rows than one block holds, a single center
    (seven idle warps), the tiny preset's head (7^2 maps, K = 8), K past one
    tile (the online merge across tiles) and HW off the 32-value chunk."""
    _check(*_inputs(cc, bd, k, hw, cc + bd + k + hw))


def test_a_row_equal_to_a_center():
    """d = 0 through the clamp (|x|^2 + |c|^2 - 2 x.c may round below zero):
    the row's minimum is 0 and every other center's weight vanishes."""
    maps, centers = _inputs(3, 8, 128, 784, 5)
    maps[1, 4] = centers[1, 77]
    got = space_cluster_loss_tf32x3_emulation(T(maps), T(centers), ALPHA)
    assert _rel(got, space_cluster_loss_plain(T(maps), T(centers), ALPHA)) <= CLUSTER_RTOL
    assert _rel(got, loss_fp64(T(maps), T(centers), ALPHA)) <= 2e-6


def test_row_blocks_split_rows_evenly():
    """BD <= 64 is one block a channel; beyond, the rows split evenly."""
    assert [row_blocks(bd) for bd in (1, 8, 32, 64, 65, 130, 192)] == [
        (1, 1), (1, 8), (1, 32), (1, 64), (2, 33), (3, 44), (3, 64)]


@pytest.mark.parametrize("bd", [8, 32])
def test_split_keeps_fp32_accuracy_and_one_pass_does_not(bd):
    """Against a float64 loss, 3xTF32 stays within 2e-6 relative at the
    training (BD 8) and scoring (BD 32) batches; one TF32 pass (hi.hi only)
    does not, which is why the body splits both operands."""
    maps, centers = _inputs(16, bd, 128, 784, bd)
    want = loss_fp64(T(maps), T(centers), ALPHA)
    three = space_cluster_loss_tf32x3_emulation(T(maps), T(centers), ALPHA, passes=3)
    one = space_cluster_loss_tf32x3_emulation(T(maps), T(centers), ALPHA, passes=1)
    assert _rel(three, want) <= 2e-6
    assert _rel(one, want) > 2e-6
