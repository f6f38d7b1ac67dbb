"""Kernel 6's head groups: a window's heads split over a thread-block cluster.

Where windows are fewer than the card's SMs, kernel 6's depth-chunked and
long layouts (``csrc/fold_attn_bwd_mma.cu``, the ``kGrouped`` instances)
run a window as a cluster of G blocks: rank g takes heads g nH / G ..
(g + 1) nH / G - 1, sums its heads' dxa into fp32 rows of its own shared
memory, and after a cluster barrier sums the ranks' rows r = g, g + G, .. of
every strip in rank order before the LN vjp.  ``ops/fold_attn.py:
fold_bwd_head_groups`` picks G and ``fold_bwd_blocks`` mirrors the launch's
block count.  The kernel runs only on the card (``chip_smoke.py`` holds it
against its plain version there, with G = 1 forced beside it); here:

* the choice at the training-batch shapes of the 8-frame, Video Swin-B-width
  and flagship paths, and over every geometry ``fold_bwd_body`` gives the
  tensor-core body, where no route answer moved (``fold_bwd_body`` and
  ``fold_fits`` counted over the sweep) and the block keeps its bytes;
* the grouped dxa sum and the rank-order reduction emulated from kernel A's
  pack as the ring streams it: one group gives the head-order walk's bits,
  and 2, 3 or 4 groups lie within 1e-6 of the float64 product (about 2^-20:
  another order of fp32 additions of exact bf16 products).
"""

import pytest
import torch

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse)
from vadcl_tpu_torch.ops.fold_attn import (
    FOLD_BWD_BLOCKS,
    FOLD_BWD_MAX_GROUPS,
    SMEM_LIMIT,
    _fold_bwd_mma_bytes,
    fold_bwd_blocks,
    fold_bwd_body,
    fold_bwd_head_groups,
    fold_bwd_mma_smem_bytes,
    fold_depth_chunks,
    fold_fits,
    fold_padded_rows,
    pack_fold_weights,
)

BF16 = torch.bfloat16

# path, stage: (clip (D, H, W, C) at the training batch of 4, heads, window,
# the head groups, the blocks of the launch)
TRAINING_SHAPES = {
    ("8-frame reconstruction", "encoder stage 0"): ((4, 56, 56, 96), 6, (4, 7, 7), 1, 128),
    ("8-frame reconstruction", "encoder stage 1"): ((4, 28, 28, 192), 12, (4, 7, 7), 2, 128),
    ("Video Swin-B width", "encoder stage 0"): ((2, 56, 56, 128), 4, (2, 7, 7), 1, 128),
    ("Video Swin-B width", "encoder stage 1"): ((2, 28, 28, 256), 8, (2, 7, 7), 2, 128),
    ("Video Swin-B width", "decoder stage 0"): ((1, 28, 28, 256), 8, (1, 7, 7), 2, 128),
    ("Video Swin-B width", "decoder stage 1"): ((1, 56, 56, 128), 4, (1, 7, 7), 1, 128),
    ("flagship", "encoder stage 0"): ((2, 56, 56, 96), 6, (2, 7, 7), 1, 128),
    ("flagship", "encoder stage 1"): ((2, 28, 28, 192), 12, (2, 7, 7), 1, 64),
    ("flagship", "decoder stage 0"): ((1, 28, 28, 192), 12, (1, 7, 7), 1, 64),
    ("flagship", "decoder stage 1"): ((1, 56, 56, 96), 6, (1, 7, 7), 1, 128),
}
BATCH = 4


@pytest.mark.parametrize("path", TRAINING_SHAPES, ids=[f"{p}, {s}" for p, s in TRAINING_SHAPES])
def test_head_groups_at_the_training_shapes(path):
    """G and the blocks of kernel 6's launch where a batch-4 step runs it:
    two groups at the 64-window stages of the depth-chunked and long
    layouts (128 blocks), one where 256 windows fill the card and at the
    flagship's 64-window stages (the whole-slice instances)."""
    (D, H, W, C), nh, window, groups, blocks = TRAINING_SHAPES[path]
    n = window[0] * window[1] * window[2]
    windows = BATCH * (D // window[0]) * (H // window[1]) * (W // window[2])
    assert fold_bwd_body(n, C, nh, BF16) == "mma"
    assert fold_bwd_head_groups(windows, n, C, nh) == groups
    assert fold_bwd_blocks(windows, groups) == blocks
    whole_slice = (fold_padded_rows(n) < 208
                   and fold_depth_chunks(n, C, nh, backward=True) == 1)
    if windows >= FOLD_BWD_BLOCKS or whole_slice:
        assert groups == 1


def _sweep():
    """(n, C, heads) over n = 1 .. 214 and C a multiple of 16 up to 272, at
    head widths 16, 32 and 48 (or one head): the tensor-core body's
    geometries and those next to them."""
    for c in range(16, 273, 16):
        for nh in sorted({c // 16, c // 32, max(c // 48, 1)} - {0}):
            if c % nh == 0:
                for n in range(1, 215):
                    yield n, c, nh


# Over _sweep, as the parent tree (before head groups) answers: fold_bwd_body's
# count of each answer and the sum of n + 1000 C + 10^6 heads over the
# geometries of each, and fold_fits' count of True backward then forward,
# bf16 then fp32
ROUTE_COUNTS = {"mma": 4128, "tiles": 784, None: 3434}
ROUTE_SUMS = {"mma": 31634046992, "tiles": 3358114824, None: 15861983379}
FITS = (4912, 4302, 3856, 4697)


def test_head_groups_over_every_tensor_core_geometry():
    """Over every geometry the tensor-core body takes and window counts from
    1 to 300: G divides nH, is at most 8, keeps G x windows within the
    card's SMs where it is above 1, is 1 on the whole-slice instances, and
    the blocks count clusters of G; the block keeps the layout's exact
    bytes (``fb_block_layout``) within ``SMEM_LIMIT``.  The routes did not
    move: ``fold_bwd_body`` and ``fold_fits`` give the counts they gave."""
    routes, sums, fits, checked = dict.fromkeys(ROUTE_COUNTS, 0), dict.fromkeys(ROUTE_SUMS, 0), \
        [0, 0, 0, 0], 0
    for n, c, nh in _sweep():
        body = fold_bwd_body(n, c, nh, BF16)
        routes[body] += 1
        sums[body] += n + 1000 * c + 1000000 * nh
        for i, (dtype, backward) in enumerate(((BF16, True), (torch.float32, True),
                                               (BF16, False), (torch.float32, False))):
            fits[i] += fold_fits(n, c, nh, dtype, backward=backward)
        if body != "mma":
            continue
        chunks = fold_depth_chunks(n, c, nh, backward=True)
        assert fold_bwd_mma_smem_bytes(n, c, nh) == _fold_bwd_mma_bytes(n, c, c // nh, chunks)
        assert fold_bwd_mma_smem_bytes(n, c, nh) <= SMEM_LIMIT
        whole_slice = fold_padded_rows(n) < 208 and chunks == 1
        for windows in (1, 2, 3, 7, 16, 33, 64, 66, 67, 100, 131, 132, 133, 256, 300):
            g = fold_bwd_head_groups(windows, n, c, nh)
            assert 1 <= g <= FOLD_BWD_MAX_GROUPS and nh % g == 0
            if g > 1:
                assert windows * g <= FOLD_BWD_BLOCKS and not whole_slice
                assert fold_bwd_blocks(windows, g) == windows * g  # one window a cluster
                # the largest such divisor
                assert not any(nh % h == 0 and windows * h <= FOLD_BWD_BLOCKS
                               for h in range(g + 1, FOLD_BWD_MAX_GROUPS + 1))
            if whole_slice or windows >= FOLD_BWD_BLOCKS:
                assert g == 1
            blocks = fold_bwd_blocks(windows, g)
            assert blocks % g == 0 and blocks <= max(FOLD_BWD_BLOCKS, windows * g)
            checked += 1
    assert routes == ROUTE_COUNTS and sums == ROUTE_SUMS
    assert tuple(fits) == FITS
    assert checked == 15 * ROUTE_COUNTS["mma"]


# --- the grouped dxa sum, emulated ------------------------------------------------


def _mma(acc, a, b):
    """``acc += a . b`` as the bodies' mma.sync steps walk it: 16 of the
    depth at a time, each step's exact products summed, added to the fp32
    accumulator in depth order."""
    for k0 in range(0, a.shape[1], 16):
        acc = acc + (a[:, k0:k0 + 16].double() @ b[k0:k0 + 16].double()).float()
    return acc


def _dxa_items(pack, nh, chunks, h0, h1):
    """The dxa pass of a head group's ring (``fb_produce``'s second pass for
    heads h0 .. h1 - 1): per head, slice h's depth chunks of kernel A's
    flat pack, each as the stage's rows."""
    npack, C, ldw = pack.shape
    kc, flat = C // chunks, pack.reshape(-1)
    for h in range(h0, h1):
        for k in range(chunks):
            yield flat[(h * C + k * kc) * ldw:(h * C + (k + 1) * kc) * ldw].view(kc, ldw)


def _group_dxa(dqkv, pack, nh, chunks, h0, h1):
    """One rank's dxa rows: zeros, then its heads' round(dqkv) . W_qkv^T in
    head order, chunk k giving the columns k C / chunks .."""
    C = dqkv.shape[1] // 3
    hd, kc = C // nh, C // chunks
    items = _dxa_items(pack, nh, chunks, h0, h1)
    dxa = torch.zeros(dqkv.shape[0], C)
    for h in range(h0, h1):
        a = dqkv[:, [j * C + h * hd + d for j in range(3) for d in range(hd)]]
        for k in range(chunks):
            cols = slice(k * kc, (k + 1) * kc)
            dxa[:, cols] = _mma(dxa[:, cols], a, next(items)[:, :3 * hd].float().t())
    assert next(items, None) is None
    return dxa


def _grouped_dxa(dqkv, pack, nh, chunks, groups):
    """The rows the LN vjp reads with ``groups`` head groups: each rank's
    partial rows (``_group_dxa``), then row r of a strip owned by rank r %
    groups and summed there over the ranks in rank order (``fb_sum_ranks``);
    every row is owned once."""
    parts = [_group_dxa(dqkv, pack, nh, chunks, g * nh // groups, (g + 1) * nh // groups)
             for g in range(groups)]
    owned = [[r for r in range(16) if r % groups == g] for g in range(groups)]
    assert sorted(sum(owned, [])) == list(range(16))  # every strip row summed by one rank
    out = parts[0]
    for part in parts[1:]:  # rank order, whichever rank owns the row
        out = out + part
    return out


def _head_order_walk(dqkv, qkv_w, nh):
    """One block a window (G = 1), as the body had it: dxa over all heads in
    order, whole slices, straight from W_qkv (no pack)."""
    C = qkv_w.shape[0]
    hd = C // nh
    dxa = torch.zeros(dqkv.shape[0], C)
    for h in range(nh):
        cols = [j * C + h * hd + d for j in range(3) for d in range(hd)]
        dxa = _mma(dxa, dqkv[:, cols], qkv_w[:, cols].t())
    return dxa


@pytest.mark.parametrize("C, nh, groups", [(192, 12, 1), (192, 12, 2), (192, 12, 3),
                                           (192, 12, 4), (256, 8, 1), (256, 8, 2),
                                           (256, 8, 4), (96, 6, 3)],
                         ids=lambda v: str(v))
def test_head_groups_keep_the_dxa_sums(C, nh, groups):
    """The grouped dxa rows of a 32-row window (two strips) from the ring of
    each rank, at every depth-chunk count that cuts C into 16-row multiples:
    one group gives the head-order walk's bits, more lie within 1e-6 of the
    float64 product; the heads' dqkv columns split disjointly over the
    ranks."""
    gen = torch.Generator().manual_seed(27)
    bf = lambda *s, k=1.0: (torch.randn(*s, generator=gen) * k).to(BF16).float()  # noqa: E731
    qkv_w, proj_w = bf(C, 3 * C, k=C ** -0.5), bf(C, C, k=C ** -0.5)  # exactly bf16
    pack = pack_fold_weights(qkv_w, proj_w, nh)
    dqkv = bf(32, 3 * C)
    want = dqkv.double() @ qkv_w.double().t()
    walk = _head_order_walk(dqkv, qkv_w, nh)
    hd = C // nh
    columns = [{j * C + h * hd + d for h in range(g * nh // groups, (g + 1) * nh // groups)
                for j in range(3) for d in range(hd)} for g in range(groups)]
    assert set().union(*columns) == set(range(3 * C))
    assert sum(len(c) for c in columns) == 3 * C
    for chunks in [1] + [k for k in (2, 3, 4) if C % (16 * k) == 0]:
        got = _grouped_dxa(dqkv, pack, nh, chunks, groups)
        if groups == 1:
            assert torch.equal(got, walk), chunks
        rel = float((got.double() - want).abs().max() / want.abs().max())
        assert rel <= 1e-6, (chunks, rel)
