"""Swin blocks at the Video Swin-B width in bf16 take kernels A and 6, against
the JAX block on the CPU.

The Video Swin-B width (``embed_dim`` 128, heads (4, 8) / (8, 4)) has blocks
at C = 256 with 8 heads (N = 98 in encoder stage 1, 49 in decoder stage 0)
and C = 128 with 4 heads (N = 98 in encoder stage 0).  The JAX package's
fold gate looks at memory only, so its ``fold`` block runs ``_fold_kernel``
and ``_fold_bwd_kernel`` there.  The port's bf16 tensor-core bodies of A and
6 take these geometries since their weight slices stream through the ring in
depth chunks (``ops/fold_attn.py:fold_depth_chunks``): a ``fold`` block runs
``fold_attention`` and its backward ``fold_attention_bwd`` (6's tensor-core
body), and a ``base`` block runs kernels 7 and 8 on those bodies through the
unpartitioned route (``window_grid_route``), counted on 7's and 8's counters.

On the CPU every wrapper runs its plain version (the CUDA bodies run on the
card, where ``chip_smoke.py:phase_kernels`` holds them against these plain
versions at the Swin-B-width shapes).  The JAX block runs its Pallas kernels
in interpret mode: ``_fold_kernel`` / ``_fold_bwd_kernel`` under ``fold``,
``_attn_kernel`` / ``_bwd_kernel`` under ``base`` (its call site passes no
``interpret``, so the test hands the block's module a copy of
``fused_window_attention_trainable`` that does), and the MLP kernels.

Bounds (``tests/test_torch_port_bf16_widths.py``'s): the forward within
2e-2 of max|jax| (both round at the same casts; another fp32 summation order
can flip one bf16 rounding), every gradient within 2e-2 of the JAX
gradient's largest entry (``chip_smoke.py:BWD_TOL``).

The depth-chunked accumulation itself is emulated in
``test_depth_chunks_keep_the_whole_slice_sums``: the ring's items as the
producer issues them from the flat pack, and the consumers' 16-row mma
steps over a slice's chunks, give the whole-slice products bit for bit
(one fp32 accumulator walked in the same order), and both lie within fp32
rounding of a float64 product: 1e-6 of the largest |product| (about 2^-20:
C / 16 fp32 additions of 16-term partial sums).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vadcl_tpu.models.swin as jax_swin
from test_torch_port_fold_models import ROUTE_FNS, _spy
from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_port_window_attn import assert_rel
from vadcl_tpu.models.swin import SwinBlock3D as JaxSwinBlock3D
from vadcl_tpu.train.checkpoint import flatten_state
from vadcl_tpu_torch.convert import state_dict_from_jax
from vadcl_tpu_torch.models import swin
from vadcl_tpu_torch.ops import fold_attn
from vadcl_tpu_torch.ops.fold_attn import (
    SMEM_LIMIT,
    fold_bwd_body,
    fold_bwd_mma_smem_bytes,
    fold_depth_chunks,
    fold_fits,
    fold_smem_bytes,
    pack_fold_weights,
)
from vadcl_tpu_torch.ops.window_attn import window_grid_route, window_tile_core

BF16 = torch.bfloat16
TOL = 2e-2  # forward: of max|jax|; each gradient: of its largest JAX entry
# name: (C, heads, window, (D, H, W)): the Swin-B width's three attention
# geometries, at 4 windows a clip
GEOMS = {
    "C256_8heads_N98": (256, 8, (2, 7, 7), (2, 14, 14)),
    "C256_8heads_N49": (256, 8, (1, 7, 7), (1, 14, 14)),
    "C128_4heads_N98": (128, 4, (2, 7, 7), (2, 14, 14)),
}
SHIFT = (0, 3, 3)


def _blocks(geom, shifted, attn_kernel, seed=5):
    """The JAX block, its variables (random bias table and biases, so that a
    dropped term shows) and the port block carrying the same weights."""
    C, nh, window, dhw = GEOMS[geom]
    shift = SHIFT if shifted else (0, 0, 0)
    jblk = JaxSwinBlock3D(C, nh, window, shift, fused=True, attn_kernel=attn_kernel,
                          dtype=jnp.bfloat16)
    x = jnp.zeros((1, *dhw, C), jnp.bfloat16)
    params = jax.jit(jblk.init)(jax.random.key(seed), x)["params"]
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map_with_path(  # biases and the rel-pos table at unit scale
        lambda path, p: (jnp.asarray(rng.randn(*p.shape), p.dtype)
                         if _random_leaf(jax.tree_util.keystr(path)) else p), params)
    block = swin.SwinBlock3D(C, nh, window, shift, fused=True, attn_kernel=attn_kernel)
    sd = state_dict_from_jax(flatten_state({"params": params}), predict=True)
    block.load_state_dict(sd, strict=True)
    return jblk, params, block


def _random_leaf(path: str) -> bool:
    return "relative_position_bias_table" in path or path.endswith("bias']")


def _inputs(geom, seed=6):
    C, _, _, dhw = GEOMS[geom]
    rng = np.random.RandomState(seed)
    x = rng.randn(1, *dhw, C).astype(np.float32)
    dout = rng.randn(1, *dhw, C).astype(np.float32)
    return x, dout


def _jax_run(jblk, params, x, dout):
    x = jnp.asarray(x, jnp.bfloat16)
    out, vjp = jax.vjp(lambda p, xx: jblk.apply({"params": p}, xx), params, x)
    gp, gx = vjp(jnp.asarray(dout, jnp.bfloat16))
    return out, gp, gx


def _spy_backward(monkeypatch):
    """The backward entries ``_FoldAttention`` takes, with the counter each
    launch would count on."""
    seen = []
    real_bwd, real_windows = fold_attn.fold_attention_bwd, fold_attn._fold_bwd_through_windows

    def bwd(*a, counter=None, **k):
        seen.append(("fold_attention_bwd", getattr(counter, "__name__", None)))
        return real_bwd(*a, counter=counter, **k)

    def windows(*a, **k):
        seen.append(("kernel 8, LN1 replayed", None))
        return real_windows(*a, **k)

    monkeypatch.setattr(fold_attn, "fold_attention_bwd", bwd)
    monkeypatch.setattr(fold_attn, "_fold_bwd_through_windows", windows)
    return seen


@pytest.mark.parametrize("attn_kernel", ["fold", "base"])
@pytest.mark.parametrize("shifted", [False, True], ids=["unshifted", "shifted"])
@pytest.mark.parametrize("geom", GEOMS)
def test_swin_b_block_takes_a_and_6_and_matches_jax(monkeypatch, geom, shifted, attn_kernel):
    """The block's route (A's and 6's tensor-core bodies, under ``base``
    counted on 7's and 8's counters) and its forward and every gradient
    against the JAX block in bf16."""
    C, nh, window, _ = GEOMS[geom]
    n = window[0] * window[1] * window[2]
    assert fold_fits(n, C, nh, BF16) and fold_bwd_body(n, C, nh, BF16) == "mma"
    assert window_grid_route(n, C, nh, BF16) and window_grid_route(n, C, nh, BF16, True)
    jblk, params, block = _blocks(geom, shifted, attn_kernel)
    x, dout = _inputs(geom)
    trainable = jax_swin.fused_window_attention_trainable
    monkeypatch.setattr(jax_swin, "fused_window_attention_trainable",
                        lambda *a: trainable(*a, True))  # interpret=True
    seen = _spy(monkeypatch, *ROUTE_FNS)
    seen_bwd = _spy_backward(monkeypatch)
    xt = torch.from_numpy(x).to(BF16).requires_grad_()
    out = block(xt)
    assert seen == ["fold_attention", "ln_mlp"]
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


# --- the depth-chunked ring, emulated -------------------------------------------


def _ring(pack, nh, chunks, backward):
    """The ring's items in the order the producer warp issues them
    (``fold_attn_mma.cuh``: item i is elements ``i * kc * ldw ..`` of the
    flat pack; ``fold_attn_bwd_mma.cu``: per head slice h's chunks, then head
    h's rows of every W_proj slice, with one chunk in the same stage; then
    the slices' chunks again for dxa), each as the stage's rows."""
    npack, C, ldw = pack.shape
    hd, kc = C // nh, C // chunks
    flat = pack.reshape(-1)
    if not backward:
        for i in range(npack * chunks):
            yield flat[i * kc * ldw:(i + 1) * kc * ldw].view(kc, ldw)
        return

    def proj_rows(h):
        return torch.cat([flat[((nh + j) * C + h * hd) * ldw:((nh + j) * C + h * hd + hd) * ldw]
                          .view(hd, ldw) for j in range(npack - nh)])

    for pass_ in (0, 1):
        for h in range(nh):
            for k in range(chunks):
                item = flat[(h * C + k * kc) * ldw:(h * C + (k + 1) * kc) * ldw].view(kc, ldw)
                yield torch.cat([item, proj_rows(h)]) if pass_ == 0 and chunks == 1 else item
            if pass_ == 0 and chunks > 1:
                yield proj_rows(h)


def _mma(acc, a, b):
    """``acc += a . b`` as the bodies' mma.sync steps walk it: 16 of the
    depth at a time, each step's exact products summed, added to the fp32
    accumulator in depth order."""
    for k0 in range(0, a.shape[1], 16):
        acc = acc + (a[:, k0:k0 + 16].double() @ b[k0:k0 + 16].double()).float()
    return acc


def _fwd_walk(xs, os, pack, nh, chunks):
    """Kernel A's products for one warp's 16 rows: per head q | k | v of the
    LN1 rows ``xs``, then the projection of the pre-projection rows ``os``,
    each slice's chunks from the ring in turn."""
    C = xs.shape[1]
    hd, kc, npc = C // nh, C // chunks, pack.shape[0] - nh
    items = _ring(pack, nh, chunks, False)
    qkv, proj = [], []
    for rows, out, count in ((xs, qkv, nh), (os, proj, npc)):
        for _ in range(count):
            acc = torch.zeros(16, 3 * hd)
            for k in range(chunks):
                acc = _mma(acc, rows[:, k * kc:(k + 1) * kc], next(items)[:, :3 * hd].float())
            out.append(acc)
    assert next(items, None) is None
    return torch.cat(qkv, 1), torch.cat(proj, 1)[:, :C]


def _bwd_walk(rows, dout, dqkv, pack, nh, chunks):
    """Kernel 6's weight products for one warp's 16 rows: per head q | k | v
    and doa = dout . W_proj[head rows]^T (``projp``'s 16-column steps, each
    from piece c0 / 3hd), then dxa = round(dqkv) . W_qkv^T, chunk k giving
    columns k C / chunks .., summed over the heads in order."""
    C = rows.shape[1]
    hd, kc, w = C // nh, C // chunks, 3 * (C // nh)
    items = _ring(pack, nh, chunks, True)
    qkv, doa = [], []
    for h in range(nh):
        acc = torch.zeros(16, w)
        for k in range(chunks):
            item = next(items).float()
            acc = _mma(acc, rows[:, k * kc:(k + 1) * kc], item[:kc, :w])
        qkv.append(acc)
        projp = item[C:] if chunks == 1 else next(items).float()
        da = torch.zeros(16, hd)
        for c0 in range(0, C, 16):
            piece = projp[(c0 // w) * hd:(c0 // w + 1) * hd, c0 % w:c0 % w + 16]
            da = _mma(da, dout[:, c0:c0 + 16], piece.t())
        doa.append(da)
    dxa = torch.zeros(16, C)
    for h in range(nh):
        a = dqkv[:, [j * C + h * hd + d for j in range(3) for d in range(hd)]]
        for k in range(chunks):
            item = next(items).float()
            cols = slice(k * kc, (k + 1) * kc)
            dxa[:, cols] = _mma(dxa[:, cols], a, item[:, :w].t())
    assert next(items, None) is None
    return torch.cat(qkv, 1), torch.cat(doa, 1), dxa


def _rel_err(got, want):
    return float((got.double() - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("C, nh", [(256, 8), (256, 16), (240, 15), (128, 4)],
                         ids=["C256_8heads", "C256_16heads", "C240_15heads", "C128_4heads"])
def test_depth_chunks_keep_the_whole_slice_sums(C, nh):
    """The ring walk of A's and 6's weight products with the slices in
    depth chunks (every count that cuts C into 16-row multiples, 1 to 4)
    gives the whole-slice walk's bits, and both lie within 1e-6 of the
    float64 products (the module's bound)."""
    gen = torch.Generator().manual_seed(40)
    bf = lambda *s, k=1.0: (torch.randn(*s, generator=gen) * k).to(BF16).float()  # noqa: E731
    qkv_w, proj_w = bf(C, 3 * C, k=C ** -0.5), bf(C, C, k=C ** -0.5)  # exactly bf16
    pack = pack_fold_weights(qkv_w, proj_w, nh)
    xs, os, dout, dqkv = bf(16, C), bf(16, C), bf(16, C), bf(16, 3 * C)
    hd = C // nh
    heads = [j * C + h * hd + d for h in range(nh) for j in range(3) for d in range(hd)]
    want_qkv, want_proj = xs.double() @ qkv_w[:, heads].double(), os.double() @ proj_w.double()
    want_doa = dout.double() @ proj_w.double().t()
    want_dxa = dqkv.double() @ qkv_w.double().t()
    whole = _fwd_walk(xs, os, pack, nh, 1), _bwd_walk(xs, dout, dqkv, pack, nh, 1)
    for got, want in zip(whole[0] + whole[1], (want_qkv, want_proj, want_qkv, want_doa,
                                               want_dxa)):
        assert _rel_err(got, want) <= 1e-6
    counts = [k for k in (2, 3, 4) if C % (16 * k) == 0]
    assert counts
    for chunks in counts:
        got = _fwd_walk(xs, os, pack, nh, chunks), _bwd_walk(xs, dout, dqkv, pack, nh, chunks)
        for g, w in zip(got[0] + got[1], whole[0] + whole[1]):
            assert torch.equal(g, w), chunks


# --- the layouts and the routes at the four geometries ----------------------------

# (n, C, heads): (A's block, A's chunks, 6's block, 6's chunks); whole slices
# took 150,144 / 260,736 / 282,752 / 205,440 B for A and 235,904 / 331,136 /
# 246,912 / 276,864 B for 6
LAYOUTS = {
    (98, 128, 4): (150144, 1, 182656, 2),
    (98, 256, 8): (207488, 2, 224640, 4),
    (49, 256, 8): (229504, 2, 153728, 2),
    (98, 192, 6): (205440, 1, 210304, 2),
}


@pytest.mark.parametrize("geom", LAYOUTS, ids=[f"N{n}_C{c}_{h}heads" for n, c, h in LAYOUTS])
def test_chunked_layouts_and_routes(geom):
    """The exact bytes of A's and 6's blocks (``chip_smoke.py`` phase 1
    holds them against the library), in bf16 the fold route and the
    unpartitioned ``base`` / ``packed`` route at each geometry, and in fp32
    every answer as before chunking (fp32 keeps its own bodies)."""
    n, c, nh = geom
    fa, fa_k, fb, fb_k = LAYOUTS[geom]
    assert fold_smem_bytes(n, c, nh, True) == fa and fold_depth_chunks(n, c, nh) == fa_k
    assert fold_bwd_mma_smem_bytes(n, c, nh) == fb
    assert fold_depth_chunks(n, c, nh, backward=True) == fb_k
    assert max(fa, fb) <= SMEM_LIMIT
    assert fold_fits(n, c, nh, BF16) and fold_bwd_body(n, c, nh, BF16) == "mma"
    for backward in (False, True):
        assert window_tile_core(n, c, nh, BF16, backward) == "fold_mma"
        assert window_tile_core(n, c, nh, torch.float32, backward) == "tile"
    assert window_grid_route(n, c, nh, BF16) and window_grid_route(n, c, nh, BF16, True)
    assert not window_grid_route(n, c, nh, torch.float32)
    # fp32: the shared-memory bodies as before (A's 278,712 B at (98, 256, 8))
    assert fold_fits(n, c, nh, torch.float32) == (fold_smem_bytes(n, c, nh, False) <= SMEM_LIMIT)
    assert fold_smem_bytes(98, 256, 8, False) == 278712
