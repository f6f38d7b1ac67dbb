"""Kernels 7 and 8 on the tensor-core bodies of kernels A and 6, on the CPU.

Where a window of at most 112 tokens at head width 16 or 32 (208 at 16) is
in bf16, the port's kernel 7 (``window_attention_fused``) runs kernel A's tensor-core body
and kernel 8 (``window_attention_fused_bwd``) kernel 6's, both without LN and
residual, on ``window_grid``'s view of the windows: ``(Bn / nW, 1, 1, nW * N,
C)`` cut by the window ``(1, 1, N)``.  The CUDA bodies run only on the card
(``chip_smoke.py`` holds them there against kernels 7's and 8's plain
versions and against the whole-tile bodies); here the view is held against
the plain versions of both pairs, bit for bit, and against the JAX kernels
(``_attn_kernel``, ``fused_window_attention_trainable``'s VJP) in interpret
mode within the bounds of ``tests/test_torch_port_window_attn.py``; the body
predicate is held at the flagship's geometries and at every window the
whole-tile body took; and the route's arguments to the two bodies are held
with the bodies replaced by their plain versions.
"""

import numpy as np
import pytest
import torch

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_port_window_attn import T, _case, _jax_forward, _jax_vjp, _opt, assert_rel
from vadcl_tpu.ops.pallas_attn import fused_window_attention
from vadcl_tpu_torch.ops import fold_attn, window_attn
from vadcl_tpu_torch.ops.fold_attn import (
    SMEM_LIMIT,
    _check_fold,
    fold_attention_bwd_plain,
    fold_attention_plain,
    fold_bwd_mma_smem_bytes,
    fold_smem_bytes,
)
from vadcl_tpu_torch.ops.window_attn import (
    tile_smem_bytes,
    window_attention_fused_bwd_plain,
    window_attention_fused_plain,
    window_body,
    window_grid,
    window_tile_core,
)

# (window, dims, C, nH): two clips' windows at the tiny widths, nW = 4
GEOMS = {"N98": ((2, 7, 7), (2, 14, 14), 32, 2), "N49": ((1, 7, 7), (1, 14, 14), 32, 2)}
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}
# the flagship's 4-frame blocks: (N, C, heads)
FLAGSHIP = {"enc_stage0": (98, 96, 6), "enc_stage1": (98, 192, 12),
            "dec_stage0": (49, 192, 12), "dec_stage1": (49, 96, 6)}
NAMES = ("dx", "dqkv_w", "dqkv_b", "dproj_w", "dproj_b", "dbias")


def _args(a, dtype):
    """Kernel 7's arguments after ``x``, as torch tensors."""
    return dict(qkv_w=T(a["qkv_w"]), qkv_b=_opt(a["qkv_b"], T), proj_w=T(a["proj_w"]),
                bias=T(a["bias"]), mask=_opt(a["mask"], T), num_heads=a["nH"],
                n_windows=a["nW"], scale=a["scale"])


def _fold_forward_on_view(x, proj_b, k):
    grid, window, shift = window_grid(x, k["mask"], k["n_windows"])
    out = fold_attention_plain(grid, None, None, k["qkv_w"], k["qkv_b"], k["proj_w"], proj_b,
                               k["bias"], k["mask"], k["num_heads"], window, k["scale"],
                               residual=False, shift=shift)
    assert out.shape == grid.shape
    return out.reshape(x.shape)


def _fold_backward_on_view(x, dout, k):
    grid, window, shift = window_grid(x, k["mask"], k["n_windows"])
    g = fold_attention_bwd_plain(grid, dout.reshape(grid.shape), None, None, k["qkv_w"],
                                 k["qkv_b"], k["proj_w"], k["bias"], k["mask"],
                                 k["num_heads"], window, k["scale"], shift, residual=False)
    assert g[1] is None and g[2] is None  # no LN gradients in this mode
    return (g[0].reshape(x.shape),) + g[3:]


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_window_grid_is_a_view_of_the_windows(masked):
    """Window ``w`` of batch element ``b`` of the view, partitioned as the
    fold kernels address it, is window ``b * nW + w``; the view shares the
    windows' memory; without a mask nW is 1, so any window count works."""
    from vadcl_tpu_torch.ops.window import window_partition

    a = _case(GEOMS["N98"], masked, seed=20)
    x = T(a["x"])
    grid, window, shift = window_grid(x, _opt(a["mask"], T), a["nW"])
    nw = a["nW"] if masked else 1
    assert grid.shape == (x.shape[0] // nw, 1, 1, nw * 98, 32)
    assert window == (1, 1, 98) and shift == (0, 0, 0)
    assert grid.data_ptr() == x.data_ptr()
    np.testing.assert_array_equal(window_partition(grid, window).numpy(), a["x"])
    odd = torch.zeros(6, 98, 32)  # 6 windows, not a multiple of nW = 4
    assert window_grid(odd, None, 4)[0].shape == (6, 1, 1, 98, 32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("qkv_bias", [True, False], ids=["qkv_bias", "no_qkv_bias"])
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("geom", GEOMS)
def test_fold_forward_on_the_view_equals_kernel_7(geom, masked, qkv_bias, dtype):
    """Kernel A's plain version without LN and residual on the view gives
    kernel 7's plain version bit for bit: the same products, casts and
    softmax on the same windows."""
    dt = DTYPES[dtype]
    a = _case(GEOMS[geom], masked, seed=21, qkv_bias=qkv_bias)
    x, k = T(a["x"]).to(dt), _args(a, dt)
    want = window_attention_fused_plain(x, proj_b=T(a["proj_b"]), **k)
    got = _fold_forward_on_view(x, T(a["proj_b"]), k)
    assert got.dtype == dt
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("qkv_bias", [True, False], ids=["qkv_bias", "no_qkv_bias"])
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("geom", GEOMS)
def test_fold_backward_on_the_view_equals_kernel_8(geom, masked, qkv_bias, dtype):
    """Kernel 6's plain version in its no-LN, no-residual mode on the view
    gives kernel 8's six gradients bit for bit."""
    dt = DTYPES[dtype]
    a = _case(GEOMS[geom], masked, seed=22, qkv_bias=qkv_bias)
    x, dout, k = T(a["x"]).to(dt), T(a["dout"]).to(dt), _args(a, dt)
    want = window_attention_fused_bwd_plain(x, dout, **k)
    got = _fold_backward_on_view(x, dout, k)
    assert len(got) == len(want) == 6
    for name, g, w in zip(NAMES, got, want):
        if w is None:
            assert g is None and name == "dqkv_b" and not qkv_bias
            continue
        assert g.dtype == w.dtype, name
        assert torch.equal(g, w), name


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("geom", GEOMS)
def test_fold_forward_on_the_view_matches_pallas(geom, masked, dtype):
    """The view through kernel A's plain version against
    ``fused_window_attention`` (kernel 7, ``_attn_kernel``) in interpret
    mode: fp32 rtol = atol = 2e-5, bf16 max|port - jax| <= 2e-2 max|jax|."""
    import jax.numpy as jnp

    dt = DTYPES[dtype]
    a = _case(GEOMS[geom], masked, seed=23)
    got = _fold_forward_on_view(T(a["x"]).to(dt), T(a["proj_b"]), _args(a, dt))
    if dt == torch.float32:
        want = np.asarray(_jax_forward(fused_window_attention, a))
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    else:
        want = _jax_forward(fused_window_attention, a, jnp.bfloat16)
        assert_rel("forward", got.float().numpy(), np.asarray(want.astype(jnp.float32)), 2e-2)


@pytest.mark.parametrize("qkv_bias", [True, False], ids=["qkv_bias", "no_qkv_bias"])
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("geom", GEOMS)
def test_fold_backward_on_the_view_matches_pallas_vjp(geom, masked, qkv_bias):
    """The view through kernel 6's plain version against ``jax.vjp`` of
    ``fused_window_attention_trainable`` (``_bwd_kernel`` in interpret mode),
    fp32, every gradient within 1e-4 of its largest value."""
    a = _case(GEOMS[geom], masked, seed=24, qkv_bias=qkv_bias)
    got = _fold_backward_on_view(T(a["x"]), T(a["dout"]), _args(a, torch.float32))
    want = _jax_vjp(a)
    assert (got[2] is None) == (not qkv_bias) and (want[2] is None) == (not qkv_bias)
    for name, g, w in zip(NAMES, got, want):
        if w is not None:
            assert_rel(name, g.numpy(), np.asarray(w), 1e-4)


@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
@pytest.mark.parametrize("geom", FLAGSHIP)
def test_flagship_windows_take_the_tensor_core_bodies_in_bf16(geom, backward):
    """Every 4-frame flagship block in bf16 runs kernels A's and 6's
    tensor-core bodies under ``base``; in fp32 the whole-tile bodies."""
    n, c, nh = FLAGSHIP[geom]
    assert window_body(n, c, nh, torch.bfloat16, backward) == "tile"
    assert window_tile_core(n, c, nh, torch.bfloat16, backward) == "fold_mma"
    assert window_tile_core(n, c, nh, torch.float32, backward) == "tile"
    x = torch.empty(4, n, c, dtype=torch.bfloat16, device="meta")
    assert window_attn._pick_body("k", None, x, nh, backward) == "fold_mma"
    # the packed forward (kernel 9) takes A's body too (the route of both names)
    assert window_attn.window_grid_route(n, c, nh, torch.bfloat16, packed=True)
    assert window_attn._pick_body("k", "tile", x, nh, backward) == "tile"


SWIN_B = {"C256_8heads": (98, 256, 8), "C256_8heads_N49": (49, 256, 8),
          "C128_4heads": (98, 128, 4)}  # the Video Swin-B width's attention geometries


@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
@pytest.mark.parametrize("geom", SWIN_B)
def test_swin_b_windows_take_the_tensor_core_bodies_in_bf16(geom, backward):
    """C = 256 with 8 heads (N = 98 and 49) and C = 128 with 4 heads take
    kernels A's and 6's tensor-core bodies in bf16 (their weight slices
    stream in depth chunks: A's block 207,488 and 229,504 B at C = 256, 6's
    224,640 and 153,728 B), ahead of the row-tiled body that the backward's
    whole tile would leave them to at N = 98; in fp32 the partitioned
    bodies."""
    n, c, nh = SWIN_B[geom]
    assert window_tile_core(n, c, nh, torch.bfloat16, backward) == "fold_mma"
    assert window_tile_core(n, c, nh, torch.float32, backward) == "tile"
    x = torch.empty(4, n, c, dtype=torch.bfloat16, device="meta")
    assert window_attn._pick_body("k", None, x, nh, backward) == "fold_mma"
    x32 = torch.empty(4, n, c, dtype=torch.float32, device="meta")
    assert (window_attn._pick_body("k", None, x32, nh, backward)
            == window_body(n, c, nh, torch.float32, backward))
    size = fold_bwd_mma_smem_bytes(n, c, nh) if backward else fold_smem_bytes(n, c, nh, True)
    assert size == {(98, 256, 8): (207488, 224640), (49, 256, 8): (229504, 153728),
                    (98, 128, 4): (150144, 182656)}[(n, c, nh)][backward] <= SMEM_LIMIT


# windows of 113-208 tokens at head width 16: the long layouts of A and 6
LONG = {"N113": (113, 96, 6), "N196": (196, 96, 6), "N196_C192": (196, 192, 12),
        "N208_C32": (208, 32, 2)}


@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
@pytest.mark.parametrize("geom", LONG)
def test_long_windows_take_the_tensor_core_bodies_in_bf16(geom, backward):
    """Windows of 113-208 tokens at head width 16 (8-frame clips' N = 196,
    and N = 113 that stayed on the whole tile before) take kernels A's and
    6's long layouts in bf16 on the view (208 rows, two strips a warp), their
    blocks within ``SMEM_LIMIT``; fp32 keeps the partitioned bodies."""
    n, c, nh = LONG[geom]
    assert window_tile_core(n, c, nh, torch.bfloat16, backward) == "fold_mma"
    assert window_tile_core(n, c, nh, torch.float32, backward) == "tile"
    x = torch.empty(4, n, c, dtype=torch.bfloat16, device="meta")
    assert window_attn._pick_body("k", None, x, nh, backward) == "fold_mma"
    x32 = torch.empty(4, n, c, dtype=torch.float32, device="meta")
    assert (window_attn._pick_body("k", None, x32, nh, backward)
            == window_body(n, c, nh, torch.float32, backward))
    size = fold_bwd_mma_smem_bytes(n, c, nh) if backward else fold_smem_bytes(n, c, nh, True)
    assert size <= SMEM_LIMIT and fold_attn.fold_padded_rows(n) == 208


@pytest.mark.parametrize("n,c,nh", [(98, 24, 2), (98, 48, 4), (49, 96, 2), (98, 192, 4),
                                    (113, 96, 3), (209, 96, 6)],
                         ids=["hd12_C24", "hd12_C48", "hd48", "hd48_C192", "N113_hd32",
                              "N209"])
def test_other_widths_keep_the_whole_tile_body(n, c, nh):
    """Head widths 12 and 48, windows above 112 tokens at head width 32 and
    above 208 at 16 stay on the partitioned bodies (the whole tile where it
    fits), in bf16 and in fp32, each direction; whole weight slices at C =
    256 with 8 heads would not fit A's block nor 6's (the depth chunks'
    reason)."""
    for dtype in (torch.bfloat16, torch.float32):
        for backward in (False, True):
            assert window_tile_core(n, c, nh, dtype, backward) == "tile"
            if window_body(n, c, nh, dtype, backward) == "tile":
                x = torch.empty(2, n, c, dtype=dtype, device="meta")
                assert window_attn._pick_body("k", None, x, nh, backward) == "tile"
    assert fold_attn._fold_fwd_mma_bytes(98, 256, 32, 1) == 260736 > SMEM_LIMIT
    assert fold_attn._fold_bwd_mma_bytes(98, 256, 32, 1) == 331136 > SMEM_LIMIT


WIDTHS = ((96, 6), (192, 12), (96, 3), (192, 6), (32, 2), (64, 4), (24, 2), (48, 4),
          (64, 1), (72, 6), (80, 1), (128, 4), (256, 8), (256, 16), (96, 2))


def test_every_window_the_whole_tile_body_took_still_maps_to_a_body():
    """Wherever the whole-tile body's block fitted (``tile_smem_bytes``, the
    parent's gate), the route still picks a body, and where it picks
    ``"fold_mma"`` the fold bodies' own checks (``_check_fold`` with the
    shared-memory mirrors of A's and 6's tensor-core bodies) take the view,
    so the launch is not refused; elsewhere the whole-tile body runs."""
    cases = folds = 0
    for c, nh in WIDTHS:
        for n in range(1, 150):
            for dtype in (torch.bfloat16, torch.float32):
                for backward in (False, True):
                    if tile_smem_bytes(n, c, nh, dtype == torch.bfloat16, backward) > SMEM_LIMIT:
                        continue
                    cases += 1
                    x = torch.empty(4, n, c, dtype=dtype, device="meta")
                    body = window_attn._pick_body("k", None, x, nh, backward)
                    assert body in ("fold_mma", "tile"), (n, c, nh, dtype, backward, body)
                    if body == "tile":
                        continue
                    folds += 1
                    mask = torch.empty(2, n, n, device="meta")
                    grid, window, _ = window_grid(x, mask, 2)
                    smem = ((lambda n_, c_, h_, _: fold_bwd_mma_smem_bytes(n_, c_, h_))
                            if backward else fold_smem_bytes)
                    _check_fold("k", grid, torch.empty(nh, n, n, device="meta"), mask, nh,
                                window, smem, register_scores=True)
    assert cases > 2000 and folds > 500


def test_the_route_hands_kernels_a_and_6_the_view(monkeypatch):
    """``_forward_cuda`` and ``_backward_cuda`` with the two bodies replaced
    by their plain versions (the only part of the route the CPU cannot run):
    each body gets the view without LN and residual, and its result comes
    back in kernel 7's and kernel 8's shapes, bit for bit their plain
    versions', counted on ``window_attention_fused`` and
    ``window_attention_fused_bwd``."""
    calls = []

    def fold_fwd(x, ln_s, ln_b, qkv_w, qkv_b, proj_w, proj_b, bias, mask, nh, window, scale,
                 residual, shift, packed=False, counter=None):
        assert ln_s is None and ln_b is None and not residual and not packed
        calls.append(("fwd", tuple(x.shape), window, shift))
        counter.launches += 1
        return fold_attention_plain(x, None, None, qkv_w, qkv_b, proj_w, proj_b, bias, mask,
                                    nh, window, scale, residual, shift)

    def fold_bwd(x, dout, ln_s, ln_b, qkv_w, qkv_b, proj_w, bias, mask, nh, window, scale,
                 shift, residual, counter=None):
        assert ln_s is None and ln_b is None and not residual
        calls.append(("bwd", tuple(x.shape), window, shift))
        counter.launches += 1
        return fold_attention_bwd_plain(x, dout, None, None, qkv_w, qkv_b, proj_w, bias, mask,
                                        nh, window, scale, shift, residual)

    monkeypatch.setattr(window_attn.cuda_lib, "library", lambda: None)
    monkeypatch.setattr(window_attn, "_fold_attention_cuda", fold_fwd)
    monkeypatch.setattr(window_attn, "_fold_attention_bwd_mma", fold_bwd)
    for k in (window_attn.window_attention_fused, window_attn.window_attention_fused_bwd):
        monkeypatch.setattr(k, "launches", 0)
    for masked in (False, True):
        a = _case(GEOMS["N98"], masked, seed=25)
        x, dout, k = T(a["x"]).bfloat16(), T(a["dout"]).bfloat16(), _args(a, torch.bfloat16)
        pos = (k["qkv_w"], k["qkv_b"], k["proj_w"])
        tail = (k["bias"], k["mask"], k["num_heads"], k["n_windows"], k["scale"])
        got = window_attn._forward_cuda("window_attention_fused", False, None, x, *pos,
                                        T(a["proj_b"]), *tail)
        assert torch.equal(got, window_attention_fused_plain(x, proj_b=T(a["proj_b"]), **k))
        grads = window_attn._backward_cuda(None, x, dout, *pos, *tail)
        want = window_attention_fused_bwd_plain(x, dout, **k)
        for name, g, w in zip(NAMES, grads, want):
            assert torch.equal(g, w), name
    nw = a["nW"]  # 4: unmasked the view takes one window a row, masked nW
    assert calls == [("fwd", (8, 1, 1, 98, 32), (1, 1, 98), (0, 0, 0)),
                     ("bwd", (8, 1, 1, 98, 32), (1, 1, 98), (0, 0, 0)),
                     ("fwd", (8 // nw, 1, 1, nw * 98, 32), (1, 1, 98), (0, 0, 0)),
                     ("bwd", (8 // nw, 1, 1, nw * 98, 32), (1, 1, 98), (0, 0, 0))]
    assert window_attn.window_attention_fused.launches == 2
    assert window_attn.window_attention_fused_bwd.launches == 2
