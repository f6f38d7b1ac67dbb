"""Kernel 9 on kernel A's packed tensor-core body, and the ``base`` and
``packed`` Swin blocks without partition copies, on the CPU.

Where a window of at most 112 tokens at head width 16 or 32 (208 at 16) is
in bf16, the port's kernel 9 (``window_attention_packed``) runs kernel A's ``packed``
tensor-core body (kernel 10's arithmetic) without LN and residual on
``window_grid``'s view of the windows, as kernel 7 runs A's plain one.  Where
kernels A's and 6's bodies take a block's geometry both ways
(``window_grid_route``), a ``base`` or ``packed`` block hands them its padded,
LN1'd tensor with the shift (``fold_attention`` or ``fold_attention_packed``
without LN and residual, counted on kernels 7's, 9's and 8's counters)
instead of rolling, partitioning, reversing and rolling back.  The CUDA bodies run only on the
card (``chip_smoke.py`` holds them there); here the view is held against
kernel 9's plain version bit for bit and against ``_attn_kernel_packed`` in
interpret mode within the bounds of ``tests/test_torch_port_window_attn.py``;
the unpartitioned block against the partitioned one bit for bit, forward and
gradients; the predicate at the flagship's geometries and at every window
the whole-tile body of 9 holds; and 9's route arguments with the body
replaced by its plain version.
"""

import numpy as np
import pytest
import torch

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_port_window_attn import T, _case, _jax_forward, assert_rel
from test_torch_port_window_fold_route import DTYPES, FLAGSHIP, GEOMS, WIDTHS, _args
from vadcl_tpu.ops.pallas_attn import fused_window_attention_packed
from vadcl_tpu_torch.models import swin
from vadcl_tpu_torch.models.layers import init_parameters
from vadcl_tpu_torch.ops import window_attn
from vadcl_tpu_torch.ops.fold_attn import (
    SMEM_LIMIT,
    _check_fold,
    fold_attention_packed_plain,
    fold_smem_bytes,
)
from vadcl_tpu_torch.ops.window_attn import (
    tile_smem_bytes,
    window_attention_packed_plain,
    window_body,
    window_grid,
    window_grid_route,
    window_tile_core,
)

NAMES = ("base", "packed")


def _packed_on_view(x, proj_b, k):
    grid, window, shift = window_grid(x, k["mask"], k["n_windows"])
    out = fold_attention_packed_plain(grid, None, None, k["qkv_w"], k["qkv_b"], k["proj_w"],
                                      proj_b, k["bias"], k["mask"], k["num_heads"], window,
                                      k["scale"], residual=False, shift=shift)
    assert out.shape == grid.shape
    return out.reshape(x.shape)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("qkv_bias", [True, False], ids=["qkv_bias", "no_qkv_bias"])
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("geom", GEOMS)
def test_packed_fold_forward_on_the_view_equals_kernel_9(geom, masked, qkv_bias, dtype):
    """Kernel 10's plain version without LN and residual on the view gives
    kernel 9's plain version bit for bit: q scaled before it rounds, the
    per-head row max, ``e * (1 / sum e)``, on the same windows."""
    dt = DTYPES[dtype]
    a = _case(GEOMS[geom], masked, seed=31, qkv_bias=qkv_bias)
    x, k = T(a["x"]).to(dt), _args(a, dt)
    want = window_attention_packed_plain(x, proj_b=T(a["proj_b"]), **k)
    got = _packed_on_view(x, T(a["proj_b"]), k)
    assert got.dtype == dt
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("geom", GEOMS)
def test_packed_view_matches_pallas(geom, masked, dtype):
    """The view through kernel 10's plain version against
    ``fused_window_attention_packed`` (kernel 9, ``_attn_kernel_packed``) in
    interpret mode: fp32 rtol = atol = 2e-5, bf16 max|port - jax| <= 2e-2
    max|jax|."""
    import jax.numpy as jnp

    dt = DTYPES[dtype]
    a = _case(GEOMS[geom], masked, seed=32)
    got = _packed_on_view(T(a["x"]).to(dt), T(a["proj_b"]), _args(a, dt))
    if dt == torch.float32:
        want = np.asarray(_jax_forward(fused_window_attention_packed, a))
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    else:
        want = _jax_forward(fused_window_attention_packed, a, jnp.bfloat16)
        assert_rel("forward", got.float().numpy(), np.asarray(want.astype(jnp.float32)), 2e-2)


# (input (B, D, H, W) at C = 32, 2 heads; configured window; configured shift)
BLOCKS = {"plain": ((2, 2, 14, 14), (2, 7, 7), (0, 0, 0)),
          "shifted": ((2, 2, 14, 14), (2, 7, 7), (1, 3, 3)),
          "padded_shifted": ((1, 2, 10, 12), (2, 7, 7), (1, 3, 3)),
          "padded_N49": ((2, 1, 9, 14), (1, 7, 7), (0, 3, 3))}


def _block(name, window, shift, seed):
    blk = swin.SwinBlock3D(32, 2, window, shift, fused=True, attn_kernel=name)
    gen = torch.Generator().manual_seed(seed)
    init_parameters(blk, gen)
    with torch.no_grad():  # non-zero biases and LN affine terms, so that none can drop out
        for p in (blk.attn.qkv_bias, blk.attn.proj_bias, blk.norm1.bias, blk.norm2.bias,
                  blk.mlp.fc1.bias, blk.mlp.fc2.bias):
            p.copy_(0.1 * torch.randn(p.shape, generator=gen))
        blk.norm1.weight.add_(0.1 * torch.randn(32, generator=gen))
    return blk


def _run(blk, x, backward):
    x = x.clone().requires_grad_(backward)
    out = blk(x)
    if not backward:
        return out, []
    probe = torch.randn(out.shape, generator=torch.Generator().manual_seed(7))
    (out.float() * probe).sum().backward()
    grads = [x.grad] + [p.grad for _, p in blk.named_parameters()]
    blk.zero_grad(set_to_none=True)
    return out, grads


@pytest.mark.parametrize("geometry", BLOCKS)
@pytest.mark.parametrize("name", NAMES)
def test_blocks_without_partition_copies_equal_the_partitioned_route(name, geometry,
                                                                     monkeypatch):
    """A bf16 ``base`` or ``packed`` block on the unpartitioned tensor (no
    roll, partition, reverse or roll back) against the same block forced
    down the partitioned route, bit for bit: the output and, under ``base``,
    the gradients of x and of every block parameter.  The unpartitioned
    branch calls ``window_partition`` no time, the partitioned one once."""
    (B, D, H, W), window, shift = BLOCKS[geometry]
    blk = _block(name, window, shift, seed=33)
    x = torch.randn(B, D, H, W, 32, generator=torch.Generator().manual_seed(34))
    x = x.to(torch.bfloat16)
    n = int(np.prod(swin.get_window_size((D, H, W), window, shift)[0]))
    assert window_grid_route(n, 32, 2, torch.bfloat16, name == "packed")
    partitions = []
    partition = swin.window_partition
    monkeypatch.setattr(swin, "window_partition",
                        lambda *a: partitions.append(1) or partition(*a))
    backward = name == "base"
    with torch.set_grad_enabled(backward):
        got, got_grads = _run(blk, x, backward)
        assert not partitions
        monkeypatch.setattr(swin, "window_grid_route", lambda *a, **k: False)
        want, want_grads = _run(blk, x, backward)
    assert len(partitions) == 1
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    assert len(got_grads) == len(want_grads)
    for (pname, _), g, w in zip([("x", None)] + list(blk.named_parameters()), got_grads,
                                want_grads):
        assert w is not None and g is not None, pname
        assert g.dtype == w.dtype and torch.equal(g, w), pname


def test_packed_grid_route_refuses_a_gradient():
    (B, D, H, W), window, shift = BLOCKS["shifted"]
    blk = _block("packed", window, shift, seed=35)
    x = torch.randn(B, D, H, W, 32).to(torch.bfloat16).requires_grad_()
    with pytest.raises(NotImplementedError, match="inference-only"):
        blk(x).float().sum().backward()


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("geom", FLAGSHIP)
def test_flagship_blocks_take_the_unpartitioned_route_in_bf16(geom, name):
    """Every 4-frame flagship block in bf16 takes the unpartitioned route
    under both names, and kernel 9 on the view takes A's packed body; in fp32
    neither."""
    n, c, nh = FLAGSHIP[geom]
    assert window_grid_route(n, c, nh, torch.bfloat16, name == "packed")
    assert not window_grid_route(n, c, nh, torch.float32, name == "packed")
    x = torch.empty(4, n, c, dtype=torch.bfloat16, device="meta")
    assert window_attn._pick_body("k", None, x, nh, False) == "fold_mma"
    assert window_attn._pick_body("k", "tile", x, nh, False) == "tile"


@pytest.mark.parametrize("packed", [False, True], ids=["base", "packed"])
@pytest.mark.parametrize("n,c,nh", [(98, 256, 8), (49, 256, 8), (98, 128, 4), (98, 192, 6)],
                         ids=["C256_8heads", "C256_8heads_N49", "C128_4heads", "C192_6heads"])
def test_swin_b_blocks_take_the_unpartitioned_route_in_bf16(n, c, nh, packed):
    """The Video Swin-B width's blocks (C = 256 with 8 heads, C = 128 with
    4) and C = 192 with 6 heads take the unpartitioned route in bf16 under
    both names, since A's and 6's weight slices stream in depth chunks (the
    backward's whole tile does not fit at N = 98, so before they took the
    row-tiled 8 on partitioned windows); in fp32 they partition."""
    assert window_grid_route(n, c, nh, torch.bfloat16, packed)
    assert not window_grid_route(n, c, nh, torch.float32, packed)
    x = torch.empty(4, n, c, dtype=torch.bfloat16, device="meta")
    for backward in (False,) if packed else (False, True):
        assert window_attn._pick_body("k", None, x, nh, backward) == "fold_mma"


@pytest.mark.parametrize("packed", [False, True], ids=["base", "packed"])
@pytest.mark.parametrize("n,c,nh", [(113, 96, 6), (196, 96, 6), (196, 192, 12), (208, 32, 2)],
                         ids=["N113", "N196", "N196_C192", "N208_C32"])
def test_long_windows_take_the_unpartitioned_route(n, c, nh, packed):
    """Windows of 113-208 tokens at head width 16 (8-frame reconstruction's
    encoder: N = 196 at C = 96 with 6 heads and C = 192 with 12) hand kernels
    A's and 6's long layouts the unpartitioned tensor in bf16; fp32 still
    partitions."""
    assert window_grid_route(n, c, nh, torch.bfloat16, packed)
    assert not window_grid_route(n, c, nh, torch.float32, packed)


@pytest.mark.parametrize("packed", [False, True], ids=["base", "packed"])
@pytest.mark.parametrize("n,c,nh", [(98, 24, 2), (98, 48, 4), (49, 96, 2), (98, 192, 4),
                                    (113, 96, 3), (196, 96, 3), (392, 96, 6), (392, 192, 12)],
                         ids=["hd12_C24", "hd12_C48", "hd48", "hd48_C192", "N113_hd32",
                              "N196_hd32", "N392", "N392_C192"])
def test_other_geometries_keep_the_partitioned_route(n, c, nh, packed):
    """Head widths 12 and 48, windows above 112 tokens at head width 32 and
    the 8-frame decoder's N = 392 partition their windows, in bf16 and in
    fp32."""
    for dtype in (torch.bfloat16, torch.float32):
        assert not window_grid_route(n, c, nh, dtype, packed)


def test_base_needs_both_directions(monkeypatch):
    """``base`` trains, so its route also asks kernel 6's body; ``packed``
    has no backward and asks only A's."""
    calls = []

    def core(n, c, nh, dtype, backward=False):
        calls.append(backward)
        return "fold_mma" if not backward else "tile"

    monkeypatch.setattr(window_attn, "window_tile_core", core)
    assert window_grid_route(98, 96, 6, torch.bfloat16, packed=True)
    assert calls == [False]
    assert not window_grid_route(98, 96, 6, torch.bfloat16, packed=False)
    assert calls == [False, False, True]


def test_every_window_the_whole_tile_9_holds_maps_to_a_body():
    """Wherever kernel 9's whole-tile body holds a window (``tile_smem_bytes``
    within ``SMEM_LIMIT``: every window it took before it had A's body beside
    it), the route picks a body: ``"fold_mma"``, where kernel A's checks with
    its shared-memory mirror take the view, or ``"tile"``."""
    cases = folds = 0
    for c, nh in WIDTHS:
        for n in range(1, 150):
            for dtype in (torch.bfloat16, torch.float32):
                if tile_smem_bytes(n, c, nh, dtype == torch.bfloat16) > SMEM_LIMIT:
                    continue
                cases += 1
                x = torch.empty(4, n, c, dtype=dtype, device="meta")
                body = window_attn._pick_body("k", None, x, nh, False)
                assert body in ("fold_mma", "tile"), (n, c, nh, dtype, body)
                assert window_body(n, c, nh, dtype) == "tile"
                if body == "tile":
                    continue
                folds += 1
                assert window_tile_core(n, c, nh, dtype) == "fold_mma"
                mask = torch.empty(2, n, n, device="meta")
                grid, window, _ = window_grid(x, mask, 2)
                _check_fold("k", grid, torch.empty(nh, n, n, device="meta"), mask, nh, window,
                            fold_smem_bytes, register_scores=True)
    assert cases > 1000 and folds > 250


def test_the_route_hands_kernel_9_the_view(monkeypatch):
    """``_forward_cuda`` for kernel 9 with A's body replaced by its plain
    version: the body gets the view without LN and residual and with
    ``packed``, and its result comes back in kernel 9's shape, bit for bit
    9's plain version's, counted on ``window_attention_packed``."""
    calls = []

    def fold_fwd(x, ln_s, ln_b, qkv_w, qkv_b, proj_w, proj_b, bias, mask, nh, window, scale,
                 residual, shift, packed=False, counter=None):
        assert ln_s is None and ln_b is None and not residual and packed
        calls.append((tuple(x.shape), window, shift))
        counter.launches += 1
        return fold_attention_packed_plain(x, None, None, qkv_w, qkv_b, proj_w, proj_b, bias,
                                           mask, nh, window, scale, residual, shift)

    monkeypatch.setattr(window_attn.cuda_lib, "library", lambda: None)
    monkeypatch.setattr(window_attn, "_fold_attention_cuda", fold_fwd)
    for k in (window_attn.window_attention_packed, window_attn.window_attention_packed_tiles):
        monkeypatch.setattr(k, "launches", 0)
    for masked in (False, True):
        a = _case(GEOMS["N49"], masked, seed=36)
        x, k = T(a["x"]).bfloat16(), _args(a, torch.bfloat16)
        got = window_attn._forward_cuda(
            "window_attention_packed", True, None, x, k["qkv_w"], k["qkv_b"], k["proj_w"],
            T(a["proj_b"]), k["bias"], k["mask"], k["num_heads"], k["n_windows"], k["scale"])
        assert torch.equal(got, window_attention_packed_plain(x, proj_b=T(a["proj_b"]), **k))
    nw = a["nW"]
    assert calls == [((8, 1, 1, 49, 32), (1, 1, 49), (0, 0, 0)),
                     ((8 // nw, 1, 1, nw * 49, 32), (1, 1, 49), (0, 0, 0))]
    assert window_attn.window_attention_packed.launches == 2
    assert window_attn.window_attention_packed_tiles.launches == 0


def test_fp32_and_bf16_models_partition_as_the_route_says(monkeypatch):
    """A fused tiny-width stage (C = 32, 2 heads, a plain and a shifted
    block): in bf16 under ``base`` and ``packed`` no ``window_partition``
    call, in fp32 one a block."""
    partitions = []
    partition = swin.window_partition
    monkeypatch.setattr(swin, "window_partition",
                        lambda *a: partitions.append(1) or partition(*a))
    x = torch.randn(1, 2, 14, 14, 32, generator=torch.Generator().manual_seed(37))
    for name in NAMES:
        stage = swin.SwinStage(32, 2, 2, (2, 7, 7), fused=True, attn_kernel=name)
        init_parameters(stage, torch.Generator().manual_seed(38))
        with torch.no_grad():
            for dtype, want in ((torch.bfloat16, 0), (torch.float32, 2)):
                partitions.clear()
                out = stage(x.to(dtype))
                assert out.dtype == dtype and bool(torch.isfinite(out.float()).all())
                assert len(partitions) == want, (name, dtype)
