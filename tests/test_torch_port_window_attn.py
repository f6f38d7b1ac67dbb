"""Kernels 7, 8 and 9 of the port (``vadcl_tpu_torch/ops/window_attn.py``)
and kernel 6's no-LN / no-residual mode against the JAX package, on the CPU.

On the CPU each wrapper runs its plain PyTorch version (the CUDA kernels run
only on the card, where ``chip_smoke.py`` phases 2 and 2b hold them against
these same plain versions).  The JAX functions run their Pallas kernels in
interpret mode, as ``tests/test_pallas_attn.py`` does.  Inputs come from a
numpy RandomState and go to both packages unchanged; the rel-pos bias is
drawn at unit scale so that a dropped or transposed bias cannot pass.

Bounds: forward fp32 rtol = atol = 2e-5 (``tests/test_pallas_attn.py``);
forward bf16 max|port - jax| <= 2e-2 * max|jax| (both round at the same
casts; a different fp32 summation order can flip one bf16 rounding);
gradients max|port - jax| <= 1e-4 * max|jax| per tensor (fp32, summation
order only).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse)
from vadcl_tpu.ops.pallas_attn import fused_window_attention, fused_window_attention_packed
from vadcl_tpu.ops.pallas_attn_bwd import fused_window_attention_trainable
from vadcl_tpu.ops.pallas_attn_fold import folded_window_attention_trainable
from vadcl_tpu.ops.window import compute_attn_mask
from vadcl_tpu_torch import ops
from vadcl_tpu_torch.ops import KERNELS, fold_attn
from vadcl_tpu_torch.ops.fold_attn import (
    fold_attention,
    fold_attention_bwd,
    fold_attention_bwd_plain,
    fold_fits,
    fold_smem_bytes,
)
from vadcl_tpu_torch.ops.window import window_partition, window_reverse
from vadcl_tpu_torch.ops.window_attn import (
    window_attention_fused,
    window_attention_fused_bwd,
    window_attention_fused_bwd_tiles,
    window_attention_fused_plain,
    window_attention_fused_tiles,
    window_attention_packed,
    window_attention_packed_tiles,
    window_body,
)

T = torch.from_numpy
IMPLS = {"base": (window_attention_fused, fused_window_attention),
         "packed": (window_attention_packed, fused_window_attention_packed)}
# (window, dims, C, nH): the geometries of tests/test_pallas_attn.py
GEOMS = {"N98_C48": ((2, 7, 7), (2, 28, 28), 48, 4), "N49_C24": ((1, 7, 7), (1, 14, 14), 24, 2)}
WIN_NAMES = ("dx", "dqkv_w", "dqkv_b", "dproj_w", "dproj_b", "dbias")


def assert_rel(name, got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = float(np.max(np.abs(want)))
    err = float(np.max(np.abs(got - want)))
    assert scale > 0, name
    assert err <= tol * scale, f"{name}: max abs err {err} > {tol} * {scale}"


def _case(geom, shifted, seed=0, batch=2, qkv_bias=True):
    ws, (D, H, W), C, nH = geom
    N = ws[0] * ws[1] * ws[2]
    nW = (D // ws[0]) * (H // ws[1]) * (W // ws[2])
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    mask = compute_attn_mask(D, H, W, ws, tuple(w // 2 for w in ws)) if shifted else None
    return dict(
        x=f(batch * nW, N, C), qkv_w=f(C, 3 * C) / np.sqrt(C),
        qkv_b=0.1 * f(3 * C) if qkv_bias else None, proj_w=f(C, C) / np.sqrt(C),
        proj_b=0.1 * f(C), bias=f(nH, N, N), mask=mask, dout=f(batch * nW, N, C),
        nH=nH, nW=nW, scale=(C // nH) ** -0.5,
    )


def _opt(a, conv, dtype=None):
    if a is None:
        return None
    return conv(a) if dtype is None else conv(a).to(dtype)


def _port_forward(fn, a, dtype=torch.float32):
    return fn(T(a["x"]).to(dtype), T(a["qkv_w"]), _opt(a["qkv_b"], T), T(a["proj_w"]),
              T(a["proj_b"]), T(a["bias"]), _opt(a["mask"], T), a["nH"], a["nW"], a["scale"])


def _jax_forward(fn, a, dtype=jnp.float32):
    return fn(jnp.asarray(a["x"], dtype), jnp.asarray(a["qkv_w"]), _opt(a["qkv_b"], jnp.asarray),
              jnp.asarray(a["proj_w"]), jnp.asarray(a["proj_b"]), jnp.asarray(a["bias"]),
              _opt(a["mask"], jnp.asarray), num_heads=a["nH"], n_windows=a["nW"],
              scale=a["scale"], interpret=True)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("shifted", [False, True], ids=["unshifted", "shifted"])
@pytest.mark.parametrize("geom", GEOMS)
def test_window_attention_matches_pallas_fp32(geom, shifted, impl):
    """Kernels 7 and 9 (plain versions) against ``fused_window_attention`` /
    ``fused_window_attention_packed`` in interpret mode.  Shifted, two
    images' windows share the masks: window i takes ``mask[i % nW]``."""
    port, ref = IMPLS[impl]
    a = _case(GEOMS[geom], shifted)
    got = _port_forward(port, a).numpy()
    np.testing.assert_allclose(got, np.asarray(_jax_forward(ref, a)), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("shifted", [False, True], ids=["unshifted", "shifted"])
def test_window_attention_matches_pallas_bf16(shifted, impl):
    port, ref = IMPLS[impl]
    a = _case(((2, 7, 7), (2, 14, 14), 32, 2), shifted, seed=1)
    got = _port_forward(port, a, torch.bfloat16)
    want = _jax_forward(ref, a, jnp.bfloat16)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert_rel(impl, got.float().numpy(), np.asarray(want.astype(jnp.float32)), 2e-2)


@pytest.mark.parametrize("impl", IMPLS)
def test_window_attention_without_qkv_bias(impl):
    port, ref = IMPLS[impl]
    a = _case(((2, 7, 7), (2, 14, 14), 24, 4), False, seed=2, qkv_bias=False)
    got = _port_forward(port, a).numpy()
    np.testing.assert_allclose(got, np.asarray(_jax_forward(ref, a)), rtol=2e-5, atol=2e-5)


def test_packed_differs_from_base_only_by_rounding():
    """In fp32 kernels 7 and 9 are the same function up to rounding; in bf16
    they differ by the ulp of q the early scale moves."""
    a = _case(GEOMS["N98_C48"], True, seed=3)
    base, packed = (_port_forward(f, a).numpy() for f in (window_attention_fused,
                                                          window_attention_packed))
    np.testing.assert_allclose(packed, base, rtol=2e-5, atol=2e-5)


def _jax_vjp(a):
    args = [_opt(a[k], jnp.asarray) for k in ("x", "qkv_w", "qkv_b", "proj_w", "proj_b", "bias")]
    mask = _opt(a["mask"], jnp.asarray)
    _, vjp = jax.vjp(
        lambda x, qw, qb, pw, pb, b: fused_window_attention_trainable(
            x, qw, qb, pw, pb, b, mask, a["nH"], a["nW"], a["scale"], True),
        *args)
    dx, dqw, dqb, dpw, dpb, dbias = vjp(jnp.asarray(a["dout"]))
    return dx, dqw, dqb, dpw, dpb, dbias


@pytest.mark.parametrize("qkv_bias", [True, False], ids=["qkv_bias", "no_qkv_bias"])
@pytest.mark.parametrize("shifted", [False, True], ids=["unshifted", "shifted"])
@pytest.mark.parametrize("geom", GEOMS)
def test_window_attention_bwd_matches_pallas_vjp(geom, shifted, qkv_bias):
    """Kernel 8's plain version against ``jax.vjp`` of
    ``fused_window_attention_trainable`` (``_bwd_kernel`` in interpret mode),
    every output held separately, d(bias) included."""
    a = _case(GEOMS[geom], shifted, seed=4, qkv_bias=qkv_bias)
    got = window_attention_fused_bwd(
        T(a["x"]), T(a["dout"]), T(a["qkv_w"]), _opt(a["qkv_b"], T), T(a["proj_w"]),
        T(a["bias"]), _opt(a["mask"], T), a["nH"], a["nW"], a["scale"])
    want = _jax_vjp(a)
    assert (got[2] is None) == (not qkv_bias) and (want[2] is None) == (not qkv_bias)
    for name, g, w in zip(WIN_NAMES, got, want):
        if w is not None:
            assert_rel(name, g.numpy(), np.asarray(w), 1e-4)


@pytest.mark.parametrize("shifted", [False, True], ids=["unshifted", "shifted"])
def test_window_attention_function_matches_autograd_of_plain(shifted):
    """The autograd Function (forward kernel 7, backward kernel 8) against
    ``torch.autograd.grad`` through the plain forward, fp32."""
    a = _case(GEOMS["N49_C24"], shifted, seed=5)
    names = ("x", "qkv_w", "qkv_b", "proj_w", "proj_b", "bias")
    grads = []
    for fn in (window_attention_fused, window_attention_fused_plain):
        leaves = [T(a[k]).clone().requires_grad_() for k in names]
        out = fn(*leaves, _opt(a["mask"], T), a["nH"], a["nW"], a["scale"])
        grads.append(torch.autograd.grad((out * T(a["dout"])).sum(), leaves))
    for name, g, w in zip(names, *grads):
        assert_rel(name, g.numpy(), w.numpy(), 1e-4)


def test_packed_has_no_backward():
    a = _case(GEOMS["N49_C24"], False, seed=6)
    x = T(a["x"]).requires_grad_()
    out = window_attention_packed(x, T(a["qkv_w"]), T(a["qkv_b"]), T(a["proj_w"]),
                                  T(a["proj_b"]), T(a["bias"]), None, a["nH"], a["nW"],
                                  a["scale"])
    with pytest.raises(NotImplementedError, match="inference-only"):
        out.sum().backward()


def _fold_case(seed):
    """B=2, D=2, 14x14, C=32, nH=2, window (2,7,7): kernel 6's arguments
    without LN and without the residual."""
    rng = np.random.RandomState(seed)
    B, D, H, W, C, nh, n = 2, 2, 14, 14, 32, 2, 98
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    return dict(x=f(B, D, H, W, C), dout=f(B, D, H, W, C), qkv_w=f(C, 3 * C) / np.sqrt(C),
                qkv_b=0.1 * f(3 * C), proj_w=f(C, C) / np.sqrt(C), proj_b=0.1 * f(C),
                bias=f(nh, n, n), nh=nh, window=(2, 7, 7), scale=(C // nh) ** -0.5)


@pytest.mark.parametrize("shifted", [False, True], ids=["unshifted", "shifted"])
def test_fold_bwd_without_ln_matches_pallas_vjp(shifted):
    """Kernel 6 with ``ln_scale=None, residual=False`` against ``jax.vjp`` of
    ``folded_window_attention_trainable`` (``_fold_bwd_call(fuse_ln=False,
    residual=False)`` in interpret mode): what a fused fold block at a
    window-padded geometry differentiates through.  Shifted, the port folds
    the roll in and JAX gets the rolled tensors."""
    a = _fold_case(seed=7)
    shift = (0, 3, 3) if shifted else (0, 0, 0)
    mask = compute_attn_mask(2, 14, 14, a["window"], shift) if shifted else None
    back = lambda t: np.roll(t, (-3, -3), axis=(2, 3)) if shifted else t  # noqa: E731
    args = [jnp.asarray(v) for v in (back(a["x"]), a["qkv_w"], a["qkv_b"], a["proj_w"],
                                     a["proj_b"], a["bias"])]
    _, vjp = jax.vjp(
        lambda x, qw, qb, pw, pb, b: folded_window_attention_trainable(
            x, qw, qb, pw, pb, b, _opt(mask, jnp.asarray), a["nh"], a["window"], a["scale"],
            True),
        *args)
    dx, dqw, dqb, dpw, dpb, dbias = (np.asarray(g) for g in vjp(jnp.asarray(back(a["dout"]))))
    if shifted:
        dx = np.roll(dx, (3, 3), axis=(2, 3))
    got = fold_attention_bwd(T(a["x"]), T(a["dout"]), None, None, T(a["qkv_w"]), T(a["qkv_b"]),
                             T(a["proj_w"]), T(a["bias"]), _opt(mask, T), a["nh"], a["window"],
                             a["scale"], shift, residual=False)
    assert got[1] is None and got[2] is None  # no LN gradients in this mode
    for name, g, w in zip(("dx", "dqkv_w", "dqkv_b", "dproj_w", "dproj_b", "dbias"),
                          (got[0],) + got[3:], (dx, dqw, dqb, dpw, dpb, dbias)):
        assert_rel(name, g.numpy(), w, 1e-4)


def test_fold_attention_without_ln_is_differentiable():
    """``fold_attention(ln_scale=None, residual=False)`` backpropagates
    (kernel 6's second mode) and equals autograd through kernel 7's plain
    version on the partitioned windows; the two mixed modes keep raising."""
    a = _fold_case(seed=8)
    names = ("x", "qkv_w", "qkv_b", "proj_w", "proj_b", "bias")
    leaves = [T(a[k]).clone().requires_grad_() for k in names]
    out = fold_attention(leaves[0], None, None, *leaves[1:], None, a["nh"], a["window"],
                         a["scale"], residual=False)
    got = torch.autograd.grad((out * T(a["dout"])).sum(), leaves)
    ref = [T(a[k]).clone().requires_grad_() for k in names]
    wins = window_attention_fused_plain(window_partition(ref[0], a["window"]), *ref[1:], None,
                                        a["nh"], 4, a["scale"])
    want = torch.autograd.grad((wins * window_partition(T(a["dout"]), a["window"])).sum(), ref)
    for name, g, w in zip(names, got, want):
        assert_rel(name, g.numpy(), w.numpy(), 1e-4)
    out = fold_attention(leaves[0], None, None, *leaves[1:], None, a["nh"], a["window"],
                         a["scale"], residual=True)
    with pytest.raises(NotImplementedError, match="two modes"):
        out.sum().backward()


@pytest.mark.parametrize("with_ln", [True, False], ids=["ln_residual", "no_ln"])
@pytest.mark.parametrize("shifted", [False, True], ids=["unshifted", "shifted"])
def test_fold_backward_falls_back_to_window_kernel(monkeypatch, shifted, with_ln):
    """Where kernel 6's block would not fit shared memory, ``fold_attention``'s
    backward replays LN1 outside the kernel and runs kernel 8 (the JAX
    package's ``_blk_bwd`` fallback): the same gradients."""
    a = _fold_case(seed=9)
    rng = np.random.RandomState(10)
    ln = (T(1 + 0.1 * rng.randn(32).astype(np.float32)),
          T(0.1 * rng.randn(32).astype(np.float32))) if with_ln else (None, None)
    shift = (0, 3, 3) if shifted else (0, 0, 0)
    mask = _opt(compute_attn_mask(2, 14, 14, a["window"], shift) if shifted else None, T)
    args = (T(a["x"]), T(a["dout"]), *ln, T(a["qkv_w"]), T(a["qkv_b"]), T(a["proj_w"]),
            T(a["bias"]), mask, a["nh"], a["window"], a["scale"], shift, with_ln)
    want = fold_attention_bwd_plain(*args)
    got = fold_attn._fold_bwd_through_windows(*args)
    for name, g, w in zip(("dx", "dln_s", "dln_b", "dqkv_w", "dqkv_b", "dproj_w", "dproj_b",
                           "dbias"), got, want):
        assert (g is None) == (w is None), name
        if w is not None:
            assert_rel(name, g.numpy(), w.numpy(), 1e-4)
    # and the Function takes that route when the predicate says so
    calls = []
    monkeypatch.setattr(fold_attn, "fold_fits", lambda *a, **k: False)
    monkeypatch.setattr(fold_attn, "_fold_bwd_through_windows",
                        lambda *a: calls.append(1) or got)
    x = T(a["x"]).requires_grad_()
    out = fold_attention(x, *ln, T(a["qkv_w"]), T(a["qkv_b"]), T(a["proj_w"]), T(a["proj_b"]),
                         T(a["bias"]), mask, a["nh"], a["window"], a["scale"],
                         residual=with_ln, shift=shift)
    out.backward(T(a["dout"]))
    assert calls == [1]
    np.testing.assert_array_equal(x.grad.numpy(), got[0].numpy())


def test_fold_fits_is_the_shared_memory_predicate():
    """Every flagship and tiny window fits the fold kernels both ways and in
    both dtypes; the (8, 7, 7) window of 8-frame reconstruction clips
    (N = 392) does not, which sends a fold block to the partitioned-window
    route, whose row-tiled bodies take it both ways."""
    for n, c, nh in ((98, 96, 6), (98, 192, 12), (49, 192, 12), (49, 96, 6), (98, 32, 2)):
        for dtype in (torch.float32, torch.bfloat16):
            for backward in (False, True):
                assert fold_fits(n, c, nh, dtype, backward), (n, c, nh, dtype, backward)
    assert not fold_fits(392, 96, 6, torch.bfloat16)
    assert not fold_fits(392, 96, 6, torch.float32, backward=True)
    for dtype in (torch.float32, torch.bfloat16):
        for backward in (False, True):
            assert window_body(392, 96, 6, dtype, backward) == "rows"
    # the bf16 forward at the flagship's widest block: the figures the kernels' headers
    # state (kernel A's block, and the body with score tiles in shared memory that the
    # whole-block kernels keep)
    assert fold_smem_bytes(98, 192, 12, True) == 154240
    assert fold_attn.fold_body_smem_bytes(98, 192, 12) == 189312
    assert fold_smem_bytes(98, 192, 12, True, backward=True) <= fold_attn.SMEM_LIMIT


def test_window_kernels_are_registered_and_count_no_cpu_calls():
    names = [k.__name__ for k in KERNELS]
    assert names[6:9] == ["window_attention_fused", "window_attention_fused_bwd",
                          "window_attention_packed"]
    assert names[12:15] == ["window_attention_fused_rows", "window_attention_fused_bwd_rows",
                            "window_attention_packed_rows"]
    assert names[15:20] == ["ln_mlp_bwd_tiles", "fold_attention_bwd_tiles", "ln_mlp_tiles",
                            "fold_block_bwd_tiles", "fold_block_tiles"]
    assert names[20:] == ["window_attention_fused_tiles", "window_attention_fused_bwd_tiles",
                          "window_attention_packed_tiles", "ln_mlp_slab", "ln_mlp_bwd_slab"]
    assert len(names) == 25 and len(set(names)) == 25
    # the unpartitioned route runs the fold wrappers on the counters of 7, 9 and 8
    assert "window_attention_packed_tiles" in ops.__all__
    assert "window_attention_grid" not in ops.__all__
    before = [k.launches for k in KERNELS]
    a = _case(GEOMS["N49_C24"], True, seed=11)
    x = T(a["x"]).requires_grad_()
    out = _port_forward(window_attention_fused, dict(a, x=a["x"]))
    _port_forward(window_attention_packed, a)
    window_attention_fused(x, T(a["qkv_w"]), T(a["qkv_b"]), T(a["proj_w"]), T(a["proj_b"]),
                           T(a["bias"]), T(a["mask"]), a["nH"], a["nW"], a["scale"]).sum().backward()
    assert out.shape == a["x"].shape and x.grad is not None
    # the forcing wrappers of the whole-tile bodies run the plain versions here too
    tiles = _port_forward(window_attention_fused_tiles, a)
    np.testing.assert_array_equal(tiles.numpy(), out.detach().numpy())
    grads = window_attention_fused_bwd_tiles(
        T(a["x"]), T(a["dout"]), T(a["qkv_w"]), T(a["qkv_b"]), T(a["proj_w"]), T(a["bias"]),
        T(a["mask"]), a["nH"], a["nW"], a["scale"])
    assert len(grads) == 6 and grads[0].shape == a["x"].shape
    packed_tiles = _port_forward(window_attention_packed_tiles, a)
    np.testing.assert_array_equal(packed_tiles.numpy(),
                                  _port_forward(window_attention_packed, a).numpy())
    # the unpartitioned route on the CPU: (1, 14, 14) tokens, window (1, 7, 7), shifted
    y = window_reverse(T(a["x"]), (1, 7, 7), 2, 1, 14, 14).requires_grad_()
    for kernel, counters in ((ops.fold_attention_packed, {"counter": window_attention_packed}),
                             (ops.fold_attention, {"counter": window_attention_fused,
                                                   "bwd_counter": window_attention_fused_bwd})):
        out = kernel(
            y, None, None, T(a["qkv_w"]), T(a["qkv_b"]), T(a["proj_w"]), T(a["proj_b"]),
            T(a["bias"]), T(a["mask"]), a["nH"], (1, 7, 7), a["scale"], residual=False,
            shift=(0, 3, 3), **counters)
        assert out.shape == y.shape
    out.sum().backward()
    assert y.grad is not None and y.grad.shape == y.shape
    assert [k.launches for k in KERNELS] == before


def test_window_attention_checks_its_arguments():
    """The checks that guard the launch are reachable without a card; a
    window the whole-tile body cannot hold goes to the row-tiled body; bf16
    at head width 12 is taken (by the CUDA-core bodies)."""
    from vadcl_tpu_torch.ops.window_attn import _check_windows, window_core

    x = torch.zeros(8, 49, 24)
    bias, mask = torch.zeros(2, 49, 49), torch.zeros(4, 49, 49)
    _check_windows("k", x, bias, mask, 2, 4)
    _check_windows("k", x.bfloat16(), bias, mask, 2, 4)
    assert window_core(24, 2, torch.bfloat16) == "cuda_core"
    with pytest.raises(ValueError, match="bias"):
        _check_windows("k", x, bias[:1], mask, 2, 4)
    with pytest.raises(ValueError, match="mask"):
        _check_windows("k", x, bias, mask[:3], 2, 4)
    _check_windows("k", torch.zeros(2, 392, 96), torch.zeros(6, 392, 392), None, 6, 1)
    assert window_body(392, 96, 6, torch.bfloat16) == "rows"
    assert window_body(49, 24, 2, torch.float32) == "tile"
