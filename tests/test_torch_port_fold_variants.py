"""Kernel 10 (``fold_attention_packed``) and the whole-Swin-block kernels
(``fold_block``, ``fold_block_bwd``) of the port against the JAX package, on
the CPU.

On the CPU each wrapper runs its plain PyTorch version (the CUDA kernels run
only on the card, where ``chip_smoke.py`` phases 2 and 2b hold them against
these same plain versions).  The JAX functions run their Pallas kernels in
interpret mode, as ``tests/test_pallas_attn_fold.py`` does.  Inputs come from
a numpy RandomState and go to both packages unchanged; the rel-pos bias and
the upstream gradient are drawn at unit scale so that a dropped or transposed
bias cannot pass.  Shifted, the port folds the roll into the call and JAX
gets the rolled tensors.

Bounds: forward fp32 rtol = atol = 2e-5 (``tests/test_pallas_attn_fold.py``;
3e-5 with LN and the residual, as there; the whole block 1e-4: its MLP tail
uses exact erf where Pallas uses the A&S 7.1.26 form, 1.5e-7 abs before two
more products); forward bf16 max|port - jax| <= 2e-2 * max|jax| (both round at
the same casts; a different fp32 summation order can flip one bf16 rounding);
gradients max|port - jax| <= 1e-4 * max|jax| per tensor (fp32, summation
order only), as ``tests/test_torch_port_grads.py`` holds kernel 6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse)
from vadcl_tpu.ops.pallas_attn_fold import (
    folded_full_block_trainable,
    fused_window_attention_folded_packed,
)
from vadcl_tpu.ops.window import compute_attn_mask
from vadcl_tpu_torch.ops import KERNELS, fold_attn
from vadcl_tpu_torch.ops.fold_attn import (
    FOLD_BLOCK_GRADS,
    fold_attention,
    fold_attention_packed,
    fold_attention_packed_plain,
    fold_attention_plain,
    fold_block,
    fold_block_bwd,
    fold_block_bwd_tiles,
    fold_block_fits,
    fold_block_plain,
    fold_block_smem_bytes,
    fold_fits,
    fold_packed_fits,
)
from vadcl_tpu_torch.ops.ln_mlp import ln_mlp

T = torch.from_numpy
ATTN = ("ln_s", "ln_b", "qkv_w", "qkv_b", "proj_w", "proj_b", "bias")
TAIL = ("ln2_s", "ln2_b", "w1", "b1", "w2", "b2")
SHIFT = (0, 3, 3)


def assert_rel(name, got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = float(np.max(np.abs(want)))
    err = float(np.max(np.abs(got - want)))
    assert scale > 0, name
    assert err <= tol * scale, f"{name}: max abs err {err} > {tol} * {scale}"


def _case(seed=0, qkv_bias=True, C=32, nh=2):
    """B=2, D=2, 14x14, window (2,7,7): four windows per image, N=98."""
    rng = np.random.RandomState(seed)
    B, D, H, W, n, Ch = 2, 2, 14, 14, 98, 4 * C
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    return dict(
        x=f(B, D, H, W, C), dout=f(B, D, H, W, C), ln_s=1 + 0.1 * f(C), ln_b=0.1 * f(C),
        qkv_w=f(C, 3 * C) / np.sqrt(C), qkv_b=0.1 * f(3 * C) if qkv_bias else None,
        proj_w=f(C, C) / np.sqrt(C), proj_b=0.1 * f(C), bias=f(nh, n, n),
        ln2_s=1 + 0.1 * f(C), ln2_b=0.1 * f(C), w1=f(C, Ch) / np.sqrt(C), b1=0.1 * f(Ch),
        w2=f(Ch, C) / np.sqrt(Ch), b2=0.1 * f(C),
        nh=nh, window=(2, 7, 7), scale=(C // nh) ** -0.5,
    )


def _mask(shifted):
    return compute_attn_mask(2, 14, 14, (2, 7, 7), SHIFT) if shifted else None


def _opt(v, conv):
    return None if v is None else conv(v)


def _rolled(t, shifted, sign=-1):
    """What the JAX block hands its kernel: ``roll(x, -shift)`` (and back)."""
    return np.roll(t, (sign * 3, sign * 3), axis=(2, 3)) if shifted else t


def _port_packed(a, shifted, ln, dtype=torch.float32, fn=fold_attention_packed):
    return fn(
        T(a["x"]).to(dtype), T(a["ln_s"]) if ln else None, T(a["ln_b"]) if ln else None,
        T(a["qkv_w"]), _opt(a["qkv_b"], T), T(a["proj_w"]), T(a["proj_b"]), T(a["bias"]),
        _opt(_mask(shifted), T), a["nh"], a["window"], a["scale"], residual=ln,
        shift=SHIFT if shifted else (0, 0, 0),
    )


def _jax_packed(a, shifted, ln, dtype=jnp.float32):
    out = fused_window_attention_folded_packed(
        jnp.asarray(_rolled(a["x"], shifted), dtype), jnp.asarray(a["qkv_w"]),
        _opt(a["qkv_b"], jnp.asarray), jnp.asarray(a["proj_w"]), jnp.asarray(a["proj_b"]),
        jnp.asarray(a["bias"]), _opt(_mask(shifted), jnp.asarray), num_heads=a["nh"],
        window=a["window"], scale=a["scale"], interpret=True,
        ln_scale=jnp.asarray(a["ln_s"]) if ln else None,
        ln_bias=jnp.asarray(a["ln_b"]) if ln else None, residual=ln,
    )
    return _rolled(np.asarray(out.astype(jnp.float32)), shifted, +1)


@pytest.mark.parametrize("ln", [True, False], ids=["ln_residual", "bare"])
@pytest.mark.parametrize("shifted", [False, True], ids=["unshifted", "shifted"])
def test_fold_packed_matches_pallas_fp32(shifted, ln):
    """Kernel 10's plain version against
    ``fused_window_attention_folded_packed`` in interpret mode, as a block's
    front half (LN1 + residual) and bare (what a padded block runs)."""
    a = _case(seed=1)
    got = _port_packed(a, shifted, ln).numpy()
    np.testing.assert_allclose(got, _jax_packed(a, shifted, ln), rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("shifted", [False, True], ids=["unshifted", "shifted"])
def test_fold_packed_matches_pallas_bf16(shifted):
    """bf16, without the residual so that the attention branch is all of the
    output: q rounds after its scale, k and v round, p rounds after e * (1 /
    sum e), as in ``_fold_packed_kernel``."""
    a = _case(seed=2)
    got = _port_packed(a, shifted, False, torch.bfloat16)
    want = _jax_packed(a, shifted, False, jnp.bfloat16)
    assert got.dtype == torch.bfloat16
    assert_rel("fold_packed bf16", got.float().numpy(), want, 2e-2)


def test_fold_packed_without_qkv_bias():
    a = _case(seed=3, qkv_bias=False, C=24, nh=4)
    got = _port_packed(a, False, True).numpy()
    np.testing.assert_allclose(got, _jax_packed(a, False, True), rtol=3e-5, atol=3e-5)


def test_fold_packed_differs_from_fold_only_by_rounding():
    """In fp32 kernels A and 10 are the same function up to rounding.  In
    bf16 they differ where the q scale is no power of two (head_dim 6 here;
    at head_dim 16 the scale is 1/4 and commutes with the rounding)."""
    a = _case(seed=4)
    fold, packed = (_port_packed(a, True, True, fn=f).numpy()
                    for f in (fold_attention, fold_attention_packed))
    np.testing.assert_allclose(packed, fold, rtol=2e-5, atol=2e-5)
    a = _case(seed=4, C=24, nh=4)
    fold, packed = (_port_packed(a, True, False, torch.bfloat16, fn=f).float().numpy()
                    for f in (fold_attention_plain, fold_attention_packed_plain))
    assert np.any(fold != packed)
    assert_rel("bf16 A vs 10", packed, fold, 4e-2)


def test_fold_packed_is_inference_only():
    a = _case(seed=5)
    x = T(a["x"]).requires_grad_()
    out = fold_attention_packed(
        x, T(a["ln_s"]), T(a["ln_b"]), T(a["qkv_w"]), T(a["qkv_b"]), T(a["proj_w"]),
        T(a["proj_b"]), T(a["bias"]), None, a["nh"], a["window"], a["scale"])
    with pytest.raises(NotImplementedError, match="inference-only"):
        out.sum().backward()


def _port_block_args(a, shifted, dtype=torch.float32, leaves=False):
    vals = [T(a["x"]).to(dtype)] + [_opt(a[k], T) for k in ATTN] + [_opt(_mask(shifted), T)] \
        + [T(a[k]) for k in TAIL]
    if leaves:
        vals = [v if v is None or i == 8 else v.clone().requires_grad_()
                for i, v in enumerate(vals)]
    return vals


def _jax_block(a, shifted, dtype=jnp.float32):
    """``folded_full_block_trainable`` closed over the mask and the static
    arguments, its 14 differentiable operands, and the rolled-input helper."""
    mask = _opt(_mask(shifted), jnp.asarray)
    ops = [jnp.asarray(_rolled(a["x"], shifted), dtype)] + [jnp.asarray(a[k]) for k in ATTN] \
        + [jnp.asarray(a[k]) for k in TAIL]

    def fn(x, ln_s, ln_b, qkv_w, qkv_b, proj_w, proj_b, bias, *tail):
        return folded_full_block_trainable(
            x, ln_s, ln_b, qkv_w, qkv_b, proj_w, proj_b, bias, mask, *tail,
            a["nh"], a["window"], a["scale"], True)

    return fn, ops


@pytest.mark.parametrize("shifted", [False, True], ids=["unshifted", "shifted"])
def test_fold_block_matches_pallas_full_block_fp32(shifted):
    """``fold_block`` (on the CPU: ``fold_block_plain``) against
    ``folded_full_block_trainable`` in interpret mode."""
    a = _case(seed=6)
    got = fold_block(*_port_block_args(a, shifted), a["nh"], a["window"], a["scale"],
                     shift=SHIFT if shifted else (0, 0, 0)).numpy()
    fn, ops = _jax_block(a, shifted)
    want = _rolled(np.asarray(fn(*ops)), shifted, +1)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_fold_block_matches_pallas_full_block_bf16():
    a = _case(seed=7)
    got = fold_block(*_port_block_args(a, True, torch.bfloat16), a["nh"], a["window"],
                     a["scale"], shift=SHIFT)
    fn, ops = _jax_block(a, True, jnp.bfloat16)
    want = _rolled(np.asarray(fn(*ops).astype(jnp.float32)), True, +1)
    assert got.dtype == torch.bfloat16
    assert_rel("fold_block bf16", got.float().numpy(), want, 2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_fold_block_equals_fold_then_tail_bit_for_bit(dtype):
    """y1 rounds to the compute dtype before LN2, so the whole-block kernel
    returns exactly what kernels A then B return."""
    a = _case(seed=8)
    args = _port_block_args(a, True, dtype)
    whole = fold_block(*args, a["nh"], a["window"], a["scale"], shift=SHIFT)
    y1 = fold_attention(*args[:9], a["nh"], a["window"], a["scale"], shift=SHIFT)
    assert torch.equal(whole, ln_mlp(y1, *args[9:]))


@pytest.mark.parametrize("shifted", [False, True], ids=["unshifted", "shifted"])
def test_fold_block_bwd_matches_pallas_full_block_vjp(shifted):
    """All 14 gradients of ``fold_block_bwd`` (on the CPU:
    ``fold_block_bwd_plain``) against ``jax.vjp`` of
    ``folded_full_block_trainable``, whose backward is ``_fold_bwd_kernel``
    with ``tail_refs`` in interpret mode."""
    a = _case(seed=9)
    fn, ops = _jax_block(a, shifted)
    _, vjp = jax.vjp(fn, *ops)
    want = [np.asarray(w) for w in vjp(jnp.asarray(_rolled(a["dout"], shifted)))]
    want[0] = _rolled(want[0], shifted, +1)
    args = _port_block_args(a, shifted)
    got = fold_block_bwd(args[0], T(a["dout"]), *args[1:14], a["nh"], a["window"], a["scale"],
                         SHIFT if shifted else (0, 0, 0))
    assert len(got) == len(want) == len(FOLD_BLOCK_GRADS) == 14
    # jax.vjp's operand order is the port's return order
    for name, g, w in zip(FOLD_BLOCK_GRADS, got, want):
        assert_rel(name, g.numpy(), w, 1e-4)


def test_fold_block_bwd_without_qkv_bias_returns_none_for_it():
    a = _case(seed=10, qkv_bias=False)
    args = _port_block_args(a, False)
    got = fold_block_bwd(args[0], T(a["dout"]), *args[1:14], a["nh"], a["window"], a["scale"])
    assert got[FOLD_BLOCK_GRADS.index("dqkv_b")] is None
    assert all(g is not None for n, g in zip(FOLD_BLOCK_GRADS, got) if n != "dqkv_b")


@pytest.mark.parametrize("shifted", [False, True], ids=["unshifted", "shifted"])
def test_fold_block_function_matches_autograd_of_plain(shifted):
    """The autograd Function (forward the whole-block kernel, backward its
    backward) against ``torch.autograd.grad`` of ``fold_block_plain``."""
    a = _case(seed=11)
    shift = SHIFT if shifted else (0, 0, 0)
    grads = []
    for fn in (fold_block, fold_block_plain):
        leaves = _port_block_args(a, shifted, leaves=True)
        out = fn(*leaves, a["nh"], a["window"], a["scale"], shift=shift)
        if fn is fold_block:
            assert "FoldBlock" in out.grad_fn.name()
        diff = [v for v in leaves if v is not None and v.requires_grad]
        grads.append(torch.autograd.grad((out * T(a["dout"])).sum(), diff))
    assert len(grads[0]) == 14
    for name, g, w in zip(FOLD_BLOCK_GRADS, *grads):
        assert_rel(name, g.numpy(), w.numpy(), 1e-4)


FLAGSHIP = {"enc_stage0": (98, 96, 6), "enc_stage1": (98, 192, 12),
            "dec_stage0": (49, 192, 12), "dec_stage1": (49, 96, 6)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("geom", FLAGSHIP)
def test_new_kernels_fit_the_flagship_geometries(geom, dtype):
    """Kernel 10 and the whole-block kernels, each way, fit 227 KB of shared
    memory at all four flagship geometries in both dtypes, so a flagship
    ``fold_block`` model runs one kernel per block each way."""
    n, c, nh = FLAGSHIP[geom]
    assert fold_packed_fits(n, c, nh, dtype)
    assert fold_block_fits(n, c, nh, 4 * c, dtype)
    bf16 = dtype == torch.bfloat16
    for backward in (False, True):
        assert fold_block_smem_bytes(n, c, nh, bf16, backward) <= fold_attn.SMEM_LIMIT
        # the whole block never needs less than the body it extends (in bf16 the
        # forward's is the one-window body with score tiles in shared memory)
        body = (fold_attn.fold_body_smem_bytes(n, c, nh) if bf16 and not backward
                else fold_attn.fold_smem_bytes(n, c, nh, bf16, backward))
        assert fold_block_smem_bytes(n, c, nh, bf16, backward) >= body


def test_large_windows_fit_none_of_the_new_kernels():
    """N=392 (window (8,7,7) on 16-frame clips) holds no (N, N) score tile in
    shared memory: the blocks take the partitioned route."""
    for dtype in (torch.bfloat16, torch.float32):
        assert not fold_packed_fits(392, 96, 6, dtype)
        assert not fold_block_fits(392, 96, 6, 384, dtype)


def test_fold_block_fits_is_one_predicate_for_both_directions(monkeypatch):
    """The forward alone fitting is not enough: where only the backward's
    block is too large, ``fold_block_fits`` is false, so forward and backward
    can never disagree about the route."""
    n, c, nh = FLAGSHIP["enc_stage1"]
    fwd = fold_block_smem_bytes(n, c, nh, True)
    bwd = fold_block_smem_bytes(n, c, nh, True, backward=True)
    assert fwd < bwd
    monkeypatch.setattr(fold_attn, "SMEM_LIMIT", (fwd + bwd) // 2)
    assert not fold_block_fits(n, c, nh, 4 * c, torch.bfloat16)
    monkeypatch.setattr(fold_attn, "SMEM_LIMIT", bwd)
    assert fold_block_fits(n, c, nh, 4 * c, torch.bfloat16)
    # the bf16 tail keeps its fc2 sums in the warps' fragments: 96 tiles at most
    assert not fold_block_fits(98, 256, 16, 1024, torch.bfloat16)
    assert fold_fits(98, 96, 6, torch.bfloat16)


def test_twelve_kernels_count_their_launches_and_cpu_calls_do_not():
    """The twelve kernels of PRs 1-5 and, since the row-tiled bodies of 7, 8
    and 9 count their own launches, three more counters, and two for the
    CUDA-core and shared-memory bodies of 5 and 6 beside their tensor-core
    bodies, and one for kernel B's CUDA-core body, and one each for the
    whole-block backward's and forward's older bodies beside their
    tensor-core bodies, and one each for the whole-tile bodies of 7 and 8
    beside A's and 6's tensor-core bodies, which 7 and 8 run in bf16, and
    one for the whole-tile body of 9 beside A's packed body, and one each for
    kernel B's and kernel 5's slab bodies: twenty-five."""
    names = [k.__name__ for k in KERNELS]
    assert len(names) == len(set(names)) == 25
    assert {"fold_attention_packed", "fold_block", "fold_block_bwd"} <= set(names)
    assert {"fold_block_bwd_tiles", "fold_block_tiles"} <= set(names)
    assert {"window_attention_fused_tiles", "window_attention_fused_bwd_tiles",
            "window_attention_packed_tiles"} <= set(names)
    before = [k.launches for k in KERNELS]
    a = _case(seed=12)
    args = _port_block_args(a, False)
    fold_block(*args, a["nh"], a["window"], a["scale"])
    fold_block_bwd(args[0], T(a["dout"]), *args[1:14], a["nh"], a["window"], a["scale"])
    _port_packed(a, False, True)
    fold_block_bwd_tiles(args[0], T(a["dout"]), *args[1:14], a["nh"], a["window"], a["scale"])
    assert [k.launches for k in KERNELS] == before


def test_whole_block_checks_its_tail_operands():
    """The checks that guard the whole-block launches are reachable without
    a card: mismatched MLP weights, a bf16 hidden width off the 128-column
    chunks, more output tiles than the warps' fragments hold, and widths the
    backward's vector loads cannot take."""
    check = fold_attn._check_block
    window = (2, 7, 7)
    x = torch.zeros(1, 2, 14, 14, 32, dtype=torch.bfloat16)
    assert check("fold_block", x, torch.zeros(32, 128), torch.zeros(128, 32), window, 128) == 128
    with pytest.raises(ValueError, match="weights"):
        check("fold_block", x, torch.zeros(32, 128), torch.zeros(64, 32), window, 128)
    with pytest.raises(NotImplementedError, match="hidden width divisible by 128"):
        check("fold_block", x, torch.zeros(32, 96), torch.zeros(96, 32), window, 128)
    wide = torch.zeros(1, 2, 14, 14, 256, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="output tiles"):
        check("fold_block", wide, torch.zeros(256, 1024), torch.zeros(1024, 256), window, 128)
    odd = torch.zeros(1, 2, 14, 14, 30)
    with pytest.raises(NotImplementedError, match="multiples of 4"):
        check("fold_block_bwd", odd, torch.zeros(30, 120), torch.zeros(120, 30), window, 4)
