"""The redesigned forward kernels of the port (fold attention with its packed
variant, LN->MLP): what a CPU can hold of them.

* The Python mirror of the bf16 fold kernel's shared-memory layout: every
  geometry that took the fold route still does, N = 392 does not (it takes
  the row-tiled partitioned-window bodies), and a block
  leaves room for the blocks per SM the design counts on.
* The packed operand layouts: pack -> unpack gives the bf16 weights (and the
  fp32 score terms) back, and the plain versions fed through them agree
  bit for bit with the plain versions fed the originals.
* The pack cache: one object per untouched tensor, a fresh pack after an
  in-place change or an optimizer step, never a hit for a successor that
  merely lives at a dead tensor's address.
* The plain versions against the Pallas kernels in interpret mode at the
  shapes where the CUDA kernels' ragged edges lie: a token count that fills
  no whole tile and an odd batch.  Tolerances as in the other parity tests:
  fp32 atol 2e-5 (LN->MLP: exact erf against the A&S erf) and 3e-5 (fold
  attention: summation order); bf16 max|port - jax| <= 2e-2 * max|jax|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse)
from vadcl_tpu.ops.pallas_attn_fold import fused_window_attention_folded
from vadcl_tpu.ops.pallas_mlp import fused_ln_mlp
from vadcl_tpu.ops.window import compute_attn_mask
from vadcl_tpu_torch.models.swin import WindowAttention3D
from vadcl_tpu_torch.ops import fold_attn
from vadcl_tpu_torch.ops.fold_attn import (
    FOLD_MAX_TOKENS,
    SMEM_LIMIT,
    fold_attention,
    fold_attention_plain,
    fold_block_fits,
    fold_body_smem_bytes,
    fold_fits,
    fold_packed_fits,
    fold_padded_rows,
    fold_smem_bytes,
    pack_fold_scores,
    pack_fold_weights,
    unpack_fold_scores,
    unpack_fold_weights,
)
from vadcl_tpu_torch.ops.ln_mlp import (
    ln_mlp,
    ln_mlp_plain,
    pack_mlp_weights,
    unpack_mlp_weights,
)
from vadcl_tpu_torch.ops.packed import PackCache
from vadcl_tpu_torch.ops.window_attn import window_body

T = torch.from_numpy
SM_SHARED = 233472  # shared memory of one Hopper SM (228 KB); a block also reserves 1 KB

# (N, C, heads) that took the fold route before the redesign: the four flagship
# geometries (the padded 240^2 and 64^2 inputs have the same windows), the tiny
# preset's two stages
FOLD_ROUTE = {"enc_stage0": (98, 96, 6), "enc_stage1": (98, 192, 12),
              "dec_stage0": (49, 192, 12), "dec_stage1": (49, 96, 6),
              "tiny_stage0": (98, 32, 2), "tiny_stage1": (98, 64, 4),
              "tiny_decoder": (49, 32, 2)}


@pytest.mark.parametrize("geom", FOLD_ROUTE)
def test_fold_route_is_kept(geom):
    n, c, nh = FOLD_ROUTE[geom]
    for dtype in (torch.bfloat16, torch.float32):
        for backward in (False, True):
            assert fold_fits(n, c, nh, dtype, backward), (geom, dtype, backward)
        assert fold_packed_fits(n, c, nh, dtype)
        assert fold_block_fits(n, c, nh, 4 * c, dtype)


def test_large_windows_are_refused_by_name():
    """N = 392 leaves the fold kernels for the row-tiled bodies of kernels 7,
    8 and 9: the bf16 forward caps the window explicitly, whatever its shared
    memory would be (112 tokens at head width 32, 208 at 16, where the long
    layout takes 8-frame clips' N = 196)."""
    assert FOLD_MAX_TOKENS == 112
    for dtype in (torch.bfloat16, torch.float32):
        assert not fold_fits(392, 96, 6, dtype)
        assert not fold_packed_fits(392, 96, 6, dtype)
        assert window_body(392, 96, 6, dtype) == "rows"
        assert window_body(392, 96, 6, dtype, backward=True) == "rows"
    assert not fold_fits(224, 32, 2, torch.bfloat16)  # would fit 227 KB, is over the cap
    assert fold_smem_bytes(224, 32, 2, True) <= SMEM_LIMIT
    assert not fold_fits(128, 64, 2, torch.bfloat16)  # head width 32 stops at 112
    assert fold_fits(128, 32, 2, torch.bfloat16)  # head width 16: the long layout


def test_head_widths_of_the_bf16_forward():
    """The bf16 forward is built for head widths 16 and 32; 48 and wider
    multiples of 16 go to the partitioned-window kernels (a route lost to the
    redesign, listed in ROADMAP.md), but stay with the whole-block kernels,
    whose predicate does not depend on the fold kernel's."""
    assert fold_attn.FOLD_HEAD_DIMS == (16, 32)
    for c, nh in ((96, 3), (192, 6), (64, 2)):  # head width 32
        assert fold_fits(98, c, nh, torch.bfloat16) and fold_packed_fits(49, c, nh, torch.bfloat16)
    assert fold_smem_bytes(98, 192, 6, True) == 205440  # one block per SM
    for c, nh in ((96, 2), (192, 3), (128, 2)):  # head widths 48, 64
        assert not fold_fits(98, c, nh, torch.bfloat16)
        assert fold_fits(49, c, nh, torch.float32)
        assert not fold_fits(49, c, nh, torch.bfloat16)
        assert fold_fits(49, c, nh, torch.bfloat16, backward=True)
        assert fold_block_fits(49, c, nh, 4 * c, torch.bfloat16)


@pytest.mark.parametrize("kernel,route", [
    ("fold_block", ["fold_block"]), ("fold", ["window_attention_fused", "ln_mlp"]),
    ("fold_packed", ["window_attention_fused", "ln_mlp"])])
def test_routes_at_a_head_width_the_bf16_forward_does_not_take(monkeypatch, kernel, route):
    """bf16 at head width 48: the whole-block kernel keeps the block, kernels
    A and 10 hand it to kernel 7."""
    from vadcl_tpu_torch.models import swin

    block = swin.SwinBlock3D(96, 2, (1, 7, 7), (0, 3, 3), fused=True, attn_kernel=kernel)
    gen = torch.Generator().manual_seed(1)
    block.attn.reset_parameters(gen)
    with torch.no_grad():
        for lin in (block.mlp.fc1, block.mlp.fc2):
            lin.weight.copy_(torch.randn(lin.weight.shape, generator=gen) * 0.1)
    seen = []
    for name in ("fold_block", "fold_attention", "fold_attention_packed",
                 "window_attention_fused", "ln_mlp"):
        real = getattr(swin, name)
        monkeypatch.setattr(swin, name, lambda *a, _n=name, _f=real, **k: seen.append(_n)
                            or _f(*a, **k))
    with torch.no_grad():
        out = block(torch.rand(1, 1, 14, 14, 96).bfloat16())
    assert seen == route and bool(torch.isfinite(out.float()).all())


@pytest.mark.parametrize("geom,blocks_per_sm", [
    ("enc_stage0", 2), ("enc_stage1", 1), ("dec_stage0", 1), ("dec_stage1", 2),
    ("tiny_stage0", 4)])
def test_forward_block_leaves_room_for_the_blocks_per_sm_of_the_design(geom, blocks_per_sm):
    """Two windows of N = 98 at C = 96 run on one SM (two blocks), two of
    N = 49 share one block and two such blocks an SM; at C = 192 one block."""
    n, c, nh = FOLD_ROUTE[geom]
    smem = fold_smem_bytes(n, c, nh, True)
    assert SM_SHARED // (smem + 1024) == blocks_per_sm, smem
    # the redesigned block is smaller than the body with score tiles in shared memory
    # wherever it holds one window; two paired windows may need more
    if n > 64:
        assert smem < fold_body_smem_bytes(n, c, nh)


def test_forward_mirror_figures():
    assert fold_smem_bytes(98, 96, 6, True) == 89728
    assert fold_smem_bytes(98, 192, 12, True) == 154240
    assert fold_smem_bytes(49, 96, 6, True) == 99456
    assert fold_padded_rows(49) == 64 and fold_padded_rows(98) == 112
    assert fold_padded_rows(392) == 400


WIDTHS = [(c, nh) for c in (32, 64, 96, 192) for nh in (2, 6, 12) if c % nh == 0]


@pytest.mark.parametrize("c,nh", WIDTHS)
def test_fold_weights_pack_and_unpack(c, nh):
    rng = np.random.RandomState(c + nh)
    qkv, proj = T(rng.randn(c, 3 * c).astype(np.float32)), T(rng.randn(c, c).astype(np.float32))
    packed = pack_fold_weights(qkv, proj, nh)
    hd = c // nh
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    assert tuple(packed.shape) == (nh + -(-c // (3 * hd)), c, 3 * hd + 8)
    assert not packed[..., 3 * hd:].any()  # the padding is zero
    back_qkv, back_proj = unpack_fold_weights(packed, nh)
    assert torch.equal(back_qkv, qkv.bfloat16()) and torch.equal(back_proj, proj.bfloat16())
    # slice h is head h's q, k and v columns
    h = nh - 1
    want = torch.cat([qkv[:, p * c + h * hd: p * c + (h + 1) * hd] for p in range(3)], 1)
    assert torch.equal(packed[h, :, : 3 * hd], want.bfloat16())


@pytest.mark.parametrize("c", [32, 48, 64, 80, 96, 192])
def test_mlp_weights_pack_and_unpack(c):
    rng = np.random.RandomState(c)
    w1, w2 = T(rng.randn(c, 4 * c).astype(np.float32)), T(rng.randn(4 * c, c).astype(np.float32))
    packed = pack_mlp_weights(w1, w2)
    assert tuple(packed.shape) == (4 * c // 64, 2 * c * 64) and packed.is_contiguous()
    assert packed.shape[1] * 2 % 16 == 0  # one chunk is one 16-byte-granular bulk copy
    b1, b2 = unpack_mlp_weights(packed, c)
    assert torch.equal(b1, w1.bfloat16()) and torch.equal(b2, w2.bfloat16())
    # chunk j holds w1[:, 64j:] then w2[64j:, :], element (k, n) at ((n // 8) * K + k) * 8 + n % 8
    j, k, n = 1, c - 3, 29
    assert packed[j, ((n // 8) * c + k) * 8 + n % 8] == w1[k, 64 * j + n].bfloat16()
    k, n = 50, c - 5
    assert packed[j, c * 64 + ((n // 8) * 64 + k) * 8 + n % 8] == w2[64 * j + k, n].bfloat16()
    with pytest.raises(ValueError):
        pack_mlp_weights(w1[:, :96], w2[:96])


@pytest.mark.parametrize("n", [49, 98, 64, 16])
def test_scores_pack_and_unpack(n):
    rng = np.random.RandomState(n)
    bias = T(rng.randn(3, n, n).astype(np.float32))
    rows = fold_padded_rows(n)
    packed = pack_fold_scores(bias, float("-inf"))
    assert tuple(packed.shape) == (3, rows // 16, rows // 8, 32, 4)
    assert torch.equal(unpack_fold_scores(packed, n), bias)
    # padded key columns hold -inf (probability 0), padded query rows 0
    assert int(torch.isinf(packed[0]).sum()) == rows * (rows - n)
    mask = pack_fold_scores(bias, 0.0)
    assert bool(torch.isfinite(mask).all())
    # strip s, n-tile j, lane l, element e is the accumulator's (row, col)
    s, j, lane, e = rows // 16 - 1, 1, 13, 2
    row, col = 16 * s + lane // 4 + 8 * (e // 2), 8 * j + 2 * (lane % 4) + e % 2
    if row < n and col < n:
        assert packed[1, s, j, lane, e] == bias[1, row, col]


def _fold_case(rng, B, D, H, W, C, nh, window, shift):
    n = window[0] * window[1] * window[2]
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    mask = compute_attn_mask(D, H, W, window, shift) if any(shift) else None
    return dict(x=f(B, D, H, W, C), ln_s=1 + 0.1 * f(C), ln_b=0.1 * f(C),
                qkv_w=f(C, 3 * C) / np.sqrt(C), qkv_b=0.1 * f(3 * C),
                proj_w=f(C, C) / np.sqrt(C), proj_b=0.1 * f(C), bias=f(nh, n, n), mask=mask,
                nh=nh, window=window, scale=(C // nh) ** -0.5, shift=shift)


def _port_fold(a, dtype, qkv_w=None, proj_w=None, bias=None, mask=None, fn=fold_attention):
    m = a["mask"] if mask is None else mask
    return fn(T(a["x"]).to(dtype), T(a["ln_s"]), T(a["ln_b"]),
              T(a["qkv_w"]) if qkv_w is None else qkv_w, T(a["qkv_b"]),
              T(a["proj_w"]) if proj_w is None else proj_w, T(a["proj_b"]),
              T(a["bias"]) if bias is None else bias,
              None if m is None else (T(m) if isinstance(m, np.ndarray) else m),
              a["nh"], a["window"], a["scale"], True, a["shift"])


def test_plain_versions_through_the_packed_operands_do_not_drift():
    """What the CUDA kernels read (pack) decodes (unpack) to exactly what the
    plain versions read: the same bf16 weights, the same fp32 bias and mask."""
    rng = np.random.RandomState(7)
    a = _fold_case(rng, 1, 2, 14, 14, 32, 2, (2, 7, 7), (0, 3, 3))
    qkv, proj = unpack_fold_weights(pack_fold_weights(T(a["qkv_w"]), T(a["proj_w"]), 2), 2)
    bias = unpack_fold_scores(pack_fold_scores(T(a["bias"]), float("-inf")), 98)
    mask = unpack_fold_scores(pack_fold_scores(T(a["mask"]), 0.0), 98)
    want = _port_fold(a, torch.bfloat16, fn=fold_attention_plain)
    got = _port_fold(a, torch.bfloat16, qkv.float(), proj.float(), bias, mask,
                     fn=fold_attention_plain)
    assert torch.equal(got, want)
    c = 32
    x = T(rng.randn(50, c).astype(np.float32)).bfloat16()
    p = [T(v.astype(np.float32)) for v in (1 + 0.1 * rng.randn(c), 0.1 * rng.randn(c),
                                           rng.randn(c, 128) / 6, 0.1 * rng.randn(128),
                                           rng.randn(128, c) / 11, 0.1 * rng.randn(c))]
    w1, w2 = unpack_mlp_weights(pack_mlp_weights(p[2], p[4]), c)
    assert torch.equal(ln_mlp_plain(x, p[0], p[1], w1.float(), p[3], w2.float(), p[5]),
                       ln_mlp_plain(x, *p))


def test_pack_cache_follows_versions_and_identities():
    cache = PackCache()
    w = torch.nn.Parameter(torch.randn(8, 8))
    made = []

    def pack():
        made.append(1)
        return w.detach().clone()

    first = cache.get((w,), ("k",), pack)
    assert cache.get((w,), ("k",), pack) is first and len(made) == 1
    with torch.no_grad():
        w.add_(1.0)  # an in-place change bumps the version
    second = cache.get((w,), ("k",), pack)
    assert second is not first and len(made) == 2 and torch.equal(second, w.detach())
    assert cache.get((w,), ("k",), pack) is second
    opt = torch.optim.SGD([w], lr=0.1)
    w.sum().backward()
    opt.step()  # so does an optimizer step
    third = cache.get((w,), ("k",), pack)
    assert third is not second and torch.equal(third, w.detach()) and len(cache) == 1
    # another tensor object never hits, even with the same storage and version
    alias = w.detach()
    assert cache.get((alias,), ("k",), lambda: "other") == "other"
    # tensors made under inference_mode track no version: packed at every call
    with torch.inference_mode():
        t = torch.ones(2)
        assert cache.get((t,), ("k",), lambda: object()) is not cache.get(
            (t,), ("k",), lambda: object())


def test_pack_cache_never_serves_a_dead_tensors_successor():
    cache = PackCache()
    t = torch.zeros(4)
    cache.get((t,), (), lambda: "old")
    key_of_t = (t.data_ptr(), t._version, tuple(t.shape))
    del t
    for _ in range(64):  # the allocator may well hand the same address out again
        u = torch.zeros(4)
        if (u.data_ptr(), u._version, tuple(u.shape)) == key_of_t:
            break
    assert cache.get((u,), (), lambda: "new") == "new"


def test_gathered_bias_is_kept_for_scoring_and_follows_the_table():
    attn = WindowAttention3D(32, (8, 7, 7), 2)
    attn.reset_parameters(torch.Generator().manual_seed(0))
    with torch.inference_mode():
        b = attn.bias(98)
        assert attn.bias(98) is b and not b.is_inference()
    with torch.no_grad():
        attn.relative_position_bias_table.add_(1.0)
        b2 = attn.bias(98)
    assert b2 is not b and torch.allclose(b2, b + 1.0)
    assert attn.bias(98).requires_grad  # training gathers through autograd every time
    assert attn.bias(49).shape == (2, 49, 49)


RAGGED = {"147_tokens_odd_batch": (3, 1, 7, 7), "1176_tokens": (2, 3, 14, 14), "50_tokens": (50,)}


@pytest.mark.parametrize("shape", RAGGED)
def test_ln_mlp_matches_pallas_at_ragged_token_counts(shape):
    """Token counts that fill no whole 16-, 32-, 64- or 128-row tile."""
    rng = np.random.RandomState(len(shape))
    C, Ch = 32, 128
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    x = f(*RAGGED[shape], C)
    p = [1 + 0.1 * f(C), 0.1 * f(C), f(C, Ch) / np.sqrt(C), 0.1 * f(Ch),
         f(Ch, C) / np.sqrt(Ch), 0.1 * f(C)]
    want = np.asarray(fused_ln_mlp(jnp.asarray(x), *map(jnp.asarray, p), True))
    got = ln_mlp(T(x), *map(T, p)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    want16 = fused_ln_mlp(jnp.asarray(x, jnp.bfloat16), *map(jnp.asarray, p), True)
    want16 = np.asarray(want16.astype(jnp.float32))
    got16 = ln_mlp(T(x).bfloat16(), *map(T, p)).float().numpy()
    assert np.max(np.abs(got16 - want16)) <= 2e-2 * np.max(np.abs(want16))


@pytest.mark.parametrize("window", [(2, 7, 7), (1, 7, 7)], ids=["N98", "N49_paired"])
@pytest.mark.parametrize("shifted", [False, True], ids=["unshifted", "shifted"])
def test_fold_attention_matches_pallas_at_an_odd_batch(shifted, window):
    """Batch 3: with N = 49 the CUDA kernel pairs windows in a block and the
    last block holds one."""
    rng = np.random.RandomState(11)
    D = window[0]
    a = _fold_case(rng, 3, D, 7, 14, 32, 2, window, (0, 3, 3) if shifted else (0, 0, 0))
    roll = (lambda t, s: np.roll(t, (s * 3, s * 3), axis=(2, 3))) if shifted else (lambda t, s: t)

    def jax_fold(dtype):
        out = fused_window_attention_folded(
            jnp.asarray(roll(a["x"], -1), dtype), jnp.asarray(a["qkv_w"]),
            jnp.asarray(a["qkv_b"]), jnp.asarray(a["proj_w"]), jnp.asarray(a["proj_b"]),
            jnp.asarray(a["bias"]), None if a["mask"] is None else jnp.asarray(a["mask"]),
            num_heads=a["nh"], window=window, scale=a["scale"], interpret=True,
            ln_scale=jnp.asarray(a["ln_s"]), ln_bias=jnp.asarray(a["ln_b"]), residual=True)
        return roll(np.asarray(out.astype(jnp.float32)), +1)

    np.testing.assert_allclose(_port_fold(a, torch.float32).numpy(), jax_fold(jnp.float32),
                               rtol=3e-5, atol=3e-5)
    want16 = jax_fold(jnp.bfloat16)
    got16 = _port_fold(a, torch.bfloat16).float().numpy()
    assert np.max(np.abs(got16 - want16)) <= 2e-2 * np.max(np.abs(want16))


def test_bf16_forward_refuses_what_it_does_not_take():
    """The checks that guard the launch are reachable without a card."""
    smem = lambda n, c, nh, bf16: fold_smem_bytes(n, c, nh, bool(bf16))  # noqa: E731
    x = torch.zeros(1, 2, 14, 14, 96, dtype=torch.bfloat16)
    fold_attn._check_fold("k", x, torch.zeros(6, 98, 98), None, 6, (2, 7, 7), smem, True)
    fold_attn._check_fold("k", x, torch.zeros(3, 98, 98), None, 3, (2, 7, 7), smem, True)
    with pytest.raises(NotImplementedError, match="head_dim 16 or 32"):
        fold_attn._check_fold("k", x, torch.zeros(2, 98, 98), None, 2, (2, 7, 7), smem, True)
    big = torch.zeros(1, 8, 7, 7, 96, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="at most 112"):
        fold_attn._check_fold("k", big, torch.zeros(6, 392, 392), None, 6, (8, 7, 7), smem, True)
