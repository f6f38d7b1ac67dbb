"""The port's four kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version (the CUDA kernels run
only on the card, where ``chip_smoke.py`` holds them against these same
plain versions).  The JAX side runs the Pallas kernels in interpret mode.
Inputs come from a numpy RandomState and go to both packages unchanged.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse)
from vadcl_tpu.ops.pallas_attn_fold import fused_window_attention_folded
from vadcl_tpu.ops.pallas_cluster import fused_cluster_assign, fused_space_cluster_loss
from vadcl_tpu.ops.pallas_mlp import fused_ln_mlp
from vadcl_tpu.ops.window import compute_attn_mask as jax_attn_mask
from vadcl_tpu.ops.window import relative_position_index as jax_rel_index
from vadcl_tpu_torch.ops import KERNELS
from vadcl_tpu_torch.ops.cluster_kernels import cluster_assign, space_cluster_loss
from vadcl_tpu_torch.ops.fold_attn import fold_attention
from vadcl_tpu_torch.ops.ln_mlp import ln_mlp

T = torch.from_numpy


def _fold_inputs(shift: bool, seed: int = 0):
    """B=2, D=2, 14x14, C=32, nH=2, window (2,7,7): the tiny geometry."""
    rng = np.random.RandomState(seed)
    B, D, H, W, C, nh = 2, 2, 14, 14, 32, 2
    window = (2, 7, 7)
    n = 98
    f = lambda *s: rng.randn(*s).astype(np.float32)
    table = (0.02 * f(15 * 13 * 13, nh))
    idx = jax_rel_index((8, 7, 7))[:n, :n].reshape(-1)  # the [:N, :N] quirk
    bias = table[idx].reshape(n, n, nh).transpose(2, 0, 1).copy()
    mask = jax_attn_mask(D, H, W, window, (0, 3, 3)) if shift else None
    return dict(
        x=f(B, D, H, W, C), ln_s=1 + 0.1 * f(C), ln_b=0.1 * f(C),
        qkv_w=f(C, 3 * C) / np.sqrt(C), qkv_b=0.1 * f(3 * C),
        proj_w=f(C, C) / np.sqrt(C), proj_b=0.1 * f(C), bias=bias, mask=mask,
        nh=nh, window=window, scale=(C // nh) ** -0.5,
    )


@pytest.mark.parametrize("shift", [False, True], ids=["unshifted", "shifted"])
def test_fold_attention_matches_pallas_fold_kernel(shift):
    a = _fold_inputs(shift)
    want = fused_window_attention_folded(
        jnp.asarray(a["x"]), jnp.asarray(a["qkv_w"]), jnp.asarray(a["qkv_b"]),
        jnp.asarray(a["proj_w"]), jnp.asarray(a["proj_b"]), jnp.asarray(a["bias"]),
        None if a["mask"] is None else jnp.asarray(a["mask"]),
        num_heads=a["nh"], window=a["window"], scale=a["scale"], interpret=True,
        ln_scale=jnp.asarray(a["ln_s"]), ln_bias=jnp.asarray(a["ln_b"]),
        residual=True,
    )
    got = fold_attention(
        T(a["x"]), T(a["ln_s"]), T(a["ln_b"]), T(a["qkv_w"]), T(a["qkv_b"]),
        T(a["proj_w"]), T(a["proj_b"]), T(a["bias"]),
        None if a["mask"] is None else T(a["mask"]),
        a["nh"], a["window"], a["scale"], residual=True,
    )
    # fp32 both sides; only the summation order differs
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_fold_attention_folds_the_shift_roll():
    """With ``shift`` the wrapper computes roll(kernel(roll(x, -s)), s), which
    the Swin block's JAX path does around the Pallas kernel."""
    a = _fold_inputs(True, seed=3)
    s = (0, 3, 3)
    rolled = np.roll(a["x"], (-3, -3), axis=(2, 3))
    want = fused_window_attention_folded(
        jnp.asarray(rolled), jnp.asarray(a["qkv_w"]), jnp.asarray(a["qkv_b"]),
        jnp.asarray(a["proj_w"]), jnp.asarray(a["proj_b"]), jnp.asarray(a["bias"]),
        jnp.asarray(a["mask"]), num_heads=a["nh"], window=a["window"],
        scale=a["scale"], interpret=True, ln_scale=jnp.asarray(a["ln_s"]),
        ln_bias=jnp.asarray(a["ln_b"]), residual=True,
    )
    got = fold_attention(
        T(a["x"]), T(a["ln_s"]), T(a["ln_b"]), T(a["qkv_w"]), T(a["qkv_b"]),
        T(a["proj_w"]), T(a["proj_b"]), T(a["bias"]), T(a["mask"]), a["nh"],
        a["window"], a["scale"], residual=True, shift=s,
    )
    np.testing.assert_allclose(
        got.numpy(), np.roll(np.asarray(want), (3, 3), axis=(2, 3)), rtol=0, atol=1e-5
    )


def test_fold_attention_without_ln_or_residual():
    a = _fold_inputs(True, seed=1)
    want = fused_window_attention_folded(
        jnp.asarray(a["x"]), jnp.asarray(a["qkv_w"]), jnp.asarray(a["qkv_b"]),
        jnp.asarray(a["proj_w"]), jnp.asarray(a["proj_b"]), jnp.asarray(a["bias"]),
        jnp.asarray(a["mask"]), num_heads=a["nh"], window=a["window"],
        scale=a["scale"], interpret=True,
    )
    got = fold_attention(
        T(a["x"]), None, None, T(a["qkv_w"]), T(a["qkv_b"]), T(a["proj_w"]),
        T(a["proj_b"]), T(a["bias"]), T(a["mask"]), a["nh"], a["window"],
        a["scale"], residual=False,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_ln_mlp_matches_pallas_mlp_kernel():
    rng = np.random.RandomState(2)
    C, Ch = 32, 128
    f = lambda *s: rng.randn(*s).astype(np.float32)
    x = f(2, 3, 14, 14, C)  # 1176 tokens: not a multiple of the Pallas tile
    p = [1 + 0.1 * f(C), 0.1 * f(C), f(C, Ch) / np.sqrt(C), 0.1 * f(Ch),
         f(Ch, C) / np.sqrt(Ch), 0.1 * f(C)]
    want = fused_ln_mlp(jnp.asarray(x), *map(jnp.asarray, p), True)
    got = ln_mlp(T(x), *map(T, p))
    # exact erf (port) vs the A&S 7.1.26 erf (Pallas, 1.5e-7 abs error)
    # times O(1) fc2 weights over 128 hidden units: a few 1e-6
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("n", [256, 200], ids=["aligned", "ragged"])
def test_cluster_assign_matches_pallas_cluster_kernel(n):
    rng = np.random.RandomState(3)
    tokens = rng.randn(n, 32).astype(np.float32)
    centers = rng.rand(24, 32).astype(np.float32)
    want = fused_cluster_assign(jnp.asarray(tokens), jnp.asarray(centers), 16.0, True)
    got = cluster_assign(T(tokens), T(centers), 16.0)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(got.recon.numpy(), np.asarray(want.recon), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(got.loss_sq_sum), float(want.loss_sq_sum), rtol=1e-5)
    assert got.labels.dtype == torch.int32


def test_space_cluster_loss_matches_pallas_space_kernel():
    rng = np.random.RandomState(4)
    maps = rng.randn(8, 4, 49).astype(np.float32)
    centers = rng.rand(8, 6, 49).astype(np.float32)
    want = float(fused_space_cluster_loss(jnp.asarray(maps), jnp.asarray(centers), 32.0, True))
    got = float(space_cluster_loss(T(maps), T(centers), 32.0))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_cpu_calls_do_not_count_as_kernel_launches():
    before = [k.launches for k in KERNELS]
    a = _fold_inputs(False)
    fold_attention(
        T(a["x"]), T(a["ln_s"]), T(a["ln_b"]), T(a["qkv_w"]), T(a["qkv_b"]),
        T(a["proj_w"]), T(a["proj_b"]), T(a["bias"]), None, a["nh"],
        a["window"], a["scale"],
    )
    assert [k.launches for k in KERNELS] == before


def test_wrappers_refuse_other_devices():
    x = torch.empty(4, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cluster_assign(x, torch.empty(3, 8, device="meta"), 1.0)
    with pytest.raises(ValueError, match="unsupported device"):
        space_cluster_loss(x[None], torch.empty(1, 3, 8, device="meta"), 1.0)
