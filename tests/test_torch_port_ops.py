"""The port's plain primitives (window, conv, cluster, LayerNorm) against
their JAX counterparts, fp32 on the CPU, same numpy inputs."""

import flax.linen as fnn
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vadcl_tpu.ops.cluster as jc
import vadcl_tpu.ops.convs as jconv
import vadcl_tpu.ops.window as jw
import vadcl_tpu_torch.ops.cluster as pc
import vadcl_tpu_torch.ops.convs as pconv
import vadcl_tpu_torch.ops.window as pw
from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse)
from vadcl_tpu_torch.models.layers import FrozenBatchNorm, LayerNorm

T = torch.from_numpy
RNG = np.random.RandomState(0)


@pytest.fixture(autouse=True)
def _reseed():
    """Each test draws the same inputs whichever tests ran before it."""
    RNG.seed(0)


def _f(*shape):
    return RNG.randn(*shape).astype(np.float32)


@pytest.mark.parametrize(
    "grid,window,shift",
    [((2, 14, 14), (2, 7, 7), (0, 3, 3)), ((1, 28, 28), (1, 7, 7), (0, 3, 3)),
     ((8, 14, 14), (8, 7, 7), (4, 3, 3)), ((2, 14, 14), (2, 7, 7), (0, 0, 0))],
)
def test_window_constants_match_jax(grid, window, shift):
    np.testing.assert_array_equal(pw.relative_position_index(window), jw.relative_position_index(window))
    pm, jm = pw.compute_attn_mask(*grid, window, shift), jw.compute_attn_mask(*grid, window, shift)
    if jm is None:
        assert pm is None
    else:
        np.testing.assert_array_equal(pm, jm)
    assert pw.get_window_size(grid, (8, 7, 7), shift) == jw.get_window_size(grid, (8, 7, 7), shift)


def test_window_partition_reverse_match_jax():
    x = _f(2, 4, 14, 21, 5)
    got = pw.window_partition(T(x), (2, 7, 7))
    want = jw.window_partition(jnp.asarray(x), (2, 7, 7))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(pw.window_reverse(got, (2, 7, 7), 2, 4, 14, 21).numpy(), x)


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_window_attention_matches_jax(masked):
    C, nh, n = 16, 2, 98
    wins = _f(8, n, C)
    qw, qb, pw_, pb = _f(C, 3 * C) / 4, _f(3 * C) / 10, _f(C, C) / 4, _f(C) / 10
    table = _f(15 * 13 * 13, nh) * 0.02
    idx = jw.relative_position_index((8, 7, 7))
    mask = jw.compute_attn_mask(2, 14, 14, (2, 7, 7), (0, 3, 3)) if masked else None
    want = jw.window_attention(
        jnp.asarray(wins), jnp.asarray(qw), jnp.asarray(qb), jnp.asarray(pw_),
        jnp.asarray(pb), jnp.asarray(table), idx, nh, mask=mask,
    )
    bias = table[idx[:n, :n].reshape(-1)].reshape(n, n, nh).transpose(2, 0, 1).copy()
    got = pw.window_attention(
        T(wins), T(qw), T(qb), T(pw_), T(pb), T(bias), nh,
        mask=None if mask is None else T(mask),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("stride,padding", [((1, 1, 1), (1, 1, 1)), ((1, 2, 2), (0, 0, 0)), ((2, 1, 1), (0, 1, 0))])
def test_conv3d_matches_jax(stride, padding):
    x, w, b = _f(2, 4, 8, 8, 5), _f(3, 2, 2, 5, 6), _f(6)
    want = jconv.conv3d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride, padding)
    got = pconv.conv3d(T(x), T(w.transpose(4, 3, 0, 1, 2).copy()), T(b), stride, padding)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("kernel,stride,padding", [((3, 2, 2), (1, 2, 2), (1, 0, 0)), ((2, 1, 1), (2, 1, 1), (0, 0, 0)), ((1, 2, 2), (1, 2, 2), (0, 0, 0))])
def test_conv_transpose3d_matches_jax(kernel, stride, padding):
    x, w, b = _f(2, 3, 5, 5, 4), _f(*kernel, 4, 6), _f(6)
    want = jconv.conv_transpose3d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride, padding)
    got = pconv.conv_transpose3d(T(x), T(w.transpose(3, 4, 0, 1, 2).copy()), T(b), stride, padding)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_patchify_matmul_matches_jax():
    x, w, b = _f(2, 4, 16, 16, 3), _f(2, 4, 4, 3, 8), _f(8)
    want = jconv.patchify_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = pconv.patchify_matmul(T(x), T(w.transpose(4, 3, 0, 1, 2).copy()), T(b))
    # 96-term fp32 dot products of O(1) values, summed in another order
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


@pytest.mark.parametrize("shape", [(1, 4, 7, 7, 3), (2, 1, 14, 14, 2)])
def test_max_pool3d_same_pads_with_zeros_like_jax(shape):
    x = _f(*shape) - 2.0  # mostly negative: a -inf pad would differ at edges
    want = jconv.max_pool3d_same(jnp.asarray(x), 3, 1)
    got = pconv.max_pool3d_same(T(x), 3, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy()[:, 0] >= 0).all()  # the zero padding wins at the border


def test_cluster_primitives_match_jax():
    x, cen = _f(2, 2, 4, 4, 8), RNG.rand(6, 8).astype(np.float32)
    want = jc.feature_cluster_assign(jnp.asarray(x), jnp.asarray(cen), 16.0)
    got = pc.feature_cluster_assign(T(x), T(cen), 16.0)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    for name in ("distance", "assign", "recon"):
        np.testing.assert_allclose(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)), rtol=1e-5, atol=1e-5
        )
    # the diagonal is sqrt of an fp32 cancellation (|c|^2 + |c|^2 - 2 c.c):
    # up to sqrt(8 * 1.2e-7 * |c|^2) ~ 1e-3 whatever the summation order
    np.testing.assert_allclose(
        got.center_self_distance.numpy(), np.asarray(want.center_self_distance),
        rtol=1e-5, atol=2e-3,
    )
    scen = RNG.rand(8, 5, 16).astype(np.float32)
    sw = jc.space_cluster_assign(jnp.asarray(x), jnp.asarray(scen), 32.0)
    sg = pc.space_cluster_assign(T(x), T(scen), 32.0)
    np.testing.assert_allclose(sg.distance.numpy(), np.asarray(sw.distance), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(sg.assign.numpy(), np.asarray(sw.assign), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        float(pc.frobenius_norm(sg.distance * sg.assign)),
        float(jc.frobenius_norm(sw.distance * sw.assign)), rtol=1e-5,
    )


def test_layer_norm_uses_flax_fast_variance():
    x = _f(3, 5, 32) * 3 + 7  # a large mean makes fast and two-pass variance differ
    s, b = _f(32), _f(32)
    ln = fnn.LayerNorm(epsilon=1e-5)
    want = ln.apply({"params": {"scale": jnp.asarray(s), "bias": jnp.asarray(b)}}, jnp.asarray(x))
    m = LayerNorm(32)
    with torch.no_grad():
        m.weight.copy_(T(s))
        m.bias.copy_(T(b))
    np.testing.assert_allclose(m(T(x)).detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_frozen_batch_norm_eps():
    from vadcl_tpu.models.layers import FrozenBatchNorm as JaxBN

    x, s, b = _f(2, 3, 4, 4, 6), _f(6), _f(6)
    mean, var = _f(6), RNG.rand(6).astype(np.float32) + 0.1
    v = {"params": {"scale": jnp.asarray(s), "bias": jnp.asarray(b)},
         "batch_stats": {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}}
    want = JaxBN().apply(v, jnp.asarray(x))
    m = FrozenBatchNorm(6)
    with torch.no_grad():
        m.weight.copy_(T(s))
        m.bias.copy_(T(b))
        m.running_mean.copy_(T(mean))
        m.running_var.copy_(T(var))
    np.testing.assert_allclose(m(T(x)).detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
    assert m.eps == 1e-3
