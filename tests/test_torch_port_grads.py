"""Gradients of the port's kernel layer against the JAX package.

The port's backward kernels (6: fold attention, 5: LN->MLP) run their plain
PyTorch versions on the CPU (the CUDA kernels run only on the card, where
``chip_smoke.py`` phase 2b holds them against these same plain versions);
the JAX side runs the Pallas backward kernels in interpret mode.  The four
forward wrappers are ``torch.autograd.Function``s whose backward is the
matching kernel (or, for the cluster heads, autograd through the plain
recompute, as the JAX custom VJPs do).  Inputs come from a numpy
RandomState and go to both packages unchanged.

Bound for every gradient tensor: max|port - jax| <= 1e-4 * max|jax| (fp32
both sides; only the summation order differs), the scheme of
``tests/test_pallas_attn_fold.py:220-223``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse)
from vadcl_tpu.ops.pallas_attn_fold import _fold_bwd_call, folded_block_attention_trainable
from vadcl_tpu.ops.pallas_cluster import fused_cluster_assign, fused_space_cluster_loss
from vadcl_tpu.ops.pallas_mlp import fused_ln_mlp
from vadcl_tpu.ops.window import compute_attn_mask as jax_attn_mask
from vadcl_tpu_torch.ops.cluster_kernels import cluster_assign, space_cluster_loss
from vadcl_tpu_torch.ops.fold_attn import fold_attention, fold_attention_bwd, fold_attention_plain
from vadcl_tpu_torch.ops.ln_mlp import ln_mlp, ln_mlp_bwd_plain, ln_mlp_plain

T = torch.from_numpy
TOL = 1e-4
FOLD_NAMES = ("dx", "dln_s", "dln_b", "dqkv_w", "dqkv_b", "dproj_w", "dproj_b", "dbias")


def assert_rel(name, got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = float(np.max(np.abs(want)))
    err = float(np.max(np.abs(got - want)))
    assert scale > 0, name
    assert err <= tol * scale, f"{name}: max abs err {err} > {tol} * {scale}"


def _fold_case(seed: int = 0):
    """B=2, D=2, 14x14, C=32, nH=2, window (2,7,7); unit-scale rel-pos bias
    and upstream gradient."""
    rng = np.random.RandomState(seed)
    B, D, H, W, C, nh = 2, 2, 14, 14, 32, 2
    n = 98
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    return dict(
        x=f(B, D, H, W, C), dout=f(B, D, H, W, C), ln_s=1 + 0.1 * f(C), ln_b=0.1 * f(C),
        qkv_w=f(C, 3 * C) / np.sqrt(C), qkv_b=0.1 * f(3 * C),
        proj_w=f(C, C) / np.sqrt(C), proj_b=0.1 * f(C), bias=f(nh, n, n),
        nh=nh, window=(2, 7, 7), scale=(C // nh) ** -0.5,
    )


def _port_fold_bwd(a, mask, shift):
    return fold_attention_bwd(
        T(a["x"]), T(a["dout"]), T(a["ln_s"]), T(a["ln_b"]), T(a["qkv_w"]),
        T(a["qkv_b"]), T(a["proj_w"]), T(a["bias"]), None if mask is None else T(mask),
        a["nh"], a["window"], a["scale"], shift,
    )


@pytest.mark.parametrize("shifted", [False, True], ids=["unshifted", "shifted"])
def test_fold_bwd_matches_pallas_fold_bwd_kernel(shifted):
    """The plain kernel-6 contract (``fold_attention_bwd`` on the CPU runs
    ``fold_attention_bwd_plain``) against ``_fold_bwd_call(fuse_ln=True,
    residual=True)`` in interpret mode; shifted, the port folds the roll in
    and JAX gets the rolled tensors, with dx rolled back."""
    a = _fold_case(seed=1)
    shift = (0, 3, 3) if shifted else (0, 0, 0)
    mask = jax_attn_mask(2, 14, 14, a["window"], shift) if shifted else None
    back = lambda t: np.roll(t, (-3, -3), axis=(2, 3)) if shifted else t  # noqa: E731
    want = _fold_bwd_call(
        jnp.asarray(back(a["x"])), jnp.asarray(back(a["dout"])), jnp.asarray(a["qkv_w"]),
        jnp.asarray(a["qkv_b"]).reshape(1, -1), jnp.asarray(a["proj_w"]),
        jnp.asarray(a["ln_s"]).reshape(1, -1), jnp.asarray(a["ln_b"]).reshape(1, -1),
        jnp.asarray(a["bias"]), None if mask is None else jnp.asarray(mask),
        num_heads=a["nh"], window=a["window"], scale=a["scale"], fuse_ln=True,
        residual=True, interpret=True,
    )
    # _fold_bwd_call returns dx, dqkv_w, dqkv_b, dproj_w, dproj_b, dbias, dln_s, dln_b
    want = [np.asarray(want[i]) for i in (0, 6, 7, 1, 2, 3, 4, 5)]
    want[0] = np.roll(want[0], (3, 3), axis=(2, 3)) if shifted else want[0]
    got = _port_fold_bwd(a, mask, shift)
    for name, g, w in zip(FOLD_NAMES, got, want):
        assert_rel(name, g.numpy(), w.reshape(g.shape))


@pytest.mark.parametrize("shifted", [False, True], ids=["unshifted", "shifted"])
def test_fold_bwd_matches_jax_grad_of_trainable_block(shifted):
    """Against ``jax.grad`` of ``folded_block_attention_trainable`` (its
    custom VJP), d(bias) included."""
    a = _fold_case(seed=2)
    mask = jax_attn_mask(2, 14, 14, a["window"], (0, 3, 3)) if shifted else None
    probe = jnp.asarray(a["dout"])
    args = [jnp.asarray(a[k]) for k in
            ("x", "ln_s", "ln_b", "qkv_w", "qkv_b", "proj_w", "proj_b", "bias")]

    def loss(x, ln_s, ln_b, qkv_w, qkv_b, proj_w, proj_b, bias):
        o = folded_block_attention_trainable(
            x, ln_s, ln_b, qkv_w, qkv_b, proj_w, proj_b, bias,
            None if mask is None else jnp.asarray(mask), a["nh"], a["window"],
            a["scale"], True,
        )
        return jnp.sum(o * probe)

    want = jax.grad(loss, argnums=tuple(range(8)))(*args)
    got = _port_fold_bwd(a, mask, (0, 0, 0))
    # jax.grad's argument order is the port's return order
    for name, g, w in zip(FOLD_NAMES, got, want):
        assert_rel(name, g.numpy(), np.asarray(w))


@pytest.mark.parametrize("shifted", [False, True], ids=["unshifted", "shifted"])
def test_fold_attention_function_matches_autograd_of_plain(shifted):
    """The autograd Function (forward kernel A, backward kernel 6) against
    ``torch.autograd.grad`` of ``fold_attention_plain`` with the shift roll
    folded in."""
    a = _fold_case(seed=3)
    shift = (0, 3, 3) if shifted else (0, 0, 0)
    mask = T(jax_attn_mask(2, 14, 14, a["window"], shift)) if shifted else None
    names = ("x", "ln_s", "ln_b", "qkv_w", "qkv_b", "proj_w", "proj_b", "bias")
    grads = []
    for fn in (fold_attention, fold_attention_plain):
        leaves = [T(a[k]).clone().requires_grad_() for k in names]
        out = fn(*leaves[:7], leaves[7], mask, a["nh"], a["window"], a["scale"],
                 residual=True, shift=shift)
        grads.append(torch.autograd.grad((out * T(a["dout"])).sum(), leaves))
    for name, g, w in zip(names, *grads):
        assert_rel(name, g.numpy(), w.numpy())


def test_ln_mlp_bwd_matches_pallas_mlp_vjp():
    """``ln_mlp_bwd_plain`` against ``jax.vjp`` of ``fused_ln_mlp`` (its
    ``_bwd_kernel`` in interpret mode) at C=32 and 147 tokens, not a
    multiple of the Pallas tile."""
    rng = np.random.RandomState(4)
    C, Ch = 32, 128
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    x, dy = f(3, 1, 7, 7, C), f(3, 1, 7, 7, C)
    p = [1 + 0.1 * f(C), 0.1 * f(C), f(C, Ch) / np.sqrt(C), 0.1 * f(Ch),
         f(Ch, C) / np.sqrt(Ch), 0.1 * f(C)]
    _, vjp = jax.vjp(lambda *t: fused_ln_mlp(*t, True), jnp.asarray(x), *map(jnp.asarray, p))
    want = vjp(jnp.asarray(dy))
    got = ln_mlp_bwd_plain(T(x), T(dy), *map(T, p[:5]))
    # The port's GELU and its derivative use exact erf where Pallas uses the
    # A&S 7.1.26 erf (1.5e-7 abs): relative to max|grad| that is ~1e-7,
    # far inside the 1e-4 bound.  vjp order: x, ls, lb, w1, b1, w2, b2, the
    # port's return order.
    for name, g, w in zip(("dx", "dls", "dlb", "dw1", "db1", "dw2", "db2"), got, want):
        assert_rel(name, g.numpy(), np.asarray(w))


def test_ln_mlp_function_matches_autograd_of_plain():
    rng = np.random.RandomState(5)
    C = 32
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    vals = [f(2, 7, 7, C), 1 + 0.1 * f(C), 0.1 * f(C), f(C, 4 * C) / np.sqrt(C),
            0.1 * f(4 * C), f(4 * C, C) / np.sqrt(4 * C), 0.1 * f(C)]
    probe = T(f(2, 7, 7, C))
    grads = []
    for fn in (ln_mlp, ln_mlp_plain):
        leaves = [T(v).clone().requires_grad_() for v in vals]
        grads.append(torch.autograd.grad((fn(*leaves) * probe).sum(), leaves))
    for i, (g, w) in enumerate(zip(*grads)):
        assert_rel(f"arg {i}", g.numpy(), w.numpy())


def test_cluster_assign_grads_match_pallas_custom_vjp():
    rng = np.random.RandomState(6)
    tokens = rng.randn(128, 16).astype(np.float32)
    centers = rng.rand(12, 16).astype(np.float32)
    cot = rng.randn(128, 16).astype(np.float32)

    def loss_jax(t, c):
        o = fused_cluster_assign(t, c, 8.0, True)
        return jnp.sum(o.recon * cot) + jnp.sqrt(o.loss_sq_sum)

    want = jax.grad(loss_jax, argnums=(0, 1))(jnp.asarray(tokens), jnp.asarray(centers))
    t, c = T(tokens).requires_grad_(), T(centers).requires_grad_()
    o = cluster_assign(t, c, 8.0)
    got = torch.autograd.grad((o.recon * T(cot)).sum() + torch.sqrt(o.loss_sq_sum), (t, c))
    for name, g, w in zip(("d_tokens", "d_centers"), got, want):
        assert_rel(name, g.numpy(), np.asarray(w))
    assert not o.labels.requires_grad


def test_space_cluster_loss_grads_match_pallas_custom_vjp():
    rng = np.random.RandomState(7)
    maps = rng.randn(8, 4, 49).astype(np.float32)
    centers = rng.rand(8, 6, 49).astype(np.float32)
    want = jax.grad(lambda m, c: jnp.sqrt(fused_space_cluster_loss(m, c, 32.0, True)),
                    argnums=(0, 1))(jnp.asarray(maps), jnp.asarray(centers))
    m, c = T(maps).requires_grad_(), T(centers).requires_grad_()
    got = torch.autograd.grad(torch.sqrt(space_cluster_loss(m, c, 32.0)), (m, c))
    for name, g, w in zip(("d_maps", "d_centers"), got, want):
        assert_rel(name, g.numpy(), np.asarray(w))


def test_wrapper_outputs_carry_the_function_grad_fn():
    """The fault this slice repairs: the wrappers must be differentiable.
    On the CPU the outputs carry the autograd Function's node (on the card
    ``chip_smoke.py`` phase 3b checks the same through the whole model)."""
    a = _fold_case(seed=8)
    leaves = {k: T(a[k]).requires_grad_() for k in
              ("x", "ln_s", "ln_b", "qkv_w", "qkv_b", "proj_w", "proj_b", "bias")}
    out = fold_attention(*[leaves[k] for k in ("x", "ln_s", "ln_b", "qkv_w", "qkv_b",
                                               "proj_w", "proj_b", "bias")],
                         None, a["nh"], a["window"], a["scale"])
    assert "_FoldAttention" in out.grad_fn.name()
    x = torch.randn(5, 32, requires_grad=True)
    y = ln_mlp(x, torch.ones(32), torch.zeros(32), torch.randn(32, 128, requires_grad=True),
               torch.zeros(128), torch.randn(128, 32), torch.zeros(32))
    assert "_LnMlp" in y.grad_fn.name()
    c = torch.rand(6, 32, requires_grad=True)
    o = cluster_assign(x, c, 16.0)
    assert "_ClusterAssign" in o.recon.grad_fn.name()
    assert "_ClusterAssign" in o.loss_sq_sum.grad_fn.name()
    s = space_cluster_loss(torch.randn(4, 3, 9, requires_grad=True), torch.rand(4, 5, 9), 32.0)
    assert "_SpaceClusterLoss" in s.grad_fn.name()


def test_backward_counters_count_no_cpu_calls():
    from vadcl_tpu_torch.ops import KERNELS
    from vadcl_tpu_torch.ops.ln_mlp import ln_mlp_bwd

    assert fold_attention_bwd in KERNELS and ln_mlp_bwd in KERNELS
    before = [k.launches for k in KERNELS]
    a = _fold_case(seed=9)
    _port_fold_bwd(a, None, (0, 0, 0))
    assert [k.launches for k in KERNELS] == before
