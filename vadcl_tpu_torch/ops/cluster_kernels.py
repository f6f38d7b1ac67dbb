"""Kernels C and D: the fused cluster-assignment and space-cluster-loss heads.

C replaces ``vadcl_tpu/ops/pallas_cluster.py:_cluster_kernel`` (entry
``fused_cluster_assign``); D replaces ``_space_kernel`` (entry
``fused_space_cluster_loss``).  C is in ``csrc/cluster_mma.cu``, D in
``csrc/space_cluster_mma.cu``: tensor-core products on operands split into
two tf32 parts (3xTF32, fp32-level accuracy whatever
``torch.backends.cuda.matmul.allow_tf32`` says) and an online soft-assign
over chunks of centers with no (rows x K) tile; C takes any N and K and
C <= 6144: one block per row tile up to 768 (``cluster_assign_shape``
mirrors the instance a width takes), above it a thread-block cluster of 2, 4
or 8 blocks splitting the channels (``cluster_assign_blocks``); D any
shape.  Both use the expanded cdist form and a deterministic
two-pass reduction of the loss (``csrc/cluster.cu``); C's labels are the
first-occurrence argmin.

Both wrappers are ``torch.autograd.Function``s.  Their backward is what the
JAX package's custom VJPs (``_bwd``, ``_space_bwd``) do: recompute the plain
forward and differentiate it (an XLA ``jax.vjp`` there, autograd here); the
Pallas package has no backward kernel for these heads.  The labels get no
gradient.

On CPU tensors the forwards run the plain versions below (built from
``ops/cluster.py``); on CUDA tensors they launch the kernels or raise.
Bounds on the card and the designs are in the headers of the two sources.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vadcl_tpu_torch.ops import cuda_lib
from vadcl_tpu_torch.ops import library as _library
from vadcl_tpu_torch.ops.cluster import cdist, neg_soft_assign


class FusedClusterOut(NamedTuple):
    recon: torch.Tensor  # (N, C) fp32
    labels: torch.Tensor  # (N,) int32
    loss_sq_sum: torch.Tensor  # scalar fp32: sum((dist*assign)^2)


def cluster_assign_plain(tokens, centers, alpha: float) -> FusedClusterOut:
    """Plain version of kernel C: cdist -> first argmin -> NegSoftAssign ->
    recon = assign @ centers, and sum((d * assign)^2)."""
    d = cdist(tokens, centers)
    labels = d.argmin(-1).to(torch.int32)
    assign = neg_soft_assign(d, alpha)
    recon = assign @ centers.float()
    da = d * assign
    return FusedClusterOut(recon=recon, labels=labels, loss_sq_sum=(da * da).sum())


def space_cluster_loss_plain(maps, centers, alpha: float) -> torch.Tensor:
    """Plain version of kernel D: sum((d * assign)^2) of the per-channel
    batched cdist of maps (Cc, BD, HW) against centers (Cc, K, HW)."""
    d = cdist(maps, centers)
    a = neg_soft_assign(d, alpha)
    da = d * a
    return (da * da).sum()


# Kernel C's instances (csrc/cluster_mma.cu:kCaShapes): channel tiles of 8
# (C <= 8 * tiles), channel parts (warps of a row tile splitting the recon's
# channels; 4 / parts row tiles of 16 tokens a block), centers per ring stage,
# ring stages.
CLUSTER_SHAPES = ((2, 1, 32, 2), (4, 1, 32, 2), (8, 1, 32, 2), (12, 1, 32, 2),
                  (16, 1, 32, 2), (24, 1, 32, 2), (32, 2, 32, 2), (48, 2, 16, 2),
                  (64, 4, 16, 2), (96, 4, 16, 1))
CLUSTER_BLOCK_C = 8 * CLUSTER_SHAPES[-1][0]  # the widest one block holds (768)
CLUSTER_SPLITS = (1, 2, 4, 8)  # blocks of a cluster splitting the channels
CLUSTER_MAX_C = CLUSTER_SPLITS[-1] * CLUSTER_BLOCK_C


def cluster_assign_blocks(c: int) -> int:
    """Blocks sharing a row tile at width ``c``, each on a slab of
    ``ceil(c / blocks)`` channels (``csrc/cluster_mma.cu:ca_blocks``): 1 up
    to 768, then the fewest of 2, 4, 8 whose slabs fit 768.  Raises above
    ``CLUSTER_MAX_C`` (6144)."""
    for blocks in CLUSTER_SPLITS:
        if 0 < c <= blocks * CLUSTER_BLOCK_C:
            return blocks
    raise ValueError(f"cluster_assign: the kernel takes 1 <= C <= {CLUSTER_MAX_C}, got C={c}")


def cluster_assign_shape(c: int) -> tuple:
    """(tiles, parts, chunk, stages) of the instance each block of kernel C
    runs at width ``c`` (``csrc/cluster_mma.cu:ca_shape``): the first whose
    channel tiles hold C, or above 768 its slab of the channels
    (``cluster_assign_blocks``).  Raises above ``CLUSTER_MAX_C`` (6144)."""
    blocks = cluster_assign_blocks(c)
    slab = -(-c // blocks)
    return next(shape for shape in CLUSTER_SHAPES if slab <= 8 * shape[0])


def _f32c(t: torch.Tensor) -> torch.Tensor:
    return t.detach().float().contiguous()


def _recompute_grads(plain, inputs, outputs_grads):
    """Gradients of ``plain(*inputs)`` for the given output gradients, by
    autograd through the plain version (the custom VJPs' XLA recompute)."""
    with torch.enable_grad():
        leaves = [t.detach().float().requires_grad_() for t in inputs]
        outs = plain(*leaves)
        grads = torch.autograd.grad(outs, leaves, outputs_grads)
    return [g.to(t.dtype) for g, t in zip(grads, inputs)]


class _ClusterAssign(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tokens, centers, alpha):
        ctx.save_for_backward(tokens, centers)
        ctx.alpha = alpha
        out = FusedClusterOut(*_library.cluster_assign(tokens, centers, alpha))
        ctx.mark_non_differentiable(out.labels)
        return tuple(out)

    @staticmethod
    def backward(ctx, d_recon, _d_labels, d_loss):
        alpha = ctx.alpha

        def plain(t, c):
            out = cluster_assign_plain(t, c, alpha)
            return out.recon, out.loss_sq_sum

        d_tokens, d_centers = _recompute_grads(plain, ctx.saved_tensors, (d_recon, d_loss))
        return d_tokens, d_centers, None


def cluster_assign(tokens, centers, alpha: float) -> FusedClusterOut:
    """tokens (N, C) post-LayerNorm, centers (K, C) -> recon, labels and
    the loss sum of squares (cluster loss = its sqrt); differentiable in
    tokens and centers."""
    if tokens.device.type not in ("cpu", "cuda"):
        raise ValueError(f"cluster_assign: unsupported device {tokens.device}")
    return FusedClusterOut(*_ClusterAssign.apply(tokens, centers, alpha))


def _cluster_assign_cuda(tokens, centers, alpha: float) -> FusedClusterOut:
    n, c = tokens.shape
    k, c2 = centers.shape
    if c2 != c:
        raise ValueError(f"cluster_assign: tokens {tuple(tokens.shape)} vs centers {tuple(centers.shape)}")
    cluster_assign_shape(c)  # (raises above the widest split)
    lib = cuda_lib.library()
    n_scratch = lib.vadcl_cluster_assign_scratch(n, c, k)
    if n_scratch < 0:
        raise ValueError(f"cluster_assign: the kernel takes N, K >= 1, got tokens "
                         f"{tuple(tokens.shape)}, centers {tuple(centers.shape)}")
    x = _f32c(tokens)
    cen = _f32c(centers.to(tokens.device))
    recon = torch.empty((n, c), dtype=torch.float32, device=x.device)
    labels = torch.empty((n,), dtype=torch.int32, device=x.device)
    scratch = torch.empty((n_scratch,), dtype=torch.float32, device=x.device)
    loss = torch.empty((), dtype=torch.float32, device=x.device)
    err = lib.vadcl_cluster_assign(
        x.data_ptr(), cen.data_ptr(), recon.data_ptr(), labels.data_ptr(),
        scratch.data_ptr(), loss.data_ptr(), n, c, k, float(alpha),
        cuda_lib.stream_ptr(x),
    )
    cuda_lib.check(err, "cluster_assign")
    cluster_assign.launches += 1
    return FusedClusterOut(recon=recon, labels=labels, loss_sq_sum=loss)


cluster_assign.launches = 0


class _SpaceClusterLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, maps, centers, alpha):
        ctx.save_for_backward(maps, centers)
        ctx.alpha = alpha
        return _library.space_cluster_loss(maps, centers, alpha)

    @staticmethod
    def backward(ctx, d_loss):
        alpha = ctx.alpha
        d_maps, d_centers = _recompute_grads(
            lambda m, c: space_cluster_loss_plain(m, c, alpha), ctx.saved_tensors, d_loss
        )
        return d_maps, d_centers, None


def space_cluster_loss(maps, centers, alpha: float) -> torch.Tensor:
    """maps (Cc, BD, HW) post-LayerNorm, centers (Cc, K, HW) -> scalar
    sum((d * assign)^2) (space loss = its sqrt); differentiable in maps and
    centers."""
    if maps.device.type not in ("cpu", "cuda"):
        raise ValueError(f"space_cluster_loss: unsupported device {maps.device}")
    return _SpaceClusterLoss.apply(maps, centers, alpha)


def _space_cluster_loss_cuda(maps, centers, alpha: float) -> torch.Tensor:
    cc, bd, hw = maps.shape
    cc2, k, hw2 = centers.shape
    if (cc2, hw2) != (cc, hw):
        raise ValueError(f"space_cluster_loss: maps {tuple(maps.shape)} vs centers {tuple(centers.shape)}")
    lib = cuda_lib.library()
    n_scratch = lib.vadcl_space_cluster_scratch(cc, bd)
    if n_scratch < 0 or hw <= 0 or k <= 0:
        raise ValueError(f"space_cluster_loss: the kernel takes non-empty inputs, got maps "
                         f"{tuple(maps.shape)}, centers {tuple(centers.shape)}")
    x = _f32c(maps)
    cen = _f32c(centers.to(maps.device))
    scratch = torch.empty((n_scratch,), dtype=torch.float32, device=x.device)
    loss = torch.empty((), dtype=torch.float32, device=x.device)
    err = lib.vadcl_space_cluster_loss(
        x.data_ptr(), cen.data_ptr(), scratch.data_ptr(), loss.data_ptr(),
        cc, bd, hw, k, float(alpha), cuda_lib.stream_ptr(x),
    )
    cuda_lib.check(err, "space_cluster_loss")
    space_cluster_loss.launches += 1
    return loss


space_cluster_loss.launches = 0
