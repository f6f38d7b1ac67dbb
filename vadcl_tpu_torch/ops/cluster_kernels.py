"""Kernels C and D: the fused cluster-assignment and space-cluster-loss heads.

C replaces ``vadcl_tpu/ops/pallas_cluster.py:_cluster_kernel`` (entry
``fused_cluster_assign``); D replaces ``_space_kernel`` (entry
``fused_space_cluster_loss``).  Both CUDA kernels are in ``csrc/cluster.cu``:
fp32 FMA only (no TF32), the expanded cdist form, first-occurrence argmin,
and a deterministic two-pass reduction of the loss.

On CPU tensors the wrappers run the plain versions below (built from
``ops/cluster.py``); on CUDA tensors they launch the kernels or raise.
Bounds on the card and what the simple design leaves are in the header of
``csrc/cluster.cu``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vadcl_tpu_torch.ops import cuda_lib
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


def _f32c(t: torch.Tensor) -> torch.Tensor:
    return t.detach().float().contiguous()


def cluster_assign(tokens, centers, alpha: float) -> FusedClusterOut:
    """tokens (N, C) post-LayerNorm, centers (K, C) -> recon, labels and
    the loss sum of squares (cluster loss = its sqrt)."""
    if tokens.device.type == "cpu":
        return cluster_assign_plain(tokens, centers, alpha)
    if tokens.device.type != "cuda":
        raise ValueError(f"cluster_assign: unsupported device {tokens.device}")
    n, c = tokens.shape
    k, c2 = centers.shape
    if c2 != c:
        raise ValueError(f"cluster_assign: tokens {tuple(tokens.shape)} vs centers {tuple(centers.shape)}")
    lib = cuda_lib.library()
    x = _f32c(tokens)
    cen = _f32c(centers.to(tokens.device))
    recon = torch.empty((n, c), dtype=torch.float32, device=x.device)
    labels = torch.empty((n,), dtype=torch.int32, device=x.device)
    scratch = torch.empty(
        (lib.vadcl_cluster_assign_scratch(n, k),), dtype=torch.float32, device=x.device
    )
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


def space_cluster_loss(maps, centers, alpha: float) -> torch.Tensor:
    """maps (Cc, BD, HW) post-LayerNorm, centers (Cc, K, HW) -> scalar
    sum((d * assign)^2) (space loss = its sqrt)."""
    if maps.device.type == "cpu":
        return space_cluster_loss_plain(maps, centers, alpha)
    if maps.device.type != "cuda":
        raise ValueError(f"space_cluster_loss: unsupported device {maps.device}")
    cc, bd, hw = maps.shape
    cc2, k, hw2 = centers.shape
    if (cc2, hw2) != (cc, hw):
        raise ValueError(f"space_cluster_loss: maps {tuple(maps.shape)} vs centers {tuple(centers.shape)}")
    lib = cuda_lib.library()
    x = _f32c(maps)
    cen = _f32c(centers.to(maps.device))
    scratch = torch.empty(
        (lib.vadcl_space_cluster_scratch(cc, bd),), dtype=torch.float32, device=x.device
    )
    loss = torch.empty((), dtype=torch.float32, device=x.device)
    err = lib.vadcl_space_cluster_loss(
        x.data_ptr(), cen.data_ptr(), scratch.data_ptr(), loss.data_ptr(),
        cc, bd, hw, k, float(alpha), cuda_lib.stream_ptr(x),
    )
    cuda_lib.check(err, "space_cluster_loss")
    space_cluster_loss.launches += 1
    return loss


space_cluster_loss.launches = 0
