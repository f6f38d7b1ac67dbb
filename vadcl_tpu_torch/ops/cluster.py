"""Euclidean soft-assignment clustering primitives (``vadcl_tpu/ops/cluster.py``).

All distance and softmax math is fp32: bf16 cancellation in the expanded
cdist can flip argmin labels.  These functions are also the plain versions
that the cluster kernels (``ops/cluster_kernels.py``) are checked against.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F


def cdist(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Pairwise Euclidean distance in torch.cdist's matmul form:
    sqrt(max(|x|^2 + |c|^2 - 2 x c^T, 0)).  x (..., N, D), c (..., K, D)
    -> (..., N, K), leading dims broadcast."""
    x = x.float()
    c = c.float()
    x_sq = (x * x).sum(-1, keepdim=True)  # (..., N, 1)
    c_sq = (c * c).sum(-1).unsqueeze(-2)  # (..., 1, K)
    cross = x @ c.transpose(-2, -1)
    d2 = x_sq + c_sq - 2.0 * cross
    return torch.sqrt(torch.clamp(d2, min=0.0))


def neg_soft_assign(d: torch.Tensor, alpha: float) -> torch.Tensor:
    """softmax(-alpha * (d - min(d))) over the last axis (NegSoftAssign)."""
    d = d.float()
    d_min = d.min(-1, keepdim=True).values
    e = torch.exp(-alpha * (d - d_min))
    return e / e.sum(-1, keepdim=True)


def pos_soft_assign(x: torch.Tensor, alpha: float) -> torch.Tensor:
    """softmax(alpha * (x - max(x))) over the last axis (PosSoftAssign)."""
    x = x.float()
    e = torch.exp(alpha * (x - x.max(-1, keepdim=True).values))
    return e / e.sum(-1, keepdim=True)


class ClusterAssignment(NamedTuple):
    distance: torch.Tensor  # (B, D, H, W, K) fp32
    assign: torch.Tensor  # (B, D, H, W, K) fp32 soft assignment
    labels: torch.Tensor  # (B*D*H*W,) int32 argmin hard labels
    recon: torch.Tensor  # (B, D, H, W, C) soft reconstruction assign @ centers
    center_self_distance: torch.Tensor  # (K, K)


def feature_cluster_assign(
    x: torch.Tensor, centers: torch.Tensor, alpha: float
) -> ClusterAssignment:
    """Feature-level clustering of post-LayerNorm x (B, D, H, W, C) against
    centers (K, C)."""
    B, D, H, W, C = x.shape
    tokens = x.reshape(B, D * H * W, C)
    dist = cdist(tokens, centers[None])  # (B, N, K)
    # torch.argmin returns the first occurrence of the minimum, like jnp
    labels = dist.argmin(-1).reshape(-1).to(torch.int32)
    assign = neg_soft_assign(dist, alpha)
    recon = assign @ centers.float()
    K = centers.shape[0]
    return ClusterAssignment(
        distance=dist.reshape(B, D, H, W, K),
        assign=assign.reshape(B, D, H, W, K),
        labels=labels,
        recon=recon.reshape(B, D, H, W, C).to(x.dtype),
        center_self_distance=cdist(centers, centers),
    )


class SpaceClusterAssignment(NamedTuple):
    distance: torch.Tensor  # (B, D, C, K) fp32
    assign: torch.Tensor  # (B, D, C, K) fp32
    center_self_distance: torch.Tensor  # (C, K, K)


def space_cluster_assign(
    x: torch.Tensor, centers: torch.Tensor, alpha: float
) -> SpaceClusterAssignment:
    """Spatial-pattern clustering: every channel clusters its (H*W) maps
    independently.  x (B, D, H, W, C) after LayerNorm; centers (C, K, H*W)."""
    B, D, H, W, C = x.shape
    maps = x.permute(4, 0, 1, 2, 3).reshape(C, B * D, H * W)
    dist = cdist(maps, centers)  # (C, B*D, K)
    K = centers.shape[1]
    dist_bd = dist.reshape(C, B, D, K).permute(1, 2, 0, 3)
    return SpaceClusterAssignment(
        distance=dist_bd,
        assign=neg_soft_assign(dist_bd, alpha),
        center_self_distance=cdist(centers, centers),
    )


def frobenius_norm(x: torch.Tensor, global_sum=None) -> torch.Tensor:
    """torch.norm(x): Frobenius norm over the whole tensor, fp32.
    ``global_sum`` (``parallel.sharding.global_sum`` in a data-parallel
    train step) sums the squares over every process's shard before the
    root, so the norm is the global batch's."""
    x = x.float()
    s = (x * x).sum()
    return torch.sqrt(s if global_sum is None else global_sum(s))


def cluster_alpha_schedule(max_n: int = 40) -> np.ndarray:
    """The reference's annealing schedule of the soft-assign temperature
    (defined, unused by its live path): alphas[0] = 0.1, alphas[i] =
    2^(1 / log(i + 1)^2) * alphas[i - 1], in float64."""
    alphas = np.zeros(max_n, dtype=np.float64)
    alphas[0] = 0.1
    for i in range(1, max_n):
        alphas[i] = (2 ** (1 / (np.log(i + 1)) ** 2)) * alphas[i - 1]
    return alphas


def l1_recon_loss(recon: torch.Tensor, target: torch.Tensor, patch_t: int = 2) -> torch.Tensor:
    """The reference's ``Recon_Loss``: zero-pad the time axis of both
    (B, T, H, W, C) tensors to a multiple of the temporal patch, then the
    mean absolute error (the padded frames count in the mean)."""
    pad = (-target.shape[1]) % patch_t
    if pad:
        target = F.pad(target, (0, 0, 0, 0, 0, 0, 0, pad))
        recon = F.pad(recon, (0, 0, 0, 0, 0, 0, 0, pad))
    return (recon.float() - target.float()).abs().mean()
