"""Dual Euclidean soft-assignment clustering heads
(``vadcl_tpu/models/cluster_heads.py``).

Each head LayerNorms its input in fp32, then either runs the plain
cdist -> argmin -> soft-assign math (``ops/cluster.py``) or, with
``fused=True``, the hand-written kernels C / D (``ops/cluster_kernels.py``),
which never materialise the distance or assignment tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn as nn

from vadcl_tpu_torch.models.layers import LayerNorm
from vadcl_tpu_torch.ops.cluster import feature_cluster_assign, space_cluster_assign
from vadcl_tpu_torch.ops.cluster_kernels import cluster_assign, space_cluster_loss


class FeatureClusterOut(NamedTuple):
    distance: Optional[torch.Tensor]  # (B, D, H, W, K); None on the fused path
    assign: Optional[torch.Tensor]  # (B, D, H, W, K); None on the fused path
    labels: torch.Tensor  # (B*D*H*W,) int32
    recon: torch.Tensor  # (B, D, H, W, C) soft reconstruction
    feature: torch.Tensor  # (B*D*H*W, C) LayerNormed tokens
    center_self_distance: Optional[torch.Tensor]  # (K, K); None when fused
    loss_sq_sum: Optional[torch.Tensor]  # fused path: sum((dist*assign)^2)


class FeatureClusterHead(nn.Module):
    """EuclidDistance_Assign_Module parity (``model/cluster.py:58-99``)."""

    def __init__(self, dim: int, clusters: int = 1024, alpha: float = 16.0,
                 fused: bool = False):
        super().__init__()
        self.alpha, self.fused = alpha, fused
        self.cluster_center = nn.Parameter(torch.empty(clusters, dim))
        self.norm = LayerNorm(dim)

    def reset_parameters(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.cluster_center.copy_(torch.rand(self.cluster_center.shape, generator=gen))

    def forward(self, x: torch.Tensor) -> FeatureClusterOut:
        B, D, H, W, C = x.shape
        xn = self.norm(x.float())
        feature = xn.reshape(-1, C)
        if self.fused:
            fo = cluster_assign(feature, self.cluster_center, self.alpha)
            return FeatureClusterOut(
                distance=None, assign=None, labels=fo.labels,
                recon=fo.recon.reshape(B, D, H, W, C).to(x.dtype),
                feature=feature, center_self_distance=None,
                loss_sq_sum=fo.loss_sq_sum,
            )
        out = feature_cluster_assign(xn, self.cluster_center, self.alpha)
        return FeatureClusterOut(
            distance=out.distance, assign=out.assign, labels=out.labels,
            recon=out.recon.to(x.dtype), feature=feature,
            center_self_distance=out.center_self_distance, loss_sq_sum=None,
        )


class SpaceClusterOut(NamedTuple):
    distance: Optional[torch.Tensor]  # (B, D, C, K); None on the fused path
    assign: Optional[torch.Tensor]  # (B, D, C, K); None on the fused path
    center_self_distance: Optional[torch.Tensor]  # (C, K, K); None when fused
    loss_sq_sum: Optional[torch.Tensor]  # fused path: sum((dist*assign)^2)


class SpaceClusterHead(nn.Module):
    """Space_EuclidDistance_Assign_Module parity (``model/cluster.py:102-149``):
    per-channel clustering of (space_size^2)-d spatial maps."""

    def __init__(self, dim: int, clusters: int = 128, alpha: float = 32.0,
                 space_size: int = 28, fused: bool = False):
        super().__init__()
        self.alpha, self.space_size, self.fused = alpha, space_size, fused
        self.cluster_center = nn.Parameter(
            torch.empty(dim, clusters, space_size * space_size)
        )
        self.norm = LayerNorm(dim)

    def reset_parameters(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.cluster_center.copy_(torch.rand(self.cluster_center.shape, generator=gen))

    def forward(self, x: torch.Tensor) -> SpaceClusterOut:
        B, D, H, W, C = x.shape
        if H * W != self.space_size**2:
            raise ValueError(
                f"space head configured for {self.space_size}^2 spatial maps, "
                f"got {H}x{W}"
            )
        xn = self.norm(x.float())
        if self.fused:
            maps = xn.permute(4, 0, 1, 2, 3).reshape(C, B * D, H * W)
            return SpaceClusterOut(
                distance=None, assign=None, center_self_distance=None,
                loss_sq_sum=space_cluster_loss(maps, self.cluster_center, self.alpha),
            )
        out = space_cluster_assign(xn, self.cluster_center, self.alpha)
        return SpaceClusterOut(
            distance=out.distance, assign=out.assign,
            center_self_distance=out.center_self_distance, loss_sq_sum=None,
        )
