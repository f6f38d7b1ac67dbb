"""The 5-level residual 3D U-Net backbone (``vadcl_tpu/models/unet3d.py``):
a (1, 2, 2) max-pool encoder of double-conv blocks with a 1x1x1 residual
projection, (1, 4, 4) transposed-conv upsampling with skip concatenation,
and a sigmoid head.  Its BatchNorms are frozen (eps 1e-5), as the
reference freezes every BN."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from vadcl_tpu_torch.models.layers import Conv3d, ConvTranspose3d, FrozenBatchNorm
from vadcl_tpu_torch.ops.convs import max_pool3d

BN_EPS = 1e-5


class ConvBlock3D(nn.Module):
    """conv-BN-ReLU twice, plus a bias-free 1x1x1 projection of the input."""

    def __init__(self, cin: int, features: int, residual: bool = True):
        super().__init__()
        self.conv1 = Conv3d(cin, features, (1, 3, 3), padding=(0, 1, 1))
        self.bn1 = FrozenBatchNorm(features, BN_EPS)
        self.conv2 = Conv3d(features, features, (1, 3, 3), padding=(0, 1, 1))
        self.bn2 = FrozenBatchNorm(features, BN_EPS)
        if residual:
            self.residual = Conv3d(cin, features, (1, 1, 1), bias=False)
        else:
            self.residual = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        if self.residual is not None:
            y = y + self.residual(x)
        return y


class Deconv3DBlock(nn.Module):
    """ConvTranspose3d (1, 4, 4), stride (1, 2, 2), padding (0, 1, 1), then
    ReLU: doubles H and W."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.deconv = ConvTranspose3d(cin, features, (1, 4, 4), stride=(1, 2, 2),
                                      padding=(0, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.deconv(x))


def _max_pool_122(x: torch.Tensor) -> torch.Tensor:
    return max_pool3d(x, (1, 2, 2), (1, 2, 2))


class UNet3D(nn.Module):
    def __init__(self, num_channels: int = 3,
                 feat_channels: Sequence[int] = (64, 128, 256, 512, 1024),
                 residual: bool = True):
        super().__init__()
        f = tuple(feat_channels)
        self.enc1 = ConvBlock3D(num_channels, f[0], residual)
        self.enc2 = ConvBlock3D(f[0], f[1], residual)
        self.enc3 = ConvBlock3D(f[1], f[2], residual)
        self.enc4 = ConvBlock3D(f[2], f[3], residual)
        self.base = ConvBlock3D(f[3], f[4], residual)
        self.up4 = Deconv3DBlock(f[4], f[3])
        self.dec4 = ConvBlock3D(2 * f[3], f[3], residual)
        self.up3 = Deconv3DBlock(f[3], f[2])
        self.dec3 = ConvBlock3D(2 * f[2], f[2], residual)
        self.up2 = Deconv3DBlock(f[2], f[1])
        self.dec2 = ConvBlock3D(2 * f[1], f[1], residual)
        self.up1 = Deconv3DBlock(f[1], f[0])
        self.dec1 = ConvBlock3D(2 * f[0], f[0], residual)
        self.head = Conv3d(f[0], num_channels, (1, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, D, H, W, C), H and W multiples of 16 -> the sigmoid
        reconstruction, same shape."""
        x1 = self.enc1(x)
        x2 = self.enc2(_max_pool_122(x1))
        x3 = self.enc3(_max_pool_122(x2))
        x4 = self.enc4(_max_pool_122(x3))
        base = self.base(_max_pool_122(x4))
        d4 = self.dec4(torch.cat([self.up4(base), x4], -1))
        d3 = self.dec3(torch.cat([self.up3(d4), x3], -1))
        d2 = self.dec2(torch.cat([self.up2(d3), x2], -1))
        d1 = self.dec1(torch.cat([self.up1(d2), x1], -1))
        return torch.sigmoid(self.head(d1))
