"""Mirrored Swin + Inception decoder with reconstruction / prediction heads
(``vadcl_tpu/models/decoder.py``; ``LegacySwinDecoder`` is not ported).

``timedebd``: prediction collapses the latent time axis with Conv3d
k=s=(2,1,1); reconstruction expands it with ConvTranspose3d k=s=(2,1,1).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from vadcl_tpu_torch.models.encoder import inception_channels
from vadcl_tpu_torch.models.layers import (
    Conv3d,
    ConvTranspose3d,
    InceptionModule,
    LayerNorm,
    gelu,
)
from vadcl_tpu_torch.models.swin import SwinStage


class UpSampling(nn.Module):
    """ConvTranspose3d(1,2,2) stride (1,2,2) halving channels, + GELU."""

    def __init__(self, dim: int):
        super().__init__()
        self.proj = ConvTranspose3d(dim, dim // 2, (1, 2, 2), stride=(1, 2, 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gelu(self.proj(x))


class PatchDebed3D(nn.Module):
    """Inverse patchify: ConvT(3,2,2)s(1,2,2) -> GELU -> Conv3d(3,3,3) ->
    GELU -> ConvT(3,2,2)s(1,2,2)."""

    def __init__(self, in_channels: int, out_channels: int = 3):
        super().__init__()
        c = in_channels
        self.deconv1 = ConvTranspose3d(c, 2 * c, (3, 2, 2), stride=(1, 2, 2), padding=(1, 0, 0))
        self.conv = Conv3d(2 * c, c, (3, 3, 3), padding=(1, 1, 1))
        self.deconv2 = ConvTranspose3d(c, out_channels, (3, 2, 2), stride=(1, 2, 2), padding=(1, 0, 0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = gelu(self.deconv1(x))
        x = gelu(self.conv(x))
        return self.deconv2(x)


class SwinDecoder3D(nn.Module):
    def __init__(self, in_chans: int = 192, depths: Sequence[int] = (6, 3),
                 num_heads: Sequence[int] = (12, 6), window_size=(8, 7, 7),
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 predict: bool = False, out_channels: int = 3,
                 fused_attention: bool = False, attn_kernel: str = "base"):
        super().__init__()
        self.num_layers = len(depths)
        conv = Conv3d if predict else ConvTranspose3d
        self.timedebd = conv(in_chans, in_chans, (2, 1, 1), stride=(2, 1, 1))
        for i in range(self.num_layers):
            dim = in_chans // (2**i)
            self.add_module(f"inception{i}", InceptionModule(dim, inception_channels(dim)))
            self.add_module(f"stage{i}", SwinStage(
                dim, depths[i], num_heads[i], window_size, mlp_ratio, qkv_bias,
                fused=fused_attention, attn_kernel=attn_kernel,
            ))
            if i < self.num_layers - 1:
                self.add_module(f"upsample{i}", UpSampling(dim))
        last = in_chans // (2 ** (self.num_layers - 1))
        self.norm = LayerNorm(last)
        self.patchdebed = PatchDebed3D(last, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, D, H, W, in_chans) latent -> (B, D_out, H*8, W*8, 3);
        D_out = D/2 (predict) or 2D (reconstruction)."""
        x = self.timedebd(x)
        for i in range(self.num_layers):
            conv_x = getattr(self, f"inception{i}")(x)
            attn_x = getattr(self, f"stage{i}")(x)
            x = attn_x + conv_x * attn_x + x
            if i < self.num_layers - 1:
                x = getattr(self, f"upsample{i}")(x)
        return self.patchdebed(self.norm(x))
