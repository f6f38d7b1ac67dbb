"""Hybrid Video-Swin-3D + I3D-Inception encoder (``vadcl_tpu/models/encoder.py``).

Each stage fuses windowed attention with a parallel Inception branch as
``x = attn + attn * conv + x``; a strided conv + GELU downsamples between
stages.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn

from vadcl_tpu_torch.models.layers import Conv3d, InceptionModule, gelu
from vadcl_tpu_torch.models.swin import PatchEmbed3D, SwinStage

# Inception branch channel plans per stage dim (model/swin_transformer.py:550-555).
INCEPTION_CHANNELS = {
    96: (16, 32, 48, 9, 16, 16),
    192: (32, 64, 96, 16, 32, 32),
    384: (128, 96, 128, 32, 64, 64),
    768: (256, 112, 256, 32, 128, 128),
}


def inception_channels(dim: int) -> Tuple[int, ...]:
    """The reference's branch plan for its dims, a proportional split
    (b0+b1b+b2b+b3b == dim) for any other width."""
    if dim in INCEPTION_CHANNELS:
        return INCEPTION_CHANNELS[dim]
    b0 = max(dim // 6, 1)
    b1b = max(dim // 2, 1)
    b2b = max(dim // 6, 1)
    b3b = dim - (b0 + b1b + b2b)
    if b3b < 1:
        raise ValueError(f"dim {dim} too small for an Inception split")
    return (b0, max(dim // 3, 1), b1b, max(dim // 12, 1), b2b, b3b)


class SwinEncoder3D(nn.Module):
    def __init__(self, patch_size=(2, 4, 4), in_channels: int = 3,
                 embed_dim: int = 96, depths: Sequence[int] = (3, 6),
                 num_heads: Sequence[int] = (6, 12), window_size=(8, 7, 7),
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 fused_attention: bool = False, attn_kernel: str = "base"):
        super().__init__()
        self.num_layers = len(depths)
        self.patch_embed = PatchEmbed3D(patch_size, in_channels, embed_dim)
        for i in range(self.num_layers):
            dim = int(embed_dim * 2**i)
            self.add_module(f"stage{i}", SwinStage(
                dim, depths[i], num_heads[i], window_size, mlp_ratio, qkv_bias,
                fused=fused_attention, attn_kernel=attn_kernel,
            ))
            self.add_module(f"inception{i}", InceptionModule(dim, inception_channels(dim)))
            if i < self.num_layers - 1:
                self.add_module(f"downsample{i}", Conv3d(
                    dim, dim * 2, (1, 2, 2), stride=(1, 2, 2)
                ))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, D, H, W, C) raw clip -> latent
        (B, D/pd, H/(4*2^(L-1)), W/(4*2^(L-1)), embed_dim*2^(L-1))."""
        x = self.patch_embed(x)
        for i in range(self.num_layers):
            attn_x = getattr(self, f"stage{i}")(x)
            conv_x = getattr(self, f"inception{i}")(x)
            x = attn_x + attn_x * conv_x + x
            if i < self.num_layers - 1:
                x = gelu(getattr(self, f"downsample{i}")(x))
        return x
