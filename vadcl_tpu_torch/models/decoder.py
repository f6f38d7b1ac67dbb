"""Mirrored Swin + Inception decoder with reconstruction / prediction heads,
and the v1 conv decoder ``LegacySwinDecoder`` (``vadcl_tpu/models/decoder.py``).

``timedebd``: prediction collapses the latent time axis with Conv3d
k=s=(2,1,1); reconstruction expands it with ConvTranspose3d k=s=(2,1,1).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from vadcl_tpu_torch.models.encoder import inception_channels
from vadcl_tpu_torch.models.layers import (
    Conv3d,
    ConvTranspose3d,
    FrozenBatchNorm,
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


def _conv3x3(cin: int, cout: int) -> Conv3d:
    return Conv3d(cin, cout, (1, 3, 3), padding=(0, 1, 1))


def _conv_bn_relu2(m: nn.Module, name: str, y: torch.Tensor) -> torch.Tensor:
    """(conv (1,3,3) - frozen BN (eps 1e-3) - ReLU) twice, through ``m``'s
    ``<name>_conv1``, ``<name>_bn1``, ``<name>_conv2``, ``<name>_bn2``."""
    y = torch.relu(getattr(m, f"{name}_bn1")(getattr(m, f"{name}_conv1")(y)))
    return torch.relu(getattr(m, f"{name}_bn2")(getattr(m, f"{name}_conv2")(y)))


class LegacySwinDecoder(nn.Module):
    """The v1 conv-only decoder with a skip concatenation (the reference's
    ``model/swin_decoder.py``, superseded by ``SwinDecoder3D``; no
    ``VADModel`` builds it).  Its quirks are kept: the loop runs only its
    ``idx == 0`` iteration, so one tap is consumed, the taps taken in
    ``reversed(taps)[1:]`` order; the channel counts are the ones the JAX
    module's lazy shapes give (the torch original declares counts its own
    loop cannot feed): block0 takes ``in_chans + tap_channels`` to
    ``in_chans`` then ``in_chans // 2``, ``upsample0`` keeps ``in_chans //
    2``, the final block goes to ``in_chans // 4``, and ``patchdebed`` is one
    transposed conv with kernel = stride = ``patch_size``.  The parameter
    names are the JAX module's (``block0_conv1``, ..., ``patchdebed``)."""

    def __init__(self, in_chans: int, tap_channels: Optional[int] = None,
                 patch_size: Tuple[int, int, int] = (2, 4, 4), out_channels: int = 3):
        super().__init__()
        c = in_chans
        tap = c if tap_channels is None else tap_channels
        self.block0_conv1 = _conv3x3(c + tap, c)
        self.block0_bn1 = FrozenBatchNorm(c)
        self.block0_conv2 = _conv3x3(c, c // 2)
        self.block0_bn2 = FrozenBatchNorm(c // 2)
        self.upsample0 = ConvTranspose3d(c // 2, c // 2, (1, 2, 2), stride=(1, 2, 2))
        self.final_conv1 = _conv3x3(c // 2, c // 4)
        self.final_bn1 = FrozenBatchNorm(c // 4)
        self.final_conv2 = _conv3x3(c // 4, c // 4)
        self.final_bn2 = FrozenBatchNorm(c // 4)
        self.patchdebed = ConvTranspose3d(c // 4, out_channels, patch_size, stride=patch_size)

    def forward(self, x: torch.Tensor, taps: Sequence[torch.Tensor]) -> torch.Tensor:
        """x (B, D, H, W, in_chans), ``taps`` the encoder's taps in encoder
        order; the second-to-last must match x spatially."""
        first = list(taps)[::-1][1:][0]
        x = torch.cat([x, first.to(x.dtype)], dim=-1)
        x = self.upsample0(_conv_bn_relu2(self, "block0", x))
        x = _conv_bn_relu2(self, "final", x)
        return self.patchdebed(x)


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
