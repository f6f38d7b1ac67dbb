"""The memory-augmented 2D conv autoencoders of MNAD
(``vadcl_tpu/models/conv_ae.py``), with the JAX modules' names so that
parameter paths map one to one.

* ``ConvAE``: reconstruction; t_length frames stacked channel-wise, a
  3-level pooled conv encoder to 512-d features, the memory read doubling
  the channels, a decoder without skips and a Tanh head that reconstructs
  every frame.
* ``ConvAEPredict``: future-frame prediction; t_length - 1 input frames,
  U-Net skips concatenated before each decoder block, a single Tanh frame.

Frames enter as (B, T, H, W, C) and are flattened to (B, H, W, T*C); the 2D
convs are the NDHWC 3D convs with depth 1.  Flax infers the first conv's
input channels from the sample clip; a torch module declares them, so each
model is built for one number of input frames and refuses another.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn as nn

from vadcl_tpu_torch.models.layers import Conv3d, ConvTranspose3d, FrozenBatchNorm
from vadcl_tpu_torch.models.memory import MemoryModule, MemoryOut
from vadcl_tpu_torch.ops.convs import max_pool3d
from vadcl_tpu_torch.ops.memory import Reduce

BN_EPS = 1e-5  # torch's BatchNorm2d default, which the MNAD models keep
FEATURES = 512  # the encoder's output width: the memory's query width


def _conv3x3(cin: int, cout: int) -> Conv3d:
    return Conv3d(cin, cout, (1, 3, 3), padding=(0, 1, 1))


class _Basic(nn.Module):
    """conv3-BN-ReLU twice; without ``final_relu`` the second conv stands
    alone (no ``bn2``)."""

    def __init__(self, cin: int, features: int, final_relu: bool = True):
        super().__init__()
        self.conv1 = _conv3x3(cin, features)
        self.bn1 = FrozenBatchNorm(features, BN_EPS)
        self.conv2 = _conv3x3(features, features)
        self.final_relu = final_relu
        if final_relu:
            self.bn2 = FrozenBatchNorm(features, BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.bn1(self.conv1(x[:, None])))
        x = self.conv2(x)
        if self.final_relu:
            x = torch.relu(self.bn2(x))
        return x[:, 0]


class _Gen(nn.Module):
    """conv-BN-ReLU twice, a conv and Tanh."""

    def __init__(self, cin: int, features: int, hidden: int):
        super().__init__()
        self.conv1 = _conv3x3(cin, hidden)
        self.bn1 = FrozenBatchNorm(hidden, BN_EPS)
        self.conv2 = _conv3x3(hidden, hidden)
        self.bn2 = FrozenBatchNorm(hidden, BN_EPS)
        self.conv3 = _conv3x3(hidden, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.bn1(self.conv1(x[:, None])))
        x = torch.relu(self.bn2(self.conv2(x)))
        return torch.tanh(self.conv3(x)[:, 0])


class _Upsample(ConvTranspose3d):
    """ConvTranspose2d(k=3, s=2, p=1, output_padding=1) + BN + ReLU: doubles
    H and W.  Its kernel and bias sit on the module itself (the JAX
    module's raw ``kernel`` / ``bias``), in the (Cin, Cout, 1, 3, 3) layout
    of every transposed conv of the port."""

    def __init__(self, cin: int, features: int):
        super().__init__(cin, features, (1, 3, 3), stride=(1, 2, 2), padding=(0, 1, 1),
                         output_padding=(0, 1, 1))
        self.bn = FrozenBatchNorm(features, BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(super().forward(x[:, None])))[:, 0]


def _max_pool_2d(x: torch.Tensor) -> torch.Tensor:
    """VALID 2x2 max-pool of (B, H, W, C)."""
    return max_pool3d(x[:, None], (1, 2, 2), (1, 2, 2))[:, 0]


class ConvAEOut(NamedTuple):
    recon: torch.Tensor  # (B, T_out, H, W, C)
    feature: torch.Tensor  # (B, H/8, W/8, 512) encoder features
    memory: MemoryOut


class _MemoryAE(nn.Module):
    """What both variants share: the encoder, the memory and the clip
    layout."""

    def __init__(self, n_channel: int, in_frames: int, memory_size: int, key_dim: int):
        super().__init__()
        self.n_channel, self.in_frames = n_channel, in_frames
        self.enc1 = _Basic(in_frames * n_channel, 64)
        self.enc2 = _Basic(64, 128)
        self.enc3 = _Basic(128, 256)
        self.enc4 = _Basic(256, FEATURES, final_relu=False)
        self.memory = MemoryModule(memory_size, key_dim)

    def _flatten(self, clip: torch.Tensor) -> torch.Tensor:
        B, T, H, W, C = clip.shape
        if T != self.in_frames or C != self.n_channel:
            raise ValueError(
                f"{type(self).__name__} was built for clips of {self.in_frames} frames of "
                f"{self.n_channel} channels (its first conv takes {self.in_frames * self.n_channel}"
                f" channels); got {T} frames of {C}")
        return clip.permute(0, 2, 3, 1, 4).reshape(B, H, W, T * C)

    def _encode(self, x: torch.Tensor):
        s1 = self.enc1(x)
        s2 = self.enc2(_max_pool_2d(s1))
        s3 = self.enc3(_max_pool_2d(s2))
        return s1, s2, s3, self.enc4(_max_pool_2d(s3))


class ConvAE(_MemoryAE):
    """Reconstruction variant (no skips): t_length frames in and out."""

    def __init__(self, n_channel: int = 3, t_length: int = 2, memory_size: int = 10,
                 key_dim: int = 512):
        super().__init__(n_channel, t_length, memory_size, key_dim)
        self.t_length = t_length
        self.dec4 = _Basic(2 * FEATURES, 512)
        self.up4 = _Upsample(512, 512)
        self.dec3 = _Basic(512, 256)
        self.up3 = _Upsample(256, 256)
        self.dec2 = _Basic(256, 128)
        self.up2 = _Upsample(128, 128)
        self.gen = _Gen(128, t_length * n_channel, 64)

    def forward(self, clip: torch.Tensor, update_memory: bool = False,
                global_sum: Reduce = None, global_max: Reduce = None) -> ConvAEOut:
        B, T, H, W, C = clip.shape
        _, _, _, fea = self._encode(self._flatten(clip))
        mem = self.memory(fea, update_memory, global_sum, global_max)
        y = mem.updated_query.to(fea.dtype)  # (B, h, w, 1024)
        y = self.up4(self.dec4(y))
        y = self.up3(self.dec3(y))
        y = self.up2(self.dec2(y))
        y = self.gen(y)
        recon = y.reshape(B, H, W, T, C).permute(0, 3, 1, 2, 4)
        return ConvAEOut(recon=recon, feature=fea, memory=mem)


class ConvAEPredict(_MemoryAE):
    """Future-frame variant with U-Net skips: t_length - 1 frames in, one
    frame out."""

    def __init__(self, n_channel: int = 3, t_length: int = 5, memory_size: int = 10,
                 key_dim: int = 512):
        super().__init__(n_channel, t_length - 1, memory_size, key_dim)
        self.t_length = t_length
        self.dec4 = _Basic(2 * FEATURES, 512)
        self.up4 = _Upsample(512, 256)
        self.dec3 = _Basic(256 + 256, 256)
        self.up3 = _Upsample(256, 128)
        self.dec2 = _Basic(128 + 128, 128)
        self.up2 = _Upsample(128, 64)
        self.gen = _Gen(64 + 64, n_channel, 64)

    def forward(self, clip: torch.Tensor, update_memory: bool = False,
                global_sum: Reduce = None, global_max: Reduce = None) -> ConvAEOut:
        s1, s2, s3, fea = self._encode(self._flatten(clip))
        mem = self.memory(fea, update_memory, global_sum, global_max)
        y = mem.updated_query.to(fea.dtype)
        y = self.up4(self.dec4(y))
        y = self.up3(self.dec3(torch.cat([s3, y], -1)))
        y = self.up2(self.dec2(torch.cat([s2, y], -1)))
        y = self.gen(torch.cat([s1, y], -1))
        return ConvAEOut(recon=y[:, None], feature=fea, memory=mem)
