"""Shared building blocks (``vadcl_tpu/models/layers.py``), NDHWC throughout.

Parameters are fp32; each module computes in the dtype of its input, which
the model sets (bf16 on CUDA, fp32 on the CPU).  Every module with
parameters has ``reset_parameters(generator)``, the JAX package's init:
kaiming-uniform fan-in weights U(-1/sqrt(fan_in), 1/sqrt(fan_in)), zero
biases, unit norm scales.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from vadcl_tpu_torch.ops.convs import conv3d, conv_transpose3d, max_pool3d_same

Tri = Tuple[int, int, int]


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU — torch nn.GELU default, not the tanh approx."""
    return F.gelu(x)


def _uniform_fan_in(t: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        t.copy_(torch.rand(t.shape, generator=gen) * (2 * bound) - bound)


def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Initialise every submodule that defines ``reset_parameters(gen)``,
    in module order, from one generator."""
    for m in module.modules():
        if m is not module and hasattr(m, "reset_parameters"):
            m.reset_parameters(generator)


class LayerNorm(nn.Module):
    """flax nn.LayerNorm numerics: fp32 statistics with the fast variance
    E[x^2] - E[x]^2 (clamped at 0), eps 1e-5; output in the input's dtype.
    Not ``F.layer_norm``, which is two-pass."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def reset_parameters(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mu = x32.mean(-1, keepdim=True)
        var = torch.clamp((x32 * x32).mean(-1, keepdim=True) - mu * mu, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x32 - mu) * mul + self.bias).to(x.dtype)


class Dense(nn.Module):
    """flax nn.Dense: weight stored (in, out); computes in the input dtype."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def reset_parameters(self, gen: torch.Generator) -> None:
        _uniform_fan_in(self.weight, self.weight.shape[0], gen)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.weight.to(x.dtype)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class Mlp(nn.Module):
    """fc1 -> GELU -> fc2 (``model/swin_transformer.py:17-35``; dropout 0)."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Dense(dim, hidden)
        self.fc2 = Dense(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.fc1(x)))


class FrozenBatchNorm(nn.Module):
    """BatchNorm that always normalises with its stored running statistics
    (eps 1e-3, as the reference's permanently-eval BN; ConvAE and UNet3D
    pass 1e-5)."""

    def __init__(self, dim: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))

    def reset_parameters(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        return ((x.float() - self.running_mean) * inv + self.bias).to(x.dtype)


class Conv3d(nn.Module):
    """torch.nn.Conv3d over NDHWC; weight (Cout, Cin, kd, kh, kw)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: Tri,
                 stride: Tri = (1, 1, 1), padding: Tri = (0, 0, 0),
                 bias: bool = True):
        super().__init__()
        self.stride, self.padding = tuple(stride), tuple(padding)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, *kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def reset_parameters(self, gen: torch.Generator) -> None:
        _uniform_fan_in(self.weight, self.weight[0].numel(), gen)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv3d(x, self.weight, self.bias, self.stride, self.padding)


class ConvTranspose3d(nn.Module):
    """torch.nn.ConvTranspose3d over NDHWC; weight (Cin, Cout, kd, kh, kw)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: Tri,
                 stride: Tri = (1, 1, 1), padding: Tri = (0, 0, 0),
                 bias: bool = True, output_padding: Tri = (0, 0, 0)):
        super().__init__()
        self.stride, self.padding = tuple(stride), tuple(padding)
        self.output_padding = tuple(output_padding)
        self.weight = nn.Parameter(torch.empty(in_channels, out_channels, *kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def reset_parameters(self, gen: torch.Generator) -> None:
        # fan-in as flax computes it for a (kd, kh, kw, Cin, Cout) kernel
        w = self.weight
        _uniform_fan_in(w, w.shape[0] * w[0, 0].numel(), gen)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_transpose3d(x, self.weight, self.bias, self.stride, self.padding,
                                self.output_padding)


class Unit3D(nn.Module):
    """Conv3d (no bias) + frozen BN + GELU (``model/I3D.py:53-94``).  Keeps
    the reference's quirk: ``padding`` zero-pads even 1x1x1 convs."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Tri = (1, 1, 1), padding: int = 0):
        super().__init__()
        self.conv3d = Conv3d(in_channels, out_channels, kernel_size,
                             padding=(padding,) * 3, bias=False)
        self.bn = FrozenBatchNorm(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gelu(self.bn(self.conv3d(x)))


class InceptionModule(nn.Module):
    """4-branch I3D Inception block (``model/I3D.py:102-135``).
    out_channels = [b0, b1a, b1b, b2a, b2b, b3b]."""

    def __init__(self, in_channels: int, out_channels: Sequence[int]):
        super().__init__()
        oc = out_channels
        self.b0 = Unit3D(in_channels, oc[0], (1, 1, 1), padding=0)
        self.b1a = Unit3D(in_channels, oc[1], (1, 1, 1), padding=1)
        self.b1b = Unit3D(oc[1], oc[2], (3, 3, 3), padding=0)
        self.b2a = Unit3D(in_channels, oc[3], (1, 1, 1), padding=1)
        self.b2b = Unit3D(oc[3], oc[4], (3, 3, 3), padding=0)
        self.b3b = Unit3D(in_channels, oc[5], (1, 1, 1), padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b0 = self.b0(x)
        b1 = self.b1b(self.b1a(x))
        b2 = self.b2b(self.b2a(x))
        b3 = self.b3b(max_pool3d_same(x, kernel=3, stride=1))
        return torch.cat([b0, b1, b2, b3], dim=-1)
