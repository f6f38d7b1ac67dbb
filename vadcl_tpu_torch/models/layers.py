"""Shared building blocks (``vadcl_tpu/models/layers.py``), NDHWC throughout.

Parameters are fp32; each module computes in the dtype of its input, which
the model sets (bf16 on CUDA, fp32 on the CPU).  Every module with
parameters has ``reset_parameters(generator)``, the JAX package's init:
kaiming-uniform fan-in weights U(-1/sqrt(fan_in), 1/sqrt(fan_in)), zero
biases, unit norm scales.

Dropout and drop-path (``Dropout``, ``DropPath``) draw their masks only in
training mode inside ``drop_keys(...)``, which the train step enters: that
is the JAX forward's ``deterministic=False`` with a ``dropout`` rng.
Elsewhere (scoring, export, a forward outside the step) they are the
identity.  A mask is a pure function of the step's ``DropKeys``, the
module's site (its name in the model, ``name_draw_sites``) and the global
index of the sample: each draw seeds its own ``torch.Generator`` and draws
the global batch's mask, of which a process keeps its own rows.  So a
recompute under ``torch.utils.checkpoint`` draws the same masks (whose
``preserve_rng_state`` restores only the default generators), and a
data-parallel rank draws the masks of its samples in one process's run.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
import zlib
from typing import Iterator, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from vadcl_tpu_torch.ops.convs import conv3d, conv_transpose3d, max_pool3d_same
from vadcl_tpu_torch.parallel.tp import shard_sum_call

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


DROPOUT_SEED_OFFSET = 0x5EED  # the JAX step's ``key(seed + 0x5EED)``


class DropKeys(NamedTuple):
    """What a step's masks derive from: ``seed`` (the run's seed plus
    ``DROPOUT_SEED_OFFSET``), ``step``, the global index of this process's
    first sample and the global batch size."""

    seed: int
    step: int
    offset: int = 0
    global_batch: int = 0  # 0: this process's batch is the global batch


_KEYS: contextvars.ContextVar[Optional[DropKeys]] = contextvars.ContextVar(
    "vadcl_drop_keys", default=None)


@contextlib.contextmanager
def drop_keys(keys: Optional[DropKeys]) -> Iterator[None]:
    """Draw the masks of the forwards inside from ``keys`` (None: none)."""
    token = _KEYS.set(keys)
    try:
        yield
    finally:
        _KEYS.reset(token)


def current_drop_keys() -> Optional[DropKeys]:
    return _KEYS.get()


def _mix64(*words: int) -> int:
    """splitmix64 over ``words``: a 63-bit generator seed."""
    h = 0
    for w in words:
        h = (h ^ (w & 0xFFFFFFFFFFFFFFFF)) + 0x9E3779B97F4A7C15 & 0xFFFFFFFFFFFFFFFF
        h = (h ^ (h >> 30)) * 0xBF58476D1CE4E5B9 & 0xFFFFFFFFFFFFFFFF
        h = (h ^ (h >> 27)) * 0x94D049BB133111EB & 0xFFFFFFFFFFFFFFFF
        h ^= h >> 31
    return h >> 1


def keep_mask(site: str, shape: Sequence[int], keep: float, device) -> torch.Tensor:
    """The bool keep mask of ``shape`` (this process's rows first) for the
    module at ``site``: rows ``offset..offset + shape[0]`` of the global
    batch's uniform draw, kept below ``keep``."""
    keys = _KEYS.get()
    if keys is None:
        raise RuntimeError("keep_mask: no DropKeys; draw inside drop_keys(...)")
    b = int(shape[0])
    total = keys.global_batch or b
    if keys.offset + b > total:
        raise ValueError(f"keep_mask: rows {keys.offset}..{keys.offset + b} of a global "
                         f"batch of {total}")
    gen = torch.Generator(device=device)
    gen.manual_seed(_mix64(keys.seed, keys.step, zlib.crc32(site.encode())))
    u = torch.rand((total, *shape[1:]), generator=gen, device=device)
    return u[keys.offset:keys.offset + b] < keep


class _Stochastic(nn.Module):
    """A module that drops at ``rate`` while it draws (``drawing``)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)
        self.site = ""  # its name in the model (``name_draw_sites``)

    def drawing(self) -> bool:
        return self.training and self.rate > 0.0 and _KEYS.get() is not None

    def _drop(self, x: torch.Tensor, shape: Sequence[int], index=None) -> torch.Tensor:
        """``x`` dropped by the mask of ``shape``, or by its part
        ``mask[index]`` (a model rank's heads or hidden columns), which has
        ``x``'s elements."""
        keep = 1.0 - self.rate
        mask = keep_mask(self.site, shape, keep, x.device)
        if index is not None:
            mask = mask[index]
        if mask.shape != x.shape and mask.numel() == x.numel():
            mask = mask.reshape(x.shape)  # (a per-sample mask broadcasts instead)
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class Dropout(_Stochastic):
    """flax ``nn.Dropout``: each element kept with probability ``1 - rate``
    and scaled by ``1 / (1 - rate)``."""

    def forward(self, x: torch.Tensor, shape: Optional[Sequence[int]] = None,
                index=None) -> torch.Tensor:
        """``shape`` (default ``x.shape``): the mask's shape, sample axis
        first, where ``x`` holds several rows a sample (windows); ``index``
        picks the part of that mask ``x`` holds, where a model axis split
        the heads or the hidden width (``parallel/tp.py``)."""
        if not self.drawing():
            return x
        return self._drop(x, x.shape if shape is None else shape, index)


class DropPath(_Stochastic):
    """Per-sample stochastic depth (``vadcl_tpu/models/layers.py:77-92``,
    timm's DropPath): a sample's whole branch is kept with probability
    ``1 - rate`` and scaled by ``1 / (1 - rate)``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.drawing():
            return x
        return self._drop(x, (x.shape[0],) + (1,) * (x.dim() - 1))


def name_draw_sites(root: nn.Module) -> None:
    """Name every ``Dropout`` and ``DropPath`` under ``root`` by its path,
    the site its masks derive from."""
    for name, m in root.named_modules():
        if isinstance(m, _Stochastic):
            m.site = name


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
    """fc1 -> GELU -> dropout -> fc2 -> dropout
    (``model/swin_transformer.py:17-35``)."""

    def __init__(self, dim: int, hidden: int, drop: float = 0.0):
        super().__init__()
        self.fc1 = Dense(dim, hidden)
        self.fc2 = Dense(hidden, dim)
        self.drop1 = Dropout(drop)
        self.drop2 = Dropout(drop)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Under a model axis (``parallel/tp.py``) the hidden width splits
        over it where its size divides it: each rank runs its columns of fc1
        and its rows of fc2, and the partial fc2 products are summed before
        fc2's bias, Megatron style (the JAX ``Mlp``'s ``shard_dim``)."""
        fc1, fc2 = self.fc1, self.fc2
        hidden = fc1.weight.shape[1]

        def hidden_part(x, cols, w1, b1, w2):
            h = x @ w1[:, cols].to(x.dtype)
            if b1 is not None:
                h = h + b1[cols].to(h.dtype)
            h = self.drop1(gelu(h), (*h.shape[:-1], hidden), (Ellipsis, cols))
            return h @ w2[cols].to(h.dtype)

        y = shard_sum_call(hidden_part, hidden, x, (fc1.weight, fc1.bias, fc2.weight))
        if fc2.bias is not None:
            y = y + fc2.bias.to(y.dtype)
        return self.drop2(y)


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
