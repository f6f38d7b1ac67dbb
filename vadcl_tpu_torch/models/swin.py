"""Video Swin 3D blocks (``vadcl_tpu/models/swin.py``), NDHWC.

With ``fused=True`` a block runs hand-written kernels, chosen by
``attn_kernel`` as the JAX blocks choose theirs:

* ``"fold"``: the folded attention kernel on the unpartitioned tensor with
  LN1, the shift roll and the residual inside (``ops/fold_attn``), then the
  fused LN2 -> MLP -> residual tail (``ops/ln_mlp``).  At a geometry that
  needs window padding LN1 cannot fold across the zero pad, so the block
  runs plain LN1, pads, and runs the fold kernel without LN and without the
  residual.  Where a window does not fit the fold kernel's shared memory
  (``fold_fits``) the block takes the ``"base"`` route.
* ``"fold_packed"`` (inference only): the same routes with the packed fold
  kernel (``fold_attention_packed``, gated by ``fold_packed_fits``) in place
  of the fold kernel; where it does not fit, the ``"base"`` route.
* ``"fold_mix"`` (inference only): ``"fold_packed"`` in blocks with 12 heads
  or more, ``"fold"`` in the others.
* ``"fold_block"``: the whole block (LN1, attention, residual, LN2, MLP,
  residual) is one kernel each way (``fold_block``) where no padding is
  needed and ``fold_block_fits`` holds (its own predicate: the whole-block
  kernels take head widths the fold kernel does not); otherwise the block is
  a ``"fold"`` block in every respect.
* ``"base"`` (trainable) and ``"packed"`` (inference only): plain LN1, pad,
  roll, ``window_partition``, the partitioned-window kernel
  (``ops/window_attn``), ``window_reverse``, roll back, slice, plain
  residual add, then the fused tail.  Where the partitioned-window kernels
  run on kernels A's and 6's tensor-core bodies (``window_grid_route``: bf16,
  head width 16 or 32, at most 112 tokens) the roll, partition, reverse
  and roll back are left to those bodies' addressing: the block runs as a
  padded ``"fold"`` (or ``"fold_packed"``) block, plain LN1, pad, the fold
  kernel without LN and residual, slice, residual, tail, with the launches
  counted on ``window_attention_fused`` / ``_packed`` / ``_fused_bwd``.

Under a model axis (``parallel/tp.py``) a fold-family block's fold kernel
(A, 10, the whole-block kernel, or the padded branch's A without LN) runs
on window-row shards through ``shard_windows_call`` and its kernel B on
the same rows through ``shard_tokens_call``, as the JAX block dispatches
its kernels; the ``base`` and ``packed`` blocks stay unsplit, as there,
even where they run A's body.

With ``fused=False`` it is the plain PyTorch block of the JAX default
config.  Parameter names and shapes are the same either way, so one
state_dict loads into every variant.

A block that draws dropout or drop-path masks (training inside the train
step's ``drop_keys`` at a rate above 0: ``layers.py``) routes as the JAX
block does with ``deterministic=False``: no kernel holds LN1, the residual
or the MLP tail, so the whole-block kernel and the in-kernel LN1 are off, a
fold-family block runs the fold kernel without LN and residual on the LN1'd
tensor (the padded branch), ``base`` runs kernels 7 and 8 as at rate 0, and
the MLP runs plain with its dropout.  Proj dropout applies to the
attention's output in the block's own layout, after the windows are merged
back and the padding cut, so that every route draws the same mask for the
same token; drop-path scales both residual branches.  ``SwinStage`` with
``remat`` recomputes each block in the backward
(``torch.utils.checkpoint``).

Two memos (the gathered rel-pos bias, the shift masks) hand the kernels the
same tensors from call to call, whose packed forms the kernels cache.  Under
``torch.export`` tracing (``torch.compiler.is_compiling()``) nothing enters
a memo: the masks are made anew (constants of the traced program), and the
bias memo is read as it stands where it holds the block's window (the
exporter fills it with one forward just before it traces), else gathered in
the graph.  So a loaded program hands the kernels the same bias tensor at
every call, as the live model does.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from vadcl_tpu_torch.models.layers import (
    Dropout,
    DropPath,
    LayerNorm,
    Mlp,
    _uniform_fan_in,
    current_drop_keys,
    drop_keys,
)
from vadcl_tpu_torch.ops.convs import patchify_matmul
from vadcl_tpu_torch.ops.fold_attn import (
    fold_attention,
    fold_attention_packed,
    fold_block,
    fold_block_fits,
    fold_fits,
    fold_packed_fits,
)
from vadcl_tpu_torch.ops.ln_mlp import ln_mlp
from vadcl_tpu_torch.ops.window import (
    compute_attn_mask,
    get_window_size,
    relative_position_index,
    window_attention,
    window_partition,
    window_reverse,
)
from vadcl_tpu_torch.ops.window_attn import (
    window_attention_fused,
    window_attention_fused_bwd,
    window_attention_packed,
    window_grid_route,
)
from vadcl_tpu_torch.parallel.tp import shard_tokens_call, shard_windows_call

Tri = Tuple[int, int, int]

_FOLD_FAMILY = ("fold", "fold_block", "fold_packed")


def resolve_attn_kernel(attn_kernel: str, num_heads: int) -> str:
    """``fold_mix`` picks per block: the packed fold kernel at 12 heads or
    more, the fold kernel below; every other name is itself."""
    if attn_kernel == "fold_mix":
        return "fold_packed" if num_heads >= 12 else "fold"
    return attn_kernel


class WindowAttention3D(nn.Module):
    """W-MSA parameters and the relative position bias
    (``model/swin_transformer.py:87-171``).  ``window_size`` is the
    *configured* window; the bias gathers ``rel_index[:N, :N]``."""

    def __init__(self, dim: int, window_size: Tri, num_heads: int,
                 qkv_bias: bool = True, qk_scale: Optional[float] = None,
                 attn_drop: float = 0.0, proj_drop: float = 0.0):
        super().__init__()
        wd, wh, ww = window_size
        self.num_heads = num_heads
        self.scale = qk_scale or (dim // num_heads) ** -0.5
        self.qk_scale = qk_scale
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * wd - 1) * (2 * wh - 1) * (2 * ww - 1), num_heads)
        )
        self.qkv_weight = nn.Parameter(torch.empty(dim, 3 * dim))
        self.qkv_bias = nn.Parameter(torch.zeros(3 * dim)) if qkv_bias else None
        self.proj_weight = nn.Parameter(torch.empty(dim, dim))
        self.proj_bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer(
            "rel_index",
            torch.from_numpy(relative_position_index(tuple(window_size))).long(),
            persistent=False,
        )
        self.attn_drop = Dropout(attn_drop)  # on the softmax (the plain route only)
        self.proj_drop = Dropout(proj_drop)
        self._bias_memo = None

    def reset_parameters(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            t = self.relative_position_bias_table
            t.copy_(torch.fmod(torch.randn(t.shape, generator=gen), 2.0) * 0.02)
            if self.qkv_bias is not None:
                self.qkv_bias.zero_()
            self.proj_bias.zero_()
        _uniform_fan_in(self.qkv_weight, self.qkv_weight.shape[0], gen)
        _uniform_fan_in(self.proj_weight, self.proj_weight.shape[0], gen)

    def bias(self, n: int) -> torch.Tensor:
        """(nH, N, N) fp32: ``table[rel_index(configured)[:N, :N]]``.  Where no
        gradient is wanted the gathered bias is kept until the table changes,
        so that scoring hands the kernels one tensor (whose packed form they
        cache) instead of gathering anew in every forward.  While
        ``torch.export`` traces, a memo of ``n`` tokens is read (it becomes
        a constant of the program) and none is written."""
        table = self.relative_position_bias_table
        if torch.compiler.is_compiling():
            memo = self._bias_memo
            if memo is not None and memo[0][0] == n:
                return memo[1]
            return self._gather_bias(table, n)
        if (torch.is_grad_enabled() and table.requires_grad) or table.is_inference():
            return self._gather_bias(table, n)
        key = (n, table.data_ptr(), table._version, table.dtype, str(table.device))
        if self._bias_memo is None or self._bias_memo[0] != key:
            with torch.inference_mode(False), torch.no_grad():
                self._bias_memo = (key, self._gather_bias(table.detach(), n))
        return self._bias_memo[1]

    def _gather_bias(self, table: torch.Tensor, n: int) -> torch.Tensor:
        idx = self.rel_index[:n, :n].reshape(-1)
        b = table.float()[idx].reshape(n, n, -1)
        return b.permute(2, 0, 1).contiguous()


class SwinBlock3D(nn.Module):
    """One Swin block: (shifted) window attention + MLP with residuals
    (``model/swin_transformer.py:174-277``)."""

    def __init__(self, dim: int, num_heads: int, window_size: Tri = (2, 7, 7),
                 shift_size: Tri = (0, 0, 0), mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, qk_scale: Optional[float] = None,
                 fused: bool = False, attn_kernel: str = "base", drop: float = 0.0,
                 attn_drop: float = 0.0, drop_path: float = 0.0):
        super().__init__()
        self.window_size = tuple(window_size)
        self.shift_size = tuple(shift_size)
        self.num_heads = num_heads
        self.fused = fused
        self.attn_kernel = attn_kernel
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention3D(dim, self.window_size, num_heads, qkv_bias, qk_scale,
                                      attn_drop, drop)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), drop)
        self.drop_path1 = DropPath(drop_path)
        self.drop_path2 = DropPath(drop_path)
        self._masks: Dict[tuple, torch.Tensor] = {}

    def _mask(self, Dp, Hp, Wp, window, shift, device) -> Optional[torch.Tensor]:
        if torch.compiler.is_compiling():
            m = compute_attn_mask(Dp, Hp, Wp, window, shift)
            return None if m is None else torch.from_numpy(m).to(device)
        key = (Dp, Hp, Wp, window, shift, str(device))
        if key not in self._masks:
            m = compute_attn_mask(Dp, Hp, Wp, window, shift)
            # (a plain tensor even when first asked for under inference_mode: the
            # kernels cache a packed form per tensor version)
            with torch.inference_mode(False):
                self._masks[key] = None if m is None else torch.from_numpy(m).to(device)
        return self._masks[key]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, D, H, W, C = x.shape
        window, shift = get_window_size((D, H, W), self.window_size, self.shift_size)
        pads = ((-D) % window[0], (-H) % window[1], (-W) % window[2])
        shifted = any(s > 0 for s in shift)
        n = window[0] * window[1] * window[2]
        attn = self.attn
        # dropout or drop-path drawn in this forward: no kernel holds LN1,
        # the residual or the MLP tail (the JAX block's deterministic=False)
        stochastic = any(m.drawing() for m in (attn.proj_drop, self.mlp.drop1, self.drop_path1))
        # the resolved name picks the fold kernel and its gate; the
        # partitioned route below tests the configured name, as the JAX block
        kind = resolve_attn_kernel(self.attn_kernel, self.num_heads)
        fits = fold_packed_fits if kind == "fold_packed" else fold_fits
        fold = (self.fused and kind in _FOLD_FAMILY
                and fits(n, C, self.num_heads, x.dtype))
        fold_kernel = fold_attention_packed if kind == "fold_packed" else fold_attention
        if (self.fused and kind == "fold_block" and not any(pads) and not stochastic
                and fold_block_fits(n, C, self.num_heads, self.mlp.fc1.weight.shape[1],
                                    x.dtype)):
            # the whole block, MLP tail included, is one kernel each way
            def block_call(xl, ml, sh, ln_s, ln_b, qkv_w, qkv_b, proj_w, proj_b, bias,
                           *tail):
                return fold_block(xl, ln_s, ln_b, qkv_w, qkv_b, proj_w, proj_b, bias, ml,
                                  *tail, self.num_heads, window, attn.scale, shift=sh)

            return shard_windows_call(
                block_call, x, self._mask(D, H, W, window, shift, x.device), window, shift,
                (self.norm1.weight, self.norm1.bias, *self._attn_weights(n),
                 self.norm2.weight, self.norm2.bias, self.mlp.fc1.weight,
                 self.mlp.fc1.bias, self.mlp.fc2.weight, self.mlp.fc2.bias),
            )
        if fold and not any(pads) and not stochastic:
            # LN1, the shift roll both ways and the residual are in the kernel
            def fold_call(xl, ml, sh, ln_s, ln_b, *w):
                return fold_kernel(xl, ln_s, ln_b, *w, ml, self.num_heads, window,
                                   attn.scale, residual=True, shift=sh)

            x = shard_windows_call(
                fold_call, x, self._mask(D, H, W, window, shift, x.device), window, shift,
                (self.norm1.weight, self.norm1.bias, *self._attn_weights(n)),
            )
            return self._tail(x)

        shortcut = x
        y = self.norm1(x)
        if any(pads):
            # trailing edges, after LN1: the pad tokens are real zero tokens that
            # attend and are attended (the reference's quirk)
            y = nn.functional.pad(y, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
        _, Dp, Hp, Wp, _ = y.shape
        mask = self._mask(Dp, Hp, Wp, window, shift, x.device)
        packed = self.attn_kernel == "packed"
        counters = {}
        grid = (not fold and self.fused
                and window_grid_route(n, C, self.num_heads, x.dtype, packed))
        if grid:
            # kernels 7 (or 9) and 8 would run A's and 6's bodies: run those on
            # the padded tensor as below, counted on the kernels of this route
            fold_kernel = fold_attention_packed if packed else fold_attention
            counters = ({"counter": window_attention_packed} if packed else
                        {"counter": window_attention_fused,
                         "bwd_counter": window_attention_fused_bwd})
        if fold or grid:
            # the fold kernel on the padded tensor, without LN and residual,
            # the shift roll folded into its addressing; a fold block's rows
            # split over a model axis, a grid (base, packed) block's do not
            def pad_call(yl, ml, sh, *w):
                return fold_kernel(yl, None, None, *w, ml, self.num_heads, window,
                                   attn.scale, residual=False, shift=sh, **counters)

            if fold:
                y = shard_windows_call(pad_call, y, mask, window, shift,
                                       self._attn_weights(n))
            else:
                y = pad_call(y, mask, shift, *self._attn_weights(n))
        else:
            if shifted:
                y = torch.roll(y, (-shift[0], -shift[1], -shift[2]), (1, 2, 3))
            wins = window_partition(y, window)
            if self.fused:
                n_windows = wins.shape[0] // B
                kernel = window_attention_packed if packed else window_attention_fused
                wins = kernel(
                    wins, attn.qkv_weight, attn.qkv_bias, attn.proj_weight,
                    attn.proj_bias, attn.bias(n), mask, self.num_heads, n_windows,
                    attn.scale,
                )
            else:
                n_windows = wins.shape[0] // B
                wins = window_attention(
                    wins, attn.qkv_weight, attn.qkv_bias, attn.proj_weight,
                    attn.proj_bias, attn.bias(n), self.num_heads, mask=mask,
                    scale=attn.qk_scale,
                    attn_dropout=lambda p, heads: attn.attn_drop(
                        p, (B, n_windows, self.num_heads, *p.shape[2:]),
                        (slice(None), slice(None), heads)),
                )
            y = window_reverse(wins, window, B, Dp, Hp, Wp)
            if shifted:
                y = torch.roll(y, shift, (1, 2, 3))
        if any(pads):
            y = y[:, :D, :H, :W, :]
        y = attn.proj_drop(y)
        return self._tail(shortcut + self.drop_path1(y))

    def _attn_weights(self, n: int):
        """What the fold kernels read of the attention: (qkv_w, qkv_b,
        proj_w, proj_b, the gathered bias)."""
        attn = self.attn
        return (attn.qkv_weight, attn.qkv_bias, attn.proj_weight, attn.proj_bias,
                attn.bias(n))

    def _tail(self, x: torch.Tensor) -> torch.Tensor:
        """LN2 -> MLP -> residual: one kernel when fused and no mask is
        drawn, its H rows split over a model axis (``shard_tokens_call``)."""
        if self.fused and not (self.mlp.drop1.drawing() or self.drop_path2.drawing()):
            return shard_tokens_call(
                ln_mlp, x, 2,
                (self.norm2.weight, self.norm2.bias, self.mlp.fc1.weight, self.mlp.fc1.bias,
                 self.mlp.fc2.weight, self.mlp.fc2.bias),
            )
        return x + self.drop_path2(self.mlp(self.norm2(x)))


def _run_block(block: nn.Module, x: torch.Tensor, keys) -> torch.Tensor:
    """``block(x)`` drawing from ``keys``: a recompute in the backward runs
    outside the step's ``drop_keys`` and draws the forward's masks again."""
    with drop_keys(keys):
        return block(x)


class SwinStage(nn.Module):
    """Blocks ``block0..`` with alternating shift (BasicLayer parity).
    ``drop_path`` is the per-block rate (one value: every block); with
    ``remat`` each block is recomputed in the backward, as
    ``nn.remat(SwinBlock3D)``."""

    def __init__(self, dim: int, depth: int, num_heads: int,
                 window_size: Tri = (8, 7, 7), mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, qk_scale: Optional[float] = None,
                 fused: bool = False, attn_kernel: str = "base", drop: float = 0.0,
                 attn_drop: float = 0.0, drop_path: Sequence[float] = (0.0,),
                 remat: bool = False):
        super().__init__()
        self.depth = depth
        self.remat = remat
        shift = tuple(w // 2 for w in window_size)
        dp = list(drop_path) * depth if len(drop_path) == 1 else list(drop_path)
        for i in range(depth):
            self.add_module(f"block{i}", SwinBlock3D(
                dim, num_heads, window_size,
                (0, 0, 0) if i % 2 == 0 else shift, mlp_ratio, qkv_bias,
                qk_scale, fused, attn_kernel, drop, attn_drop, dp[i],
            ))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        remat = self.remat and torch.is_grad_enabled() and not torch.compiler.is_compiling()
        keys = current_drop_keys()
        for i in range(self.depth):
            block = getattr(self, f"block{i}")
            if remat:
                x = checkpoint(_run_block, block, x, keys, use_reentrant=False)
            else:
                x = block(x)
        return x


def drop_path_schedule(rate: float, depths: Sequence[int]):
    """The per-stage drop-path rates: ``rate * i / (total - 1)`` over all
    ``total`` blocks (``torch.linspace`` semantics, as
    ``vadcl_tpu/models/encoder.py:79-82``)."""
    total = sum(depths)
    dpr = [rate * i / max(total - 1, 1) for i in range(total)]
    starts = [sum(depths[:i]) for i in range(len(depths) + 1)]
    return [tuple(dpr[starts[i]:starts[i + 1]]) for i in range(len(depths))]


class PatchEmbed3D(nn.Module):
    """Pad to patch multiples, then Conv3d(k=s=patch) as reshape + matmul."""

    def __init__(self, patch_size: Tri = (2, 4, 4), in_channels: int = 3,
                 embed_dim: int = 96):
        super().__init__()
        self.patch_size = tuple(patch_size)
        self.weight = nn.Parameter(torch.empty(embed_dim, in_channels, *patch_size))
        self.bias = nn.Parameter(torch.zeros(embed_dim))

    def reset_parameters(self, gen: torch.Generator) -> None:
        _uniform_fan_in(self.weight, self.weight[0].numel(), gen)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, D, H, W, _ = x.shape
        pd, ph, pw = self.patch_size
        pads = ((-D) % pd, (-H) % ph, (-W) % pw)
        if any(pads):
            x = nn.functional.pad(x, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
        return patchify_matmul(x, self.weight, self.bias)
