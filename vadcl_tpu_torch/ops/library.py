"""The forward entries of the hand-written kernels as ``torch.library`` ops.

A scoring forward reaches six kernel entries: kernel A / 10
(``fold_attention``), the whole-block kernel (``fold_block``), kernels 7 / 9
(``window_attention``, whose bodies include A's on ``window_grid``'s view),
kernel B (``ln_mlp``), kernel C (``cluster_assign``) and kernel D
(``space_cluster_loss``).  Each is an op in the ``vadcl`` namespace with

* a CUDA implementation: the wrapper's launch (``_fold_attention_cuda``,
  ``_fold_block_cuda``, ``window_attn._forward_cuda``, ``_ln_mlp_cuda``,
  ``_cluster_assign_cuda``, ``_space_cluster_loss_cuda``), which counts the
  launch on the body's counter and raises where no body takes the call;
* a CPU implementation: the kernel's plain version;
* a fake implementation that gives the output shapes and dtypes.

The autograd Functions of ``fold_attn.py``, ``window_attn.py``,
``ln_mlp.py`` and ``cluster_kernels.py`` call these ops in their forward;
their backward is unchanged.  So ``torch.export`` traces a model through
them into graph nodes (``torch.ops.vadcl.*``), and a loaded
``ExportedProgram`` calls the same launches, counted as in the live model.
Everything that reads storage (aligned copies, the packed-operand cache,
the body choice, the ctypes call) runs inside the implementations, never
on a traced tensor.  Importing this module registers the ops; a serving
process imports it before ``torch.export.load`` and needs nothing of the
model code.
"""

from __future__ import annotations

import importlib
from typing import List, Optional, Tuple

import torch
from torch import Tensor

NAMESPACE = "vadcl"


def _ops_module(name: str):
    return importlib.import_module(f"vadcl_tpu_torch.ops.{name}")


def _counter(name: str):
    """The wrapper whose ``launches`` counts a call ("" = the op's own)."""
    return getattr(importlib.import_module("vadcl_tpu_torch.ops"), name) if name else None


# kernel A / 10: LN1 + window attention + residual on the unpartitioned tensor

@torch.library.custom_op(f"{NAMESPACE}::fold_attention", mutates_args=(), device_types="cpu")
def fold_attention(x: Tensor, ln_scale: Optional[Tensor], ln_bias: Optional[Tensor],
                   qkv_w: Tensor, qkv_b: Optional[Tensor], proj_w: Tensor,
                   proj_b: Optional[Tensor], bias: Tensor, mask: Optional[Tensor],
                   num_heads: int, window: List[int], scale: float, residual: bool,
                   shift: List[int], packed: bool, counter: str) -> Tensor:
    fa = _ops_module("fold_attn")
    plain = fa.fold_attention_packed_plain if packed else fa.fold_attention_plain
    return plain(x, ln_scale, ln_bias, qkv_w, qkv_b, proj_w, proj_b, bias, mask, num_heads,
                 tuple(window), scale, residual, tuple(shift))


@fold_attention.register_kernel("cuda")
def _(x, ln_scale, ln_bias, qkv_w, qkv_b, proj_w, proj_b, bias, mask, num_heads, window,
      scale, residual, shift, packed, counter):
    return _ops_module("fold_attn")._fold_attention_cuda(
        x, ln_scale, ln_bias, qkv_w, qkv_b, proj_w, proj_b, bias, mask, num_heads,
        tuple(window), scale, residual, tuple(shift), packed=packed, counter=_counter(counter))


@fold_attention.register_fake
def _(x, *args):
    return x.new_empty(x.shape)


# the whole Swin block forward

@torch.library.custom_op(f"{NAMESPACE}::fold_block", mutates_args=(), device_types="cpu")
def fold_block(x: Tensor, ln_scale: Tensor, ln_bias: Tensor, qkv_w: Tensor,
               qkv_b: Optional[Tensor], proj_w: Tensor, proj_b: Optional[Tensor], bias: Tensor,
               mask: Optional[Tensor], ln2_scale: Tensor, ln2_bias: Tensor, w1: Tensor,
               b1: Optional[Tensor], w2: Tensor, b2: Optional[Tensor], num_heads: int,
               window: List[int], scale: float, shift: List[int], tiles: bool) -> Tensor:
    return _ops_module("fold_attn").fold_block_plain(
        x, ln_scale, ln_bias, qkv_w, qkv_b, proj_w, proj_b, bias, mask, ln2_scale, ln2_bias,
        w1, b1, w2, b2, num_heads, tuple(window), scale, tuple(shift))


@fold_block.register_kernel("cuda")
def _(x, ln_scale, ln_bias, qkv_w, qkv_b, proj_w, proj_b, bias, mask, ln2_scale, ln2_bias,
      w1, b1, w2, b2, num_heads, window, scale, shift, tiles):
    return _ops_module("fold_attn")._fold_block_cuda(
        x, ln_scale, ln_bias, qkv_w, qkv_b, proj_w, proj_b, bias, mask, ln2_scale, ln2_bias,
        w1, b1, w2, b2, num_heads, tuple(window), scale, tuple(shift), tiles=tiles)


@fold_block.register_fake
def _(x, *args):
    return x.new_empty(x.shape)


# kernels 7 / 9: attention over partitioned windows (Bn, N, C)

@torch.library.custom_op(f"{NAMESPACE}::window_attention", mutates_args=(), device_types="cpu")
def window_attention(x: Tensor, qkv_w: Tensor, qkv_b: Optional[Tensor], proj_w: Tensor,
                     proj_b: Optional[Tensor], bias: Tensor, mask: Optional[Tensor],
                     num_heads: int, n_windows: int, scale: float, packed: bool,
                     body: str) -> Tensor:
    wa = _ops_module("window_attn")
    plain = wa.window_attention_packed_plain if packed else wa.window_attention_fused_plain
    return plain(x, qkv_w, qkv_b, proj_w, proj_b, bias, mask, num_heads, n_windows, scale)


@window_attention.register_kernel("cuda")
def _(x, qkv_w, qkv_b, proj_w, proj_b, bias, mask, num_heads, n_windows, scale, packed, body):
    what = "window_attention_packed" if packed else "window_attention_fused"
    return _ops_module("window_attn")._forward_cuda(
        what, packed, body or None, x, qkv_w, qkv_b, proj_w, proj_b, bias, mask, num_heads,
        n_windows, scale)


@window_attention.register_fake
def _(x, *args):
    return x.new_empty(x.shape)


# kernel B: LN2 -> fc1 -> GELU -> fc2 + residual

@torch.library.custom_op(f"{NAMESPACE}::ln_mlp", mutates_args=(), device_types="cpu")
def ln_mlp(x: Tensor, ln_scale: Tensor, ln_bias: Tensor, w1: Tensor, b1: Optional[Tensor],
           w2: Tensor, b2: Optional[Tensor], tiles: bool) -> Tensor:
    return _ops_module("ln_mlp").ln_mlp_plain(x, ln_scale, ln_bias, w1, b1, w2, b2)


@ln_mlp.register_kernel("cuda")
def _(x, ln_scale, ln_bias, w1, b1, w2, b2, tiles):
    return _ops_module("ln_mlp")._ln_mlp_cuda(x, ln_scale, ln_bias, w1, b1, w2, b2, tiles)


@ln_mlp.register_fake
def _(x, *args):
    return x.new_empty(x.shape)


# kernel C: soft assignment, labels, recon and the loss's sum of squares

@torch.library.custom_op(f"{NAMESPACE}::cluster_assign", mutates_args=(), device_types="cpu")
def cluster_assign(tokens: Tensor, centers: Tensor,
                   alpha: float) -> Tuple[Tensor, Tensor, Tensor]:
    return tuple(_ops_module("cluster_kernels").cluster_assign_plain(tokens, centers, alpha))


@cluster_assign.register_kernel("cuda")
def _(tokens, centers, alpha):
    return tuple(_ops_module("cluster_kernels")._cluster_assign_cuda(tokens, centers, alpha))


@cluster_assign.register_fake
def _(tokens, centers, alpha):
    n, c = tokens.shape
    return (tokens.new_empty((n, c), dtype=torch.float32),
            tokens.new_empty((n,), dtype=torch.int32),
            tokens.new_empty((), dtype=torch.float32))


# kernel D: the space-cluster loss's sum of squares

@torch.library.custom_op(f"{NAMESPACE}::space_cluster_loss", mutates_args=(),
                         device_types="cpu")
def space_cluster_loss(maps: Tensor, centers: Tensor, alpha: float) -> Tensor:
    return _ops_module("cluster_kernels").space_cluster_loss_plain(maps, centers, alpha)


@space_cluster_loss.register_kernel("cuda")
def _(maps, centers, alpha):
    return _ops_module("cluster_kernels")._space_cluster_loss_cuda(maps, centers, alpha)


@space_cluster_loss.register_fake
def _(maps, centers, alpha):
    return maps.new_empty((), dtype=torch.float32)


OPS = (fold_attention, fold_block, window_attention, ln_mlp, cluster_assign,
       space_cluster_loss)
