"""Model-axis (tensor) parallelism (``vadcl_tpu/parallel/tp.py``).

The JAX package splits a data shard's forward and backward over the model
axis of a ``(data, model)`` mesh: GSPMD constraints (``shard_dim``) on the
heads and the MLP hidden width where XLA runs the attention and the MLP,
and ``jax.shard_map`` over the Hp window rows where a Pallas kernel runs.
The port has no partitioner, so every split here is explicit, on a model
group of processes (``core/mesh.py:make_mesh_2d``), with the collectives
as ``torch.autograd.Function``s:

* ``shard_windows_call`` (the fold kernels A, 10 and the whole-block
  kernel, and the padded fold branch without LN): each model rank runs the
  SAME single-device kernel on its own window rows, and the rows are
  gathered.  The port's kernels fold the shifted-window roll into their
  addressing, so a rank's rows would need rows from the far edge: a
  shifted call rolls the whole tensor first, splits the rolled rows, runs
  the kernel with a zero shift and its rows' slice of the mask, and rolls
  the gathered output back (the JAX block rolls before its kernel too).
* ``shard_tokens_call`` (kernel B, the fused LN -> MLP tail): a
  token-pointwise kernel on a slice of one dimension (the H rows).
* ``shard_sum_call`` (the plain path: the window attention's heads,
  ``ops/window.py``; the MLP's hidden width, ``models/layers.py:Mlp``),
  Megatron style: each rank computes its heads' (its hidden columns')
  partial projection and the partials are summed.

Gradients: the input of a split region and every tensor handed to it in
``weights`` enter through ``_Replicate`` (identity forward, sum over the
model group backward), so a parameter used on row shards, or on a head
slice, gets its gradient summed over the group, and so does the input's
cotangent: what ``shard_map``'s transpose and GSPMD do in JAX.  A
parameter used outside every split region sees the same full gradient on
every rank and is not summed.  Gathered rows give back only their own
slice of the upstream gradient (``_GatherRows``); a summed partial passes
it through (``_SumPartials``).

Every call is the plain, unsplit call outside ``model_parallel``, at model
size 1, or where the model size does not divide the window rows (the
tokens, the heads, the hidden width), as in the JAX package.

``model_parallel_by_turns(size)`` runs the same splits in ONE process with
no collective: each virtual rank's rows (heads, columns) go through the
kernels in turn, the outputs are concatenated (summed), and autograd adds
the ranks' gradients where the same tensor fed every turn.  It is how one
card checks the row-split kernels at the flagship (``chip_smoke.py``); a
recorder may time each turn.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Callable, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.utils.weak import WeakIdKeyDictionary

Tri = Tuple[int, int, int]


class ModelAxis(NamedTuple):
    """The active model axis: its size, this process's index on it, its
    process group (``None``: by turns in this process) and the recorder of
    the turns (by turns only, or ``None``)."""

    size: int
    rank: int
    group: Optional[Any]
    recorder: Optional[Any] = None


_CTX: Optional[ModelAxis] = None


@contextmanager
def model_parallel(mesh, axis: Optional[str]):
    """Split the enclosed forwards (and their backwards) over ``axis`` of
    ``mesh`` (a ``core.mesh.Mesh2D``).  ``mesh=None``, ``axis=None`` or an
    axis of size 1 make it a no-op, so call sites need no branching."""
    global _CTX
    prev = _CTX
    if mesh is not None and axis is not None and mesh.shape.get(axis, 1) > 1:
        _CTX = ModelAxis(mesh.shape[axis], mesh.index(axis), mesh.group(axis))
    try:
        yield
    finally:
        _CTX = prev


@contextmanager
def model_parallel_by_turns(size: int, recorder=None):
    """The splits of ``model_parallel`` at model size ``size``, every
    virtual rank in turn in this process (the module docstring).
    ``recorder.mark(rank, phase, edge)`` is called where a turn starts and
    ends, in the forward (``"fwd"``) and in the backward (``"bwd"``)."""
    global _CTX
    prev = _CTX
    if size > 1:
        _CTX = ModelAxis(size, 0, None, recorder)
    try:
        yield
    finally:
        _CTX = prev


def active_axis() -> Optional[ModelAxis]:
    """The model axis the splits follow, or None."""
    return _CTX


# ----------------------------------------------------------------- collectives


class _Replicate(torch.autograd.Function):
    """Identity forward; the gradient summed over the model group."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GatherRows(torch.autograd.Function):
    """Every rank's slice, concatenated along ``dim`` in rank order; the
    backward keeps this rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.rank, ctx.n = dim, dist.get_rank(group), t.shape[dim]
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, t, group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None


class _SumPartials(torch.autograd.Function):
    """The partials summed over the model group; the gradient passes
    through to each."""

    @staticmethod
    def forward(ctx, t, group):
        out = t.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _TurnMark(torch.autograd.Function):
    """Tells the recorder where a turn starts or ends, forward and
    backward (identity both ways)."""

    @staticmethod
    def forward(ctx, t, recorder, rank, edge):
        ctx.recorder, ctx.rank, ctx.edge = recorder, rank, edge
        recorder.mark(rank, "fwd", edge)
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        ctx.recorder.mark(ctx.rank, "bwd", "end" if ctx.edge == "start" else "start")
        return grad, None, None, None


def _replicated(ax: ModelAxis, tensors: Sequence[Optional[torch.Tensor]]):
    return [None if t is None else _Replicate.apply(t, ax.group) for t in tensors]


def _turn(ax: ModelAxis, rank: int, fn: Callable, x: torch.Tensor, *rest):
    """``fn(x, *rest)`` as virtual rank ``rank``'s turn, marked for the
    recorder where there is one."""
    rec = ax.recorder
    if rec is None:
        return fn(x, *rest)
    out = fn(_TurnMark.apply(x, rec, rank, "start"), *rest)
    return _TurnMark.apply(out, rec, rank, "end")


# ------------------------------------------------------------------ row splits


def window_rows(nhb: int, size: int, rank: int) -> Tuple[int, int]:
    """Rank ``rank``'s window rows ``[lo, hi)`` of ``nhb`` over ``size``."""
    per = nhb // size
    return rank * per, (rank + 1) * per


def split_rows(x: torch.Tensor, window: Tri, size: int, rank: int) -> torch.Tensor:
    """Rank ``rank``'s window rows of ``x`` (B, Dp, Hp, Wp, C), contiguous
    (the kernels take dense operands)."""
    wh = window[1]
    lo, hi = window_rows(x.shape[2] // wh, size, rank)
    return x[:, :, lo * wh:hi * wh].contiguous()


_MASK_ROWS = WeakIdKeyDictionary()


def mask_rows(mask: torch.Tensor, dims: Tri, window: Tri, size: int,
              rank: int) -> torch.Tensor:
    """Rank ``rank``'s windows of the (nW, N, N) shift mask, whose windows
    are in (d, h, w) order: reshaped to (nd, nhb, wins, N, N) and sliced on
    nhb.  Memoised per mask tensor and geometry, so that a rank hands the
    kernels one tensor from call to call (whose packed form they cache, as
    ``SwinBlock3D._mask`` memoises the whole mask); not while
    ``torch.export`` traces."""
    key = (tuple(dims), tuple(window), size, rank)
    memo = None if torch.compiler.is_compiling() else _MASK_ROWS.setdefault(mask, {})
    if memo is not None and key in memo:
        return memo[key]
    (dp, hp, wp), (wd, wh, ww) = dims, window
    n = wd * wh * ww
    lo, hi = window_rows(hp // wh, size, rank)
    with torch.inference_mode(False), torch.no_grad():
        out = mask.reshape(dp // wd, hp // wh, wp // ww, n, n)[:, lo:hi].reshape(-1, n, n)
        out = out.contiguous().clone()
    if memo is not None:
        memo[key] = out
    return out


def shard_windows_call(fn: Callable, x: torch.Tensor, mask: Optional[torch.Tensor],
                       window: Tri, shift: Tri = (0, 0, 0),
                       weights: Sequence[Optional[torch.Tensor]] = ()) -> torch.Tensor:
    """``fn(x, mask, shift, *weights)``, a folded window kernel on the
    unpartitioned (B, Dp, Hp, Wp, C) tensor that is shape-preserving and
    treats each window alone, with the Hp window rows split over the active
    model axis (the module docstring).  ``mask`` is the (nW, N, N) shift
    mask or None; ``weights`` are the tensors ``fn`` reads whose gradients
    the split must sum (``None`` entries pass as they are).  Plain call
    without an axis or where its size does not divide the window rows."""
    ax = _CTX
    shift = tuple(shift)
    if ax is None or ax.size <= 1 or (x.shape[2] // window[1]) % ax.size:
        return fn(x, mask, shift, *weights)
    dims = tuple(x.shape[1:4])
    shifted = any(s > 0 for s in shift)
    if shifted:
        x = torch.roll(x, (-shift[0], -shift[1], -shift[2]), (1, 2, 3))

    def rows(xs, r, ws):
        mr = None if mask is None else mask_rows(mask, dims, window, ax.size, r)
        return fn(split_rows(xs, window, ax.size, r), mr, (0, 0, 0), *ws)

    if ax.group is None:
        out = torch.cat([_turn(ax, r, rows, x, r, weights) for r in range(ax.size)], 2)
    else:
        xs, *ws = _replicated(ax, [x, *weights])
        out = _GatherRows.apply(rows(xs, ax.rank, ws), 2, ax.group)
    if shifted:
        out = torch.roll(out, shift, (1, 2, 3))
    return out


def shard_tokens_call(fn: Callable, x: torch.Tensor, dim: int = 2,
                      weights: Sequence[Optional[torch.Tensor]] = ()) -> torch.Tensor:
    """``fn(x, *weights)``, a token-pointwise, shape-preserving kernel,
    with dimension ``dim`` of ``x`` split over the active model axis: the
    rows ``shard_windows_call`` splits, so a fold block's two kernels see
    the same split.  Plain call without an axis or where its size does
    not divide that dimension."""
    ax = _CTX
    if ax is None or ax.size <= 1 or x.shape[dim] % ax.size:
        return fn(x, *weights)
    n = x.shape[dim] // ax.size

    def part(xs, r, ws):
        return fn(xs.narrow(dim, r * n, n).contiguous(), *ws)

    if ax.group is None:
        return torch.cat([_turn(ax, r, part, x, r, weights) for r in range(ax.size)], dim)
    xs, *ws = _replicated(ax, [x, *weights])
    return _GatherRows.apply(part(xs, ax.rank, ws), dim, ax.group)


def shard_sum_call(fn: Callable, total: int, x: torch.Tensor,
                   weights: Sequence[Optional[torch.Tensor]] = ()) -> torch.Tensor:
    """``fn(x, part, *weights)`` for each model rank's slice ``part`` of
    ``range(total)`` (the plain path's heads, or the MLP's hidden columns),
    the partial results summed over the active model axis: ``fn`` returns
    the slice's share of a projection without its bias.  ``fn(x, slice(0,
    total), *weights)`` without an axis or where its size does not divide
    ``total``."""
    ax = _CTX
    if ax is None or ax.size <= 1 or total % ax.size:
        return fn(x, slice(0, total), *weights)
    n = total // ax.size
    if ax.group is None:
        out = None
        for r in range(ax.size):
            part = _turn(ax, r, fn, x, slice(r * n, (r + 1) * n), *weights)
            out = part if out is None else out + part
        return out
    xs, *ws = _replicated(ax, [x, *weights])
    r = ax.rank
    return _SumPartials.apply(fn(xs, slice(r * n, (r + 1) * n), *ws), ax.group)
