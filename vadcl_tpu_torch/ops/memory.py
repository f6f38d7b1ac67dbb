"""MNAD-style memory addressing (``vadcl_tpu/ops/memory.py``): cosine-score
addressing with two softmaxes, the top-1 score-weighted update as a one-hot
segment sum, and the separateness / compactness losses.

The bank is ``keys`` (M, d), the query (B, H, W, d) is L2-normalised over d.
Ties of ``argmax`` and of the top-2 pick resolve to the first slot, as the
JAX functions' ``argmax`` and ``top_k`` do.

Across a process group (a data-parallel train step) the JAX step computes
these over the global batch.  ``memory_update`` and ``memory_losses`` take
the group's reductions (``parallel.sharding.global_sum``,
``global_max``; ``None`` = this process alone): the query-axis softmax, the
column maxima and ``w.T @ q`` of the update, and the losses' sums and
counts, so that every process computes the same bank and the global
batch's losses.  The read and the scores are per query and need none.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

Reduce = Optional[Callable[[torch.Tensor], torch.Tensor]]


def _l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """``F.normalize``: x / max(||x||, eps), computed in fp32 and cast back
    to the input's dtype."""
    x32 = x.float()
    n = torch.linalg.vector_norm(x32, dim=dim, keepdim=True)
    return (x32 / torch.clamp(n, min=eps)).to(x.dtype)


def _reduce(t: torch.Tensor, fn: Reduce) -> torch.Tensor:
    return t if fn is None else fn(t)


def memory_scores(keys: torch.Tensor, query: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """query (N, d), keys (M, d) -> (score_query, score_memory): the softmax
    of ``query @ keys.T`` over the query axis (every query of the batch)
    and over the slots."""
    score = query.float() @ keys.float().t()
    return torch.softmax(score, dim=0), torch.softmax(score, dim=1)


def _top2(s_m: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The best and second-best slot of each row, ties to the first slot
    (``jax.lax.top_k``'s order; ``torch.topk`` leaves the order of ties
    open).  Softmax values are >= 0, so -1 takes the first pick out."""
    first = s_m.argmax(dim=1)
    rest = s_m.scatter(1, first[:, None], -1.0)
    return first, rest.argmax(dim=1)


class MemoryReadOut(NamedTuple):
    updated_query: torch.Tensor  # (B, H, W, 2d): concat(query, score_memory @ keys)
    score_query: torch.Tensor  # (N, M)
    score_memory: torch.Tensor  # (N, M)


def memory_read(query_bhwd: torch.Tensor, keys: torch.Tensor) -> MemoryReadOut:
    """The addressed summary of the bank concatenated to the query; the
    addressing weights are detached, as the reference detaches
    ``softmax_score_memory``.  ``score_query`` is over this call's queries."""
    B, H, W, d = query_bhwd.shape
    q = query_bhwd.reshape(-1, d)
    s_q, s_m = memory_scores(keys, q)
    addressed = s_m.detach() @ keys.float()
    out = torch.cat([q.float(), addressed], dim=-1)
    return MemoryReadOut(updated_query=out.reshape(B, H, W, 2 * d).to(query_bhwd.dtype),
                         score_query=s_q, score_memory=s_m)


@torch.no_grad()
def memory_update(query_bhwd: torch.Tensor, keys: torch.Tensor, global_sum: Reduce = None,
                  global_max: Reduce = None) -> torch.Tensor:
    """The bank after one update, detached: each slot adds the queries whose
    top-1 slot it is, weighted by ``score_query / max(colmax(score_query),
    1e-12)``, and is re-normalised:
    ``normalize(w.T @ q + keys)``, ``w = onehot(argmax s_m) * s_q / colmax``.
    ``global_sum`` / ``global_max`` reduce the query-axis softmax, the
    column maxima and ``w.T @ q`` over the process group."""
    d = query_bhwd.shape[-1]
    q = query_bhwd.reshape(-1, d).float()
    score = q @ keys.float().t()
    s_m = torch.softmax(score, dim=1)
    # the softmax over the query axis: every process's queries
    e = torch.exp(score - _reduce(score.max(dim=0, keepdim=True).values, global_max))
    s_q = e / _reduce(e.sum(dim=0, keepdim=True), global_sum)
    # (a scatter, not ``F.one_hot``, which checks its indices on the host)
    onehot = torch.zeros_like(s_m).scatter_(1, s_m.argmax(dim=1, keepdim=True), 1.0)
    col_max = _reduce(s_q.max(dim=0, keepdim=True).values, global_max)
    w = onehot * s_q / torch.clamp(col_max, min=1e-12)
    query_update = _reduce(w.t() @ q, global_sum)
    return _l2_normalize(query_update + keys.float(), dim=1).to(keys.dtype)


class MemoryLosses(NamedTuple):
    compactness: torch.Tensor  # MSE(query, keys[top1])  (gathering loss)
    separateness: torch.Tensor  # triplet(query, keys[top1], keys[top2]), margin 1


def _mean(x: torch.Tensor, global_sum: Reduce) -> torch.Tensor:
    """The mean of ``x``, over every process's elements with ``global_sum``
    (a global sum over a global count: a per-process mean whose gradients
    the step sums would be off by the world size).  The count is filled on
    the device: a host-to-device copy would stop a CUDA graph's capture."""
    count = torch.full((), float(x.numel()), dtype=torch.float32, device=x.device)
    return _reduce(x.sum(), global_sum) / _reduce(count, global_sum)


def memory_losses(query_bhwd: torch.Tensor, keys: torch.Tensor,
                  global_sum: Reduce = None) -> MemoryLosses:
    """Gathering (compactness) and spreading (separateness) losses against
    the detached top-1 and top-2 keys; the triplet term adds torch's
    ``pairwise_distance`` eps of 1e-6 inside the norm."""
    d = query_bhwd.shape[-1]
    q = query_bhwd.reshape(-1, d).float()
    _, s_m = memory_scores(keys, q)
    first, second = _top2(s_m.detach())
    k = keys.detach().float()
    pos, neg = k[first], k[second]
    compact = _mean((q - pos) ** 2, global_sum)
    eps = 1e-6
    d_pos = torch.linalg.vector_norm(q - pos + eps, dim=1)
    d_neg = torch.linalg.vector_norm(q - neg + eps, dim=1)
    separate = _mean(torch.clamp(d_pos - d_neg + 1.0, min=0.0), global_sum)
    return MemoryLosses(compactness=compact, separateness=separate)


class MemoryTop1(NamedTuple):
    keys: torch.Tensor  # (N, d) nearest memory item per query (detached)
    index: torch.Tensor  # (N,) its slot index


def memory_top1(query_bhwd: torch.Tensor, keys: torch.Tensor) -> MemoryTop1:
    """The nearest memory item of each query and its slot (MNAD's
    test-time top-1 addressing)."""
    d = query_bhwd.shape[-1]
    q = query_bhwd.reshape(-1, d).float()
    _, s_m = memory_scores(keys, q)
    top1 = s_m.argmax(dim=1)
    return MemoryTop1(keys=keys.detach().float()[top1], index=top1)


def memory_pointwise_compactness(query_bhwd: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """The unreduced compactness loss (N, d) against the detached top-1 key:
    MNAD's per-location anomaly-energy map at test time."""
    d = query_bhwd.shape[-1]
    q = query_bhwd.reshape(-1, d).float()
    return (q - memory_top1(query_bhwd, keys).keys) ** 2


def memory_loss_regularizer(keys: torch.Tensor) -> torch.Tensor:
    """The mean off-diagonal |shifted cosine similarity| of the bank
    (the reference's ``MemoryLoss``)."""
    m = keys.shape[0]
    k = keys.float()
    sim = (k @ k.t()) / 2.0 + 0.5
    sim = torch.abs(sim - torch.eye(m, dtype=torch.float32, device=keys.device))
    return sim.sum() / (m * (m - 1))
