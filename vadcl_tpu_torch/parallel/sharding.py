"""Cross-process operations of data parallelism
(``vadcl_tpu/parallel/sharding.py``).

Each process keeps its own shard of the batch (the loader's per-rank
slice), so the JAX package's ``local_batch_to_global``, which assembles the
global array from the hosts' shards, has no counterpart here: the train
step sums the gradients over the group instead
(``train/step.py:GradientExchange``).
What remains is the loss's batch sums (``global_sum``), the memory bank's
maxima over the batch (``global_max``, ``ops/memory.py``) and gathering
eval results (``cross_host_gather_ragged``, ``cross_host_concat``).  Outside a
process group every function returns its input.
"""

from __future__ import annotations

from typing import Any, List

import numpy as np
import torch
import torch.distributed as dist

from vadcl_tpu_torch.core.mesh import is_distributed


class _GlobalSum(torch.autograd.Function):
    """All-reduce (sum) forward, identity backward: this rank's term enters
    the global sum with coefficient 1, and every rank holds the same
    upstream gradient (the rest of the loss is computed from the same
    all-reduced values), so each rank's gradient is the global loss's
    gradient through its own shard; summing them over ranks gives the
    global gradient."""

    @staticmethod
    def forward(ctx, t, group):
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def global_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` summed over ``group`` (default: the whole process group; under
    tensor parallelism the data group, ``core/mesh.py:make_mesh_2d``), with
    the gradient of that sum reaching this rank's ``t``; ``t`` itself
    outside a group."""
    return _GlobalSum.apply(t, group) if is_distributed() else t


def global_max(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t``'s elementwise maximum over ``group`` (as ``global_sum``),
    without a gradient (the memory bank's update, which is detached, is its
    only user); ``t`` itself outside a group."""
    if not is_distributed():
        return t
    out = t.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def _comm_device() -> torch.device:
    """Where the group's collectives take their tensors: the current card
    under NCCL, the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def cross_host_gather_ragged(arr: np.ndarray) -> np.ndarray:
    """Concatenate every process's ``arr`` along axis 0 in rank order; the
    leading lengths may differ (a rank may hold none), the trailing shape
    and the dtype may not.  The lengths gather first, each rank pads to the
    longest, the padded arrays gather, and each is cut back to its length.
    Outside a group ``arr`` is returned."""
    if not is_distributed():
        return arr
    arr = np.ascontiguousarray(arr)
    dev, world = _comm_device(), dist.get_world_size()
    n = torch.tensor([arr.shape[0]], dtype=torch.int64, device=dev)
    lens = [torch.zeros_like(n) for _ in range(world)]
    dist.all_gather(lens, n)
    lens = [int(x.item()) for x in lens]
    longest = max(lens)
    if longest == 0:
        return arr
    padded = np.zeros((longest,) + arr.shape[1:], arr.dtype)
    padded[: arr.shape[0]] = arr
    mine = torch.from_numpy(padded).to(dev)
    parts = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(parts, mine)
    return np.concatenate([p[:k].cpu().numpy() for p, k in zip(parts, lens)], axis=0)


def cross_host_concat(values: List[Any]) -> List[Any]:
    """Every process's list of picklable ``values``, concatenated in rank
    order; ``values`` outside a group."""
    if not is_distributed():
        return values
    gathered: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, values)
    return [v for per_rank in gathered for v in per_rank]
