"""The MNAD memory module (``vadcl_tpu/models/memory.py``) over
``ops/memory.py``.

The bank is state, not a parameter: a registered fp32 buffer ``keys``
(M, d), which the optimizer never sees and ``state_dict`` (hence every
checkpoint) carries.  The JAX package keeps it in its ``memory``
collection, drawn from ``jax.random.key(2023)``; the port cannot draw JAX's
bits, so it seeds a generator of its own with 2023 (a JAX bank loads
through ``convert.py``).

The update is explicit: ``forward(..., update=True)`` is the train step's
``mutable=["memory"]`` apply; every other call, whatever ``training``
says, leaves the bank alone.  The losses and the read use the bank as it
was; the new bank is then written into the buffer in place.  The buffer is
never rebound: rebinding a registered buffer fires torch's global
registration hook, which marks every captured graph in the process stale
(``utils/graphs.py``), and a captured train step would go on reading the
old tensor.  An update reads a copy of the bank, whose version the write
does not touch, so the losses' and the read's ``q @ keys.T`` keep the old
bank for their backward.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn as nn

from vadcl_tpu_torch.ops.memory import (
    Reduce,
    _l2_normalize,
    memory_losses,
    memory_read,
    memory_update,
)

BANK_SEED = 2023


class MemoryOut(NamedTuple):
    updated_query: torch.Tensor  # (B, H, W, 2d)
    keys: torch.Tensor  # (M, d): the bank after this call
    score_query: torch.Tensor
    score_memory: torch.Tensor
    separateness: torch.Tensor
    compactness: torch.Tensor


class MemoryModule(nn.Module):
    """``temp_update`` and ``temp_gather`` are in the reference's signature
    and unused by its arithmetic; kept for the same signature."""

    def __init__(self, memory_size: int = 10, key_dim: int = 512,
                 temp_update: float = 0.1, temp_gather: float = 0.1):
        super().__init__()
        self.memory_size, self.key_dim = memory_size, key_dim
        self.temp_update, self.temp_gather = temp_update, temp_gather
        self.register_buffer("keys", torch.empty(memory_size, key_dim, dtype=torch.float32))
        self.reset_parameters(None)

    def reset_parameters(self, gen) -> None:
        """The bank from its own generator (seed 2023), whatever ``gen``."""
        bank = torch.rand(self.memory_size, self.key_dim,
                          generator=torch.Generator().manual_seed(BANK_SEED))
        with torch.no_grad():
            self.keys.copy_(_l2_normalize(bank, dim=1))

    def forward(self, query: torch.Tensor, update: bool = False, global_sum: Reduce = None,
                global_max: Reduce = None) -> MemoryOut:
        """query (B, H, W, d) raw features, L2-normalised here.  ``update``
        writes the updated bank (after the losses and the read);
        ``global_sum`` / ``global_max`` reduce the losses and the update
        over a process group (``ops/memory.py``)."""
        keys = self.keys.clone() if update else self.keys
        q = _l2_normalize(query, dim=-1)
        losses = memory_losses(q, keys, global_sum)
        read = memory_read(q, keys)
        if update:
            with torch.no_grad():
                self.keys.copy_(memory_update(q, keys, global_sum, global_max))
        return MemoryOut(updated_query=read.updated_query, keys=self.keys,
                         score_query=read.score_query, score_memory=read.score_memory,
                         separateness=losses.separateness, compactness=losses.compactness)
