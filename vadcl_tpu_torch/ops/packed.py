"""A cache of packed kernel operands.

The redesigned forward kernels read their weights (and the fold kernels
their rel-pos bias and shift mask) in layouts made for the card: rows padded
against shared-memory bank conflicts, slices contiguous so that one bulk copy
stages each, score terms in the order of the tensor-core accumulator's
registers.  Packing is plain PyTorch on tensors (a few small library kernels),
so it is done once per distinct operand, not once per call.

An entry sits in the slot of its source tensor objects and remembers their
``(data_ptr, _version, dtype, device, shape)`` and a weak reference to each:
scoring packs a parameter once; a training step, whose optimizer updates the
parameter in place and so bumps ``_version``, packs it again into the same
slot; and a temporary that died (whose id and address may pass to another
tensor of the same shape) can never be mistaken for its successor, because a
hit also requires the very same tensor objects to be alive.  A tensor made
under ``torch.inference_mode`` tracks no version, so a change to it could not
be seen: operands that include one are packed at every call.

A CUDA graph being captured reads the packed tensor by address, not its
sources, so every lookup names its sources to the capture
(``utils/graphs.py:note_sources``), which then holds the graph stale when
one of them changes.  A captured train step updates the sources at every
replay, so inside its capture (``utils/graphs.py:pack_region``) a pack is
made in the captured region and serves that region only: an entry carries
the region it was made in, and a lookup hits only an entry of its own.
"""

from __future__ import annotations

import weakref
from typing import Callable, Dict, Sequence, Tuple

import torch

from vadcl_tpu_torch.utils.graphs import note_sources, pack_region


def _state(t: torch.Tensor) -> tuple:
    return (t.data_ptr(), t._version, t.dtype, t.device, t.shape)


class PackCache:
    """``get(sources, extra, make)`` returns ``make()`` for these source
    tensors, computed once while they stay alive and unmodified."""

    _SWEEP_EVERY = 256  # misses between two sweeps of entries whose sources died

    def __init__(self) -> None:
        self._entries: Dict[tuple, Tuple[tuple, tuple, object]] = {}
        self._misses = 0

    def get(self, sources: Sequence[torch.Tensor], extra: tuple, make: Callable[[], object]):
        note_sources(sources)
        if any(t.is_inference() for t in sources):
            return make()
        slot = (tuple(id(t) for t in sources), tuple(extra))
        state = (pack_region(),) + tuple(_state(t) for t in sources)
        entry = self._entries.get(slot)
        if (entry is not None and entry[0] == state
                and all(r() is t for r, t in zip(entry[1], sources))):
            return entry[2]
        self._misses += 1
        value = make()
        self._entries[slot] = (state, tuple(weakref.ref(t) for t in sources), value)
        if self._misses % self._SWEEP_EVERY == 0:
            self._sweep()
        return value

    def _sweep(self) -> None:
        """Drop the entries of sources that died (temporaries)."""
        dead = [slot for slot, (_, refs, _) in self._entries.items()
                if any(r() is None for r in refs)]
        for slot in dead:
            del self._entries[slot]

    def __len__(self) -> int:
        return len(self._entries)
