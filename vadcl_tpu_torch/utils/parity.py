"""Bounds that hold one training run against another of the same Adam
steps from the same weights: a data-parallel run against one process
(``chip_smoke.py``'s phase 6, ``tools/ddp_check_torch.py``, the CPU
distributed tests), the port against the JAX step (the CPU train-step
parity tests), and the card against the CPU in fp32 (``chip_smoke.py``'s
phase 9, the alternate families and the memory bank); and a serving
artifact's scores against the live scorer's."""

from __future__ import annotations

import contextlib
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

# the data-parallel step's losses against one process's in bf16: the bf16
# kernel bound (``chip_smoke.py``'s ``BOUNDS``)
DDP_LOSS_RTOL = 2e-2
# the same fp32 step on the card (TF32 off) and on the CPU: the repo's fp32
# loss bound
FP32_LOSS_RTOL = 1e-4
# a memory bank after the same fp32 update of the same bank (a unit row's
# elements are ~0.04; summation order moves them ~1e-7)
BANK_ATOL = 1e-5
# two fp32 runs may send a query to different top-1 slots only where its
# two best scores (cosines) lie closer than this: their scores differ by
# ~1e-6, and a slot chosen apart where the gap is wider is a fault
TIE_GAP = 1e-4
# the same for a bank updated from bf16 queries (the card's compute dtype):
# a data-parallel run against one process (``chip_smoke.py``'s phase 6,
# ``tools/ddp_check_torch.py``).  A bf16 query is off by up to 2^-9 of
# each element, which moves a cosine by up to ~2e-3 and a unit row's
# elements (~0.04) by ~1e-4: ten times that, and five times the score's
# worst case.  An update left per rank moves the bank ~1.5e-2 (the 2-rank
# gloo control at the tiny preset), past both.
BF16_BANK_ATOL = 1e-3
BF16_TIE_GAP = 1e-2
BANK_BOUNDS = {torch.float32: (BANK_ATOL, TIE_GAP), torch.bfloat16: (BF16_BANK_ATOL, BF16_TIE_GAP)}
# a serving artifact's scores against the live scorer's on the same windows
# (``tools/export_torch.py --check``, ``chip_smoke.py``'s export phase): the
# JAX export CLI's 1e-5 + 1e-3 max|want| in fp32, the bf16 kernel bound
# (``DDP_LOSS_RTOL``) in bf16
SCORE_RTOL = {torch.float32: 1e-3, torch.bfloat16: DDP_LOSS_RTOL}


def score_bound(want, dtype: torch.dtype) -> float:
    """The largest |artifact - live| allowed for scores ``want``."""
    return 1e-5 + SCORE_RTOL[dtype] * float(np.max(np.abs(np.asarray(want))))


def _tensor(x) -> torch.Tensor:
    return x.detach() if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))


def key_bias(name: str, p: torch.Tensor) -> torch.Tensor:
    """True on the key third of a ``qkv_bias``, False elsewhere."""
    mask = torch.zeros_like(_tensor(p), dtype=torch.bool)
    if name.endswith("attn.qkv_bias"):
        c = mask.numel() // 3
        mask[c:2 * c] = True
    return mask


def check_adam_bound(label: str, got: Mapping, want: Mapping, lr: float, steps: int,
                     key_biases_apart: bool = True) -> Dict[str, float]:
    """Hold each tensor of ``got`` against ``want``'s of the same name
    after ``steps`` Adam steps at ``lr``.  Adam moves an element by about
    lr a step whatever its gradient, so an element whose gradient is
    within rounding of zero may step the other way: every element stays
    within 2.5 lr a step, and fewer than 2% of a tensor's elements lie
    beyond one lr.

    With ``key_biases_apart`` the key third of each ``qkv_bias`` (torch
    names) is held to 2 lr a step and left out of the rest: its gradient
    is zero in exact arithmetic (a constant added to every key of a query
    leaves the softmax unchanged), so both runs hold rounding noise there,
    which Adam turns into steps of +-lr whatever its size.

    Raises ``AssertionError`` naming the first tensor out of bounds;
    returns the number of tensors equal bit for bit (``same`` of
    ``tensors``), the largest difference (``worst``, against ``bound``)
    and the largest share of a tensor beyond one lr (``beyond``)."""
    bound = 2.5 * lr * steps
    same, worst, beyond = 0, 0.0, 0.0
    for k, w in want.items():
        g, w = _tensor(got[k]), _tensor(w)
        same += int(torch.equal(g, w))
        diff = (g.float() - w.float()).abs()
        key = key_bias(k, diff) if key_biases_apart else torch.zeros_like(diff, dtype=torch.bool)
        if key.any() and float(diff[key].max()) > 2 * lr * steps:
            raise AssertionError(f"{label}: {k}'s key bias moved more than 2 lr a step")
        rest = diff[~key]
        share = float((rest > lr).float().mean())
        if float(rest.max()) > bound or share >= 0.02:
            raise AssertionError(f"{label}: {k} leaves the Adam bound (largest difference "
                                 f"{float(rest.max()):.3e}, bound {bound:.3e}; {share:.2%} "
                                 f"beyond one lr, bound 2%)")
        worst, beyond = max(worst, float(rest.max())), max(beyond, share)
    return {"same": same, "tensors": len(want), "worst": worst, "beyond": beyond,
            "bound": bound}


def top1_slots(query: torch.Tensor, keys: torch.Tensor):
    """Each query's best slot of the bank and the gap between its two best
    scores (cosines of the L2-normalised query (..., d) and ``keys``)."""
    score = query.float().reshape(-1, keys.shape[-1]) @ keys.float().t()
    top = score.topk(2, dim=1)
    return top.indices[:, 0], top.values[:, 0] - top.values[:, 1]


def check_bank(label: str, got, want, slots_got, slots_want, gap,
               bounds: Tuple[float, float] = (BANK_ATOL, TIE_GAP)) -> Dict[str, float]:
    """Hold a bank ``got`` after its updates against ``want``, another
    run's: ``slots_*`` are the top-1 slot each run gave each query of each
    update (``top1_slots``, concatenated in the same order), ``gap`` the
    second run's score gaps.  ``bounds`` is (row bound, tie gap),
    ``BANK_BOUNDS`` of the queries' dtype.  A query whose slot differs must
    be a near tie (gap below the tie gap): its weight then lands in another
    row, which is a legitimate outcome, and the rows of both slots are left
    out; every other row is within the row bound, and at least one row must
    remain.  Raises ``AssertionError``; returns the queries sent apart
    (``moved``), the largest gap among them (``gap_apart``), the rows left
    out (``rows_apart``) and the largest difference of the rest
    (``worst``)."""
    atol, tie_gap = bounds
    got, want = _tensor(got).float().cpu(), _tensor(want).float().cpu()
    slots_got, slots_want = _tensor(slots_got).cpu(), _tensor(slots_want).cpu()
    gap = _tensor(gap).float().cpu()
    apart = slots_got != slots_want
    gap_apart = float(gap[apart].max()) if bool(apart.any()) else 0.0
    if gap_apart >= tie_gap:
        raise AssertionError(f"{label}: a query took another top-1 slot at a score gap of "
                             f"{gap_apart:.3e} (ties below {tie_gap:g} only)")
    rows = torch.zeros(got.shape[0], dtype=torch.bool)
    rows[slots_got[apart]] = True
    rows[slots_want[apart]] = True
    if bool(rows.all()):
        raise AssertionError(f"{label}: queries at near ties left every row out")
    worst = float((got - want).abs().amax(dim=1)[~rows].max())
    if worst > atol:
        raise AssertionError(f"{label}: bank rows differ by {worst:.3e} (bound {atol:g})")
    return {"moved": int(apart.sum()), "gap_apart": gap_apart, "rows_apart": int(rows.sum()),
            "worst": worst}


@contextlib.contextmanager
def recording_bank_updates():
    """While open, records every memory-bank update
    (``models.memory.memory_update``, as the train step calls it): the
    query (fp32, flattened) and bank it was given and the bank it returned,
    all on the CPU, and the top-1 slot of each query and the gap of its two
    best scores, computed where the update ran.  Yields the list."""
    from vadcl_tpu_torch.models import memory

    calls, real = [], memory.memory_update

    def recorded(query, keys, global_sum=None, global_max=None):
        out = real(query, keys, global_sum, global_max)
        slots, gap = top1_slots(query.detach(), keys)
        calls.append(dict(query=query.detach().float().reshape(-1, keys.shape[-1]).cpu(),
                          keys=keys.detach().cpu(), new=out.detach().cpu(), slots=slots.cpu(),
                          gap=gap.cpu()))
        return out

    memory.memory_update = recorded
    try:
        yield calls
    finally:
        memory.memory_update = real
