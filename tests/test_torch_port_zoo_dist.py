"""A memory family's data parallelism on the CPU: 2 gloo ranks at half
batch (``tests/torch_dist_worker.py memory_step``) against one process at
the whole batch, ``convae`` at 32x32 with a bank of 6 x 512, three Adam
steps in fp32.

The JAX step computes the memory ops over the global batch; the port's
step reduces them over the group (the query-axis softmax, the column
maxima and ``w.T @ q`` of the bank's update; the losses as global sums
over global counts), so both ranks hold one bank.  Bounds: the bank the
same bit for bit on both ranks and within 1e-5 (``BANK_ATOL``) of one
process's after every step; every loss term within rtol 1e-5 (measured
1.2e-7); the parameters the same on both ranks and within the Adam bound
(``utils.parity.check_adam_bound``) of one process's.  Not the moment and
parameter bounds of ``test_torch_port_dist.py`` (1e-4, 3e-4, set on the
GELU flagship): this ReLU decoder's activations at init are ~1e-6, and
the reordered sums move a few pre-activations of ~1e-12 across a kink,
which moves whole gradient tensors by ~1e-3 (measured 6.2e-4 moments,
1.0e-3 parameters).  The control: each rank's bank update over its own
shard alone (the losses still global) leaves the bank bound.  The same
two ranks captured (``tests/graph_double.py``: two eager steps, then a
capture and its replay, the bank's maxima and sums all-reduced inside the
replay) equal their eager run bit for bit, the bank after every step
included.
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_port_dist import assert_same_run, launch
from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse)
from torch_dist_worker import run_steps
from vadcl_tpu_torch.core.config import preset
from vadcl_tpu_torch.models import VADModel
from vadcl_tpu_torch.utils.graphs import WARMUP_CALLS
from vadcl_tpu_torch.utils.parity import check_adam_bound

BANK_ATOL, LOSS_RTOL = 1e-5, 1e-5
LR, STEPS, GLOBAL_BATCH, SIZE = 1e-4, 3, 4, 32


@pytest.fixture(scope="module")
def inputs():
    base = preset("tiny")
    cfg = base.replace(
        model=dataclasses.replace(base.model, backbone="convae", memory_size=6),
        data=dataclasses.replace(base.data, frame_num=4, image_size=(SIZE, SIZE)),
        optim=dataclasses.replace(base.optim, lr=LR, epochs=4),
    )
    model = VADModel(cfg.model, torch.float32, torch.Generator().manual_seed(0), 4)
    clips = np.random.RandomState(21).randint(
        0, 256, (STEPS, GLOBAL_BATCH, 4, SIZE, SIZE, 3)).astype(np.uint8)
    return dict(cfg=cfg, state_dict=model.state_dict(), clips=clips, steps_per_epoch=10)


@pytest.fixture(scope="module")
def one_process(inputs):
    return run_steps(inputs, 0, 1)


@pytest.fixture(scope="module")
def two_ranks(inputs, tmp_path_factory):
    return launch("memory_step", tmp_path_factory.mktemp("memory_step"), inputs)


def _bank_gap(run, ref) -> float:
    return max(float((b - r).abs().max()) for b, r in zip(run["banks"], ref["banks"]))


def test_two_ranks_hold_one_bank_and_match_one_process(two_ranks, one_process):
    r0, r1 = (r["global"] for r in two_ranks)
    for b0, b1 in zip(r0["banks"], r1["banks"]):
        assert torch.equal(b0, b1)
    assert len(r0["banks"]) == STEPS
    assert _bank_gap(r0, one_process) <= BANK_ATOL
    np.testing.assert_allclose(np.linalg.norm(r0["banks"][-1].numpy(), axis=1), 1.0, rtol=1e-6)
    assert not torch.equal(r0["banks"][0], r0["banks"][-1])  # it moved every step
    for run in (r0, r1):
        np.testing.assert_allclose(run["losses"], one_process["losses"], rtol=LOSS_RTOL)
        check_adam_bound("2 ranks against one process", run["params"], one_process["params"],
                         LR, STEPS, key_biases_apart=False)
    for k, p in r0["params"].items():
        assert torch.equal(p, r1["params"][k]), k


def test_per_rank_bank_update_leaves_the_bound(two_ranks, one_process):
    """Each rank's update over its own shard: the banks drift apart (and
    from one process's) by more than a hundredfold the bound."""
    r0, r1 = (r["per_rank_bank"] for r in two_ranks)
    assert _bank_gap(r0, one_process) > 100 * BANK_ATOL
    assert _bank_gap(r0, r1) > 100 * BANK_ATOL


# a replayed 2-rank convae step's collectives: the pixel loss's sum, the
# memory losses' two sums and two counts, the update's sum of exponentials,
# w.T @ q and two maxima, and the one gradient sum
MEMORY_STEP_COLLECTIVES = 10


def test_two_ranks_captured_bank_equals_eager_bit_for_bit(two_ranks, one_process):
    """The 2-rank convae step captured: the bank's reductions and the
    gradient sum inside the replay; each rank ends on its eager run's
    losses, moments, parameters and bank after every step bit for bit, so
    within the bank bound of one process."""
    for rank in two_ranks:
        assert_same_run(rank["captured"], rank["global"], STEPS - WARMUP_CALLS,
                        MEMORY_STEP_COLLECTIVES)
        assert _bank_gap(rank["captured"], one_process) <= BANK_ATOL
