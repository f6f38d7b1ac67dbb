"""``train()`` on the CPU: a run killed mid-epoch resumes inside the epoch
and ends where an uninterrupted one does (``test_torch_port_train.py``'s
tiny preset and Adam bound)."""

import dataclasses
import os

import numpy as np
import pytest

from test_torch_port_train import LR, _clips
from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse)
from vadcl_tpu_torch.core.config import preset
from vadcl_tpu_torch.train import train


class _Loader:
    """In-memory uint8 loader with the HostDataLoader protocol."""

    batch_size = 2

    def __init__(self, crash_after=None):
        self.data = _clips(6, seed=3)
        self.crash_after = crash_after

    def steps_per_epoch(self):
        return 3

    def epoch(self, e, start_iter=0):
        for i in range(start_iter, 3):
            if self.crash_after is not None and e * 3 + i >= self.crash_after:
                raise KeyboardInterrupt("simulated kill")
            yield self.data[(e * 3 + i) % 6]


def test_train_loop_crash_resume_matches_uninterrupted(tmp_path):
    """train() on an in-memory loader; a run killed mid-epoch after an
    iteration checkpoint resumes inside the epoch and ends on the loss
    records and (within the Adam bound) the parameters of an uninterrupted
    run."""
    base = preset("tiny")
    cfg = base.replace(
        model=dataclasses.replace(base.model, predict=True, fused_attention=True,
                                  fused_cluster=True, attn_kernel="fold"),
        optim=dataclasses.replace(base.optim, lr=LR, epochs=2),
        save_every_iters=2,
    )
    ref = train(cfg.replace(output_dir=str(tmp_path / "a")), _Loader(), device="cpu")
    assert ref.step == 6
    want = np.load(tmp_path / "a" / "loss_record" / "loss.npy")
    assert want.shape == (6,) and np.all(np.isfinite(want))

    out = str(tmp_path / "b")
    with pytest.raises(KeyboardInterrupt):
        train(cfg.replace(output_dir=out), _Loader(crash_after=4), device="cpu")
    mid = np.load(os.path.join(out, "loss_record", "loss.npy"))
    np.testing.assert_allclose(mid, want[:4], rtol=1e-6)
    got = train(cfg.replace(output_dir=out), _Loader(), device="cpu")
    assert got.step == 6
    np.testing.assert_allclose(np.load(os.path.join(out, "loss_record", "loss.npy")), want,
                               rtol=1e-6)
    # CPU backward sums are not bitwise deterministic between runs, and Adam
    # turns a last-bit gradient difference into up to one lr-step: the
    # final-parameter bound of the trajectory tests
    for (k, a), (_, b) in zip(ref.model.named_parameters(), got.model.named_parameters()):
        diff = (a - b).abs().detach()
        assert float(diff.max()) <= 2.5 * LR * 6, k
        assert float((diff > LR).float().mean()) < 0.02, k
    log = open(os.path.join(out, "exp.log")).read()
    assert "resumed from checkpoint 4 at epoch 1 iter 1" in log
    assert "Epoch:[1/2]\t batch:[2/3]\t loss=" in log


