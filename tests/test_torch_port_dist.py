"""The port's data parallelism on the CPU: several gloo processes
(``tests/torch_dist_worker.py``, each with one torch thread and a
``FileStore`` of its own under ``tmp_path``) against one process and
against the JAX package.

Every launch waits at most ``LAUNCH_TIMEOUT`` seconds for its processes
(then kills them and fails), and each process group bounds its collectives
by the worker's ``GROUP_TIMEOUT``: a hung rendezvous fails the test.

Bounds, two ranks at half batch against one process at the whole batch
over three Adam steps (fp32).  The control (``run_half_batches``) does the
same in one process with no collective: each global batch as two
half-batch passes whose gradients accumulate, each half's loss taking the
other half's batch sums.

* Two ranks against the control, to the all-reduce's rounding: loss
  terms, Adam moments and every parameter (the key biases included), each
  tensor's max |diff| over its max |control|, ``LOSS_REL`` 1e-5 (measured:
  0, bit for bit: with two ranks the all-reduce adds two numbers, as the
  control does).
* Two ranks (and the control) against one process at batch 4, where only
  the order of the batch sums differs: every loss term, relative to its
  largest value, ``LOSS_REL`` (measured 1.4e-7); each Adam moment tensor,
  max |diff| over max |one process|, ``MOMENT_REL`` 1e-4 (measured 2.2e-5:
  the space-cluster centers and the relative-position tables, whose
  gradients are sums with much cancellation); each parameter tensor, max
  |diff| over max |one process|, ``PARAM_REL`` 3e-4 (measured 1.4e-4), and
  ||diff|| over ||one process||, ``MOMENT_REL`` (measured 3.6e-5).  The
  control reads the same numbers, so the gap past 1e-5 is the reordering
  alone.  The key third of ``qkv_bias`` is apart: its gradient is zero in
  exact arithmetic (a constant added to every key of a query leaves its
  softmax unchanged), so both runs hold rounding noise there, in its
  moments too, which Adam turns into steps of +-lr: it is held to 2 lr a
  step.

The reference's semantics (each rank's own loss, averaged gradients) lands
0.30 (losses), 0.58 (moments) and 0.31 (parameters, norm ratio) away:
outside these bounds by three orders of magnitude and more.  The same two
ranks captured (``tests/graph_double.py``: two eager steps, then a capture
and its replay, every collective of the step inside the replay) equal
their eager run bit for bit, and so hold to the same bounds.  Against the
JAX step: the bounds of ``test_torch_port_train_steps.py`` (loss rtol
1e-4, the final-parameter Adam bound).  Distributed AUCs equal the
one-process ones to 1e-12.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vadcl_tpu.eval.predict as jax_predict
import vadcl_tpu_torch.eval.predict as port_predict
from vadcl_tpu_torch.utils.parity import key_bias
from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_port_train import LR, _configs, _port_model, jax_variables  # noqa: F401
from test_torch_port_train_steps import _assert_params_close
from torch_dist_worker import STEPS_CAPTURED, run_half_batches, run_steps
from vadcl_tpu.core.config import preset as jax_preset
from vadcl_tpu.models.backbone import VADModel as JaxVADModel
from vadcl_tpu.train.checkpoint import flatten_state
from vadcl_tpu.train.optim import build_optimizer as jax_build_optimizer
from vadcl_tpu.train.optim import cosine_epoch_lr as jax_cosine_epoch_lr
from vadcl_tpu.train.optim import param_gate_thresholds as jax_param_gates
from vadcl_tpu.train.step import TrainState as JaxTrainState
from vadcl_tpu.train.step import make_train_step as jax_make_train_step
from vadcl_tpu_torch.convert import load_state_dict_strict, state_dict_from_jax
from vadcl_tpu_torch.core.config import preset
from vadcl_tpu_torch.models import VADModel
from vadcl_tpu_torch.utils.graphs import WARMUP_CALLS

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_dist_worker.py")
LAUNCH_TIMEOUT = 240  # seconds for every process of one launch
LOSS_REL, MOMENT_REL, PARAM_REL = 1e-5, 1e-4, 3e-4  # (the module docstring)
STEPS, STEPS_PER_EPOCH, GLOBAL_BATCH = 3, 3, 4
# cluster losses from step 0, compactness and the cluster parameters from
# step 1: three steps cross the gated and the ungated phases
SCHED = dict(cluster_start_iter=0, compactness_start_iter=1, cluster_train_start_iter=1)


def launch(mode: str, workdir, inputs: dict, world: int = 2) -> list:
    """Run ``world`` worker processes of ``mode`` on ``inputs``; their
    results in rank order."""
    workdir = str(workdir)
    torch.save(inputs, os.path.join(workdir, "inputs.pt"))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, WORKER, mode, str(r), str(world), workdir],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
             for r in range(world)]
    deadline = time.monotonic() + LAUNCH_TIMEOUT
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            errs.append(err)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, err) in enumerate(zip(procs, errs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{err[-4000:]}"
    return [torch.load(os.path.join(workdir, f"{mode}_rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _clips():
    return np.random.RandomState(7).randint(
        0, 256, (STEPS, GLOBAL_BATCH, 4, 56, 56, 3)).astype(np.uint8)


@pytest.fixture(scope="module")
def step_inputs(jax_variables):
    _, pcfg = _configs(True, **SCHED)
    model = _port_model(jax_variables, pcfg)
    return dict(cfg=pcfg, state_dict=model.state_dict(), clips=_clips(),
                steps_per_epoch=STEPS_PER_EPOCH)


@pytest.fixture(scope="module")
def one_process(step_inputs):
    """The port's one-process step at the global batch."""
    return run_steps(step_inputs, 0, 1)


@pytest.fixture(scope="module")
def half_batches(step_inputs):
    """The control: two half-batch passes a step in one process."""
    return run_half_batches(step_inputs)


@pytest.fixture(scope="module")
def two_ranks(step_inputs, tmp_path_factory):
    return launch("step", tmp_path_factory.mktemp("step"), step_inputs)


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.max(np.abs(want), axis=0)))


def _worst(run, ref, apart=None) -> dict:
    """``run`` against ``ref``: the largest relative error of the loss
    terms, of the Adam moments and of the parameters (max |diff| over max
    |ref|, and the norm ratio), the key biases apart, and the largest
    difference of a key-bias parameter.  ``apart`` (a parameter's name to
    a bool mask) leaves more elements out of the parameter measures."""
    out = {"loss": _rel_err(run["losses"], ref["losses"]), "moments": 0.0, "params": 0.0,
           "params_norm": 0.0, "key_bias": 0.0}
    assert ref["moments"].keys() == run["moments"].keys() == ref["params"].keys()
    for k, p_ref in ref["params"].items():
        key = key_bias(k, p_ref)
        for got, want in zip(run["moments"][k], ref["moments"][k]):
            out["moments"] = max(out["moments"], _rel_err(got[~key], want[~key]))
        diff = run["params"][k] - p_ref
        held = ~key if apart is None else ~key & ~apart[k]
        if held.any():
            out["params"] = max(out["params"], _rel_err(run["params"][k][held], p_ref[held]))
            out["params_norm"] = max(out["params_norm"],
                                     float(diff[held].norm() / p_ref[held].norm()))
        if key.any():
            out["key_bias"] = max(out["key_bias"], float(diff[key].abs().max()))
    return out


def _assert_one_process_bounds(worst: dict) -> None:
    assert worst["loss"] <= LOSS_REL, worst
    assert worst["moments"] <= MOMENT_REL and worst["params_norm"] <= MOMENT_REL, worst
    assert worst["params"] <= PARAM_REL, worst
    assert worst["key_bias"] <= 2 * LR * STEPS, worst


def test_two_ranks_match_one_process(two_ranks, one_process):
    """2 gloo ranks at batch 2 each against one process at batch 4, three
    steps: the global loss, the Adam moments and the parameters agree to
    the reordered sums' rounding (the module docstring), and both ranks
    hold the same losses and parameters bit for bit."""
    for rank in two_ranks:
        _assert_one_process_bounds(_worst(rank["global"], one_process))
    r0, r1 = (r["global"] for r in two_ranks)
    assert r0["losses"] == r1["losses"]
    for k, p in r0["params"].items():
        assert torch.equal(p, r1["params"][k]), k


def test_two_ranks_match_the_half_batch_control(two_ranks, half_batches, one_process):
    """The same arithmetic in one process, two half-batch passes a step and
    no collective: the 2-rank run equals it to the all-reduce's rounding
    (``LOSS_REL``, every tensor whole, the key biases included), and the
    control alone already lies past ``LOSS_REL`` from one process at batch
    4, within the bounds the 2-rank run is held to: the reordered sums, not
    the collective, set those bounds."""
    for rank in two_ranks:
        run = rank["global"]
        assert _rel_err(run["losses"], half_batches["losses"]) <= LOSS_REL
        for k, p in half_batches["params"].items():
            assert _rel_err(run["params"][k], p) <= LOSS_REL, k
            for got, want in zip(run["moments"][k], half_batches["moments"][k]):
                assert _rel_err(got, want) <= LOSS_REL, k
    control = _worst(half_batches, one_process)
    _assert_one_process_bounds(control)
    assert control["moments"] > LOSS_REL and control["params"] > LOSS_REL, control


def assert_same_run(got, want, replays, per_replay) -> None:
    """A captured run (``torch_dist_worker.run_captured``) against the
    eager run of the same steps: one capture, ``replays`` replays, each
    running ``per_replay`` collectives; the losses, the Adam moments, every
    parameter (and a memory family's bank after each step) bit for bit."""
    assert got["captures"] == 1 and got["replays"] == replays
    assert got["collectives"] == per_replay * replays
    assert got["losses"] == want["losses"]
    assert got["params"].keys() == want["params"].keys()
    for k, p in want["params"].items():
        assert torch.equal(got["params"][k], p), k
    for k, pair in want["moments"].items():
        assert all(torch.equal(a, b) for a, b in zip(got["moments"][k], pair)), k
    for a, b in zip(got.get("banks", []), want.get("banks", [])):
        assert torch.equal(a, b)


# a replayed 2-rank flagship step's collectives: the three loss sums and the
# one gradient sum (every parameter fp32: one buffer)
STEP_COLLECTIVES = 4


def test_two_ranks_captured_step_equals_eager_bit_for_bit(two_ranks):
    """The 2-rank step captured: its replay's collectives (the loss sums
    before the roots, the gradients' one sum) run inside it, and each rank
    ends on its eager run's losses, moments and parameters bit for bit."""
    assert STEPS == STEPS_CAPTURED
    for rank in two_ranks:
        assert_same_run(rank["captured"], rank["global"], STEPS - WARMUP_CALLS, STEP_COLLECTIVES)


def test_two_ranks_captured_step_matches_one_process_and_jax(two_ranks, one_process,
                                                              jax_three_steps, jax_variables,
                                                              step_inputs):
    """The captured 2-rank run held, as the eager one is, to one process at
    batch 4 (the module docstring's bounds) and to the JAX step's three
    steps (loss rtol 1e-4, the final-parameter Adam bound)."""
    losses, jax_params = jax_three_steps
    init = flatten_state({"params": jax_variables["params"]})
    for rank in two_ranks:
        run = rank["captured"]
        _assert_one_process_bounds(_worst(run, one_process))
        np.testing.assert_allclose([l[0] for l in run["losses"]], losses, rtol=1e-4)
        model = VADModel(step_inputs["cfg"].model, torch.float32)
        model.load_state_dict(run["params"], strict=False)
        _assert_params_close(model, jax_params, init, STEPS)


def test_per_rank_loss_leaves_the_bound(two_ranks, one_process):
    """The reference's DDP semantics (each rank's loss over its own shard,
    gradients averaged) is not the JAX step's: square roots of batch sums
    do not split over ranks, and the run leaves every bound the global loss
    holds by more than a hundredfold."""
    worst = _worst(two_ranks[0]["per_rank"], one_process)
    assert worst["loss"] > 100 * LOSS_REL, worst
    assert worst["moments"] > 100 * MOMENT_REL and worst["params_norm"] > 100 * MOMENT_REL, worst
    assert worst["params"] > 100 * PARAM_REL, worst


@pytest.fixture(scope="module")
def jax_three_steps(jax_variables):
    """The JAX make_train_step (XLA path) over the same three global
    batches: per-step losses and the final parameters."""
    jcfg, _ = _configs(False, **SCHED)
    params = jax_variables["params"]
    extras = {k: v for k, v in jax_variables.items() if k != "params"}
    o = jcfg.optim
    lr = jax_cosine_epoch_lr(o.lr, o.min_lr, o.epochs, STEPS_PER_EPOCH, o.warmup_epochs)
    tx = jax_build_optimizer(
        o.optimizer, lr, weight_decay=o.weight_decay, b1=o.b1, b2=o.b2, eps=o.eps,
        gate_thresholds=jax_param_gates(params, jcfg.schedule.cluster_train_start_iter),
    )
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, extras=extras,
                          opt_state=tx.init(params))
    step_fn = jax_make_train_step(JaxVADModel(config=jcfg.model), jcfg, tx, STEPS_PER_EPOCH)
    losses = []
    for clip in _clips():
        state, m = step_fn(state, jnp.asarray(clip))
        losses.append(float(m.loss))
    return losses, flatten_state({"params": state.params})


def test_two_ranks_match_jax(two_ranks, one_process, jax_three_steps, jax_variables,
                             step_inputs):
    """The 2-rank run and the one-process run against the JAX step on the
    same four clips a step, with the bounds of the train-step parity tests."""
    losses, jax_params = jax_three_steps
    init = flatten_state({"params": jax_variables["params"]})
    for run in (two_ranks[0]["global"], one_process):
        np.testing.assert_allclose([l[0] for l in run["losses"]], losses, rtol=1e-4)
        model = VADModel(step_inputs["cfg"].model, torch.float32)
        model.load_state_dict(run["params"], strict=False)
        _assert_params_close(model, jax_params, init, STEPS)


def test_train_two_processes_gate_writes_and_resume(tmp_path):
    """``train()`` in 2 gloo processes: only rank 0 writes (rank 1's every
    write below the run directory is recorded: none), rank 1 logs nowhere,
    ``run_meta.json`` records 2 processes, and a run stopped after 3 steps
    and resumed from its step-2 checkpoint ends on the uninterrupted run's
    loss records and parameters."""
    base = preset("tiny")
    cfg = base.replace(
        model=dataclasses.replace(base.model, predict=True, fused_attention=True,
                                  fused_cluster=True, attn_kernel="fold"),
        optim=dataclasses.replace(base.optim, lr=LR, epochs=2),
        save_every_iters=2, batch_size_per_device=2,
    )
    clips = np.random.RandomState(3).randint(0, 256, (3, 4, 4, 56, 56, 3)).astype(np.uint8)
    r0, r1 = launch("train", tmp_path, dict(cfg=cfg, clips=clips, stop_after=3))
    for r in (r0, r1):
        assert r["steps"] == (6, 6) and r["stopped_step"] == 3
    assert r1["writes"] == [], r1["writes"]
    assert r1["handlers"] == ["NullHandler"] and r0["handlers"] == ["FileHandler"]
    for k, p in r0["b"].items():
        assert torch.equal(p, r1["b"][k]), k
        # the same arithmetic in the same order: the resumed run is the same run
        assert torch.equal(p, r0["a"][k]), k
    meta = json.load(open(tmp_path / "b" / "run_meta.json"))
    assert meta["topology"]["process_count"] == 2
    want = np.load(tmp_path / "a" / "loss_record" / "loss.npy")
    assert want.shape == (6,) and np.all(np.isfinite(want))
    np.testing.assert_array_equal(np.load(tmp_path / "b" / "loss_record" / "loss.npy"), want)
    log = open(tmp_path / "b" / "exp.log").read()
    assert "resumed from checkpoint 2 at epoch 0 iter 2" in log
    assert sorted(os.listdir(tmp_path / "b" / "ckpt")) == sorted(
        os.listdir(tmp_path / "a" / "ckpt"))


def _videos():
    """Five ragged uint8 videos at 56^2 in two scenes, both label classes
    among the scored frames of each scene."""
    rng = np.random.RandomState(11)
    out = []
    for i, scene in enumerate(["01", "01", "02", "02", "02"]):
        t = 12 + 3 * i
        frames = rng.randint(0, 256, (t, 56, 56, 3)).astype(np.uint8)
        labels = np.zeros(t, np.int64)
        labels[t // 2: t // 2 + 4] = 1
        out.append((frames, labels, scene))
    return out


def test_distributed_eval_and_gathers(tmp_path):
    """3 gloo ranks: ``cross_host_gather_ragged`` is exact in rank order
    with a rank holding no rows; ``cross_host_concat`` keeps rank order;
    ``evaluate_videos_distributed`` (videos dealt rank::3) gives every rank
    the per-scene and mean AUC of the one-process ``evaluate_videos`` and of
    the JAX ``evaluate_videos`` on the same videos and weights."""
    m = dataclasses.replace(jax_preset("tiny").model, predict=True)
    jmodel = JaxVADModel(config=m)
    variables = jax.jit(jmodel.init)(jax.random.key(0), jnp.zeros((1, 4, 56, 56, 3)))
    pm = dataclasses.replace(preset("tiny").model, predict=True)
    tmodel = VADModel(pm, torch.float32)
    load_state_dict_strict(tmodel, state_dict_from_jax(flatten_state(variables), predict=True))
    tmodel.eval()
    cfg = preset("tiny").replace(model=pm)
    ranks = launch("eval", tmp_path, dict(cfg=cfg, state_dict=tmodel.state_dict(),
                                          videos=_videos()), world=3)

    want_rows = np.concatenate([np.arange(n * 2, dtype=np.float64).reshape(n, 2) + 100.0 * r
                                for r, n in enumerate((3, 0, 5))])
    for r in ranks:
        np.testing.assert_array_equal(r["ragged"], want_rows)
        assert r["ragged"].dtype == np.float64
        np.testing.assert_array_equal(r["ragged_int"], [0, 0, 1, 0, 1, 2])
        assert r["concat"] == ["r0a", "r0b", "r1a", "r1b", "r2a", "r2b"]
    assert [len(r["local_videos"]) for r in ranks] == [2, 2, 1]

    pscorer = port_predict.make_video_scorer(lambda c: tmodel(c).recon, frame_num=4,
                                             predict=True, batch_windows=4, input_frames=4,
                                             device="cpu")
    jscorer = jax_predict.make_video_scorer(lambda c: jmodel.apply(variables, c).recon,
                                            frame_num=4, predict=True, batch_windows=4,
                                            input_frames=4)
    pauc, pscenes, _ = port_predict.evaluate_videos(pscorer, _videos(), 4, True)
    jauc, jscenes, _ = jax_predict.evaluate_videos(jscorer, _videos(), 4, True)
    assert pscenes.keys() == jscenes.keys() == {"01", "02"}
    for r in ranks:
        assert r["scenes"].keys() == pscenes.keys()
        for s in pscenes:
            np.testing.assert_allclose(r["scenes"][s], pscenes[s], rtol=0, atol=1e-12)
            np.testing.assert_allclose(r["scenes"][s], jscenes[s], rtol=0, atol=1e-12)
        np.testing.assert_allclose(r["auc"], pauc, rtol=0, atol=1e-12)
        np.testing.assert_allclose(r["auc"], jauc, rtol=0, atol=1e-12)
