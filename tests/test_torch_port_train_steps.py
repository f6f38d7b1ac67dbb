"""The port's train step over several steps and across checkpoints against
the JAX package's, on the CPU: six ``make_train_step`` steps under ``fold``,
``base`` and ``fold_block`` against the JAX XLA path, and checkpoints that
cross the packages.  Inputs, weights and bounds as
``test_torch_port_train.py``, whose helpers these are.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_train import (  # noqa: F401  (jax_variables is a fixture)
    LR, SCHEDULE, STEPS, STEPS_PER_EPOCH, _clips, _configs, _port_model, jax_variables,
)
from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse)
from vadcl_tpu.models.backbone import VADModel as JaxVADModel
from vadcl_tpu.train.checkpoint import CheckpointManager as JaxCheckpointManager
from vadcl_tpu.train.checkpoint import flatten_state, unflatten_into
from vadcl_tpu.train.optim import build_optimizer as jax_build_optimizer
from vadcl_tpu.train.optim import cosine_epoch_lr as jax_cosine_epoch_lr
from vadcl_tpu.train.optim import param_gate_thresholds as jax_param_gates
from vadcl_tpu.train.step import TrainState as JaxTrainState
from vadcl_tpu.train.step import make_train_step as jax_make_train_step
from vadcl_tpu_torch.convert import jax_from_state_dict
from vadcl_tpu_torch.models import VADModel
from vadcl_tpu_torch.train import CheckpointManager, create_train_state, make_train_step
from vadcl_tpu_torch.utils.parity import check_adam_bound


@pytest.fixture(scope="module")
def jax_trajectory(jax_variables, tmp_path_factory):
    """JAX make_train_step (XLA path) over STEPS uint8 batches: per-step
    losses, the final params, and a JAX checkpoint after 3 steps."""
    jcfg, _ = _configs(False, **SCHEDULE)
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
    ckpt_dir = str(tmp_path_factory.mktemp("jax_ckpt"))
    losses, lrs = [], []
    for i, clip in enumerate(_clips(STEPS, seed=2)):
        state, m = step_fn(state, jnp.asarray(clip))
        losses.append(float(m.loss))
        lrs.append(float(m.lr))
        if i == 2:
            JaxCheckpointManager(ckpt_dir).save("3", state, {"epoch": 0, "iter": 2})
    return dict(losses=losses, lrs=lrs, params=flatten_state({"params": state.params}),
                ckpt_dir=ckpt_dir, state=state)


def _assert_params_close(model, jax_flat, init_flat, steps):
    """test_reference_train_parity's final-parameter bound
    (``utils.parity.check_adam_bound``, no tensor apart): Adam moves an
    element by ~lr per step whatever its gradient, so elements whose
    gradient is within rounding of zero may step opposite ways; hold every
    leaf to 2.5 * lr * steps and fewer than 2% of its elements to one
    lr-step.  A leaf that JAX moved must move in the port too."""
    got = jax_from_state_dict(dict(model.named_parameters()), predict=True)
    want = {k: np.asarray(w, np.float32) for k, w in jax_flat.items()}
    check_adam_bound("port against JAX", got, want, LR, steps, key_biases_apart=False)
    for k, w in jax_flat.items():
        init = np.asarray(init_flat[k], np.float32)
        if float(np.max(np.abs(np.asarray(w) - init))) > 0:
            assert float(np.max(np.abs(got[k] - init))) > 0, k


def test_six_step_trajectory_matches_jax(jax_variables, jax_trajectory):
    """The port's make_train_step (fused config, plain versions on the CPU)
    against the JAX make_train_step (XLA path) over six steps that cross
    the pre-cluster, compactness and cluster-unfreeze phases and an epoch
    boundary of the cosine schedule."""
    _, pcfg = _configs(True, **SCHEDULE)
    model = _port_model(jax_variables, pcfg)
    state = create_train_state(model, pcfg)
    step_fn = make_train_step(model, pcfg, STEPS_PER_EPOCH)
    metrics = [step_fn(state, torch.from_numpy(c)) for c in _clips(STEPS, seed=2)]
    np.testing.assert_allclose([float(m.loss) for m in metrics], jax_trajectory["losses"],
                               rtol=1e-4)
    np.testing.assert_allclose([m.lr for m in metrics], jax_trajectory["lrs"], rtol=1e-6)
    assert state.step == STEPS
    _assert_params_close(model, jax_trajectory["params"],
                         flatten_state({"params": jax_variables["params"]}), STEPS)


def test_base_kernel_trajectory_matches_jax(jax_variables, jax_trajectory):
    """``attn_kernel="base"`` (kernel 7 forward, kernel 8 backward, plain
    LN1 and residual around them) through the same six steps against the JAX
    make_train_step with ``fused_attention=False``: the JAX model cannot run
    its ``base`` kernels on the CPU, and the XLA path is their oracle."""
    _, pcfg = _configs(True, attn_kernel="base", **SCHEDULE)
    assert pcfg.model.fused_attention and pcfg.model.attn_kernel == "base"
    model = _port_model(jax_variables, pcfg)
    state = create_train_state(model, pcfg)
    step_fn = make_train_step(model, pcfg, STEPS_PER_EPOCH)
    metrics = [step_fn(state, torch.from_numpy(c)) for c in _clips(STEPS, seed=2)]
    np.testing.assert_allclose([float(m.loss) for m in metrics], jax_trajectory["losses"],
                               rtol=1e-4)
    _assert_params_close(model, jax_trajectory["params"],
                         flatten_state({"params": jax_variables["params"]}), STEPS)


def test_fold_block_trajectory_matches_jax(jax_variables, jax_trajectory):
    """``attn_kernel="fold_block"`` (every block the whole-block kernel each
    way; on the CPU its plain versions) through the same six steps against
    the JAX make_train_step on the XLA path, within the bounds the ``fold``
    and ``base`` trajectories are held to."""
    _, pcfg = _configs(True, attn_kernel="fold_block", **SCHEDULE)
    model = _port_model(jax_variables, pcfg)
    state = create_train_state(model, pcfg)
    step_fn = make_train_step(model, pcfg, STEPS_PER_EPOCH)
    metrics = [step_fn(state, torch.from_numpy(c)) for c in _clips(STEPS, seed=2)]
    np.testing.assert_allclose([float(m.loss) for m in metrics], jax_trajectory["losses"],
                               rtol=1e-4)
    assert state.step == STEPS
    _assert_params_close(model, jax_trajectory["params"],
                         flatten_state({"params": jax_variables["params"]}), STEPS)


def test_checkpoints_cross_packages(jax_variables, jax_trajectory, tmp_path):
    """JAX trains 3 steps and saves; the port restores into a fresh model
    and optimizer and trains 3 more, landing on JAX's 6-step result.  The
    port's checkpoint then restores into a JAX TrainState template."""
    _, pcfg = _configs(True, **SCHEDULE)
    model = VADModel(pcfg.model, torch.float32, torch.Generator().manual_seed(123))
    state = create_train_state(model, pcfg)
    jmgr = CheckpointManager(jax_trajectory["ckpt_dir"])
    assert jmgr.latest_tag() == "3" and jmgr.metadata("3") == {"epoch": 0, "iter": 2}
    jmgr.restore("3", state)
    assert state.step == 3
    step_fn = make_train_step(model, pcfg, STEPS_PER_EPOCH)
    losses = [float(step_fn(state, torch.from_numpy(c)).loss)
              for c in _clips(STEPS, seed=2)[3:]]
    np.testing.assert_allclose(losses, jax_trajectory["losses"][3:], rtol=1e-4)
    _assert_params_close(model, jax_trajectory["params"],
                         flatten_state({"params": jax_variables["params"]}), STEPS)

    CheckpointManager(str(tmp_path)).save("6", state, {"epoch": 1, "iter": 2})
    template = jax.tree_util.tree_map(jnp.zeros_like, jax_trajectory["state"])
    with np.load(tmp_path / "ckpt_6.npz") as z:
        restored = unflatten_into(template, {k: z[k] for k in z.files if k != "__meta__"})
    assert int(restored.step) == 6
    assert JaxCheckpointManager(str(tmp_path)).metadata("6") == {"epoch": 1, "iter": 2}
    flat = flatten_state(restored)
    ours = jax_from_state_dict(dict(model.named_parameters()), predict=True)
    for k, v in ours.items():
        np.testing.assert_array_equal(np.asarray(flat[k]), v)
    p = model.decoder.patchdebed.deconv1.weight  # a transposed conv: layout mapped
    mu = jax_from_state_dict({"decoder.patchdebed.deconv1.weight":
                              state.optimizer.state[p]["exp_avg"]}, predict=True)
    np.testing.assert_array_equal(
        np.asarray(flat["opt_state/mu/decoder/patchdebed/deconv1/kernel"]),
        mu["params/decoder/patchdebed/deconv1/kernel"])
    assert int(flat["opt_state/count/cluster1/cluster_center"]) == 3  # unfroze at step 3
    assert int(flat["opt_state/count/encoder/patch_embed/kernel"]) == 6


