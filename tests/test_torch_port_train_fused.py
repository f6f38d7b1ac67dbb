"""The port's loss and gradients against the JAX package's fused kernels
(``fused_attention=True``: the fold kernels and ``fused_ln_mlp`` in
interpret mode), on the CPU, and the parameter gates of a step.  Inputs,
weights and bounds as ``test_torch_port_train.py``, whose helpers these are.
"""

import numpy as np
import pytest
import torch

from test_torch_port_train import (  # noqa: F401  (jax_variables is a fixture)
    GRAD_TOL, PHASES, SCHED, STEPS_PER_EPOCH, _assert_rel, _clips, _configs, _graph_nodes,
    _port_model, check_loss_and_grads, jax_loss_and_grads, jax_variables,
)
from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse)
from vadcl_tpu.train.checkpoint import flatten_state
from vadcl_tpu_torch.convert import state_dict_from_jax
from vadcl_tpu_torch.train import create_train_state, make_loss_fn, make_train_step, param_gate_thresholds


@pytest.mark.parametrize("step", list(PHASES), ids=[f"fused-predict-{PHASES[s]}" for s in PHASES])
def test_loss_and_grads_match_jax(jax_variables, step):
    """Loss and every parameter gradient of the fused ``make_loss_fn`` against
    ``jax.value_and_grad`` of the JAX fused ``make_loss_fn`` at the same
    weights, in each phase of the schedule (``test_torch_port_train.py``)."""
    check_loss_and_grads(jax_variables, True, True, True, step)


def test_gated_parameters_get_no_update(jax_variables):
    """Before ``cluster_train_start_iter`` the parameters named "cluster"
    (the heads' LayerNorms included) are gated on the device: no weight
    decay, no moments, no step count (their state is count 0 and zero
    moments, as ``torch_adam``'s); every other parameter moves and counts
    one step."""
    _, pcfg = _configs(True, cluster_train_start_iter=1)
    model = _port_model(jax_variables, pcfg)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    state = create_train_state(model, pcfg)
    step_fn = make_train_step(model, pcfg, STEPS_PER_EPOCH)
    step_fn(state, torch.from_numpy(_clips(1)[0]))
    gated = {k for k, v in param_gate_thresholds(model.named_parameters(), 1).items() if v}
    assert gated == {k for k, _ in model.named_parameters() if "cluster" in k}
    assert "cluster1.norm.weight" in gated
    for k, p in model.named_parameters():
        moved = not torch.equal(p.detach(), before[k])
        assert moved == (k not in gated), k
        st = state.optimizer.state[p]
        assert int(st["step"]) == (k not in gated), k
        if k in gated:
            assert not st["exp_avg"].any() and not st["exp_avg_sq"].any(), k
    step_fn(state, torch.from_numpy(_clips(2)[1]))  # step 1: the heads unfreeze
    for k, p in model.named_parameters():
        assert int(state.optimizer.state[p]["step"]) == (1 if k in gated else 2), k


def test_fold_block_loss_and_grads_match_jax(jax_variables):
    """Loss and every parameter gradient under ``attn_kernel="fold_block"``
    against ``jax.value_and_grad`` of the JAX loss built with the same
    ``attn_kernel`` (``folded_full_block_trainable`` and its ``_full_bwd`` in
    interpret mode), with compactness on."""
    jcfg, pcfg = _configs(True, attn_kernel="fold_block", **SCHED)
    assert jcfg.model.attn_kernel == pcfg.model.attn_kernel == "fold_block"
    clip = _clips(1, seed=1)[0]
    (loss_j, _), grads_j = jax_loss_and_grads(jax_variables, True, True, 2, "fold_block")
    model = _port_model(jax_variables, pcfg)
    loss_t, _ = make_loss_fn(model, pcfg)(torch.from_numpy(clip), 2)
    assert any("FoldBlock" in type(f).__name__ for f in _graph_nodes(loss_t.grad_fn))
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=1e-4)
    want = state_dict_from_jax(flatten_state({"params": grads_j}), predict=True)
    for k, p in model.named_parameters():
        assert p.grad is not None, f"{k}: no gradient"
        _assert_rel(k, p.grad.numpy(), want[k].numpy(), GRAD_TOL)


