"""The port's training path against the JAX package's, on the CPU.

Tiny preset with depths (2, 2) (so shifted blocks occur), prediction mode
(and reconstruction mode for the loss and gradients), batches of two uint8
4x56x56 clips from a numpy RandomState; the JAX
weights come across through ``convert.state_dict_from_jax``.  The port runs
with ``fused_attention=fused_cluster=True``, which on the CPU means the
kernels' plain versions (forward and backward).

Bounds: loss rtol 1e-4; every parameter gradient max|port - jax| <=
2e-3 * max|jax| (the bound of ``tests/test_reference_train_parity.py:202-205``:
the two packages sum in different orders through a deep network, and the
cluster heads' cdist gradients amplify that); after several Adam steps the
final-parameter bound of ``test_reference_train_parity.py:261-284``.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vadcl_tpu.core.config import preset as jax_preset
from vadcl_tpu.models.backbone import VADModel as JaxVADModel
from vadcl_tpu.train.checkpoint import CheckpointManager as JaxCheckpointManager
from vadcl_tpu.train.checkpoint import flatten_state, unflatten_into
from vadcl_tpu.train.optim import build_optimizer as jax_build_optimizer
from vadcl_tpu.train.optim import cosine_epoch_lr as jax_cosine_epoch_lr
from vadcl_tpu.train.optim import param_gate_thresholds as jax_param_gates
from vadcl_tpu.train.step import TrainState as JaxTrainState
from vadcl_tpu.train.step import make_loss_fn as jax_make_loss_fn
from vadcl_tpu.train.step import make_train_step as jax_make_train_step
from vadcl_tpu_torch.convert import jax_from_state_dict, load_state_dict_strict, state_dict_from_jax
from vadcl_tpu_torch.core.config import preset
from vadcl_tpu_torch.models import VADModel
from vadcl_tpu_torch.train import (
    CheckpointManager,
    cosine_epoch_lr,
    create_train_state,
    make_loss_fn,
    make_train_step,
    param_gate_thresholds,
    train,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAD_TOL = 2e-3
LR = 1e-4
STEPS = 6
STEPS_PER_EPOCH = 3
# compactness engages at step 2, cluster losses at step 1, cluster parameters
# train from step 3: six steps cross every phase
SCHEDULE = dict(compactness_start_iter=2, cluster_start_iter=1, cluster_train_start_iter=3)


def _configs(fused: bool, predict: bool = True, attn_kernel: str = "fold", **schedule):
    """(JAX Config, port Config) of the same run; ``attn_kernel`` is the
    fused attention kernel."""
    out = []
    for make in (jax_preset, preset):
        cfg = make("tiny")
        cfg = cfg.replace(
            model=dataclasses.replace(
                cfg.model, encoder_depths=(2, 2), decoder_depths=(2, 2), predict=predict,
                fused_attention=fused, attn_kernel=attn_kernel if fused else "base",
                # the JAX fused cluster heads have no interpret switch on the
                # CPU; their kernels equal the XLA path (test_pallas_cluster.py)
                fused_cluster=fused and make is preset,
            ),
            optim=dataclasses.replace(cfg.optim, lr=LR, epochs=4),
            schedule=dataclasses.replace(cfg.schedule, **schedule),
        )
        out.append(cfg)
    return out


def _clips(n: int, seed: int = 0):
    return np.random.RandomState(seed).randint(0, 256, (n, 2, 4, 56, 56, 3)).astype(np.uint8)


def _init(predict: bool):
    jcfg, _ = _configs(False, predict)
    x = jnp.zeros((2, 4, 56, 56, 3), jnp.float32)
    return jax.jit(JaxVADModel(config=jcfg.model).init)(jax.random.key(0), x)


@pytest.fixture(scope="module")
def jax_variables():
    return _init(predict=True)


def _port_model(variables, cfg) -> VADModel:
    model = VADModel(cfg.model, torch.float32)
    load_state_dict_strict(
        model, state_dict_from_jax(flatten_state(variables), predict=cfg.model.predict))
    return model


def _assert_rel(name, got, want, tol):
    scale = float(np.max(np.abs(want)))
    err = float(np.max(np.abs(got - want)))
    assert err <= 1e-8 + tol * scale, f"{name}: max abs err {err} > {tol} * {scale}"


_JAX_GRAD_FNS = {}
_RECON_VARIABLES = {}
PHASES = {0: "cluster_losses_gated", 1: "compactness_off", 2: "compactness_on"}


@pytest.mark.parametrize(
    "fused, jax_fused, predict, step",
    [(f, f, True, s) for f in (False, True) for s in PHASES]
    # reconstruction mode changes the decoder head and the target, not the
    # kernels: both port variants against the JAX XLA path
    + [(False, False, False, 2), (True, False, False, 2)],
    ids=[f"{'fused' if f else 'unfused'}-predict-{PHASES[s]}" for f in (False, True)
         for s in PHASES] + ["unfused-recon", "fused-vs-xla-recon"],
)
def test_loss_and_grads_match_jax(jax_variables, fused, jax_fused, predict, step):
    """Loss and every parameter gradient of ``make_loss_fn`` against
    ``jax.value_and_grad`` of the JAX ``make_loss_fn`` at the same weights,
    in each phase of the schedule: cluster losses gated off (step 0), on
    without compactness (step 1), with compactness (step 2)."""
    sched = dict(compactness_start_iter=2, cluster_start_iter=1)
    jcfg, _ = _configs(jax_fused, predict, **sched)
    _, pcfg = _configs(fused, predict, **sched)
    if not predict and not _RECON_VARIABLES:
        _RECON_VARIABLES["v"] = _init(predict=False)
    variables = jax_variables if predict else _RECON_VARIABLES["v"]
    clip = _clips(1, seed=1)[0]
    key = (jax_fused, predict)
    if key not in _JAX_GRAD_FNS:
        _JAX_GRAD_FNS[key] = jax.jit(jax.value_and_grad(
            jax_make_loss_fn(JaxVADModel(config=jcfg.model), jcfg), has_aux=True))
    params = variables["params"]
    extras = {k: v for k, v in variables.items() if k != "params"}
    (loss_j, aux_j), grads_j = _JAX_GRAD_FNS[key](
        params, extras, jnp.asarray(clip), jnp.asarray(step, jnp.int32))

    model = _port_model(variables, pcfg)
    loss_t, aux_t = make_loss_fn(model, pcfg)(torch.from_numpy(clip), step)
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=1e-4)
    for a, b in zip(aux_t[:3], aux_j[:3]):
        np.testing.assert_allclose(float(a.detach()), float(b), rtol=1e-4)

    want = state_dict_from_jax(flatten_state({"params": grads_j}), predict=predict)
    got = {k: p.grad for k, p in model.named_parameters()}
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert g is not None, f"{k}: no gradient"
        _assert_rel(k, g.numpy(), w.numpy(), GRAD_TOL)


def test_fused_model_grads_cover_every_parameter_the_unfused_one_does(jax_variables):
    """The fault this slice repairs: the fused wrappers used to return
    tensors without a grad_fn on the card, so the fused model lost the
    gradients of every Swin block and both cluster centers."""
    sets = []
    for fused in (False, True):
        _, pcfg = _configs(fused)
        model = _port_model(jax_variables, pcfg)
        loss, _ = make_loss_fn(model, pcfg)(torch.from_numpy(_clips(1)[0]), 0)
        loss.backward()
        sets.append({k for k, p in model.named_parameters()
                     if p.grad is not None and float(p.grad.abs().max()) > 0})
    assert sets[0] == sets[1]
    assert any("attn.qkv_weight" in k for k in sets[1])
    assert "cluster1.cluster_center" in sets[1] and "space_cluster.cluster_center" in sets[1]


def test_gated_parameters_get_no_update(jax_variables):
    """Before ``cluster_train_start_iter`` the parameters named "cluster"
    (the heads' LayerNorms included) get grad=None: no weight decay, no
    moments, no step count; every other parameter moves."""
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
        assert (p in state.optimizer.state) == (k not in gated), k
    step_fn(state, torch.from_numpy(_clips(2)[1]))  # step 1: the heads unfreeze
    assert all(p in state.optimizer.state for _, p in model.named_parameters())


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
    """test_reference_train_parity's final-parameter bound: Adam moves an
    element by ~lr per step whatever its gradient, so elements whose
    gradient is within rounding of zero may step opposite ways; hold every
    leaf to 2.5 * lr * steps and at most 2% of its elements to one lr-step."""
    got = jax_from_state_dict(dict(model.named_parameters()), predict=True)
    for k, w in jax_flat.items():
        diff = np.abs(got[k] - np.asarray(w, np.float32))
        assert float(diff.max()) <= 2.5 * LR * steps, (k, float(diff.max()))
        assert float(np.mean(diff > LR)) < 0.02, k
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


def test_base_kernel_loss_and_grads_match_jax(jax_variables):
    """Loss and every parameter gradient under ``attn_kernel="base"`` against
    ``jax.value_and_grad`` of the JAX unfused loss, with compactness on."""
    sched = dict(compactness_start_iter=2, cluster_start_iter=1)
    jcfg, _ = _configs(False, **sched)
    _, pcfg = _configs(True, attn_kernel="base", **sched)
    clip = _clips(1, seed=1)[0]
    fn = jax.jit(jax.value_and_grad(
        jax_make_loss_fn(JaxVADModel(config=jcfg.model), jcfg), has_aux=True))
    extras = {k: v for k, v in jax_variables.items() if k != "params"}
    (loss_j, _), grads_j = fn(jax_variables["params"], extras, jnp.asarray(clip),
                              jnp.asarray(2, jnp.int32))
    model = _port_model(jax_variables, pcfg)
    loss_t, _ = make_loss_fn(model, pcfg)(torch.from_numpy(clip), 2)
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=1e-4)
    want = state_dict_from_jax(flatten_state({"params": grads_j}), predict=True)
    for k, p in model.named_parameters():
        assert p.grad is not None, f"{k}: no gradient"
        _assert_rel(k, p.grad.numpy(), want[k].numpy(), GRAD_TOL)


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


def test_fold_block_loss_and_grads_match_jax(jax_variables):
    """Loss and every parameter gradient under ``attn_kernel="fold_block"``
    against ``jax.value_and_grad`` of the JAX loss built with the same
    ``attn_kernel`` (``folded_full_block_trainable`` and its ``_full_bwd`` in
    interpret mode), with compactness on."""
    sched = dict(compactness_start_iter=2, cluster_start_iter=1)
    jcfg, pcfg = _configs(True, attn_kernel="fold_block", **sched)
    assert jcfg.model.attn_kernel == pcfg.model.attn_kernel == "fold_block"
    clip = _clips(1, seed=1)[0]
    fn = jax.jit(jax.value_and_grad(
        jax_make_loss_fn(JaxVADModel(config=jcfg.model), jcfg), has_aux=True))
    extras = {k: v for k, v in jax_variables.items() if k != "params"}
    (loss_j, _), grads_j = fn(jax_variables["params"], extras, jnp.asarray(clip),
                              jnp.asarray(2, jnp.int32))
    model = _port_model(jax_variables, pcfg)
    loss_t, _ = make_loss_fn(model, pcfg)(torch.from_numpy(clip), 2)
    assert any("FoldBlock" in type(f).__name__ for f in _graph_nodes(loss_t.grad_fn))
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=1e-4)
    want = state_dict_from_jax(flatten_state({"params": grads_j}), predict=True)
    for k, p in model.named_parameters():
        assert p.grad is not None, f"{k}: no gradient"
        _assert_rel(k, p.grad.numpy(), want[k].numpy(), GRAD_TOL)


def _graph_nodes(fn):
    """Every node of an autograd graph."""
    seen, stack = set(), [fn]
    while stack:
        f = stack.pop()
        if f is None or f in seen:
            continue
        seen.add(f)
        stack.extend(g for g, _ in f.next_functions)
    return seen


@pytest.mark.parametrize("kernel", ["fold_packed", "fold_mix"])
def test_packed_fold_kernels_are_refused_for_training(jax_variables, kernel):
    """``fold_packed`` and ``fold_mix`` are inference-only, as ``packed``:
    the loss and the step refuse them when they are built."""
    _, pcfg = _configs(True, attn_kernel=kernel)
    model = _port_model(jax_variables, pcfg)
    with pytest.raises(ValueError, match="inference-only"):
        make_train_step(model, pcfg, STEPS_PER_EPOCH)
    with pytest.raises(ValueError, match="inference-only"):
        make_loss_fn(model, pcfg)


def test_packed_kernel_is_refused_for_training(jax_variables):
    """``packed`` is inference-only: both the loss and the step refuse it
    when they are built, before any forward."""
    _, pcfg = _configs(True, attn_kernel="packed")
    model = _port_model(jax_variables, pcfg)
    with pytest.raises(ValueError, match="inference-only"):
        make_train_step(model, pcfg, STEPS_PER_EPOCH)
    with pytest.raises(ValueError, match="inference-only"):
        make_loss_fn(model, pcfg)


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


def test_cosine_lr_and_gates_match_jax():
    for warm in (0, 2):
        j = jax_cosine_epoch_lr(6e-6, 1e-6, 10, 7, warm)
        p = cosine_epoch_lr(6e-6, 1e-6, 10, 7, warm)
        for step in (0, 6, 7, 20, 69):
            assert p(step) == float(j(jnp.asarray(step, jnp.int32))), (warm, step)
    _, pcfg = _configs(False)
    model = VADModel(pcfg.model)
    jcfg, _ = _configs(False)
    shapes = jax.eval_shape(JaxVADModel(config=jcfg.model).init, jax.random.key(0),
                            jnp.zeros((1, 4, 56, 56, 3)))
    jgates = flatten_state({"params": jax_param_gates(shapes["params"], 5)})
    sd = {k: p for k, p in model.named_parameters()}
    ours = {path: v for k, v in param_gate_thresholds(model.named_parameters(), 5).items()
            for path in jax_from_state_dict({k: sd[k]}, predict=True)}
    assert ours == {k: int(v) for k, v in jgates.items()}


def test_unported_training_options_raise():
    from vadcl_tpu_torch.train.optim import build_optimizer

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_optimizer("lars", [torch.nn.Parameter(torch.zeros(2))], 0.0, 0.9, 0.999, 1e-8)
    _, pcfg = _configs(False)
    cfg = pcfg.replace(model=dataclasses.replace(pcfg.model, drop_path_rate=0.1))
    with pytest.raises(NotImplementedError, match="drop"):
        make_loss_fn(VADModel(cfg.model), cfg)


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


def test_training_modules_import_without_jax_or_pil():
    code = (
        "import sys\n"
        "import vadcl_tpu_torch.train, vadcl_tpu_torch.train.loop, tools.train_torch\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'flax', 'PIL', 'vadcl_tpu'))\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_train_cli_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    sys.path.insert(0, REPO)
    from tools.train_torch import main

    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--data-path", "/nonexistent"])
