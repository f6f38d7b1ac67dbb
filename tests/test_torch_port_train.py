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

This file holds the loss and gradients against the JAX XLA path and the
training options; its neighbours hold the same path against the JAX fused
kernels (``test_torch_port_train_fused.py``), over several steps and across
checkpoints (``test_torch_port_train_steps.py``) and through ``train()``
(``test_torch_port_train_loop.py``).  The files share the helpers here, and
each JAX reference is computed once per file.
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

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse)
from vadcl_tpu.core.config import preset as jax_preset
from vadcl_tpu.models.backbone import VADModel as JaxVADModel
from vadcl_tpu.train.checkpoint import flatten_state
from vadcl_tpu.train.optim import cosine_epoch_lr as jax_cosine_epoch_lr
from vadcl_tpu.train.optim import param_gate_thresholds as jax_param_gates
from vadcl_tpu.train.step import make_loss_fn as jax_make_loss_fn
from vadcl_tpu_torch.convert import jax_from_state_dict, load_state_dict_strict, state_dict_from_jax
from vadcl_tpu_torch.core.config import preset
from vadcl_tpu_torch.models import VADModel
from vadcl_tpu_torch.train import (
    cosine_epoch_lr,
    make_loss_fn,
    make_train_step,
    param_gate_thresholds,
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
_JAX_RESULTS = {}
_RECON_VARIABLES = {}
PHASES = {0: "cluster_losses_gated", 1: "compactness_off", 2: "compactness_on"}
SCHED = dict(compactness_start_iter=2, cluster_start_iter=1)


def _variables(jax_variables, predict):
    if not predict and not _RECON_VARIABLES:
        _RECON_VARIABLES["v"] = _init(predict=False)
    return jax_variables if predict else _RECON_VARIABLES["v"]


def jax_loss_and_grads(jax_variables, jax_fused, predict, step, attn_kernel="fold"):
    """``jax.value_and_grad`` of the JAX ``make_loss_fn`` on ``_clips(1,
    seed=1)[0]`` at ``step``: ((loss, aux), grads), computed once per file
    and argument tuple (one jitted function per model)."""
    key = (jax_fused, predict, step, attn_kernel)
    if key not in _JAX_RESULTS:
        jcfg, _ = _configs(jax_fused, predict, attn_kernel, **SCHED)
        fkey = key[:2] + key[3:]
        if fkey not in _JAX_GRAD_FNS:
            _JAX_GRAD_FNS[fkey] = jax.jit(jax.value_and_grad(
                jax_make_loss_fn(JaxVADModel(config=jcfg.model), jcfg), has_aux=True))
        variables = _variables(jax_variables, predict)
        extras = {k: v for k, v in variables.items() if k != "params"}
        _JAX_RESULTS[key] = _JAX_GRAD_FNS[fkey](
            variables["params"], extras, jnp.asarray(_clips(1, seed=1)[0]),
            jnp.asarray(step, jnp.int32))
    return _JAX_RESULTS[key]


def check_loss_and_grads(jax_variables, fused, jax_fused, predict, step):
    """Loss, the first three aux terms and every parameter gradient of the
    port's ``make_loss_fn`` against ``jax_loss_and_grads``."""
    _, pcfg = _configs(fused, predict, **SCHED)
    (loss_j, aux_j), grads_j = jax_loss_and_grads(jax_variables, jax_fused, predict, step)
    clip = _clips(1, seed=1)[0]
    model = _port_model(_variables(jax_variables, predict), pcfg)
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


@pytest.mark.parametrize(
    "fused, jax_fused, predict, step",
    [(False, False, True, s) for s in PHASES]
    # reconstruction mode changes the decoder head and the target, not the
    # kernels: both port variants against the JAX XLA path
    + [(False, False, False, 2), (True, False, False, 2)],
    ids=[f"unfused-predict-{PHASES[s]}" for s in PHASES] + ["unfused-recon",
                                                            "fused-vs-xla-recon"],
)
def test_loss_and_grads_match_jax(jax_variables, fused, jax_fused, predict, step):
    """Loss and every parameter gradient of ``make_loss_fn`` against
    ``jax.value_and_grad`` of the JAX ``make_loss_fn`` at the same weights,
    in each phase of the schedule: cluster losses gated off (step 0), on
    without compactness (step 1), with compactness (step 2).  The fused
    predict-mode cases against the JAX fused kernels are in
    ``test_torch_port_train_fused.py``."""
    check_loss_and_grads(jax_variables, fused, jax_fused, predict, step)


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


def test_base_kernel_loss_and_grads_match_jax(jax_variables):
    """Loss and every parameter gradient under ``attn_kernel="base"`` against
    ``jax.value_and_grad`` of the JAX unfused loss, with compactness on."""
    _, pcfg = _configs(True, attn_kernel="base", **SCHED)
    clip = _clips(1, seed=1)[0]
    (loss_j, _), grads_j = jax_loss_and_grads(jax_variables, False, True, 2)
    model = _port_model(jax_variables, pcfg)
    loss_t, _ = make_loss_fn(model, pcfg)(torch.from_numpy(clip), 2)
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
