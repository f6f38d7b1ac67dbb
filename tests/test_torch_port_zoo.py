"""The port's alternate model families and the model zoo's remaining ops
against the JAX package, on the CPU.

Covered: the MNAD memory ops (``ops/memory.py``) function by function; the
ConvAE, ConvAEPredict and UNet3D modules (forward and every parameter's
gradient); ``VADModel`` of each family through three train steps against
``vadcl_tpu.train.step.make_train_step`` (losses, every parameter, the
bank); scoring, which leaves the bank alone in train mode too; the bank's
write (a rebound buffer); checkpoints across the packages; the weight
bridge for each family; the CLIs with ``--backbone``; the transposed conv
against the JAX package's lowerings, ``subpixel_deconv`` read as a no-op;
``pos_soft_assign``, ``cluster_alpha_schedule`` and ``l1_recon_loss``;
``LegacySwinDecoder``; ``utils.parity.check_bank``.

Inputs from numpy ``RandomState`` seeds, the JAX weights and bank carried
across by ``convert.state_dict_from_jax``, 32x32 clips at the families'
full widths (ConvAE 64-512, a bank of 6 x 512; UNet3D 64-1024 and a narrow
8-32), fp32.  Bounds: forward outputs within 1e-5 of max|JAX| (``FWD_TOL``);
losses rtol 1e-4; each parameter gradient within 2e-3 max|JAX| (the
repo's train-parity bound, ``GRAD_TOL``); after three Adam steps every
parameter within ``utils.parity.check_adam_bound`` and the bank within
1e-5 absolute (``BANK_ATOL``) with unit-norm rows; the transposed conv
within 1e-5 of max|JAX| for each lowering.  Each JAX reference runs once
per module (module-scoped fixtures).
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vadcl_tpu.ops.cluster as jax_cluster
import vadcl_tpu.ops.convs as jax_convs
import vadcl_tpu.ops.memory as jax_memory
from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse)
from vadcl_tpu.core.config import Config as JaxConfig
from vadcl_tpu.core.config import DataConfig as JaxDataConfig
from vadcl_tpu.core.config import ModelConfig as JaxModelConfig
from vadcl_tpu.core.config import OptimConfig as JaxOptimConfig
from vadcl_tpu.core.config import preset as jax_preset
from vadcl_tpu.eval.predict import evaluate_videos as jax_evaluate_videos
from vadcl_tpu.eval.predict import make_video_scorer as jax_make_video_scorer
from vadcl_tpu.models.backbone import VADModel as JaxVADModel
from vadcl_tpu.models.conv_ae import ConvAE as JaxConvAE
from vadcl_tpu.models.conv_ae import ConvAEPredict as JaxConvAEPredict
from vadcl_tpu.models.decoder import LegacySwinDecoder as JaxLegacySwinDecoder
from vadcl_tpu.models.unet3d import UNet3D as JaxUNet3D
from vadcl_tpu.train.checkpoint import CheckpointManager as JaxCheckpointManager
from vadcl_tpu.train.checkpoint import flatten_state, unflatten_into
from vadcl_tpu.train.optim import build_optimizer as jax_build_optimizer
from vadcl_tpu.train.optim import cosine_epoch_lr as jax_cosine_epoch_lr
from vadcl_tpu.train.optim import param_gate_thresholds as jax_param_gates
from vadcl_tpu.train.step import TrainState as JaxTrainState
from vadcl_tpu.train.step import make_train_step as jax_make_train_step
from vadcl_tpu.train.step import split_predict_batch as jax_split_predict_batch
from vadcl_tpu_torch.convert import jax_from_state_dict, load_state_dict_strict, state_dict_from_jax
from vadcl_tpu_torch.core.config import Config, DataConfig, ModelConfig, OptimConfig, preset
from vadcl_tpu_torch.eval.predict import eval_input_frames, evaluate_videos, make_video_scorer
from vadcl_tpu_torch.models import (
    ConvAE,
    ConvAEPredict,
    LegacySwinDecoder,
    MemoryModule,
    UNet3D,
    VADModel,
)
from vadcl_tpu_torch.models.backbone import model_input_frames, predicts
from vadcl_tpu_torch.ops import cluster as port_cluster
from vadcl_tpu_torch.ops import convs as port_convs
from vadcl_tpu_torch.ops import memory as port_memory
from vadcl_tpu_torch.train import CheckpointManager, create_train_state, make_train_step
from vadcl_tpu_torch.train.step import split_predict_batch
from vadcl_tpu_torch.utils.parity import check_adam_bound

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FWD_TOL, GRAD_TOL, BANK_ATOL = 1e-5, 2e-3, 1e-5
LR, STEPS, STEPS_PER_EPOCH, SIZE, MEMORY = 1e-4, 3, 10, 32, 6
# the clip length each family trains on: convae_predict's true-future split
# takes 4 of 5 frames; UNet3D's (1, 2, 2) pools leave time alone
FRAMES = {"unet3d": 2, "convae": 4, "convae_predict": 5}
SIZES = {"unet3d": 16, "convae": SIZE, "convae_predict": SIZE}  # UNet3D: 1024 channels at 1^2


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


# ---------------------------------------------------------------- memory ops


def _memory_inputs(seed, B=2, H=4, W=4, d=8, M=6):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, W, d).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    keys = rng.randn(M, d).astype(np.float32)
    keys /= np.linalg.norm(keys, axis=1, keepdims=True)
    return q, keys


def test_memory_scores_read_top1_and_regularizer_match_jax():
    q, keys = _memory_inputs(0)
    tq, tk = torch.from_numpy(q), torch.from_numpy(keys)
    want = jax_memory.memory_read(q, keys)
    got = port_memory.memory_read(tq, tk)
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) <= FWD_TOL
    s_q, s_m = port_memory.memory_scores(tk, tq.reshape(-1, 8))
    np.testing.assert_allclose(s_q.sum(0).numpy(), 1.0, rtol=1e-6)  # over the queries
    np.testing.assert_allclose(s_m.sum(1).numpy(), 1.0, rtol=1e-6)  # over the slots
    top1 = port_memory.memory_top1(tq, tk)
    jtop1 = jax_memory.memory_top1(q, keys)
    np.testing.assert_array_equal(top1.index.numpy(), np.asarray(jtop1.index))
    np.testing.assert_array_equal(top1.keys.numpy(), np.asarray(jtop1.keys))
    assert _rel(port_memory.memory_pointwise_compactness(tq, tk).numpy(),
                jax_memory.memory_pointwise_compactness(q, keys)) <= FWD_TOL
    np.testing.assert_allclose(float(port_memory.memory_loss_regularizer(tk)),
                               float(jax_memory.memory_loss_regularizer(keys)), rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_l2_normalize_matches_jax(dtype):
    x = np.random.RandomState(1).randn(5, 7).astype(np.float32)
    x[2] = 0.0  # the eps clamp
    got = port_memory._l2_normalize(torch.from_numpy(x).to(dtype), dim=1)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = jax_memory._l2_normalize(jnp.asarray(x, jdt), axis=1)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_memory_update_chained_three_times_matches_jax():
    """Three updates in a row, each on new queries and the bank before it."""
    _, keys = _memory_inputs(2)
    tk = torch.from_numpy(keys)
    for seed in (3, 4, 5):
        q, _ = _memory_inputs(seed)
        keys = np.asarray(jax_memory.memory_update(q, keys))
        tk = port_memory.memory_update(torch.from_numpy(q), tk)
        np.testing.assert_allclose(tk.numpy(), keys, rtol=0, atol=BANK_ATOL)
    np.testing.assert_allclose(np.linalg.norm(tk.numpy(), axis=1), 1.0, rtol=1e-6)


def test_memory_losses_and_their_query_gradients_match_jax():
    q, keys = _memory_inputs(6)
    want = jax_memory.memory_losses(q, keys)
    jgrad = jax.grad(lambda x: sum(jax_memory.memory_losses(x, keys)))(q)
    tq = torch.from_numpy(q).requires_grad_()
    got = port_memory.memory_losses(tq, torch.from_numpy(keys))
    np.testing.assert_allclose(float(got.compactness), float(want.compactness), rtol=1e-4)
    np.testing.assert_allclose(float(got.separateness), float(want.separateness), rtol=1e-4)
    (got.compactness + got.separateness).backward()
    assert _rel(tq.grad.numpy(), jgrad) <= GRAD_TOL


def test_ties_go_to_the_first_slot_as_in_jax():
    """Slots 1 and 3 hold the same key: every query nearest to it ties, and
    the top-1 and top-2 picks (hence the update, the losses and top-1) go
    to slot 1 first, as ``jnp.argmax`` and ``jax.lax.top_k`` do."""
    q, keys = _memory_inputs(7)
    keys[3] = keys[1]
    q[0, 0, 0] = keys[1]
    tq, tk = torch.from_numpy(q), torch.from_numpy(keys)
    assert int(port_memory.memory_top1(tq, tk).index[0]) == 1
    np.testing.assert_array_equal(port_memory.memory_top1(tq, tk).index.numpy(),
                                  np.asarray(jax_memory.memory_top1(q, keys).index))
    first, second = port_memory._top2(port_memory.memory_scores(tk, tq.reshape(-1, 8))[1])
    _, jtop2 = jax.lax.top_k(jax_memory.memory_scores(keys, q.reshape(-1, 8))[1], 2)
    np.testing.assert_array_equal(first.numpy(), np.asarray(jtop2[:, 0]))
    np.testing.assert_array_equal(second.numpy(), np.asarray(jtop2[:, 1]))
    assert (int(first[0]), int(second[0])) == (1, 3)
    np.testing.assert_allclose(port_memory.memory_update(tq, tk).numpy(),
                               np.asarray(jax_memory.memory_update(q, keys)), atol=BANK_ATOL)
    for g, w in zip(port_memory.memory_losses(tq, tk), jax_memory.memory_losses(q, keys)):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-4)


# ------------------------------------------------------------------ modules


def _load_module(module, variables, prefix):
    sd = state_dict_from_jax(_flat_under(variables, prefix), predict=False)
    load_state_dict_strict(module, {k.split(".", 1)[1]: v for k, v in sd.items()})


def _flat_under(variables, prefix):
    flat = flatten_state(variables)
    return {"/".join((k.split("/")[0], prefix, k.split("/", 1)[1])): v for k, v in flat.items()}


MODULES = {
    "convae": lambda: (JaxConvAE(t_length=4, memory_size=MEMORY),
                       ConvAE(3, 4, MEMORY), 4, "convae"),
    "convae_predict": lambda: (JaxConvAEPredict(t_length=5, memory_size=MEMORY),
                               ConvAEPredict(3, 5, MEMORY), 4, "convae"),
    "unet3d": lambda: (JaxUNet3D(), UNet3D(), 1, "unet3d"),
    "unet3d_narrow": lambda: (JaxUNet3D(feat_channels=(8, 16, 16, 32, 32)),
                              UNet3D(feat_channels=(8, 16, 16, 32, 32)), 3, "unet3d"),
}


@pytest.mark.parametrize("name", sorted(MODULES))
def test_module_forward_and_gradients_match_jax(name):
    """Each module as a module: the forward in fp32 (the memory outputs
    too), and the gradient of sum(recon * cotangent) (+ the memory losses)
    with respect to every parameter.

    The gradients are the port's in float64 against JAX's in fp32.  These
    are ReLU networks whose decoder activations at the JAX init are ~1e-6:
    the port's fp32 convolutions (oneDNN, 2-3 times the per-layer rounding
    of XLA's) put a few pre-activations of ~1e-12 on the other side of a
    ReLU's kink, which moves a whole tensor's gradient by up to 9% of its
    max (measured: 5 of 16 seeds in fp32; in float64 all 16 within
    1.0e-6-5.3e-6 of JAX).  The fp32 gradients are held through the three
    train steps below, to the Adam bound."""
    jmod, pmod, frames, prefix = MODULES[name]()
    rng = np.random.RandomState(8)
    size = SIZE // 2 if name == "unet3d" else SIZE  # the full width's 1024 channels at 1^2
    clip = rng.rand(2, frames, size, size, 3).astype(np.float32)
    memory = prefix == "convae"
    kw = {"train": False} if memory else {}
    variables = jax.jit(lambda c: jmod.init(jax.random.key(0), c, **kw))(clip)
    params = variables["params"]
    rest = {k: v for k, v in variables.items() if k != "params"}

    def fwd(p):
        return jmod.apply({"params": p, **rest}, clip, **kw)

    def jloss(p, cot):
        out = fwd(p)
        if memory:
            return jnp.sum(out.recon * cot) + out.memory.separateness + out.memory.compactness, out
        return jnp.sum(out * cot), out

    shape = jax.eval_shape(fwd, params)
    cot = rng.randn(*(shape.recon if memory else shape).shape).astype(np.float32)
    (_, jout), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params, cot)

    _load_module(pmod, variables, prefix)
    with torch.no_grad():
        out = pmod(torch.from_numpy(clip))
    assert _rel((out.recon if memory else out).numpy(), jout.recon if memory else jout) <= FWD_TOL
    if memory:
        assert _rel(out.feature.numpy(), jout.feature) <= FWD_TOL
        assert _rel(out.memory.updated_query.numpy(), jout.memory.updated_query) <= FWD_TOL
        for k in ("separateness", "compactness"):
            np.testing.assert_allclose(float(getattr(out.memory, k)),
                                       float(getattr(jout.memory, k)), rtol=1e-4)

    pmod.double()
    out = pmod(torch.from_numpy(clip).double())
    loss = ((out.recon if memory else out) * torch.from_numpy(cot).double()).sum()
    if memory:
        loss = loss + out.memory.separateness + out.memory.compactness
    loss.backward()
    got = jax_from_state_dict({f"{prefix}.{k}": p.grad for k, p in pmod.named_parameters()},
                              predict=False)
    want = _flat_under({"params": jgrads}, prefix)
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert _rel(got[k], w) <= GRAD_TOL, k


# ------------------------------------------------- VADModel, the train step


def _configs(backbone):
    """(JAX Config, port Config) of test_zoo.py's kind of run, at LR."""
    out = []
    for C, M, D, O in ((JaxConfig, JaxModelConfig, JaxDataConfig, JaxOptimConfig),
                       (Config, ModelConfig, DataConfig, OptimConfig)):
        out.append(C(model=M(backbone=backbone, memory_size=MEMORY, memory_dim=512),
                     data=D(frame_num=FRAMES[backbone], image_size=(SIZES[backbone],) * 2),
                     optim=O(lr=LR, epochs=4), batch_size_per_device=2))
    return out


def _clips(backbone, seed=9):
    return np.random.RandomState(seed).randint(
        0, 256, (STEPS, 2, FRAMES[backbone], SIZES[backbone], SIZES[backbone], 3)).astype(np.uint8)


def _bank(state):
    return np.asarray(state.extras["memory"]["convae"]["memory"]["keys"])


@pytest.fixture(scope="module", params=sorted(FRAMES))
def jax_run(request, tmp_path_factory):
    """The JAX ``make_train_step`` over STEPS uint8 batches from the port's
    seeded init (weights and bank): the init variables, per-step losses and
    banks, the final parameters, and a JAX checkpoint after 2 steps."""
    backbone = request.param
    jcfg, _ = _configs(backbone)
    model = JaxVADModel(config=jcfg.model)
    clips = _clips(backbone)
    # the port's seeded init carried into JAX's variable tree, whose shapes
    # come from an abstract init (jit-compiling UNet3D's init takes 16 s)
    _, port = _port_model(backbone)
    inputs, _ = jax_split_predict_batch(clips[0].astype(np.float32) / 255.0, FRAMES[backbone],
                                        backbone == "convae_predict", overlap_quirk=False)
    template = jax.eval_shape(model.init, jax.random.key(0), inputs)
    variables = dict(unflatten_into(template, jax_from_state_dict(port.state_dict(),
                                                                  predict=False)))
    params = variables.pop("params")
    o = jcfg.optim
    tx = jax_build_optimizer(
        o.optimizer, jax_cosine_epoch_lr(o.lr, o.min_lr, o.epochs, STEPS_PER_EPOCH,
                                         o.warmup_epochs),
        weight_decay=o.weight_decay, b1=o.b1, b2=o.b2, eps=o.eps,
        gate_thresholds=jax_param_gates(params, jcfg.schedule.cluster_train_start_iter))
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, extras=variables,
                          opt_state=tx.init(params))
    init = flatten_state({"params": state.params, **state.extras})
    step_fn = jax_make_train_step(model, jcfg, tx, STEPS_PER_EPOCH)
    ckpt_dir = str(tmp_path_factory.mktemp(f"jax_{backbone}"))
    losses, banks = [], []
    for i, clip in enumerate(clips):
        state, m = step_fn(state, jnp.asarray(clip))
        losses.append([float(m.loss), float(m.loss_pixel), float(m.cluster_loss),
                       float(m.space_loss)])
        if "memory" in state.extras:
            banks.append(_bank(state))
        if i == 1:
            JaxCheckpointManager(ckpt_dir).save("2", state, {"epoch": 0, "iter": 1})
    return dict(backbone=backbone, init=init, losses=losses, banks=banks, state=state,
                params=flatten_state({"params": state.params}), ckpt_dir=ckpt_dir)


def _port_model(backbone, init=None, seed=0):
    """The port's model of ``backbone`` from its seeded init, or with the
    flat JAX variables ``init`` loaded strictly."""
    _, pcfg = _configs(backbone)
    model = VADModel(pcfg.model, torch.float32, torch.Generator().manual_seed(seed),
                     model_input_frames(backbone, FRAMES[backbone]))
    if init is not None:
        load_state_dict_strict(model, state_dict_from_jax(init, predict=False))
    return pcfg, model


def _assert_bank(model, want):
    got = model.convae.memory.keys.numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=BANK_ATOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-5)


def test_bridge_round_trips_every_key(jax_run):
    """JAX variables -> the port (strictly, shapes checked) -> JAX: every
    key of the family, the bank and the transposed convs included, bit for
    bit."""
    _, model = _port_model(jax_run["backbone"], jax_run["init"], seed=5)
    back = jax_from_state_dict(model.state_dict(), predict=False)
    assert back.keys() == jax_run["init"].keys()
    for k, v in jax_run["init"].items():
        np.testing.assert_array_equal(back[k], np.asarray(v), err_msg=k)
    if jax_run["backbone"] != "unet3d":
        assert "memory/convae/memory/keys" in back


def test_three_train_steps_match_jax(jax_run):
    """The port's make_train_step against the JAX make_train_step: every
    loss term at every step, every parameter after three Adam steps, and
    the memory families' bank after each step."""
    backbone = jax_run["backbone"]
    pcfg, model = _port_model(backbone, jax_run["init"])
    state = create_train_state(model, pcfg)
    step_fn = make_train_step(model, pcfg, STEPS_PER_EPOCH)
    for i, clip in enumerate(_clips(backbone)):
        m = step_fn(state, torch.from_numpy(clip))
        got = [float(m.loss), float(m.loss_pixel), float(m.cluster_loss), float(m.space_loss)]
        np.testing.assert_allclose(got, jax_run["losses"][i], rtol=1e-4)
        if jax_run["banks"]:
            _assert_bank(model, jax_run["banks"][i])
    if backbone == "unet3d":
        assert jax_run["losses"][0][2:] == [0.0, 0.0]
    else:  # the memory losses ride the cluster and space slots
        assert min(jax_run["losses"][0][2:]) > 0
    params = jax_from_state_dict(dict(model.named_parameters()), predict=False)
    check_adam_bound(f"{backbone} against JAX", params, jax_run["params"], LR, STEPS,
                     key_biases_apart=False)


@pytest.mark.parametrize("jax_run", ["convae", "convae_predict"], indirect=True)
def test_checkpoints_cross_packages(jax_run, tmp_path):
    """The memory families: JAX saves after 2 steps; the port restores it
    strictly (the bank included) into a fresh model and optimizer and takes
    step 3 onto JAX's step 3; the port's checkpoint then restores into the
    JAX TrainState, every parameter, statistic and the bank bit for bit
    (the other leaves are the flagship's, ``test_torch_port_train_steps.py``)."""
    backbone = jax_run["backbone"]
    pcfg, _ = _configs(backbone)
    model = VADModel(pcfg.model, torch.float32, torch.Generator().manual_seed(123),
                     model_input_frames(backbone, FRAMES[backbone]))
    state = create_train_state(model, pcfg)
    CheckpointManager(jax_run["ckpt_dir"]).restore("2", state)
    assert state.step == 2
    _assert_bank(model, jax_run["banks"][1])
    m = make_train_step(model, pcfg, STEPS_PER_EPOCH)(state, torch.from_numpy(_clips(backbone)[2]))
    np.testing.assert_allclose(float(m.loss), jax_run["losses"][2][0], rtol=1e-4)
    _assert_bank(model, jax_run["banks"][2])

    CheckpointManager(str(tmp_path)).save("3", state, {"epoch": 0, "iter": 2})
    template = jax.tree_util.tree_map(jnp.zeros_like, jax_run["state"])
    with np.load(tmp_path / "ckpt_3.npz") as z:
        restored = unflatten_into(template, {k: z[k] for k in z.files if k != "__meta__"})
    assert int(restored.step) == 3
    flat = flatten_state(restored)
    for k, v in jax_from_state_dict(model.state_dict(), predict=False).items():
        np.testing.assert_array_equal(np.asarray(flat[k if k.startswith("params/") else
                                                      "extras/" + k]), v, err_msg=k)
    np.testing.assert_array_equal(_bank(restored), model.convae.memory.keys.numpy())
    assert int(flat["opt_state/count/convae/up4/kernel"]) == 3


def _videos(seed=10):
    rng = np.random.RandomState(seed)
    out = []
    for t, scene in ((10, "01"), (9, "02")):
        frames = rng.randint(0, 256, (t, SIZE, SIZE, 3)).astype(np.uint8)
        labels = np.zeros(t, np.int64)
        labels[t // 2 + 1:] = 1
        out.append((frames, labels, scene))
    return out


@pytest.mark.parametrize("backbone", ["convae", "convae_predict"])
def test_scoring_leaves_the_bank_alone_and_matches_jax(backbone):
    """``evaluate_videos`` with the model left in train mode: the bank is
    the same bit for bit after it, and the per-frame anomaly scores (in
    [0, 1], each video min-max normalised) are the JAX scorer's (its plain
    apply) within 1e-4."""
    jcfg, pcfg = _configs(backbone)
    fn = 4
    predict = predicts(pcfg.model)
    frames = eval_input_frames(backbone, predict, fn)
    jmodel = JaxVADModel(config=jcfg.model)
    sample = np.zeros((1, model_input_frames(backbone, fn), SIZE, SIZE, 3), np.float32)
    variables = jax.jit(jmodel.init)(jax.random.key(0), sample)
    model = VADModel(pcfg.model, torch.float32, input_frames=model_input_frames(backbone, fn))
    load_state_dict_strict(model, state_dict_from_jax(flatten_state(variables), predict=False))
    model.train()
    before = model.convae.memory.keys.clone()
    scorer = make_video_scorer(lambda c: model(c).recon, frame_num=fn, predict=predict,
                               batch_windows=4, input_frames=frames, device="cpu")
    auc, _, per_video = evaluate_videos(scorer, _videos(), fn, predict)
    assert torch.equal(model.convae.memory.keys, before)
    with torch.no_grad():
        model(torch.rand(2, model_input_frames(backbone, fn), SIZE, SIZE, 3))
    assert torch.equal(model.convae.memory.keys, before)
    jscorer = jax_make_video_scorer(lambda c: jmodel.apply(variables, c).recon, frame_num=fn,
                                    predict=predict, batch_windows=4, input_frames=frames)
    jauc, _, jper_video = jax_evaluate_videos(jscorer, _videos(), fn, predict)
    for v, jv in zip(per_video, jper_video):
        np.testing.assert_allclose(v.scores, jv.scores, rtol=0, atol=1e-4)
    assert np.isfinite(auc)


def test_bank_write_rebinds_the_buffer():
    """The update writes the new bank into the buffer in place (the buffer
    is never rebound: that would fire the registration hook and stale every
    captured graph), after the losses and the read, which use a copy of the
    old bank: a backward through the scores (``q @ keys.T`` saved the copy)
    runs, with the gradients of the same forward without the update.  An
    in-place write of the bank a forward without the update read breaks
    that backward (version counter); and in ``VADModel`` the update moves
    no gradient either."""
    gen = torch.Generator().manual_seed(11)
    query = torch.randn(2, 3, 3, 8, generator=gen)
    grads = []
    for update in (False, True):
        mem = MemoryModule(6, 8)
        old = mem.keys
        saved = old.clone()
        q = query.clone().requires_grad_()
        out = mem(q, update=update)
        (out.score_memory.square().sum() + out.score_query.square().sum()
         + out.updated_query.square().sum() + out.separateness + out.compactness).backward()
        assert mem.keys is old and torch.equal(out.keys, mem.keys)
        assert torch.equal(old, saved) != update
        grads.append(q.grad)
    assert torch.equal(grads[0], grads[1])
    assert not torch.equal(mem.keys, saved)
    np.testing.assert_allclose(np.linalg.norm(mem.keys.numpy(), axis=1), 1.0, rtol=1e-6)
    mem = MemoryModule(6, 8)
    out = mem(query.clone().requires_grad_())
    mem.keys.copy_(torch.zeros_like(saved))  # an in-place write of the bank
    with pytest.raises(RuntimeError, match="modified by an inplace operation"):
        out.score_memory.square().sum().backward()

    _, pcfg = _configs("convae")
    clip = torch.rand(2, 4, SIZE, SIZE, 3, generator=gen)
    grads = []
    for update in (False, True):
        model = VADModel(pcfg.model, torch.float32, input_frames=4)
        out = model(clip, update_memory=update)
        (out.recon.square().sum() + out.cluster_loss + out.space_loss).backward()
        grads.append({k: p.grad for k, p in model.named_parameters()})
    for k, g in grads[0].items():
        assert torch.equal(g, grads[1][k]), k


def test_clip_length_and_frames_are_checked():
    """A ConvAE family is built for one clip length and refuses another
    with a plain message; it cannot be built without one."""
    _, pcfg = _configs("convae")
    with pytest.raises(ValueError, match="needs input_frames"):
        VADModel(pcfg.model, torch.float32)
    model = VADModel(pcfg.model, torch.float32, input_frames=4)
    with pytest.raises(ValueError, match="built for clips of 4 frames"):
        model(torch.rand(1, 3, SIZE, SIZE, 3))
    assert model_input_frames("convae_predict", 5) == 4
    assert model_input_frames("convae", 5) == model_input_frames("unet3d", 5) == 5


@pytest.mark.parametrize("predict,quirk", [(True, True), (True, False), (False, True)])
def test_split_predict_batch_matches_jax(predict, quirk):
    clip = np.random.RandomState(12).rand(2, 5, 4, 4, 3).astype(np.float32)
    got = split_predict_batch(torch.from_numpy(clip), 5, predict, overlap_quirk=quirk)
    want = jax_split_predict_batch(jnp.asarray(clip), 5, predict, overlap_quirk=quirk)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_clis_train_and_score_the_families(tmp_path):
    """``tools/train_torch.py --backbone convae --device cpu`` trains an
    epoch and checkpoints the bank; ``tools/evaluate_torch.py`` loads that
    checkpoint strictly and scores; ``convae_predict`` scores its predicted
    frame without ``--predict`` and ``unet3d`` at 32^2."""
    sys.path.insert(0, REPO)
    from tools import evaluate_torch, train_torch
    from vadcl_tpu_torch.data import make_synthetic_dataset

    train_dir, test_dir, label_dir = make_synthetic_dataset(
        str(tmp_path / "data"), num_train_videos=1, num_test_videos=2, frames_per_video=8,
        size=32)
    out = tmp_path / "run"
    state = train_torch.main(["--preset", "tiny", "--data-path", train_dir, "--device", "cpu",
                              "--backbone", "convae", "--epochs", "1", "--batch-size", "2",
                              "--output-dir", str(out)])
    ckpts = sorted(os.listdir(out / "ckpt"))
    assert state.step >= 2 and ckpts == [f"ckpt_{state.step}.npz"]
    with np.load(out / "ckpt" / ckpts[0]) as z:
        bank = z["extras/memory/convae/memory/keys"]
    assert bank.shape == (10, 512)
    common = ["--preset", "tiny", "--device", "cpu", "--test-data-path", test_dir,
              "--label-path", label_dir, "--batch-windows", "4", "--image-size", "32"]
    for extra in (["--backbone", "convae", "--ckpt", str(out / "ckpt" / ckpts[0])],
                  ["--backbone", "convae_predict"], ["--backbone", "unet3d"]):
        auc = evaluate_torch.main(common + extra + ["--out", str(tmp_path / "s.npz")])
        assert 0.0 <= auc <= 1.0
        with np.load(tmp_path / "s.npz") as z:
            scores = z[z.files[0]]
        n = 8 - 4  # the windows of an 8-frame video
        assert scores.shape == (2, n if "convae_predict" in extra else 4 * n)


# ------------------------------------------------------------ the zoo's ops


DECONV_CASES = [((3, 2, 2), (1, 2, 2), (1, 0, 0)), ((1, 2, 2), (1, 2, 2), (0, 0, 0)),
                ((2, 3, 3), (1, 3, 3), (0, 0, 0)), ((2, 2, 3), (2, 2, 3), (0, 0, 0))]


@pytest.mark.parametrize("kernel,stride,padding", DECONV_CASES)
def test_conv_transpose3d_matches_both_jax_lowerings(kernel, stride, padding):
    """The port's one transposed conv (the decoders' shapes, and kernel ==
    stride) against the JAX package's dilated form and its TPU lowerings,
    the sub-pixel form and the unpatchify matmul, where they apply: the
    port reads ``subpixel_deconv`` as a no-op."""
    rng = np.random.RandomState(13)
    x = rng.randn(2, 3, 5, 6, 7).astype(np.float32)
    w = rng.randn(7, 4, *kernel).astype(np.float32)  # (Cin, Cout, kd, kh, kw)
    b = rng.randn(4).astype(np.float32)
    got = port_convs.conv_transpose3d(*map(torch.from_numpy, (x, w, b)), stride, padding).numpy()
    jw = w.transpose(2, 3, 4, 0, 1)  # (kd, kh, kw, Cin, Cout)
    assert _rel(got, jax_convs.conv_transpose3d(x, jw, b, stride, padding)) <= FWD_TOL
    if jax_convs.subpixel_applicable(kernel, stride, padding):
        assert _rel(got, jax_convs.conv_transpose3d_subpixel(x, jw, b, stride, padding)) <= FWD_TOL
    if tuple(kernel) == tuple(stride):
        assert _rel(got, jax_convs.unpatchify_matmul(x, jw, b)) <= FWD_TOL


@pytest.mark.parametrize("predict", [True, False])
def test_flagship_tiny_model_reads_subpixel_deconv_as_a_no_op(predict):
    """The tiny flagship with ``subpixel_deconv`` on: the same parameters
    and the same reconstruction, bit for bit, as with it off, and within
    the forward bound of the JAX model with the flag on (its sub-pixel
    lowering)."""
    base = dataclasses.replace(preset("tiny").model, predict=predict)
    clip = np.random.RandomState(15).rand(1, 4, 56, 56, 3).astype(np.float32)
    jm = dataclasses.replace(jax_preset("tiny").model, predict=predict, subpixel_deconv=True)
    jmodel = JaxVADModel(config=jm)
    variables = jax.jit(jmodel.init)(jax.random.key(0), clip)
    state = state_dict_from_jax(flatten_state(variables), predict=predict)
    outs = []
    for subpixel in (False, True):
        model = VADModel(dataclasses.replace(base, subpixel_deconv=subpixel), torch.float32)
        load_state_dict_strict(model, state)
        with torch.no_grad():
            outs.append(model(torch.from_numpy(clip)).recon.numpy())
    np.testing.assert_array_equal(outs[1], outs[0])
    assert _rel(outs[1], jax.jit(jmodel.apply)(variables, clip).recon) <= FWD_TOL


def test_cluster_extras_match_jax():
    x = np.random.RandomState(16).randn(3, 5, 7).astype(np.float32)
    assert _rel(port_cluster.pos_soft_assign(torch.from_numpy(x), 16.0).numpy(),
                jax_cluster.pos_soft_assign(x, 16.0)) <= FWD_TOL
    np.testing.assert_array_equal(port_cluster.cluster_alpha_schedule(40),
                                  jax_cluster.cluster_alpha_schedule(40))
    for t in (3, 4):  # 3: zero-padded in time to the patch
        r, g = np.random.RandomState(t).rand(2, 2, t, 4, 4, 3).astype(np.float32)
        got = port_cluster.l1_recon_loss(torch.from_numpy(r), torch.from_numpy(g))
        np.testing.assert_allclose(float(got), float(jax_cluster.l1_recon_loss(r, g)),
                                   rtol=1e-6)


def test_legacy_swin_decoder_matches_jax():
    """The v1 decoder as a module, with taps built from numpy: one tap (the
    second-to-last) consumed, JAX's lazily inferred channel counts."""
    rng = np.random.RandomState(17)
    x = rng.randn(1, 2, 4, 4, 16).astype(np.float32)
    taps = [rng.randn(1, 2, 8, 8, 8).astype(np.float32),
            rng.randn(1, 2, 4, 4, 12).astype(np.float32),
            rng.randn(1, 2, 2, 2, 24).astype(np.float32)]
    jmod = JaxLegacySwinDecoder(in_chans=16)
    variables = jax.jit(jmod.init)(jax.random.key(0), x, taps)
    want = jax.jit(jmod.apply)(variables, x, taps)
    pmod = LegacySwinDecoder(16, tap_channels=12)
    load_state_dict_strict(pmod, state_dict_from_jax(flatten_state(variables), predict=False))
    with torch.no_grad():
        got = pmod(torch.from_numpy(x), [torch.from_numpy(t) for t in taps])
    assert got.shape == (1, 4, 32, 32, 3)
    assert _rel(got.numpy(), want) <= FWD_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_check_bank_allows_only_near_ties(dtype):
    """``utils.parity.check_bank`` at each dtype's bounds (the card against
    the CPU, and the data-parallel step against one process): a query sent
    to another slot at a near tie leaves its two rows out; one sent apart
    at a clear gap, a row off by more than the bound, or near ties that
    leave every row out fail."""
    from vadcl_tpu_torch.utils.parity import BANK_BOUNDS, check_bank, top1_slots

    BANK_ATOL, TIE_GAP = bounds = BANK_BOUNDS[dtype]
    q, keys = _memory_inputs(18)
    tq, tk = torch.from_numpy(q), torch.from_numpy(keys)
    slots, gap = top1_slots(tq, tk)
    np.testing.assert_array_equal(slots.numpy(), port_memory.memory_top1(tq, tk).index.numpy())
    new = port_memory.memory_update(tq, tk)
    assert check_bank("same", new + BANK_ATOL / 2, new, slots, slots, gap, bounds)["moved"] == 0
    moved = slots.clone()
    i = int(gap.argmin())
    moved[i] = (slots[i] + 1) % keys.shape[0]
    wrong = new.clone()
    wrong[slots[i]] += 1.0
    wrong[moved[i]] -= 1.0
    with pytest.raises(AssertionError, match="bank rows differ"):
        check_bank("moved row", wrong, new, slots, slots, gap, bounds)
    near = gap.clone()
    near[i] = TIE_GAP / 2
    out = check_bank("near tie", wrong, new, moved, slots, near, bounds)
    assert out["moved"] == 1 and out["rows_apart"] == 2 and out["worst"] == 0.0
    far = gap.clone()
    far[i] = 2 * TIE_GAP
    with pytest.raises(AssertionError, match="another top-1 slot"):
        check_bank("clear gap", wrong, new, moved, slots, far, bounds)
    every = torch.arange(keys.shape[0])
    with pytest.raises(AssertionError, match="every row"):
        check_bank("all ties", new, new, every, (every + 1) % keys.shape[0],
                   torch.zeros(keys.shape[0]), bounds)
