"""The port's tensor parallelism (``vadcl_tpu_torch/parallel/tp.py``) on the
CPU: gloo ranks (``tests/torch_dist_worker.py``, started once per fixture
by ``test_torch_port_dist.launch``) and the same splits by turns in one
process, against the port's one process and the JAX package.

The model is the tiny preset with encoder depths (2, 1) at 56^2: stage 0's
second block is shifted and has 2 window rows (Hp = 14, window 7), so at
model size 2 its rows, and its heads and MLP hidden width on the plain
path, split; stage 1 (7^2, one window row) stays unsplit.  The port runs
the kernels' plain versions on the CPU.

Bounds:

* Forward at (1, 2) against the JAX package's unsharded fold apply (the
  Pallas kernels in interpret mode): ``test_tp.py``'s 1e-5 (rtol and
  atol).  Against the port's one process: bit for bit on the fold and
  ``fold_block`` routes (each window computes alone, the same kernel on
  the same rows), 1e-5 on the plain path (the partial projections sum in
  another order).
* One train step at (2, 2), global batch 4, against the port's one process
  at batch 4: loss terms rtol 1e-5; every parameter's gradient, read off
  its first Adam moment, max |diff| over max |one process| ``GRAD_REL``
  1e-4 (the dist tests' moment bound), the key third of ``qkv_bias`` apart
  (zero in exact arithmetic, rounding noise in both runs; measured 3.5e-6
  on the fold route, 1.6e-5 on the plain path, and 0.90 for the control
  without the model group's gradient sum); every parameter
  2.5 lr (Adam's first step moves an element by about lr whatever its
  gradient, so the parameters alone would not see a gradient half summed:
  the control without the model group's gradient sum leaves the gradient
  bound).  Against the JAX dp x tp step (``make_mesh_2d(2, 2)``, the XLA
  path): loss rtol 1e-5 and parameters 2.5 lr, as ``test_tp.py:99-130``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_dist import launch
from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse)
from torch_dist_worker import STEPS_CAPTURED, tp_step_result
from vadcl_tpu.core.config import preset as jax_preset
from vadcl_tpu.core.mesh import make_mesh_2d as jax_make_mesh_2d
from vadcl_tpu.models.backbone import VADModel as JaxVADModel
from vadcl_tpu.train.checkpoint import flatten_state
from vadcl_tpu.train.step import create_train_state as jax_create_train_state
from vadcl_tpu.train.step import make_train_step as jax_make_train_step
from vadcl_tpu_torch.convert import jax_from_state_dict, state_dict_from_jax
from vadcl_tpu_torch.core.config import preset
from vadcl_tpu_torch.core.mesh import Mesh2D
from vadcl_tpu_torch.models import VADModel
from vadcl_tpu_torch.parallel import tp
from vadcl_tpu_torch.train.step import create_train_state, make_train_step
from vadcl_tpu_torch.utils.graphs import WARMUP_CALLS
from vadcl_tpu_torch.utils.parity import check_adam_bound, key_bias

FWD_TOL, LOSS_RTOL, GRAD_REL, LR = 1e-5, 1e-5, 1e-4, 1e-3
STEPS_PER_EPOCH = 10


def _model_cfgs(fused: bool, attn_kernel: str = "fold"):
    """(JAX ModelConfig, port ModelConfig): tiny, encoder depths (2, 1),
    prediction mode."""
    out = []
    for make in (jax_preset, preset):
        m = make("tiny").model
        out.append(dataclasses.replace(
            m, encoder_depths=(2, 1), predict=True, fused_attention=fused,
            attn_kernel=attn_kernel if fused else "base",
            fused_cluster=fused and make is preset))
    return out


def _port_cfg(fused: bool, attn_kernel: str = "fold"):
    base = preset("tiny")
    return base.replace(model=_model_cfgs(fused, attn_kernel)[1],
                        optim=dataclasses.replace(base.optim, lr=LR, epochs=10,
                                                  weight_decay=0.02))


@pytest.fixture(scope="module")
def weights():
    """The JAX variables at init and the port's state_dict of them."""
    jm, _ = _model_cfgs(False)
    variables = jax.jit(JaxVADModel(config=jm).init)(
        jax.random.key(0), jnp.zeros((2, 4, 56, 56, 3), jnp.float32))
    return variables, state_dict_from_jax(flatten_state(variables), predict=True)


def _clip(n: int, seed: int) -> np.ndarray:
    return np.random.RandomState(seed).rand(n, 4, 56, 56, 3).astype(np.float32)


def _port_model(sd, fused, attn_kernel="fold") -> VADModel:
    model = VADModel(_model_cfgs(fused, attn_kernel)[1], torch.float32)
    model.load_state_dict(sd)
    return model


FORWARD_CASES = {"fold": (True, "fold"), "fold_block": (True, "fold_block"),
                 "plain": (False, "base")}


@pytest.fixture(scope="module")
def two_ranks(weights, tmp_path_factory):
    """Each case's forward on 2 gloo ranks at (1, 2)."""
    _, sd = weights
    cases = {name: dict(cfg=_port_cfg(*how), state_dict=sd, clip=_clip(2, 3))
             for name, how in FORWARD_CASES.items()}
    return launch("tp_forward", tmp_path_factory.mktemp("tp_forward"), dict(cases=cases))


@pytest.fixture(scope="module")
def one_process_forward(weights):
    _, sd = weights
    out = {}
    for name, how in FORWARD_CASES.items():
        with torch.no_grad():
            o = _port_model(sd, *how)(torch.from_numpy(_clip(2, 3)))
        out[name] = o
    return out


@pytest.mark.parametrize("name", list(FORWARD_CASES))
def test_two_ranks_forward_matches_one_process(two_ranks, one_process_forward, name):
    """At model size 2 every rank holds the whole output: bit for bit the
    one process's on the fold routes, within 1e-5 on the plain path; the
    shifted stage-0 block really split (rows gathered, or partials summed
    for its heads and hidden width)."""
    want = one_process_forward[name]
    for rank in two_ranks:
        got = rank[name]
        if name == "plain":
            # stage 0's blocks: heads and MLP hidden of each, summed
            assert got["calls"]["partials"] >= 4 and got["calls"]["rows"] == 0, got["calls"]
            np.testing.assert_allclose(got["recon"], want.recon, rtol=FWD_TOL, atol=FWD_TOL)
            np.testing.assert_allclose(got["cluster_loss"], want.cluster_loss, rtol=FWD_TOL)
        else:
            # stage 0's blocks (and the decoder's 14^2 stage): rows gathered
            assert got["calls"]["rows"] >= 2, got["calls"]
            assert torch.equal(got["recon"], want.recon)
            assert torch.equal(got["cluster_loss"], want.cluster_loss)
            assert torch.equal(got["space_loss"], want.space_loss)
    assert torch.equal(two_ranks[0][name]["recon"], two_ranks[1][name]["recon"])


def test_same_gradients_hands_every_rank_the_first_ranks(two_ranks):
    """After a step's backward the model group's processes take its first
    process's gradients (the parameters computed alone on each process may
    differ by rounding on the card)."""
    for rank in two_ranks:
        assert [g.tolist() for g in rank["same_gradients"]] == [[[0.0] * 2] * 3, [1.0] * 5]


def test_two_ranks_fold_forward_matches_jax_unsharded(two_ranks, weights):
    """The JAX package's unsharded fold apply (Pallas in interpret mode)
    against the port's fold and fold_block routes on 2 ranks: 1e-5."""
    variables, _ = weights
    jm, _ = _model_cfgs(True, "fold")
    want = jax.jit(JaxVADModel(config=jm).apply)(variables, jnp.asarray(_clip(2, 3)))
    for name in ("fold", "fold_block"):
        got = two_ranks[0][name]
        np.testing.assert_allclose(got["recon"], np.asarray(want.recon), rtol=FWD_TOL,
                                   atol=FWD_TOL)
        np.testing.assert_allclose(float(got["cluster_loss"].mean()),
                                   float(np.asarray(want.cluster_loss).mean()), rtol=FWD_TOL)


STEP_CASES = {"fold": (True, "fold"), "plain": (False, "base")}


@pytest.fixture(scope="module")
def four_ranks(weights, tmp_path_factory):
    """One step of each case on 4 gloo ranks at (2, 2), global batch 4."""
    _, sd = weights
    cases = {name: dict(cfg=_port_cfg(*how), state_dict=sd, clip=_clip(4, 4), captured=True)
             for name, how in STEP_CASES.items()}
    cases["fold_unsummed"] = dict(cases["fold"], unsummed=True, captured=False)
    return launch("tp_step", tmp_path_factory.mktemp("tp_step"),
                  dict(cases=cases, model=2, steps_per_epoch=STEPS_PER_EPOCH), world=4)


@pytest.fixture(scope="module")
def one_process_step(weights):
    _, sd = weights
    out = {}
    for name, how in STEP_CASES.items():
        cfg = _port_cfg(*how)
        model = _port_model(sd, *how)
        state = create_train_state(model, cfg)
        m = make_train_step(model, cfg, STEPS_PER_EPOCH)(state, torch.from_numpy(_clip(4, 4)))
        out[name] = tp_step_result(model, state, m)
    return out


@pytest.fixture(scope="module")
def jax_dp_tp_steps(weights):
    """The JAX make_train_step on a (2, 2) mesh (XLA path, heads and hidden
    sharded by GSPMD), ``STEPS_CAPTURED`` steps on the same clip: each
    step's loss and the parameters after it."""
    jcfg = jax_preset("tiny")
    jcfg = jcfg.replace(model=_model_cfgs(False)[0],
                        optim=dataclasses.replace(jcfg.optim, lr=LR, epochs=10,
                                                  weight_decay=0.02))
    model = JaxVADModel(config=jcfg.model)
    clip = jnp.asarray(_clip(4, 4))
    state, tx = jax_create_train_state(model, jcfg, jax.random.key(0), clip, STEPS_PER_EPOCH)
    variables, _ = weights
    state = state._replace(params=variables["params"])
    step = jax_make_train_step(model, jcfg, tx, STEPS_PER_EPOCH,
                               mesh=jax_make_mesh_2d(2, 2), model_axis="model")
    out = []
    for _ in range(STEPS_CAPTURED):
        state, m = step(state, clip)
        out.append((float(m.loss), flatten_state({"params": state.params})))
    return out


@pytest.fixture(scope="module")
def jax_dp_tp_step(jax_dp_tp_steps):
    """The JAX dp x tp step's first step: its loss and the parameters after it."""
    return jax_dp_tp_steps[0]


def _grad_err(got, want) -> float:
    """The largest relative difference of a gradient (a first moment), max
    |diff| over max |want| per tensor, the key biases apart."""
    worst = 0.0
    for k, w in want["moments"].items():
        keep = ~key_bias(k, w)
        scale = float(w[keep].abs().max())
        if scale > 0:
            worst = max(worst, float((got["moments"][k] - w)[keep].abs().max()) / scale)
    return worst


def _assert_step_close(got, want):
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
    assert got["params"].keys() == want["params"].keys() and got["moments"].keys() == want[
        "moments"].keys()
    assert _grad_err(got, want) <= GRAD_REL
    for k, p in want["params"].items():
        np.testing.assert_allclose(got["params"][k], p, rtol=0, atol=2.5 * LR, err_msg=k)


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_four_ranks_step_matches_one_process(four_ranks, one_process_step, name):
    """dp2 x tp2, one step, against one process at the same global batch:
    the loss terms and every parameter; the four ranks end on the same
    parameters, bit for bit within each model group."""
    for rank in four_ranks:
        _assert_step_close(rank[name], one_process_step[name])
    for a, b in ((0, 1), (2, 3)):
        for k, p in four_ranks[a][name]["params"].items():
            assert torch.equal(p, four_ranks[b][name]["params"][k]), (name, k)


def test_without_the_model_group_sum_the_gradients_leave_the_bound(four_ranks,
                                                                    one_process_step):
    """The control: the same fold step with each rank's row-shard gradients
    left unsummed over the model group has the same loss, and the
    parameters still move by about lr, but the gradients of the split
    blocks' weights are half what they should be, far outside
    ``GRAD_REL``."""
    got, want = four_ranks[0]["fold_unsummed"], one_process_step["fold"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
    assert _grad_err(got, want) > 100 * GRAD_REL


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_four_ranks_step_matches_jax_dp_tp(four_ranks, jax_dp_tp_step, name):
    """The same step against the JAX dp x tp step: loss rtol 1e-5, every
    parameter within 2.5 lr."""
    loss, params = jax_dp_tp_step
    for rank in four_ranks:
        np.testing.assert_allclose(rank[name]["loss"][0], loss, rtol=LOSS_RTOL)
        got = jax_from_state_dict(rank[name]["params"], predict=True)
        for k, w in params.items():
            np.testing.assert_allclose(got[k], np.asarray(w), rtol=0, atol=2.5 * LR,
                                       err_msg=k)


# a replayed dp2 x tp2 step's collectives on each rank: the three loss sums
# over the data group, then per case the model group's all-gathers and
# partial sums in the forward and all-reduces of the replicated inputs'
# gradients in the backward, and last the gradients' broadcast over the
# model group and sum over the data group (every parameter fp32: one buffer)
TP_STEP_COLLECTIVES = {"fold": 56, "plain": 60}


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_four_ranks_captured_step_equals_eager_bit_for_bit(four_ranks, name):
    """dp2 x tp2 captured (``tests/graph_double.py``: two eager steps, then a
    capture and its replay, the model group's all-gathers, partial sums and
    gradient all-reduces, the loss sums and the gradients' exchange inside
    the replay): each rank ends on its eager run's losses, Adam moments and
    parameters bit for bit."""
    for rank in four_ranks:
        got, want = rank[f"{name}_steps"]["captured"], rank[f"{name}_steps"]["eager"]
        assert got["captures"] == 1 and got["replays"] == STEPS_CAPTURED - WARMUP_CALLS
        assert got["collectives"] == TP_STEP_COLLECTIVES[name] * got["replays"]
        assert got["losses"] == want["losses"] and got["loss"] == want["loss"]
        for k, p in want["params"].items():
            assert torch.equal(got["params"][k], p), k
            if k in want["moments"]:
                assert torch.equal(got["moments"][k], want["moments"][k]), k


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_four_ranks_captured_steps_match_jax_dp_tp(four_ranks, jax_dp_tp_steps, name):
    """The captured dp2 x tp2 run against the JAX dp x tp step's
    ``STEPS_CAPTURED`` steps: every step's loss rtol 1e-5, the parameters
    within the repo's Adam bound for that many steps (``check_adam_bound``:
    2.5 lr a step, one step's bound above; the key third of each
    ``qkv_bias``, rounding noise in both runs, 2 lr a step)."""
    want = state_dict_from_jax({k: np.asarray(w) for k, w in jax_dp_tp_steps[-1][1].items()},
                               predict=True)
    for rank in four_ranks:
        got = rank[f"{name}_steps"]["captured"]
        np.testing.assert_allclose(got["losses"], [l for l, _ in jax_dp_tp_steps],
                                   rtol=LOSS_RTOL)
        check_adam_bound("captured dp x tp against JAX", got["params"], want, LR,
                         STEPS_CAPTURED)


def test_guards_use_the_jax_words():
    """``model_axis`` without a mesh holding it, and a fused model on the
    single-device ``base`` kernels, raise the JAX step's errors."""
    cfg = _port_cfg(True, "base")
    model = VADModel(cfg.model, torch.float32)
    with pytest.raises(ValueError, match="mesh with that axis"):
        make_train_step(model, cfg, STEPS_PER_EPOCH, mesh=None, model_axis="model")
    with pytest.raises(ValueError, match="mesh with that axis"):
        make_train_step(model, cfg, STEPS_PER_EPOCH, mesh=Mesh2D(1, 1, ("data", "x")),
                        model_axis="model")
    with pytest.raises(ValueError, match="single-device"):
        make_train_step(model, cfg, STEPS_PER_EPOCH, mesh=Mesh2D(1, 1), model_axis="model")


def test_by_turns_matches_one_process_with_every_gradient(weights):
    """The splits by turns in one process (what ``chip_smoke.py`` runs on
    one card) at model size 2: the fold forward bit for bit, and every
    parameter's gradient within 1e-5 of its largest element (the rows'
    partial gradients add in another order)."""
    _, sd = weights
    clip = torch.from_numpy(_clip(2, 5))
    model = _port_model(sd, True, "fold")
    out = model(clip)
    (out.recon.square().sum() + out.cluster_loss.sum()).backward()
    want = {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None}
    model.zero_grad()
    with tp.model_parallel_by_turns(2):
        got = model(clip)
        (got.recon.square().sum() + got.cluster_loss.sum()).backward()
    assert torch.equal(got.recon, out.recon)
    for k, p in model.named_parameters():
        if k in want:
            scale = float(want[k].abs().max())
            assert float((p.grad - want[k]).abs().max()) <= FWD_TOL * scale + 1e-12, k


class _Spy:
    def __init__(self, fn):
        self.fn, self.shapes = fn, []

    def __call__(self, x, *rest):
        self.shapes.append(tuple(x.shape))
        return self.fn(x, *rest)


def test_indivisible_rows_heads_and_hidden_stay_unsplit():
    """Rows, tokens, heads or hidden columns the model size does not divide
    take the plain call once on the whole tensor; divisible ones a call a
    rank on its part."""
    x = torch.randn(1, 2, 14, 14, 8)
    windows = _Spy(lambda xl, ml, sh: xl * 2)
    tokens = _Spy(lambda xl: xl * 2)
    heads = _Spy(lambda xl, sl: xl * (sl.stop - sl.start))
    with tp.model_parallel_by_turns(3):  # 2 window rows, 14 rows, 4 heads: none divide
        assert torch.equal(tp.shard_windows_call(windows, x, None, (2, 7, 7)), x * 2)
        assert torch.equal(tp.shard_tokens_call(tokens, x, 2), x * 2)
        assert torch.equal(tp.shard_sum_call(heads, 4, x), x * 4)
        assert torch.equal(tp.shard_sum_call(heads, 32, x), x * 32)
    assert windows.shapes == tokens.shapes == [tuple(x.shape)]
    assert heads.shapes == [tuple(x.shape)] * 2
    with tp.model_parallel_by_turns(2):
        assert torch.equal(tp.shard_windows_call(windows, x, None, (2, 7, 7)), x * 2)
        assert torch.equal(tp.shard_sum_call(heads, 4, x), x * 4)
    assert windows.shapes[1:] == [(1, 2, 7, 14, 8)] * 2
    assert tp.active_axis() is None


def test_shifted_split_rolls_first_and_slices_the_mask():
    """A shifted call at model size 2 hands each rank its rows of the ROLLED
    tensor, a zero shift and its window rows of the mask, and the gathered
    output rolled back equals the unsplit call with the shift folded in."""
    from vadcl_tpu_torch.ops.window import compute_attn_mask

    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(1, 2, 14, 14, 4).astype(np.float32))
    window, shift = (2, 7, 7), (0, 3, 3)
    mask = torch.from_numpy(compute_attn_mask(2, 14, 14, window, shift))
    seen = []

    def fn(xl, ml, sh):
        seen.append((tuple(xl.shape), None if ml is None else ml.clone(), sh))
        # a per-window function of the rows and the mask: the window's mean
        # plus its mask's sum, at each of its tokens
        rolled = torch.roll(xl, tuple(-s for s in sh), (1, 2, 3))
        b, d, h, w, c = rolled.shape
        win = rolled.reshape(b, d // 2, 2, h // 7, 7, w // 7, 7, c)
        mean = win.mean(dim=(2, 4, 6), keepdim=True)
        msum = ml.reshape(d // 2, h // 7, w // 7, -1).sum(-1)[None, :, None, :, None, :, None, None]
        out = (win * 0 + mean + msum).reshape(rolled.shape)
        return torch.roll(out, sh, (1, 2, 3))

    want = fn(x, mask, shift)
    seen.clear()
    with tp.model_parallel_by_turns(2):
        got = tp.shard_windows_call(fn, x, mask, window, shift)
    assert torch.equal(got, want)
    assert [s[0] for s in seen] == [(1, 2, 7, 14, 4)] * 2 and all(s[2] == (0, 0, 0) for s in seen)
    halves = mask.reshape(1, 2, 2, 98, 98)
    for r, (_, m, _) in enumerate(seen):
        assert torch.equal(m, halves[:, r].reshape(-1, 98, 98))
    # the rank's mask slice is memoised: the same tensor at the next call
    with tp.model_parallel_by_turns(2):
        first = tp.mask_rows(mask, (2, 14, 14), window, 2, 1)
        assert tp.mask_rows(mask, (2, 14, 14), window, 2, 1) is first and first.is_contiguous()
