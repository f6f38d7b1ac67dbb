"""The train-step options the port took over from the JAX package last:
dropout and drop-path, ``remat``, the ``lars`` optimizer and
``tolerant_merge``, on the CPU at the tiny preset of
``test_torch_port_train.py`` (depths (2, 2), so shifted blocks occur;
4x56x56 uint8 clips).

References: the JAX model in eval with the rates set (recon atol 1e-4, the
forward bound of ``test_torch_port_model.py``); the port's own
deterministic forward bit for bit; for a step that draws masks, the same
step on the plain route with the same masks (loss rtol 1e-4, each gradient
2e-3 of its largest element, the train tests' bounds), the same step
without ``remat`` bit for bit, and one process against two gloo ranks at
half batch (the bounds of ``test_torch_port_dist.py``); ``optax.lars`` on
the same gradients (1e-6 relative) and the JAX package's LARS state; the
JAX package's ``tolerant_merge`` on the same flat dict.
"""

import contextlib
import dataclasses
import math
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import vadcl_tpu_torch.models.swin as swin
from graph_double import GraphDouble
from test_torch_port_dist import (
    LOSS_REL,
    MOMENT_REL,
    STEP_COLLECTIVES,
    _assert_one_process_bounds,
    _rel_err,
    _worst,
    assert_same_run,
    launch,
)
from test_torch_port_dist import SCHED as DIST_SCHED
from test_torch_port_dist import STEPS as DIST_STEPS
from test_torch_port_dist import STEPS_PER_EPOCH as DIST_STEPS_PER_EPOCH
from test_torch_port_dist import _clips as dist_clips
from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_port_train import GRAD_TOL, LR, _assert_rel, _clips, _configs, _port_model
from test_torch_port_train import jax_variables  # noqa: F401  (a fixture)
from torch_dist_worker import run_half_batches, run_steps
from vadcl_tpu.models.backbone import VADModel as JaxVADModel
from vadcl_tpu.train.checkpoint import flatten_state, unflatten_into
from vadcl_tpu.train.checkpoint import tolerant_merge as jax_tolerant_merge
from vadcl_tpu.train.optim import build_optimizer as jax_build_optimizer
from vadcl_tpu_torch.convert import jax_from_state_dict
from vadcl_tpu_torch.models import DropKeys, DropPath, VADModel, drop_keys
from vadcl_tpu_torch.models import layers
from vadcl_tpu_torch.models.layers import keep_mask
from vadcl_tpu_torch.train import (
    Lars,
    create_train_state,
    flatten_train_state,
    load_train_state,
    make_loss_fn,
    make_train_step,
    tolerant_merge,
)
from vadcl_tpu_torch.utils.graphs import WARMUP_CALLS
from vadcl_tpu_torch.utils.parity import check_adam_bound

RATES = dict(drop_rate=0.1, drop_path_rate=0.2)


def _cfg(fused=True, attn_kernel="fold", **model):
    _, pcfg = _configs(fused, attn_kernel=attn_kernel, cluster_start_iter=0,
                       compactness_start_iter=0)
    return pcfg.replace(model=dataclasses.replace(pcfg.model, fused_cluster=fused, **model))


def _model(cfg, state_dict=None) -> VADModel:
    model = VADModel(cfg.model, torch.float32, torch.Generator().manual_seed(0))
    if state_dict is not None:
        model.load_state_dict(state_dict)
    return model


def _loss_and_grads(model, cfg, clip, step=0):
    model.train()
    model.zero_grad(set_to_none=True)
    loss, _ = make_loss_fn(model, cfg)(torch.from_numpy(clip), step)
    loss.backward()
    return float(loss.detach()), {k: p.grad.clone() for k, p in model.named_parameters()
                         if p.grad is not None}


@pytest.fixture(scope="module")
def weights():
    return _model(_cfg(**RATES)).state_dict()


def test_eval_forward_ignores_the_rates_and_matches_jax(jax_variables):
    """In eval, and in training mode outside the train step's draws, a model
    with every rate set computes the rate-0 model's forward bit for bit, and
    the JAX model's deterministic forward with the same rates."""
    jcfg, pcfg = _configs(True, attn_kernel="fold")
    rates = dict(RATES, attn_drop_rate=0.0)
    jcfg = jcfg.replace(model=dataclasses.replace(jcfg.model, fused_attention=False, **rates))
    with_rates = pcfg.replace(model=dataclasses.replace(pcfg.model, **rates))
    port = _port_model(jax_variables, with_rates)
    plain = _port_model(jax_variables, pcfg)
    x = _clips(1, seed=4)[0].astype(np.float32) / 255.0
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x)).recon
        train_mode = port.train()(torch.from_numpy(x)).recon
        want_port = plain.eval()(torch.from_numpy(x)).recon
    assert torch.equal(got, want_port) and torch.equal(train_mode, want_port)
    want = jax.jit(JaxVADModel(config=jcfg.model).apply)(jax_variables, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want.recon), rtol=0, atol=1e-4)


def test_routes_follow_the_jax_block(weights, monkeypatch):
    """Which kernels a fused block calls (spied on the CPU): at rate 0 in
    a train step, today's routes (LN1 and the residual in the fold kernel,
    the fused MLP tail; the whole-block kernel under fold_block); with
    masks drawn, the fold kernel without LN and residual, no fused tail and
    no whole-block kernel."""
    calls = []

    def spy(name, fn):
        def wrapped(*a, **k):
            calls.append((name, a[1] is not None) if name == "fold" else name)
            return fn(*a, **k)
        monkeypatch.setattr(swin, {"fold": "fold_attention"}.get(name, name), wrapped)

    spy("fold", swin.fold_attention)
    spy("ln_mlp", swin.ln_mlp)
    spy("fold_block", swin.fold_block)
    clip = _clips(1, seed=5)[0]
    seen = {}
    for kernel in ("fold", "fold_block"):
        for rates in ({}, RATES):
            calls.clear()
            cfg = _cfg(attn_kernel=kernel, **rates)
            _loss_and_grads(_model(cfg, weights), cfg, clip)
            seen[kernel, bool(rates)] = set(calls)
    assert seen["fold", False] == {("fold", True), "ln_mlp"}
    assert seen["fold_block", False] == {"fold_block"}
    assert seen["fold", True] == seen["fold_block", True] == {("fold", False)}


def test_drop_path_keeps_one_minus_rate_of_the_samples():
    """Over many samples and draws the kept share lies within 3 sigma of
    1 - rate, kept samples are scaled by 1 / keep, and a draw is a function
    of its keys alone."""
    rate, n, draws = 0.3, 512, 8
    m = DropPath(rate).train()
    m.site = "encoder.stage0.block0.drop_path1"
    x = torch.ones(n, 2, 3)
    kept = 0
    for step in range(draws):
        with drop_keys(DropKeys(seed=1, step=step)):
            y = m(x)
        with drop_keys(DropKeys(seed=1, step=step)):
            assert torch.equal(m(x), y)
        keep = y[:, 0, 0] != 0
        assert torch.equal(y[keep], torch.full_like(y[keep], 1 / (1 - rate)))
        assert torch.equal(y[~keep], torch.zeros_like(y[~keep]))
        kept += int(keep.sum())
    total = n * draws
    sigma = math.sqrt(total * rate * (1 - rate))
    assert abs(kept - total * (1 - rate)) <= 3 * sigma, (kept, total)
    assert torch.equal(m.eval()(x), x)
    # a process at global offset 2 of a batch of 4 draws rows 2..3 of the draw
    with drop_keys(DropKeys(seed=1, step=0, global_batch=4)):
        whole = keep_mask("site", (4, 5, 6), 0.5, "cpu")
    with drop_keys(DropKeys(seed=1, step=0, offset=2, global_batch=4)):
        assert torch.equal(keep_mask("site", (2, 5, 6), 0.5, "cpu"), whole[2:])


def test_two_steps_draw_different_masks(weights):
    """JAX's ``test_dropout_active_when_configured``: two steps from the
    same weights on the same clip draw different masks (different losses),
    one step drawn twice gives the same loss."""
    cfg = _cfg(**RATES)
    model = _model(cfg, weights).train()
    loss_fn = make_loss_fn(model, cfg)
    clip = torch.from_numpy(_clips(1, seed=6)[0])
    with torch.no_grad():
        a, b, a2 = (float(loss_fn(clip, s)[0]) for s in (0, 1, 0))
    assert a == a2 and a != b


@pytest.mark.parametrize("kernel", ["fold", "base", "fold_block"])
def test_stochastic_fused_route_matches_the_plain_route(weights, kernel):
    """A step that draws masks on the fused route against the plain model
    with the same masks: loss and every gradient."""
    clip = _clips(1, seed=7)[0]
    fused_cfg = _cfg(attn_kernel=kernel, **RATES)
    plain_cfg = _cfg(fused=False, **RATES)
    got_loss, got = _loss_and_grads(_model(fused_cfg, weights), fused_cfg, clip)
    want_loss, want = _loss_and_grads(_model(plain_cfg, weights), plain_cfg, clip)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-4)
    assert got.keys() == want.keys()
    for k in want:
        _assert_rel(k, got[k].numpy(), want[k].numpy(), GRAD_TOL)


def test_remat_matches_no_remat_bit_for_bit(weights):
    """remat recomputes each block in the backward with the forward's masks
    (attention dropout too, on the plain route): the loss and every
    gradient equal the step without remat."""
    for fused, extra in ((True, {}), (False, {"attn_drop_rate": 0.1})):
        out = []
        for remat in (False, True):
            cfg = _cfg(fused=fused, remat=remat, **RATES, **extra)
            out.append(_loss_and_grads(_model(cfg, weights), cfg, _clips(1, seed=8)[0]))
        (l0, g0), (l1, g1) = out
        assert l0 == l1
        assert g0.keys() == g1.keys() and all(torch.equal(g0[k], g1[k]) for k in g0)


@pytest.fixture(scope="module")
def dropout_inputs(jax_variables):
    _, pcfg = _configs(True, **DIST_SCHED)
    cfg = pcfg.replace(model=dataclasses.replace(pcfg.model, **RATES))
    return dict(cfg=cfg, state_dict=_port_model(jax_variables, pcfg).state_dict(),
                clips=dist_clips(), steps_per_epoch=DIST_STEPS_PER_EPOCH)


@pytest.fixture(scope="module")
def dropout_ranks(dropout_inputs, tmp_path_factory):
    """``torch_dist_worker.py dropout_step`` on two gloo ranks: the steps
    eager, and the same steps captured."""
    return launch("dropout_step", tmp_path_factory.mktemp("dropout_step"), dropout_inputs)


def test_remat_recompute_draws_the_forwards_masks_from_a_device_step(weights):
    """With the step a 0-d tensor, as the train step passes its device
    ``clock``, remat's recompute draws the forward's masks: the loss and
    every gradient equal the step without remat bit for bit, and another
    step draws another loss."""
    out = []
    for remat in (False, True):
        cfg = _cfg(remat=remat, **RATES)
        out.append(_loss_and_grads(_model(cfg, weights), cfg, _clips(1, seed=8)[0],
                                   torch.tensor(3)))
    (l0, g0), (l1, g1) = out
    assert l0 == l1 and g0.keys() == g1.keys() and all(torch.equal(g0[k], g1[k]) for k in g0)
    cfg = _cfg(**RATES)
    assert _loss_and_grads(_model(cfg, weights), cfg, _clips(1, seed=8)[0],
                           torch.tensor(4))[0] != l0


# the most of the elements the rule of ``_within_rounding_of_zero`` may leave
# out of the parameter bounds (the test's run: the share in its docstring)
ROUNDING_SHARE = 0.1


def _within_rounding_of_zero(one, exact) -> dict:
    """Each parameter's elements whose gradient in ``one`` (fp32) lies, at
    some step, farther than ``MOMENT_REL`` of itself from ``exact``'s (the
    same steps in float64): the reference's own rounding there is past the
    bound its run is held to."""
    apart = {k: torch.zeros_like(p, dtype=torch.bool) for k, p in one["params"].items()}
    for got, want in zip(one["grads"], exact["grads"]):
        for k, g in got.items():
            apart[k] |= (g.double() - want[k]).abs() > MOMENT_REL * want[k].abs()
    return apart


def test_two_ranks_with_dropout_match_one_process(dropout_inputs, dropout_ranks):
    """``test_torch_port_dist.py``'s run (two gloo ranks at batch 2 against
    one process at batch 4, three steps) with dropout and drop-path on.
    Each rank draws its own samples' masks (the rows of one process's
    draw), so the 2-rank run equals its control, one process taking each
    global batch as two half-batch passes that draw the ranks' masks
    (``run_half_batches``), to the all-reduce's rounding (``LOSS_REL``,
    every tensor whole), and holds to one process at batch 4 within that
    file's bounds (``_assert_one_process_bounds``) and ``check_adam_bound``.

    The parameter bounds there leave out, with the key biases, the elements
    whose reference gradient is within rounding of zero
    (``_within_rounding_of_zero``: one process's fp32 gradient, at some
    step, farther than ``MOMENT_REL`` of itself from the float64 run's).
    Adam steps by a gradient's ratio to its history, so at such an element
    the reference's rounding sets the step.  Element 3 of the
    zero-initialised BatchNorm bias ``encoder.inception0.b1a.bn.bias``
    has the step-1 gradient 3.2271e-4 in fp32 and 3.2231e-4 in float64
    (1.2e-3 of itself; the tensor's largest is 0.455), and the step-0
    gradient -2.6151e-4, so Adam's first moment cancels to about a quarter
    of either: the 2-rank run steps it 1.4e-7 from one process, and that
    tensor's norm ratio, every element held, reads 3.4e-4.  One process in
    fp32 is itself 1.4e-4 (norm ratio) from float64 at that tensor.  The
    rule leaves out 4.8% of the elements, each still held by
    ``check_adam_bound``; past ``ROUNDING_SHARE`` the test fails."""
    one = run_steps(dropout_inputs, 0, 1, grads=True)
    apart = _within_rounding_of_zero(
        one, run_steps(dropout_inputs, 0, 1, dtype=torch.float64, grads=True))
    share = sum(int(m.sum()) for m in apart.values()) / sum(m.numel() for m in apart.values())
    assert share <= ROUNDING_SHARE, share
    control = run_half_batches(dropout_inputs)
    for rank in dropout_ranks:
        run = rank["global"]
        assert _rel_err(run["losses"], control["losses"]) <= LOSS_REL
        for k, p in control["params"].items():
            assert _rel_err(run["params"][k], p) <= LOSS_REL, k
            assert float((run["params"][k] - p).norm()) <= LOSS_REL * float(p.norm()), k
            for got, want in zip(run["moments"][k], control["moments"][k]):
                assert _rel_err(got, want) <= LOSS_REL, k
        _assert_one_process_bounds(_worst(run, one, apart))
        check_adam_bound("2 ranks against one process", run["params"], one["params"], LR,
                         DIST_STEPS)


def test_two_ranks_captured_dropout_step_equals_eager_bit_for_bit(dropout_ranks):
    """The 2-rank dropout run captured (``tests/graph_double.py``: two eager
    steps, then a capture and its replay): the replay draws its own step's
    masks from the device clock, so each rank ends on its eager run's
    losses, moments and parameters bit for bit."""
    for rank in dropout_ranks:
        assert_same_run(rank["captured"], rank["global"], DIST_STEPS - WARMUP_CALLS,
                        STEP_COLLECTIVES)


def _draw(step, shape=(4, 3, 5, 8), keep=0.9, offset=0, global_batch=0):
    with drop_keys(DropKeys(seed=3, step=step, offset=offset, global_batch=global_batch)):
        return keep_mask("encoder.stage0.block1.mlp.drop1", shape, keep, "cpu")


def test_device_draw_rows_steps_and_keep_share():
    """The draw from a device step count (a 0-d tensor, as the train step's
    ``clock``) equals the draw from the same host count; a process at
    global offset r draws rows r.. of one process's draw, whatever its
    share; another step or another site draws other masks; and over 10^6
    elements at each rate the kept share lies within 4 binomial sigma of
    1 - rate."""
    whole = _draw(5)
    assert torch.equal(_draw(torch.tensor(5)), whole)
    for offset, rows in ((0, 2), (2, 2), (1, 3), (3, 1)):
        part = _draw(torch.tensor(5), (rows, 3, 5, 8), offset=offset, global_batch=4)
        assert torch.equal(part, whole[offset:offset + rows])
    assert not torch.equal(_draw(6), whole)
    with drop_keys(DropKeys(seed=3, step=5)):
        assert not torch.equal(keep_mask("encoder.stage0.block1.mlp.drop2", (4, 3, 5, 8), 0.9,
                                         "cpu"), whole)
    n = 10 ** 6
    for rate in (0.1, 0.2, 0.5):
        kept = int(_draw(torch.tensor(7), (1000, 1000), keep=1 - rate).sum())
        assert abs(kept - n * (1 - rate)) <= 4 * math.sqrt(n * rate * (1 - rate)), (rate, kept)


def test_device_draw_is_splitmix64_of_seed_step_site_and_element():
    """The draw's int64 tensor arithmetic (masked shifts, wrapping
    products, the top bits compared with their sign flipped, the last
    xorshift skipped) against splitmix64 in Python integers: element i of
    the global draw kept where the top 24 bits of ``fmix64(i * golden +
    fmix64(mix64(seed, crc32(site)) + (step + 1) * golden))`` lie below
    ``ceil(keep * 2^24)``, at the rates' edges too."""
    golden, m64 = layers._GOLDEN, layers._M64
    for keep in (0.9, 0.5, 1e-9, 0.0, 1 - 1e-9):
        for step in (0, 7, 2 ** 40 + 3):
            got = _draw(torch.tensor(step), (2, 3, 5, 8), keep, offset=1, global_batch=4)
            base = layers._mix64(3, zlib.crc32(b"encoder.stage0.block1.mlp.drop1"))
            key = layers._fmix64((base + (step + 1) * golden) & m64)
            kept = [layers._fmix64((i * golden + key) & m64) >> 40 < math.ceil(keep * 2 ** 24)
                    for i in range(120, 360)]
            assert got.flatten().tolist() == kept, (keep, step)


def test_a_replay_draws_its_own_steps_masks():
    """A draw captured at step 2 (``tests/graph_double.py``) and replayed
    after the clock moved to 3 and 4 gives those steps' masks, the eager
    draws at the same steps, not the capture's."""
    clock = torch.tensor(2)
    replay, mask = GraphDouble()(lambda c: _draw(c), (clock,), contextlib.nullcontext())
    for step in (3, 4):
        clock.fill_(step)
        replay()
        assert torch.equal(mask, _draw(step)) and not torch.equal(mask, _draw(2))


def test_lars_matches_optax():
    """Three LARS steps against ``optax.lars(lr, weight_decay, momentum)``
    on the same gradients: a zero tensor (trust ratio 1) and a zero
    gradient included."""
    rng = np.random.RandomState(0)
    shapes = [(4, 3), (5,), (2, 2, 2)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes] + [np.zeros(3, np.float32)]
    grads = [[rng.randn(*p.shape).astype(np.float32) for p in params] for _ in range(3)]
    grads[1][1] = np.zeros_like(params[1])
    lr, wd, mom = 0.05, 1e-3, 0.9
    tparams = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = Lars(tparams, lr=lr, weight_decay=wd, momentum=mom)
    tx = optax.lars(lr, weight_decay=wd, momentum=mom)
    jp = [jnp.asarray(p) for p in params]
    st = tx.init(jp)
    for g in grads:
        for p, gi in zip(tparams, g):
            p.grad = torch.from_numpy(gi)
        opt.step()
        upd, st = tx.update([jnp.asarray(gi) for gi in g], st, jp)
        jp = optax.apply_updates(jp, upd)
        for p, w in zip(tparams, jp):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)
    assert opt.count == 3


def _nested(flat):
    out = {}
    for path, a in flat.items():
        *parents, leaf = path.split("/")
        node = out
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = jnp.asarray(a)
    return out


def test_lars_steps_ungated_and_round_trips_into_jax_state(weights):
    """``train()``'s step with ``optimizer="lars"``: no staged gating (the
    cluster parameters move before ``cluster_train_start_iter``), and its
    state flattens to the leaves of the JAX package's LARS state, fills
    them, and loads back."""
    cfg = _cfg(**RATES)
    cfg = cfg.replace(optim=dataclasses.replace(cfg.optim, optimizer="lars"),
                      schedule=dataclasses.replace(cfg.schedule, cluster_train_start_iter=5))
    model = _model(cfg, weights)
    state = create_train_state(model, cfg)
    assert isinstance(state.optimizer, Lars)
    step_fn = make_train_step(model, cfg, 3)
    center = model.cluster1.cluster_center.detach().clone()
    for clip in _clips(2, seed=10):
        step_fn(state, torch.from_numpy(clip))
    assert not torch.equal(model.cluster1.cluster_center, center)
    flat = flatten_train_state(state)
    params = _nested({k[len("params/"):]: v for k, v in flat.items() if k.startswith("params/")})
    o = cfg.optim
    tx = jax_build_optimizer("lars", lambda s: 0.0, o.weight_decay, o.b1, o.b2, o.eps)
    template = flatten_state({"opt_state": tx.init(params)})
    got = {k: v for k, v in flat.items() if k.startswith("opt_state/")}
    assert got.keys() == template.keys()
    assert int(got["opt_state/0/2/count"]) == 2
    filled = unflatten_into({"opt_state": tx.init(params)}, got)
    assert flatten_state(filled).keys() == template.keys()
    fresh = create_train_state(_model(cfg, weights), cfg)
    load_train_state(flat, fresh)
    assert fresh.optimizer.count == 2 and fresh.step == 2
    again = flatten_train_state(fresh)
    assert all(np.array_equal(again[k], flat[k]) for k in flat)


def test_tolerant_merge_matches_jax(weights):
    """The same flat dict (a missing leaf, a leaf of the wrong shape, a key
    the model lacks, the rest changed values) merged by both packages: the
    same hits and misses, hit tensors loaded, the rest kept."""
    cfg = _cfg()
    model = _model(cfg, weights)
    own = jax_from_state_dict(model.state_dict(), predict=True)
    rng = np.random.RandomState(11)
    flat = {k: (v + rng.rand(*v.shape).astype(np.float32)) for k, v in own.items()}
    missing = "params/encoder/stage0/block0/attn/proj_bias"
    wrong = "params/decoder/norm/scale"
    del flat[missing]
    flat[wrong] = np.zeros(3, np.float32)
    flat["params/not/in/the/model"] = np.zeros(2, np.float32)
    _, jax_hits, jax_misses = jax_tolerant_merge(_nested(own), flat)
    merged, hits, misses = tolerant_merge(model, flat)
    assert merged is model
    assert hits == sorted(jax_hits) and misses == sorted(jax_misses)
    assert set(misses) == {missing, wrong}
    after = jax_from_state_dict(model.state_dict(), predict=True)
    for k in hits:
        np.testing.assert_array_equal(after[k], flat[k])
    for k in misses:
        np.testing.assert_array_equal(after[k], own[k])
    sd, hits_sd, _ = tolerant_merge(_model(cfg, weights).state_dict(), flat, predict=True)
    assert hits_sd == hits and all(torch.equal(sd[k], v) for k, v in model.state_dict().items())
