"""The train step's host half: one captured graph a step
(``train/step.py``, ``utils/graphs.py:CapturedCall``), the optimizers'
gates and the non-finite guard on the device (``train/optim.py``), on the
CPU at the tiny preset.

Nothing is captured on the CPU (a CUDA graph lives on the card), so the
captured step runs here with its capture step replaced by
``tests/graph_double.py:GraphDouble``, which behaves as a CUDA graph does
where it matters (its docstring): a replay runs the recorded operators
with no Python in between, reads what existed before the capture by
reference and leaves every ``_version`` where it was.  The steps split
over gloo processes run it in ``tests/torch_dist_worker.py``.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from graph_double import GraphDouble
from test_torch_port_captured_scoring import RecordingCapture
from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_port_train import (  # noqa: F401  (jax_variables is a fixture)
    SCHEDULE, STEPS, STEPS_PER_EPOCH, _clips, _configs, _port_model, jax_variables,
)
from test_torch_port_train_steps import _assert_params_close, jax_trajectory  # noqa: F401
from vadcl_tpu.train.checkpoint import flatten_state
from vadcl_tpu_torch.core.config import preset
from vadcl_tpu_torch.models import VADModel
from vadcl_tpu_torch.models.backbone import model_input_frames
from vadcl_tpu_torch.ops.packed import PackCache
from vadcl_tpu_torch.train import (
    create_train_state,
    flatten_train_state,
    load_train_state,
    make_train_step,
    train,
)
from vadcl_tpu_torch.utils import graphs


# the gates, the compactness gate and an epoch's LR change all fall on
# replayed steps (the capture is step 2): one capture serves them all
MIDRUN = dict(cluster_start_iter=3, cluster_train_start_iter=4, compactness_start_iter=5)
N_STEPS, EPOCH_STEPS = 6, 3


def _cfg(attn_kernel="fold", frames=0, optimizer="adam", clip_grad=0.0, remat=False,
         backbone="swin", **model):
    """The tiny preset, fused, with the mid-run schedule; ``frames`` > 0:
    reconstruction on clips of that many frames (the Swin model predicts
    otherwise)."""
    cfg = preset("tiny")
    m = dataclasses.replace(cfg.model, fused_attention=True, fused_cluster=True,
                            attn_kernel=attn_kernel, remat=remat,
                            predict=not frames and backbone == "swin",
                            backbone=backbone, **model)
    return cfg.replace(
        model=m, data=dataclasses.replace(cfg.data, frame_num=frames or 4),
        optim=dataclasses.replace(cfg.optim, optimizer=optimizer, clip_grad=clip_grad, lr=1e-3,
                                  epochs=4),
        schedule=dataclasses.replace(cfg.schedule, **MIDRUN))


def _batches(cfg, n, seed=0, batch=1, size=56):
    frames = cfg.data.frame_num
    return [torch.from_numpy(c) for c in np.random.RandomState(seed).randint(
        0, 256, (n, batch, frames, size, size, 3)).astype(np.uint8)]


def _state(cfg, seed=0):
    model = VADModel(cfg.model, torch.float32, torch.Generator().manual_seed(seed),
                     model_input_frames(cfg.model.backbone, cfg.data.frame_num))
    model.train()
    return create_train_state(model, cfg)


def _run(cfg, graph, batches, state=None):
    """(state, metrics, step_fn) after one step on each batch; ``graph``
    steps through ``GraphDouble``."""
    state = state if state is not None else _state(cfg)
    double = GraphDouble() if graph else None
    step_fn = make_train_step(state.model, cfg, EPOCH_STEPS, capture=double)
    metrics = [step_fn(state, b) for b in batches]
    return state, metrics, step_fn


def _assert_same_state(a, b):
    assert a.step == b.step
    for (k, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), k
        sa, sb = a.optimizer.state[p], b.optimizer.state[q]
        assert sa.keys() == sb.keys(), k
        for s in sa:
            assert torch.equal(torch.as_tensor(sa[s]), torch.as_tensor(sb[s])), (k, s)
    for (k, x), y in zip(a.model.named_buffers(), b.model.buffers()):
        assert torch.equal(x, y), k


CASES = {
    "fold": {},
    "base": dict(attn_kernel="base"),
    "fold_block": dict(attn_kernel="fold_block"),
    "reconstruction-8-frames": dict(frames=8),
    "remat": dict(remat=True),
    "adamw": dict(optimizer="adamw"),
    "sgd": dict(optimizer="sgd"),
    "lars": dict(optimizer="lars"),
    "clip_grad": dict(clip_grad=0.5),
    # masks drawn from the device clock: each replay its own step's (and
    # remat's recompute the forward's)
    "dropout-remat": dict(remat=True, drop_rate=0.1, drop_path_rate=0.2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_captured_steps_equal_eager_steps_bit_for_bit(case):
    """N steps through the captured step (2 eager, one capture, replays)
    against N eager steps from the same state on the same batches:
    parameters, moments and counts, the step, losses and learning rates bit
    for bit, with one capture across the stage gates, the compactness gate
    and an epoch's learning-rate change."""
    cfg = _cfg(**CASES[case])
    batches = _batches(cfg, N_STEPS)
    eager, me, fn_e = _run(cfg, False, batches)
    graphed, mg, fn_g = _run(cfg, True, batches)
    assert fn_e.graph is None
    assert fn_g.graph.captures == fn_g.graph._capture.captures == 1
    assert fn_g.graph._capture.replays == N_STEPS - graphs.WARMUP_CALLS
    assert eager.step == graphed.step == N_STEPS
    _assert_same_state(eager, graphed)
    for a, b in zip(me, mg):
        for f in ("loss", "loss_pixel", "cluster_loss", "space_loss", "grad_finite"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
        assert a.lr == b.lr
    assert len({m.lr for m in mg}) == 2  # the epoch boundary moved the rate
    moved = [float((p - q).detach().abs().max()) for p, q in zip(
        graphed.model.parameters(), _state(cfg).model.parameters())]
    assert min(moved) > 0  # every parameter, the gated ones too, trained


def test_captured_trajectory_matches_jax(jax_variables, jax_trajectory):
    """The captured step in place of the eager one in
    ``test_torch_port_train_steps.py``'s six-step trajectory against the
    JAX make_train_step, under the bounds that test states."""
    _, pcfg = _configs(True, **SCHEDULE)
    model = _port_model(jax_variables, pcfg)
    state = create_train_state(model, pcfg)
    double = GraphDouble()
    step_fn = make_train_step(model, pcfg, STEPS_PER_EPOCH, capture=double)
    metrics = [step_fn(state, torch.from_numpy(c)) for c in _clips(STEPS, seed=2)]
    assert double.captures == 1 and double.replays == STEPS - graphs.WARMUP_CALLS
    np.testing.assert_allclose([float(m.loss) for m in metrics], jax_trajectory["losses"],
                               rtol=1e-4)
    np.testing.assert_allclose([m.lr for m in metrics], jax_trajectory["lrs"], rtol=1e-6)
    assert state.step == STEPS
    _assert_params_close(model, jax_trajectory["params"],
                         flatten_state({"params": jax_variables["params"]}), STEPS)


@pytest.mark.parametrize("graph", [False, True], ids=["eager", "captured"])
def test_a_non_finite_step_holds_every_parameter_and_moment(graph):
    """A batch that makes the loss NaN, on a replayed step: every
    parameter, moment and count keeps its bits, the flag says so, and the
    next step trains as if the held step had not been."""
    cfg = _cfg()
    batches = [b.float() / 255.0 for b in _batches(cfg, 5)]
    bad = batches[3].clone()
    bad[0, 0, 0, 0, 0] = float("nan")
    state = _state(cfg)
    double = GraphDouble() if graph else None
    step_fn = make_train_step(state.model, cfg, EPOCH_STEPS, capture=double)
    for b in batches[:3]:
        assert bool(step_fn(state, b).grad_finite)
    before = copy.deepcopy((state.model.state_dict(), state.optimizer.state_dict()))
    m = step_fn(state, bad)
    assert not bool(m.grad_finite) and not np.isfinite(float(m.loss))
    assert state.step == 4
    model_sd, opt_sd = before
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, model_sd[k]), k
    for i, st in state.optimizer.state_dict()["state"].items():
        for s, v in st.items():
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(opt_sd["state"][i][s])), (i, s)
    assert bool(step_fn(state, batches[4]).grad_finite)
    if graph:
        assert double.captures == 1


class _NanLoader:
    """Float batches, the ``nan_at``-th made non-finite; counts requests."""

    batch_size = 1

    def __init__(self, cfg, steps, nan_at):
        self.batches = [b.float().numpy() / 255.0 for b in _batches(cfg, steps)]
        self.batches[nan_at][0, 0, 0, 0, 0] = np.nan
        self.requested = 0

    def steps_per_epoch(self):
        return len(self.batches)

    def epoch(self, e, start_iter=0):
        for b in self.batches[start_iter:]:
            self.requested += 1
            yield b


def test_the_loop_raises_one_step_late_on_a_non_finite_loss(tmp_path):
    """``train()`` reads a step's loss after the next step is dispatched
    (the JAX loop's lag), so a NaN at step 2 raises once step 3 ran."""
    cfg = _cfg().replace(output_dir=str(tmp_path), save_every_iters=0, save_every_epochs=0)
    loader = _NanLoader(cfg, 6, nan_at=2)
    with pytest.raises(FloatingPointError, match="non-finite loss at step 3"):
        train(cfg, loader, device="cpu")
    assert loader.requested == 4


def test_replays_leave_no_stale_pack_memo_or_graph():
    """A pack, the bias memo and a scorer ``CapturedCall`` made before the
    replays, then the replays (whose writes a real graph hides from
    ``_version``): each serves the stepped weights afterwards, as do an
    eager forward and a fresh model loading the stepped ``state_dict``."""
    cfg = _cfg()
    batches = _batches(cfg, 5)
    state = _state(cfg)
    model = state.model
    step_fn = make_train_step(model, cfg, EPOCH_STEPS, capture=GraphDouble())
    for b in batches[:3]:  # 2 warm-ups and the capture's step
        step_fn(state, b)
    attn = model.encoder.stage0.block0.attn
    table = attn.relative_position_bias_table
    cache = PackCache()
    x = torch.rand(1, 4, 56, 56, 3, generator=torch.Generator().manual_seed(5))
    scorer_double = RecordingCapture(replay_calls=False)
    scorer = graphs.CapturedCall(lambda c: model(c).recon, "cpu", capture=scorer_double)
    with torch.no_grad():
        n = attn.rel_index.shape[0]
        memo = attn.bias(n).clone()
        packed = cache.get((table,), ("test",), lambda: table.detach().clone())
        stale = scorer(x)
    for b in batches[3:]:  # replays
        step_fn(state, b)
    assert step_fn.graph._capture.replays == 3  # the capture's step and these two
    fresh = VADModel(cfg.model, torch.float32)
    fresh.load_state_dict(model.state_dict())
    with torch.no_grad():
        want = fresh(x).recon
        assert not torch.equal(want, stale)
        torch.testing.assert_close(scorer(x), want, rtol=0, atol=0)
        assert scorer.captures == 2
        torch.testing.assert_close(model(x).recon, want, rtol=0, atol=0)
        assert not torch.equal(attn.bias(n), memo)
        torch.testing.assert_close(attn.bias(n), fresh.encoder.stage0.block0.attn.bias(n),
                                   rtol=0, atol=0)
        assert not torch.equal(packed, table)
        assert torch.equal(cache.get((table,), ("test",), lambda: table.detach().clone()),
                           table)


def test_a_restore_captures_anew_and_matches_eager():
    """A checkpoint restored in place after replays gives a new graph, and
    the steps after it are the eager steps' after the same restore."""
    cfg = _cfg()
    batches = _batches(cfg, 7)
    runs = []
    for graph in (False, True):
        state, _, step_fn = _run(cfg, graph, batches[:2])
        flat = flatten_train_state(state)  # after 2 steps
        for b in batches[2:5]:
            step_fn(state, b)
        load_train_state(flat, state)
        assert state.step == 2
        for b in batches[5:]:
            step_fn(state, b)
        runs.append(state)
        if graph:
            assert step_fn.graph.captures == 2
    _assert_same_state(*runs)


def test_routing_and_refusals():
    """The CPU runs the step eagerly by default and refuses ``graph=True``
    for its device alone; no configuration is eager by nature any more: a
    step that draws dropout masks, or one under a mesh and model axis, is
    captured wherever a capture step is (here the double), and only
    ``debug_nans`` runs eagerly, refusing ``graph=True``."""
    from vadcl_tpu_torch.core.mesh import Mesh2D

    cfg = _cfg()
    model = _state(cfg).model
    assert make_train_step(model, cfg, EPOCH_STEPS).graph is None
    with pytest.raises(ValueError, match="CUDA device"):
        make_train_step(model, cfg, EPOCH_STEPS, graph=True)
    drop = cfg.replace(model=dataclasses.replace(cfg.model, drop_rate=0.1, drop_path_rate=0.1))
    assert make_train_step(model, drop, EPOCH_STEPS).graph is None
    with pytest.raises(ValueError, match="CUDA device"):
        make_train_step(model, drop, EPOCH_STEPS, graph=True)
    for c, kw in ((drop, {}), (cfg, dict(mesh=Mesh2D(1, 1), model_axis="model"))):
        assert make_train_step(model, c, EPOCH_STEPS, capture=GraphDouble(), **kw).graph \
            is not None
    with pytest.raises(ValueError, match="debug_nans"):
        train(cfg, _NanLoader(cfg, 2, 0), device="cpu", debug_nans=True, graph=True)


def test_a_graph_refuses_a_host_read():
    """A step that reads a value on the host cannot be captured: the
    double raises where a capture on the card would."""
    cfg = _cfg()
    state = _state(cfg)
    step_fn = make_train_step(state.model, cfg, EPOCH_STEPS, capture=GraphDouble())
    batches = _batches(cfg, 3)
    for b in batches[:2]:
        step_fn(state, b)
    real = state.model.forward

    def reads(*args, **kwargs):
        out = real(*args, **kwargs)
        bool(out.recon.isfinite().all())
        return out

    state.model.forward = reads
    with pytest.raises(RuntimeError, match="reads a value on the host"):
        step_fn(state, batches[2])


@pytest.mark.parametrize("backbone", ["convae", "convae_predict"])
def test_memory_bank_after_captured_steps_equals_eager(backbone):
    """The memory families' bank, written in place at every step, after N
    captured steps: the eager bank's bits, parameters and moments too."""
    cfg = _cfg(backbone=backbone)
    batches = _batches(cfg, 4, size=32)
    eager, _, _ = _run(cfg, False, batches)
    graphed, _, fn = _run(cfg, True, batches)
    assert fn.graph.captures == 1
    bank = graphed.model.convae.memory.keys
    assert not torch.equal(bank, _state(cfg).model.convae.memory.keys)
    _assert_same_state(eager, graphed)


def test_step_functions_share_nothing_but_the_model():
    """Two step functions over one model: each its own clock and graph;
    the second's eager steps continue the first's captured ones."""
    cfg = _cfg()
    batches = _batches(cfg, 6)
    a, _, fn = _run(cfg, True, batches[:4])
    b, _, _ = _run(cfg, False, batches[:4])
    _assert_same_state(a, b)
    again = make_train_step(a.model, cfg, EPOCH_STEPS, graph=False)
    for x in batches[4:]:
        again(a, x)
        _run(cfg, False, [x], state=b)
    _assert_same_state(a, b)


@pytest.mark.parametrize("name", ["adam", "adamw", "sgd"])
@pytest.mark.parametrize("counts", [(0, 0, 0), (4, 4, 4), (2, 7, 0)],
                         ids=["fresh", "loaded-equal", "loaded-unequal"])
def test_the_device_update_is_torchs(name, counts):
    """Three steps of the port's optimizer, every mask true, against
    torch's own (``foreach=False``) from the same state: counts made fresh,
    loaded equal (one mask, so one bias-correction factor for the three)
    and loaded unequal (a mask a parameter, so a factor each); then a false
    mask holds every tensor bit for bit."""
    from vadcl_tpu_torch.train import build_optimizer

    rng = np.random.RandomState(3)
    shapes = [(4, 3), (5,), (2, 2, 2)]
    init = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[rng.randn(*s).astype(np.float32) for s in shapes] for _ in range(4)]
    ours = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in init]
    theirs = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in init]
    opt = build_optimizer(name, ours, 0.02, 0.9, 0.999, 1e-8)
    kind = {"adam": torch.optim.Adam, "adamw": torch.optim.AdamW, "sgd": torch.optim.SGD}[name]
    kw = dict(momentum=0.9) if name == "sgd" else dict(betas=(0.9, 0.999), eps=1e-8)
    ref = kind(theirs, lr=1e-2, weight_decay=0.02, foreach=False, **kw)
    opt.param_groups[0]["lr"] = 1e-2
    if name != "sgd" and any(counts):
        moments = [torch.from_numpy(rng.rand(*s).astype(np.float32)) for s in shapes]
        for o, ps in ((opt, ours), (ref, theirs)):
            for p, n, m in zip(ps, counts, moments):
                o.state[p] = {"step": torch.tensor(float(n)), "exp_avg": m.clone(),
                              "exp_avg_sq": m.square()}
    unequal = len(set(counts)) > 1
    live = {p: torch.tensor(True) for p in ours} if unequal else dict.fromkeys(
        ours, torch.tensor(True))
    opt.init_state([[p] for p in ours] if unequal else [ours])
    for g in grads[:3]:
        for a, b, gi in zip(ours, theirs, g):
            a.grad, b.grad = torch.from_numpy(gi), torch.from_numpy(gi.copy())
        opt.step(masks=live)
        ref.step()
        for a, b in zip(ours, theirs):
            torch.testing.assert_close(a.detach(), b.detach(), rtol=1e-5, atol=1e-6)
    before = [t.clone() for p in ours for t in [p.detach()] + [
        v for v in opt.state[p].values() if isinstance(v, torch.Tensor)]]
    for p, gi in zip(ours, grads[3]):
        p.grad = torch.from_numpy(gi)
    opt.step(masks=dict.fromkeys(ours, torch.tensor(False)))
    after = [t for p in ours for t in [p.detach()] + [
        v for v in opt.state[p].values() if isinstance(v, torch.Tensor)]]
    assert all(torch.equal(a, b) for a, b in zip(after, before))


@pytest.mark.parametrize("name", ["adam", "adamw"])
def test_a_load_with_unequal_counts_under_one_gate_raises(name):
    """The parameters that step under one mask take one bias-correction
    factor, from the first one's count: ``init_state`` refuses a load that
    gives them different counts, and takes the same counts split over two
    gates."""
    from vadcl_tpu_torch.train import build_optimizer

    ps = [torch.nn.Parameter(torch.zeros(3)) for _ in range(3)]
    opt = build_optimizer(name, ps, 0.02, 0.9, 0.999, 1e-8)
    opt.init_state([ps])  # fresh: every count 0
    for p, n in zip(ps, (4, 4, 2)):
        opt.state[p] = {"step": torch.tensor(float(n)), "exp_avg": torch.zeros(3),
                        "exp_avg_sq": torch.zeros(3)}
    with pytest.raises(ValueError, match="different step counts"):
        opt.init_state([ps])
    opt.init_state([ps[:2], ps[2:]])
