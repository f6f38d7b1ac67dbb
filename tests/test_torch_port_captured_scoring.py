"""The scorer's host half: static batches, the stager thread, and the
captured call's invalidation rule and launch counts (``utils/graphs.py``).

On the CPU nothing is captured (the card is where a CUDA graph lives), so
the captured call runs here with its capture step replaced by a recording
double: it records one call as the real step does and replays it eagerly.
What is tested is what the call decides (when to capture anew, that a
replay counts no launch), not the graph.
"""

import dataclasses
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

import vadcl_tpu.core.config as jax_config
import vadcl_tpu.eval.predict as jax_predict
import vadcl_tpu_torch.core.config as port_config
import vadcl_tpu_torch.eval.predict as port_predict
from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse)
from vadcl_tpu.models.backbone import VADModel as JaxVADModel
from vadcl_tpu.train.checkpoint import flatten_state
from vadcl_tpu_torch import ops
from vadcl_tpu_torch.convert import load_state_dict_strict, state_dict_from_jax
from vadcl_tpu_torch.models import VADModel
from vadcl_tpu_torch.models.swin import WindowAttention3D
from vadcl_tpu_torch.ops.packed import PackCache
from vadcl_tpu_torch.utils import graphs

JOIN_S = 10.0  # seconds a pipeline thread may take to exit


@pytest.fixture(scope="module")
def models():
    """The tiny predict model in both packages, same weights (unfused), as
    ``test_torch_port_eval.py`` builds them."""
    m = dataclasses.replace(jax_config.preset("tiny").model, predict=True)
    jmodel = JaxVADModel(config=m)
    variables = jax.jit(jmodel.init)(jax.random.key(0), jnp.zeros((1, 4, 56, 56, 3)))
    pm = dataclasses.replace(port_config.preset("tiny").model, predict=True)
    tmodel = VADModel(pm, torch.float32)
    load_state_dict_strict(tmodel, state_dict_from_jax(flatten_state(variables), predict=True))
    return jmodel, variables, tmodel.eval()


def _video(t: int = 13, seed: int = 0) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, 256, (t, 56, 56, 3)).astype(np.uint8)


# ---- static batch --------------------------------------------------------

@pytest.mark.parametrize("batch_windows", [4, 5])
def test_static_batch_matches_jax_and_unpadded(models, batch_windows):
    """13 frames give 9 stride-1 windows: batches of 4 leave a tail of 1,
    of 5 a tail of 4.  The padded static batch is held against the JAX
    scorer (which pads too) at ``test_torch_port_eval.py``'s tolerance and
    against the same windows scored in one unpadded call."""
    jmodel, variables, tmodel = models
    frames = _video()
    starts = port_predict.sliding_windows(frames.shape[0], 4, "stride1")
    assert len(starts) % batch_windows
    jscorer = jax_predict.make_video_scorer(
        lambda c: jmodel.apply(variables, c).recon, frame_num=4, predict=True,
        batch_windows=batch_windows, input_frames=4)
    pscorer = port_predict.make_video_scorer(
        lambda c: tmodel(c).recon, frame_num=4, predict=True, batch_windows=batch_windows,
        input_frames=4, device="cpu")
    want = jscorer(frames, starts)
    got = pscorer(frames, starts)
    assert got.shape == want.shape == (len(starts),)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)

    score = port_predict.window_score_fn(lambda c: tmodel(c).recon, True, input_frames=4)
    windows = torch.from_numpy(np.stack([frames[s:s + 4] for s in starts]))
    with torch.inference_mode():
        unpadded = score(windows).numpy()
    np.testing.assert_allclose(got, unpadded, rtol=0, atol=1e-5)


def test_static_batch_pads_by_repeating_the_last_start():
    """Every batch reaches the window scorer at ``batch_windows``; the
    padding repeats the last window and its scores are dropped."""
    seen = []

    def score_windows(w):
        seen.append(w.clone())
        return w.float().mean(dim=(1, 2, 3, 4))

    frames = _video(11, seed=1)
    starts = [0, 1, 2, 3, 4, 5, 6]
    run = port_predict.windows_video_scorer(score_windows, 4, True, batch_windows=3,
                                            device="cpu")
    got = run(frames, starts)
    assert [tuple(w.shape) for w in seen] == [(3, 4, 56, 56, 3)] * 3
    for i in (1, 2):  # the last batch holds window 6 and twice more
        assert torch.equal(seen[2][i], seen[2][0])
    want = np.stack([frames[s:s + 4] for s in starts]).astype(np.float32).mean(axis=(1, 2, 3, 4))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_dynamic_batch_scores_a_video_in_one_call():
    calls = []

    def score_windows(w):
        calls.append(w.shape[0])
        return w.float().mean(dim=(1, 2, 3, 4))

    run = port_predict.windows_video_scorer(score_windows, 4, True, batch_windows=None,
                                            device="cpu")
    assert run(_video(9), list(range(5))).shape == (5,)
    assert calls == [5]
    with pytest.raises(ValueError, match="eagerly"):
        port_predict.windows_video_scorer(score_windows, 4, True, None, device="cpu",
                                          graph=True)


# ---- the stager thread ---------------------------------------------------

class _Stager:
    """A scorer whose ``stage`` records the thread it ran on."""

    def __init__(self, fail_at: int = -1):
        self.threads, self.staged, self.fail_at = [], [], fail_at

    def __call__(self, frames, starts):
        return np.zeros(len(starts), np.float32)

    def stage(self, frames):
        self.threads.append(threading.current_thread())
        i = int(frames[0, 0, 0, 0])
        if i == self.fail_at:
            raise RuntimeError(f"staging video {i} failed")
        self.staged.append(i)
        return frames


def _videos(n, fail_at: int = -1, log=None):
    for i in range(n):
        if i == fail_at:
            raise OSError(f"decoding video {i} failed")
        if log is not None:
            log(i)
        yield np.full((6, 2, 2, 3), i, np.uint8), np.zeros(6, np.int64), f"{i:02d}"


def test_stage_runs_on_a_thread_of_its_own_and_order_is_kept():
    scorer = _Stager()
    got = [int(f[0, 0, 0, 0]) for f, _, _ in port_predict.pipeline_videos(scorer, _videos(7))]
    assert got == list(range(7)) == scorer.staged
    me = threading.current_thread()
    assert all(t is not me for t in scorer.threads)
    assert {t.name for t in scorer.threads} == {"vadcl-stage"}


@pytest.mark.parametrize("lookahead", [1, 2, 3])
def test_lookahead_bounds_decoded_and_staged_videos(lookahead):
    """At every decode and every stage, the videos decoded (staged ones
    included) and not yet scored number at most ``lookahead``: the slot of
    a video frees when the consumer asks for the next one."""
    decoded, scored, worst = [0], [0], [0]

    def check(_=None):
        worst[0] = max(worst[0], decoded[0] - scored[0])

    def log(_):
        decoded[0] += 1
        check()

    class Scorer(_Stager):
        def stage(self, frames):
            check()
            time.sleep(0.002)
            return super().stage(frames)

    for _ in port_predict.pipeline_videos(Scorer(), _videos(12, log=log), lookahead):
        time.sleep(0.005)  # the consumer is the slow leg: the producers run ahead
        scored[0] += 1
    assert scored[0] == decoded[0] == 12
    assert worst[0] == lookahead


def test_pipelines_under_thread_switch_stress_keep_order_and_bound():
    """More pipelines than cores at once, the interpreter switching threads
    every 10 µs: each keeps its videos' order and its lookahead bound."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    failures = []

    def consume(k):
        try:
            decoded, scored, worst = [0], [0], [0]

            def log(_):
                decoded[0] += 1
                worst[0] = max(worst[0], decoded[0] - scored[0])

            got = []
            for frames, _, _ in port_predict.pipeline_videos(_Stager(), _videos(40, log=log), 2):
                got.append(int(frames[0, 0, 0, 0]))
                scored[0] += 1
            if got != list(range(40)) or worst[0] > 2:
                failures.append((k, got, worst[0]))
        except Exception as e:  # reported below
            failures.append((k, repr(e)))

    try:
        workers = [threading.Thread(target=consume, args=(k,)) for k in range(16)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(60.0)
            assert not w.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert failures == []


def test_a_decode_error_is_raised_in_the_consumer():
    got = []
    with pytest.raises(OSError, match="decoding video 3"):
        for frames, _, _ in port_predict.pipeline_videos(_Stager(), _videos(6, fail_at=3)):
            got.append(int(frames[0, 0, 0, 0]))
    assert got == [0, 1, 2]


def test_a_stage_error_is_raised_in_the_consumer():
    got = []
    with pytest.raises(RuntimeError, match="staging video 2"):
        for frames, _, _ in port_predict.pipeline_videos(_Stager(fail_at=2), _videos(6)):
            got.append(int(frames[0, 0, 0, 0]))
    assert got == [0, 1]


def test_both_threads_exit_when_the_consumer_stops_early():
    def endless():
        i = 0
        while True:
            yield np.full((6, 2, 2, 3), i % 256, np.uint8), np.zeros(6, np.int64), "01"
            i += 1

    before = set(threading.enumerate())
    gen = port_predict.pipeline_videos(_Stager(), endless(), lookahead=2)
    next(gen)
    mine = [t for t in threading.enumerate() if t not in before]
    assert sorted(t.name for t in mine) == ["vadcl-decode", "vadcl-stage"]
    gen.close()
    for t in mine:
        t.join(JOIN_S)
        assert not t.is_alive(), t.name


def test_a_cpu_scorer_stages_onto_its_device():
    run = port_predict.make_video_scorer(lambda c: c, 4, True, batch_windows=2, device="cpu")
    staged = run.stage(_video(7))
    assert isinstance(staged, port_predict.StagedVideo)
    assert staged.num_frames == 7 and staged.ready is None
    assert run(staged, [0, 1, 2]).shape == (3,)


# ---- the captured call ---------------------------------------------------

class RecordingCapture:
    """The capture step's double: records one call inside ``recording``
    as the real step captures it, and replays by calling ``fn`` again into
    the same outputs (``replay_calls=False``: by keeping them)."""

    def __init__(self, replay_calls: bool = True):
        self.captures, self.replay_calls = 0, replay_calls

    def __call__(self, fn, static, recording):
        self.captures += 1
        with recording:
            out = fn(*static)

        def replay():
            if self.replay_calls:
                out.copy_(fn(*static))

        return replay, out


def _linear_call(seed: int = 0):
    model = nn.Linear(4, 3)
    nn.init.normal_(model.weight, generator=torch.Generator().manual_seed(seed))
    double = RecordingCapture()
    return model, double, graphs.CapturedCall(model, "cpu", capture=double)


def test_a_repeated_call_replays_and_a_new_shape_gets_a_second_graph():
    model, double, call = _linear_call()
    x, y = torch.randn(5, 4), torch.randn(2, 4)
    with torch.no_grad():
        for _ in range(3):
            torch.testing.assert_close(call(x), model(x), rtol=0, atol=0)
        assert double.captures == call.captures == 1
        call(y)
        assert call.captures == 2
        call(x)
        call(y)
    assert call.captures == 2


def test_an_in_place_parameter_update_captures_anew():
    model, double, call = _linear_call()
    x = torch.randn(5, 4)
    with torch.no_grad():
        call(x)
        call(x)
        model.weight.add_(0.5)  # an optimizer's step: same tensor, new version
        torch.testing.assert_close(call(x), model(x), rtol=0, atol=0)
    assert call.captures == 2


def test_a_replaced_parameter_captures_anew():
    """A parameter swapped for another (the old one still alive elsewhere,
    as an optimizer would hold it), and a ``.data`` swap, each give a new
    graph."""
    model, double, call = _linear_call()
    x = torch.randn(5, 4)
    with torch.no_grad():
        call(x)
        old = model.weight
        model.weight = nn.Parameter(torch.randn(3, 4))
        call(x)
        assert call.captures == 2
        call(x)
        assert call.captures == 2
        model.bias.data = torch.randn(3)
        torch.testing.assert_close(call(x), model(x), rtol=0, atol=0)
    assert call.captures == 3 and old is not model.weight


def test_a_pack_source_changing_captures_anew():
    """The capture reads a packed tensor taken from the cache, never its
    source: the cache names the source to the capture, whose graph then
    goes stale when the source changes in place."""
    cache, src = PackCache(), torch.randn(4, 4)

    def pack():
        return cache.get([src], ("double",), lambda: src * 2.0)

    pack()  # made before the capture, as the real step's warm-up makes it
    double = RecordingCapture()
    call = graphs.CapturedCall(lambda x: x @ pack(), "cpu", capture=double)
    x = torch.randn(3, 4)
    call(x)
    call(x)
    assert call.captures == 1
    with torch.no_grad():
        src.mul_(3.0)
    torch.testing.assert_close(call(x), x @ (src * 2.0), rtol=0, atol=0)
    assert call.captures == 2


def test_a_bias_table_changing_captures_anew():
    """The same for a block's gathered rel-pos bias: its memo is made before
    the capture, which reads the memo; the table's in-place update makes
    the graph stale."""
    attn = WindowAttention3D(8, (1, 2, 2), 2)
    attn.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        attn.bias(4)
        double = RecordingCapture()
        call = graphs.CapturedCall(lambda x: x + attn.bias(4), "cpu", capture=double)
        x = torch.randn(2, 4, 4)
        call(x)
        call(x)
        assert call.captures == 1
        attn.relative_position_bias_table.add_(1.0)
        torch.testing.assert_close(call(x), x + attn.bias(4), rtol=0, atol=0)
    assert call.captures == 2


def test_the_port_model_captures_anew_after_a_weight_update(models):
    """The tiny model's window scorer through the captured call at a static
    batch: a conv weight and a Swin block's table, each updated in place,
    give a new graph whose scores are the updated model's."""
    _, _, tmodel = models
    score = port_predict.window_score_fn(lambda c: tmodel(c).recon, True, input_frames=4)
    double = RecordingCapture()
    call = graphs.CapturedCall(score, "cpu", capture=double)
    frames = _video()
    windows = torch.from_numpy(np.stack([frames[s:s + 4] for s in range(4)]))
    table = tmodel.encoder.stage0.block0.attn.relative_position_bias_table
    conv = next(p for n, p in tmodel.named_parameters() if p.dim() == 5)
    saved = table.detach().clone(), conv.detach().clone()
    try:
        with torch.inference_mode():
            first = call(windows)
            call(windows)
            assert call.captures == 1
            gen = torch.Generator().manual_seed(1)
            for i, p in enumerate((table, conv)):
                with torch.inference_mode(False), torch.no_grad():
                    # (a random step: a constant added to the table would leave the softmax)
                    p.add_(torch.randn(p.shape, generator=gen) * 0.25)
                got = call(windows)
                assert call.captures == 2 + i
                torch.testing.assert_close(got, score(windows), rtol=0, atol=0)
                assert not torch.equal(got, first)
    finally:
        with torch.no_grad():
            table.copy_(saved[0])
            conv.copy_(saved[1])


def test_a_replay_counts_no_launch():
    """The capture's call runs the wrappers, which count as they always do;
    a replay runs no wrapper, so the counters stay where the capture left
    them (what a replay launched is read from the device's trace)."""

    def fn(x):
        ops.fold_attention.launches += 2  # as the wrapper counts a launch
        ops.ln_mlp.launches += 1
        return x * 2.0

    double = RecordingCapture(replay_calls=False)
    call = graphs.CapturedCall(fn, "cpu", capture=double)
    x = torch.randn(3)
    a0, b0 = ops.fold_attention.launches, ops.ln_mlp.launches
    try:
        call(x)  # the capture, then one replay
        assert (ops.fold_attention.launches - a0, ops.ln_mlp.launches - b0) == (2, 1)
        for _ in range(3):
            torch.testing.assert_close(call(x), x * 2.0)
        assert (ops.fold_attention.launches - a0, ops.ln_mlp.launches - b0) == (2, 1)
        assert call.captures == 1
    finally:
        ops.fold_attention.launches, ops.ln_mlp.launches = a0, b0


def test_the_returned_outputs_are_copies():
    double = RecordingCapture()
    call = graphs.CapturedCall(lambda x: x + 1.0, "cpu", capture=double)
    a = call(torch.zeros(2))
    b = call(torch.ones(2))
    assert a.tolist() == [1.0, 1.0] and b.tolist() == [2.0, 2.0]


# ---- capture off the card ------------------------------------------------

def test_capture_on_the_cpu_raises():
    with pytest.raises(ValueError, match="CUDA"):
        graphs.CapturedCall(lambda x: x, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        graphs.cuda_graph_capture(lambda x: x, (torch.zeros(1),), None)
    for factory in (port_predict.make_video_scorer, port_predict.make_window_scorer):
        with pytest.raises(ValueError, match="graph=True"):
            factory(lambda c: c, 4, True, batch_windows=2, device="cpu", graph=True)
    assert graphs.wants_graph(None, "cpu") is False
    assert graphs.wants_graph(None, "cuda") is True
    assert graphs.wants_graph(False, "cuda") is False


def test_an_exported_scorer_copies_no_host_constant():
    """The shift masks enter the program as constants on the model's device
    (the export reads the blocks' mask memos, as it reads their bias
    memos), not as host arrays lifted into the program, which a loaded
    program on the card copies to the device at every call and a CUDA
    graph's capture refuses.  What is still lifted is 0-dim (the plain
    attention's scale), which an operator takes as a number."""
    from vadcl_tpu_torch.serve import export_window_scorer

    # two blocks a stage: every second one shifted, so with a mask
    cfg = dataclasses.replace(port_config.preset("tiny").model, predict=True,
                              encoder_depths=(2, 2), decoder_depths=(2, 2))
    model = VADModel(cfg, torch.float32, torch.Generator().manual_seed(0)).eval()
    program, _ = export_window_scorer(model, batch_windows=2, frame_num=4, image_size=(56, 56),
                                      predict=True, input_frames=4)
    lifted = [n for n in program.graph.nodes if "lift_fresh" in str(n.target)]
    assert [tuple(n.meta["val"].shape) for n in lifted if n.meta["val"].dim()] == []
