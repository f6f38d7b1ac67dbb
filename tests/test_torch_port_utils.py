"""The port's profiling, attention-kernel autotune, FLOP-count and
process-group utilities on the CPU, and the CLIs under two processes.

* autotune: without a card both picks are ``base``; with the card and the
  measurement stubbed, the >5%-over-``base`` rule, ``trainable_only`` and
  the cache keyed by the card's name, and a failed measurement raises.
* FLOPs: ``counted_flops`` of the tiny forward against the JAX package's
  ``lowered_flops`` of the same unfused forward.  The two count on
  different bases: ``FlopCounterMode`` counts 2*M*N*K for every product and
  every convolution tap, padding taps included; XLA's cost analysis counts
  only the taps that fall on real input, plus the elementwise work.  The
  predict decoder's last 3x3x3 convolution runs over one frame padded in
  time, two thirds of its taps on padding, and the counts measured 1.453
  (predict) and 1.063 (reconstruction) times XLA's: the bounds are
  [1.0, 1.5] and [1.0, 1.1].
* ``trace_steps`` and ``train(profile_steps=, debug_nans=)``.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vadcl_tpu_torch.utils.autotune as autotune
from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse)
from vadcl_tpu.core.config import preset as jax_preset
from vadcl_tpu.models.backbone import VADModel as JaxVADModel
from vadcl_tpu.utils.flops import lowered_flops
from vadcl_tpu_torch.core import mesh
from vadcl_tpu_torch.core.config import preset
from vadcl_tpu_torch.models import VADModel
from vadcl_tpu_torch.parallel import cross_host_concat, cross_host_gather_ragged, global_sum
from vadcl_tpu_torch.train import train
from vadcl_tpu_torch.utils.flops import counted_flops, device_peak_tflops, mfu_pct
from vadcl_tpu_torch.utils.profiling import StepTimer, trace_steps

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMES = {"base": 1.0, "packed": 0.5, "fold": 0.97, "fold_packed": 0.8}


def test_autotune_picks_base_without_a_card(tmp_path):
    assert not torch.cuda.is_available()
    assert autotune.pick_attn_kernel() == "base"
    assert autotune.pick_attn_kernel(trainable_only=True) == "base"
    assert autotune.tuned_attn_kernel(cache_path=str(tmp_path / "c.json")) == "base"
    assert not (tmp_path / "c.json").exists()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        autotune.measure_attn_kernels()


@pytest.mark.parametrize("times,trainable_only,want", [
    (TIMES, False, "packed"),
    (TIMES, True, "base"),  # fold is 3% faster: not the 5% it takes
    (dict(TIMES, fold=0.9), True, "fold"),
    (dict(TIMES, fold=0.9, packed=0.2, fold_packed=0.1), True, "fold"),
    (dict(TIMES, packed=0.96, fold_packed=0.99), False, "base"),
    (dict(TIMES, packed=1.2, fold_packed=0.94), False, "fold_packed"),
])
def test_pick_rule(times, trainable_only, want):
    assert autotune.pick_from_times(times, trainable_only) == want


@pytest.fixture()
def fake_card(monkeypatch):
    """A visible card named by ``card["name"]`` whose measurement returns
    ``card["times"]`` and counts its calls."""
    card = {"name": "Fake GPU A", "times": dict(TIMES), "calls": 0}

    def measure():
        card["calls"] += 1
        if isinstance(card["times"], Exception):
            raise card["times"]
        return dict(card["times"])

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: card["name"])
    monkeypatch.setattr(autotune, "measure_attn_kernels", measure)
    return card


def test_tuned_cache_keyed_by_card(fake_card, tmp_path):
    path = str(tmp_path / "sub" / "autotune.json")
    assert autotune.tuned_attn_kernel(cache_path=path) == "packed"
    assert autotune.tuned_attn_kernel(trainable_only=True, cache_path=path) == "base"
    assert fake_card["calls"] == 2
    cache = json.load(open(path))
    assert cache["Fake GPU A|trainable=False"] == {"pick": "packed", "times_s": TIMES}
    assert cache["Fake GPU A|trainable=True"]["pick"] == "base"
    # cached: no measurement, even where the card would now pick otherwise
    fake_card["times"] = dict(TIMES, fold=0.5)
    assert autotune.tuned_attn_kernel(trainable_only=True, cache_path=path) == "base"
    assert fake_card["calls"] == 2
    # another kind of card is measured and cached beside the first
    fake_card["name"] = "Fake GPU B"
    assert autotune.tuned_attn_kernel(trainable_only=True, cache_path=path) == "fold"
    assert fake_card["calls"] == 3
    assert set(json.load(open(path))) == {"Fake GPU A|trainable=False",
                                          "Fake GPU A|trainable=True",
                                          "Fake GPU B|trainable=True"}
    # refresh measures again
    assert autotune.tuned_attn_kernel(cache_path=path, refresh=True) == "packed"
    assert fake_card["calls"] == 4


def test_autotune_cli_reads_the_cache_unless_refreshed(fake_card, tmp_path, monkeypatch,
                                                       capsys):
    """``tools/autotune_torch.py``: the first run measures and caches; a
    second prints the cached pick and times and measures nothing, even
    where the card would now pick otherwise; ``--refresh`` measures again."""
    from tools import autotune_torch

    monkeypatch.setattr(autotune_torch, "smi_line", lambda: "Fake GPU A, 700.00 W")
    path = str(tmp_path / "autotune.json")

    def run(*flags):
        pick = autotune_torch.main(["--cache", path, *flags])
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert line["pick"] == pick and line["nvidia_smi"] == "Fake GPU A, 700.00 W"
        return line

    first = run()
    assert first["pick"] == "packed" and not first["from_cache"] and fake_card["calls"] == 1
    fake_card["times"] = dict(TIMES, fold=0.4)
    again = run()
    assert again == first | {"from_cache": True} and fake_card["calls"] == 1
    fresh = run("--refresh")
    assert fresh["pick"] == "fold" and not fresh["from_cache"] and fake_card["calls"] == 2
    assert fresh["times_ms"]["fold"] == pytest.approx(400.0)


def test_tuned_unreadable_cache_is_measured_anew(fake_card, tmp_path):
    path = tmp_path / "autotune.json"
    path.write_text("{not json")
    assert autotune.tuned_attn_kernel(cache_path=str(path)) == "packed"
    assert fake_card["calls"] == 1
    assert json.load(open(path))["Fake GPU A|trainable=False"]["pick"] == "packed"


def test_tuned_measurement_failure_raises(fake_card, tmp_path):
    """A kernel that does not build or launch is not turned into a pick."""
    fake_card["times"] = RuntimeError("vadcl kernel build failed")
    with pytest.raises(RuntimeError, match="build failed"):
        autotune.tuned_attn_kernel(cache_path=str(tmp_path / "c.json"))
    with pytest.raises(RuntimeError, match="build failed"):
        autotune.pick_attn_kernel()
    assert not (tmp_path / "c.json").exists()


@pytest.mark.parametrize("predict,bounds", [(True, (1.0, 1.5)), (False, (1.0, 1.1))])
def test_counted_flops_against_xla(predict, bounds):
    m = dataclasses.replace(jax_preset("tiny").model, predict=predict)
    jmodel = JaxVADModel(config=m)
    x = jnp.zeros((2, 4, 56, 56, 3))
    variables = jax.jit(jmodel.init)(jax.random.key(0), x)
    want = lowered_flops(lambda v, c: jmodel.apply(v, c).recon, variables, x)
    model = VADModel(dataclasses.replace(preset("tiny").model, predict=predict), torch.float32)
    with torch.no_grad():
        got = counted_flops(model, torch.zeros(2, 4, 56, 56, 3))
        on_meta = counted_flops(model.to("meta"), torch.zeros(2, 4, 56, 56, 3, device="meta"))
    assert on_meta == got  # the count needs no data
    assert bounds[0] <= got / want <= bounds[1], got / want


def test_peak_and_mfu_without_a_card():
    assert device_peak_tflops() is None and device_peak_tflops("cpu") is None
    assert mfu_pct(1e12, None) is None
    assert mfu_pct(98.9e12, 989.0) == pytest.approx(10.0)


def test_peak_by_card_name(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for name, peak in (("NVIDIA H100 80GB HBM3", 989.0), ("NVIDIA H100 PCIe", 756.0),
                       ("NVIDIA H100 NVL", 835.0), ("NVIDIA A100-SXM4-80GB", None)):
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a, n=name: n)
        assert device_peak_tflops() == peak, name


def test_trace_steps_writes_a_chrome_trace(tmp_path):
    with trace_steps(str(tmp_path / "off"), enabled=False):
        torch.ones(4) @ torch.ones(4)
    assert not (tmp_path / "off").exists()
    with trace_steps(str(tmp_path / "on")):
        torch.ones(8, 8) @ torch.ones(8, 8)
    trace = json.load(open(tmp_path / "on" / "trace.json"))
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])


def test_step_timer_counts_the_world():
    from vadcl_tpu_torch.train.loop import StepTimer as LoopStepTimer

    assert LoopStepTimer is StepTimer
    timer = StepTimer(clips_per_step=8)
    assert timer.clips_per_sec == 0.0
    timer.tick()
    time.sleep(0.01)
    timer.tick()
    assert 0 < timer.clips_per_sec <= 8 / 0.01


class _AnomalyLoader:
    """Four uint8 batches of two tiny clips; records whether autograd's
    anomaly detection is on as each batch is drawn."""

    batch_size = 2

    def __init__(self):
        self.data = np.random.RandomState(5).randint(0, 256, (4, 2, 4, 56, 56, 3)).astype(
            np.uint8)
        self.anomaly = []

    def steps_per_epoch(self):
        return 4

    def epoch(self, e, start_iter=0):
        for i in range(start_iter, 4):
            self.anomaly.append(torch.is_anomaly_enabled())
            yield self.data[i]


def test_train_profiles_steps_and_detects_anomalies(tmp_path):
    """``profile_steps=1`` traces step 3 (steps [2, 3)) into
    ``profile/trace.json``; ``debug_nans`` runs the loop under anomaly
    detection and restores the former mode after it."""
    base = preset("tiny")
    cfg = base.replace(model=dataclasses.replace(base.model, predict=True),
                       output_dir=str(tmp_path), save_every_epochs=0)
    loader = _AnomalyLoader()
    state = train(cfg, loader, max_steps=4, device="cpu", profile_steps=1, debug_nans=True)
    assert state.step == 4
    assert loader.anomaly == [True] * 4 and not torch.is_anomaly_enabled()
    trace = json.load(open(tmp_path / "profile" / "trace.json"))
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("convolution" in n for n in names) and any("mm" in n for n in names)


def test_process_group_helpers_outside_a_group(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert not mesh.maybe_initialize_distributed("cpu")
    assert not mesh.is_distributed()
    assert (mesh.process_index(), mesh.process_count()) == (0, 1)
    mesh.barrier()
    assert mesh.local_device("cpu") == torch.device("cpu")
    assert mesh.local_device("cuda") == torch.device("cuda", 0)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert mesh.local_device("cuda") == torch.device("cuda", 3)
    rows = np.arange(6.0).reshape(3, 2)
    assert cross_host_gather_ragged(rows) is rows
    assert cross_host_concat([1, "a"]) == [1, "a"]
    t = torch.ones(3, requires_grad=True)
    assert global_sum(t) is t


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_evaluate_cli_under_two_processes(tmp_path):
    """``tools/evaluate_torch.py --device cpu`` started as two processes
    with torchrun's variables: ``maybe_initialize_distributed`` joins them
    (gloo), both print rank 0's AUC only once, and each writes the curves
    of its own videos to ``scores.proc<rank>.npz``; the per-scene AUCs are
    the one-process run's."""
    from vadcl_tpu_torch.data import make_synthetic_dataset

    _, test_dir, label_dir = make_synthetic_dataset(
        str(tmp_path / "data"), num_train_videos=1, num_test_videos=3, frames_per_video=9,
        size=56)
    args = [sys.executable, os.path.join(REPO, "tools", "evaluate_torch.py"), "--preset", "tiny",
            "--predict", "--device", "cpu", "--test-data-path", test_dir, "--label-path",
            label_dir, "--batch-windows", "4"]
    one = subprocess.run(args + ["--out", str(tmp_path / "one.npz")], capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert one.returncode == 0, one.stderr[-3000:]
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, OMP_NUM_THREADS="1", RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE="2", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(args + ["--out", str(tmp_path / "scores.npz")], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
    deadline = time.monotonic() + 120
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic())))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    aucs = [line for out, _ in outs for line in out.splitlines() if "AUC" in line]
    assert aucs == [line for line in one.stdout.splitlines() if "AUC" in line]
    with np.load(tmp_path / "scores.proc0.npz") as a, np.load(tmp_path / "scores.proc1.npz") as b:
        assert (len(a.files), len(b.files)) == (2, 1)
    assert not (tmp_path / "scores.npz").exists()
