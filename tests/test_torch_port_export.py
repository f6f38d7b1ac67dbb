"""The port's serving export (``vadcl_tpu_torch/serve``) on the CPU, as
``tests/test_serve_export.py`` holds the JAX package's: the tiny preset of
``test_torch_port_train.py`` (56x56 windows of 4 frames, 16 feature and 8
space clusters), exported once per artifact kind for the module.

The fused model's artifact (its graph calls the kernels' ``torch.library``
ops, which run their plain versions on the CPU) scores windows bit for bit
as the live port does, and as the JAX package's ``window_score_fn`` on the
same weights within the fp32 score bound of ``utils/parity.py`` (1e-5 +
1e-3 max|want|, the JAX export CLI's).  The CLIs run end to end in
subprocesses; the serving one imports nothing of the model code or of JAX.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vadcl_tpu_torch.models.swin as swin
from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_port_train import _configs
from vadcl_tpu.eval.predict import window_score_fn as jax_window_score_fn
from vadcl_tpu.models.backbone import VADModel as JaxVADModel
from vadcl_tpu.train.checkpoint import unflatten_into
from vadcl_tpu_torch.convert import jax_from_state_dict
from vadcl_tpu_torch.eval import window_score_fn
from vadcl_tpu_torch.eval.predict import make_window_scorer
from vadcl_tpu_torch.models import VADModel
from vadcl_tpu_torch.serve import (
    artifact_window_runner,
    export_window_scorer,
    load_artifact,
    save_artifact,
)
from vadcl_tpu_torch.utils.parity import score_bound

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 4
OPS = ["vadcl.cluster_assign.default", "vadcl.fold_attention.default",
       "vadcl.ln_mlp.default", "vadcl.space_cluster_loss.default"]


def _windows(n, seed):
    return np.random.RandomState(seed).randint(0, 256, (n, 4, 56, 56, 3)).astype(np.uint8)


def _live(model, predict=True):
    fn = window_score_fn(lambda clips: model(clips).recon, predict,
                         input_frames=4 if predict else None)

    def score(windows):
        with torch.no_grad():
            return fn(torch.from_numpy(windows))

    return score


@pytest.fixture(scope="module")
def fused(tmp_path_factory):
    """The fused tiny model from its seeded init, its twin that is never
    exported, its artifact (static batch 4), exported before the model
    ever scored, and the same weights as JAX variables (on the template of
    an abstract JAX init)."""
    jcfg, pcfg = _configs(True, attn_kernel="fold")
    model, twin = (VADModel(pcfg.model, torch.float32, torch.Generator().manual_seed(0)).eval()
                   for _ in range(2))
    template = jax.eval_shape(JaxVADModel(config=jcfg.model).init, jax.random.key(0),
                              jnp.zeros((1, 4, 56, 56, 3), jnp.float32))
    variables = unflatten_into(template, jax_from_state_dict(model.state_dict(), predict=True))
    program, meta = export_window_scorer(model, batch_windows=BATCH, frame_num=4,
                                         image_size=(56, 56), predict=True, input_frames=4)
    path = str(tmp_path_factory.mktemp("art") / "fused")
    save_artifact(path, program, meta)
    return dict(model=model, twin=twin, path=path, art=load_artifact(path), variables=variables)


def test_artifact_round_trips_and_matches_jax(fused):
    with open(os.path.join(fused["path"], "meta.json")) as f:
        meta = json.load(f)
    assert meta["format"] == "torch.export.ExportedProgram" and meta["device"] == "cpu"
    assert meta["batch_windows"] == BATCH and meta["out_shape"] == [[BATCH]]
    assert meta["ops"] == OPS
    assert os.path.exists(os.path.join(fused["path"], "scorer.pt2"))
    windows = _windows(BATCH, seed=0)
    got = fused["art"].score(windows)
    assert got.shape == (BATCH,)
    assert torch.equal(got, _live(fused["model"])(windows))
    jcfg, _ = _configs(False)
    jmodel = JaxVADModel(config=jcfg.model)
    want = np.asarray(jax.jit(jax_window_score_fn(
        lambda clips: jmodel.apply(fused["variables"], clips).recon, predict=True,
        input_frames=4))(jnp.asarray(windows)))
    assert float(np.max(np.abs(got.numpy() - want))) <= score_bound(want, torch.float32)


def test_live_model_scores_the_same_after_an_export(fused):
    """The export bypasses the model's memos (the gathered rel-pos bias,
    the shift masks): the exported model scores after it as its twin that
    was never exported, bit for bit, and holds no traced tensor."""
    windows = _windows(2, seed=1)
    assert torch.equal(_live(fused["model"])(windows), _live(fused["twin"])(windows))
    for m in fused["model"].modules():
        if isinstance(m, swin.SwinBlock3D):
            memo = m.attn._bias_memo
            assert memo is not None and type(memo[1]) is torch.Tensor
            assert all(v is None or type(v) is torch.Tensor for v in m._masks.values())


def test_runner_pads_the_tail(fused):
    """6 windows at batch 4: the tail of 2 is padded with its last window,
    whose scores are dropped; the runner equals the live window scorer."""
    art = fused["art"]
    windows = _windows(6, seed=2)
    out = artifact_window_runner(art)(windows)
    assert out.shape == (6,)
    tail = art.score(np.concatenate([windows[4:], windows[5:6], windows[5:6]])).numpy()[:2]
    np.testing.assert_array_equal(out[4:], tail)
    live = make_window_scorer(lambda clips: fused["model"](clips).recon, 4, True, BATCH,
                              input_frames=4, device="cpu")
    np.testing.assert_array_equal(out, live(windows))


def test_dynamic_batch_recon_artifact(tmp_path):
    """The plain model (one block a stage) in reconstruction mode with a
    dynamic batch: one artifact scores batches 1 and 3, per frame; a fused
    model refuses a dynamic batch."""
    _, pcfg = _configs(False, predict=False)
    m = dataclasses.replace(pcfg.model, encoder_depths=(1, 1), decoder_depths=(1, 1))
    model = VADModel(m, torch.float32, torch.Generator().manual_seed(1)).eval()
    program, meta = export_window_scorer(model, batch_windows=None, frame_num=4,
                                         image_size=(56, 56), predict=False)
    assert meta["batch_windows"] is None and meta["out_shape"] == [["batch", 4]]
    assert meta["ops"] == []
    save_artifact(str(tmp_path / "dyn"), program, meta)
    art = load_artifact(str(tmp_path / "dyn"))
    run = artifact_window_runner(art)
    for n in (1, 3):
        windows = _windows(n, seed=3 + n)
        got = run(windows)
        assert got.shape == (n, 4)
        np.testing.assert_allclose(got, _live(model, predict=False)(windows).numpy(),
                                   rtol=1e-6, atol=1e-8)
    _, fcfg = _configs(True)
    with pytest.raises(ValueError, match="dynamic batch"):
        export_window_scorer(VADModel(fcfg.model), batch_windows=None, frame_num=4,
                             image_size=(56, 56))


def _run(args, timeout=300):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    return subprocess.run([sys.executable, *args], capture_output=True, text=True,
                          timeout=timeout, env=env, cwd=REPO)


def test_export_cli_check(tmp_path):
    """tools/export_torch.py end to end on the CPU: export the fused model,
    reload, hold it against the live scorer."""
    out = _run([os.path.join(REPO, "tools", "export_torch.py"), "--preset", "tiny",
                "--out", str(tmp_path / "art"), "--predict", "--batch-windows", "2",
                "--image-size", "56", "--fused", "--device", "cpu", "--check"])
    assert out.returncode == 0, out.stderr[-3000:]
    assert "reload check: max |artifact - live| = 0.000e+00" in out.stdout, out.stdout


SERVE = """
import runpy, sys
sys.argv = ["serve_torch.py"] + sys.argv[1:]
runpy.run_path("tools/serve_torch.py", run_name="__main__")
bad = sorted(k for k in sys.modules if k.startswith("vadcl_tpu_torch.models")
             or k.split(".")[0] in ("jax", "jaxlib", "flax", "vadcl_tpu"))
assert not bad, bad
print("imports clean")
"""


def test_serve_cli_end_to_end(fused, tmp_path):
    """tools/serve_torch.py: the artifact and frame folders in, per-scene
    AUC and scores.npz out, in a process that imports no model code."""
    from vadcl_tpu_torch.data import make_synthetic_dataset

    _, test_dir, label_dir = make_synthetic_dataset(str(tmp_path / "data"), num_train_videos=0,
                                                    size=56, frames_per_video=8)
    out_npz = str(tmp_path / "scores.npz")
    out = _run(["-c", SERVE, "--artifact", fused["path"], "--data-path", test_dir,
                "--label-path", label_dir, "--protocol", "stride1", "--out", out_npz])
    assert out.returncode == 0, out.stderr[-3000:]
    assert "mean scene AUC" in out.stdout and "imports clean" in out.stdout
    curves = np.load(out_npz)
    assert len(curves.files) == 2
    for k in curves.files:
        scores, labels = curves[k]
        assert scores.shape == (4,) and np.isfinite(scores).all()
        assert scores.min() >= 0.0 and scores.max() <= 1.0 + 1e-6
