"""The port's scoring path against the JAX package's: ``evaluate_videos`` of
both packages on the same ragged in-memory videos and the same weights, the
copied scoring functions and the copied config dataclasses.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vadcl_tpu.core.config as jax_config
import vadcl_tpu.eval.predict as jax_predict
import vadcl_tpu.eval.scoring as jax_scoring
import vadcl_tpu_torch.core.config as port_config
import vadcl_tpu_torch.eval.predict as port_predict
import vadcl_tpu_torch.eval.scoring as port_scoring
from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse)
from vadcl_tpu.models.backbone import VADModel as JaxVADModel
from vadcl_tpu.train.checkpoint import flatten_state
from vadcl_tpu_torch.convert import load_state_dict_strict, state_dict_from_jax
from vadcl_tpu_torch.models import VADModel


def _videos():
    """Two ragged uint8 videos (13 and 21 frames at 56^2) in two scenes;
    every protocol scores both label classes in each scene."""
    rng = np.random.RandomState(0)
    out = []
    for t, scene, span in ((13, "01", (8, 13)), (21, "02", (10, 16))):
        frames = rng.randint(0, 256, (t, 56, 56, 3)).astype(np.uint8)
        labels = np.zeros(t, np.int64)
        labels[span[0]:span[1]] = 1
        out.append((frames, labels, scene))
    return out


@pytest.fixture(scope="module")
def models():
    """The tiny predict model in both packages, same weights (unfused)."""
    m = dataclasses.replace(jax_config.preset("tiny").model, predict=True)
    jmodel = JaxVADModel(config=m)
    variables = jax.jit(jmodel.init)(jax.random.key(0), jnp.zeros((1, 4, 56, 56, 3)))
    pm = dataclasses.replace(port_config.preset("tiny").model, predict=True)
    tmodel = VADModel(pm, torch.float32)
    load_state_dict_strict(tmodel, state_dict_from_jax(flatten_state(variables), predict=True))
    return jmodel, variables, tmodel.eval()


@pytest.mark.parametrize("protocol", ["stride1", "nonoverlap", "stride1_first_frame"])
def test_evaluate_videos_matches_jax(models, protocol):
    jmodel, variables, tmodel = models
    quirk = protocol == "stride1_first_frame"
    proto = "stride1" if quirk else protocol
    jscorer = jax_predict.make_video_scorer(
        lambda c: jmodel.apply(variables, c).recon, frame_num=4, predict=True,
        batch_windows=4, first_frame_quirk=quirk, input_frames=4,
    )
    pscorer = port_predict.make_video_scorer(
        lambda c: tmodel(c).recon, frame_num=4, predict=True, batch_windows=4,
        first_frame_quirk=quirk, input_frames=4, device="cpu",
    )
    jauc, jscenes, jvideos = jax_predict.evaluate_videos(jscorer, _videos(), 4, True, proto)
    pauc, pscenes, pvideos = port_predict.evaluate_videos(pscorer, _videos(), 4, True, proto)
    assert len(pvideos) == len(jvideos) == 2
    for pv, jv in zip(pvideos, jvideos):
        assert pv.scene == jv.scene
        np.testing.assert_array_equal(pv.labels, jv.labels)
        np.testing.assert_allclose(pv.scores, jv.scores, rtol=0, atol=1e-4)
    assert pscenes.keys() == jscenes.keys()
    for s in jscenes:
        np.testing.assert_allclose(pscenes[s], jscenes[s], rtol=0, atol=1e-6)
    np.testing.assert_allclose(pauc, jauc, rtol=0, atol=1e-6)


def test_recon_mode_window_mse_matches_jax():
    """Reconstruction mode scores every frame of every window: (n, frame_num)."""
    rng = np.random.RandomState(1)
    frames = rng.randint(0, 256, (11, 8, 8, 3)).astype(np.uint8)
    starts = port_predict.sliding_windows(11, 4, "stride1")

    def jfn(c):
        return c * 0.5 + 0.1

    jscorer = jax_predict.make_video_scorer(jfn, 4, False, batch_windows=3)
    pscorer = port_predict.make_video_scorer(lambda c: c * 0.5 + 0.1, 4, False, batch_windows=3,
                                           device="cpu")
    want = jscorer(frames, starts)
    got = pscorer(frames, starts)
    assert got.shape == want.shape == (len(starts), 4)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("num_frames,protocol", [(13, "stride1"), (21, "nonoverlap"), (4, "stride1"), (3, "nonoverlap")])
def test_sliding_windows_and_input_frames_match_jax(num_frames, protocol):
    assert port_predict.sliding_windows(num_frames, 4, protocol) == jax_predict.sliding_windows(
        num_frames, 4, protocol
    )
    for backbone, predict in (("swin", True), ("swin", False), ("convae_predict", True)):
        assert port_predict.eval_input_frames(backbone, predict, 4) == jax_predict.eval_input_frames(
            backbone, predict, 4
        )


def test_pipeline_holds_at_most_lookahead_videos():
    """The decode-ahead producer never runs more than ``lookahead`` videos
    ahead of the one being scored."""
    decoded, scored = [], []

    def videos():
        for i in range(6):
            decoded.append(i)
            assert len(decoded) - len(scored) <= 2
            yield np.zeros((5, 2, 2, 3), np.uint8), np.zeros(5, np.int64), "01"

    scorer = port_predict.make_video_scorer(lambda c: c, 4, True, batch_windows=2, device="cpu")
    for _ in port_predict.pipeline_videos(scorer, videos(), lookahead=2):
        scored.append(1)
    assert len(scored) == 6


def test_scoring_functions_equal_jax():
    rng = np.random.RandomState(2)
    mse = rng.rand(50) * 0.1 + 1e-3
    np.testing.assert_array_equal(port_scoring.psnr(mse), jax_scoring.psnr(mse))
    p = port_scoring.psnr(mse)
    np.testing.assert_array_equal(port_scoring.anomaly_score(p), jax_scoring.anomaly_score(p))
    labels = (rng.rand(50) > 0.6).astype(np.int64)
    scores = np.round(rng.rand(50), 1)  # ties exercise the midranks
    assert port_scoring.roc_auc(labels, scores) == jax_scoring.roc_auc(labels, scores)
    ss = {"a": scores[:25], "b": scores[25:]}
    ll = {"a": labels[:25], "b": labels[25:]}
    aucs = port_scoring.per_scene_auc(ss, ll)
    assert aucs == jax_scoring.per_scene_auc(ss, ll)
    assert port_scoring.mean_scene_auc(aucs) == jax_scoring.mean_scene_auc(aucs)


@pytest.mark.parametrize(
    "name", ["ClusterConfig", "ModelConfig", "DataConfig", "EvalConfig", "OptimConfig",
             "ScheduleConfig", "MeshConfig", "Config"]
)
def test_config_dataclasses_equal_jax(name):
    pc, jc = getattr(port_config, name), getattr(jax_config, name)
    pf = [(f.name, f.default, f.default_factory) for f in dataclasses.fields(pc)]
    jf = [(f.name, f.default, f.default_factory) for f in dataclasses.fields(jc)]
    assert [f[0] for f in pf] == [f[0] for f in jf]
    assert dataclasses.asdict(pc()) == dataclasses.asdict(jc())
    assert port_config.ATTN_KERNELS == jax_config.ATTN_KERNELS
    assert port_config.TRAINABLE_ATTN_KERNELS == jax_config.TRAINABLE_ATTN_KERNELS


# every preset of the JAX package, so that one added there fails here until ported
@pytest.mark.parametrize("name", sorted(jax_config._PRESETS))
def test_presets_equal_jax(name):
    p, j = port_config.preset(name), jax_config.preset(name)
    for part in ("model", "data", "optim", "schedule", "eval", "mesh"):
        assert dataclasses.asdict(getattr(p, part)) == dataclasses.asdict(getattr(j, part))
    for f in ("seed", "batch_size_per_device", "output_dir", "save_every_epochs",
              "save_every_iters", "dump_every_iters", "bf16"):
        assert getattr(p, f) == getattr(j, f), f


def test_model_config_checks_attn_kernel():
    with pytest.raises(ValueError, match="unknown attn_kernel"):
        port_config.ModelConfig(attn_kernel="nope")
    with pytest.raises(ValueError, match="attention-dropout"):
        port_config.ModelConfig(fused_attention=True, attn_drop_rate=0.1)
