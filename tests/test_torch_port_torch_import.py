"""The port's reference-checkpoint bridge (``vadcl_tpu_torch/train/torch_import.py``)
against the JAX package's (``vadcl_tpu/train/torch_import.py``).

The reference-keyed state dicts are built here, as ``tests/test_torch_import.py``
builds them (its ``_inverse_torch_name`` writes the name map backwards): the
flagship's whole key set (shapes from ``jax.eval_shape``), with and without
the DDP ``module.`` prefix, and the tiny preset's for a forward.  Bounds:
translated arrays equal, unmatched keys equal; the forward of the weights so
loaded, recon atol 1e-4 and cluster/space loss rtol 1e-4
(``tests/test_torch_port_model.py``'s); ``inflate_swin2d``'s resized tables
1e-6 of JAX's ``jax.image.resize``; the CLIs print the JAX CLIs' counts.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_import import _inverse_torch_name
from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse)
from vadcl_tpu.core.config import ModelConfig as JaxModelConfig
from vadcl_tpu.core.config import preset as jax_preset
from vadcl_tpu.models.backbone import VADModel as JaxVADModel
from vadcl_tpu.train import torch_import as jax_ti
from vadcl_tpu.train.checkpoint import _path_str
from vadcl_tpu.train.checkpoint import tolerant_merge as jax_tolerant_merge
from vadcl_tpu_torch.core.config import preset
from vadcl_tpu_torch.data import make_synthetic_dataset
from vadcl_tpu_torch.models import VADModel
from vadcl_tpu_torch.train import torch_import as port_ti
from vadcl_tpu_torch.train.torch_import import merge_reference_checkpoint


def reference_state(model_cfg, prefix: str = "", seed: int = 0, image: int = 224):
    """A reference-named, torch-layout state dict of ``model_cfg``'s every
    variable (random values), plus a constant buffer the translators skip
    and two keys they must report unmatched."""
    shapes = jax.eval_shape(JaxVADModel(config=model_cfg).init, jax.random.key(0),
                            jnp.zeros((1, 4, image, image, 3), jnp.float32))
    rng = np.random.RandomState(seed)
    state = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        key, to_torch = _inverse_torch_name(_path_str(path))
        shape = to_torch(tuple(leaf.shape))
        scale = 1.0 if key.endswith("running_var") else 0.05
        v = rng.randn(*shape).astype(np.float32) * scale
        state[prefix + key] = np.abs(v) + 0.5 if key.endswith("running_var") else v
    state[prefix + "cluster1.identity_matrix"] = np.eye(4, dtype=np.float32)
    state[prefix + "head.weight"] = np.zeros((2, 2), np.float32)
    state[prefix + "encoder.layers.0.blocks.0.attn.unknown"] = np.zeros(3, np.float32)
    return state


@pytest.mark.parametrize("prefix", ["", "module."])
@pytest.mark.parametrize("predict", [True, False])
def test_flagship_translation_equals_jax(prefix, predict):
    state = reference_state(JaxModelConfig(predict=True), prefix)
    want = jax_ti.translate_torch_state(state, predict=predict)
    got = port_ti.translate_torch_state(state, predict=predict)
    assert got[2] == want[2] == [prefix + "head.weight",
                                 prefix + "encoder.layers.0.blocks.0.attn.unknown"]
    for g, w in zip(got[:2], want[:2]):
        assert g.keys() == w.keys() and len(g) > 0
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _tiny(predict=True):
    jm = dataclasses.replace(jax_preset("tiny").model, predict=predict)
    pm = dataclasses.replace(preset("tiny").model, predict=predict)
    return jm, pm


@pytest.fixture(scope="module")
def tiny_pth(tmp_path_factory):
    """A reference-keyed tiny-preset ``.pth`` (DDP prefix, torch tensors)."""
    jm, _ = _tiny()
    state = reference_state(jm, "module.", seed=1, image=56)
    path = str(tmp_path_factory.mktemp("ref") / "ref.pth")
    torch.save({k: torch.from_numpy(v) for k, v in state.items()}, path)
    return path


def _jax_loaded(jm, path):
    variables = jax.jit(JaxVADModel(config=jm).init)(
        jax.random.key(0), jnp.zeros((1, 4, 56, 56, 3), jnp.float32))
    params, stats, unmatched = jax_ti.load_reference_checkpoint(path)
    flat = {f"params/{k}": v for k, v in params.items()}
    flat.update({f"batch_stats/{k}": v for k, v in stats.items()})
    variables, hits, misses = jax_tolerant_merge(variables, flat)
    return variables, hits, misses, unmatched


def test_reference_weights_forward_equals_jax(tiny_pth):
    """The same ``.pth`` loaded into each package: every leaf matched in
    both (the same hits, misses and unmatched keys), and the forwards
    agree within the model parity bounds."""
    jm, pm = _tiny()
    variables, jhits, jmisses, junmatched = _jax_loaded(jm, tiny_pth)
    model = VADModel(pm, torch.float32)
    hits, misses, unmatched = merge_reference_checkpoint(model, tiny_pth)
    assert hits == sorted(jhits) and misses == sorted(jmisses) == []
    assert unmatched == junmatched == ["module.head.weight",
                                       "module.encoder.layers.0.blocks.0.attn.unknown"]
    clip = np.random.RandomState(2).rand(2, 4, 56, 56, 3).astype(np.float32)
    want = jax.jit(JaxVADModel(config=jm).apply)(variables, jnp.asarray(clip))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(clip))
    np.testing.assert_allclose(got.recon.numpy(), np.asarray(want.recon), rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(got.cluster_loss), float(want.cluster_loss), rtol=1e-4)
    np.testing.assert_allclose(float(got.space_loss), float(want.space_loss), rtol=1e-4)


def _swin2d(window: int, heads=(3, 6), stages: int = 4, seed: int = 0):
    """An upstream 2D Swin state dict (``layers.{i}.blocks.{j}...``) of
    window ``window``, with PatchMerging, head and norm keys."""
    rng = np.random.RandomState(seed)
    side, c = 2 * window - 1, 96
    s = {"patch_embed.proj.weight": rng.randn(c, 3, 4, 4).astype(np.float32),
         "patch_embed.proj.bias": rng.randn(c).astype(np.float32),
         "head.weight": rng.randn(10, c).astype(np.float32), "norm.weight": np.ones(c, np.float32)}
    for i in range(stages):
        nh = heads[min(i, len(heads) - 1)]
        b = f"layers.{i}.blocks.0."
        s[b + "attn.relative_position_bias_table"] = (
            rng.randn(side * side, nh).astype(np.float32) * 0.02)
        s[b + "attn.relative_position_index"] = np.zeros((window ** 2,) * 2, np.int64)
        s[b + "attn.qkv.weight"] = rng.randn(3 * c, c).astype(np.float32)
        s[b + "norm1.weight"] = rng.randn(c).astype(np.float32)
        s[b + "mlp.fc2.bias"] = rng.randn(c).astype(np.float32)
        s[f"layers.{i}.downsample.reduction.weight"] = rng.randn(2 * c, 4 * c).astype(np.float32)
    return s


@pytest.mark.parametrize("src_window,dst_window", [(12, 7), (7, 12), (7, 7)],
                         ids=["shrink_23_to_13", "grow_13_to_23", "same"])
def test_inflate_swin2d_equals_jax(src_window, dst_window):
    """A window-12 table (23^2 entries) shrunk to window 7 (13^2), a
    window-7 table grown to window 12, and an unchanged one: every output
    array within 1e-6 of JAX's, the same keys and the same skips."""
    state = _swin2d(src_window)
    kw = dict(window_size=(8, dst_window, dst_window), patch_size=(2, 4, 4), num_stages=2)
    want = jax_ti.inflate_swin2d(state, **kw)
    got = port_ti.inflate_swin2d(state, **kw)
    assert got.keys() == want.keys()
    assert not any(re.search(r"stage[23]|downsample|head|/norm/", k) for k in got)
    tables = [k for k in got if k.endswith("relative_position_bias_table")]
    assert len(tables) == 2
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=0, atol=1e-6, err_msg=k)
    assert got[tables[0]].shape == ((2 * 8 - 1) * (2 * dst_window - 1) ** 2, 3)


def test_resize_bicubic_is_not_torch_bicubic():
    """The port resizes as JAX does (Keys a = -0.5, antialiased shrink),
    which torch's ``interpolate(mode="bicubic")`` (a = -0.75) does not."""
    grid = np.random.RandomState(3).randn(23, 23, 2).astype(np.float32) * 0.02
    want = np.asarray(jax.image.resize(jnp.asarray(grid), (13, 13, 2), method="bicubic"))
    np.testing.assert_allclose(port_ti.resize_bicubic(grid, (13, 13)), want, rtol=0, atol=1e-6)
    other = torch.nn.functional.interpolate(torch.from_numpy(grid).permute(2, 0, 1)[None],
                                            size=(13, 13), mode="bicubic")[0].permute(1, 2, 0)
    assert np.abs(other.numpy() - want).max() > 1e-4


def test_torch_ckpt_through_both_clis(tiny_pth, tmp_path, capsys):
    """``--torch-ckpt`` in ``tools/evaluate_torch.py`` and
    ``tools/export_torch.py`` at the tiny preset on the CPU: the counts the
    JAX CLIs print, a score curve and an artifact."""
    from tools import evaluate_torch, export_torch

    jm, _ = _tiny()
    _, hits, misses, unmatched = _jax_loaded(jm, tiny_pth)
    _, test_dir, label_dir = make_synthetic_dataset(
        str(tmp_path / "data"), num_train_videos=1, num_test_videos=2, frames_per_video=8,
        size=56)
    auc = evaluate_torch.main(["--preset", "tiny", "--predict", "--torch-ckpt", tiny_pth,
                               "--test-data-path", test_dir, "--label-path", label_dir,
                               "--device", "cpu", "--batch-windows", "4",
                               "--out", str(tmp_path / "scores.npz")])
    out = capsys.readouterr().out
    assert (f"translated torch ckpt: {len(hits)} loaded, {len(misses)} kept, "
            f"{len(unmatched)} unmatched torch keys") in out
    assert 0.0 <= auc <= 1.0 and (tmp_path / "scores.npz").exists()
    export_torch.main(["--preset", "tiny", "--predict", "--torch-ckpt", tiny_pth,
                       "--out", str(tmp_path / "art"), "--device", "cpu",
                       "--batch-windows", "2", "--check"])
    out = capsys.readouterr().out
    assert f"translated torch ckpt: {len(hits)} loaded, {len(misses)} kept\n" in out
    assert "reload check" in out and (tmp_path / "art" / "scorer.pt2").exists()
