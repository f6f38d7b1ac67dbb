"""The whole port ``VADModel`` against the JAX ``VADModel`` on the tiny
preset with depths (2, 2), so that shifted blocks occur (decoder stage 1 at
14^2), in prediction mode: the fused config (fold attention, LN->MLP tail,
fused cluster heads) and the plain unfused config.

The JAX weights are carried across by ``convert.state_dict_from_jax``.  The
JAX fused reference runs its fold and MLP kernels in interpret mode and the
XLA cluster path (``tests/test_pallas_cluster.py`` shows it equal to the
fused cluster kernel).  Bounds: recon atol 1e-4 (``test_reference_parity``),
cluster/space loss rtol 1e-4, hard labels identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vadcl_tpu.core.config import preset as jax_preset
from vadcl_tpu.models.backbone import VADModel as JaxVADModel
from vadcl_tpu.train.checkpoint import flatten_state
from vadcl_tpu_torch.convert import load_state_dict_strict, state_dict_from_jax
from vadcl_tpu_torch.core.config import preset
from vadcl_tpu_torch.models import VADModel


def jax_reference(predict: bool, fused: bool, seed: int = 0):
    """(JAX variables, JAX output, input clip) at the tiny (2, 2) geometry."""
    m = dataclasses.replace(
        jax_preset("tiny").model, encoder_depths=(2, 2), decoder_depths=(2, 2),
        predict=predict, fused_attention=False, fused_cluster=False,
    )
    clip = np.random.RandomState(seed).rand(2, 4, 56, 56, 3).astype(np.float32)
    x = jnp.asarray(clip)
    variables = jax.jit(JaxVADModel(config=m).init)(jax.random.key(seed), x)
    run = dataclasses.replace(m, fused_attention=fused, attn_kernel="fold" if fused else "base")
    out = jax.jit(JaxVADModel(config=run).apply)(variables, x)
    return variables, out, clip


def port_model(variables, predict: bool, fused: bool) -> VADModel:
    m = dataclasses.replace(
        preset("tiny").model, encoder_depths=(2, 2), decoder_depths=(2, 2),
        predict=predict, fused_attention=fused, fused_cluster=fused,
        attn_kernel="fold" if fused else "base",
    )
    model = VADModel(m, torch.float32)
    sd = state_dict_from_jax(flatten_state(variables), predict=predict)
    load_state_dict_strict(model, sd)
    return model.eval()


def assert_outputs_match(got, want):
    np.testing.assert_allclose(got.recon.numpy(), np.asarray(want.recon), rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(got.cluster_loss), float(want.cluster_loss), rtol=1e-4)
    np.testing.assert_allclose(float(got.space_loss), float(want.space_loss), rtol=1e-4)
    np.testing.assert_array_equal(got.feature_label.numpy(), np.asarray(want.feature_label))
    np.testing.assert_allclose(got.feature.numpy(), np.asarray(want.feature), rtol=0, atol=1e-4)


@pytest.fixture(scope="module")
def predict_variables():
    return jax_reference(predict=True, fused=True)


def test_fused_fold_predict_model_matches_jax(predict_variables):
    variables, want, clip = predict_variables
    model = port_model(variables, predict=True, fused=True)
    with torch.inference_mode():
        got = model(torch.from_numpy(clip))
    assert got.recon.shape == (2, 1, 56, 56, 3)
    assert got.cluster_assign is None and got.space_assign is None
    assert_outputs_match(got, want)


def test_unfused_predict_model_matches_jax(predict_variables):
    variables, _, clip = predict_variables
    m = dataclasses.replace(
        jax_preset("tiny").model, encoder_depths=(2, 2), decoder_depths=(2, 2),
        predict=True,
    )
    want = jax.jit(JaxVADModel(config=m).apply)(variables, jnp.asarray(clip))
    model = port_model(variables, predict=True, fused=False)
    with torch.inference_mode():
        got = model(torch.from_numpy(clip))
    assert_outputs_match(got, want)
    np.testing.assert_allclose(
        got.cluster_assign.numpy(), np.asarray(want.cluster_assign), rtol=0, atol=1e-5
    )


def test_fused_and_unfused_port_agree(predict_variables):
    variables, _, clip = predict_variables
    x = torch.from_numpy(clip)
    with torch.inference_mode():
        a = port_model(variables, predict=True, fused=True)(x)
        b = port_model(variables, predict=True, fused=False)(x)
    np.testing.assert_allclose(a.recon.numpy(), b.recon.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(a.feature_label.numpy(), b.feature_label.numpy())


@pytest.mark.parametrize("kernel", ["base", "packed", "fold_block", "fold_packed", "fold_mix"])
def test_unported_attention_kernels_raise(kernel):
    m = dataclasses.replace(preset("tiny").model, fused_attention=True, attn_kernel=kernel)
    with pytest.raises(NotImplementedError, match="not ported"):
        VADModel(m)


def test_fused_geometry_needing_window_padding_raises():
    m = dataclasses.replace(
        preset("tiny").model, fused_attention=True, attn_kernel="fold",
        cluster=dataclasses.replace(preset("tiny").model.cluster, space_size=8),
    )
    model = VADModel(m)
    with pytest.raises(NotImplementedError, match="window padding"):
        model(torch.rand(1, 4, 64, 64, 3))  # 16x16 latent: not a multiple of 7


def test_alternate_backbones_raise():
    m = dataclasses.replace(preset("tiny").model, backbone="unet3d")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        VADModel(m)
