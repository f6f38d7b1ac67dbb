"""The port ``VADModel`` against the JAX one in reconstruction mode (the
``timedebd`` transposed conv, 4 output frames), fused config, and with the
cluster heads off or decoding encoder features (``use_cluster=False``,
``compactness=False``); tiny preset with depths (2, 2).  Same protocol and
bounds as test_torch_port_model.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_model import (
    assert_outputs_match,
    jax_reference,
    jax_unfused,
    port_model,
)
from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse)
from vadcl_tpu.core.config import preset as jax_preset
from vadcl_tpu.models.backbone import VADModel as JaxVADModel
from vadcl_tpu.train.checkpoint import flatten_state
from vadcl_tpu_torch.convert import load_state_dict_strict, state_dict_from_jax
from vadcl_tpu_torch.core.config import preset
from vadcl_tpu_torch.models import VADModel


@pytest.fixture(scope="module")
def recon_reference():
    return jax_reference(predict=False, fused=True, seed=1)


def test_fused_recon_model_matches_jax(recon_reference):
    variables, want, clip = recon_reference
    model = port_model(variables, predict=False, fused=True)
    with torch.inference_mode():
        got = model(torch.from_numpy(clip))
    assert got.recon.shape == (2, 4, 56, 56, 3)
    assert_outputs_match(got, want)


@pytest.mark.parametrize("kernel", ["base", "packed"])
def test_window_kernel_recon_model_matches_jax(recon_reference, kernel):
    """``attn_kernel="base"`` / ``"packed"`` in reconstruction mode against
    the JAX ``fold`` model and the JAX unfused model."""
    variables, want_fold, clip = recon_reference
    model = port_model(variables, predict=False, fused=True, attn_kernel=kernel)
    with torch.inference_mode():
        got = model(torch.from_numpy(clip))
    assert got.recon.shape == (2, 4, 56, 56, 3)
    assert_outputs_match(got, want_fold)
    assert_outputs_match(got, jax_unfused(variables, clip, predict=False))


@pytest.mark.parametrize("override", [{"use_cluster": False}, {"compactness": False}],
                         ids=["no_cluster", "no_compactness"])
def test_cluster_switches_match_jax(override):
    m = dataclasses.replace(jax_preset("tiny").model, predict=True, **override)
    clip = np.random.RandomState(2).rand(1, 4, 56, 56, 3).astype(np.float32)
    jm = JaxVADModel(config=m)
    variables = jax.jit(jm.init)(jax.random.key(2), jnp.asarray(clip))
    want = jax.jit(jm.apply)(variables, jnp.asarray(clip))
    model = VADModel(dataclasses.replace(preset("tiny").model, predict=True, **override))
    load_state_dict_strict(model, state_dict_from_jax(flatten_state(variables), predict=True))
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(clip))
    assert_outputs_match(got, want)
