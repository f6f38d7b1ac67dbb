"""The port's ``VADModel`` in reconstruction mode under ``attn_kernel`` =
``fold_packed``, ``fold_mix`` and ``fold_block`` against the JAX ``VADModel``
built with the same ``attn_kernel``, on the CPU: the cases, helpers and bounds
of ``test_torch_port_fold_models.py``."""

import pytest
import torch

from test_torch_port_fold_models import KERNELS, _port_model, _reference, assert_outputs_match
from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("predict", [False], ids=["recon"])
@pytest.mark.parametrize("kernel", KERNELS)
def test_fold_variant_model_matches_jax(kernel, predict):
    variables, want, clip = _reference(kernel, predict)
    with torch.inference_mode():
        got = _port_model(variables, kernel, predict).eval()(torch.from_numpy(clip))
    assert got.recon.shape == (2, 1 if predict else 4, 56, 56, 3)
    assert_outputs_match(got, want)


