"""The port's ``VADModel`` at a window-padded geometry under ``attn_kernel`` =
``fold_packed``, ``fold_mix`` and ``fold_block``, and every parameter
gradient through the whole-block kernels, against the JAX ``VADModel`` built
with the same ``attn_kernel``, on the CPU: the cases, helpers and bounds of
``test_torch_port_fold_models.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_fold_models import (
    KERNELS, _configs, _port_model, _reference, assert_outputs_match,
)
from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse)
from vadcl_tpu.models.backbone import VADModel as JaxVADModel
from vadcl_tpu.train.checkpoint import flatten_state
from vadcl_tpu_torch.convert import state_dict_from_jax


@pytest.mark.parametrize("kernel", KERNELS)
def test_fold_variant_model_at_padded_geometry_matches_jax(kernel):
    """At 64^2 every block's token grid needs window padding: plain LN1, pad,
    the fold kernel (packed under ``fold_packed``) without LN and residual,
    crop, plain residual, then the fused tail; ``fold_block`` is a ``fold``
    block there."""
    variables, want, clip = _reference(kernel, size=64)
    with torch.inference_mode():
        got = _port_model(variables, kernel, size=64).eval()(torch.from_numpy(clip))
    assert got.recon.shape == (2, 1, 64, 64, 3)
    assert_outputs_match(got, want)


def test_fold_block_model_gradients_match_jax():
    """Every parameter gradient through the whole-block kernels (on the CPU:
    their plain versions) against ``jax.grad`` of the JAX ``fold_block``
    model, whose backward is ``_fold_bwd_kernel`` with ``tail_refs``."""
    variables, _, clip = _reference("fold_block")
    probe = np.random.RandomState(6).randn(2, 1, 56, 56, 3).astype(np.float32)
    jm = JaxVADModel(config=_configs("fold_block")[0])
    extras = {k: v for k, v in variables.items() if k != "params"}

    def loss(params):
        o = jm.apply({"params": params, **extras}, jnp.asarray(clip))
        return jnp.sum(o.recon * probe) + o.cluster_loss + o.space_loss

    grads = jax.jit(jax.grad(loss))(variables["params"])
    model = _port_model(variables, "fold_block")
    out = model(torch.from_numpy(clip))
    ((out.recon * torch.from_numpy(probe)).sum() + out.cluster_loss + out.space_loss).backward()
    want = state_dict_from_jax(flatten_state({"params": grads}), predict=True)
    got = {k: p.grad for k, p in model.named_parameters()}
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k] is not None, f"{k}: no gradient"
        scale = float(w.abs().max())
        err = float((got[k] - w).abs().max())
        assert err <= 1e-8 + 2e-3 * scale, f"{k}: max abs err {err} > 2e-3 * {scale}"
