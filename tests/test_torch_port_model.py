"""The whole port ``VADModel`` against the JAX ``VADModel`` on the tiny
preset with depths (2, 2), so that shifted blocks occur (decoder stage 1 at
14^2), in prediction mode: the fused configs (``fold``, ``base`` or ``packed``
attention, LN->MLP tail, fused cluster heads) and the plain unfused config;
and the fused ``fold`` config at a geometry that needs window padding (64^2
input: 16^2 and 8^2 token grids against 7x7 windows), forward and gradients.

The JAX weights are carried across by ``convert.state_dict_from_jax``.  The
JAX fused reference runs its fold and MLP kernels in interpret mode and the
XLA cluster path (``tests/test_pallas_cluster.py`` shows it equal to the
fused cluster kernel).  The JAX model cannot run ``base`` or ``packed`` on the
CPU (its call sites pass no ``interpret``), so those two are held against the
JAX unfused model and the JAX ``fold`` model, which share their variables.
Bounds: recon atol 1e-4 (``test_reference_parity``),
cluster/space loss rtol 1e-4, hard labels identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse)
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


def port_model(variables, predict: bool, fused: bool, attn_kernel: str = "fold") -> VADModel:
    m = dataclasses.replace(
        preset("tiny").model, encoder_depths=(2, 2), decoder_depths=(2, 2),
        predict=predict, fused_attention=fused, fused_cluster=fused,
        attn_kernel=attn_kernel if fused else "base",
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


def jax_unfused(variables, clip, predict: bool):
    m = dataclasses.replace(
        jax_preset("tiny").model, encoder_depths=(2, 2), decoder_depths=(2, 2),
        predict=predict,
    )
    return jax.jit(JaxVADModel(config=m).apply)(variables, jnp.asarray(clip))


@pytest.mark.parametrize("kernel", ["base", "packed"])
def test_window_kernel_predict_model_matches_jax(predict_variables, kernel):
    """The partitioned-window route (kernel 7 or 9 in every block) against
    the JAX unfused model and the JAX ``fold`` model at the same variables."""
    variables, want_fold, clip = predict_variables
    model = port_model(variables, predict=True, fused=True, attn_kernel=kernel)
    with torch.inference_mode():
        got = model(torch.from_numpy(clip))
    assert got.recon.shape == (2, 1, 56, 56, 3)
    assert_outputs_match(got, jax_unfused(variables, clip, predict=True))
    assert_outputs_match(got, want_fold)


def _padded_configs():
    """(JAX model config, port model config): tiny widths, depths (2, 2),
    fused fold attention, 64^2 input (space head at 8^2)."""
    out = []
    for make in (jax_preset, preset):
        m = make("tiny").model
        out.append(dataclasses.replace(
            m, encoder_depths=(2, 2), decoder_depths=(2, 2), predict=True,
            fused_attention=True, attn_kernel="fold", fused_cluster=make is preset,
            cluster=dataclasses.replace(m.cluster, space_size=8),
        ))
    return out


@pytest.fixture(scope="module")
def padded_reference():
    """JAX ``fold`` model at the padded geometry: variables, outputs, and the
    gradient of sum(recon * probe) + cluster_loss + space_loss."""
    jcfg, _ = _padded_configs()
    rng = np.random.RandomState(3)
    clip = rng.rand(2, 4, 64, 64, 3).astype(np.float32)
    probe = rng.randn(2, 1, 64, 64, 3).astype(np.float32)
    jm = JaxVADModel(config=jcfg)
    variables = jax.jit(JaxVADModel(config=dataclasses.replace(
        jcfg, fused_attention=False)).init)(jax.random.key(3), jnp.asarray(clip))
    extras = {k: v for k, v in variables.items() if k != "params"}

    def loss(params):
        o = jm.apply({"params": params, **extras}, jnp.asarray(clip))
        return jnp.sum(o.recon * probe) + o.cluster_loss + o.space_loss, o

    (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(variables["params"])
    return variables, out, grads, clip, probe


def _padded_port_model(variables) -> VADModel:
    model = VADModel(_padded_configs()[1], torch.float32)
    load_state_dict_strict(model, state_dict_from_jax(flatten_state(variables), predict=True))
    return model


def test_fused_fold_model_at_padded_geometry_matches_jax(padded_reference):
    """A fused ``fold`` block whose token grid is not a multiple of the
    window runs plain LN1, pads, and runs the fold kernel without LN and
    residual, as the JAX package does."""
    variables, want, _, clip, _ = padded_reference
    with torch.inference_mode():
        got = _padded_port_model(variables).eval()(torch.from_numpy(clip))
    assert got.recon.shape == (2, 1, 64, 64, 3)
    assert_outputs_match(got, want)


def test_fused_fold_model_at_padded_geometry_gradients_match_jax(padded_reference):
    """Every parameter gradient through the padded route (kernel 6 without
    LN and residual) against ``jax.grad`` of the JAX ``fold`` model, each
    within 2e-3 of the JAX gradient's largest entry (the bound of
    ``test_torch_port_train.py``)."""
    variables, _, grads, clip, probe = padded_reference
    model = _padded_port_model(variables)
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


def test_fold_block_too_large_for_shared_memory_takes_the_window_route(monkeypatch):
    """Where ``fold_fits`` is false (a window whose block exceeds 227 KB of
    shared memory) a ``fold`` block runs the partitioned-window kernels:
    same output, kernel 7's Function in the graph."""
    from vadcl_tpu_torch.models import swin

    torch.manual_seed(0)
    x = torch.rand(1, 2, 14, 14, 32)
    block = swin.SwinBlock3D(32, 2, (2, 7, 7), (0, 3, 3), fused=True, attn_kernel="fold")
    block.attn.reset_parameters(torch.Generator().manual_seed(1))
    want = block(x)
    assert "LnMlp" in want.grad_fn.name()
    monkeypatch.setattr(swin, "fold_fits", lambda *a, **k: False)
    seen = []
    real = swin.window_attention_fused
    monkeypatch.setattr(swin, "window_attention_fused",
                        lambda *a, **k: seen.append(1) or real(*a, **k))
    got = block(x)
    assert seen == [1]
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), rtol=0, atol=1e-5)


def test_alternate_backbones_raise():
    """Every family of the JAX package builds (none is refused as unported:
    ``tests/test_torch_port_zoo.py`` holds them against JAX); what raises is
    an unknown family, and a ConvAE family built without the clip length
    its first conv takes."""
    m = dataclasses.replace(preset("tiny").model, backbone="unet3d")
    assert hasattr(VADModel(m), "unet3d")
    with pytest.raises(ValueError, match="unknown backbone"):
        VADModel(dataclasses.replace(m, backbone="resnet"))
    with pytest.raises(ValueError, match="needs input_frames"):
        VADModel(dataclasses.replace(m, backbone="convae"))
