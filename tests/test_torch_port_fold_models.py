"""The port's ``VADModel`` under ``attn_kernel`` = ``fold_packed``,
``fold_mix`` and ``fold_block`` against the JAX ``VADModel`` built with the
same ``attn_kernel``, on the CPU, and the routes a Swin block takes under
each name.

Tiny preset with depths (2, 2), so that shifted blocks occur; prediction and
reconstruction mode, and a 64^2 input whose 16^2 and 8^2 token grids need
window padding against the 7x7 windows.  The JAX weights are carried across
by ``convert.state_dict_from_jax``.  The JAX models run their fold kernels
(``_fold_packed_kernel``, ``_fold_kernel`` with and without ``tail=``) and
``fused_ln_mlp`` in interpret mode and the XLA cluster path
(``tests/test_pallas_cluster.py`` shows it equal to the fused cluster
kernel); the port runs its kernels' plain versions.  The tiny preset has at
most 4 heads, where ``fold_mix`` is ``fold``; a wider variant with 12 heads
in its inner stages drives ``fold_mix``'s packed branch.

Bounds: recon atol 1e-4 (``test_reference_parity``), cluster/space loss rtol
1e-4, hard labels identical, gradients within 2e-3 of the JAX gradient's
largest entry (the bound of ``test_torch_port_train.py``).

This file holds the prediction-mode models and the routes; the
reconstruction-mode models are in ``test_torch_port_fold_models_recon.py``,
the window-padded geometry and the ``fold_block`` gradients in
``test_torch_port_fold_models_padded.py``, on this file's helpers (each file
builds its JAX references once).
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
from vadcl_tpu.models.swin import _resolve_attn_kernel
from vadcl_tpu.train.checkpoint import flatten_state
from vadcl_tpu_torch.convert import load_state_dict_strict, state_dict_from_jax
from vadcl_tpu_torch.core.config import preset
from vadcl_tpu_torch.models import VADModel, swin

KERNELS = ("fold_packed", "fold_mix", "fold_block")


def _configs(attn_kernel, predict=True, size=56, wide=False):
    """(JAX model config, port model config) of one fused model."""
    out = []
    for make in (jax_preset, preset):
        m = make("tiny").model
        m = dataclasses.replace(
            m, encoder_depths=(2, 2), decoder_depths=(2, 2), predict=predict,
            fused_attention=True, attn_kernel=attn_kernel, fused_cluster=make is preset,
            cluster=dataclasses.replace(m.cluster, space_size=size // 8),
        )
        if wide:  # 12 heads of width 8 in the inner stages: fold_mix's packed branch
            m = dataclasses.replace(m, embed_dim=48, encoder_heads=(2, 12),
                                    decoder_heads=(12, 2))
        out.append(m)
    return out


_REFERENCES = {}


def _reference(attn_kernel, predict=True, size=56, wide=False):
    """JAX variables (initialised unfused: the tree does not depend on the
    kernel), the JAX model's output under ``attn_kernel``, and the clip."""
    key = (attn_kernel, predict, size, wide)
    if key not in _REFERENCES:
        jcfg, _ = _configs(attn_kernel, predict, size, wide)
        clip = np.random.RandomState(5).rand(2, 4, size, size, 3).astype(np.float32)
        vkey = ("variables", predict, size, wide)
        if vkey not in _REFERENCES:
            _REFERENCES[vkey] = jax.jit(JaxVADModel(config=dataclasses.replace(
                jcfg, fused_attention=False)).init)(jax.random.key(5), jnp.asarray(clip))
        variables = _REFERENCES[vkey]
        out = jax.jit(JaxVADModel(config=jcfg).apply)(variables, jnp.asarray(clip))
        _REFERENCES[key] = (variables, out, clip)
    return _REFERENCES[key]


def _port_model(variables, attn_kernel, predict=True, size=56, wide=False) -> VADModel:
    model = VADModel(_configs(attn_kernel, predict, size, wide)[1], torch.float32)
    load_state_dict_strict(model, state_dict_from_jax(flatten_state(variables), predict=predict))
    return model


def assert_outputs_match(got, want):
    np.testing.assert_allclose(got.recon.numpy(), np.asarray(want.recon), rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(got.cluster_loss), float(want.cluster_loss), rtol=1e-4)
    np.testing.assert_allclose(float(got.space_loss), float(want.space_loss), rtol=1e-4)
    np.testing.assert_array_equal(got.feature_label.numpy(), np.asarray(want.feature_label))
    np.testing.assert_allclose(got.feature.numpy(), np.asarray(want.feature), rtol=0, atol=1e-4)


@pytest.mark.parametrize("predict", [True], ids=["predict"])
@pytest.mark.parametrize("kernel", KERNELS)
def test_fold_variant_model_matches_jax(kernel, predict):
    variables, want, clip = _reference(kernel, predict)
    with torch.inference_mode():
        got = _port_model(variables, kernel, predict).eval()(torch.from_numpy(clip))
    assert got.recon.shape == (2, 1 if predict else 4, 56, 56, 3)
    assert_outputs_match(got, want)


def test_fold_mix_model_with_twelve_heads_matches_jax(monkeypatch):
    """With 12 heads in the inner stages ``fold_mix`` runs the packed fold
    kernel there and the fold kernel in the outer stages, as the JAX model."""
    variables, want, clip = _reference("fold_mix", wide=True)
    calls = {"fold_attention": 0, "fold_attention_packed": 0}
    for name in calls:
        real = getattr(swin, name)

        def counted(*a, _name=name, _real=real, **k):
            calls[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(swin, name, counted)
    with torch.inference_mode():
        got = _port_model(variables, "fold_mix", wide=True).eval()(torch.from_numpy(clip))
    assert calls == {"fold_attention": 4, "fold_attention_packed": 4}
    assert_outputs_match(got, want)


@pytest.mark.parametrize("name, heads, want", [
    ("fold_mix", 6, "fold"), ("fold_mix", 11, "fold"), ("fold_mix", 12, "fold_packed"),
    ("fold_mix", 24, "fold_packed"), ("fold_packed", 2, "fold_packed"),
    ("fold_block", 12, "fold_block"), ("fold", 12, "fold"), ("base", 12, "base"),
])
def test_attn_kernel_resolution_per_num_heads(name, heads, want):
    assert swin.resolve_attn_kernel(name, heads) == want == _resolve_attn_kernel(name, heads)


def _block(attn_kernel, heads=2, dim=32):
    torch.manual_seed(0)
    block = swin.SwinBlock3D(dim, heads, (2, 7, 7), (0, 3, 3), fused=True,
                             attn_kernel=attn_kernel)
    gen = torch.Generator().manual_seed(1)
    block.attn.reset_parameters(gen)
    for lin in (block.mlp.fc1, block.mlp.fc2):
        with torch.no_grad():
            lin.weight.copy_(torch.randn(lin.weight.shape, generator=gen) * 0.1)
    return block


def _spy(monkeypatch, *names):
    seen = []
    for name in names:
        real = getattr(swin, name)
        monkeypatch.setattr(swin, name, lambda *a, _n=name, _r=real, **k: (
            seen.append(_n), _r(*a, **k))[1])
    return seen


ROUTE_FNS = ("fold_attention", "fold_attention_packed", "fold_block", "ln_mlp",
             "window_attention_fused", "window_attention_packed")


@pytest.mark.parametrize("kernel, heads, dim, route", [
    ("fold", 2, 32, ["fold_attention", "ln_mlp"]),
    ("fold_packed", 2, 32, ["fold_attention_packed", "ln_mlp"]),
    ("fold_mix", 2, 32, ["fold_attention", "ln_mlp"]),
    ("fold_mix", 12, 96, ["fold_attention_packed", "ln_mlp"]),
    ("fold_block", 2, 32, ["fold_block"]),
])
def test_block_route_where_everything_fits(monkeypatch, kernel, heads, dim, route):
    """Which wrappers one fused Swin block calls, in order: under
    ``fold_block`` the whole-block kernel alone (no tail kernel after it)."""
    x = torch.rand(1, 2, 14, 14, dim)
    want = _block("fold", heads, dim)(x)
    seen = _spy(monkeypatch, *ROUTE_FNS)
    got = _block(kernel, heads, dim)(x)
    assert seen == route
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), rtol=0, atol=2e-5)


@pytest.mark.parametrize("kernel, heads, dim", [("fold_packed", 2, 32), ("fold_mix", 12, 96)])
def test_packed_fold_that_does_not_fit_takes_kernel_7(monkeypatch, kernel, heads, dim):
    """Where kernel 10 does not fit, a ``fold_packed`` (or ``fold_mix``)
    block takes the partitioned route, which tests the configured name: it is
    not ``"packed"``, so kernel 7's Function is in the graph, not kernel 9."""
    x = torch.rand(1, 2, 14, 14, dim)
    block = _block(kernel, heads, dim)
    want = block(x)
    monkeypatch.setattr(swin, "fold_packed_fits", lambda *a, **k: False)
    seen = _spy(monkeypatch, *ROUTE_FNS)
    got = block(x)
    assert seen == ["window_attention_fused", "ln_mlp"]
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), rtol=0, atol=2e-5)
    (got * torch.rand(got.shape)).sum().backward()  # kernel 7 is trainable; 9 would raise
    assert block.attn.qkv_weight.grad is not None


def test_whole_block_that_does_not_fit_is_a_fold_block(monkeypatch):
    """Where ``fold_block_fits`` is false a ``fold_block`` block runs kernel A
    then kernel B, and where the fold kernel does not fit either, kernel 7
    then kernel B: ``fold``'s routes, same output and gradients."""
    x = torch.rand(1, 2, 14, 14, 32)
    probe = torch.rand(1, 2, 14, 14, 32)
    block = _block("fold_block")
    want = block(x)
    (want * probe).sum().backward()
    want_grads = {k: p.grad.clone() for k, p in block.named_parameters()}
    assert "FoldBlock" in want.grad_fn.name()
    for fits, route in ((("fold_block_fits",), ["fold_attention", "ln_mlp"]),
                        (("fold_block_fits", "fold_fits"), ["window_attention_fused", "ln_mlp"])):
        with monkeypatch.context() as mp:
            for f in fits:
                mp.setattr(swin, f, lambda *a, **k: False)
            seen = _spy(mp, *ROUTE_FNS)
            block.zero_grad()
            got = block(x)
            (got * probe).sum().backward()
        assert seen == route
        np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), rtol=0,
                                   atol=2e-5)
        for k, p in block.named_parameters():
            scale = float(want_grads[k].abs().max())
            assert float((p.grad - want_grads[k]).abs().max()) <= 1e-4 * scale + 1e-8, k


def test_no_attention_kernel_of_the_reference_is_refused():
    """Every ``attn_kernel`` the JAX package accepts builds a fused port
    model; none raises "not ported"."""
    from vadcl_tpu.core.config import ATTN_KERNELS as JAX_ATTN_KERNELS
    from vadcl_tpu_torch.core.config import ATTN_KERNELS

    assert set(ATTN_KERNELS) == set(JAX_ATTN_KERNELS)
    assert not hasattr(swin, "_UNPORTED_ATTN") and not hasattr(swin, "check_attn_kernel")
    for kernel in sorted(ATTN_KERNELS):
        m = dataclasses.replace(preset("tiny").model, fused_attention=True, attn_kernel=kernel)
        assert VADModel(m).config.attn_kernel == kernel
