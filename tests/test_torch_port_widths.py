"""Fused widths above 192: kernel B's body choice, kernel C's instances, and
fused models whose Swin tails and cluster head run at C = 256 (and at 896),
against the JAX package on the CPU.

Kernel B (``ln_mlp``) runs its wgmma body in bf16 at C % 16 == 0, C <= 192
and a hidden width divisible by 128, its slab body
(``csrc/ln_mlp_slab.cu``) in bf16 at C % 16 == 0, 192 < C <= 1024 and a
hidden width divisible by 64, and its CUDA-core body
(``csrc/ln_mlp.cu:ln_mlp_kernel``, the same cast boundaries) at every other
width; ``mlp_fwd_body`` is that choice.  Kernel C (``cluster_assign``) takes
C up to 768 in one block a row tile through the instances of
``csrc/cluster_mma.cu:kCaShapes``, mirrored by ``cluster_assign_shape``, and
wider C over a cluster of 2, 4 or 8 blocks; the instances above 384 take
16-center chunks, whose arithmetic ``tests/test_torch_port_cluster_mma.py``'s
emulation repeats here at C = 256 and 384.  The kernels run only on the
card (``chip_smoke.py``'s ``phase_width_kernels`` holds them against their
plain versions there).  ``tests/test_torch_port_every_width.py`` sweeps
every width up to 2048.

The model is the tiny preset fused (``attn_kernel="fold"``) at
``embed_dim`` 128 with encoder heads (4, 8) and decoder heads (8, 4): head
width 32, C = 128 in the outer stages and 256 in the inner ones (two blocks
each, so one of them shifted) and the feature head; one 56^2 clip.  It is held against the JAX ``VADModel`` with the same
weights (its fold kernels and ``fused_ln_mlp`` in interpret mode, the XLA
cluster path), forward and every parameter gradient, at the bounds of
``tests/test_torch_port_fold_models.py``: recon atol 1e-4, cluster and space
loss rtol 1e-4, hard labels identical, gradients within 2e-3 of the JAX
gradient's largest entry (fp32: summation order only).
"""

import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_cluster_mma import _check, _inputs, cluster_assign_tf32x3_emulation
from test_torch_port_fold_models import assert_outputs_match
from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse)
from vadcl_tpu.core.config import preset as jax_preset
from vadcl_tpu.models.backbone import VADModel as JaxVADModel
from vadcl_tpu.train.checkpoint import flatten_state, unflatten_into
from vadcl_tpu_torch.convert import jax_from_state_dict, state_dict_from_jax
from vadcl_tpu_torch.core.config import preset
from vadcl_tpu_torch.models import VADModel
from test_torch_port_every_width import check_tiny_model_matches_jax
from vadcl_tpu_torch.ops.cluster_kernels import (
    CLUSTER_BLOCK_C,
    CLUSTER_MAX_C,
    CLUSTER_SHAPES,
    cluster_assign_blocks,
    cluster_assign_plain,
    cluster_assign_shape,
)
from vadcl_tpu_torch.ops.fold_attn import SMEM_LIMIT
from vadcl_tpu_torch.ops.ln_mlp import mlp_fwd_body, mlp_fwd_smem_bytes, mlp_fwd_tokens

T = torch.from_numpy
CSRC = Path(__file__).resolve().parent.parent / "vadcl_tpu_torch" / "csrc"


@pytest.mark.parametrize("c, ch, dtype, body", [
    (96, 384, torch.bfloat16, "wgmma"), (192, 768, torch.bfloat16, "wgmma"),
    (128, 512, torch.bfloat16, "wgmma"), (16, 128, torch.bfloat16, "wgmma"),
    (256, 1024, torch.bfloat16, "slab"), (100, 400, torch.bfloat16, "tiles"),
    (24, 96, torch.bfloat16, "tiles"), (96, 192, torch.bfloat16, "tiles"),
    (96, 384, torch.float32, "tiles"), (768, 3072, torch.bfloat16, "slab"),
    (30, 120, torch.float32, "tiles"),
])
def test_mlp_forward_body_by_width(c, ch, dtype, body):
    """The tensor-core bodies where they take the width, the CUDA-core body at
    every other width and in fp32: no width the JAX package runs is refused."""
    assert mlp_fwd_body(c, ch, dtype) == body


def test_mlp_forward_body_refuses_only_above_shared_memory():
    """Above C = 844, where 32 tokens' fp32 rows outgrow the CUDA-core body's
    block, that body takes 16 tokens (8, ... 1 wider still) and bf16 at
    C % 16 == 0 up to 1024 takes the slab body: C = 848, which raised
    before, runs on both; the block's size mirrors the source's layout, and
    only above C = 28,992, where one token's rows do not fit, does the
    choice raise."""
    consts = {name: int(v) for name, v in re.findall(
        r"constexpr int (kTokens|kMlpChunk) = (\d+);",
        (CSRC / "ln_mlp.cu").read_text() + (CSRC / "mlp_tail.cuh").read_text())}
    assert consts == {"kTokens": 32, "kMlpChunk": 128}
    assert mlp_fwd_smem_bytes(256) == 4 * (2 * 32 * 256 + 32 * 128) == 81920
    assert mlp_fwd_smem_bytes(844) <= SMEM_LIMIT and mlp_fwd_tokens(844) == 32
    assert mlp_fwd_smem_bytes(848) == 4 * (2 * 16 * 848 + 16 * 128) <= SMEM_LIMIT
    assert mlp_fwd_tokens(848) == 16
    assert mlp_fwd_body(848, 3392, torch.bfloat16) == "slab"
    assert mlp_fwd_body(848, 3392, torch.float32) == "tiles"
    assert mlp_fwd_body(850, 3400, torch.bfloat16) == "tiles"
    with pytest.raises(NotImplementedError, match="shared memory"):
        mlp_fwd_body(28993, 4 * 28993, torch.bfloat16)


def _ca_smem(nt, parts, chunk, stages):
    """csrc/cluster_mma.cu:ca_smem_bytes plus the kernel's static arrays."""
    stride = 8 * nt + 4
    return (4 * (2 * 16 * (4 // parts) * stride + stages * (2 * chunk * stride + chunk))
            + 4 * (64 + 4) + 16 * stages)


def test_cluster_instances_agree_with_the_source():
    """``CLUSTER_SHAPES`` is the source's table; every instance fits 227 KB
    and keeps the recon accumulator at 24 channel tiles a warp or fewer (the
    registers of the widest instance before)."""
    text = (CSRC / "cluster_mma.cu").read_text()
    table = text[text.index("kCaShapes[] = {"):text.index("};", text.index("kCaShapes[] = {"))]
    shapes = tuple(tuple(int(v) for v in m) for m in
                   re.findall(r"\{(\d+), (\d+), (\d+), (\d+)\}", table))
    assert shapes == CLUSTER_SHAPES
    for nt, parts, chunk, stages in shapes:
        assert _ca_smem(nt, parts, chunk, stages) <= SMEM_LIMIT
        assert nt % parts == 0 and nt // parts <= 24 and chunk in (16, 32)
    assert shapes[:6] == tuple((nt, 1, 32, 2) for nt in (2, 4, 8, 12, 16, 24))


@pytest.mark.parametrize("c, shape", [
    (1, (2, 1, 32, 2)), (30, (4, 1, 32, 2)), (192, (24, 1, 32, 2)), (193, (32, 2, 32, 2)),
    (256, (32, 2, 32, 2)), (384, (48, 2, 16, 2)), (512, (64, 4, 16, 2)),
    (768, (96, 4, 16, 1)),
])
def test_cluster_instance_by_width(c, shape):
    assert cluster_assign_shape(c) == shape


def test_cluster_refuses_only_above_768():
    """C = 769, which raised before, splits its channels over two blocks of
    385 on the 64-tile instance; one block a row tile holds 768 at most, and
    the split takes C up to 6144 (eight blocks), above which it raises."""
    assert CLUSTER_BLOCK_C == 768 and CLUSTER_MAX_C == 6144
    assert cluster_assign_blocks(768) == 1 and cluster_assign_blocks(769) == 2
    assert cluster_assign_shape(769) == (64, 4, 16, 2)
    with pytest.raises(ValueError, match="6144"):
        cluster_assign_shape(6145)


@pytest.mark.parametrize("c", [256, 384])
def test_cluster_emulation_at_wide_widths_matches_plain(c):
    """The body's arithmetic at C = 256 (32-center chunks) and 384 (16-center
    chunks), K = 1024, against the plain version at ``chip_smoke.py``'s
    bounds (recon, loss; labels wherever the top-2 gap is decided)."""
    x, cen = _inputs(256, c, 1024, c)
    got = cluster_assign_tf32x3_emulation(T(x), T(cen), 16.0)
    _check(got, cluster_assign_plain(T(x), T(cen), 16.0), T(x), T(cen), all_labels=False)


# --- the fused model at embed_dim 128 ------------------------------------------

SIZE = 56


def _configs():
    """(JAX, port) model configs: the tiny preset, fused, head width 32 at
    C = 128 and 256."""
    out = []
    for make in (jax_preset, preset):
        m = make("tiny").model
        out.append(dataclasses.replace(
            m, embed_dim=128, encoder_heads=(4, 8), decoder_heads=(8, 4),
            encoder_depths=(1, 2), decoder_depths=(2, 1), predict=True, fused_attention=True,
            attn_kernel="fold", fused_cluster=make is preset,
            cluster=dataclasses.replace(m.cluster, space_size=SIZE // 8)))
    return out


@pytest.fixture(scope="module")
def reference():
    """A seeded port model, its weights carried into the JAX variable tree
    (``convert.jax_from_state_dict``), the clip, a probe of the recon, and
    the JAX model's outputs and parameter gradients."""
    jcfg, pcfg = _configs()
    model = VADModel(pcfg, torch.float32, torch.Generator().manual_seed(12))
    clip = np.random.RandomState(12).rand(1, 4, SIZE, SIZE, 3).astype(np.float32)
    probe = np.random.RandomState(13).randn(1, 1, SIZE, SIZE, 3).astype(np.float32)
    jm = JaxVADModel(config=jcfg)
    template = jax.eval_shape(jm.init, jax.random.key(0), jnp.asarray(clip))
    variables = unflatten_into(template, jax_from_state_dict(model.state_dict(), predict=True))
    extras = {k: v for k, v in variables.items() if k != "params"}

    def loss(params):
        o = jm.apply({"params": params, **extras}, jnp.asarray(clip))
        return jnp.sum(o.recon * probe) + o.cluster_loss + o.space_loss, o

    (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(variables["params"])
    return model, clip, probe, out, state_dict_from_jax(flatten_state({"params": grads}),
                                                        predict=True)


def test_wide_fused_model_widths():
    """The model's Swin tails run at C = 128 and 256 and its feature head at
    256: the wgmma MLP body in the outer stages, the slab body in the inner
    stages in bf16 (the CUDA-core one in fp32), and kernel C's two-part
    instance."""
    _, pcfg = _configs()
    widths = {pcfg.embed_dim * 2 ** i for i in range(len(pcfg.encoder_depths))}
    assert widths == {128, 256}
    assert mlp_fwd_body(128, 512, torch.bfloat16) == "wgmma"
    assert mlp_fwd_body(256, 1024, torch.bfloat16) == "slab"
    assert mlp_fwd_body(256, 1024, torch.float32) == "tiles"
    assert cluster_assign_shape(256) == (32, 2, 32, 2)


def test_wide_fused_model_matches_jax(reference):
    """Forward outputs and every parameter gradient of the embed_dim 128
    model against the JAX model (see the module docstring for the bounds)."""
    model, clip, probe, want, want_grads = reference
    out = model(T(clip))
    assert out.recon.shape == (1, 1, SIZE, SIZE, 3)
    assert_outputs_match(type(out)(*(v.detach() if isinstance(v, torch.Tensor) else v
                                     for v in out)), want)
    ((out.recon * T(probe)).sum() + out.cluster_loss + out.space_loss).backward()
    got = {k: p.grad for k, p in model.named_parameters()}
    assert set(got) == set(want_grads)
    for k, w in want_grads.items():
        assert got[k] is not None, f"{k}: no gradient"
        scale = float(w.abs().max())
        err = float((got[k] - w).abs().max())
        assert err <= 1e-8 + 2e-3 * scale, f"{k}: max abs err {err} > 2e-3 * {scale}"


def test_embed448_model_matches_jax():
    """The tiny preset fused at ``embed_dim`` 448, heads (14, 28) / (28, 14):
    Swin tails at C = 448 and 896 and the feature head at 896 (kernel C's
    channel split on the card), forward and every parameter gradient against
    the JAX model (``tests/test_torch_port_every_width.py``'s bounds)."""
    check_tiny_model_matches_jax("embed448")
