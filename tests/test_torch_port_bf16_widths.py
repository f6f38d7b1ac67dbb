"""bf16 fused models at head widths off 16: the routes, the wrappers'
checks, kernels 7, 8 and 9 at head width 12, and a fused ``embed_dim`` 24
model, against the JAX package on the CPU.

The JAX package's fold gates look at memory only, so it runs kernel A (and
the whole-block kernel) in bf16 at head width 12.  The port's bf16 fold
kernels run on 16x16 tensor-core tiles and take head widths 16 and 32 only;
a bf16 block at another head width takes the partitioned-window route, whose
kernels 7, 8 and 9 run it on their CUDA-core bodies (``window_core`` names
them ``"cuda_core"``: fp32 arithmetic that rounds to bf16 where the bf16
contract rounds).  On the CPU every wrapper runs its plain version; the
CUDA-core bodies run only on the card (``chip_smoke.py`` holds them against
these plain versions there).

Bounds: kernels 7 and 9 (plain, bf16) against the Pallas kernels in
interpret mode, max|port - jax| <= 2e-2 * max|jax| (both round at the same
casts; another fp32 summation order can flip one bf16 rounding); kernel 8,
each gradient within 2e-2 of the JAX gradient's largest entry
(``chip_smoke.py:BWD_TOL``).  The model: the port in bf16 under ``fold``,
``fold_block`` and ``base`` against the JAX model in bf16 (its XLA path:
the JAX package's fused model in interpret mode takes 40 s a kernel here),
one 56^2 clip: two bf16 computations that round at other places through
~20 layers, so recon within 5e-2 of max|recon|, the losses rtol 2e-3, at
least 85% of the hard labels equal, and every parameter gradient within
15% of the JAX gradient's norm (the worst measured: 7.7%, an I3D batch-norm
scale).  oneDNN's bf16 CPU convolution backward returns NaN in some runs of
this model's transposed convolutions (the port's code plays no part), so
the model test runs torch's own CPU convolutions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_fold_models import ROUTE_FNS, _spy
from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_port_window_attn import _case, _jax_forward, _opt, _port_forward, assert_rel
from vadcl_tpu.core.config import preset as jax_preset
from vadcl_tpu.models.backbone import VADModel as JaxVADModel
from vadcl_tpu.ops.pallas_attn import fused_window_attention, fused_window_attention_packed
from vadcl_tpu.ops.pallas_attn_bwd import fused_window_attention_trainable
from vadcl_tpu.train.checkpoint import flatten_state, unflatten_into
from vadcl_tpu_torch.convert import jax_from_state_dict, state_dict_from_jax
from vadcl_tpu_torch.core.config import preset
from vadcl_tpu_torch.models import VADModel, swin
from vadcl_tpu_torch.ops.fold_attn import (
    fold_block_bwd_body,
    fold_block_fits,
    fold_bwd_body,
    fold_fits,
    fold_packed_fits,
)
from vadcl_tpu_torch.ops.ln_mlp import mlp_bwd_body, mlp_fwd_body
from vadcl_tpu_torch.ops.window_attn import (
    _check_windows,
    rows_smem_bytes,
    tile_smem_bytes,
    window_attention_fused,
    window_attention_fused_bwd,
    window_attention_packed,
    window_body,
    window_core,
)

T = torch.from_numpy
BF16 = torch.bfloat16
HEAD12 = [(24, 2), (48, 4), (72, 6)]  # (C, heads): head width 12


@pytest.mark.parametrize("c, nh", HEAD12, ids=[f"C{c}" for c, _ in HEAD12])
def test_routes_and_checks_at_head_width_12(c, nh):
    """No fold kernel takes a bf16 window at head width 12 (the tensor-core
    bodies refuse it), kernels 7, 8 and 9 do, on their CUDA-core bodies,
    whose blocks hold fp32 tiles; the wrappers' checks pass."""
    for n in (49, 98):
        for backward in (False, True):
            assert not fold_fits(n, c, nh, BF16, backward)
            assert fold_fits(n, c, nh, torch.float32, backward)
            assert window_body(n, c, nh, BF16, backward) == "tile"
        assert fold_bwd_body(n, c, nh, BF16) is None
        assert not fold_packed_fits(n, c, nh, BF16)
        for ch in (2 * c, 4 * c):
            assert not fold_block_fits(n, c, nh, ch, BF16)
            assert fold_block_fits(n, c, nh, ch, torch.float32)
        for backward in (False, True):
            assert (tile_smem_bytes(n, c, nh, True, backward)
                    == tile_smem_bytes(n, c, nh, False, backward))
    for n in (196, 392):  # 8-frame windows: the row-tiled CUDA-core cores
        assert window_body(n, c, nh, BF16, True) == "rows"
        assert rows_smem_bytes(n, c, nh, True, True) == rows_smem_bytes(n, c, nh, False, True)
    assert window_core(c, nh, BF16) == window_core(c, nh, BF16, rows=True) == "cuda_core"
    assert window_core(96, 6, BF16) == window_core(96, 6, BF16, rows=True) == "mma"
    x = torch.zeros(4, 98, c, dtype=BF16)
    _check_windows("k", x, torch.zeros(nh, 98, 98), torch.zeros(2, 98, 98), nh, 2)


def _block(attn_kernel, dim, heads, ch):
    gen = torch.Generator().manual_seed(3)
    block = swin.SwinBlock3D(dim, heads, (2, 7, 7), (0, 3, 3), mlp_ratio=ch / dim, fused=True,
                             attn_kernel=attn_kernel)
    block.attn.reset_parameters(gen)
    with torch.no_grad():
        for lin in (block.mlp.fc1, block.mlp.fc2):
            lin.weight.copy_(torch.randn(lin.weight.shape, generator=gen) * 0.1)
    return block


@pytest.mark.parametrize("kernel, dim, heads, ch, route", [
    ("fold", 24, 2, 96, ["window_attention_fused", "ln_mlp"]),
    ("fold_block", 24, 2, 96, ["window_attention_fused", "ln_mlp"]),
    ("base", 48, 4, 192, ["window_attention_fused", "ln_mlp"]),
    ("fold_block", 48, 4, 192, ["window_attention_fused", "ln_mlp"]),
    ("fold_mix", 72, 6, 288, ["window_attention_fused", "ln_mlp"]),
    ("packed", 24, 2, 96, ["window_attention_packed", "ln_mlp"]),
    ("fold_block", 48, 3, 192, ["fold_block"]),
])
def test_bf16_block_routes(monkeypatch, kernel, dim, heads, ch, route):
    """Which wrappers one fused bf16 Swin block calls: at head width 12 the
    partitioned-window route under every ``attn_kernel``; at head width 16
    with hidden 192 (off the 128-column chunks of PR 4's whole-block
    forward, which the tensor-core body takes) the whole-block kernel.
    Forward and backward run."""
    block = _block(kernel, dim, heads, ch).to(BF16)
    x = torch.rand(1, 2, 14, 14, dim, generator=torch.Generator().manual_seed(4)).to(BF16)
    seen = _spy(monkeypatch, *ROUTE_FNS)
    out = block(x.requires_grad_(kernel != "packed"))
    assert seen == route
    assert out.dtype == BF16 and bool(torch.isfinite(out.float()).all())
    if kernel != "packed":
        out.float().sum().backward()
        assert x.grad is not None and block.attn.qkv_weight.grad is not None


# --- kernels 7, 9 and 8 at head width 12, bf16, against the Pallas kernels --

IMPLS = {"base": (window_attention_fused, fused_window_attention),
         "packed": (window_attention_packed, fused_window_attention_packed)}
GEOM12 = ((2, 7, 7), (2, 14, 14), 24, 2)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("shifted", [False, True], ids=["unshifted", "shifted"])
def test_forward_matches_pallas_bf16_head_width_12(shifted, impl):
    port, ref = IMPLS[impl]
    a = _case(GEOM12, shifted, seed=7)
    got = _port_forward(port, a, BF16)
    want = _jax_forward(ref, a, jnp.bfloat16)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    assert_rel(impl, got.float().numpy(), np.asarray(want.astype(jnp.float32)), 2e-2)


@pytest.mark.parametrize("shifted", [False, True], ids=["unshifted", "shifted"])
def test_backward_matches_pallas_bf16_head_width_12(shifted):
    """Kernel 8 (plain, bf16) against ``jax.vjp`` of the trainable Pallas
    forward in bf16 (``_bwd_kernel`` in interpret mode), every gradient."""
    a = _case(((2, 7, 7), (2, 14, 14), 48, 4), shifted, seed=8)
    mask = _opt(a["mask"], jnp.asarray)
    x = jnp.asarray(a["x"], jnp.bfloat16)
    _, vjp = jax.vjp(lambda x, qw, qb, pw, pb, b: fused_window_attention_trainable(
        x, qw, qb, pw, pb, b, mask, a["nH"], a["nW"], a["scale"], True),
        x, *(jnp.asarray(a[k]) for k in ("qkv_w", "qkv_b", "proj_w", "proj_b", "bias")))
    want = vjp(jnp.asarray(a["dout"], jnp.bfloat16))
    got = window_attention_fused_bwd(
        T(a["x"]).to(BF16), T(a["dout"]).to(BF16), T(a["qkv_w"]), T(a["qkv_b"]),
        T(a["proj_w"]), T(a["bias"]), _opt(a["mask"], T), a["nH"], a["nW"], a["scale"])
    assert got[0].dtype == BF16
    # (dx, dqkv_w, dqkv_b, dproj_w, dproj_b, dbias) against (dx, qw, qb, pw, pb, bias)
    for name, g, w in zip(("dx", "dqkv_w", "dqkv_b", "dproj_w", "dproj_b", "dbias"), got, want):
        assert_rel(name, g.float().numpy(), np.asarray(w.astype(jnp.float32)), 2e-2)


# --- the fused embed_dim 24 model in bf16 --------------------------------------

SIZE = 56
MODEL_KERNELS = ("fold", "fold_block", "base")


def _configs(attn_kernel):
    """(JAX, port) configs: the tiny preset at ``embed_dim`` 24 (heads (2,
    4) / (4, 2): head width 12 at C = 24 and 48, hidden 96 and 192); the
    port fused under ``attn_kernel``, the JAX model on its XLA path."""
    out = []
    for make in (jax_preset, preset):
        m = make("tiny").model
        out.append(dataclasses.replace(
            m, embed_dim=24, predict=True, fused_attention=make is preset,
            attn_kernel=attn_kernel, fused_cluster=make is preset,
            cluster=dataclasses.replace(m.cluster, space_size=SIZE // 8)))
    return out


def _port(attn_kernel):
    return VADModel(_configs(attn_kernel)[1], BF16, torch.Generator().manual_seed(12))


@pytest.fixture(scope="module")
def reference():
    """The JAX model in bf16 with the port model's seeded weights, its
    outputs on one clip and the gradients of recon . probe + both losses."""
    jcfg, _ = _configs("base")
    clip = np.random.RandomState(12).rand(1, 4, SIZE, SIZE, 3).astype(np.float32)
    probe = np.random.RandomState(13).randn(1, 1, SIZE, SIZE, 3).astype(np.float32)
    jm = JaxVADModel(config=jcfg, dtype=jnp.bfloat16)
    template = jax.eval_shape(jm.init, jax.random.key(0), jnp.asarray(clip))
    variables = unflatten_into(template,
                               jax_from_state_dict(_port("base").state_dict(), predict=True))
    extras = {k: v for k, v in variables.items() if k != "params"}

    def loss(params):
        o = jm.apply({"params": params, **extras}, jnp.asarray(clip))
        return jnp.sum(o.recon.astype(jnp.float32) * probe) + o.cluster_loss + o.space_loss, o

    (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(variables["params"])
    return clip, probe, out, state_dict_from_jax(flatten_state({"params": grads}), predict=True)


@pytest.fixture
def native_cpu_convolutions():
    enabled = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    yield
    torch.backends.mkldnn.enabled = enabled


@pytest.mark.parametrize("attn_kernel", MODEL_KERNELS)
def test_embed_dim_24_model_matches_jax_bf16(reference, native_cpu_convolutions, attn_kernel):
    clip, probe, want, want_grads = reference
    model = _port(attn_kernel)
    out = model(T(clip))
    assert out.recon.dtype == BF16 and out.recon.shape == (1, 1, SIZE, SIZE, 3)
    recon = np.asarray(want.recon.astype(jnp.float32))
    assert_rel("recon", out.recon.detach().float().numpy(), recon, 5e-2)
    for name in ("cluster_loss", "space_loss"):
        np.testing.assert_allclose(float(getattr(out, name)), float(getattr(want, name)),
                                   rtol=2e-3, err_msg=name)
    assert float((out.feature_label.numpy() == np.asarray(want.feature_label)).mean()) >= 0.85
    ((out.recon.float() * T(probe)).sum() + out.cluster_loss + out.space_loss).backward()
    got = {k: p.grad for k, p in model.named_parameters()}
    assert set(got) == set(want_grads)
    for k, w in want_grads.items():
        g = got[k]
        assert g is not None and bool(torch.isfinite(g).all()), k
        err = float((g.float() - w.float()).norm())
        assert err <= 0.15 * float(w.float().norm()) + 1e-12, f"{k}: {err} vs {w.norm()}"


# --- the flagship route table ---------------------------------------------------

# Every predicate's answer at the four flagship geometries and the tiny
# preset's, as it stood before head widths off 16 were taken: per (N, C,
# heads), bf16 then fp32 (fold_block_fits at hidden 4C; the whole-block
# backward's, kernels 5's and 6's and B's bodies; kernels 7/8's bodies).
_TC = dict(fold=True, fold_bwd=True, fold_packed=True, block=True, fold_bwd_body="mma",
           block_bwd_body="mma", mlp="wgmma", mlp_bwd="mma", window="tile", window_bwd="tile")
_F32 = dict(_TC, fold_bwd_body="tiles", block_bwd_body="tiles", mlp="tiles", mlp_bwd="tiles")
FLAGSHIP = [(98, 96, 6), (98, 192, 12), (49, 192, 12), (49, 96, 6), (98, 32, 2), (98, 64, 4),
            (49, 64, 4), (49, 32, 2)]


@pytest.mark.parametrize("geom", FLAGSHIP, ids=[f"N{n}_C{c}_{nh}" for n, c, nh in FLAGSHIP])
def test_flagship_route_table_unchanged(geom):
    n, c, nh = geom
    for dt, want in ((BF16, _TC), (torch.float32, _F32)):
        got = dict(
            fold=fold_fits(n, c, nh, dt), fold_bwd=fold_fits(n, c, nh, dt, backward=True),
            fold_packed=fold_packed_fits(n, c, nh, dt), block=fold_block_fits(n, c, nh, 4 * c, dt),
            fold_bwd_body=fold_bwd_body(n, c, nh, dt),
            block_bwd_body=fold_block_bwd_body(n, c, nh, 4 * c, dt),
            mlp=mlp_fwd_body(c, 4 * c, dt), mlp_bwd=mlp_bwd_body(c, 4 * c, dt),
            window=window_body(n, c, nh, dt), window_bwd=window_body(n, c, nh, dt, True))
        assert got == want, (geom, dt)
    assert window_core(c, nh, BF16) == "mma" and window_core(c, nh, torch.float32) == "cuda_core"
