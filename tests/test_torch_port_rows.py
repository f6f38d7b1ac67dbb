"""The row-tiled bodies of kernels 7, 8 and 9 (``csrc/window_attn_rows.cu``,
``csrc/window_attn_bwd_rows.cu``) and the reconstruction path at
``frame_num = 8`` that needs them, against the JAX package on the CPU.

On the CPU every wrapper runs its plain PyTorch version (the row-tiled
kernels run only on the card, where ``chip_smoke.py`` phases 2 and 2b hold
them against these plain versions); what the CPU holds here is the contract
at the window sizes of 8-frame clips, the choice of body, and the model
around it.  The JAX kernels run in interpret mode, as
``tests/test_pallas_attn.py`` runs them.  Inputs come from a numpy
RandomState; the rel-pos bias is drawn at unit scale.

The reference model is the JAX XLA (unfused) model: its fused blocks at
N = 196 and N = 392 call the Pallas window kernels without ``interpret``, which
the CPU cannot run.  The route difference this module once recorded (at
N = 196 with 6 heads the JAX package runs its fold kernel A, where the port
ran the row-tiled kernel 7 because its A stopped at 112 tokens) is repaired:
kernels A's and 6's long layouts take bf16 windows of up to 208 tokens at
head width 16, so a bf16 encoder block at ``frame_num = 8`` runs them, and
only the decoder's N = 392 stays on the row-tiled bodies
(``tests/test_torch_port_long_windows.py`` holds those blocks against the
JAX block).

Bounds: kernel forward fp32 rtol = atol = 2e-5 (``tests/test_pallas_attn.py``),
bf16 max|port - jax| <= 2e-2 * max|jax| (both round at the same casts; a
different fp32 summation order can flip one bf16 rounding); gradients
max|port - jax| <= 1e-4 * max|jax| per tensor (fp32, summation order only);
model recon atol 1e-4, cluster losses rtol 1e-4, labels equal
(``tests/test_torch_port_model.py``); model gradients 1e-3 * max|jax| per
tensor (fp32, summation order only; ``tests/test_torch_port_train.py`` allows
2e-3 over several steps); per-window scores atol 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vadcl_tpu.eval.predict as jax_predict
from test_torch_port_model import assert_outputs_match
from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse)
from vadcl_tpu.core.config import preset as jax_preset
from vadcl_tpu.models.backbone import VADModel as JaxVADModel
from vadcl_tpu.ops.pallas_attn import fused_window_attention, fused_window_attention_packed
from vadcl_tpu.ops.pallas_attn_bwd import fused_window_attention_trainable
from vadcl_tpu.ops.window import compute_attn_mask
from vadcl_tpu.train.checkpoint import flatten_state, unflatten_into
from vadcl_tpu.train.step import make_loss_fn as jax_make_loss_fn
import vadcl_tpu_torch.eval.predict as port_predict
import vadcl_tpu_torch.models.swin as port_swin
from vadcl_tpu_torch.convert import (
    jax_from_state_dict,
    load_state_dict_strict,
    state_dict_from_jax,
)
from vadcl_tpu_torch.core.config import preset
from vadcl_tpu_torch.models import VADModel
from vadcl_tpu_torch.ops.fold_attn import SMEM_LIMIT, fold_bwd_body, fold_fits
from vadcl_tpu_torch.ops.window_attn import (
    ROWS_MAX_HEAD_DIM,
    rows_smem_bytes,
    rows_streams,
    tile_smem_bytes,
    window_attention_fused_bwd_rows,
    window_attention_fused_rows,
    window_attention_packed_rows,
    window_body,
    window_grid_route,
)
from vadcl_tpu_torch.train.step import make_loss_fn

T = torch.from_numpy
IMPLS = {"base": (window_attention_fused_rows, fused_window_attention),
         "packed": (window_attention_packed_rows, fused_window_attention_packed)}
DEPTHS = {147: 3, 196: 4, 245: 5, 392: 8}  # N: window depth of a (D, 7, 7) window
WIDTHS = {"C32": (32, 2), "C64": (64, 4)}
BWD_WIDTH = {147: "C32", 196: "C64", 245: "C32", 392: "C64"}
# the forward cases: every N at one width, N = 392 at both
FWD_CASES = [(147, "C32"), (196, "C64"), (245, "C32"), (392, "C32"), (392, "C64")]
WIN_NAMES = ("dx", "dqkv_w", "dqkv_b", "dproj_w", "dproj_b", "dbias")


def assert_rel(name, got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = float(np.max(np.abs(want)))
    err = float(np.max(np.abs(got - want)))
    assert scale > 0, name
    assert err <= tol * scale, f"{name}: max abs err {err} > {tol} * {scale}"


def _case(n, width, shifted, seed):
    """One image's four (D, 7, 7) windows of a (D, 14, 14) token grid; the
    shifted blocks roll in H and W only, as a model block with D <= 8 does."""
    (C, nh), D = WIDTHS[width], DEPTHS[n]
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    mask = compute_attn_mask(D, 14, 14, (D, 7, 7), (0, 3, 3)) if shifted else None
    return dict(
        x=f(4, n, C), qkv_w=f(C, 3 * C) / np.sqrt(C), qkv_b=0.1 * f(3 * C),
        proj_w=f(C, C) / np.sqrt(C), proj_b=0.1 * f(C), bias=f(nh, n, n), mask=mask,
        dout=f(4, n, C), nH=nh, nW=4, scale=(C // nh) ** -0.5,
    )


def _opt(a, conv):
    return None if a is None else conv(a)


def _port_forward(fn, a, dtype=torch.float32):
    return fn(T(a["x"]).to(dtype), T(a["qkv_w"]), T(a["qkv_b"]), T(a["proj_w"]),
              T(a["proj_b"]), T(a["bias"]), _opt(a["mask"], T), a["nH"], a["nW"], a["scale"])


def _jax_forward(fn, a, dtype=jnp.float32):
    return fn(jnp.asarray(a["x"], dtype), jnp.asarray(a["qkv_w"]), jnp.asarray(a["qkv_b"]),
              jnp.asarray(a["proj_w"]), jnp.asarray(a["proj_b"]), jnp.asarray(a["bias"]),
              _opt(a["mask"], jnp.asarray), num_heads=a["nH"], n_windows=a["nW"],
              scale=a["scale"], interpret=True)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("shifted", [False, True], ids=["unshifted", "shifted"])
@pytest.mark.parametrize("n, width", FWD_CASES, ids=[f"{n}-{w}" for n, w in FWD_CASES])
def test_rows_forward_matches_pallas_fp32(n, width, shifted, impl):
    """Kernels 7 and 9 at the window sizes above 112 tokens against
    ``fused_window_attention`` / ``fused_window_attention_packed``."""
    port, ref = IMPLS[impl]
    a = _case(n, width, shifted, seed=n)
    np.testing.assert_allclose(_port_forward(port, a).numpy(),
                               np.asarray(_jax_forward(ref, a)), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("impl", IMPLS)
def test_rows_forward_matches_pallas_bf16(impl):
    port, ref = IMPLS[impl]
    a = _case(392, "C64", True, seed=1)
    got = _port_forward(port, a, torch.bfloat16)
    want = _jax_forward(ref, a, jnp.bfloat16)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert_rel(impl, got.float().numpy(), np.asarray(want.astype(jnp.float32)), 2e-2)


@pytest.mark.parametrize("shifted", [False, True], ids=["unshifted", "shifted"])
@pytest.mark.parametrize("n", DEPTHS)
def test_rows_backward_matches_pallas_vjp(n, shifted):
    """Kernel 8 against ``jax.vjp`` of ``fused_window_attention_trainable``
    (``_bwd_kernel`` in interpret mode), every gradient held separately,
    d(bias) included."""
    a = _case(n, BWD_WIDTH[n], shifted, seed=100 + n)
    mask = _opt(a["mask"], jnp.asarray)
    args = [jnp.asarray(a[k]) for k in ("x", "qkv_w", "qkv_b", "proj_w", "proj_b", "bias")]
    _, vjp = jax.vjp(
        lambda x, qw, qb, pw, pb, b: fused_window_attention_trainable(
            x, qw, qb, pw, pb, b, mask, a["nH"], a["nW"], a["scale"], True),
        *args)
    want = vjp(jnp.asarray(a["dout"]))
    got = window_attention_fused_bwd_rows(
        T(a["x"]), T(a["dout"]), T(a["qkv_w"]), T(a["qkv_b"]), T(a["proj_w"]), T(a["bias"]),
        _opt(a["mask"], T), a["nH"], a["nW"], a["scale"])
    for name, g, w in zip(WIN_NAMES, got, want):
        assert_rel(name, g.numpy(), np.asarray(w), 1e-4)


@pytest.mark.parametrize("c, nh", [(96, 6), (192, 12), (96, 3), (192, 6), (64, 2)],
                         ids=["C96_6", "C192_12", "C96_hd32", "C192_hd32", "C64_hd32"])
def test_every_window_size_maps_to_a_body(c, nh):
    """The body-choice mirror: every N up to 392 at the flagship widths and
    at head width 32 maps to a body, both dtypes, both directions, and never
    to a refusal; the row-tiled body is chosen exactly where the whole-tile
    body's block exceeds 227 KB."""
    for n in range(1, 393):
        for dtype in (torch.bfloat16, torch.float32):
            bf16 = dtype == torch.bfloat16
            for backward in (False, True):
                body = window_body(n, c, nh, dtype, backward)
                tile_fits = tile_smem_bytes(n, c, nh, bf16, backward) <= SMEM_LIMIT
                assert body == ("tile" if tile_fits else "rows"), (n, dtype, backward)
                assert rows_smem_bytes(n, c, nh, bf16, backward) <= SMEM_LIMIT


def test_frame8_geometries_take_the_row_tiled_bodies():
    """The decoder's window geometries of the flagship at ``frame_num = 8``
    ((8, 7, 7): N = 392) leave the fold kernels and run the row-tiled bodies
    both ways in bf16; the sizes the kernels' headers state."""
    for n, c, nh in ((392, 192, 12), (392, 96, 6)):
        assert not fold_fits(n, c, nh, torch.bfloat16)
        assert fold_bwd_body(n, c, nh, torch.bfloat16) is None
        assert not window_grid_route(n, c, nh, torch.bfloat16)
        for backward in (False, True):
            assert window_body(n, c, nh, torch.bfloat16, backward) == "rows"
    assert rows_smem_bytes(392, 96, 6, True) == 38400
    assert rows_smem_bytes(392, 96, 6, True, backward=True) == 86400
    assert ROWS_MAX_HEAD_DIM == 64
    # head width 80 (above the bf16 tensor-core cores' 64): the CUDA-core core,
    # whose K and V of a 392-token head outgrow the block, streams the head's
    # channels; a window longer than the streamed layout holds has no body
    assert window_body(392, 80, 1, torch.bfloat16) == "rows"
    assert rows_streams(392, 80, 1) and rows_smem_bytes(392, 80, 1, True) == 164 * 392 + 1024
    with pytest.raises(NotImplementedError, match="neither"):
        window_body(1412, 80, 1, torch.bfloat16)


@pytest.mark.parametrize("n, c, nh", [(196, 96, 6), (196, 192, 12)], ids=["C96", "C192"])
def test_frame8_encoder_windows_take_kernels_a_and_6(n, c, nh):
    """The encoder's window geometries at ``frame_num = 8`` ((4, 7, 7): N =
    196) run kernels A's and 6's long layouts in bf16: ``fold_fits``, 6's
    tensor-core body, and the unpartitioned route of ``base`` and ``packed``
    blocks; in fp32 they keep what they had, the partitioned row-tiled
    bodies (the fp32 fold kernel's block does not fit) and no grid route."""
    assert fold_fits(n, c, nh, torch.bfloat16) and fold_fits(n, c, nh, torch.bfloat16, True)
    assert fold_bwd_body(n, c, nh, torch.bfloat16) == "mma"
    assert window_grid_route(n, c, nh, torch.bfloat16)
    assert window_grid_route(n, c, nh, torch.bfloat16, packed=True)
    assert not fold_fits(n, c, nh, torch.float32)
    assert fold_bwd_body(n, c, nh, torch.float32) is None
    assert not window_grid_route(n, c, nh, torch.float32)
    for backward in (False, True):
        assert window_body(n, c, nh, torch.float32, backward) == "rows"
        # the partitioned body, forced or where A and 6 do not run
        assert window_body(n, c, nh, torch.bfloat16, backward) == "rows"


# --- the tiny model at frame_num = 8, reconstruction mode ------------------------

FRAMES = 8


def _tiny(make, size=56, **kw):
    """The tiny preset in reconstruction mode with depths (2, 2), so that
    every stage has a shifted block, its space head sized for ``size``^2
    clips."""
    m = make("tiny").model
    return dataclasses.replace(m, predict=False, encoder_depths=(2, 2), decoder_depths=(2, 2),
                               cluster=dataclasses.replace(m.cluster, space_size=size // 8),
                               **kw)


_REFS = {}


def _reference(size):
    """A seeded port model's weights carried into the JAX variable tree
    (``convert.jax_from_state_dict``), the JAX XLA model, a clip at
    ``size``^2 and the JAX model's outputs on it."""
    if size not in _REFS:
        torch_model = VADModel(_tiny(preset, size), torch.float32,
                               torch.Generator().manual_seed(size))
        clip = np.random.RandomState(size).rand(1, FRAMES, size, size, 3).astype(np.float32)
        jm = JaxVADModel(config=_tiny(jax_preset, size))
        template = jax.eval_shape(jm.init, jax.random.key(0), jnp.asarray(clip))
        variables = unflatten_into(template, jax_from_state_dict(torch_model.state_dict(),
                                                                 predict=False))
        want = jax.jit(jm.apply)(variables, jnp.asarray(clip))
        _REFS[size] = variables, jm, clip, want
    return _REFS[size]


@pytest.fixture(scope="module")
def frame8():
    return _reference(56)


def _port(variables, attn_kernel="fold", dtype=torch.float32, size=56):
    model = VADModel(_tiny(preset, size, fused_attention=True, fused_cluster=True,
                           attn_kernel=attn_kernel), dtype)
    load_state_dict_strict(model, state_dict_from_jax(flatten_state(variables), predict=False))
    return model


@pytest.mark.parametrize("attn_kernel", ["fold", "base", "packed"])
def test_frame8_recon_model_matches_jax(frame8, attn_kernel):
    variables, _, clip, want = frame8
    with torch.inference_mode():
        got = _port(variables, attn_kernel).eval()(T(clip))
    assert got.recon.shape == (1, FRAMES, 56, 56, 3)
    assert_outputs_match(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_frame8_blocks_route_to_the_row_tiled_bodies(monkeypatch, dtype):
    """Which kernel every fused block of the tiny model at ``frame_num = 8``
    calls (N = 196 in the encoder, 392 in the decoder, shifted blocks rolling
    by (0, 3, 3)), at 56^2 and at the window-padded 64^2.  In fp32 every
    block takes the partitioned-window route (kernel 7; the row-tiled body's
    windows both ways).  In bf16 the encoder's blocks run kernel A
    (``fold_attention``, LN1 and the residual inside; at 64^2 the padded
    blocks without them) on its long layout and 6 takes their backward, and
    only the decoder's N = 392 blocks partition for the row-tiled bodies."""
    seen, folded = [], []
    orig, orig_fold = port_swin.window_attention_fused, port_swin.fold_attention

    def spy(wins, qkv_w, qkv_b, proj_w, proj_b, bias, mask, nh, nw, scale):
        seen.append((wins.shape[1], wins.shape[2], nh, mask is not None))
        return orig(wins, qkv_w, qkv_b, proj_w, proj_b, bias, mask, nh, nw, scale)

    def fold_spy(x, ln_s, ln_b, qkv_w, qkv_b, proj_w, proj_b, bias, mask, nh, window, *a, **k):
        folded.append((window[0] * window[1] * window[2], x.shape[-1], nh, mask is not None))
        return orig_fold(x, ln_s, ln_b, qkv_w, qkv_b, proj_w, proj_b, bias, mask, nh, window,
                         *a, **k)

    monkeypatch.setattr(port_swin, "window_attention_fused", spy)
    monkeypatch.setattr(port_swin, "fold_attention", fold_spy)
    for size in (56, 64):
        seen.clear()
        folded.clear()
        variables, _, clip, _ = _reference(size)
        model = _port(variables, "fold", dtype, size=size).eval()
        with torch.inference_mode():
            out = model(T(clip).to(dtype))
        assert out.recon.shape == (1, FRAMES, size, size, 3)
        assert len(seen) + len(folded) == 8, (seen, folded)  # every Swin block
        if dtype == torch.float32:
            assert not folded
            assert sorted({n for n, *_ in seen}) == [196, 392]
            assert {n for n, _, _, shifted in seen if shifted} == {196, 392}
        else:
            assert {n for n, *_ in folded} == {196} and len(folded) == 4
            assert {n for n, *_ in seen} == {392} and len(seen) == 4
            assert {n for n, _, _, shifted in folded if shifted} == {196}
            assert {n for n, _, _, shifted in seen if shifted} == {392}
        for n, c, nh, _ in seen:
            assert not fold_fits(n, c, nh, dtype)
            for backward in (False, True):
                assert window_body(n, c, nh, torch.bfloat16, backward) == "rows"
        for n, c, nh, _ in folded:
            assert fold_fits(n, c, nh, dtype) and fold_bwd_body(n, c, nh, dtype) == "mma"


def test_frame8_padded_recon_model_matches_jax():
    """A 64^2 clip: 16^2 and 8^2 token grids pad to whole 7x7 windows."""
    variables, _, clip, want = _reference(64)
    with torch.inference_mode():
        got = _port(variables, size=64).eval()(T(clip))
    assert got.recon.shape == (1, FRAMES, 64, 64, 3)
    assert_outputs_match(got, want)


def test_frame8_recon_loss_and_grads_match_jax(frame8):
    """``make_loss_fn`` of the fused port (the row-tiled backward route)
    against ``jax.value_and_grad`` of the JAX one, whole-clip target, every
    parameter gradient held separately; cluster losses and compactness on."""
    variables = frame8[0]
    cfgs = []
    for make, fused in ((jax_preset, False), (preset, True)):
        cfg = make("tiny")
        sched = dataclasses.replace(cfg.schedule, compactness_start_iter=0, cluster_start_iter=0)
        cfgs.append(cfg.replace(model=_tiny(make, fused_attention=fused, fused_cluster=fused),
                                schedule=sched))
    jcfg, pcfg = cfgs
    clip = np.random.RandomState(5).randint(0, 256, (1, FRAMES, 56, 56, 3)).astype(np.uint8)
    params = variables["params"]
    extras = {k: v for k, v in variables.items() if k != "params"}
    (loss_j, _), grads_j = jax.jit(jax.value_and_grad(
        jax_make_loss_fn(JaxVADModel(config=jcfg.model), jcfg), has_aux=True))(
        params, extras, jnp.asarray(clip), jnp.asarray(2, jnp.int32))
    model = _port(variables)
    loss_t, _ = make_loss_fn(model, pcfg)(T(clip), 2)
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=1e-4)
    want = state_dict_from_jax(flatten_state({"params": grads_j}), predict=False)
    got = {k: p.grad for k, p in model.named_parameters()}
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k] is not None, f"{k}: no gradient"
        assert_rel(k, got[k].numpy(), w.numpy(), 1e-3)


def _videos():
    rng = np.random.RandomState(6)
    out = []
    for t, scene in ((10, "01"), (9, "02")):  # two windows and one
        frames = rng.randint(0, 256, (t, 56, 56, 3)).astype(np.uint8)
        labels = np.zeros(t, np.int64)
        labels[t // 2:] = 1
        out.append((frames, labels, scene))
    return out


def test_frame8_evaluate_videos_matches_jax(frame8):
    """Reconstruction scoring at ``frame_num = 8``: per-window MSE of shape
    (n, 8), the per-frame scores and the per-scene AUC of both packages."""
    variables, jm, _, _ = frame8
    model = _port(variables).eval()
    jscorer = jax_predict.make_video_scorer(
        lambda c: jm.apply(variables, c).recon, frame_num=FRAMES, predict=False,
        batch_windows=4)
    pscorer = port_predict.make_video_scorer(
        lambda c: model(c).recon, frame_num=FRAMES, predict=False, batch_windows=4,
        device="cpu")
    jauc, jscenes, jvideos = jax_predict.evaluate_videos(jscorer, _videos(), FRAMES, False)
    with torch.inference_mode():
        pauc, pscenes, pvideos = port_predict.evaluate_videos(pscorer, _videos(), FRAMES, False)
    for pv, jv in zip(pvideos, jvideos):
        assert pv.scene == jv.scene and len(pv.scores) == len(jv.scores) > 0
        np.testing.assert_array_equal(pv.labels, jv.labels)
        np.testing.assert_allclose(pv.scores, jv.scores, rtol=0, atol=1e-4)
    assert set(pscenes) == set(jscenes) == {"01", "02"}
    for s in jscenes:
        np.testing.assert_allclose(pscenes[s], jscenes[s], atol=1e-6)
    np.testing.assert_allclose(pauc, jauc, atol=1e-6)
