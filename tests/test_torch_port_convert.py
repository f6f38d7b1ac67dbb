"""The weight bridge, the port's import hygiene, its evaluation CLI, and
``chip_smoke.py`` refusing to run without a GPU."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse)
from vadcl_tpu.core.config import preset as jax_preset
from vadcl_tpu.models.backbone import VADModel as JaxVADModel
from vadcl_tpu.train.checkpoint import CheckpointManager, flatten_state
from vadcl_tpu.train.step import TrainState
from vadcl_tpu_torch.convert import (
    jax_from_state_dict,
    load_jax_checkpoint,
    load_state_dict_strict,
    state_dict_from_jax,
)
from vadcl_tpu_torch.core.config import preset
from vadcl_tpu_torch.models import VADModel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_flat(predict: bool):
    m = dataclasses.replace(jax_preset("tiny").model, predict=predict)
    v = jax.jit(JaxVADModel(config=m).init)(jax.random.key(3), jnp.zeros((1, 4, 56, 56, 3)))
    return v, flatten_state(v)


def _port(predict: bool) -> VADModel:
    return VADModel(dataclasses.replace(preset("tiny").model, predict=predict))


@pytest.mark.parametrize("predict", [True, False], ids=["predict", "recon"])
def test_round_trip_is_lossless(predict):
    _, flat = _jax_flat(predict)
    model = _port(predict)
    load_state_dict_strict(model, state_dict_from_jax(flat, predict=predict))
    back = jax_from_state_dict(model.state_dict(), predict=predict)
    assert back.keys() == flat.keys()
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)


def test_one_state_dict_loads_into_every_attention_kernel():
    """The parameter tree does not depend on ``attn_kernel``: one converted
    state_dict loads strictly into an unfused model and into fused models
    under all six kernels, and they agree on an input."""
    _, flat = _jax_flat(True)
    sd = state_dict_from_jax(flat, predict=True)
    x = torch.from_numpy(np.random.RandomState(0).rand(1, 4, 56, 56, 3).astype(np.float32))
    outs = {}
    kernels = ("fold", "base", "packed", "fold_packed", "fold_mix", "fold_block")
    for kernel in (None,) + kernels:
        m = dataclasses.replace(
            preset("tiny").model, predict=True, fused_attention=kernel is not None,
            attn_kernel=kernel or "base")
        model = VADModel(m)
        load_state_dict_strict(model, dict(sd))
        with torch.inference_mode():
            outs[kernel] = model.eval()(x).recon.numpy()
    for kernel in kernels:
        np.testing.assert_allclose(outs[kernel], outs[None], rtol=0, atol=1e-5)


def test_layouts_follow_torch_conventions():
    _, flat = _jax_flat(False)
    sd = state_dict_from_jax(flat, predict=False)
    # Conv3d DHWIO -> OIDHW; ConvTranspose3d (kd,kh,kw,Ci,Co) -> (Ci,Co,kd,kh,kw)
    assert tuple(sd["encoder.downsample0.weight"].shape) == (64, 32, 1, 2, 2)
    assert tuple(sd["decoder.patchdebed.deconv2.weight"].shape) == (32, 3, 3, 2, 2)
    assert tuple(sd["encoder.stage0.block0.attn.qkv_weight"].shape) == (32, 96)
    w = flat["params/decoder/timedebd/kernel"]  # recon head: a transposed conv
    np.testing.assert_array_equal(sd["decoder.timedebd.weight"].numpy(), w.transpose(3, 4, 0, 1, 2))
    assert "encoder.inception0.b0.bn.running_var" in sd


def test_strict_loading_names_missing_and_leftover_keys():
    _, flat = _jax_flat(True)
    sd = state_dict_from_jax(flat, predict=True)
    dropped = dict(sd)
    dropped.pop("decoder.norm.bias")
    with pytest.raises(KeyError, match=r"missing \['decoder\.norm\.bias'\]"):
        load_state_dict_strict(_port(True), dropped)
    extra = dict(sd, **{"decoder.extra.weight": torch.zeros(1)})
    with pytest.raises(KeyError, match=r"unexpected \['decoder\.extra\.weight'\]"):
        load_state_dict_strict(_port(True), extra)
    bad = dict(sd, **{"norm.weight": torch.zeros(3)})
    with pytest.raises(KeyError, match="norm.weight"):
        load_state_dict_strict(_port(True), bad)


def test_load_jax_checkpoint_reads_train_state_npz(tmp_path):
    variables, flat = _jax_flat(True)
    variables = dict(variables)
    params = variables.pop("params")
    state = TrainState(step=np.int32(7), params=params, extras=variables, opt_state=None)
    CheckpointManager(str(tmp_path)).save("1", state)
    model = _port(True)
    load_jax_checkpoint(model, str(tmp_path / "ckpt_1.npz"))
    sd = model.state_dict()
    np.testing.assert_array_equal(
        sd["cluster1.cluster_center"].numpy(), flat["params/cluster1/cluster_center"]
    )
    np.testing.assert_array_equal(
        sd["encoder.inception1.b1b.bn.running_mean"].numpy(),
        flat["batch_stats/encoder/inception1/b1b/bn/mean"],
    )


def test_port_imports_neither_jax_nor_pil():
    code = (
        "import importlib, pkgutil, sys\n"
        "import vadcl_tpu_torch\n"
        "for m in pkgutil.walk_packages(vadcl_tpu_torch.__path__, 'vadcl_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'flax', 'PIL', 'vadcl_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok', len([k for k in sys.modules if k.startswith('vadcl_tpu_torch')]))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


@pytest.mark.parametrize("attn_kernel", ["auto", "base", "packed", "fold_packed", "fold_mix",
                                         "fold_block"])
def test_evaluate_torch_cli_on_synthetic_frames(tmp_path, attn_kernel):
    from tools.evaluate_torch import main
    from vadcl_tpu_torch.data import make_synthetic_dataset

    _, test_dir, label_dir = make_synthetic_dataset(
        str(tmp_path), num_train_videos=0, num_test_videos=2, frames_per_video=12, size=56
    )
    out = tmp_path / "scores.npz"
    auc = main([
        "--preset", "tiny", "--predict", "--fused", "--device", "cpu",
        "--test-data-path", test_dir, "--label-path", label_dir,
        "--batch-windows", "4", "--out", str(out), "--attn-kernel", attn_kernel,
    ])
    assert np.isfinite(auc)
    with np.load(out) as z:
        assert len(z.files) == 2
        assert all(z[k].shape == (2, 8) for k in z.files)  # 12 frames -> 8 windows


def test_evaluate_torch_cli_refuses_cuda_without_a_gpu(tmp_path, monkeypatch):
    """The default device is the card; without one the CLI raises instead of
    quietly scoring on the CPU."""
    from tools.evaluate_torch import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(["--preset", "tiny", "--predict", "--fused", "--test-data-path",
              str(tmp_path), "--label-path", str(tmp_path)])


def test_chip_smoke_refuses_to_run_without_a_gpu(tmp_path):
    """No CPU fallback: without CUDA the smoke test fails before printing a
    result, from the repository and from a directory holding only itself."""
    import shutil

    alone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), alone)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for cwd, script in ((REPO, "chip_smoke.py"), (str(tmp_path), str(alone))):
        out = subprocess.run(
            [sys.executable, script], cwd=cwd, capture_output=True, text=True,
            timeout=120, env=env,
        )
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
