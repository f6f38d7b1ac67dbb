"""The port's build of the C++ JPEG decoder (``vadcl_tpu_torch/data/native.py``)
against the JAX package's (``vadcl_tpu/data/native.py``) and against PIL.

Both bridges compile the same ``native/vadcl_decode.cpp``, so their outputs
are the same bits; against PIL the bounds are ``tests/test_native_decode.py``'s
(float max 6e-3, mean 2e-3; uint8 within 3 steps).  The port builds into its
own ``vadcl_tpu_torch/_build/native-<hash>/``, never ``native/_build/``.
"""

import os

import numpy as np
import pytest
from PIL import Image

import vadcl_tpu.data.native as jax_native
import vadcl_tpu_torch.data.native as port_native
from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse)
from vadcl_tpu.data.dataset import load_clip as jax_load_clip
from vadcl_tpu_torch.data.dataset import _decode_resize, load_clip

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    """Three smooth JPEGs (codec noise small, so PIL against the decoder
    measures the resampler) and one noisy one."""
    d = tmp_path_factory.mktemp("jpgs")
    rng = np.random.RandomState(0)
    paths = []
    for i, (h, w) in enumerate([(480, 856), (240, 360), (224, 224)]):
        yy, xx = np.mgrid[0:h, 0:w]
        img = np.stack([127 + 120 * np.sin(xx / 37.0 + i), 127 + 120 * np.cos(yy / 53.0),
                        127 + 120 * np.sin((xx + yy) / 71.0)], -1).astype(np.uint8)
        paths.append(str(d / f"{i}.jpg"))
        Image.fromarray(img).save(paths[-1], quality=95)
    paths.append(str(d / "noise.jpg"))
    Image.fromarray(rng.randint(0, 256, (97, 131, 3)).astype(np.uint8)).save(paths[-1])
    return paths


@pytest.fixture(scope="module")
def both():
    if not (port_native.available() and jax_native.available()):
        pytest.skip("g++ or libjpeg missing: both packages decode with PIL")


def test_port_decoder_builds_into_its_own_directory(both):
    so = port_native.library_path()
    assert os.path.exists(so)
    build_root = os.path.join(REPO, "vadcl_tpu_torch", "_build")
    assert os.path.commonpath([so, build_root]) == build_root
    assert os.path.dirname(so) != os.path.dirname(jax_native._SO)
    assert port_native.get_lib()._name == so


@pytest.mark.parametrize("size", [(224, 224), (56, 72)])
def test_port_decoder_equals_jax_bit_for_bit(jpegs, both, size):
    np.testing.assert_array_equal(port_native.decode_resize_batch(jpegs, size),
                                  jax_native.decode_resize_batch(jpegs, size))
    np.testing.assert_array_equal(port_native.decode_resize_batch_u8(jpegs, size),
                                  jax_native.decode_resize_batch_u8(jpegs, size))


def test_port_decoder_within_pil_bounds(jpegs, both):
    smooth = jpegs[:3]
    got = port_native.decode_resize_batch(smooth, (224, 224))
    want = np.stack([_decode_resize(p, (224, 224)) for p in smooth])
    assert np.abs(got - want).max() < 6e-3 and np.abs(got - want).mean() < 2e-3
    a = load_clip(smooth, (112, 112), use_native=True, as_uint8=True)
    b = load_clip(smooth, (112, 112), use_native=False, as_uint8=True)
    assert a.dtype == b.dtype == np.uint8
    assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 3


@pytest.mark.parametrize("as_uint8", [False, True])
def test_load_clip_native_semantics_equal_jax(jpegs, both, as_uint8):
    """``load_clip(use_native=True)`` in both packages: the same array from
    the decoder, and where a frame is no JPEG (a PNG) both take PIL."""
    np.testing.assert_array_equal(load_clip(jpegs, (64, 64), as_uint8=as_uint8),
                                  jax_load_clip(jpegs, (64, 64), as_uint8=as_uint8))
    png = os.path.join(os.path.dirname(jpegs[0]), "frame.png")
    Image.open(jpegs[1]).save(png)
    mixed = [jpegs[2], png]
    np.testing.assert_array_equal(load_clip(mixed, (64, 64), as_uint8=as_uint8),
                                  load_clip(mixed, (64, 64), use_native=False,
                                            as_uint8=as_uint8))
    np.testing.assert_array_equal(load_clip(mixed, (64, 64), as_uint8=as_uint8),
                                  jax_load_clip(mixed, (64, 64), as_uint8=as_uint8))


def test_refused_file_falls_back_to_pil(jpegs, both, tmp_path):
    """A ``.jpg`` the decoder refuses (a PNG under a JPEG name) raises in the
    bridge and is read by PIL in ``load_clip``, as in the JAX package."""
    fake = str(tmp_path / "fake.jpg")
    Image.open(jpegs[2]).save(fake, format="PNG")
    with pytest.raises(IOError):
        port_native.decode_resize_batch([jpegs[2], fake], (64, 64))
    np.testing.assert_array_equal(load_clip([jpegs[2], fake], (64, 64)),
                                  load_clip([jpegs[2], fake], (64, 64), use_native=False))
    np.testing.assert_array_equal(load_clip([jpegs[2], fake], (64, 64)),
                                  jax_load_clip([jpegs[2], fake], (64, 64)))


def test_without_a_decoder_load_clip_reads_pil(jpegs, monkeypatch):
    monkeypatch.setattr(port_native, "available", lambda: False)
    np.testing.assert_array_equal(load_clip(jpegs, (48, 48)),
                                  load_clip(jpegs, (48, 48), use_native=False))
