"""The port's own data and dump modules (``vadcl_tpu_torch/data``,
``vadcl_tpu_torch/viz``) against the JAX package's, and the port's import
hygiene: nothing of ``vadcl_tpu_torch``, ``chip_smoke.py`` or
``tools/*_torch.py`` may import ``jax``, ``flax`` or ``vadcl_tpu``.

The drift tests run the same frame folder and the same seed through both
packages and ask for equal arrays (both decode with PIL here: the JAX
package's C++ decoder is switched off so that the comparison is exact).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import vadcl_tpu.data as jax_data
import vadcl_tpu.data.native as jax_native
import vadcl_tpu.viz.dumps as jax_dumps
import vadcl_tpu_torch.data as port_data
import vadcl_tpu_torch.viz.dumps as port_dumps
from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def frame_folder(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("frames"))
    return port_data.make_synthetic_dataset(
        root, num_train_videos=2, num_test_videos=2, frames_per_video=10, size=40)


@pytest.fixture()
def pil_only(monkeypatch):
    monkeypatch.setattr(jax_native, "available", lambda: False)


def test_synthetic_fixture_equals_jax(tmp_path, frame_folder):
    jax_dirs = jax_data.make_synthetic_dataset(
        str(tmp_path), num_train_videos=2, num_test_videos=2, frames_per_video=10, size=40)
    for ours, theirs in zip(frame_folder, jax_dirs):
        names = sorted(os.listdir(ours))
        assert names == sorted(os.listdir(theirs)) and names
        for name in names:
            a, b = os.path.join(ours, name), os.path.join(theirs, name)
            if os.path.isdir(a):
                assert sorted(os.listdir(a)) == sorted(os.listdir(b))
                for f in os.listdir(a):
                    assert open(os.path.join(a, f), "rb").read() == open(
                        os.path.join(b, f), "rb").read(), (name, f)
            else:
                np.testing.assert_array_equal(np.load(a), np.load(b))


@pytest.mark.parametrize("size", [(40, 40), (56, 56)], ids=["native_size", "resized"])
def test_clip_dataset_equals_jax(frame_folder, pil_only, size):
    train_dir, test_dir, label_dir = frame_folder
    ours = port_data.ClipDataset(train_dir, frame_num=4, size=size)
    theirs = jax_data.ClipDataset(train_dir, frame_num=4, size=size)
    assert len(ours) == len(theirs) == 14 and ours.samples == theirs.samples
    for i in (0, 6, 7, 13):
        clip = ours.get_clip(i)
        assert clip.dtype == np.uint8 and clip.shape == (4, *size, 3)
        np.testing.assert_array_equal(clip, theirs.get_clip(i))
    ours = port_data.ClipDataset(test_dir, 4, size, label_root=label_dir, istest=True)
    theirs = jax_data.ClipDataset(test_dir, 4, size, label_root=label_dir, istest=True)
    for (f, l, s), (jf, jl, js) in zip(ours.iter_test_videos(), theirs.iter_test_videos()):
        np.testing.assert_array_equal(f, jf)
        np.testing.assert_array_equal(l, jl)
        assert s == js and f.shape == (10, *size, 3) and l.sum() > 0


def test_load_clip_and_video_equal_jax(frame_folder, pil_only):
    video = sorted(os.listdir(frame_folder[0]))[0]
    vdir = os.path.join(frame_folder[0], video)
    np.testing.assert_array_equal(port_data.load_video(vdir, (48, 48)),
                                  jax_data.load_video(vdir, (48, 48)))
    paths = sorted(os.path.join(vdir, f) for f in os.listdir(vdir))[:3]
    got = port_data.load_clip(paths, (40, 40))
    assert got.dtype == np.float32 and got.max() <= 1.0
    np.testing.assert_array_equal(got, jax_data.load_clip(paths, (40, 40), use_native=False))


@pytest.mark.parametrize("hosts", [1, 2])
def test_host_data_loader_equals_jax(frame_folder, pil_only, hosts):
    """Same seed, same permutation, same batches, the mid-epoch
    fast-forward included."""
    ours = port_data.ClipDataset(frame_folder[0], frame_num=4, size=(40, 40))
    theirs = jax_data.ClipDataset(frame_folder[0], frame_num=4, size=(40, 40))
    kw = dict(batch_size=3, seed=5, num_workers=2, host_id=hosts - 1, num_hosts=hosts)
    a, b = port_data.HostDataLoader(ours, **kw), jax_data.HostDataLoader(theirs, **kw)
    assert a.steps_per_epoch() == b.steps_per_epoch() > 0
    for epoch, start in ((0, 0), (1, 1)):
        got, want = list(a.epoch(epoch, start)), list(b.epoch(epoch, start))
        assert len(got) == len(want) == a.steps_per_epoch() - start
        for g, w in zip(got, want):
            assert g.dtype == np.uint8 and g.shape == (3, 4, 40, 40, 3)
            np.testing.assert_array_equal(g, w)
    assert not np.array_equal(next(iter(a.epoch(0))), next(iter(a.epoch(1))))


def test_dumps_equal_jax(tmp_path):
    rng = np.random.RandomState(0)
    clip = rng.rand(2, 3, 16, 16, 3).astype(np.float32)
    port_dumps.save_clip_frames(clip, str(tmp_path / "a"))
    jax_dumps.save_clip_frames(clip, str(tmp_path / "b"))
    port_dumps.save_clip_frames((clip * 255).astype(np.uint8), str(tmp_path / "a8"), "x.jpg")
    jax_dumps.save_clip_frames((clip * 255).astype(np.uint8), str(tmp_path / "b8"), "x.jpg")
    for ours, theirs in (("a", "b"), ("a8", "b8")):
        for b in ("0", "1"):
            names = sorted(os.listdir(tmp_path / ours / b))
            assert names == sorted(os.listdir(tmp_path / theirs / b)) and names
            for n in names:
                assert (tmp_path / ours / b / n).read_bytes() == (
                    tmp_path / theirs / b / n).read_bytes()
    np.testing.assert_array_equal(port_dumps.error_heatmap(clip[0, 0], clip[1, 0]),
                                  jax_dumps.error_heatmap(clip[0, 0], clip[1, 0]))


HYGIENE = """
import importlib, os, pkgutil, sys, tempfile
for name in ("jax", "jaxlib", "flax", "vadcl_tpu"):
    sys.modules[name] = None  # any import of these raises ImportError
import vadcl_tpu_torch
names = [m.name for m in pkgutil.walk_packages(vadcl_tpu_torch.__path__, "vadcl_tpu_torch.")]
for name in names + ["chip_smoke", "tools.evaluate_torch", "tools.train_torch",
                     "tools.profile_torch", "tools.autotune_torch", "tools.ddp_check_torch"]:
    importlib.import_module(name)
for name in ("vadcl_tpu_torch.data.dataset", "vadcl_tpu_torch.data.loader",
             "vadcl_tpu_torch.viz.dumps", "vadcl_tpu_torch.ops.window_attn",
             "vadcl_tpu_torch.core.mesh", "vadcl_tpu_torch.parallel.sharding",
             "vadcl_tpu_torch.utils.profiling", "vadcl_tpu_torch.utils.autotune",
             "vadcl_tpu_torch.utils.flops", "vadcl_tpu_torch.utils.parity"):
    assert name in names, name
bad = sorted(k for k, v in sys.modules.items()
             if v is not None and k.split(".")[0] in ("jax", "jaxlib", "flax", "vadcl_tpu"))
assert not bad, bad
from vadcl_tpu_torch.data import ClipDataset, HostDataLoader, make_synthetic_dataset
with tempfile.TemporaryDirectory() as root:
    train_dir, test_dir, label_dir = make_synthetic_dataset(
        root, num_train_videos=1, num_test_videos=1, frames_per_video=6, size=32)
    ds = ClipDataset(train_dir, frame_num=4, size=(32, 32))
    assert len(ds) == 3 and ds.get_clip(0).shape == (4, 32, 32, 3)
    batch = next(iter(HostDataLoader(ds, batch_size=2, num_workers=1).epoch(0)))
    assert batch.shape == (2, 4, 32, 32, 3)
    frames, labels, scene = ClipDataset(test_dir, 4, (32, 32), label_dir, True).get_test_video(0)
    assert frames.shape == (6, 32, 32, 3) and labels.shape == (6,) and scene == "01"
print("ok", len(names))
"""


def test_port_imports_nothing_of_jax_and_reads_a_frame_folder():
    """With ``jax``, ``flax`` and ``vadcl_tpu`` made unimportable, every
    module of the port, ``chip_smoke`` and the five CLIs import, and a
    ``ClipDataset`` reads a synthetic frame folder."""
    out = subprocess.run([sys.executable, "-c", HYGIENE], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_port_sources_name_no_jax_import():
    """The same rule read off the sources: no ``import jax``/``flax``/
    ``vadcl_tpu`` statement in the port, ``chip_smoke.py`` or the CLIs."""
    import re

    pattern = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|flax|vadcl_tpu)(\.|\s|$)", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    files += [os.path.join(REPO, "tools", f) for f in os.listdir(os.path.join(REPO, "tools"))
              if f.endswith("_torch.py")]
    for root, _, names in os.walk(os.path.join(REPO, "vadcl_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 30
    bad = [f for f in files if pattern.search(open(f).read())]
    assert not bad, bad
