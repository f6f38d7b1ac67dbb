"""The port's copies of the JAX package's last data and tool leftovers
against it: the latent-anomaly fixture (``data/synthetic.py``), the cluster
embedding export (``viz/dumps.py``), and the three tools
``tools/train_synthetic_torch.py``, ``tools/visualize_torch.py`` and
``tools/center_training_experiment_torch.py``, each run at a tiny size on
the CPU (``--device cpu``)."""

import os

import numpy as np
import pytest

import vadcl_tpu.data.synthetic as jax_synthetic
import vadcl_tpu.viz.dumps as jax_dumps
import vadcl_tpu_torch.data.synthetic as port_synthetic
import vadcl_tpu_torch.viz.dumps as port_dumps
from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse)


def _same_tree(a: str, b: str) -> int:
    """Every file under ``a`` equals (bytes) its counterpart under ``b``;
    returns the number of files."""
    n = 0
    for root, dirs, files in os.walk(a):
        rel = os.path.relpath(root, a)
        assert sorted(files) == sorted(os.listdir(os.path.join(b, rel))) or dirs
        for f in files:
            with open(os.path.join(root, f), "rb") as x, open(os.path.join(b, rel, f), "rb") as y:
                assert x.read() == y.read(), os.path.join(rel, f)
            n += 1
    return n


def test_latent_anomaly_fixture_equals_jax(tmp_path):
    ours = port_synthetic.make_latent_anomaly_dataset(
        str(tmp_path / "a"), num_train_videos=3, num_test_videos=2, frames_per_video=9, size=40)
    theirs = jax_synthetic.make_latent_anomaly_dataset(
        str(tmp_path / "b"), num_train_videos=3, num_test_videos=2, frames_per_video=9, size=40)
    assert [os.path.relpath(p, tmp_path / "a") for p in ours] == [
        os.path.relpath(p, tmp_path / "b") for p in theirs]
    assert _same_tree(str(tmp_path / "a"), str(tmp_path / "b")) == 3 * 9 + 2 * 9 + 2
    for kind in range(3):
        np.testing.assert_array_equal(port_synthetic._pattern_frame(5, 32, kind, 0.15),
                                      jax_synthetic._pattern_frame(5, 32, kind, 0.15))
    labels = np.load(os.path.join(ours[2], sorted(os.listdir(ours[2]))[0]))
    assert labels.tolist() == [0, 0, 0, 1, 1, 1, 0, 0, 0]


@pytest.mark.parametrize("n", [300, 2500], ids=["all_points", "subsampled"])
def test_export_cluster_embedding_equals_jax(tmp_path, n):
    rng = np.random.RandomState(0)
    feats = rng.randn(n, 8).astype(np.float32)
    labels = rng.randint(0, 9, n).astype(np.int32)
    got = port_dumps.export_cluster_embedding(feats, labels, str(tmp_path / "a" / "e.npz"),
                                              top_clusters=4, max_points=2000, run_tsne=False)
    want = jax_dumps.export_cluster_embedding(feats, labels, str(tmp_path / "b" / "e.npz"),
                                              top_clusters=4, max_points=2000, run_tsne=False)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    with np.load(tmp_path / "a" / "e.npz") as a, np.load(tmp_path / "b" / "e.npz") as b:
        assert a.files == b.files
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


def test_train_synthetic_tool_on_cpu(tmp_path, capsys):
    from tools import train_synthetic_torch

    auc = train_synthetic_torch.main(["--steps", "2", "--size", "32", "--fused", "--device",
                                      "cpu", "--root", str(tmp_path)])
    out = capsys.readouterr().out
    assert "trained 2 steps" in out and "per-scene AUC:" in out and "mean scene AUC:" in out
    assert 0.0 <= auc <= 1.0


def test_visualize_tool_on_cpu(tmp_path, capsys):
    from tools import visualize_torch

    _, test_dir, _ = port_synthetic.make_synthetic_dataset(
        str(tmp_path / "data"), num_train_videos=1, num_test_videos=1, frames_per_video=9,
        size=56)
    video = os.path.join(test_dir, sorted(os.listdir(test_dir))[0])
    common = ["--preset", "tiny", "--video", video, "--device", "cpu"]
    visualize_torch.main(["heatmaps", *common, "--out", str(tmp_path / "heat")])
    assert sorted(os.listdir(tmp_path / "heat")) == [f"heat_{i:04d}.png" for i in range(8)]
    visualize_torch.main(["tsne", *common, "--out", str(tmp_path / "tsne.npz")])
    with np.load(tmp_path / "tsne.npz") as z:
        assert z["embedding"].shape[1] == 2 and len(z["labels"]) == len(z["embedding"]) > 0
    np.save(tmp_path / "a.npy", np.linspace(1, 0, 10))
    np.save(tmp_path / "b.npy", np.linspace(2, 1, 10))
    visualize_torch.main(["losses", "--records", str(tmp_path / "a.npy"),
                          str(tmp_path / "b.npy"), "--out", str(tmp_path / "l.png")])
    np.savez(tmp_path / "scores.npz", video0_01=np.stack([np.linspace(0, 1, 30)] * 2))
    visualize_torch.main(["paradigm", "--scores", str(tmp_path / "scores.npz"),
                          "--out", str(tmp_path / "p.png"),
                          "--export-csv", str(tmp_path / "temp.csv")])
    visualize_torch.main(["paradigm", "--scores", str(tmp_path / "scores.npz"),
                          "--csv", str(tmp_path / "temp.csv"), "--out", str(tmp_path / "q.png")])
    for f in ("l.png", "p.png", "q.png", "temp.csv"):
        assert (tmp_path / f).stat().st_size > 0, f
    out = capsys.readouterr().out
    assert "heat maps ->" in out and "t-SNE of" in out and "paradigm comparison ->" in out


def test_center_training_experiment_tool_on_cpu(monkeypatch, capsys):
    import json

    from tools import center_training_experiment_torch as exp

    for name, value in dict(DEVICE="cpu", WARMUP=2, LEGS=[2, 3], K=16).items():
        monkeypatch.setattr(exp, name, value)
    exp.main()
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert [r["step"] for r in lines] == [2, 3]
    assert "auc_compact_decode" not in lines[0] and 0.0 < lines[1]["occ_used"] <= 1.0
    assert all(0.0 <= r["auc_plain_decode"] <= 1.0 for r in lines)
