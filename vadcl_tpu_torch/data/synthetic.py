"""Synthetic frame-folder fixture shaped like ShanghaiTech (the port's copy
of ``make_synthetic_dataset`` in ``vadcl_tpu/data/synthetic.py``).

Writes the on-disk format the loaders expect: ``<root>/train/SS_VVVV/NNN.jpg``
and ``<root>/test/SS_VVVV/NNN.jpg`` + ``<root>/test_labels/SS_VVVV.npy``.
Normal frames are a smooth moving-gradient scene; anomalous spans inject a
bright erratic square.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np


def _frame(t: int, size: int, anomalous: bool, rng: np.random.RandomState) -> np.ndarray:
    h = w = size
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 0.4 + 0.2 * np.sin(2 * np.pi * (xx / w + 0.03 * t)) * np.cos(
        2 * np.pi * (yy / h - 0.02 * t)
    )
    img = np.stack([base, base * 0.9, base * 1.1], -1)
    # a slow-moving dark square is part of the "normal" dynamics
    cx = int((0.2 + 0.5 * ((0.01 * t) % 1.0)) * w)
    cy = h // 2
    s = size // 8
    img[max(cy - s, 0) : cy + s, max(cx - s, 0) : cx + s] *= 0.5
    if anomalous:
        ax, ay = rng.randint(0, w - s), rng.randint(0, h - s)
        img[ay : ay + s, ax : ax + s] = rng.rand(3) * 0.5 + 0.5
    return np.clip(img, 0.0, 1.0)


def make_synthetic_dataset(
    root: str,
    num_train_videos: int = 2,
    num_test_videos: int = 2,
    frames_per_video: int = 24,
    size: int = 64,
    num_scenes: int = 2,
    seed: int = 0,
) -> Tuple[str, str, str]:
    """Returns (train_dir, test_dir, label_dir)."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    train_dir = os.path.join(root, "train")
    test_dir = os.path.join(root, "test")
    label_dir = os.path.join(root, "test_labels")
    for d in (train_dir, test_dir, label_dir):
        os.makedirs(d, exist_ok=True)

    def write_video(parent: str, name: str, anomaly_span):
        vdir = os.path.join(parent, name)
        os.makedirs(vdir, exist_ok=True)
        labels = np.zeros((frames_per_video,), np.int64)
        for t in range(frames_per_video):
            anom = anomaly_span is not None and anomaly_span[0] <= t < anomaly_span[1]
            labels[t] = int(anom)
            img = (_frame(t, size, anom, rng) * 255).astype(np.uint8)
            Image.fromarray(img).save(os.path.join(vdir, "%03d.jpg" % t))
        return labels

    for i in range(num_train_videos):
        scene = i % num_scenes + 1
        write_video(train_dir, "%02d_%04d" % (scene, i + 1), None)
    for i in range(num_test_videos):
        scene = i % num_scenes + 1
        name = "%02d_%04d" % (scene, i + 1)
        span = (frames_per_video // 2, frames_per_video // 2 + frames_per_video // 4)
        labels = write_video(test_dir, name, span)
        np.save(os.path.join(label_dir, name + ".npy"), labels)
    return train_dir, test_dir, label_dir
