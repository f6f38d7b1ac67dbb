"""Synthetic frame-folder fixtures shaped like ShanghaiTech (the port's copy
of ``make_synthetic_dataset``, ``_pattern_frame`` and
``make_latent_anomaly_dataset`` in ``vadcl_tpu/data/synthetic.py``).

Writes the on-disk format the loaders expect: ``<root>/train/SS_VVVV/NNN.jpg``
and ``<root>/test/SS_VVVV/NNN.jpg`` + ``<root>/test_labels/SS_VVVV.npy``.
In ``make_synthetic_dataset`` normal frames are a smooth moving-gradient
scene and anomalous spans inject a bright erratic square; in
``make_latent_anomaly_dataset`` the anomaly is a striped patch's orientation
and motion, at the normal frames' pixel statistics.
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


def _pattern_frame(
    t: int, size: int, kind: int, phase: float, size_frac: float = 0.25
) -> np.ndarray:
    """One frame of a moving striped patch.  ``kind`` selects the motion and
    stripe orientation jointly; all kinds share identical brightness,
    contrast, and patch area, so frames are matched in raw pixel statistics
    and differ only in spatio-temporal STRUCTURE:

    * kind 0: vertical stripes, patch translates left->right
    * kind 1: vertical stripes, patch translates right->left
    * kind 2 (the anomaly): horizontal stripes, patch translates downward

    A reconstruction model trained only on kinds 0/1 has latent prototypes
    for "vertical stripes moving horizontally"; kind 2 produces latents off
    the prototype manifold while keeping per-frame pixel statistics equal —
    the separation must come from the LATENT structure, not brightness."""
    h = w = size
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.full((h, w, 3), 0.45, np.float32)
    s = max(int(size * size_frac), 8)
    speed = 0.035
    pos = (phase + speed * t) % 1.0
    if kind == 0:
        cx, cy = int(pos * (w - s)), (h - s) // 2
    elif kind == 1:
        cx, cy = int((1.0 - pos) * (w - s)), (h - s) // 2
    else:
        cx, cy = (w - s) // 2, int(pos * (h - s))
    patch_y = yy[cy : cy + s, cx : cx + s]
    patch_x = xx[cy : cy + s, cx : cx + s]
    coord = patch_x if kind in (0, 1) else patch_y
    stripes = 0.45 + 0.25 * np.sin(2 * np.pi * coord / 8.0)
    img[cy : cy + s, cx : cx + s] = stripes[..., None]
    return np.clip(img, 0.0, 1.0)


def make_latent_anomaly_dataset(
    root: str,
    num_train_videos: int = 4,
    num_test_videos: int = 2,
    frames_per_video: int = 32,
    size: int = 56,
) -> Tuple[str, str, str]:
    """Non-saturated fixture: anomalies are separable via latent structure,
    not pixel statistics (VERDICT r3 item 6 / the reference's ablation
    protocol ``实验记录.xlsx`` rows 5/9/11).

    Train videos cycle the two NORMAL patterns (kinds 0/1).  Each test video
    runs a normal pattern except for a middle span of the ANOMALOUS pattern
    (kind 2) — same brightness/contrast/patch-area, novel orientation+motion.
    Unlike ``make_synthetic_dataset`` (bright random square -> AUC saturates
    at ~0.99), plain reconstruction picks this up only weakly; prototype
    regularization (cluster heads + compactness decode) is what should widen
    the margin.  Returns (train_dir, test_dir, label_dir)."""
    train_dir = os.path.join(root, "train")
    test_dir = os.path.join(root, "test")
    label_dir = os.path.join(root, "test_labels")
    for d in (train_dir, test_dir, label_dir):
        os.makedirs(d, exist_ok=True)

    from PIL import Image

    def write(parent: str, name: str, kinds) -> np.ndarray:
        vdir = os.path.join(parent, name)
        os.makedirs(vdir, exist_ok=True)
        labels = np.zeros((frames_per_video,), np.int64)
        for t in range(frames_per_video):
            kind = kinds(t)
            labels[t] = int(kind == 2)
            img = (_pattern_frame(t, size, kind, 0.15) * 255).astype(np.uint8)
            Image.fromarray(img).save(os.path.join(vdir, "%03d.jpg" % t))
        return labels

    for i in range(num_train_videos):
        scene = i % 2 + 1
        kind = i % 2  # both normal patterns, split across videos
        write(train_dir, "%02d_%04d" % (scene, i + 1), lambda t, k=kind: k)
    lo = frames_per_video // 3
    hi = 2 * frames_per_video // 3
    for i in range(num_test_videos):
        scene = i % 2 + 1
        name = "%02d_%04d" % (scene, i + 1)
        base = i % 2
        labels = write(
            test_dir, name,
            lambda t, b=base: 2 if lo <= t < hi else b,
        )
        np.save(os.path.join(label_dir, name + ".npy"), labels)
    return train_dir, test_dir, label_dir
