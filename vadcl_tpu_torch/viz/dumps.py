"""Visual-inspection dumps (the port's copy of ``save_clip_frames`` and
``error_heatmap`` in ``vadcl_tpu/viz/dumps.py``; numpy + PIL, PIL imported at
first use; ``tests/test_torch_port_data.py`` guards it against drift)."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def save_clip_frames(
    clip: np.ndarray, output_dir: str = "video_show", save_name: Optional[str] = None
) -> None:
    """clip: (B, T, H, W, C) float in [0, 1] or uint8 ->
    <dir>/<b>/imgN.jpg per frame."""
    from PIL import Image

    clip = np.asarray(clip)
    if clip.dtype == np.uint8:
        clip = clip.astype(np.float32) / 255.0
    else:
        clip = clip.astype(np.float32)
    os.makedirs(output_dir, exist_ok=True)
    for b in range(clip.shape[0]):
        vdir = os.path.join(output_dir, str(b))
        os.makedirs(vdir, exist_ok=True)
        for t in range(clip.shape[1]):
            img = np.clip(clip[b, t] * 255.0 + 0.5, 0, 255).astype(np.uint8)
            name = save_name or f"img{t}.jpg"
            Image.fromarray(img).save(os.path.join(vdir, name))


def _jet(x: np.ndarray) -> np.ndarray:
    """Minimal jet colormap, x in [0, 1] -> (..., 3) uint8."""
    x = np.clip(x, 0.0, 1.0)
    r = np.clip(1.5 - np.abs(4 * x - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * x - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * x - 1), 0, 1)
    return (np.stack([r, g, b], -1) * 255).astype(np.uint8)


def error_heatmap(recon: np.ndarray, origin: np.ndarray, gain: float = 10.0) -> np.ndarray:
    """Jet heat map of the squared difference of the min-max normalised
    grayscale images, times ``gain``."""

    def gray_norm(img):
        g = np.asarray(img, np.float32) @ np.array([0.2125, 0.7154, 0.0721])
        mn, mx = g.min(), g.max()
        return (g - mn) / (mx - mn + 1e-12)

    d = np.abs(gray_norm(origin) - gray_norm(recon)) ** 2 * gain
    return _jet(d)
