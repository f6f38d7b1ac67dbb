"""Frame-folder clip dataset (the port's copy of ``vadcl_tpu/data/dataset.py``,
numpy + PIL only; ``tests/test_torch_port_data.py`` guards it against drift).

* layout: ``<root>/<video_id>/<NNN>.jpg`` frame folders, sorted; test labels
  ``<label_root>/<video_id>.npy``; scene id = ``video_id.split('_')[0]``
  (ShanghaiTech ``SS_VVVV`` naming);
* train samples: every frame index with ``frame_num`` lookahead
  (``i <= len - frame_num``), clip = ``frame_num`` consecutive frames;
* test samples: one item per video = all frames + labels + scene id;
* transform: resize to 224x224 (bilinear) as a uint8 image; the /255 runs on
  the device (train step, video scorer).  No mean/std normalisation, as in the
  reference.

Frames are decoded with PIL, imported at first use so the package imports
without it.  The threaded C++ JPEG decoder of the JAX package
(``vadcl_tpu/data/native.py``) has no counterpart here yet (ROADMAP.md).
Arrays are NDHWC.
"""

from __future__ import annotations

import glob
import os
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np


def _decode_resize(path: str, size: Tuple[int, int]) -> np.ndarray:
    """Image file -> RGB float32 in [0, 1], resized bilinear (PIL)."""
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB")
        if im.size != (size[1], size[0]):
            im = im.resize((size[1], size[0]), Image.BILINEAR)
        return np.asarray(im, np.float32) / 255.0


def load_clip(
    frame_paths: Sequence[str],
    size: Tuple[int, int] = (224, 224),
    as_uint8: bool = False,
) -> np.ndarray:
    """(T, H, W, C) float32 in [0, 1], or uint8 pixels with ``as_uint8``: the
    reference pipeline's quantisation point (resize as a uint8 image, then
    /255), so every pixel is k/255."""
    out = np.stack([_decode_resize(p, size) for p in frame_paths])
    if as_uint8:
        return np.rint(out * 255.0).astype(np.uint8)
    return out


def load_video(video_dir: str, size: Tuple[int, int] = (224, 224)) -> np.ndarray:
    paths = sorted(glob.glob(os.path.join(video_dir, "*")))
    return load_clip(paths, size)


class TestVideo(NamedTuple):
    video_dir: str
    labels_path: Optional[str]
    scene: str
    num_frames: int


@dataclass
class ClipDataset:
    """Enumerates (video, start) train samples or whole test videos."""

    root: str
    frame_num: int = 4
    size: Tuple[int, int] = (224, 224)
    label_root: Optional[str] = None
    istest: bool = False

    def __post_init__(self):
        self.videos = sorted(
            d for d in glob.glob(os.path.join(self.root, "*")) if os.path.isdir(d)
        )
        self.frames = {
            v: sorted(glob.glob(os.path.join(v, "*.jpg")))
            or sorted(glob.glob(os.path.join(v, "*")))
            for v in self.videos
        }
        if self.istest:
            self.samples: List = list(range(len(self.videos)))
        else:
            samples = []
            for vi, v in enumerate(self.videos):
                n = len(self.frames[v])
                samples.extend((vi, i) for i in range(max(n - self.frame_num + 1, 0)))
            self.samples = samples

    def __len__(self) -> int:
        return len(self.samples)

    def get_clip(self, index: int) -> np.ndarray:
        """Train sample: (frame_num, H, W, C) uint8 (normalised on the device
        by the train step)."""
        vi, start = self.samples[index]
        paths = self.frames[self.videos[vi]][start : start + self.frame_num]
        if len(paths) < self.frame_num:
            # lookahead walked off the end: repeat the last frame
            paths = paths + [paths[-1]] * (self.frame_num - len(paths))
        return load_clip(paths, self.size, as_uint8=True)

    def get_test_video(self, index: int) -> Tuple[np.ndarray, np.ndarray, str]:
        """Test sample: (frames (T, H, W, C) uint8, labels (T,), scene)."""
        v = self.videos[index]
        name = os.path.basename(v)
        scene = name.split("_")[0]
        frames = load_clip(self.frames[v], self.size, as_uint8=True)
        if self.label_root:
            labels = np.load(os.path.join(self.label_root, name + ".npy"))
            labels = np.asarray(labels).ravel()
        else:
            labels = np.zeros((frames.shape[0],), np.int64)
        return frames, labels, scene

    def iter_test_videos(self):
        for i in range(len(self.videos)):
            yield self.get_test_video(i)
