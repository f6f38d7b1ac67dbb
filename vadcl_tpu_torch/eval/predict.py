"""Sliding-window video evaluation driving PSNR -> anomaly score -> AUC
(``vadcl_tpu/eval/predict.py``), in one process (``evaluate_videos``) or
across a process group (``evaluate_videos_distributed``).

Protocols: ``stride1`` (a window at every frame), ``nonoverlap`` (every
``frame_num`` frames), and ``stride1_first_frame`` (stride-1 windows scored
against the *first* input frame, the quirk of ``main_predict.py:415-420``).

Each video goes to the device once, as uint8; ``/255`` runs on the device
and windows are gathered there by index, ``batch_windows`` at a time (the
last batch may be short).  The per-window math is ``window_score_fn``,
which the serving export (``vadcl_tpu_torch/serve``) traces as it stands.
A producer thread decodes ahead, holding at most ``lookahead``
decoded-but-unscored videos.  The per-video min-max normalisation and the
per-scene AUC run on the host.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Callable, Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from vadcl_tpu_torch.core.mesh import process_count, process_index
from vadcl_tpu_torch.eval.scoring import anomaly_score, mean_scene_auc, per_scene_auc, psnr
from vadcl_tpu_torch.parallel.sharding import cross_host_gather_ragged

# the reference's literal ``video[:, :, 0:4]`` (vadcl_tpu/train/step.py:63)
PREDICT_INPUT_FRAMES = 4


class VideoScores(NamedTuple):
    scores: np.ndarray  # per-frame anomaly scores for the scored frames
    labels: np.ndarray  # matching ground-truth labels
    scene: str


class StagedVideo(NamedTuple):
    """A whole video already on the device (from a scorer's ``stage``)."""

    video: torch.Tensor  # (T, H, W, C) uint8 or float, on the scorer's device
    num_frames: int


def sliding_windows(num_frames: int, frame_num: int, protocol: str) -> List[int]:
    """Window start indices.  Both protocols keep the reference's loop bound
    ``start + frame_num < num_frames`` (the final possible window is
    dropped, faithfully)."""
    stride = 1 if protocol.startswith("stride1") else frame_num
    return list(range(0, max(num_frames - frame_num, 0), stride))


def eval_input_frames(backbone: str, predict: bool, frame_num: int) -> Optional[int]:
    """How many leading window frames the model sees (None = all):
    ``convae_predict`` all but the target frame; flagship predict mode
    exactly the first 4 (the reference hardcodes ``clip[:, :, 0:4]``);
    reconstruction modes the full window."""
    if backbone == "convae_predict":
        if frame_num < 2:
            raise ValueError(
                "convae_predict needs frame_num >= 2 (frame_num-1 input "
                f"frames + 1 target), got {frame_num}"
            )
        return frame_num - 1
    if predict:
        return PREDICT_INPUT_FRAMES
    return None


def window_score_fn(
    apply_fn: Callable[[torch.Tensor], torch.Tensor],
    predict: bool,
    first_frame_quirk: bool = False,
    input_frames: Optional[int] = None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """The window-scoring math (``vadcl_tpu/eval/predict.py:122-148``):
    (B, frame_num, H, W, C) uint8 windows (``/255`` inside) or float
    windows in [0, 1] -> the per-window MSE (B,) in predict mode, against
    the last frame (the first with ``first_frame_quirk``), or the per-frame
    MSE (B, frame_num) in reconstruction mode.  ``apply_fn(inputs) ->
    recon`` sees the first ``input_frames`` frames (all when None)."""

    def score(clips: torch.Tensor) -> torch.Tensor:
        clips = clips.float() / 255.0 if clips.dtype == torch.uint8 else clips.float()
        inputs = clips[:, :input_frames] if input_frames is not None else clips
        recon = apply_fn(inputs).float()
        if predict:
            target = clips[:, 0:1] if first_frame_quirk else clips[:, -1:]
            return ((recon - target) ** 2).mean(dim=(1, 2, 3, 4))
        return ((recon - clips) ** 2).mean(dim=(2, 3, 4))

    return score


def padded_batches(score: Callable[[torch.Tensor], torch.Tensor], windows: torch.Tensor,
                   batch_windows: int) -> torch.Tensor:
    """``score`` over ``windows`` ``batch_windows`` at a time, the tail batch
    padded by repeating the last window (its scores dropped)."""
    n = windows.shape[0]
    pad = (-n) % batch_windows
    if pad:
        windows = torch.cat([windows, windows[-1:].expand(pad, *windows.shape[1:])])
    outs = [score(windows[i:i + batch_windows]) for i in range(0, windows.shape[0], batch_windows)]
    return torch.cat(outs)[:n]


def make_window_scorer(
    apply_fn: Callable[[torch.Tensor], torch.Tensor],
    frame_num: int,
    predict: bool,
    batch_windows: int,
    first_frame_quirk: bool = False,
    input_frames: Optional[int] = None,
    device: torch.device | str = "cuda",
) -> Callable[[np.ndarray], np.ndarray]:
    """``run(windows) -> scores`` (``vadcl_tpu/eval/predict.py:151-222``):
    (n, frame_num, H, W, C) numpy windows -> (n,) or (n, frame_num), scored
    ``batch_windows`` at a time on ``device``, the tail batch padded by
    repeating the last window.  (No ``mesh``: across a process group the
    port deals videos, ``evaluate_videos_distributed``.)"""
    device = torch.device(device)
    score = window_score_fn(apply_fn, predict, first_frame_quirk, input_frames)

    @torch.inference_mode()
    def run(windows: np.ndarray) -> np.ndarray:
        if windows.shape[0] == 0:
            return np.zeros((0,) if predict else (0, frame_num), np.float32)
        w = torch.from_numpy(np.ascontiguousarray(windows)).to(device)
        return padded_batches(score, w, batch_windows).cpu().numpy()

    return run


def make_video_scorer(
    apply_fn: Callable[[torch.Tensor], torch.Tensor],
    frame_num: int,
    predict: bool,
    batch_windows: int,
    first_frame_quirk: bool = False,
    input_frames: Optional[int] = None,
    device: torch.device | str = "cuda",
):
    """Build ``run(frames, starts) -> per-window MSE``: (n,) in predict mode,
    (n, frame_num) in reconstruction mode.  ``apply_fn(clips) -> recon``
    is the model forward; it receives the first ``input_frames`` frames of
    each window (all of them when None).  ``frames`` is a (T, H, W, C)
    numpy video (uint8 or float in [0, 1]) or a ``StagedVideo``."""
    score_windows = window_score_fn(apply_fn, predict, first_frame_quirk, input_frames)
    return windows_video_scorer(score_windows, frame_num, predict, batch_windows, device)


def windows_video_scorer(score_windows: Callable[[torch.Tensor], torch.Tensor],
                         frame_num: int, predict: bool, batch_windows: int,
                         device: torch.device | str = "cuda", pad_tail: bool = False):
    """``make_video_scorer``'s ``run`` over a window scorer: the windows of
    a staged video, gathered on ``device`` by index, go to
    ``score_windows`` (uint8 windows of a uint8 video) ``batch_windows`` at
    a time; with ``pad_tail`` the last batch is padded to ``batch_windows``
    by repeating its last window (a scorer of one batch size, such as a
    static-batch serving artifact)."""
    device = torch.device(device)
    offsets = torch.arange(frame_num, device=device)

    def stage(frames: np.ndarray) -> StagedVideo:
        video = torch.from_numpy(np.ascontiguousarray(frames)).to(device)
        return StagedVideo(video=video, num_frames=int(frames.shape[0]))

    @torch.inference_mode()
    def score(video: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
        windows = video[starts[:, None] + offsets[None, :]]  # (B, frame_num, H, W, C)
        if pad_tail:
            return padded_batches(score_windows, windows, batch_windows)
        return score_windows(windows)

    def run(frames, starts: Sequence[int]) -> np.ndarray:
        starts_np = np.asarray(list(starts), np.int64)
        if starts_np.size == 0:
            return np.zeros((0,) if predict else (0, frame_num), np.float32)
        staged = frames if isinstance(frames, StagedVideo) else stage(frames)
        starts_t = torch.from_numpy(starts_np).to(device)
        outs = [
            score(staged.video, starts_t[i : i + batch_windows])
            for i in range(0, starts_np.size, batch_windows)
        ]
        return torch.cat(outs).cpu().numpy()  # one readback per video

    run.stage = stage
    return run


def pipeline_videos(
    scorer,
    videos: Iterable[Tuple[np.ndarray, np.ndarray, str]],
    lookahead: int = 2,
):
    """Decode the next videos on a producer thread while the current one
    scores.  At most ``lookahead`` videos are decoded and not yet scored at
    any time (the slot of a video frees when the consumer asks for the next
    one).  Videos are staged onto the device as they are handed out."""
    stage = getattr(scorer, "stage", None)
    slots = threading.Semaphore(max(1, lookahead))
    q: "queue.Queue" = queue.Queue()
    stop = threading.Event()
    end = object()

    def producer():
        try:
            it = iter(videos)
            while True:
                slots.acquire()
                if stop.is_set():
                    return
                try:
                    item = next(it)
                except StopIteration:
                    q.put(end)
                    return
                q.put(item)
        except BaseException as e:  # surface decode errors to the consumer
            q.put(e)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if isinstance(item, BaseException):
                raise item
            if item is end:
                break
            frames, labels, scene = item
            if stage is not None:
                frames = stage(frames)
            yield frames, labels, scene
            slots.release()
    finally:
        stop.set()
        slots.release()  # wake a producer waiting for a slot so it can exit


def score_video(
    scorer,
    frames,  # (T, H, W, C) numpy video or StagedVideo
    labels: np.ndarray,  # (T,) int
    frame_num: int,
    predict: bool,
    protocol: str = "stride1",
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-frame MSEs + aligned labels for one whole video."""
    num_frames = frames.num_frames if isinstance(frames, StagedVideo) else frames.shape[0]
    starts = sliding_windows(num_frames, frame_num, protocol)
    if not starts:
        return np.zeros((0,)), np.zeros((0,), np.int64)
    mse = scorer(frames, starts)
    labels = np.asarray(labels).ravel()
    if predict:
        return mse.ravel(), np.array([labels[s + frame_num] for s in starts])
    return mse.reshape(-1), np.concatenate([labels[s : s + frame_num] for s in starts])


def evaluate_videos(
    scorer,
    videos: Iterable[Tuple[np.ndarray, np.ndarray, str]],
    frame_num: int,
    predict: bool,
    protocol: str = "stride1",
    lookahead: int = 2,
) -> Tuple[float, Dict[str, float], List[VideoScores]]:
    """Per-video PSNR -> min-max anomaly score, grouped by scene, AUC per
    scene, mean over scenes (``tool/contrast_evaluae.py:258-299``)."""
    scene_scores: Dict[str, np.ndarray] = {}
    scene_labels: Dict[str, np.ndarray] = {}
    per_video = _score_videos(scorer, videos, frame_num, predict, protocol, lookahead)
    for v in per_video:
        if v.scene in scene_scores:
            scene_scores[v.scene] = np.append(scene_scores[v.scene], v.scores)
            scene_labels[v.scene] = np.append(scene_labels[v.scene], v.labels)
        else:
            scene_scores[v.scene] = v.scores
            scene_labels[v.scene] = v.labels
    aucs = per_scene_auc(scene_scores, scene_labels)
    return mean_scene_auc(aucs), aucs, per_video


def _score_videos(scorer, videos, frame_num, predict, protocol, lookahead
                  ) -> List[VideoScores]:
    """Each video's per-frame anomaly scores (PSNR -> min-max), in order;
    a video too short for one window is left out."""
    per_video: List[VideoScores] = []
    for frames, labels, scene in pipeline_videos(scorer, videos, lookahead):
        frame_mse, frame_labels = score_video(
            scorer, frames, labels, frame_num, predict, protocol
        )
        if frame_mse.size == 0:
            continue
        per_video.append(VideoScores(scores=anomaly_score(psnr(frame_mse)),
                                     labels=frame_labels, scene=scene))
    return per_video


def scene_names(video_dirs: Iterable[str]) -> List[str]:
    """The ordered scenes of a test split: each video directory's name up
    to its first "_" (``ClipDataset.get_test_video``'s scene)."""
    return sorted({os.path.basename(v).split("_")[0] for v in video_dirs})


def evaluate_videos_distributed(
    scorer,
    num_videos: int,
    get_video: Callable[[int], Tuple[np.ndarray, np.ndarray, str]],
    all_scenes: Sequence[str],
    frame_num: int,
    predict: bool,
    protocol: str = "stride1",
    lookahead: int = 2,
) -> Tuple[float, Dict[str, float], List[VideoScores]]:
    """``evaluate_videos`` across a process group: process ``r`` of ``P``
    scores videos ``r, r + P, ...`` on its own card, then the per-frame
    anomaly scores (float64), labels (int64) and scene ids gather in rank
    order (``cross_host_gather_ragged``; a process may have scored none),
    and every process computes the same per-scene AUC and its mean.

    ``all_scenes`` is the same ordered scene list on every process (from
    the full dataset listing).  The returned ``per_video`` holds this
    process's videos only.  Outside a group this process scores every
    video, and the AUCs are ``evaluate_videos``' (the scenes in
    ``all_scenes`` order)."""
    rank, world = process_index(), process_count()
    scene_to_idx = {s: i for i, s in enumerate(all_scenes)}
    local = (get_video(i) for i in range(rank, num_videos, world))
    per_video = _score_videos(scorer, local, frame_num, predict, protocol, lookahead)

    def gathered(part: Callable[[VideoScores], np.ndarray], dtype) -> np.ndarray:
        mine = [np.asarray(part(v), dtype) for v in per_video]
        return cross_host_gather_ragged(np.concatenate(mine) if mine else np.zeros(0, dtype))

    g_scores = gathered(lambda v: v.scores, np.float64)
    g_labels = gathered(lambda v: v.labels, np.int64)
    g_scene = gathered(lambda v: np.full(len(v.scores), scene_to_idx[v.scene]), np.int64)
    scene_scores = {s: g_scores[g_scene == i] for i, s in enumerate(all_scenes)
                    if np.any(g_scene == i)}
    scene_labels = {s: g_labels[g_scene == scene_to_idx[s]] for s in scene_scores}
    aucs = per_scene_auc(scene_scores, scene_labels)
    return mean_scene_auc(aucs), aucs, per_video
