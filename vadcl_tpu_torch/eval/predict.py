"""Sliding-window video evaluation driving PSNR -> anomaly score -> AUC
(``vadcl_tpu/eval/predict.py``), in one process (``evaluate_videos``) or
across a process group (``evaluate_videos_distributed``).

Protocols: ``stride1`` (a window at every frame), ``nonoverlap`` (every
``frame_num`` frames), and ``stride1_first_frame`` (stride-1 windows scored
against the *first* input frame, the quirk of ``main_predict.py:415-420``).

Each video goes to the device once, as uint8; ``/255`` runs on the device
and windows are gathered there by index, ``batch_windows`` at a time.  The
batch is static, as the JAX scorer's: the last batch is padded to
``batch_windows`` by repeating its last start, and the padding's scores are
dropped.  On the card each batch replays one captured CUDA graph of the
window scorer (``utils/graphs.py:CapturedCall``), the JAX scorer's one
jitted executable a batch; the gather runs before the graph, into its
static input, so the video's length keys nothing (the JAX scorer's
``_T_BUCKET`` padding has no counterpart).  Each batch's scores are copied
out of the graph before the next replay, and each video is read back once.
``graph=False`` runs the same static batches eagerly, for comparisons; the
CPU always runs eagerly.  The per-window math is ``window_score_fn``, which
the serving export (``vadcl_tpu_torch/serve``) traces as it stands.

``pipeline_videos`` decodes ahead on one thread and stages each video onto
the card on another (the JAX pipeline's stager): a pinned host copy, then an
asynchronous copy on a staging stream whose event the scoring stream waits
on.  At most ``lookahead`` videos are decoded or staged and not yet
scored.  The per-video min-max normalisation and the per-scene AUC run on
the host.
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
from vadcl_tpu_torch.utils.graphs import CapturedCall, wants_graph

# the reference's literal ``video[:, :, 0:4]`` (vadcl_tpu/train/step.py:63)
PREDICT_INPUT_FRAMES = 4


class VideoScores(NamedTuple):
    scores: np.ndarray  # per-frame anomaly scores for the scored frames
    labels: np.ndarray  # matching ground-truth labels
    scene: str


class StagedVideo(NamedTuple):
    """A whole video on the device (from a scorer's ``stage``); on the card
    its copy is done once ``ready`` has fired."""

    video: torch.Tensor  # (T, H, W, C) uint8 or float, on the scorer's device
    num_frames: int
    ready: Optional[torch.cuda.Event] = None


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


def padded_batches(score: Callable[[torch.Tensor], torch.Tensor],
                   gather: Callable[[torch.Tensor], torch.Tensor], index: torch.Tensor,
                   batch_windows: int) -> torch.Tensor:
    """``score(gather(batch))`` over the window indices ``index`` (a 1-D
    int64 tensor) ``batch_windows`` at a time, the last batch padded to
    ``batch_windows`` by repeating its last index (its scores dropped)."""
    n = index.shape[0]
    pad = (-n) % batch_windows
    if pad:
        index = torch.cat([index, index[-1:].expand(pad)])
    outs = [score(gather(index[i:i + batch_windows]))
            for i in range(0, index.shape[0], batch_windows)]
    return torch.cat(outs)[:n]


def make_window_scorer(
    apply_fn: Callable[[torch.Tensor], torch.Tensor],
    frame_num: int,
    predict: bool,
    batch_windows: int,
    first_frame_quirk: bool = False,
    input_frames: Optional[int] = None,
    device: torch.device | str = "cuda",
    graph: Optional[bool] = None,
) -> Callable[[np.ndarray], np.ndarray]:
    """``run(windows) -> scores`` (``vadcl_tpu/eval/predict.py:151-222``):
    (n, frame_num, H, W, C) numpy windows -> (n,) or (n, frame_num), scored
    ``batch_windows`` at a time on ``device``, the tail batch padded by
    repeating the last window; on the card each batch replays a captured
    graph (``graph=False``: eagerly).  (No ``mesh``: across a process group
    the port deals videos, ``evaluate_videos_distributed``.)"""
    device = torch.device(device)
    score = window_score_fn(apply_fn, predict, first_frame_quirk, input_frames)
    if wants_graph(graph, device):
        score = CapturedCall(score, device)

    @torch.inference_mode()
    def run(windows: np.ndarray) -> np.ndarray:
        if windows.shape[0] == 0:
            return np.zeros((0,) if predict else (0, frame_num), np.float32)
        w = torch.from_numpy(np.ascontiguousarray(windows)).to(device)
        index = torch.arange(w.shape[0], device=device)
        return padded_batches(score, lambda i: w.index_select(0, i), index,
                              batch_windows).cpu().numpy()

    return run


def make_video_scorer(
    apply_fn: Callable[[torch.Tensor], torch.Tensor],
    frame_num: int,
    predict: bool,
    batch_windows: int,
    first_frame_quirk: bool = False,
    input_frames: Optional[int] = None,
    device: torch.device | str = "cuda",
    graph: Optional[bool] = None,
):
    """Build ``run(frames, starts) -> per-window MSE``: (n,) in predict mode,
    (n, frame_num) in reconstruction mode.  ``apply_fn(clips) -> recon``
    is the model forward; it receives the first ``input_frames`` frames of
    each window (all of them when None).  ``frames`` is a (T, H, W, C)
    numpy video (uint8 or float in [0, 1]) or a ``StagedVideo``.  On the
    card each batch of ``batch_windows`` windows replays one captured graph
    of the window scorer; ``graph=False`` runs the same batches eagerly."""
    score_windows = window_score_fn(apply_fn, predict, first_frame_quirk, input_frames)
    return windows_video_scorer(score_windows, frame_num, predict, batch_windows, device, graph)


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """``a`` on ``device``; to the card from pinned memory, asynchronously."""
    t = torch.from_numpy(a)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def windows_video_scorer(score_windows: Callable[[torch.Tensor], torch.Tensor],
                         frame_num: int, predict: bool, batch_windows: Optional[int],
                         device: torch.device | str = "cuda", graph: Optional[bool] = None):
    """``make_video_scorer``'s ``run`` over a window scorer: the windows of
    a staged video, gathered on ``device`` by index, go to
    ``score_windows`` (uint8 windows of a uint8 video) ``batch_windows`` at
    a time, the last batch padded to ``batch_windows`` by repeating its last
    start (its scores dropped).  On the card ``score_windows`` replays as a
    ``CapturedCall`` unless ``graph=False`` (a scorer that is one already,
    such as a static-batch serving artifact's, passes ``graph=False``).
    ``batch_windows=None`` scores a video's windows in one eager call (a
    dynamic-batch scorer).

    ``run.stage(frames)`` starts a video's copy to the device (a pinned
    host copy, then an asynchronous copy on the scorer's staging stream);
    ``run.device_scores(frames, starts)`` leaves the scores on the device
    (``run`` reads them back once a video)."""
    device = torch.device(device)
    offsets = torch.arange(frame_num, device=device)
    if batch_windows is None:
        if graph:
            raise ValueError("a dynamic batch (batch_windows=None) runs eagerly: its shape "
                             "changes with every video")
        call = score_windows
    else:
        call = CapturedCall(score_windows, device) if wants_graph(graph, device) else score_windows
    staging = torch.cuda.Stream(device) if device.type == "cuda" else None

    def stage(frames: np.ndarray) -> StagedVideo:
        host = torch.from_numpy(np.ascontiguousarray(frames))
        if staging is None:
            return StagedVideo(video=host.to(device), num_frames=int(frames.shape[0]))
        with torch.cuda.stream(staging):
            video = host.pin_memory().to(device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(staging)
        return StagedVideo(video=video, num_frames=int(frames.shape[0]), ready=ready)

    @torch.inference_mode()
    def device_scores(frames, starts: Sequence[int]) -> torch.Tensor:
        staged = frames if isinstance(frames, StagedVideo) else stage(frames)
        video = staged.video
        if staged.ready is not None:
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(staged.ready)
            # the video's memory was allocated on the staging stream
            video.record_stream(consumer)
        starts_t = _upload(np.asarray(list(starts), np.int64), device)

        def gather(batch: torch.Tensor) -> torch.Tensor:
            idx = (batch[:, None] + offsets[None, :]).reshape(-1)
            return video.index_select(0, idx).view(batch.shape[0], frame_num, *video.shape[1:])

        return padded_batches(call, gather, starts_t, batch_windows or max(len(starts), 1))

    def run(frames, starts: Sequence[int]) -> np.ndarray:
        if len(starts) == 0:
            return np.zeros((0,) if predict else (0, frame_num), np.float32)
        return device_scores(frames, starts).cpu().numpy()  # one readback per video

    run.stage = stage
    run.device_scores = device_scores
    return run


def pipeline_videos(
    scorer,
    videos: Iterable[Tuple[np.ndarray, np.ndarray, str]],
    lookahead: int = 2,
):
    """Decode the next videos on one thread and stage them with the
    scorer's ``stage`` on another while the current one scores
    (``vadcl_tpu/eval/predict.py:pipeline_videos``, its ``stager``).  At
    most ``lookahead`` videos are decoded or staged and not yet scored at
    any time (a video's slot frees when the consumer asks for the next
    one).  An error in decoding or staging is raised in the consumer; when
    the consumer stops early, both threads exit."""
    stage = getattr(scorer, "stage", None)
    slots = threading.Semaphore(max(1, lookahead))
    decoded: "queue.Queue" = queue.Queue()
    staged: "queue.Queue" = queue.Queue()
    stop = threading.Event()
    end = object()

    def decoder():
        try:
            it = iter(videos)
            while True:
                slots.acquire()
                if stop.is_set():
                    return
                try:
                    item = next(it)
                except StopIteration:
                    decoded.put(end)
                    return
                decoded.put(item)
        except BaseException as e:  # raised again in the consumer
            decoded.put(e)

    def stager():
        while True:
            item = decoded.get()
            if stop.is_set():
                return
            if item is end or isinstance(item, BaseException):
                staged.put(item)
                return
            frames, labels, scene = item
            try:
                if stage is not None:
                    frames = stage(frames)
            except BaseException as e:  # raised again in the consumer
                staged.put(e)
                return
            staged.put((frames, labels, scene))

    for target, name in ((decoder, "vadcl-decode"), (stager, "vadcl-stage")):
        threading.Thread(target=target, name=name, daemon=True).start()
    try:
        while True:
            item = staged.get()
            if isinstance(item, BaseException):
                raise item
            if item is end:
                break
            yield item
            slots.release()
    finally:
        stop.set()
        slots.release()  # wake a decoder waiting for a slot
        decoded.put(end)  # wake a stager waiting for a video


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
