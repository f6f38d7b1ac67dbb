from vadcl_tpu_torch.eval.predict import (
    VideoScores,
    eval_input_frames,
    evaluate_videos,
    make_video_scorer,
    score_video,
    sliding_windows,
)
from vadcl_tpu_torch.eval.scoring import (
    anomaly_score,
    mean_scene_auc,
    per_scene_auc,
    psnr,
    roc_auc,
)

__all__ = [
    "VideoScores",
    "anomaly_score",
    "eval_input_frames",
    "evaluate_videos",
    "make_video_scorer",
    "mean_scene_auc",
    "per_scene_auc",
    "psnr",
    "roc_auc",
    "score_video",
    "sliding_windows",
]
