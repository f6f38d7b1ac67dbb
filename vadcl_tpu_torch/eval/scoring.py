"""Anomaly scoring math: PSNR, min-max anomaly score, frame-level ROC-AUC.

A copy of ``vadcl_tpu/eval/scoring.py`` (numpy only): importing the JAX
package's ``eval`` pulls in jax.  ``tests/test_torch_port_eval.py`` holds the
two copies equal.

Parity targets: ``misc/utils.py:124`` (psnr = 10 log10(1/mse)), ``:131``
(anomaly = 1 - minmax(psnr), per video), and the per-scene AUC averaging of
``tool/contrast_evaluae.py:276-299`` / ``main_predict.py:443-455``.  The AUC
is our own rank-based (Mann-Whitney) implementation with midrank tie handling
— numerically identical to sklearn.roc_auc_score, no sklearn on the eval path.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def psnr(mse: np.ndarray) -> np.ndarray:
    """10 * log10(1 / mse), elementwise (``misc/utils.py:124-128``).
    Inputs are per-frame mean squared errors of [0,1]-ranged frames."""
    mse = np.asarray(mse, np.float64)
    return 10.0 * np.log10(1.0 / mse)


def anomaly_score(psnr_values: np.ndarray) -> np.ndarray:
    """1 - minmax-normalized PSNR, computed PER VIDEO
    (``misc/utils.py:131-135``) — higher = more anomalous."""
    p = np.asarray(psnr_values, np.float64)
    p_min, p_max = p.min(), p.max()
    denom = p_max - p_min
    if denom == 0:
        return np.zeros_like(p)
    return 1.0 - (p - p_min) / denom


def roc_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Frame-level ROC-AUC via the Mann-Whitney U statistic with midranks;
    identical to sklearn.roc_auc_score for binary labels."""
    labels = np.asarray(labels).astype(np.int64).ravel()
    scores = np.asarray(scores, np.float64).ravel()
    assert labels.shape == scores.shape
    n_pos = int(labels.sum())
    n_neg = labels.size - n_pos
    if n_pos == 0 or n_neg == 0:
        raise ValueError("roc_auc needs both classes present")
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty(scores.size, np.float64)
    sorted_scores = scores[order]
    # midranks for ties
    i = 0
    while i < scores.size:
        j = i
        while j + 1 < scores.size and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        ranks[order[i : j + 1]] = 0.5 * (i + j) + 1.0
        i = j + 1
    rank_sum_pos = ranks[labels == 1].sum()
    u = rank_sum_pos - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


def per_scene_auc(
    scene_scores: Dict[str, np.ndarray], scene_labels: Dict[str, np.ndarray]
) -> Dict[str, float]:
    """Group per-video score/label streams by scene id, AUC per scene
    (``tool/contrast_evaluae.py:276-299``).  Returns {scene: auc}; the
    headline metric is the plain mean of the values."""
    out = {}
    for scene in scene_scores:
        out[scene] = roc_auc(scene_labels[scene], scene_scores[scene])
    return out


def mean_scene_auc(scene_aucs: Dict[str, float]) -> float:
    return float(np.mean(list(scene_aucs.values())))
