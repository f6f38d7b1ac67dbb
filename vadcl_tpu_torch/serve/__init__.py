"""Serving: the window scorer as a self-contained ``torch.export`` artifact.

``export_window_scorer`` traces ``eval.predict.window_score_fn`` of a model
with its weights into an ``ExportedProgram`` whose graph calls the
hand-written kernels as ``torch.library`` ops (``ops/library.py``); a
serving process loads it with ``load_artifact``, which imports those ops
and nothing of the model code, and scores windows of uint8 frames.
"""

from vadcl_tpu_torch.serve.export import (
    ServingArtifact,
    artifact_window_runner,
    export_window_scorer,
    load_artifact,
    save_artifact,
)

__all__ = [
    "ServingArtifact",
    "artifact_window_runner",
    "export_window_scorer",
    "load_artifact",
    "save_artifact",
]
