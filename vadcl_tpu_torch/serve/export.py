"""Export / reload the window scorer as a ``torch.export`` artifact
(``vadcl_tpu/serve/export.py``).

``torch.export.export`` traces ``window_score_fn(model)`` once under
``torch.no_grad()``, after one forward that fills the blocks' gathered
rel-pos biases and shift masks: the model's weights ride in the program as
its parameters and buffers, the gathered biases and the shift masks as its
constants on the device, and
each hand-written kernel is a graph node (``torch.ops.vadcl.*``,
``ops/library.py``) that runs the kernel's launch when the loaded program is
called, on the card, or its plain version on the CPU.  The kernels' packed
operands are made at the first call of the loaded program and cached as in
the live model.

Artifact layout (a directory):
  scorer.pt2   ``torch.export.save`` of the ExportedProgram
  meta.json    input spec, protocol fields, device, torch version

The exported function maps (batch, frame_num, H, W, C) uint8 (or float32)
windows to the anomaly MSE per window (predict mode) or per frame
(reconstruction mode); ``/255`` runs inside the program.  The fused kernels
take a static batch: a model with ``fused_attention`` or ``fused_cluster``
exports at a fixed ``batch_windows``, as the JAX package's Pallas path
does; ``batch_windows=None`` (a dynamic batch dimension) is for the plain
model.  On the card a static-batch artifact's ``score`` replays one
captured CUDA graph of the loaded program a call
(``utils/graphs.py:CapturedCall``), as the JAX artifact runs its program
under ``jax.jit``; a dynamic-batch artifact runs eagerly, its shape
changing with every video.
"""

from __future__ import annotations

import json
import os
from typing import Callable, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from vadcl_tpu_torch.eval.predict import padded_batches, window_score_fn
from vadcl_tpu_torch.utils.graphs import CapturedCall, wants_graph

_PROGRAM = "scorer.pt2"
_META = "meta.json"


class ServingArtifact(NamedTuple):
    """A reloaded scorer: ``score`` runs the loaded program under
    ``torch.no_grad`` on windows (a numpy array or a tensor) and returns
    a tensor on ``device``.  ``batch_windows`` is None for a dynamic-batch
    artifact, which takes any batch.  ``program`` is the loaded program's
    module (its parameters may be updated in place: a captured ``score``
    captures anew)."""

    score: Callable[[Union[np.ndarray, torch.Tensor]], torch.Tensor]
    batch_windows: Optional[int]
    frame_num: int
    image_size: Tuple[int, int]
    channels: int
    input_dtype: str
    predict: bool
    device: torch.device
    meta: dict
    program: torch.nn.Module


class _WindowScorer(torch.nn.Module):
    """``window_score_fn`` of ``model`` as a module, the thing exported."""

    def __init__(self, model: torch.nn.Module, predict: bool, first_frame_quirk: bool,
                 input_frames: Optional[int]):
        super().__init__()
        self.model = model
        self.score = window_score_fn(self._recon, predict, first_frame_quirk, input_frames)

    def _recon(self, inputs: torch.Tensor) -> torch.Tensor:
        out = self.model(inputs)
        return out.recon if hasattr(out, "recon") else out

    def forward(self, clips: torch.Tensor) -> torch.Tensor:
        return self.score(clips)


def _fused(model: torch.nn.Module) -> bool:
    cfg = getattr(model, "config", None)
    return bool(cfg is not None and (cfg.fused_attention or cfg.fused_cluster))


def export_window_scorer(
    model: torch.nn.Module,
    *,
    batch_windows: Optional[int],
    frame_num: int,
    image_size: Tuple[int, int],
    channels: int = 3,
    predict: bool = True,
    first_frame_quirk: bool = False,
    input_frames: Optional[int] = None,
    input_dtype: str = "uint8",
) -> Tuple[torch.export.ExportedProgram, dict]:
    """Trace the scorer of ``model`` (its forward returns the recon or a
    ``VADOutput``) on the device of its parameters; returns (program,
    meta).  ``batch_windows=None`` exports a dynamic batch dimension
    (``torch.export.Dim``): the plain model only (a fused model raises
    ``ValueError``).  The model is traced as it is (its mode is not
    changed); its scoring forward draws no dropout mask."""
    if batch_windows is None and _fused(model):
        raise ValueError(
            "a dynamic batch (batch_windows=None) needs the plain model: the fused "
            "kernels export at a static batch; pass batch_windows or build the model "
            "with fused_attention=fused_cluster=False")
    device = next(model.parameters()).device
    h, w = image_size
    example = torch.zeros((batch_windows or 2, frame_num, h, w, channels),
                          dtype=getattr(torch, input_dtype), device=device)
    dynamic = None
    if batch_windows is None:
        dynamic = ({0: torch.export.Dim("batch", min=1)},)
    scorer = _WindowScorer(model, predict, first_frame_quirk, input_frames)
    with torch.no_grad():
        scorer(example)  # fills the blocks' bias and mask memos, the program's constants
        program = torch.export.export(scorer, (example,), dynamic_shapes=dynamic,
                                      strict=False)
    outputs = next(n for n in program.graph.nodes if n.op == "output").args[0]
    out_shape = [[d if isinstance(d, int) else "batch" for d in o.meta["val"].shape]
                 for o in outputs]
    meta = {
        "format": "torch.export.ExportedProgram",
        "torch_version": torch.__version__,
        "device": device.type,
        "batch_windows": batch_windows,
        "frame_num": frame_num,
        "image_size": [h, w],
        "channels": channels,
        "input_dtype": input_dtype,
        "predict": predict,
        "first_frame_quirk": first_frame_quirk,
        "input_frames": input_frames,
        "out_shape": out_shape,
        "ops": sorted({str(n.target) for n in program.graph.nodes
                       if n.op == "call_function" and str(n.target).startswith("vadcl.")}),
    }
    return program, meta


def save_artifact(path: str, program: torch.export.ExportedProgram, meta: dict) -> None:
    os.makedirs(path, exist_ok=True)
    torch.export.save(program, os.path.join(path, _PROGRAM))
    with open(os.path.join(path, _META), "w") as f:
        json.dump(meta, f, indent=1)


def load_artifact(path: str, graph: Optional[bool] = None) -> ServingArtifact:
    """Load an artifact directory into a callable scorer on the device it
    was exported on.  Registers the kernels' ops (``ops/library.py``)
    first; imports nothing of the model code.  A static-batch artifact's
    ``score`` takes exactly its batch (``artifact_window_runner`` pads) and
    on the card replays a captured graph of the program (``graph=False``:
    eagerly, for comparisons); a dynamic-batch artifact runs eagerly."""
    import vadcl_tpu_torch.ops.library  # noqa: F401  (registers torch.ops.vadcl.*)

    with open(os.path.join(path, _META)) as f:
        meta = json.load(f)
    program = torch.export.load(os.path.join(path, _PROGRAM))
    module = program.module()
    device = torch.device(meta["device"])
    dtype = getattr(torch, meta["input_dtype"])
    bw = meta["batch_windows"]
    if bw is None:
        if graph:
            raise ValueError("a dynamic-batch artifact runs eagerly: its batch changes with "
                             "every video")
        call = module
    else:
        call = CapturedCall(module, device) if wants_graph(graph, device) else module

    def score(windows: Union[np.ndarray, torch.Tensor]) -> torch.Tensor:
        if isinstance(windows, np.ndarray):
            windows = torch.from_numpy(np.ascontiguousarray(windows))
        with torch.no_grad():
            return call(windows.to(device=device, dtype=dtype))

    return ServingArtifact(
        score=score,
        batch_windows=None if bw is None else int(bw),
        frame_num=int(meta["frame_num"]),
        image_size=tuple(meta["image_size"]),
        channels=int(meta["channels"]),
        input_dtype=meta["input_dtype"],
        predict=bool(meta["predict"]),
        device=device,
        meta=meta,
        program=module,
    )


def artifact_window_runner(art: ServingArtifact) -> Callable[[np.ndarray], np.ndarray]:
    """A loaded artifact as an any-length window scorer (the contract of
    ``eval.predict.make_window_scorer``'s runner): (n, frame_num, H, W, C)
    numpy -> (n,) or (n, frame_num) numpy, the tail batch padded by
    repeating the last window; a dynamic-batch artifact takes the windows
    in one call."""
    bw = art.batch_windows

    def run(windows: np.ndarray) -> np.ndarray:
        if bw is None:
            return art.score(windows).cpu().numpy()
        w = torch.from_numpy(np.ascontiguousarray(windows))
        index = torch.arange(w.shape[0])
        return padded_batches(art.score, lambda i: w.index_select(0, i), index, bw).cpu().numpy()

    return run
