"""Checkpoint manager with auto-resume (``vadcl_tpu/train/checkpoint.py``).

A checkpoint is the JAX package's file: one flat npz per tag,
``<dir>/ckpt_<tag>.npz``, holding a ``TrainState`` as "/"-joined paths:
``step``, ``params/...``, ``extras/batch_stats/...``, the memory families'
bank ``extras/memory/...`` and the optimizer's ``opt_state/...``
(``convert.py`` maps every leaf), plus a JSON ``__meta__`` entry.  So each
package resumes from the other's checkpoints.  ``tolerant_merge`` is the
partial load of the JAX package's export CLI: whatever matches, the rest
kept.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from typing import Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from vadcl_tpu_torch.convert import (
    EXTRAS,
    _to_torch_layout,
    _torch_key,
    jax_from_state_dict,
    load_state_dict_strict,
    opt_state_from_jax,
    opt_state_to_jax,
    state_dict_from_jax,
)
from vadcl_tpu_torch.train.step import TrainState

_NUMERIC = re.compile(r"ckpt_(\d+)\.npz")


def flatten_train_state(state: TrainState) -> Dict[str, np.ndarray]:
    """``state`` as the flat dict ``vadcl_tpu.train.checkpoint.flatten_state``
    makes of a JAX ``TrainState``."""
    predict = state.model.config.predict
    flat = {"step": np.asarray(state.step, np.int32)}
    for k, v in jax_from_state_dict(state.model.state_dict(), predict=predict).items():
        flat[k if k.startswith("params/") else "extras/" + k] = v
    flat.update(opt_state_to_jax(state.model, state.optimizer, predict=predict))
    return flat


def load_train_state(flat: Dict[str, np.ndarray], state: TrainState) -> TrainState:
    """Fill ``state`` (model with its bank, optimizer, step) from a flat
    TrainState dict, strictly: a missing or leftover parameter, statistic
    or bank raises."""
    predict = state.model.config.predict
    weights = {}
    for k, v in flat.items():
        if k.startswith("params/"):
            weights[k] = v
        elif k.startswith(EXTRAS):
            weights[k.split("/", 1)[1]] = v
        elif not (k == "step" or k.startswith("opt_state/")):
            raise KeyError(f"checkpoint leaf {k!r} has no place in the port's TrainState")
    load_state_dict_strict(state.model, state_dict_from_jax(weights, predict=predict))
    opt_state_from_jax(flat, state.model, state.optimizer, predict=predict)
    state.step = int(flat["step"])
    return state


def tolerant_merge(
    target: Union[torch.nn.Module, Dict[str, torch.Tensor]],
    flat: Mapping[str, np.ndarray],
    predict: Optional[bool] = None,
) -> Tuple[Union[torch.nn.Module, Dict[str, torch.Tensor]], List[str], List[str]]:
    """``vadcl_tpu/train/checkpoint.py:tolerant_merge`` on the port: every
    tensor of ``target`` (a ``VADModel``, or a state_dict with ``predict``
    given) whose JAX path (``params/...``, ``batch_stats/...``,
    ``memory/...``: ``convert.py``'s key map) is a key of ``flat`` with the
    same JAX-layout shape takes that value; the rest are kept.  Returns
    (the model, loaded in place, or a new state_dict; the hit paths; the
    missed paths), the paths sorted."""
    model = target if isinstance(target, torch.nn.Module) else None
    if predict is None:
        predict = model.config.predict
    sd = dict(model.state_dict() if model is not None else target)
    own = jax_from_state_dict(sd, predict=predict)
    hits: List[str] = []
    misses: List[str] = []
    for path in sorted(own):
        if path in flat and tuple(np.shape(flat[path])) == tuple(own[path].shape):
            key = _torch_key(path)
            sd[key] = _to_torch_layout(key, flat[path], predict).to(
                device=sd[key].device, dtype=sd[key].dtype)
            hits.append(path)
        else:
            misses.append(path)
    if model is None:
        return sd, hits, misses
    load_state_dict_strict(model, sd)
    return model, hits, misses


class CheckpointManager:
    """The checkpoints under ``directory``, which the first ``save``
    creates (so that a process that only reads, such as a data-parallel
    rank other than 0, writes nothing)."""

    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep

    def _path(self, tag: str) -> str:
        return os.path.join(self.directory, f"ckpt_{tag}.npz")

    def save(self, tag: str, state: TrainState, metadata: Optional[dict] = None) -> None:
        flat = flatten_train_state(state)
        os.makedirs(self.directory, exist_ok=True)
        if metadata is not None:
            flat["__meta__"] = np.frombuffer(json.dumps(metadata).encode(), dtype=np.uint8)
        # atomic write: tmp file + rename
        fd, tmp = tempfile.mkstemp(dir=self.directory, suffix=".tmp")
        os.close(fd)
        with open(tmp, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, self._path(str(tag)))
        self._gc()

    def restore(self, tag: str, state: TrainState) -> TrainState:
        """Load checkpoint ``tag`` into ``state`` in place; returns it."""
        with np.load(self._path(str(tag))) as z:
            flat = {k: z[k] for k in z.files if k != "__meta__"}
        return load_train_state(flat, state)

    def metadata(self, tag: str) -> dict:
        with np.load(self._path(str(tag))) as z:
            if "__meta__" in z.files:
                return json.loads(z["__meta__"].tobytes().decode())
        return {}

    def _numeric_tags(self):
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(m.group(1)) for m in map(_NUMERIC.fullmatch, os.listdir(self.directory))
                      if m)

    def latest_tag(self) -> Optional[str]:
        """Highest numeric tag (the auto-resume target); 'best' is excluded."""
        tags = self._numeric_tags()
        return str(tags[-1]) if tags else None

    def _gc(self) -> None:
        """Keep the newest ``max_to_keep`` numeric checkpoints (and 'best')."""
        if not self.max_to_keep:
            return
        for v in self._numeric_tags()[: -self.max_to_keep]:
            try:
                os.remove(self._path(str(v)))
            except FileNotFoundError:
                pass
