"""Weight bridge between the JAX package's flat parameter dict and the
port's ``state_dict``.

The JAX side is the ``"params/<path>"`` / ``"batch_stats/<path>"`` dict that
``vadcl_tpu.train.checkpoint.flatten_state`` makes from ``VADModel``
variables.  Module paths are the same in both packages, so the bridge is a
rename plus layout transposes:

  Dense / attention kernels (in, out)          kept as (in, out)
  Conv3d kernel DHWIO                          -> OIDHW (torch Conv3d)
  ConvTranspose3d kernel (kd, kh, kw, Ci, Co)  -> (Ci, Co, kd, kh, kw)
  LayerNorm / BatchNorm scale, bias            -> weight, bias
  BatchNorm batch_stats mean, var              -> running_mean, running_var

Which 5-D kernels are transposed convs depends on the decoder head
(``timedebd`` is a Conv3d in predict mode and a ConvTranspose3d in
reconstruction mode), hence the ``predict`` argument.  Loading is strict.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

_RENAME = {
    "kernel": "weight",
    "scale": "weight",
    "qkv_kernel": "qkv_weight",
    "proj_kernel": "proj_weight",
}
_STATS = {"mean": "running_mean", "var": "running_var"}
_CONVT = re.compile(r"^decoder\.(upsample\d+\.proj|patchdebed\.deconv\d)\.weight$")
_CONV_TO_TORCH = (4, 3, 0, 1, 2)  # DHWIO -> OIDHW
_CONVT_TO_TORCH = (3, 4, 0, 1, 2)  # (kd, kh, kw, Ci, Co) -> (Ci, Co, kd, kh, kw)


def _is_convt(key: str, predict: bool) -> bool:
    return bool(_CONVT.match(key)) or (key == "decoder.timedebd.weight" and not predict)


def state_dict_from_jax(flat: Dict[str, np.ndarray], *, predict: bool) -> Dict[str, torch.Tensor]:
    """The port's state_dict from a flat JAX ``{params,batch_stats}/...`` dict."""
    out: Dict[str, torch.Tensor] = {}
    for path, arr in flat.items():
        coll, _, rest = path.partition("/")
        parts = rest.split("/")
        if coll == "params":
            parts[-1] = _RENAME.get(parts[-1], parts[-1])
        elif coll == "batch_stats":
            parts[-1] = _STATS[parts[-1]]
        else:
            raise KeyError(f"unexpected collection in {path!r}")
        key = ".".join(parts)
        a = np.asarray(arr)
        if a.ndim == 5:
            a = a.transpose(_CONVT_TO_TORCH if _is_convt(key, predict) else _CONV_TO_TORCH)
        out[key] = torch.from_numpy(np.array(a, dtype=np.float32))  # a writable copy
    return out


def jax_from_state_dict(sd: Dict[str, torch.Tensor], *, predict: bool) -> Dict[str, np.ndarray]:
    """Inverse of ``state_dict_from_jax``."""
    inv_rename = {v: k for k, v in _RENAME.items() if k != "scale"}
    inv_stats = {v: k for k, v in _STATS.items()}
    flat: Dict[str, np.ndarray] = {}
    for key, t in sd.items():
        parts = key.split(".")
        a = t.detach().cpu().float().numpy()
        if parts[-1] in inv_stats:
            coll = "batch_stats"
            parts[-1] = inv_stats[parts[-1]]
        else:
            coll = "params"
            if parts[-1] == "weight" and a.ndim == 1:  # LayerNorm / BatchNorm
                parts[-1] = "scale"
            else:
                parts[-1] = inv_rename.get(parts[-1], parts[-1])
        if a.ndim == 5:
            perm = _CONVT_TO_TORCH if _is_convt(key, predict) else _CONV_TO_TORCH
            a = a.transpose(np.argsort(perm))
        flat[coll + "/" + "/".join(parts)] = np.ascontiguousarray(a)
    return flat


def load_jax_checkpoint(model: torch.nn.Module, npz_path: str) -> None:
    """Load a JAX-package checkpoint (``params/...`` plus
    ``extras/batch_stats/...``, as ``CheckpointManager.save`` writes a
    TrainState) into ``model``, strictly: a missing or leftover key raises
    with the list of keys."""
    with np.load(npz_path) as z:
        flat = {}
        for k in z.files:
            if k.startswith("params/"):
                flat[k] = z[k]
            elif k.startswith("extras/batch_stats/"):
                flat[k.split("/", 1)[1]] = z[k]
    sd = state_dict_from_jax(flat, predict=model.config.predict)
    load_state_dict_strict(model, sd)


def load_state_dict_strict(model: torch.nn.Module, sd: Dict[str, torch.Tensor]) -> None:
    """``model.load_state_dict`` that also checks shapes and names every
    missing and unexpected key in its error."""
    own = model.state_dict()
    missing = sorted(set(own) - set(sd))
    unexpected = sorted(set(sd) - set(own))
    bad_shape = sorted(
        f"{k}: {tuple(sd[k].shape)} vs {tuple(own[k].shape)}"
        for k in set(own) & set(sd) if tuple(sd[k].shape) != tuple(own[k].shape)
    )
    if missing or unexpected or bad_shape:
        raise KeyError(
            f"state_dict mismatch: missing {missing}, unexpected {unexpected}, "
            f"shape {bad_shape}"
        )
    model.load_state_dict(sd, strict=True)
