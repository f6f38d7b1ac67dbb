"""Weight bridge between the JAX package's flat parameter dict and the
port's ``state_dict``.

The JAX side is the ``"params/<path>"`` / ``"batch_stats/<path>"`` /
``"memory/<path>"`` dict that ``vadcl_tpu.train.checkpoint.flatten_state``
makes from ``VADModel`` variables.  Module paths are the same in both
packages, so the bridge is a rename plus layout transposes:

  Dense / attention kernels (in, out)          kept as (in, out)
  Conv3d kernel DHWIO                          -> OIDHW (torch Conv3d)
  ConvTranspose3d kernel (kd, kh, kw, Ci, Co)  -> (Ci, Co, kd, kh, kw)
  LayerNorm / BatchNorm scale, bias            -> weight, bias
  BatchNorm batch_stats mean, var              -> running_mean, running_var
  the MNAD bank memory/.../keys (M, d)         -> the buffer .../keys (M, d)

Which 5-D kernels are transposed convs is a list of module paths
(``_CONVT``: the Swin decoder's, ConvAE's ``up*``, UNet3D's
``up*.deconv``, the legacy decoder's), plus the decoder head
(``timedebd`` is a Conv3d in predict mode and a ConvTranspose3d in
reconstruction mode), hence the ``predict`` argument.  A wrong entry would
transpose a kernel silently; every family's variables round-trip bit for
bit in the tests.  Loading is strict.

The optimizer state maps the same way: the JAX package's ``torch_adam``
state (``opt_state/count|mu|nu/<param path>``) and ``torch_sgd`` state
(``opt_state/momentum/<param path>``) against torch's per-parameter Adam /
AdamW ``step``, ``exp_avg``, ``exp_avg_sq`` and SGD ``momentum_buffer``,
the moments transposed like their parameters; and the state of
``optax.chain(optax.lars(...))`` (``opt_state/0/2/count``, the schedule's
step count, and ``opt_state/0/3/trace/<param path>``) against the port's
``Lars`` ``count`` and ``trace``.
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np
import torch

_RENAME = {
    "kernel": "weight",
    "scale": "weight",
    "qkv_kernel": "qkv_weight",
    "proj_kernel": "proj_weight",
}
_STATS = {"mean": "running_mean", "var": "running_var"}
_CONVT = re.compile(
    r"^(decoder\.(upsample\d+\.proj|patchdebed\.deconv\d)"  # SwinDecoder3D
    r"|convae\.up\d|unet3d\.up\d\.deconv"  # ConvAE / ConvAEPredict, UNet3D
    r"|(decoder\.)?(upsample\d+|patchdebed))\.weight$")  # LegacySwinDecoder
_CONV_TO_TORCH = (4, 3, 0, 1, 2)  # DHWIO -> OIDHW
_CONVT_TO_TORCH = (3, 4, 0, 1, 2)  # (kd, kh, kw, Ci, Co) -> (Ci, Co, kd, kh, kw)


# the non-parameter collections of a JAX TrainState's ``extras``
EXTRAS = ("extras/batch_stats/", "extras/memory/")


def _is_convt(key: str, predict: bool) -> bool:
    return bool(_CONVT.match(key)) or (key == "decoder.timedebd.weight" and not predict)


def _torch_key(path: str) -> str:
    """``params/a/b/kernel``, ``batch_stats/a/b/mean`` or
    ``memory/a/memory/keys`` -> ``a.b.weight``, ``a.b.running_mean``,
    ``a.memory.keys``."""
    coll, _, rest = path.partition("/")
    parts = rest.split("/")
    if coll == "params":
        parts[-1] = _RENAME.get(parts[-1], parts[-1])
    elif coll == "batch_stats":
        parts[-1] = _STATS[parts[-1]]
    elif coll != "memory":
        raise KeyError(f"unexpected collection in {path!r}")
    return ".".join(parts)


def _jax_path(key: str, ndim: int) -> str:
    """Inverse of ``_torch_key`` (``ndim`` tells a LayerNorm scale from a
    Dense or conv weight)."""
    parts = key.split(".")
    inv_stats = {v: k for k, v in _STATS.items()}
    if parts[-1] in inv_stats:
        parts[-1] = inv_stats[parts[-1]]
        return "batch_stats/" + "/".join(parts)
    if parts[-1] == "keys":  # the MNAD bank (models/memory.py)
        return "memory/" + "/".join(parts)
    if parts[-1] == "weight" and ndim == 1:  # LayerNorm / BatchNorm
        parts[-1] = "scale"
    else:
        parts[-1] = {v: k for k, v in _RENAME.items() if k != "scale"}.get(parts[-1], parts[-1])
    return "params/" + "/".join(parts)


def _to_torch_layout(key: str, a: np.ndarray, predict: bool) -> torch.Tensor:
    a = np.asarray(a)
    if a.ndim == 5:
        a = a.transpose(_CONVT_TO_TORCH if _is_convt(key, predict) else _CONV_TO_TORCH)
    return torch.from_numpy(np.array(a, dtype=np.float32))  # a writable copy


def _to_jax_layout(key: str, t: torch.Tensor, predict: bool) -> Tuple[str, np.ndarray]:
    a = t.detach().cpu().float().numpy()
    if a.ndim == 5:
        perm = _CONVT_TO_TORCH if _is_convt(key, predict) else _CONV_TO_TORCH
        a = a.transpose(np.argsort(perm))
    return _jax_path(key, a.ndim), np.ascontiguousarray(a)


def state_dict_from_jax(flat: Dict[str, np.ndarray], *, predict: bool) -> Dict[str, torch.Tensor]:
    """The port's state_dict from a flat JAX ``{params,batch_stats}/...`` dict."""
    out: Dict[str, torch.Tensor] = {}
    for path, arr in flat.items():
        key = _torch_key(path)
        out[key] = _to_torch_layout(key, arr, predict)
    return out


def jax_from_state_dict(sd: Dict[str, torch.Tensor], *, predict: bool) -> Dict[str, np.ndarray]:
    """Inverse of ``state_dict_from_jax``."""
    return dict(_to_jax_layout(key, t, predict) for key, t in sd.items())


LARS_COUNT = "opt_state/0/2/count"
LARS_TRACE = "opt_state/0/3/trace/"


def _opt_kind(optimizer: torch.optim.Optimizer) -> str:
    from vadcl_tpu_torch.train.optim import Lars

    if isinstance(optimizer, Lars):
        return "lars"
    if isinstance(optimizer, (torch.optim.Adam, torch.optim.AdamW)):
        return "adam"
    if isinstance(optimizer, torch.optim.SGD):
        return "sgd"
    raise TypeError(f"no JAX optimizer-state layout for {type(optimizer).__name__}")


def opt_state_to_jax(model: torch.nn.Module, optimizer: torch.optim.Optimizer, *,
                     predict: bool) -> Dict[str, np.ndarray]:
    """The ``opt_state/...`` leaves of the JAX package's ``TrainState`` from
    a torch optimizer over ``model.parameters()``.  A parameter the optimizer
    has not stepped yet (gated so far) has count 0 and zero moments, as in
    ``torch_adam``."""
    kind = _opt_kind(optimizer)
    out: Dict[str, np.ndarray] = {}
    if kind == "lars":
        out[LARS_COUNT] = np.asarray(optimizer.count, np.int32)
    for key, p in model.named_parameters():
        st = optimizer.state.get(p, {})
        leaf = _jax_path(key, p.ndim).split("/", 1)[1]
        if kind == "adam":
            out[f"opt_state/count/{leaf}"] = np.asarray(int(st["step"]) if st else 0, np.int32)
            for name, sk in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
                out[f"opt_state/{name}/{leaf}"] = _to_jax_layout(
                    key, st[sk] if st else torch.zeros_like(p), predict)[1]
        elif kind == "lars":
            out[LARS_TRACE + leaf] = _to_jax_layout(
                key, st["trace"] if "trace" in st else torch.zeros_like(p), predict)[1]
        else:
            buf = st.get("momentum_buffer")
            out[f"opt_state/momentum/{leaf}"] = _to_jax_layout(
                key, buf if buf is not None else torch.zeros_like(p), predict)[1]
    return out


def opt_state_from_jax(flat: Dict[str, np.ndarray], model: torch.nn.Module,
                       optimizer: torch.optim.Optimizer, *, predict: bool) -> None:
    """Inverse of ``opt_state_to_jax``: fills ``optimizer.state`` for every
    parameter of ``model`` (a missing leaf raises ``KeyError``)."""
    kind = _opt_kind(optimizer)
    count = int(flat[LARS_COUNT]) if kind == "lars" else 0
    for key, p in model.named_parameters():
        leaf = _jax_path(key, p.ndim).split("/", 1)[1]
        optimizer.state.pop(p, None)
        if kind == "adam":
            count = int(flat[f"opt_state/count/{leaf}"])
            if count > 0:  # torch creates the state of a parameter at its first step
                optimizer.state[p] = {
                    "step": torch.tensor(float(count), dtype=torch.float32),
                    "exp_avg": _to_torch_layout(key, flat[f"opt_state/mu/{leaf}"], predict).to(p.device),
                    "exp_avg_sq": _to_torch_layout(key, flat[f"opt_state/nu/{leaf}"], predict).to(p.device),
                }
        elif kind == "lars":
            trace = _to_torch_layout(key, flat[LARS_TRACE + leaf], predict)
            if count > 0:
                optimizer.state[p] = {"trace": trace.to(p.device), "count": count}
        else:
            buf = _to_torch_layout(key, flat[f"opt_state/momentum/{leaf}"], predict)
            if bool(buf.any()):
                optimizer.state[p] = {"momentum_buffer": buf.to(p.device)}


def load_jax_checkpoint(model: torch.nn.Module, npz_path: str) -> None:
    """Load a JAX-package checkpoint (``params/...`` plus
    ``extras/batch_stats/...`` and, for the memory families, the bank
    ``extras/memory/...``, as ``CheckpointManager.save`` writes a
    TrainState) into ``model``, strictly: a missing or leftover key raises
    with the list of keys."""
    with np.load(npz_path) as z:
        flat = {}
        for k in z.files:
            if k.startswith("params/"):
                flat[k] = z[k]
            elif k.startswith(EXTRAS):
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
