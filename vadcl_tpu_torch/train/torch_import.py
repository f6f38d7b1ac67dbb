"""PyTorch reference checkpoint -> the JAX package's flat parameter paths
(the port's copy of ``vadcl_tpu/train/torch_import.py``; numpy only, torch
only to read a ``.pth``).

A reference ``Mymodel`` state_dict (``model/backbone.py:28``, saved
DDP-prefixed per ``main_predict.py:204``) maps 1:1 onto the flat
``params/...`` and ``batch_stats/...`` paths of the JAX ``VADModel``, which
the port's ``convert.state_dict_from_jax`` and
``train/checkpoint.py:tolerant_merge`` take (``tools/evaluate_torch.py`` and
``tools/export_torch.py`` ``--torch-ckpt``).

Name map (torch -> JAX path), after stripping the 7-char ``module.`` prefix
exactly like ``misc/utils.py:62``:

  encoder.patch_embed.proj.*          -> encoder/patch_embed
  encoder.layers.{i}.blocks.{j}.*     -> encoder/stage{i}/block{j}
  encoder.conv_layers.{i}.0.*         -> encoder/inception{i}
  encoder.downsample.{i}.0.*          -> encoder/downsample{i}
  decoder.timedebd.*                  -> decoder/timedebd
  decoder.ST_layers.{i}.blocks.{j}.*  -> decoder/stage{i}/block{j}
  decoder.I3D_layers.{i}.0.*          -> decoder/inception{i}
  decoder.upsampling.0.proj.0.*       -> decoder/upsample0/proj
  decoder.norm.*                      -> decoder/norm
  decoder.patchdebed.proj.{0,2,4}.*   -> decoder/patchdebed/{deconv1,conv,deconv2}
  cluster1.* / space_cluster.* / norm.* -> same names

Layout conversions:
  Linear  (out, in)            -> kernel (in, out)
  Conv3d  (O, I, kd, kh, kw)   -> kernel (kd, kh, kw, I, O)
  ConvT3d (I, O, kd, kh, kw)   -> kernel (kd, kh, kw, I, O)
  LayerNorm/BatchNorm weight/bias -> scale/bias; BN running stats ->
  batch_stats/{mean,var}; ``identity_matrix`` buffers are dropped (constant,
  unused — model/cluster.py:72).

``inflate_swin2d`` resizes relative-position tables as
``jax.image.resize(method="bicubic")`` does (``resize_bicubic``): Keys'
cubic at a = -0.5, the kernel widened by the scale when it shrinks
(antialiasing), weights normalised per output sample; not
``torch.nn.functional.interpolate(mode="bicubic")``, whose cubic has
a = -0.75.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import numpy as np

_INCEPTION_UNITS = ("b0", "b1a", "b1b", "b2a", "b2b", "b3b")


def _block_rename(rest: str) -> Optional[Tuple[str, str]]:
    """Swin block param: returns (our_subpath, kind). kind in
    {linear, tensor, norm_scale, norm_bias, bias}."""
    m = re.fullmatch(r"(norm[12])\.(weight|bias)", rest)
    if m:
        kind = "norm_scale" if m.group(2) == "weight" else "norm_bias"
        return f"{m.group(1)}", kind
    m = re.fullmatch(r"attn\.relative_position_bias_table", rest)
    if m:
        return "attn/relative_position_bias_table", "tensor"
    m = re.fullmatch(r"attn\.qkv\.(weight|bias)", rest)
    if m:
        if m.group(1) == "weight":
            return "attn/qkv_kernel", "linear"
        return "attn/qkv_bias", "tensor"
    m = re.fullmatch(r"attn\.proj\.(weight|bias)", rest)
    if m:
        if m.group(1) == "weight":
            return "attn/proj_kernel", "linear"
        return "attn/proj_bias", "tensor"
    m = re.fullmatch(r"mlp\.(fc[12])\.(weight|bias)", rest)
    if m:
        if m.group(2) == "weight":
            return f"mlp/{m.group(1)}/kernel", "linear"
        return f"mlp/{m.group(1)}/bias", "tensor"
    return None


def _convert(kind: str, v: np.ndarray) -> np.ndarray:
    if kind == "linear":
        return np.transpose(v)  # (out, in) -> (in, out)
    if kind == "conv":
        return np.transpose(v, (2, 3, 4, 1, 0))  # OIDHW -> DHWIO
    if kind == "convT":
        return np.transpose(v, (2, 3, 4, 0, 1))  # IODHW -> DHW,I,O
    return v


def _unit3d(rest: str) -> Optional[Tuple[str, str, str]]:
    """Inception Unit3D param -> (our_subpath, kind, collection)."""
    m = re.fullmatch(
        r"(b0|b1a|b1b|b2a|b2b|b3b)\.(conv3d\.weight|bn\.weight|bn\.bias|"
        r"bn\.running_mean|bn\.running_var|bn\.num_batches_tracked)",
        rest,
    )
    if not m:
        return None
    unit, leaf = m.group(1), m.group(2)
    if leaf == "conv3d.weight":
        return f"{unit}/conv3d/kernel", "conv", "params"
    if leaf == "bn.weight":
        return f"{unit}/bn/scale", "tensor", "params"
    if leaf == "bn.bias":
        return f"{unit}/bn/bias", "tensor", "params"
    if leaf == "bn.running_mean":
        return f"{unit}/bn/mean", "tensor", "batch_stats"
    if leaf == "bn.running_var":
        return f"{unit}/bn/var", "tensor", "batch_stats"
    return ("__drop__", "tensor", "params")  # num_batches_tracked


def translate_torch_state(
    torch_state: Dict[str, np.ndarray],
    predict: bool = True,
) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray], list]:
    """Returns (params_flat, batch_stats_flat, unmatched_keys) with '/'-joined
    paths matching ``vadcl_tpu.train.checkpoint.flatten_state`` of the
    VADModel variables (rooted below 'params'/'batch_stats')."""
    params: Dict[str, np.ndarray] = {}
    stats: Dict[str, np.ndarray] = {}
    unmatched = []

    def put(path: str, kind: str, v, collection: str = "params"):
        if path.endswith("__drop__"):
            # drop markers may arrive prefixed (e.g. encoder/inception0/
            # __drop__ for num_batches_tracked buffers)
            return
        arr = _convert(kind, np.asarray(v))
        (params if collection == "params" else stats)[path] = arr

    for key, v in torch_state.items():
        k = key[7:] if key.startswith("module.") else key
        if "identity_matrix" in k or "relative_position_index" in k:
            # constant buffers: identity_matrix (model/cluster.py:72) and the
            # rel-pos gather index (model/swin_transformer.py:109-124) are
            # derived from geometry; we rebuild them as host constants.
            continue

        # --- encoder ---
        m = re.fullmatch(r"encoder\.patch_embed\.proj\.(weight|bias)", k)
        if m:
            put(
                "encoder/patch_embed/" + ("kernel" if m.group(1) == "weight" else "bias"),
                "conv" if m.group(1) == "weight" else "tensor",
                v,
            )
            continue
        m = re.fullmatch(r"encoder\.layers\.(\d+)\.blocks\.(\d+)\.(.*)", k)
        if m:
            sub = _block_rename(m.group(3))
            if sub:
                path, kind = sub
                if kind.startswith("norm_"):
                    leaf = "scale" if kind == "norm_scale" else "bias"
                    put(
                        f"encoder/stage{m.group(1)}/block{m.group(2)}/{path}/{leaf}",
                        "tensor", v,
                    )
                else:
                    put(
                        f"encoder/stage{m.group(1)}/block{m.group(2)}/{path}",
                        kind, v,
                    )
                continue
        m = re.fullmatch(r"encoder\.conv_layers\.(\d+)\.0\.(.*)", k)
        if m:
            sub = _unit3d(m.group(2))
            if sub:
                path, kind, coll = sub
                put(f"encoder/inception{m.group(1)}/{path}", kind, v, coll)
                continue
        m = re.fullmatch(r"encoder\.downsample\.(\d+)\.0\.(weight|bias)", k)
        if m:
            put(
                f"encoder/downsample{m.group(1)}/"
                + ("kernel" if m.group(2) == "weight" else "bias"),
                "conv" if m.group(2) == "weight" else "tensor",
                v,
            )
            continue

        # --- decoder ---
        m = re.fullmatch(r"decoder\.timedebd\.(weight|bias)", k)
        if m:
            # Conv3d in predict mode (OIDHW) vs ConvTranspose3d in recon mode
            # (IODHW) — both 192x192x(2,1,1), so the layout cannot be inferred
            # from shape; the ``predict`` argument selects it.
            kind = "conv" if predict else "convT"
            put(
                "decoder/timedebd/" + ("kernel" if m.group(1) == "weight" else "bias"),
                kind if m.group(1) == "weight" else "tensor",
                v,
            )
            continue
        m = re.fullmatch(r"decoder\.ST_layers\.(\d+)\.blocks\.(\d+)\.(.*)", k)
        if m:
            sub = _block_rename(m.group(3))
            if sub:
                path, kind = sub
                if kind.startswith("norm_"):
                    leaf = "scale" if kind == "norm_scale" else "bias"
                    put(
                        f"decoder/stage{m.group(1)}/block{m.group(2)}/{path}/{leaf}",
                        "tensor", v,
                    )
                else:
                    put(
                        f"decoder/stage{m.group(1)}/block{m.group(2)}/{path}",
                        kind, v,
                    )
                continue
        m = re.fullmatch(r"decoder\.I3D_layers\.(\d+)\.0\.(.*)", k)
        if m:
            sub = _unit3d(m.group(2))
            if sub:
                path, kind, coll = sub
                put(f"decoder/inception{m.group(1)}/{path}", kind, v, coll)
                continue
        m = re.fullmatch(r"decoder\.upsampling\.0\.proj\.0\.(weight|bias)", k)
        if m:
            put(
                "decoder/upsample0/proj/"
                + ("kernel" if m.group(1) == "weight" else "bias"),
                "convT" if m.group(1) == "weight" else "tensor",
                v,
            )
            continue
        m = re.fullmatch(r"decoder\.norm\.(weight|bias)", k)
        if m:
            put(
                "decoder/norm/" + ("scale" if m.group(1) == "weight" else "bias"),
                "tensor", v,
            )
            continue
        m = re.fullmatch(r"decoder\.patchdebed\.proj\.(0|2|4)\.(weight|bias)", k)
        if m:
            name = {"0": "deconv1", "2": "conv", "4": "deconv2"}[m.group(1)]
            kind = {"0": "convT", "2": "conv", "4": "convT"}[m.group(1)]
            put(
                f"decoder/patchdebed/{name}/"
                + ("kernel" if m.group(2) == "weight" else "bias"),
                kind if m.group(2) == "weight" else "tensor",
                v,
            )
            continue

        # --- cluster heads + final norm ---
        m = re.fullmatch(r"(cluster1|space_cluster)\.norm\.(weight|bias)", k)
        if m:
            put(
                f"{m.group(1)}/norm/"
                + ("scale" if m.group(2) == "weight" else "bias"),
                "tensor", v,
            )
            continue
        m = re.fullmatch(r"(cluster1|space_cluster)\.cluster_center", k)
        if m:
            put(f"{m.group(1)}/cluster_center", "tensor", v)
            continue
        m = re.fullmatch(r"norm\.(weight|bias)", k)
        if m:
            put(
                "norm/" + ("scale" if m.group(1) == "weight" else "bias"),
                "tensor", v,
            )
            continue

        unmatched.append(key)

    return params, stats, unmatched


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel at a = -0.5 (jax.image's)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out).astype(np.float32)


def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float32 weights of ``jax.image``'s
    ``compute_weight_mat`` for a scale of n_out / n_in, no translation,
    antialiasing on."""
    inv_scale = np.float32(n_in / n_out)
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv_scale - np.float32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) / kernel_scale
    w = _keys_cubic(x.astype(np.float32))
    total = w.sum(axis=0, keepdims=True, dtype=np.float32)
    eps = np.float32(1000.0 * np.finfo(np.float32).eps)
    w = np.where(np.abs(total) > eps, w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


def resize_bicubic(grid: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``jax.image.resize(grid, (*size, C), method="bicubic")`` of an
    (H, W, C) array, in float32: one weight matrix an axis, an axis whose
    size is kept is left as it is."""
    out = np.asarray(grid, np.float32)
    for axis, n_out in enumerate(size):
        n_in = out.shape[axis]
        if n_in == n_out:
            continue
        w = _resize_weights(n_in, n_out)
        out = np.moveaxis(np.tensordot(out, w, axes=([axis], [0])), -1, axis)
    return out.astype(np.float32)


def inflate_swin2d(
    state2d: Dict[str, np.ndarray],
    window_size=(8, 7, 7),
    patch_size=(2, 4, 4),
    num_stages: int = 2,
) -> Dict[str, np.ndarray]:
    """Inflate a 2D Swin checkpoint into the 3D encoder's parameter space
    (capability parity with ``inflate_weights``,
    ``model/swin_transformer.py:624-682``):

    * ``patch_embed.proj.weight`` (C, 3, kh, kw) repeats over the temporal
      kernel dim and divides by it;
    * relative-position bias tables bicubic-resize in (h, w) if the window
      differs, then tile (2*wd - 1) times over the temporal axis;
    * linear/norm weights pass through the standard layout conversion.

    Input keys use upstream Swin-2D naming (``layers.{i}.blocks.{j}...``) —
    including the UNMODIFIED 4-stage upstream checkpoints
    (``mmaction/models/backbones/swin_transformer.py:17-669`` layout): stages
    past ``num_stages`` and ``PatchMerging`` keys (``layers.{i}.downsample.*``
    — the reference disables merging, ``model/swin_transformer.py:546``) are
    skipped with a per-key log line, the reference's tolerant partial-load
    semantics (``misc/utils.py:51-76``).  Classifier ``head.*`` and the final
    ``norm.*`` (which has no 2-stage analogue) are skipped likewise.

    Output is a flat params dict under ``encoder/...`` suitable for
    ``tolerant_merge``.
    """
    import logging

    logger = logging.getLogger("vadcl_torch")
    out: Dict[str, np.ndarray] = {}
    wd, wh, ww = window_size

    def skip(key: str, why: str):
        logger.info(f"inflate_swin2d: skipping {key} ({why})")

    for key, v in state2d.items():
        v = np.asarray(v)
        if "relative_position_index" in key or "attn_mask" in key:
            continue
        m = re.fullmatch(r"layers\.(\d+)\.downsample\..*", key)
        if m:
            skip(key, "PatchMerging — disabled in the target model")
            continue
        m = re.fullmatch(r"layers\.(\d+)\..*", key)
        if m and int(m.group(1)) >= num_stages:
            skip(key, f"stage {m.group(1)} >= model stages {num_stages}")
            continue
        if re.fullmatch(r"(head|norm)\.(weight|bias)", key):
            skip(key, "no counterpart in the 2-stage encoder")
            continue
        if key == "patch_embed.proj.weight":
            # (C, 3, kh, kw) -> repeat temporal taps, /kd (weight inflation)
            kd = patch_size[0]
            v3 = np.repeat(v[:, :, None], kd, axis=2) / kd  # (C, 3, kd, kh, kw)
            out["encoder/patch_embed/kernel"] = np.transpose(v3, (2, 3, 4, 1, 0))
            continue
        if key == "patch_embed.proj.bias":
            out["encoder/patch_embed/bias"] = v
            continue
        m = re.fullmatch(r"layers\.(\d+)\.blocks\.(\d+)\.(.*)", key)
        if not m:
            skip(key, "no counterpart in the 3D encoder")
            continue
        base = f"encoder/stage{m.group(1)}/block{m.group(2)}"
        rest = m.group(3)
        if rest == "attn.relative_position_bias_table":
            L1, nH = v.shape
            S1 = int(round(L1**0.5))
            L2 = (2 * wh - 1) * (2 * ww - 1)
            if L1 != L2:
                grid = resize_bicubic(v.reshape(S1, S1, nH), (2 * wh - 1, 2 * ww - 1))
                v = grid.reshape(L2, nH)
            out[f"{base}/attn/relative_position_bias_table"] = np.tile(
                v, (2 * wd - 1, 1)
            )
            continue
        sub = _block_rename(rest)
        if sub is None:
            skip(key, "unrecognized block parameter")
            continue
        path, kind = sub
        if kind == "norm_scale":
            out[f"{base}/{path}/scale"] = v
        elif kind == "norm_bias":
            out[f"{base}/{path}/bias"] = v
        else:
            out[f"{base}/{path}"] = _convert(kind, v)
    return out


def load_reference_checkpoint(path: str):
    """torch.load a reference .pth (on the CPU) and translate it: returns
    ``translate_torch_state``'s (params, batch_stats, unmatched keys)."""
    import torch

    raw = torch.load(path, map_location="cpu")
    if isinstance(raw, dict) and "state_dict" in raw:
        raw = raw["state_dict"]  # misc/utils.py:104 variant
    state = {k: v.numpy() for k, v in raw.items() if hasattr(v, "numpy")}
    return translate_torch_state(state)


def merge_reference_checkpoint(model, path: str):
    """Load a reference ``.pth`` into the port's ``model`` as the JAX CLIs
    do: ``load_reference_checkpoint``, its params under ``params/`` and its
    statistics under ``batch_stats/``, through ``tolerant_merge``.  Returns
    (the hit paths, the missed paths, the unmatched torch keys)."""
    from vadcl_tpu_torch.train.checkpoint import tolerant_merge

    params, stats, unmatched = load_reference_checkpoint(path)
    flat = {f"params/{k}": v for k, v in params.items()}
    flat.update({f"batch_stats/{k}": v for k, v in stats.items()})
    _, hits, misses = tolerant_merge(model, flat)
    return hits, misses, unmatched
