"""Composite model (``vadcl_tpu/models/backbone.py``): the flagship
encoder + dual cluster heads + decoder, or one of the alternate families.

The JAX ``VADModel``'s semantics, gradient flow included: cluster losses are
``||distance * assign||_F``; the cluster heads see detached features unless
compactness is on (or its gate is); in compactness mode the decoder consumes
the cluster's soft reconstruction ``assign @ centers``; a LayerNorm sits
between the latent and the decoder.  ``config.backbone`` picks the family:
``swin`` (the flagship), ``unet3d`` (``models/unet3d.py``), or the MNAD
memory autoencoders ``convae`` / ``convae_predict`` (``models/conv_ae.py``),
whose separateness and compactness ride the cluster and space loss slots,
so one train step serves every family.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
import torch.nn as nn

from vadcl_tpu_torch.core.config import ModelConfig
from vadcl_tpu_torch.models.cluster_heads import FeatureClusterHead, SpaceClusterHead
from vadcl_tpu_torch.models.conv_ae import ConvAE, ConvAEPredict
from vadcl_tpu_torch.models.decoder import SwinDecoder3D
from vadcl_tpu_torch.models.encoder import SwinEncoder3D
from vadcl_tpu_torch.models.layers import LayerNorm, init_parameters, name_draw_sites
from vadcl_tpu_torch.models.unet3d import UNet3D
from vadcl_tpu_torch.ops.cluster import frobenius_norm

BACKBONES = ("swin", "unet3d", "convae", "convae_predict")
MEMORY_BACKBONES = ("convae", "convae_predict")  # their bank updates every train step


def predicts(cfg: ModelConfig) -> bool:
    """Whether the family predicts the clip's last frame (``predict``, and
    always ``convae_predict``) rather than reconstructing the clip."""
    return cfg.predict or cfg.backbone == "convae_predict"


def model_input_frames(backbone: str, frame_num: int) -> int:
    """The frames of a ``frame_num`` clip a family's model sees when built
    for that clip length: all but the target frame for ``convae_predict``,
    every frame otherwise (the flagship's predict mode cuts its 4 input
    frames from the clip itself)."""
    return frame_num - 1 if backbone == "convae_predict" else frame_num


def _summed(s: torch.Tensor, global_sum) -> torch.Tensor:
    return s if global_sum is None else global_sum(s)


class VADOutput(NamedTuple):
    recon: torch.Tensor  # (B, D_out, H, W, 3)
    cluster_loss: torch.Tensor  # scalar fp32 (0 when the head is off)
    space_loss: torch.Tensor  # scalar fp32
    feature: torch.Tensor  # (B*D'*H'*W', C) latent tokens
    feature_label: torch.Tensor  # (B*D'*H'*W',) int32 hard cluster labels
    cluster_assign: Optional[torch.Tensor]  # (B, D', H', W', K) or None
    space_assign: Optional[torch.Tensor]  # (B, D', C, K) or None


class VADModel(nn.Module):
    """The VAD model of ``config.backbone``'s family.

    ``dtype`` is the compute dtype (``core.dtypes.compute_dtype``);
    parameters are fp32.  ``generator`` seeds the JAX package's init; the
    weights of a JAX checkpoint load with ``convert.load_jax_checkpoint``.
    ``input_frames`` is the clip length the ConvAE families take (their
    first conv stacks the frames as channels: ``model_input_frames``); the
    other families take any length and ignore it.
    """

    def __init__(self, config: ModelConfig, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None,
                 input_frames: Optional[int] = None):
        super().__init__()
        cfg = config
        if cfg.backbone not in BACKBONES:
            raise ValueError(f"unknown backbone {cfg.backbone!r}; families: {BACKBONES}")
        self.config = cfg
        self.dtype = dtype
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        if cfg.backbone == "unet3d":
            self.unet3d = UNet3D(num_channels=cfg.in_channels)
        elif cfg.backbone in MEMORY_BACKBONES:
            if input_frames is None:
                raise ValueError(
                    f"backbone {cfg.backbone!r} needs input_frames, the clip length its first "
                    "conv takes (models.backbone.model_input_frames(backbone, frame_num))")
            net = ConvAE if cfg.backbone == "convae" else ConvAEPredict
            t_length = input_frames if cfg.backbone == "convae" else input_frames + 1
            self.convae = net(cfg.in_channels, t_length, cfg.memory_size, cfg.memory_dim)
        else:
            self._build_swin(cfg)
        init_parameters(self, gen)
        name_draw_sites(self)

    def _build_swin(self, cfg: ModelConfig) -> None:
        latent = int(cfg.embed_dim * 2 ** (len(cfg.encoder_depths) - 1))
        self.encoder = SwinEncoder3D(
            cfg.patch_size, cfg.in_channels, cfg.embed_dim, cfg.encoder_depths,
            cfg.encoder_heads, cfg.window_size, cfg.mlp_ratio, cfg.qkv_bias,
            cfg.fused_attention, cfg.attn_kernel, cfg.drop_rate, cfg.attn_drop_rate,
            cfg.drop_path_rate, cfg.remat,
        )
        if cfg.use_cluster:
            cl = cfg.cluster
            self.cluster1 = FeatureClusterHead(
                latent, cl.feature_clusters, cl.feature_alpha, cfg.fused_cluster
            )
            self.space_cluster = SpaceClusterHead(
                latent, cl.space_clusters, cl.space_alpha, cl.space_size,
                cfg.fused_cluster,
            )
        self.norm = LayerNorm(latent)
        self.decoder = SwinDecoder3D(
            latent, cfg.decoder_depths, cfg.decoder_heads, cfg.window_size,
            cfg.mlp_ratio, cfg.qkv_bias, cfg.predict, cfg.in_channels,
            cfg.fused_attention, cfg.attn_kernel, cfg.drop_rate, cfg.attn_drop_rate,
            cfg.drop_path_rate, cfg.remat,
        )

    def forward(self, clip: torch.Tensor, detach_cluster_input: Optional[bool] = None,
                compactness_gate: Optional[torch.Tensor] = None,
                global_sum: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
                global_max: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
                update_memory: bool = False) -> VADOutput:
        """clip (B, D, H, W, 3) in [0, 1] -> VADOutput.

        ``compactness_gate`` (a 0/1 scalar tensor) is the staged
        compactness flip of ``ScheduleConfig.compactness_start_iter``: at 0
        the cluster heads see detached features and the decoder consumes the
        encoder features; at 1 gradients flow into the heads and the decoder
        consumes ``assign @ centers``.  ``None`` keeps the static
        ``config.compactness`` behaviour, with the heads' input detached
        unless ``detach_cluster_input`` (default: ``not compactness``) says
        otherwise.

        ``global_sum`` takes each cluster loss's sum of squares before its
        square root: a data-parallel train step passes the all-reduce
        (``parallel.sharding.global_sum``), so every process gets the
        losses of the global batch, as the JAX step computes them.

        The alternate families read none of the flagship's arguments but
        these: ``update_memory`` (the JAX step's ``deterministic=False,
        mutable=["memory"]``) writes the memory bank's update after the
        forward, which nothing else does, ``training`` included;
        ``global_sum`` and ``global_max`` take the memory losses and the
        bank's update over the global batch (``ops/memory.py``)."""
        cfg = self.config
        if cfg.backbone != "swin":
            return self._alt_backbone(clip, update_memory, global_sum, global_max)
        x = self.encoder(clip.to(self.dtype))
        B, Dp, Hp, Wp, C = x.shape
        if detach_cluster_input is None:
            detach_cluster_input = not cfg.compactness
        if cfg.use_cluster:
            gate = None
            if compactness_gate is not None and cfg.compactness:
                gate = compactness_gate.to(device=x.device, dtype=x.dtype)
                # d/dx of g*x + (1-g)*x.detach() is g: gradient flows iff the gate is on
                x_for_cluster = gate * x + (1 - gate) * x.detach()
            else:
                x_for_cluster = x.detach() if detach_cluster_input else x
            fc = self.cluster1(x_for_cluster)
            sc = self.space_cluster(x_for_cluster)
            if fc.loss_sq_sum is not None:
                cluster_loss = torch.sqrt(_summed(fc.loss_sq_sum, global_sum))
            else:
                cluster_loss = frobenius_norm(fc.distance * fc.assign, global_sum)
            if sc.loss_sq_sum is not None:
                space_loss = torch.sqrt(_summed(sc.loss_sq_sum, global_sum))
            else:
                space_loss = frobenius_norm(sc.distance * sc.assign, global_sum)
            if cfg.compactness:
                if gate is not None:
                    x = gate * fc.recon.to(self.dtype) + (1 - gate) * x
                else:
                    x = fc.recon.to(self.dtype)
            feature, feature_label = fc.feature, fc.labels
            cluster_assign, space_assign = fc.assign, sc.assign
        else:
            zero = torch.zeros((), dtype=torch.float32, device=x.device)
            cluster_loss = space_loss = zero
            feature = x.reshape(-1, C).float()
            feature_label = torch.zeros(B * Dp * Hp * Wp, dtype=torch.int32, device=x.device)
            cluster_assign = space_assign = None
        recon = self.decoder(self.norm(x))
        return VADOutput(
            recon=recon, cluster_loss=cluster_loss, space_loss=space_loss,
            feature=feature, feature_label=feature_label,
            cluster_assign=cluster_assign, space_assign=space_assign,
        )

    def _alt_backbone(self, clip: torch.Tensor, update_memory: bool, global_sum,
                      global_max) -> VADOutput:
        """The alternate families behind the flagship's output contract."""
        B = clip.shape[0]
        zero = torch.zeros((), dtype=torch.float32, device=clip.device)
        if self.config.backbone == "unet3d":
            recon = self.unet3d(clip.to(self.dtype))
            return VADOutput(
                recon=recon, cluster_loss=zero, space_loss=zero,
                feature=recon.reshape(B, -1)[:, :1].float(),
                feature_label=torch.zeros(B, dtype=torch.int32, device=clip.device),
                cluster_assign=None, space_assign=None,
            )
        out = self.convae(clip.to(self.dtype), update_memory, global_sum, global_max)
        feature = out.feature.reshape(-1, out.feature.shape[-1]).float()
        return VADOutput(
            recon=out.recon, cluster_loss=out.memory.separateness,
            space_loss=out.memory.compactness, feature=feature,
            feature_label=torch.zeros(feature.shape[0], dtype=torch.int32, device=clip.device),
            cluster_assign=None, space_assign=None,
        )
