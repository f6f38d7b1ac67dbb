"""Typed configuration tree: the port's copy of ``vadcl_tpu/core/config.py``,
with the same field names and defaults.  ``MeshConfig`` describes the data
axis; under the port it is one process per card (``core/mesh.py``).

It is a copy, not an import: ``vadcl_tpu/core/__init__.py`` imports the jax
mesh helpers, so importing ``vadcl_tpu.core.config`` would pull jax into this
package.  ``tests/test_torch_port_eval.py`` guards the copy against drift.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


@dataclass(frozen=True)
class ClusterConfig:
    """Dual clustering heads (reference ``model/backbone.py:40-42``).

    feature head:  K=1024 centers over 192-d tokens, alpha=16
    spatial head:  per-channel, K=128 centers over 28*28 spatial maps, alpha=32
    """

    feature_clusters: int = 1024
    feature_alpha: float = 16.0
    space_clusters: int = 128
    space_alpha: float = 32.0
    space_size: int = 28  # spatial side of the latent grid the space head sees


# The fused window-attention kernel families of the JAX package; the port
# runs all six (models/swin.py says which kernels each one launches).
ATTN_KERNELS = frozenset(
    {"base", "packed", "fold", "fold_block", "fold_packed", "fold_mix"}
)
# The kernel families with a backward in the JAX package.
TRAINABLE_ATTN_KERNELS = frozenset({"base", "fold", "fold_block"})


@dataclass(frozen=True)
class ModelConfig:
    """Hybrid Video-Swin-3D + I3D-Inception autoencoder (see the JAX
    package's ``ModelConfig`` for the meaning of every field).  The dropout
    rates and ``remat`` act in the train step only (``models/layers.py``,
    ``models/swin.py``); like the JAX package's deterministic forward, a
    scoring forward's result does not depend on them.  Nothing reads ``subpixel_deconv`` either: it picks the JAX
    package's TPU lowering of the decoder's transposed convs (a dense conv
    and a pixel shuffle, the same result), which the H100 runs slower than
    its transposed convolution (ROADMAP.md), so the port's decoder takes
    the transposed convolution whatever it says.  ``memory_size`` /
    ``memory_dim`` size the bank of the ``convae`` and ``convae_predict``
    families (``models/memory.py``)."""

    backbone: str = "swin"  # swin | unet3d | convae | convae_predict
    in_channels: int = 3
    embed_dim: int = 96
    patch_size: Tuple[int, int, int] = (2, 4, 4)
    encoder_depths: Tuple[int, ...] = (3, 6)
    encoder_heads: Tuple[int, ...] = (6, 12)
    decoder_depths: Tuple[int, ...] = (6, 3)
    decoder_heads: Tuple[int, ...] = (12, 6)
    window_size: Tuple[int, int, int] = (8, 7, 7)
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    qk_scale: Optional[float] = None
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    drop_path_rate: float = 0.0
    predict: bool = False  # next-frame prediction vs reconstruction decoder
    use_cluster: bool = True
    compactness: bool = True  # decode from cluster reconstruction (assign @ centers)
    cluster: ClusterConfig = field(default_factory=ClusterConfig)
    remat: bool = False
    fused_attention: bool = False  # hand-written fold attention + LN->MLP kernels
    fused_cluster: bool = False  # hand-written cluster-assign / space-loss kernels
    attn_kernel: str = "base"
    subpixel_deconv: bool = False
    memory_size: int = 10
    memory_dim: int = 512

    def __post_init__(self):
        if self.fused_attention and self.attn_drop_rate > 0.0:
            raise ValueError(
                "fused_attention=True has no attention-dropout path; set "
                "attn_drop_rate=0 or fused_attention=False "
                f"(got attn_drop_rate={self.attn_drop_rate})"
            )
        if self.attn_kernel not in ATTN_KERNELS:
            raise ValueError(
                f"unknown attn_kernel {self.attn_kernel!r}; valid kernels: "
                f"{sorted(ATTN_KERNELS)}"
            )


@dataclass(frozen=True)
class DataConfig:
    """Clip dataset semantics (reference ``dataset/utils_dataset.py:55-148``)."""

    name: str = "shanghaitech"
    data_path: str = ""
    test_data_path: str = ""
    label_path: str = ""
    frame_num: int = 4
    image_size: Tuple[int, int] = (224, 224)
    num_workers: int = 8
    prefetch: int = 2


@dataclass(frozen=True)
class OptimConfig:
    """Adam + per-epoch cosine schedule (reference ``main_predict.py:180-185``):
    ``torch.optim.Adam(lr, weight_decay=0.02)``, L2 weight decay added to
    the gradient (``adamw`` decouples it), timm cosine stepped per epoch."""

    optimizer: str = "adam"  # adam | adamw | sgd (lars is still to port)
    lr: float = 6e-6
    min_lr: float = 1e-6
    weight_decay: float = 0.02
    epochs: int = 120
    warmup_epochs: int = 0
    clip_grad: float = 0.0  # 0 disables
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8


@dataclass(frozen=True)
class ScheduleConfig:
    """Staged-training flips (reference ``main_predict.py:244-257``): the
    iteration at which the cluster losses turn on, at which parameters whose
    name contains "cluster" start to train, and at which compactness engages
    (before it the heads see detached features and the decoder the encoder
    features); plus the loss weights."""

    cluster_start_iter: int = 0
    cluster_train_start_iter: int = 0
    compactness_start_iter: int = 0
    recon_weight: float = 1.0
    cluster_weight: float = 1.0
    space_weight: float = 1.0


@dataclass(frozen=True)
class EvalConfig:
    """Scoring protocols: "stride1" or "nonoverlap" sliding windows per whole
    test video; per-frame PSNR -> per-video min-max anomaly score ->
    per-scene-averaged AUROC."""

    protocol: str = "stride1"
    batch_windows: int = 8  # windows batched per device step


@dataclass(frozen=True)
class MeshConfig:
    """The data-parallel axis.  The JAX package lays a 1-D ``data`` mesh over
    its devices; the port runs one process per card instead
    (``core/mesh.py``), whose process group is that axis.  The fields are
    kept so the tree and its run stamp match the JAX package's; the port's
    world size comes from the launcher, not from ``num_devices``."""

    data_axis: str = "data"
    num_devices: int = 0  # 0 = all available


@dataclass(frozen=True)
class Config:
    """The JAX ``Config`` tree."""

    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    schedule: ScheduleConfig = field(default_factory=ScheduleConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    seed: int = 0
    batch_size_per_device: int = 4
    output_dir: str = "log_dir"
    save_every_epochs: int = 1
    save_every_iters: int = 0
    dump_every_iters: int = 0  # input+recon JPEG dump every N steps (needs PIL)
    bf16: bool = True  # bf16 compute / fp32 params+reductions

    def replace(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **kw)


_PRESETS: Dict[str, Dict[str, Any]] = {
    "shanghaitech": dict(
        data=DataConfig(name="shanghaitech", frame_num=4),
    ),
    "avenue": dict(
        data=DataConfig(name="avenue", frame_num=4),
    ),
    "ped2": dict(
        data=DataConfig(name="ped2", frame_num=4),
    ),
    # tiny synthetic config used by tests
    "tiny": dict(
        model=ModelConfig(
            embed_dim=32,
            encoder_depths=(1, 1),
            encoder_heads=(2, 4),
            decoder_depths=(1, 1),
            decoder_heads=(4, 2),
            window_size=(8, 7, 7),
            cluster=ClusterConfig(
                feature_clusters=16, space_clusters=8, space_size=7
            ),
        ),
        data=DataConfig(name="tiny", frame_num=4, image_size=(56, 56)),
        batch_size_per_device=2,
    ),
}


def preset(name: str, **overrides: Any) -> Config:
    """Build a Config from a named per-dataset preset."""
    if name not in _PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(_PRESETS)}")
    cfg = Config(**_PRESETS[name])
    if overrides:
        cfg = cfg.replace(**overrides)
    return cfg
