from vadcl_tpu_torch.models.backbone import VADModel, VADOutput
from vadcl_tpu_torch.models.cluster_heads import FeatureClusterHead, SpaceClusterHead
from vadcl_tpu_torch.models.decoder import PatchDebed3D, SwinDecoder3D, UpSampling
from vadcl_tpu_torch.models.encoder import SwinEncoder3D
from vadcl_tpu_torch.models.layers import (
    Conv3d,
    ConvTranspose3d,
    Dense,
    FrozenBatchNorm,
    InceptionModule,
    LayerNorm,
    Mlp,
    Unit3D,
)
from vadcl_tpu_torch.models.swin import (
    PatchEmbed3D,
    SwinBlock3D,
    SwinStage,
    WindowAttention3D,
)

__all__ = [
    "Conv3d",
    "ConvTranspose3d",
    "Dense",
    "FeatureClusterHead",
    "FrozenBatchNorm",
    "InceptionModule",
    "LayerNorm",
    "Mlp",
    "PatchDebed3D",
    "PatchEmbed3D",
    "SpaceClusterHead",
    "SwinBlock3D",
    "SwinDecoder3D",
    "SwinEncoder3D",
    "SwinStage",
    "Unit3D",
    "UpSampling",
    "VADModel",
    "VADOutput",
    "WindowAttention3D",
]
