from vadcl_tpu_torch.models.backbone import VADModel, VADOutput
from vadcl_tpu_torch.models.cluster_heads import FeatureClusterHead, SpaceClusterHead
from vadcl_tpu_torch.models.conv_ae import ConvAE, ConvAEPredict
from vadcl_tpu_torch.models.decoder import (
    LegacySwinDecoder,
    PatchDebed3D,
    SwinDecoder3D,
    UpSampling,
)
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
from vadcl_tpu_torch.models.memory import MemoryModule
from vadcl_tpu_torch.models.swin import (
    PatchEmbed3D,
    SwinBlock3D,
    SwinStage,
    WindowAttention3D,
)
from vadcl_tpu_torch.models.unet3d import UNet3D

__all__ = [
    "Conv3d",
    "ConvAE",
    "ConvAEPredict",
    "ConvTranspose3d",
    "Dense",
    "FeatureClusterHead",
    "FrozenBatchNorm",
    "InceptionModule",
    "LayerNorm",
    "LegacySwinDecoder",
    "MemoryModule",
    "Mlp",
    "PatchDebed3D",
    "PatchEmbed3D",
    "SpaceClusterHead",
    "SwinBlock3D",
    "SwinDecoder3D",
    "SwinEncoder3D",
    "SwinStage",
    "UNet3D",
    "Unit3D",
    "UpSampling",
    "VADModel",
    "VADOutput",
    "WindowAttention3D",
]
