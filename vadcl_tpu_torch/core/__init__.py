from vadcl_tpu_torch.core.config import (
    ClusterConfig,
    Config,
    DataConfig,
    EvalConfig,
    MeshConfig,
    ModelConfig,
    preset,
)
from vadcl_tpu_torch.core.dtypes import compute_dtype

__all__ = [
    "ClusterConfig",
    "Config",
    "DataConfig",
    "EvalConfig",
    "MeshConfig",
    "ModelConfig",
    "preset",
    "compute_dtype",
]
