from vadcl_tpu_torch.core.config import (
    ClusterConfig,
    Config,
    DataConfig,
    EvalConfig,
    ModelConfig,
    preset,
)
from vadcl_tpu_torch.core.dtypes import compute_dtype

__all__ = [
    "ClusterConfig",
    "Config",
    "DataConfig",
    "EvalConfig",
    "ModelConfig",
    "preset",
    "compute_dtype",
]
