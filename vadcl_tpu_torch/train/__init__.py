from vadcl_tpu_torch.train.checkpoint import (
    CheckpointManager,
    flatten_train_state,
    load_train_state,
    tolerant_merge,
)
from vadcl_tpu_torch.train.loop import train
from vadcl_tpu_torch.train.optim import (
    Lars,
    apply_gates,
    build_optimizer,
    cosine_epoch_lr,
    param_gate_thresholds,
)
from vadcl_tpu_torch.train.step import (
    StepMetrics,
    TrainState,
    create_train_state,
    make_loss_fn,
    make_train_step,
    normalize_clip,
    split_predict_batch,
)

__all__ = [
    "CheckpointManager",
    "Lars",
    "StepMetrics",
    "TrainState",
    "apply_gates",
    "build_optimizer",
    "cosine_epoch_lr",
    "create_train_state",
    "flatten_train_state",
    "load_train_state",
    "make_loss_fn",
    "make_train_step",
    "normalize_clip",
    "param_gate_thresholds",
    "split_predict_batch",
    "tolerant_merge",
    "train",
]
