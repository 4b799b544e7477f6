"""Training: losses, metrics, the train step, distillation and resume
(counterpart of the JAX package's ``training/``). Fine-tuning and
teacher-to-student distillation run on the card the models serve on; the
student trains in fp32 through the plain attention route, as the kernels
K1 to K4 have no backward.
"""

from monocular_depth_estimation_trt_tpu_torch.training.losses import (
    align_scale_shift,
    distillation_loss,
    gradient_matching_loss,
    silog_loss,
    ssi_loss,
)
from monocular_depth_estimation_trt_tpu_torch.training.trainer import (
    TrainState,
    create_train_state,
    load_train_state,
    make_train_step,
    save_train_state,
    shard_batch_tree,
    shard_train_state,
)
from monocular_depth_estimation_trt_tpu_torch.training.distill import (
    distill,
    make_distill_step,
)
from monocular_depth_estimation_trt_tpu_torch.training.metrics import (
    depth_metrics,
    flow_metrics,
)

__all__ = [
    "TrainState",
    "align_scale_shift",
    "create_train_state",
    "depth_metrics",
    "distill",
    "distillation_loss",
    "flow_metrics",
    "gradient_matching_loss",
    "load_train_state",
    "make_distill_step",
    "make_train_step",
    "save_train_state",
    "shard_batch_tree",
    "shard_train_state",
    "silog_loss",
    "ssi_loss",
]
