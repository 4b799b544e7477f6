"""Multi-device placement on ``torch.distributed`` (counterpart of the JAX
package's ``parallel/``): meshes (:mod:`.mesh`) and the sharding rules that
place a model's tensors on them (:mod:`.sharding`)."""

from monocular_depth_estimation_trt_tpu_torch.parallel.mesh import (
    get_mesh,
    init_process_group,
    run_in_process_group,
    single_device_mesh,
)
from monocular_depth_estimation_trt_tpu_torch.parallel.sharding import (
    ShardingRules,
    geometric_tp_rules,
    metric3d_tp_rules,
    replicate,
    rules_for_family,
    shard_batch,
    vit_tp_rules,
)

__all__ = [
    "get_mesh",
    "init_process_group",
    "run_in_process_group",
    "single_device_mesh",
    "replicate",
    "shard_batch",
    "ShardingRules",
    "vit_tp_rules",
    "geometric_tp_rules",
    "metric3d_tp_rules",
    "rules_for_family",
]
