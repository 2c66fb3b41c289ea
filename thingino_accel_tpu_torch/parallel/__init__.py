"""Scaling over several devices in one process (port of
``thingino_accel_tpu.parallel``): data-parallel batch sharding for
serving throughput, tensor-parallel channel sharding, both over a
('dp', 'tp') mesh of torch devices (``mesh``, ``shard``), and a stage
pipeline (``pipeline``)."""

from thingino_accel_tpu_torch.parallel.mesh import (
    make_mesh, param_sharding_rules, shard_params, batch_sharding,
)
from thingino_accel_tpu_torch.parallel.shard import (
    make_sharded_detector, make_sharded_forward,
    make_sharded_train_step,
)
from thingino_accel_tpu_torch.parallel.pipeline import (
    PipelinedEngine, split_graph,
)

__all__ = [
    "make_mesh", "param_sharding_rules", "shard_params", "batch_sharding",
    "make_sharded_detector", "make_sharded_forward",
    "make_sharded_train_step", "PipelinedEngine", "split_graph",
]
