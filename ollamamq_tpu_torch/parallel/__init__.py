from ollamamq_tpu_torch.parallel.mesh import (AXIS_DATA, AXIS_EXPERT,
                                              AXIS_PIPE, AXIS_SEQ,
                                              AXIS_TENSOR, RankMesh,
                                              TensorGroup, make_mesh)
from ollamamq_tpu_torch.parallel.sharding import (kv_cache_spec,
                                                  param_partition_specs,
                                                  shard_params)

__all__ = [
    "make_mesh", "RankMesh", "TensorGroup", "AXIS_DATA", "AXIS_EXPERT",
    "AXIS_PIPE", "AXIS_SEQ", "AXIS_TENSOR", "param_partition_specs",
    "kv_cache_spec", "shard_params",
]
