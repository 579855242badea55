from ollamamq_tpu_torch.parallel.mesh import (AXIS_DATA, AXIS_EXPERT,
                                              AXIS_PIPE, AXIS_SEQ,
                                              AXIS_TENSOR, ExpertGroup,
                                              PipeGroup, RankMesh, SeqGroup,
                                              TensorGroup, make_mesh)
from ollamamq_tpu_torch.parallel.sharding import (kv_cache_spec,
                                                  kv_pipe_spec,
                                                  param_partition_specs,
                                                  pipeline_param_specs,
                                                  shard_layer, shard_params,
                                                  stage_layers)

__all__ = [
    "make_mesh", "RankMesh", "TensorGroup", "PipeGroup", "SeqGroup",
    "ExpertGroup",
    "AXIS_DATA",
    "AXIS_EXPERT", "AXIS_PIPE", "AXIS_SEQ", "AXIS_TENSOR",
    "param_partition_specs", "pipeline_param_specs", "kv_cache_spec",
    "kv_pipe_spec", "shard_layer", "shard_params", "stage_layers",
]
