"""Distribution of the port: the sharding rule tables on a torch
``DeviceMesh`` (``sharding``) with the collective helpers of the DP
super-axis and the "model" axis, Megatron tensor parallelism over
"model" (``tp``), and the low-rank gradient compression (PowerSGD) with
its data-parallel all-reduces (``compression``), which the training step
takes as its ``grad_transform``."""
from .sharding import (MeshShape, Spec, batch_sharding, cache_pspec,
                       cache_sharding, dp_axes, dp_group, dp_name, dp_rank,
                       dp_size, local_block, model_group, model_rank,
                       model_size, opt_state_sharding, param_spec,
                       params_sharding, placements, replicated,
                       require_groups, shard_params, token_sharding)
