"""Distributed substrate of the port: meshes, sharding rules, collectives,
compression, elasticity, and the scenario mesh of the sweep stack."""
from .collectives import hierarchical_allreduce, ring_allreduce
from .compression import compress_decompress, compression_ratio, ef_init
from .elastic import rescale, set_parameters, surviving_mesh
from .mesh import (BATCH_AXES, DATA, MODEL, POD, SCENARIO, NamedSharding,
                   axis_size, batch_spec, device_count_hint,
                   force_host_device_env, has_pod_axis, mesh_shape, named,
                   pad_to_multiple, partition_bounds, scenario_mesh)
from .sharding import (CACHE_RULES, LOGICAL_RULES, PARAM_RULES,
                       cache_shardings, cache_specs, current_mesh,
                       param_shardings, param_specs, sanitize_spec, shard,
                       sharding_context)

__all__ = ["POD", "DATA", "MODEL", "SCENARIO", "BATCH_AXES", "batch_spec",
           "axis_size", "has_pod_axis", "named", "NamedSharding",
           "mesh_shape", "scenario_mesh", "pad_to_multiple",
           "partition_bounds", "device_count_hint", "force_host_device_env",
           "shard", "sharding_context", "current_mesh", "param_specs",
           "param_shardings", "cache_specs", "cache_shardings",
           "sanitize_spec", "LOGICAL_RULES", "PARAM_RULES", "CACHE_RULES",
           "ring_allreduce", "hierarchical_allreduce",
           "ef_init", "compress_decompress", "compression_ratio",
           "rescale", "set_parameters", "surviving_mesh"]
