"""Distributed substrate of the port: the scenario mesh of the sweep stack,
int8 error-feedback compression and elastic re-placement (one card). The
reference's model-parallel sharding rules and collectives wait for the
multi-GPU training port."""
from .compression import compress_decompress, compression_ratio, ef_init
from .elastic import rescale
from .mesh import (SCENARIO, device_count_hint, force_host_device_env,
                   pad_to_multiple, partition_bounds, scenario_mesh)

__all__ = ["ef_init", "compress_decompress", "compression_ratio",
           "rescale", "SCENARIO", "scenario_mesh", "pad_to_multiple",
           "partition_bounds", "device_count_hint", "force_host_device_env"]
