"""Distributed substrate of the port: int8 error-feedback compression and
elastic re-placement (one card). The reference's meshes, sharding rules and
collectives wait for the multi-GPU port."""
from .compression import compress_decompress, compression_ratio, ef_init
from .elastic import rescale

__all__ = ["ef_init", "compress_decompress", "compression_ratio",
           "rescale"]
