"""Command-line entry points of the port (``python -m
repro_torch.launch.serve``, ``.train``, ``.dryrun``), the production mesh
and the dry-run's shape stand-ins."""
from .mesh import make_mesh, make_production_mesh
from .specs import (SHAPE_KIND, SHAPES, batch_specs, cache_structs,
                    cell_supported, input_specs, param_structs)

__all__ = ["make_production_mesh", "make_mesh", "SHAPES", "SHAPE_KIND",
           "cell_supported", "batch_specs", "param_structs",
           "cache_structs", "input_specs"]
