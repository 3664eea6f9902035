"""Control-plane pieces of the port: registries and the engine config."""
from .executor import EngineConfig, resolve_device
from .registry import CONTROLLERS, SIM_ENGINES, Registry

__all__ = ["EngineConfig", "resolve_device", "Registry", "CONTROLLERS",
           "SIM_ENGINES"]
