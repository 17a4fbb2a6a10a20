"""The decomposition engine of the port."""
from .config import EngineConfig
from .engine import DecomposeEngine, default_z0

__all__ = ["DecomposeEngine", "EngineConfig", "default_z0"]
