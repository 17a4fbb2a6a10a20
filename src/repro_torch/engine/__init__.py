"""The decomposition engine of the port."""
from .backends import (Backend, available_backends, get_backend,
                       register_backend)
from .config import EngineConfig
from .engine import DecomposeEngine, default_z0

__all__ = ["Backend", "DecomposeEngine", "EngineConfig", "available_backends",
           "default_z0", "get_backend", "register_backend"]
