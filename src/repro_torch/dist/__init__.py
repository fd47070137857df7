"""Multi-device layout (port of ``repro/dist``)."""
from . import sharding

__all__ = ["sharding"]
