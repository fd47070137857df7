"""Serve-path fault tolerance (a copy of ``repro/runtime/resilience.py``); the
train loop and elastic re-meshing of ``repro/runtime`` are not ported yet."""
from .resilience import (SERVE_FAULT_SITES, FailureInjector, SimulatedFailure,  # noqa: F401
                         StepTimer, StragglerMonitor)
