"""Fault tolerance and the train loop (port of ``repro/runtime``): the serve
path's failure injection and straggler monitor (a copy of
``resilience.py``), the checkpointing train loop with restart on failure,
and elastic mesh planning (a copy of ``elastic.py``)."""
from .resilience import (SERVE_FAULT_SITES, FailureInjector, SimulatedFailure,  # noqa: F401
                         StepTimer, StragglerMonitor)
from .loop import LoopConfig, TrainLoop  # noqa: F401
from . import elastic  # noqa: F401
