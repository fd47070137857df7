from .engine import Request, ServeEngine  # noqa: F401
from .lifecycle import (LifecycleError, RequestLifecycle,  # noqa: F401
                        RequestState, ShedPolicy, spec_ladder)
from .sampling import sample  # noqa: F401
from .scheduler import (ChunkScheduler, SchedRecord,  # noqa: F401
                        SchedulerConfig)
