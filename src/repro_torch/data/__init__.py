# Synthetic token task for pretraining and QAT.
from .pipeline import TokenTask, PipelineState, host_batch, global_batch  # noqa: F401
from .images import ImageTask  # noqa: F401
