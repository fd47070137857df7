# Step-versioned npz checkpoints: the restore half (the save half waits, ROADMAP queue 1).
from .store import (  # noqa: F401
    ArtifactError,
    keystr,
    latest_step,
    list_steps,
    load_policy_artifact,
    restore,
)
