# Atomic, step-versioned npz checkpoints in the JAX package's format, with
# async save: either package restores what the other saved.
from .store import (  # noqa: F401
    ArtifactError,
    CheckpointStore,
    keystr,
    latest_step,
    list_steps,
    load_policy_artifact,
    restore,
    save,
)
