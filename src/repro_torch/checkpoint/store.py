"""Step-versioned npz checkpoints, the restore half (port of
``repro/checkpoint/store.py``).

Layout (one directory per step), as the JAX package writes it::

    <root>/step_00000400/
        shard-00000-of-00001.npz    # this host's leaves, keyed by tree path
        MANIFEST.json               # step, n_hosts, leaf index, extras

Leaves are keyed by JAX's key-path strings (``['blocks'][0]['conv1']``);
:func:`keystr` writes the same string for a path of the port's tree, so a
checkpoint restores into the port's structure without JAX.  bfloat16 leaves
were saved as a same-width unsigned view and are viewed back.
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from repro_torch.core.policy import PolicyArtifact

#: manifest-extra key and sidecar file name of the searched quantization policy
ARTIFACT_KEY = "policy_artifact"
ARTIFACT_FILE = "policy_artifact.json"


class ArtifactError(RuntimeError):
    """A checkpoint's policy-artifact payload is unreadable; the message names
    the file and the field that failed."""


def _parse_artifact(payload: str, src: str) -> PolicyArtifact:
    try:
        json.loads(payload)
    except json.JSONDecodeError as e:
        raise ArtifactError(f"{src}: corrupted or truncated artifact JSON ({e})") from e
    try:
        return PolicyArtifact.from_json(payload)
    except KeyError as e:
        raise ArtifactError(f"{src}: policy artifact is missing required field "
                            f"{e.args[0]!r}") from e
    except (TypeError, ValueError) as e:
        raise ArtifactError(f"{src}: invalid policy artifact field value ({e})") from e


def keystr(path: tuple) -> str:
    """A tree path as ``jax.tree_util.keystr`` writes it: ``['key']`` for a
    dict key, ``[i]`` for a list index."""
    return "".join(f"[{p!r}]" if isinstance(p, str) else f"[{int(p)}]" for p in path)


def _step_dir(root: str, step: int) -> str:
    return os.path.join(root, f"step_{step:08d}")


def list_steps(root: str) -> list[int]:
    if not os.path.isdir(root):
        return []
    return sorted(int(name[5:]) for name in os.listdir(root)
                  if name.startswith("step_")
                  and os.path.exists(os.path.join(root, name, "MANIFEST.json")))


def latest_step(root: str) -> int | None:
    steps = list_steps(root)
    return steps[-1] if steps else None


def _resolve_step(root: str, step: int | None) -> int:
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {root}")
    return step


def load_policy_artifact(root: str, *, step: int | None = None) -> PolicyArtifact | None:
    """The policy artifact saved with a step, or None if the step has none.

    A corrupted payload raises :class:`ArtifactError`; a manifest without
    its embedded copy falls back to the ``policy_artifact.json`` sidecar.
    """
    d = _step_dir(root, _resolve_step(root, step))
    mpath = os.path.join(d, "MANIFEST.json")
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except json.JSONDecodeError as e:
        raise ArtifactError(f"{mpath}: corrupted or truncated manifest JSON ({e})") from e
    extra = manifest.get("extra", {})
    if not isinstance(extra, dict):
        raise ArtifactError(f"{mpath}: manifest field 'extra' is {type(extra).__name__}, "
                            f"expected an object")
    if ARTIFACT_KEY in extra:
        return _parse_artifact(json.dumps(extra[ARTIFACT_KEY]),
                               f"{mpath} (field {ARTIFACT_KEY!r})")
    sidecar = os.path.join(d, ARTIFACT_FILE)
    if os.path.exists(sidecar):
        with open(sidecar) as f:
            return _parse_artifact(f.read(), sidecar)
    return None


def _leaf(arr: np.ndarray, like: torch.Tensor, key: str) -> torch.Tensor:
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"{key}: shape {arr.shape} != expected {tuple(like.shape)}")
    want = like.dtype
    if arr.dtype.kind == "u" and want.is_floating_point and arr.dtype.itemsize == want.itemsize \
            and want not in (torch.float16, torch.float32, torch.float64):
        t = torch.from_numpy(np.ascontiguousarray(arr)).view(want)   # bf16 saved as a u16 view
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr)).to(want)
    return t.to(like.device)


def restore(root: str, like: Any, *, step: int | None = None, host_id: int = 0
            ) -> tuple[Any, dict]:
    """Restore into the structure, dtypes and devices of ``like`` (nested
    dicts and lists of tensors) -> ``(tree, extra)``.  Raises
    FileNotFoundError or ValueError on a mismatch."""
    d = _step_dir(root, _resolve_step(root, step))
    with open(os.path.join(d, "MANIFEST.json")) as f:
        manifest = json.load(f)
    shards = [fn for fn in os.listdir(d) if fn.startswith(f"shard-{host_id:05d}-")]
    if not shards:
        raise FileNotFoundError(f"host {host_id} shard missing in {d}")
    with np.load(os.path.join(d, shards[0])) as data:
        def rec(tree, path):
            if isinstance(tree, dict):
                return {k: rec(v, path + (k,)) for k, v in tree.items()}
            if isinstance(tree, (list, tuple)):
                return type(tree)(rec(v, path + (i,)) for i, v in enumerate(tree))
            key = keystr(path)
            if key not in data:
                raise ValueError(f"checkpoint {d} missing leaf {key}")
            return _leaf(data[key], tree, key)

        return rec(like, ()), manifest["extra"]
