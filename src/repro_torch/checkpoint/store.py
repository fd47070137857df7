"""Atomic, step-versioned npz checkpoints with async save (port of
``repro/checkpoint/store.py``).

Layout (one directory per step), as the JAX package writes it::

    <root>/step_00000400/
        shard-00000-of-00001.npz    # this host's leaves, keyed by tree path
        MANIFEST.json               # step, n_hosts, leaf index, extras
        policy_artifact.json        # the searched policy, where one was saved

Leaves are keyed by JAX's key-path strings (``['blocks'][0]['conv1']``, a
packed weight's ``['w'].packed`` and ``['w'].scale``) in JAX's flattening
order (sorted dict keys); :func:`keystr` writes the same string for a path
of the port's tree, so either package restores what the other saved.
bfloat16 leaves are saved as a same-width unsigned view and viewed back; a
Python number in the tree (the optimizer's step) is saved as a 0-d array
and restored as the number.

* **atomic**: a step is written to ``<root>/.tmp.step_X.<host>`` and renamed
  into place after its manifest, so a reader never sees half a step;
* **retention**: the newest ``keep`` steps stay, older ones go, after a
  successful save only;
* **async**: ``CheckpointStore.save_async`` copies every leaf to host memory
  before it returns (the port updates params and optimizer moments in place,
  so a view would race the next step), then writes in a background thread.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.core.policy import PolicyArtifact
from repro_torch.quant.tensor import QuantizedTensor

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


def _host_array(x) -> np.ndarray:
    """A leaf as a numpy array that owns its bytes on the host (a copy even of a
    CPU tensor); bfloat16 as its ``u2`` view, as npz cannot hold it."""
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    t = x.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _flatten_with_paths(tree: Any, path: str = "") -> list[tuple[str, np.ndarray]]:
    """``(key, host array)`` for each leaf, keyed and ordered as JAX flattens:
    sorted dict keys, list and tuple indices, a packed weight's fields."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flatten_with_paths(tree[k], path + keystr((k,)))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in _flatten_with_paths(v, path + keystr((i,)))]
    if isinstance(tree, QuantizedTensor):
        return [(path + ".packed", _host_array(tree.packed)),
                (path + ".scale", _host_array(tree.scale))]
    return [(path, _host_array(tree))]


def _write(root: str, step: int, leaves: list[tuple[str, np.ndarray]], *, host_id: int,
           n_hosts: int, extra: dict | None, keep: int, artifact: PolicyArtifact | None) -> str:
    os.makedirs(root, exist_ok=True)
    tmp = os.path.join(root, f".tmp.step_{step:08d}.{host_id}")
    final = _step_dir(root, step)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    shard = os.path.join(tmp, f"shard-{host_id:05d}-of-{n_hosts:05d}.npz")
    np.savez(shard, **dict(leaves))
    extra = dict(extra or {})
    if artifact is not None:
        extra[ARTIFACT_KEY] = json.loads(artifact.to_json())
        with open(os.path.join(tmp, ARTIFACT_FILE), "w") as f:
            f.write(artifact.to_json())
    manifest = {"step": step, "n_hosts": n_hosts, "leaves": [k for k, _ in leaves],
                "extra": extra}
    with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):       # a re-save of the same step (a restart's double write)
        shutil.rmtree(final)
    os.rename(tmp, final)
    _apply_retention(root, keep)
    return final


def save(root: str, step: int, tree: Any, *, host_id: int = 0, n_hosts: int = 1,
         extra: dict | None = None, keep: int = 3,
         artifact: PolicyArtifact | None = None) -> str:
    """Synchronous atomic save of ``tree`` (nested dicts, lists and tuples of
    tensors, packed weights and numbers).  Returns the final step directory.

    ``artifact`` persists the searched quantization policy with the weights:
    embedded in the manifest extras (atomic with the step) and mirrored as a
    readable ``policy_artifact.json`` sidecar.
    """
    return _write(root, step, _flatten_with_paths(tree), host_id=host_id, n_hosts=n_hosts,
                  extra=extra, keep=keep, artifact=artifact)


def _apply_retention(root: str, keep: int) -> None:
    steps = list_steps(root)
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(_step_dir(root, s), ignore_errors=True)


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
    dicts, lists and tuples of tensors, packed weights, whose ``bits`` and
    ``shape`` come from ``like``, and numbers) -> ``(tree, extra)``.  Raises
    FileNotFoundError or ValueError on a mismatch."""
    d = _step_dir(root, _resolve_step(root, step))
    with open(os.path.join(d, "MANIFEST.json")) as f:
        manifest = json.load(f)
    shards = [fn for fn in os.listdir(d) if fn.startswith(f"shard-{host_id:05d}-")]
    if not shards:
        raise FileNotFoundError(f"host {host_id} shard missing in {d}")
    with np.load(os.path.join(d, shards[0])) as data:
        def load(key):
            if key not in data:
                raise ValueError(f"checkpoint {d} missing leaf {key}")
            return data[key]

        def rec(tree, key):
            if isinstance(tree, dict):
                return {k: rec(v, key + keystr((k,))) for k, v in tree.items()}
            if isinstance(tree, (list, tuple)):
                return type(tree)(rec(v, key + keystr((i,))) for i, v in enumerate(tree))
            if isinstance(tree, QuantizedTensor):
                return dataclasses.replace(
                    tree, packed=_leaf(load(key + ".packed"), tree.packed, key + ".packed"),
                    scale=_leaf(load(key + ".scale"), tree.scale, key + ".scale"))
            if isinstance(tree, torch.Tensor):
                return _leaf(load(key), tree, key)
            arr = load(key)
            if arr.shape != ():
                raise ValueError(f"{key}: shape {arr.shape} != expected () for a number")
            return type(tree)(arr.item())

        return rec(like, ""), manifest["extra"]


class CheckpointStore:
    """Async wrapper: snapshot on the call, write in the background, join on
    ``wait``."""

    def __init__(self, root: str, *, keep: int = 3, host_id: int = 0, n_hosts: int = 1):
        self.root = root
        self.keep = keep
        self.host_id = host_id
        self.n_hosts = n_hosts
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save_async(self, step: int, tree: Any, extra: dict | None = None,
                   artifact: PolicyArtifact | None = None) -> None:
        """Copy every leaf of ``tree`` to host memory, then write it in a
        background thread; a step taken after the call leaves the save as it
        was.  A failed write raises from the next ``wait``."""
        self.wait()                 # one save in flight at a time (bounded memory)
        snapshot = _flatten_with_paths(tree)

        def work():
            try:
                _write(self.root, step, snapshot, host_id=self.host_id, n_hosts=self.n_hosts,
                       extra=extra, keep=self.keep, artifact=artifact)
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def latest(self) -> int | None:
        return latest_step(self.root)

    def restore_latest(self, like: Any) -> tuple[Any, dict]:
        self.wait()
        return restore(self.root, like, host_id=self.host_id)

    def load_policy_artifact(self, step: int | None = None) -> PolicyArtifact | None:
        self.wait()
        return load_policy_artifact(self.root, step=step)
