"""Carries a parameter tree from the JAX package into the port.

The input is plain data — nested dicts and lists of numpy arrays, as
``jax.tree.map(np.asarray, tree)`` produces — with each packed leaf given
as a ``{"packed", "scale", "bits", "shape"}`` dict.  Nothing here imports
JAX.  numpy has no bfloat16 of its own and ``torch.from_numpy`` refuses
``ml_dtypes``' one, so such arrays cross as a ``uint16`` view.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.quant.tensor import QuantizedTensor

PACKED_KEYS = frozenset({"packed", "scale", "bits", "shape"})


def to_tensor(a, *, device, dtype=None) -> torch.Tensor:
    """One numpy array -> tensor on ``device`` (floats cast to ``dtype`` if given)."""
    a = np.ascontiguousarray(np.asarray(a))
    if not a.flags.writeable:      # a JAX array's numpy view is read-only
        a = a.copy()
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree, *, device, dtype=None):
    """The JAX package's parameter tree (as numpy) -> the port's.

    A packed leaf may also be any object with ``packed``/``scale``/``bits``/
    ``shape`` attributes (the JAX container after ``jax.tree.map(np.asarray, ·)``).
    """
    if not isinstance(tree, dict) and all(hasattr(tree, k) for k in PACKED_KEYS):
        tree = {k: getattr(tree, k) for k in PACKED_KEYS}
    if isinstance(tree, dict):
        if set(tree) == PACKED_KEYS:
            return QuantizedTensor(packed=to_tensor(tree["packed"], device=device),
                                   scale=to_tensor(tree["scale"], device=device),
                                   bits=int(tree["bits"]),
                                   shape=tuple(int(d) for d in tree["shape"]))
        return {k: params_from_numpy(v, device=device, dtype=dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device=device, dtype=dtype) for v in tree]
    return to_tensor(tree, device=device, dtype=dtype)
